"""Where the time of one serving step goes, on the card.

    python -m ray_tpu_torch.tools.profile_decode [--layers 32] [--steps 8]

Builds Llama-3-8B (bf16, random weights from seed 0) on the CUDA card and
times one dense decode chunk and one paged decode chunk of ``--steps``
steps over 8 slots (the ``chip_smoke.py`` serving shape: history
116..516 tokens, page 64), and one dense batched prefill of 8 x 512
tokens. For each it prints the host wall time (median of 3 unprofiled
runs), the device busy time from one ``torch.profiler`` run (sum of
kernel times; one stream, so kernels do not overlap), the device idle
share, the kernels that take the most device time and, for the paged
chunk, the share of the paged attention kernels (split and merge passes
together). Needs one card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import time
from collections import defaultdict

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from ray_tpu_torch.models import llama, llama_decode, llama_paged


def _kernel_times(prof) -> dict:
    """Device microseconds per kernel name."""
    out = defaultdict(float)
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            out[evt.name] += evt.time_range.elapsed_us()
    return out


def run(name: str, fn, steps: int, top: int = 8, share: str = "") -> None:
    fn()                                  # warm: allocator, cuBLAS plans
    walls = []
    for _ in range(3):                    # host wall without the profiler
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall = sorted(walls)[1]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kt = _kernel_times(prof)
    if not kt:
        print(f"{name}: wall {wall:.3f} ms; the profiler recorded no "
              "device time (device busy: not measured)", flush=True)
        return
    busy = sum(kt.values()) / 1e3
    print(f"{name}: wall {wall:.3f} ms ({wall / steps:.3f} ms/step), "
          f"device busy {busy:.3f} ms ({busy / steps:.3f} ms/step), "
          f"idle share {1 - busy / wall:.3f}", flush=True)
    for k, us in sorted(kt.items(), key=lambda kv: -kv[1])[:top]:
        print(f"    {us / 1e3 / steps:8.4f} ms/step  {100 * us / 1e3 / busy:5.1f}%"
              f"  {k[:90]}", flush=True)
    if share:
        us = sum(t for k, t in kt.items() if share in k)
        print(f"    {us / 1e3 / steps:8.4f} ms/step  {100 * us / 1e3 / busy:5.1f}%"
              f"  all kernels named *{share}*", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=32)
    ap.add_argument("--steps", type=int, default=8)
    args = ap.parse_args()
    dev = llama.resolve_device(None)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = llama.LlamaConfig.llama3_8b(num_layers=args.layers,
                                      dtype=torch.bfloat16,
                                      param_dtype=torch.bfloat16)
    params = llama.init_params(cfg, seed=0, device=dev)
    S, max_len, page = 8, 1024, 64
    ctx = np.array([116, 173, 230, 287, 344, 401, 458, 516], np.int32)
    toks = torch.ones(S, dtype=torch.int32, device=dev)
    pos = torch.from_numpy(ctx).to(dev)
    act = np.ones(S, bool)
    print(f"Llama-3-8B bf16, {args.layers} layers, {S} slots, "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    cache = llama_decode.init_cache(cfg, S, max_len, dev)
    run("dense decode chunk", lambda: llama_decode.decode_chunk(
        cfg, params, cache, toks, pos, act, args.steps, sample=False),
        args.steps)
    del cache

    maxp = max_len // page
    pool = llama_paged.init_paged_cache(cfg, S * maxp, page, dev)
    bt = torch.arange(S * maxp, dtype=torch.int32,
                      device=dev).reshape(S, maxp)
    run("paged decode chunk", lambda: llama_paged.paged_decode_chunk(
        cfg, params, pool, toks, pos, act, bt, args.steps, sample=False),
        args.steps, share="paged_")
    del pool

    rows = torch.ones((S, 512), dtype=torch.int32, device=dev)
    last = torch.full((S,), 511, dtype=torch.int32)
    run("dense prefill 8 x 512", lambda: llama_decode.prefill_batch(
        cfg, params, rows, last), 1)


if __name__ == "__main__":
    main()
