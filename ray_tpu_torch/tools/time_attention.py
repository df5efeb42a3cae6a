"""Device time of the attention kernels of one checkout.

    python3 ray_tpu_torch/tools/time_attention.py [--tree DIR]
        [--dtype bfloat16|float32]

Imports ``ray_tpu_torch`` from ``DIR`` (default: the checkout holding
this file), so two checkouts can be timed in turns on one card, e.g. a
parent commit unpacked under ``_tree/parent``::

    for t in _tree/parent . . _tree/parent; do
        python3 ray_tpu_torch/tools/time_attention.py --tree $t; done

Times, on inputs of ``--dtype`` (bf16 by default; fp32 takes the fp32
routes, e.g. the 3xTF32 dQ against a parent's scalar one) with 32/8
heads and d 128, causal: the forward wrapper at the dense engine's largest prefill (b 8, s 512) and at the
training shape (b 4, s 2048), by CUDA events around each call after a
512 MB write that evicts the 50 MB L2 and keeps the card busy while the
host enqueues the call (mean of 20), as ``chip_smoke.py`` times; the dQ and dK/dV
kernels of the backward at the training shape, by ``torch.profiler``
over 10 calls of the backward wrapper (device time of the kernels whose
name holds ``flash_bwd_dq`` or ``flash_bwd_dkv``). The paged wrapper at
``chip_smoke.py`` phase 1's decode shape (8 slots, 8 kv heads, G 4, page
64, 16-entry tables, history 116..516), three ways: CUDA events around
each call after the same L2 write (mean of 50; what ``chip_smoke.py``
reports), the device time of its kernels (name holding ``paged``) from
``torch.profiler`` over 50 calls, each after the L2 write, and the host
time of one call (mean over 200 calls, synchronised at the end). At
head dim 256 (16/16 heads, Gemma's): the forward at b 8, s 512 by CUDA
events as above, and the dQ and dK/dV kernels at b 2, s 2048 by
``torch.profiler`` as above. Prints one JSON line with the card's name
and power limit and the names of the kernels the profiler timed (which
route each backward took: e.g. ``flash_bwd_dq_sm90_d256_kernel`` in
bf16, ``flash_bwd_dq_tf32x3_kernel`` in fp32, or a parent's scalar
``flash_bwd_dq_kernel``). Needs one card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path


def _smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30, check=True).stdout.strip().splitlines()[0]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve()
                                          .parents[2]))
    ap.add_argument("--dtype", choices=("bfloat16", "float32"),
                    default="bfloat16")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ray_tpu_torch.ops import attention, paged_attention

    assert Path(attention.__file__).resolve().is_relative_to(tree)
    if not torch.cuda.is_available():
        sys.exit("time_attention: no CUDA device")
    dev = torch.device("cuda")
    H, KVH, D, dt = 32, 8, 128, getattr(torch, args.dtype)
    g = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(128 << 20, dtype=torch.float32, device=dev)

    def inputs(b, s, heads=(H, KVH, KVH, H), d=D):
        return [torch.randn(b, s, h, d, generator=g, device=dev).to(dt)
                for h in heads]

    def events_ms(fn, iters=20):
        for _ in range(3):
            fn()
        total = 0.0
        for _ in range(iters):
            flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            total += start.elapsed_time(end)
        return total / iters

    out = {"tree": args.tree, "dtype": args.dtype, "card": _smi(),
           "kernels": []}
    for name, (b, s) in (("fwd_ms_b8_s512", (8, 512)),
                         ("fwd_ms_b4_s2048", (4, 2048))):
        q, k, v, _ = inputs(b, s)
        out[name] = events_ms(lambda: attention.flash_forward(q, k, v, True))
    def profiled_ms(fn, keys, iters):
        """{key: ms a call} of the kernels whose name holds ``key``; the
        names they matched go to ``out["kernels"]``."""
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                flush.zero_()
                fn()
            torch.cuda.synchronize()
        us = dict.fromkeys(keys, 0.0)
        for evt in prof.events():
            if evt.device_type != torch.autograd.DeviceType.CUDA:
                continue
            for key in keys:
                if key in evt.name:
                    us[key] += evt.time_range.elapsed_us()
                    ran = re.search(r"(flash|paged)_\w+", evt.name).group()
                    if ran not in out["kernels"]:
                        out["kernels"].append(ran)
        return {key: t / 1e3 / iters for key, t in us.items()}

    q, k, v, do = inputs(4, 2048)
    o, lse = attention.flash_forward(q, k, v, True)
    bwd = profiled_ms(
        lambda: attention.flash_backward(q, k, v, o, lse, do, True),
        ("flash_bwd_dq", "flash_bwd_dkv"), 10)
    out["dq_ms_b4_s2048"] = bwd["flash_bwd_dq"]
    out["dkv_ms_b4_s2048"] = bwd["flash_bwd_dkv"]
    del q, k, v, do, o, lse

    q, k, v, _ = inputs(8, 512, (16,) * 4, 256)
    out["fwd_d256_ms_b8_s512"] = events_ms(
        lambda: attention.flash_forward(q, k, v, True))
    q, k, v, do = inputs(2, 2048, (16,) * 4, 256)
    o, lse = attention.flash_forward(q, k, v, True)
    bwd = profiled_ms(
        lambda: attention.flash_backward(q, k, v, o, lse, do, True),
        ("flash_bwd_dq", "flash_bwd_dkv"), 10)
    out["dq_d256_ms_b2_s2048"] = bwd["flash_bwd_dq"]
    out["dkv_d256_ms_b2_s2048"] = bwd["flash_bwd_dkv"]
    del q, k, v, do, o, lse

    S, G, page, maxp = 8, 4, 64, 16
    ctx = [m + 16 for m in (100, 157, 214, 271, 328, 385, 442, 500)]
    P = S * maxp + 8
    q = torch.randn(S, KVH, G, D, generator=g, device=dev).to(dt)
    kp = torch.randn(P, KVH, page, D, generator=g, device=dev).to(dt)
    vp = torch.randn(P, KVH, page, D, generator=g, device=dev).to(dt)
    bt = torch.zeros(S, maxp, dtype=torch.int32)
    ids = torch.randperm(P, generator=torch.Generator().manual_seed(2))
    used = 0
    for s, c in enumerate(ctx):
        n = -(-c // page)
        bt[s, :n] = ids[used:used + n].to(torch.int32)
        used += n
    bt = bt.to(dev)
    ctx_t = torch.tensor(ctx, dtype=torch.int32, device=dev)

    def paged():
        paged_attention.paged_attention(q, kp, vp, bt, ctx_t)

    out["paged_ms_events"] = events_ms(paged, iters=50)
    out["paged_ms_device"] = profiled_ms(paged, ("paged",), 50)["paged"]
    paged()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        paged()
    torch.cuda.synchronize()
    out["paged_ms_host"] = (time.perf_counter() - t0) / 200 * 1e3
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
