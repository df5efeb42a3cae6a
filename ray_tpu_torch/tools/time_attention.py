"""Device time of the bf16 flash-attention kernels of one checkout.

    python3 ray_tpu_torch/tools/time_attention.py [--tree DIR]

Imports ``ray_tpu_torch`` from ``DIR`` (default: the checkout holding
this file), so two checkouts can be timed in turns on one card, e.g. a
parent commit unpacked under ``_tree/parent``::

    for t in _tree/parent . . _tree/parent; do
        python3 ray_tpu_torch/tools/time_attention.py --tree $t; done

Times, on bf16 inputs with 32/8 heads and d 128, causal: the forward
wrapper at the dense engine's largest prefill (b 8, s 512) and at the
training shape (b 4, s 2048), by CUDA events around each call after a
256 MB write that evicts the 50 MB L2 (mean of 20); the dK/dV kernel of
the backward at the training shape, by ``torch.profiler`` over 10 calls
of the backward wrapper (device time of the kernels whose name holds
``flash_bwd_dkv``). Prints one JSON line with the card's name and power
limit. Needs one card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
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
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ray_tpu_torch.ops import attention

    assert Path(attention.__file__).resolve().is_relative_to(tree)
    if not torch.cuda.is_available():
        sys.exit("time_attention: no CUDA device")
    dev = torch.device("cuda")
    H, KVH, D, dt = 32, 8, 128, torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)

    def inputs(b, s):
        return [torch.randn(b, s, h, D, generator=g, device=dev).to(dt)
                for h in (H, KVH, KVH, H)]

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

    out = {"tree": args.tree, "card": _smi()}
    for name, (b, s) in (("fwd_ms_b8_s512", (8, 512)),
                         ("fwd_ms_b4_s2048", (4, 2048))):
        q, k, v, _ = inputs(b, s)
        out[name] = events_ms(lambda: attention.flash_forward(q, k, v, True))
    q, k, v, do = inputs(4, 2048)
    o, lse = attention.flash_forward(q, k, v, True)
    attention.flash_backward(q, k, v, o, lse, do, True)
    torch.cuda.synchronize()
    iters, us = 10, 0.0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            flush.zero_()
            attention.flash_backward(q, k, v, o, lse, do, True)
        torch.cuda.synchronize()
    for evt in prof.events():
        if (evt.device_type == torch.autograd.DeviceType.CUDA
                and "flash_bwd_dkv" in evt.name):
            us += evt.time_range.elapsed_us()
    out["dkv_ms_b4_s2048"] = us / 1e3 / iters
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
