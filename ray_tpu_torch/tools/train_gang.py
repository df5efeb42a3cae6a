"""Llama-3-8B width trained by a gang of GPU workers, one card each.

    python -m ray_tpu_torch.tools.train_gang [--workers N] [--steps 3]

``TorchTrainer`` on the port's runtime starts a gang of ``use_gpu``
workers (default: every card), each an actor holding one card, joined in
one NCCL default group (``TorchConfig(distributed=True)``). Each runs
``profile_train``'s configuration (Llama-3-8B width with 8 layers, fp32
params, bf16 compute, full remat, params from seed 0) on its slice of
the global batch of 4 x 2048 tokens (numpy seed 0) and averages every
gradient over the group before each AdamW step (``gang_loop``). The run
at world size N must give the losses of a one-worker gang on the whole
batch at rtol 2e-2 (bf16 compute); the step time of each is printed.
``chip_smoke.py`` phase 15 runs ``gang_loop`` at world size 1.

Prints the cards' name and power limit first and one JSON object last.
Exits non-zero when a check fails or fewer than 2 cards are visible.
Imports nothing of JAX; guards its top level, since the gang's workers
import this module.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from ray_tpu_torch.tools import profile_train as run


def average_grads(opt) -> None:
    """Every gradient summed over the default process group, then
    divided by its size (a real collective at world size 1 too)."""
    import torch.distributed as dist

    world = dist.get_world_size()
    for group in opt.param_groups:
        for p in group["params"]:
            if p.grad is not None:
                dist.all_reduce(p.grad)
                p.grad.div_(world)


def launch_counts() -> dict:
    """This process's flash launches: each kernel on all routes and on
    the wgmma route."""
    from ray_tpu_torch.ops.attention import flash_backward, flash_forward

    return {"fwd": flash_forward.launches,
            "fwd_sm90": flash_forward.sm90_launches,
            "dq": flash_backward.dq_launches,
            "dq_sm90": flash_backward.dq_sm90_launches,
            "dkv": flash_backward.dkv_launches,
            "dkv_sm90": flash_backward.dkv_sm90_launches}


def gang_loop(config) -> None:
    """One gang worker: the run on this rank's slice of the batch,
    ``config["steps"]`` AdamW steps, the gradients averaged over the
    group. Reports each step's loss (averaged over the group), step
    time, peak memory, this process's launches since the first step, the
    worker's ``CUDA_VISIBLE_DEVICES`` and pid, and whether it built the
    kernel library. ``config`` may carry ``cfg``, ``batch`` and ``seq``
    in place of the run's (a rehearsal on the CPU) and ``device``."""
    import torch.distributed as dist

    from ray_tpu_torch import train
    from ray_tpu_torch.ops import _build

    ctx = train.get_context()
    rank, world = ctx.get_world_rank(), ctx.get_world_size()
    dev = torch.device(config.get("device") or
                       f"cuda:{torch.cuda.current_device()}")
    cuda = dev.type == "cuda"
    cfg, params, opt, toks = run.build_train_run(
        dev, cfg=config.get("cfg"), batch=config.get("batch"),
        seq=config.get("seq"))
    share = toks.shape[0] // world
    mine = toks[rank * share:(rank + 1) * share]
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    start = launch_counts()
    for step in range(int(config["steps"])):
        t0 = time.perf_counter()
        loss = run.train_step(cfg, params, opt, mine,
                              reduce_grads=average_grads)
        mean = loss.detach().clone()
        dist.all_reduce(mean)
        value = float(mean) / world
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        now = launch_counts()
        train.report({
            "step": step, "loss": value, "step_ms": wall * 1e3,
            "peak_gib": (torch.cuda.max_memory_allocated() / 2**30
                         if cuda else 0.0),
            "launches": {k: now[k] - start[k] for k in now},
            "world": dist.get_world_size(), "backend": dist.get_backend(),
            "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "device": str(dev), "pid": os.getpid(),
            "build_s": _build.last_build_seconds})


def fit(workers: int, steps: int, storage: str, use_gpu: bool = True,
        **loop_cfg):
    """``gang_loop`` in a gang of ``workers`` (one card each when
    ``use_gpu``); returns the Result."""
    from ray_tpu_torch import train

    device = loop_cfg.get("device")
    return train.TorchTrainer(
        gang_loop, train_loop_config=dict(loop_cfg, steps=steps),
        torch_config=train.TorchConfig(device=device, distributed=True,
                                       timeout_s=600.0),
        scaling_config=train.ScalingConfig(num_workers=workers,
                                           use_gpu=use_gpu),
        run_config=train.RunConfig(storage_path=storage,
                                   name=f"gang{workers}")).fit()


def _smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30, check=True).stdout.strip()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workers", type=int, default=0,
                    help="gang size (default: every card)")
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args()
    import ray_tpu_torch as rt
    from ray_tpu_torch.ops import _build

    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        print("train_gang: needs 2 or more CUDA cards", file=sys.stderr)
        sys.exit(2)
    n = args.workers or torch.cuda.device_count()
    print(_smi(), flush=True)
    t0 = time.perf_counter()
    _build.load()   # built once here; the workers load it
    print(f"kernels built in {_build.last_build_seconds:.1f} s (load "
          f"{time.perf_counter() - t0:.1f} s)", flush=True)
    # a worker's bundle holds a CPU beside its card
    rt.init(num_workers=max(2, n), object_store_memory=256 << 20)
    runs = {}
    try:
        with tempfile.TemporaryDirectory() as storage:
            for w in (1, n):
                t1 = time.perf_counter()
                res = fit(w, args.steps, storage)
                if res.error is not None:
                    print(f"FAIL: the {w}-worker gang: {res.error!r}")
                    sys.exit(1)
                hist = res.metrics_history
                runs[w] = {
                    "losses": [m["loss"] for m in hist],
                    "step_ms": [m["step_ms"] for m in hist],
                    "peak_gib": hist[-1]["peak_gib"],
                    "launches": hist[-1]["launches"],
                    "wall_s": time.perf_counter() - t1}
                print(f"world {w}: losses "
                      f"{' '.join(f'{x:.4f}' for x in runs[w]['losses'])}; "
                      f"step ms {' '.join(f'{x:.1f}' for x in runs[w]['step_ms'])}"
                      f"; rank 0 peak {runs[w]['peak_gib']:.2f} GiB, "
                      f"launches {runs[w]['launches']}; fit "
                      f"{runs[w]['wall_s']:.1f} s", flush=True)
    finally:
        rt.shutdown()
    one, many = runs[1]["losses"], runs[n]["losses"]
    diff = float(np.max(np.abs(np.array(many) - one) / np.abs(one)))
    ok = diff <= 2e-2
    print(f"world {n} against world 1: largest relative loss difference "
          f"{diff:.3e} (limit 2e-2); step ms (median) "
          f"{np.median(runs[n]['step_ms'][1:]):.1f} against "
          f"{np.median(runs[1]['step_ms'][1:]):.1f}", flush=True)
    print(json.dumps({"ok": ok, "world": n, "rel_loss_diff": diff,
                      "runs": {str(k): v for k, v in runs.items()}}))
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
