"""Test helper: run a function on N ranks, one spawned process each, the
CPU stand-in for N cards (the reference's tests use N virtual XLA CPU
devices).

``run_ranks(fn, n, *args, store_dir=..., timeout_s=...)`` starts ``n``
processes with the ``spawn`` method; each joins a gloo process group
through a ``FileStore`` in ``store_dir`` (no network port), runs
``fn(rank, n, *args)`` and sends back its result, which must pickle.
The results come back in rank order. When any rank raises, or the
whole launch outlasts ``timeout_s``, every rank is killed and the call
raises with the failing rank's traceback: a rank left waiting in a
collective whose peer died would otherwise hang forever.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue as queue_mod
import time
import traceback
from typing import Any, Callable, List


def _rank_main(fn, rank, world_size, store_path, args, out) -> None:
    import torch
    import torch.distributed as dist

    from ray_tpu_torch.parallel.mesh import init_process_group

    # n ranks share the host's cores; one thread each keeps them from
    # oversubscribing it
    torch.set_num_threads(1)
    try:
        init_process_group(rank, world_size, "cpu", store_path=store_path)
        out.put((rank, True, fn(rank, world_size, *args)))
    except BaseException:  # reported to the parent, which kills the rest
        out.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn: Callable, world_size: int, *args: Any, store_dir: str,
              timeout_s: float = 120.0) -> List[Any]:
    """``[fn(r, world_size, *args) for r in range(world_size)]``, each in
    its own process of one gloo group. ``fn`` must be importable by name
    (a module-level function)."""
    os.makedirs(store_dir, exist_ok=True)
    store_path = os.path.join(store_dir, f"store_{os.getpid()}_"
                              f"{time.monotonic_ns()}")
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world_size, store_path, args, out),
                         daemon=True)
             for r in range(world_size)]
    for p in procs:
        p.start()
    results: dict = {}
    deadline = time.monotonic() + timeout_s
    try:
        while len(results) < world_size:
            left = deadline - time.monotonic()
            if left <= 0:
                missing = sorted(set(range(world_size)) - set(results))
                raise TimeoutError(
                    f"ranks {missing} of {world_size} gave no result in "
                    f"{timeout_s:.0f} s")
            try:
                rank, ok, value = out.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in results]
                if dead:
                    raise RuntimeError(
                        f"rank {dead[0]} exited with code "
                        f"{procs[dead[0]].exitcode} and no result")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            results[rank] = value
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join(timeout=10)
        out.close()
    return [results[r] for r in range(world_size)]
