"""Tensor-parallel serving: the engines' process group and command link.

The reference serves tensor-parallel with one process that owns every
chip of a mesh and lets GSPMD partition each jitted step. The port runs
one process per rank (one card each, or the CPU under gloo), every rank
running the same step on its weight shards
(``llama_decode.make_engine_fns(mesh=)``). Rank 0 is the engine the
caller talks to: its mailbox, admission, slot and page allocation,
prefix cache and stop tokens are host state no other rank holds. Before
each device call it broadcasts a small command (the call's name and its
host arguments) over a gloo group of its own, the control plane, so a
command never waits on the card; the other ranks, the followers, run the
same call on their shards and their own copy of the chain state, and
the step's collectives run over the default group (NCCL on cards).

Two ways in:

- ``LLMEngine(tp=N)`` without a mesh (``spawn``): the caller's process
  becomes rank 0 of a new group and starts ``N - 1`` follower processes
  (``spawn`` method), each on one device (``cuda:r``, or the CPU with
  ``device="cpu"``), joined through a ``FileStore`` in a temporary
  directory; ``shutdown()`` stops them and destroys the group.
- ``mesh=``: the caller already runs one process per rank in a group;
  every rank builds the engine with the same mesh, and every rank but 0
  runs the follower loop inside its constructor until rank 0 shuts down.

Rank 0 scatters its weights (``place_params``): each rank receives its
own shard, never a whole copy. Every device call goes out on the one
link, a disaggregated prefill worker's too: NCCL kernels wait on their
peers, so collectives issued in different orders on different ranks
deadlock, whichever communicators carry them. A follower that dies
makes rank 0's next device call raise ``TpGroupError`` (a liveness
check before every command, and the data group's collectives, which
fail on a closed peer or at ``TP_TIMEOUT_S``), and the engine fails its
requests and stops.
"""

from __future__ import annotations

import logging
import multiprocessing as mp
import os
import shutil
import tempfile
from datetime import timedelta
from typing import Any, Dict, List, Optional

import torch
import torch.distributed as dist

log = logging.getLogger(__name__)

# bound on a collective of the data group (and on the group's start): a
# follower that died or stalls fails rank 0's step within it
TP_TIMEOUT_S = 120.0
# followers wait for rank 0's next command as long as the engine idles
_CTL_TIMEOUT = timedelta(days=7)


class TpGroupError(RuntimeError):
    """The tensor-parallel group is broken: a follower exited or a
    collective failed. The engine cannot go on without it."""


class Link:
    """One rank's end of the engine's command channel over ``mesh``, which
    spans every rank of the default process group (built on every rank,
    in the same order: it creates the control group)."""

    def __init__(self, mesh, procs=(), tmpdir: Optional[str] = None):
        self.mesh = mesh
        self.rank = dist.get_rank()
        self.world = dist.get_world_size()
        if mesh.size() != self.world:
            raise ValueError(
                f"a serving mesh spans every rank of the process group: "
                f"the mesh has {mesh.size()} ranks, the group "
                f"{self.world}")
        self._ctl = (dist.new_group(backend="gloo", timeout=_CTL_TIMEOUT)
                     if self.world > 1 else None)
        self._procs = list(procs)
        self._tmpdir = tmpdir

    def share(self, obj: Any = None) -> Any:
        """Rank 0's ``obj`` on every rank."""
        if self._ctl is None:
            return obj
        box = [obj]
        dist.broadcast_object_list(box, src=0, group=self._ctl)
        return box[0]

    def check_alive(self) -> None:
        for r, p in enumerate(self._procs, 1):
            if p.exitcode is not None:
                raise TpGroupError(f"tensor-parallel follower rank {r} "
                                   f"exited with code {p.exitcode}")

    def send(self, op: str, args: tuple) -> None:
        """Rank 0: tell every follower to run ``op(*args)``."""
        self.check_alive()
        self.share((op, args))

    def recv(self) -> tuple:
        """A follower: the next ``(op, args)`` from rank 0."""
        return self.share()

    def close(self) -> None:
        """Rank 0: stop the followers (best effort when the group is
        broken), then release what ``spawn`` started: the group, the
        processes, the store's directory. A follower: release the
        control group. Rank 0 destroys its groups before it waits for
        the followers: NCCL's teardown is collective, so a follower's
        ``destroy_process_group`` returns only once rank 0 calls its
        own."""
        wait = 30.0
        if self.rank == 0 and self._ctl is not None:
            try:
                self.send("shutdown", ())
            except (RuntimeError, ValueError) as e:
                log.warning("tensor-parallel shutdown not delivered: %r", e)
                wait = 0.0
        if self._ctl is not None:
            try:
                dist.destroy_process_group(self._ctl)
            except (RuntimeError, ValueError):
                pass
            self._ctl = None
        if self._tmpdir is not None and dist.is_initialized():
            dist.destroy_process_group()
        for p in self._procs:
            p.join(timeout=wait)
        for p in self._procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        if self._tmpdir is not None:
            shutil.rmtree(self._tmpdir, ignore_errors=True)
            self._tmpdir = None


def spawn(engine_cls, tp: int, device: torch.device) -> Link:
    """Rank 0 of a new ``tp``-rank group in this process, with ``tp - 1``
    followers of ``engine_cls`` started on the other devices (the caller
    has checked that the process holds no group and, on CUDA, that there
    are ``tp`` cards)."""
    from ray_tpu_torch.parallel import MeshSpec, build_mesh
    from ray_tpu_torch.parallel.mesh import init_process_group

    if device.type == "cuda":
        others = [torch.device("cuda", i)
                  for i in range(torch.cuda.device_count())
                  if i != device.index]
        devices = [device] + others[:tp - 1]
    else:
        devices = [device] * tp
    tmpdir = tempfile.mkdtemp(prefix="rtpu_tp_")
    store = os.path.join(tmpdir, "store")
    ctx = mp.get_context("spawn")
    procs: List[Any] = [
        ctx.Process(target=_follower_main,
                    args=(engine_cls, r, tp, store, str(devices[r])),
                    daemon=True, name=f"tp-follower-{r}")
        for r in range(1, tp)]
    try:
        for p in procs:
            p.start()
        init_process_group(0, tp, device, store_path=store,
                           timeout=timedelta(seconds=TP_TIMEOUT_S))
        return Link(build_mesh(MeshSpec({"tp": tp})), procs, tmpdir)
    except BaseException:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(timeout=10)
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(tmpdir, ignore_errors=True)
        raise


def _follower_main(engine_cls, rank: int, world: int, store: str,
                   device: str) -> None:
    from ray_tpu_torch.parallel import MeshSpec, build_mesh
    from ray_tpu_torch.parallel.mesh import init_process_group

    if device == "cpu":
        # the ranks share the host's cores
        torch.set_num_threads(1)
    init_process_group(rank, world, device, store_path=store,
                       timeout=timedelta(seconds=TP_TIMEOUT_S))
    try:
        # a follower's constructor runs the follower loop to shutdown
        engine_cls(mesh=build_mesh(MeshSpec({"tp": world})), device=device)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


def _set(tree: Dict, path: str, value) -> None:
    *head, last = path.split(".")
    for k in head:
        tree = tree.setdefault(k, {})
    tree[last] = value


def rank_block(full: torch.Tensor, sharding, rank: int) -> torch.Tensor:
    """``rank``'s block of ``full`` under ``sharding`` (a view): the
    Shard dims narrowed by the rank's mesh coordinates, outer axes
    first, as DTensor and the reference chunk them."""
    mesh = sharding.mesh
    coord = (mesh.mesh == rank).nonzero()[0].tolist()
    for i, pl in enumerate(sharding.placements):
        if pl.is_shard():
            n = mesh.size(i)
            size = full.shape[pl.dim]
            if size % n:
                raise ValueError(
                    f"dim {pl.dim} of {tuple(full.shape)} does not split "
                    f"over axis {mesh.mesh_dim_names[i]!r} of size {n}")
            full = full.narrow(pl.dim, coord[i] * (size // n), size // n)
    return full


def place_params(params: Optional[Dict], shardings: Dict, link: Link,
                 device: torch.device) -> Dict:
    """DTensors placed by ``shardings`` from rank 0's whole ``params``
    (other ranks pass None): rank 0 scatters each leaf's shards, so every
    rank receives its own block and no rank a whole copy; a leaf no axis
    shards is broadcast. At world size 1 the leaves are wrapped as they
    are (no copy)."""
    from torch.distributed.tensor import DTensor

    rank0 = link.rank == 0
    flat = dict(_leaves(params)) if rank0 else {}
    meta = link.share({p: (tuple(v.shape), v.dtype) for p, v in
                       flat.items()} if rank0 else None)
    out: Dict = {}
    for path, sh in _leaves(shardings):
        shape, dtype = meta[path]
        if link.world == 1:
            local = flat[path].to(device)
        else:
            full = flat.pop(path).to(device) if rank0 else None
            split = any(pl.is_shard() for pl in sh.placements)
            if split:
                blocks = ([rank_block(full, sh, r).contiguous()
                           for r in range(link.world)] if rank0 else None)
                local_shape = (blocks[0].shape if rank0 else
                               rank_block(torch.empty(shape, device="meta"),
                                          sh, link.rank).shape)
                local = torch.empty(local_shape, dtype=dtype, device=device)
                dist.scatter(local, blocks, src=0)
            else:
                local = (full.clone() if rank0 else
                         torch.empty(shape, dtype=dtype, device=device))
                dist.broadcast(local, src=0)
        _set(out, path, DTensor.from_local(local, sh.mesh, sh.placements,
                                           run_check=False))
    return out
