"""Sharded checkpoints on ``torch.distributed.checkpoint``.

Counterpart of ``ray_tpu/train/orbax_checkpoint.py``. Each rank writes
only the shards it owns: a DTensor leaf (placed, say, by
``parallel.sharding``'s rules) writes its local shard, and a leaf every
rank holds alike (a plain tensor, a replicated DTensor) is written once.
``restore`` lays the tree out by ``like``: DTensor leaves load their
local shard whatever mesh saved the checkpoint, and however many
processes, so a 4-process gang's checkpoint restores onto a 2-process
mesh unchanged (the property the reference's docstring states).

    from ray_tpu_torch.train import dist_checkpoint as dc

    dc.save(step_dir, {"params": params, "opt": opt_state, "step": 7})
    state = dc.restore(step_dir, like={"params": params_like, ...})

``save`` is collective when a process group is initialized: every rank
of the default group calls it with its shards. Without one it runs in
this process alone. Leaves that are not tensors (``"step": 7``) are
pickled and come back as they were.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Optional

import torch
import torch.distributed as dist
import torch.distributed.checkpoint as dcp


def _grouped() -> bool:
    return dist.is_available() and dist.is_initialized()


def save(path: str, state: Any, *, force: bool = True) -> str:
    """Write ``state`` (nested dicts and lists of tensors, DTensors and
    other picklable leaves). ``force`` overwrites an existing checkpoint
    (rank 0 clears the directory, then every rank meets at a barrier);
    without it an existing path raises ``FileExistsError``. Returns the
    absolute checkpoint path."""
    path = os.path.abspath(path)
    grouped = _grouped()
    if os.path.exists(path) and not force:
        raise FileExistsError(f"checkpoint {path} exists; pass force=True "
                              f"to overwrite it")
    if force and (not grouped or dist.get_rank() == 0):
        shutil.rmtree(path, ignore_errors=True)
    if grouped:
        dist.barrier()
    dcp.save(state, checkpoint_id=path, no_dist=not grouped)
    return path


def restore(path: str, like: Optional[Any] = None) -> Any:
    """Read a checkpoint. With ``like`` (a tree of tensors and DTensors,
    the target layout, with a placeholder for each other leaf), the
    values are loaded INTO ``like``'s tensors, each DTensor its local
    shard (resharded from whatever mesh saved it), and ``like`` is
    returned with its other leaves replaced by the saved ones; a subtree
    of the checkpoint may be asked for alone. Collective when ``like``
    holds DTensors. Without ``like`` this process reads the whole tree
    as plain CPU tensors."""
    path = os.path.abspath(path)
    if like is not None:
        dcp.load(like, checkpoint_id=path, no_dist=not _grouped())
        return like
    md = dcp.FileSystemReader(path).read_metadata()
    flat = {fqn: (torch.empty(m.size, dtype=m.properties.dtype)
                  if hasattr(m, "size") else None)
            for fqn, m in md.state_dict_metadata.items()}
    dcp.load(flat, checkpoint_id=path, no_dist=True)
    # the save planner records each flat key's path in the tree
    paths = md.planner_data or {}
    tree: dict = {}
    for fqn, value in flat.items():
        _set(tree, paths.get(fqn, (fqn,)), value)
    return _lists(tree)


def _set(tree: dict, path, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def _lists(tree):
    """Dicts keyed 0..n-1 by the planner's list indices back to lists."""
    if not isinstance(tree, dict):
        return tree
    out = {k: _lists(v) for k, v in tree.items()}
    if out and all(isinstance(k, int) for k in out) \
            and sorted(out) == list(range(len(out))):
        return [out[i] for i in range(len(out))]
    return out
