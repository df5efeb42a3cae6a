"""Gang of training worker actors placed in a placement group.

Reference: python/ray/train/_internal/worker_group.py:102 (WorkerGroup) and
backend_executor.py:67. The port's copy of ``ray_tpu/train/worker_group.py``:
one actor per worker; a GPU worker (``ScalingConfig(use_gpu=True)``) is an
actor with ``num_gpus=gpus_per_worker``, which the runtime gives a worker
process of its own, cold-spawned with ``CUDA_VISIBLE_DEVICES`` naming its
cards. Each such worker sees its first card as ``cuda:0`` whatever its
rank.
"""

from __future__ import annotations

import os
import socket
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.core.config import config
from ray_tpu_torch.core.placement_group import PlacementGroup, placement_group, \
    placement_group_table, remove_placement_group
from ray_tpu_torch.core.scheduling_strategies import PlacementGroupSchedulingStrategy
from ray_tpu_torch.exceptions import PlacementGroupError
from ray_tpu_torch.train import session as session_mod
from ray_tpu_torch.train.config import ScalingConfig
from ray_tpu_torch.train.session import TrainContext, TrainingResult, _TrainSession


class _TrainWorker:
    """The actor class hosting one training worker."""

    def __init__(self, rank: int, world_size: int):
        self.rank = rank
        self.world_size = world_size
        self.session: Optional[_TrainSession] = None

    # --------------------------------------------------------- bookkeeping
    def node_info(self) -> Dict[str, Any]:
        return {
            "hostname": socket.gethostname(),
            "pid": os.getpid(),
            "rank": self.rank,
            "gpu_ids": os.environ.get("RTPU_GPU_IDS"),
        }

    def set_env(self, env: Dict[str, str]):
        os.environ.update(env)

    def update_rank(self, rank: int, world_size: int):
        """Re-address this worker after an elastic resize (ranks compact
        to 0..new_world-1). Takes effect for the NEXT session; the env
        mirrors what set_env wrote at gang start."""
        self.rank = rank
        self.world_size = world_size
        os.environ["RAY_TPU_RANK"] = str(rank)
        os.environ["RAY_TPU_WORLD_SIZE"] = str(world_size)

    def interrupt_session(self, reason: str) -> bool:
        """Driver-side resize entry point. Runs on a spare concurrency
        slot (the actor is created with max_concurrency > 1) so it can
        overtake a next_result call blocked on the result queue."""
        if self.session is None:
            return False
        self.session.interrupt(reason)
        return True

    def execute(self, fn: Callable, *args, **kwargs):
        """Run an arbitrary function in the worker process (backend hooks)."""
        return fn(*args, **kwargs)

    # ----------------------------------------------------------- training
    def start_training(self, train_fn: Callable, config: Dict[str, Any],
                       context_kwargs: Dict[str, Any],
                       checkpoint_path: Optional[str],
                       dataset_shards: Optional[Dict[str, Any]] = None,
                       storage_info: Optional[Dict[str, Any]] = None):
        from ray_tpu_torch.train.checkpoint import Checkpoint
        from ray_tpu_torch.train.storage import StorageContext

        ctx = TrainContext(world_rank=self.rank, world_size=self.world_size,
                           local_rank=self.rank, local_world_size=self.world_size,
                           **context_kwargs)
        ckpt = Checkpoint(checkpoint_path) if checkpoint_path else None
        storage = None
        ckpt_start = 0
        if storage_info:
            storage = StorageContext(storage_info["storage_path"],
                                     storage_info["experiment_name"],
                                     storage_info["trial_name"])
            ckpt_start = storage_info.get("checkpoint_index_start", 0)
        self.session = _TrainSession(train_fn, config or {}, ctx,
                                     checkpoint=ckpt,
                                     dataset_shards=dataset_shards,
                                     storage=storage,
                                     checkpoint_index_start=ckpt_start)
        session_mod._set_session(self.session)
        self.session.start()

    def next_result(self) -> TrainingResult:
        assert self.session is not None, "start_training not called"
        return self.session.next_result()

    def end_session(self):
        session_mod._set_session(None)
        self.session = None


class WorkerGroup:
    """Creates and addresses the gang.

    Elastic bookkeeping: ``bundle_indices[i]`` is the placement-group
    bundle worker ``i`` occupies — on a shrink the dead worker's bundle
    is released by the runtime and stays reserved in the PG, so a later
    grow re-creates a worker into the freed bundle. ``generation``
    counts resizes; the collective layer uses it to name each
    incarnation's coordinator.
    """

    def __init__(self, scaling: ScalingConfig):
        self.scaling = scaling
        self.pg: Optional[PlacementGroup] = None
        self.workers: List[Any] = []
        self.bundle_indices: List[int] = []
        self.generation = 0

    def _worker_options(self, bundle_index: Optional[int]) -> Dict[str, Any]:
        # max_concurrency=4: interrupt_session/node_info must be able to
        # overtake a next_result call blocked on the session queue during
        # an elastic resize. trap_sigterm: maintenance SIGTERMs become
        # the train.preempted() flag, installed on the worker's MAIN
        # thread at actor creation (actor calls run on pool threads,
        # which may not set signal handlers).
        opts: Dict[str, Any] = {"max_restarts": 0, "max_concurrency": 4,
                                "trap_sigterm": True}
        if self.pg is not None and bundle_index is not None:
            opts["scheduling_strategy"] = PlacementGroupSchedulingStrategy(
                placement_group=self.pg,
                placement_group_bundle_index=bundle_index)
            opts["num_cpus"] = self.scaling.num_cpus_per_worker
        if self.scaling.use_gpu:
            # a GPU actor: its own worker, CUDA_VISIBLE_DEVICES set at spawn
            opts["num_gpus"] = self.scaling.gpus
        return opts

    def _unsatisfiable_detail(self, bundles: List[Dict[str, float]]) -> str:
        """Name the first bundle the node cannot currently satisfy (the
        local branch of ``ray_tpu/state.py``'s resource views: the port's
        state module comes with cluster mode)."""
        from ray_tpu_torch.core import runtime_context

        reason = None
        if self.pg is not None:
            entry = placement_group_table().get(self.pg.id.hex()) or {}
            reason = entry.get("infeasible_reason")
        if reason:
            return reason
        try:
            res = runtime_context.get_core().state_summary()["resources"]
            avail, total = res["available"], res["total"]
        except (RuntimeError, KeyError):
            avail = total = {}
        for i, b in enumerate(bundles):
            short = {k: v for k, v in b.items()
                     if v > total.get(k, 0.0)} if total else {}
            if short:
                return (f"bundle {i} {b} exceeds the node's total "
                        f"resources (have {total})")
            short = {k: v for k, v in b.items()
                     if v > avail.get(k, 0.0)} if avail else {}
            if short:
                return (f"bundle {i} {b} cannot be satisfied from "
                        f"available resources {avail}")
        return (f"bundle {bundles[0]} x{len(bundles)} "
                f"({self.scaling.placement_strategy}) is not placeable")

    def start(self):
        n = self.scaling.num_workers
        bundles = [self.scaling.bundle_for_worker() for _ in range(n)]
        if any(bundles[0].values()):
            timeout_s = config.train_pg_ready_timeout_s
            self.pg = placement_group(bundles, strategy=self.scaling.placement_strategy)
            if not self.pg.wait(timeout_seconds=timeout_s):
                detail = self._unsatisfiable_detail(bundles)
                pg, self.pg = self.pg, None
                try:
                    remove_placement_group(pg)
                # rtpu-lint: disable=L4 — best-effort teardown of a PG
                # that never became ready; the PlacementGroupError below
                # carries the actual failure
                except Exception:
                    pass
                raise PlacementGroupError(
                    f"placement group for {n} training workers not ready "
                    f"within {timeout_s:g}s (train_pg_ready_timeout_s): "
                    f"{detail}")
        worker_cls = ray_tpu_torch.remote(_TrainWorker)
        self.workers = []
        self.bundle_indices = []
        for rank in range(n):
            idx = rank if self.pg is not None else None
            self.workers.append(
                worker_cls.options(**self._worker_options(idx)).remote(rank, n))
            self.bundle_indices.append(rank)

    # ------------------------------------------------------ elastic resize
    def remove_positions(self, positions) -> None:
        """Drop (already-dead or killed) workers from the gang; their PG
        bundles stay reserved for a later grow."""
        doomed = set(positions)
        for pos in doomed:
            try:
                ray_tpu_torch.kill(self.workers[pos])
            # rtpu-lint: disable=L4 — the worker is usually already dead
            # (that is why it is being removed); kill is best-effort
            except Exception:
                pass
        self.workers = [w for i, w in enumerate(self.workers)
                        if i not in doomed]
        self.bundle_indices = [b for i, b in enumerate(self.bundle_indices)
                               if i not in doomed]

    def try_add_worker(self, probe_timeout_s: float):
        """Grow by one: create a worker in a freed placement bundle and
        probe it. Returns the new worker position, or None when capacity
        has not returned (the probe actor is killed)."""
        from ray_tpu_torch.exceptions import ActorDiedError, ActorUnavailableError, \
            GetTimeoutError

        free = [i for i in range(self.scaling.num_workers)
                if i not in self.bundle_indices]
        if self.pg is not None and not free:
            return None
        idx = free[0] if free else None
        worker_cls = ray_tpu_torch.remote(_TrainWorker)
        w = worker_cls.options(**self._worker_options(idx)).remote(
            len(self.workers), len(self.workers) + 1)
        try:
            ray_tpu_torch.get(w.node_info.remote(), timeout=probe_timeout_s)
        except (GetTimeoutError, ActorDiedError, ActorUnavailableError):
            try:
                ray_tpu_torch.kill(w)
            # rtpu-lint: disable=L4 — probe actor may never have been
            # scheduled; kill is best-effort cleanup
            except Exception:
                pass
            return None
        self.workers.append(w)
        self.bundle_indices.append(idx if idx is not None else len(self.bundle_indices))
        return len(self.workers) - 1

    def reassign_ranks(self) -> None:
        """Compact ranks to 0..len-1 after a resize (rank order is
        preserved for survivors, new workers take the tail)."""
        n = len(self.workers)
        ray_tpu_torch.get([w.update_rank.remote(i, n)
                     for i, w in enumerate(self.workers)])

    def execute(self, fn: Callable, *args, **kwargs) -> List[Any]:
        """Run fn on every worker, return all results (ordered by rank)."""
        return ray_tpu_torch.get([w.execute.remote(fn, *args, **kwargs)
                            for w in self.workers])

    def execute_single(self, rank: int, fn: Callable, *args, **kwargs) -> Any:
        return ray_tpu_torch.get(self.workers[rank].execute.remote(fn, *args, **kwargs))

    def execute_async(self, fn: Callable, *args, **kwargs):
        return [w.execute.remote(fn, *args, **kwargs) for w in self.workers]

    def __len__(self):
        return len(self.workers)

    def shutdown(self):
        for w in self.workers:
            try:
                ray_tpu_torch.kill(w)
            # rtpu-lint: disable=L4 — teardown: workers may already be
            # dead (preempted/killed); nothing to recover
            except Exception:
                pass
        self.workers = []
        self.bundle_indices = []
        if self.pg is not None:
            try:
                remove_placement_group(self.pg)
            # rtpu-lint: disable=L4 — teardown: the PG may already be
            # removed (failed start path); nothing to recover
            except Exception:
                pass
            self.pg = None
