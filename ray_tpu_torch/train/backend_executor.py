"""Drives the worker gang through a training run.

Reference: python/ray/train/_internal/backend_executor.py:67 (start :129,
start_training :445); the port's copy of
``ray_tpu/train/backend_executor.py``. The executor owns the WorkerGroup,
applies backend hooks, fans the train loop out, and pumps synchronized
result batches — one TrainingResult per worker per report — back to the
trainer.

Elastic gangs (ScalingConfig.min_workers set): a worker death — actor
death, injected preemption, or a PreemptedError raised by the loop after
a maintenance SIGTERM — is a RESIZE EVENT, not a run failure. The
executor aborts survivors' in-flight collectives (CollectiveAbortedError
within ~ms instead of the 120 s op timeout), interrupts and drains the
surviving sessions, tears down only the lost ranks, re-forms the gang at
the new world size (new collective generation, compacted ranks,
re-sharded data), and restarts every rank's loop from the last
CONSISTENT checkpoint — the newest one that every rank completed — so
the loss curve is step-for-step deterministic versus an uninterrupted
run. A collective of the default process group (``TorchConfig(
distributed=True)``) is out of the abort's reach: a survivor blocked in
one unwinds when it fails (gloo, at once) or times out (NCCL), and a
loop error in an elastic gang whose peer turns out dead is a resize
too. When capacity returns (bounded by min/max workers and the grow
cooldown), the gang grows back through the same path.
"""

from __future__ import annotations

import logging
import os
import signal
import time
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.core.config import config
from ray_tpu_torch.exceptions import ActorDiedError, ActorUnavailableError, \
    GetTimeoutError, RayTpuError, WorkerCrashedError
from ray_tpu_torch.train.backend import Backend, BackendConfig
from ray_tpu_torch.train.config import ScalingConfig
from ray_tpu_torch.train.session import PreemptedError, TrainingResult
from ray_tpu_torch.train.worker_group import WorkerGroup

logger = logging.getLogger(__name__)

# How long a survivor gets to unwind (report in flight -> interrupt
# observed -> done sentinel) before the executor gives up and treats it
# as dead too. Generous: the normal path completes in milliseconds.
_DRAIN_TIMEOUT_S = 15.0
# How long a loop error in an elastic gang waits to learn whether a peer
# died (the runtime reports a death within milliseconds of the exit).
_PROBE_TIMEOUT_S = 5.0

_DEATH_ERRORS = (ActorDiedError, ActorUnavailableError, WorkerCrashedError)


class TrainingWorkerError(RayTpuError):
    """A training worker died or its train loop raised."""


class _GangResizeNeeded(Exception):
    """Internal: a harvest detected lost ranks in an elastic gang."""

    def __init__(self, dead: Dict[int, BaseException],
                 results: List[Optional[TrainingResult]],
                 pending_refs: Optional[Dict[int, Any]] = None):
        super().__init__(f"lost ranks {sorted(dead)}")
        self.dead = dead          # position -> underlying cause
        self.results = results    # partial harvest (per current position)
        # position -> the harvest's still-in-flight next_result ref. The
        # drain MUST consume these instead of issuing fresh calls: two
        # concurrent readers on one session would steal each other's
        # queue items (including the done sentinel).
        self.pending_refs = pending_refs or {}


class BackendExecutor:
    def __init__(self, backend_config: BackendConfig, scaling: ScalingConfig):
        self.backend_config = backend_config
        self.backend: Backend = backend_config.backend_cls()()
        self.scaling = scaling
        self.worker_group: Optional[WorkerGroup] = None
        # -------- elastic state --------
        self._spec: Optional[Dict[str, Any]] = None  # captured training spec
        self._batch_index = 0                 # harvested batches this run
        self._consistent_ckpts: List[str] = []  # full-batch ckpt paths
        self._ckpt_index_next = 0
        self._last_resize_t = 0.0
        self.elastic_stats: List[Dict[str, Any]] = []

    @property
    def _elastic(self) -> bool:
        return self.scaling.elastic

    @property
    def _min_workers(self) -> int:
        return self.scaling.min_workers or self.scaling.num_workers

    @property
    def _target_workers(self) -> int:
        # the PG bounds growth to its bundle count regardless; max_workers
        # beyond num_workers only takes effect for bundle-less gangs
        return self.scaling.max_workers or self.scaling.num_workers

    def start(self):
        self.worker_group = WorkerGroup(self.scaling)
        self.worker_group.start()
        # rank/world-size env before any user code or torch import
        for rank, w in enumerate(self.worker_group.workers):
            w.set_env.remote({
                "RAY_TPU_RANK": str(rank),
                "RAY_TPU_WORLD_SIZE": str(self.scaling.num_workers),
            })
        self.backend.on_start(self.worker_group, self.backend_config)

    def start_training(self, train_fn: Callable, config_dict: Dict[str, Any],
                       context_kwargs: Dict[str, Any],
                       checkpoint_path: Optional[str] = None,
                       dataset_shards: Optional[List[Dict[str, Any]]] = None,
                       storage_info: Optional[Dict[str, Any]] = None,
                       shard_fn: Optional[Callable] = None):
        assert self.worker_group is not None, "call start() first"
        self._spec = {
            "train_fn": train_fn,
            "config": config_dict,
            "context_kwargs": context_kwargs,
            "checkpoint_path": checkpoint_path,
            "storage_info": storage_info,
            "shard_fn": shard_fn,
        }
        self._ckpt_index_next = (storage_info or {}).get(
            "checkpoint_index_start", 0)
        self.backend.on_training_start(self.worker_group, self.backend_config)
        refs = []
        for rank, w in enumerate(self.worker_group.workers):
            shards = dataset_shards[rank] if dataset_shards else None
            refs.append(w.start_training.remote(
                train_fn, config_dict, context_kwargs, checkpoint_path,
                shards, storage_info))
        ray_tpu_torch.get(refs)

    # ------------------------------------------------------------ harvest
    def get_next_results(self) -> Optional[List[TrainingResult]]:
        """One synchronized batch: the next report from every worker.

        Returns None when all workers finished cleanly. Raises
        TrainingWorkerError when any worker errored (actor death or user
        exception), carrying the first underlying error. Elastic gangs
        absorb worker deaths/preemptions here by resizing and resuming;
        only a real user error, or shrinking below min_workers, raises.
        """
        assert self.worker_group is not None
        if not self._elastic:
            results = self._harvest()
            self._commit_batch(results)
            return results
        while True:
            self._maybe_grow()
            try:
                results = self._harvest()
            except _GangResizeNeeded as ev:
                self._resize(ev)
                continue
            self._commit_batch(results)
            return results

    def _commit_batch(self, results: Optional[List[TrainingResult]]):
        """Bookkeeping after a full-gang batch, then the chaos site."""
        if results is None:
            return
        idx = self._batch_index
        self._batch_index += 1
        ckpt_dirs = [r.checkpoint_dir for r in results if r.checkpoint_dir]
        if ckpt_dirs:
            # every rank reported this step: the persisted checkpoint is
            # CONSISTENT — a valid deterministic resume point
            self._consistent_ckpts.append(ckpt_dirs[0])
            self._ckpt_index_next += 1
        self._fire_gang_resize(str(idx))

    def _harvest(self) -> Optional[List[TrainingResult]]:
        wg = self.worker_group
        refs = [w.next_result.remote() for w in wg.workers]
        # Harvest as results land and FAIL FAST on the first error: when
        # one rank raises (user exception, PreemptedError after a
        # maintenance SIGTERM, actor death), its gang peers are typically
        # blocked inside a cross-process collective and will never report
        # — waiting for all refs would deadlock the driver. Non-elastic
        # teardown (executor.shutdown on the error path) unblocks them by
        # killing the group; elastic gangs unblock them via the
        # collective abort inside _resize.
        results: List[Optional[TrainingResult]] = [None] * len(refs)
        pending = list(refs)
        index = {r: i for i, r in enumerate(refs)}
        dead: Dict[int, BaseException] = {}
        while pending:
            done_refs, pending = ray_tpu_torch.wait(pending, num_returns=1)
            for k, ref in enumerate(done_refs):
                pos = index[ref]
                # refs the resize's drain must take over (everything not
                # consumed yet, minus the one that just failed)
                unharvested = {index[r]: r
                               for r in list(done_refs[k + 1:]) + pending}
                try:
                    res: TrainingResult = ray_tpu_torch.get(ref)
                except _DEATH_ERRORS as e:
                    if self._elastic:
                        dead[pos] = e
                        raise _GangResizeNeeded(dead, results, unharvested)
                    raise TrainingWorkerError(
                        f"training worker died: {e}") from e
                except Exception as e:
                    raise TrainingWorkerError(
                        f"training worker died: {e}") from e
                if res.error is not None:
                    if self._elastic and isinstance(res.error, PreemptedError):
                        # the loop checkpointed and bowed out; treat the
                        # rank as departed
                        dead[pos] = res.error
                        raise _GangResizeNeeded(dead, results, unharvested)
                    lost = self._dead_peers(pos) if self._elastic else {}
                    if lost:
                        # a peer's death failed this rank's collective
                        # before the runtime reported it (gloo fails at
                        # once): the loop has finished, nothing to drain
                        results[pos] = res
                        dead.update(lost)
                        raise _GangResizeNeeded(dead, results, {
                            p: r for p, r in unharvested.items()
                            if p not in lost})
                    raise TrainingWorkerError(
                        f"train loop failed on a worker: {res.error!r}"
                    ) from res.error
                results[pos] = res
        if all(r.done for r in results):
            return None
        # Mixed done/not-done means a worker returned early from its loop —
        # the remaining workers would deadlock on their next collective.
        if any(r.done for r in results):
            raise TrainingWorkerError(
                "some workers finished while others are still reporting — "
                "train_loop_per_worker must report the same number of times "
                "on every rank")
        return results

    def _dead_peers(self, pos: int) -> Dict[int, BaseException]:
        """The gang's workers other than ``pos`` that are dead, by
        position, probed with ``node_info`` (a spare concurrency slot
        answers it while ``next_result`` blocks)."""
        wg = self.worker_group
        probes = {p: w.node_info.remote() for p, w in enumerate(wg.workers)
                  if p != pos}
        lost: Dict[int, BaseException] = {}
        for p, ref in probes.items():
            try:
                ray_tpu_torch.get(ref, timeout=_PROBE_TIMEOUT_S)
            except _DEATH_ERRORS as e:
                lost[p] = e
            except GetTimeoutError:
                pass  # alive but busy: not known dead
        return lost

    # ------------------------------------------------------------- resize
    def _resize(self, ev: _GangResizeNeeded):
        """Shrink-and-continue: drop the lost ranks, re-form the gang at
        the new world size, resume from the last consistent checkpoint."""
        t0 = time.monotonic()
        wg = self.worker_group
        old_world = len(wg.workers)
        cause = ev.dead[min(ev.dead)]
        new_world = old_world - len(ev.dead)
        if new_world < self._min_workers:
            raise TrainingWorkerError(
                f"gang lost rank(s) {sorted(ev.dead)} and would shrink to "
                f"{new_world} < min_workers={self._min_workers}: {cause!r}"
            ) from cause
        reason = (f"gang resize: lost rank(s) {sorted(ev.dead)} "
                  f"({type(cause).__name__}), shrinking "
                  f"{old_world} -> {new_world}")
        logger.warning(reason)
        self._restart_gang(dead=set(ev.dead), partial=ev.results,
                           reason=reason, pending_refs=ev.pending_refs)
        self.elastic_stats.append({
            "event": "shrink",
            "old_world": old_world,
            "new_world": len(self.worker_group.workers),
            "cause": type(cause).__name__,
            "resume_s": time.monotonic() - t0,
        })

    def _maybe_grow(self):
        """Grow back toward the target world size when capacity returns.
        One probe per cooldown window: a replacement worker is created in
        a freed placement bundle; if it comes up, the gang restarts at
        the larger world size through the same resize path."""
        wg = self.worker_group
        target = self._target_workers
        if wg.pg is not None:
            # a placement group has exactly num_workers bundles; growth
            # beyond that has nowhere to land
            target = min(target, self.scaling.num_workers)
        if len(wg.workers) >= target:
            return
        now = time.monotonic()
        if now - self._last_resize_t < config.elastic_grow_cooldown_s:
            return
        self._last_resize_t = now
        t0 = time.monotonic()
        old_world = len(wg.workers)
        pos = wg.try_add_worker(config.elastic_grow_probe_timeout_s)
        if pos is None:
            return  # capacity has not returned; try again after cooldown
        reason = (f"gang resize: capacity returned, growing "
                  f"{old_world} -> {old_world + 1}")
        logger.info(reason)
        self._restart_gang(dead=set(), partial=None, reason=reason,
                           fresh={pos})
        self.elastic_stats.append({
            "event": "grow",
            "old_world": old_world,
            "new_world": len(self.worker_group.workers),
            "cause": None,
            "resume_s": time.monotonic() - t0,
        })

    def _restart_gang(self, dead: set, partial, reason: str,
                      fresh: Optional[set] = None,
                      pending_refs: Optional[Dict[int, Any]] = None):
        """Common resize machinery: abort collectives, interrupt + drain
        surviving sessions, drop dead ranks, re-rank, re-wire the
        backend at the new generation, and restart every loop from the
        last consistent checkpoint."""
        assert self._spec is not None, "start_training not called"
        wg = self.worker_group
        dead = set(dead)
        fresh = fresh or set()
        # 1. poison the old collective generation so blocked survivors
        #    fail over in ~one poll interval
        self.backend.abort_collectives(wg, reason)
        # 2. ask surviving sessions to unwind at their next boundary
        survivors = [(pos, w) for pos, w in enumerate(wg.workers)
                     if pos not in dead and pos not in fresh]
        for pos, w in survivors:
            w.interrupt_session.remote(reason)
        # 3. drain each survivor to its done sentinel; one that cannot
        #    unwind within the window is wedged — kill it and treat it
        #    as dead (never below min_workers: checked by callers for
        #    the planned dead set, re-checked here for escalations)
        pending_refs = pending_refs or {}
        for pos, w in survivors:
            if partial is not None and pos < len(partial) \
                    and partial[pos] is not None and partial[pos].done:
                continue  # loop already finished; nothing to drain
            if not self._drain_worker(w, pending_refs.get(pos)):
                logger.warning("worker at position %d failed to drain; "
                               "treating it as dead", pos)
                dead.add(pos)
        # 4. close the drained sessions SYNCHRONOUSLY — end_session must
        #    complete before the start_training below, and with
        #    max_concurrency > 1 actor calls are not ordered
        for pos, w in survivors:
            if pos in dead:
                continue
            try:
                ray_tpu_torch.get(w.end_session.remote())
            except _DEATH_ERRORS:
                dead.add(pos)  # died after draining; demote it too
        new_world = len(wg.workers) - len(dead)
        if new_world < self._min_workers:
            raise TrainingWorkerError(
                f"gang shrank to {new_world} < min_workers="
                f"{self._min_workers} while draining ({reason})")
        # 5. tear down only the lost ranks; bundles stay reserved
        wg.remove_positions(dead)
        # 6. new incarnation: bump generation, compact ranks, re-wire
        wg.generation += 1
        wg.reassign_ranks()
        self.backend.on_resize(wg, self.backend_config)
        # 7. resume every rank from the last consistent checkpoint with
        #    data re-sharded by the new (rank, world_size)
        resume = self._pick_resume_checkpoint()
        spec = self._spec
        n = len(wg.workers)
        shards = spec["shard_fn"](n) if spec["shard_fn"] else None
        storage_info = dict(spec["storage_info"] or {})
        if storage_info:
            storage_info["checkpoint_index_start"] = self._ckpt_index_next
        refs = []
        for rank, w in enumerate(wg.workers):
            refs.append(w.start_training.remote(
                spec["train_fn"], spec["config"], spec["context_kwargs"],
                resume, shards[rank] if shards else None,
                storage_info or None))
        ray_tpu_torch.get(refs)
        self._last_resize_t = time.monotonic()

    def _drain_worker(self, w, first_ref=None) -> bool:
        """Pump a survivor's results until its done sentinel. True when
        it unwound cleanly; False when it was wedged (killed here).

        Calls are strictly serialized, starting from the aborted
        harvest's still-in-flight next_result ref when there is one — a
        second concurrent reader on the same session would steal queue
        items (possibly the done sentinel itself) and strand the drain.
        """
        deadline = time.monotonic() + _DRAIN_TIMEOUT_S + \
            self.backend.unwind_timeout_s(self.backend_config)
        ref = first_ref if first_ref is not None else w.next_result.remote()
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                res = ray_tpu_torch.get(ref, timeout=remaining)
            except _DEATH_ERRORS:
                return False  # died while draining; caller demotes it
            except GetTimeoutError:
                break
            if res.done:
                return True
            ref = w.next_result.remote()
        try:
            ray_tpu_torch.kill(w)
        # rtpu-lint: disable=L4 — the wedged worker may have died on its
        # own in the window; kill is best-effort and the caller already
        # treats the worker as dead
        except Exception:
            pass
        return False

    def _pick_resume_checkpoint(self) -> Optional[str]:
        """Newest consistent checkpoint: walk the full-batch checkpoints
        newest-first, validating each manifest, and fall back to the
        run's original resume point when none survive."""
        from ray_tpu_torch.train.storage import validate_checkpoint_dir

        while self._consistent_ckpts:
            path = self._consistent_ckpts[-1]
            if validate_checkpoint_dir(path):
                return path
            logger.warning("checkpoint %s is torn/partial; falling back "
                           "to the previous one", path)
            self._consistent_ckpts.pop()
        return self._spec["checkpoint_path"] if self._spec else None

    # --------------------------------------------------------- chaos site
    def _fire_gang_resize(self, key: str):
        """Driver-side gang_resize fault site: after the matching batch
        commits, kill (SIGKILL) or preempt (SIGTERM) the highest-rank
        worker — the deterministic stand-in for a spot preemption."""
        from ray_tpu_torch.core import fault_injection

        if not fault_injection.enabled():
            return
        action = fault_injection.fire("gang_resize", key)
        if action is None:
            return
        wg = self.worker_group
        victim = wg.workers[-1]
        info = ray_tpu_torch.get(victim.node_info.remote())
        sig = signal.SIGKILL if action == "kill" else signal.SIGTERM
        logger.warning("gang_resize fault: sending %s to rank %d (pid %d) "
                       "after batch %s", sig.name, len(wg.workers) - 1,
                       info["pid"], key)
        os.kill(info["pid"], sig)

    def shutdown(self):
        if self.worker_group is not None:
            self.backend.on_shutdown(self.worker_group, self.backend_config)
            self.worker_group.shutdown()
            self.worker_group = None
