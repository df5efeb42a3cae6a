"""In-training-loop session: report/get_checkpoint/get_context.

Reference: python/ray/train/_internal/session.py (_TrainSession :111,
report :667, get_checkpoint :754). The user loop runs on a thread inside the
worker actor; ``report`` hands a result to the actor thread and blocks in
lockstep until the driver has consumed it — that keeps all workers advancing
step-for-step, which matters where every member of a process group must
enter the same collective together.

The port's copy of ``ray_tpu/train/session.py``. ``TrainContext``'s
``local_rank`` is the gang rank, as in the reference; a GPU worker sees
the card it holds as ``cuda:0`` whatever its rank (the backend makes it
the current device), so code picks its card with
``torch.cuda.current_device()``, never ``local_rank``.
"""

from __future__ import annotations

import os
import queue
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

from ray_tpu_torch.train.checkpoint import Checkpoint

_session: Optional["_TrainSession"] = None
_session_lock = threading.Lock()


@dataclass
class TrainingResult:
    metrics: Dict[str, Any]
    checkpoint_dir: Optional[str] = None   # worker-local dir to persist
    done: bool = False
    error: Optional[BaseException] = None


@dataclass
class TrainContext:
    """What a worker knows about its place in the gang (reference:
    ray.train.get_context() → TrainContext)."""

    world_size: int = 1
    world_rank: int = 0
    local_rank: int = 0
    local_world_size: int = 1
    node_rank: int = 0
    trial_name: str = ""
    experiment_name: str = ""
    trial_dir: str = ""
    metadata: Dict[str, Any] = field(default_factory=dict)

    def get_world_size(self) -> int:
        return self.world_size

    def get_world_rank(self) -> int:
        return self.world_rank

    def get_local_rank(self) -> int:
        return self.local_rank

    def get_local_world_size(self) -> int:
        return self.local_world_size

    def get_node_rank(self) -> int:
        return self.node_rank

    def get_trial_name(self) -> str:
        return self.trial_name

    def get_experiment_name(self) -> str:
        return self.experiment_name

    def get_trial_dir(self) -> str:
        return self.trial_dir


class SessionInterruptedError(BaseException):
    """Raised inside the user train loop when the driver interrupts the
    session (gang resize: a peer died or the gang is growing back). A
    BaseException on purpose: a user loop's ``except Exception`` must not
    swallow the interrupt — the loop is being unwound so the worker can
    rejoin at the new world size and resume from the last consistent
    checkpoint."""


class _TrainSession:
    """Pumps results from the user training thread to the actor thread.

    Checkpoint persistence happens HERE, worker-side, inside ``report`` —
    before the result is handed to the driver — because the worker-local
    checkpoint dir may be temporary and, on multi-node, not reachable from
    the driver at all (reference: storage upload in train/_internal/
    session.py report path).
    """

    def __init__(self, train_fn, config: Dict[str, Any], context: TrainContext,
                 checkpoint: Optional[Checkpoint] = None,
                 dataset_shards: Optional[Dict[str, Any]] = None,
                 storage=None, checkpoint_index_start: int = 0,
                 checkpoint_upload_rank: Optional[int] = 0):
        self.context = context
        self.loaded_checkpoint = checkpoint
        self.dataset_shards = dataset_shards or {}
        self.storage = storage
        self._ckpt_index = checkpoint_index_start
        self._ckpt_upload_rank = checkpoint_upload_rank
        self._result_q: "queue.Queue[TrainingResult]" = queue.Queue(maxsize=1)
        self._consumed = threading.Semaphore(0)
        self._finished = False
        self._interrupted: Optional[str] = None

        def runner():
            try:
                train_fn(config) if _wants_config(train_fn) else train_fn()
                self._result_q.put(TrainingResult(metrics={}, done=True))
            except BaseException as e:  # surfaced to the driver, not swallowed
                # Includes SessionInterruptedError: the queue may still
                # hold the result the interrupt overtook, but the driver
                # drains every queued result until it sees this done
                # sentinel, so the blocking put always completes — and
                # the sentinel is never dropped.
                self._result_q.put(
                    TrainingResult(metrics={}, done=True, error=e))

        self._thread = threading.Thread(target=runner, daemon=True,
                                        name="rtpt-train-loop")

    def start(self):
        self._thread.start()

    # --------------------------------------------- called by the driver
    # (via _TrainWorker.interrupt_session, on the actor's second
    # concurrency slot while next_result may be blocked on the first)
    def interrupt(self, reason: str = "gang resize"):
        """Ask the train loop to unwind at its next report boundary.

        Protocol: set the flag, then release one ``_consumed`` token so a
        loop blocked in lockstep (report() waiting for the driver) wakes
        up and observes the flag. A loop blocked inside a collective is
        unblocked separately by the coordinator abort. The driver must
        keep calling ``next_result`` (draining) until it sees a ``done``
        result — in-flight reports complete normally before the loop
        raises SessionInterruptedError."""
        self._interrupted = reason
        self._consumed.release()

    # ------------------------------------------------- called by train_fn
    def report(self, metrics: Dict[str, Any],
               checkpoint_dir: Optional[str] = None):
        if self._interrupted is not None:
            raise SessionInterruptedError(self._interrupted)
        persisted = None
        if checkpoint_dir is not None:
            if (self.storage is not None
                    and (self._ckpt_upload_rank is None
                         or self.context.world_rank == self._ckpt_upload_rank)):
                ckpt = self.storage.persist_checkpoint_dir(
                    checkpoint_dir, self._ckpt_index)
                persisted = ckpt.path
            self._ckpt_index += 1
        self._result_q.put(TrainingResult(metrics=dict(metrics),
                                          checkpoint_dir=persisted))
        # Lockstep: wait until the driver consumed this result before the
        # training loop continues (mirrors reference's blocking report).
        self._consumed.acquire()
        if self._interrupted is not None:
            raise SessionInterruptedError(self._interrupted)

    # --------------------------------------------------- called by driver
    def next_result(self, timeout: Optional[float] = None) -> TrainingResult:
        res = self._result_q.get(timeout=timeout)
        if res.done:
            self._finished = True
        else:
            self._consumed.release()
        return res

    def finished(self) -> bool:
        return self._finished


# ------------------------------------------------------------ public API

def _get_session() -> _TrainSession:
    if _session is None:
        raise RuntimeError(
            "No train session active — this API must be called inside a "
            "train_loop_per_worker launched by a Trainer.")
    return _session


def _set_session(s: Optional[_TrainSession]):
    global _session
    _session = s


# ---- preemption (maintenance events arrive as SIGTERM) ---------------------

_preempt_event = threading.Event()


class PreemptedError(RuntimeError):
    """Raised by a train loop that observed preemption (after saving its
    checkpoint). The trainer treats it as a gang-restart signal that does
    NOT consume the failure budget — preemptions are scheduled events,
    not faults (reference analogue: spot/maintenance handling in
    cluster autoscaling; cloud VMs get maintenance events as SIGTERM
    with a grace window)."""


def _core_preempt_event():
    """The worker-process-level preemption flag, when running inside a
    runtime worker (set by the SIGTERM handler that trap_sigterm actors
    install at creation — see core/worker_proc.py). None driver-side."""
    from ray_tpu_torch.core import runtime_context

    core = runtime_context.get_core_or_none()
    return getattr(core, "preempted", None)


def preempted() -> bool:
    """True once a preemption signal (SIGTERM) reached this worker.
    Poll at step boundaries: save a checkpoint, then raise
    PreemptedError so the gang restarts cleanly on fresh resources."""
    if _preempt_event.is_set():
        return True
    ev = _core_preempt_event()
    return ev is not None and ev.is_set()


def _flag_preemption():
    """Mark this worker preempted (what the SIGTERM handler does; also
    the hook for environments that deliver maintenance events through a
    channel other than signals)."""
    _preempt_event.set()


def _install_preemption_handler():
    """Worker-side: arm the SIGTERM→flag route for a (new or resized)
    gang incarnation. The actual signal handler lives in the worker
    process's main thread, installed at actor creation for trap_sigterm
    actors (core/worker_proc.py) — actor calls run on pool threads when
    max_concurrency > 1 and may not set signal handlers themselves, so
    this call only CLEARS stale flags: a preemption observed by a
    previous gang on a reused process must not re-fire, while a SIGTERM
    landing after this point must stick. In-process sessions (driver-
    side unit tests) get a best-effort direct install instead."""
    import signal

    _preempt_event.clear()
    ev = _core_preempt_event()
    if ev is not None:
        ev.clear()
    # Only the main thread may install handlers (CPython rule). On a
    # pool thread the process-level handler installed at actor creation
    # (core/worker_proc.py) owns the SIGTERM route — skip explicitly
    # rather than swallow the ValueError, which is how the original
    # never-armed bug stayed invisible.
    if threading.current_thread() is threading.main_thread():
        signal.signal(signal.SIGTERM, lambda signum, frame:
                      _flag_preemption())


def report(metrics: Dict[str, Any], checkpoint: Optional[Checkpoint] = None,
           *, checkpoint_dir: Optional[str] = None):
    """Report metrics (and optionally a just-written checkpoint dir) to the
    driver. Blocks until the driver has processed the result."""
    s = _get_session()
    if checkpoint is not None and checkpoint_dir is None:
        checkpoint_dir = checkpoint.path
    s.report(metrics, checkpoint_dir=checkpoint_dir)


def get_checkpoint() -> Optional[Checkpoint]:
    """The latest persisted checkpoint to resume from (None on fresh start)."""
    return _get_session().loaded_checkpoint


def get_context() -> TrainContext:
    s = _session
    return s.context if s is not None else TrainContext()


def get_dataset_shard(name: str = "train"):
    """This worker's shard of a dataset passed to the Trainer
    (reference: ray.train.get_dataset_shard)."""
    return _get_session().dataset_shards.get(name)


def _wants_config(fn) -> bool:
    import inspect

    try:
        return len(inspect.signature(fn).parameters) >= 1
    except (TypeError, ValueError):
        return False
