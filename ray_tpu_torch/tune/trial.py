"""Trial state + the trial actor hosting a function trainable.

Reference: python/ray/tune/experiment/trial.py (Trial FSM) and
tune/trainable/function_trainable.py — the user function runs on a thread
inside the trial actor; ``tune.report`` hands results over in lockstep
(the same pattern as the Train session, train/_internal/session.py:111).

The port's copy of ``ray_tpu/tune/trial.py``: the trial actor is the
port's (``trial_resources={"num_gpus": 1}`` makes it a GPU actor in a
worker of its own that sees its card as ``cuda:0``), and
``get_checkpoint`` returns the port's ``train.Checkpoint``.
"""

from __future__ import annotations

import enum
import os
import queue
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import ray_tpu_torch


class TrialStatus(str, enum.Enum):
    PENDING = "PENDING"
    RUNNING = "RUNNING"
    PAUSED = "PAUSED"
    TERMINATED = "TERMINATED"
    ERROR = "ERROR"


@dataclass
class Trial:
    """Driver-side record of one trial (reference: experiment/trial.py)."""

    trial_id: str
    config: Dict[str, Any]
    status: TrialStatus = TrialStatus.PENDING
    last_result: Dict[str, Any] = field(default_factory=dict)
    metric_history: list = field(default_factory=list)
    error: Optional[str] = None
    checkpoint_path: Optional[str] = None
    num_failures: int = 0
    iterations: int = 0
    resources: Optional[Dict[str, Any]] = None  # per-trial override
    actor: Any = None           # ActorHandle while running
    pending_result: Any = None  # in-flight ObjectRef from next_result

    @property
    def is_finished(self) -> bool:
        return self.status in (TrialStatus.TERMINATED, TrialStatus.ERROR)

    def snapshot(self) -> dict:
        return {
            "trial_id": self.trial_id,
            "config": self.config,
            "status": self.status.value,
            "last_result": self.last_result,
            "error": self.error,
            "checkpoint_path": self.checkpoint_path,
            "iterations": self.iterations,
            "num_failures": self.num_failures,
            "resources": self.resources,
        }

    @staticmethod
    def from_snapshot(snap: dict) -> "Trial":
        t = Trial(snap["trial_id"], snap["config"])
        t.status = TrialStatus(snap["status"])
        t.last_result = snap.get("last_result", {})
        t.error = snap.get("error")
        t.checkpoint_path = snap.get("checkpoint_path")
        t.iterations = snap.get("iterations", 0)
        t.num_failures = snap.get("num_failures", 0)
        t.resources = snap.get("resources")
        return t


# ---------------------------------------------------------------- sessions

# One TrialActor per worker process and one runner thread per actor, so a
# plain module global suffices (threading.local is unpicklable, and actor
# classes ship to workers by value).
_active_session: Optional["_TuneSession"] = None


class _TuneSession:
    def __init__(self, checkpoint_path: Optional[str], trial_dir: str):
        self.result_q: "queue.Queue" = queue.Queue(maxsize=1)
        self.consumed = threading.Semaphore(0)
        self.checkpoint_path = checkpoint_path
        self.trial_dir = trial_dir
        self.should_stop = False

    def report(self, metrics: Dict[str, Any],
               checkpoint_path: Optional[str] = None):
        self.result_q.put(("result", dict(metrics), checkpoint_path))
        self.consumed.acquire()
        if self.should_stop:
            raise StopTrial()


class StopTrial(Exception):
    """Raised inside the user fn when the scheduler stops the trial early."""


def report(metrics: Dict[str, Any], *, checkpoint=None):
    """In-trial API (reference: ray.tune.report / train.report in trials)."""
    s = _active_session
    if s is None:
        raise RuntimeError("tune.report() called outside a Tune trial")
    path = None
    if checkpoint is not None:
        path = checkpoint if isinstance(checkpoint, str) else \
            getattr(checkpoint, "path", None)
    s.report(metrics, checkpoint_path=path)


def get_checkpoint():
    """Latest checkpoint to resume from (None on fresh start)."""
    s = _active_session
    if s is None or s.checkpoint_path is None:
        return None
    from ray_tpu_torch.train.checkpoint import Checkpoint
    return Checkpoint(s.checkpoint_path)


def get_trial_dir() -> str:
    s = _active_session
    return s.trial_dir if s else ""


@ray_tpu_torch.remote
class TrialActor:
    """Hosts one function trainable; the controller polls next_result()."""

    def __init__(self, fn, config: Dict[str, Any], trial_dir: str,
                 checkpoint_path: Optional[str] = None):
        os.makedirs(trial_dir, exist_ok=True)
        self._session = _TuneSession(checkpoint_path, trial_dir)
        self._fn = fn
        self._config = config
        self._thread = None
        self._unacked = False

    def start(self):
        session = self._session

        def runner():
            # The actor class ships to workers pickled by value, giving it
            # a synthetic globals dict; user code calls tune.report via the
            # canonically imported module. Set the session THERE.
            import ray_tpu_torch.tune.trial as _trial_mod
            _trial_mod._active_session = session
            try:
                self._fn(self._config)
                session.result_q.put(("done", {}, None))
            except StopTrial:
                session.result_q.put(("stopped", {}, None))
            except BaseException as e:  # noqa: BLE001
                import traceback
                session.result_q.put(
                    ("error", {"error": repr(e),
                               "traceback": traceback.format_exc()}, None))

        self._thread = threading.Thread(target=runner, daemon=True,
                                        name="rtpt-tune-trial")
        self._thread.start()
        return True

    def ack_and_next(self, action: str = "continue"):
        """Acknowledge the previous result with ``action`` ('continue' |
        'stop'), then block for the next report.

        Actor calls execute serially, so stop cannot be a separate method —
        it would queue behind a blocked next_result. Instead the controller
        folds its scheduler decision into the next poll; when un-acked, the
        user fn is guaranteed parked inside report(), so flipping
        should_stop before releasing the semaphore is race-free.
        Returns (kind, metrics, ckpt_path)."""
        if self._unacked:
            if action == "stop":
                self._session.should_stop = True
            self._session.consumed.release()
            self._unacked = False
        kind, metrics, ckpt = self._session.result_q.get()
        self._unacked = kind == "result"
        return kind, metrics, ckpt
