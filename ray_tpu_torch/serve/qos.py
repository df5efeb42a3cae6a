"""Serving QoS primitives: priority classes, tiered depth limits, and
the TTFT wait estimator behind deadline admission.

The port's copy of ``ray_tpu/serve/qos.py``.

Reference shape: the reference's proxy/router tier has no first-class
admission control (requests queue unboundedly per replica scheduler);
the priority/deadline/shedding design here follows the overload
literature instead — tiered thresholds so lower classes shed strictly
earlier (the classic "graceful degradation" knee), and an EWMA of
observed time-to-first-token as the wait estimator for deadline-based
admission (an SLO-feasibility check at the door, not a timeout deep in
the engine).

Everything in this module is pure/process-local; the router owns the
locking and the live counters.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, Optional, Union

#: priority classes, lowest sheds first. Accepts the names or raw ints.
PRIORITY_CLASSES: Dict[str, int] = {"low": 0, "normal": 1, "high": 2}
_NUM_CLASSES = 3


def normalize_priority(p: Union[str, int, None]) -> int:
    """Map a user-facing priority (class name or int) to its rank."""
    if p is None:
        return PRIORITY_CLASSES["normal"]
    if isinstance(p, str):
        try:
            return PRIORITY_CLASSES[p.lower()]
        except KeyError:
            raise ValueError(
                f"unknown priority {p!r}; classes: "
                f"{sorted(PRIORITY_CLASSES)} (or an int 0..2)") from None
    return max(0, min(_NUM_CLASSES - 1, int(p)))


def depth_limit(max_queue_depth: int, priority: int) -> int:
    """Admission cap for a priority class under a deployment-wide
    ``max_queue_depth``: tiered fractions (low 1/3, normal 2/3, high
    full) so lower classes shed strictly earlier as depth builds. Every
    class keeps a floor of 1 so a tiny cap (1 or 2) still admits an
    otherwise-idle deployment's low-priority traffic."""
    if max_queue_depth <= 0:
        return 0  # unbounded
    rank = max(0, min(_NUM_CLASSES - 1, priority))
    if rank >= _NUM_CLASSES - 1:
        return max_queue_depth
    return max(1, (max_queue_depth * (rank + 1)) // _NUM_CLASSES)


class TtftEstimator:
    """Per-replica EWMA of observed time-to-first-token, aggregated into
    the wait estimate deadline admission checks against.

    ``observe`` feeds a measured TTFT (engine/generator streams: submit
    to first chunk; unary paths: full call latency as the proxy) into
    the replica's EWMA and a bounded recent-sample list the router
    drains into controller load reports (TTFT percentiles for the
    autoscaler). ``estimated_wait_s`` scales the mean EWMA by the queue
    depth spread over the replica count — a first-order M/M/c feel that
    is deliberately conservative and cheap, not a queueing model."""

    MAX_SAMPLES = 256

    def __init__(self, alpha: float = 0.3):
        self.alpha = min(1.0, max(0.01, float(alpha)))
        self._ewma: Dict[str, float] = {}
        self._count: Dict[str, int] = {}  # observations per replica
        self._samples: list = []  # recent TTFTs in ms, drained by reports
        self._lock = threading.Lock()

    def observe(self, replica_id: str, ttft_s: float) -> None:
        ttft_s = max(0.0, float(ttft_s))
        with self._lock:
            prev = self._ewma.get(replica_id)
            self._ewma[replica_id] = (
                ttft_s if prev is None
                else prev + self.alpha * (ttft_s - prev))
            self._count[replica_id] = self._count.get(replica_id, 0) + 1
            self._samples.append(ttft_s * 1e3)
            if len(self._samples) > self.MAX_SAMPLES:
                del self._samples[:len(self._samples) - self.MAX_SAMPLES]

    def drop_replica(self, replica_id: str) -> None:
        with self._lock:
            self._ewma.pop(replica_id, None)
            self._count.pop(replica_id, None)

    def snapshot(self) -> Dict[str, tuple]:
        """{replica_id: (ewma_s, observation count)} — the input to
        gray-replica outlier scoring (serve/retry.py ReplicaHealth)."""
        with self._lock:
            return {rid: (ewma, self._count.get(rid, 0))
                    for rid, ewma in self._ewma.items()}

    def drain_samples(self) -> list:
        with self._lock:
            out, self._samples = self._samples, []
            return out

    def mean_ttft_s(self) -> float:
        with self._lock:
            if not self._ewma:
                return 0.0
            return sum(self._ewma.values()) / len(self._ewma)

    def estimated_wait_s(self, queue_depth: int, num_replicas: int) -> float:
        base = self.mean_ttft_s()
        if base <= 0.0:
            return 0.0  # no observations yet: admit optimistically
        return base * (1.0 + queue_depth / max(1, num_replicas))


def retry_after_hint(estimated_wait_s: float, mean_ttft_s: float) -> float:
    """Client back-off hint carried on BackpressureError: roughly when a
    slot should free (one service time, or the wait estimate if larger),
    floored so 429 storms don't immediately re-arrive."""
    return max(0.1, estimated_wait_s, mean_ttft_s)


def percentile(samples, q: float) -> float:
    """Nearest-rank percentile over a small sample list (0 if empty)."""
    if not samples:
        return 0.0
    s = sorted(samples)
    rank = max(0, min(len(s) - 1, math.ceil(q / 100.0 * len(s)) - 1))
    return float(s[rank])


def qos_from_config(cfg: dict) -> dict:
    """Extract+normalize the QoS trio from a deployment config dict:
    ``priority`` (class name or 0..2, default normal), ``max_queue_depth``
    (0 = unbounded, falling back to the ``serve_max_queue_depth`` flag),
    ``deadline_s`` (default per-request completion deadline, None = no
    deadline)."""
    from ray_tpu_torch.core.config import config

    raw_depth = cfg.get("max_queue_depth")
    depth = int(raw_depth if raw_depth is not None
                else config.serve_max_queue_depth)
    raw_deadline = cfg.get("deadline_s")
    deadline: Optional[float] = (None if raw_deadline is None
                                 else float(raw_deadline))
    if deadline is not None and deadline <= 0:
        raise ValueError(
            f"deadline_s must be positive (got {deadline})")
    if depth < 0:
        raise ValueError(
            f"max_queue_depth must be >= 0 (got {depth})")
    return {"priority": normalize_priority(cfg.get("priority")),
            "max_queue_depth": depth, "deadline_s": deadline}
