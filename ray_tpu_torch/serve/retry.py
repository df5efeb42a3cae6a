"""Request-level fault tolerance for the serving plane.

The port's copy of ``ray_tpu/serve/retry.py``.

One policy object replaces the three divergent retry loops the router
grew (`_unary_request`, `call_method`, `_flush_batch`) and extends the
same contract to the engine-mailbox path that previously had none:
pick a replica, dispatch, classify the failure, and — when the failure
is a replica loss — re-pick (affinity-aware, via the router's `_pick`)
and replay.

Three cooperating pieces:

- :class:`RequestLedger` — router-side record of replayable requests in
  flight. Every request run under ``serve_request_replay`` opens a
  ledger entry and gets a process-unique dedup **nonce**; the nonce
  rides to the replica (``_NONCE_KWARG``), where a memo of applied
  results (:mod:`ray_tpu_torch.serve.replica`) collapses at-least-once
  delivery into exactly-once execution — the replay of a request whose
  first attempt executed but whose reply was lost returns the recorded
  result instead of re-running side effects.

- :func:`run_with_replay` — the unified dispatch loop. Flag off it
  reproduces the seed behavior exactly: 3 attempts, retry only on
  ActorDiedError, no nonce attached (the wire payload stays
  byte-identical). Flag on, the budget comes from
  ``serve_replay_max_attempts``, call timeouts also classify as replica
  loss, and the ``serve_replica_kill`` fault site can inject synthetic
  deaths (``die`` = lost request, ``die_after`` = lost reply) for
  deterministic chaos tests. Exhausting the budget surfaces
  ReplicaUnavailableError carrying the attempt count and last cause.

- :class:`ReplicaHealth` — gray-replica scoring + hysteresis
  (``serve_replica_ejection``). Two signals feed ejection: a
  consecutive dispatch-failure streak (which also covers engine-poll
  staleness — a replica whose 60 s collect polls time out accrues
  failures), and a TTFT EWMA that is an outlier against the median of
  its peers (``serve_eject_ttft_ratio``). Ejected replicas are filtered
  out of `_pick` (never down to an empty set), reported to the
  controller — which probes and replaces persistently gray replicas —
  and locally restored after a cooldown so a recovered replica earns
  its way back (hysteresis, at replica granularity).

Everything here is process-local; the router owns replica state and
calls in with its own pick/drop/refresh machinery.
"""

from __future__ import annotations

import threading
import time
import uuid
from typing import Any, Callable, Dict, List, Optional, Tuple

from ray_tpu_torch.core import fault_injection
from ray_tpu_torch.core.config import config
from ray_tpu_torch.exceptions import (ActorDiedError, GetTimeoutError,
                                      ObjectTimeoutError,
                                      ReplicaUnavailableError)

#: internal kwarg carrying a request's dedup nonce to the replica
#: (popped in ReplicaActor before the user callable runs, same pattern
#: as the router's _DEADLINE_KWARG)
_NONCE_KWARG = "__rtpu_nonce__"


def replay_attempts() -> int:
    """The dispatch-attempt budget per request: the seed's 3 with the
    flag off, ``serve_replay_max_attempts`` with it on."""
    if config.serve_request_replay:
        return max(1, config.serve_replay_max_attempts)
    return 3


def exhausted_error(deployment: str, attempts: int,
                    last: Optional[BaseException]
                    ) -> ReplicaUnavailableError:
    """The typed terminal error for a spent replay budget."""
    return ReplicaUnavailableError(deployment=deployment,
                                   attempts=attempts, last_cause=last)


class RequestLedger:
    """Lightweight router-side ledger of replayable requests in flight.

    ``open`` mints a process-unique nonce and records the entry;
    ``note_attempt`` tracks which replicas each request was dispatched
    to (and counts replays); ``close`` retires the entry when the
    request resolves either way. The ledger is bookkeeping, not
    durability-critical state — the dedup guarantee lives in the
    replica-side applied-results memo keyed by the nonce."""

    def __init__(self):
        self._lock = threading.Lock()
        self._prefix = uuid.uuid4().hex[:12]
        self._seq = 0
        self._open: Dict[str, dict] = {}
        self._opened = 0
        self._replayed = 0

    def open(self) -> str:
        with self._lock:
            self._seq += 1
            self._opened += 1
            nonce = f"{self._prefix}-{self._seq}"
            self._open[nonce] = {"attempts": 0, "replicas": []}
            return nonce

    def note_attempt(self, nonce: str, replica_id: str) -> None:
        with self._lock:
            entry = self._open.get(nonce)
            if entry is not None:
                entry["attempts"] += 1
                entry["replicas"].append(replica_id)
                if entry["attempts"] > 1:
                    self._replayed += 1

    def close(self, nonce: str) -> None:
        with self._lock:
            self._open.pop(nonce, None)

    def stats(self) -> dict:
        with self._lock:
            return {"open": len(self._open), "opened": self._opened,
                    "replayed": self._replayed}


class ReplicaHealth:
    """Per-replica gray scoring with hysteresis, router-local.

    A replica ejects when its consecutive dispatch-failure streak hits
    ``STREAK_LIMIT``, or when its TTFT EWMA exceeds
    ``serve_eject_ttft_ratio`` x the median of its peers (with at least
    ``MIN_OBS`` own observations, ``MIN_PEER_OBS`` per peer, and an
    absolute ``MIN_EXCESS_S`` floor so microsecond-scale noise on fast
    deployments never trips it). Ejections expire after ``COOLDOWN_S``
    — the replica gets picked again, and re-ejects on the next signal
    if it is still gray — or end earlier when the controller replaces
    the replica (``drop``)."""

    STREAK_LIMIT = 3
    COOLDOWN_S = 10.0
    MIN_OBS = 5
    MIN_PEER_OBS = 3
    MIN_EXCESS_S = 0.05

    def __init__(self):
        self._lock = threading.Lock()
        self._streak: Dict[str, int] = {}
        self._ejected: Dict[str, float] = {}  # rid -> eject monotonic ts

    def note_ok(self, replica_id: str) -> None:
        """A successful dispatch (or engine poll) resets the streak."""
        with self._lock:
            self._streak.pop(replica_id, None)

    def note_failure(self, replica_id: str) -> bool:
        """Count a dispatch failure; True when it tripped ejection."""
        with self._lock:
            n = self._streak.get(replica_id, 0) + 1
            self._streak[replica_id] = n
            if n >= self.STREAK_LIMIT and replica_id not in self._ejected:
                self._ejected[replica_id] = time.monotonic()
                return True
        return False

    def note_ttft(self, replica_id: str,
                  snapshot: Dict[str, Tuple[float, int]],
                  ratio: float) -> bool:
        """TTFT-outlier check against the peer median; ``snapshot`` maps
        replica id -> (ewma_s, observation count) (TtftEstimator
        .snapshot()). True when the observation tripped ejection."""
        mine = snapshot.get(replica_id)
        if mine is None or mine[1] < self.MIN_OBS:
            return False
        peers = sorted(ewma for rid, (ewma, count) in snapshot.items()
                       if rid != replica_id and count >= self.MIN_PEER_OBS)
        if not peers:
            return False
        median = peers[len(peers) // 2]
        if (mine[0] >= ratio * median
                and mine[0] - median >= self.MIN_EXCESS_S):
            with self._lock:
                if replica_id not in self._ejected:
                    self._ejected[replica_id] = time.monotonic()
                    return True
        return False

    def is_ejected(self, replica_id: str,
                   now: Optional[float] = None) -> bool:
        now = time.monotonic() if now is None else now
        with self._lock:
            ts = self._ejected.get(replica_id)
            if ts is None:
                return False
            if now - ts >= self.COOLDOWN_S:
                # hysteresis restore: the replica earns another chance;
                # a still-gray one re-ejects on its next signal
                del self._ejected[replica_id]
                self._streak.pop(replica_id, None)
                return False
            return True

    def filter(self, replicas: List[Tuple[str, Any]]
               ) -> List[Tuple[str, Any]]:
        """Drop ejected replicas from a pick candidate list. Never
        empties it: with every replica ejected the full list comes back
        — degraded service beats refusing all traffic."""
        with self._lock:
            if not self._ejected:
                return replicas
        now = time.monotonic()
        live = [r for r in replicas if not self.is_ejected(r[0], now)]
        return live or replicas

    def ejected_ids(self) -> List[str]:
        """Currently-ejected replica ids (for controller gray reports)."""
        now = time.monotonic()
        with self._lock:
            return [rid for rid, ts in self._ejected.items()
                    if now - ts < self.COOLDOWN_S]

    def drop(self, replica_id: str) -> None:
        """The replica left the deployment (death or replacement)."""
        with self._lock:
            self._streak.pop(replica_id, None)
            self._ejected.pop(replica_id, None)


def run_with_replay(router, pick: Callable[[set], Tuple[str, Any]],
                    attempt: Callable[[str, Any, Optional[str]], Any],
                    weight: int = 1) -> Tuple[str, Any]:
    """The unified dispatch loop behind every router request path.

    ``pick(failed)`` returns (replica_id, handle) — the router's
    `_pick`, so replays are affinity-aware; ``failed`` is the set of
    replica ids this request already watched die, which the pick skips
    (a forced refresh can re-add a corpse the controller has not yet
    noticed). ``attempt(rid, handle, nonce)`` runs the
    actual call and is responsible for attaching the nonce to its wire
    payload (None with the flag off: the payload stays byte-identical
    to the seed). Returns ``("ok", result)`` or ``("err", exception)``;
    the caller routes the error to its future(s)/stream.

    Classification: ActorDiedError always replays (the seed's contract);
    Get/Object timeouts replay only under ``serve_request_replay``
    (replica-side nonce dedup makes replaying a possibly-executed call
    safe); anything else is an application error and terminal. The
    ``serve_replica_kill`` fault site injects synthetic deaths here —
    ``die`` before dispatch (lost request), ``die_after`` after a
    successful call whose result is then discarded (lost reply, the
    exactly-once dedup test)."""
    ledger = router._ledger
    nonce = ledger.open() if config.serve_request_replay else None
    max_attempts = replay_attempts()
    last: Optional[BaseException] = None
    attempts = 0
    failed: set = set()
    try:
        while attempts < max_attempts:
            attempts += 1
            try:
                rid, handle = pick(failed)
            except ReplicaUnavailableError as e:
                if last is not None:
                    e = exhausted_error(router._name, attempts - 1, last)
                return ("err", e)
            if nonce is not None:
                ledger.note_attempt(nonce, rid)
            with router._lock:
                router._inflight[rid] = (
                    router._inflight.get(rid, 0) + weight)
            die_after = False
            try:
                if fault_injection.enabled():
                    action = fault_injection.fire(
                        "serve_replica_kill", f"{router._name}:{rid}")
                    if action == "die":
                        raise ActorDiedError(
                            f"injected serve_replica_kill: replica "
                            f"{rid} died before dispatch")
                    die_after = action == "die_after"
                out = attempt(rid, handle, nonce)
                if die_after:
                    raise ActorDiedError(
                        f"injected serve_replica_kill: replica {rid} "
                        f"died after executing the call (reply lost)")
                if config.serve_replica_ejection:
                    router._health.note_ok(rid)
                return ("ok", out)
            except ActorDiedError as e:
                last = e
                failed.add(rid)
                router._note_replica_failure(rid)
            except (GetTimeoutError, ObjectTimeoutError) as e:
                if not config.serve_request_replay:
                    # seed behavior: a timeout is terminal (no dedup
                    # protects a re-execution without the flag)
                    return ("err", e)
                last = e
                failed.add(rid)
                router._note_replica_failure(rid)
            except BaseException as e:  # noqa: BLE001 — app error: terminal
                return ("err", e)
            finally:
                with router._lock:
                    if rid in router._inflight:
                        router._inflight[rid] -= weight
        return ("err", exhausted_error(router._name, attempts, last))
    finally:
        if nonce is not None:
            ledger.close(nonce)
