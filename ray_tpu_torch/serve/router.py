"""Request router: replica choice, admission control, dynamic batching,
engine polling.

The port's copy of ``ray_tpu/serve/router.py``.

Power-of-two-choices over router-local in-flight counts (reference:
serve/_private/replica_scheduler/pow_2_scheduler.py:51 — the reference
also uses caller-local accounting). Batching buffers requests per
deployment and flushes on max_batch_size or batch_wait_timeout_s
(reference: serve/batching.py:80 _BatchQueue).

Overload: when the deployment carries QoS config (priority /
max_queue_depth / deadline_s — see serve/qos.py), every request and
stream passes an admission check BEFORE any replica work starts: depth
over the priority class's share of max_queue_depth, or an estimated
wait (TTFT EWMA x queue depth) past the request's deadline, sheds the
request with a typed BackpressureError carrying the depth, the
estimate, and a retry-after hint. With no QoS config the admission path
is a no-op — exactly the pre-QoS router.
"""

from __future__ import annotations

import random
import threading
import time
from concurrent.futures import Future
from typing import Any, Dict, List, Optional, Tuple

import weakref

import ray_tpu_torch
from ray_tpu_torch.core import fault_injection
from ray_tpu_torch.core.config import config
from ray_tpu_torch.exceptions import (ActorDiedError, BackpressureError,
                                      GetTimeoutError, ObjectTimeoutError,
                                      ReplicaUnavailableError, TaskError)
from ray_tpu_torch.serve.qos import (TtftEstimator, depth_limit,
                                     normalize_priority, qos_from_config,
                                     retry_after_hint)
from ray_tpu_torch.serve.retry import (_NONCE_KWARG, ReplicaHealth,
                                       RequestLedger, exhausted_error,
                                       replay_attempts, run_with_replay)

#: internal kwarg carrying a request's wall-clock deadline to the
#: replica (popped in ReplicaActor.handle, same pattern as _MUX_KWARG)
_DEADLINE_KWARG = "__rtpu_deadline_wall__"


class _DepthToken:
    """One admitted request's depth accounting. ``release`` is
    idempotent, usable directly as a Future done-callback, and also
    fires from ``__del__`` so an abandoned (never-iterated) stream
    generator cannot leak queue depth."""

    __slots__ = ("_router", "_released")

    def __init__(self, router: "Router"):
        self._router = router
        self._released = False

    def release(self, *_):
        if self._released:
            return
        self._released = True
        r = self._router
        with r._lock:
            r._depth = max(0, r._depth - 1)

    __del__ = release

class _TokenStream:
    """Iterator handed out by ``stream_request``, tying the admission
    depth token's release to the STREAM OBJECT instead of generator
    finalization alone. ``generator.close()`` on a never-started
    generator does not run its ``finally`` block, so an abandoned
    (never-iterated) stream would hold its queue-depth slot until GC;
    ``close`` here releases both deterministically and ``__del__``
    remains only as the backstop."""

    __slots__ = ("_gen", "_token")

    def __init__(self, gen, token: Optional[_DepthToken]):
        self._gen = gen
        self._token = token

    def __iter__(self):
        return self

    def __next__(self):
        return next(self._gen)

    def close(self):
        """Idempotent: finalize the generator (running its finally when
        iteration started), then release the depth slot either way."""
        try:
            self._gen.close()
        finally:
            if self._token is not None:
                self._token.release()

    __del__ = close


# process-local registry so serve.delete/shutdown can stop the reporting
# threads of routers whose handles are still alive in this process
_ROUTERS: "weakref.WeakSet[Router]" = weakref.WeakSet()


def stop_routers(name: Optional[str] = None):
    """Stop load-report loops for one deployment (or all, name=None)."""
    for r in list(_ROUTERS):
        if name is None or r._name == name:
            r.stop()


class Router:
    """One per (process, deployment): routes requests to replicas."""

    def __init__(self, controller, name: str):
        self._controller = controller
        self._name = name
        self._stop_reporting = False
        _ROUTERS.add(self)
        self._lock = threading.Lock()
        self._replicas: List[Tuple[str, Any]] = []
        self._inflight: Dict[str, int] = {}
        # multiplexing: model id -> replica id that last loaded it
        self._mux_affinity: Dict[str, str] = {}
        # cache-aware routing (serve_cache_affinity, serve/affinity.py):
        # per-replica prefix-residency digests refreshed by the report
        # loop, and session id -> replica id stickiness (a session's
        # chain lives where its previous turn ran)
        self._residency: Dict[str, Any] = {}
        self._session_affinity: Dict[str, str] = {}
        self._version = -1
        self._snapshot = 0
        self._deployment_gone = False
        self._last_refresh = 0.0
        self._topology_thread: Optional[threading.Thread] = None
        cfg = ray_tpu_torch.get(controller.get_deployment_config.remote(name),
                                timeout=30) or {}
        self._max_batch = int(cfg.get("max_batch_size", 0))
        self._batch_wait_s = float(cfg.get("batch_wait_timeout_s", 0.01))
        self._engine = bool(cfg.get("engine", False))
        # generator deployments stream through num_returns="streaming"
        # actor calls instead of the engine mailbox (set by serve.run)
        self._streaming = bool(cfg.get("is_generator", False))
        self._pending: List[Tuple[tuple, dict, Future]] = []
        self._batch_thread: Optional[threading.Thread] = None
        self._engine_state: Dict[str, Any] = {}
        self._req_seq = 0
        # QoS: deployment-level priority class, admission depth cap, and
        # default deadline; the TTFT estimator drives deadline admission
        # and feeds percentiles to the controller's demand signal
        self._qos = qos_from_config(cfg)
        self._depth = 0  # admitted, not yet completed (all paths)
        self._ttft = TtftEstimator(config.serve_ttft_ewma_alpha)
        # request fault tolerance (serve/retry.py): the replay ledger
        # mints dedup nonces under serve_request_replay; per-replica
        # gray scoring ejects outliers under serve_replica_ejection
        self._ledger = RequestLedger()
        self._health = ReplicaHealth()
        qos_active = (self._qos["max_queue_depth"] > 0
                      or self._qos["deadline_s"] is not None
                      or "priority" in cfg)
        # load reporting feeds controller autoscaling and the serve
        # demand signal (reference: handles push autoscaling metrics);
        # started when the deployment autoscales OR carries QoS config
        # (the controller aggregates depth + TTFT percentiles for the
        # autoscaler's serve:demand KV key)
        self._autoscaling = bool(cfg.get("autoscaling_config"))
        # cache-affinity routing rides the same loop: digests refresh on
        # the report tick, so an engine deployment under the flag always
        # reports (the controller then also sees residency aggregates)
        self._report_enabled = (self._autoscaling or qos_active
                                or (config.serve_cache_affinity
                                    and self._engine)
                                or config.serve_replica_ejection)
        self._report_thread: Optional[threading.Thread] = None
        if self._report_enabled:
            import os as _os
            import uuid as _uuid

            # pid+uuid: id(self) alone collides across processes and
            # would overwrite another router's load report
            self._router_id = f"router-{_os.getpid()}-{_uuid.uuid4().hex[:8]}"
            self._ensure_report_thread()
        self._ensure_topology_thread()

    # ----------------------------------------------------------- admission

    def _resolve_qos(self, priority, deadline_s) -> Tuple[int, Optional[float]]:
        """Per-request QoS: handle.options overrides beat the
        deployment-level defaults."""
        pr = (self._qos["priority"] if priority is None
              else normalize_priority(priority))
        dl = (self._qos["deadline_s"] if deadline_s is None
              else float(deadline_s))
        if dl is not None and dl <= 0:
            raise ValueError(f"deadline_s must be positive (got {dl})")
        return pr, dl

    def _shed(self, message: str, depth: int) -> BackpressureError:
        mean = self._ttft.mean_ttft_s()
        with self._lock:
            n = max(1, len(self._replicas))
        est = self._ttft.estimated_wait_s(depth, n)
        return BackpressureError(
            message, deployment=self._name, queue_depth=depth,
            estimated_wait_s=est,
            retry_after_s=retry_after_hint(est, mean))

    def _depth_now(self) -> int:
        """Locked read of the current queue depth (diagnostic reads on
        the stream paths go through here)."""
        with self._lock:
            return self._depth

    def _admit(self, priority: int,
               deadline_s: Optional[float]) -> Optional[_DepthToken]:
        """Admission check, run BEFORE any replica work: sheds with
        BackpressureError, or returns the depth token the caller must
        release at completion (None when QoS is off — the counter is
        then never touched, keeping the pre-QoS path byte-identical)."""
        if fault_injection.enabled():
            action = fault_injection.fire("serve_overload", self._name)
            if action == "shed":
                with self._lock:
                    depth = self._depth
                raise self._shed(
                    "request shed (injected serve_overload)", depth)
        max_depth = self._qos["max_queue_depth"]
        if max_depth <= 0 and deadline_s is None:
            return None
        # wait estimate outside the router lock (the estimator has its
        # own); the depth check+increment is one critical section so
        # concurrent admissions cannot both pass the last slot
        limit = depth_limit(max_depth, priority)
        with self._lock:
            depth = self._depth
            n = max(1, len(self._replicas))
        est = self._ttft.estimated_wait_s(depth, n)
        if deadline_s is not None and est > deadline_s:
            raise self._shed(
                f"request shed: estimated wait {est:.3f}s exceeds the "
                f"{deadline_s:.3f}s deadline", depth)
        with self._lock:
            if limit and self._depth >= limit:
                depth = self._depth
            else:
                self._depth += 1
                return _DepthToken(self)
        raise self._shed(
            "request shed: queue depth at the priority class's "
            f"admission share ({depth}/{limit} of "
            f"max_queue_depth={max_depth})", depth)

    def _ensure_topology_thread(self):
        """(Re)start the long-poll topology listener. Replica-set and
        config changes PUSH from the controller (reference:
        serve/_private/long_poll.py client loop) — the router issues no
        steady-state get_replicas polls at all."""
        if self._deployment_gone:
            return
        with self._lock:
            t = self._topology_thread
            if t is not None and t.is_alive():
                return
            self._stop_reporting = False
            self._topology_thread = threading.Thread(
                target=self._topology_loop, daemon=True,
                name="serve-topology-listen")
            self._topology_thread.start()

    def _topology_loop(self):
        key = f"replicas:{self._name}"
        consecutive_failures = 0
        # Worker processes talk to their owner over ONE serialized data
        # connection: a get() blocking 10 s on the long-poll ref would
        # head-of-line block every other RPC the replica makes (measured:
        # the controller's health checks then time out and it kills the
        # replica). In worker context the poll ref is therefore drained
        # with non-blocking wait() probes against the LOCAL owner —
        # ~100 ms extra latency for in-replica routers, zero controller
        # load either way. Driver routers (the proxies, user drivers)
        # block directly: instant push.
        from ray_tpu_torch.core import runtime_context

        core = runtime_context.get_core_or_none()
        in_worker = type(core).__module__.endswith("worker_proc")
        while not self._stop_reporting:
            ref = None
            try:
                with self._lock:
                    snap0 = self._snapshot
                ref = self._controller.listen_for_change.remote(
                    {key: snap0}, 10.0)
                if in_worker:
                    deadline = (time.monotonic()
                                + config.serve_worker_poll_deadline_s)
                    while (not self._stop_reporting
                           and time.monotonic() < deadline):
                        ready, _ = ray_tpu_torch.wait([ref], num_returns=1,
                                                      timeout=0)
                        if ready:
                            break
                        time.sleep(0.05)
                    else:
                        continue  # re-arm (server timeout imminent)
                    res = ray_tpu_torch.get(ref, timeout=5)
                else:
                    res = ray_tpu_torch.get(ref, timeout=25)
                consecutive_failures = 0
            except Exception:  # noqa: BLE001 — controller restart/outage
                consecutive_failures += 1
                if consecutive_failures >= 12:  # ~2 min of outage
                    return
                time.sleep(1.0)
                continue
            finally:
                # refs have no implicit reclamation in this runtime; an
                # unfreed poll result every ~10 s would grow the object
                # table forever (same rule as the report loop's prev_ref)
                if ref is not None:
                    try:
                        ray_tpu_torch.free(ref)
                    except Exception:  # noqa: BLE001
                        pass
            if not res or key not in res:
                continue  # timed out server-side: re-arm
            snap, payload = res[key]
            if payload is None:
                # deployment deleted: end this router's loops
                self._deployment_gone = True
                self._stop_reporting = True
                return
            version, replicas = payload
            with self._lock:
                self._snapshot = int(snap)
                self._version = version
                self._replicas = replicas
                self._last_refresh = time.monotonic()
                live = {rid for rid, _ in replicas}
                for rid in live:
                    self._inflight.setdefault(rid, 0)

    def _ensure_report_thread(self):
        """(Re)start load reporting. A router whose loop exited — deleted
        deployment, controller outage, stop() — but that then routes NEW
        traffic must become visible to the autoscaler again, or its
        in-flight load is invisible and replicas scale to min under load."""
        if not self._report_enabled:
            return
        with self._lock:  # check-then-start must not race concurrent calls
            t = self._report_thread
            if t is not None and t.is_alive():
                return
            self._stop_reporting = False
            self._report_thread = threading.Thread(
                target=self._report_load_loop, daemon=True,
                name="serve-load-report")
            self._report_thread.start()

    def _report_load_loop(self):
        prev_ref = None
        consecutive_failures = 0
        try:
            while not self._stop_reporting:
                try:
                    with self._lock:
                        load = sum(self._inflight.values())
                        depth = self._depth
                    residency = None
                    if config.serve_cache_affinity and self._engine:
                        residency = self._poll_residency()
                    gray = (self._health.ejected_ids()
                            if config.serve_replica_ejection else [])
                    if gray:
                        # 7-arg shape: the controller probes gray
                        # replicas and replaces the persistently slow
                        ref = self._controller.report_load.remote(
                            self._name, self._router_id, load,
                            max(load, depth), self._ttft.drain_samples(),
                            residency, gray)
                    elif residency is not None:
                        ref = self._controller.report_load.remote(
                            self._name, self._router_id, load,
                            max(load, depth), self._ttft.drain_samples(),
                            residency)
                    else:
                        # legacy 5-arg shape when affinity is off: the
                        # flag-off wire traffic stays byte-identical
                        ref = self._controller.report_load.remote(
                            self._name, self._router_id, load,
                            max(load, depth), self._ttft.drain_samples())
                    if prev_ref is not None:
                        # free the previous report's return entry — a
                        # periodic fire-and-forget would otherwise grow
                        # the object table forever
                        ray_tpu_torch.free(prev_ref)
                    prev_ref = ref
                    consecutive_failures = 0
                except Exception:  # noqa: BLE001 — controller restart
                    # a dead controller must also end the loop, not just a
                    # deleted deployment: ~30s of straight failures means
                    # serve was torn down (a restart would have recovered)
                    consecutive_failures += 1
                    if consecutive_failures >= 60:
                        return
                # deletion is PUSHED: the long-poll listener flags
                # _deployment_gone, so no periodic existence RPC here.
                # Keep the listener alive — it gives up after ~13 s of
                # controller outage, and without it a later deletion
                # would never reach this loop (report_load to an unknown
                # deployment is a silent no-op, not an error)
                if self._deployment_gone:
                    return
                self._ensure_topology_thread()
                time.sleep(0.5)
        finally:
            if prev_ref is not None:
                try:
                    ray_tpu_torch.free(prev_ref)
                except Exception:  # noqa: BLE001
                    pass

    def _poll_residency(self) -> dict:
        """Refresh per-replica prefix-residency digests (engine replicas
        publish bounded chain-hash fingerprint sets; see
        serve/affinity.py) and return the aggregate the report loop
        forwards to the controller. Best-effort per replica: one without
        the surface (non-paged engine, old code) or one that died simply
        contributes no digest, and _pick falls back to pow-2 for it."""
        from ray_tpu_torch.serve.affinity import ResidencyDigest

        with self._lock:
            replicas = list(self._replicas)
        summary: Dict[str, int] = {}
        for rid, handle in replicas:
            try:
                payload = ray_tpu_torch.get(
                    handle.residency_digest.remote(), timeout=5)
            except Exception:  # noqa: BLE001 — dead/old replica
                payload = None
            dg = ResidencyDigest.from_report(payload)
            with self._lock:
                if dg is not None:
                    self._residency[rid] = dg
                    summary[rid] = len(dg.hashes)
                else:
                    self._residency.pop(rid, None)
        return {"replicas": summary,
                "cached_chains": sum(summary.values())}

    def stop(self):
        """Stop background reporting (called by DeploymentHandle teardown
        and serve.delete/shutdown via the process-local registry)."""
        self._stop_reporting = True

    def _observe_ttft(self, rid: str, dt_s: float):
        """Feed an observed TTFT (streams: submit to first chunk; unary
        paths: full call latency as the proxy) into the estimator; under
        ejection the same observation feeds gray scoring — a replica
        whose EWMA is an outlier vs its peers' median stops being picked
        until it recovers or the controller replaces it."""
        self._ttft.observe(rid, dt_s)
        if config.serve_replica_ejection:
            self._health.note_ttft(rid, self._ttft.snapshot(),
                                   config.serve_eject_ttft_ratio)

    def _note_replica_failure(self, rid: str):
        """A dispatch to ``rid`` failed with replica loss (real or
        injected): drop it from the routing set, force-refresh so the
        next pick sees the controller's view, and — under ejection —
        count the failure toward the gray streak."""
        if config.serve_replica_ejection:
            self._health.note_failure(rid)
        self._drop_replica(rid)
        self._refresh(force=True)

    # ------------------------------------------------------------- replicas

    def _refresh(self, force: bool = False):
        """Pull fallback only: the long-poll listener keeps the replica
        set fresh, so non-forced refreshes are no-ops once seeded.
        Forced pulls remain for replica-death recovery (don't wait a
        push round-trip to stop routing at a corpse)."""
        now = time.monotonic()
        with self._lock:
            seeded = bool(self._replicas)
        if not force and seeded:
            self._ensure_topology_thread()  # revive after outage exit
            return
        snap, version, replicas = ray_tpu_torch.get(
            self._controller.get_replicas_snapshot.remote(self._name),
            timeout=30)
        with self._lock:
            self._last_refresh = now
            # the push channel may have delivered a NEWER snapshot while
            # this pull was in flight — never let a stale pull overwrite
            # it (the suppressed push would not be redelivered)
            if int(snap) >= self._snapshot:
                self._snapshot = int(snap)
                self._version = version
                self._replicas = replicas
                for rid, _ in replicas:
                    self._inflight.setdefault(rid, 0)
        self._ensure_topology_thread()

    def _pick(self, model_id: Optional[str] = None,
              prompt_tokens: Optional[list] = None,
              session_id: Optional[str] = None,
              avoid: Optional[set] = None) -> Tuple[str, Any]:
        """Power-of-two-choices on local in-flight counts; with a
        multiplexed ``model_id``, prefer the replica that already loaded
        that variant (reference: multiplex-aware replica scheduler) unless
        it is clearly overloaded vs the pow-2 alternative.

        Under ``serve_cache_affinity``, engine requests carrying their
        ``prompt_tokens`` (and optionally a ``session_id``) first try the
        cache-affinity pick (serve/affinity.py): the replica holding the
        longest cached prefix of the prompt wins unless its load penalty
        eats the match; no candidate clearing the bar falls back to
        pow-2 unchanged. Flag off, the extra arguments are inert and the
        seed pow-2 path runs byte-identical (no digest reads, no extra
        RNG draws)."""
        deadline = time.monotonic() + config.serve_replica_wait_s
        while True:
            self._refresh()
            with self._lock:
                replicas = list(self._replicas)
            if replicas:
                break
            if time.monotonic() > deadline:
                raise ReplicaUnavailableError(deployment=self._name)
            time.sleep(0.05)
        if config.serve_replica_ejection:
            # ejected (gray) replicas stop receiving picks; the filter
            # never empties the candidate set (all-gray → full list).
            # Flag off this branch never runs: pow-2 stays byte-identical
            replicas = self._health.filter(replicas)
        if avoid:
            # replay re-pick: skip replicas this request already watched
            # die — the controller's health check may not have noticed
            # yet, so a forced refresh can re-add the corpse and burn
            # the whole replay budget on it. Empty on first attempts,
            # so the pow-2 path is untouched; never empties the
            # candidate set: when every replica failed this request,
            # the ones that still answer are retried, and with none
            # left the pick waits for the controller's replacement
            alive = [r for r in replicas if r[0] not in avoid]
            replicas = alive or self._await_replacement(replicas, avoid,
                                                        deadline)
        if model_id is not None:
            with self._lock:
                rid = self._mux_affinity.get(model_id)
                hot = next((r for r in replicas if r[0] == rid), None)
                if hot is not None:
                    # cache hit beats a cold load unless the hot replica
                    # is badly backed up relative to the least-loaded one
                    least = min(self._inflight.get(r[0], 0)
                                for r in replicas)
                    if self._inflight.get(rid, 0) <= least + 4:
                        return hot
        choice = None
        if config.serve_cache_affinity and (prompt_tokens is not None
                                            or session_id is not None):
            choice = self._pick_affinity(replicas, prompt_tokens,
                                         session_id)
        if choice is None:
            if len(replicas) == 1:
                choice = replicas[0]
            else:
                a, b = random.sample(replicas, 2)
                with self._lock:
                    choice = a if (self._inflight.get(a[0], 0)
                                   <= self._inflight.get(b[0], 0)) else b
        if model_id is not None:
            with self._lock:
                self._mux_affinity[model_id] = choice[0]
                if len(self._mux_affinity) > 10_000:
                    self._mux_affinity.clear()  # bounded, rebuilt on use
        if session_id is not None and config.serve_cache_affinity:
            with self._lock:
                self._session_affinity[session_id] = choice[0]
                if len(self._session_affinity) > 10_000:
                    self._session_affinity.clear()
        return choice

    def _await_replacement(self, replicas: List[Tuple[str, Any]],
                           avoid: set, deadline: float
                           ) -> List[Tuple[str, Any]]:
        """Candidates for a replay whose request saw every known replica
        fail. A replica that still answers a ping is retried: its failure
        was a timeout, or injected. If none answers, they are corpses the
        controller has not replaced yet (a deployment of one replica
        whose replica was killed), and retrying them would burn the
        replay budget in milliseconds: wait, up to
        ``serve_replica_wait_s``, for a replica this request has not
        seen fail. (``ray_tpu``'s router retries the corpse.)"""
        live = [r for r in replicas if self._answers(r[1])]
        if live:
            return live
        while time.monotonic() < deadline:
            time.sleep(0.1)
            self._refresh(force=True)
            with self._lock:
                fresh = [r for r in self._replicas if r[0] not in avoid]
            if fresh:
                return fresh
        raise ReplicaUnavailableError(deployment=self._name)

    @staticmethod
    def _answers(handle) -> bool:
        """False only when the replica's actor is dead; a slow ping
        counts as alive."""
        try:
            ray_tpu_torch.get(handle.ping.remote(), timeout=5)
        except ActorDiedError:
            return False
        except Exception:  # noqa: BLE001 — alive but slow or busy
            pass
        return True

    def _pick_affinity(self, replicas: List[Tuple[str, Any]],
                       prompt_tokens: Optional[list],
                       session_id: Optional[str]
                       ) -> Optional[Tuple[str, Any]]:
        """Cache-affinity choice: session stickiness first (the session's
        previous replica holds its whole chain, beyond what full-page
        digests can attest), then residency-digest scoring. None = no
        candidate cleared the bar; caller falls back to pow-2."""
        from ray_tpu_torch.serve.affinity import score_replicas

        by_id = {r[0]: r for r in replicas}
        with self._lock:
            if session_id is not None:
                rid = self._session_affinity.get(session_id)
                if rid in by_id:
                    # same hot-replica tolerance as mux affinity
                    least = min(self._inflight.get(r[0], 0)
                                for r in replicas)
                    if self._inflight.get(rid, 0) <= least + 4:
                        return by_id[rid]
            digests = dict(self._residency)
            inflight = dict(self._inflight)
        rid = score_replicas(
            prompt_tokens, replicas, digests, inflight,
            min_prefix_tokens=config.serve_affinity_min_prefix_tokens,
            load_penalty=config.serve_affinity_load_penalty)
        return by_id.get(rid)

    def _drop_replica(self, rid: str):
        with self._lock:
            self._replicas = [r for r in self._replicas if r[0] != rid]
            self._inflight.pop(rid, None)
            # affinity state for a corpse must go too: its digest can no
            # longer win a pick, and sticky sessions re-score fresh on
            # their next request instead of chasing the dead replica
            self._residency.pop(rid, None)
            for sid in [s for s, r in self._session_affinity.items()
                        if r == rid]:
                del self._session_affinity[sid]
        self._ttft.drop_replica(rid)
        # gray-health state deliberately survives the drop: a force
        # refresh re-adds a slow-but-alive replica immediately, and its
        # failure streak must keep accruing across that cycle (entries
        # for genuinely replaced replicas age out via the cooldown)

    # --------------------------------------------------------------- routing

    def request(self, args: tuple, kwargs: dict,
                model_id: Optional[str] = None,
                priority=None, deadline_s: Optional[float] = None,
                session_id: Optional[str] = None) -> Future:
        self._ensure_report_thread()
        if model_id is not None and (self._engine or self._max_batch > 1):
            # engine mailboxes and dynamic batches mix requests across
            # model ids — silently dropping the id would serve the wrong
            # variant, so refuse loudly until those paths are mux-aware
            raise ValueError(
                "multiplexed_model_id is not supported for engine or "
                "batched deployments")
        pr, dl = self._resolve_qos(priority, deadline_s)
        token = self._admit(pr, dl)  # sheds with BackpressureError
        fut: Future = Future()
        if token is not None:
            fut.add_done_callback(token.release)
        # wall-clock (cross-process) completion deadline: the replica
        # rejects requests that are already late at execution start
        deadline_wall = None if dl is None else time.time() + dl
        if self._engine:
            threading.Thread(target=self._engine_request,
                             args=(args, kwargs, fut, session_id),
                             daemon=True).start()
        elif self._max_batch > 1:
            with self._lock:
                self._pending.append((args, kwargs, fut))
                if self._batch_thread is None or not self._batch_thread.is_alive():
                    self._batch_thread = threading.Thread(
                        target=self._batch_loop, daemon=True)
                    self._batch_thread.start()
        else:
            threading.Thread(target=self._unary_request,
                             args=(args, kwargs, fut, model_id,
                                   deadline_wall, session_id),
                             daemon=True).start()
        return fut

    def call_method(self, method: str, args: tuple, kwargs: dict) -> Future:
        # control-plane calls (handle.<method>.remote): no admission —
        # shedding management traffic under data-plane overload would
        # block the operator's way out
        self._ensure_report_thread()
        fut: Future = Future()

        def run():
            def attempt(rid, handle, nonce):
                kw = (kwargs if nonce is None
                      else dict(kwargs, **{_NONCE_KWARG: nonce}))
                return ray_tpu_torch.get(
                    handle.call_method.remote(method, args, kw))

            status, out = run_with_replay(
                self, lambda failed: self._pick(avoid=failed), attempt)
            if status == "ok":
                fut.set_result(out)
            else:
                fut.set_exception(out)
        threading.Thread(target=run, daemon=True).start()
        return fut

    def _unary_request(self, args, kwargs, fut: Future, model_id=None,
                       deadline_wall: Optional[float] = None,
                       session_id: Optional[str] = None):
        from ray_tpu_torch.serve.multiplex import _MUX_KWARG

        if model_id is not None:
            kwargs = dict(kwargs, **{_MUX_KWARG: model_id})
        if deadline_wall is not None:
            kwargs = dict(kwargs, **{_DEADLINE_KWARG: deadline_wall})

        def attempt(rid, handle, nonce):
            kw = (kwargs if nonce is None
                  else dict(kwargs, **{_NONCE_KWARG: nonce}))
            t0 = time.monotonic()
            out = ray_tpu_torch.get(handle.handle.remote(args, kw))
            self._observe_ttft(rid, time.monotonic() - t0)
            return out

        status, out = run_with_replay(
            self, lambda failed: self._pick(model_id,
                                            session_id=session_id,
                                            avoid=failed),
            attempt)
        if status == "ok":
            fut.set_result(out)
            return
        if isinstance(out, TaskError) and isinstance(out.cause,
                                                     BackpressureError):
            # surface the replica's typed shed (deadline expired before
            # execution) unwrapped, like a router-side shed
            out = out.cause
        fut.set_exception(out)

    # -------------------------------------------------------------- batching

    def _batch_loop(self):
        # Lives for the router's lifetime (daemon): exiting on idle races
        # request()'s is_alive() check and could strand a request unflushed.
        while True:
            with self._lock:
                n = len(self._pending)
            if n >= self._max_batch:
                pass  # full batch: flush immediately, no added latency
            elif n > 0:
                time.sleep(self._batch_wait_s)  # let the batch fill
            else:
                time.sleep(min(self._batch_wait_s, 0.002))
                continue
            with self._lock:
                batch, self._pending = (self._pending[:self._max_batch],
                                        self._pending[self._max_batch:])
            if batch:
                self._flush_batch(batch)

    def _flush_batch(self, batch):
        futs = [f for _, _, f in batch]

        def attempt(rid, handle, nonce):
            if nonce is None:
                reqs = [(a, k) for a, k, _ in batch]
            else:
                # per-member nonces: handle_batch may have PARTIALLY
                # executed before the reply was lost, so a replayed
                # batch deduplicates member-by-member on the replica
                reqs = [(a, dict(k, **{_NONCE_KWARG: f"{nonce}.{i}"}))
                        for i, (a, k, _) in enumerate(batch)]
            t0 = time.monotonic()
            outs = ray_tpu_torch.get(handle.handle_batch.remote(reqs))
            self._observe_ttft(rid, time.monotonic() - t0)
            return outs

        status, out = run_with_replay(
            self, lambda failed: self._pick(avoid=failed), attempt,
            weight=len(batch))
        if status == "ok":
            for f, o in zip(futs, out):
                f.set_result(o)
        else:
            for f in futs:
                f.set_exception(out)

    # ---------------------------------------------------------------- engine

    def stream_request(self, args, kwargs, timeout_s: float = 600.0,
                       model_id: Optional[str] = None,
                       priority=None, deadline_s: Optional[float] = None,
                       session_id: Optional[str] = None):
        """Streaming entry point. Generator deployments (the callable
        uses ``yield``) ride ``num_returns="streaming"`` actor calls:
        each yielded item seals into the object store as produced and is
        pulled here via ObjectRefGenerator. Engine deployments (LLM
        continuous batching) fall back to the submit/peek mailbox. A
        deployment that is neither fails with a clear TypeError.

        Admission runs EAGERLY — in this call, not on first iteration —
        so a shed surfaces as a raised BackpressureError the caller (and
        the HTTP proxy's status-line mapping) sees before any bytes
        stream. A request whose deadline expires mid-stream is shed
        typed too: the stream raises BackpressureError after cancelling
        the replica-side work."""
        self._ensure_report_thread()
        pr, dl = self._resolve_qos(priority, deadline_s)
        if self._streaming and not self._engine:
            token = self._admit(pr, dl)
            return _TokenStream(
                self._generator_stream(args, kwargs, timeout_s,
                                       model_id, token, dl, session_id),
                token)
        if not self._engine:
            raise TypeError(
                f"deployment {self._name!r} is neither a generator nor "
                "an engine: stream() needs a callable that yields, or "
                "an engine exposing submit/peek/collect; use .remote() "
                "for request/response")
        if model_id is not None:
            # the engine mailbox mixes requests across model ids
            raise ValueError(
                "multiplexed_model_id is not supported for engine "
                "streaming deployments")
        token = self._admit(pr, dl)
        return _TokenStream(
            self._engine_stream(args, kwargs, timeout_s, token, dl,
                                session_id),
            token)

    def _generator_stream(self, args, kwargs, timeout_s: float,
                          model_id: Optional[str],
                          token: Optional[_DepthToken] = None,
                          deadline_s: Optional[float] = None,
                          session_id: Optional[str] = None):
        """Consume a generator replica: one streaming actor call, yield
        each item as its ref arrives (backpressure rides the stream's
        credit window, so a slow consumer stalls the replica's yields)."""
        from ray_tpu_torch.exceptions import ObjectTimeoutError
        from ray_tpu_torch.serve.multiplex import _MUX_KWARG

        if model_id is not None:
            kwargs = dict(kwargs, **{_MUX_KWARG: model_id})
        rid, handle = self._pick(model_id, session_id=session_id)
        with self._lock:
            self._inflight[rid] = self._inflight.get(rid, 0) + 1
        t0 = time.monotonic()
        deadline = t0 + timeout_s
        req_deadline = None if deadline_s is None else t0 + deadline_s
        first = True
        gen = None
        try:
            gen = handle.handle_stream.options(
                num_returns="streaming").remote(args, kwargs)
            while True:
                now = time.monotonic()
                remaining = deadline - now
                if req_deadline is not None:
                    remaining = min(remaining, req_deadline - now)
                if remaining <= 0:
                    if (req_deadline is not None
                            and req_deadline <= deadline):
                        # mid-flight shed: deadline expired while
                        # streaming — close typed, not a generic timeout
                        raise self._shed(
                            f"stream shed: {deadline_s:.3f}s deadline "
                            f"expired mid-flight", self._depth_now())
                    raise TimeoutError(
                        f"stream exceeded {timeout_s}s")
                try:
                    ref = gen.next_ref(timeout=remaining)
                except StopIteration:
                    gen = None  # drained: nothing to cancel
                    return
                except ObjectTimeoutError:
                    continue  # deadline check at loop top decides
                if first:
                    first = False
                    self._observe_ttft(rid, time.monotonic() - t0)
                yield ray_tpu_torch.get(ref)
        except ActorDiedError:
            self._drop_replica(rid)
            raise
        finally:
            if gen is not None:
                # abandoned/errored mid-stream: stop the replica-side
                # generator so it doesn't keep producing into the void
                try:
                    ray_tpu_torch.cancel(gen)
                except Exception:  # noqa: BLE001
                    pass
            with self._lock:
                if rid in self._inflight:  # dropped replicas stay dropped
                    self._inflight[rid] = max(0, self._inflight[rid] - 1)
            if token is not None:
                token.release()

    def _engine_stream(self, args, kwargs, timeout_s: float,
                       token: Optional[_DepthToken] = None,
                       deadline_s: Optional[float] = None,
                       session_id: Optional[str] = None):
        """Generator over an engine request's progress: yields lists of
        NEW tokens as they are generated, ending after the final chunk
        (reference: serve streaming responses / vLLM token streaming).
        Requires an engine with ``peek`` (the LLM engine); bounded by
        ``timeout_s`` overall and, when the request carries a deadline,
        shed typed (BackpressureError, generation cancelled) the moment
        the deadline expires mid-flight.

        Under ``serve_request_replay`` the stream survives replica loss:
        the router checkpoints a delivered-token watermark (tokens the
        consumer has actually received), and on ActorDiedError — or the
        injected ``stream_resume`` fault site — resubmits
        ``prompt + tokens_so_far`` to the next pick (cache affinity makes
        the replayed prefix cheap on a warm replica) with the new-token
        budget shrunk by the watermark. The client stream splices at the
        watermark: greedy decoding regenerates the identical
        continuation, with no duplicated or missing tokens. Flag off,
        replica loss kills the stream exactly as before."""
        t0 = time.monotonic()
        deadline = t0 + timeout_s
        req_deadline = None if deadline_s is None else t0 + deadline_s
        delivered: list = []  # resume watermark: tokens the consumer got
        max_attempts = replay_attempts()
        attempts = 0
        last: Optional[BaseException] = None
        failed: set = set()
        try:
            while attempts < max_attempts:
                attempts += 1
                a, k = self._resume_call(args, kwargs, delivered)
                if a is None:
                    return  # watermark exhausted the budget: complete
                with self._lock:
                    self._req_seq += 1
                    req_id = f"s{id(self)}-{self._req_seq}"
                rid, handle = self._pick(
                    prompt_tokens=self._prompt_of(a, k),
                    session_id=session_id, avoid=failed)
                with self._lock:
                    self._inflight[rid] = self._inflight.get(rid, 0) + 1
                try:
                    yield from self._stream_attempt(
                        rid, handle, req_id, a, k, delivered, t0,
                        deadline, req_deadline, deadline_s, timeout_s)
                    return
                except ActorDiedError as e:
                    if not config.serve_request_replay:
                        # seed behavior: replica loss kills the stream
                        self._drop_replica(rid)
                        raise
                    last = e
                    failed.add(rid)
                    self._note_replica_failure(rid)
                except (GetTimeoutError, ObjectTimeoutError) as e:
                    if not config.serve_request_replay:
                        raise  # seed behavior: a poll timeout is terminal
                    last = e
                    failed.add(rid)
                    self._note_replica_failure(rid)
                finally:
                    with self._lock:
                        if rid in self._inflight:
                            self._inflight[rid] = max(
                                0, self._inflight[rid] - 1)
            raise exhausted_error(self._name, attempts, last)
        finally:
            if token is not None:
                token.release()

    def _stream_attempt(self, rid: str, handle, req_id: str, args, kwargs,
                        delivered: list, t0: float, deadline: float,
                        req_deadline: Optional[float],
                        deadline_s: Optional[float], timeout_s: float):
        """One dispatch of an engine stream: submit + peek-poll, yielding
        chunks of new tokens. Each chunk is appended to ``delivered``
        (the resume watermark) only AFTER the consumer's ``next()``
        returned — a chunk lost between peek and delivery replays."""
        first = not delivered  # TTFT belongs to the original first token
        collected = False
        try:
            ray_tpu_torch.get(handle.submit.remote(req_id, *args, **kwargs))
            sent = 0
            while True:
                snap = ray_tpu_torch.get(
                    handle.peek.remote([req_id], {req_id: sent}),
                    timeout=60)
                if snap is None:
                    raise TypeError(
                        "deployment's engine has no peek(): token "
                        "streaming needs the LLM engine surface; use "
                        ".remote() for request/response")
                snap = snap.get(req_id)
                if snap is not None:
                    if "error" in snap:
                        collected = True  # collect below drains the error
                        ray_tpu_torch.get(handle.collect.remote([req_id]),
                                          timeout=60)
                        raise RuntimeError(snap["error"])
                    new = snap["tokens"]
                    if new:
                        if first:
                            first = False
                            self._observe_ttft(rid,
                                               time.monotonic() - t0)
                        yield new
                        delivered.extend(new)
                        sent = snap["offset"] + len(new)
                        if fault_injection.enabled():
                            action = fault_injection.fire(
                                "stream_resume", self._name)
                            if action == "drop":
                                raise ActorDiedError(
                                    "injected stream_resume: engine "
                                    f"replica {rid} died mid-stream")
                    if snap["done"]:
                        collected = True
                        ray_tpu_torch.get(handle.collect.remote([req_id]),
                                          timeout=60)
                        return
                now = time.monotonic()
                if req_deadline is not None and now > req_deadline:
                    # mid-flight shed: the finally block cancels the
                    # engine request so no generation leaks
                    raise self._shed(
                        f"stream shed: {deadline_s:.3f}s deadline "
                        f"expired mid-flight", self._depth_now())
                if now > deadline:
                    raise TimeoutError(
                        f"stream {req_id} exceeded {timeout_s}s")
                time.sleep(0.005)
        finally:
            if not collected:
                # abandoned/errored mid-stream: abort generation and
                # drop any finished result so nothing leaks replica-side
                try:
                    handle.cancel.remote(req_id)
                except Exception:  # noqa: BLE001
                    pass

    @staticmethod
    def _resume_call(args, kwargs, delivered: list):
        """Rebuild an engine submit call for mid-stream resume: the new
        prompt is ``original prompt + delivered tokens`` (the prefix
        cache makes the replay cheap) and the explicit new-token budget
        shrinks by the watermark so the resumed generation stops exactly
        where the uninterrupted one would. Returns (args, kwargs) —
        unchanged when nothing was delivered yet — or (None, None) when
        the watermark already exhausted the budget (stream complete).
        Engines running on their default budget regenerate the remainder
        under their own cap."""
        if not delivered:
            return args, kwargs
        args = list(args)
        kwargs = dict(kwargs)
        prompt = args[0] if args else kwargs.get("prompt_tokens")
        prompt = list(prompt) + [int(t) for t in delivered]
        if args:
            args[0] = prompt
        else:
            kwargs["prompt_tokens"] = prompt
        max_new = None
        if len(args) >= 2 and args[1] is not None:
            max_new = int(args[1])
        elif kwargs.get("max_new_tokens") is not None:
            max_new = int(kwargs["max_new_tokens"])
        if max_new is not None:
            remaining = max_new - len(delivered)
            if remaining <= 0:
                return None, None
            if len(args) >= 2 and args[1] is not None:
                args[1] = remaining
            else:
                kwargs["max_new_tokens"] = remaining
        return tuple(args), kwargs

    @staticmethod
    def _prompt_of(args: tuple, kwargs: dict) -> Optional[list]:
        """The prompt token list of an engine submit call (positional
        ``prompt_tokens`` or the kwarg) — what cache-affinity scores.
        None for shapes the engine surface doesn't use anyway."""
        toks = args[0] if args else kwargs.get("prompt_tokens")
        return toks if isinstance(toks, (list, tuple)) else None

    def _engine_request(self, args, kwargs, fut: Future,
                        session_id: Optional[str] = None):
        """Submit to an engine replica's mailbox and poll its collect()."""
        self._engine_dispatch(args, kwargs, fut, session_id, 0, None)

    def _engine_dispatch(self, args, kwargs, fut: Future,
                         session_id: Optional[str],
                         attempts: int, last: Optional[BaseException],
                         avoid: Optional[set] = None):
        """Dispatch (or re-dispatch after replica loss) one engine
        request: pick, submit to the replica's mailbox, and ensure its
        collect poller. The req_id is fresh per attempt — the engine
        deduplicates repeated submits of the SAME id (a replay racing a
        delivered-but-unacked first submit runs the generation once),
        while a fresh id on a NEW replica regenerates a request whose
        result died with its replica. ``attempts``/``last``/``avoid``
        carry the budget and the dead-replica set across _poll_engine
        re-dispatches."""
        max_attempts = replay_attempts()
        avoid = set(avoid or ())
        while attempts < max_attempts:
            attempts += 1
            with self._lock:
                self._req_seq += 1
                req_id = f"r{id(self)}-{self._req_seq}"
            try:
                rid, handle = self._pick(
                    prompt_tokens=self._prompt_of(args, kwargs),
                    session_id=session_id, avoid=avoid)
            except ReplicaUnavailableError as e:
                if last is not None:
                    e = exhausted_error(self._name, attempts - 1, last)
                fut.set_exception(e)
                return
            if fault_injection.enabled():
                action = fault_injection.fire(
                    "serve_replica_kill", f"{self._name}:{rid}")
                if action in ("die", "die_after"):
                    # both variants collapse on the mailbox path: the
                    # submit (or the replica holding its result) is lost
                    # before collect, and the fresh req_id on the next
                    # attempt regenerates safely
                    last = ActorDiedError(
                        "injected serve_replica_kill: engine replica "
                        f"{rid} died")
                    avoid.add(rid)
                    self._note_replica_failure(rid)
                    continue
            with self._lock:
                self._inflight[rid] = self._inflight.get(rid, 0) + 1
                st = self._engine_state.setdefault(rid, {
                    "futures": {}, "poller": None, "handle": handle,
                })
                st["futures"][req_id] = {
                    "fut": fut, "args": args, "kwargs": kwargs,
                    "session_id": session_id, "attempts": attempts,
                    "t0": time.monotonic(),
                }
            try:
                ray_tpu_torch.get(
                    handle.submit.remote(req_id, *args, **kwargs))
            except ActorDiedError as e:
                with self._lock:
                    st["futures"].pop(req_id, None)
                    if rid in self._inflight:
                        self._inflight[rid] -= 1
                last = e
                avoid.add(rid)
                self._note_replica_failure(rid)
                continue
            except BaseException as e:  # noqa: BLE001 — app error: terminal
                with self._lock:
                    st["futures"].pop(req_id, None)
                    if rid in self._inflight:
                        self._inflight[rid] -= 1
                fut.set_exception(e)
                return
            with self._lock:
                if st["poller"] is None or not st["poller"].is_alive():
                    st["poller"] = threading.Thread(
                        target=self._poll_engine, args=(rid, st),
                        daemon=True)
                    st["poller"].start()
            return
        fut.set_exception(exhausted_error(self._name, attempts, last))

    def _poll_engine(self, rid: str, st: dict):
        handle = st["handle"]
        while True:
            with self._lock:
                if not st["futures"]:
                    return
                mine = list(st["futures"])
            try:
                # only this router's ids: collect() is destructive and
                # other handles/processes poll the same engine
                done = ray_tpu_torch.get(handle.collect.remote(mine),
                                         timeout=60)
            except BaseException as e:  # noqa: BLE001 — replica died/hung
                with self._lock:
                    entries = list(st["futures"].values())
                    st["futures"].clear()
                    self._inflight[rid] = max(
                        0, self._inflight.get(rid, 0) - len(entries))
                    self._engine_state.pop(rid, None)
                self._note_replica_failure(rid)
                # replica loss must not fail the in-flight requests:
                # each re-dispatches with a fresh req_id against the
                # next pick, up to its remaining replay budget
                for ent in entries:
                    threading.Thread(
                        target=self._engine_dispatch,
                        args=(ent["args"], ent["kwargs"], ent["fut"],
                              ent["session_id"], ent["attempts"], e,
                              {rid}),
                        daemon=True).start()
                return
            resolved = []
            if done:
                with self._lock:
                    for req_id, result in done.items():
                        ent = st["futures"].pop(req_id, None)
                        if ent is not None:
                            resolved.append((ent, result))
                    self._inflight[rid] = max(
                        0, self._inflight.get(rid, 0) - len(resolved))
            if resolved:
                if config.serve_replica_ejection:
                    self._health.note_ok(rid)
                for ent, result in resolved:
                    if isinstance(result, Exception):
                        ent["fut"].set_exception(result)
                    else:
                        self._observe_ttft(rid,
                                           time.monotonic() - ent["t0"])
                        ent["fut"].set_result(result)
            else:
                time.sleep(0.003)
