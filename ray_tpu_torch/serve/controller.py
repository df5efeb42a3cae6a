"""Serve controller: the deployment control plane, as an actor.

The port's copy of ``ray_tpu/serve/controller.py``.

Reconciles every deployment's target replica count against running
replicas and health-checks them from a background thread (reference:
serve/_private/controller.py:86 run_control_loop, deployment_state.py:1226
DeploymentState reconcile). Replica actors are created with max_restarts=0
— the controller itself is the restart FSM, so a dead replica is replaced
with a fresh one (and routers drop it on first failed call).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

import ray_tpu_torch

HEALTH_CHECK_PERIOD_S = 1.0
CONTROLLER_NAME = "SERVE_CONTROLLER"
#: gray-replica handling (serve_replica_ejection): routers report the
#: replicas they have locally ejected; a report not renewed within the
#: expiry restores the replica, one gray continuously for the replace
#: window gets probed (ping with a short timeout) and replaced — a
#: slow-but-alive replica passes the liveness ping yet still serves 10x
#: TTFT, so persistence of the routers' ejection IS the replace signal
GRAY_REPORT_EXPIRY_S = 3.0
GRAY_REPLACE_AFTER_S = 5.0
GRAY_PROBE_TIMEOUT_S = 2.0
GRAY_REPLACE_COOLDOWN_S = 10.0
#: KV rendezvous key the controller publishes serve demand under; the
#: cluster autoscaler (autoscaler_v2) reads it so serve queue depth and
#: TTFT percentiles count as demand alongside task queues + pending PGs.
SERVE_DEMAND_KEY = "serve:demand"
_DEMAND_PUBLISH_PERIOD_S = 0.5


class _ReplicaInfo:
    __slots__ = ("replica_id", "handle", "state", "last_healthy", "checking")

    def __init__(self, replica_id: str, handle):
        self.replica_id = replica_id
        self.handle = handle
        self.state = "STARTING"
        self.last_healthy = time.monotonic()
        self.checking = False


class _DeploymentInfo:
    def __init__(self, name: str, pickled_def: bytes, config: dict):
        self.name = name
        self.pickled_def = pickled_def
        self.config = dict(config)
        self.target = self._initial_target(config)
        self.replicas: Dict[str, _ReplicaInfo] = {}
        self.version = 0
        self.next_id = 0
        self.deleting = False
        # long-poll snapshot id: bumps on ANY change a router cares
        # about (running replica set, config/redeploy, deletion)
        self.snapshot = 1
        self._last_running_fp: tuple = ()
        # autoscaling state: router load reports + pending decision
        self.loads: Dict[str, tuple] = {}   # router_id -> (load, ts)
        self.desired_since: Optional[tuple] = None  # (desired, since_ts)
        # QoS telemetry: router-local admission depths and recent TTFT
        # samples (ms), aggregated into the serve:demand KV signal
        self.depths: Dict[str, tuple] = {}  # router_id -> (depth, ts)
        self.ttft_ms: deque = deque(maxlen=512)
        # cache-affinity telemetry: router_id -> (residency summary, ts);
        # the summary maps replica_id -> cached prefix-chain count
        self.residency: Dict[str, tuple] = {}
        # gray-replica reports: replica_id -> (first_reported_ts,
        # last_reported_ts); entries renew while any router still
        # ejects the replica and expire GRAY_REPORT_EXPIRY_S after the
        # last report (the replica recovered: restore, don't replace)
        self.gray: Dict[str, tuple] = {}
        self.last_gray_replace = 0.0

    @staticmethod
    def _initial_target(cfg: dict) -> int:
        au = cfg.get("autoscaling_config")
        if au:
            return int(au.get("min_replicas", 1))
        return int(cfg.get("num_replicas", 1))


class ServeController:
    """Actor. One per cluster (named actor SERVE_CONTROLLER)."""

    def __init__(self):
        self._deployments: Dict[str, _DeploymentInfo] = {}
        self._lock = threading.Lock()
        # long-poll push channel (reference: serve/_private/long_poll.py
        # LongPollHost): topology changes notify blocked listeners
        self._lp_cond = threading.Condition(self._lock)
        self._get_replicas_calls = 0  # pull-RPC counter (tests pin ~0)
        self._stop = False
        self._loop = threading.Thread(target=self._control_loop, daemon=True,
                                      name="serve-controller")
        self._loop.start()

    # ------------------------------------------------------------------- API

    def deploy(self, name: str, pickled_def: bytes, config: dict) -> None:
        with self._lock:
            info = self._deployments.get(name)
            if info is None:
                self._deployments[name] = _DeploymentInfo(
                    name, pickled_def, config)
            else:
                # redeploy: new code/config, replicas are rolled
                info.pickled_def = pickled_def
                info.config = dict(config)
                info.target = _DeploymentInfo._initial_target(config)
                info.version += 1
                info.deleting = False
                for r in list(info.replicas.values()):
                    self._stop_replica(info, r)
                self._bump_locked(info)

    def delete_deployment(self, name: str) -> None:
        with self._lock:
            info = self._deployments.get(name)
            if info is not None:
                info.deleting = True
                info.target = 0

    def scale(self, name: str, num_replicas: int) -> None:
        with self._lock:
            info = self._deployments.get(name)
            if info is None:
                raise KeyError(f"no deployment {name!r}")
            if info.config.get("autoscaling_config"):
                raise ValueError(
                    f"deployment {name!r} has autoscaling_config; a "
                    "manual scale would be silently reverted by the "
                    "autoscaler — redeploy without autoscaling_config "
                    "to pin the replica count")
            info.target = int(num_replicas)
            info.config["num_replicas"] = int(num_replicas)

    def report_load(self, name: str, router_id: str, load: int,
                    queue_depth: Optional[int] = None,
                    ttft_ms: Optional[List[float]] = None,
                    residency: Optional[dict] = None,
                    gray: Optional[List[str]] = None) -> None:
        """Routers push their in-flight count per deployment (reference:
        handles push autoscaling metrics to the controller); reports
        expire so a vanished router stops counting. QoS-era routers also
        carry their admission queue depth and the TTFT samples observed
        since the last report; cache-affinity routers additionally carry
        a residency summary ({"replicas": {rid: cached chain count},
        "cached_chains": total}) aggregated into status() /
        demand_snapshot(); ejection-era routers (serve_replica_ejection)
        carry the replica ids they currently hold gray — the control
        loop probes and replaces the persistently gray. Every extension
        defaults None, so the legacy 3-positional, the QoS 5-arg, the
        6-arg, and the 7-arg shapes all land here unchanged."""
        with self._lock:
            info = self._deployments.get(name)
            if info is not None:
                now = time.monotonic()
                info.loads[router_id] = (int(load), now)
                if queue_depth is not None:
                    info.depths[router_id] = (int(queue_depth), now)
                if ttft_ms:
                    info.ttft_ms.extend(float(x) for x in ttft_ms)
                if residency is not None:
                    info.residency[router_id] = (dict(residency), now)
                for rid in (gray or ()):
                    first, _ = info.gray.get(rid, (now, now))
                    info.gray[rid] = (first, now)

    def get_replicas(self, name: str):
        """(version, [(replica_id, actor_name)]) for router refresh."""
        with self._lock:
            self._get_replicas_calls += 1
            info = self._deployments.get(name)
            if info is None:
                return (0, [])
            return (info.version, self._running_list(info))

    @staticmethod
    def _running_list(info: "_DeploymentInfo"):
        return [(r.replica_id, r.handle)
                for r in info.replicas.values() if r.state == "RUNNING"]

    def get_replicas_snapshot(self, name: str):
        """(snapshot, version, replicas) — the long-poll seed."""
        with self._lock:
            info = self._deployments.get(name)
            if info is None:
                return (0, 0, [])
            return (info.snapshot, info.version, self._running_list(info))

    def listen_for_change(self, keys: Dict[str, int],
                          timeout_s: float = 30.0):
        """Long-poll host (reference: serve/_private/long_poll.py:64
        LongPollHost.listen_for_change): block until any watched key's
        snapshot exceeds the caller's, then return {key: (snapshot,
        payload)} for the changed keys; {} on timeout (caller re-arms).
        Keys are "replicas:<deployment>" (payload (version, [(rid,
        actor_name)])) or "config:<deployment>" (payload config dict).
        A deployment the caller has seen (last snapshot > 0) that no
        longer exists yields payload None — the listener's exit signal.
        Requires the controller actor's max_concurrency > number of
        concurrent listeners (get_or_create_controller sets it)."""
        deadline = time.monotonic() + max(0.0, min(float(timeout_s), 60.0))
        with self._lp_cond:
            while True:
                out: Dict[str, tuple] = {}
                for key, last in keys.items():
                    kind, _, name = key.partition(":")
                    info = self._deployments.get(name)
                    if info is None:
                        if int(last) > 0:
                            out[key] = (int(last) + 1, None)
                        continue
                    if info.snapshot > int(last):
                        if kind == "config":
                            payload: Any = dict(info.config)
                        else:
                            payload = (info.version,
                                       self._running_list(info))
                        out[key] = (info.snapshot, payload)
                if out:
                    return out
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return {}
                self._lp_cond.wait(remaining)

    def _bump_locked(self, info: "_DeploymentInfo"):
        info.snapshot += 1
        self._lp_cond.notify_all()

    def control_plane_stats(self) -> Dict[str, Any]:
        """Counters for tests/observability: pull-RPC volume should stay
        flat while the long-poll channel is healthy."""
        with self._lock:
            return {"get_replicas_calls": self._get_replicas_calls}

    def get_deployment_config(self, name: str) -> Optional[dict]:
        with self._lock:
            info = self._deployments.get(name)
            return dict(info.config) if info else None

    @staticmethod
    def _cached_chains(info) -> int:
        """Aggregate the routers' residency summaries into one number:
        per replica, the max chain count any router reported (reports
        describe the same replica cache, so max — not sum — dedups),
        summed across replicas."""
        per_replica: Dict[str, int] = {}
        for summary, _ in info.residency.values():
            for rid, n in (summary.get("replicas") or {}).items():
                per_replica[rid] = max(per_replica.get(rid, 0), int(n))
        return sum(per_replica.values())

    def status(self) -> Dict[str, Any]:
        from ray_tpu_torch.serve.qos import percentile

        with self._lock:
            return {
                name: {
                    "target": info.target,
                    "running": sum(1 for r in info.replicas.values()
                                   if r.state == "RUNNING"),
                    "starting": sum(1 for r in info.replicas.values()
                                    if r.state == "STARTING"),
                    "version": info.version,
                    "deleting": info.deleting,
                    "queue_depth": sum(d for d, _ in info.depths.values()),
                    "ttft_p50_ms": percentile(info.ttft_ms, 50),
                    "ttft_p99_ms": percentile(info.ttft_ms, 99),
                    "cached_prefix_chains": self._cached_chains(info),
                }
                for name, info in self._deployments.items()
            }

    def demand_snapshot(self) -> Dict[str, Any]:
        """The serve-demand signal as published to the ``serve:demand``
        KV key (minus the timestamp): per-deployment admission queue
        depth (summed over live routers) and TTFT percentiles over the
        recent sample window."""
        from ray_tpu_torch.serve.qos import percentile

        now = time.monotonic()
        out: Dict[str, Any] = {}
        with self._lock:
            for name, info in self._deployments.items():
                for rid, (_, ts) in list(info.depths.items()):
                    if now - ts >= 3.0:  # vanished router: expire like loads
                        del info.depths[rid]
                for rid, (_, ts) in list(info.residency.items()):
                    if now - ts >= 3.0:
                        del info.residency[rid]
                out[name] = {
                    "queue_depth": sum(d for d, _ in info.depths.values()),
                    "ttft_p50_ms": percentile(info.ttft_ms, 50),
                    "ttft_p99_ms": percentile(info.ttft_ms, 99),
                    "cached_prefix_chains": self._cached_chains(info),
                }
        return out

    def wait_healthy(self, name: str, timeout: float = 60.0) -> bool:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                info = self._deployments.get(name)
                if info is not None:
                    running = sum(1 for r in info.replicas.values()
                                  if r.state == "RUNNING")
                    if running >= info.target:
                        return True
            time.sleep(0.05)
        return False

    def shutdown(self) -> None:
        self._stop = True
        with self._lock:
            for info in self._deployments.values():
                info.target = 0
                for r in list(info.replicas.values()):
                    self._stop_replica(info, r)
            self._deployments.clear()
        # wait for the backgrounded stops: returning before replicas (and
        # their DAG stage actors) are gone would leak them past process
        # teardown
        from ray_tpu_torch.core.config import config

        deadline = time.monotonic() + config.serve_shutdown_grace_s
        for t in getattr(self, "_stop_threads", []):
            t.join(max(0.1, deadline - time.monotonic()))

    # --------------------------------------------------------- control loop

    def _control_loop(self):
        last_publish = 0.0
        while not self._stop:
            try:
                self._reconcile()
                self._health_check()
                self._probe_gray()
                self._notify_topology_changes()
                now = time.monotonic()
                if now - last_publish >= _DEMAND_PUBLISH_PERIOD_S:
                    last_publish = now
                    self._publish_demand()
            except Exception:  # noqa: BLE001 — the loop must survive
                pass
            time.sleep(0.1)

    def _publish_demand(self):
        """Push the serve-demand signal to the cluster KV so the node
        autoscaler sees serving pressure (queue depth, TTFT percentiles)
        as demand, not just task queues and pending placement groups.
        Best-effort: a missing core (unit tests instantiate the
        controller in-process) or KV hiccup skips the publish — the next
        tick retries."""
        from ray_tpu_torch.core import runtime_context

        core = runtime_context.get_core_or_none()
        if core is None:
            return
        payload = {"ts": time.time(), "deployments": self.demand_snapshot()}
        try:
            core.kv_op("put", SERVE_DEMAND_KEY, payload)
        except Exception:  # noqa: BLE001 — telemetry only, never fatal
            pass

    def _notify_topology_changes(self):
        """Push side of the long-poll channel: one fingerprint sweep per
        control-loop tick catches every running-set transition (replica
        became RUNNING, died, was rolled) wherever it happened."""
        with self._lp_cond:
            for info in self._deployments.values():
                fp = tuple(sorted(
                    r.replica_id for r in info.replicas.values()
                    if r.state == "RUNNING"))
                if fp != info._last_running_fp:
                    info._last_running_fp = fp
                    self._bump_locked(info)

    def _autoscale(self, info: "_DeploymentInfo") -> None:
        """Load-based target adjustment (reference:
        serve/_private/autoscaling_policy.py): desired =
        ceil(total_ongoing / target_ongoing_requests), clamped to
        [min_replicas, max_replicas]; a change must persist for
        upscale_delay_s / downscale_delay_s before it is applied."""
        au = info.config.get("autoscaling_config")
        if not au or info.deleting:
            return
        import math

        now = time.monotonic()
        with self._lock:
            # prune vanished routers (short-lived drivers would otherwise
            # grow this dict forever)
            for rid, (_, ts) in list(info.loads.items()):
                if now - ts >= 3.0:
                    del info.loads[rid]
            total = sum(load for load, _ in info.loads.values())
            lo = int(au.get("min_replicas", 1))
            hi = int(au.get("max_replicas", max(lo, 1)))
            per = max(1e-9, float(au.get("target_ongoing_requests", 2)))
            desired = min(hi, max(lo, math.ceil(total / per)))
            if desired == info.target:
                info.desired_since = None
                return
            if (info.desired_since is None
                    or info.desired_since[0] != desired):
                info.desired_since = (desired, now)
                return
            delay = (float(au.get("upscale_delay_s", 1.0))
                     if desired > info.target
                     else float(au.get("downscale_delay_s", 5.0)))
            if now - info.desired_since[1] >= delay:
                info.target = desired
                info.desired_since = None

    def _reconcile(self):
        with self._lock:
            deployments = list(self._deployments.values())
        for info in deployments:
            self._autoscale(info)
            with self._lock:
                n = len(info.replicas)
                deficit = info.target - n
                surplus = n - info.target
            for _ in range(max(0, deficit)):
                self._start_replica(info)
            if surplus > 0:
                with self._lock:
                    victims = list(info.replicas.values())[:surplus]
                    for v in victims:
                        self._stop_replica(info, v)
            if info.deleting and info.target == 0:
                with self._lp_cond:
                    if not info.replicas:
                        self._deployments.pop(info.name, None)
                        # listeners see info=None → exit signal
                        self._lp_cond.notify_all()

    def _start_replica(self, info: _DeploymentInfo):
        import cloudpickle

        from ray_tpu_torch.serve.replica import ReplicaActor

        with self._lock:
            info.next_id += 1
            replica_id = f"{info.name}#{info.version}.{info.next_id}"
        opts = {"num_cpus": float(info.config.get("num_cpus", 0.1))}
        if info.config.get("num_gpus"):
            opts["num_gpus"] = info.config["num_gpus"]
        if info.config.get("resources"):
            opts["resources"] = info.config["resources"]
        try:
            handle = ReplicaActor.options(**opts).remote(
                info.pickled_def,
                info.config.get("init_args") or (),
                info.config.get("init_kwargs") or {})
        except Exception:  # noqa: BLE001 — no capacity yet; retry next tick
            return
        rinfo = _ReplicaInfo(replica_id, handle)
        with self._lock:
            info.replicas[replica_id] = rinfo
        # confirm constructor success asynchronously (the control loop must
        # not block on a slow model load)
        def confirm():
            try:
                ray_tpu_torch.get(handle.ping.remote(), timeout=120)
                rinfo.state = "RUNNING"
                rinfo.last_healthy = time.monotonic()
            except Exception:  # noqa: BLE001
                with self._lock:
                    info.replicas.pop(replica_id, None)
                try:
                    ray_tpu_torch.kill(handle)
                except Exception:  # noqa: BLE001
                    pass
        threading.Thread(target=confirm, daemon=True).start()

    def _stop_replica(self, info: _DeploymentInfo, r: _ReplicaInfo):
        info.replicas.pop(r.replica_id, None)
        handle = r.handle

        def stop():
            try:
                # graceful first: lets DAG-mode replicas tear down their
                # stage-actor pipelines (they would outlive their creator)
                ray_tpu_torch.get(handle.graceful_shutdown.remote(), timeout=5)
            except Exception:  # noqa: BLE001
                pass
            try:
                ray_tpu_torch.kill(handle)
            except Exception:  # noqa: BLE001
                pass

        # background: call sites hold the controller lock — a busy
        # replica must not stall the whole control plane for its grace
        # period. The threads are tracked so shutdown() can join them
        # (a daemon thread killed at exit would leak the stage actors
        # the graceful path exists to reclaim).
        t = threading.Thread(target=stop, daemon=True, name="replica-stop")
        if not hasattr(self, "_stop_threads"):
            self._stop_threads = []
        self._stop_threads = [x for x in self._stop_threads
                              if x.is_alive()] + [t]
        t.start()

    def _probe_gray(self):
        """Act on the routers' gray-replica reports: expire entries no
        router has renewed (the replica recovered — routers restore it
        locally after their own cooldown, the controller just forgets),
        drop entries for replicas that already left the deployment, and
        probe-then-replace one that has stayed gray past the replace
        window. The probe is a short-timeout ping: whether it passes
        (slow-but-alive, the gray signature) or fails (wedged), the
        replica is replaced — persistence of the ejection is the
        signal, the probe only distinguishes the two for the kill path
        having a live target. Replacement is rate-limited to one per
        cooldown per deployment so a fleet-wide slowdown (overload, not
        grayness) cannot cascade into mass replacement."""
        now = time.monotonic()
        victims = []
        with self._lock:
            for info in self._deployments.values():
                for rid, (first, last_ts) in list(info.gray.items()):
                    if now - last_ts >= GRAY_REPORT_EXPIRY_S:
                        del info.gray[rid]
                        continue
                    r = info.replicas.get(rid)
                    if r is None or r.state != "RUNNING":
                        del info.gray[rid]
                        continue
                    if (now - first >= GRAY_REPLACE_AFTER_S
                            and now - info.last_gray_replace
                            >= GRAY_REPLACE_COOLDOWN_S
                            and sum(1 for x in info.replicas.values()
                                    if x.state == "RUNNING") > 1):
                        info.last_gray_replace = now
                        info.gray.pop(rid, None)
                        victims.append((info, r))
                        break  # at most one per deployment per sweep

        def probe_and_replace(info, r):
            try:
                ray_tpu_torch.get(r.handle.ping.remote(),
                                  timeout=GRAY_PROBE_TIMEOUT_S)
            except Exception:  # noqa: BLE001 — wedged, not just slow
                pass
            with self._lock:
                if r.replica_id in info.replicas:
                    self._stop_replica(info, r)
            # _reconcile starts the replacement on its next tick

        for info, r in victims:
            threading.Thread(target=probe_and_replace, args=(info, r),
                             daemon=True).start()

    def _health_check(self):
        now = time.monotonic()
        with self._lock:
            checks = [(info, r) for info in self._deployments.values()
                      for r in info.replicas.values()
                      if r.state == "RUNNING"]
        for info, r in checks:
            if now - r.last_healthy < HEALTH_CHECK_PERIOD_S or r.checking:
                continue
            r.checking = True

            def check(info=info, r=r):
                try:
                    ray_tpu_torch.get(r.handle.ping.remote(), timeout=10)
                    r.last_healthy = time.monotonic()
                except Exception:  # noqa: BLE001 — dead/stuck: replace it
                    with self._lock:
                        info.replicas.pop(r.replica_id, None)
                    try:
                        # a stuck-but-alive actor must not keep its
                        # resource grant after being replaced
                        ray_tpu_torch.kill(r.handle)
                    except Exception:  # noqa: BLE001
                        pass
                finally:
                    r.checking = False
            threading.Thread(target=check, daemon=True).start()


def get_or_create_controller():
    """Driver/worker helper: the controller is a named detached-style actor."""
    import ray_tpu_torch

    try:
        return ray_tpu_torch.get_actor(CONTROLLER_NAME)
    except Exception:  # noqa: BLE001
        from ray_tpu_torch.api import remote

        # max_concurrency: long-poll listeners (one per router: proxies,
        # drivers, replicas holding handles) each BLOCK one executor
        # slot in listen_for_change; serial execution would head-of-line
        # block deploys and load reports behind them. 128 bounds the
        # fleet size this control plane serves crisply — beyond that,
        # listener queuing degrades push latency toward the 10 s poll
        # timeout (scale the constant with the deployment fan-out).
        cls = remote(num_cpus=0.05, name=CONTROLLER_NAME,
                     max_concurrency=128)(ServeController)
        try:
            return cls.remote()
        except ValueError:
            # raced another creator
            return ray_tpu_torch.get_actor(CONTROLLER_NAME)
