"""Driver-side core client for a multi-node cluster.

Implements the same interface the embedded single-node ``Runtime`` exposes
to the public API (api.py / actor.py / remote_function.py /
placement_group.py), but routes every operation to node servers over RPC:

- tasks: resource-fit node selection from the GCS cluster view (least
  loaded, most available), lazy per-node function shipping
- objects: owner-hint routed gets (the node a task was sent to serves its
  returns, proxying if it spilled the task), put to the home node
- actors: placement like tasks, location-transparent handles, restart on a
  different node when the hosting node dies (driver-side FSM; the
  reference's gcs_actor_manager does this inside the GCS)
- placement groups: cluster PGs composed of node-local PGs (STRICT_PACK
  pins one node; SPREAD distributes bundles round-robin)

The reference analogue of this layer is the CoreWorker's
NormalTaskSubmitter + ActorTaskSubmitter + ownership tables
(src/ray/core_worker/core_worker.h), minus distributed refcounting: the
driver owns every ref it creates, like the single-node runtime.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ray_tpu_torch.core import netem, protocol, serialization
from ray_tpu_torch.core.cluster.ha import HaGcsClient
from ray_tpu_torch.core.cluster.rpc import ClientCache, RpcError, cluster_authkey
from ray_tpu_torch.core.config import config
from ray_tpu_torch.core.ids import ActorID, JobID, NodeID, ObjectID, PlacementGroupID, WorkerID
from ray_tpu_torch.core.object_ref import ObjectRef
from ray_tpu_torch.core.placement_group import PlacementGroup
from ray_tpu_torch.core.runtime import NUM_TPUS_REFUSED
from ray_tpu_torch.util.debug_lock import make_lock
from ray_tpu_torch.exceptions import (ActorDiedError, ActorUnavailableError,
                                GetTimeoutError, ObjectLostError,
                                ObjectTimeoutError, PlacementGroupError)


class _ClusterPG:
    __slots__ = ("pg_id", "bundles", "strategy", "name", "placements",
                 "node_pgs")

    def __init__(self, pg_id, bundles, strategy, name):
        self.pg_id = pg_id
        self.bundles = bundles
        self.strategy = strategy
        self.name = name
        # per-bundle: (node_addr, local_pg_id_bytes, local_bundle_index)
        self.placements: List[Tuple[Tuple[str, int], bytes, int]] = []
        # node_addr -> local_pg_id_bytes
        self.node_pgs: Dict[Tuple[str, int], bytes] = {}


class ClusterCore:
    """Driver client to a ray_tpu_torch cluster (GCS + node servers)."""

    def __init__(self, gcs_address: Tuple[str, int],
                 authkey: Optional[bytes] = None):
        self._authkey = authkey or cluster_authkey()
        # netem source selector: outbound driver edges match "driver"
        # role rules (nothing dials the driver, so no listen address)
        netem.set_identity("driver")
        # ride-through GCS client: calls park (bounded by
        # gcs_op_buffer_max / gcs_reconnect_timeout_s) while the head is
        # down, then fail with the typed GcsUnavailableError; a detected
        # head restart re-registers this driver and clamps pubsub cursors
        self.gcs = HaGcsClient(tuple(gcs_address), self._authkey,
                               on_reconnect=self._on_gcs_reconnect)
        self.gcs.call(("ping",))
        self._nodes = ClientCache(self._authkey)
        self.job_id = JobID.from_random()
        self.node_id = NodeID.from_random()     # driver pseudo-node id
        self.worker_id = WorkerID.from_random()

        self._lock = make_lock("ClusterCore._lock")
        self._functions: Dict[bytes, bytes] = {}
        self._fn_cache: Dict[int, Tuple[bytes, Any]] = {}
        self._shipped: Dict[Tuple[str, int], set] = {}
        self._ref_node: Dict[bytes, Tuple[str, int]] = {}
        # actors whose restart FSM the GCS accepted (register_actor_spec
        # succeeded); the driver restarts only the others
        self._gcs_owned: set = set()
        # driver-side tombstones for eagerly freed ids: a get after free
        # must fail fast with the documented freed message, not spend the
        # fetch deadline discovering no copy exists (mirrors Runtime._freed;
        # insertion-ordered so note_freed evicts oldest-first)
        self._freed: Dict[bytes, None] = {}
        # lineage: first-return-id -> resubmittable task description, for
        # reconstructing objects lost to node death (reference:
        # object_recovery_manager.h:41). Keyed per return id.
        # insertion-ordered; evicted oldest-first under the byte budget
        from collections import OrderedDict
        self._lineage: "OrderedDict[bytes, tuple]" = OrderedDict()
        self._lineage_bytes = 0
        self._reconstructions: Dict[bytes, int] = {}
        self._actor_node: Dict[ActorID, Tuple[str, int]] = {}
        # addresses of nodes the GCS declared dead (until one comes back)
        self._dead_addrs: set = set()
        self._actor_opts: Dict[ActorID, dict] = {}
        self._actor_spec: Dict[ActorID, tuple] = {}  # for restart
        self._pgs: Dict[PlacementGroupID, _ClusterPG] = {}
        # driver-local sentinel objects (e.g. cluster PG ready refs)
        self._local: Dict[bytes, Tuple[threading.Event, list]] = {}
        self._rr = 0
        # object-location cache: oid -> (addrs, cached_at). Fed by
        # loc_get_batch; invalidated by the GCS "freed" channel, node
        # death, and locality_cache_ttl_s. Only a scheduling hint —
        # staleness costs placement quality, never correctness.
        self._loc_cache: Dict[bytes, Tuple[List[Tuple[str, int]], float]] = {}
        # known object sizes (driver puts + directory replies); sizes are
        # immutable so entries never go stale, only die on free
        self._obj_size: Dict[bytes, int] = {}
        # locality-scheduling observability (mutated under self._lock):
        # hits/misses count submissions that did/didn't land on the node
        # holding the most qualifying argument bytes; bytes_local is the
        # cross-node transfer volume locality avoided, bytes_remote what
        # still has to move
        self.locality_stats: Dict[str, int] = {
            "hits": 0, "misses": 0, "bytes_local": 0, "bytes_remote": 0,
            "batched_lookups": 0, "cache_hits": 0,
        }

        self._view: Optional[dict] = None
        self._view_time = 0.0
        self._death_seq = 0
        self._freed_seq = 0  # cursor into the GCS "freed" channel
        # cursor into the GCS "actor_state" channel + last seen restart-FSM
        # state per actor (aid bytes -> message dict): RESTARTING gates
        # call retries on the restart finishing instead of failing fast
        self._actor_state_seq = 0
        self._actor_states: Dict[bytes, dict] = {}
        self._monitor_stop = False
        # owner identity: this driver registers with the GCS and
        # heartbeats; if it dies, nodes reclaim its objects and its
        # non-detached actors stop restarting (reference: owner-failure
        # semantics of reference_count.h:61, GCS-mediated)
        self._driver_id = self.job_id.binary()
        try:
            self.gcs.call(("register_driver", self._driver_id, {}))
        except RpcError:
            pass
        self._beat = self._start_beat(tuple(gcs_address))
        self._monitor = threading.Thread(target=self._death_watch,
                                         daemon=True, name="driver-deaths")
        self._monitor.start()

        view = self._cluster_view(force=True)
        if not view["nodes"]:
            raise RuntimeError("cluster has no alive nodes")
        self._home: Tuple[str, int] = tuple(view["nodes"][0]["address"])

        # local store fast path: if the home node is on this host, read big
        # objects straight out of its shm store (zero-copy) instead of TCP.
        self._home_store = None
        self.store = None
        try:
            import socket as _s

            home = next(n for n in view["nodes"]
                        if tuple(n["address"]) == self._home)
            if home["topology"].get("hostname") == _s.gethostname():
                from ray_tpu_torch.core.object_store.store import ShmObjectStore

                self._home_store = ShmObjectStore.connect(
                    home["topology"]["store"])
                self.store = self._home_store
        except Exception:  # noqa: BLE001 — fast path is optional
            self._home_store = None

    def _start_beat(self, gcs_address: Tuple[str, int]):
        """This driver's heartbeat from a process of its own
        (``driver_beat.py``), which beats while the driver holds its GIL
        and stops when the pipe it holds closes."""
        import ray_tpu_torch as _pkg

        env = dict(os.environ, RTPU_CLUSTER_AUTHKEY=self._authkey.hex())
        root = os.path.dirname(os.path.dirname(os.path.abspath(
            _pkg.__file__)))
        pp = env.get("PYTHONPATH", "")
        env["PYTHONPATH"] = root + os.pathsep + pp if pp else root
        return subprocess.Popen(
            [sys.executable, "-m", "ray_tpu_torch.core.cluster.driver_beat",
             str(gcs_address[0]), str(gcs_address[1]),
             self._driver_id.hex()],
            stdin=subprocess.PIPE, env=env)

    def _cluster_view(self, force: bool = False) -> dict:
        now = time.monotonic()
        if (not force and self._view is not None
                and now - self._view_time < config.cluster_view_refresh_s):
            return self._view
        view = self.gcs.call(("list_nodes", True))
        self._view = view
        self._view_time = now
        return view

    def _on_gcs_reconnect(self, info: dict):
        """The head restarted (epoch change): re-assert this driver's
        registration and clamp channel/death cursors to the fresh heads.
        After an EMPTY restart every seq restarts from 0, so a cursor
        left at its old (higher) value would silently skip every future
        freed/actor_state/death event; after a persisted restart the
        heads are >= the cursors and the clamps are no-ops."""
        try:
            self.gcs.try_call(("register_driver", self._driver_id, {}))
            heads = info.get("channel_seq") or {}
            with self._lock:
                self._freed_seq = min(self._freed_seq,
                                      heads.get("freed", 0))
                self._actor_state_seq = min(self._actor_state_seq,
                                            heads.get("actor_state", 0))
            self._death_seq = min(self._death_seq,
                                  info.get("death_seq", 0))
        # rtpu-lint: disable=L4 — reconnect hook runs inside whichever
        # call detected the restart; a malformed info dict must not
        # poison that call (the next heartbeat tick re-registers anyway)
        except Exception:  # noqa: BLE001
            pass

    def _death_watch(self):
        last_hb = 0.0
        # cadence must satisfy BOTH duties: node-death polling and the
        # driver heartbeat (whose timeout is independent of the node
        # heartbeat knobs — never let one flag starve the other)
        period = min(config.gcs_heartbeat_interval_s * 2,
                     config.driver_heartbeat_interval_s)
        while not self._monitor_stop:
            time.sleep(period)
            now = time.monotonic()
            if now - last_hb >= config.driver_heartbeat_interval_s:
                last_hb = now
                try:
                    if not self.gcs.call(
                            ("driver_heartbeat", self._driver_id)):
                        # GCS restarted and lost the (transient) driver
                        # registry: re-register and clamp cursors — an
                        # EMPTY restart also reset every pubsub seq
                        info = self.gcs.call(("gcs_info",))
                        self._on_gcs_reconnect(
                            info if isinstance(info, dict) else {})
                # rtpu-lint: disable=L4 — crash-proof daemon loop: call()
                # re-raises arbitrary picklable remote exceptions, and a
                # missed heartbeat during a GCS restart must not kill the
                # death watch (the next tick retries)
                except Exception:  # noqa: BLE001
                    pass
            try:
                deaths = self.gcs.call(("deaths_since", self._death_seq))
            # rtpu-lint: disable=L4 — same: any poll failure (GCS down,
            # mid-restart, remote error) just means try again next tick
            except Exception:  # noqa: BLE001
                continue
            self._drain_freed_channel()
            self._drain_actor_state_channel()
            for seq, node_id in deaths:
                self._death_seq = max(self._death_seq, seq)
                self._on_node_death(node_id)

    def _drain_freed_channel(self):
        """Apply freed-id broadcasts: a worker-originated free on any
        node must invalidate THIS driver's lineage for those ids ("free
        means dead" — reconstruction must never resurrect them, and the
        dead entries must stop counting against the lineage budget).
        freed_check at reconstruction time remains the authority; this
        is the eager path."""
        with self._lock:
            since = self._freed_seq
        try:
            msgs = self.gcs.call(("poll", "freed", since, 0.0))
        except (RpcError, OSError):
            return
        if not msgs:
            return
        from ray_tpu_torch.core.runtime import note_freed

        with self._lock:
            for seq, oid_list in msgs:
                self._freed_seq = max(self._freed_seq, seq)
                note_freed(self._freed, oid_list)
                for b in oid_list:
                    self._drop_lineage_locked(b)
                    self._loc_cache.pop(b, None)
                    self._obj_size.pop(b, None)

    def _drain_actor_state_channel(self):
        """Apply actor-restart FSM broadcasts (the GCS ``actor_state``
        channel): ALIVE updates routing so the next call goes straight to
        the new incarnation's node; RESTARTING is remembered so call
        retries wait out the restart window instead of failing fast;
        DEAD is terminal (buffable-and-wait would hang forever)."""
        with self._lock:
            since = self._actor_state_seq
        try:
            msgs = self.gcs.call(("poll", "actor_state", since, 0.0))
        except (RpcError, OSError):
            return
        if not msgs:
            return
        with self._lock:
            for seq, m in msgs:
                self._actor_state_seq = max(self._actor_state_seq, seq)
                aid_b = m.get("actor_id")
                if aid_b is None:
                    continue
                self._actor_states[aid_b] = m
                aid = ActorID(aid_b)
                if m.get("state") == "ALIVE" and m.get("node"):
                    self._actor_node[aid] = tuple(m["node"])
                elif m.get("state") in ("RESTARTING", "DEAD"):
                    # stale routing either way: re-resolve on next call
                    self._actor_node.pop(aid, None)

    def _await_actor_restart(self, actor_id: ActorID) -> bool:
        """If the actor is mid-restart per the ``actor_state`` channel,
        block (bounded by ``actor_restart_timeout_s``) until the FSM
        publishes a terminal transition. Returns True when the actor came
        back ALIVE, False when no restart is known to be underway; raises
        when the restart failed or overran its window."""
        aid_b = actor_id.binary()
        state = (self._actor_states.get(aid_b) or {}).get("state")
        if state != "RESTARTING":
            return state == "ALIVE"
        deadline = time.monotonic() + config.actor_restart_timeout_s
        while time.monotonic() < deadline:
            self._drain_actor_state_channel()
            state = (self._actor_states.get(aid_b) or {}).get("state")
            if state == "ALIVE":
                return True
            if state == "DEAD":
                raise ActorDiedError(
                    f"actor {actor_id} died during restart",
                    cause="restart failed (budget exhausted or no node)")
            time.sleep(0.05)
        raise ActorUnavailableError(
            f"actor {actor_id} did not finish restarting within "
            f"actor_restart_timeout_s ({config.actor_restart_timeout_s}s); "
            f"the restart may still complete — retry later")

    def _drop_lineage_locked(self, oid_b: bytes):
        old = self._lineage.pop(oid_b, None)
        if old is not None:
            self._lineage_bytes -= (len(old[1][1])
                                    if old[1][0] == "inline" else 64)
        self._reconstructions.pop(oid_b, None)

    def _on_node_death(self, node_id: bytes):
        view = self.gcs.call(("list_nodes", False))
        dead = [n for n in view["nodes"] if n["node_id"] == node_id]
        if not dead:
            return
        addr = tuple(dead[0]["address"])
        with self._lock:
            self._dead_addrs.add(addr)
        self._nodes.drop(addr)
        self._shipped.pop(addr, None)
        if addr == self._home:
            self._rehome(view)
        with self._lock:
            # location cache entries naming the dead node are poison for
            # the locality scorer; deaths are rare, drop the whole cache
            self._loc_cache.clear()
        # The GCS owns restarts for plain restartable/detached actors
        # (it got their spec at creation); the driver restarts ONLY
        # PG-scheduled ones, whose placement table is driver state. Stale
        # driver-side routing drops so calls re-resolve via the GCS actor
        # table once the restart lands.
        with self._lock:
            lost = [aid for aid, a in self._actor_node.items() if a == addr]
            specs = {aid: self._actor_spec.get(aid) for aid in lost}
        for aid in lost:
            spec = specs.get(aid)
            opts = (spec[3] if spec else {}) or {}
            restartable = (opts.get("max_restarts", 0) != 0
                           or opts.get("lifetime") == "detached")
            if (spec is not None and restartable
                    and aid not in self._gcs_owned):
                threading.Thread(target=self._restart_actor_with_retry,
                                 args=(aid, spec), daemon=True,
                                 name="actor-restart").start()
            else:
                with self._lock:
                    self._actor_node.pop(aid, None)

    def _rehome(self, view: dict) -> None:
        """The home node died: puts and gets without a known route move
        to an alive node, whose store this driver maps when it is on this
        host. Values already read zero-copy keep the dead node's mapping
        (it is never closed here)."""
        import socket as _s

        alive = [n for n in view["nodes"] if n["state"] == "ALIVE"
                 and tuple(n["address"]) != self._home]
        if not alive:
            return
        home = alive[0]
        store = None
        if home["topology"].get("hostname") == _s.gethostname():
            from ray_tpu_torch.core.object_store.store import ShmObjectStore

            try:
                store = ShmObjectStore.connect(home["topology"]["store"])
            except Exception:  # noqa: BLE001 — the fast path is optional
                store = None
        with self._lock:
            self._home = tuple(home["address"])
            self._home_store = store
            self.store = store

    def _restart_actor_with_retry(self, actor_id: ActorID, spec,
                                  timeout: float = 300.0):
        """Restart pends until a node satisfying the actor's resources is
        alive (reference: gcs_actor_manager reschedules on node addition)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline and not self._monitor_stop:
            try:
                self._restart_actor(actor_id, spec)
                return
            except Exception:  # noqa: BLE001 — no fitting node yet
                time.sleep(1.0)
        with self._lock:
            self._actor_node.pop(actor_id, None)

    def _restart_actor(self, actor_id: ActorID, spec):
        """Recreate the actor under its ORIGINAL id on a fitting node, so
        every handle — driver- or worker-held — keeps working unchanged.
        The decremented max_restarts is persisted back into the spec so the
        restart budget is actually enforced."""
        cls_fn_id, payload, deps, opts = spec
        opts = dict(opts or {})
        if int(opts.get("max_restarts", 0)) > 0:
            opts["max_restarts"] = int(opts["max_restarts"]) - 1
        addr = self._pick_node_strict(opts, is_actor=True)
        client = self._nodes.get(addr)
        pickled = self._ship_fn(addr, cls_fn_id)
        opts_local = self._localize_pg(opts, addr)
        client.call(("create_actor", cls_fn_id, pickled, payload,
                     deps, opts_local, None, actor_id.binary(),
                     os.urandom(16), self._driver_id))
        self._mark_shipped(addr, cls_fn_id)
        with self._lock:
            self._actor_node[actor_id] = addr
            self._actor_spec[actor_id] = (cls_fn_id, payload, deps, opts)
        self.gcs.try_call(("register_actor", actor_id.binary(),
                           {"node": addr, "state": "RESTARTED"}))

    # ------------------------------------------------------------ functions

    def register_function(self, fn) -> bytes:
        key = id(fn)
        cached = self._fn_cache.get(key)
        if cached is not None and cached[1] is fn:
            return cached[0]
        pickled = serialization.pack(fn)
        fn_id = hashlib.blake2b(pickled, digest_size=16).digest()
        with self._lock:
            self._functions[fn_id] = pickled
        self._fn_cache[key] = (fn_id, fn)
        return fn_id

    def _ship_fn(self, addr: Tuple[str, int], fn_id: bytes) -> Optional[bytes]:
        """Returns the pickled fn to attach if the node hasn't seen it.
        Callers confirm delivery with _mark_shipped AFTER the RPC succeeds."""
        if fn_id in self._shipped.setdefault(addr, set()):
            return None
        with self._lock:
            return self._functions.get(fn_id)

    def _mark_shipped(self, addr: Tuple[str, int], fn_id: bytes):
        self._shipped.setdefault(addr, set()).add(fn_id)

    # ------------------------------------------------------------ scheduling

    def _locate_deps(self, oid_bs: Sequence[bytes], fresh: bool = False
                     ) -> Dict[bytes, Tuple[List[Tuple[str, int]],
                                            Optional[int]]]:
        """Resolve locations + sizes for many ids with at most ONE GCS
        RPC (loc_get_batch), cache-first. ``fresh`` bypasses the cache —
        reconstruction dep-checks need authoritative absence, not a
        stale hit. Ids with no known location are omitted."""
        now = time.monotonic()
        ttl = config.locality_cache_ttl_s
        neg_ttl = 0.25  # a confirmed miss (producer not finished yet) is
        # re-queried at most ~4x/s — bounds the per-submission RPC rate
        # for pipelined chains without hiding publication for long
        out: Dict[bytes, Tuple[List[Tuple[str, int]], Optional[int]]] = {}
        missing: List[bytes] = []
        with self._lock:
            for b in oid_bs:
                ent = None if fresh else self._loc_cache.get(b)
                if ent is not None:
                    addrs, ts = ent
                    if addrs and now - ts < ttl:
                        out[b] = (addrs, self._obj_size.get(b))
                        continue
                    if not addrs and now - ts < neg_ttl:
                        continue  # recently confirmed absent
                missing.append(b)
        cache_hits = len(out)
        got = {}
        if missing:
            try:
                got = self.gcs.call(("loc_get_batch", list(missing)))
            except RpcError:
                got = {}
        with self._lock:
            self.locality_stats["cache_hits"] += cache_hits
            if missing:
                self.locality_stats["batched_lookups"] += 1
            for b in missing:
                ent = got.get(b)
                if ent is None:
                    self._loc_cache[b] = ([], now)  # negative entry
                    continue
                addrs = [tuple(a) for a in ent[0]]
                if ent[1] is not None:
                    self._obj_size[b] = int(ent[1])
                self._loc_cache[b] = (addrs, now)
                out[b] = (addrs, self._obj_size.get(b))
            if len(self._loc_cache) > 65536:
                self._loc_cache.clear()  # crude bound; it is only a cache
        return out

    def _pick_node_strict(self, options: dict, is_actor: bool
                          ) -> Tuple[str, int]:
        return self._pick_node(options, is_actor, strict=True)

    def _pick_node(self, options: dict, is_actor: bool,
                   exclude: Sequence[Tuple[str, int]] = (),
                   strict: bool = False,
                   dep_locs: Optional[Dict[bytes, tuple]] = None
                   ) -> Tuple[str, int]:
        options = options or {}
        req: Dict[str, float] = {}
        num_cpus = options.get("num_cpus")
        if num_cpus is None:
            num_cpus = 0.0 if is_actor else 1.0
        if num_cpus:
            req["CPU"] = float(num_cpus)
        if options.get("num_tpus"):
            raise ValueError(NUM_TPUS_REFUSED)
        if options.get("num_gpus"):
            req["GPU"] = float(options["num_gpus"])
        for k, v in (options.get("resources") or {}).items():
            req[k] = req.get(k, 0) + float(v)

        strategy = options.get("scheduling_strategy")
        wire = None
        if strategy is not None and hasattr(strategy, "_to_wire"):
            wire = strategy._to_wire()
        elif isinstance(strategy, tuple):
            wire = strategy
        if wire and wire[0] == "pg":
            pg = self._pgs.get(PlacementGroupID(wire[1]))
            if pg is None:
                raise PlacementGroupError("unknown placement group")
            idx = wire[2] if wire[2] is not None and wire[2] >= 0 else 0
            addr, _, _ = pg.placements[idx]
            return addr

        nodes = self._cluster_view()["nodes"]
        if wire and wire[0] == "node":
            # node affinity keeps precedence over locality / load scoring
            target, soft = wire[1], wire[2]
            tb = bytes.fromhex(target) if isinstance(target, str) else target
            for n in nodes:
                if (n["node_id"] == tb
                        and tuple(n["address"]) not in exclude):
                    return tuple(n["address"])
            if not soft:
                raise RuntimeError(
                    f"node affinity target {target!r} is not alive")
            # soft affinity: target gone, fall through to normal selection

        fit = [n for n in nodes
               if tuple(n["address"]) not in exclude
               and all(n["resources"].get(k, 0) >= v for k, v in req.items())]
        if not fit:
            if strict:
                raise RuntimeError("no node satisfies the resource request")
            # No ALIVE node's totals fit. A QUARANTINED node is cordoned
            # but not condemned — when it is the ONLY host whose totals
            # can ever satisfy the request, placing there beats parking
            # on a node whose queue would hold the task forever (the
            # quarantine shed load from a suspect node; it must not
            # strand work that is resource-bound to it). DRAINING /
            # DRAINED nodes stay excluded: they are leaving.
            if req:
                listing = self.gcs.call(("list_nodes", False))
                fit = [n for n in listing["nodes"]
                       if n["state"] == "QUARANTINED"
                       and tuple(n["address"]) not in exclude
                       and all(n["resources"].get(k, 0) >= v
                               for k, v in req.items())]
            if not fit:
                # park the task on the least-loaded node, whose queue
                # holds it until resources appear (matches the
                # reference's infeasible-task pending queue)
                fit = [n for n in nodes if tuple(n["address"]) not in exclude]
        if not fit:
            raise RuntimeError("no alive nodes in cluster")

        # locality: credit each feasible node with the bytes of
        # qualifying arguments (>= locality_min_arg_bytes) it already
        # holds, discounted by queue depth (locality_load_penalty_bytes
        # per queued task) — the owner leases from the node holding the
        # most argument bytes unless its backlog costs more than the
        # transfer saves (reference: locality-aware leasing,
        # lease_policy.h / Ownership NSDI'21)
        local_bytes: Dict[Tuple[str, int], int] = {}
        if dep_locs and not is_actor and config.locality_aware_scheduling:
            floor = config.locality_min_arg_bytes
            for addrs, nbytes in dep_locs.values():
                if nbytes is None or nbytes < floor:
                    continue
                for a in addrs:
                    a = tuple(a)
                    local_bytes[a] = local_bytes.get(a, 0) + nbytes
        penalty = config.locality_load_penalty_bytes

        # with no locality signal every eff is 0 and ordering reduces to
        # the classic (availability headroom, queue depth), then RR
        def score(n):
            addr = tuple(n["address"])
            avail_ok = all(n["avail"].get(k, 0) >= v for k, v in req.items())
            eff = (local_bytes.get(addr, 0) - n["load"] * penalty
                   if local_bytes else 0)
            return (-eff, 0 if avail_ok else 1, n["load"])
        fit.sort(key=score)
        best = [n for n in fit if score(n) == score(fit[0])]
        with self._lock:
            self._rr += 1
            chosen = tuple(best[self._rr % len(best)]["address"])
            if local_bytes:
                floor = config.locality_min_arg_bytes
                st = self.locality_stats
                if local_bytes.get(chosen, 0) >= max(local_bytes.values()):
                    st["hits"] += 1
                else:
                    st["misses"] += 1
                for addrs, nbytes in dep_locs.values():
                    if nbytes is None or nbytes < floor:
                        continue
                    if chosen in (tuple(a) for a in addrs):
                        st["bytes_local"] += nbytes   # transfer avoided
                    else:
                        st["bytes_remote"] += nbytes  # still has to move
        return chosen

    def _localize_pg(self, options: dict, addr: Tuple[str, int]) -> dict:
        """Rewrite a cluster PG scheduling strategy into the node-local one."""
        options = dict(options or {})
        strategy = options.get("scheduling_strategy")
        wire = None
        if strategy is not None and hasattr(strategy, "_to_wire"):
            wire = strategy._to_wire()
        elif isinstance(strategy, tuple):
            wire = strategy
        if wire and wire[0] == "pg":
            pg = self._pgs.get(PlacementGroupID(wire[1]))
            idx = wire[2] if wire[2] is not None and wire[2] >= 0 else 0
            node_addr, local_pg, local_idx = pg.placements[idx]
            assert node_addr == addr
            options["scheduling_strategy"] = ("pg", local_pg, local_idx)
        return options

    # ----------------------------------------------------------------- tasks

    def submit_task(self, fn_id: bytes, args: tuple, kwargs: dict,
                    num_returns=1, options: Optional[dict] = None
                    ) -> List[ObjectRef]:
        options = dict(options or {})
        streaming = num_returns == "streaming"
        if streaming:
            # single return id doubles as the stream seed; the chosen
            # node registers the stream state (node_server._do_submit)
            num_returns = 1
            options["__stream"] = True
        args2, kwargs2, deps = self._swap_top_level_refs(args, kwargs)
        payload, nested = protocol.serialize_args(args2, kwargs2, store=None)
        return_ids = [ObjectID.from_random() for _ in range(num_returns)]
        # one RPC resolves every dep's locations + sizes (cache-first);
        # feeds both the submit-time location hints and locality scoring
        dep_bs = [d.binary() for d in deps]
        dep_locs = (self._locate_deps(dep_bs)
                    if dep_bs and config.locality_aware_scheduling else {})
        locations = {}
        with self._lock:
            hints = {b: self._ref_node.get(b) for b in dep_bs}
            sizes = {b: self._obj_size.get(b) for b in dep_bs}
        for b in dep_bs:
            hint = hints[b]
            addrs, nbytes = dep_locs.get(b, ([], None))
            if hint is not None and hint not in addrs:
                # the owner hint covers deps the directory hasn't seen
                # yet (unfinished producers): the submitting node knows
                # where the object WILL appear
                addrs = list(addrs) + [hint]
            if nbytes is None:
                nbytes = sizes[b]
            if addrs:
                dep_locs[b] = (addrs, nbytes)
                locations[b] = tuple(addrs[0]) if hint is None else hint
        msg_tail = ([d.binary() for d in deps],
                    [r.binary() for r in nested],
                    [r.binary() for r in return_ids])
        tried: List[Tuple[str, int]] = []
        # One nonce per LOGICAL submission. The transport layer retries a
        # lost reply on the SAME node, where the nonce dedups (exactly-
        # once); reconstruction mints a new nonce because re-execution
        # there is deliberate. The failover loop below only fires after
        # the same-node retry failed too — i.e. the node is unreachable —
        # so cross-node re-submission is at-least-once under a network
        # partition (the reference's task max_retries has the same
        # semantics).
        nonce = os.urandom(16)
        while True:
            # spillback failover re-scores with the tried nodes excluded
            addr = self._pick_node(options, is_actor=False, exclude=tried,
                                   dep_locs=dep_locs)
            options2 = self._localize_pg(options, addr)
            pickled_fn = self._ship_fn(addr, fn_id)
            try:
                self._nodes.get(addr).call(
                    ("submit", fn_id, pickled_fn, payload, *msg_tail,
                     options2, locations, nonce, self._driver_id))
                break
            except RpcError:
                # stale view: the node died but isn't marked DEAD yet
                tried.append(addr)
                if len(tried) >= 4:
                    raise
                self._cluster_view(force=True)
        self._mark_shipped(addr, fn_id)
        if streaming:
            # No lineage for streams: replay-after-worker-death happens on
            # the owning node (skip-aware requeue); a lost index object is
            # not reconstructable and raises ObjectLostError instead.
            with self._lock:
                self._ref_node[return_ids[0].binary()] = addr
            return [ObjectRef(rid, core=self) for rid in return_ids]
        lineage = (fn_id, payload, [d.binary() for d in deps],
                   [r.binary() for r in nested],
                   [r.binary() for r in return_ids], options)
        cost = len(payload[1]) if payload[0] == "inline" else 64
        with self._lock:
            for rid in return_ids:
                self._ref_node[rid.binary()] = addr
                self._lineage[rid.binary()] = lineage
                # cost accrues per entry (eviction also subtracts per entry)
                self._lineage_bytes += cost
            # byte-budgeted lineage (reference evicts lineage the same way:
            # max_lineage_bytes); oldest entries lose reconstructability
            while (self._lineage_bytes > config.lineage_max_bytes
                   and self._lineage):
                _, old = self._lineage.popitem(last=False)
                self._lineage_bytes -= (len(old[1][1])
                                        if old[1][0] == "inline" else 64)
        return [ObjectRef(rid, core=self) for rid in return_ids]

    def _swap_top_level_refs(self, args, kwargs):
        deps: List[ObjectID] = []

        def swap(v):
            if isinstance(v, ObjectRef):
                deps.append(v.id)
                return protocol._TopLevelDep(v.binary())
            return v

        return (tuple(swap(a) for a in args),
                {k: swap(v) for k, v in kwargs.items()}, deps)

    # --------------------------------------------------------------- objects

    def put_object(self, value: Any) -> ObjectRef:
        pickled, views, total = serialization.serialize(value)
        buf = bytearray(total)
        serialization.write_container(memoryview(buf), pickled, views)
        oid_b = self._nodes.get(self._home).call(
            ("put", bytes(buf), None, self._driver_id))
        with self._lock:
            self._ref_node[oid_b] = self._home
            # the driver knows its own puts' size and home before the
            # node's batched loc_add lands — seed the scorer's tables
            self._obj_size[oid_b] = total
            self._loc_cache[oid_b] = ([self._home], time.monotonic())
        return ObjectRef(ObjectID(oid_b), core=self)

    def _route(self, oid_b: bytes, default=None):
        """Locked single-probe read of the owner-routing table. Every
        read of _ref_node goes through here (or holds _lock inline) so
        routing lookups never observe a torn compound update."""
        with self._lock:
            return self._ref_node.get(oid_b, default)

    def get_objects(self, refs: List[ObjectRef],
                    timeout: Optional[float] = None) -> List[Any]:
        out: Dict[bytes, Any] = {}
        groups: Dict[Tuple[str, int], List[bytes]] = {}
        for ref in refs:
            b = ref.binary()
            # rtpu-lint: disable=L7 — deliberate lock-free tombstone
            # probe on the hot get() path: note_freed only ever ADDS
            # tombstones, a dict-membership read is GIL-atomic, and this
            # loop blocks on ev.wait() so holding self._lock here would
            # stall every other driver thread (and violate L2)
            if b in self._freed:
                raise ObjectLostError(
                    f"object {b.hex()} was freed by ray_tpu_torch.free() and is "
                    f"not reconstructable")
            if b in self._local:
                ev, cell = self._local[b]
                if not ev.wait(timeout):
                    raise GetTimeoutError("get() timed out")
                out[b] = cell[0]
                continue
            addr = self._route(b, self._home)
            groups.setdefault(addr, []).append(b)
        errs: List[BaseException] = []

        def fetch(addr, oids):
            try:
                allow_shm = (self._home_store is not None
                             and addr == self._home)
                payloads = self._nodes.get(addr).call(
                    ("get", oids, timeout, allow_shm))
                for b, payload in payloads.items():
                    try:
                        out[b] = self._decode(payload)
                    except Exception:  # noqa: BLE001
                        if payload[0] != "shm":
                            raise
                        # shm fast path raced a spill: re-request the
                        # materialized bytes over RPC
                        p2 = self._nodes.get(addr).call(
                            ("get", [b], timeout, False))
                        out[b] = self._decode(p2[b])
            except RpcError:
                # node died: any other location? (GCS directory) — one
                # batched lookup covers the whole failed group
                batched = (self._locate_deps(oids, fresh=True)
                           if len(oids) > 1 else {})
                for b in oids:
                    try:
                        out[b] = self._fetch_anywhere(
                            b, timeout, locs=batched.get(b, (None,))[0])
                    except BaseException as e:  # noqa: BLE001
                        errs.append(e)
            except BaseException as e:  # noqa: BLE001
                errs.append(e)

        if len(groups) == 1:
            ((addr, oids),) = groups.items()
            fetch(addr, oids)
        elif groups:
            threads = [threading.Thread(target=fetch, args=(a, o))
                       for a, o in groups.items()]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        if errs:
            raise errs[0]
        values = []
        for ref in refs:
            v = out[ref.binary()]
            values.append(protocol.raise_if_error(v))
        return values

    def _decode(self, payload):
        kind, data = payload
        if kind == "shm" and self._home_store is not None:
            return protocol.shm_unpack(self._home_store, ObjectID(data))
        return serialization.unpack(data)

    def _fetch_anywhere(self, oid_b: bytes, timeout: Optional[float],
                        locs=None):
        if not locs:
            # single-id path keeps loc_get's short blocking wait (the
            # object may be mid-publication on its new node)
            locs = self.gcs.call(("loc_get", oid_b, 2.0))
        for addr in locs:
            try:
                data = self._nodes.get(tuple(addr)).call(("fetch", oid_b))
            except RpcError:
                continue
            if data is not None:
                with self._lock:
                    self._ref_node[oid_b] = tuple(addr)
                return self._decode(data)
        # a worker-freed object must stay dead: check the published
        # tombstone before resurrecting through lineage (the driver-side
        # _freed set only covers driver-initiated frees)
        try:
            freed = self.gcs.call(("freed_check", oid_b))
        except RpcError:
            freed = False
        if freed:
            with self._lock:
                from ray_tpu_torch.core.runtime import note_freed
                note_freed(self._freed, (oid_b,))
            raise ObjectLostError(
                f"object {oid_b.hex()} was freed by ray_tpu_torch.free() "
                f"and is not reconstructable")
        # no surviving copy: reconstruct through lineage by resubmitting the
        # creating task (recursively reconstructing lost deps first)
        if self._reconstruct(oid_b):
            payloads = self._nodes.get(self._route(oid_b)).call(
                ("get", [oid_b], timeout, False))
            return self._decode(payloads[oid_b])
        raise ObjectLostError(
            f"object {oid_b.hex()} is lost (owner node died, no other copy "
            f"exists, and no lineage is available to reconstruct it)")

    def _reconstruct(self, oid_b: bytes, depth: int = 0) -> bool:
        """Resubmit the creating task of a lost object. Returns True when a
        resubmission was issued (the object will materialize on the new
        node). Bounded per object by max_reconstructions."""
        if depth > 10:
            return False
        # "free means dead": an eagerly-freed object (driver- OR
        # worker-originated) must never be resurrected, directly or as a
        # recursively-reconstructed dependency
        with self._lock:
            freed = oid_b in self._freed
            lineage = self._lineage.get(oid_b)
            n = self._reconstructions.get(oid_b, 0)
        if freed or lineage is None or n >= config.max_reconstructions:
            return False
        try:
            # the GCS freed-set is authoritative for worker-originated
            # frees the driver hasn't drained yet
            if self.gcs.call(("freed_check", oid_b)):
                return False
        except RpcError:
            pass
        fn_id, payload, deps_b, nested_b, return_ids_b, options = lineage
        # deps that are lost themselves get reconstructed first; with
        # several deps one loc_get_batch replaces the per-id loop
        # (fresh: a stale cache hit here would skip reviving a lost dep)
        if len(deps_b) > 1:
            present = self._locate_deps(deps_b, fresh=True)
            missing = [b for b in deps_b
                       if not present.get(b, ((), None))[0]]
        else:
            missing = [b for b in deps_b
                       if not self.gcs.call(("loc_get", b, 0.0))]
        for dep_b in missing:
            if not self._reconstruct(dep_b, depth + 1):
                return False
        # the cluster view can lag node death by a heartbeat timeout;
        # fail over across candidate nodes
        tried: List[Tuple[str, int]] = []
        for _ in range(4):
            try:
                addr = self._pick_node(dict(options or {}), is_actor=False,
                                       exclude=tried)
            except RuntimeError:
                return False
            pickled_fn = self._ship_fn(addr, fn_id)
            options2 = self._localize_pg(dict(options or {}), addr) \
                if (options or {}).get("scheduling_strategy") \
                else dict(options or {})
            try:
                # fresh nonce: reconstruction deliberately RE-executes the
                # creating task, it must never be deduped against the
                # original submission
                self._nodes.get(addr).call(
                    ("submit", fn_id, pickled_fn, payload, deps_b, nested_b,
                     return_ids_b, options2, None, os.urandom(16),
                     self._driver_id))
                break
            except RpcError:
                tried.append(addr)
                self._cluster_view(force=True)
        else:
            return False
        self._mark_shipped(addr, fn_id)
        with self._lock:
            for rid_b in return_ids_b:
                self._ref_node[rid_b] = addr
                self._reconstructions[rid_b] = (
                    self._reconstructions.get(rid_b, 0) + 1)
        return True

    def wait(self, refs: List[ObjectRef], num_returns: int = 1,
             timeout: Optional[float] = None):
        if num_returns > len(refs):
            raise ValueError("num_returns exceeds number of refs")
        deadline = None if timeout is None else time.monotonic() + timeout
        ready_set: set = set()
        while True:
            groups: Dict[Tuple[str, int], List[bytes]] = {}
            for ref in refs:
                b = ref.binary()
                if b in ready_set:
                    continue
                if b in self._local:
                    if self._local[b][0].is_set():
                        ready_set.add(b)
                    continue
                groups.setdefault(self._route(b, self._home),
                                  []).append(b)
            if len(ready_set) >= num_returns:
                break
            remaining = (None if deadline is None
                         else deadline - time.monotonic())
            if remaining is not None and remaining <= 0:
                break
            step = 0.2 if remaining is None else max(0.0, min(0.2, remaining))
            if not groups:
                # only driver-local sentinels left: block on one of them
                # instead of spinning
                unresolved = [self._local[r.binary()][0] for r in refs
                              if r.binary() in self._local
                              and not self._local[r.binary()][0].is_set()]
                if unresolved:
                    unresolved[0].wait(step)
                else:
                    time.sleep(min(0.01, step))
                continue

            def poll(addr, oids):
                try:
                    r, _ = self._nodes.get(addr).call(
                        ("wait", oids, len(oids), step))
                    ready_set.update(r)
                # rtpu-lint: disable=L4 — one node failing its poll slice
                # (dying, restarting) must not fail the whole wait(); its
                # objects just stay not-ready until the next round
                except Exception:  # noqa: BLE001
                    pass

            threads = [threading.Thread(target=poll, args=(a, o))
                       for a, o in groups.items()]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        ready = [r for r in refs if r.binary() in ready_set][:num_returns]
        ready_ids = {r.binary() for r in ready}
        rest = [r for r in refs if r.binary() not in ready_ids]
        return ready, rest

    def as_future(self, ref: ObjectRef):
        import asyncio

        loop = asyncio.get_event_loop()
        fut = loop.create_future()

        def run():
            try:
                v = self.get_objects([ref], timeout=None)[0]
            except BaseException as e:  # noqa: BLE001
                loop.call_soon_threadsafe(fut.set_exception, e)
                return
            loop.call_soon_threadsafe(fut.set_result, v)

        threading.Thread(target=run, daemon=True).start()
        return fut

    # ---------------------------------------------------------------- actors

    def create_actor(self, cls_fn_id: bytes, args: tuple, kwargs: dict,
                     opts: Optional[dict] = None) -> ActorID:
        opts = dict(opts or {})
        args2, kwargs2, deps = self._swap_top_level_refs(args, kwargs)
        payload, _ = protocol.serialize_args(args2, kwargs2, store=None)
        addr = self._pick_node(opts, is_actor=True)
        opts2 = self._localize_pg(opts, addr)
        pickled_cls = self._ship_fn(addr, cls_fn_id)
        locations = {d.binary(): self._route(d.binary()) for d in deps}
        locations = {k: v for k, v in locations.items() if v is not None}
        dep_b = [d.binary() for d in deps]
        # driver-chosen actor id + per-request nonce: a retried
        # create_actor whose reply was lost dedups server-side
        # (exactly-once apply), while restarts under the same id mint a
        # new nonce and re-apply
        actor_id_b = ActorID.from_random().binary()
        self._nodes.get(addr).call(
            ("create_actor", cls_fn_id, pickled_cls, payload, dep_b, opts2,
             locations, actor_id_b, os.urandom(16), self._driver_id))
        self._mark_shipped(addr, cls_fn_id)
        actor_id = ActorID(actor_id_b)
        with self._lock:
            self._actor_node[actor_id] = addr
            self._actor_opts[actor_id] = opts.get("method_opts", {})
            # keep the ORIGINAL opts (cluster-level PG strategy): restart
            # re-localizes against whichever node it lands on
            self._actor_spec[actor_id] = (cls_fn_id, payload, dep_b, opts)
        # restartable/detached actors hand their restart FSM to the GCS
        # (reference: gcs_actor_manager.h:278) so they outlive this
        # driver. PG-scheduled actors stay driver-restarted: the PG
        # placement table is driver state.
        restartable = (opts.get("max_restarts", 0) != 0
                       or opts.get("lifetime") == "detached")
        if restartable and not opts.get("scheduling_strategy"):
            try:
                with self._lock:
                    pickled_full = self._functions.get(cls_fn_id)
                if pickled_full is not None:
                    self.gcs.call(("register_fn", cls_fn_id, pickled_full))
                # full opts INCLUDING method_opts: after a GCS-owned
                # restart, handles re-derived via get_actor() must keep
                # per-method options (num_returns overrides etc.)
                self.gcs.call(("register_actor_spec", actor_id_b, {
                    "cls_fn_id": cls_fn_id, "payload": payload,
                    "deps": dep_b, "opts": opts,
                    "name": opts.get("name"),
                    # owner: if this driver dies, the GCS stops
                    # restarting the actor unless it is detached
                    "owner": self._driver_id,
                }))
                with self._lock:
                    self._gcs_owned.add(actor_id)
            # rtpu-lint: disable=L4 — registration failed (GCS outage
            # window): the driver keeps restart authority — never leave
            # the actor with NO restart owner
            except Exception:  # noqa: BLE001
                pass
        return actor_id

    def _actor_addr(self, actor_id: ActorID) -> Tuple[str, int]:
        with self._lock:
            addr = self._actor_node.get(actor_id)
        if addr is None:
            info = self.gcs.call(("list_actors",)).get(actor_id.binary())
            if info is None or "node" not in info:
                raise ActorDiedError(f"unknown actor {actor_id}")
            addr = tuple(info["node"])
            with self._lock:
                self._actor_node[actor_id] = addr
        return addr

    def _actor_call_with_retry(self, actor_id: ActorID, msg_fn):
        """Run an actor-routed RPC; on stale routing (node died, actor was
        restarted elsewhere) re-resolve via the GCS actor table and retry.
        When the ``actor_state`` channel says a restart is underway, the
        retry first waits (bounded) for the new incarnation so the call
        lands on it instead of surfacing a transient death."""
        addr = self._actor_addr(actor_id)
        try:
            if self._node_gone(addr):
                raise RpcError(f"node {addr[0]}:{addr[1]} is dead")
            return addr, self._nodes.get(addr).call(msg_fn(addr))
        except (RpcError, ActorDiedError):
            with self._lock:
                self._actor_node.pop(actor_id, None)
            self._drain_actor_state_channel()
            self._await_actor_restart(actor_id)
            addr = self._actor_addr(actor_id)
            if self._node_gone(addr):
                # no restart under way and the table still names the dead
                # node: the actor died with it (dialing would only wait
                # out the connect deadline)
                raise ActorDiedError(
                    f"actor {actor_id} died with its node "
                    f"{addr[0]}:{addr[1]}")
            return addr, self._nodes.get(addr).call(msg_fn(addr))

    def _node_gone(self, addr: Tuple[str, int]) -> bool:
        """Whether the GCS declared the node at ``addr`` dead and it has
        not registered again since (a healed partition re-registers at
        the same address)."""
        with self._lock:
            if addr not in self._dead_addrs:
                return False
        if any(tuple(n["address"]) == addr
               for n in self._cluster_view(force=True)["nodes"]):
            with self._lock:
                self._dead_addrs.discard(addr)
            return False
        return True

    def submit_actor_task(self, actor_id: ActorID, method: str, args: tuple,
                          kwargs: dict, num_returns=1,
                          options: Optional[dict] = None
                          ) -> List[ObjectRef]:
        streaming = num_returns == "streaming"
        if streaming:
            num_returns = 1
        args2, kwargs2, deps = self._swap_top_level_refs(args, kwargs)
        payload, nested = protocol.serialize_args(args2, kwargs2, store=None)
        return_ids = [ObjectID.from_random() for _ in range(num_returns)]
        msg = ("actor_call", actor_id.binary(), method, payload,
               [d.binary() for d in deps], [r.binary() for r in nested],
               [r.binary() for r in return_ids], os.urandom(16),
               self._driver_id, streaming, dict(options or {}))
        try:
            addr, _ = self._actor_call_with_retry(actor_id, lambda a: msg)
        except RpcError as e:
            raise ActorDiedError(
                f"actor {actor_id} node is unreachable: {e}") from e
        with self._lock:
            for rid in return_ids:
                self._ref_node[rid.binary()] = addr
        return [ObjectRef(rid, core=self) for rid in return_ids]

    def kill_actor(self, actor_id: ActorID, no_restart: bool = True):
        if no_restart:
            with self._lock:
                self._actor_spec.pop(actor_id, None)
            # the GCS must not resurrect an explicitly killed actor
            self.gcs.try_call(("drop_actor_spec", actor_id.binary()))
        try:
            self._actor_call_with_retry(
                actor_id,
                lambda a: ("kill_actor", actor_id.binary(), no_restart))
        # rtpu-lint: disable=L4 — kill of an already-dead/unreachable
        # actor is the desired end state, not a lost signal: there is
        # nothing left to kill and no caller waiting on a result
        except (RpcError, ActorDiedError):
            pass

    def get_actor_method_opts(self, actor_id: ActorID) -> dict:
        opts = self._actor_opts.get(actor_id)
        if opts is not None:
            return opts
        _, opts = self._actor_call_with_retry(
            actor_id, lambda a: ("actor_opts", actor_id.binary()))
        self._actor_opts[actor_id] = opts
        return opts

    def get_named_actor(self, name: str) -> ActorID:
        entry = self.gcs.call(("get_named_actor", name))
        if entry is None:
            raise ValueError(f"no actor named {name!r}")
        actor_id = ActorID(entry[0])
        with self._lock:
            self._actor_node.setdefault(actor_id, tuple(entry[1]))
        return actor_id

    def get_actor_handle(self, name: str):
        from ray_tpu_torch.core.actor import ActorHandle

        aid = self.get_named_actor(name)
        return ActorHandle(aid, self.get_actor_method_opts(aid))

    # ------------------------------------------------------ placement groups

    def create_placement_group(self, bundles, strategy, name
                               ) -> PlacementGroup:
        pg_id = PlacementGroupID.from_random()
        cpg = _ClusterPG(pg_id, bundles, strategy, name)
        nodes = self._cluster_view(force=True)["nodes"]
        if not nodes:
            raise RuntimeError("no alive nodes")

        def fits(node, bundle_list):
            need: Dict[str, float] = {}
            for b in bundle_list:
                for k, v in b.items():
                    need[k] = need.get(k, 0) + v
            return all(node["resources"].get(k, 0) >= v
                       for k, v in need.items())

        assignments: Dict[Tuple[str, int], List[int]] = {}
        if strategy in ("PACK", "STRICT_PACK"):
            host = next((n for n in nodes if fits(n, bundles)), None)
            if host is None:
                if strategy == "STRICT_PACK":
                    raise ValueError(
                        "no node can hold all STRICT_PACK bundles")
                host = max(nodes, key=lambda n: sum(n["avail"].values()))
            assignments[tuple(host["address"])] = list(range(len(bundles)))
        else:  # SPREAD / STRICT_SPREAD: round-robin over fitting nodes
            order = sorted(nodes, key=lambda n: n["load"])
            if strategy == "STRICT_SPREAD" and len(order) < len(bundles):
                raise ValueError(
                    f"STRICT_SPREAD needs {len(bundles)} nodes, "
                    f"cluster has {len(order)}")
            for i, bundle in enumerate(bundles):
                cand = [n for n in order if fits(n, [bundle])] or order
                node = cand[i % len(cand)]
                assignments.setdefault(tuple(node["address"]), []).append(i)

        placements: List[Optional[Tuple]] = [None] * len(bundles)
        created: List[Tuple[Tuple[str, int], bytes]] = []
        try:
            for addr, idxs in assignments.items():
                sub = [bundles[i] for i in idxs]
                local_pg_b = self._nodes.get(addr).call(
                    ("pg", "create", sub, "PACK", None))
                created.append((addr, local_pg_b))
                cpg.node_pgs[addr] = local_pg_b
                for local_idx, i in enumerate(idxs):
                    placements[i] = (addr, local_pg_b, local_idx)
        except Exception:
            for addr, local_pg_b in created:
                try:
                    # rtpu-lint: disable=L9 — per-node rollback fan-out,
                    # not a re-send: each iteration targets a DIFFERENT
                    # node, and removing an already-removed local group
                    # is a no-op on the node
                    self._nodes.get(addr).call(("pg", "remove", local_pg_b))
                # rtpu-lint: disable=L4 — best-effort rollback of the
                # partially created group; the original placement error
                # re-raises below regardless
                except Exception:  # noqa: BLE001
                    pass
            raise
        cpg.placements = placements
        with self._lock:
            self._pgs[pg_id] = cpg
        return PlacementGroup(pg_id, bundles)

    def _cluster_pg(self, pg_id: PlacementGroupID) -> _ClusterPG:
        pg = self._pgs.get(pg_id)
        if pg is None:
            raise PlacementGroupError(f"unknown placement group {pg_id}")
        return pg

    def wait_placement_group(self, pg_id: PlacementGroupID,
                             timeout: float) -> bool:
        pg = self._cluster_pg(pg_id)
        deadline = time.monotonic() + timeout
        for addr, local_pg_b in pg.node_pgs.items():
            remaining = max(0.0, deadline - time.monotonic())
            if not self._nodes.get(addr).call(
                    ("pg", "wait", local_pg_b, remaining)):
                return False
        return True

    def placement_group_ready_ref(self, pg_id: PlacementGroupID) -> ObjectRef:
        oid = ObjectID.from_random()
        ev = threading.Event()
        cell: list = [None]
        self._local[oid.binary()] = (ev, cell)

        def run():
            try:
                ok = self.wait_placement_group(pg_id, timeout=3600.0)
                cell[0] = ok
            except BaseException as e:  # noqa: BLE001
                cell[0] = protocol.ErrorValue(e)
            ev.set()

        threading.Thread(target=run, daemon=True).start()
        return ObjectRef(oid, core=self)

    def placement_group_gpus(self, pg_id: PlacementGroupID,
                             index: int) -> List[str]:
        pg = self._cluster_pg(pg_id)
        addr, local_pg_b, local_idx = pg.placements[index]
        return self._nodes.get(addr).call(("pg", "gpus", local_pg_b,
                                           local_idx))

    def remove_placement_group(self, pg_id: PlacementGroupID):
        pg = self._pgs.get(pg_id)
        if pg is None:
            return
        for addr, local_pg_b in pg.node_pgs.items():
            try:
                # rtpu-lint: disable=L9 — per-node fan-out, not a
                # re-send: each iteration removes a DIFFERENT node's
                # slice, and a double remove is a no-op on the node
                self._nodes.get(addr).call(("pg", "remove", local_pg_b))
            # rtpu-lint: disable=L4 — removal on a dead/unreachable node
            # is moot (its reservations died with it); remove the rest
            except Exception:  # noqa: BLE001
                pass
        with self._lock:
            self._pgs.pop(pg_id, None)

    def placement_group_table(self) -> Dict[str, dict]:
        out = {}
        with self._lock:
            pgs = list(self._pgs.items())
        for pg_id, pg in pgs:
            out[pg_id.hex()] = {
                "bundles": pg.bundles,
                "strategy": pg.strategy,
                "name": pg.name,
                "nodes": [list(a) for a in pg.node_pgs],
            }
        return out

    # -------------------------------------------------------------- misc api

    def cancel_task(self, ref: ObjectRef, force: bool = False):
        addr = self._route(ref.binary(), self._home)
        try:
            self._nodes.get(addr).call(("cancel", ref.binary(), force))
        except RpcError:
            pass

    # ---------------------------------------------------- streaming returns

    def stream_owner(self, seed: bytes) -> Optional[Tuple[str, int]]:
        """Node address owning a stream's state (captured into the
        ObjectRefGenerator so it keeps routing after cross-node pickling)."""
        return self._route(seed)

    def stream_next(self, seed: bytes, index: int,
                    timeout: Optional[float] = None, owner=None):
        """Driver-side consumption: poll the owning node in bounded slices
        (same contract as Runtime.stream_next — ("ref", rid_b) or
        ("end", count), ObjectTimeoutError past the deadline)."""
        addr = tuple(owner) if owner else self._route(seed, self._home)
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        while True:
            slice_s = 0.2
            if deadline is not None:
                # always probe at least once (timeout=0 is a poll)
                slice_s = max(0.0, min(slice_s,
                                       deadline - time.monotonic()))
            reply = self._nodes.get(addr).call(
                ("stream_next", seed, index, max(1, int(slice_s * 1000))))
            if reply[0] == "pending":
                if (deadline is not None
                        and time.monotonic() >= deadline):
                    raise ObjectTimeoutError(
                        f"stream_next timed out waiting for index {index} "
                        f"of stream {seed.hex()}")
                continue
            if reply[0] == "ref":
                # the owner sealed the index object locally; route gets
                with self._lock:
                    self._ref_node[reply[1]] = addr
            return reply

    def stream_consumed(self, seed: bytes, index: int, owner=None):
        """Advance the consumer watermark (backpressure credit) on the
        owning node; best-effort — a lost credit only delays the producer
        by one poll slice."""
        addr = tuple(owner) if owner else self._route(seed, self._home)
        try:
            # rtpu-lint: disable=L9 — the credit is a MONOTONIC
            # watermark: the producer takes max(old, new), so a lost or
            # double-applied advance can only under-report consumption
            # (one poll-slice stall), never corrupt the stream
            self._nodes.get(addr).call(("stream_consumed", seed, index))
        except RpcError:
            pass

    def kv_op(self, op: str, key: str, value=None):
        return self.gcs.call(("kv", op, key, value))

    def pubsub_op(self, op: str, channel: str, arg=None,
                  timeout: float = 0.0):
        """Cluster-wide pubsub IS the GCS channel plane."""
        if op == "publish":
            return self.gcs.call(("publish", channel, arg))
        if op == "poll":
            return self.gcs.call(("poll", channel, int(arg or 0), timeout))
        raise ValueError(op)

    def free_objects(self, oid_bytes_list: List[bytes]) -> int:
        """Fan eager deletion out to every node holding a copy; returns
        the count of UNIQUE objects freed anywhere."""
        freed: set = set()
        # full listing, not the schedulable view: DRAINING/QUARANTINED
        # nodes are cordoned from NEW placement but still hold copies —
        # a free that skips them leaves stale bytes to be served later
        listing = self.gcs.call(("list_nodes", False))
        addrs = {tuple(n["address"]) for n in listing["nodes"]
                 if n["state"] != "DEAD"}
        for addr in addrs:
            try:
                # rtpu-lint: disable=L9 — per-node fan-out, not a
                # re-send; free of an unknown/tombstoned id is a no-op,
                # and the freed_add tombstone published below is the
                # authority a missed node converges on via _drain_freed
                freed.update(self._nodes.get(addr).call(
                    ("free", oid_bytes_list)) or [])
            except RpcError:
                continue
        # clear lineage ONLY for ids actually freed: free of an
        # unresolved/unknown id is a no-op and must not destroy a live
        # object's reconstructability (symmetric byte accounting with the
        # insertion/eviction paths)
        from ray_tpu_torch.core.runtime import note_freed

        if freed:
            # publish tombstones so node fetch loops and reconstruction
            # refuse these ids even when the freeing driver exits
            try:
                self.gcs.call(("freed_add", list(freed)))
            except RpcError:
                pass
        with self._lock:
            note_freed(self._freed, freed)
            for b in freed:
                # drop the location hint too — the periodic-free pattern
                # (router load reports) must not grow _ref_node unboundedly
                self._ref_node.pop(b, None)
                self._loc_cache.pop(b, None)
                self._obj_size.pop(b, None)
            for b in freed:
                self._drop_lineage_locked(b)
        return len(freed)

    # ---- runtime_env packages: content-addressed blobs in the GCS KV,
    # pulled lazily by each node (reference: GCS package store + per-node
    # runtime-env agent download)

    def register_package(self, pkg_hash: str, data: bytes) -> None:
        registered = getattr(self, "_registered_pkgs", None)
        if registered is None:
            registered = self._registered_pkgs = set()
        if pkg_hash in registered:
            return
        key = f"pkg:{pkg_hash}"
        # exists-check: never pull the blob back just to test presence
        if not self.kv_op("exists", key):
            self.kv_op("put", key, data)
        registered.add(pkg_hash)

    def prepare_runtime_env(self, runtime_env):
        from ray_tpu_torch.core import runtime_env as _re

        return _re.prepare(self, runtime_env)

    def cluster_resources(self) -> Dict[str, float]:
        total: Dict[str, float] = {}
        for n in self._cluster_view(force=True)["nodes"]:
            for k, v in n["resources"].items():
                total[k] = total.get(k, 0) + v
        return total

    def nodes(self) -> List[dict]:
        return self._cluster_view(force=True)["nodes"]

    def drain_node(self, node_id: bytes) -> bool:
        """Begin planned removal of a node (ALIVE -> DRAINING): the
        scheduler cordon is immediate, actors migrate via the GCS
        restart FSM, and running tasks get node_drain_grace_s before
        the node is declared DRAINED and can deregister cleanly."""
        return bool(self.gcs.call(("drain_node", node_id)))

    def node_states(self) -> Dict[str, str]:
        """{node_id hex: lifecycle state} for every node the GCS knows
        (including DRAINING/QUARANTINED/DRAINED/DEAD ones the scheduling
        view filters out)."""
        listing = self.gcs.call(("list_nodes", False))
        return {n["node_id"].hex(): n["state"] for n in listing["nodes"]}

    def wait_for_workers(self, count: Optional[int] = None,
                         timeout: Optional[float] = None):
        return True  # nodes bring their own pools up

    def shutdown(self):
        self._monitor_stop = True
        self._beat.stdin.close()  # EOF: the beat process exits
        try:
            self._beat.wait(timeout=5.0)
        except subprocess.TimeoutExpired:
            self._beat.kill()
            self._beat.wait()
        # clean exit: no death event, nodes keep objects until eviction
        self.gcs.try_call(("unregister_driver", self._driver_id))
        if self._home_store is not None:
            try:
                self._home_store.close()
            # rtpu-lint: disable=L4 — shutdown path: keep tearing the
            # rest of the cluster down whatever state the store is in
            except Exception:  # noqa: BLE001
                pass
        self._nodes.close_all()
        self.gcs.close()
        # reap the death-watch: close() wakes any call it has parked in
        # the ride-through loop, so the thread exits within one poll
        # period — without the join it outlives shutdown() and bleeds
        # connect-retry activity into whatever runs next (the seeded
        # interleave tracer sees that as a schedule mismatch)
        self._monitor.join(timeout=5.0)
