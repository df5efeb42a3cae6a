"""GCS — the cluster control plane.

One process holding the authoritative cluster state, mirroring the
reference's gcs_server (src/ray/gcs/gcs_server/gcs_server.h:78) at the
capability level:

- node table + health: registration, periodic heartbeats with resource
  loads, a monitor thread that marks silent nodes DEAD and records a death
  event stream (reference: gcs_node_manager.h:45,
  gcs_health_check_manager.h:39)
- named actor directory (gcs_actor_manager)
- size-tracked object location directory with blocking waits (the
  reference spreads this across the ownership layer + object directory;
  here the GCS is the rendezvous so any node can find any object's
  owner). ``loc_add``/``loc_add_batch`` optionally carry ``nbytes`` so
  the directory doubles as a size table; ``loc_get_batch`` resolves many
  ids in one RPC (non-blocking) and returns ``{oid: (addrs, nbytes)}``
  for the driver's locality-aware scheduler
- cluster KV (gcs_kv_manager) and a cluster function table
  (function_manager.py exports to GCS in the reference)

Run as ``python -m ray_tpu_torch.core.cluster.gcs --port N``.

Wire semantics of every ``_op_*`` arm here — may a client re-send it
after a lost reply, and how does its state resync after failover — are
declared in ``WIRE_CONTRACT``/``RESYNC_COVERAGE`` (protocol_meta.py),
the single source of truth the transport whitelist derives from. Add a
new op there first; the L9/L10 lint rules fail on unclassified arms,
on persisted tables missing from ``_WAL_OPS``/the snapshot round-trip,
and on nondeterminism inside WAL-replayed apply bodies.
"""

from __future__ import annotations

import os
import pickle
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.core import fault_injection, netem
from ray_tpu_torch.core.cluster.rpc import RpcServer, cluster_authkey
from ray_tpu_torch.core.config import config
from ray_tpu_torch.exceptions import StaleGcsEpochError
from ray_tpu_torch.util.debug_lock import make_lock

# ops whose effects must survive a GCS restart (heartbeats and reads are
# deliberately not logged: transient / no effect). kv is logged only for
# its mutating sub-ops — see _WAL_KV_MUTATORS.
_WAL_OPS = frozenset({
    "register_node", "unregister_node", "kv", "name_actor",
    "drop_actor_name", "register_actor", "register_actor_spec",
    "drop_actor_spec", "loc_add", "loc_add_batch",
    "loc_drop", "freed_add", "publish", "register_fn",
    "drain_node", "node_drained",
})

# node lifecycle: ALIVE -> DRAINING -> DRAINED (planned removal, clean
# deregistration) and ALIVE <-> QUARANTINED (gray-failure cordon). Only
# ALIVE nodes are schedulable; DRAINING/QUARANTINED/DRAINED nodes keep
# heartbeating (their data plane stays up) but receive no new work.
_LIVE_STATES = ("ALIVE", "DRAINING", "QUARANTINED")
_WAL_KV_MUTATORS = frozenset({"put", "del", "merge", "cas_merge"})
_WAL_SNAPSHOT_EVERY = 50_000  # records between compactions


class _NodeInfo:
    __slots__ = ("node_id", "address", "resources", "topology", "labels",
                 "state", "last_heartbeat", "avail", "load", "death_seq",
                 "drain_deadline", "jitter_ewma", "fail_total", "fail_ewma",
                 "clean_since", "last_probe")

    def __init__(self, node_id: bytes, address, resources, topology, labels):
        self.node_id = node_id
        self.address = tuple(address)
        self.resources = dict(resources)       # total resources
        self.topology = topology               # {"gpus": n, "hostname", "store"}
        self.labels = dict(labels or {})
        self.state = "ALIVE"
        self.last_heartbeat = time.monotonic()
        self.avail = dict(resources)           # latest reported availability
        self.load = 0                          # queued+running tasks
        self.death_seq = None
        # drain: absolute monotonic deadline for the grace window
        self.drain_deadline = None
        # gray-failure health signals (EWMAs updated per heartbeat):
        # jitter = excess heartbeat interval over the expected cadence,
        # fail = per-tick unexpected worker-death delta. fail_total is
        # the last cumulative counter the node reported.
        self.jitter_ewma = 0.0
        self.fail_total = 0
        self.fail_ewma = 0.0
        # quarantine hysteresis: when the score first dropped below the
        # recovery threshold (None while still dirty) and the last time
        # the un-quarantine probe pinged this node
        self.clean_since = None
        self.last_probe = 0.0

    def view(self) -> dict:
        return {
            "node_id": self.node_id,
            "address": self.address,
            "resources": self.resources,
            "topology": self.topology,
            "labels": self.labels,
            "state": self.state,
            "avail": self.avail,
            "load": self.load,
        }


class GcsServer:
    """In-process GCS server (embed in a dedicated process via main()).

    With ``persistence_path`` set, every state-mutating op is written to a
    write-ahead log before the reply, compacted into a snapshot
    periodically; a restarted GCS on the same path rehydrates
    nodes/actors/KV/locations/functions/tombstones and resumes pubsub seq
    counters, so subscribers resync through the normal seq-gap path and
    nodes re-register on their next rejected heartbeat (reference:
    src/ray/gcs/store_client/redis_store_client.h:33 — the role of the
    Redis-backed table storage, done as a single-writer WAL instead of an
    external store). Durability: appends are flush()ed (survives GCS
    process crash); set ``RTPU_GCS_WAL_FSYNC=1`` to fsync per append and
    additionally survive host/OS crashes."""

    # L7 lock-protection intent for fields whose majority-use lock is
    # NOT their guard:
    # - _pdir: persistence dir path, write-once in __init__, immutable.
    # - _epoch: incarnation marker, write-once in __init__, immutable.
    # - _wal: the BINDING doubles as the "persistence enabled" flag —
    #   set before serving starts and nulled once at close(); readers
    #   probe it lock-free by design (lock order forbids _wal_lock under
    #   self._lock). The file CONTENTS are serialized by _wal_lock.
    # - _epoch_seq: monotonic incarnation counter, write-once in
    #   __init__, immutable.
    # - _fenced / _fenced_by: one-way False->True split-brain latch.
    #   Writers hold self._lock; the per-op dispatch check in _handle
    #   reads it lock-free by design (a latch read can only be one op
    #   late, and taking self._lock on every dispatch would tax the
    #   hot path for a test-of-time rarity).
    _guarded_by_ = {"_pdir": None, "_epoch": None, "_wal": None,
                    "_epoch_seq": None, "_fenced": None,
                    "_fenced_by": None}

    def __init__(self, port: int = 0, authkey: Optional[bytes] = None,
                 persistence_path: Optional[str] = None):
        self._authkey = authkey or cluster_authkey()
        self._peers = None  # lazy ClientCache for actor-restart RPCs
        # restartable/detached actor specs: the GCS owns the restart FSM
        # (reference: gcs_actor_manager.h:278) so actors outlive drivers
        self._actor_specs: Dict[bytes, dict] = {}
        self._lock = make_lock("GcsServer._lock")
        self._cond = threading.Condition(self._lock)
        self._nodes: Dict[bytes, _NodeInfo] = {}
        # condensed peer_health suspicion reports, keyed by reporter
        # node_id -> {"host:port": recent-failure streak}; folded into
        # the per-node health score (transient — not persisted)
        self._peer_reports: Dict[bytes, Dict[str, int]] = {}
        self._next_orphan_scan = 0.0  # health-loop cadence (monotonic)
        self._kv: Dict[str, Any] = {}
        self._named_actors: Dict[str, Tuple[bytes, tuple]] = {}
        self._actor_table: Dict[bytes, dict] = {}
        self._locations: Dict[bytes, List[tuple]] = {}
        # object sizes (bytes), keyed like _locations and sharing its
        # lifecycle: entries die when the last location drops. Sizes feed
        # the driver's locality scorer; None/absent means "unknown".
        self._obj_sizes: Dict[bytes, int] = {}
        self._functions: Dict[bytes, bytes] = {}
        self._deaths: List[Tuple[int, bytes]] = []  # (seq, node_id)
        self._death_seq = 0
        # driver (owner) registry: drivers heartbeat like nodes; a dead
        # driver's objects/actors are reclaimed cluster-wide (reference:
        # job death handling, gcs_job_manager.h — owner-failure semantics
        # of reference_count.h:61 done GCS-mediated)
        self._drivers: Dict[bytes, float] = {}     # driver_id -> last hb
        self._driver_deaths: List[Tuple[int, bytes]] = []
        self._driver_death_seq = 0
        # pubsub channels: bounded event logs with long-poll subscribers
        # (reference: src/ray/pubsub/publisher.h:296)
        self._channels: Dict[str, List[Tuple[int, Any]]] = {}
        self._channel_seq: Dict[str, int] = {}
        # eager-free tombstones (worker-originated frees): bounded,
        # insertion-ordered — consulted before any fetch-retry spin or
        # lineage reconstruction so "free means dead" holds cluster-wide
        self._freed: Dict[bytes, None] = {}
        self._view_version = 0
        self._stop = False
        # Incarnation marker: minted fresh per GCS process, never
        # persisted. Clients compare it across replies to detect that the
        # head restarted (even a fast restart between two heartbeats) and
        # trigger a full resync (reference: gcs_server session_name).
        self._epoch = os.urandom(8).hex()
        # Split-brain fencing latch: set when evidence arrives that a
        # NEWER GCS incarnation exists (a node reported a higher
        # epoch_seq, or rejected one of our writes with
        # StaleGcsEpochError). A fenced head stops restarting actors,
        # stops marking deaths, and rejects mutating ops — the random
        # _epoch above detects restarts, the monotonic _epoch_seq
        # (minted below, after persistence) ORDERS incarnations.
        self._fenced = False
        self._fenced_by = 0  # newest epoch_seq that fenced us
        # RECOVERING window: a restart that rehydrated prior state gives
        # known nodes/drivers this long to heartbeat back in before the
        # health loop may declare them DEAD (set in _load_persisted).
        self._recovering_until = 0.0
        # persistence: rehydrate BEFORE serving so no request sees
        # pre-recovery state. LOCK ORDER: _wal_lock, then self._lock —
        # mutating ops apply-and-log atomically under _wal_lock (the op
        # body takes self._lock inside), and compaction snapshots the same
        # way, so WAL order always matches apply order and no inversion
        # exists. Code holding self._lock must never take _wal_lock
        # (deaths buffer into _wal_pending instead).
        self._wal = None
        self._wal_lock = make_lock("GcsServer._wal_lock")
        self._wal_pending: List[tuple] = []  # guarded by self._lock
        self._wal_count = 0
        self._replaying = False
        self._pdir = persistence_path
        if persistence_path:
            os.makedirs(persistence_path, exist_ok=True)
            self._replaying = True
            self._load_persisted()
            self._replaying = False
            self._wal = open(os.path.join(persistence_path, "wal.pkl"), "ab")
        self._epoch_seq = self._mint_epoch_seq()
        self._server = RpcServer(self._handle, self._authkey, port=port)
        self.address = self._server.address
        netem.set_identity("gcs", self.address)
        self._monitor = threading.Thread(target=self._health_loop,
                                         daemon=True, name="gcs-health")
        self._monitor.start()

    def _mint_epoch_seq(self) -> int:
        """A strictly increasing incarnation number. With a persist dir
        it is a durable counter file (incremented per incarnation, so
        any two heads sharing the dir are totally ordered); without one
        a millisecond timestamp still orders incarnations across
        processes well enough for fencing tests."""
        if self._pdir:
            path = os.path.join(self._pdir, "epoch_seq")
            try:
                with open(path, encoding="utf-8") as f:
                    prev = int(f.read().strip() or 0)
            except (OSError, ValueError):
                prev = 0
            seq = prev + 1
            tmp = path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                f.write(str(seq))
            os.replace(tmp, path)
            return seq
        return int(time.time() * 1000)

    # ------------------------------------------------------- persistence

    def _snapshot_state(self) -> dict:
        with self._lock:
            return {
                "nodes": [(i.node_id, i.address, i.resources, i.topology,
                           i.labels, i.state) for i in self._nodes.values()],
                "kv": dict(self._kv),
                "named_actors": dict(self._named_actors),
                "actor_table": {k: dict(v)
                                for k, v in self._actor_table.items()},
                "locations": {k: list(v)
                              for k, v in self._locations.items()},
                "obj_sizes": dict(self._obj_sizes),
                "functions": dict(self._functions),
                "actor_specs": {k: dict(v)
                                for k, v in self._actor_specs.items()},
                "freed": dict(self._freed),
                "deaths": list(self._deaths),
                "death_seq": self._death_seq,
                "driver_deaths": list(self._driver_deaths),
                "driver_death_seq": self._driver_death_seq,
                "channel_seq": dict(self._channel_seq),
                "channels": {k: list(v) for k, v in self._channels.items()},
                "view_version": self._view_version,
            }

    def _restore_state(self, s: dict):
        # startup path (before the RPC server and health monitor exist),
        # but cheap to hold the lock anyway — so the guarded-field
        # invariant is uniform instead of "except during restore"
        with self._lock:
            for node_id, address, resources, topology, labels, state in \
                    s.get("nodes", []):
                info = _NodeInfo(node_id, address, resources, topology,
                                 labels)
                info.state = state
                if state == "DRAINING":
                    # re-arm the grace window: the pre-crash deadline was
                    # monotonic (meaningless across processes), and the
                    # node reports node_drained itself when it goes idle
                    info.drain_deadline = (time.monotonic()
                                           + config.node_drain_grace_s)
                # ALIVE nodes get a fresh grace period: the health monitor
                # re-marks truly-dead ones after the heartbeat timeout,
                # live ones heartbeat in (and re-register if they were
                # marked DEAD during the outage)
                self._nodes[node_id] = info
            self._kv = dict(s.get("kv", {}))
            self._named_actors = dict(s.get("named_actors", {}))
            self._actor_table = {k: dict(v)
                                 for k, v in s.get("actor_table",
                                                   {}).items()}
            self._locations = {k: list(map(tuple, v))
                               for k, v in s.get("locations", {}).items()}
            self._obj_sizes = dict(s.get("obj_sizes", {}))
            self._functions = dict(s.get("functions", {}))
            self._actor_specs = {k: dict(v)
                                 for k, v in s.get("actor_specs",
                                                   {}).items()}
            self._freed = dict(s.get("freed", {}))
            self._deaths = [tuple(d) for d in s.get("deaths", [])]
            self._death_seq = s.get("death_seq", 0)
            self._driver_deaths = [tuple(d)
                                   for d in s.get("driver_deaths", [])]
            self._driver_death_seq = s.get("driver_death_seq", 0)
            self._channel_seq = dict(s.get("channel_seq", {}))
            self._channels = {k: [tuple(e) for e in v]
                              for k, v in s.get("channels", {}).items()}
            self._view_version = s.get("view_version", 0) + 1

    def _load_persisted(self):
        snap_path = os.path.join(self._pdir, "snapshot.pkl")
        wal_path = os.path.join(self._pdir, "wal.pkl")
        # a crash mid-compaction can strand the temp file; the real
        # snapshot (if any) is intact because os.replace is atomic
        try:
            os.unlink(snap_path + ".tmp")
        except OSError:
            pass
        recovered = False
        if os.path.exists(snap_path):
            with open(snap_path, "rb") as f:
                self._restore_state(pickle.load(f))
            recovered = True
        if os.path.exists(wal_path):
            recovered = recovered or os.path.getsize(wal_path) > 0
            with open(wal_path, "rb") as f:
                while True:
                    try:
                        op, args = pickle.load(f)
                    # rtpu-lint: disable=L4 — a torn tail record from a
                    # crash mid-append can surface as EOFError,
                    # UnpicklingError, or (truncated frame/garbage bytes)
                    # ValueError/AttributeError and others; any failure to
                    # decode the NEXT record means the log ends here
                    except Exception:  # noqa: BLE001
                        break  # torn tail record from a crash: stop here
                    try:
                        if op == "__death__":
                            with self._lock:
                                info = self._nodes.get(args[0])
                                if info is not None \
                                        and info.state == "ALIVE":
                                    self._mark_dead_locked(info)
                        elif op == "__driver_death__":
                            # keep the seq monotonic across restarts so
                            # nodes' watermarks stay valid (spec drops
                            # replay via their own records)
                            with self._lock:
                                self._driver_death_seq += 1
                                self._driver_deaths.append(
                                    (self._driver_death_seq, args[0]))
                        else:
                            getattr(self, "_op_" + op)(*args)
                    # rtpu-lint: disable=L4 — WAL replay is best-effort:
                    # one corrupt/stale record (schema drift across a
                    # version bump, truncated tail write) must not keep
                    # the whole GCS from starting
                    except Exception:  # noqa: BLE001
                        continue
        if recovered:
            self._recovering_until = (time.monotonic()
                                      + config.gcs_recovery_grace_s)

    def _wal_write_locked(self, op: str, args: tuple):
        """Append one record (+ any buffered death records); _wal_lock
        held by the caller."""
        with self._lock:
            pending, self._wal_pending = self._wal_pending, []
        for rec in pending:
            pickle.dump(rec, self._wal)
            self._wal_count += 1
        if op is not None:
            pickle.dump((op, args), self._wal)
            self._wal_count += 1
        self._wal.flush()
        if config.gcs_wal_fsync:
            os.fsync(self._wal.fileno())
        if self._wal_count >= _WAL_SNAPSHOT_EVERY:
            self._compact_locked()

    def _flush_pending_deaths(self):
        """Health-loop hook: persist buffered __death__ records. Runs
        WITHOUT self._lock so the _wal_lock -> self._lock order holds."""
        # rtpu-lint: disable=L7 — deliberate lock-free emptiness probe:
        # a stale read only delays the flush one health-loop tick; the
        # authoritative swap happens under self._lock in
        # _wal_write_locked
        if self._wal is None or not self._wal_pending:
            return
        with self._wal_lock:
            self._wal_write_locked(None, ())

    def _compact_locked(self):
        """Snapshot current state, truncate the WAL (wal lock held; the
        snapshot takes self._lock inside — consistent lock order)."""
        snap_path = os.path.join(self._pdir, "snapshot.pkl")
        tmp = snap_path + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump(self._snapshot_state(), f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, snap_path)
        # fsync the directory too: the rename itself must be durable, or
        # a host crash can resurrect the old snapshot with a truncated WAL
        dfd = os.open(self._pdir, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
        self._wal.close()
        self._wal = open(os.path.join(self._pdir, "wal.pkl"), "wb")
        self._wal_count = 0

    # ------------------------------------------------------------ health

    def _health_loop(self):
        timeout = config.gcs_heartbeat_timeout_s
        drv_timeout = config.driver_heartbeat_timeout_s
        while not self._stop:
            time.sleep(min(0.1, timeout / 4))
            now = time.monotonic()
            if self._fenced:
                # a newer head exists: marking deaths from this side of
                # the partition would fork cluster state (the classic
                # split-brain write) — stand down until killed
                continue
            if now < self._recovering_until:
                # RECOVERING: we just rehydrated from snapshot+WAL and the
                # whole cluster is reconnecting — declaring anything DEAD
                # on a stale last_heartbeat now would cascade restarts for
                # nodes that are merely mid-reconnect
                self._flush_pending_deaths()
                continue
            probe_targets = []
            with self._lock:
                for info in list(self._nodes.values()):
                    if (info.state in _LIVE_STATES
                            and now - info.last_heartbeat > timeout):
                        self._mark_dead_locked(info)
                    elif (info.state == "DRAINING"
                            and info.drain_deadline is not None
                            and now >= info.drain_deadline):
                        # grace window over: whatever was still running
                        # had its chance — declare the drain complete so
                        # the node can deregister cleanly
                        self._apply_drained_locked(info)
                        if self._wal is not None:
                            self._wal_pending.append(
                                ("node_drained", (info.node_id,)))
                for did, last in list(self._drivers.items()):
                    if now - last > drv_timeout:
                        self._mark_driver_dead_locked(did)
                probe_targets = self._quarantine_scan_locked(now)
            self._flush_pending_deaths()
            if probe_targets:
                self._probe_quarantined(probe_targets)
            if now >= self._next_orphan_scan:
                self._next_orphan_scan = now + max(
                    0.1, config.job_lease_ttl_s / 4)
                self._scan_orphan_jobs()

    def _mark_dead_locked(self, info: _NodeInfo):
        # timeout-detected deaths are state too (explicit unregisters are
        # WAL'd as their own op). self._lock is held: BUFFER the record —
        # the health loop flushes it after releasing the lock (lock order
        # forbids taking _wal_lock here).
        if self._wal is not None:
            self._wal_pending.append(("__death__", (info.node_id,)))
        self._peer_reports.pop(info.node_id, None)
        info.drain_deadline = None
        info.state = "DEAD"
        self._death_seq += 1
        info.death_seq = self._death_seq
        self._deaths.append((self._death_seq, info.node_id))
        self._publish_locked("node_deaths", {
            "node_id": info.node_id, "address": list(info.address)})
        self._view_version += 1
        # objects whose only location was the dead node are now lost
        dead_addr = info.address
        for oid, locs in list(self._locations.items()):
            locs = [a for a in locs if a != dead_addr]
            if locs:
                self._locations[oid] = locs
            else:
                del self._locations[oid]
                self._obj_sizes.pop(oid, None)
        # GCS-owned actor restart (reference: gcs_actor_manager.h:278 —
        # the FSM lives HERE so named/detached actors survive driver exit
        # and node death alike)
        # NOT during WAL replay: a replayed death is history — if the
        # actor was since restarted, later WAL records already say where
        # it lives; if its host truly died during the outage, the health
        # monitor re-detects that death after the grace period and this
        # path fires then, on live state.
        lost = [aid for aid, spec in self._actor_specs.items()
                if tuple((self._actor_table.get(aid) or {})
                         .get("node", ())) == dead_addr]
        if lost and not self._stop and not self._replaying:
            threading.Thread(target=self._restart_actors, args=(lost,),
                             daemon=True, name="gcs-actor-restart").start()
        self._cond.notify_all()

    # --------------------------------------- drain / quarantine lifecycle

    def _apply_drained_locked(self, info: _NodeInfo):
        """DRAINING -> DRAINED (self._lock held). The node's data plane
        stays up (objects remain fetchable) but it is out of every
        scheduling pool; its eventual unregister is the quiet path — no
        death event, no lineage reconstruction. Callers that reach this
        from the health loop must buffer the ``node_drained`` WAL record
        themselves (the RPC path is logged by _handle)."""
        if info.state != "DRAINING":
            return
        info.state = "DRAINED"
        info.drain_deadline = None
        self._publish_locked("node_state", {
            "node_id": info.node_id, "address": list(info.address),
            "state": "DRAINED"})
        self._view_version += 1
        self._cond.notify_all()

    def _quarantine_scan_locked(self, now: float) -> List[tuple]:
        """Score every live node and flip gray ones to QUARANTINED
        (self._lock held). Returns the [(node_id, address)] of
        quarantined nodes due for an un-quarantine liveness probe —
        probing is an RPC, so the caller does it after releasing the
        lock.

        Score = heartbeat-jitter EWMA + worker-death-rate EWMA + peer
        suspicion. Suspicion sums the recent-failure streaks other nodes
        report about this one (capped per reporter), discounted by the
        reporter's OWN jitter/failure score — a node that is itself gray
        cannot quarantine its healthy peers by blaming them for its own
        flaky edges."""
        thr = config.quarantine_score_threshold
        if thr <= 0:
            return []
        probes: List[tuple] = []
        for info in self._nodes.values():
            if info.state not in ("ALIVE", "QUARANTINED"):
                continue
            addr_str = f"{info.address[0]}:{info.address[1]}"
            susp = 0.0
            for rid, reports in self._peer_reports.items():
                if rid == info.node_id:
                    continue
                streak = reports.get(addr_str, 0)
                if streak <= 0:
                    continue
                reporter = self._nodes.get(rid)
                own = (reporter.jitter_ewma + reporter.fail_ewma
                       if reporter is not None else 0.0)
                susp += min(streak, 5) / (1.0 + own)
            score = info.jitter_ewma + info.fail_ewma + susp
            if info.state == "ALIVE":
                if score >= thr:
                    info.state = "QUARANTINED"
                    info.clean_since = None
                    self._publish_locked("node_state", {
                        "node_id": info.node_id,
                        "address": list(info.address),
                        "state": "QUARANTINED", "score": score})
                    self._view_version += 1
                    self._cond.notify_all()
                continue
            # QUARANTINED: hysteresis — the score must stay below half
            # the threshold for quarantine_recover_s AND the node must
            # answer a liveness probe before it rejoins the pool
            if score >= thr / 2:
                info.clean_since = None
                continue
            if info.clean_since is None:
                info.clean_since = now
            if (now - info.clean_since >= config.quarantine_recover_s
                    and now - info.last_probe
                    >= max(0.1, config.quarantine_recover_s / 2)):
                info.last_probe = now
                probes.append((info.node_id, info.address))
        return probes

    def _probe_quarantined(self, targets: List[tuple]):
        """Liveness-probe quarantined nodes whose score has stayed clean
        through the hysteresis window; a successful ping restores them
        to ALIVE. Runs WITHOUT self._lock (it is an RPC)."""
        from ray_tpu_torch.core.cluster.rpc import RpcError

        self._ensure_peers()
        for node_id, address in targets:
            try:
                self._peers.get(tuple(address)).call(("ping",))
            except (RpcError, OSError):
                continue
            with self._lock:
                info = self._nodes.get(node_id)
                if info is None or info.state != "QUARANTINED" \
                        or info.clean_since is None:
                    continue
                info.state = "ALIVE"
                info.clean_since = None
                info.jitter_ewma = 0.0
                info.fail_ewma = 0.0
                self._publish_locked("node_state", {
                    "node_id": node_id, "address": list(info.address),
                    "state": "ALIVE"})
                self._view_version += 1
                self._cond.notify_all()

    def _ensure_peers(self):
        from ray_tpu_torch.core.cluster.rpc import ClientCache

        if self._peers is None:
            self._peers = ClientCache(self._authkey)

    # ------------------------------------------- supervised-job orphans

    def _scan_orphan_jobs(self):
        """Re-queue (or fail, per max_restarts policy) RUNNING jobs whose
        agent lease expired — a SIGKILLed agent can no longer strand
        them. Candidates are collected under self._lock; the mutation
        itself is a WAL'd cas_merge keyed on the exact expired lease, so
        a racing agent renewal (or a concurrent scan on another thread)
        safely loses."""
        from ray_tpu_torch.job.backoff import delay_for

        now = time.time()
        with self._lock:
            candidates = [(key, dict(spec), spec.get("lease_expires_at"))
                          for key, spec in self._kv.items()
                          if key.startswith("job/")
                          and isinstance(spec, dict)
                          and spec.get("status") == "RUNNING"
                          and spec.get("lease_expires_at")
                          and spec["lease_expires_at"] < now]
        for key, spec, lease in candidates:
            expect = {"status": "RUNNING", "lease_expires_at": lease}
            restarts = int(spec.get("restarts") or 0)
            max_restarts = int(spec.get("max_restarts") or 0)
            if spec.get("stop_requested"):
                # stop semantics hold across the orphan boundary: the
                # agent died before honoring the stop — finish the job
                # as STOPPED instead of resurrecting it
                updates = {"status": "STOPPED", "lease_expires_at": None,
                           "agent": None,
                           "message": "stopped (agent lost)"}
            elif restarts < max_restarts:
                bo = spec.get("backoff") or {}
                delay = delay_for(spec.get("submission_id") or key,
                                  restarts, bo.get("base_s", 1.0),
                                  bo.get("max_s", 30.0))
                updates = {"status": "PENDING", "agent": None,
                           "restarts": restarts + 1,
                           "next_eligible_at": now + delay,
                           "lease_expires_at": None, "orphaned": True,
                           "backoff_history":
                               list(spec.get("backoff_history") or [])
                               + [delay],
                           "message": "orphaned (agent lease expired); "
                                      "re-queued"}
            else:
                updates = {"status": "FAILED", "lease_expires_at": None,
                           "agent": None,
                           "message": "job agent lost (lease expired)"}
            self._kv_mutate_internal("cas_merge", key, (expect, updates))

    def _kv_mutate_internal(self, op: str, key: str, value=None):
        """A GCS-originated kv mutation with the same apply+log
        discipline _handle gives client ops (callers must NOT hold
        self._lock — lock order is _wal_lock then self._lock)."""
        if self._wal is not None:
            with self._wal_lock:
                result = self._op_kv(op, key, value)
                self._wal_write_locked("kv", (op, key, value))
            return result
        return self._op_kv(op, key, value)

    # ----------------------------------------------- actor restart FSM

    def _restart_actors(self, actor_ids: List[bytes],
                        timeout: float = 300.0, migrate_from=None):
        """Restart (node death) or migrate (``migrate_from`` = the
        draining node's address) the given actors. Migration rides the
        same FSM but is free: no restart-budget charge, no terminal
        branch at budget 0 — the actor is healthy, its host is merely
        being retired — and the live copy is evicted first so exactly
        one incarnation ever runs."""
        from ray_tpu_torch.core.cluster.rpc import RpcError

        self._ensure_peers()
        for aid in actor_ids:
            with self._lock:
                if self._fenced:
                    return  # stale head: a newer incarnation owns the FSM
                spec = self._actor_specs.get(aid)
            if spec is None:
                continue
            opts = dict(spec.get("opts") or {})
            restarts = int(opts.get("max_restarts", 0))
            detached = opts.get("lifetime") == "detached"
            if migrate_from is None:
                if restarts == 0 and not detached:
                    # budget exhausted: terminal — subscribers must fail
                    # buffered calls with ActorDiedError, not keep waiting
                    with self._lock:
                        self._actor_table.setdefault(
                            aid, {})["state"] = "DEAD"
                        self._publish_actor_state_locked(aid, "DEAD", spec,
                                                         opts)
                    continue
                if restarts > 0:
                    opts["max_restarts"] = restarts - 1
            with self._lock:
                self._publish_actor_state_locked(aid, "RESTARTING", spec,
                                                 opts)
            if migrate_from is not None:
                # planned drain: quiesce-then-reap the live copy before
                # the new one exists — queued and in-flight calls finish
                # (bounded by the drain grace), nothing is failed, and
                # exactly one incarnation ever runs. Past the grace the
                # reap turns forceful: the window is a promise to the
                # cluster, not to one chatty actor.
                try:
                    peer = self._peers.get(tuple(migrate_from))
                    grace = time.monotonic() + config.node_drain_grace_s
                    # rtpu-lint: disable=L9 — deliberate poll-until-done
                    # loop, and the op is epoch-fenced (_epoch_seq): a
                    # duplicate eviction of an already-evicted actor is
                    # a no-op, a stale epoch is rejected by the node
                    while not peer.call(("evict_actor", aid,
                                         self._epoch_seq, 0.5)):
                        if time.monotonic() >= grace or self._stop:
                            peer.call(("kill_actor", aid, True,
                                       self._epoch_seq))
                            break
                except StaleGcsEpochError as fe:
                    with self._lock:
                        self._fenced = True
                        self._fenced_by = max(self._fenced_by,
                                              fe.current_seq)
                    return
                except (RpcError, OSError):
                    pass  # node gone mid-drain: death path takes over
            deadline = time.monotonic() + timeout
            nonce = os.urandom(16)
            restarted = False
            while time.monotonic() < deadline and not self._stop:
                addr = self._pick_restart_node(opts)
                if addr is None:
                    time.sleep(0.5)  # pend until a fitting node joins
                    continue
                with self._lock:
                    pickled = self._functions.get(spec["cls_fn_id"])
                try:
                    # one nonce per restart invocation: a lost reply is
                    # retried same-node by the transport and deduped
                    # there; later restarts of the same actor mint their
                    # own nonce. An RpcError reaching HERE means the node
                    # was unreachable even after the same-node retry, so
                    # re-picking a node is right; a create that applied
                    # on a PARTITIONED (not dead) node can still leave a
                    # stale copy — at-least-once under partition, like
                    # the reference's actor restart.
                    self._peers.get(addr).call(
                        ("create_actor", spec["cls_fn_id"], pickled,
                         spec["payload"], list(spec.get("deps") or []),
                         opts, None, aid, nonce, spec.get("owner"),
                         self._epoch_seq))
                except StaleGcsEpochError as fe:
                    # the node has seen a NEWER head: we are the stale
                    # half of a split brain — fence ourselves and stop
                    # writing (the new incarnation owns the restart FSM)
                    with self._lock:
                        self._fenced = True
                        self._fenced_by = max(self._fenced_by,
                                              fe.current_seq)
                    return
                except RpcError:
                    time.sleep(0.5)
                    continue
                # apply + log atomically under _wal_lock (same discipline
                # as _handle) so a concurrent drop_actor_spec can never
                # slot between our apply and our log — replay order must
                # equal apply order or a replayed WAL resurrects a spec
                # that was dropped
                dropped = False
                with self._wal_lock:
                    with self._lock:
                        dropped = aid not in self._actor_specs
                        if not dropped:
                            self._actor_specs[aid] = dict(spec, opts=opts)
                            self._actor_table.setdefault(aid, {}).update(
                                {"node": addr, "state": "RESTARTED"})
                            name = spec.get("name")
                            if name and self._named_actors.get(
                                    name, (None,))[0] == aid:
                                self._named_actors[name] = (aid, addr)
                            self._publish_actor_state_locked(
                                aid, "ALIVE", spec, opts, node=addr)
                            restarted = True
                    if not dropped and self._wal is not None:
                        self._wal_write_locked(
                            "register_actor",
                            (aid, {"node": addr, "state": "RESTARTED"}))
                        self._wal_write_locked(
                            "register_actor_spec",
                            (aid, dict(spec, opts=opts)))
                if dropped:
                    # the actor was killed (drop_actor_spec) while our
                    # create was in flight: reap the copy we just created
                    # or it runs orphaned, holding resources forever
                    try:
                        self._peers.get(addr).call(
                            ("kill_actor", aid, True, self._epoch_seq))
                    except StaleGcsEpochError as fe:
                        with self._lock:
                            self._fenced = True
                            self._fenced_by = max(self._fenced_by,
                                                  fe.current_seq)
                        return
                    except RpcError:
                        pass
                break
            if not restarted:
                # dropped mid-restart or no node materialized before the
                # deadline: terminal either way from the callers' view
                with self._lock:
                    self._actor_table.setdefault(aid, {})["state"] = "DEAD"
                    self._publish_actor_state_locked(aid, "DEAD", spec, opts)

    def _publish_actor_state_locked(self, aid: bytes, state: str,
                                    spec: dict, opts: dict, node=None):
        """One actor-restart FSM transition on the ``actor_state``
        channel (same shape the single-node runtime publishes, so driver
        subscribers handle both sources with one code path)."""
        self._publish_locked("actor_state", {
            "actor_id": aid,
            "state": state,
            "restarts_left": int(opts.get("max_restarts", 0)),
            "name": spec.get("name"),
            "node": list(node) if node else None,
        })

    def _pick_restart_node(self, opts: dict):
        """An ALIVE node whose TOTAL resources cover the request (the
        node's own queue pends the creation if currently busy)."""
        req: Dict[str, float] = {}
        if opts.get("num_cpus"):
            req["CPU"] = float(opts["num_cpus"])
        if opts.get("num_gpus"):
            req["GPU"] = float(opts["num_gpus"])
        for k, v in (opts.get("resources") or {}).items():
            req[k] = req.get(k, 0) + float(v)
        with self._lock:
            fit = [i for i in self._nodes.values() if i.state == "ALIVE"
                   and all(i.resources.get(k, 0) >= v
                           for k, v in req.items())]
        if not fit:
            return None
        fit.sort(key=lambda i: i.load)
        return fit[0].address

    # ------------------------------------------------------------ handler

    def _handle(self, msg, ctx) -> Any:
        op = msg[0]
        if fault_injection.enabled():
            # chaos site: SIGKILL the head mid-request, deterministically
            # keyed by op name (arm e.g. RTPU_FAULT_GCS_KILL=kill:1:kv to
            # die while handling the first kv op)
            if fault_injection.fire("gcs_kill", op) == "kill":
                os.kill(os.getpid(), 9)  # SIGKILL — no cleanup, no WAL flush
        fn = getattr(self, "_op_" + op, None)
        if fn is None:
            raise ValueError(f"unknown GCS op {op!r}")
        if (self._fenced and op in _WAL_OPS
                and (op != "kv" or msg[1] in _WAL_KV_MUTATORS)):
            # stale-writer rejection, server side: once fenced, every
            # state-mutating op gets the typed error — a client still
            # talking to this head must fail over to the new one, not
            # write into a fork
            raise StaleGcsEpochError(
                f"GCS mutation {op!r} rejected: this head is fenced",
                stale_seq=self._epoch_seq, current_seq=self._fenced_by)
        if (self._wal is not None and op in _WAL_OPS
                and (op != "kv" or msg[1] in _WAL_KV_MUTATORS)):
            # apply + log atomically: concurrent mutators serialize here,
            # so replay order always equals apply order
            with self._wal_lock:
                result = fn(*msg[1:])
                self._wal_write_locked(op, tuple(msg[1:]))
            return result
        return fn(*msg[1:])

    # -- nodes

    def _op_register_node(self, node_id: bytes, address, resources,
                          topology, labels=None):
        with self._lock:
            prev = self._nodes.get(node_id)
            # rtpu-lint: disable=L10 — _NodeInfo stamps last_heartbeat
            # with time.monotonic(): transient liveness state, NOT
            # replayed table data. Replay MUST grant a fresh grace
            # window — replaying the original wall-clock stamp would
            # declare every node dead the moment the health loop runs
            # (the recovery grace in _load_persisted depends on this).
            info = _NodeInfo(node_id, address, resources, topology, labels)
            if prev is not None and prev.state in ("DRAINING",
                                                   "QUARANTINED"):
                # a resync re-register must not launder a cordoned node
                # back into the scheduling pool
                info.state = prev.state
                info.drain_deadline = prev.drain_deadline
                info.jitter_ewma = prev.jitter_ewma
                info.fail_ewma = prev.fail_ewma
            self._nodes[node_id] = info
            self._view_version += 1
            self._cond.notify_all()
        return True

    def _op_heartbeat(self, node_id: bytes, avail: dict, load: int,
                      seen_epoch_seq: int = 0, stats: dict = None):
        # replies carry the GCS epoch so nodes detect a head restart even
        # when every heartbeat is accepted (persisted state restored the
        # node as ALIVE) and resync their locations/actors/PGs; they also
        # carry epoch_seq (fencing order), the freed-channel head so a
        # node can cheaply notice frees it missed while partitioned, and
        # the node's lifecycle state so a DRAINING node starts winding
        # down. ``stats`` (optional) feeds the gray-failure scorer:
        # {"task_failures": cumulative worker-death count,
        #  "peer_health": {"host:port": recent-failure streak}}.
        with self._lock:
            if seen_epoch_seq and seen_epoch_seq > self._epoch_seq:
                # the node has heartbeated a NEWER incarnation: this
                # head is the stale side of a split brain — fence
                self._fenced = True
                self._fenced_by = max(self._fenced_by, seen_epoch_seq)
            base = {"epoch": self._epoch, "epoch_seq": self._epoch_seq,
                    "fenced": self._fenced,
                    "freed_head": self._channel_seq.get("freed", 0)}
            info = self._nodes.get(node_id)
            if self._fenced or info is None or info.state == "DEAD":
                # node must re-register (or, fenced: go away entirely)
                return dict(base, accepted=False)
            now = time.monotonic()
            expected = max(1e-3, config.gcs_heartbeat_interval_s)
            # excess interval ratio over 1.5x the cadence (clamped so one
            # huge gap cannot poison the EWMA forever)
            excess = max(0.0, (now - info.last_heartbeat) / expected - 1.5)
            info.jitter_ewma = (0.7 * info.jitter_ewma
                                + 0.3 * min(excess, 10.0))
            info.last_heartbeat = now
            if stats:
                failures = int(stats.get("task_failures") or 0)
                delta = max(0, failures - info.fail_total)
                info.fail_total = failures
                info.fail_ewma = (0.7 * info.fail_ewma
                                  + 0.3 * min(delta, 10.0))
                peer = stats.get("peer_health")
                if peer:
                    self._peer_reports[node_id] = dict(peer)
                else:
                    self._peer_reports.pop(node_id, None)
            if info.avail != avail or info.load != load:
                info.avail = dict(avail)
                info.load = load
                # rtpu-lint: disable=L10 — _view_version is a monotonic
                # cache-invalidation counter, not table data: it is
                # persisted only so a restore resumes PAST every seen
                # value (+1 in _restore_state); losing heartbeat bumps
                # to compaction timing can never roll a client backward
                self._view_version += 1
            state = info.state
        return dict(base, accepted=True, state=state)

    def _op_unregister_node(self, node_id: bytes):
        with self._lock:
            info = self._nodes.get(node_id)
            if info is None:
                return True
            if info.state == "DRAINED":
                # clean deregistration: the drain already migrated the
                # actors and let running work finish, so this is NOT a
                # death — no event on node_deaths, no restart FSM, no
                # lineage reconstruction storm. Its remaining locations
                # drop quietly (consumers fetched during the grace).
                del self._nodes[node_id]
                self._peer_reports.pop(node_id, None)
                dead_addr = info.address
                for oid, locs in list(self._locations.items()):
                    kept = [a for a in locs if a != dead_addr]
                    if kept:
                        self._locations[oid] = kept
                    else:
                        del self._locations[oid]
                        self._obj_sizes.pop(oid, None)
                self._publish_locked("node_state", {
                    "node_id": node_id, "address": list(info.address),
                    "state": "REMOVED"})
                self._view_version += 1
                self._cond.notify_all()
            elif info.state in _LIVE_STATES:
                self._mark_dead_locked(info)
        return True

    def _op_drain_node(self, node_id: bytes):
        """Begin planned removal: ALIVE/QUARANTINED -> DRAINING. The
        scheduler cordon is immediate (only ALIVE nodes are placement
        candidates); restartable/detached actors migrate via the restart
        FSM; running tasks get ``node_drain_grace_s`` to finish before
        the health loop forces DRAINED (the node reports node_drained
        itself as soon as it goes idle)."""
        with self._lock:
            info = self._nodes.get(node_id)
            if info is None or info.state == "DEAD":
                return False
            if info.state in ("DRAINING", "DRAINED"):
                return True  # idempotent: re-drain is a no-op
            info.state = "DRAINING"
            # rtpu-lint: disable=L10 — drain_deadline is transient
            # pacing (monotonic clock is meaningless across processes):
            # replay and _restore_state both deliberately re-arm a
            # FRESH grace window; the durable fact is only the DRAINING
            # state itself
            info.drain_deadline = (time.monotonic()
                                   + config.node_drain_grace_s)
            self._publish_locked("node_state", {
                "node_id": node_id, "address": list(info.address),
                "state": "DRAINING"})
            self._view_version += 1
            addr = info.address
            moving = [aid for aid, spec in self._actor_specs.items()
                      if tuple((self._actor_table.get(aid) or {})
                               .get("node", ())) == addr]
            self._cond.notify_all()
        if moving and not self._stop and not self._replaying:
            threading.Thread(target=self._restart_actors, args=(moving,),
                             kwargs={"migrate_from": addr}, daemon=True,
                             name="gcs-drain-migrate").start()
        return True

    def _op_node_drained(self, node_id: bytes):
        """The node (or the grace-window deadline) reports the drain
        finished: all queued/running work completed."""
        with self._lock:
            info = self._nodes.get(node_id)
            if info is not None:
                self._apply_drained_locked(info)
        return True

    def _op_list_nodes(self, alive_only: bool = False):
        with self._lock:
            return {
                "version": self._view_version,
                "nodes": [i.view() for i in self._nodes.values()
                          if not alive_only or i.state == "ALIVE"],
            }

    def _op_wait_nodes(self, count: int, timeout: float):
        deadline = time.monotonic() + timeout
        with self._lock:
            while True:
                alive = [i for i in self._nodes.values() if i.state == "ALIVE"]
                if len(alive) >= count:
                    return True
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cond.wait(remaining)

    # -- drivers (owners)

    def _op_register_driver(self, driver_id: bytes, meta: dict = None):
        with self._lock:
            self._drivers[driver_id] = time.monotonic()
        return True

    def _op_driver_heartbeat(self, driver_id: bytes) -> bool:
        """False tells the driver to re-register (GCS restarted and lost
        the transient registry)."""
        with self._lock:
            if driver_id not in self._drivers:
                return False
            self._drivers[driver_id] = time.monotonic()
            return True

    def _op_unregister_driver(self, driver_id: bytes):
        """Clean driver exit: no death event — nodes keep its objects
        until normal eviction (a deliberate exit usually follows gets)."""
        with self._lock:
            self._drivers.pop(driver_id, None)
        return True

    def _op_driver_deaths_since(self, seq: int):
        with self._lock:
            return [d for d in self._driver_deaths if d[0] > seq]

    def _mark_driver_dead_locked(self, driver_id: bytes):
        self._drivers.pop(driver_id, None)
        self._driver_death_seq += 1
        self._driver_deaths.append((self._driver_death_seq, driver_id))
        if len(self._driver_deaths) > 256:
            del self._driver_deaths[:-256]
        # stop restarting the dead driver's NON-detached actors; detached
        # ones outlive their driver by definition. BUFFER the drops for
        # the WAL (self._lock is held — same discipline as node deaths):
        # without the record, a GCS restart would replay
        # register_actor_spec and resurrect an ownerless actor forever.
        for aid, spec in list(self._actor_specs.items()):
            opts = spec.get("opts") or {}
            if (spec.get("owner") == driver_id
                    and opts.get("lifetime") != "detached"):
                del self._actor_specs[aid]
                if self._wal is not None:
                    self._wal_pending.append(("drop_actor_spec", (aid,)))
        # persist the death (like node __death__ records): a restarted
        # GCS must keep the seq monotonic, or nodes whose watermark is
        # already past a reset-to-0 seq would never see new deaths
        if self._wal is not None:
            self._wal_pending.append(("__driver_death__", (driver_id,)))
        self._cond.notify_all()

    def _op_deaths_since(self, seq: int):
        with self._lock:
            return [(s, nid) for s, nid in self._deaths if s > seq]

    # -- eager-free tombstones

    def _op_freed_add(self, oid_bytes_list):
        from ray_tpu_torch.core.runtime import note_freed

        with self._lock:
            note_freed(self._freed, oid_bytes_list, cap=1_000_000)
            # broadcast on the "freed" channel: every driver must
            # invalidate its lineage for these ids ("free means dead"),
            # not just discover the tombstone lazily at reconstruction
            # time — a dead entry would otherwise sit charged against
            # the lineage byte budget until evicted
            self._publish_locked("freed", list(oid_bytes_list))
        return True

    def _op_freed_check(self, oid_bytes: bytes) -> bool:
        with self._lock:
            return oid_bytes in self._freed

    # -- kv

    def _op_kv(self, op: str, key: str, value=None):
        with self._lock:
            if op == "put":
                self._kv[key] = value
                return True
            if op == "get":
                return self._kv.get(key)
            if op == "del":
                return self._kv.pop(key, None) is not None
            if op == "exists":
                return key in self._kv
            if op == "keys":
                return [k for k in self._kv if k.startswith(key)]
            if op == "merge":
                # atomic read-modify-write for dict values: concurrent
                # writers can't lose each other's fields
                cur = self._kv.setdefault(key, {})
                cur.update(value or {})
                return dict(cur)
            if op == "cas_merge":
                # value = (expect: {field: val}, updates: {field: val});
                # merge only if every expected field matches; returns the
                # merged dict or None on mismatch
                expect, updates = value
                cur = self._kv.get(key)
                if cur is None or any(cur.get(k) != v
                                      for k, v in expect.items()):
                    return None
                cur.update(updates)
                return dict(cur)
        raise ValueError(f"unknown kv op {op!r}")

    # -- named actors / actor table

    def _op_name_actor(self, name: str, actor_id: bytes, node_addr):
        with self._lock:
            if name in self._named_actors:
                existing_id, _ = self._named_actors[name]
                if existing_id != actor_id:
                    raise ValueError(f"actor name {name!r} already taken")
            self._named_actors[name] = (actor_id, tuple(node_addr))
        return True

    def _op_get_named_actor(self, name: str):
        with self._lock:
            return self._named_actors.get(name)

    def _op_drop_actor_name(self, name: str, actor_id: bytes):
        with self._lock:
            cur = self._named_actors.get(name)
            if cur is not None and cur[0] == actor_id:
                del self._named_actors[name]
        return True

    def _op_register_actor(self, actor_id: bytes, info: dict):
        with self._lock:
            self._actor_table.setdefault(actor_id, {}).update(info)
        return True

    def _op_register_actor_spec(self, actor_id: bytes, spec: dict):
        """Hand the GCS restart authority for this actor: spec carries
        {cls_fn_id, payload, deps, opts, name}; the class pickle must be
        in the GCS function table (register_fn) so a restart can ship it."""
        with self._lock:
            self._actor_specs[actor_id] = dict(spec)
        return True

    def _op_drop_actor_spec(self, actor_id: bytes):
        with self._lock:
            self._actor_specs.pop(actor_id, None)
        return True

    def _op_list_actors(self):
        with self._lock:
            return dict(self._actor_table)

    # -- object directory

    def _op_loc_add(self, oid: bytes, node_addr, nbytes: Optional[int] = None):
        with self._lock:
            locs = self._locations.setdefault(oid, [])
            addr = tuple(node_addr)
            if addr not in locs:
                locs.append(addr)
            if nbytes is not None:
                self._obj_sizes[oid] = int(nbytes)
            self._cond.notify_all()
        return True

    def _op_loc_add_batch(self, oids: List[bytes], node_addr,
                          sizes: Optional[List[Optional[int]]] = None):
        addr = tuple(node_addr)
        with self._lock:
            for i, oid in enumerate(oids):
                locs = self._locations.setdefault(oid, [])
                if addr not in locs:
                    locs.append(addr)
                if sizes is not None and sizes[i] is not None:
                    self._obj_sizes[oid] = int(sizes[i])
            self._cond.notify_all()
        return True

    def _op_loc_get(self, oid: bytes, timeout: float = 0.0):
        deadline = time.monotonic() + timeout
        with self._lock:
            while True:
                locs = self._locations.get(oid)
                if locs:
                    return list(locs)
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return []
                self._cond.wait(remaining)

    def _op_loc_get_batch(self, oids: List[bytes]):
        """Resolve many ids in one RPC: {oid: (addrs, nbytes_or_None)}.

        Non-blocking by design (unlike loc_get's optional wait): callers
        use it to resolve a whole submission's deps for locality scoring,
        where "unknown yet" is an acceptable answer. Ids with no known
        location are omitted from the reply."""
        with self._lock:
            out = {}
            for oid in oids:
                locs = self._locations.get(oid)
                if locs:
                    out[oid] = (list(locs), self._obj_sizes.get(oid))
            return out

    def _op_loc_drop(self, oid: bytes, node_addr):
        addr = tuple(node_addr)
        with self._lock:
            locs = self._locations.get(oid)
            if locs and addr in locs:
                locs.remove(addr)
                if not locs:
                    del self._locations[oid]
                    self._obj_sizes.pop(oid, None)
        return True

    # -- pubsub

    _CHANNEL_CAP = 10_000

    def _publish_locked(self, channel: str, message):
        seq = self._channel_seq.get(channel, 0) + 1
        self._channel_seq[channel] = seq
        log = self._channels.setdefault(channel, [])
        log.append((seq, message))
        if len(log) > self._CHANNEL_CAP:
            del log[: len(log) - self._CHANNEL_CAP]
        self._cond.notify_all()

    def _op_publish(self, channel: str, message):
        with self._lock:
            self._publish_locked(channel, message)
            return self._channel_seq[channel]

    def _op_poll(self, channel: str, since_seq: int, timeout: float = 0.0):
        """Long-poll subscribe: messages with seq > since_seq, blocking up
        to ``timeout`` for the first one. Returns [(seq, message)].

        Seqs are contiguous per channel, so a slow subscriber can DETECT
        trimming: if the first returned seq > since_seq + 1, the log was
        truncated past its cursor and it should resync from a snapshot."""
        deadline = time.monotonic() + timeout
        with self._lock:
            while True:
                if self._channel_seq.get(channel, 0) > since_seq:
                    log = self._channels[channel]
                    # contiguous seqs: index the tail instead of scanning
                    first_seq = log[0][0]
                    start = max(0, since_seq + 1 - first_seq)
                    return log[start:]
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return []
                self._cond.wait(remaining)

    # -- function table

    def _op_register_fn(self, fn_id: bytes, pickled: bytes):
        with self._lock:
            self._functions.setdefault(fn_id, pickled)
        return True

    def _op_get_fn(self, fn_id: bytes):
        with self._lock:
            return self._functions.get(fn_id)

    # -- lifecycle

    def _op_ping(self):
        return "pong"

    def _op_netem(self, cmd: str, *args):
        """Remote control for the netem shim in THIS process: the test
        fixture arms/clears partition rules on the GCS side of an edge
        over a still-healthy path (see core/netem.py)."""
        return netem.control(cmd, *args)

    def _op_gcs_info(self):
        """Identity + recovery status + resync cursors, in one read.

        Clients reconnecting after an outage compare ``epoch`` to the one
        they last saw: a change means the head restarted, so they
        re-register and clamp their pubsub/death cursors to the returned
        heads (after an EMPTY restart the heads reset to 0 and a cursor
        left high would skip every future event; after a persisted
        restart the heads are >= the cursors and nothing moves)."""
        with self._lock:
            return {
                "epoch": self._epoch,
                "epoch_seq": self._epoch_seq,
                "fenced": self._fenced,
                "recovering": time.monotonic() < self._recovering_until,
                "view_version": self._view_version,
                "nodes_alive": sum(1 for i in self._nodes.values()
                                   if i.state == "ALIVE"),
                "channel_seq": dict(self._channel_seq),
                "death_seq": self._death_seq,
                "driver_death_seq": self._driver_death_seq,
            }

    def _op_shutdown_gcs(self):
        threading.Thread(target=self.close, daemon=True).start()
        return True

    def close(self):
        self._stop = True
        if self._wal is not None:
            with self._wal_lock:
                try:
                    self._compact_locked()
                # rtpu-lint: disable=L4 — shutdown-time compaction is an
                # optimization (disk full, unpicklable entry): the
                # uncompacted WAL replays fine on the next start
                except Exception:  # noqa: BLE001
                    pass
                self._wal.close()
                self._wal = None
        self._server.close()


def main(argv=None):
    import argparse
    import signal
    import sys

    p = argparse.ArgumentParser(description="ray_tpu_torch GCS server")
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--persist-dir", default=None,
                   help="directory for the WAL + snapshots; a restarted "
                        "GCS on the same dir rehydrates cluster state")
    args = p.parse_args(argv)
    gcs = GcsServer(port=args.port, persistence_path=args.persist_dir)
    # Parent reads the bound address from stdout.
    print(f"GCS_ADDRESS {gcs.address[0]}:{gcs.address[1]}", flush=True)
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *a: stop.set())
    signal.signal(signal.SIGINT, lambda *a: stop.set())
    stop.wait()
    gcs.close()
    sys.exit(0)


if __name__ == "__main__":
    main()
