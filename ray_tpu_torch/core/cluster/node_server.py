"""Per-node server: local scheduler + object services behind a TCP RPC.

The capability analogue of the reference's raylet (src/ray/raylet/
node_manager.h:119) + object manager (src/ray/object_manager/
object_manager.h:117): each node embeds the single-node ``Runtime`` (worker
pool, shm store, resource-aware scheduler, local PGs) and this server adds

- payload-level task/actor submission from remote drivers,
- node-to-node object transfer (peer ``fetch``, pull-based, GCS object
  directory as the rendezvous),
- lease-style spillback: a task whose resource request can never be met
  locally is forwarded to a peer whose totals fit (reference:
  cluster_task_manager.cc spillback),
- registration + heartbeats to the GCS, and cluster-wide KV / named actors
  via the GCS.

Run as ``python -m ray_tpu_torch.core.cluster.node_server --gcs HOST:PORT``.
"""

from __future__ import annotations

import os
import socket
import threading
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.core import external_storage, netem, protocol, serialization
from ray_tpu_torch.core.cluster.pull_manager import (PRIO_GET, PRIO_TASK_ARGS,
                                               PRIO_WAIT)
from ray_tpu_torch.core.cluster.ha import HaGcsClient, resync_node
from ray_tpu_torch.core.cluster.rpc import (ClientCache, RpcError, RpcServer,
                                      cluster_authkey)
from ray_tpu_torch.core.config import config
from ray_tpu_torch.core.ids import ActorID, ObjectID, PlacementGroupID, make_task_id
from ray_tpu_torch.core.object_ref import ObjectRef
from ray_tpu_torch.core.runtime import Runtime, _TaskSpec
from ray_tpu_torch.util.debug_lock import make_condition, make_lock
from ray_tpu_torch.exceptions import (ActorDiedError, ActorError, ObjectLostError,
                                ObjectStoreFullError, ObjectTimeoutError,
                                StaleGcsEpochError)

# Tag prefix for ops; kept as plain strings (framed pickle transport).

#: sentinel returned by _fetch_ranged when the payload was written
#: directly into the shm store (zero-copy bulk path) — there is nothing
#: left for the caller to store.
_STORED = object()


class _PullAdmissionTimeout(Exception):
    """Bulk-pull budget stayed full past the wait: retry, don't treat
    the source location as dead."""


def materialize(runtime: Runtime, payload) -> Tuple[str, bytes]:
    """Convert a local payload descriptor into wire-safe ("inline", bytes)."""
    kind, data = payload
    if kind == "inline":
        return payload
    if kind == "spilled":
        path = data[0] if isinstance(data, tuple) else data
        return ("inline", bytes(external_storage.read_buffer(path)))
    oid = ObjectID(data)
    view = runtime.store.get(oid, timeout_ms=0)
    try:
        return ("inline", bytes(view))
    finally:
        del view
        runtime.store.release(oid)


def payload_nbytes(runtime: Runtime, payload) -> Optional[int]:
    """Byte size of a stored payload, or None when it cannot be measured
    cheaply. Sizes feed the GCS object directory for locality-aware
    scheduling; 'unknown' merely opts the object out of locality scoring."""
    kind, data = payload
    if kind == "inline":
        try:
            return len(data)
        except TypeError:
            return None
    if kind == "spilled":
        path = data[0] if isinstance(data, tuple) else data
        try:
            return external_storage.size(path)
        except OSError:
            return None
    oid = ObjectID(data)
    try:
        view = runtime.store.get(oid, timeout_ms=0)
    except (ObjectTimeoutError, ValueError, OSError):
        return None
    try:
        return view.nbytes
    finally:
        del view
        runtime.store.release(oid)


def store_incoming(runtime: Runtime, oid: ObjectID, data: bytes):
    """Store wire bytes locally: shm when large, inline entry otherwise."""
    if oid.binary() in runtime._freed:
        return  # eagerly freed while this transfer was in flight
    if len(data) > serialization.inline_threshold() and not runtime.store.contains(oid):
        try:
            # retain: _store_payload adopts the ref as the tracking pin
            runtime.store.put(oid, data, retain=True)
            runtime._store_payload(oid, ("shm", oid.binary()))
            return
        except (ObjectStoreFullError, ValueError, OSError):
            pass  # store full/closed: keep the object inline instead
    runtime._store_payload(oid, ("inline", data))


class NodeRuntime(Runtime):
    """Runtime with cluster hooks: remote-object fetch, actor-call routing,
    cluster KV, spillback, and location publication."""

    def __init__(self, server: "NodeServer", **kw):
        self._server_ref = server
        super().__init__(**kw)

    def register_package(self, pkg_hash: str, data: bytes) -> None:
        """Nested submissions from this node's workers: publish to the
        GCS KV so spillback peers (and later tasks on any node) can pull
        the package — the local table alone would strand spilled tasks."""
        super().register_package(pkg_hash, data)
        srv = self._server_ref
        if srv is not None:
            key = f"pkg:{pkg_hash}"
            if not srv.gcs.call(("kv", "exists", key, None)):
                srv.gcs.call(("kv", "put", key, data))

    def _get_package(self, pkg_hash: str):
        """Runtime_env package lookup: local table first, then the GCS
        KV blob the submitting driver registered; cache locally."""
        data = super()._get_package(pkg_hash)
        if data is None:
            srv = self._server_ref
            if srv is not None:
                # no RAM cache: workers extract once into the shared
                # on-disk session cache and never re-fetch this hash
                data = srv.gcs.call(("kv", "get", f"pkg:{pkg_hash}", None))
        return data

    # locations: publish every stored object id (with its payload size,
    # for the locality scorer) to the GCS directory
    def _store_payload(self, oid, payload):
        super()._store_payload(oid, payload)
        srv = self._server_ref
        if srv is not None and oid.binary() not in srv._unpublished:
            srv.note_location(oid.binary(), payload_nbytes(self, payload))

    # Worker-originated requests that need cluster awareness: remote-object
    # gets/waits, cluster KV, and calls on actors living on peer nodes.
    def _handle_data_request(self, w, msg):
        srv = self._server_ref
        tag = msg[0]
        if srv is not None:
            if tag in (protocol.REQ_GET, protocol.REQ_WAIT):
                prio = (PRIO_GET if tag == protocol.REQ_GET
                        else PRIO_WAIT)
                for b in msg[1]:
                    srv.ensure_available(b, priority=prio)
            elif tag == protocol.REQ_KV:
                _, op, key, value = msg
                return ("ok", srv.gcs.call(("kv", op, key, value)))
            elif tag == protocol.REQ_FREE:
                # worker-originated free: the object may live on any node
                return ("ok", len(srv.free_cluster_wide(msg[1])))
            elif tag == protocol.REQ_KILL_ACTOR:
                aid = ActorID(msg[1])
                if msg[2]:
                    srv.gcs.try_call(("drop_actor_spec", msg[1]))
                if aid in self._actors:
                    self.kill_actor(aid, no_restart=msg[2])
                    return ("ok",)
                # actor lives elsewhere: route via the GCS actor table
                # (brief retry — creation registration may be racing)
                import sys as _sys

                for _ in range(5):
                    info = (srv.gcs.try_call(("list_actors",), default={})
                            or {})
                    entry = info.get(msg[1])
                    if entry and "node" in entry:
                        try:
                            srv._peers.get(tuple(entry["node"])).call(
                                ("kill_actor", msg[1], msg[2]))
                            return ("ok",)
                        except RpcError:
                            pass
                    time.sleep(0.1)
                print(f"kill_actor: could not route kill for {aid} "
                      f"(no table entry / peer unreachable) — the actor "
                      f"may leak", file=_sys.stderr)
                return ("ok",)
            elif tag == protocol.REQ_ACTOR_CALL:
                _, actor_id_b, method, args_payload, extra, n_returns = msg
                if ActorID(actor_id_b) not in self._actors:
                    refs = srv.forward_actor_call_payload(
                        ActorID(actor_id_b), method, args_payload,
                        extra.get("__deps", []), n_returns,
                        opts=extra.get("__opts"))
                    return ("ok", [r.binary() for r in refs])
            elif tag == protocol.REQ_STREAM_NEXT:
                # generator consumed by a worker on a node that does not
                # own the stream: forward one wait slice to the owner
                _, seed, index, timeout_ms, owner = msg
                if seed not in self._streams and owner is not None:
                    return srv._peers.get(tuple(owner)).call(
                        ("stream_next", seed, index, timeout_ms))
            elif tag == protocol.REQ_STREAM_CONSUMED_ASYNC:
                _, seed, index, owner = msg
                if seed not in self._streams and owner is not None:
                    try:
                        # rtpu-lint: disable=L9 — forwarded credit: a
                        # MONOTONIC watermark (owner takes max), so a
                        # lost/duplicate advance only stalls the
                        # producer one poll slice, never corrupts
                        srv._peers.get(tuple(owner)).call(
                            ("stream_consumed", seed, index))
                    except RpcError:
                        pass  # credit update is best-effort
                    return protocol.NO_REPLY
            elif tag == protocol.REQ_ACTOR_CALL_ASYNC:
                _, actor_id_b, method, args_payload, extra, rids_b = msg
                if ActorID(actor_id_b) not in self._actors:
                    try:
                        srv.forward_actor_call_payload(
                            ActorID(actor_id_b), method, args_payload,
                            extra.get("__deps", []), len(rids_b),
                            return_ids=[ObjectID(b) for b in rids_b],
                            opts=extra.get("__opts"))
                    except BaseException as e:  # noqa: BLE001 — at get()
                        # keep ActorError subtypes intact: a worker-side
                        # get must see ActorUnavailableError as itself,
                        # not masked as a terminal death
                        self._store_error(
                            [ObjectID(b) for b in rids_b],
                            e if isinstance(e, ActorError)
                            else ActorDiedError(
                                f"actor call failed: {e!r}"))
                    return protocol.NO_REPLY
        return super()._handle_data_request(w, msg)

    # spillback: infeasible plain tasks leave for a fitting peer
    def _enqueue(self, spec: _TaskSpec):
        srv = self._server_ref
        if srv is not None:
            if (spec.actor_id is None and spec.request is not None
                    and spec.pg_wire is None and spec.stream is None
                    and not spec.request.is_subset_of(self._total)
                    and srv.spill_task(spec)):
                # stream specs never spill: the stream state (and the
                # consumer's cached owner address) is pinned to this node
                return
            srv.mark_local_products(spec.return_ids)
        super()._enqueue(spec)

    def placement_group_ready_ref(self, pg_id):
        ref = super().placement_group_ready_ref(pg_id)
        if self._server_ref is not None:
            self._server_ref.mark_local_products([ref.id])
        return ref

    # cluster-wide KV lives in the GCS
    def kv_op(self, op: str, key: str, value=None):
        return self._server_ref.gcs.call(("kv", op, key, value))

    # cluster-wide pubsub channels live in the GCS too: a worker's
    # REQ_PUBSUB reaches every driver subscribed anywhere in the cluster
    def pubsub_op(self, op: str, channel: str, arg=None,
                  timeout: float = 0.0):
        gcs = self._server_ref.gcs
        if op == "publish":
            return gcs.call(("publish", channel, arg))
        if op == "poll":
            return gcs.call(("poll", channel, int(arg or 0), timeout))
        raise ValueError(op)

    # named actors are registered cluster-wide
    def _create_actor_from_payload(self, cls_fn_id, args_payload, deps, opts,
                                   actor_id=None):
        name = (opts or {}).get("name")
        srv = self._server_ref
        if srv is not None and actor_id is None:
            # a worker's creation this node can never hold leaves for a
            # fitting peer, as an infeasible task does
            spilled = srv.spill_actor(cls_fn_id, args_payload, deps, opts)
            if spilled is not None:
                return spilled
        actor_id = actor_id or ActorID.from_random()
        if srv is not None and name:
            # claim the name cluster-wide BEFORE creating: a creation that
            # loses the race to a peer's must leave no local actor
            # answering to the name (the reference creates first, so two
            # workers racing to create a group's coordinator on two nodes
            # each kept their own)
            srv.gcs.call(("name_actor", name, actor_id.binary(),
                          srv.address))
        try:
            actor_id = super()._create_actor_from_payload(
                cls_fn_id, args_payload, deps, opts, actor_id=actor_id)
        except BaseException:
            if srv is not None and name:
                srv.gcs.try_call(("drop_actor_name", name,
                                  actor_id.binary()))
            raise
        if srv is not None:
            srv.gcs.try_call(("register_actor", actor_id.binary(), {
                "node": srv.address, "name": name, "state": "ALIVE",
                "opts": {k: v for k, v in (opts or {}).items()
                         if k in ("max_restarts", "num_gpus", "num_cpus")},
            }))
        return actor_id

    def _mark_actor_dead(self, state, cause):
        super()._mark_actor_dead(state, cause)
        srv = self._server_ref
        if srv is not None and state.restarts_left == 0:
            name = state.opts.get("name")
            if name:
                srv.gcs.try_call(("drop_actor_name", name,
                                  state.actor_id.binary()))
            srv.gcs.try_call(("register_actor", state.actor_id.binary(),
                              {"state": "DEAD"}))

    # actor calls targeting a peer node's actor (worker-held handles)
    def submit_actor_task(self, actor_id, method, args, kwargs,
                          num_returns=1, options=None):
        if actor_id in self._actors or self._server_ref is None:
            return super().submit_actor_task(
                actor_id, method, args, kwargs, num_returns,
                options=options)
        return self._server_ref.remote_actor_call(
            actor_id, method, args, kwargs, num_returns, options=options)

    def get_actor_method_opts(self, actor_id):
        if actor_id in self._actors or self._server_ref is None:
            return super().get_actor_method_opts(actor_id)
        return self._server_ref.remote_actor_opts(actor_id)

    def kill_actor(self, actor_id, no_restart=True):
        if actor_id in self._actors or self._server_ref is None:
            return super().kill_actor(actor_id, no_restart)
        return self._server_ref.remote_kill_actor(actor_id, no_restart)

    def get_named_actor(self, name: str):
        with self._lock:
            aid = self._named_actors.get(name)
        if aid is not None:
            return aid
        entry = self._server_ref.gcs.call(("get_named_actor", name))
        if entry is None:
            raise ValueError(f"no actor named {name!r}")
        actor_id = ActorID(entry[0])
        self._server_ref.note_remote_actor(actor_id, tuple(entry[1]))
        return actor_id


class NodeServer:
    """One per node process. Owns the NodeRuntime and all cluster links."""

    def __init__(self, gcs_address: Tuple[str, int], num_workers=None,
                 object_store_memory=None, resources: Optional[dict] = None,
                 port: int = 0, authkey: Optional[bytes] = None,
                 labels: Optional[dict] = None):
        if resources and "GPU" in resources:
            # a GPU added as a custom resource would carry no device ids:
            # the actor placed on it would get no CUDA_VISIBLE_DEVICES
            raise ValueError(
                "a node's GPUs come from its own detection (RTPU_GPUS, "
                "CUDA_VISIBLE_DEVICES, /dev/nvidia*), not from --resources: "
                f"got {resources!r}")
        self._authkey = authkey or cluster_authkey()
        # ride-through GCS client: calls buffer across a head restart;
        # an epoch change (the head came back as a new process) triggers
        # a full state resync — see _on_gcs_reconnect
        self.gcs = HaGcsClient(tuple(gcs_address), self._authkey,
                               on_reconnect=self._on_gcs_reconnect)
        self.gcs.call(("ping",))
        self._peers = ClientCache(self._authkey)
        self._stop = False
        self._labels = dict(labels or {})
        # GCS incarnation this node's state is known to be synced into;
        # a heartbeat reply carrying a different epoch (or a rejection)
        # re-runs resync_node until it succeeds. _resync_lock serializes
        # concurrent triggers (heartbeat loop + reconnect hook).
        self._synced_epoch: Optional[str] = None
        self._resync_lock = make_lock("NodeServer._resync_lock")
        # True when this server IS the process (python -m ...node_server):
        # a shutdown_node drain then exits the process so the
        # autoscaler's cloud view sees the node release promptly
        self._owns_process = False

        # node workers log to the session files (served via the get_log
        # op); no local monitor thread — the driver pulls, it isn't pushed
        self.runtime = NodeRuntime(
            self, num_workers=num_workers,
            object_store_memory=object_store_memory, log_to_driver=False)
        self.node_id = self.runtime.node_id
        if resources:
            # extend the node's resource pool with custom resources
            from ray_tpu_torch.core.resources import ResourceSet
            extra = ResourceSet(resources)
            self.runtime._total = self.runtime._total + extra
            self.runtime._avail = self.runtime._avail + extra

        self._server = RpcServer(self._handle, self._authkey, port=port)
        self.address = self._server.address
        netem.set_identity("node", self.address)

        # split-brain fencing: newest GCS epoch_seq observed in
        # heartbeat replies. GCS-originated writes (actor restarts,
        # reaps) carry their sender's seq; a token older than this is a
        # partitioned stale head and is rejected with
        # StaleGcsEpochError (see _check_gcs_epoch). Single-writer
        # (heartbeat thread), lock-free monotonic reads elsewhere.
        self._gcs_epoch_seq = 0
        # freed-channel cursor: heartbeat replies piggyback the channel
        # head, so frees that happened while this node was partitioned
        # are replayed (copies reclaimed, tombstones applied) within
        # one heartbeat of heal — and again during resync, BEFORE
        # locations are re-published (the gcs.py stale-copy hole)
        self._freed_seq = 0
        self._freed_cursor_lock = make_lock("NodeServer._freed_cursor_lock")

        # sender-side transfer flow control (reference: push_manager.h —
        # cap outbound chunk bytes in flight; requesters queue FIFO-ish
        # on the condition instead of over-committing sender memory)
        self._push_cv = make_condition("NodeServer._push_cv")
        self._push_inflight = 0
        self._push_waits = 0  # observability: times a chunk had to queue

        # object-location publication (batched); entries are
        # (oid_bytes, nbytes_or_None) — sizes ride along so the GCS
        # directory can feed the driver's locality scorer
        self._loc_lock = make_lock("NodeServer._loc_lock")
        self._loc_pending: List[Tuple[bytes, Optional[int]]] = []
        self._loc_thread = threading.Thread(
            target=self._loc_flush_loop, daemon=True, name="node-locs")
        self._loc_thread.start()

        # owner-death reclamation (see _owner_of above)
        self._owner_thread = threading.Thread(
            target=self._owner_watch_loop, daemon=True, name="node-owners")
        self._owner_thread.start()

        # exactly-once apply for retried submissions: the wire layer (and
        # cluster_core's failover loops) may re-send a submit/actor_call/
        # create_actor whose REPLY was lost. The sender attaches a fresh
        # NONCE per logical request and reuses it on retries; deliberate
        # re-executions (lineage reconstruction, actor restart) mint a new
        # nonce, so they are never confused with duplicate delivery
        # (reference: task-id dedup in
        # src/ray/core_worker/transport/direct_actor_transport.cc)
        self._applied: "OrderedDict[bytes, tuple]" = OrderedDict()
        self._applied_lock = make_lock("NodeServer._applied_lock")

        # ownership: driver-submitted work tags its return objects (and
        # actors) with the owner driver id; when the GCS declares that
        # driver dead, this node reclaims its objects and kills its
        # non-detached actors (reference: owner-failure cleanup,
        # core_worker/reference_count.h:61 + gcs_job_manager.h, done
        # GCS-mediated instead of per-worker RPC). Worker-created objects
        # carry no owner: the node owns them, so detached-actor state
        # survives driver churn. Bounded: oldest entries age out (an aged
        # object merely falls back to normal LRU/spill lifecycle).
        self._owner_of: "OrderedDict[bytes, bytes]" = OrderedDict()
        self._actor_owner: Dict[bytes, bytes] = {}
        self._owner_lock = make_lock("NodeServer._owner_lock")
        self._driver_death_seq = 0

        # in-flight fetch/proxy threads, keyed by oid bytes; _fetch_prio
        # holds each fetch's mutable priority box (upgradable while the
        # pull is queued for admission)
        self._fetching: set = set()
        self._fetch_prio: Dict[bytes, list] = {}
        self._fetch_lock = make_lock("NodeServer._fetch_lock")
        # cross-node pull throughput (cumulative; surfaced via ("state",))
        self._fetch_stats_lock = make_lock("NodeServer._fetch_stats_lock")
        self._fetch_bytes = 0
        self._fetch_seconds = 0.0
        self._fetch_count = 0
        # per-peer suspicion for fetch-candidate ordering: addr ->
        # [latency EWMA s, consecutive transport failures, last-fail
        # monotonic]. A peer that heartbeats the GCS fine but cannot
        # serve data (asymmetric partition) accumulates failures and
        # sinks to the back of every candidate list instead of eating
        # the pull budget first; surfaced via ("state",).
        self._peer_health: Dict[Tuple[str, int], list] = {}
        self._peer_health_lock = make_lock("NodeServer._peer_health_lock")
        # pull admission: bulk transfers reserve their byte size against
        # a store-derived budget, in priority order task-args > get >
        # wait (reference: pull_manager.h:52). Small payloads (below the
        # ranged-transfer threshold) skip admission — they are bounded
        # by the threshold itself.
        from ray_tpu_torch.core.cluster.pull_manager import PullManager
        self.pulls = PullManager(int(
            self.runtime.store.stats()["heap_size"]
            * config.pull_admission_fraction))
        # return ids a local submission will produce (no fetch needed)
        self._local_products: set = set()
        # ids whose stored payload must NOT be published as a location
        # (locally-synthesized error values)
        self._unpublished: set = set()
        # ids latched with a local fetch-timeout error: a later get clears
        # the entry and retries the fetch (the producer may just be slow)
        self._lost_marked: set = set()

        # tasks spilled to peers: first-return-id -> peer address
        self._forwarded: Dict[bytes, Tuple[str, int]] = {}
        # known remote actors: actor_id -> node address
        self._remote_actors: Dict[ActorID, Tuple[str, int]] = {}

        # drain wind-down: latched once when a heartbeat reply says the
        # GCS moved this node to DRAINING (guarded by _drain_lock)
        self._drain_started = False
        self._drain_lock = make_lock("NodeServer._drain_lock")

        self.gcs.call(self.register_msg())
        self._hb_thread = threading.Thread(
            target=self._heartbeat_loop, daemon=True, name="node-heartbeat")
        self._hb_thread.start()

    # --------------------------------------------------------------- plumbing

    def register_msg(self) -> tuple:
        """The register_node RPC for THIS node — one builder so initial
        registration, heartbeat-rejection recovery, and post-failover
        resync all register identically (same node_id: the GCS replaces
        the row wholesale, so re-registration never double-counts
        resources)."""
        gpus = self.runtime.gpus
        return ("register_node", self.node_id.binary(), self.address,
                self.runtime._total.to_dict(),
                {"gpus": gpus.num_gpus if gpus is not None else 0,
                 "store": self.runtime.store.name,
                 "hostname": socket.gethostname(), "pid": os.getpid()},
                dict(self._labels))

    def _heartbeat_loop(self):
        interval = config.gcs_heartbeat_interval_s
        while not self._stop:
            rt = self.runtime
            with rt._lock:
                avail = rt._avail.to_dict()
                load = len(rt._task_queue)
                failures = getattr(rt, "_worker_death_count", 0)
            # condensed per-peer suspicion: only peers with a RECENT
            # failure streak ride the heartbeat, so healed edges decay
            # out of the GCS health score instead of pinning it forever
            now = time.monotonic()
            recent = config.gcs_heartbeat_timeout_s
            with self._peer_health_lock:
                peer = {f"{h}:{p}": int(st[1])
                        for (h, p), st in self._peer_health.items()
                        if st[1] > 0 and now - st[2] < recent}
            reply = self.gcs.try_call(
                ("heartbeat", self.node_id.binary(), avail, load,
                 self._gcs_epoch_seq,
                 {"task_failures": failures, "peer_health": peer}))
            if reply is not None:
                seq = reply.get("epoch_seq")
                if isinstance(seq, int) and seq > self._gcs_epoch_seq:
                    self._gcs_epoch_seq = seq
                head = reply.get("freed_head")
                if isinstance(head, int):
                    self._drain_freed(head)
                epoch = reply.get("epoch")
                rejected = not reply.get("accepted", True)
                if self._synced_epoch is None and not rejected:
                    # first contact after our own registration: baseline
                    self._synced_epoch = epoch
                elif rejected or (epoch is not None
                                  and epoch != self._synced_epoch):
                    # marked dead (long GC pause or a healed partition),
                    # or the head restarted (possibly from EMPTY state —
                    # epoch changed even though the rehydrated row
                    # accepted us): re-register and re-publish
                    # locations/actors/PG state. A rejection forces the
                    # resync even under an unchanged epoch: the head
                    # never restarted, it declared US dead, so the
                    # same-epoch dedup must not swallow the re-register.
                    self._resync(epoch, force=rejected)
                if reply.get("state") == "DRAINING":
                    self._begin_drain()
            time.sleep(interval)

    def _begin_drain(self):
        """Heartbeat said the GCS is draining this node: wind down —
        wait for the local queue and in-flight work to empty (actors
        were migrated by the GCS restart FSM; the scheduler cordon
        stops new arrivals), then report node_drained. The process
        stays up serving fetches so consumers can pull results; the
        actual removal is a later (clean) unregister."""
        with self._drain_lock:
            if self._drain_started:
                return
            self._drain_started = True

        def monitor():
            rt = self.runtime
            idle_beats = 0
            while not self._stop and idle_beats < 3:
                with rt._lock:
                    busy = (len(rt._task_queue)
                            + sum(len(w.inflight)
                                  for w in rt._workers.values()))
                idle_beats = idle_beats + 1 if busy == 0 else 0
                time.sleep(0.05)
            if not self._stop:
                # rtpu-lint: disable=L9 — state-machine edge: the GCS
                # applies node_drained only while the node is DRAINING,
                # and a lost reply is healed by the drain-deadline
                # backstop in the GCS monitor (forces DRAINED at grace)
                self.gcs.try_call(("node_drained", self.node_id.binary()))

        threading.Thread(target=monitor, daemon=True,
                         name="node-drain-monitor").start()

    def _clamp_freed_cursor(self, head: int):
        """Rewind the freed-channel cursor after a head restart from
        EMPTY state (the channel seq reset below our watermark)."""
        with self._freed_cursor_lock:
            self._freed_seq = min(self._freed_seq, int(head))

    def _drain_freed(self, head: Optional[int] = None):
        """Apply freed-id broadcasts this node may have missed: a
        driver's free fan-out cannot reach a partitioned node, so on
        heal (heartbeat piggybacks the channel head) or resync we
        replay the ``freed`` channel from our cursor — reclaiming local
        copies and tombstoning the ids so a healed node never serves,
        re-publishes, or re-fetches a stale copy of a freed object.
        ``head`` short-circuits the poll when nothing new was freed; a
        trimmed channel (gap past _CHANNEL_CAP) degrades to the lazy
        per-fetch freed_check, which stays authoritative."""
        with self._freed_cursor_lock:
            since = self._freed_seq
            if head is not None and head <= since:
                return
            msgs = self.gcs.try_call(("poll", "freed", since, 0.0))
            if not msgs:
                return
            freed: List[bytes] = []
            for seq, oid_list in msgs:
                if seq > self._freed_seq:
                    self._freed_seq = seq
                freed.extend(oid_list)
        if not freed:
            return
        # free BEFORE tombstoning: free_objects skips already-tombstoned
        # ids (same ordering free_cluster_wide relies on)
        from ray_tpu_torch.core.runtime import note_freed
        self._op_free(freed)
        rt = self.runtime
        with rt._lock:
            note_freed(rt._freed, freed)

    def _resync(self, epoch: Optional[str], force: bool = False):
        with self._resync_lock:
            if not force and epoch is not None \
                    and self._synced_epoch == epoch:
                return  # a concurrent trigger already resynced into it
            if resync_node(self):
                self._synced_epoch = epoch

    def _on_gcs_reconnect(self, info: dict):
        # runs from whichever thread's call detected the restart — hand
        # the (RPC-heavy) resync to its own thread so that caller's op
        # returns promptly
        threading.Thread(target=self._resync, args=(info.get("epoch"),),
                         daemon=True, name="node-gcs-resync").start()

    def note_location(self, oid_bytes: bytes, nbytes: Optional[int] = None):
        with self._loc_lock:
            self._loc_pending.append((oid_bytes, nbytes))

    def _loc_flush_loop(self):
        while not self._stop:
            time.sleep(0.02)
            with self._loc_lock:
                batch, self._loc_pending = self._loc_pending, []
            if batch:
                ok = self.gcs.try_call(
                    ("loc_add_batch", [b for b, _ in batch],
                     self.address, [n for _, n in batch]))
                if ok is None:
                    # head unreachable (e.g. mid-failover): requeue so
                    # the publications land once it is back, bounded so
                    # a long outage can't grow the buffer without limit
                    with self._loc_lock:
                        self._loc_pending[:0] = batch
                        del self._loc_pending[100_000:]

    def note_remote_actor(self, actor_id: ActorID, addr: Tuple[str, int]):
        self._remote_actors[actor_id] = tuple(addr)

    def _alive_peers(self) -> List[dict]:
        view = self.gcs.call(("list_nodes", True))
        return [n for n in view["nodes"]
                if tuple(n["address"]) != self.address]

    # ---------------------------------------------------- object availability

    def mark_local_products(self, oids):
        for oid in oids:
            self._local_products.add(
                oid if isinstance(oid, bytes) else oid.binary())

    def ensure_available(self, oid_bytes: bytes,
                         hint: Optional[Tuple[str, int]] = None,
                         priority: int = PRIO_GET):
        """Ensure an object id will eventually resolve locally, starting at
        most one background fetch/proxy per id. No-ops for ids a local
        submission will produce, and for already-resolved entries.
        ``priority`` orders bulk-transfer admission (pull_manager.py:
        PRIO_TASK_ARGS=0 > PRIO_GET=1 > PRIO_WAIT=2)."""
        if oid_bytes in self._local_products:
            return
        rt = self.runtime
        oid = ObjectID(oid_bytes)
        if oid_bytes in self._lost_marked:
            # previously latched a fetch-timeout error: clear the entry so
            # this get retries the fetch (waiters of the old error already
            # observed it)
            self._lost_marked.discard(oid_bytes)
            with rt._lock:
                rt._objects.pop(oid, None)
        with rt._lock:
            e = rt._objects.get(oid)
            if e is not None and e.event.is_set():
                return
        with self._fetch_lock:
            if oid_bytes in self._fetching:
                # already pulling: UPGRADE its class if ours is more
                # urgent (reference: PullManager re-prioritizes when a
                # higher-priority requester arrives for the same object)
                box = self._fetch_prio.get(oid_bytes)
                if box is not None and priority < box[0]:
                    box[0] = priority
                return
            self._fetching.add(oid_bytes)
            box = [priority]
            self._fetch_prio[oid_bytes] = box
        fwd = self._forwarded.get(oid_bytes)
        t = threading.Thread(target=self._fetch_object,
                             args=(oid_bytes, fwd or hint, box),
                             daemon=True, name="node-fetch")
        t.start()

    def _fetch_from(self, addr, oid_bytes: bytes,
                    prio_box=None) -> Optional[bytes]:
        """Pull one object from a peer. Large payloads transfer as ranged
        chunks over ``fetch_parallelism`` dedicated connections — the DCN
        bulk path (reference: object_manager chunked pushes over multiple
        gRPC streams); small ones take the single-call fast path."""
        threshold = config.fetch_parallel_threshold_bytes
        t0 = time.monotonic()
        data = self._peers.get(addr).call(
            ("fetch", oid_bytes, threshold if threshold > 0 else None))
        if data is None:
            return None
        if data[0] != "size":
            self._note_fetch(len(data[1]), time.monotonic() - t0)
            return data[1]
        size = data[1]

        # bulk transfer: reserve the payload size against the pull
        # budget, in priority order (reference: pull_manager.h:52). A
        # timed-out reservation surfaces as a retriable failure — the
        # caller's fetch loop re-attempts, so pressure delays, never
        # deadlocks. The priority BOX rides into acquire: a concurrent
        # upgrade (ensure_available from a task-args requester) re-ranks
        # the waiter in place without losing its queue position.
        prio_box = prio_box if prio_box is not None else [PRIO_GET]
        requested_ts = time.time()
        if not self.pulls.acquire(size, prio_box,
                                  timeout=config.pull_acquire_timeout_s):
            raise _PullAdmissionTimeout(
                f"pull admission timed out for {size}B from "
                f"{addr[0]}:{addr[1]} after "
                f"{config.pull_acquire_timeout_s:g}s (priority {prio_box[0]}; "
                f"flag pull_acquire_timeout_s)")
        priority = prio_box[0]  # class at grant time, for the timeline
        granted_ts = time.time()
        granted_mono = time.monotonic()
        ok = False
        try:
            data = self._fetch_ranged(addr, oid_bytes, size)
            ok = True
            self._note_fetch(size, time.monotonic() - granted_mono)
            return data
        finally:
            self.pulls.release(size)
            rt = self.runtime
            if rt._events is not None and len(rt._events) < 200_000:
                from ray_tpu_torch.core.cluster.pull_manager import prio_name
                rt._events.append({
                    "task_id": oid_bytes.hex(),
                    "parent_task_id": None,
                    "fn": (f"pull:{prio_name(priority)}"
                           + ("" if ok else ":failed")),
                    "actor": None, "worker": "pull", "pid": 0,
                    "submitted": requested_ts,
                    "dispatched": granted_ts,
                    "done": time.time(),
                })

    def _fetch_ranged(self, addr, oid_bytes: bytes, size: int):
        """Chunked bulk pull. The normal path pre-creates the shm store
        allocation and writes every ranged chunk straight into it, then
        seals — ONE copy from socket to store, where the old
        assemble-into-bytearray-then-bytes() path held two full copies at
        peak. Returns ``_STORED`` when the payload landed in the store
        (caller skips store_incoming), else the assembled bytes (store
        full / id already allocated: rare pressure fallback)."""
        rt = self.runtime
        oid = ObjectID(oid_bytes)
        chunk = max(1 << 20, config.fetch_chunk_bytes)
        nstreams = max(1, min(config.fetch_parallelism,
                              (size + chunk - 1) // chunk))
        offsets = list(range(0, size, chunk))
        dst = None
        try:
            if oid_bytes not in rt._freed and not rt.store.contains(oid):
                try:
                    dst = rt.store.create_object(oid, size)
                except (ObjectStoreFullError, ValueError, OSError):
                    dst = None  # heap-assembly fallback below
            buf = None if dst is not None else bytearray(size)
            out = dst if dst is not None else memoryview(buf)
            failed: List[str] = []
            idx_lock = make_lock("NodeServer._fetch_ranged.<idx>")
            next_idx = [0]

            client = self._peers.get(addr)  # pooled: N concurrent calls
            # use N connections, kept for future transfers to the same peer

            def puller():
                try:
                    while not failed:
                        with idx_lock:
                            if next_idx[0] >= len(offsets):
                                return
                            off = offsets[next_idx[0]]
                            next_idx[0] += 1
                        n = min(chunk, size - off)
                        part = client.call(
                            ("fetch_range", oid_bytes, off, n))
                        if part is None or len(part) != n:
                            failed.append(f"range {off}+{n} unavailable")
                            return
                        out[off:off + n] = part
                except Exception as e:  # noqa: BLE001
                    failed.append(repr(e))

            threads = [threading.Thread(target=puller, daemon=True,
                                        name="node-fetch-range")
                       for _ in range(nstreams)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        except BaseException:
            # transfer machinery failed before the verdict below (e.g.
            # dialing the peer raised): an unsealed allocation is
            # invisible to getters and reclaimed only at store close —
            # abort it before surfacing
            if dst is not None:
                rt.store.release(oid)
                rt.store.delete(oid)
            raise
        if failed:
            if dst is not None:
                # abort the unsealed allocation: drop the creator ref,
                # then free (an unsealed object is invisible to getters,
                # so nobody else can hold it)
                rt.store.release(oid)
                rt.store.delete(oid)
            raise RpcError(f"chunked fetch of {size} bytes from "
                           f"{addr} failed: {failed[0]}")
        if dst is not None:
            rt.store.seal(oid, retain=True)
            if oid_bytes in rt._freed:
                # freed while the transfer was in flight: reclaim instead
                # of publishing (mirrors store_incoming's tombstone check)
                rt.store.release(oid)
                rt.store.delete(oid)
                return _STORED
            # retain'd ref hands off to the tracking pin; publishes the
            # location (with size) like any other stored payload
            rt._store_payload(oid, ("shm", oid_bytes))
            return _STORED
        return bytes(buf)

    def _note_fetch(self, nbytes: int, seconds: float):
        with self._fetch_stats_lock:
            self._fetch_bytes += nbytes
            self._fetch_seconds += seconds
            self._fetch_count += 1

    def _note_peer(self, addr, ok: bool, elapsed: float = 0.0):
        """Update per-peer suspicion after a transfer attempt: latency
        EWMA plus a consecutive-transport-failure counter. Under an
        asymmetric partition a peer may accept our TCP connect yet never
        deliver (one-way netem/blackhole) — the failure streak, not the
        connect, is what marks it suspect."""
        addr = tuple(addr)
        with self._peer_health_lock:
            h = self._peer_health.setdefault(addr, [0.0, 0, 0.0])
            if ok:
                h[0] = elapsed if h[0] == 0.0 else 0.8 * h[0] + 0.2 * elapsed
                h[1] = 0
            else:
                h[1] += 1
                h[2] = time.monotonic()

    def _peer_suspicion(self, addr) -> Tuple[int, float]:
        """Sort key for fetch candidates: peers with an active failure
        streak are tried LAST, ties broken by latency EWMA — a fetch
        under an asymmetric partition fails over to a reachable copy
        instead of burning its budget on the severed edge."""
        with self._peer_health_lock:
            h = self._peer_health.get(tuple(addr))
            return (0, 0.0) if h is None else (h[1], h[0])

    def _fetch_object(self, oid_bytes: bytes, hint, prio_box=None):
        rt = self.runtime
        oid = ObjectID(oid_bytes)
        prio_box = prio_box if prio_box is not None else [PRIO_GET]
        started = time.monotonic()
        deadline = started + 600.0
        transport_failures = 0
        suspects: Dict[Tuple[str, int], str] = {}
        try:
            while not self._stop:
                e = rt._objects.get(oid)
                if e is not None and e.event.is_set():
                    return  # resolved locally meanwhile
                addrs: List[Tuple[str, int]] = []
                if hint:
                    addrs.append(tuple(hint))
                locs = self.gcs.try_call(("loc_get", oid_bytes, 0.5),
                                         default=[])
                addrs.extend(tuple(a) for a in locs or [])
                # dedup, then try the least-suspect peers first: under an
                # asymmetric partition the severed copy fails in
                # milliseconds and the fetch fails over to a healthy
                # replica instead of re-dialing the dead edge
                addrs = sorted(dict.fromkeys(addrs),
                               key=self._peer_suspicion)
                for addr in addrs:
                    if addr == self.address:
                        continue
                    attempt_t0 = time.monotonic()
                    try:
                        data = self._fetch_from(addr, oid_bytes,
                                                prio_box)
                    except _PullAdmissionTimeout:
                        # location is fine — the budget was busy.
                        # Age the priority (a starved get/wait climbs to
                        # task-args class, whose FIFO bounds its wait)
                        # and push the loss deadline out: congestion is
                        # delay, never data loss.
                        prio_box[0] = max(0, prio_box[0] - 1)
                        deadline = max(deadline,
                                       time.monotonic() + 300.0)
                        continue
                    except (RpcError, Exception) as err:  # noqa: BLE001
                        self._note_peer(addr, False)
                        transport_failures += 1
                        suspects[addr] = f"{type(err).__name__}: {err}"
                        if self._peer_suspicion(addr)[0] >= 3:
                            # a sustained streak, not a blip: retract the
                            # location so other pulls stop dialing it. A
                            # sub-second partition keeps its directory
                            # entry and resumes on heal.
                            self.gcs.try_call(
                                ("loc_drop", oid_bytes, addr))
                        continue
                    if data is _STORED:
                        self._note_peer(
                            addr, True, time.monotonic() - attempt_t0)
                        return  # zero-copy path already sealed + published
                    if data is not None:
                        self._note_peer(
                            addr, True, time.monotonic() - attempt_t0)
                        store_incoming(rt, oid, data)
                        return
                # no copy anywhere: an eagerly-freed object must fail NOW
                # with the documented message, not spin out the deadline
                if self.gcs.try_call(("freed_check", oid_bytes),
                                     default=False):
                    self._unpublished.add(oid_bytes)
                    self._lost_marked.add(oid_bytes)
                    try:
                        rt._store_payload(oid, protocol.serialize_value(
                            protocol.ErrorValue(ObjectLostError(
                                f"object {oid} was freed by ray_tpu_torch.free() "
                                f"and is not reconstructable")), store=None))
                    finally:
                        self._unpublished.discard(oid_bytes)
                    return
                if transport_failures >= 8 and \
                        time.monotonic() - started > 2.0:
                    # every known copy sits behind a severed edge and the
                    # failure streak has outlived the blip grace: latch
                    # the loss NOW (naming the unreachable peers) so the
                    # waiter's reconstruction/retry machinery kicks in
                    # seconds after the partition, not after the full
                    # 600s pull budget. A sub-second partition never gets
                    # here — attempts resume as soon as it heals.
                    who = "; ".join(
                        f"{a[0]}:{a[1]} ({why})"
                        for a, why in sorted(suspects.items()))
                    self._unpublished.add(oid_bytes)
                    self._lost_marked.add(oid_bytes)
                    try:
                        rt._store_payload(oid, protocol.serialize_value(
                            protocol.ErrorValue(ObjectLostError(
                                f"object {oid} unreachable: every known "
                                f"copy is behind a partitioned peer after "
                                f"{transport_failures} transport failures"
                                f" — {who}")), store=None))
                    finally:
                        self._unpublished.discard(oid_bytes)
                    return
                if time.monotonic() > deadline:
                    # Surface ObjectLostError to local waiters (queued
                    # tasks would otherwise hang forever on the dep) but
                    # never publish this node as a location for it — the
                    # error value is local, not the object.
                    oid_b = oid.binary()
                    self._unpublished.add(oid_b)
                    self._lost_marked.add(oid_b)
                    try:
                        rt._store_payload(oid, protocol.serialize_value(
                            protocol.ErrorValue(ObjectLostError(
                                f"object {oid} could not be fetched from "
                                f"any node within 600s")), store=None))
                    finally:
                        self._unpublished.discard(oid_b)
                    return
                time.sleep(0.05)
        finally:
            with self._fetch_lock:
                self._fetching.discard(oid_bytes)
                self._fetch_prio.pop(oid_bytes, None)

    # --------------------------------------------------------------- spilling

    def spill_task(self, spec: _TaskSpec) -> bool:
        """Forward an infeasible task to a peer whose totals fit. Returns
        True when spilled."""
        try:
            peers = self._alive_peers()
        except RpcError:
            return False
        req = spec.request.to_dict()
        fit = [n for n in peers
               if all(n["resources"].get(k, 0) >= v for k, v in req.items())]
        if not fit:
            return False
        fit.sort(key=lambda n: (n["load"],
                                -sum(n["avail"].get(k, 0) for k in req)))
        target = tuple(fit[0]["address"])
        rt = self.runtime
        with rt._lock:
            pickled_fn = rt._functions.get(spec.fn_id)
        payload = materialize(rt, spec.args_payload)
        msg = ("submit", spec.fn_id, pickled_fn, payload,
               [d.binary() for d in spec.deps],
               [d.binary() for d in spec.nested_deps],
               [r.binary() for r in spec.return_ids],
               spec.options, None, os.urandom(16))
        try:
            self._peers.get(target).call(msg)
        except RpcError:
            return False
        for rid in spec.return_ids:
            self._forwarded[rid.binary()] = target
        # free the resources this spec reserved from accounting (it never
        # acquired; request simply never enters the local pool)
        return True

    def spill_actor(self, cls_fn_id: bytes, args_payload, deps, opts
                    ) -> Optional[ActorID]:
        """Create on a peer an actor a local worker asked for that this
        node cannot hold: one whose request exceeds this node's totals
        goes to a peer whose totals fit; one that does not fit what is
        free here now goes to a peer where it fits what is free there
        (lease spillback). A placement-group member stays: its bundle is
        here. Returns the actor's id, or None to create it here. The
        reference leaves such an actor pending on the worker's node, so
        a serve controller's replicas never leave its node."""
        rt = self.runtime
        request, pg_wire = rt._prepare_request(dict(opts or {}),
                                               is_actor=True)
        if pg_wire is not None or request is None:
            return None
        with rt._lock:
            feasible = request.is_subset_of(rt._total)
            if feasible and request.is_subset_of(rt._avail):
                return None
        try:
            peers = self._alive_peers()
        except RpcError:
            return None
        req = request.to_dict()
        pool = "avail" if feasible else "resources"
        fit = [n for n in peers
               if all(n[pool].get(k, 0) >= v for k, v in req.items())]
        if not fit:
            return None
        fit.sort(key=lambda n: (n["load"],
                                -sum(n["avail"].get(k, 0) for k in req)))
        target = tuple(fit[0]["address"])
        with rt._lock:
            pickled_cls = rt._functions.get(cls_fn_id)
        dep_b = [d.binary() for d in deps]
        actor_id = ActorID.from_random()
        self._peers.get(target).call(
            ("create_actor", cls_fn_id, pickled_cls,
             materialize(rt, args_payload), dep_b, dict(opts or {}),
             {b: self.address for b in dep_b}, actor_id.binary(),
             os.urandom(16), None))
        self._remote_actors[actor_id] = target
        return actor_id

    # ------------------------------------------------- remote actor routing

    def _actor_addr(self, actor_id: ActorID) -> Tuple[str, int]:
        addr = self._remote_actors.get(actor_id)
        if addr is None:
            table = self.gcs.call(("list_actors",))
            info = table.get(actor_id.binary())
            if info is None or info.get("state") == "DEAD" or "node" not in info:
                raise ActorDiedError(f"unknown actor {actor_id}")
            addr = tuple(info["node"])
            self._remote_actors[actor_id] = addr
        return addr

    def remote_actor_call(self, actor_id: ActorID, method: str, args, kwargs,
                          num_returns: int, options=None) -> List[ObjectRef]:
        rt = self.runtime
        args2, kwargs2, deps = rt._swap_top_level_refs(args, kwargs)
        payload, nested = protocol.serialize_args(args2, kwargs2, store=None)
        return self._send_actor_call(
            actor_id, method, payload, [d.binary() for d in deps],
            [r.binary() for r in nested], num_returns, opts=options)

    def forward_actor_call_payload(self, actor_id: ActorID, method: str,
                                   args_payload, deps: List[bytes],
                                   num_returns: int,
                                   return_ids: Optional[List[ObjectID]]
                                   = None, opts=None) -> List[ObjectRef]:
        """Route a worker's call on a peer node's actor (payload level).
        ``return_ids`` preset = fire-and-forget caller already handed
        refs out."""
        return self._send_actor_call(
            actor_id, method, materialize(self.runtime, args_payload),
            list(deps), [], num_returns, return_ids=return_ids, opts=opts)

    def _send_actor_call(self, actor_id, method, payload, deps, nested,
                         num_returns, return_ids=None,
                         opts=None) -> List[ObjectRef]:
        rt = self.runtime
        if return_ids is None:
            return_ids = [ObjectID.from_random()
                          for _ in range(num_returns)]
        msg = ("actor_call", actor_id.binary(), method, payload, deps, nested,
               [r.binary() for r in return_ids], os.urandom(16), None, False,
               dict(opts or {}))
        addr = self._actor_addr(actor_id)
        try:
            self._peers.get(addr).call(msg)
        except (RpcError, ActorDiedError):
            # stale cache: the actor may have been restarted on another
            # node. The GCS re-registers it only once the new incarnation
            # is up, so keep re-resolving for the restart window — a call
            # racing a cross-node restart must land on the new
            # incarnation, not surface a transient routing error.
            # _actor_addr itself raising (table says DEAD/unknown) stays
            # terminal: that's a real death, not a stale route.
            self._remote_actors.pop(actor_id, None)
            deadline = time.monotonic() + config.actor_restart_timeout_s
            while True:
                addr = self._actor_addr(actor_id)
                try:
                    self._peers.get(addr).call(msg)
                    break
                except (RpcError, ActorDiedError):
                    self._remote_actors.pop(actor_id, None)
                    if time.monotonic() >= deadline:
                        raise
                    time.sleep(0.2)
        for rid in return_ids:
            rt._entry(rid)
            self.ensure_available(rid.binary(), hint=addr)
        return [ObjectRef(rid, core=rt) for rid in return_ids]

    def remote_actor_opts(self, actor_id: ActorID) -> dict:
        addr = self._actor_addr(actor_id)
        return self._peers.get(addr).call(("actor_opts", actor_id.binary()))

    def remote_kill_actor(self, actor_id: ActorID, no_restart: bool):
        addr = self._actor_addr(actor_id)
        return self._peers.get(addr).call(
            ("kill_actor", actor_id.binary(), no_restart))

    # ---------------------------------------------------------------- handler

    def _handle(self, msg, ctx) -> Any:
        op = msg[0]
        fn = getattr(self, "_op_" + op, None)
        if fn is None:
            raise ValueError(f"unknown node op {op!r}")
        return fn(*msg[1:])

    def _op_ping(self):
        return "pong"

    def _op_status(self):
        rt = self.runtime
        with rt._lock:
            return {
                "node_id": self.node_id.binary(),
                "address": self.address,
                "total": rt._total.to_dict(),
                "avail": rt._avail.to_dict(),
                "load": len(rt._task_queue),
                "num_workers": len(rt._workers),
                "store": rt.store.stats(),
                "oom_kills": getattr(rt, "_oom_kill_count", 0),
            }

    def _op_state(self):
        s = self.runtime.state_summary()
        s["push_waits"] = self._push_waits  # sender-side backpressure hits
        s["pulls"] = self.pulls.stats()     # admission-control occupancy
        with self._fetch_stats_lock:        # cross-node pull throughput
            s["fetch"] = {"bytes": self._fetch_bytes,
                          "seconds": round(self._fetch_seconds, 6),
                          "count": self._fetch_count}
        s["gcs_epoch_seq"] = self._gcs_epoch_seq  # split-brain fence watermark
        with self._peer_health_lock:        # per-peer suspicion (EWMA, streak)
            s["peer_health"] = {
                f"{a[0]}:{a[1]}": {"ewma_s": round(h[0], 6),
                                   "fail_streak": h[1]}
                for a, h in self._peer_health.items()}
        return s

    def _op_netem(self, cmd, *args):
        """Control plane for the deterministic network-fault shim: the
        cluster fixture arms/heals partitions in THIS process over an
        unaffected edge (see core/netem.py)."""
        return netem.control(cmd, *args)

    def _check_gcs_epoch(self, token):
        """Reject a GCS-originated write stamped by an incarnation older
        than the newest this node has seen (split-brain fence: a
        partitioned-but-alive old head must not restart or reap actors
        here). ``None`` = pre-epoch caller or node-local path: allowed."""
        seen = self._gcs_epoch_seq
        if token is not None and seen and int(token) < seen:
            raise StaleGcsEpochError(
                f"write from stale GCS incarnation rejected by node "
                f"{self.address[0]}:{self.address[1]}",
                stale_seq=int(token), current_seq=seen)

    def _op_stack_dump(self):
        return self.runtime.stack_dump()

    def _op_task_events(self):
        """Flag-gated task timeline events recorded by this node's
        runtime (driver aggregates across nodes for ray_tpu_torch.timeline).
        None = recording disabled on this node."""
        ev = self.runtime._events
        return None if ev is None else list(ev)

    def _op_list_logs(self):
        from ray_tpu_torch.core.log_monitor import list_log_files

        return list_log_files(self.runtime.log_dir)

    def _op_get_log(self, name: str, tail_lines: int = 1000):
        from ray_tpu_torch.core.log_monitor import read_log_file

        return read_log_file(self.runtime.log_dir, name, tail_lines)

    def _op_register_fn(self, fn_id: bytes, pickled: bytes):
        rt = self.runtime
        with rt._lock:
            rt._functions.setdefault(fn_id, pickled)
        return True

    _APPLIED_CAP = 16384
    _OWNED_CAP = 1 << 18

    def _tag_owner(self, oid_bytes_list, owner):
        with self._owner_lock:
            for b in oid_bytes_list:
                self._owner_of[b] = owner
            while len(self._owner_of) > self._OWNED_CAP:
                self._owner_of.popitem(last=False)

    def _untag_owner(self, oid_bytes_list):
        with self._owner_lock:
            for b in oid_bytes_list:
                self._owner_of.pop(b, None)

    def _dedup(self, nonce, fn):
        """Run ``fn`` exactly once per nonce (at-most-once apply).

        A duplicate delivery (lost-reply retry) returns the original's
        result; a duplicate racing an IN-PROGRESS original waits for it
        (wip latch) instead of reporting phantom success. The result is
        published only on completion — if the original raises, the entry
        is dropped so a retry legitimately re-runs. ``nonce=None`` (older
        peers / no retry in play) just runs ``fn``."""
        if nonce is None:
            return fn()
        while True:
            with self._applied_lock:
                ent = self._applied.get(nonce)
                if ent is None:
                    ev = threading.Event()
                    self._applied[nonce] = ("wip", ev)
                    break
            if ent[0] == "done":
                return ent[1]
            ent[1].wait(600)  # original still applying: wait, re-check
        try:
            result = fn()
        except BaseException:
            with self._applied_lock:
                self._applied.pop(nonce, None)
            ev.set()
            raise
        with self._applied_lock:
            self._applied[nonce] = ("done", result)
            # evict oldest DONE entries; wip entries (rare, transient) go
            # back at the tail. O(evictions), not O(cap).
            requeue = []
            while len(self._applied) - len(requeue) > self._APPLIED_CAP:
                k, v = self._applied.popitem(last=False)
                if v[0] == "wip":
                    requeue.append((k, v))
            for k, v in requeue:
                self._applied[k] = v
        ev.set()
        return result

    def _op_submit(self, fn_id, pickled_fn, args_payload, deps, nested,
                   return_ids, options, locations, nonce=None, owner=None):
        return self._dedup(nonce, lambda: self._do_submit(
            fn_id, pickled_fn, args_payload, deps, nested, return_ids,
            options, locations, owner))

    def _do_submit(self, fn_id, pickled_fn, args_payload, deps, nested,
                   return_ids, options, locations, owner=None):
        rt = self.runtime
        if owner is not None:
            self._tag_owner(return_ids, owner)
        if pickled_fn is not None:
            with rt._lock:
                rt._functions.setdefault(fn_id, pickled_fn)
        with rt._lock:
            known = fn_id in rt._functions
        if not known:
            raise KeyError(f"function {fn_id.hex()} not registered on node")
        dep_ids = [ObjectID(b) for b in deps]
        ret_ids = [ObjectID(b) for b in return_ids]
        for b, d in zip(deps, dep_ids):
            self.ensure_available(
                b, hint=tuple(locations[b]) if locations and b in locations
                else None, priority=PRIO_TASK_ARGS)
        for b in nested:
            self.ensure_available(b, priority=PRIO_TASK_ARGS)
        task_id = make_task_id(rt.job_id)
        for rid in ret_ids:
            rt._entry(rid)
        opts = dict(options or {})
        streaming = bool(opts.pop("__stream", False))
        spec = _TaskSpec(task_id, fn_id, args_payload, dep_ids, ret_ids,
                         opts)
        spec.nested_deps = [ObjectID(b) for b in nested]
        spec.request, spec.pg_wire = rt._prepare_request(
            dict(opts), is_actor=False)
        rt._cancellable[ret_ids[0].binary()] = spec
        if streaming:
            # this node owns the stream state: the consumer's stream_next
            # ops route here (ClusterCore caches seed -> this address)
            seed = ret_ids[0].binary()
            spec.stream = rt._stream_opts(seed)
            rt._register_stream(seed)
        rt._enqueue(spec)
        return True

    def _op_get(self, oid_bytes_list, timeout, allow_shm=False):
        rt = self.runtime
        deadline = None if timeout is None else time.monotonic() + timeout
        for b in oid_bytes_list:
            if b in rt._freed:
                raise ObjectLostError(
                    f"object {b.hex()} was freed by ray_tpu_torch.free() and is "
                    f"not reconstructable")
            self.ensure_available(b)
        out = {}
        for b in oid_bytes_list:
            e = rt._entry(ObjectID(b))
            remaining = (None if deadline is None
                         else max(0.0, deadline - time.monotonic()))
            if not e.event.wait(remaining):
                from ray_tpu_torch.exceptions import GetTimeoutError
                raise GetTimeoutError(f"get timed out for {b.hex()}")
            if allow_shm and e.payload[0] == "shm":
                # same-host driver reads the store zero-copy
                out[b] = e.payload
            else:
                out[b] = materialize(rt, e.payload)
        return out

    def _op_fetch(self, oid_bytes, max_bytes=None):
        """Peer pull: ("inline", payload_bytes), or ("size", n) when the
        payload exceeds ``max_bytes`` (caller switches to ranged pulls),
        or None if this node does not hold the object (no recursive
        fetch)."""
        rt = self.runtime
        oid = ObjectID(oid_bytes)
        with rt._lock:
            e = rt._objects.get(oid)
            # a freed id must not be served: the entry keeps its payload
            # as a tombstone, but the storage is reclaimed ("free means
            # dead" — peers see "not held", then the GCS tombstone)
            if (e is None or not e.event.is_set()
                    or oid_bytes in rt._freed):
                return None
            payload = e.payload
        if max_bytes is not None:
            size = self._op_fetch_size(oid_bytes)
            if size is not None and size >= max_bytes:
                return ("size", size)
        return materialize(rt, payload)

    def _op_fetch_size(self, oid_bytes):
        """Payload byte count for range-based transfer, or None."""
        rt = self.runtime
        oid = ObjectID(oid_bytes)
        with rt._lock:
            e = rt._objects.get(oid)
            if (e is None or not e.event.is_set()
                    or oid_bytes in rt._freed):
                return None
            kind, data = e.payload
        if kind == "inline":
            return len(data)
        if kind == "spilled":
            path = data[0] if isinstance(data, tuple) else data
            return external_storage.size(path)
        view = rt.store.get(oid, timeout_ms=0)
        try:
            return view.nbytes
        finally:
            del view
            rt.store.release(oid)

    def _op_fetch_range(self, oid_bytes, offset: int, length: int):
        """One chunk of a payload (the DCN bulk path: a puller runs many
        of these concurrently on separate connections). Serves shm-backed
        objects without materializing the whole payload, under the
        sender-side in-flight byte cap (push_max_inflight_bytes)."""
        cap = config.push_max_inflight_bytes
        if cap > 0:
            with self._push_cv:
                if self._push_inflight + length > cap \
                        and self._push_inflight > 0:
                    self._push_waits += 1
                while (self._push_inflight + length > cap
                       and self._push_inflight > 0):
                    self._push_cv.wait(timeout=1.0)
                self._push_inflight += length
            try:
                return self._fetch_range_inner(oid_bytes, offset, length)
            finally:
                with self._push_cv:
                    self._push_inflight -= length
                    self._push_cv.notify_all()
        return self._fetch_range_inner(oid_bytes, offset, length)

    def _fetch_range_inner(self, oid_bytes, offset: int, length: int):
        rt = self.runtime
        oid = ObjectID(oid_bytes)
        with rt._lock:
            e = rt._objects.get(oid)
            if (e is None or not e.event.is_set()
                    or oid_bytes in rt._freed):
                return None
            kind, data = e.payload
        if kind == "inline":
            return bytes(data[offset:offset + length])
        if kind == "spilled":
            path = data[0] if isinstance(data, tuple) else data
            try:
                return external_storage.read_range(path, offset, length)
            except Exception:  # noqa: BLE001
                return None
        view = rt.store.get(oid, timeout_ms=0)
        try:
            return bytes(view[offset:offset + length])
        finally:
            del view
            rt.store.release(oid)

    def _owner_watch_loop(self):
        """Poll the GCS for driver deaths; reclaim a dead driver's
        objects and kill its non-detached actors on THIS node. Every node
        runs the same loop over its own ownership maps, so cleanup needs
        no fan-out coordinator (reference: owner-failure cleanup paths of
        reference_count.h:61 / gcs_job_manager.h)."""
        while not self._stop:
            time.sleep(config.gcs_heartbeat_interval_s * 2)
            try:
                deaths = self.gcs.call(
                    ("driver_deaths_since", self._driver_death_seq))
            # rtpu-lint: disable=L4 — crash-proof daemon loop: call()
            # re-raises arbitrary picklable remote exceptions, and a
            # failed poll (GCS down/restarting) just retries next tick
            except Exception:  # noqa: BLE001
                continue
            for seq, driver_id in deaths:
                self._driver_death_seq = max(self._driver_death_seq, seq)
                try:
                    self._reclaim_owner(driver_id)
                # rtpu-lint: disable=L4 — cleanup is best-effort: a
                # partly-reclaimed owner must not wedge the watch loop;
                # unfreed ids are re-reported on the next death record
                except Exception:  # noqa: BLE001
                    pass

    def _reclaim_owner(self, driver_id: bytes):
        with self._owner_lock:
            dead_oids = [b for b, o in self._owner_of.items()
                         if o == driver_id]
            dead_actors = [b for b, o in self._actor_owner.items()
                           if o == driver_id]
            for b in dead_oids:
                self._owner_of.pop(b, None)
            for b in dead_actors:
                self._actor_owner.pop(b, None)
        if dead_oids:
            self._op_free(dead_oids)
        for aid_b in dead_actors:
            try:
                self.runtime.kill_actor(ActorID(aid_b), no_restart=True)
            # rtpu-lint: disable=L4 — the actor may already be dead or
            # mid-restart; reclaim must still process the remaining ones
            except Exception:  # noqa: BLE001
                pass

    def _op_owner_cleanup(self, driver_id: bytes):
        """Test/ops hook: reclaim one owner's footprint immediately."""
        self._reclaim_owner(driver_id)
        return True

    def _op_free(self, oid_bytes_list):
        """Eager deletion (driver free fan-out). Returns the ids actually
        freed here (the driver unions across nodes — a replicated object
        must count once). The freed-error marker is local — never
        republish these ids as locations."""
        for b in oid_bytes_list:
            self._unpublished.add(b)
        try:
            freed = self.runtime.free_objects(oid_bytes_list,
                                              return_ids=True)
        finally:
            for b in oid_bytes_list:
                self._unpublished.discard(b)
        self._untag_owner(oid_bytes_list)
        for b in oid_bytes_list:
            self.gcs.try_call(("loc_drop", b, self.address))
        return freed

    def free_cluster_wide(self, oid_bytes_list) -> set:
        """Worker-originated free: the copy may live on ANY node (a
        worker on node A freeing an object produced on node B), so free
        locally, then fan out to EVERY alive peer — the location
        directory only covers transferred copies, not a producer's
        original, so loc_get alone would miss the primary copy (the
        driver-side free fans out the same way). Returns the union of
        ids freed anywhere."""
        freed = set(self._op_free(oid_bytes_list) or [])
        for info in self._alive_peers():
            addr = tuple(info["address"])
            try:
                # rtpu-lint: disable=L9 — per-peer fan-out, not a
                # re-send; free of an unknown/tombstoned id is a no-op
                # and the freed_add tombstones published below are the
                # authority a missed peer converges on
                freed.update(self._peers.get(addr).call(
                    ("free", list(oid_bytes_list))) or [])
            except RpcError:
                continue
        if freed:
            # publish tombstones (bounded GCS table): fetch loops and the
            # driver's lineage reconstruction consult them, so a
            # worker-freed object dies fast everywhere instead of being
            # spun on or resurrected ("free means dead")
            self.gcs.try_call(("freed_add", list(freed)))
            # close the prefetch race: a transfer of one of these ids that
            # started before the free can land locally AFTER the local
            # _op_free above ran (this very node prefetches nested task
            # deps). Re-free anything that landed meanwhile, THEN
            # tombstone locally so later arrivals are never stored or
            # served (free_objects skips already-tombstoned ids, so the
            # order matters).
            self._op_free(list(freed))
            from ray_tpu_torch.core.runtime import note_freed

            rt = self.runtime
            with rt._lock:
                note_freed(rt._freed, freed)
        return freed

    def _op_has(self, oid_bytes):
        rt = self.runtime
        with rt._lock:
            e = rt._objects.get(ObjectID(oid_bytes))
            return e is not None and e.event.is_set()

    def _op_wait(self, oid_bytes_list, num_returns, timeout):
        rt = self.runtime
        for b in oid_bytes_list:
            self.ensure_available(b, priority=PRIO_WAIT)
        refs = [ObjectRef(ObjectID(b), core=rt) for b in oid_bytes_list]
        ready, rest = rt.wait(refs, num_returns=num_returns, timeout=timeout)
        return [r.binary() for r in ready], [r.binary() for r in rest]

    def _op_put(self, data: bytes, oid_bytes=None, owner=None):
        rt = self.runtime
        oid = ObjectID(oid_bytes) if oid_bytes else ObjectID.from_random()
        store_incoming(rt, oid, data)
        if owner is not None:
            self._tag_owner([oid.binary()], owner)
        return oid.binary()

    def _op_release(self, oid_bytes_list):
        rt = self.runtime
        for b in oid_bytes_list:
            oid = ObjectID(b)
            with rt._lock:
                e = rt._objects.pop(oid, None)
            if (e is not None and e.payload is not None
                    and e.payload[0] == "spilled"):
                try:
                    os.unlink(e.payload[1][0])
                except OSError:
                    pass
            # drop the owner tracking pin so delete can actually reclaim
            with rt._spill_lock:
                had_pin = rt._pinned.pop(b, None) is not None
            try:
                if had_pin:
                    rt.store.release(oid)
                rt.store.delete(oid)
            # rtpu-lint: disable=L4 — the object may have been evicted or
            # the store closed under us; release is best-effort and the
            # location drop below must still be published
            except Exception:  # noqa: BLE001
                pass
            self.gcs.try_call(("loc_drop", b, self.address))
        return True

    def _op_cancel(self, oid_bytes, force):
        rt = self.runtime
        return rt.cancel_task(ObjectRef(ObjectID(oid_bytes), core=rt),
                              force=force)

    # -- streaming returns (stream state lives on the owning node; the
    #    driver and peer nodes poll it with bounded slices)

    def _op_stream_next(self, seed, index, timeout_ms):
        """One bounded wait slice against a local stream. Returns
        ("ref", rid_b) | ("end", count) | ("pending",)."""
        rt = self.runtime
        st = rt._streams.get(seed)
        if st is None:
            raise ValueError(f"unknown stream {seed.hex()}")
        deadline = time.monotonic() + timeout_ms / 1000.0
        with st.cond:
            while True:
                hit = rt._stream_poll_locked(st, index)
                if hit is not None:
                    return hit
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return ("pending",)
                st.cond.wait(remaining)

    def _op_stream_consumed(self, seed, index):
        self.runtime.stream_consumed(seed, index)
        return True

    # -- actors

    def _op_create_actor(self, cls_fn_id, pickled_cls, args_payload, deps,
                         opts, locations, actor_id_b=None, nonce=None,
                         owner=None, gcs_epoch_seq=None):
        # GCS-driven restarts stamp their epoch_seq; a fenced (stale)
        # head's restart must not run — it would fork actor state
        self._check_gcs_epoch(gcs_epoch_seq)
        return self._dedup(nonce, lambda: self._do_create_actor(
            cls_fn_id, pickled_cls, args_payload, deps, opts, locations,
            actor_id_b, owner))

    def _do_create_actor(self, cls_fn_id, pickled_cls, args_payload, deps,
                         opts, locations, actor_id_b=None, owner=None):
        rt = self.runtime
        if (owner is not None and actor_id_b is not None
                and (opts or {}).get("lifetime") != "detached"):
            with self._owner_lock:
                self._actor_owner[actor_id_b] = owner
        if pickled_cls is not None:
            with rt._lock:
                rt._functions.setdefault(cls_fn_id, pickled_cls)
        for b in deps:
            self.ensure_available(
                b, hint=tuple(locations[b]) if locations and b in locations
                else None, priority=PRIO_TASK_ARGS)
        actor_id = rt._create_actor_from_payload(
            cls_fn_id, args_payload, [ObjectID(b) for b in deps],
            dict(opts or {}),
            actor_id=ActorID(actor_id_b) if actor_id_b else None)
        return actor_id.binary()

    def _op_actor_call(self, actor_id_bytes, method, args_payload, deps,
                       nested, return_ids, nonce=None, owner=None,
                       stream=False, opts=None):
        return self._dedup(nonce, lambda: self._do_actor_call(
            actor_id_bytes, method, args_payload, deps, nested, return_ids,
            owner, stream, opts))

    def _do_actor_call(self, actor_id_bytes, method, args_payload, deps,
                       nested, return_ids, owner=None, stream=False,
                       opts=None):
        rt = self.runtime
        if owner is not None:
            self._tag_owner(return_ids, owner)
        actor_id = ActorID(actor_id_bytes)
        state = rt._actors.get(actor_id)
        if state is None:
            raise ActorDiedError(f"actor {actor_id} is not on this node")
        # bounded restart window: past the buffer cap / restart deadline
        # this raises ActorUnavailableError, which travels back through
        # the RPC layer typed (callers must see "may come back", never a
        # hang and never a premature death)
        rt._check_actor_admission(state)
        for b in deps:
            self.ensure_available(b, priority=PRIO_TASK_ARGS)
        for b in nested:
            self.ensure_available(b, priority=PRIO_TASK_ARGS)
        ret_ids = [ObjectID(b) for b in return_ids]
        for rid in ret_ids:
            rt._entry(rid)
        task_id = make_task_id(rt.job_id)
        if stream:
            # register before the dead check so ActorDiedError routes
            # through _fail_stream rather than landing on the seed id
            rt._register_stream(ret_ids[0].binary())
        if state.dead:
            if state.migrated:
                # planned-drain eviction: the actor lives on elsewhere —
                # reject at submit so the caller re-routes through the
                # actor_state channel instead of consuming a dead result
                raise ActorDiedError(
                    f"actor {actor_id} migrated off this node")
            rt._store_error(ret_ids, rt._actor_dead_error(state))
            return True
        spec = _TaskSpec(task_id, None, args_payload,
                         [ObjectID(b) for b in deps], ret_ids,
                         dict(opts or {}), actor_id=actor_id, method=method)
        spec.nested_deps = [ObjectID(b) for b in nested]
        if stream:
            spec.stream = rt._stream_opts(ret_ids[0].binary())
        rt._cancellable[ret_ids[0].binary()] = spec
        rt._enqueue(spec)
        return True

    def _op_actor_opts(self, actor_id_bytes):
        return self.runtime.get_actor_method_opts(ActorID(actor_id_bytes))

    def _op_prestart_workers(self, num: int):
        """Backlog hint: pre-fork idle workers ahead of a burst
        (reference: PrestartWorkers RPC, raylet/worker_pool.h:344)."""
        self.runtime.prestart_workers(int(num))
        return True

    def _op_kill_actor(self, actor_id_bytes, no_restart,
                       gcs_epoch_seq=None):
        # a stale head reaping an actor it believes dead would kill a
        # healthy incarnation the NEW head is tracking
        self._check_gcs_epoch(gcs_epoch_seq)
        self.runtime.kill_actor(ActorID(actor_id_bytes), no_restart=no_restart)
        return True

    def _op_evict_actor(self, actor_id_bytes, gcs_epoch_seq=None,
                        wait_s=0.5):
        # drain migration: same fencing as kill_actor, but the reap
        # waits for in-flight calls to settle and fails nothing
        self._check_gcs_epoch(gcs_epoch_seq)
        return self.runtime.evict_actor(ActorID(actor_id_bytes),
                                        wait_s=wait_s)

    # -- placement groups (node-local; the driver composes cluster PGs)

    def _op_pg(self, op, *args):
        rt = self.runtime
        if op == "create":
            bundles, strategy, name = args
            pg = rt.create_placement_group(bundles, strategy, name)
            return pg.id.binary()
        if op == "table":
            # no pg-id operand — must dispatch before the id parse below
            # (the autoscaler polls this for pending-PG demand)
            return rt.placement_group_table()
        pg_id = PlacementGroupID(args[0])
        if op == "wait":
            return rt.wait_placement_group(pg_id, args[1])
        if op == "remove":
            rt.remove_placement_group(pg_id)
            return True
        if op == "gpus":
            return rt.placement_group_gpus(pg_id, args[1])
        if op == "table":
            return rt.placement_group_table()
        raise ValueError(f"unknown pg op {op!r}")

    # -- lifecycle

    def _op_shutdown_node(self):
        def drain_and_exit():
            self.close()
            if self._owns_process:
                # a drained node must actually release its process (the
                # autoscaler's cloud view polls liveness): lingering
                # non-daemon helper threads would otherwise pin it
                os._exit(0)

        threading.Thread(target=drain_and_exit, daemon=True).start()
        return True

    def close(self):
        if self._stop:
            return
        self._stop = True
        self.gcs.try_call(("unregister_node", self.node_id.binary()))
        self._server.close()
        try:
            self.runtime.shutdown()
        # rtpu-lint: disable=L4 — node teardown: whatever state the
        # runtime is in, the peers and GCS client still get closed
        except Exception:  # noqa: BLE001
            pass
        self._peers.close_all()
        self.gcs.close()


def _parse_addr(s: str) -> Tuple[str, int]:
    host, port = s.rsplit(":", 1)
    return host, int(port)


def main(argv=None):
    import argparse
    import signal
    import sys

    p = argparse.ArgumentParser(description="ray_tpu_torch node server")
    p.add_argument("--gcs", required=True, help="GCS address host:port")
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--num-workers", type=int, default=None)
    p.add_argument("--object-store-memory", type=int, default=None)
    p.add_argument("--resources", type=str, default=None,
                   help='JSON dict of extra resources, e.g. {"disk": 2}')
    p.add_argument("--head", action="store_true",
                   help="run head-node services (the job agent)")
    args = p.parse_args(argv)
    resources = None
    if args.resources:
        import json

        resources = json.loads(args.resources)
    node = NodeServer(_parse_addr(args.gcs), num_workers=args.num_workers,
                      object_store_memory=args.object_store_memory,
                      resources=resources, port=args.port)
    node._owns_process = True
    agent = None
    if args.head:
        from ray_tpu_torch.job.agent import JobAgent

        agent = JobAgent(node.gcs, _parse_addr(args.gcs),
                         agent_id=node.node_id.hex())
    print(f"NODE_ADDRESS {node.address[0]}:{node.address[1]}", flush=True)
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *a: stop.set())
    signal.signal(signal.SIGINT, lambda *a: stop.set())

    def _dump_stacks(*_a):
        # ops hatch (mirrors the workers' SIGUSR1 dumps): all-thread
        # stacks of the NODE SERVER itself, to a file — stderr may be
        # detached under a supervisor
        import traceback

        import tempfile

        path = os.path.join(tempfile.gettempdir(),
                            f"rtpt_node_stacks_{os.getpid()}.txt")
        with open(path, "w") as f:
            for tid, fr in sys._current_frames().items():
                f.write(f"--- thread {tid} ---\n")
                f.write("".join(traceback.format_stack(fr)))

    signal.signal(signal.SIGUSR2, _dump_stacks)
    stop.wait()
    if agent is not None:
        agent.close()
    node.close()
    sys.exit(0)


if __name__ == "__main__":
    main()
