"""Head-node availability: GCS failover with cluster-wide ride-through.

The GCS already persists every state-mutating op to a snapshot+WAL
(gcs.py), so a restarted head rehydrates nodes/actors/locations/KV/
pubsub seqs by itself. This module supplies the *client* half of
failover — what drivers and node servers do while the head is down and
right after it comes back:

- ``HaGcsClient`` wraps the transport ``RpcClient`` with a bounded
  ride-through buffer: calls that fail because the head is unreachable
  park and retry (with backoff+jitter) until ``gcs_reconnect_timeout_s``
  elapses or ``gcs_op_buffer_max`` calls are already parked, then fail
  with the typed ``GcsUnavailableError`` — the cluster-level mirror of
  ``ActorUnavailableError``'s bounded-buffering semantics. Only ops
  ``WIRE_CONTRACT`` (protocol_meta.py — the single source of truth for
  wire retry classes) marks retry-safe are ever replayed once their
  request may have been applied (lost reply), so at-least-once delivery
  stays indistinguishable from exactly-once.
- Epoch tracking: every GCS process mints a fresh ``epoch``
  (never persisted) and stamps it on heartbeat replies and
  ``gcs_info``. A changed epoch means the head restarted — even a fast
  restart between two heartbeats that never failed a call — and
  triggers ``resync_node`` / the driver's reconnect hook.
- ``resync_node`` re-pushes one node's slice of cluster state into a
  (possibly empty) restarted GCS: re-register under the SAME node_id,
  re-publish every sealed object location with sizes, re-register live
  actor incarnations (re-claiming names), re-publish placement-group
  state, and clamp the driver-death cursor so an empty head's reset
  seqs don't strand the watermark.

Reference: the GcsServer + Redis-backed fault tolerance split
(src/ray/gcs/gcs_server/gcs_server.h:78, gcs_rpc_client.h retryable
method table); here the WAL replaces Redis and this module replaces the
raylet/core-worker reconnect machinery.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Any, Callable, Optional, Tuple

from ray_tpu_torch.core import netem
from ray_tpu_torch.core.cluster.rpc import RpcClient, RpcError
from ray_tpu_torch.core.config import config
from ray_tpu_torch.exceptions import GcsUnavailableError
from ray_tpu_torch.util.debug_lock import check_fire_outside, make_lock

# Per-attempt connect budget inside the ride-through loop: short, so the
# loop (not the transport) owns pacing against gcs_reconnect_timeout_s.
_ATTEMPT_TIMEOUT_S = 2.0


class HaGcsClient:
    """GCS client with head-outage ride-through.

    Drop-in for ``RpcClient`` where the peer is the GCS (same ``call`` /
    ``try_call`` / ``close`` / ``address`` surface). ``call`` buffers
    across an outage within the configured bounds; ``try_call`` stays
    strictly best-effort (heartbeats and batched location flushes must
    not park threads for the whole reconnect window). ``on_reconnect``
    — when given — fires once per detected GCS restart (epoch change)
    with the fresh ``gcs_info`` dict, from the thread that noticed.
    """

    def __init__(self, address: Tuple[str, int], authkey: bytes,
                 on_reconnect: Optional[Callable[[dict], None]] = None):
        self.address = tuple(address)
        netem.tag_peer(self.address, "gcs")  # role-selector rules match it
        self._rpc = RpcClient(self.address, authkey,
                              connect_timeout=_ATTEMPT_TIMEOUT_S,
                              unavailable_exc=GcsUnavailableError)
        self._on_reconnect = on_reconnect
        self._lock = make_lock("HaGcsClient._lock")
        self._buffered = 0          # calls currently parked in ride-through
        self._epoch: Optional[str] = None   # last GCS incarnation seen
        self._saw_outage = False    # a call failed since the last epoch check
        self._closed = False

    # ------------------------------------------------------------- calls

    def call(self, msg: Any) -> Any:
        r0 = self._rpc.reconnects
        try:
            result = self._rpc.call(msg)
        except RpcError as e:
            return self._ride_through(msg, e)
        if self._epoch_suspect(r0):
            self._check_epoch()
        return result

    def try_call(self, msg: Any, default=None):
        """Best-effort call: no ride-through buffering, still epoch-aware
        (a success right after an outage triggers the reconnect hook)."""
        r0 = self._rpc.reconnects
        try:
            result = self._rpc.call(msg)
        except RpcError:
            with self._lock:
                self._saw_outage = True
            return default
        if self._epoch_suspect(r0):
            self._check_epoch()
        return result

    def _epoch_suspect(self, r0: int) -> bool:
        """True when the GCS incarnation needs re-verifying: never seen
        an epoch, a call failed since the last check, or the transport
        silently re-dialed mid-call (fast head restart that never
        surfaced an error — the peer may be a different incarnation)."""
        with self._lock:
            return self._epoch is None or self._saw_outage \
                or self._rpc.reconnects != r0

    def _ride_through(self, msg: Any, first_err: RpcError) -> Any:
        op = msg[0] if isinstance(msg, tuple) and msg else msg
        if getattr(first_err, "maybe_applied", False):
            # the request reached the head and the op is NOT on the
            # retry-after-apply whitelist: blind replay could run the
            # side effect twice — surface instead of buffering
            raise GcsUnavailableError(
                f"GCS call {op!r} may already have been applied (reply "
                f"lost) and is not replay-safe") from first_err
        with self._lock:
            if self._closed:
                raise first_err
            if self._buffered >= config.gcs_op_buffer_max:
                raise GcsUnavailableError(
                    f"GCS at {self.address} is unreachable and "
                    f"{self._buffered} calls are already parked "
                    f"(gcs_op_buffer_max={config.gcs_op_buffer_max})"
                ) from first_err
            self._buffered += 1
            self._saw_outage = True
        try:
            deadline = time.monotonic() + config.gcs_reconnect_timeout_s
            delay = 0.05
            while True:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise GcsUnavailableError(
                        f"GCS at {self.address} unreachable past the "
                        f"ride-through window (gcs_reconnect_timeout_s="
                        f"{config.gcs_reconnect_timeout_s:g}); last "
                        f"error: {first_err}") from first_err
                # backoff with full jitter: a restarted head sees every
                # buffered call in the cluster wake at once
                time.sleep(min(delay * (0.5 + random.random()), remaining))
                delay = min(delay * 2, 1.0)
                with self._lock:
                    if self._closed:
                        raise first_err
                try:
                    result = self._rpc.call(msg)
                except RpcError as e:
                    if getattr(e, "maybe_applied", False):
                        raise GcsUnavailableError(
                            f"GCS call {op!r} may already have been "
                            f"applied (reply lost) and is not replay-"
                            f"safe") from e
                    first_err = e
                    continue
                self._check_epoch()
                return result
        finally:
            with self._lock:
                self._buffered -= 1

    # ------------------------------------------------------------- epoch

    def _check_epoch(self):
        """Refresh the known GCS incarnation; fire ``on_reconnect`` when
        it changed (i.e. the head restarted since we last looked)."""
        try:
            info = self._rpc.call(("gcs_info",))
        except RpcError:
            return
        if not isinstance(info, dict) or "epoch" not in info:
            return
        with self._lock:
            prev, self._epoch = self._epoch, info["epoch"]
            self._saw_outage = False
        if prev is not None and prev != info["epoch"] \
                and self._on_reconnect is not None:
            # resync code re-enters the GCS client; firing it under
            # _lock would deadlock the ride-through bookkeeping
            check_fire_outside("HaGcsClient._check_epoch.on_reconnect")
            try:
                self._on_reconnect(info)
            # rtpu-lint: disable=L4 — the reconnect hook is arbitrary
            # resync code; a bug there must not poison the call that
            # merely detected the restart (the result is still good)
            except Exception:  # noqa: BLE001
                pass

    @property
    def epoch(self) -> Optional[str]:
        with self._lock:
            return self._epoch

    @property
    def buffered(self) -> int:
        """Calls currently parked in the ride-through buffer."""
        with self._lock:
            return self._buffered

    def close(self):
        # parked ride-through loops notice _closed at their next wakeup
        # and fail with the original transport error
        with self._lock:
            self._closed = True
        self._rpc.close()


# ---------------------------------------------------------------- resync


def resync_node(server) -> bool:
    """Push one node's slice of cluster state back into the GCS.

    Runs after a detected head restart (epoch change or rejected
    heartbeat): the restarted GCS may have rehydrated from snapshot+WAL
    (then everything here is an idempotent no-op — all ops are on the
    retry-after-apply whitelist) or come back EMPTY (then this rebuilds
    its node/directory/actor/PG rows). Re-registering under the same
    node_id replaces the GCS row wholesale, so resources are never
    double-counted. Returns False when the head went away again
    mid-resync; the caller retries on the next epoch mismatch.
    """
    from ray_tpu_torch.core.cluster.node_server import payload_nbytes

    rt = server.runtime
    try:
        server.gcs.call(server.register_msg())

        # replay the freed channel BEFORE re-publishing locations: frees
        # broadcast while this node was partitioned must land first, or
        # the batch below re-advertises a stale copy of a freed object
        # (and a getter could read it back). An EMPTY restart reset the
        # channel seq, so clamp the cursor to the head's watermark first.
        info = server.gcs.call(("gcs_info",))
        if isinstance(info, dict):
            server._clamp_freed_cursor(
                info.get("channel_seq", {}).get("freed", 0))
        server._drain_freed()

        # sealed object locations, with sizes for the locality scorer;
        # collect under the runtime lock, measure + publish outside it
        with rt._lock:
            sealed = [(oid, e.payload) for oid, e in rt._objects.items()
                      if e.event.is_set() and e.payload is not None
                      and oid.binary() not in rt._freed]
        batch = []
        for oid, payload in sealed:
            b = oid.binary()
            if b in server._unpublished:
                continue
            batch.append((b, payload_nbytes(rt, payload)))
        for i in range(0, len(batch), 1000):
            chunk = batch[i:i + 1000]
            server.gcs.call(("loc_add_batch", [b for b, _ in chunk],
                             server.address, [n for _, n in chunk]))

        # live actor incarnations; re-claim names we rightfully hold
        with rt._lock:
            actors = [(aid, st.name, st.incarnation)
                      for aid, st in rt._actors.items() if not st.dead]
        for aid, name, incarnation in actors:
            server.gcs.call(("register_actor", aid.binary(),
                             {"node": server.address, "state": "ALIVE",
                              "incarnation": incarnation, "name": name}))
            if name:
                try:
                    server.gcs.call(("name_actor", name, aid.binary(),
                                     server.address))
                except ValueError:
                    # another holder re-claimed it first: the directory
                    # (not this node) arbitrates duplicate names
                    pass

        # placement-group state, published into cluster KV so a fresh
        # head (and debugging humans) can see which bundles live here
        table = rt.placement_group_table()
        if table:
            server.gcs.call(("kv", "put",
                             "node_pgs:" + server.node_id.binary().hex(),
                             table))

        # clamp the driver-death watermark: an EMPTY restart reset the
        # seq to 0, and a cursor left high would skip every future death
        # (reuses the gcs_info snapshot fetched before the replay above)
        if isinstance(info, dict):
            server._driver_death_seq = min(
                server._driver_death_seq, info.get("driver_death_seq", 0))
    except RpcError:
        return False
    return True
