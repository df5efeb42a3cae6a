"""WIRE_CONTRACT — the single source of truth for wire-level retry,
idempotency, and durability-resync classification.

Every op a client can put on a wire — the GCS ``_op_*`` dispatch arms,
the node server ``_op_*`` dispatch arms, and the driver<->worker
``MSG_*``/``REQ_*`` tags from ``core/protocol.py`` — has exactly one
entry here, keyed by its wire string (``msg[0]``). The transport retry
weave (rpc.py), the HA ride-through buffer (ha.py), and the L9/L10 lint
rules of the reference framework's tree derive from this table; nothing
else may hardcode a retry whitelist.

The four classifications:

- ``IDEMPOTENT`` — a pure read or poll. Applying it any number of times
  returns the same answer and changes nothing; re-send freely.
- ``RETRY_AFTER_APPLY`` — a set-style / last-writer-wins write where
  apply-twice == apply-once (register_node replaces the row wholesale,
  loc_add inserts into a set, cancel of a finished task is a no-op).
  Safe to re-send even when the first request may already have been
  applied (reply lost).
- ``dedup_keyed("<key>")`` — exactly-once via a server-side dedup
  structure keyed on a caller-minted id (the ``nonce`` argument,
  absorbed by ``NodeServer._dedup``/``_applied``). Re-delivery returns
  the original result instead of re-running the side effect, so the
  transport may retry it like an idempotent op — but ONLY against a
  server that holds the dedup table (same-address retry).
- ``NON_RETRYABLE`` — everything else: a blind re-send after a lost
  reply risks running the side effect twice (double pubsub event,
  double refcount decrement, double merge). A lost reply surfaces as
  ``RpcError`` with ``maybe_applied=True`` and the caller decides.

Classifying a new op: start from the server-side apply body. If it only
reads, ``IDEMPOTENT``. If re-applying the same arguments cannot change
the outcome (pure overwrite / set-insert / idempotent state machine),
``RETRY_AFTER_APPLY``. If the handler runs arbitrary side effects but
takes a nonce through ``_dedup``, ``dedup_keyed("nonce")``. Anything
else — including "probably fine" — is ``NON_RETRYABLE`` until a netem
dup/lost_reply sweep (tests/test_netem.py) proves otherwise. L9 fails
the build on an unclassified op.

NOTE on conservatism: the retry-safe subset of this table is pinned
byte-for-byte to the whitelist the transport has always used
(tests/test_netem.py::test_wire_contract_whitelist_parity), so hoisting
the table out of rpc.py changed no runtime behavior. Several ops below
are marked ``NON_RETRYABLE`` although a case can be made for retrying
them (``node_drained`` and ``stream_consumed`` are idempotent state
transitions; ``free`` tombstones make double-frees no-ops); promoting
one is a semantic change that must ride its own netem sweep, not this
table's refactor.

Driver<->worker ``MSG_*``/``REQ_*`` tags travel over pipes with NO
retry machinery — a broken pipe is a worker death, never a re-send — so
the pipe-only tags are all ``NON_RETRYABLE`` by policy regardless of
semantic idempotence (the classification is inert there; it exists so
L9 can prove table totality). Tags that SHARE a wire string with an RPC
op (``get``, ``submit``, ``actor_call``, ``create_actor``, ``wait``,
``kv``, ``cancel``, ``pg``, ``stream_next``) carry the RPC
classification: the transport weave keys on ``msg[0]`` alone, so one
wire string can only ever have one contract.
"""

from __future__ import annotations

from typing import Dict

IDEMPOTENT = "idempotent"
RETRY_AFTER_APPLY = "retry_after_apply"
NON_RETRYABLE = "non_retryable"
#: kv's contract depends on the sub-op (msg[1]) — see KV_SUBOP_CONTRACT
PER_SUBOP = "per_subop"


def dedup_keyed(key: str) -> str:
    """Exactly-once through a server-side dedup table keyed on the
    caller-minted ``key`` argument (NodeServer._dedup / _applied)."""
    return "dedup_keyed:" + key


def is_dedup_keyed(classification: str) -> bool:
    return classification.startswith("dedup_keyed:")


def dedup_key(classification: str) -> str:
    """The caller-minted id field a dedup_keyed op is keyed on."""
    return classification.split(":", 1)[1]


def retry_safe(classification: str) -> bool:
    """True when re-sending is safe even if the server already applied
    the request once (at-least-once indistinguishable from
    exactly-once)."""
    return (classification in (IDEMPOTENT, RETRY_AFTER_APPLY)
            or is_dedup_keyed(classification))


WIRE_CONTRACT: Dict[str, str] = {
    # ------------------------------------------------ reads / polls
    "ping": IDEMPOTENT,
    "status": IDEMPOTENT,
    "state": IDEMPOTENT,
    "stack_dump": IDEMPOTENT,
    "task_events": IDEMPOTENT,
    "list_logs": IDEMPOTENT,
    "get_log": IDEMPOTENT,
    "list_nodes": IDEMPOTENT,
    "wait_nodes": IDEMPOTENT,      # blocking read; waits, writes nothing
    "deaths_since": IDEMPOTENT,
    "driver_deaths_since": IDEMPOTENT,
    "freed_check": IDEMPOTENT,
    "get_named_actor": IDEMPOTENT,
    "list_actors": IDEMPOTENT,
    "loc_get": IDEMPOTENT,
    "loc_get_batch": IDEMPOTENT,
    "poll": IDEMPOTENT,            # long-poll read; cursor is client-side
    "get_fn": IDEMPOTENT,
    "gcs_info": IDEMPOTENT,
    "get": IDEMPOTENT,             # node op + REQ_GET (same wire string)
    "fetch": IDEMPOTENT,
    "fetch_size": IDEMPOTENT,
    "fetch_range": IDEMPOTENT,
    "has": IDEMPOTENT,
    "wait": IDEMPOTENT,            # node op + REQ_WAIT
    "actor_opts": IDEMPOTENT,
    # ---------------- set / last-writer-wins writes (apply-twice ==
    # apply-once: wholesale row replace, set-insert, or no-op re-apply)
    "register_node": RETRY_AFTER_APPLY,   # replaces the row wholesale
    "heartbeat": RETRY_AFTER_APPLY,       # refreshes a timestamp
    "unregister_node": RETRY_AFTER_APPLY,  # second apply sees no row
    "freed_add": RETRY_AFTER_APPLY,       # tombstone set-insert
    "name_actor": RETRY_AFTER_APPLY,      # same (name, id) re-claim ok
    "drop_actor_name": RETRY_AFTER_APPLY,
    "register_actor": RETRY_AFTER_APPLY,
    "register_actor_spec": RETRY_AFTER_APPLY,
    "drop_actor_spec": RETRY_AFTER_APPLY,
    "loc_add": RETRY_AFTER_APPLY,         # set-insert into the directory
    "loc_add_batch": RETRY_AFTER_APPLY,
    "loc_drop": RETRY_AFTER_APPLY,
    "register_fn": RETRY_AFTER_APPLY,     # setdefault: first write wins
    "cancel": RETRY_AFTER_APPLY,          # cancel of finished is a no-op
    "kill_actor": RETRY_AFTER_APPLY,      # kill of dead is a no-op
    "prestart_workers": RETRY_AFTER_APPLY,  # hint; pool is capped
    "register_driver": RETRY_AFTER_APPLY,
    "driver_heartbeat": RETRY_AFTER_APPLY,
    "unregister_driver": RETRY_AFTER_APPLY,
    "owner_cleanup": RETRY_AFTER_APPLY,   # reclaim of reclaimed: no-op
    # ------------- exactly-once via server-side nonce dedup (_dedup)
    "submit": dedup_keyed("nonce"),
    "actor_call": dedup_keyed("nonce"),   # + MSG_/REQ_ACTOR_CALL
    "create_actor": dedup_keyed("nonce"),  # + MSG_CREATE_ACTOR
    # ------------------------------------------- per-sub-op (msg[1])
    "kv": PER_SUBOP,                      # + REQ_KV — see below
    # --------------------------------- non-retryable GCS / node ops
    "publish": NON_RETRYABLE,        # re-send = duplicate pubsub event
    "drain_node": NON_RETRYABLE,     # idempotent-in-effect; unswept
    "node_drained": NON_RETRYABLE,   # idempotent-in-effect; unswept
    "free": NON_RETRYABLE,           # double refcount decrement hazard
    "put": NON_RETRYABLE,            # second apply stores a second copy
    "release": NON_RETRYABLE,        # double refcount decrement hazard
    "stream_next": NON_RETRYABLE,    # + REQ_STREAM_NEXT (pipe tag)
    "stream_consumed": NON_RETRYABLE,  # monotonic watermark; unswept
    "evict_actor": NON_RETRYABLE,    # epoch-fenced reap; unswept
    "pg": NON_RETRYABLE,             # + REQ_PG — create/remove mutate
    "netem": NON_RETRYABLE,          # test chaos control plumbing
    "shutdown_node": NON_RETRYABLE,
    "shutdown_gcs": NON_RETRYABLE,
    # ------------- driver<->worker pipe tags (no retry machinery on
    # the pipe: a transport failure is a worker/driver death, never a
    # re-send — NON_RETRYABLE by policy, see the module docstring)
    "reg_fn": NON_RETRYABLE,               # MSG_REGISTER_FN
    "task_batch": NON_RETRYABLE,           # MSG_TASK_BATCH
    "shutdown": NON_RETRYABLE,             # MSG_SHUTDOWN
    "ready": NON_RETRYABLE,                # MSG_READY
    "done": NON_RETRYABLE,                 # MSG_DONE
    "error": NON_RETRYABLE,                # MSG_ERROR
    "actor_ready": NON_RETRYABLE,          # MSG_ACTOR_READY
    "actor_error": NON_RETRYABLE,          # MSG_ACTOR_ERROR
    "stream_yield": NON_RETRYABLE,         # MSG_STREAM_YIELD
    "put_meta": NON_RETRYABLE,             # REQ_PUT_META
    "create_actor_req": NON_RETRYABLE,     # REQ_CREATE_ACTOR
    "get_actor": NON_RETRYABLE,            # REQ_GET_ACTOR (read; inert)
    "pkg": NON_RETRYABLE,                  # REQ_PKG (read; inert)
    "pkg_put": NON_RETRYABLE,              # REQ_PKG_PUT
    "need_space": NON_RETRYABLE,           # REQ_NEED_SPACE (spill)
    "free_objs": NON_RETRYABLE,            # REQ_FREE
    "kill_actor_req": NON_RETRYABLE,       # REQ_KILL_ACTOR
    "stream_credit": NON_RETRYABLE,        # REQ_STREAM_CREDIT
    "pubsub": NON_RETRYABLE,               # REQ_PUBSUB
    "put_meta_async": NON_RETRYABLE,       # REQ_PUT_META_ASYNC
    "submit_async": NON_RETRYABLE,         # REQ_SUBMIT_ASYNC
    "actor_call_async": NON_RETRYABLE,     # REQ_ACTOR_CALL_ASYNC
    "stream_consumed_async": NON_RETRYABLE,  # REQ_STREAM_CONSUMED_ASYNC
    "barrier": NON_RETRYABLE,              # REQ_BARRIER
    "task_cancelled": NON_RETRYABLE,       # REQ_TASK_CANCELLED (read; inert)
}

#: kv (msg[0] == "kv") classifies per sub-op (msg[1]): overwrites and
#: deletes are LWW; merge/cas_merge are read-modify-write — a replay
#: double-merges (the netem sweep exercises exactly this split).
KV_SUBOP_CONTRACT: Dict[str, str] = {
    "put": RETRY_AFTER_APPLY,     # overwrite: LWW
    "get": IDEMPOTENT,
    "del": RETRY_AFTER_APPLY,     # second delete is a no-op
    "exists": IDEMPOTENT,
    "keys": IDEMPOTENT,
    "merge": NON_RETRYABLE,       # dict.update RMW: replay double-merges
    "cas_merge": NON_RETRYABLE,   # compare-and-swap RMW
}

#: The derived transport whitelist (imported by rpc.py). Pinned to the
#: historical ``_IDEMPOTENT_OPS`` literal by the netem parity test.
RETRY_SAFE_OPS = frozenset(
    op for op, c in WIRE_CONTRACT.items() if retry_safe(c))
RETRY_SAFE_KV_SUBOPS = frozenset(
    sub for sub, c in KV_SUBOP_CONTRACT.items() if retry_safe(c))


# -------------------------------------------------- durability / resync
#
# For every op the GCS write-ahead-logs (gcs.py _WAL_OPS), how does a
# node or driver RE-ACQUIRE that state when the head restarts EMPTY (no
# persist dir, or a wiped one)? L10 statically checks each declaration
# against the code it names:
#
# - "resync:<op>"      the op (or the batch op superseding it) is
#                      re-published by ha.py resync_node — the literal
#                      must appear in resync_node's body.
# - "helper:<fn>"      resync_node re-publishes it through node_server's
#                      <fn>() message builder — resync_node must call
#                      <fn> and <fn>'s body must contain the op literal.
# - "cursor:<key>"     consumers recover through a gcs_info cursor clamp
#                      (<key> must be a key in _op_gcs_info's reply) —
#                      the event stream is re-cut at the head's
#                      watermark rather than re-pushed.
# - "durable"          snapshot+WAL is the ONLY copy (the data has no
#                      second home on a node to re-push from); an EMPTY
#                      restart legitimately loses it. Keep this list
#                      short and justified.
RESYNC_COVERAGE: Dict[str, str] = {
    "register_node": "helper:register_msg",  # node re-registers itself
    "unregister_node": "cursor:death_seq",   # deaths re-cut at watermark
    "kv": "resync:kv",               # node PG slice re-published; other
                                     # kv content is driver-origin and
                                     # durable-only past driver exit
    "name_actor": "resync:name_actor",
    "drop_actor_name": "durable",    # a dropped name needs no re-drop:
                                     # an empty head has no row to drop
    "register_actor": "resync:register_actor",
    "register_actor_spec": "durable",  # restart authority: once handed
                                       # to the GCS the spec's only home
                                       # is snapshot+WAL (driver may be
                                       # long gone)
    "drop_actor_spec": "durable",    # tombstone of a durable row
    "loc_add": "resync:loc_add_batch",   # superseded by the batch op
    "loc_add_batch": "resync:loc_add_batch",
    "loc_drop": "cursor:channel_seq",    # drops re-derive from the freed
                                         # channel replay + fetch misses
    "freed_add": "cursor:channel_seq",   # freed channel re-cut + replay
    "publish": "cursor:channel_seq",     # subscribers clamp + resync
                                         # through the seq-gap path
    "register_fn": "durable",        # re-shipped lazily on first use
                                     # (submit carries pickled_fn)
    "drain_node": "durable",         # operator intent: lives only here;
                                     # restore re-arms the grace window
    "node_drained": "durable",       # terminal lifecycle edge of ^
}
