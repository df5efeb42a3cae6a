"""Control-plane wire protocol between driver and workers.

Messages are tuples ``(tag, ...)`` sent over ``multiprocessing.connection``
(pickle framing). This is the single-node analogue of the reference's gRPC
services: the task conn carries what ``CoreWorkerService.PushTask``
(src/ray/protobuf/core_worker.proto:444) carries, and the data conn carries
the worker→owner requests that in the reference go over dedicated RPCs
(get/put/submit from inside tasks).

Values travel as *payload descriptors*::

    ("inline", bytes)         - serialization container inlined in the message
    ("shm", oid_bytes)        - stored in the shared-memory object store

Args additionally carry ``inline_values``: {oid_bytes: payload} for resolved
dependencies whose values live only in the owner's memory store.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.core import serialization
from ray_tpu_torch.core.ids import ObjectID
from ray_tpu_torch.core.object_ref import ObjectRef, begin_ref_collection, end_ref_collection
from ray_tpu_torch.exceptions import ObjectStoreFullError

# driver -> worker (task conn)
MSG_REGISTER_FN = "reg_fn"         # (MSG_REGISTER_FN, fn_id, pickled_fn)
MSG_CREATE_ACTOR = "create_actor"  # (.., actor_id_b, cls_fn_id, args_payload, inline_values, opts)
MSG_ACTOR_CALL = "actor_call"      # (.., task_id_b, actor_id_b, method, args_payload, inline_values, return_id_bytes)
MSG_TASK_BATCH = "task_batch"      # (MSG_TASK_BATCH, [(task_id_b, fn_id, args_payload, inline_values, return_ids, runtime_env|None, stream_opts|None), ...])
MSG_SHUTDOWN = "shutdown"

# worker -> driver (task conn)
MSG_READY = "ready"                # (MSG_READY, pid)
MSG_DONE = "done"                  # (MSG_DONE, task_id_b, [payload, ...])
MSG_ERROR = "error"                # (MSG_ERROR, task_id_b, pickled_exc_payload)
MSG_ACTOR_READY = "actor_ready"    # (.., actor_id_b)
MSG_ACTOR_ERROR = "actor_error"    # (.., actor_id_b, pickled_exc_payload)
MSG_STREAM_YIELD = "stream_yield"  # (.., task_id_b, seed, index, rid_b, payload, is_end): one streamed return sealed

# worker -> driver (data conn, request/response)
REQ_GET = "get"                    # (REQ_GET, [oid_bytes], timeout_ms, cur_task_id_b) -> ("ok", {oid: payload}) | ("err", payload)
REQ_PUT_META = "put_meta"          # (REQ_PUT_META, oid_bytes, payload_or_none) -> ("ok",)
REQ_SUBMIT = "submit"              # (REQ_SUBMIT, fn_id, pickled_fn_or_none, args_payload, inline_values, n_returns, ref_oids) -> ("ok", [oid_bytes])
REQ_ACTOR_CALL = "actor_call"      # worker-side actor handle call -> ("ok", [oid_bytes])
REQ_WAIT = "wait"                  # (REQ_WAIT, [oid_bytes], num_returns, timeout_s) -> ("ok", ready, rest)
REQ_KV = "kv"                      # (REQ_KV, op, key, value) -> ("ok", value)
REQ_CREATE_ACTOR = "create_actor_req"  # (.., fn_id, pickled_cls_or_none, args_payload, deps, opts) -> ("ok", actor_id_bytes)
REQ_PG = "pg"                      # (REQ_PG, op, *args) -> ("ok", result); op in create/remove/ready_ref/wait/chips/table
REQ_GET_ACTOR = "get_actor"        # (REQ_GET_ACTOR, name) -> ("ok", handle_payload)
REQ_CANCEL = "cancel"              # (REQ_CANCEL, oid_bytes, force) -> ("ok",)
REQ_PKG = "pkg"                    # (REQ_PKG, hash_str) -> ("ok", bytes_or_none)
REQ_PKG_PUT = "pkg_put"            # (REQ_PKG_PUT, hash_str, bytes) -> ("ok", None)
REQ_NEED_SPACE = "need_space"      # (REQ_NEED_SPACE, nbytes) -> ("ok", freed_bool)
REQ_FREE = "free_objs"             # (REQ_FREE, [oid_bytes]) -> ("ok", count_freed)
REQ_KILL_ACTOR = "kill_actor_req"  # (REQ_KILL_ACTOR, actor_id_bytes, no_restart) -> ("ok",)
REQ_STREAM_NEXT = "stream_next"    # (REQ_STREAM_NEXT, seed, index, timeout_ms, owner) -> ("ref", rid_b) | ("end", count) | ("pending",) | ("err", payload)
REQ_STREAM_CREDIT = "stream_credit"  # (REQ_STREAM_CREDIT, seed, produced) -> ("ok", consumed): producer backpressure probe
REQ_TASK_CANCELLED = "task_cancelled"  # (REQ_TASK_CANCELLED, task_id_b) -> ("ok", bool): was this batched task cancelled
REQ_PUBSUB = "pubsub"              # (REQ_PUBSUB, op, channel, arg, timeout) -> ("ok", result); op in publish/poll (GCS channel semantics)
# well-known pubsub channels: "freed" (eager-free tombstone broadcast),
# "node_deaths" (GCS health monitor), "actor_state" (actor-restart FSM
# transitions: {"actor_id", "state": ALIVE|RESTARTING|DEAD,
# "restarts_left", "name", ...} — published by the owning runtime on
# worker-death restarts and by the GCS on cross-node restarts)

# fire-and-forget variants (NO reply — the worker pre-generates the ids,
# so the owner's round trip leaves the submission hot path; errors land
# in the return-object entries and surface at get(), like the
# reference's async task submission through the core worker):
REQ_PUT_META_ASYNC = "put_meta_async"      # (.., oid_bytes, payload_or_none)
REQ_SUBMIT_ASYNC = "submit_async"          # (.., fn_id, pickled_fn_or_none, args_payload, inline_values, return_ids, options)
REQ_ACTOR_CALL_ASYNC = "actor_call_async"  # (.., actor_id_b, method, args_payload, extra, return_ids)
# ``extra`` on REQ_ACTOR_CALL / REQ_ACTOR_CALL_ASYNC is a dict of optional
# keys: "__deps" (top-level dep oid bytes), "__stream" (streaming call),
# "__parent" (submitting task id), "__opts" (per-call overrides —
# max_task_retries / retry_exceptions — resolved against the actor's
# class-level opts at enqueue).
REQ_STREAM_CONSUMED_ASYNC = "stream_consumed_async"  # (.., seed, index, owner): consumer advanced past index

REQ_BARRIER = "barrier"  # (REQ_BARRIER,) -> ("ok",): all earlier async sends applied

NO_REPLY = ("__no_reply__",)  # sentinel: data server sends nothing back

class ErrorValue:
    """Marker wrapping an exception stored as an object's value.

    Distinguishes "the task failed with E" from "the task returned the
    exception object E" (the reference uses RayTaskError subclassing for the
    same purpose). ``raise_if_error`` re-raises at get().
    """

    __slots__ = ("error",)

    def __init__(self, error: BaseException):
        self.error = error

    def __reduce__(self):
        return (ErrorValue, (self.error,))


def raise_if_error(value):
    if isinstance(value, ErrorValue):
        raise value.error
    return value


class _TopLevelDep:
    """Sentinel replacing a resolved top-level ObjectRef arg in transit."""

    __slots__ = ("oid_bytes",)

    def __init__(self, oid_bytes: bytes):
        self.oid_bytes = oid_bytes

    def __reduce__(self):
        return (_TopLevelDep, (self.oid_bytes,))


class _StreamEnd:
    """End-of-stream sentinel sealed at the index one past the final yield
    of a ``num_returns="streaming"`` task (the reference stores
    ``ObjectRefStreamEndOfStreamError`` the same way). ``count`` is the
    number of values the generator produced, so a consumer that attaches
    late still learns the stream length."""

    __slots__ = ("count",)

    def __init__(self, count: int):
        self.count = count

    def __reduce__(self):
        return (_StreamEnd, (self.count,))


def stream_index_id(seed: bytes, index: int) -> bytes:
    """Deterministic per-index object id for a streaming return.

    Derived from the submit-time seed so the owner, the worker, and a
    replayed generator after worker death all agree on the id of yield
    ``index`` without a round trip (the reference derives dynamic return
    ids from the task id + index the same way)."""
    import hashlib

    return hashlib.blake2b(
        seed + index.to_bytes(8, "little"), digest_size=16).digest()


Payload = Tuple[str, bytes]


def serialize_args(
    args: tuple, kwargs: dict, store=None
) -> Tuple[Payload, List[ObjectRef]]:
    """Serialize an (args, kwargs) pair, collecting nested ObjectRefs.

    Large payloads go to the shm ``store`` when provided.
    Returns (payload_descriptor, collected_refs).
    """
    refs = begin_ref_collection()
    try:
        pickled, views, total = serialization.serialize((args, kwargs))
    finally:
        end_ref_collection()
    payload = _store_or_inline(pickled, views, total, store)
    return payload, refs


def serialize_value(value: Any, store=None) -> Payload:
    pickled, views, total = serialization.serialize(value)
    return _store_or_inline(pickled, views, total, store)


def _store_or_inline(pickled, views, total, store) -> Payload:
    if store is not None and total > serialization.inline_threshold():
        oid = ObjectID.from_random()
        dst = None
        try:
            # invokes the store's need_space hook (spilling) when full;
            # retain-seal hands the creator ref to the owner's tracking pin
            dst = store.create_object_with_pressure(oid, total)
            serialization.write_container(dst, pickled, views)
            store.seal(oid, retain=True)
            return ("shm", oid.binary())
        except (ObjectStoreFullError, ValueError, OSError):
            if dst is not None:
                # allocation succeeded but the write/seal window failed:
                # an unsealed object is invisible to getters and only
                # reclaimed at store close — abort it (drop the creator
                # ref, then free) before falling back to inline
                try:
                    store.release(oid)
                    store.delete(oid)
                # rtpu-lint: disable=L4 — abort of a slot the store may
                # have concurrently closed under us; inline fallback is
                # the contract either way
                except Exception:  # noqa: BLE001
                    pass
            # store full/closed even after spilling: fall back to inline
    out = bytearray(total)
    serialization.write_container(memoryview(out), pickled, views)
    return ("inline", bytes(out))


def spilled_unpack(path_and_size) -> Any:
    """Decode a spilled payload (reference: external_storage restore,
    python/ray/_private/external_storage.py:451). Local files hold the
    same container format as a shm object and are mmap'd so large
    tensors stay file-backed until touched; fsspec URIs (s3://...) read
    through the filesystem driver.

    A missing or undecodable spill file means the value is LOST (disk
    reclaimed, torn write, bucket eviction) — that surfaces as
    ObjectLostError, the same signal as a shm-store miss, so the owner
    can attempt lineage reconstruction of the producing task."""
    from ray_tpu_torch.core import external_storage as _ext
    from ray_tpu_torch.exceptions import ObjectLostError

    path = path_and_size[0] if isinstance(path_and_size, tuple) else path_and_size
    try:
        buf = _ext.read_buffer(path)
    except Exception as e:  # noqa: BLE001 — missing file / backend error
        raise ObjectLostError(
            f"spill file {path} is unreadable ({type(e).__name__}: {e})"
        ) from None
    try:
        return serialization.unpack(memoryview(buf))
    except ObjectLostError:
        raise
    except Exception as e:  # noqa: BLE001 — truncated/overwritten file
        raise ObjectLostError(
            f"spill file {path} is corrupt ({type(e).__name__}: {e})"
        ) from None


class _Pin:
    """Keeps one shm object pinned until every wrapped buffer is collected."""

    __slots__ = ("_store", "_oid", "count")

    def __init__(self, store, oid, count):
        self._store = store
        self._oid = oid
        self.count = count

    def decref(self):
        self.count -= 1
        if self.count == 0:
            try:
                self._store.release(self._oid)
            # rtpu-lint: disable=L4 — runs from zero-copy buffer
            # finalizers, possibly during interpreter teardown with the
            # store already closed; a pin release must never raise there
            except Exception:  # noqa: BLE001
                pass


def shm_unpack(store, oid: ObjectID, timeout_ms: int = 0) -> Any:
    """Fetch + deserialize an object from the shm store with zero-copy
    buffers that keep the object pinned for the lifetime of the deserialized
    arrays (the reference pins plasma objects-in-use per worker the same way:
    src/ray/core_worker/store_provider/plasma_store_provider.h).

    Callers only reach this once the owner reports the object sealed, so a
    miss means it was LRU-evicted -> ObjectLostError (the reference raises
    the same). The owning Runtime catches that signal for task-produced
    objects and resubmits the producing task from its lineage table (up to
    config.max_reconstructions attempts, budgeted by
    config.lineage_max_bytes); put/freed/lineage-evicted objects stay
    lost and the error propagates to the caller.
    """
    import ctypes
    import weakref

    from ray_tpu_torch.exceptions import ObjectLostError, ObjectTimeoutError

    try:
        mv = store.get(oid, timeout_ms=timeout_ms)
    except ObjectTimeoutError:
        raise ObjectLostError(
            f"object {oid} was evicted from the object store before it was "
            f"read (store under memory pressure)"
        ) from None
    wrapped_count = 0
    pin_box = []

    def wrap(chunk: memoryview):
        nonlocal wrapped_count
        # ctypes arrays are weakref-able buffer-protocol objects; a numpy
        # array reconstructed over one keeps it (and thus the pin) alive.
        blk = (ctypes.c_uint8 * chunk.nbytes).from_buffer(chunk)
        wrapped_count += 1
        pin_box.append(blk)
        return blk

    try:
        value = serialization.unpack(mv, wrap_buffer=wrap)
    except Exception:
        store.release(oid)
        raise
    if wrapped_count == 0:
        store.release(oid)
    else:
        pin = _Pin(store, oid, wrapped_count)
        for blk in pin_box:
            weakref.finalize(blk, pin.decref)
    return value


def deserialize_payload(payload: Payload, store=None) -> Any:
    """Decode a payload descriptor (zero-copy + pinned for shm payloads)."""
    kind, data = payload
    if kind == "inline":
        return serialization.unpack(data)
    if kind == "shm":
        return shm_unpack(store, ObjectID(data))
    if kind == "spilled":
        return spilled_unpack(data)
    raise ValueError(f"unknown payload kind {kind!r}")


def schema() -> str:
    """The complete wire schema, assembled from this module's message
    constants (driver<->worker link) and the RPC servers' op handlers
    (node/GCS planes) — the single-language analogue of the reference's
    .proto files (`python -m ray_tpu_torch.core.protocol` prints it)."""
    import inspect
    import re

    lines = ["ray_tpu_torch wire schema", "=" * 60, "",
             "driver <-> worker (framed pickle over pipes)", "-" * 60]
    src = inspect.getsource(inspect.getmodule(schema))
    for m in re.finditer(
            r'^(MSG_|REQ_)(\w+) = "([^"]+)"[ \t]*(?:#[ \t]*(.*))?$',
            src, re.M):
        kind, name, tag, doc = m.groups()
        lines.append(f"  {kind}{name:<18} {tag!r:<22} {doc or ''}".rstrip())

    for title, cls_path in (
            ("node server RPC ops", "ray_tpu_torch.core.cluster.node_server"),
            ("GCS server RPC ops", "ray_tpu_torch.core.cluster.gcs")):
        lines += ["", title + " (authkey'd framed-pickle TCP)", "-" * 60]
        import importlib

        mod = importlib.import_module(cls_path)
        for cls in vars(mod).values():
            if not inspect.isclass(cls):
                continue
            ops = [(n[len("_op_"):], f) for n, f in vars(cls).items()
                   if n.startswith("_op_")]
            for op, f in sorted(ops):
                doc = (inspect.getdoc(f) or "").split("\n")[0]
                sig = str(inspect.signature(f)).replace("(self, ", "(")
                lines.append(f"  {op:<22} {sig:<40} {doc}".rstrip())
    return "\n".join(lines)


if __name__ == "__main__":
    print(schema())
