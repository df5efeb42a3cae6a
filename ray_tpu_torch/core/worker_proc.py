"""Worker process: executes tasks and hosts actors.

The per-process core client (``WorkerCore``) mirrors the reference's
``CoreWorker`` execution side (src/ray/core_worker/core_worker_process.cc:63
RunTaskExecutionLoop; python/ray/_raylet.pyx:1693 execute_task): a loop that
receives task specs on the *task connection*, executes them, and writes
results either straight into the shared-memory store (large) or inline into
the completion message (small). A second *data connection* carries
synchronous worker→driver requests (get/put/submit/actor calls), which in the
reference are CoreWorker RPCs to the owner.

Launched as: python -m ray_tpu_torch.core.worker_main
with connection info in environment variables (RTPU_ADDRESS, RTPU_AUTH,
RTPU_STORE, RTPU_NODE_ID, RTPU_WORKER_ID).
"""

from __future__ import annotations

import os
import sys
import tempfile
import threading
import traceback
from multiprocessing.connection import Client
from typing import Any, Dict, List, Optional

from ray_tpu_torch.core import protocol, serialization
from ray_tpu_torch.core.protocol import _TopLevelDep
from ray_tpu_torch.core.ids import ActorID, NodeID, ObjectID, TaskID, WorkerID
from ray_tpu_torch.core.object_ref import ObjectRef
from ray_tpu_torch.core import runtime_context
from ray_tpu_torch.core.object_store.store import ShmObjectStore
from ray_tpu_torch.exceptions import ObjectStoreFullError, TaskError
from ray_tpu_torch.util.debug_lock import make_lock


class WorkerCore:
    """Core client installed in worker processes."""

    def __init__(self, task_conn, data_conn, store: Optional[ShmObjectStore],
                 node_id: NodeID, worker_id: WorkerID):
        self.task_conn = task_conn
        self.data_conn = data_conn
        self.store = store
        if store is not None:
            # Store-full backpressure: ask the owner to spill cold objects
            # (only the owner knows which containers are safe to spill).
            store.need_space_hook = (
                lambda n: self._request(protocol.REQ_NEED_SPACE, n)[1])
        self.node_id = node_id
        self.worker_id = worker_id
        # the driver's session directory (the parent of the package dir
        # it names): a gang that a worker starts (a Tune trial over a
        # TorchTrainer) meets in a rendezvous file there, as the driver's
        pkg_dir = os.environ.get("RTPU_PKG_DIR")
        self._session_dir = os.path.dirname(pkg_dir) if pkg_dir else None
        # task/actor context is thread-local: concurrent actor threads
        # (max_concurrency > 1) must not clobber each other's attribution
        self._ctx_tls = threading.local()
        # set by the SIGTERM handler of actors created with trap_sigterm
        # (train workers); read by train.preempted()
        self.preempted = threading.Event()
        self._data_lock = make_lock("WorkerCore._data_lock")
        self._send_lock = make_lock("WorkerCore._send_lock")
        # a cancel SIGINT that landed outside a task's own code (see
        # _on_sigint)
        self.sigint_pending = False
        self._async_dirty = False  # async sends since last barrier
        self._functions: Dict[bytes, Any] = {}
        self._driver_known_fns: set = set()
        self._actors: Dict[bytes, Any] = {}
        self._actor_loops: Dict[bytes, Any] = {}  # actor_id -> asyncio loop
        self._actor_pools: Dict[bytes, Any] = {}  # actor_id -> executor
        # named concurrency groups (reference:
        # concurrency_group_manager.h:34): per-group executors + the
        # method -> group routing map declared at actor creation
        self._actor_group_pools: Dict[bytes, Dict[str, Any]] = {}
        self._actor_method_group: Dict[bytes, Dict[str, str]] = {}

    @property
    def current_task_id(self) -> Optional[TaskID]:
        return getattr(self._ctx_tls, "task_id", None)

    @current_task_id.setter
    def current_task_id(self, v) -> None:
        self._ctx_tls.task_id = v

    @property
    def interruptible(self) -> bool:
        """True while this thread runs a task's own code (its function,
        its stream): only there does a cancel SIGINT raise."""
        return getattr(self._ctx_tls, "interruptible", False)

    @interruptible.setter
    def interruptible(self, v: bool) -> None:
        self._ctx_tls.interruptible = v

    @property
    def current_actor_id(self) -> Optional[ActorID]:
        return getattr(self._ctx_tls, "actor_id", None)

    @current_actor_id.setter
    def current_actor_id(self, v) -> None:
        self._ctx_tls.actor_id = v

    # ---- data-conn RPC ------------------------------------------------------

    def _request(self, *msg):
        from ray_tpu_torch.core.config import config

        if config.testing_rpc_delay_ms > 0:
            # Chaos delay injection (reference: asio_chaos.cc:35).
            import random
            import time

            time.sleep(random.uniform(0, config.testing_rpc_delay_ms / 1000))
        with self._data_lock:
            # rtpu-lint: disable=L2 — _data_lock must span send+recv:
            # data_conn is shared by every thread in this worker, and the
            # lock is what pairs each request with its own response
            self.data_conn.send(msg)
            reply = self.data_conn.recv()  # rtpu-lint: disable=L2 — see above
        if reply[0] == "err":
            err = protocol.deserialize_payload(reply[1], store=self.store)
            raise err.error if isinstance(err, protocol.ErrorValue) else err
        return reply

    def _send_async(self, *msg):
        """Fire-and-forget send: the owner applies in FIFO order on this
        connection, so a later REQ_GET can never observe pre-apply state.
        Removing the reply round trip from put/submit is what lets a
        worker drive thousands of calls/s through the owner (reference:
        async task submission via the core worker's io loop). Results
        travel a DIFFERENT connection — _send_results barriers first so a
        returned ref can never reach the driver before its submission is
        applied (else ray.cancel on it would silently no-op)."""
        with self._data_lock:
            # rtpu-lint: disable=L2 — _data_lock serializes frames on the
            # shared data_conn (its whole purpose); no other lock nests here
            self.data_conn.send(msg)
        self._async_dirty = True

    # ---- core-client surface (same as driver Runtime) -----------------------

    def get_objects(self, refs: List[ObjectRef], timeout: Optional[float] = None):
        oids = [r.id for r in refs]
        values: Dict[ObjectID, Any] = {}
        missing: List[ObjectID] = []
        for oid in oids:
            if self.store is not None and self.store.contains(oid):
                values[oid] = protocol.shm_unpack(self.store, oid)
            else:
                missing.append(oid)
        if missing:
            payloads = self._get_sliced([o.binary() for o in missing],
                                        timeout)
            for oid in missing:
                values[oid] = protocol.deserialize_payload(
                    payloads[oid.binary()], store=self.store
                )
        out = []
        for oid in oids:
            out.append(protocol.raise_if_error(values[oid]))
        return out

    def _get_sliced(self, oid_bytes: List[bytes],
                    timeout: Optional[float]) -> Dict[bytes, Any]:
        """The owner's payloads of ``oid_bytes``, asked for in slices of at
        most 200 ms (as ``wait``): the data connection is this process's,
        one request at a time, and an unbounded get would hold every other
        thread's request behind it (a trial actor's ``fit()`` waits on its
        gang while the gang's Dataset feeder, a thread of the same actor,
        must reach the split coordinator)."""
        import time

        from ray_tpu_torch.exceptions import GetTimeoutError

        cur = self.current_task_id.binary() if self.current_task_id else None
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            slice_ms = 200 if deadline is None else max(
                0, min(200, int((deadline - time.monotonic()) * 1000)))
            try:
                _, payloads = self._request(
                    protocol.REQ_GET, oid_bytes, slice_ms, cur)
                return payloads
            except GetTimeoutError:
                if deadline is not None and time.monotonic() >= deadline:
                    raise
            time.sleep(0.001)   # a window for the other threads' requests

    def put_object(self, value: Any) -> ObjectRef:
        oid = ObjectID.from_random()
        payload = protocol.serialize_value(value, store=self.store)
        if payload[0] == "shm":
            # Data already in shm under a scratch id; re-register under oid is
            # avoided by just using the payload's id as the object id.
            oid = ObjectID(payload[1])
            self._send_async(protocol.REQ_PUT_META_ASYNC, oid.binary(), None)
        else:
            self._send_async(protocol.REQ_PUT_META_ASYNC, oid.binary(),
                             payload)
        return ObjectRef(oid, core=self)

    def submit_task(self, fn_id: bytes, pickled_fn: Optional[bytes], args: tuple,
                    kwargs: dict, num_returns, options: dict) -> List[ObjectRef]:
        args_payload, deps, nested = _prepare_args_local(self, args, kwargs)
        send_fn = None if fn_id in self._driver_known_fns else pickled_fn
        options = dict(options)
        if num_returns == "streaming":
            # the single pre-generated return id doubles as the stream
            # seed; the owner registers the stream when it applies this
            # submission (see Runtime._apply_worker_submit)
            num_returns = 1
            options["__stream"] = True
        options["__deps"] = deps
        # span propagation: nested submissions carry the submitting
        # task's id so cross-process traces keep causality
        if self.current_task_id is not None:
            options["__parent"] = self.current_task_id.hex()
        options["__nested"] = nested
        return_ids = [ObjectID.from_random() for _ in range(num_returns)]
        self._send_async(
            protocol.REQ_SUBMIT_ASYNC, fn_id, send_fn, args_payload, {},
            [r.binary() for r in return_ids], options,
        )
        self._driver_known_fns.add(fn_id)
        return [ObjectRef(rid, core=self) for rid in return_ids]

    def submit_actor_task(self, actor_id: ActorID, method: str, args: tuple,
                          kwargs: dict, num_returns,
                          options=None) -> List[ObjectRef]:
        args_payload, deps, _nested = _prepare_args_local(self, args, kwargs)
        extra = {"__deps": deps}
        if options:
            # per-call retry options (max_task_retries/retry_exceptions)
            # resolved by the owner when it builds the spec
            extra["__opts"] = dict(options)
        if num_returns == "streaming":
            num_returns = 1
            extra["__stream"] = True
        if self.current_task_id is not None:
            extra["__parent"] = self.current_task_id.hex()
        return_ids = [ObjectID.from_random() for _ in range(num_returns)]
        self._send_async(
            protocol.REQ_ACTOR_CALL_ASYNC, actor_id.binary(), method,
            args_payload, extra, [r.binary() for r in return_ids],
        )
        return [ObjectRef(rid, core=self) for rid in return_ids]

    # ---- streaming generator consumption (ObjectRefGenerator) ---------------

    def stream_next(self, seed: bytes, index: int,
                    timeout: Optional[float] = None, owner=None):
        """Next streamed return of generator ``seed``: blocks (in short
        request slices, so cancel/SIGINT stays responsive) until the
        producer seals index ``index`` or ends the stream."""
        import time

        from ray_tpu_torch.exceptions import ObjectTimeoutError

        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            slice_ms = 200
            if deadline is not None:
                remaining = deadline - time.monotonic()
                slice_ms = min(slice_ms, max(0, int(remaining * 1000)))
            # asked at least once: timeout=0 is a poll (the streaming
            # executor's), not a refusal to look
            reply = self._request(
                protocol.REQ_STREAM_NEXT, seed, index, slice_ms, owner)
            if reply[0] != "pending":
                return reply[0], reply[1] if len(reply) > 1 else None
            if deadline is not None and time.monotonic() >= deadline:
                raise ObjectTimeoutError(
                    f"stream {seed.hex()} index {index} not produced "
                    f"within {timeout}s")

    def stream_consumed(self, seed: bytes, index: int, owner=None):
        self._send_async(
            protocol.REQ_STREAM_CONSUMED_ASYNC, seed, index, owner)

    def create_actor_from_worker(self, fn_id: bytes, pickled_cls: Optional[bytes],
                                 args: tuple, kwargs: dict, opts: dict) -> ActorID:
        args_payload, deps, _nested = _prepare_args_local(self, args, kwargs)
        send_cls = None if fn_id in self._driver_known_fns else pickled_cls
        _, actor_id_b = self._request(
            protocol.REQ_CREATE_ACTOR, fn_id, send_cls, args_payload, deps, opts
        )
        self._driver_known_fns.add(fn_id)
        return ActorID(actor_id_b)

    def wait(self, refs, num_returns=1, timeout=None):
        """Owner-side wait in slices of at most 200 ms, for the reason
        ``_get_sliced`` gives."""
        import time

        if num_returns > len(refs):
            raise ValueError("num_returns exceeds number of refs")
        by_id = {r.id.binary(): r for r in refs}
        cur = self.current_task_id.binary() if self.current_task_id else None
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            slice_s = 0.2 if deadline is None else max(
                0.0, min(0.2, deadline - time.monotonic()))
            _, ready_b, rest_b = self._request(
                protocol.REQ_WAIT, list(by_id.keys()), num_returns, slice_s,
                cur)
            if len(ready_b) >= num_returns or (
                    deadline is not None and time.monotonic() >= deadline):
                return [by_id[b] for b in ready_b], [by_id[b] for b in rest_b]
            time.sleep(0.001)   # a window for the other threads' requests

    # ---- placement groups (proxied to the driver) ---------------------------

    def create_placement_group(self, bundles, strategy, name):
        from ray_tpu_torch.core.ids import PlacementGroupID
        from ray_tpu_torch.core.placement_group import PlacementGroup

        _, (pg_id_b, specs) = self._request(
            protocol.REQ_PG, "create", bundles, strategy, name)
        return PlacementGroup(PlacementGroupID(pg_id_b), specs)

    def remove_placement_group(self, pg_id):
        self._request(protocol.REQ_PG, "remove", pg_id.binary())

    def placement_group_ready_ref(self, pg_id):
        _, oid_b = self._request(protocol.REQ_PG, "ready_ref", pg_id.binary())
        return ObjectRef(ObjectID(oid_b), core=self)

    def wait_placement_group(self, pg_id, timeout):
        _, ok = self._request(protocol.REQ_PG, "wait", pg_id.binary(), timeout)
        return ok

    def placement_group_gpus(self, pg_id, index):
        _, ids = self._request(protocol.REQ_PG, "gpus", pg_id.binary(), index)
        return ids

    def placement_group_table(self):
        _, table = self._request(protocol.REQ_PG, "table")
        return table

    def kv_op(self, op: str, key: str, value=None):
        _, result = self._request(protocol.REQ_KV, op, key, value)
        return result

    def pubsub_op(self, op: str, channel: str, arg=None,
                  timeout: float = 0.0):
        _, result = self._request(protocol.REQ_PUBSUB, op, channel, arg,
                                  timeout)
        return result

    def cancel_task(self, ref: ObjectRef, force: bool = False):
        self._request(protocol.REQ_CANCEL, ref.id.binary(), force)

    def get_actor_handle(self, name: str):
        _, payload = self._request(protocol.REQ_GET_ACTOR, name)
        return protocol.deserialize_payload(payload, store=self.store)

    def as_future(self, ref: ObjectRef):
        import asyncio

        loop = asyncio.get_event_loop()
        fut = loop.create_future()

        def resolve():
            try:
                v = self.get_objects([ref])[0]
                loop.call_soon_threadsafe(fut.set_result, v)
            except BaseException as e:  # noqa: BLE001
                loop.call_soon_threadsafe(fut.set_exception, e)

        threading.Thread(target=resolve, daemon=True).start()
        return fut

    # ---- execution ----------------------------------------------------------

    def run_loop(self):
        self.task_conn.send((protocol.MSG_READY, os.getpid()))
        while True:
            try:
                msg = self.task_conn.recv()
            except (EOFError, OSError):
                break
            tag = msg[0]
            if tag == protocol.MSG_SHUTDOWN:
                for pool in self._actor_pools.values():
                    pool.shutdown(wait=False, cancel_futures=True)
                for pools in self._actor_group_pools.values():
                    for pool in pools.values():
                        pool.shutdown(wait=False, cancel_futures=True)
                break
            elif tag == protocol.MSG_REGISTER_FN:
                _, fn_id, pickled_fn = msg
                self._functions[fn_id] = serialization.unpack(pickled_fn)
            elif tag == protocol.MSG_TASK_BATCH:
                self._execute_task_batch(msg[1])
            elif tag == protocol.MSG_CREATE_ACTOR:
                self._create_actor(msg)
            elif tag == protocol.MSG_ACTOR_CALL:
                group = self._actor_method_group.get(msg[2], {}).get(msg[3])
                pool = None
                if group is not None:
                    # named concurrency group: this method's calls share
                    # the group's own thread budget, isolated from other
                    # groups (reference: concurrency groups)
                    pool = self._actor_group_pools[msg[2]].get(group)
                if pool is None:
                    pool = self._actor_pools.get(msg[2])
                if pool is not None:
                    # max_concurrency > 1: calls overlap on pool threads
                    # (FIFO submission; completion may reorder — the
                    # reference's threaded-actor semantics)
                    pool.submit(self._execute_actor_call, msg)
                else:
                    self._execute_actor_call(msg)
            else:  # pragma: no cover
                sys.stderr.write(f"worker: unknown message {tag!r}\n")

    def _decode_args(self, args_payload, inline_values):
        args, kwargs = protocol.deserialize_payload(args_payload, store=self.store)
        dep_cache: Dict[bytes, Any] = {}

        def resolve(v):
            if isinstance(v, _TopLevelDep):
                b = v.oid_bytes
                if b not in dep_cache:
                    if b in inline_values and inline_values[b] is not None:
                        dep_cache[b] = protocol.deserialize_payload(
                            inline_values[b], store=self.store
                        )
                    else:
                        dep_cache[b] = protocol.shm_unpack(self.store, ObjectID(b))
                return protocol.raise_if_error(dep_cache[b])
            return v

        args = tuple(resolve(a) for a in args)
        kwargs = {k: resolve(v) for k, v in kwargs.items()}
        return args, kwargs

    @staticmethod
    def _split_returns(result, num_returns: int) -> list:
        if num_returns == 1:
            return [result]
        values = list(result)
        if len(values) != num_returns:
            raise ValueError(
                f"task declared num_returns={num_returns} but returned "
                f"{len(values)} values"
            )
        return values

    @staticmethod
    def _error_payload(exc: BaseException):
        """Serialize an exception, falling back to a repr-wrapped error when
        the original (or its cause chain) does not pickle."""
        err = exc if isinstance(exc, TaskError) else TaskError(
            exc, traceback.format_exc())
        try:
            return protocol.serialize_value(protocol.ErrorValue(err), store=None)
        except Exception:
            return protocol.serialize_value(
                protocol.ErrorValue(TaskError(
                    RuntimeError(repr(exc)), traceback.format_exc())),
                store=None)

    def _dag_start(self, instance, in_descs, out_descs, method: str) -> str:
        """Start a compiled-DAG resident loop: read ALL input channels (in
        edge order), invoke the bound method with those values, write the
        result to EVERY output channel. Errors are forwarded as ('e', exc)
        markers so downstream stages pass them through and the driver
        re-raises (reference: compiled DAG error propagation). Each
        channel is shm, or a DeviceChannel between two stages of this
        actor. Every stage runs its loop in a thread of its own, so two
        stages of one actor may run on other CUDA streams: the device
        lane orders them with an event (``dag/channel.py``)."""
        import threading

        from ray_tpu_torch.dag.channel import ChannelClosed, open_endpoint

        fn = getattr(instance, method)

        def loop():
            import sys
            import traceback as tb

            ins: list = []
            outs: list = []
            try:
                # append one by one: a failure partway must not orphan
                # the endpoints already opened
                for d in in_descs:
                    ins.append(open_endpoint(d, store=self.store))
                for d in out_descs:
                    outs.append(open_endpoint(d, store=self.store))
            except Exception as e:  # noqa: BLE001
                # a real setup failure must not present as a silent hang:
                # log it, and try to push the error downstream so the
                # driver's first execute raises instead of timing out
                tb.print_exc(file=sys.stderr)
                err = RuntimeError(
                    f"DAG stage {method!r} failed to open its channels: "
                    f"{e!r}")
                for d in out_descs:
                    try:
                        outch = open_endpoint(d, store=self.store)
                        outch.write(("e", err), timeout_ms=5000)
                        outs.append(outch)
                    # rtpu-lint: disable=L4 — best-effort error fan-out:
                    # a downstream peer that is itself dead cannot be
                    # told; the remaining descriptors still get the error
                    except Exception:  # noqa: BLE001 — peer gone too
                        pass
                for ch in ins + outs:
                    ch.release()
                return
            try:
                while True:
                    vals = []
                    err = None
                    try:
                        for inch in ins:
                            tag, value = inch.read(timeout_ms=-1)
                            if tag == "e" and err is None:
                                err = value
                            vals.append(value)
                    except ChannelClosed:
                        for outch in outs:
                            outch.close()
                        return
                    except Exception:  # noqa: BLE001 — store torn down
                        return
                    if err is not None:
                        out = ("e", err)
                    else:
                        try:
                            out = ("v", fn(*vals))
                        except BaseException as e:  # noqa: BLE001
                            out = ("e", e)
                    # infinite timeout to MATCH the infinite reads: with a
                    # pipelined call in flight, a slow downstream stage
                    # (LLM decode) can legitimately hold the ack >10s
                    for outch in outs:
                        outch.write(out, timeout_ms=-1)
            finally:
                for ch in ins + outs:
                    ch.release()

        threading.Thread(target=loop, daemon=True,
                         name=f"dag-{method}").start()
        return "ok"

    @staticmethod
    def _dag_devinfo() -> tuple:
        """(pid, is_gpu) for the __rtpu_dag_devinfo__ compile probe. GPU
        detection is env-first (the runtime names a GPU actor's cards in
        ``RTPU_GPU_IDS``), then whether this process already initialised
        CUDA, read only when torch is already loaded: the probe never
        imports torch or initialises CUDA in a CPU worker."""
        import os as _os
        import sys as _sys

        is_gpu = bool(_os.environ.get("RTPU_GPU_IDS"))
        torch = _sys.modules.get("torch")
        if not is_gpu and torch is not None:
            is_gpu = bool(torch.cuda.is_initialized())
        return (_os.getpid(), is_gpu)

    def _send_results(self, task_id_b: bytes, result, num_returns: int,
                      return_id_bytes: List[bytes]):
        if self._async_dirty:
            # cross-connection ordering barrier: flush the owner's data
            # queue before the result (with any escaping refs) crosses
            # the task conn (see _send_async)
            self._async_dirty = False
            self._request(protocol.REQ_BARRIER)
        values = self._split_returns(result, num_returns)
        payloads = []
        for value, rid in zip(values, return_id_bytes):
            payloads.append(self._serialize_result(value, ObjectID(rid)))
        # _send_lock: actor thread pools (max_concurrency > 1) complete
        # calls concurrently; unsynchronized sends would interleave
        # Connection frames and corrupt the worker->driver protocol.
        with self._send_lock:
            # rtpu-lint: disable=L2 — _send_lock exists to serialize
            # result frames on task_conn (see comment above); leaf lock
            self.task_conn.send((protocol.MSG_DONE, task_id_b, payloads))

    def _serialize_result(self, value, rid: ObjectID):
        pickled, views, total = serialization.serialize(value)
        if (
            self.store is not None
            and total > serialization.inline_threshold()
        ):
            dst = None
            try:
                dst = self.store.create_object_with_pressure(rid, total)
                serialization.write_container(dst, pickled, views)
                # retain: the ref is adopted by the owner's tracking pin
                self.store.seal(rid, retain=True)
                return ("shm", rid.binary())
            except (ObjectStoreFullError, ValueError, OSError):
                if dst is not None:
                    # write/seal failed after allocation: abort the
                    # unsealed slot (invisible to getters, reclaimed
                    # only at close otherwise) before going inline
                    try:
                        self.store.release(rid)
                        self.store.delete(rid)
                    # rtpu-lint: disable=L4 — abort of a slot the store
                    # may have concurrently closed; inline fallback is
                    # the contract either way
                    except Exception:  # noqa: BLE001
                        pass
                # store full/closed even after spilling: go inline
        out = bytearray(total)
        serialization.write_container(memoryview(out), pickled, views)
        return ("inline", bytes(out))

    # ---- streaming generator production --------------------------------------

    def _drain_async_gen(self, agen):
        """Adapt an async generator to a sync iterator on a private loop."""
        import asyncio

        loop = asyncio.new_event_loop()
        try:
            while True:
                try:
                    yield loop.run_until_complete(agen.__anext__())
                except StopAsyncIteration:
                    return
        finally:
            loop.close()

    def _stream_report(self, task_id_b: bytes, seed: bytes, index: int,
                       rid_b: bytes, payload, is_end: bool):
        if self._async_dirty:
            # same cross-connection barrier as _send_results: a yielded
            # value carrying a just-submitted ref must not reach the
            # driver before its submission is applied
            self._async_dirty = False
            self._request(protocol.REQ_BARRIER)
        with self._send_lock:
            # rtpu-lint: disable=L2 — _send_lock serializes task_conn
            # frames against concurrent actor-thread results; leaf lock
            self.task_conn.send((protocol.MSG_STREAM_YIELD, task_id_b,
                                 seed, index, rid_b, payload, is_end))

    def _run_stream(self, task_id_b: bytes, result, stream_opts: dict):
        """Drive a ``num_returns="streaming"`` task: seal each yield under
        its deterministic index id and report it immediately, honoring the
        consumer-credit backpressure cap; finish with a _StreamEnd sentinel
        then a payload-less MSG_DONE for inflight bookkeeping."""
        import time

        seed = stream_opts["seed"]
        skip = int(stream_opts.get("skip", 0))
        cap = int(stream_opts.get("cap", 0))
        if hasattr(result, "__aiter__") and not hasattr(result, "__next__"):
            result = self._drain_async_gen(result)
        if not hasattr(result, "__next__"):
            raise TypeError(
                f"num_returns='streaming' requires the task to return a "
                f"generator/iterator, got {type(result).__name__}")
        index = 0
        for value in result:
            if index < skip:
                # replay after worker death: these indices were already
                # sealed (and survive in the owner/store); re-run the
                # generator for its state but do not re-report them
                index += 1
                continue
            rid = ObjectID(protocol.stream_index_id(seed, index))
            payload = self._serialize_result(value, rid)
            self._stream_report(task_id_b, seed, index, rid.binary(),
                                payload, False)
            index += 1
            while cap > 0:
                # producer backpressure: pause until the consumer is
                # within `cap` indices of us (instant probe + sleep keeps
                # SIGINT cancel windows off the data conn)
                _, consumed = self._request(
                    protocol.REQ_STREAM_CREDIT, seed, index)
                if index - consumed < cap:
                    break
                time.sleep(0.005)
        rid = ObjectID(protocol.stream_index_id(seed, index))
        payload = self._serialize_result(protocol._StreamEnd(index), rid)
        self._stream_report(task_id_b, seed, index, rid.binary(),
                            payload, True)
        with self._send_lock:
            # rtpu-lint: disable=L2 — _send_lock serializes task_conn
            # frames (see _send_results); leaf lock
            self.task_conn.send((protocol.MSG_DONE, task_id_b, []))

    def _execute_task_batch(self, tasks):
        """Execute a pipelined batch. The *dispatch* leg is what the batching
        amortizes (one driver→worker message for N tasks, the reference gets
        the same from leased-worker pipelining in NormalTaskSubmitter);
        results are flushed after every task so a finished result is never
        held hostage by a slow successor, and so the driver's completion
        log stays exact for crash recovery (requeue of never-started tasks).
        """
        from ray_tpu_torch.core.config import config

        for entry in tasks:
            task_id_b, fn_id, args_payload, inline_values, return_ids = \
                entry[:5]
            runtime_env = entry[5] if len(entry) > 5 else None
            stream_opts = entry[6] if len(entry) > 6 else None
            if config.testing_kill_worker_prob > 0:
                # Chaos injection (reference: WorkerKillerActor,
                # python/ray/_private/test_utils.py:1597).
                import random

                if random.random() < config.testing_kill_worker_prob:
                    os._exit(1)
            from ray_tpu_torch.core import fault_injection

            if fault_injection.enabled() and fault_injection.fire(
                    "task", fn_id.hex() if fn_id else "") == "exit":
                # deterministic 'task' fault site (env-armed: workers
                # inherit RTPU_FAULT_TASK from the driver)
                os._exit(1)
            self.current_task_id = TaskID(task_id_b)
            saved_env = None
            try:
                # inside the try: a failed package fetch/extract must fail
                # THIS task (and restore any partial state), not kill the
                # worker and drop the rest of the batch
                saved_env = self._apply_runtime_env(runtime_env)
                fn = self._functions[fn_id]
                args, kwargs = self._decode_args(args_payload, inline_values)
                self._enter_task_code(task_id_b)
                result = fn(*args, **kwargs)
                if stream_opts is not None:
                    self._run_stream(task_id_b, result, stream_opts)
                    self.interruptible = False
                else:
                    self.interruptible = False
                    self._send_results(task_id_b, result, len(return_ids),
                                       return_ids)
            except BaseException as e:  # noqa: BLE001
                self.interruptible = False
                self._send_error(task_id_b, e)
            finally:
                _re_restore(saved_env)
                self.current_task_id = None

    def _enter_task_code(self, task_id_b: bytes) -> None:
        """From here until the task's own code returns, a cancel SIGINT
        raises KeyboardInterrupt in it. One that landed before was held
        (``sigint_pending``): the driver sends one when a task cancelled
        while batched behind another becomes the head of this worker's
        batch, and it may land while the previous task sends its results
        or before this one starts. Ask the driver whether this task is the
        cancelled one (SIGINT blocked meanwhile, so none interrupts the
        request) and raise KeyboardInterrupt, the cancellation, if so; a
        stale SIGINT for the task before changes nothing. Pool threads of
        a threaded actor never take a SIGINT, so only the main thread
        asks."""
        import signal

        self.interruptible = True
        if (not self.sigint_pending
                or threading.current_thread() is not threading.main_thread()):
            return
        signal.pthread_sigmask(signal.SIG_BLOCK, {signal.SIGINT})
        try:
            self.sigint_pending = False
            _, cancelled = self._request(protocol.REQ_TASK_CANCELLED,
                                         task_id_b)
        finally:
            signal.pthread_sigmask(signal.SIG_UNBLOCK, {signal.SIGINT})
        if cancelled:
            raise KeyboardInterrupt

    def _apply_runtime_env(self, runtime_env):
        """env_vars + working_dir + py_modules; packages fetched from the
        core over REQ_PKG and cached under RTPU_PKG_DIR. Workers spawned
        FOR a pip env (their interpreter is the venv) skip re-activating
        it — and their env's modules persist across tasks."""
        from ray_tpu_torch.core import runtime_env as _re

        if not runtime_env:
            return None
        return _re.apply(runtime_env, fetch=self._fetch_package,
                         own_pip_key=os.environ.get("RTPU_WORKER_PIP_KEY"))

    def _fetch_package(self, pkg_hash: str):
        _, data = self._request(protocol.REQ_PKG, pkg_hash)
        return data

    def register_package(self, pkg_hash: str, data: bytes) -> None:
        """Upload a package to the core (nested submissions from tasks)."""
        self._request(protocol.REQ_PKG_PUT, pkg_hash, data)

    def kill_actor(self, actor_id: ActorID, no_restart: bool = True):
        """Kill an actor from inside a task/actor (nested lifecycles:
        DAG-mode pipelines own their stage actors)."""
        self._request(protocol.REQ_KILL_ACTOR, actor_id.binary(),
                      no_restart)

    def free_objects(self, oid_bytes_list) -> int:
        """Eager deletion from inside a task/actor — forwarded to the
        owning core over the data conn (reference: internal_api.free is
        routed through the core worker to the owning raylet)."""
        _, n = self._request(protocol.REQ_FREE, list(oid_bytes_list))
        return n

    def prepare_runtime_env(self, runtime_env):
        from ray_tpu_torch.core import runtime_env as _re

        return _re.prepare(self, runtime_env)

    def _send_error(self, task_id_b: bytes, exc: BaseException):
        with self._send_lock:
            # rtpu-lint: disable=L2 — _send_lock serializes frames on
            # task_conn against concurrent _send_results; leaf lock
            self.task_conn.send(
                (protocol.MSG_ERROR, task_id_b, self._error_payload(exc)))

    def _create_actor(self, msg):
        _, actor_id_b, cls_fn_id, args_payload, inline_values, opts = msg
        try:
            cls = self._functions[cls_fn_id]
            args, kwargs = self._decode_args(args_payload, inline_values)
            self.current_actor_id = ActorID(actor_id_b)
            # actor-scoped runtime_env: applied for the actor's lifetime
            # (the worker is dedicated to it)
            self._apply_runtime_env(opts.get("runtime_env"))
            if opts.get("trap_sigterm"):
                # TPU maintenance events arrive as SIGTERM; this actor
                # asked for them as a flag (train.preempted()) instead
                # of sudden death. Installed HERE because actor calls
                # run on pool threads when max_concurrency > 1 and only
                # the main thread (this recv loop) may set signal
                # handlers. Forceful teardown is unaffected: runtime
                # kills escalate to SIGKILL.
                import signal as _signal

                # rtpu-lint: disable=L6 — _create_actor runs on the
                # recv loop, which IS this worker process's main
                # thread (main() dispatches to it directly); pool
                # threads only ever run method bodies, never creation
                _signal.signal(
                    _signal.SIGTERM,
                    lambda signum, frame: self.preempted.set())
            instance = cls(*args, **kwargs)
            self._actors[actor_id_b] = instance
            mc = int(opts.get("max_concurrency") or 1)
            if mc > 1:
                from concurrent.futures import ThreadPoolExecutor

                self._actor_pools[actor_id_b] = ThreadPoolExecutor(
                    max_workers=mc, thread_name_prefix="actor-conc")
            cgs = opts.get("concurrency_groups") or {}
            if cgs:
                from concurrent.futures import ThreadPoolExecutor

                self._actor_group_pools[actor_id_b] = {
                    name: ThreadPoolExecutor(
                        max_workers=int(limit),
                        thread_name_prefix=f"actor-cg-{name}")
                    for name, limit in cgs.items()}
                self._actor_method_group[actor_id_b] = {
                    m: mo["concurrency_group"]
                    for m, mo in (opts.get("method_opts") or {}).items()
                    if mo.get("concurrency_group")}
                # the DEFAULT group gets its own executor too, so a long
                # ungrouped call can never block the recv loop from
                # feeding the named groups (reference: the default group
                # is just another concurrency group)
                if actor_id_b not in self._actor_pools:
                    self._actor_pools[actor_id_b] = ThreadPoolExecutor(
                        max_workers=mc, thread_name_prefix="actor-conc")
            if opts.get("has_async_methods"):
                import asyncio

                self._actor_loops[actor_id_b] = asyncio.new_event_loop()
            self.task_conn.send((protocol.MSG_ACTOR_READY, actor_id_b))
        except BaseException as e:  # noqa: BLE001
            err = TaskError(e, traceback.format_exc())
            self.task_conn.send(
                (protocol.MSG_ACTOR_ERROR, actor_id_b,
                 protocol.serialize_value(protocol.ErrorValue(err), store=None))
            )

    def _execute_actor_call(self, msg):
        (_, task_id_b, actor_id_b, method, args_payload, inline_values,
         return_ids) = msg[:7]
        stream_opts = msg[7] if len(msg) > 7 else None
        from ray_tpu_torch.core import fault_injection

        kill_after = False
        if fault_injection.enabled():
            # deterministic 'actor_worker_kill' site (env-armed: the
            # worker inherits RTPU_FAULT_ACTOR_WORKER_KILL): 'exit' dies
            # before the method runs (a pure in-flight kill); 'exit_after'
            # runs the method and seals its results, then dies before the
            # DONE report flushes — the owner must adopt the sealed
            # results instead of re-executing the side effect
            act = fault_injection.fire(
                "actor_worker_kill",
                f"{ActorID(actor_id_b).hex()}:{method}")
            if act == "exit":
                os._exit(1)
            kill_after = act == "exit_after"
        self.current_task_id = TaskID(task_id_b)
        self.current_actor_id = ActorID(actor_id_b)
        try:
            instance = self._actors[actor_id_b]
            if method == "__rtpu_dag_start__":
                # compiled-DAG resident loop (ray_tpu_torch/dag): not a
                # method of the user class — the worker hosts the loop
                # thread
                fn = lambda in_d, out_d, m: self._dag_start(  # noqa: E731
                    instance, in_d, out_d, m)
            elif method == "__rtpu_dag_devinfo__":
                # compile-time placement probe: (pid, is_gpu). Device
                # edges require both stages in ONE process (tensors pass
                # by reference), so the compiler compares pids.
                fn = self._dag_devinfo
            else:
                fn = getattr(instance, method)
            args, kwargs = self._decode_args(args_payload, inline_values)
            self._enter_task_code(task_id_b)
            result = fn(*args, **kwargs)
            if hasattr(result, "__await__"):
                import asyncio

                if actor_id_b in self._actor_pools:
                    loop = getattr(self._ctx_tls, "loop", None)
                    if loop is None:
                        loop = self._ctx_tls.loop = asyncio.new_event_loop()
                else:
                    loop = self._actor_loops.get(actor_id_b)
                    if loop is None:
                        loop = asyncio.new_event_loop()
                        self._actor_loops[actor_id_b] = loop
                result = loop.run_until_complete(result)
            if stream_opts is None:
                self.interruptible = False
            if kill_after and stream_opts is None:
                # seal the results exactly as _send_results would, then
                # die without reporting: the sealed containers are the
                # evidence the owner's adoption path recovers from
                values = self._split_returns(result, len(return_ids))
                for value, rid in zip(values, return_ids):
                    self._serialize_result(value, ObjectID(rid))
                os._exit(1)
            if stream_opts is not None:
                self._run_stream(task_id_b, result, stream_opts)
                self.interruptible = False
            else:
                self._send_results(task_id_b, result, len(return_ids),
                                   return_ids)
        except BaseException as e:  # noqa: BLE001
            self.interruptible = False
            self._send_error(task_id_b, e)
        finally:
            self.current_task_id = None


def _re_restore(saved):
    from ray_tpu_torch.core import runtime_env as _re

    _re.restore(saved)


def _prepare_args_local(core: WorkerCore, args: tuple, kwargs: dict):
    """Worker-side arg prep for nested submissions: top-level refs become
    _TopLevelDep markers; the driver re-resolves them (it owns all objects).
    Returns (args_payload, dep_oid_bytes_list)."""
    deps: List[bytes] = []

    def swap(v):
        if isinstance(v, ObjectRef):
            deps.append(v.binary())
            return _TopLevelDep(v.binary())
        return v

    args = tuple(swap(a) for a in args)
    kwargs = {k: swap(v) for k, v in kwargs.items()}
    payload, nested = protocol.serialize_args(args, kwargs, store=core.store)
    return payload, deps, [r.binary() for r in nested]


def main():
    from ray_tpu_torch.core.config import config

    if config.fault_dump_after_s > 0:
        # Debug aid: dump all thread stacks after N seconds (hang triage).
        import faulthandler
        faulthandler.dump_traceback_later(
            config.fault_dump_after_s,
            file=open(os.path.join(tempfile.gettempdir(),
                                   f"rtpt_worker_dump_{os.getpid()}.txt"),
                      "w"))
    address = os.environ["RTPU_ADDRESS"]
    if address.startswith("@"):  # the driver's abstract-namespace socket
        address = "\0" + address[1:]
    authkey = bytes.fromhex(os.environ["RTPU_AUTH"])
    store_name = os.environ.get("RTPU_STORE", "")
    node_id = NodeID.from_hex(os.environ["RTPU_NODE_ID"])
    worker_id = WorkerID.from_hex(os.environ["RTPU_WORKER_ID"])

    task_conn = Client(address, authkey=authkey)
    task_conn.send(("hello", "task", worker_id.binary()))
    data_conn = Client(address, authkey=authkey)
    data_conn.send(("hello", "data", worker_id.binary()))

    store = ShmObjectStore.connect(store_name) if store_name else None
    core = WorkerCore(task_conn, data_conn, store, node_id, worker_id)
    runtime_context.set_core(core)

    # Cancellation SIGINT (ray.cancel force=False) must only interrupt a
    # task's own code; landing between tasks (e.g. blocked in recv), or
    # while a finished task sends its results, it would otherwise kill the
    # whole worker and its batched neighbours, or fail the finished task.
    # One that lands there is held: the next task asks the driver whether
    # it is the cancelled one (_enter_task_code). The first raise ends the
    # window, so a second SIGINT cannot interrupt the error report.
    import signal

    def _on_sigint(signum, frame):
        if core.interruptible:
            core.interruptible = False
            raise KeyboardInterrupt
        core.sigint_pending = True

    signal.signal(signal.SIGINT, _on_sigint)

    # Live profiling hook (reference role: the dashboard's py-spy stack
    # endpoint, reporter_agent.py): SIGUSR1 dumps every thread's Python
    # stack — with the CURRENT task id for attribution — to a well-known
    # file the driver collects. The handler runs between bytecodes, so a
    # busy worker can be profiled without stopping it.
    def _on_sigusr1(signum, frame):
        import sys as _sys
        import traceback as _tb

        from ray_tpu_torch.core.proc_stats import stack_dump_path

        path = stack_dump_path(os.getpid())
        try:
            # tmp + rename: the collector polls the final path and must
            # never observe a partial write
            with open(path + ".tmp", "w") as f:
                f.write(f"pid {os.getpid()} task="
                        f"{core.current_task_id} actor="
                        f"{core.current_actor_id}\n")
                for tid, fr in _sys._current_frames().items():
                    f.write(f"\n--- thread {tid} ---\n")
                    f.write("".join(_tb.format_stack(fr)))
            os.replace(path + ".tmp", path)
        # rtpu-lint: disable=L4 — signal-handler profiling hook: a failed
        # stack dump (disk full, frames mutating underneath) must never
        # kill the worker it is inspecting
        except Exception:  # noqa: BLE001 — profiling must never kill
            pass

    signal.signal(signal.SIGUSR1, _on_sigusr1)
    try:
        core.run_loop()
    finally:
        if store is not None:
            store.close()


def zygote_main():
    """Pre-warmed worker template: fork new workers in milliseconds.

    Answers the reference's prestarted-worker pool
    (src/ray/raylet/worker_pool.h:344 PrestartWorkers, prestarted idle
    pool at :163): instead of keeping N idle full processes around, keep
    ONE warm template whose fork is ~10 ms — interpreter start and module
    imports (the ~300 ms that made actor launch slow) are paid once.
    Forked children share the template's pages copy-on-write, so a fleet
    of workers is also cheaper in RSS than N separate interpreters.

    Protocol (runtime -> zygote over stdin, replies on stdout)::

        {"wid": hex, "env": {...}, "out": path|null, "err": path|null}\\n
        -> "<pid>\\n"

    The zygote runs NO threads and holds NO locks at fork time; children
    reset signal handlers, apply their env, redirect stdio, and enter the
    normal ``main()``. EOF on stdin (runtime gone) exits the zygote;
    SIGCHLD is ignored so the kernel auto-reaps dead children.
    """
    import json
    import signal

    signal.signal(signal.SIGCHLD, signal.SIG_IGN)
    # warm everything main() touches before the first fork
    import ray_tpu_torch.api  # noqa: F401
    from ray_tpu_torch.core.config import config  # noqa: F401

    stdin = sys.stdin.buffer if hasattr(sys.stdin, "buffer") else sys.stdin
    stdout = sys.stdout
    print("ZYGOTE_READY", flush=True)
    for line in stdin:
        line = line.strip()
        if not line:
            continue
        try:
            req = json.loads(line)
        except ValueError:
            continue  # garbage on stdin: ignore, keep serving forks
        pid = os.fork()
        if pid == 0:
            # ---- child: become a normal worker ----
            try:
                signal.signal(signal.SIGCHLD, signal.SIG_DFL)
                os.environ.update(req.get("env") or {})
                os.environ["RTPU_WORKER_ID"] = req["wid"]
                # same non-TPU sanitization the cold-spawn path applies
                # AFTER merging extra_env: zygote children are always
                # plain CPU workers, so a user runtime_env must not drag
                # in TPU/PJRT registration (shared rules: worker_env.py)
                from ray_tpu_torch.core.worker_env import sanitize_cpu_worker_env

                sanitize_cpu_worker_env(os.environ)
                devnull = os.open(os.devnull, os.O_RDONLY)
                os.dup2(devnull, 0)
                os.close(devnull)
                for path, fd in ((req.get("err"), 2), (req.get("out"), 1)):
                    if path:
                        f = os.open(path,
                                    os.O_WRONLY | os.O_CREAT | os.O_APPEND)
                        os.dup2(f, fd)
                        os.close(f)
                if not req.get("out"):
                    # NEVER leave fd 1 on the zygote's protocol pipe — a
                    # worker print would corrupt fork replies. No log
                    # path -> route stdout alongside stderr.
                    os.dup2(2, 1)
                main()
            except BaseException:  # noqa: BLE001
                traceback.print_exc()
            finally:
                os._exit(0)
        stdout.write(f"{pid}\n")
        stdout.flush()


if __name__ == "__main__":
    main()
