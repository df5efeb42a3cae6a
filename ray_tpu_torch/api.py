"""Top-level public API: init/shutdown/remote/get/put/wait/kill.

The port's copy of ``ray_tpu/api.py`` (itself mirroring the reference
framework's python/ray/_private/worker.py — ray.init :1227, ray.get
:2578, ray.put :2693, ray.wait :2758, ray.kill :2939) on the port's
single-node runtime, with GPUs as a resource (``num_gpus`` on actors).
``init(address="host:port")`` connects to a cluster's GCS
(``core/cluster/``) and ``init("ray://host:port")`` to a thin-client
proxy (``client.py``).
"""

from __future__ import annotations

import atexit
import os
from typing import Any, List, Optional, Sequence, Tuple, Union

from ray_tpu_torch.core import runtime_context
from ray_tpu_torch.core.actor import ActorClass, ActorHandle, get_actor  # noqa: F401
from ray_tpu_torch.core.object_ref import ObjectRef
from ray_tpu_torch.core.remote_function import RemoteFunction

_runtime = None


def init(num_workers: Optional[int] = None,
         object_store_memory: Optional[int] = None,
         ignore_reinit_error: bool = True,
         address: Optional[str] = None,
         log_to_driver: Optional[bool] = None,
         **kwargs):
    """Start the local runtime (worker pool + shm object store), or connect
    to a running cluster when ``address="host:port"`` names its GCS
    (reference: ray.init(address=...), python/ray/_private/worker.py:1227),
    or to a thin-client proxy when it is ``"ray://host:port"``.

    Returns the runtime context. Safe to call twice with
    ``ignore_reinit_error`` (the default).
    """
    global _runtime
    if runtime_context.is_initialized():
        if ignore_reinit_error:
            return runtime_context.get_runtime_context()
        raise RuntimeError("ray_tpu_torch.init() called twice")
    if address is None:
        # submitted jobs inherit the cluster address from the job agent
        address = os.environ.get("RTPU_ADDRESS")
    if address and address.startswith("ray://"):
        # thin-client mode through the multi-tenant proxy (reference:
        # ray.init("ray://...") -> util/client; see client.py)
        from ray_tpu_torch.client import ProxyCore

        host, _, port = address[len("ray://"):].rpartition(":")
        _runtime = ProxyCore((host, int(port)))
    elif address:
        from ray_tpu_torch.core.cluster.cluster_core import ClusterCore

        host, _, port = address.rpartition(":")
        _runtime = ClusterCore((host, int(port)))
    else:
        from ray_tpu_torch.core.runtime import Runtime

        _runtime = Runtime(num_workers=num_workers,
                           object_store_memory=object_store_memory,
                           log_to_driver=log_to_driver)
    runtime_context.set_core(_runtime)
    atexit.register(shutdown)
    return runtime_context.get_runtime_context()


def is_initialized() -> bool:
    return runtime_context.is_initialized()


def shutdown():
    global _runtime
    if _runtime is not None:
        _runtime.shutdown()
        _runtime = None
    if runtime_context.get_core_or_none() is not None:
        runtime_context.set_core(None)


def remote(*args, **options):
    """Decorator converting a function into a RemoteFunction or a class into
    an ActorClass (reference: python/ray/_private/worker.py ray.remote)."""

    def decorate(obj):
        if isinstance(obj, type):
            return ActorClass(obj, options)
        if callable(obj):
            return RemoteFunction(obj, options)
        raise TypeError("@remote requires a function or class")

    if len(args) == 1 and not options and (callable(args[0]) or isinstance(args[0], type)):
        return decorate(args[0])
    if args:
        raise TypeError("@remote takes keyword options only, e.g. @remote(num_cpus=2)")
    return decorate


def get(refs: Union[ObjectRef, Sequence[ObjectRef]],
        timeout: Optional[float] = None) -> Any:
    """Block until object(s) are available and return the value(s)."""
    core = runtime_context.get_core()
    if isinstance(refs, ObjectRef):
        return core.get_objects([refs], timeout=timeout)[0]
    refs = list(refs)
    for r in refs:
        if not isinstance(r, ObjectRef):
            raise TypeError(f"get() expects ObjectRefs, got {type(r).__name__}")
    if not refs:
        return []
    return core.get_objects(refs, timeout=timeout)


def put(value: Any) -> ObjectRef:
    """Store a value in the object store and return a ref."""
    core = runtime_context.get_core()
    return core.put_object(value)


def wait(refs: Sequence[ObjectRef], *, num_returns: int = 1,
         timeout: Optional[float] = None
         ) -> Tuple[List[ObjectRef], List[ObjectRef]]:
    """Wait until ``num_returns`` of ``refs`` are ready."""
    core = runtime_context.get_core()
    refs = list(refs)
    return core.wait(refs, num_returns=num_returns, timeout=timeout)


def kill(actor: ActorHandle, *, no_restart: bool = True):
    """Forcibly terminate an actor (reference: ray.kill, worker.py:2939).

    With ``no_restart=True`` (the default) the death is terminal: pending
    and future calls fail with ``ActorDiedError`` and the restart spec is
    dropped so nothing resurrects the actor. With ``no_restart=False``
    the kill behaves exactly like a worker crash: it consumes one unit of
    the actor's ``max_restarts`` budget and, if budget remains, the actor
    restarts — in-flight calls with ``max_task_retries`` left replay
    against the new incarnation and calls submitted meanwhile buffer
    through the RESTARTING window."""
    core = runtime_context.get_core()
    core.kill_actor(actor.actor_id, no_restart=no_restart)


def cancel(ref: ObjectRef, *, force: bool = False, recursive: bool = True):
    """Cancel the task that produces ``ref`` (reference: ray.cancel,
    worker.py:2970). Queued tasks are dropped; executing tasks are
    interrupted (force=False) or their worker killed (force=True). The
    caller sees TaskCancelledError at ``get``. Accepts an
    ``ObjectRefGenerator`` to cancel a ``num_returns="streaming"`` task
    mid-stream (the consumer's next ref raises, then the stream ends).
    ``recursive`` is accepted for API parity; child-task cancellation
    follows worker death."""
    del recursive
    core = runtime_context.get_core()
    from ray_tpu_torch.core.ids import ObjectID
    from ray_tpu_torch.core.object_ref import ObjectRefGenerator

    if isinstance(ref, ObjectRefGenerator):
        ref = ObjectRef(ObjectID(ref.seed), core=core)
    core.cancel_task(ref, force=force)


def free(refs, *, local_only: bool = False) -> int:
    """Eagerly delete objects from the store (reference:
    ray._private.internal_api.free). Complements the pin+spill lifetime
    model when the caller knows an object is dead: storage (shm or spill
    file) is reclaimed immediately, the id's lineage entry is
    invalidated, and subsequent ``get``s raise ObjectLostError — free
    means dead, reconstruction is never attempted for a freed id.

    That makes ``free`` the exception to the recovery rule: objects a
    TASK produced that are lost to LRU eviction, a missing/corrupt spill
    file, or worker death are otherwise transparently recomputed from
    recorded lineage (resubmitting the producing task, recursively
    rebuilding lost upstream deps) up to ``max_reconstructions``
    attempts per object. Not recoverable — ``get`` raises
    ObjectLostError naming the producing task and the attempt history
    where one exists: ``ray_tpu_torch.put`` objects (no producing task),
    freed ids, and ids whose lineage was evicted past the
    ``lineage_max_bytes`` budget. Deterministic loss for tests is
    injected via ``ray_tpu_torch.core.fault_injection`` (``RTPU_FAULT_<SITE>``
    env vars or the ``fault_injection`` config flag).

    Returns the number of objects actually freed. ``local_only`` is
    accepted for API parity (deletion always covers the owning core)."""
    del local_only
    if isinstance(refs, ObjectRef):
        refs = [refs]
    core = runtime_context.get_core()
    return core.free_objects([r.binary() for r in refs])


def timeline(filename: Optional[str] = None):
    """Export recorded task events as a chrome://tracing trace (reference:
    ray.timeline, python/ray/_private/worker.py). Requires the
    RTPU_TASK_EVENTS_ENABLED=1 flag; returns the event list when no
    filename is given."""
    import json

    core = runtime_context.get_core()
    events = getattr(core, "_events", None)
    if events is None and hasattr(core, "_cluster_view"):
        # cluster driver: aggregate every node's flag-gated event log
        # (reference: ray.timeline merges per-raylet task events)
        from ray_tpu_torch.core.cluster.rpc import RpcClient, RpcError

        events = None
        for idx, n in enumerate(core._cluster_view(force=True)["nodes"]):
            # dedicated short-timeout client: a freshly-dead node must
            # cost ~2s, not the pooled client's full 10s connect retry
            client = RpcClient(tuple(n["address"]), core._authkey,
                               connect_timeout=2.0)
            try:
                node_events = client.call(("task_events",))
            except RpcError:
                continue
            finally:
                client.close()
            if node_events is None:
                continue  # recording disabled on that node
            events = events if events is not None else []
            nid = n["node_id"].hex()[:6] if hasattr(
                n["node_id"], "hex") else str(n["node_id"])[:6]
            for e in node_events:
                # composite pid: same OS pid on different hosts must not
                # merge into one chrome-trace process row
                events.append({**e, "worker": f"{nid}:{e['worker']}",
                               "pid": idx * (1 << 23) + int(e["pid"] or 0)})
    if events is None:
        raise RuntimeError(
            "task events are disabled; set RTPU_TASK_EVENTS_ENABLED=1 "
            "before init()")
    trace = [{
        "name": e["fn"],
        "cat": "actor_task" if e["actor"] else "task",
        "ph": "X",
        "ts": e["dispatched"] * 1e6,
        "dur": max(0.0, (e["done"] - e["dispatched"]) * 1e6),
        "pid": e["pid"],
        "tid": e["worker"],
        "args": {"task_id": e["task_id"],
                 "parent_task_id": e.get("parent_task_id"),
                 "queued_ms": round(max(
                     0.0, (e["dispatched"] - e.get("submitted",
                                                   e["dispatched"]))
                 ) * 1e3, 3)},
    } for e in events]
    if filename is None:
        return trace
    with open(filename, "w") as f:
        json.dump(trace, f)
    return filename


def method(**opts):
    """Decorator for actor methods to set options (num_returns)."""

    def wrap(fn):
        fn.__rtpu_method_opts__ = opts
        return fn

    return wrap
