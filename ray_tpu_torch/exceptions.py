"""User-facing exceptions (reference: python/ray/exceptions.py)."""

from __future__ import annotations

from ray_tpu_torch.core.cluster.rpc import RpcError as _RpcError


class RayTpuError(Exception):
    """Base class for all framework errors."""


class TaskError(RayTpuError):
    """A task raised an exception during execution.

    Re-raised at ``get`` on the caller, wrapping the remote traceback
    (reference: RayTaskError in python/ray/exceptions.py).
    """

    def __init__(self, cause: BaseException, remote_traceback: str = ""):
        self.cause = cause
        self.remote_traceback = remote_traceback
        super().__init__(f"{type(cause).__name__}: {cause}\n{remote_traceback}")


class ActorError(RayTpuError):
    pass


class ActorDiedError(ActorError):
    """The actor is dead: it crashed, was killed, or exhausted restarts.

    When the runtime knows more than the bare fact, the structured
    fields carry it (and are appended to the message, so the context
    survives pickling across processes): ``cause`` is the terminal
    death reason, ``restarts_consumed`` how many of the actor's
    ``max_restarts`` budget were spent, and ``incarnation`` which
    incarnation (0 = the original process) failed.
    """

    def __init__(self, message: str = "", cause: str = "",
                 restarts_consumed=None, incarnation=None):
        self.cause = cause
        self.restarts_consumed = restarts_consumed
        self.incarnation = incarnation
        detail = []
        if cause:
            detail.append(f"cause: {cause}")
        if restarts_consumed is not None:
            detail.append(f"restarts consumed: {restarts_consumed}")
        if incarnation is not None:
            detail.append(f"failing incarnation: {incarnation}")
        if detail:
            message += " (" + "; ".join(detail) + ")"
        super().__init__(message)


class ActorUnavailableError(ActorError):
    """The actor is temporarily unreachable: its worker died and a
    restart is underway, but the call could not be buffered — the
    RESTARTING queue is past ``actor_restart_buffer_max``, or the
    restart has been running longer than ``actor_restart_timeout_s``.
    Unlike ``ActorDiedError`` the actor may come back; callers may
    retry later."""


class GcsUnavailableError(RayTpuError, _RpcError):
    """The head node (GCS) is temporarily unreachable: it died or is
    mid-restart, and the call could not be buffered past the ride-through
    window — more than ``gcs_op_buffer_max`` calls are already parked, the
    outage outlasted ``gcs_reconnect_timeout_s``, or the op is not on the
    retry-after-apply whitelist and its reply was lost (blind replay could
    run the side effect twice). Unlike a node death this is usually
    transient: a restarted GCS recovers its state from snapshot+WAL and
    the cluster resyncs, so callers may retry later. Mirrors
    ``ActorUnavailableError`` semantics at the cluster level; subclasses
    the transport ``RpcError`` so existing best-effort handlers keep
    treating it as a connectivity failure."""


class StaleGcsEpochError(RayTpuError, _RpcError):
    """A write from a fenced (stale) GCS incarnation was rejected.

    Split-brain guard: every GCS incarnation carries a monotonic
    ``epoch_seq`` (persisted counter, stamped on heartbeat replies and
    ``gcs_info``), and nodes remember the highest value they have seen.
    A GCS-originated write (actor restart, reap) carrying a LOWER seq
    than the receiver has observed is the signature of a
    partitioned-but-alive old head still trying to mutate the cluster —
    the node rejects it with this error, and the stale head fences
    itself on seeing the rejection (stops restarts, death-marking, and
    table writes). Structured fields survive pickling via
    ``__reduce__``: ``stale_seq`` is the writer's epoch_seq,
    ``current_seq`` the newest the rejecting side has seen. Subclasses
    the transport ``RpcError`` so best-effort ``except RpcError``
    handlers treat a fenced head like an unreachable one.
    """

    def __init__(self, message: str = "", stale_seq: int = 0,
                 current_seq: int = 0):
        self.stale_seq = int(stale_seq)
        self.current_seq = int(current_seq)
        self._message = message or "stale GCS incarnation fenced"
        super().__init__(
            f"{self._message} (writer epoch_seq {self.stale_seq} < "
            f"newest seen {self.current_seq})")

    def __reduce__(self):
        # rebuild from the original fields: default exception pickling
        # would re-call __init__ with the composed message, doubling
        # the suffix and zeroing the structured fields
        return (type(self), (self._message, self.stale_seq,
                             self.current_seq))


class BackpressureError(RayTpuError):
    """The serving plane rejected (shed) the request under overload.

    Raised at ADMISSION by the router — before any replica work starts —
    when the deployment's queue depth exceeds the priority class's share
    of ``max_queue_depth``, or when the TTFT estimate says the request's
    deadline cannot be met; and mid-flight when a request's deadline
    expires (the stream is closed and the engine request cancelled).
    Structured fields survive pickling across processes via
    ``__reduce__``: ``deployment`` names the shedding deployment,
    ``queue_depth`` the router-local depth at rejection,
    ``estimated_wait_s`` the TTFT-EWMA-based wait estimate, and
    ``retry_after_s`` a client hint (the HTTP proxy maps this error to
    429 with a ``Retry-After`` header)."""

    def __init__(self, message: str = "", deployment: str = "",
                 queue_depth: int = 0, estimated_wait_s: float = 0.0,
                 retry_after_s: float = 1.0):
        self.deployment = deployment
        self.queue_depth = int(queue_depth)
        self.estimated_wait_s = float(estimated_wait_s)
        self.retry_after_s = float(retry_after_s)
        self._message = message
        detail = []
        if deployment:
            detail.append(f"deployment: {deployment!r}")
        detail.append(f"queue depth: {self.queue_depth}")
        detail.append(f"estimated wait: {self.estimated_wait_s:.3f}s")
        detail.append(f"retry after: {self.retry_after_s:.3f}s")
        super().__init__((message or "request shed under overload")
                         + " (" + "; ".join(detail) + ")")

    def __reduce__(self):
        # default exception pickling re-calls __init__ with the COMPOSED
        # message as args[0], doubling the detail suffix and zeroing the
        # structured fields — rebuild from the originals instead
        return (type(self), (self._message, self.deployment,
                             self.queue_depth, self.estimated_wait_s,
                             self.retry_after_s))


class ReplicaUnavailableError(RayTpuError):
    """No running replica could serve a deployment's request: none
    appeared within the router's wait window (``serve_replica_wait_s``
    — deleted, never deployed, or every replica down/restarting), or
    the request's replay budget ran out across replica deaths. Unlike
    ``BackpressureError`` this is not load-dependent — retrying sooner
    will not help until the control plane brings replicas back. The HTTP
    proxy maps it to 503.

    ``attempts`` counts the dispatch attempts the router spent before
    giving up (0 when no replica was ever picked) and ``last_cause``
    carries the final attempt's error (usually ActorDiedError), so
    callers can distinguish "never had a replica" from "replicas kept
    dying under the request"."""

    def __init__(self, message: str = "", deployment: str = "",
                 attempts: int = 0, last_cause=None):
        self.deployment = deployment
        self.attempts = int(attempts)
        self.last_cause = last_cause
        if not message:
            if self.attempts:
                message = (
                    f"request to deployment {deployment!r} failed after "
                    f"{self.attempts} attempt(s)")
                if last_cause is not None:
                    message += f"; last cause: {last_cause!r}"
            else:
                message = (
                    f"no running replicas for deployment {deployment!r}"
                    if deployment else "no running replicas")
        self._message = message
        super().__init__(message)

    def __reduce__(self):
        # rebuild from the original fields (not the composed message) so
        # a pickle round-trip neither doubles the suffix nor drops the
        # structured attempt count / cause
        return (type(self), (self._message, self.deployment,
                             self.attempts, self.last_cause))


class GetTimeoutError(RayTpuError, TimeoutError):
    """``get`` did not complete within the requested timeout."""


class ObjectLostError(RayTpuError):
    """The object's value was lost and could not be reconstructed.

    Task returns are normally recomputed transparently from lineage (up
    to ``config.max_reconstructions`` attempts); this error surfaces only
    for unrecoverable objects — ``ray_tpu_torch.put`` values, eagerly freed
    ids, lineage-evicted entries — or once the reconstruction budget is
    exhausted. When the producing task is known, ``task_id`` carries its
    hex id and ``attempts`` the reconstruction history (one string per
    attempt, e.g. why it was retried or why it stopped).
    """

    def __init__(self, message: str = "", task_id: str = "",
                 attempts=None):
        self.task_id = task_id
        self.attempts = list(attempts or [])
        if task_id:
            message += f" (producing task {task_id}"
            if self.attempts:
                message += ("; reconstruction attempts: "
                            + "; ".join(self.attempts))
            message += ")"
        super().__init__(message)


class WorkerCrashedError(RayTpuError):
    """The worker executing the task died unexpectedly."""


class TaskCancelledError(RayTpuError):
    """The task was cancelled via ``ray_tpu_torch.cancel()`` before completing
    (reference: TaskCancelledError in python/ray/exceptions.py)."""


class RuntimeNotInitializedError(RayTpuError):
    """An API call was made before ``ray_tpu_torch.init()``."""


class ObjectStoreFullError(RayTpuError):
    """Allocation failed after eviction: the object store is out of memory."""


class ObjectTimeoutError(RayTpuError, TimeoutError):
    """A store-level blocking get did not complete in time."""


class PlacementGroupError(RayTpuError):
    pass


class OutOfMemoryError(TaskError):
    """A task's worker was killed by the node memory monitor and the
    task is out of OOM retries (reference: ray.exceptions.OutOfMemoryError
    raised by the worker-killing policy, memory_monitor.h:52)."""
