"""Driver-side runtime: object directory, worker pool, and task scheduler.

Single-node analogue of the reference's driver CoreWorker + raylet + GCS
rolled into the driver process (the multi-node split arrives with the cluster
control plane):

- Object directory + memory store: the ownership table. The driver owns every
  object; small values live inline here, large values in the shm store
  (reference: src/ray/core_worker/store_provider/memory_store/memory_store.h,
  reference ownership model: src/ray/core_worker/reference_count.h:61).
- Worker pool: forks/pools worker processes, tracks idle/busy, restarts
  actors (reference: src/ray/raylet/worker_pool.h:153).
- Scheduler: FIFO dispatch of ready tasks (deps resolved) onto idle workers;
  per-actor ordered queues (reference: raylet local_task_manager.cc dispatch
  loop + actor_task_submitter.h ordering).
"""

from __future__ import annotations

import os
import queue
import signal
import subprocess
import sys
import tempfile
import threading
import time
from collections import OrderedDict, deque
from multiprocessing.connection import Listener
from typing import Any, Callable, Dict, List, Optional, Tuple

from ray_tpu_torch.core import external_storage, fault_injection, protocol, \
    serialization
from ray_tpu_torch.core.config import config
from ray_tpu_torch.core.ids import (
    ActorID, JobID, NodeID, ObjectID, PlacementGroupID, TaskID, WorkerID,
    make_task_id,
)
from ray_tpu_torch.core.object_ref import ObjectRef
from ray_tpu_torch.core import runtime_context
from ray_tpu_torch.core.object_store.store import ShmObjectStore, default_store_capacity
from ray_tpu_torch.core.placement_group import (
    PlacementGroup, PlacementGroupState,
)
from ray_tpu_torch.core.protocol import _TopLevelDep
from ray_tpu_torch.core.resources import (
    GpuSet, ResourceSet, node_resources,
)
from ray_tpu_torch.util.debug_lock import check_fire_outside, make_condition, \
    make_lock
from ray_tpu_torch.exceptions import (
    ActorDiedError, ActorUnavailableError, GetTimeoutError, ObjectLostError,
    PlacementGroupError, TaskCancelledError, TaskError, WorkerCrashedError,
)


def note_freed(freed: Dict[bytes, None], ids, cap: int = 1_000_000) -> None:
    """Record eager-free tombstones (20B ids kept only so get-after-free
    errors fast instead of hanging). Past ``cap``, evict oldest-first —
    the dict is insertion-ordered — degrading a year-late get of an
    ancient freed id to a hang-with-timeout, which is acceptable. Shared
    by Runtime and ClusterCore (call under the owner's lock)."""
    for b in ids:
        freed[b] = None
    if len(freed) > cap:
        from itertools import islice

        for b in list(islice(iter(freed), len(freed) - cap // 2)):
            del freed[b]


class _ObjectEntry:
    __slots__ = ("event", "payload", "callbacks")

    def __init__(self):
        self.event = threading.Event()
        self.payload = None  # protocol.Payload once ready
        self.callbacks: List[Callable[[], None]] = []


class _Lineage:
    """Resubmittable description of a task, kept per return id so a lost
    object can be recomputed (reference: object_recovery_manager.h +
    task_manager lineage pinning). One instance is shared by all of the
    task's return ids; ``holders`` counts the table entries still
    pointing at it so the retained args container (shm payloads stay
    pinned for replay) releases exactly once."""

    __slots__ = ("task_id_hex", "fn_id", "args_payload", "deps_b",
                 "nested_b", "return_ids_b", "options", "cost", "holders",
                 "args_pinned")

    def __init__(self):
        self.args_pinned = False


class _DepsLost(Exception):
    """Raised by dependency inlining when a dep's backing value vanished
    between resolution and dispatch; carries the lost oid bytes."""

    def __init__(self, oids: List[bytes]):
        super().__init__(f"{len(oids)} task dependencies lost")
        self.oids = oids


def _task_env_key(options) -> Optional[str]:
    """Key of the isolated env a task/actor is pinned to ("<kind>:<content
    hash>"), or None. Tasks with the same key share a worker pool AND an
    env build; the kind's EnvProvider (runtime_env.register_env_provider
    — pip built-in, conda/image_uri pluggable) supplies the interpreter
    the pool's workers run."""
    renv = (options or {}).get("runtime_env") or {}
    from ray_tpu_torch.core.runtime_env import resolve_env_provider

    res = resolve_env_provider(renv)
    if res is None:
        return None
    kind, provider, spec = res
    key = provider.env_key(spec)
    if not key:
        return None
    return f"{kind}:{key}"


class _TaskSpec:
    __slots__ = (
        "task_id", "fn_id", "args_payload", "deps", "return_ids", "options",
        "actor_id", "method", "pending_deps", "request", "pg_wire",
        "acquired_bundle", "blocked_released", "nested_deps", "cancelled",
        "retries_left", "args_pinned", "dep_pins", "submitted_ts",
        "dispatched_ts", "parent_task", "oom_kills", "env_key", "stream",
        "seq",
    )

    def __init__(self, task_id, fn_id, args_payload, deps, return_ids, options,
                 actor_id=None, method=None):
        self.task_id = task_id
        self.fn_id = fn_id
        self.args_payload = args_payload
        self.deps = deps
        self.return_ids = return_ids
        self.options = options
        self.actor_id = actor_id
        self.method = method
        self.pending_deps = 0
        # Resource accounting (filled by Runtime._prepare_request).
        self.request: Optional[ResourceSet] = None
        self.pg_wire = None          # ("pg", pg_id_bytes, bundle_index) | None
        self.acquired_bundle = None  # Bundle the request was drawn from
        self.blocked_released = False  # resources credited back while blocked
        # ObjectIDs referenced *inside* arg containers (not top-level args).
        # They are NOT scheduling dependencies (reference semantics: nested
        # refs pass through unresolved), but while unavailable the task must
        # ship alone — batched behind it, its producer could never run.
        self.nested_deps: List = []
        self.cancelled = False
        # Worker-crash retry budget (reference: max_retries,
        # src/ray/core_worker/task_manager.h:208); resolved at enqueue.
        self.retries_left: Optional[int] = None
        # memory-monitor kills survived so far (OOM retries are budgeted
        # separately from crash retries — reference: task_oom_retries)
        self.oom_kills = 0
        self.args_pinned = False
        # Real store refs taken at dispatch on shm dep containers, so spill
        # can never pull a dep out from under a worker mid-read.
        self.dep_pins: List[bytes] = []
        # timeline timestamps (recorded when task_events_enabled)
        self.submitted_ts = 0.0
        self.dispatched_ts = 0.0
        # cross-process span propagation: the submitting task's id (hex)
        # for nested submissions, None for driver-originated work
        # (reference: tracing_helper.py's trace-context injection)
        self.parent_task: Optional[str] = None
        # pip-env tasks dispatch only to workers running that env's own
        # interpreter (per-env pools — true module-version isolation)
        self.env_key: Optional[str] = _task_env_key(options)
        # num_returns="streaming": {"seed": bytes, "skip": int, "cap": int}
        # shipped to the worker so it seals yields under deterministic
        # per-index ids; None for ordinary tasks
        self.stream: Optional[dict] = None
        # Actor calls only: position in the actor's per-submission order
        # (assigned at enqueue); the actor's completion watermark keys off
        # it so a replayed already-completed call is served from the
        # store, never re-executed.
        self.seq: Optional[int] = None


class _StreamState:
    """Owner-side bookkeeping for one ``num_returns="streaming"`` task
    (reference: the per-generator ObjectRefStream in
    core_worker/task_manager.h). Index ids are deterministic
    (protocol.stream_index_id), so only counters live here:

    - ``produced``: indices sealed and reported so far (their entries are
      resolvable); the consumer may hand out refs below this watermark.
    - ``consumed``: the consumer's advance watermark — the producer's
      REQ_STREAM_CREDIT probe blocks it at ``produced - consumed >= cap``.
    - ``end_index``: total yield count once the end sentinel (or a
      mid-stream failure ref) lands; None while the stream is live.
    """

    __slots__ = ("seed", "cap", "produced", "consumed", "end_index",
                 "failed", "cond")

    def __init__(self, seed: bytes, cap: int):
        self.seed = seed
        self.cap = cap
        self.produced = 0
        self.consumed = 0
        self.end_index: Optional[int] = None
        self.failed = False
        self.cond = make_condition("_StreamState.cond")


def _fd_readable(fd, timeout) -> bool:
    """poll()-based readiness (select() raises ValueError for fds past
    FD_SETSIZE=1024 — long-lived runtimes exceed it)."""
    import select

    p = select.poll()
    p.register(fd, select.POLLIN | select.POLLERR | select.POLLHUP)
    import math

    # ceil, not truncate: selectors.py does the same so a 0.5ms wait
    # doesn't degrade to a non-blocking poll
    ms = None if timeout is None else max(0, math.ceil(timeout * 1000))
    return bool(p.poll(ms))


# Connections the driver's socket queues before its accept loop takes
# them. Cold-spawned workers connect at once, two connections each; at
# Listener's default of 1 a burst overflows the queue, and where a full
# queue refuses a connect (gVisor: EAGAIN, as Linux does for a
# non-blocking one) the worker dies before its hello.
LISTEN_BACKLOG = 128


# The reference's TPU option: this package schedules GPUs only.
NUM_TPUS_REFUSED = ("num_tpus: ray_tpu_torch schedules GPUs, not TPUs; "
                    "ask for num_gpus=N")


def listen(path: str) -> Listener:
    """The driver's AF_UNIX listener on ``path``."""
    return Listener(path, family="AF_UNIX", backlog=LISTEN_BACKLOG)


def _pidfd_supported() -> bool:
    """Whether this kernel gives ``os.pidfd_open``, which ``_ForkedProc``
    needs to watch a zygote fork."""
    try:
        os.close(os.pidfd_open(os.getpid()))
    except (AttributeError, OSError):
        return False
    return True


class _ForkedProc:
    """Popen-compatible handle for a worker forked by the zygote.

    The child is the ZYGOTE's child (kernel-reaped there via SIG_IGN),
    so Popen's wait machinery doesn't apply. Liveness and signaling go
    through a pidfd: the fd names the exact process, so a recycled pid
    can never be misread as the worker still alive, nor signaled by
    mistake (a bare signal-0 probe has both hazards). Matches the subset
    of the Popen surface the runtime uses (pid/poll/terminate/kill/
    wait)."""

    __slots__ = ("pid", "returncode", "_pidfd")

    def __init__(self, pid: int):
        self.pid = pid
        self.returncode = None
        try:
            self._pidfd = os.pidfd_open(pid)
        except OSError:
            # already gone (or no pidfd support): treat as exited —
            # never fall back to pid probing, it can alias a recycled pid
            self._pidfd = None
            self.returncode = -1

    def poll(self):
        if self.returncode is not None:
            return self.returncode
        if _fd_readable(self._pidfd, 0):
            # pidfd becomes readable when the process exits
            self.returncode = -1
            os.close(self._pidfd)
            self._pidfd = None
        return self.returncode

    def _signal(self, sig):
        if self._pidfd is None:
            return
        try:
            signal.pidfd_send_signal(self._pidfd, sig)
        except (OSError, ProcessLookupError):
            pass

    def terminate(self):
        self._signal(signal.SIGTERM)

    def kill(self):
        self._signal(signal.SIGKILL)

    def wait(self, timeout=None):
        if self.returncode is not None:
            return self.returncode
        if not _fd_readable(self._pidfd, timeout):
            raise subprocess.TimeoutExpired("forked-worker", timeout)
        self.returncode = -1
        os.close(self._pidfd)
        self._pidfd = None
        return self.returncode


class _Worker:
    __slots__ = (
        "worker_id", "proc", "task_conn", "data_conn", "ready", "alive",
        "registered_fns", "actor_id", "inflight", "reader", "data_thread",
        "send_lock", "blocked", "oom_killed", "env_key",
    )

    def __init__(self, worker_id, proc):
        self.worker_id = worker_id
        self.proc = proc
        # pip-env workers run the env's OWN interpreter (per-env pools,
        # reference: raylet/worker_pool.h:153 env-keyed pools); None =
        # the general pool
        self.env_key: Optional[str] = None
        self.task_conn = None
        self.data_conn = None
        self.ready = False
        self.alive = True
        self.registered_fns = set()
        self.actor_id: Optional[ActorID] = None
        self.inflight: Dict[bytes, _TaskSpec] = {}
        self.reader: Optional[threading.Thread] = None
        self.data_thread: Optional[threading.Thread] = None
        # Connection.send is not thread-safe; every task_conn.send goes
        # through this lock (reader thread, dispatchers, shutdown).
        self.send_lock = make_lock("_Worker.send_lock")
        # True while the worker is blocked in a driver-side get/wait; used
        # by the scheduler to oversubscribe the pool instead of deadlocking.
        self.blocked = False
        # set by the memory monitor just before SIGKILL: death handling
        # then applies OOM retry semantics instead of crash semantics
        self.oom_killed = False


class _ActorState:
    __slots__ = (
        "actor_id", "worker", "cls_fn_id", "creation_args_payload",
        "creation_deps", "opts", "queue", "ready", "dead", "death_cause",
        "restarts_left", "name", "creation_event", "request", "pg_wire",
        "acquired_bundle", "gpu_ids", "resources_acquired", "capacity",
        "restarting", "restarting_since", "incarnation", "next_seq",
        "seq_watermark", "completed_seqs", "migrated",
    )

    def __init__(self, actor_id, cls_fn_id, args_payload, deps, opts):
        self.actor_id = actor_id
        self.worker: Optional[_Worker] = None
        self.cls_fn_id = cls_fn_id
        self.creation_args_payload = args_payload
        self.creation_deps = deps
        self.opts = opts
        # in-flight call budget the driver may keep on the worker: the
        # default pool plus every named concurrency group's threads
        # (reference: concurrency_group_manager.h:34 — per-group limits)
        self.capacity = max(1, int(opts.get("max_concurrency") or 1)) + \
            sum(int(v) for v in
                (opts.get("concurrency_groups") or {}).values())
        self.queue: deque = deque()
        self.ready = False
        self.dead = False
        self.death_cause: Optional[BaseException] = None
        self.restarts_left = opts.get("max_restarts", 0)
        self.name = opts.get("name")
        self.creation_event = threading.Event()
        self.request: Optional[ResourceSet] = None
        self.pg_wire = None
        self.acquired_bundle = None
        self.gpu_ids: List[str] = []
        self.resources_acquired = False
        # Restart FSM (reference: gcs_actor_manager.h:278 ALIVE ->
        # RESTARTING -> ALIVE|DEAD): while restarting, new calls buffer
        # (bounded by actor_restart_buffer_max / actor_restart_timeout_s)
        # and queued+in-flight calls replay to the next incarnation.
        self.restarting = False
        self.restarting_since = 0.0
        self.incarnation = 0
        # Per-actor call sequencing for exactly-once result delivery:
        # every call gets the next seq at enqueue; completion advances a
        # contiguous watermark (out-of-order completions park in
        # completed_seqs) so replays of finished calls are recognized.
        self.next_seq = 0
        self.seq_watermark = 0
        self.completed_seqs: set = set()
        # set by evict_actor (planned drain): the actor is dead HERE but
        # lives on elsewhere — reject racing calls at submit instead of
        # failing their results, so callers re-route
        self.migrated = False


def _reap_stale_shm_arenas():
    """Unlink /dev/shm arenas left by DEAD runtimes (reference: the
    raylet cleans stale plasma files on startup). A SIGKILLed node
    can't unlink its own arena; the name embeds the creator pid, so a
    dead pid means garbage. Unlinking is safe even if some zombie
    still maps the file — the mapping stays valid, only the name goes.
    Only this package's ``rtpt_`` arenas are swept: ``ray_tpu``'s
    ``rtpu_`` ones belong to the other runtime, which may run beside
    this one.
    """
    try:
        names = os.listdir("/dev/shm")
    except OSError:
        return
    for name in names:
        if not name.startswith("rtpt_"):
            continue
        parts = name.split("_")
        try:
            pid = int(parts[1])
        except (IndexError, ValueError):
            continue
        try:
            os.kill(pid, 0)  # alive (or EPERM: someone else's — keep)
            continue
        except ProcessLookupError:
            pass
        except OSError:
            continue
        try:
            os.unlink(os.path.join("/dev/shm", name))
        except OSError:
            pass


class Runtime:
    """The driver core client. One per driver process."""

    def __init__(self, num_workers: Optional[int] = None,
                 object_store_memory: Optional[int] = None,
                 session_name: Optional[str] = None,
                 gpus: Optional[GpuSet] = None,
                 log_to_driver: Optional[bool] = None):
        self.node_id = NodeID.from_random()
        self.worker_id = WorkerID.from_random()
        self.job_id = JobID.from_random()
        self.num_workers = num_workers or max(2, (os.cpu_count() or 4))
        # "rtpt_": sessions, sockets and shm arenas of this package never
        # share a name (or a stale-arena sweep) with ray_tpu's "rtpu_"
        self._session = session_name or f"rtpt_{os.getpid()}_{self.node_id.hex()[:8]}"
        self._session_dir = os.path.join(tempfile.gettempdir(), self._session)
        # an AF_UNIX path holds at most 107 bytes: under a longer TMPDIR
        # the socket binds in the abstract namespace (no file), which the
        # workers' RTPU_ADDRESS spells with "@" for the leading NUL
        sock = self._session_dir + ".sock"
        self._sock_path = (sock if len(sock.encode()) < 108
                           else "\0" + self._session)
        self._authkey = os.urandom(16)

        _reap_stale_shm_arenas()
        self.store = ShmObjectStore.create(
            "/" + self._session,
            object_store_memory or default_store_capacity(),
        )
        self.store.need_space_hook = self._try_free_space
        self._spill_dir = external_storage.spill_dir_for(
            config.spill_dir
            or os.path.join(tempfile.gettempdir(), "rtpt_spill"),
            self._session)

        self._lock = make_lock("Runtime._lock")
        self._objects: Dict[ObjectID, _ObjectEntry] = {}
        # Memory management: the runtime pins every tracked shm container so
        # the LRU can never evict a live object out from under a ref; under
        # pressure, cold pinned containers are spilled to disk instead
        # (reference: local_object_manager.h spilling + pinning).
        self._spill_lock = make_lock("Runtime._spill_lock")
        self._pinned: Dict[bytes, int] = {}       # container oid -> access seq
        self._pin_seq = 0
        self._args_pins: Dict[bytes, int] = {}    # in-flight args refcounts
        self._spilled_bytes = 0
        # task lifecycle events for ray_tpu_torch.timeline() (bounded; flag-gated)
        self._events: Optional[List[dict]] = (
            [] if config.task_events_enabled else None)
        self._functions: Dict[bytes, bytes] = {}  # fn_id -> pickled
        self._fn_cache: Dict[int, Tuple[bytes, bytes]] = {}  # id(fn) -> (fn_id, pickled)
        self._workers: Dict[WorkerID, _Worker] = {}
        self._idle: deque = deque()
        # per-pip-env worker pools (reference: worker_pool.h env-keyed
        # pools): env tasks dispatch only to these; spawned on demand
        # with the venv's own interpreter
        self._env_idle: Dict[str, deque] = {}
        self._env_queue: Dict[str, deque] = {}
        self._env_spawning: Dict[str, int] = {}
        # consecutive pre-READY deaths per env (a broken env must fail
        # its tasks after a few respawns, not crash-loop forever)
        self._env_spawn_fails: Dict[str, int] = {}
        self._task_queue: deque = deque()
        self._actors: Dict[ActorID, _ActorState] = {}
        self._named_actors: Dict[str, ActorID] = {}
        self._kv: Dict[str, Any] = {}
        # single-node mirror of the GCS pubsub plane (bounded per-channel
        # event logs with contiguous seqs; see gcs.py _op_publish/_op_poll)
        self._channels: Dict[str, list] = {}
        self._channel_seq: Dict[str, int] = {}
        self._pubsub_cond = make_condition("Runtime._pubsub_cond")
        self._packages: Dict[str, bytes] = {}  # runtime_env package store
        # eagerly-freed object ids: insertion-ordered so the tombstone cap
        # evicts oldest-first (dict preserves insertion order)
        self._freed: Dict[bytes, None] = {}
        # Lineage reconstruction (reference: object_recovery_manager.h):
        # per-return-id task descriptions, byte-bounded by
        # config.lineage_max_bytes (oldest-evicted); lost task returns
        # are recomputed by resubmitting the recorded task, up to
        # config.max_reconstructions attempts per object. ray.put and
        # freed objects are never recorded/recovered.
        self._lineage: "OrderedDict[bytes, _Lineage]" = OrderedDict()
        self._lineage_bytes = 0
        self._reconstructions: Dict[bytes, int] = {}
        self._recon_history: Dict[bytes, List[str]] = {}
        # return ids with a reconstruction resubmission in flight (their
        # entries are reset: event cleared, payload None)
        self._recovering: Dict[bytes, None] = {}
        # First-return-id -> spec, for ray.cancel lookup; entries drop when
        # the task finishes (done/error/cancel paths).
        self._cancellable: Dict[bytes, _TaskSpec] = {}
        # seed (first-return-id) -> _StreamState for every
        # num_returns="streaming" task submitted through this owner
        self._streams: Dict[bytes, _StreamState] = {}
        self._shutdown = False
        self._spawning = 0
        # Pool workers stolen by actors and not yet replaced. Replacement
        # is DEMAND-driven (reference: worker_pool.h prestart-on-backlog,
        # inverted): an actor-creation burst pays zero replacement forks;
        # the first queued task that finds the pool empty triggers one.
        self._pool_deficit = 0

        # Resource model: CPU slots == pool size; GPUs from the node's
        # device ids (detected or injected for tests).
        self.gpus = gpus if gpus is not None else GpuSet.detect()
        self._total = ResourceSet(node_resources(
            num_cpus=self.num_workers, gpus=self.gpus,
        ))
        self._avail = ResourceSet(self._total.to_dict())
        self._pgs: Dict[PlacementGroupID, PlacementGroupState] = {}
        self._pending_pgs: List[PlacementGroupState] = []
        self._pending_actors: List[_ActorState] = []
        self._pg_ready_waiters: Dict[PlacementGroupID, List[ObjectID]] = {}

        # per-session worker log capture + driver streaming (reference:
        # session/logs + log_monitor.py)
        self.log_dir = os.path.join(self._session_dir, "logs")
        os.makedirs(self.log_dir, exist_ok=True)
        self._log_monitor = None
        if log_to_driver if log_to_driver is not None else config.log_to_driver:
            from ray_tpu_torch.core.log_monitor import LogMonitor

            self._log_monitor = LogMonitor(
                self.log_dir,
                interval_s=config.log_monitor_interval_s).start()

        # no authkey on the listener: the HMAC handshake runs bounded in
        # a per-connection thread (a child dying mid-handshake must not
        # wedge the accept loop — see rpc._timed_handshake)
        self._listener = listen(self._sock_path)
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True, name="rtpu-accept"
        )
        self._accept_thread.start()
        # zygote: pre-warmed fork template for ~10ms worker launch
        # (reference: prestarted workers, raylet/worker_pool.h:344)
        self._zygote: Optional[subprocess.Popen] = None
        self._zygote_lock = make_lock("Runtime._zygote_lock")
        # a fork is the zygote's child, watched only through a pidfd
        # (_ForkedProc): a kernel without pidfd_open (a sandboxing
        # kernel can lack it) would see every fork as dead at once, so
        # such a host cold-spawns every worker
        if config.worker_zygote and _pidfd_supported():
            try:
                with self._zygote_lock:
                    self._start_zygote_locked()
            except Exception:  # noqa: BLE001 — fall back to cold spawns
                self._zygote = None
        for _ in range(self.num_workers):
            self._spawn_worker()

        # serialized actor-start lane (see _actor_spawner_loop)
        self._actor_start_queue: "queue.Queue" = queue.Queue()
        threading.Thread(target=self._actor_spawner_loop, daemon=True,
                         name="rtpu-actor-spawner").start()

        # memory monitor + OOM kill policy (reference:
        # memory_monitor.h:52, worker_killing_policy_group_by_owner.h)
        self._oom_kill_count = 0
        if config.memory_monitor_enabled:
            threading.Thread(target=self._memory_monitor_loop,
                             daemon=True, name="rtpu-memmon").start()

    # ------------------------------------------------------------------ pool

    def _pool_env(self, gpu: bool,
                  extra_env: Optional[Dict[str, str]]) -> Dict[str, str]:
        env = dict(os.environ)
        env.update(
            RTPU_ADDRESS=self._sock_path.replace("\0", "@", 1),
            RTPU_AUTH=self._authkey.hex(),
            RTPU_STORE="/" + self._session,
            RTPU_PKG_DIR=os.path.join(self._session_dir, "packages"),
            RTPU_NODE_ID=self.node_id.hex(),
            RTPU_OWNER_PID=str(os.getpid()),
        )
        # every worker (cold-spawned, the zygote, a venv interpreter)
        # runs ``-m ray_tpu_torch.core.worker_main`` and must find the
        # package where this driver found it, whatever its working
        # directory: pin the package's parent onto PYTHONPATH
        import ray_tpu_torch as _pkg

        repo_root = os.path.dirname(
            os.path.dirname(os.path.abspath(_pkg.__file__)))
        pp = env.get("PYTHONPATH", "")
        if repo_root not in pp.split(os.pathsep):
            env["PYTHONPATH"] = (repo_root + os.pathsep + pp
                                 if pp else repo_root)
        if extra_env:
            env.update(extra_env)
        if not gpu:
            # Plain pool workers never see a card (no CUDA context on
            # it); workers that land GPU actors (num_gpus>0) get their
            # ids in extra_env. Shared with the zygote fork path — see
            # worker_env.py.
            from ray_tpu_torch.core.worker_env import sanitize_cpu_worker_env

            sanitize_cpu_worker_env(env)
        return env

    def _start_zygote_locked(self):
        # bufsize=0: replies are read through poll(), which must never
        # be defeated by data parked in a userspace buffer
        self._zygote = subprocess.Popen(
            [sys.executable, "-m", "ray_tpu_torch.core.worker_main", "--zygote"],
            env=self._pool_env(gpu=False, extra_env=None),
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, bufsize=0,
            stderr=open(os.path.join(self.log_dir, "zygote.err"), "ab",
                        buffering=0),
        )
        self._zygote_ready = False

    def _fork_from_zygote(self, worker_id: WorkerID,
                          extra_env: Optional[Dict[str, str]],
                          out_path: Optional[str],
                          err_path: Optional[str]) -> Optional[int]:
        """Ask the zygote for a forked worker; returns the pid or None
        (zygote unavailable — caller cold-spawns)."""
        import json

        with self._zygote_lock:
            z = self._zygote
            if z is None or z.poll() is not None:
                if self._shutdown:
                    return None
                try:
                    self._start_zygote_locked()
                    z = self._zygote
                except Exception:  # noqa: BLE001
                    self._zygote = None
                    return None
            try:
                if not self._zygote_ready:
                    # first use: wait for the warm-import banner
                    if not _fd_readable(z.stdout, 30.0) or \
                            b"ZYGOTE_READY" not in z.stdout.readline():
                        raise RuntimeError("zygote never became ready")
                    self._zygote_ready = True
                req = {"wid": worker_id.hex(), "env": extra_env or {},
                       "out": out_path, "err": err_path}
                z.stdin.write((json.dumps(req) + "\n").encode())
                z.stdin.flush()
                if not _fd_readable(z.stdout, 30.0):
                    raise RuntimeError("zygote fork timed out")
                return int(z.stdout.readline())
            except Exception:  # noqa: BLE001 — zygote wedged: drop it
                try:
                    z.kill()
                except OSError:
                    pass
                self._zygote = None
                return None

    def _spawn_worker(self, gpu: bool = False,
                      extra_env: Optional[Dict[str, str]] = None,
                      python_exe: Optional[str] = None,
                      env_key: Optional[str] = None) -> _Worker:
        worker_id = WorkerID.from_random()
        if env_key is not None:
            # the worker knows its own env so per-task application can
            # skip re-activating it (its interpreter IS the env)
            extra_env = dict(extra_env or {})
            extra_env["RTPU_WORKER_PIP_KEY"] = env_key
        out_path = err_path = None
        if config.worker_log_redirect:
            from ray_tpu_torch.core.log_monitor import worker_log_paths

            out_path, err_path = worker_log_paths(self.log_dir,
                                                  worker_id.hex())
        w = _Worker(worker_id, None)
        w.env_key = env_key
        # registered BEFORE the process exists: a zygote fork connects and
        # says hello within a millisecond, possibly before this thread
        # runs again (a loaded host), and _register_conn drops the
        # connection of an id it does not know: the worker then dies
        # sending MSG_READY
        with self._lock:
            self._workers[worker_id] = w
            self._spawning += 1
        try:
            w.proc = self._launch(worker_id, gpu, extra_env, python_exe,
                                  out_path, err_path)
        except BaseException:
            with self._lock:
                self._workers.pop(worker_id, None)
                self._spawning -= 1
            raise
        # a worker that dies (or wedges) BEFORE connecting has no reader
        # thread to observe its death: without this watcher it would leak
        # self._spawning forever and close the dispatch/scale-up gates
        # (env pools additionally need the death to drive their
        # crash-loop bound)
        threading.Thread(target=self._watch_until_ready, args=(w,),
                         daemon=True,
                         name=f"rtpu-spawn-{worker_id.hex()[:6]}").start()
        return w

    def _launch(self, worker_id: WorkerID, gpu: bool,
                extra_env: Optional[Dict[str, str]],
                python_exe: Optional[str], out_path: Optional[str],
                err_path: Optional[str]):
        """Start a worker process: a zygote fork when possible, else a
        cold interpreter. Returns its process handle."""
        proc = None
        with self._zygote_lock:
            warm = self._zygote is not None
        if not gpu and python_exe is None and warm:
            # fast path: fork from the warm template. GPU workers need a
            # fresh interpreter (CUDA reads CUDA_VISIBLE_DEVICES once, when
            # the process first initialises it), so they always
            # cold-spawn.
            pid = self._fork_from_zygote(worker_id, extra_env,
                                         out_path, err_path)
            if pid is not None:
                proc = _ForkedProc(pid)
        if proc is None:
            env = self._pool_env(gpu, extra_env)
            env["RTPU_WORKER_ID"] = worker_id.hex()
            out = err = None
            if out_path is not None:
                out = open(out_path, "ab", buffering=0)
                err = open(err_path, "ab", buffering=0)
            try:
                proc = subprocess.Popen(
                    [python_exe or sys.executable, "-m",
                     "ray_tpu_torch.core.worker_main"],
                    env=env, stdin=subprocess.DEVNULL, stdout=out,
                    stderr=err,
                )
            finally:
                # the child holds its own descriptors after fork/exec
                if out is not None:
                    out.close()
                if err is not None:
                    err.close()
        return proc

    def _watch_until_ready(self, w: _Worker):
        deadline = time.monotonic() + config.worker_ready_timeout_s
        while (not self._shutdown and w.alive and not w.ready
               and time.monotonic() < deadline):
            if w.proc is not None and w.proc.poll() is not None:
                break
            time.sleep(0.05)
        if not self._shutdown and w.alive and not w.ready:
            if w.proc is not None:
                try:
                    w.proc.kill()
                except OSError:
                    pass
            self._on_worker_death(w)

    def _accept_loop(self):
        while not self._shutdown:
            try:
                conn = self._listener.accept()
            except (OSError, EOFError, Exception):
                if self._shutdown:
                    return
                continue
            threading.Thread(target=self._greet_conn, args=(conn,),
                             daemon=True, name="rtpu-greet").start()

    def _greet_conn(self, conn):
        from ray_tpu_torch.core.cluster.rpc import _timed_handshake

        try:
            _timed_handshake(conn, self._authkey, server_side=True)
            hello = conn.recv()
        except Exception:  # noqa: BLE001 — died mid-handshake
            try:
                conn.close()
            except OSError:
                pass
            return
        if hello[0] != "hello":
            conn.close()
            return
        self._register_conn(conn, hello)

    def _register_conn(self, conn, hello):
        _, kind, wid_bytes = hello
        wid = WorkerID(wid_bytes)
        with self._lock:
            w = self._workers.get(wid)
        if w is None:
            conn.close()
            return
        if kind == "task":
            w.task_conn = conn
            w.reader = threading.Thread(
                target=self._worker_reader, args=(w,), daemon=True,
                name=f"rtpu-read-{wid.hex()[:6]}",
            )
            w.reader.start()
        else:
            w.data_conn = conn
            w.data_thread = threading.Thread(
                target=self._data_server, args=(w,), daemon=True,
                name=f"rtpu-data-{wid.hex()[:6]}",
            )
            w.data_thread.start()

    # --------------------------------------------------------- reader threads

    def _worker_reader(self, w: _Worker):
        try:
            while True:
                msg = w.task_conn.recv()
                tag = msg[0]
                if tag == protocol.MSG_READY:
                    with self._lock:
                        w.ready = True
                        self._spawning -= 1
                        if w.env_key is not None:
                            # a successful startup clears the env's
                            # crash-loop strikes: only CONSECUTIVE
                            # pre-ready deaths fail the queue out
                            self._env_spawn_fails.pop(w.env_key, None)
                        # Workers pre-claimed for an actor never join the
                        # general idle pool; env workers join their env's
                        # pool.
                        if w.actor_id is None:
                            if w.env_key is not None:
                                self._env_idle.setdefault(
                                    w.env_key, deque()).append(w)
                            else:
                                self._idle.append(w)
                    if w.env_key is not None:
                        self._dispatch_env(w.env_key)
                    else:
                        self._dispatch()
                elif tag == protocol.MSG_DONE:
                    self._on_task_done(w, msg[1], msg[2])
                elif tag == protocol.MSG_STREAM_YIELD:
                    self._on_stream_yield(w, msg)
                elif tag == protocol.MSG_ERROR:
                    self._on_task_error(w, msg[1], msg[2])
                elif tag == protocol.MSG_ACTOR_READY:
                    self._on_actor_ready(w, ActorID(msg[1]))
                elif tag == protocol.MSG_ACTOR_ERROR:
                    self._on_actor_error(w, ActorID(msg[1]), msg[2])
        except (EOFError, OSError):
            pass
        finally:
            self._on_worker_death(w)

    def _on_worker_death(self, w: _Worker):
        if self._shutdown:
            return
        with self._lock:
            if not w.alive:
                return
            w.alive = False
            # cumulative unexpected-death count: the node server reports
            # it on heartbeats as the per-node task-failure signal the
            # GCS health scorer folds into quarantine decisions
            self._worker_death_count = getattr(
                self, "_worker_death_count", 0) + 1
            if not w.ready:
                # died before MSG_READY: release the spawning slot it
                # held, or scale-up/pool-repay gates stay closed forever
                self._spawning = max(0, self._spawning - 1)
            self._workers.pop(w.worker_id, None)
            try:
                self._idle.remove(w)
            except ValueError:
                pass
            if w.env_key is not None:
                try:
                    self._env_idle.get(w.env_key, deque()).remove(w)
                except ValueError:
                    pass
                if not w.ready:
                    # died before READY: likely a broken env (a pinned
                    # package shadowing a framework dep). Bound respawns
                    # or a crash-looping env would retry forever.
                    n = self._env_spawn_fails.get(w.env_key, 0) + 1
                    self._env_spawn_fails[w.env_key] = n
                else:
                    self._env_spawn_fails.pop(w.env_key, None)
            inflight = list(w.inflight.values())
            w.inflight.clear()
            actor_id = w.actor_id
            oom = w.oom_killed
            if actor_id is not None:
                # detach the dead worker NOW (not in the later restart
                # handling): a concurrent _dispatch_actor must never pop
                # queued calls into a dead worker's inflight table,
                # where they would be lost
                st = self._actors.get(actor_id)
                if st is not None and st.worker is w:
                    st.worker = None
                    st.ready = False
        if inflight:
            # Results flush per task, so inflight = not-yet-completed, in
            # dispatch order. Only the head task can have been executing
            # when the process died; the rest never started and are safe to
            # requeue on another worker. The head itself is retried while
            # its max_retries budget lasts (reference: task_manager.h
            # retries apply to system failures, not app exceptions). OOM
            # kills budget separately: the memory monitor's SIGKILL does
            # not consume max_retries (reference: task_oom_retries) —
            # only the dedicated OOM budget, after which callers see a
            # typed OutOfMemoryError.
            if actor_id is None:
                head = inflight[0]
                if oom and not head.cancelled:
                    head.oom_kills += 1
                    if (config.task_oom_retries < 0
                            or head.oom_kills <= config.task_oom_retries):
                        fail, requeue = [], inflight
                    else:
                        fail, requeue = inflight[:1], inflight[1:]
                elif head.retries_left and not head.cancelled:
                    head.retries_left -= 1
                    fail, requeue = [], inflight
                else:
                    fail, requeue = inflight[:1], inflight[1:]
            else:
                # Actor calls: at-least-once replay (reference:
                # max_task_retries, actor_task_submitter resubmission).
                # Every in-flight call whose retry budget allows it goes
                # back on the actor's queue for the restarted
                # incarnation; a call whose results the dead worker
                # already sealed is adopted straight from the store —
                # exactly-once result delivery, no re-execution.
                fail, requeue = [], []
                for spec in inflight:
                    if spec.cancelled:
                        fail.append(spec)
                    elif self._adopt_sealed_actor_result(spec):
                        pass  # served from the store
                    elif spec.retries_left != 0:
                        if spec.retries_left > 0:
                            spec.retries_left -= 1
                        requeue.append(spec)
                    else:
                        fail.append(spec)
            if oom:
                from ray_tpu_torch.exceptions import OutOfMemoryError

                err = OutOfMemoryError(
                    f"worker {w.worker_id.hex()[:8]} was killed by the "
                    f"node memory monitor (usage above "
                    f"{config.memory_usage_threshold:.0%}) and the task "
                    f"is out of OOM retries")
            elif actor_id is not None:
                st = self._actors.get(actor_id)
                err = ActorDiedError(
                    "the actor's worker process died mid-call and the "
                    "call is out of task retries",
                    incarnation=st.incarnation if st is not None else None)
            else:
                err = WorkerCrashedError(
                    f"worker {w.worker_id.hex()[:8]} died while "
                    f"executing task")
            # Cancelled specs must not come back: report them cancelled
            # whether they were executing or merely batched behind the head.
            fail = fail + [s for s in requeue if s.cancelled]
            requeue = [s for s in requeue if not s.cancelled]
            with self._lock:
                for spec in fail + requeue:
                    # requeued specs re-acquire at dispatch; holding their
                    # old grant would double-count
                    had_request = spec.request is not None
                    self._release_spec_locked(spec)
                    if spec in requeue and had_request:
                        # release nulls the request; rebuild it so dispatch
                        # re-acquires instead of running unaccounted
                        spec.request, spec.pg_wire = self._prepare_request(
                            spec.options, is_actor=False)
            for spec in fail + requeue:
                # dispatch-time dep pins are re-taken at the next dispatch
                self._release_spec_deps(spec)
                # a worker that sealed a return container (retain=True) but
                # died before its DONE message flushed leaves a refcount-1
                # orphan; reclaim it (and clear the id for a retry's write)
                self._reap_orphan_returns(spec)
            for spec in requeue:
                if spec.stream is not None:
                    # generator replay: every index reported so far survives
                    # (shm containers are owner-pinned, inline payloads are
                    # already stored), so the retry re-runs the generator
                    # but re-seals nothing below the produced watermark
                    st = self._streams.get(spec.stream["seed"])
                    if st is not None:
                        with st.cond:
                            spec.stream = dict(spec.stream,
                                               skip=st.produced)
            for spec in fail:
                self._release_spec_args(spec)
                self._store_error(
                    spec.return_ids,
                    TaskCancelledError("task was cancelled")
                    if spec.cancelled else err)
            if requeue:
                with self._lock:
                    if actor_id is not None:
                        # replayed calls rejoin the FRONT of the actor's
                        # queue in dispatch order, ahead of calls that
                        # buffered during the restart window
                        st = self._actors.get(actor_id)
                        if st is not None:
                            st.queue.extendleft(reversed(requeue))
                    else:
                        self._task_queue.extendleft(reversed(requeue))
            self._retry_pending_pgs()
        if actor_id is not None:
            self._handle_actor_worker_death(actor_id)
        elif w.env_key is not None:
            # env pools replace on demand (in _dispatch_env — which also
            # fails the queue out once the env proves crash-looping);
            # never backfill the GENERAL pool for an env worker
            if not self._shutdown:
                self._dispatch_env(w.env_key)
        else:
            # replace pool capacity
            if not self._shutdown:
                self._spawn_worker()
        self._dispatch()

    # ------------------------------------------------------------- functions

    def register_function(self, fn) -> bytes:
        """Pickle a function once; returns its fn_id (content hash).

        The reference exports pickled functions to the GCS function table once
        per job (python/ray/_private/function_manager.py); here the registry
        lives in the driver and is lazily pushed per worker.
        """
        key = id(fn)
        cached = self._fn_cache.get(key)
        if cached is not None and cached[1] is fn:
            return cached[0]
        pickled = serialization.pack(fn)
        import hashlib

        fn_id = hashlib.blake2b(pickled, digest_size=16).digest()
        with self._lock:
            self._functions[fn_id] = pickled
        self._fn_cache[key] = (fn_id, fn)
        return fn_id

    def _send_msg(self, w: _Worker, msg) -> None:
        with w.send_lock:
            # rtpu-lint: disable=L2 — send_lock exists precisely to
            # serialize frames on this worker's task_conn; nothing else
            # is ever taken under it, so it cannot participate in a cycle
            w.task_conn.send(msg)

    def _ensure_fn_on_worker(self, w: _Worker, fn_id: bytes):
        if fn_id not in w.registered_fns:
            with self._lock:
                pickled = self._functions[fn_id]
            self._send_msg(w, (protocol.MSG_REGISTER_FN, fn_id, pickled))
            w.registered_fns.add(fn_id)

    # ------------------------------------------------------------ object dir

    def _entry(self, oid: ObjectID) -> _ObjectEntry:
        with self._lock:
            e = self._objects.get(oid)
            if e is None:
                e = _ObjectEntry()
                if oid.binary() in self._freed:
                    # freed ids keep only a 20-byte tombstone; a get
                    # resurrects this transient error entry instead of
                    # hanging on a value that will never arrive
                    from ray_tpu_torch.exceptions import ObjectLostError

                    e.payload = protocol.serialize_value(
                        protocol.ErrorValue(ObjectLostError(
                            f"object {oid} was freed")), store=None)
                    e.event.set()
                self._objects[oid] = e
            return e

    def _store_payload(self, oid: ObjectID, payload: protocol.Payload):
        e = self._entry(oid)
        # The event-set + callback-swap must happen under the same lock the
        # registration sites use for their check-and-append, or a registration
        # can land on the dead list after the swap (lost wakeup).
        with self._lock:
            e.payload = payload
            e.event.set()
            self._recovering.pop(oid.binary(), None)
            callbacks, e.callbacks = e.callbacks, []
        # Pin tracked shm containers against LRU eviction (spill handles
        # pressure). Only self-named containers (container id == entry id)
        # are spill candidates; that is every put/task-return container.
        if payload[0] == "shm" and payload[1] == oid.binary():
            self._pin_container(payload[1])
        # Foreign callables (dep-ready continuations, as_future
        # resolvers): must dispatch with no runtime lock held — a
        # callback that re-enters the runtime deadlocks the holder
        # (the PR 5 _enqueue bug). Sanitizer-enforced when armed.
        check_fire_outside("Runtime._store_payload")
        for cb in callbacks:
            cb()

    # ------------------------------------------------------ pinning + spill

    def _pin_container(self, oid_b: bytes):
        """Adopt the retained creator reference of a container as this
        owner's tracking pin (the handoff protocol: every task-return/put
        container is sealed with retain=True, so it arrives refcount>=1 and
        there is never an evictable window)."""
        with self._spill_lock:
            self._pin_seq += 1
            self._pinned[oid_b] = self._pin_seq  # insert or LRU-touch

    def _pin_args(self, oid_b: bytes):
        """Adopt the retained ref of an args container for a task's flight
        time (refcounted: actor restarts re-pin the same container)."""
        with self._spill_lock:
            n = self._args_pins.get(oid_b, 0)
            self._args_pins[oid_b] = n + 1
        if n:
            # extra pins beyond the adopted creator ref take a real one
            try:
                self.store.get(ObjectID(oid_b), timeout_ms=0)
            # rtpu-lint: disable=L4 — best-effort extra pin: if the
            # container already left the store (evicted/spilled), the
            # task's dependency resolution recovers it anyway
            except Exception:  # noqa: BLE001
                pass

    def _unpin_args(self, oid_b: bytes, delete: bool = True):
        # Symmetric with _pin_args: every pin holds one ref (the first
        # adopts the retained creator ref, later ones took real refs), so
        # every unpin releases one; the last also deletes.
        with self._spill_lock:
            n = self._args_pins.get(oid_b, 0) - 1
            if n > 0:
                self._args_pins[oid_b] = n
            else:
                self._args_pins.pop(oid_b, None)
        oid = ObjectID(oid_b)
        try:
            self.store.release(oid)
            if n <= 0 and delete:
                self.store.delete(oid)
        # rtpu-lint: disable=L4 — the container may have been spilled,
        # freed, or the store closed mid-shutdown; all mean the pin is
        # already moot
        except Exception:  # noqa: BLE001
            pass

    def _pin_spec_args(self, spec: _TaskSpec):
        p = spec.args_payload
        if p is not None and p[0] == "shm" and not spec.args_pinned:
            spec.args_pinned = True
            self._pin_args(p[1])

    def _release_spec_args(self, spec: _TaskSpec):
        # Only task/actor-CALL specs pass through here; actor CREATION
        # payloads live in _ActorState (kept pinned for restarts).
        p = spec.args_payload
        if spec.args_pinned and p is not None and p[0] == "shm":
            spec.args_pinned = False
            self._unpin_args(p[1])

    def free_objects(self, oid_bytes_list: List[bytes],
                     return_ids: bool = False):
        """Eagerly delete objects (reference: internal_api.free) —
        complements the pin+spill lifetime model for workloads that know
        an object is dead. Unresolved ids are skipped; subsequent gets of
        a freed id surface ObjectLostError, and the id's lineage entry is
        invalidated so reconstruction is never attempted (free means
        dead). Returns the count actually freed."""
        from ray_tpu_torch.exceptions import ObjectLostError

        freed_ids: List[bytes] = []
        for oid_b in oid_bytes_list:
            oid = ObjectID(oid_b)
            with self._lock:
                e = self._objects.get(oid)
                if (e is None or not e.event.is_set()
                        or oid_b in self._freed):
                    continue
                note_freed(self._freed, (oid_b,))
                payload = e.payload
            kind, data = payload
            if kind == "shm":
                with self._spill_lock:
                    pinned = self._pinned.pop(oid_b, None) is not None
                if pinned:
                    try:
                        self.store.release(oid)
                        self.store.delete(oid)
                    # rtpu-lint: disable=L4 — already evicted or store
                    # closed: either way the object is gone, which is
                    # what free() wants
                    except Exception:  # noqa: BLE001
                        pass
                else:
                    # the pressure-spill thread won the pin: the payload
                    # may have flipped shm->spilled after our read —
                    # re-read so the spill file is reclaimed, not leaked
                    with self._lock:
                        e2 = self._objects.get(oid)
                        payload = e2.payload if e2 is not None else payload
                    kind, data = payload
            if kind == "spilled":
                path = data[0] if isinstance(data, tuple) else data
                external_storage.delete(path)
                if isinstance(data, tuple):
                    with self._spill_lock:
                        self._spilled_bytes -= data[1]
            # drop the table entry entirely: periodic fire-and-forget
            # callers (e.g. load reports) can then free their refs
            # without the object table growing; the _freed tombstone
            # keeps later gets erroring instead of hanging
            with self._lock:
                e = self._objects.pop(oid, None)
                unresolved = e is not None and not e.event.is_set()
                if unresolved:
                    # concurrent waiters on a just-freed id: re-insert so
                    # _store_error below resolves them with the error
                    self._objects[oid] = e
            if unresolved:
                self._store_error(
                    [oid], ObjectLostError(f"object {oid} was freed"))
            self._cancellable.pop(oid_b, None)
            self._drop_lineage(oid_b)
            freed_ids.append(oid_b)
        return freed_ids if return_ids else len(freed_ids)

    def _try_free_space(self, nbytes: int) -> bool:
        """Spill cold tracked containers to disk until ``nbytes`` are freed.
        Called by the store's pressure hook (driver-side) and by workers via
        REQ_NEED_SPACE. Returns True when anything was spilled."""
        with self._spill_lock:
            candidates = sorted(self._pinned.items(), key=lambda kv: kv[1])
        freed = 0
        for oid_b, _ in candidates:
            if freed >= nbytes:
                break
            freed += self._spill_one(oid_b)
        return freed > 0

    def _spill_one(self, oid_b: bytes) -> int:
        oid = ObjectID(oid_b)
        # Safe to spill only when our tracking pin is the sole reference —
        # a reader's zero-copy view must never lose its backing pages.
        if self.store.refcount(oid) != 1:
            return 0
        try:
            view = self.store.get(oid, timeout_ms=0)
        except Exception:  # noqa: BLE001
            return 0
        try:
            try:
                path, size = external_storage.write(self._spill_dir,
                                                    oid.hex(), view)
            except Exception:  # noqa: BLE001 — transient backend error
                # (s3 hiccup etc.): skip this candidate; the caller's
                # put must see store pressure, never a raw fsspec error
                return 0
        finally:
            del view
            try:
                self.store.release(oid)  # the read pin just taken
            # rtpu-lint: disable=L4 — pin release on a store that may be
            # closing; failing to release cannot be worse than raising
            # out of the spill path
            except Exception:  # noqa: BLE001
                pass
        with self._lock:
            e = self._objects.get(oid)
            swapped = (e is not None and e.payload == ("shm", oid_b)
                       and oid_b not in self._freed)
            if swapped:
                e.payload = ("spilled", (path, size))
        if not swapped:
            # a concurrent free() won (payload is now a freed-error marker
            # or gone): discard the file we just wrote — accounting it
            # would leak disk and inflate _spilled_bytes forever
            external_storage.delete(path)
            return 0
        with self._spill_lock:
            self._pinned.pop(oid_b, None)
            self._spilled_bytes += size
        try:
            self.store.release(oid)  # the tracking pin
            self.store.delete(oid)
        # rtpu-lint: disable=L4 — the shm copy just became redundant
        # (payload points at the spill file); if reclaim races a close
        # or eviction the copy is gone anyway
        except Exception:  # noqa: BLE001
            pass
        if fault_injection.enabled():
            # 'spill' fault site: lose the file the moment the payload
            # moved to disk (torn write / reclaimed scratch volume)
            action = fault_injection.fire("spill", oid.hex())
            if action == "delete":
                external_storage.delete(path)
            elif action == "corrupt":
                external_storage.corrupt(path)
        return size

    def _store_error(self, oids: List[ObjectID], err: BaseException):
        payload = protocol.serialize_value(protocol.ErrorValue(err), store=None)
        for oid in oids:
            self._cancellable.pop(oid.binary(), None)
            st = self._streams.get(oid.binary())
            if st is not None:
                # A streaming task's seed id is never resolved directly;
                # surface the failure as the stream's final ref instead
                # (the consumer's next() hands it out, its get() raises,
                # then the iterator ends).
                self._fail_stream(st, payload)
            else:
                self._store_payload(oid, payload)

    # ------------------------------------------------------ streaming returns

    def _register_stream(self, seed: bytes) -> "_StreamState":
        st = _StreamState(seed, int(config.streaming_generator_backpressure))
        with self._lock:
            self._streams[seed] = st
        return st

    def _stream_opts(self, seed: bytes) -> dict:
        """Wire dict shipped to the worker alongside the task."""
        return {"seed": seed, "skip": 0,
                "cap": int(config.streaming_generator_backpressure)}

    def _on_stream_yield(self, w: "_Worker", msg):
        """MSG_STREAM_YIELD: one streamed return sealed by the worker.
        Adopt the payload under its deterministic index id and advance the
        produced watermark so blocked ``next()`` calls wake."""
        _, task_id_b, seed, index, rid_b, payload, is_end = msg
        st = self._streams.get(seed)
        self._store_payload(ObjectID(rid_b), payload)
        if st is None:
            return  # stream unknown (late report after shutdown/reap)
        with st.cond:
            if is_end:
                if st.end_index is None:
                    st.end_index = index
            elif index >= st.produced:
                st.produced = index + 1
            st.cond.notify_all()

    def _fail_stream(self, st: "_StreamState", err_payload):
        """Terminate a stream with an error: seal the payload at the next
        unproduced index (consumers blocked there wake and get a ref whose
        get() raises) and end the stream right after it. A stream that
        already ended normally is left untouched."""
        with st.cond:
            if st.end_index is not None:
                return
            idx = st.produced
            st.produced = idx + 1
            st.end_index = idx + 1
            st.failed = True
            st.cond.notify_all()
        self._store_payload(
            ObjectID(protocol.stream_index_id(st.seed, idx)), err_payload)

    def stream_next(self, seed: bytes, index: int,
                    timeout: Optional[float] = None, owner=None):
        """Blocking driver-side next for ObjectRefGenerator: returns
        ("ref", rid_bytes) once index is produced or ("end", count) once
        the stream ended before it. ``owner`` is a cluster-path routing
        hint; a single-node runtime owns every stream it knows."""
        from ray_tpu_torch.exceptions import ObjectTimeoutError

        st = self._streams.get(seed)
        if st is None:
            raise ValueError(f"unknown stream {seed.hex()}")
        deadline = None if timeout is None else time.monotonic() + timeout
        with st.cond:
            while True:
                kind = self._stream_poll_locked(st, index)
                if kind is not None:
                    return kind
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                if remaining is not None and remaining <= 0:
                    raise ObjectTimeoutError(
                        f"stream {seed.hex()} index {index} not produced "
                        f"within {timeout}s")
                st.cond.wait(remaining)

    def _stream_poll_locked(self, st: "_StreamState", index: int):
        """One non-blocking poll; holds st.cond."""
        if st.end_index is not None and index >= st.end_index:
            return ("end", st.end_index)
        if index < st.produced:
            return ("ref", protocol.stream_index_id(st.seed, index))
        return None

    def stream_consumed(self, seed: bytes, index: int, owner=None):
        """The consumer advanced past ``index``: raise the consumed
        watermark so the producer's backpressure credit frees up."""
        st = self._streams.get(seed)
        if st is None:
            return
        with st.cond:
            if index + 1 > st.consumed:
                st.consumed = index + 1
            st.cond.notify_all()

    # ---------------------------------------------------------------- lineage

    def _record_lineage(self, spec: _TaskSpec):
        """Keep enough of a plain task's description to resubmit it if a
        return is lost. Shm args containers are retained (one _pin_args
        ref) for the lineage entry's lifetime and charged at their full
        size, so the lineage_max_bytes budget — and store pressure via
        _try_free_space — bounds what replayability costs."""
        p = spec.args_payload
        lin = _Lineage()
        lin.task_id_hex = spec.task_id.hex()
        lin.fn_id = spec.fn_id
        lin.args_payload = p
        lin.deps_b = [d.binary() for d in spec.deps]
        lin.nested_b = [d.binary() for d in spec.nested_deps]
        lin.return_ids_b = [r.binary() for r in spec.return_ids]
        lin.options = dict(spec.options)
        cost = 64
        if p is not None and p[0] == "inline":
            cost += len(p[1])
        elif p is not None and p[0] == "shm":
            self._pin_args(p[1])
            lin.args_pinned = True
            try:
                mv = self.store.get(ObjectID(p[1]), timeout_ms=0)
                cost += mv.nbytes
                del mv
                self.store.release(ObjectID(p[1]))
            except Exception:  # noqa: BLE001
                cost += 64
        lin.cost = cost
        lin.holders = len(lin.return_ids_b)
        to_unpin: List[bytes] = []
        with self._lock:
            for rid_b in lin.return_ids_b:
                old = self._lineage.pop(rid_b, None)
                if old is not None:
                    self._lineage_bytes -= old.cost
                    if self._drop_lineage_holder_locked(old):
                        to_unpin.append(old.args_payload[1])
                self._lineage[rid_b] = lin
                self._lineage_bytes += lin.cost
            to_unpin.extend(self._evict_lineage_locked())
        for oid_b in to_unpin:
            self._unpin_args(oid_b)

    def _drop_lineage_holder_locked(self, lin: _Lineage) -> bool:
        """Returns True when the caller must release the entry's retained
        args container (last holder gone)."""
        lin.holders -= 1
        return lin.holders == 0 and lin.args_pinned

    def _evict_lineage_locked(self) -> List[bytes]:
        """Enforce the byte budget; returns args containers to unpin."""
        to_unpin: List[bytes] = []
        while self._lineage_bytes > config.lineage_max_bytes and self._lineage:
            rid_b, old = self._lineage.popitem(last=False)
            self._lineage_bytes -= old.cost
            if self._drop_lineage_holder_locked(old):
                to_unpin.append(old.args_payload[1])
        return to_unpin

    def _drop_lineage(self, oid_b: bytes):
        """Invalidate one return id's lineage (free means dead)."""
        with self._lock:
            lin = self._lineage.pop(oid_b, None)
            unpin = False
            if lin is not None:
                self._lineage_bytes -= lin.cost
                unpin = self._drop_lineage_holder_locked(lin)
            self._reconstructions.pop(oid_b, None)
            self._recon_history.pop(oid_b, None)
        if unpin:
            self._unpin_args(lin.args_payload[1])

    def _payload_lost(self, payload) -> bool:
        """True when a resolved payload's backing value is gone (shm
        container evicted / spill file deleted). Inline payloads and
        None (entry reset for an in-flight reconstruction) are not
        lost."""
        if payload is None:
            return False
        kind, data = payload
        if kind == "shm":
            return not self.store.contains(ObjectID(data))
        if kind == "spilled":
            path = data[0] if isinstance(data, tuple) else data
            return external_storage.size(path) is None
        return False

    def _object_available(self, oid_b: bytes) -> bool:
        with self._lock:
            e = self._objects.get(ObjectID(oid_b))
            if e is None:
                return False
            if not e.event.is_set():
                return True  # pending: a producer/reconstruction resolves it
            payload = e.payload
        return not self._payload_lost(payload)

    def _lost_error(self, oid_b: bytes, cause=None) -> ObjectLostError:
        """The enriched terminal error for an unrecoverable object:
        names the producing task (when lineage knows it) and the
        reconstruction attempt history."""
        oid = ObjectID(oid_b)
        with self._lock:
            freed = oid_b in self._freed
            lin = self._lineage.get(oid_b)
            history = list(self._recon_history.get(oid_b, ()))
            n = self._reconstructions.get(oid_b, 0)
        if freed:
            why = "it was freed (free means dead)"
        elif lin is None:
            why = ("no lineage is recorded (ray_tpu_torch.put values and "
                   "lineage-evicted task returns are not reconstructable)")
        elif n >= max(0, config.max_reconstructions):
            why = (f"the reconstruction budget is exhausted "
                   f"(max_reconstructions={config.max_reconstructions})")
        else:
            why = "reconstruction failed"
        msg = f"object {oid} is lost and cannot be reconstructed: {why}"
        if cause is not None:
            msg += f" [loss: {str(cause)[:200]}]"
        return ObjectLostError(msg, task_id=lin.task_id_hex if lin else "",
                               attempts=history)

    def _recover_object(self, oid_b: bytes, cause=None, depth: int = 0
                        ) -> bool:
        """Attempt lineage reconstruction of a lost object by
        resubmitting its producing task (recursively recovering lost
        upstream deps). Returns True when the object's entry WILL
        resolve again — a resubmission is in flight, possibly started by
        another thread, possibly resolving to an error — so the caller
        should re-wait on the entry. Returns False when the object is
        unrecoverable and the entry is untouched (caller raises
        _lost_error)."""
        if depth > 10:
            return False
        reset_ids: List[bytes] = []
        with self._lock:
            if oid_b in self._freed:
                return False
            e = self._objects.get(ObjectID(oid_b))
            if e is not None and not e.event.is_set():
                return True  # already being reproduced
            lin = self._lineage.get(oid_b)
            if lin is None:
                return False
            # find which of the task's returns are actually lost; a
            # concurrent recovery may already have replaced the value
            lost = [rid_b for rid_b in lin.return_ids_b
                    if (re := self._objects.get(ObjectID(rid_b))) is not None
                    and re.event.is_set() and self._payload_lost(re.payload)]
            if oid_b not in lost:
                if cause is None:
                    return True  # probe says alive: concurrent recovery won
                # the caller OBSERVED a failed decode — trust it over the
                # existence probe (a corrupt spill file still stats fine)
                lost.append(oid_b)
            n = self._reconstructions.get(oid_b, 0)
            if n >= config.max_reconstructions:
                return False
            self._reconstructions[oid_b] = n + 1
            self._recon_history.setdefault(oid_b, []).append(
                f"attempt {n + 1}: resubmitted task {lin.task_id_hex[:16]} "
                f"({type(cause).__name__ if cause is not None else 'loss'})")
            spilled_cleanup = []
            for rid_b in lost:
                re_ = self._objects[ObjectID(rid_b)]
                if re_.payload is not None and re_.payload[0] == "spilled":
                    spilled_cleanup.append(re_.payload[1])
                re_.payload = None
                re_.event.clear()
                self._recovering[rid_b] = None
                reset_ids.append(rid_b)
        with self._spill_lock:
            for rid_b in reset_ids:
                self._pinned.pop(rid_b, None)
        for data in spilled_cleanup:
            path = data[0] if isinstance(data, tuple) else data
            external_storage.delete(path)
            if isinstance(data, tuple):
                with self._spill_lock:
                    self._spilled_bytes -= data[1]
        # upstream deps must be readable before the task re-runs
        for dep_b in list(lin.deps_b) + list(lin.nested_b):
            if not self._object_available(dep_b):
                if not self._recover_object(dep_b, cause, depth + 1):
                    self._finish_failed_recovery(
                        reset_ids, self._lost_error(
                            oid_b, cause=ObjectLostError(
                                f"upstream dependency "
                                f"{ObjectID(dep_b)} is unrecoverable")))
                    return True
        try:
            task_id = make_task_id(self.job_id)
            spec = _TaskSpec(task_id, lin.fn_id, lin.args_payload,
                             [ObjectID(b) for b in lin.deps_b],
                             [ObjectID(b) for b in lin.return_ids_b],
                             dict(lin.options))
            spec.nested_deps = [ObjectID(b) for b in lin.nested_b]
            spec.request, spec.pg_wire = self._prepare_request(
                spec.options, is_actor=False)
            self._cancellable[lin.return_ids_b[0]] = spec
            self._enqueue(spec)
        except BaseException as err:  # noqa: BLE001 — e.g. PG removed
            self._finish_failed_recovery(
                reset_ids, self._lost_error(oid_b, cause=err))
        return True

    def _finish_failed_recovery(self, reset_ids: List[bytes],
                                err: ObjectLostError):
        """Resolve reset entries to the terminal error so waiters wake
        instead of hanging on a reconstruction that cannot happen."""
        self._store_error([ObjectID(b) for b in reset_ids], err)

    def _apply_get_fault(self, oid: ObjectID):
        """'get' fault site: lose the object deterministically just
        before a driver-side read decodes it."""
        action = fault_injection.fire("get", oid.hex())
        if action == "evict":
            fault_injection.evict_object(self, oid)
        elif action == "delete_spill":
            fault_injection.delete_spill_file(self, oid)
        elif action == "corrupt_spill":
            fault_injection.corrupt_spill_file(self, oid)

    # ------------------------------------------------------------- scheduler

    def submit_task(self, fn_id: bytes, args: tuple, kwargs: dict,
                    num_returns=1, options: Optional[dict] = None
                    ) -> List[ObjectRef]:
        options = options or {}
        streaming = num_returns == "streaming"
        if streaming:
            # one pre-generated return id doubles as the stream seed; the
            # yields live under deterministic per-index ids derived from it
            num_returns = 1
        task_id = make_task_id(self.job_id)
        args2, kwargs2, deps = self._swap_top_level_refs(args, kwargs)
        args_payload, nested = protocol.serialize_args(
            args2, kwargs2, store=self.store)
        return_ids = [ObjectID.from_random() for _ in range(num_returns)]
        spec = _TaskSpec(task_id, fn_id, args_payload, deps, return_ids, options)
        spec.nested_deps = [r.id for r in nested]
        spec.request, spec.pg_wire = self._prepare_request(options, is_actor=False)
        for rid in return_ids:
            self._entry(rid)
        self._cancellable[return_ids[0].binary()] = spec
        if streaming:
            seed = return_ids[0].binary()
            spec.stream = self._stream_opts(seed)
            self._register_stream(seed)
        else:
            # streaming tasks replay via the worker-death requeue path
            # (skip=produced); lost index objects surface the enriched
            # ObjectLostError instead of lineage resubmission
            self._record_lineage(spec)
        self._enqueue(spec)
        return [ObjectRef(rid, core=self) for rid in return_ids]

    def _swap_top_level_refs(self, args, kwargs):
        deps: List[ObjectID] = []

        def swap(v):
            if isinstance(v, ObjectRef):
                deps.append(v.id)
                return _TopLevelDep(v.binary())
            return v

        return (tuple(swap(a) for a in args),
                {k: swap(v) for k, v in kwargs.items()}, deps)

    def _enqueue(self, spec: _TaskSpec):
        if self._spec_pg_removed(spec):
            self._store_error(spec.return_ids, PlacementGroupError(
                "placement group was removed"))
            return
        if spec.retries_left is None:
            if spec.actor_id is not None:
                # per-call option > per-method/class default > 0 (actor
                # calls are not retried unless asked — reference:
                # max_task_retries defaults to 0, python/ray/actor.py)
                state = self._actors.get(spec.actor_id)
                default = (int(state.opts.get("max_task_retries", 0))
                           if state is not None else 0)
                spec.retries_left = int(
                    (spec.options or {}).get("max_task_retries", default))
            else:
                spec.retries_left = int(spec.options.get(
                    "max_retries", config.task_max_retries))
        if spec.actor_id is not None and spec.seq is None:
            state = self._actors.get(spec.actor_id)
            if state is not None:
                with self._lock:
                    spec.seq = state.next_seq
                    state.next_seq += 1
        if self._events is not None and not spec.submitted_ts:
            spec.submitted_ts = time.time()
        self._pin_spec_args(spec)
        unresolved = []
        for dep in spec.deps:
            e = self._entry(dep)
            if not e.event.is_set():
                unresolved.append(e)
        spec.pending_deps = len(unresolved)
        if unresolved:
            lock = make_lock("Runtime._enqueue.<deps>")

            def on_ready():
                with lock:
                    spec.pending_deps -= 1
                    ready = spec.pending_deps == 0
                if ready:
                    self._queue_ready(spec)

            for e in unresolved:
                # check-and-append stays under the lock (lost-wakeup
                # guard), but the callback must fire OUTSIDE it: on_ready
                # of the last pending dep runs _queue_ready, which
                # re-acquires the (non-reentrant) lock — invoking it here
                # would deadlock the submitting thread against itself
                fire = False
                with self._lock:
                    if e.event.is_set():
                        fire = True
                    else:
                        e.callbacks.append(on_ready)
                if fire:
                    check_fire_outside("Runtime._enqueue.on_ready")
                    on_ready()
        else:
            self._queue_ready(spec)

    def _spec_pg_removed(self, spec) -> bool:
        if spec.pg_wire is None:
            return False
        with self._lock:
            pg = self._pgs.get(PlacementGroupID(spec.pg_wire[1]))
        return pg is None or pg.removed

    def _queue_ready(self, spec: _TaskSpec):
        if spec.cancelled:
            # Never dispatched -> no resources were acquired; nothing to
            # release. (cancel_task already failed the return ids.)
            self._store_error(spec.return_ids,
                              TaskCancelledError("task was cancelled"))
            return
        # Deps may resolve long after submission; re-check the PG here so a
        # task whose group vanished while it waited fails instead of hanging.
        if spec.actor_id is None and self._spec_pg_removed(spec):
            self._store_error(spec.return_ids, PlacementGroupError(
                "placement group was removed"))
            return
        if spec.actor_id is not None:
            state = self._actors[spec.actor_id]
            with self._lock:
                # the submit-path migrated check and the evict mark are
                # not atomic; re-check under the lock the eviction marks
                # under, so a call racing the mark gets a RETRYABLE
                # error instead of joining a queue nothing will drain
                if state.dead and state.migrated:
                    evicted = True
                else:
                    evicted = False
                    state.queue.append(spec)
            if evicted:
                self._store_error(spec.return_ids, ActorUnavailableError(
                    "actor migrated off this node mid-submit; the new "
                    "incarnation is registering — retry"))
                return
            self._dispatch_actor(state)
        else:
            with self._lock:
                self._task_queue.append(spec)
            self._dispatch()

    def _mark_worker_blocked(self, w: _Worker, task_id_b: Optional[bytes]):
        """Worker enters a blocking get/wait: release the *blocking task's*
        resources so dependents can run (reference: raylet releases CPU of
        workers blocked in ray.get), and scale the pool if everyone is
        blocked."""
        released = False
        with self._lock:
            if not w.blocked:
                w.blocked = True
                spec = w.inflight.get(task_id_b) if task_id_b else None
                if spec is not None and spec.request is not None \
                        and spec.acquired_bundle is None \
                        and not spec.blocked_released:
                    self._avail = self._avail + spec.request
                    spec.blocked_released = True
                    released = True
        if released:
            self._retry_pending_pgs()
            self._dispatch()
        self._maybe_scale_up()

    def _unmark_worker_blocked(self, w: _Worker, task_id_b: Optional[bytes]):
        with self._lock:
            if w.blocked:
                w.blocked = False
                spec = w.inflight.get(task_id_b) if task_id_b else None
                if spec is not None and spec.blocked_released:
                    # Oversubscription debt is allowed; it drains as other
                    # tasks finish.
                    self._avail = self._avail.subtract_unchecked(spec.request)
                    spec.blocked_released = False

    def _maybe_scale_up(self):
        """Spawn an extra worker when queued tasks cannot run because every
        pool worker is blocked in a driver-side get/wait (otherwise nested
        task graphs deadlock). The reference raylet similarly releases the
        CPU of workers blocked in ray.get (worker_pool/lease semantics)."""
        with self._lock:
            if self._shutdown or not self._task_queue or self._idle:
                return
            if self._spawning > 0:
                return
            pool = [w for w in self._workers.values()
                    if w.alive and w.actor_id is None]
            # an EMPTY pool (every worker stolen by actors under lazy
            # replacement) must also scale, or queued tasks starve
            spawn = not pool or all(w.blocked or not w.ready
                                    for w in pool)
        if spawn:
            self._spawn_worker()

    @property
    def MAX_DISPATCH_BATCH(self):
        from ray_tpu_torch.core.config import config

        return config.max_dispatch_batch

    def _route_env_specs(self):
        """Move pip-env tasks from the general queue into their env's
        queue (dispatched by _dispatch_env to env-keyed workers only —
        they never touch the general pool)."""
        routed: List[_TaskSpec] = []
        with self._lock:
            if not any(s.env_key for s in self._task_queue):
                return
            keep: deque = deque()
            for s in self._task_queue:
                (routed if s.env_key else keep).append(s)
            self._task_queue = keep
            keys = set()
            for s in routed:
                self._env_queue.setdefault(s.env_key, deque()).append(s)
                keys.add(s.env_key)
        for key in keys:
            self._dispatch_env(key)

    def _dispatch_env(self, key: str):
        """Dispatch queued env tasks onto idle env workers, spawning the
        env's worker (venv build + cold start with the venv interpreter)
        when none exists."""
        while True:
            renv = None
            send = None
            failed = None
            with self._lock:
                q = self._env_queue.get(key)
                idle = self._env_idle.get(key)
                while idle and not idle[0].alive:
                    idle.popleft()
                if not q:
                    return
                if idle:
                    spec = q[0]
                    if not self._try_acquire_spec_locked(spec):
                        return
                    q.popleft()
                    w = idle.popleft()
                    w.inflight[spec.task_id.binary()] = spec
                    send = (w, spec)
                else:
                    failed = None
                    alive_env = sum(1 for x in self._workers.values()
                                    if x.alive and x.env_key == key
                                    and x.actor_id is None)
                    # grow the env pool with demand (bounded by the
                    # general pool size) — one worker per env would
                    # serialize a deep env queue while the node idles
                    cap = max(1, self.num_workers)
                    want = min(len(q), cap)
                    if (not self._env_spawning.get(key)
                            and alive_env < want):
                        if self._env_spawn_fails.get(key, 0) >= 3:
                            # crash-looping env: fail its queue out
                            failed = list(q)
                            q.clear()
                        else:
                            self._env_spawning[key] = 1
                            renv = q[0].options.get("runtime_env")
            if send is not None:
                self._send_task_batch(send[0], [send[1]])
                continue
            if failed:
                err = RuntimeError(
                    f"pip env {key} workers crashed repeatedly before "
                    "becoming ready — the env is likely broken (a "
                    "pinned package shadowing a framework dependency?)")
                for spec in failed:
                    self._store_error(spec.return_ids, err)
                return
            if renv is not None:
                threading.Thread(target=self._spawn_env_worker,
                                 args=(key, renv), daemon=True).start()
            return

    def _spawn_env_worker(self, key: str, runtime_env: dict):
        """Background: build (or reuse) the venv, then cold-spawn a
        worker running ITS interpreter. Build failures fail every task
        queued for the env — there is no worker that could ever run
        them."""
        from ray_tpu_torch.core import runtime_env as _re

        try:
            kind, provider, spec = _re.resolve_env_provider(runtime_env)
            prep = provider.prepare(spec)
            self._spawn_worker(python_exe=prep.python_exe, env_key=key,
                               extra_env=prep.env_vars or None)
        except Exception as e:  # noqa: BLE001 — fail the env's tasks
            with self._lock:
                q = self._env_queue.pop(key, deque())
            # queued env specs were never resource-acquired (acquisition
            # happens at dispatch), so there is NOTHING to release here —
            # releasing would credit the pool for grants never taken
            for spec in q:
                self._store_error(spec.return_ids, RuntimeError(
                    f"runtime_env setup failed: {e!r}"))
        finally:
            with self._lock:
                self._env_spawning[key] = 0
        # pre-ready death (broken env, bogus provider exe) is observed by
        # the shared _watch_until_ready watcher every spawn starts — it
        # feeds _on_worker_death, which drives this env's crash-loop
        # bound / respawn via _dispatch_env

    def _dispatch(self):
        self._route_env_specs()
        # env queues also drain on GENERAL events (resource release,
        # completions): an env task that failed resource acquisition
        # with an idle env worker would otherwise never be retried
        with self._lock:
            env_keys = [k for k, q in self._env_queue.items() if q]
        for k in env_keys:
            self._dispatch_env(k)
        while True:
            batch = []
            with self._lock:
                while self._idle and not self._idle[0].alive:
                    self._idle.popleft()
                if not self._task_queue or not self._idle:
                    # queued work + drained pool: repay ONE stolen
                    # worker (actor creations defer replacement forks
                    # to exactly this moment — see _pool_deficit)
                    if (self._task_queue and not self._idle
                            and not self._shutdown
                            and self._spawning == 0
                            and self._pool_deficit > 0):
                        self._pool_deficit -= 1
                        threading.Thread(
                            target=self._repay_pool_deficit,
                            daemon=True).start()
                    return
                # Fair division: divide the queue across the whole pool
                # (busy workers rejoin soon), so one early-finishing worker
                # cannot swallow work the others would run in parallel.
                # The pool counts the workers actors took and the runtime
                # owes back (_pool_deficit): tasks that rendezvous by
                # polling (host collectives) never block, and batched onto
                # one worker of a pool that actors drained they would wait
                # on each other forever.
                pool = sum(1 for x in self._workers.values()
                           if x.alive and x.actor_id is None
                           and x.env_key is None) + self._pool_deficit or 1
                cap = max(1, min(
                    self.MAX_DISPATCH_BATCH,
                    -(-len(self._task_queue) // pool),
                ))
                i = 0
                while i < len(self._task_queue) and len(batch) < cap:
                    spec = self._task_queue[i]
                    if spec.request is not None or spec.pg_wire is not None:
                        # Resource-bearing specs ship alone so their
                        # resources release at *their* completion, not at
                        # the end of an unrelated batch.
                        if batch:
                            break
                        if self._try_acquire_spec_locked(spec):
                            batch.append(spec)
                            del self._task_queue[i]
                        else:
                            i += 1
                        if batch:
                            break
                        continue
                    if spec.nested_deps and self._nested_unready_locked(spec):
                        # May block in get() on a not-yet-produced object:
                        # ship alone, so its producer is never ordered
                        # behind it in the same worker's batch (blocked-
                        # worker scale-up then guarantees progress).
                        if batch:
                            break
                        batch.append(spec)
                        del self._task_queue[i]
                        break
                    batch.append(spec)
                    del self._task_queue[i]
                if not batch:
                    return
                w = self._idle.popleft()
                for spec in batch:
                    w.inflight[spec.task_id.binary()] = spec
            self._send_task_batch(w, batch)

    # ----------------------------------------------------------- resources

    def _prepare_request(self, options: dict, is_actor: bool):
        """Normalize task/actor options into (ResourceSet, pg_wire)."""
        req = {}
        num_cpus = options.get("num_cpus")
        if num_cpus is None:
            num_cpus = 0.0 if is_actor else 1.0
        if num_cpus:
            req["CPU"] = float(num_cpus)
        if options.get("num_tpus"):
            raise ValueError(NUM_TPUS_REFUSED)
        num_gpus = options.get("num_gpus", 0)
        if num_gpus:
            if not is_actor:
                raise ValueError(
                    "num_gpus is actor-scoped in this release: GPUs are "
                    "bound to dedicated worker processes at spawn time "
                    "(CUDA_VISIBLE_DEVICES is read when CUDA initialises). "
                    "Wrap GPU work in an actor with num_gpus=N."
                )
            req["GPU"] = float(num_gpus)
        for k, v in (options.get("resources") or {}).items():
            req[k] = req.get(k, 0) + float(v)
        strategy = options.get("scheduling_strategy")
        pg_wire = None
        if strategy is not None and hasattr(strategy, "_to_wire"):
            wire = strategy._to_wire()
            if wire[0] == "pg":
                pg_wire = wire
        elif isinstance(strategy, tuple) and strategy and strategy[0] == "pg":
            pg_wire = strategy
        if not is_actor and pg_wire is None and req == {"CPU": 1.0}:
            # The worker slot IS the CPU for a default task (pool size ==
            # CPU count): gate on worker availability only, which lets the
            # dispatcher pipeline batches onto workers. Non-default
            # requests (custom resources, fractional CPU, PG bundles) go
            # through explicit accounting.
            return None, None
        return ResourceSet(req), pg_wire

    def _nested_unready_locked(self, spec) -> bool:
        """True if any ObjectID nested inside the task's args is not yet
        produced (missing entry counts as unready). Caller holds _lock."""
        for oid in spec.nested_deps:
            e = self._objects.get(oid)
            if e is None or not e.event.is_set():
                return True
        return False

    def _try_acquire_spec_locked(self, spec) -> bool:
        """Try to acquire spec.request from its pool. Caller holds _lock."""
        if spec.request is None:
            return True
        if spec.pg_wire is not None:
            state = self._pgs.get(PlacementGroupID(spec.pg_wire[1]))
            if state is None or state.removed or not state.ready_event.is_set():
                return False
            bundle = state.find_bundle(spec.request, spec.pg_wire[2])
            if bundle is None:
                return False
            bundle.acquire(spec.request)
            spec.acquired_bundle = bundle
            return True
        if spec.request.is_subset_of(self._avail):
            self._avail = self._avail - spec.request
            return True
        return False

    def _release_spec_locked(self, spec):
        if spec.request is None:
            return
        if spec.acquired_bundle is not None:
            spec.acquired_bundle.release(spec.request)
            # Resources of a *removed* PG's bundle must flow back to the
            # node pool, not die inside the dead bundle.
            if spec.pg_wire is not None:
                pg = self._pgs.get(PlacementGroupID(spec.pg_wire[1]))
                if pg is None or pg.removed:
                    self._avail = self._avail + spec.request
            spec.acquired_bundle = None
        elif spec.blocked_released:
            spec.blocked_released = False  # already credited at block time
        else:
            self._avail = self._avail + spec.request
        spec.request = None

    def _dispatch_actor(self, state: _ActorState):
        specs: List[_TaskSpec] = []
        failed: List[_TaskSpec] = []
        served: List[_TaskSpec] = []
        with self._lock:
            w = state.worker
            if state.dead and state.queue:
                failed = list(state.queue)
                state.queue.clear()
            elif w is not None and state.ready and not state.dead:
                # keep up to `capacity` calls in flight: with
                # max_concurrency / concurrency groups the worker-side
                # pools overlap them (default actors stay FIFO, cap 1)
                while (state.queue
                       and len(w.inflight) < state.capacity):
                    spec = state.queue.popleft()
                    if (spec.seq is not None
                            and (spec.seq < state.seq_watermark
                                 or spec.seq in state.completed_seqs)):
                        # replay of a call that already completed (its
                        # result is sealed in the store): deliver from
                        # the store, never re-execute the side effect
                        served.append(spec)
                        continue
                    w.inflight[spec.task_id.binary()] = spec
                    specs.append(spec)
        for spec in served:
            self._release_spec_args(spec)
            self._release_spec_deps(spec)
            self._cancellable.pop(spec.return_ids[0].binary(), None)
        for f in failed:
            self._store_error(f.return_ids, self._actor_dead_error(state))
        for spec in specs:
            self._send_actor_call(w, spec)

    def _inline_values_for(self, deps: List[ObjectID],
                           spec: Optional[_TaskSpec] = None
                           ) -> Dict[bytes, Any]:
        """Raises _DepsLost (when dispatching a spec) if a dep's backing
        value vanished between resolution and dispatch — the dispatcher
        then reconstructs the deps and requeues the spec instead of
        shipping a read that is known to fail worker-side."""
        out: Dict[bytes, Any] = {}
        lost: List[bytes] = []
        with self._lock:
            entries = {dep: self._objects[dep] for dep in deps}
        for dep in deps:
            e = entries[dep]
            payload = e.payload
            if payload is None:
                # entry reset: its reconstruction is already in flight
                lost.append(dep.binary())
                continue
            kind, data = payload
            if kind == "shm":
                # Pin the container for the task's flight time: with only
                # the tracking pin, spill could delete it between dispatch
                # and the worker's shm read.
                pinned = False
                if spec is not None:
                    try:
                        self.store.get(ObjectID(data), timeout_ms=0)
                        spec.dep_pins.append(data)
                        pinned = True
                    # rtpu-lint: disable=L4 — pin miss (raced a spill or
                    # eviction) is an expected outcome: the not-pinned
                    # branch below re-reads the entry and recovers
                    except Exception:  # noqa: BLE001
                        pass
                if spec is not None and not pinned:
                    # raced a spill: the entry's payload has moved to disk —
                    # re-read and ship the current descriptor in-message
                    with self._lock:
                        refreshed = self._objects[dep].payload
                    if refreshed is None or refreshed[0] == "shm":
                        # not a spill race: the container is truly gone
                        lost.append(dep.binary())
                    else:
                        out[dep.binary()] = refreshed
                else:
                    out[dep.binary()] = None  # worker reads shm directly
            elif (kind == "spilled" and spec is not None
                  and self._payload_lost(payload)):
                lost.append(dep.binary())
            else:
                # inline and spilled payload descriptors travel in-message
                # (the worker opens spill files itself — same host)
                out[dep.binary()] = payload
        if lost and spec is not None:
            self._release_spec_deps(spec)  # pins taken before the loss hit
            raise _DepsLost(lost)
        return out

    def _release_spec_deps(self, spec: _TaskSpec):
        pins, spec.dep_pins = spec.dep_pins, []
        for oid_b in pins:
            try:
                self.store.release(ObjectID(oid_b))
            # rtpu-lint: disable=L4 — flight-pin release races frees and
            # store shutdown; a stale pin on a gone object is a no-op
            except Exception:  # noqa: BLE001
                pass

    def _reap_orphan_returns(self, spec: _TaskSpec):
        """Reclaim sealed-but-unreported return containers of a crashed
        worker (refcount 1 from seal-retain, never adopted). A container
        the worker only CREATED (died mid-write) still leaks its creator
        ref — reclaiming that needs dead-process ref accounting in the C
        store, a narrower window left for a future round."""
        rids = list(spec.return_ids)
        if spec.stream is not None:
            # a streaming worker may have sealed index `produced` without
            # its MSG_STREAM_YIELD flushing; that container is the same
            # kind of orphan
            st = self._streams.get(spec.stream["seed"])
            if st is not None:
                with st.cond:
                    nxt = st.produced
                rids.append(ObjectID(
                    protocol.stream_index_id(spec.stream["seed"], nxt)))
        for rid in rids:
            rid_b = rid.binary()
            with self._spill_lock:
                if rid_b in self._pinned:
                    continue  # adopted: the result actually arrived
            with self._lock:
                e = self._objects.get(rid)
                if e is not None and e.event.is_set():
                    continue
            try:
                if self.store.contains(rid):
                    self.store.release(rid)
                    self.store.delete(rid)
            # rtpu-lint: disable=L4 — reaping after a worker crash is
            # best-effort: a container that cannot be reclaimed now is
            # only a leak, and raising would abort the death handling
            except Exception:  # noqa: BLE001
                pass

    def _requeue_lost_dep_spec(self, w: _Worker, spec: _TaskSpec,
                               lost_oids: List[bytes]):
        """A dep's value vanished between resolution and dispatch: pull
        the spec back off the worker, kick off reconstruction of the
        lost deps, and requeue it (it re-waits on the reset entries).
        Unrecoverable deps fail the task with the enriched error."""
        with self._lock:
            w.inflight.pop(spec.task_id.binary(), None)
            self._release_spec_locked(spec)
        self._release_spec_deps(spec)
        for oid_b in lost_oids:
            if not self._recover_object(oid_b):
                self._release_spec_args(spec)
                self._store_error(spec.return_ids, self._lost_error(oid_b))
                return
        if spec.actor_id is None:
            # re-derive the resource request released above; actor-call
            # specs carry none (the actor's worker holds its resources)
            spec.request, spec.pg_wire = self._prepare_request(
                spec.options, is_actor=False)
        self._enqueue(spec)

    def _send_task_batch(self, w: _Worker, batch: List[_TaskSpec]):
        try:
            entries = []
            sent = []
            for spec in batch:
                # unconditional: the OOM kill policy sorts on this
                spec.dispatched_ts = time.time()
                self._ensure_fn_on_worker(w, spec.fn_id)
                try:
                    inline_values = self._inline_values_for(spec.deps, spec)
                except _DepsLost as lost:
                    self._requeue_lost_dep_spec(w, spec, lost.oids)
                    continue
                entries.append((
                    spec.task_id.binary(), spec.fn_id, spec.args_payload,
                    inline_values, [r.binary() for r in spec.return_ids],
                    spec.options.get("runtime_env"), spec.stream,
                ))
                sent.append(spec)
            if entries:
                self._send_msg(w, (protocol.MSG_TASK_BATCH, entries))
            if fault_injection.enabled() and w.proc is not None:
                # 'dispatch' fault site: the worker dies right after
                # receiving the batch (keyed by function id)
                for spec in sent:
                    key = spec.fn_id.hex() if spec.fn_id else ""
                    if fault_injection.fire("dispatch", key) == "kill_worker":
                        try:
                            os.kill(w.proc.pid, signal.SIGKILL)
                        except ProcessLookupError:
                            pass
                        break
        except (OSError, EOFError, BrokenPipeError):
            self._on_worker_death(w)

    def _send_actor_call(self, w: _Worker, spec: _TaskSpec):
        try:
            # unconditional: the OOM kill policy sorts on this
            spec.dispatched_ts = time.time()
            fault = None
            if fault_injection.enabled():
                # 'actor_call' fault site, keyed "<actor hex>:<method>":
                # 'drop' loses the dispatch (the call stays in flight but
                # the worker never sees it), 'kill_worker' SIGKILLs the
                # actor's worker right after the send
                fault = fault_injection.fire(
                    "actor_call",
                    f"{spec.actor_id.hex()}:{spec.method}")
                if fault == "drop":
                    return
            try:
                inline_values = self._inline_values_for(spec.deps, spec)
            except _DepsLost as lost:
                self._requeue_lost_dep_spec(w, spec, lost.oids)
                return
            self._send_msg(w, (
                protocol.MSG_ACTOR_CALL, spec.task_id.binary(),
                spec.actor_id.binary(), spec.method, spec.args_payload,
                inline_values, [r.binary() for r in spec.return_ids],
                spec.stream,
            ))
            if fault == "kill_worker" and w.proc is not None:
                try:
                    os.kill(w.proc.pid, signal.SIGKILL)
                except ProcessLookupError:
                    pass
        except (OSError, EOFError, BrokenPipeError):
            self._on_worker_death(w)

    def _on_task_done(self, w: _Worker, task_id_b: bytes, payloads):
        with self._lock:
            spec = w.inflight.pop(task_id_b, None)
            if spec is not None:
                self._release_spec_locked(spec)
        if spec is not None:
            if self._events is not None and len(self._events) < 200_000:
                now = time.time()
                self._events.append({
                    "task_id": spec.task_id.hex(),
                    "parent_task_id": spec.parent_task,
                    "fn": (spec.method if spec.method
                           else (spec.fn_id.hex()[:8] if spec.fn_id
                                 else "task")),
                    "actor": spec.actor_id.hex() if spec.actor_id else None,
                    "worker": w.worker_id.hex()[:8],
                    "pid": w.proc.pid if w.proc else 0,
                    "submitted": spec.submitted_ts or now,
                    "dispatched": spec.dispatched_ts or now,
                    "done": now,
                })
            self._release_spec_args(spec)
            self._release_spec_deps(spec)
            if spec.cancelled:
                # cancel() was promised while the task sat batched behind
                # the worker's head task; honor it even though the task ran.
                self._store_error(spec.return_ids,
                                  TaskCancelledError("task was cancelled"))
            else:
                self._cancellable.pop(spec.return_ids[0].binary(), None)
                for rid, payload in zip(spec.return_ids, payloads):
                    self._store_payload(rid, payload)
            self._actor_call_completed(spec)
        self._signal_cancelled_head(w)
        self._retry_pending_pgs()
        self._worker_now_idle(w)

    def _signal_cancelled_head(self, w: _Worker) -> None:
        """A task cancelled while batched behind its worker's head was
        left unsignalled (a SIGINT then would interrupt the head): once it
        is the head, send the SIGINT. The worker holds one that lands
        before the task starts and asks about it (REQ_TASK_CANCELLED), so
        the task never runs to its end."""
        with self._lock:
            head = next(iter(w.inflight.values()), None)
        if (head is None or not head.cancelled or w.actor_id is not None
                or w.proc is None):
            return
        try:
            os.kill(w.proc.pid, signal.SIGINT)
        except OSError:
            pass

    def _on_task_error(self, w: _Worker, task_id_b: bytes, err_payload):
        with self._lock:
            spec = w.inflight.pop(task_id_b, None)
            if spec is not None:
                self._release_spec_locked(spec)
        if spec is not None:
            self._release_spec_deps(spec)
            if (not spec.cancelled
                    and self._maybe_retry_actor_error(spec, err_payload)):
                # retry_exceptions replay: the args stay pinned for the
                # re-execution, the error is never delivered
                self._retry_pending_pgs()
                self._worker_now_idle(w)
                return
            self._release_spec_args(spec)
            if spec.cancelled:
                # SIGINT-interrupted execution surfaces as a cancellation,
                # not as the raw KeyboardInterrupt TaskError.
                self._store_error(spec.return_ids,
                                  TaskCancelledError("task was cancelled"))
            else:
                self._cancellable.pop(spec.return_ids[0].binary(), None)
                st = (self._streams.get(spec.stream["seed"])
                      if spec.stream is not None else None)
                if st is not None:
                    # mid-stream app error: becomes the stream's final
                    # (raising) ref instead of resolving the seed id
                    self._fail_stream(st, err_payload)
                else:
                    for rid in spec.return_ids:
                        self._store_payload(rid, err_payload)
            self._actor_call_completed(spec)
        self._signal_cancelled_head(w)
        self._retry_pending_pgs()
        self._worker_now_idle(w)

    def _worker_now_idle(self, w: _Worker):
        if w.actor_id is not None:
            state = self._actors.get(w.actor_id)
            if state is not None:
                self._dispatch_actor(state)
            return
        if w.env_key is not None:
            retire_env = False
            with self._lock:
                q = self._env_queue.get(w.env_key)
                idle = self._env_idle.setdefault(w.env_key, deque())
                if (not q) and idle and not w.inflight:
                    # keep ONE warm worker per env; retire the surplus
                    retire_env = True
                    self._workers.pop(w.worker_id, None)
                    w.alive = False
                elif w.alive and not w.inflight and w not in idle:
                    idle.append(w)
            if retire_env:
                try:
                    self._send_msg(w, (protocol.MSG_SHUTDOWN,))
                except (OSError, EOFError, BrokenPipeError):
                    pass  # already exiting on its own
            else:
                self._dispatch_env(w.env_key)
            return
        retire = False
        with self._lock:
            pool = sum(1 for x in self._workers.values()
                       if x.alive and x.actor_id is None
                       and x.env_key is None)
            if (not self._task_queue and pool > self.num_workers
                    and not w.inflight):
                # Surplus worker from blocked-get scale-up: retire it so the
                # pool (and the implicit CPU cap on default tasks) returns
                # to its configured size.
                self._workers.pop(w.worker_id, None)
                w.alive = False
                retire = True
            elif w.alive and not w.inflight and w not in self._idle:
                self._idle.append(w)
        if retire:
            try:
                self._send_msg(w, (protocol.MSG_SHUTDOWN,))
            except (OSError, EOFError, BrokenPipeError):
                pass
            return
        self._dispatch()

    # ------------------------------------------------------------------- api

    def get_objects(self, refs: List[ObjectRef], timeout: Optional[float] = None
                    ) -> List[Any]:
        deadline = None if timeout is None else time.monotonic() + timeout
        return [protocol.raise_if_error(self._get_one(ref, deadline))
                for ref in refs]

    def _get_one(self, ref: ObjectRef, deadline: Optional[float]):
        """Resolve + decode one object, transparently reconstructing a
        lost value from lineage: on ObjectLostError the producing task is
        resubmitted (recursively recovering lost upstream deps) and the
        wait restarts, up to config.max_reconstructions attempts."""
        e = self._entry(ref.id)
        oid_b = ref.id.binary()
        while True:
            remaining = None if deadline is None else max(
                0.0, deadline - time.monotonic())
            if not e.event.wait(remaining):
                raise GetTimeoutError(f"get() timed out waiting for {ref}")
            if fault_injection.enabled():
                self._apply_get_fault(ref.id)
            try:
                return self._decode_entry(e)
            except ObjectLostError as err:
                if not self._recover_object(oid_b, err):
                    raise self._lost_error(oid_b, err) from None

    def _decode_entry(self, e: _ObjectEntry):
        payload = e.payload
        if payload is None:
            # entry reset by a concurrent reconstruction between our
            # event.wait and this read; callers re-wait
            raise ObjectLostError("object is being reconstructed")
        kind, data = payload
        if kind == "inline":
            return serialization.unpack(data)
        if kind == "spilled":
            return protocol.spilled_unpack(data)
        try:
            return protocol.shm_unpack(self.store, ObjectID(data))
        except ObjectLostError:
            # raced a concurrent spill: the payload may have moved to disk
            kind2, data2 = e.payload if e.payload is not None else (None, None)
            if kind2 == "spilled":
                return protocol.spilled_unpack(data2)
            raise

    def put_object(self, value: Any) -> ObjectRef:
        payload = protocol.serialize_value(value, store=self.store)
        oid = ObjectID(payload[1]) if payload[0] == "shm" else ObjectID.from_random()
        self._store_payload(oid, payload)
        return ObjectRef(oid, core=self)

    def wait(self, refs: List[ObjectRef], num_returns: int = 1,
             timeout: Optional[float] = None) -> Tuple[List[ObjectRef], List[ObjectRef]]:
        if num_returns > len(refs):
            raise ValueError("num_returns exceeds number of refs")
        deadline = None if timeout is None else time.monotonic() + timeout
        pending = {r.id: r for r in refs}
        ready: List[ObjectRef] = []
        cond = make_condition("Runtime.wait.<cond>")

        def notify():
            with cond:
                cond.notify_all()

        for oid in list(pending):
            e = self._entry(oid)
            with self._lock:
                if not e.event.is_set():
                    e.callbacks.append(notify)
        while True:
            with self._lock:
                ready = [r for r in refs
                         if self._objects[r.id].event.is_set()]
            if len(ready) >= num_returns:
                break
            remaining = None if deadline is None else deadline - time.monotonic()
            if remaining is not None and remaining <= 0:
                break
            with cond:
                cond.wait(remaining if remaining is None or remaining > 0 else 0)
        ready_set = {r.id for r in ready[:num_returns]}
        ready_list = [r for r in refs if r.id in ready_set]
        rest = [r for r in refs if r.id not in ready_set]
        return ready_list, rest

    def as_future(self, ref: ObjectRef):
        import asyncio

        loop = asyncio.get_event_loop()
        fut = loop.create_future()
        e = self._entry(ref.id)

        def resolve():
            try:
                v = self._decode_entry(e)
            except ObjectLostError as exc:
                oid_b = ref.id.binary()
                if self._recover_object(oid_b, exc):
                    # re-arm for the reconstructed value
                    with self._lock:
                        if not e.event.is_set():
                            e.callbacks.append(resolve)
                            return
                    resolve()
                else:
                    loop.call_soon_threadsafe(
                        fut.set_exception, self._lost_error(oid_b, exc))
                return
            except BaseException as exc:  # noqa: BLE001
                loop.call_soon_threadsafe(fut.set_exception, exc)
                return
            if isinstance(v, protocol.ErrorValue):
                loop.call_soon_threadsafe(fut.set_exception, v.error)
            else:
                loop.call_soon_threadsafe(fut.set_result, v)

        # same discipline as _enqueue's dep registration: check-and-append
        # under the lock, but run the callback outside it — resolve() can
        # enter reconstruction, which re-acquires the non-reentrant lock
        fire = False
        with self._lock:
            if e.event.is_set():
                fire = True
            else:
                e.callbacks.append(resolve)
        if fire:
            resolve()
        return fut

    # ----------------------------------------------------------------- actors

    def create_actor(self, cls_fn_id: bytes, args: tuple, kwargs: dict,
                     opts: Optional[dict] = None) -> ActorID:
        opts = opts or {}
        args2, kwargs2, deps = self._swap_top_level_refs(args, kwargs)
        args_payload, _ = protocol.serialize_args(args2, kwargs2, store=self.store)
        return self._create_actor_from_payload(cls_fn_id, args_payload, deps, opts)

    def _create_actor_from_payload(self, cls_fn_id: bytes, args_payload,
                                   deps: List[ObjectID], opts: dict,
                                   actor_id: Optional[ActorID] = None
                                   ) -> ActorID:
        # A caller-specified id lets the cluster layer recreate a restarted
        # actor under its original identity on a different node.
        actor_id = actor_id or ActorID.from_random()
        if args_payload is not None and args_payload[0] == "shm":
            # adopt the retained creation-args ref for the actor's lifetime
            # (restarts re-read the payload); released at terminal death
            self._pin_args(args_payload[1])
        state = _ActorState(actor_id, cls_fn_id, args_payload, deps, opts)
        state.request, state.pg_wire = self._prepare_request(opts, is_actor=True)
        if self._spec_pg_removed(state):
            with self._lock:
                self._actors[actor_id] = state
            self._mark_actor_dead(state, ActorDiedError(
                "placement group was removed before the actor was placed"))
            return actor_id
        with self._lock:
            self._actors[actor_id] = state
            name = opts.get("name")
            if name:
                if name in self._named_actors:
                    raise ValueError(f"actor name {name!r} already taken")
                self._named_actors[name] = actor_id
            placed = self._try_acquire_actor_locked(state)
            if not placed:
                self._pending_actors.append(state)
        if placed:
            # Start (fork + handshake) OFF the caller's thread: the
            # creator only needs the id it already chose, and method
            # calls queue on the actor state until MSG_ACTOR_READY —
            # so a creation burst pipelines instead of paying a
            # serialized fork per reply (reference: actor creation is
            # async task submission, core_worker.cc SubmitActorCreationTask).
            # One spawner thread per runtime: concurrent forks on few
            # cores thrash (page-table churn + context switches).
            self._actor_start_queue.put(state)
        return actor_id

    def _actor_spawner_loop(self):
        while not self._shutdown:
            try:
                state = self._actor_start_queue.get(timeout=0.5)
            except queue.Empty:
                continue
            if state.dead:
                continue  # killed while queued: never fork for it
            try:
                self._start_actor(state)
            except Exception as e:  # noqa: BLE001
                # transient start failure (fork EAGAIN, zygote respawn):
                # spend the restart budget like a worker death would,
                # only then declare the actor dead
                if state.restarts_left != 0 and not state.dead:
                    if state.restarts_left > 0:
                        state.restarts_left -= 1
                    time.sleep(0.05)
                    self._actor_start_queue.put(state)
                    continue
                try:
                    self._mark_actor_dead(state, ActorDiedError(
                        f"actor failed to start: {e!r}"))
                # rtpu-lint: disable=L4 — crash-proof daemon loop: the
                # spawner thread serves every actor; failing to mark one
                # dead must not stop it from starting the rest
                except Exception:  # noqa: BLE001
                    pass

    def _start_actor(self, state: _ActorState):
        needs_gpu = bool(state.gpu_ids) or state.opts.get("num_gpus", 0) > 0
        env_key = _task_env_key(state.opts)
        if env_key is not None and not needs_gpu:
            # pip-env actor: a DEDICATED worker running the venv's own
            # interpreter (never a pooled one — its module versions
            # must come from the env). Venv build is cached; the actor
            # start queue thread absorbs the one-time cost.
            from ray_tpu_torch.core import runtime_env as _re

            renv = state.opts.get("runtime_env") or {}
            kind, provider, spec = _re.resolve_env_provider(renv)
            prep = provider.prepare(spec)
            w = self._spawn_worker(python_exe=prep.python_exe,
                                   env_key=env_key,
                                   extra_env=prep.env_vars or None)
            with self._lock:
                w.actor_id = state.actor_id
                state.worker = w
                died = state.dead
            if died:
                if w.proc is not None:
                    try:
                        w.proc.terminate()
                    except OSError:
                        pass
                return
            self._when_worker_ready(
                w, lambda: self._send_create_actor(w, state))
            return
        w = None
        if not needs_gpu:
            # Prefer an idle pooled worker; else spawn fresh (+ replace pool).
            with self._lock:
                w = self._idle.popleft() if self._idle else None
        if w is None:
            extra_env = {}
            if state.gpu_ids:
                ids = ",".join(state.gpu_ids)
                # the env contract of the reference framework's GPU
                # workers (accelerators/nvidia_gpu.py
                # set_current_process_visible_accelerator_ids), set
                # before the interpreter starts
                extra_env["CUDA_VISIBLE_DEVICES"] = ids
                extra_env["RTPU_GPU_IDS"] = ids
            w = self._spawn_worker(gpu=needs_gpu, extra_env=extra_env)
        else:
            # replace task-pool capacity lazily (see _pool_deficit): the
            # fork (~10-25ms even from the zygote) must not serialize
            # into every create_actor RPC reply, and a burst of actor
            # creations should not pay a fork per actor at all
            with self._lock:
                self._pool_deficit += 1
        with self._lock:
            w.actor_id = state.actor_id
            state.worker = w
            died = state.dead
        if died:
            # killed between the queue pop and here: reclaim the worker
            # instead of pinning it to a dead actor
            if w.proc is not None:
                try:
                    w.proc.terminate()
                except OSError:
                    pass
            return
        self._when_worker_ready(w, lambda: self._send_create_actor(w, state))

    def _repay_pool_deficit(self):
        """Spawn ONE replacement for a stolen pool worker (called when
        queued work finds the pool empty). On failure the debt stays."""
        try:
            self._spawn_worker()
            return
        # rtpu-lint: disable=L4 — spawn can fail many ways (fork EAGAIN,
        # racing shutdown); the deficit below records the debt so a later
        # caller retries, which beats failing THIS task submission
        except Exception:  # noqa: BLE001 — racing shutdown
            pass
        with self._lock:
            self._pool_deficit += 1

    def _when_worker_ready(self, w: _Worker, fn):
        def poll():
            while not self._shutdown and w.alive:
                if w.ready and w.task_conn is not None:
                    fn()
                    return
                time.sleep(0.002)
        if w.ready and w.task_conn is not None:
            fn()
        else:
            threading.Thread(target=poll, daemon=True).start()

    def _send_create_actor(self, w: _Worker, state: _ActorState):
        try:
            self._ensure_fn_on_worker(w, state.cls_fn_id)
            inline_values = self._inline_values_for(state.creation_deps)
            self._send_msg(w, (
                protocol.MSG_CREATE_ACTOR, state.actor_id.binary(),
                state.cls_fn_id, state.creation_args_payload, inline_values,
                {k: v for k, v in state.opts.items() if k != "name"},
            ))
        except (OSError, EOFError, BrokenPipeError):
            self._on_worker_death(w)

    def _on_actor_ready(self, w: _Worker, actor_id: ActorID):
        state = self._actors.get(actor_id)
        if state is None:
            return
        with self._lock:
            restarted = state.restarting
            state.restarting = False
            state.ready = True
        state.creation_event.set()
        if restarted:
            # RESTARTING -> ALIVE: buffered + replayed calls drain to the
            # new incarnation in _dispatch_actor below
            self._publish_actor_state(state, "ALIVE")
        self._dispatch_actor(state)

    def _publish_actor_state(self, state: _ActorState, st: str):
        """Broadcast an actor FSM transition (ALIVE/RESTARTING/DEAD) on
        the ``actor_state`` pubsub channel. Single-node this lands in the
        Runtime's local mirror; in cluster mode the overriding core
        routes it to the GCS so every node and driver observes the same
        buffer/raise/replay semantics."""
        try:
            self.pubsub_op("publish", "actor_state", {
                "actor_id": state.actor_id.binary(),
                "state": st,
                "incarnation": state.incarnation,
                "restarts_left": state.restarts_left,
                "name": state.name,
            })
        # rtpu-lint: disable=L4 — the publication is advisory (a
        # subscriber that misses a transition re-reads the actor table);
        # losing it must never break the death/restart handling itself
        except Exception:  # noqa: BLE001
            pass

    def _actor_dead_error(self, state: _ActorState) -> ActorDiedError:
        """Terminal-death error enriched with the cause, the restart
        budget spent, and the incarnation that failed."""
        opts_max = int(state.opts.get("max_restarts", 0) or 0)
        consumed = (state.incarnation if opts_max < 0
                    else opts_max - max(0, state.restarts_left))
        return ActorDiedError(
            "actor is dead",
            cause=str(state.death_cause or "unknown"),
            restarts_consumed=consumed,
            incarnation=state.incarnation)

    def _check_actor_admission(self, state: _ActorState):
        """While an actor is RESTARTING new calls buffer on its queue —
        but only actor_restart_buffer_max of them, and only until the
        restart has run for actor_restart_timeout_s. Past either bound
        the caller gets ActorUnavailableError: unlike ActorDiedError the
        actor may come back, so callers can retry later."""
        if state.dead or not state.restarting:
            return
        if (time.monotonic() - state.restarting_since
                > config.actor_restart_timeout_s):
            raise ActorUnavailableError(
                f"actor {state.actor_id.hex()[:12]} has been RESTARTING "
                f"for more than actor_restart_timeout_s="
                f"{config.actor_restart_timeout_s:g}s "
                f"(incarnation {state.incarnation})")
        if len(state.queue) >= config.actor_restart_buffer_max:
            raise ActorUnavailableError(
                f"actor {state.actor_id.hex()[:12]} is RESTARTING and "
                f"its call buffer is full (actor_restart_buffer_max="
                f"{config.actor_restart_buffer_max})")

    def _actor_call_completed(self, spec: _TaskSpec):
        """Advance the actor's completed-call watermark: a replayed call
        at a seq the watermark already covers is served from the store
        by _dispatch_actor, never re-executed (exactly-once result
        delivery on top of at-least-once execution)."""
        if spec.actor_id is None or spec.seq is None:
            return
        state = self._actors.get(spec.actor_id)
        if state is None:
            return
        with self._lock:
            state.completed_seqs.add(spec.seq)
            while state.seq_watermark in state.completed_seqs:
                state.completed_seqs.discard(state.seq_watermark)
                state.seq_watermark += 1

    def _actor_retry_exceptions(self, spec: _TaskSpec):
        """Resolved retry_exceptions setting for one call: per-call
        option > per-method/class default > False. True retries any
        application exception; a list/tuple retries matching types."""
        copts = spec.options or {}
        if "retry_exceptions" in copts:
            return copts["retry_exceptions"]
        state = self._actors.get(spec.actor_id)
        return state.opts.get("retry_exceptions", False) if state else False

    def _maybe_retry_actor_error(self, spec: _TaskSpec, err_payload) -> bool:
        """Application-error retry (reference: retry_exceptions,
        task_manager.cc RetryTaskIfPossible): when the call's resolved
        retry_exceptions setting matches the raised error and retry
        budget remains, requeue it at the front of the actor's queue
        instead of delivering the error."""
        if (spec.actor_id is None or spec.stream is not None
                or spec.retries_left == 0):
            return False
        retry_on = self._actor_retry_exceptions(spec)
        if not retry_on:
            return False
        if retry_on is not True:
            try:
                v = protocol.deserialize_payload(err_payload,
                                                 store=self.store)
                err = v.error if isinstance(v, protocol.ErrorValue) else v
                cause = err.cause if isinstance(err, TaskError) else err
                if not isinstance(cause, tuple(retry_on)):
                    return False
            # rtpu-lint: disable=L4 — an error payload that cannot be
            # deserialized (or a malformed retry_exceptions list) cannot
            # be matched: deliver the original error instead of retrying
            except Exception:  # noqa: BLE001
                return False
        state = self._actors.get(spec.actor_id)
        if state is None or state.dead:
            return False
        if spec.retries_left > 0:
            spec.retries_left -= 1
        with self._lock:
            state.queue.appendleft(spec)
        self._dispatch_actor(state)
        return True

    def _adopt_sealed_actor_result(self, spec: _TaskSpec) -> bool:
        """Exactly-once result delivery for a call in flight at worker
        death: if the worker sealed every return container before dying
        (death landed between the seal and the DONE report flushing),
        adopt the results from the store instead of re-executing the
        call — its side effect already happened exactly once."""
        if spec.cancelled or spec.stream is not None:
            return False
        with self._lock:
            entries = [self._objects.get(rid) for rid in spec.return_ids]
        sealed = True
        for e in entries:
            if e is None or not e.event.is_set():
                sealed = False
                break
        if not sealed:
            try:
                if not all(self.store.contains(rid)
                           for rid in spec.return_ids):
                    return False
            # rtpu-lint: disable=L4 — a store probe that fails (store
            # closing, container racing an eviction) simply means the
            # result is NOT recoverable: fall back to replaying the call
            except Exception:  # noqa: BLE001
                return False
            for rid in spec.return_ids:
                # same descriptor the worker's DONE report would have
                # carried; _store_payload adopts the retained seal ref
                self._store_payload(rid, ("shm", rid.binary()))
        with self._lock:
            self._release_spec_locked(spec)
        self._release_spec_deps(spec)
        self._release_spec_args(spec)
        self._cancellable.pop(spec.return_ids[0].binary(), None)
        self._actor_call_completed(spec)
        return True

    def _actor_restart_deadline(self, state: _ActorState, incarnation: int):
        """actor_restart_timeout_s elapsed for one restart attempt: if
        that SAME restart is still in progress, fail the buffered calls
        with ActorUnavailableError. The restart itself keeps going — a
        later call may find the actor ALIVE again."""
        if self._shutdown:
            return
        with self._lock:
            stuck = (state.restarting and not state.dead
                     and state.incarnation == incarnation)
            buffered = list(state.queue) if stuck else []
            if stuck:
                state.queue.clear()
        if not buffered:
            return
        err = ActorUnavailableError(
            f"actor {state.actor_id.hex()[:12]} did not finish restarting "
            f"within actor_restart_timeout_s="
            f"{config.actor_restart_timeout_s:g}s "
            f"(incarnation {incarnation})")
        for spec in buffered:
            self._cancellable.pop(spec.return_ids[0].binary(), None)
            self._release_spec_args(spec)
            self._store_error(spec.return_ids, err)

    def _on_actor_error(self, w: _Worker, actor_id: ActorID, err_payload):
        state = self._actors.get(actor_id)
        if state is None:
            return
        try:
            v = protocol.deserialize_payload(err_payload, store=self.store)
            err = v.error if isinstance(v, protocol.ErrorValue) else v
        except Exception as e:  # noqa: BLE001
            err = ActorDiedError(f"actor constructor failed: {e}")
        self._mark_actor_dead(state, err)

    def _mark_actor_dead(self, state: _ActorState, cause: BaseException):
        with self._lock:
            if state.dead:
                return  # keep the original death cause
            state.dead = True
            state.ready = False
            state.restarting = False
            state.death_cause = cause
            if state.name and self._named_actors.get(state.name) == \
                    state.actor_id:
                # Terminal death frees the name: a later named create or
                # get-or-create (e.g. a collective coordinator re-formed
                # after a gang restart) must not rendezvous with this
                # corpse (reference: GCS removes the named-actor entry on
                # terminal death).
                del self._named_actors[state.name]
            pending = list(state.queue)
            state.queue.clear()
            self._release_actor_locked(state)
            try:
                self._pending_actors.remove(state)
            except ValueError:
                pass
        state.creation_event.set()
        if (state.restarts_left == 0
                and state.creation_args_payload is not None
                and state.creation_args_payload[0] == "shm"):
            # terminal death: the creation-args container is never needed
            # again — release the adopted ref and free it
            self._unpin_args(state.creation_args_payload[1])
        err = (cause if isinstance(cause, ActorDiedError)
               else self._actor_dead_error(state))
        self._publish_actor_state(state, "DEAD")
        for spec in pending:
            self._store_error(spec.return_ids, err)
        self._retry_pending_pgs()
        self._dispatch()

    def _handle_actor_worker_death(self, actor_id: ActorID):
        state = self._actors.get(actor_id)
        if state is None:
            return
        if state.restarts_left != 0 and not state.dead:
            if state.restarts_left > 0:
                state.restarts_left -= 1
            with self._lock:
                state.ready = False
                state.worker = None
                state.restarting = True
                state.restarting_since = time.monotonic()
                state.incarnation += 1
                incarnation = state.incarnation
            self._publish_actor_state(state, "RESTARTING")
            # bound the RESTARTING window: past the deadline the calls
            # buffered for this incarnation fail with
            # ActorUnavailableError (restarts are rare; one short-lived
            # timer thread per attempt is fine)
            timer = threading.Timer(
                config.actor_restart_timeout_s,
                self._actor_restart_deadline, args=(state, incarnation))
            timer.daemon = True
            timer.start()
            self._actor_start_queue.put(state)
        else:
            self._mark_actor_dead(
                state, ActorDiedError("the actor's worker process died")
            )

    def submit_actor_task(self, actor_id: ActorID, method: str, args: tuple,
                          kwargs: dict, num_returns=1,
                          options: Optional[dict] = None) -> List[ObjectRef]:
        state = self._actors.get(actor_id)
        if state is None:
            raise ActorDiedError(f"unknown actor {actor_id}")
        # RESTARTING admission: buffer, or raise ActorUnavailableError
        # past the buffer/deadline — before any state is built
        self._check_actor_admission(state)
        streaming = num_returns == "streaming"
        if streaming:
            num_returns = 1
        task_id = make_task_id(self.job_id)
        args2, kwargs2, deps = self._swap_top_level_refs(args, kwargs)
        args_payload, _ = protocol.serialize_args(args2, kwargs2, store=self.store)
        return_ids = [ObjectID.from_random() for _ in range(num_returns)]
        for rid in return_ids:
            self._entry(rid)
        if streaming:
            # registered before the dead-actor check so the error routes
            # through the stream (consumer gets a raising ref, then end)
            self._register_stream(return_ids[0].binary())
        if state.dead:
            refs = [ObjectRef(rid, core=self) for rid in return_ids]
            self._store_error(return_ids, self._actor_dead_error(state))
            return refs
        spec = _TaskSpec(task_id, None, args_payload, deps, return_ids,
                         dict(options or {}), actor_id=actor_id,
                         method=method)
        if streaming:
            spec.stream = self._stream_opts(return_ids[0].binary())
        self._cancellable[return_ids[0].binary()] = spec
        self._enqueue(spec)
        return [ObjectRef(rid, core=self) for rid in return_ids]

    def cancel_task(self, ref: ObjectRef, force: bool = False):
        """Best-effort task cancellation (reference: ray.cancel,
        python/ray/_private/worker.py:2970).

        A task still queued (or waiting on deps) is dropped and its caller
        sees TaskCancelledError at get(). A task already executing is
        interrupted with SIGINT (force=False, raising KeyboardInterrupt in
        the worker like the reference) or its worker is killed (force=True).
        Already-finished tasks are unaffected.
        """
        key = ref.id.binary()
        exec_worker = None
        removed = False
        inflight = False
        with self._lock:
            spec = self._cancellable.get(key)
            if spec is None:
                return
            spec.cancelled = True
            try:
                self._task_queue.remove(spec)
                removed = True
            except ValueError:
                pass
            if not removed and spec.actor_id is not None:
                state = self._actors.get(spec.actor_id)
                if state is not None:
                    try:
                        state.queue.remove(spec)
                        removed = True
                    except ValueError:
                        pass
            if not removed:
                tid = spec.task_id.binary()
                for w in self._workers.values():
                    if tid in w.inflight:
                        inflight = True
                        # Only signal when the target is the *executing*
                        # (head) entry — a SIGINT (or force-kill) for a task
                        # batched behind it would take out an innocent
                        # neighbour; batched targets are converted at
                        # completion instead (spec.cancelled check in
                        # _on_task_done).
                        if next(iter(w.inflight)) == tid:
                            exec_worker = w
                        break
        if removed or not inflight:
            # Queued, or still waiting on deps: it never acquired resources
            # and will never run — fail the caller immediately (the
            # reference also fails pending tasks at cancel time).
            self._store_error(spec.return_ids,
                              TaskCancelledError("task was cancelled"))
            self._dispatch()
        elif exec_worker is not None and exec_worker.proc is not None:
            import signal

            try:
                if force:
                    exec_worker.proc.terminate()
                else:
                    os.kill(exec_worker.proc.pid, signal.SIGINT)
            except OSError:
                pass

    def kill_actor(self, actor_id: ActorID, no_restart: bool = True):
        state = self._actors.get(actor_id)
        if state is None:
            return
        if no_restart:
            state.restarts_left = 0
        with self._lock:
            w = state.worker
        if not no_restart and state.restarts_left != 0 and not state.dead:
            # kill(no_restart=False) with restart budget left behaves
            # exactly like a worker death: the budget is consumed and
            # the actor restarts; queued + in-flight calls follow the
            # normal replay path (reference: ray.kill(no_restart=False)
            # routes through the GCS restart FSM, gcs_actor_manager.cc).
            if w is not None and w.proc is not None:
                try:
                    w.proc.kill()
                except OSError:
                    pass
                # reader-thread EOF -> _on_worker_death -> replay +
                # _handle_actor_worker_death consumes the budget
            # no live worker: the actor is starting or already mid-
            # restart — there is no incarnation to kill
            return
        self._mark_actor_dead(state, ActorDiedError("actor was killed via kill()"))
        if w is not None and w.proc is not None:
            # ray.kill semantics are FORCEFUL (no exit handlers), so
            # escalate to SIGKILL — SIGTERM alone is not a kill for
            # processes that trap it (train workers route SIGTERM to the
            # preemption flag, and a worker blocked in a cross-process
            # collective never reaches a python signal handler at all)
            try:
                w.proc.terminate()
                w.proc.kill()
            except OSError:
                pass

    def evict_actor(self, actor_id: ActorID, wait_s: float = 0.5) -> bool:
        """Planned-migration eviction (node drain): remove the local
        incarnation only once its queued and in-flight calls have
        settled — unlike kill_actor, nothing pending is failed and no
        DEAD state is published (the drain migrator already published
        RESTARTING and recreates the actor elsewhere). Returns False
        while calls are still settling, so the caller can keep polling
        inside the drain grace window."""
        state = self._actors.get(actor_id)
        if state is None or state.dead:
            return True
        deadline = time.monotonic() + wait_s
        while True:
            with self._lock:
                w = state.worker
                busy = len(state.queue) + (
                    len(w.inflight) if w is not None else 0)
                if not busy:
                    # settle-and-mark under one hold: a call racing in
                    # after this point fails at submit admission, where
                    # the driver's actor_state retry path re-routes it
                    # to the new incarnation
                    state.dead = True
                    state.migrated = True
                    state.ready = False
                    state.restarting = False
                    state.death_cause = ActorDiedError(
                        "actor migrated off a draining node")
                    if state.name and self._named_actors.get(
                            state.name) == state.actor_id:
                        del self._named_actors[state.name]
                    self._release_actor_locked(state)
                    try:
                        self._pending_actors.remove(state)
                    except ValueError:
                        pass
                    break
            if time.monotonic() >= deadline:
                return False
            time.sleep(0.01)
        state.creation_event.set()
        if w is not None and w.proc is not None:
            try:
                w.proc.terminate()
                w.proc.kill()
            except OSError:
                pass
        self._dispatch()
        return True

    def get_actor_method_opts(self, actor_id: ActorID) -> dict:
        state = self._actors.get(actor_id)
        return state.opts.get("method_opts", {}) if state else {}

    def get_named_actor(self, name: str) -> ActorID:
        with self._lock:
            aid = self._named_actors.get(name)
        if aid is None:
            raise ValueError(f"no actor named {name!r}")
        return aid

    # ------------------------------------------------- placement groups

    def create_placement_group(self, bundles, strategy, name) -> PlacementGroup:
        pg_id = PlacementGroupID.from_random()
        state = PlacementGroupState(pg_id, bundles, strategy, name)
        for b in state.bundles:
            if not b.reserved.is_subset_of(self._total):
                raise ValueError(
                    f"bundle {b.spec} can never fit this node's resources "
                    f"{self._total.to_dict()}"
                )
        if strategy == "STRICT_SPREAD" and len(bundles) > 1:
            state.infeasible_reason = (
                "STRICT_SPREAD requires one node per bundle; the single-node "
                "runtime cannot satisfy it"
            )
        reserved = False
        with self._lock:
            self._pgs[pg_id] = state
            if state.infeasible_reason is None:
                reserved = self._try_reserve_pg_locked(state)
                if not reserved:
                    self._pending_pgs.append(state)
        if reserved:
            self._resolve_pg_waiters(state)
        return PlacementGroup(pg_id, bundles)

    def _try_reserve_pg_locked(self, state: PlacementGroupState) -> bool:
        if state.infeasible_reason or state.removed:
            return False
        total = state.total_request()
        if not total.is_subset_of(self._avail):
            return False
        n_total = int(total.get("GPU"))
        if n_total:
            # one node's GPUs need no contiguity, so every strategy takes
            # n_total ids at once and hands each bundle its share
            if self.gpus is None:
                return False
            ids = self.gpus.allocate(n_total)
            if ids is None:
                return False
            off = 0
            for b in state.bundles:
                n = int(b.reserved.get("GPU"))
                b.gpu_ids = ids[off:off + n]
                b.free_gpu_ids = list(b.gpu_ids)
                off += n
        self._avail = self._avail - total
        state.ready_event.set()
        return True

    def _resolve_pg_waiters(self, state: PlacementGroupState):
        with self._lock:
            waiters = self._pg_ready_waiters.pop(state.id, [])
        payload = protocol.serialize_value(True, store=None)
        for oid in waiters:
            self._store_payload(oid, payload)

    def placement_group_ready_ref(self, pg_id: PlacementGroupID) -> ObjectRef:
        oid = ObjectID.from_random()
        self._entry(oid)
        resolve_now = False
        err = None
        with self._lock:
            state = self._pgs.get(pg_id)
            if state is None:
                err = PlacementGroupError(f"unknown placement group {pg_id}")
            elif state.removed:
                err = PlacementGroupError("placement group was removed")
            elif state.infeasible_reason:
                err = PlacementGroupError(state.infeasible_reason)
            elif state.ready_event.is_set():
                resolve_now = True
            else:
                self._pg_ready_waiters.setdefault(pg_id, []).append(oid)
        if err is not None:
            self._store_error([oid], err)
        elif resolve_now:
            self._store_payload(oid, protocol.serialize_value(True, store=None))
        return ObjectRef(oid, core=self)

    def wait_placement_group(self, pg_id: PlacementGroupID,
                             timeout: float) -> bool:
        with self._lock:
            state = self._pgs.get(pg_id)
        if state is None:
            raise PlacementGroupError(f"unknown placement group {pg_id}")
        return state.ready_event.wait(timeout)

    def placement_group_gpus(self, pg_id: PlacementGroupID,
                             index: int) -> List[str]:
        with self._lock:
            state = self._pgs.get(pg_id)
        if state is None:
            raise PlacementGroupError(f"unknown placement group {pg_id}")
        return list(state.bundles[index].gpu_ids)

    def remove_placement_group(self, pg_id: PlacementGroupID):
        with self._lock:
            state = self._pgs.get(pg_id)
            if state is None or state.removed:
                return
            state.removed = True
            try:
                self._pending_pgs.remove(state)
            except ValueError:
                pass
            if state.ready_event.is_set():
                for b in state.bundles:
                    unconsumed = b.reserved.subtract_unchecked(b.consumed)
                    self._avail = self._avail + unconsumed
                    if self.gpus is not None and b.free_gpu_ids:
                        self.gpus.release(b.free_gpu_ids)
                        b.free_gpu_ids = []
            waiters = self._pg_ready_waiters.pop(pg_id, [])
            orphaned = [s for s in self._task_queue
                        if s.pg_wire is not None and s.pg_wire[1] == pg_id.binary()]
            for s in orphaned:
                self._task_queue.remove(s)
            orphaned_actors = [
                a for a in self._pending_actors
                if a.pg_wire is not None and a.pg_wire[1] == pg_id.binary()
            ]
        err = PlacementGroupError("placement group was removed")
        if waiters:
            self._store_error(waiters, err)
        for s in orphaned:
            self._store_error(s.return_ids, err)
        for a in orphaned_actors:
            self._mark_actor_dead(a, ActorDiedError(
                "placement group was removed before the actor was placed"))
        self._retry_pending_pgs()
        self._dispatch()

    def placement_group_table(self) -> Dict[str, dict]:
        out = {}
        with self._lock:
            for pg_id, state in self._pgs.items():
                out[pg_id.hex()] = {
                    "name": state.name,
                    "strategy": state.strategy,
                    "bundles": [b.spec for b in state.bundles],
                    "gpu_ids": [b.gpu_ids for b in state.bundles],
                    "state": ("REMOVED" if state.removed else
                              "CREATED" if state.ready_event.is_set() else
                              "PENDING"),
                    "infeasible_reason": state.infeasible_reason,
                }
        return out

    def _retry_pending_pgs(self):
        newly_ready = []
        to_start = []
        with self._lock:
            still = []
            for st in self._pending_pgs:
                if self._try_reserve_pg_locked(st):
                    newly_ready.append(st)
                else:
                    still.append(st)
            self._pending_pgs = still
            still_a = []
            for astate in self._pending_actors:
                if astate.dead:
                    continue
                if self._try_acquire_actor_locked(astate):
                    to_start.append(astate)
                else:
                    still_a.append(astate)
            self._pending_actors = still_a
        for st in newly_ready:
            self._resolve_pg_waiters(st)
        for astate in to_start:
            self._actor_start_queue.put(astate)
        if newly_ready:
            self._dispatch()

    def _try_acquire_actor_locked(self, state: _ActorState) -> bool:
        """Acquire an actor's resources (+ concrete GPU ids). Holds _lock."""
        req = state.request
        n_gpus = int(req.get("GPU")) if req is not None else 0
        if state.pg_wire is not None:
            pg = self._pgs.get(PlacementGroupID(state.pg_wire[1]))
            if pg is None or pg.removed or not pg.ready_event.is_set():
                return False
            bundle = pg.find_bundle(req or ResourceSet(), state.pg_wire[2])
            if bundle is None:
                return False
            if n_gpus and len(bundle.free_gpu_ids) < n_gpus:
                return False
            bundle.acquire(req or ResourceSet())
            state.acquired_bundle = bundle
            state.gpu_ids = bundle.take_gpus(n_gpus) if n_gpus else []
            state.resources_acquired = True
            return True
        if req is not None and not req.is_subset_of(self._avail):
            return False
        gpu_ids: List[str] = []
        if n_gpus:
            # a node without the GPUs leaves the actor pending, never on
            # the CPU
            if self.gpus is None:
                return False
            got = self.gpus.allocate(n_gpus)
            if got is None:
                return False
            gpu_ids = got
        if req is not None:
            self._avail = self._avail - req
        state.gpu_ids = gpu_ids
        state.resources_acquired = True
        return True

    def _release_actor_locked(self, state: _ActorState):
        req = state.request
        if req is None or not state.resources_acquired:
            return  # never acquired (still pending) -> nothing to credit
        state.resources_acquired = False
        if state.acquired_bundle is not None:
            state.acquired_bundle.release(req)
            pg_removed = False
            if state.pg_wire is not None:
                pg = self._pgs.get(PlacementGroupID(state.pg_wire[1]))
                pg_removed = pg is None or pg.removed
            if pg_removed:
                if self.gpus is not None and state.gpu_ids:
                    self.gpus.release(state.gpu_ids)
            else:
                state.acquired_bundle.return_gpus(state.gpu_ids)
            state.acquired_bundle = None
        else:
            self._avail = self._avail + req
            if self.gpus is not None and state.gpu_ids:
                self.gpus.release(state.gpu_ids)
        state.request = None
        state.gpu_ids = []

    # ------------------------------------------------------------ data server

    def _apply_worker_submit(self, fn_id, pickled_fn, args_payload,
                             return_ids: List[ObjectID], options: dict):
        """Shared body of REQ_SUBMIT (server-generated ids) and
        REQ_SUBMIT_ASYNC (worker-generated ids, no reply)."""
        if pickled_fn is not None:
            with self._lock:
                self._functions.setdefault(fn_id, pickled_fn)
        options = dict(options)
        deps = options.pop("__deps", [])
        nested = options.pop("__nested", [])
        parent = options.pop("__parent", None)
        streaming = options.pop("__stream", False)
        task_id = make_task_id(self.job_id)
        for rid in return_ids:
            self._entry(rid)
        spec = _TaskSpec(task_id, fn_id, args_payload,
                         [ObjectID(d) for d in deps], return_ids, options)
        spec.parent_task = parent
        spec.nested_deps = [ObjectID(b) for b in nested]
        spec.request, spec.pg_wire = self._prepare_request(
            options, is_actor=False)
        self._cancellable[return_ids[0].binary()] = spec
        if streaming:
            seed = return_ids[0].binary()
            spec.stream = self._stream_opts(seed)
            self._register_stream(seed)
        else:
            self._record_lineage(spec)
        self._enqueue(spec)

    def _apply_worker_actor_call(self, actor_id_b, method, args_payload,
                                 extra: dict, return_ids: List[ObjectID]):
        """Shared body of REQ_ACTOR_CALL / REQ_ACTOR_CALL_ASYNC."""
        state = self._actors.get(ActorID(actor_id_b))
        if state is None:
            raise ActorDiedError("unknown actor")
        deps = [ObjectID(d) for d in extra.get("__deps", [])]
        task_id = make_task_id(self.job_id)
        for rid in return_ids:
            self._entry(rid)
        spec = _TaskSpec(task_id, None, args_payload, deps, return_ids,
                         dict(extra.get("__opts") or {}),
                         actor_id=state.actor_id, method=method)
        spec.parent_task = extra.get("__parent")
        if extra.get("__stream"):
            seed = return_ids[0].binary()
            spec.stream = self._stream_opts(seed)
            self._register_stream(seed)
        if state.dead:
            self._store_error(return_ids, self._actor_dead_error(state))
        else:
            # raises ActorUnavailableError past the RESTARTING buffer;
            # the data-server handlers preserve ActorError subtypes
            self._check_actor_admission(state)
            self._enqueue(spec)

    def _data_server(self, w: _Worker):
        conn = w.data_conn
        try:
            while True:
                msg = conn.recv()
                try:
                    reply = self._handle_data_request(w, msg)
                except BaseException as e:  # noqa: BLE001
                    # Preserve the exception type (GetTimeoutError,
                    # ActorDiedError, ...) so worker-side handlers behave
                    # exactly like driver-side ones. Errors in a
                    # fire-and-forget request have no reply channel —
                    # they were already stored into the return entries
                    # (or are put-metadata failures, surfaced at get).
                    if msg and str(msg[0]).endswith("_async"):
                        continue
                    reply = ("err", protocol.serialize_value(
                        protocol.ErrorValue(e), store=None))
                if reply is not protocol.NO_REPLY:
                    conn.send(reply)
        except (EOFError, OSError):
            pass

    def register_package(self, pkg_hash: str, data: bytes) -> None:
        """Store a runtime_env package (driver-side prepare)."""
        self._packages[pkg_hash] = data

    def _get_package(self, pkg_hash: str):
        return self._packages.get(pkg_hash)

    def prepare_runtime_env(self, runtime_env):
        from ray_tpu_torch.core import runtime_env as _re

        return _re.prepare(self, runtime_env)

    def _handle_data_request(self, w: _Worker, msg):
        tag = msg[0]
        if tag == protocol.REQ_GET:
            _, oid_bytes_list, timeout_ms, cur_task = msg
            timeout = None if timeout_ms < 0 else timeout_ms / 1000.0
            deadline = None if timeout is None else time.monotonic() + timeout
            payloads = {}
            entries = [self._entry(ObjectID(b)) for b in oid_bytes_list]
            if not all(e.event.is_set() for e in entries):
                self._mark_worker_blocked(w, cur_task)
            try:
                for b, e in zip(oid_bytes_list, entries):
                    while True:
                        remaining = None if deadline is None else max(
                            0.0, deadline - time.monotonic())
                        if not e.event.wait(remaining):
                            raise GetTimeoutError(
                                "get() timed out in worker request")
                        payload = e.payload
                        if payload is None:
                            # reset mid-reconstruction: wait for the
                            # recomputed value
                            continue
                        if self._payload_lost(payload):
                            if self._recover_object(b):
                                continue
                            # unrecoverable: ship the enriched error so
                            # the worker's read raises it
                            payload = protocol.serialize_value(
                                protocol.ErrorValue(self._lost_error(b)),
                                store=None)
                        payloads[b] = payload
                        break
            finally:
                self._unmark_worker_blocked(w, cur_task)
            return ("ok", payloads)
        if tag == protocol.REQ_NEED_SPACE:
            return ("ok", self._try_free_space(msg[1]))
        if tag == protocol.REQ_TASK_CANCELLED:
            with self._lock:
                spec = w.inflight.get(msg[1])
            return ("ok", bool(spec is not None and spec.cancelled))
        if tag == protocol.REQ_FREE:
            return ("ok", self.free_objects(msg[1]))
        if tag == protocol.REQ_KILL_ACTOR:
            self.kill_actor(ActorID(msg[1]), no_restart=msg[2])
            return ("ok",)
        if tag == protocol.REQ_PUT_META:
            _, oid_bytes, payload = msg
            oid = ObjectID(oid_bytes)
            self._store_payload(oid, ("shm", oid_bytes) if payload is None else payload)
            return ("ok",)
        if tag == protocol.REQ_PUT_META_ASYNC:
            _, oid_bytes, payload = msg
            oid = ObjectID(oid_bytes)
            try:
                self._store_payload(
                    oid, ("shm", oid_bytes) if payload is None else payload)
            except BaseException as e:  # noqa: BLE001 — no reply channel:
                # the worker already holds the ref, so the error must
                # live in the entry or a later get() hangs forever
                self._store_error(
                    [oid], TaskError(f"put failed owner-side: {e!r}"))
            return protocol.NO_REPLY
        if tag == protocol.REQ_BARRIER:
            # sync point: all earlier fire-and-forget sends on this conn
            # are applied once this replies (FIFO per connection)
            return ("ok",)
        if tag == protocol.REQ_STREAM_NEXT:
            # one bounded wait slice (the worker loops on "pending", so a
            # cancel SIGINT never lands mid-recv of an unbounded request)
            _, seed, index, timeout_ms, owner = msg
            st = self._streams.get(seed)
            if st is None:
                raise ValueError(f"unknown stream {seed.hex()}")
            with st.cond:
                hit = self._stream_poll_locked(st, index)
            if hit is not None:
                return hit
            deadline = time.monotonic() + timeout_ms / 1000.0
            self._mark_worker_blocked(w, None)
            try:
                with st.cond:
                    while True:
                        hit = self._stream_poll_locked(st, index)
                        if hit is not None:
                            return hit
                        remaining = deadline - time.monotonic()
                        if remaining <= 0:
                            return ("pending",)
                        st.cond.wait(remaining)
            finally:
                self._unmark_worker_blocked(w, None)
        if tag == protocol.REQ_STREAM_CREDIT:
            _, seed, produced = msg
            st = self._streams.get(seed)
            if st is None:
                # stream reaped/unknown: report full consumption so a
                # producer can never block on a dead stream
                return ("ok", produced)
            with st.cond:
                return ("ok", st.consumed)
        if tag == protocol.REQ_STREAM_CONSUMED_ASYNC:
            _, seed, index, owner = msg
            self.stream_consumed(seed, index)
            return protocol.NO_REPLY
        if tag == protocol.REQ_SUBMIT_ASYNC:
            # worker pre-generated the return ids: apply without replying
            _, fn_id, pickled_fn, args_payload, inline_values, \
                return_ids_b, options = msg
            return_ids = [ObjectID(b) for b in return_ids_b]
            try:
                self._apply_worker_submit(fn_id, pickled_fn, args_payload,
                                          return_ids, options)
            except BaseException as e:  # noqa: BLE001 — surface at get()
                self._store_error(
                    return_ids, e if isinstance(e, TaskError)
                    else TaskError(f"submission failed: {e!r}"))
            return protocol.NO_REPLY
        if tag == protocol.REQ_ACTOR_CALL_ASYNC:
            _, actor_id_b, method, args_payload, extra, return_ids_b = msg
            return_ids = [ObjectID(b) for b in return_ids_b]
            try:
                self._apply_worker_actor_call(actor_id_b, method,
                                              args_payload, extra,
                                              return_ids)
            except BaseException as e:  # noqa: BLE001 — surface at get()
                from ray_tpu_torch.exceptions import ActorError

                # _store_error creates missing entries itself; ActorError
                # subtypes (ActorDiedError, ActorUnavailableError) must
                # reach the caller as-is
                self._store_error(
                    return_ids, e if isinstance(e, ActorError)
                    else ActorDiedError(f"actor call failed: {e!r}"))
            return protocol.NO_REPLY
        if tag == protocol.REQ_SUBMIT:
            _, fn_id, pickled_fn, args_payload, inline_values, n_returns, options = msg
            return_ids = [ObjectID.from_random() for _ in range(n_returns)]
            self._apply_worker_submit(fn_id, pickled_fn, args_payload,
                                      return_ids, options)
            return ("ok", [r.binary() for r in return_ids])
        if tag == protocol.REQ_ACTOR_CALL:
            _, actor_id_b, method, args_payload, extra, n_returns = msg
            return_ids = [ObjectID.from_random() for _ in range(n_returns)]
            self._apply_worker_actor_call(actor_id_b, method, args_payload,
                                          extra, return_ids)
            return ("ok", [r.binary() for r in return_ids])
        if tag == protocol.REQ_WAIT:
            _, oid_bytes_list, num_returns, timeout_s, cur_task = msg
            refs = [ObjectRef(ObjectID(b), core=self) for b in oid_bytes_list]
            self._mark_worker_blocked(w, cur_task)
            try:
                ready, rest = self.wait(refs, num_returns=num_returns,
                                        timeout=timeout_s)
            finally:
                self._unmark_worker_blocked(w, cur_task)
            return ("ok", [x.binary() for x in ready], [x.binary() for x in rest])
        if tag == protocol.REQ_PKG:
            return ("ok", self._get_package(msg[1]))
        if tag == protocol.REQ_PKG_PUT:
            self.register_package(msg[1], msg[2])
            return ("ok", None)
        if tag == protocol.REQ_KV:
            _, op, key, value = msg
            if op == "get":
                return ("ok", self._kv.get(key))
            if op == "put":
                self._kv[key] = value
                return ("ok", None)
            if op == "del":
                self._kv.pop(key, None)
                return ("ok", None)
            raise ValueError(f"bad kv op {op}")
        if tag == protocol.REQ_PUBSUB:
            _, op, channel, arg, timeout = msg
            return ("ok", self.pubsub_op(op, channel, arg, timeout))
        if tag == protocol.REQ_PG:
            _, op, *args = msg
            if op == "create":
                bundles, strategy, name = args
                pg = self.create_placement_group(bundles, strategy, name)
                return ("ok", (pg.id.binary(), pg.bundle_specs))
            if op == "remove":
                self.remove_placement_group(PlacementGroupID(args[0]))
                return ("ok", None)
            if op == "ready_ref":
                ref = self.placement_group_ready_ref(PlacementGroupID(args[0]))
                return ("ok", ref.binary())
            if op == "wait":
                return ("ok", self.wait_placement_group(
                    PlacementGroupID(args[0]), args[1]))
            if op == "gpus":
                return ("ok", self.placement_group_gpus(
                    PlacementGroupID(args[0]), args[1]))
            if op == "table":
                return ("ok", self.placement_group_table())
            raise ValueError(f"unknown pg op {op!r}")
        if tag == protocol.REQ_CREATE_ACTOR:
            _, fn_id, pickled_cls, args_payload, deps, opts = msg
            if pickled_cls is not None:
                with self._lock:
                    self._functions.setdefault(fn_id, pickled_cls)
            actor_id = self._create_actor_from_payload(
                fn_id, args_payload, [ObjectID(d) for d in deps], opts or {})
            return ("ok", actor_id.binary())
        if tag == protocol.REQ_CANCEL:
            _, oid_bytes, force = msg
            self.cancel_task(ObjectRef(ObjectID(oid_bytes), core=self),
                             force=force)
            return ("ok", None)
        if tag == protocol.REQ_GET_ACTOR:
            _, name = msg
            aid = self.get_named_actor(name)
            from ray_tpu_torch.core.actor import ActorHandle

            handle = ActorHandle(aid, self.get_actor_method_opts(aid))
            return ("ok", protocol.serialize_value(handle, store=None))
        raise ValueError(f"unknown data request {tag!r}")

    # -------------------------------------------------------------- lifecycle

    def stack_dump(self, timeout_s: float = 2.0) -> Dict[str, str]:
        """Live profile of every worker: SIGUSR1 triggers each worker's
        stack-dump handler, then the dump files are collected
        (reference role: the dashboard's py-spy stack endpoint). Returns
        {worker_id_hex: stacks_text}."""
        import signal as _signal

        from ray_tpu_torch.core.proc_stats import stack_dump_path

        with self._lock:
            targets = [(w.worker_id.hex(), w.proc.pid)
                       for w in self._workers.values()
                       if w.alive and w.proc is not None]
        paths = {}
        for wid, pid in targets:
            path = stack_dump_path(pid)
            try:
                os.unlink(path)
            except OSError:
                pass
            try:
                os.kill(pid, _signal.SIGUSR1)
                paths[wid] = path
            except OSError:
                continue
        out: Dict[str, str] = {}
        deadline = time.monotonic() + timeout_s
        while paths and time.monotonic() < deadline:
            for wid, path in list(paths.items()):
                try:
                    with open(path) as f:
                        out[wid] = f.read()
                    paths.pop(wid)
                    os.unlink(path)
                except OSError:
                    continue
            if paths:
                time.sleep(0.02)
        for wid in paths:
            out[wid] = "<no dump: worker busy in non-python code>"
        return out

    def state_summary(self) -> dict:
        """Introspection snapshot for the state API (reference:
        python/ray/util/state/api.py:781 backed by the GCS/raylet state
        services; here the runtime answers directly)."""
        from ray_tpu_torch.core.proc_stats import CpuTracker

        with self._lock:
            if not hasattr(self, "_cpu_tracker"):
                self._cpu_tracker = CpuTracker()
            self._cpu_tracker.prune(
                w.proc.pid for w in self._workers.values()
                if w.proc is not None)
            workers = []
            for w in self._workers.values():
                pid = w.proc.pid if w.proc else None
                entry = {
                    "worker_id": w.worker_id.hex(),
                    "pid": pid,
                    "alive": w.alive,
                    "actor_id": w.actor_id.hex() if w.actor_id else None,
                    "inflight": len(w.inflight),
                    "blocked": w.blocked,
                }
                # per-process CPU/RSS from /proc (reference:
                # reporter_agent.py:428 via psutil)
                if pid is not None and w.alive:
                    ps = self._cpu_tracker.stats(pid)
                    if ps is not None:
                        entry.update(ps)
                workers.append(entry)
            actors = [{
                "actor_id": s.actor_id.hex(),
                "name": s.name,
                "state": ("DEAD" if s.dead else
                          "RESTARTING" if s.restarting else
                          "ALIVE" if s.ready else "PENDING"),
                "restarts_left": s.restarts_left,
                "incarnation": s.incarnation,
                "queued_calls": len(s.queue),
            } for s in self._actors.values()]
            queued = len(self._task_queue)
            running = sum(len(w.inflight) for w in self._workers.values())
            objects = len(self._objects)
            resolved = sum(1 for e in self._objects.values()
                           if e.event.is_set())
            resources = {"total": self._total.to_dict(),
                         "available": self._avail.to_dict()}
            n_pgs = len(self._pgs)
        with self._spill_lock:
            pinned = len(self._pinned)
            spilled_bytes = self._spilled_bytes
        return {
            "node_id": self.node_id.hex(),
            "workers": workers,
            "actors": actors,
            "tasks": {"queued": queued, "running": running},
            "objects": {"tracked": objects, "resolved": resolved,
                        "pinned": pinned, "spilled_bytes": spilled_bytes},
            "resources": resources,
            "store": self.store.stats(),
            "placement_groups": n_pgs,
        }

    def kv_op(self, op: str, key: str, value=None):
        if op == "get":
            return self._kv.get(key)
        if op == "put":
            self._kv[key] = value
            return None
        if op == "del":
            self._kv.pop(key, None)
            return None
        raise ValueError(op)

    _CHANNEL_CAP = 10_000

    def pubsub_op(self, op: str, channel: str, arg=None,
                  timeout: float = 0.0):
        """Single-node mirror of the GCS pubsub plane (gcs.py
        _op_publish/_op_poll): ``publish`` appends to a bounded
        per-channel log and returns the seq; ``poll`` long-polls for
        messages with seq > arg, returning [(seq, message)]. Seqs are
        contiguous per channel so a slow subscriber can detect trimming.
        In cluster mode the overriding cores route these to the GCS."""
        if op == "publish":
            with self._pubsub_cond:
                seq = self._channel_seq.get(channel, 0) + 1
                self._channel_seq[channel] = seq
                log = self._channels.setdefault(channel, [])
                log.append((seq, arg))
                if len(log) > self._CHANNEL_CAP:
                    del log[: len(log) - self._CHANNEL_CAP]
                self._pubsub_cond.notify_all()
                return seq
        if op == "poll":
            since_seq = int(arg or 0)
            deadline = time.monotonic() + timeout
            with self._pubsub_cond:
                while True:
                    if self._channel_seq.get(channel, 0) > since_seq:
                        log = self._channels[channel]
                        first_seq = log[0][0]
                        start = max(0, since_seq + 1 - first_seq)
                        return log[start:]
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return []
                    self._pubsub_cond.wait(remaining)
        raise ValueError(op)

    # -------------------------------------------------- memory monitor

    def _memory_monitor_loop(self):
        """Poll memory usage; above the threshold, kill one worker per
        tick by the group-by-owner policy so the node sheds load instead
        of letting the kernel OOM-kill it wholesale."""
        from ray_tpu_torch.core.memory_monitor import MemoryMonitor

        mon = MemoryMonitor(limit_bytes=config.memory_limit_bytes)
        while not self._shutdown:
            time.sleep(config.memory_monitor_interval_s)
            try:
                mon.limit_bytes = config.memory_limit_bytes  # reloadable
                with self._lock:
                    pids = [w.proc.pid for w in self._workers.values()
                            if w.alive and w.proc is not None]
                if mon.usage_fraction(pids) >= config.memory_usage_threshold:
                    self._kill_for_memory()
            # rtpu-lint: disable=L4 — crash-proof daemon loop: losing
            # the monitor silently disables OOM protection for the rest
            # of the session; one bad poll just skips a tick
            except Exception:  # noqa: BLE001 — monitoring must not die
                pass

    def _kill_for_memory(self):
        """Pick and SIGKILL one victim worker (reference policy,
        worker_killing_policy_group_by_owner.h): group running tasks by
        owner (submitting parent), prefer the group with the most
        in-flight tasks, and within it the NEWEST dispatch — last-in
        first-killed keeps earlier (likely further-along) work alive.
        Retriable tasks are preferred over non-retriable; actor workers
        are a last resort (their death is more disruptive)."""
        with self._lock:
            task_workers = []   # (group_size, dispatched_ts, worker)
            groups: Dict[Optional[str], int] = {}
            for w in self._workers.values():
                if not w.alive or w.actor_id is not None or not w.inflight:
                    continue
                head = next(iter(w.inflight.values()))
                groups[head.parent_task] = groups.get(head.parent_task,
                                                      0) + 1
            for w in self._workers.values():
                if not w.alive or w.actor_id is not None or not w.inflight:
                    continue
                head = next(iter(w.inflight.values()))
                retriable = (config.task_oom_retries < 0
                             or head.oom_kills < config.task_oom_retries)
                task_workers.append((
                    0 if retriable else 1,       # retriable first
                    -groups.get(head.parent_task, 0),  # biggest group
                    -head.dispatched_ts,         # newest dispatch
                    id(w), w))
            victim = None
            if task_workers:
                task_workers.sort(key=lambda t: t[:4])
                victim = task_workers[0][4]
            else:
                # no plain-task candidates: newest busy actor worker
                actors = [w for w in self._workers.values()
                          if w.alive and w.actor_id is not None
                          and w.inflight]
                if actors:
                    victim = actors[-1]
            if victim is None:
                return
            victim.oom_killed = True
            self._oom_kill_count += 1
        # kill the DESCENDANTS first: bounded-mode accounting charges the
        # worker's whole tree, so forked helpers (mp pools, loaders) must
        # die with it or their RSS survives the kill and the monitor
        # starts executing innocent workers
        try:
            from ray_tpu_torch.core.memory_monitor import _descendants

            pid = victim.proc.pid
            for child in _descendants([pid]):
                if child != pid:
                    try:
                        os.kill(child, signal.SIGKILL)
                    except (ProcessLookupError, PermissionError):
                        pass
            victim.proc.kill()
        # rtpu-lint: disable=L4 — the victim (or its /proc entries) may
        # vanish mid-walk; an incomplete kill pass must not take the
        # memory monitor down with it
        except Exception:  # noqa: BLE001
            pass

    def prestart_workers(self, num: int):
        """Pre-spawn up to ``num`` EXTRA idle workers ahead of an
        anticipated burst (reference: WorkerPool::PrestartWorkers,
        src/ray/raylet/worker_pool.h:344 — there driven by task-backlog
        hints). With the zygote this is ~10ms each; surplus workers are
        retired by the normal pool-trim path once load passes."""
        with self._lock:
            if self._shutdown:
                return
            have = sum(1 for w in self._workers.values()
                       if w.alive and w.actor_id is None) + self._spawning
            want = min(num, 4 * self.num_workers - have)
        for _ in range(max(0, want)):
            self._spawn_worker()

    def wait_for_workers(self, count: Optional[int] = None,
                         timeout: Optional[float] = None):
        from ray_tpu_torch.core.config import config

        if timeout is None:
            timeout = config.worker_register_timeout_s
        count = count or self.num_workers
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                n = sum(1 for w in self._workers.values() if w.ready)
            if n >= count:
                return
            time.sleep(0.005)
        raise TimeoutError(f"only some workers became ready within {timeout}s")

    def shutdown(self):
        if self._shutdown:
            return
        self._shutdown = True
        with self._lock:
            workers = list(self._workers.values())
        for w in workers:
            try:
                if w.task_conn is not None:
                    self._send_msg(w, (protocol.MSG_SHUTDOWN,))
            except (OSError, EOFError, BrokenPipeError):
                pass
        from ray_tpu_torch.core.config import config

        deadline = time.monotonic() + config.worker_shutdown_grace_s
        for w in workers:
            if w.proc is None:
                continue  # still being launched: _launch raced shutdown
            try:
                w.proc.wait(timeout=max(0.05, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                w.proc.kill()
        with self._zygote_lock:
            # claim the zygote under its lock: a concurrent respawn can
            # drop/replace it (_fork_from_zygote nulls a wedged zygote),
            # so an unlocked check-then-terminate races to AttributeError
            zygote, self._zygote = self._zygote, None
        if zygote is not None:
            try:
                zygote.stdin.close()  # EOF -> zygote exits
                zygote.terminate()
            except (OSError, ValueError):
                pass  # pipe already broken / zygote already gone
        try:
            self._listener.close()
        except OSError:
            pass
        try:
            os.unlink(self._sock_path)
        except (OSError, ValueError):  # ValueError: an abstract address
            pass
        self.store.close()
        if self._log_monitor is not None:
            self._log_monitor.stop(flush=True)  # drain final worker output
        import shutil

        external_storage.cleanup_dir(self._spill_dir)
        shutil.rmtree(self._session_dir, ignore_errors=True)
        if runtime_context.get_core_or_none() is self:
            runtime_context.set_core(None)
