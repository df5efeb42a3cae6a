"""Central configuration registry: every core tunable in one table.

Analogue of the reference's RayConfig x-macro flag system
(src/ray/common/ray_config_def.h:22 — 215 ``RAY_CONFIG(type, name,
default)`` entries, overridable per-process via ``RAY_<name>`` env vars).
Here the table is a list of ``Flag`` rows; each flag is overridable via the
``RTPU_<NAME>`` environment variable (upper-cased flag name), read once at
import and refreshable with ``config.reload()`` (tests) — so a flag set in
the driver's environment propagates to workers, which inherit the env.

Usage::

    from ray_tpu_torch.core.config import config
    if config.fault_dump_after_s > 0: ...

``python -m ray_tpu_torch.core.config`` prints the full table with docs,
defaults, and current values.

The rows are those of the reference's table (``ray_tpu/core/config.py``)
that port code reads, under the same ``RTPU_*`` variables, so one
environment configures both packages; ``gpus`` takes the place of the
TPU rows. The rows of the parts the port has not taken over yet (the
job agent, the autoscaler) come with the code that reads them.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Dict, List


@dataclass(frozen=True)
class Flag:
    name: str
    type: type
    default: Any
    doc: str

    @property
    def env_var(self) -> str:
        return "RTPU_" + self.name.upper()


def _parse_bool(s: str) -> bool:
    return s.strip().lower() not in ("", "0", "false", "no", "off")


# The table. Keep alphabetized within each section.
_FLAGS: List[Flag] = [
    # ---- core runtime ----------------------------------------------------
    Flag("fault_dump_after_s", float, 0.0,
         "If > 0, every worker dumps all thread stacks to "
         "<tmp>/rtpt_worker_dump_<pid>.txt after this many seconds "
         "(hang triage; reference analogue: RAY_testing_asio_delay_us "
         "class of debug knobs)."),
    Flag("gpus", int, 0,
         "If > 0, the node's GPU count, overriding detection (ids 0.."
         "n-1; scheduling tests on hosts without cards). Read at call "
         "time from RTPU_GPUS in resources.GpuSet.detect(), not via "
         "config resolution. The port's counterpart of the reference's "
         "tpu_topology row."),
    Flag("inline_threshold_bytes", int, 100 * 1024,
         "Results/args at or below this size travel inline in control "
         "messages; larger values go through the shm object store "
         "(reference: max_direct_call_object_size, ray_config_def.h)."),
    Flag("max_dispatch_batch", int, 32,
         "Upper bound on tasks pipelined to one worker in a single "
         "dispatch message (amortizes the driver->worker message cost; "
         "reference analogue: leased-worker pipelining)."),
    Flag("object_store_memory_fraction", float, 0.3,
         "Default shm store capacity as a fraction of system RAM when "
         "object_store_memory is not passed to init() (reference: "
         "object_store_memory default heuristic in services.py)."),
    Flag("store_lib", str, "",
         "Path to a prebuilt object-store shared library, overriding "
         "the bundled/compiled one (store-corruption tests, custom "
         "builds). Read at call time from RTPU_STORE_LIB in "
         "object_store.store._load_lib, not via config resolution, "
         "because store subprocesses receive it through their env."),
    Flag("streaming_generator_backpressure", int, 16,
         "Max in-flight (produced-but-unconsumed) returns a "
         "num_returns='streaming' generator may buffer before its worker "
         "blocks waiting for the consumer to catch up; 0 disables "
         "backpressure (reference: "
         "_generator_backpressure_num_objects, _raylet.pyx)."),
    Flag("worker_register_timeout_s", float, 30.0,
         "How long wait_for_workers waits for the pool to come up."),
    Flag("worker_shutdown_grace_s", float, 2.0,
         "Grace period for workers to exit at shutdown before SIGKILL."),
    # ---- compiled dags ---------------------------------------------------
    Flag("dag_compile_actor_wait_s", float, 5.0,
         "compile_dag deadline for a bound actor to finish registering "
         "with the cluster (actor creation is async; the DAG compiler "
         "races it). Lookup failures past the deadline name the actor."),
    Flag("dag_device_channels", str, "auto",
         "On-device DAG edges: 'auto' uses a DeviceChannel (torch "
         "tensors handed off by reference, doorbell-only shm) for edges "
         "between stages of the same GPU actor process, falling back to "
         "shm channels elsewhere; 'off' forces shm everywhere; 'force' "
         "uses device edges for any same-process edge, GPU or not "
         "(tests exercise the handoff on the CPU)."),
    Flag("dag_spin_us", int, 50,
         "Busy-poll budget in microseconds for compiled-DAG channel "
         "waits before falling back to the condvar (0 = pure block). "
         "The spin loop yields the CPU each poll round, so the default "
         "is safe on 1-core hosts; raise toward ~200 on multi-core "
         "hosts where the peer runs truly in parallel."),
    # ---- observability ---------------------------------------------------
    Flag("log_to_driver", bool, True,
         "Stream worker stdout/stderr lines to the driver's stderr with "
         "(worker=<id> out|err) prefixes (reference: ray.init "
         "log_to_driver + log_monitor.py)."),
    Flag("log_monitor_interval_s", float, 0.2,
         "Poll interval of the driver/node log monitor thread."),
    Flag("worker_log_redirect", bool, True,
         "Redirect each worker's stdout/stderr to per-worker files under "
         "the session log dir (worker-<id8>.out|err). Disabling inherits "
         "the parent's terminal (debug)."),
    Flag("task_events_enabled", bool, False,
         "Record task lifecycle events (submit/dispatch/done per task) "
         "for ray_tpu_torch.timeline() chrome-trace export (reference: "
         "RAY_task_events_* flags + ray.timeline, "
         "python/ray/_private/state.py chrome_tracing_dump)."),
    # ---- fault tolerance -------------------------------------------------
    Flag("actor_restart_buffer_max", int, 1000,
         "How many calls may queue on a RESTARTING actor before new "
         "submissions raise ActorUnavailableError instead of buffering "
         "(reference: the bounded client queue in "
         "actor_task_submitter.h)."),
    Flag("actor_restart_timeout_s", float, 30.0,
         "Deadline for one actor restart: calls buffered longer than "
         "this (and new calls submitted past it) fail with "
         "ActorUnavailableError while the restart keeps going "
         "(reference: timeout_ms on the GCS actor restart path)."),
    Flag("task_max_retries", int, 3,
         "Default retry budget for tasks whose worker died mid-execution "
         "(reference: max_retries / task_retry_delay_ms, "
         "src/ray/core_worker/task_manager.h). Application exceptions are "
         "not retried."),
    Flag("max_reconstructions", int, 3,
         "How many times the driver resubmits a task to reconstruct a "
         "lost object before giving up (reference: "
         "object_recovery_manager.h)."),
    Flag("spill_dir", str, "",
         "Spill location under store memory pressure (empty: "
         "<tmp>/rtpt_spill, <tmp> being tempfile.gettempdir()): a local "
         "directory (mmap'd reads) or any fsspec URI (s3://..., gs://...). URI "
         "backends must be reachable from EVERY process — memory:// is "
         "driver-process-only, for tests (reference: "
         "object_spilling_config + external_storage.py S3 spilling)."),
    Flag("lineage_max_bytes", int, 256 << 20,
         "Byte budget for the driver's lineage table (serialized task "
         "descriptions kept for object reconstruction); oldest entries "
         "are evicted past it (reference: max_lineage_bytes)."),
    # ---- train / elastic gangs -------------------------------------------
    Flag("elastic_grow_cooldown_s", float, 3.0,
         "Minimum spacing between attempts to grow an elastic training "
         "gang back toward its target world size. Each attempt probes "
         "for capacity by creating one replacement worker; the cooldown "
         "keeps a capacity-starved cluster from paying a probe (and a "
         "failed placement) every step."),
    Flag("elastic_grow_probe_timeout_s", float, 10.0,
         "How long a grow attempt waits for the probe worker to come up "
         "in its placement bundle before concluding capacity has not "
         "returned (the probe actor is killed and the gang stays at its "
         "current size)."),
    Flag("train_pg_ready_timeout_s", float, 60.0,
         "How long WorkerGroup.start waits for the gang's placement "
         "group before failing with PlacementGroupError; the error "
         "names the first bundle the node cannot satisfy."),
    # ---- serve / overload ------------------------------------------------
    Flag("serve_affinity_load_penalty", float, 64.0,
         "Cache-affinity load discount: estimated matched-prefix tokens "
         "a replica's score loses per router-local in-flight request on "
         "it. Higher values make affinity defer to load balance sooner "
         "(a replica must hold that many MORE cached prefix tokens to "
         "beat a one-request-lighter peer); 0 routes to the best cache "
         "holder regardless of load."),
    Flag("serve_affinity_min_prefix_tokens", int, 16,
         "Minimum estimated matched-prefix tokens before cache-affinity "
         "routing overrides power-of-two choices. Below this, the "
         "prefill saved is too small to justify skewing load — the "
         "request routes blind. Must be at least one page to ever "
         "match (prefix fingerprints cover full pages only)."),
    Flag("serve_cache_affinity", bool, False,
         "Prefix-cache-aware routing: engine replicas publish a bounded "
         "digest of their cached KV prefix fingerprints; the router "
         "scores candidates by estimated matched-prefix tokens minus a "
         "load penalty (serve_affinity_load_penalty) and routes to the "
         "best holder when the match clears "
         "serve_affinity_min_prefix_tokens. Off (default) keeps the "
         "seed power-of-two router byte-identical — no digest polling, "
         "no extra RNG draws."),
    Flag("serve_dag_spin_us", int, -1,
         "Busy-poll budget for serve dag_mode pipelines (the replica->"
         "engine hot path compiled onto DAG channels); -1 inherits "
         "dag_spin_us, 0 forces pure-block channels for serve only."),
    Flag("serve_disagg", bool, False,
         "Prefill/decode disaggregation for paged engine replicas: long "
         "prompts divert to dedicated prefill workers whose finished KV "
         "pages are adopted by the decode engine as cached prefixes. "
         "serve.disagg.engine_class() resolves the flag."),
    Flag("serve_eject_ttft_ratio", float, 3.0,
         "Gray-replica detection bar (serve_replica_ejection on): a "
         "replica whose TTFT EWMA exceeds this multiple of the median "
         "of its peers' EWMAs (after a minimum observation count) is "
         "ejected from the router's pick set until the hysteresis "
         "cooldown expires or the controller replaces it."),
    Flag("serve_max_queue_depth", int, 0,
         "Default per-deployment admission cap: router-local requests in "
         "flight (admitted, not yet completed) beyond which new requests "
         "are shed with BackpressureError, lowest priority class first "
         "(low sheds at 1/3 of the cap, normal at 2/3, high at the full "
         "cap). 0 = unbounded — admission is a no-op, exactly the "
         "pre-QoS behavior. Per-deployment 'max_queue_depth' config "
         "overrides this default."),
    Flag("serve_prefill_workers", int, 1,
         "Dedicated prefill workers per disaggregated engine: each owns "
         "a private staging KV pool of the engine's geometry and "
         "prefills diverted prompts on its own CUDA stream."),
    Flag("serve_replay_max_attempts", int, 3,
         "Total dispatch attempts per request under serve_request_replay "
         "(first try + replays). Every replay re-picks a replica via the "
         "affinity scorer; an exhausted budget surfaces "
         "ReplicaUnavailableError carrying the attempt count and the "
         "last cause."),
    Flag("serve_replica_ejection", bool, False,
         "Gray-replica ejection: the router scores per-replica health "
         "(TTFT EWMA outlier vs the deployment median, consecutive "
         "dispatch-failure streak, engine-poll staleness) and stops "
         "picking ejected replicas; routers report ejections with their "
         "load reports and the controller probes and replaces "
         "persistently gray replicas (reports that stop refreshing "
         "restore the replica instead). Off (default) keeps the pick "
         "path byte-identical to the seed pow-2 router."),
    Flag("serve_replica_wait_s", float, 30.0,
         "How long the router waits for a running replica to appear "
         "before failing the request with ReplicaUnavailableError "
         "(deployment deleted, never deployed, or all replicas down)."),
    Flag("serve_request_replay", bool, False,
         "Durable request replay: every unary/batch/call_method request "
         "carries a dedup nonce recorded in the router's request "
         "ledger; on replica death or call timeout the router re-picks "
         "(affinity-aware) and replays up to serve_replay_max_attempts, "
         "with replica-side nonce dedup collapsing at-least-once "
         "execution to exactly-once results. Also enables mid-stream "
         "resume: an engine token stream that loses its replica "
         "resubmits prompt + delivered tokens to the best affinity "
         "candidate and splices at the delivered-token watermark. Off "
         "(default) keeps the seed 3-attempt retry loops and the wire "
         "payloads byte-identical."),
    Flag("serve_shutdown_grace_s", float, 15.0,
         "How long serve controller shutdown waits for backgrounded "
         "replica stops (graceful_shutdown + kill) to finish before "
         "returning; past it, stop threads are abandoned."),
    Flag("serve_ttft_ewma_alpha", float, 0.3,
         "Smoothing factor for the router's per-replica TTFT EWMA (the "
         "admission-control wait estimator): higher reacts faster to "
         "load shifts, lower resists outliers."),
    Flag("serve_worker_poll_deadline_s", float, 12.0,
         "In-worker routers drain the controller long-poll ref with "
         "non-blocking probes for at most this long before re-arming "
         "(a blocking get would head-of-line block the replica's "
         "serialized owner connection)."),
    # ---- cluster plane ---------------------------------------------------
    Flag("fetch_chunk_bytes", int, 16 << 20,
         "Chunk size for ranged node-to-node object transfer "
         "(reference: object manager 64MB chunked pushes)."),
    Flag("fetch_parallel_threshold_bytes", int, 64 << 20,
         "Objects at or above this size transfer as parallel ranged "
         "chunks over multiple connections (the DCN bulk path); smaller "
         "ones use a single fetch call. 0 disables ranged transfer."),
    Flag("fetch_parallelism", int, 4,
         "Concurrent connections per large-object fetch."),
    Flag("push_max_inflight_bytes", int, 64 << 20,
         "Sender-side flow control: max bytes of outbound object chunks "
         "being copied/served concurrently per node; excess chunk "
         "requests queue (reference: push_manager.h caps chunks in "
         "flight on the sending side). 0 disables the cap."),
    Flag("locality_aware_scheduling", bool, True,
         "Score resource-feasible nodes by the bytes of task arguments "
         "already resident on each (args >= locality_min_arg_bytes), so "
         "tasks chase their data instead of pulling it (reference: "
         "locality-aware leasing, lease_policy.h / Ownership NSDI'21). "
         "Placement-group and node-affinity strategies keep precedence; "
         "off = pure resource-fit + load + round-robin."),
    Flag("locality_cache_ttl_s", float, 5.0,
         "Driver-side object-location cache max staleness. Entries are "
         "invalidated eagerly on free (the GCS 'freed' channel) and node "
         "death; the TTL bounds staleness from eviction/spill, which "
         "only ever costs scheduling quality, not correctness."),
    Flag("locality_load_penalty_bytes", int, 16 << 20,
         "Queue-depth tradeoff for locality scoring: each queued task on "
         "a node discounts its local-argument bytes by this much, so a "
         "deeply backlogged holder loses to an idle peer once the "
         "transfer it saves is cheaper than the wait."),
    Flag("locality_min_arg_bytes", int, 1 << 20,
         "Arguments at or above this size participate in locality "
         "scoring; smaller ones are cheaper to ship than to chase."),
    Flag("gcs_heartbeat_interval_s", float, 0.2,
         "Node -> GCS heartbeat period (reference: "
         "raylet_report_resources_period_milliseconds)."),
    Flag("gcs_heartbeat_timeout_s", float, 3.0,
         "A node missing heartbeats for this long is marked DEAD "
         "(reference: health_check_timeout_ms, "
         "gcs_health_check_manager.h)."),
    Flag("pull_acquire_timeout_s", float, 120.0,
         "How long a bulk object pull waits for admission (store-memory "
         "reservation) before timing out and re-planning from fresh "
         "locations. Shrink in partition tests so a blocked pull fails "
         "over in seconds, not minutes; errors name the peer address."),
    Flag("pull_admission_fraction", float, 0.5,
         "Fraction of object-store capacity that concurrent bulk pulls "
         "may reserve; excess pulls queue by priority task-args > get > "
         "wait (reference: pull_manager.h:52)."),
    # ---- workers and memory ----------------------------------------------
    Flag("memory_monitor_enabled", bool, True,
         "Kill workers under node memory pressure instead of letting the "
         "kernel OOM the node (reference: memory_monitor.h:52)."),
    Flag("memory_monitor_interval_s", float, 0.25,
         "Memory monitor poll period (reference: "
         "memory_monitor_refresh_ms)."),
    Flag("memory_usage_threshold", float, 0.95,
         "Usage fraction above which the kill policy fires (reference: "
         "memory_usage_threshold)."),
    Flag("memory_limit_bytes", int, 0,
         "When >0, bound the WORKER TREE's summed RSS by this many bytes "
         "instead of watching host/cgroup usage — deterministic for "
         "tests, and a fence on shared hosts."),
    Flag("task_oom_retries", int, 3,
         "OOM kills a retriable task survives without consuming its "
         "max_retries budget; past this, callers get OutOfMemoryError "
         "(reference: task_oom_retries, -1 = infinite)."),
    Flag("worker_zygote", bool, True,
         "Fork new workers from a pre-warmed zygote template (~10ms) "
         "instead of cold interpreter starts (~300ms). GPU workers always "
         "cold-spawn (reference: PrestartWorkers, "
         "raylet/worker_pool.h:344)."),
    Flag("worker_ready_timeout_s", float, 300.0,
         "A spawned worker that neither connects (MSG_READY) nor exits "
         "within this window is presumed wedged: killed and handled as "
         "a pre-ready death (env pools count it toward their "
         "crash-loop bound). Raise on hosts with very slow cold "
         "starts."),
    Flag("gcs_wal_fsync", bool, False,
         "fsync the GCS write-ahead log on every append. Default off: "
         "durability then covers GCS process crashes (the common failure), "
         "not host/OS crashes. Turn on for strict durability at ~ms/append "
         "cost (reference: gcs_storage durability knobs)."),
    Flag("gcs_reconnect_timeout_s", float, 15.0,
         "How long GCS clients (driver ClusterCore, node servers) keep "
         "buffering and retrying calls while the head is unreachable "
         "before failing them with GcsUnavailableError. Covers a SIGKILL "
         "+ restart of the GCS process (reference: "
         "gcs_rpc_server_reconnect_timeout_s)."),
    Flag("gcs_op_buffer_max", int, 512,
         "Max GCS calls a single client parks in the ride-through buffer "
         "while the head is down; calls beyond this raise "
         "GcsUnavailableError immediately instead of piling up threads "
         "(mirror of actor_restart_buffer_max at the cluster level)."),
    Flag("gcs_recovery_grace_s", float, 5.0,
         "After a GCS restart that recovered prior state, suppress "
         "death-marking of known nodes/drivers for this long so they can "
         "heartbeat back in before the health loop declares them DEAD "
         "(reference: gcs_failover_worker_reconnect_timeout)."),
    Flag("rpc_handshake_timeout_s", float, 15.0,
         "Hard deadline on the cluster RPC authkey handshake (client and "
         "server side): a half-open peer that stalls mid-challenge is "
         "cut off after this long instead of wedging the connect path "
         "(see rpc._timed_handshake). Timeout errors name the peer."),
    Flag("driver_heartbeat_interval_s", float, 0.5,
         "Driver -> GCS owner-liveness heartbeat period."),
    Flag("driver_heartbeat_timeout_s", float, 3.0,
         "A driver missing heartbeats this long is declared dead; its "
         "objects are reclaimed cluster-wide and its non-detached actors "
         "stop restarting (reference: owner-failure semantics, "
         "core_worker/reference_count.h:61, gcs_job_manager.h)."),
    Flag("cluster_view_refresh_s", float, 0.25,
         "Driver-side cluster view (node table + loads) max staleness "
         "before re-fetching from the GCS."),
    Flag("node_drain_grace_s", float, 10.0,
         "Bounded grace window for a DRAINING node: the scheduler stops "
         "placing new work immediately, restartable/detached actors "
         "migrate, and running tasks get this long to finish before the "
         "GCS declares the node DRAINED (reference: DrainNodeRequest "
         "deadline, gcs_node_manager). A drained node deregisters "
         "cleanly — no death event, no lineage reconstruction."),
    Flag("quarantine_score_threshold", float, 2.0,
         "Per-node health score (heartbeat-interval jitter EWMA + "
         "task-failure-rate EWMA + peer suspicion reports) above which "
         "the GCS auto-QUARANTINES a gray-failing node: cordoned from "
         "scheduling, existing work allowed to finish, periodically "
         "probed for recovery. 0 disables quarantining."),
    Flag("quarantine_recover_s", float, 1.0,
         "Hysteresis window for un-quarantine: a QUARANTINED node "
         "returns to ALIVE only after its health score has stayed below "
         "half the quarantine threshold for this long AND the GCS's "
         "periodic liveness probe succeeds — so a flapping node cannot "
         "oscillate in and out of the schedulable set."),
    Flag("job_lease_ttl_s", float, 2.0,
         "Heartbeat lease a job agent holds on every claimed job; the "
         "agent renews it each poll tick, and the GCS orphan detector "
         "re-queues (or fails, per the job's max_restarts policy) any "
         "RUNNING job whose lease expired — a SIGKILLed agent can no "
         "longer strand jobs forever."),
    Flag("job_max_restarts_default", int, 0,
         "Default max_restarts for submit_job when the caller does not "
         "pass one: how many times a crash-looping entrypoint (nonzero "
         "exit, or an orphaned claim) is re-queued with exponential "
         "backoff + full jitter before the job goes FAILED."),
    # ---- chaos / testing -------------------------------------------------
    Flag("testing_rpc_delay_ms", int, 0,
         "If > 0, injects a uniform random delay up to this many ms into "
         "worker<->driver control messages (reference: asio_chaos.cc:35)."),
    Flag("testing_kill_worker_prob", float, 0.0,
         "If > 0, each task execution exits the worker with this "
         "probability before running (chaos; reference: WorkerKillerActor "
         "test_utils.py:1597)."),
    Flag("fault_injection", str, "",
         "Deterministic fault plan: comma-separated "
         "'<site>=<action>[:<times>[:<match>]]' specs armed at named "
         "sites (see ray_tpu_torch/core/fault_injection.py for the site and "
         "action tables). Equivalent per-site env form: "
         "RTPU_FAULT_<SITE>=<action>[:<times>[:<match>]]. Unlike the "
         "probabilistic testing_* knobs above, these target a chosen "
         "object/task and fire an exact number of times."),
]

_BY_NAME: Dict[str, Flag] = {f.name: f for f in _FLAGS}

# Per-process plumbing injected by whichever process spawns another:
# addresses, auth material, identities. These are NOT user tunables (no
# Flag row, no default, no reload()); they exist so the rtpu-lint L3
# analyzer — and readers — can tell a registered wiring variable from a
# stray/undeclared RTPU_* env read. Keep alphabetized.
WIRING_ENV_VARS: Dict[str, str] = {
    "RTPU_ADDRESS": "driver/GCS RPC address handed to spawned workers "
                    "and attached drivers (host:port)",
    "RTPU_AUTH": "hex authkey for the driver<->worker control plane, "
                 "generated per session by the spawner",
    "RTPU_CLUSTER_AUTHKEY": "hex authkey shared by every cluster "
                            "process (see rpc.cluster_authkey: no "
                            "default, deliberately)",
    "RTPU_GPU_IDS": "comma-separated GPU ids the runtime bound to a GPU "
                    "actor's worker (set at spawn alongside "
                    "CUDA_VISIBLE_DEVICES)",
    "RTPU_NETEM": "seeded deterministic network-fault plan "
                  "'<seed>:<spec>' armed at import in every cluster "
                  "process (rule grammar and replay protocol in "
                  "core/netem.py; wire-level sibling of RTPU_FAULT_*)",
    "RTPU_NODE_ID": "id of the node a spawned worker belongs to",
    "RTPU_OWNER_PID": "pid of the process whose runtime spawned a "
                      "worker (a driver or a node server); the worker "
                      "exits when it dies",
    "RTPU_PKG_DIR": "working-dir package root a worker unpacked its "
                    "runtime env into (set by runtime_env activation)",
    "RTPU_SANITIZE": "arm the lock-order sanitizer: util/debug_lock.py "
                     "wraps core locks, raises on acquisition-order "
                     "inversions and callbacks fired under a tracked "
                     "lock (read at import, inherited by workers)",
    "RTPU_STORE": "object-store shm segment name handed to workers",
    "RTPU_WORKER_ID": "id the spawner assigned this worker process",
    "RTPU_WORKER_PIP_KEY": "cache key of the pip runtime env a worker "
                           "was launched under (env pool accounting)",
}


class _Config:
    """Singleton holding resolved flag values as attributes."""

    def __init__(self):
        self.reload()

    def reload(self, env: Dict[str, str] = None):
        """Re-resolve every flag from the environment (tests, or after
        mutating os.environ in-process)."""
        env = os.environ if env is None else env
        for f in _FLAGS:
            raw = env.get(f.env_var)
            if raw is None:
                value = f.default
            elif f.type is bool:
                value = _parse_bool(raw)
            else:
                value = f.type(raw)
            object.__setattr__(self, f.name, value)

    def to_dict(self) -> Dict[str, Any]:
        return {f.name: getattr(self, f.name) for f in _FLAGS}

    def describe(self) -> List[Dict[str, Any]]:
        return [
            {"name": f.name, "env": f.env_var, "type": f.type.__name__,
             "default": f.default, "value": getattr(self, f.name),
             "doc": f.doc}
            for f in _FLAGS
        ]


config = _Config()


def flags() -> List[Flag]:
    return list(_FLAGS)


if __name__ == "__main__":
    for row in config.describe():
        star = "" if row["value"] == row["default"] else "  *"
        print(f"{row['name']} ({row['env']}, {row['type']}) = "
              f"{row['value']!r} [default {row['default']!r}]{star}")
        print(f"    {row['doc']}")
