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
cluster, the compiled DAGs, serve's router) come with the code that
reads them.
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
    Flag("serve_disagg", bool, False,
         "Prefill/decode disaggregation for paged engine replicas: long "
         "prompts divert to dedicated prefill workers whose finished KV "
         "pages are adopted by the decode engine as cached prefixes. "
         "serve.disagg.engine_class() resolves the flag."),
    Flag("serve_prefill_workers", int, 1,
         "Dedicated prefill workers per disaggregated engine: each owns "
         "a private staging KV pool of the engine's geometry and "
         "prefills diverted prompts on its own CUDA stream."),
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
    Flag("rpc_handshake_timeout_s", float, 15.0,
         "Hard deadline on the authkey handshake the runtime's accept "
         "loop runs with each worker connection: a half-open peer that "
         "stalls mid-challenge is cut off after this long instead of "
         "wedging the accept loop (see rpc._timed_handshake)."),
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
    "RTPU_GPU_IDS": "comma-separated GPU ids the runtime bound to a GPU "
                    "actor's worker (set at spawn alongside "
                    "CUDA_VISIBLE_DEVICES)",
    "RTPU_NODE_ID": "id of the node a spawned worker belongs to",
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
