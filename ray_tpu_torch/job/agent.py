"""JobAgent: claims PENDING jobs from the GCS table and runs them.

Reference: the JobManager/JobSupervisor pair
(dashboard/modules/job/job_manager.py:58) — there a supervisor actor per
job; here a thread on the head node spawns the entrypoint subprocess with
RTPU_ADDRESS pointing at the cluster, streams logs to a file, honors stop
requests, and writes terminal status back to the table.

Supervision contract:

- every claim carries a heartbeat lease (``lease_expires_at``, renewed
  each poll tick); the GCS orphan detector re-queues or fails any
  RUNNING job whose lease expired, so a SIGKILLed agent cannot strand
  jobs forever
- a crash-looping entrypoint (nonzero exit) is re-queued up to
  ``max_restarts`` times with exponential backoff + full jitter
  (job/backoff.py — the same deterministic schedule the orphan detector
  uses), and ``stop_requested`` holds across every restart boundary
- terminal writes go through cas_merge keyed on this agent's claim, so
  an agent racing the orphan detector (or another agent) loses cleanly
  instead of clobbering

Run standalone as ``python -m ray_tpu_torch.job.agent --gcs host:port``
(the cluster authkey comes from RTPU_CLUSTER_AUTHKEY) — tests use this to
SIGKILL an agent mid-job and watch lease-expiry recovery. A head node
(``node_server --head``) runs one in its own process.

The port's copy of ``ray_tpu/job/agent.py``. Job logs go under
``tempfile.gettempdir()`` (``rtpt_jobs``) unless a ``log_dir`` is given;
the reference writes under ``/tmp``.
"""

from __future__ import annotations

import logging
import os
import signal
import subprocess
import tempfile
import threading
import time
from typing import Dict, Optional, Tuple

from ray_tpu_torch.core import fault_injection
from ray_tpu_torch.core.cluster.rpc import RpcClient, RpcError
from ray_tpu_torch.core.config import config

from ray_tpu_torch.job.backoff import delay_for
from ray_tpu_torch.job.client import JobStatus

logger = logging.getLogger(__name__)


def default_log_dir() -> str:
    """Where an agent writes its jobs' logs unless told otherwise."""
    return os.path.join(tempfile.gettempdir(), "rtpt_jobs")


class JobAgent:
    def __init__(self, gcs: RpcClient, gcs_address: Tuple[str, int],
                 agent_id: str, log_dir: Optional[str] = None,
                 poll_s: float = 0.25):
        self._gcs = gcs
        self._gcs_address = gcs_address
        self._agent_id = agent_id
        self._log_dir = log_dir or default_log_dir()
        self._poll_s = poll_s
        self._procs: Dict[str, subprocess.Popen] = {}
        self._stop = False
        self._warned_unexpected = False
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="job-agent")
        self._thread.start()

    def _loop(self):
        while not self._stop:
            try:
                self._claim_pending()
                self._renew_leases()
                self._reap()
            except (RpcError, ConnectionError, TimeoutError, OSError,
                    EOFError):
                # GCS unreachable (failover, partition): transient by
                # construction — the next tick retries, and the lease
                # machinery covers us if we stay cut off too long
                pass
            except Exception:  # noqa: BLE001 — the agent must survive
                # NOT a transport error: a bug or a malformed spec must
                # be visible once, not silently swallowed every tick
                if not self._warned_unexpected:
                    self._warned_unexpected = True
                    logger.warning("job agent loop failed unexpectedly",
                                   exc_info=True)
            time.sleep(self._poll_s)

    def _claim_pending(self):
        now = time.time()
        for key in self._gcs.call(("kv", "keys", "job/")):
            spec = self._gcs.call(("kv", "get", key))
            if not spec or spec.get("status") != JobStatus.PENDING.value:
                continue
            if spec.get("stop_requested"):
                # stop holds across restart boundaries: a job stopped
                # while RUNNING must not run its backoff re-queue
                self._gcs.call(("kv", "cas_merge", key, (
                    {"status": JobStatus.PENDING.value},
                    {"status": JobStatus.STOPPED.value,
                     "finished_at": now})))
                continue
            if (spec.get("next_eligible_at") or 0) > now:
                continue  # crash-loop backoff window still open
            os.makedirs(self._log_dir, exist_ok=True)
            log_path = os.path.join(self._log_dir,
                                    f"{spec['job_id']}.log")
            # atomic claim: only one agent flips PENDING -> RUNNING, and a
            # concurrent stop_job's merge can't be overwritten. The claim
            # carries this agent's lease; _renew_leases keeps it fresh.
            claimed = self._gcs.call(("kv", "cas_merge", key, (
                {"status": JobStatus.PENDING.value},
                {"status": JobStatus.RUNNING.value,
                 "agent": self._agent_id, "log_path": log_path,
                 "started_at": now,
                 "lease_expires_at": now + config.job_lease_ttl_s})))
            if claimed is None:
                continue
            spec = claimed
            if fault_injection.enabled() and fault_injection.fire(
                    "job_claim", spec["job_id"]) == "drop":
                # chaos: the agent "dies" right after claiming — abandon
                # the claim without spawning; lease expiry must recover
                continue
            stale_pid = spec.get("pid")
            if stale_pid and (spec.get("orphaned")
                              or int(spec.get("restarts") or 0) > 0):
                # re-claim after an agent death: the previous attempt's
                # process group may still be running (start_new_session
                # outlives the agent) — reap it so the job never runs
                # twice concurrently
                try:
                    os.killpg(stale_pid, signal.SIGKILL)
                except OSError:
                    pass
            # append on retries so earlier attempts' output survives
            log = open(log_path,
                       "a" if int(spec.get("restarts") or 0) else "w")
            try:
                env = dict(os.environ)
                env.update(spec.get("env") or {})
                env["RTPU_ADDRESS"] = (
                    f"{self._gcs_address[0]}:{self._gcs_address[1]}")
                try:
                    proc = subprocess.Popen(
                        spec["entrypoint"], shell=True, env=env,
                        stdout=log, stderr=subprocess.STDOUT,
                        start_new_session=True)
                except OSError as e:
                    self._gcs.call(("kv", "merge", key, {
                        "status": JobStatus.FAILED.value,
                        "error": repr(e)}))
                    continue
            finally:
                # the child holds its own dup of the fd; keeping ours
                # open leaks one fd per claim (and a failed Popen used
                # to leak it forever)
                log.close()
            self._procs[spec["job_id"]] = proc
            self._gcs.call(("kv", "merge", key, {"pid": proc.pid}))

    def _renew_leases(self):
        now = time.time()
        for job_id in list(self._procs):
            self._gcs.call(("kv", "cas_merge", f"job/{job_id}", (
                {"status": JobStatus.RUNNING.value,
                 "agent": self._agent_id},
                {"lease_expires_at": now + config.job_lease_ttl_s})))

    def _reap(self):
        for job_id, proc in list(self._procs.items()):
            key = f"job/{job_id}"
            spec = self._gcs.call(("kv", "get", key)) or {}
            if spec.get("agent") != self._agent_id or \
                    spec.get("status") != JobStatus.RUNNING.value:
                # the orphan detector (or an operator) took the job from
                # us — a lease we let lapse. Kill our copy: the table's
                # owner decides what runs, never two agents at once.
                if proc.poll() is None:
                    try:
                        os.killpg(proc.pid, signal.SIGKILL)
                    except OSError:
                        pass
                del self._procs[job_id]
                continue
            if spec.get("stop_requested") and proc.poll() is None:
                try:
                    os.killpg(proc.pid, signal.SIGTERM)
                except OSError:
                    pass
                try:
                    proc.wait(5)
                except subprocess.TimeoutExpired:
                    try:
                        os.killpg(proc.pid, signal.SIGKILL)
                    except OSError:
                        pass
                self._gcs.call(("kv", "merge", key, {
                    "status": JobStatus.STOPPED.value,
                    "lease_expires_at": None,
                    "finished_at": time.time()}))
                del self._procs[job_id]
                continue
            rc = proc.poll()
            if rc is None:
                continue
            restarts = int(spec.get("restarts") or 0)
            max_restarts = int(spec.get("max_restarts") or 0)
            if rc == 0:
                updates = {"status": JobStatus.SUCCEEDED.value,
                           "returncode": rc, "lease_expires_at": None,
                           "finished_at": time.time()}
            elif spec.get("stop_requested"):
                # the process died while we were about to stop it —
                # report STOPPED, not a crash-loop retry
                updates = {"status": JobStatus.STOPPED.value,
                           "returncode": rc, "lease_expires_at": None,
                           "finished_at": time.time()}
            elif restarts < max_restarts:
                delay = delay_for(spec.get("submission_id") or job_id,
                                  restarts,
                                  (spec.get("backoff") or {})
                                  .get("base_s", 1.0),
                                  (spec.get("backoff") or {})
                                  .get("max_s", 30.0))
                updates = {"status": JobStatus.PENDING.value,
                           "agent": None, "returncode": rc,
                           "restarts": restarts + 1,
                           "next_eligible_at": time.time() + delay,
                           "lease_expires_at": None,
                           "backoff_history":
                               list(spec.get("backoff_history") or [])
                               + [delay]}
            else:
                updates = {"status": JobStatus.FAILED.value,
                           "returncode": rc, "lease_expires_at": None,
                           "finished_at": time.time()}
            # cas on our own claim: if the orphan detector re-queued the
            # job between our poll and now, it owns the next attempt and
            # this write must lose
            self._gcs.call(("kv", "cas_merge", key, (
                {"status": JobStatus.RUNNING.value,
                 "agent": self._agent_id}, updates)))
            del self._procs[job_id]

    def close(self):
        self._stop = True
        for job_id, proc in list(self._procs.items()):
            if proc.poll() is None:
                try:
                    os.killpg(proc.pid, signal.SIGKILL)
                except OSError:
                    pass
            # record a terminal status so clients never spin on RUNNING
            try:
                # rtpu-lint: disable=L9 — per-job fan-out on the
                # shutdown path: the merge applies at most once per job,
                # and if it is lost the lease-expiry orphan scan redoes
                # the bookkeeping once the lease runs out
                self._gcs.call(("kv", "merge", f"job/{job_id}", {
                    "status": JobStatus.STOPPED.value,
                    "lease_expires_at": None,
                    "finished_at": time.time(),
                    "error": "job agent shut down"}))
            # rtpu-lint: disable=L4 — shutdown path: the terminal-status
            # write is best-effort (the GCS may already be gone, fenced,
            # or mid-failover); nothing here can act on the error
            except Exception:  # noqa: BLE001
                pass


def main(argv=None):
    """Standalone agent process (tests SIGKILL this to exercise
    lease-expiry orphan recovery)."""
    import argparse
    import sys
    import uuid

    from ray_tpu_torch.core.cluster.rpc import cluster_authkey

    p = argparse.ArgumentParser(description="ray_tpu_torch job agent")
    p.add_argument("--gcs", required=True, help="host:port of the GCS")
    p.add_argument("--agent-id", default=None)
    p.add_argument("--log-dir", default=None)
    p.add_argument("--poll", type=float, default=0.25)
    args = p.parse_args(argv)
    host, _, port = args.gcs.rpartition(":")
    addr = (host, int(port))
    gcs = RpcClient(addr, cluster_authkey())
    agent = JobAgent(gcs, addr,
                     agent_id=args.agent_id or uuid.uuid4().hex[:12],
                     log_dir=args.log_dir, poll_s=args.poll)
    print("AGENT_READY", flush=True)
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *a: stop.set())
    signal.signal(signal.SIGINT, lambda *a: stop.set())
    stop.wait()
    agent.close()
    gcs.close()
    sys.exit(0)


if __name__ == "__main__":
    main()
