"""JobSubmissionClient: submit/status/logs/stop against the GCS job table.

Reference surface: python/ray/dashboard/modules/job/sdk.py
(JobSubmissionClient.submit_job/get_job_status/get_job_logs/stop_job).
The port's copy of ``ray_tpu/job/client.py``.
"""

from __future__ import annotations

import enum
import os
import time
import uuid
from typing import List, Optional, Tuple

from ray_tpu_torch.core.cluster.rpc import RpcClient, cluster_authkey


class JobStatus(str, enum.Enum):
    PENDING = "PENDING"
    RUNNING = "RUNNING"
    SUCCEEDED = "SUCCEEDED"
    FAILED = "FAILED"
    STOPPED = "STOPPED"


def _parse_addr(address: str) -> Tuple[str, int]:
    host, _, port = address.rpartition(":")
    return host, int(port)


class JobSubmissionClient:
    def __init__(self, address: str, authkey: Optional[bytes] = None):
        self._gcs = RpcClient(_parse_addr(address),
                              authkey or cluster_authkey())
        self._gcs.call(("ping",))

    def submit_job(self, *, entrypoint: str,
                   runtime_env: Optional[dict] = None,
                   submission_id: Optional[str] = None,
                   metadata: Optional[dict] = None,
                   max_restarts: Optional[int] = None,
                   backoff=None) -> str:
        """Submit an entrypoint for supervised execution.

        ``max_restarts`` bounds how many times a crash-looping
        entrypoint (nonzero exit, or an orphaned claim after the agent
        died) is re-queued — each retry waits exponential backoff with
        full jitter. ``backoff`` tunes the schedule: a float (base
        seconds) or {"base_s", "max_s"}. Defaults come from
        config.job_max_restarts_default / 1s base, 30s cap."""
        from ray_tpu_torch.core.config import config

        job_id = submission_id or f"job_{uuid.uuid4().hex[:10]}"
        if max_restarts is None:
            max_restarts = config.job_max_restarts_default
        if backoff is None:
            backoff = {}
        elif isinstance(backoff, (int, float)):
            backoff = {"base_s": float(backoff)}
        bo = {"base_s": float(backoff.get("base_s", 1.0)),
              "max_s": float(backoff.get("max_s", 30.0))}
        spec = {
            "job_id": job_id,
            "submission_id": job_id,
            "entrypoint": entrypoint,
            "env": (runtime_env or {}).get("env_vars", {}),
            "metadata": metadata or {},
            "status": JobStatus.PENDING.value,
            "submitted_at": time.time(),
            "agent": None,
            "max_restarts": int(max_restarts),
            "backoff": bo,
            "restarts": 0,
            "next_eligible_at": 0.0,
            "lease_expires_at": None,
        }
        if self._gcs.call(("kv", "exists", f"job/{job_id}")):
            raise ValueError(f"job {job_id!r} already exists")
        self._gcs.call(("kv", "put", f"job/{job_id}", spec))
        return job_id

    def get_job_info(self, job_id: str) -> dict:
        spec = self._gcs.call(("kv", "get", f"job/{job_id}"))
        if spec is None:
            raise KeyError(f"no job {job_id!r}")
        return spec

    def get_job_status(self, job_id: str) -> JobStatus:
        return JobStatus(self.get_job_info(job_id)["status"])

    def list_jobs(self) -> List[dict]:
        keys = self._gcs.call(("kv", "keys", "job/"))
        # a job deleted between the keys scan and the per-key get reads
        # back as None — skip it instead of handing callers a None row
        jobs = (self._gcs.call(("kv", "get", k)) for k in keys)
        return [j for j in jobs if j is not None]

    def get_job_logs(self, job_id: str) -> str:
        info = self.get_job_info(job_id)
        path = info.get("log_path")
        if not path or not os.path.exists(path):
            return ""
        with open(path) as f:
            return f.read()

    def stop_job(self, job_id: str) -> bool:
        info = self.get_job_info(job_id)
        if info["status"] == JobStatus.PENDING.value:
            # not claimed yet: flip straight to STOPPED (atomic; if an
            # agent claims concurrently the cas fails and we fall through)
            if self._gcs.call(("kv", "cas_merge", f"job/{job_id}", (
                    {"status": JobStatus.PENDING.value},
                    {"status": JobStatus.STOPPED.value}))) is not None:
                return True
            info = self.get_job_info(job_id)
        if info["status"] == JobStatus.RUNNING.value:
            self._gcs.call(("kv", "merge", f"job/{job_id}",
                            {"stop_requested": True}))
            return True
        return False

    def wait_until_finished(self, job_id: str, timeout: float = 300.0
                            ) -> JobStatus:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            status = self.get_job_status(job_id)
            if status in (JobStatus.SUCCEEDED, JobStatus.FAILED,
                          JobStatus.STOPPED):
                return status
            time.sleep(0.25)
        raise TimeoutError(f"job {job_id} did not finish in {timeout}s")

    def close(self):
        self._gcs.close()
