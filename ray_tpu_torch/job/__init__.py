"""Job submission (reference: python/ray/dashboard/modules/job/ —
JobSubmissionClient sdk.py, JobManager job_manager.py:58).

Jobs are driver scripts run as subprocesses against the cluster: the
client records the job spec in the GCS job table (cluster KV under
``job/``), a JobAgent on one node (a head node's, ``node_server
--head``) claims it, spawns the entrypoint with RTPU_ADDRESS pointing
at the GCS, captures logs, and updates status. ``backoff.delay_for`` is
the crash-loop schedule the agent and the GCS's orphan scan share.
"""

from ray_tpu_torch.job.client import JobStatus, JobSubmissionClient  # noqa: F401
from ray_tpu_torch.job.agent import JobAgent  # noqa: F401
