"""Job submission and the state API on the port against ``ray_tpu``.

``test_port_*`` run the programs of ``tests/test_job.py`` (all seven:
the round trip, concurrent claims, an agent SIGKILLed mid-job, the
crash-loop schedule, a stop across a restart boundary, the ``job_claim``
fault site) and of ``tests/test_control_plane.py``'s state and job tests
on the port, held to those files' own assertions
(``_torch_port_copy.py``). The control-plane job test's log directory
moves under ``tempfile.gettempdir()``. ``test_head_node_runs_a_job``
submits to the agent a head node starts (``node_server --head``), whose
entrypoint drives the cluster from its own process.
"""

from __future__ import annotations

import os
import sys
import time

import pytest

import ray_tpu_torch as rt
from ray_tpu_torch.core import runtime_context
from ray_tpu_torch.core.cluster import Cluster
from tests._torch_port_copy import export, port_copy, ref_tests

_job = port_copy("test_job.py")
export(_job, globals(), ref_tests(_job))

_cp = port_copy("test_control_plane.py", rewrite=[(
    'log_dir="/tmp/ray_tpu_test_jobs")',
    'log_dir=os.path.join(__import__("tempfile").gettempdir(), '
    '"rtpt_test_jobs"))')])
export(_cp, globals(), ["test_state_api_embedded", "test_state_api_cluster",
                        "test_job_submission"], fixtures=["cluster2"])

_ENTRY = r"""
import os, sys
import ray_tpu_torch as rt

rt.init()

@rt.remote
def where(x):
    return os.environ["RTPU_NODE_ID"], x * x

node, sq = rt.get(where.options(resources={"worker_node": 1}).remote(7),
                  timeout=60)
print("JOB_RESULT", node, sq, flush=True)
rt.shutdown()
"""


def test_head_node_runs_a_job(tmp_path):
    """A head node (``add_node(head=True)``) runs the job agent: a job
    submitted through ``JobSubmissionClient`` runs its entrypoint as a
    driver of the cluster (``RTPU_ADDRESS``), which places a task on the
    other node; the job reaches SUCCEEDED with the task's result in its
    logs, and a long job stops on request."""
    from ray_tpu_torch.job import JobStatus, JobSubmissionClient

    prev = runtime_context.get_core_or_none()
    runtime_context.set_core(None)
    c = Cluster(num_nodes=0, num_workers_per_node=1,
                object_store_memory=32 << 20)
    try:
        c.add_node(head=True)
        c.add_node(resources={"worker_node": 2})
        assert c.wait_for_nodes(2)
        c.connect()
        worker_node = next(
            n["node_id"].hex() for n in runtime_context.get_core().nodes()
            if n["resources"].get("worker_node"))
        script = tmp_path / "entry.py"
        script.write_text(_ENTRY)
        gcs = c.gcs_address
        client = JobSubmissionClient(f"{gcs[0]}:{gcs[1]}", authkey=c.authkey)
        try:
            jid = client.submit_job(entrypoint=f"{sys.executable} {script}")
            assert client.wait_until_finished(jid, timeout=120) == \
                JobStatus.SUCCEEDED, client.get_job_logs(jid)
            line = next(ln for ln in client.get_job_logs(jid).splitlines()
                        if ln.startswith("JOB_RESULT"))
            assert line.split()[1:] == [worker_node, "49"]
            info = client.get_job_info(jid)
            head_id = info["agent"]
            assert head_id != worker_node and info["returncode"] == 0
            long = client.submit_job(entrypoint="sleep 60")
            deadline = time.monotonic() + 60
            while (client.get_job_status(long) != JobStatus.RUNNING
                   and time.monotonic() < deadline):
                time.sleep(0.05)
            assert client.stop_job(long)
            assert client.wait_until_finished(long, timeout=60) == \
                JobStatus.STOPPED
            assert {j["agent"] for j in client.list_jobs()} == {head_id}
        finally:
            client.close()
    finally:
        rt.shutdown()
        c.shutdown()
        runtime_context.set_core(prev)


@pytest.mark.parametrize("name", ["JobStatus", "JobSubmissionClient",
                                  "JobAgent"])
def test_job_package_exports_the_reference_names(name):
    import ray_tpu.job as ref
    import ray_tpu_torch.job as port

    assert hasattr(ref, name) and hasattr(port, name)
    if name == "JobStatus":
        assert [s.value for s in port.JobStatus] == \
            [s.value for s in ref.JobStatus]


def test_agent_logs_under_the_temp_dir():
    """The port's agent writes its jobs' logs under
    ``tempfile.gettempdir()`` unless told otherwise."""
    import tempfile

    from ray_tpu_torch.job.agent import default_log_dir

    assert os.path.dirname(default_log_dir()) == tempfile.gettempdir()
