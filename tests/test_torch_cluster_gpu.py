"""GPUs in the port's cluster mode, its refusals, its node processes,
and the RLlib policy server.

No card is needed: a node is given GPU ids with ``RTPU_GPUS``
(``Cluster.add_node(gpus=n)``), and an id only travels into a worker's
``CUDA_VISIBLE_DEVICES``. The policy server's program is
``tests/test_rllib.py::test_policy_server_external_client_process``,
run on the port (``_torch_port_copy.py``) with its learner on the CPU
and held to that test's own return checks; its reference half is that
test.
"""

from __future__ import annotations

import os
import time

import pytest

import ray_tpu_torch as rt
from ray_tpu_torch.core import runtime_context
from ray_tpu_torch.core.cluster import Cluster
from tests._torch_port_copy import export, port_copy

_rl = port_copy("test_rllib.py", rewrite=[(
    """    learner = ImpalaLearner(build_pv_module(spec), lr=1e-3, gamma=0.99,
                            seed=0)""",
    """    learner = ImpalaLearner(build_pv_module(spec), lr=1e-3, gamma=0.99,
                            seed=0, device="cpu")""")])
export(_rl, globals(), ["test_policy_server_external_client_process"],
       fixtures=["rl_ray"])


@pytest.fixture(autouse=True)
def _one_torch_thread(request):
    """The policy-server program's learner updates in this process on the
    CPU while its client plays free-running. At torch's default of one
    intra-op thread a core, a loaded host (14 busy processes on 8 cores)
    slowed the updates so far that the client's 300 episodes ended before
    the returns rose, where the reference's learner kept up; one thread,
    as the RLlib runners use, kept up too. The setting is restored."""
    if "policy_server" not in request.node.name:
        yield
        return
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module")
def gpu_cluster():
    """Node A: CPUs only. Node B: two injected GPU ids."""
    prev = runtime_context.get_core_or_none()
    runtime_context.set_core(None)
    c = Cluster(num_nodes=1, num_workers_per_node=2,
                object_store_memory=64 << 20)
    try:
        c.add_node(gpus=2)
        assert c.wait_for_nodes(2)
        c.connect()
        yield c
    finally:
        c.shutdown()
        runtime_context.set_core(prev)


def _where():
    return (os.environ.get("RTPU_NODE_ID"),
            os.environ.get("CUDA_VISIBLE_DEVICES"),
            os.environ.get("RTPU_GPU_IDS"))


def test_gpus_are_advertised_by_one_node(gpu_cluster):
    core = runtime_context.get_core()
    assert core.cluster_resources()["GPU"] == 2.0
    nodes = core.nodes()
    assert sorted(n["resources"].get("GPU", 0.0) for n in nodes) == [0.0,
                                                                    2.0]
    assert sorted(n["topology"]["gpus"] for n in nodes) == [0, 2]


def test_gpu_actors_land_on_the_gpu_node_and_see_their_card(gpu_cluster):
    core = runtime_context.get_core()
    gpu_node = next(n for n in core.nodes()
                    if n["resources"].get("GPU"))["node_id"].hex()

    @rt.remote(num_gpus=1)
    class OnCard:
        def where(self):
            return _where()

    @rt.remote
    def cpu_task():
        return _where()

    actors = [OnCard.remote() for _ in range(2)]
    seen = rt.get([a.where.remote() for a in actors], timeout=60)
    assert {s[0] for s in seen} == {gpu_node}
    assert sorted(s[1] for s in seen) == ["0", "1"]
    assert all(s[1] == s[2] for s in seen)
    tasks = rt.get([cpu_task.remote() for _ in range(6)], timeout=60)
    assert {t[1] for t in tasks} == {""}
    assert len({t[0] for t in tasks}) == 2     # both nodes took tasks
    for a in actors:
        rt.kill(a)


def test_num_tpus_is_refused(gpu_cluster):
    @rt.remote
    def f():
        return 1

    with pytest.raises(ValueError, match="num_gpus"):
        f.options(num_tpus=1).remote()
    assert rt.get(f.remote(), timeout=60) == 1


def test_gpu_in_resources_and_head_are_refused():
    """A ``"GPU"`` resource is refused; ``--head`` no longer is: a head
    node starts the job agent, which claims a submitted job."""
    from ray_tpu_torch.core.cluster import node_server
    from ray_tpu_torch.job import JobStatus, JobSubmissionClient

    with pytest.raises(ValueError, match="RTPU_GPUS"):
        node_server.NodeServer(("127.0.0.1", 1), resources={"GPU": 1})
    # this cluster's shutdown would shut down the driver installed in the
    # runtime context: set the module's driver aside meanwhile
    prev = runtime_context.get_core_or_none()
    runtime_context.set_core(None)
    c = Cluster(num_nodes=0, num_workers_per_node=1,
                object_store_memory=32 << 20)
    try:
        c.add_node(head=True)
        assert c.wait_for_nodes(1)
        gcs = c.gcs_address
        client = JobSubmissionClient(f"{gcs[0]}:{gcs[1]}", authkey=c.authkey)
        jid = client.submit_job(entrypoint="echo head-agent")
        assert client.wait_until_finished(jid, timeout=60) == \
            JobStatus.SUCCEEDED
        assert "head-agent" in client.get_job_logs(jid)
        client.close()
    finally:
        c.shutdown()
        runtime_context.set_core(prev)


def test_no_gpu_node_never_takes_a_gpu_actor():
    """Without a GPU node a ``num_gpus`` actor is not placed anywhere."""
    prev = runtime_context.get_core_or_none()
    runtime_context.set_core(None)
    c = Cluster(num_nodes=1, num_workers_per_node=1,
                object_store_memory=32 << 20)
    try:
        assert c.wait_for_nodes(1)
        c.connect()

        @rt.remote(num_gpus=1)
        class OnCard:
            def where(self):
                return _where()

        with pytest.raises(Exception) as ei:
            rt.get(OnCard.remote().where.remote(), timeout=3)
        assert type(ei.value).__name__ == "GetTimeoutError", ei.value
    finally:
        c.shutdown()
        runtime_context.set_core(prev)


def _maps(pid):
    with open(f"/proc/{pid}/maps") as f:
        return f.read()


def test_node_processes_load_no_torch_and_workers_die_with_them(
        gpu_cluster):
    """The GCS and node servers never load torch (so never a CUDA
    context), and a SIGKILLed node takes its workers with it."""
    import subprocess

    c = gpu_cluster
    for p in [c._gcs_proc] + [n.proc for n in c.nodes]:
        assert "libtorch" not in _maps(p.pid), p.args

    node = c.add_node(num_workers=1)
    assert c.wait_for_nodes(3)
    core = runtime_context.get_core()
    nid = next(n["node_id"] for n in core.nodes()
               if tuple(n["address"]) == tuple(node.address)).hex()

    @rt.remote
    def busy(s):
        time.sleep(s)
        return os.getpid()

    @rt.remote
    def pid_on(node_id):
        return os.getpid()

    from ray_tpu_torch.util.scheduling_strategies import (
        NodeAffinitySchedulingStrategy)
    pid = rt.get(pid_on.options(scheduling_strategy=(
        NodeAffinitySchedulingStrategy(nid, soft=False))).remote(nid),
        timeout=60)
    busy.options(scheduling_strategy=NodeAffinitySchedulingStrategy(
        nid, soft=False)).remote(60)
    kids = subprocess.run(["pgrep", "-P", str(node.proc.pid)],
                          capture_output=True, text=True).stdout.split()
    assert kids
    c.remove_node(node)

    def alive(p):
        try:
            os.kill(int(p), 0)
        except OSError:
            return False
        return True

    deadline = time.monotonic() + 10
    while any(alive(p) for p in kids + [pid]) and time.monotonic() < deadline:
        time.sleep(0.1)
    assert not [p for p in kids + [pid] if alive(p)]


def test_driver_rehomes_when_its_home_node_dies():
    """The driver's home node (its puts, its gets without a route, the
    store it reads zero-copy) is SIGKILLed: the driver moves to an alive
    node and goes on. The reference's driver keeps dialing the dead one;
    this is the port's repair (ROADMAP.md section 3)."""
    import numpy as np

    prev = runtime_context.get_core_or_none()
    runtime_context.set_core(None)
    c = Cluster(num_nodes=2, num_workers_per_node=1,
                object_store_memory=64 << 20)
    try:
        assert c.wait_for_nodes(2)
        core = c.connect()
        home = next(n for n in c.nodes
                    if tuple(n.address) == tuple(core._home))
        other = next(n for n in c.nodes if n is not home)
        c.remove_node(home)
        deadline = time.monotonic() + 30
        while (tuple(core._home) != tuple(other.address)
               and time.monotonic() < deadline):
            time.sleep(0.1)
        assert tuple(core._home) == tuple(other.address)
        big = np.arange(1 << 20, dtype=np.float64)
        ref = rt.put(big)
        assert np.array_equal(rt.get(ref, timeout=30), big)

        @rt.remote
        def total(a):
            return float(a.sum())

        assert rt.get(total.remote(ref), timeout=60) == float(big.sum())
    finally:
        c.shutdown()
        runtime_context.set_core(prev)


def test_driver_that_holds_its_gil_keeps_its_actors(gpu_cluster):
    """A driver that holds its GIL longer than
    ``driver_heartbeat_timeout_s`` (one long C call; here a Python loop
    under a switch interval longer than the loop) is not declared dead:
    its heartbeat comes from a process of its own
    (``core/cluster/driver_beat.py``), so the nodes keep its actors."""
    import sys

    from ray_tpu_torch.core.config import config

    core = runtime_context.get_core()

    @rt.remote
    class Echo:
        def ping(self, x):
            return x

    a = Echo.remote()
    assert rt.get(a.ping.remote(1), timeout=60) == 1
    hold = 2 * config.driver_heartbeat_timeout_s
    prev = sys.getswitchinterval()
    sys.setswitchinterval(4 * hold)
    try:
        t0 = time.monotonic()
        while time.monotonic() - t0 < hold:
            pass
    finally:
        sys.setswitchinterval(prev)
    time.sleep(2 * config.driver_heartbeat_interval_s)
    deaths = core.gcs.call(("driver_deaths_since", 0))
    assert core._driver_id not in [d for _, d in deaths]
    assert rt.get(a.ping.remote(2), timeout=60) == 2
    rt.kill(a)


_DRIVER = """
import sys, time
import ray_tpu_torch as rt
from ray_tpu_torch.core import runtime_context
host, port = sys.argv[1:3]
rt.init(address=f"{host}:{port}")
core = runtime_context.get_core()
print(core._driver_id.hex(), core._beat.pid, flush=True)
time.sleep(600)
"""


def test_driver_beats_stop_when_the_driver_dies(gpu_cluster):
    """A SIGKILLed driver's beat process sees its pipe close and exits,
    and the GCS declares the driver dead."""
    import subprocess
    import sys

    from ray_tpu_torch.core.config import config

    c = gpu_cluster
    core = runtime_context.get_core()
    env = dict(os.environ, RTPU_CLUSTER_AUTHKEY=c.authkey.hex())
    proc = subprocess.Popen(
        [sys.executable, "-c", _DRIVER, str(c.gcs_address[0]),
         str(c.gcs_address[1])], env=env, stdout=subprocess.PIPE,
        text=True)
    try:
        driver_id, beat_pid = proc.stdout.readline().split()
        born = _stat(int(beat_pid))[19]  # tells a reused pid apart
        proc.kill()
        proc.wait()
        deadline = time.monotonic() + 4 * config.driver_heartbeat_timeout_s
        dead = False
        while not dead and time.monotonic() < deadline:
            deaths = core.gcs.call(("driver_deaths_since", 0))
            dead = bytes.fromhex(driver_id) in [d for _, d in deaths]
            time.sleep(0.1)
        assert dead
        st = _stat(int(beat_pid))
        assert not st or st[19] != born or st[0] == "Z", st
    finally:
        proc.kill()
        proc.wait()


def _stat(pid: int) -> list:
    """``/proc/<pid>/stat``'s fields after the command (the state first),
    or [] once the process is gone."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()
    except OSError:
        return []
