"""Compiled DAGs across nodes on the port against ``ray_tpu``.

``test_port_*`` run ``tests/test_dag.py::test_cross_node_dag`` and
``test_socket_channel_rejects_unauthenticated_peer`` and
``tests/test_serve.py::test_pipeline_deployment_cross_node_stages`` on
the port, held to those tests' own assertions (``_torch_port_copy.py``).
``test_parity_cross_node_edges`` runs one program through both packages'
two-node clusters: a pipeline whose stages sit on both nodes, its edge
descriptors (``"sock"`` with the reader node's advertised address),
values with numpy arrays and an error crossing the edges, and the KV
keys left after teardown. ``test_llm_pipeline_across_nodes`` builds a
``PipelineDeployment`` from ``LLMPipeline``'s three stage classes
(tokenize and detokenize on one node, generate on the other; the tiny
preset on the CPU) and holds its replies to the stages run in the test's
process.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest

import ray_tpu
import ray_tpu_torch
import ray_tpu_torch.core.runtime_context  # noqa: F401
from tests._torch_port_copy import export, port_copy

_dag = port_copy("test_dag.py")
export(_dag, globals(), ["test_cross_node_dag",
                         "test_socket_channel_rejects_unauthenticated_peer"])
_serve = port_copy("test_serve.py")
export(_serve, globals(), ["test_pipeline_deployment_cross_node_stages"])


@pytest.fixture(scope="module")
def both():
    """A two-node cluster of each package (resources ``na`` and ``nb``),
    each driver installed in its package's runtime context."""
    from ray_tpu.core import runtime_context as ref_ctx
    from ray_tpu.core.cluster.fixture import Cluster as RefCluster
    from ray_tpu_torch.core import runtime_context as port_ctx
    from ray_tpu_torch.core.cluster import Cluster as PortCluster

    prev = (ref_ctx.get_core_or_none(), port_ctx.get_core_or_none())
    ref_ctx.set_core(None)
    port_ctx.set_core(None)
    clusters = []
    try:
        for cls in (RefCluster, PortCluster):
            c = cls(num_nodes=2, num_workers_per_node=1,
                    object_store_memory=64 << 20,
                    node_resources=[{"na": 4}, {"nb": 4}])
            clusters.append(c)
            assert c.wait_for_nodes(2)
            c.connect()
        yield {ray_tpu: clusters[0], ray_tpu_torch: clusters[1]}
    finally:
        for c in clusters:
            c.shutdown()
        ref_ctx.set_core(prev[0])
        port_ctx.set_core(prev[1])


def _edges_program(rt, cluster):
    from importlib import import_module

    dag_mod = import_module(rt.__name__ + ".dag")
    ctx = import_module(rt.__name__ + ".core.runtime_context")

    @rt.remote
    class Stage:
        def __init__(self, tag):
            self.tag = tag

        def step(self, x):
            if isinstance(x, str):
                raise ValueError(f"bad input at {self.tag}")
            return {"tag": self.tag, "arr": np.asarray(x) * 2}

        def tail(self, d):
            return (d["tag"], self.tag, d["arr"].tolist())

    a = Stage.options(resources={"na": 1}).remote("a")
    b = Stage.options(resources={"nb": 1}).remote("b")
    rt.get([a.step.remote([0]), b.step.remote([0])], timeout=60)
    dag = dag_mod.compile_pipeline([(b, "step"), (a, "tail")])
    core = ctx.get_core()
    home = tuple(core._home)
    addrs = [tuple(n.address) for n in cluster.nodes]
    try:
        descs = [d for d, _ in dag._in_edges + dag._out_edges]
        kinds = [d[0] for d in descs]
        # a socket descriptor names its reader's node: the stage's, or
        # the driver's home for the output edge
        hosts = [d[2] if d[0] == "sock" else None for d in descs]
        out = [dag.execute(np.arange(4), timeout_ms=60_000),
               dag.execute([7], timeout_ms=60_000)]
        with pytest.raises(ValueError, match="bad input at b"):
            dag.execute("x", timeout_ms=60_000)
        out.append(dag.execute([1, 2], timeout_ms=60_000))
    finally:
        dag.teardown()
    # the stage loops drop their readers' keys as the close reaches them
    deadline = time.monotonic() + 30
    while core.kv_op("keys", "dagchan:") and time.monotonic() < deadline:
        time.sleep(0.05)
    left = core.kv_op("keys", "dagchan:")
    out_kind = "shm" if home == addrs[0] else "sock"
    return kinds[0], hosts[0], kinds[1] == out_kind, out, left


def test_parity_cross_node_edges(both):
    got = {}

    def run(rt):
        got[rt] = _edges_program(rt, both[rt])

    threads = [threading.Thread(target=run, args=(rt,))
               for rt in (ray_tpu, ray_tpu_torch)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(180)
    ref, port = got[ray_tpu], got[ray_tpu_torch]
    assert port == ref
    # the input edge reaches node B's stage over a socket; the output
    # edge is shm when the driver's home is node A, which holds stage a
    assert ref[:3] == ("sock", "127.0.0.1", True)
    assert ref[3] == [("b", "a", [0, 2, 4, 6]), ("b", "a", [14]),
                      ("b", "a", [2, 4])]
    assert ref[4] == []


def test_llm_pipeline_across_nodes(both):
    """Tokenize and detokenize on node A, generate on node B (the tiny
    preset on the CPU): the two cross-node edges between A and B are
    socket channels and the replies equal the stages run here."""
    from ray_tpu_torch.serve.dag_mode import (PipelineDeployment,
                                              _Detokenize, _Generate,
                                              _Tokenize)

    mc = {"preset": "tiny"}
    vocab = 256
    dep = PipelineDeployment([
        (_Tokenize, "run", (vocab,), {"resources": {"na": 1}}),
        (_Generate, "run", (mc, 6, None, "cpu"), {"resources": {"nb": 1}}),
        (_Detokenize, "run", (), {"resources": {"na": 1}}),
    ])
    try:
        dag = dep._dag
        text = "across two nodes"
        replies = [dep(text, timeout_ms=120_000)]
        # every socket edge's reader has published its port by now: the
        # two between the stages' nodes, and any edge to or from the
        # driver when its home is not node A
        to_driver = sum(d[0] == "sock" for d, _ in
                        dag._in_edges + dag._out_edges)
        keys = ray_tpu_torch.core.runtime_context.get_core().kv_op(
            "keys", "dagchan:")
        replies.append(dep(text, timeout_ms=120_000))
    finally:
        dep.shutdown()
    assert len(keys) == 2 + to_driver, (keys, to_driver)
    want = _Detokenize().run(_Generate(mc, 6, device="cpu").run(
        _Tokenize(vocab).run(text)))
    assert replies == [want, want]


# --------------------------------------- actors a worker creates elsewhere


def _node_of_actor(name_or_res):
    """Runs in a task on node A: the node id of an actor it creates with
    ``resources`` (a dict) or looks up by name (a str)."""
    import os as _os

    import ray_tpu_torch as rt

    @rt.remote
    class Where:
        def node(self):
            return _os.environ["RTPU_NODE_ID"]

    if isinstance(name_or_res, dict):
        a = Where.options(resources=name_or_res).remote()
    else:
        try:
            a = Where.options(name=name_or_res).remote()
        except ValueError:
            a = rt.get_actor(name_or_res)
    return rt.get(a.node.remote(), timeout=30), _os.environ["RTPU_NODE_ID"]


def test_worker_created_actor_leaves_a_node_that_cannot_hold_it(both):
    """A task on node A creates an actor that needs node B's resource:
    node A's server creates it on node B (``NodeServer.spill_actor``),
    and the task's calls reach it there. The reference leaves such an
    actor pending on node A."""
    rt = ray_tpu_torch
    f = rt.remote(_node_of_actor)
    actor_node, task_node = rt.get(
        f.options(resources={"na": 1}).remote({"nb": 1}), timeout=60)
    assert actor_node != task_node


def test_named_actor_race_across_nodes_keeps_one_actor(both):
    """A task on node B creates an actor under a name an actor on node A
    already holds: the creation is refused before anything starts on
    node B, and the task's lookup finds node A's actor. (The reference
    creates the actor on node B first and only then asks the GCS, so
    node B kept a second actor answering to the name locally.)"""
    rt = ray_tpu_torch
    f = rt.remote(_node_of_actor)
    first, task_a = rt.get(
        f.options(resources={"na": 1}).remote("coord_race"), timeout=60)
    found, task_b = rt.get(
        f.options(resources={"nb": 1}).remote("coord_race"), timeout=60)
    assert first == task_a != task_b
    assert found == first
