"""Cluster mode on the port against ``ray_tpu``'s: the GCS, node servers,
cross-node objects, actors, placement groups, spillback, the ray://
client.

Two kinds of test:

- ``test_port_*``: the programs of ``tests/test_cluster.py``, run on the
  port's ``Cluster`` fixture and held to that file's own assertions (a
  copy of the file with ``ray_tpu`` read as ``ray_tpu_torch``; see
  ``_torch_port_copy.py``). Their reference halves are the reference's
  own tests. The four slow drills are in
  ``test_torch_cluster_drills.py``.
- ``test_parity_*``: programs run through both packages, each on its own
  three-node cluster, whose results must be equal: task and actor
  results, object bytes, exception type names and causes, placement
  group placements.
"""

from __future__ import annotations

import hashlib

import numpy as np
import pytest

import ray_tpu
import ray_tpu_torch
from tests._torch_port_copy import export, port_copy

_SLOW_DRILLS = ("test_cluster_remove_node_survival",
                "test_many_nodes_scale_stress",
                "test_detached_actor_survives_driver_and_node_death",
                "test_cluster_actor_restart_transparent_calls")

_ref = port_copy("test_cluster.py")
export(_ref, globals(),
       [n for n in vars(_ref) if n.startswith("test_")
        and n not in _SLOW_DRILLS],
       fixtures=["cluster"])


# ------------------------------------------------------------- parity

@pytest.fixture(scope="module")
def both():
    """A three-node cluster of each package (resources res0..res2), each
    driver installed in its package's runtime context."""
    from ray_tpu.core import runtime_context as ref_ctx
    from ray_tpu.core.cluster.fixture import Cluster as RefCluster
    from ray_tpu_torch.core import runtime_context as port_ctx
    from ray_tpu_torch.core.cluster import Cluster as PortCluster

    prev = (ref_ctx.get_core_or_none(), port_ctx.get_core_or_none())
    ref_ctx.set_core(None)
    port_ctx.set_core(None)
    res = [{"res0": 4}, {"res1": 4}, {"res2": 4}]
    clusters = []
    try:
        for cls in (RefCluster, PortCluster):
            c = cls(num_nodes=3, num_workers_per_node=2,
                    object_store_memory=64 << 20, node_resources=res)
            clusters.append(c)
            assert c.wait_for_nodes(3)
            c.connect()
        yield {ray_tpu: clusters[0], ray_tpu_torch: clusters[1]}
    finally:
        for c in clusters:
            c.shutdown()
        ref_ctx.set_core(prev[0])
        port_ctx.set_core(prev[1])


def _run(both, program):
    """``program(rt, cluster)`` through each package; both results."""
    return [program(rt, both[rt]) for rt in (ray_tpu, ray_tpu_torch)]


def _node_index(cluster, pid):
    return [n.proc.pid for n in cluster.nodes].index(pid)


def p_tasks_on_each_node(rt, cluster):
    @rt.remote
    def where(x):
        util = __import__(rt.__name__ + ".util", fromlist=["x"])
        return x * x, util.host_node_pid()

    out = rt.get([where.options(resources={f"res{i % 3}": 1}).remote(i)
                  for i in range(9)], timeout=60)
    return [(v, _node_index(cluster, pid)) for v, pid in out]


def p_cross_node_bytes(rt, cluster):
    @rt.remote
    def produce(n):
        return np.random.default_rng(7).integers(
            0, 256, size=n, dtype=np.uint8)

    @rt.remote
    def digest(a):
        return hashlib.sha256(a.tobytes()).hexdigest(), a.nbytes

    ref = produce.options(resources={"res0": 1}).remote(3 << 20)
    far = rt.get(digest.options(resources={"res2": 1}).remote(ref),
                 timeout=60)
    back = rt.get(ref, timeout=60)
    put = rt.put(back[::-1].copy())
    flipped = rt.get(digest.options(resources={"res1": 1}).remote(put),
                     timeout=60)
    return far, hashlib.sha256(back.tobytes()).hexdigest(), flipped


def p_actor_across_nodes(rt, cluster):
    @rt.remote
    class Counter:
        def __init__(self, start):
            self.n = start

        def add(self, k):
            self.n += k
            return self.n

    @rt.remote
    def bump(handle, k):
        return rt.get(handle.add.remote(k))

    c = Counter.options(resources={"res1": 1}).remote(10)
    seen = [rt.get(c.add.remote(1), timeout=60)]
    for i in (0, 2):
        seen.append(rt.get(bump.options(resources={f"res{i}": 1}).remote(
            c, i + 2), timeout=60))
    seen.append(rt.get(c.add.remote(0), timeout=60))
    rt.kill(c)
    return seen


def p_errors(rt, cluster):
    @rt.remote
    def boom(x):
        raise ValueError(f"boom {x}")

    @rt.remote
    def relay(r):
        return r

    out = []
    for ref in (boom.options(resources={"res0": 1}).remote(1),
                relay.options(resources={"res2": 1}).remote(
                    boom.options(resources={"res1": 1}).remote(2))):
        try:
            rt.get(ref, timeout=60)
            out.append(None)
        except Exception as e:  # noqa: BLE001 — the type is the result
            cause = getattr(e, "cause", None) or e.__cause__
            out.append((type(e).__name__, type(cause).__name__,
                        "boom" in str(e)))
    gone = rt.put(np.arange(1 << 18))
    rt.free(gone)
    try:
        rt.get(gone, timeout=30)
        out.append(None)
    except Exception as e:  # noqa: BLE001
        out.append((type(e).__name__, "free" in str(e)))
    return out


def p_placement_group(rt, cluster):
    util = __import__(rt.__name__ + ".util", fromlist=["x"])

    @rt.remote
    def where():
        u = __import__(rt.__name__ + ".util", fromlist=["x"])
        return u.host_node_pid()

    pg = util.placement_group([{"CPU": 1}] * 3, strategy="SPREAD")
    assert pg.wait(30)
    pids = rt.get([where.options(
        scheduling_strategy=("pg", pg.id.binary(), i)).remote()
        for i in range(3)], timeout=60)
    util.remove_placement_group(pg)
    return sorted(_node_index(cluster, p) for p in pids)


def p_kv_wait_stream(rt, cluster):
    core = __import__(rt.__name__ + ".core.runtime_context",
                      fromlist=["x"]).get_core()
    core.kv_op("put", "k", {"v": 1})
    kv = core.kv_op("get", "k")

    @rt.remote
    def nap(s):
        import time
        time.sleep(s)
        return s

    fast = nap.options(resources={"res1": 1}).remote(0.01)
    slow = nap.options(resources={"res2": 1}).remote(3.0)
    ready, rest = rt.wait([fast, slow], num_returns=1, timeout=30)

    @rt.remote(num_returns="streaming")
    def gen(n):
        for i in range(n):
            yield i * 3

    streamed = [rt.get(r, timeout=30)
                for r in gen.options(resources={"res0": 1}).remote(5)]
    return kv, [r == fast for r in ready], len(rest), streamed


@pytest.mark.parametrize("program", [
    p_tasks_on_each_node, p_cross_node_bytes, p_actor_across_nodes,
    p_errors, p_placement_group, p_kv_wait_stream,
], ids=lambda p: p.__name__[2:])
def test_parity(both, program):
    ref, port = _run(both, program)
    assert port == ref
