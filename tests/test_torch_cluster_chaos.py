"""The serve chaos drill under ``RTPU_NETEM`` on two nodes, the port
against ``ray_tpu``.

The program of ``tests/test_serve_replay.py::
test_chaos_sigkill_rounds_zero_lost_requests`` (two replicas, a replica
SIGKILLed each round under unary traffic, replay on, affinity off and
on) runs on a two-node ``Cluster`` of each package at once. Every node
process is started with the reference's delay rule
``node->node=delay,ms=1,jitter=2`` (its seeds), and the drivers load it
as the reference test does. The port's replicas are one a node (a
``pool`` resource of 1 on each): the controller creates the second
where the first's node has no ``pool`` left, so it leaves for the other
node (``NodeServer.spill_actor``), and controller-to-replica calls
cross node-to-node edges. The reference places no worker-created actor
off its worker's node (such an actor pends there), so its replicas run
unpinned, on the controller's node. Both must lose no request and
execute none twice, with equal replies; the port's nodes' netem
schedules show delayed node-to-node messages.
"""

from __future__ import annotations

import os
import signal
import threading
import time
from importlib import import_module

import pytest

import ray_tpu
import ray_tpu_torch


def _drill(rt, cluster, affinity: bool, pin: bool):
    """The reference drill's body, its replicas one a node when ``pin``;
    returns what its assertions read."""
    serve = import_module(rt.__name__ + ".serve")
    netem = import_module(rt.__name__ + ".core.netem")
    rpc = import_module(rt.__name__ + ".core.cluster.rpc")
    seed = 33 if affinity else 7
    name = f"chaos{int(affinity)}"

    @serve.deployment(name=name, num_replicas=2,
                      resources={"pool": 1} if pin else None)
    class Victim:
        def __init__(self):
            self.seen = []

        def __call__(self, x):
            self.seen.append(x)
            return x * 2 + 1

        def pid(self):
            return os.getpid(), os.environ.get("RTPU_NODE_ID")

        def dupes(self):
            return sorted(x for x in set(self.seen)
                          if self.seen.count(x) > 1)

    handle = serve.run(Victim.bind())
    netem.load_env({"RTPU_NETEM": f"{seed}:node->node=delay,ms=1,jitter=2"})
    out = []
    try:
        killed = set()
        base = 0
        for _ in range(2):
            seen = set()
            deadline = time.monotonic() + 60
            while (len({p for p, _ in seen}) < 2
                   and time.monotonic() < deadline):
                seen.add(handle.pid.remote().result(timeout=30))
            pids = {p for p, _ in seen}
            out.append((len(pids), len({n for _, n in seen})))
            victim = sorted(pids - killed)[0]
            futs = [handle.remote(base + i) for i in range(10)]
            os.kill(victim, signal.SIGKILL)
            killed.add(victim)
            out.append([f.result(timeout=60) for f in futs])
            base += 10
            deadline = time.monotonic() + 60
            while time.monotonic() < deadline:
                if serve.status()[name]["running"] >= 2:
                    break
                time.sleep(0.3)
        out.append([handle.dupes.remote().result(timeout=30)
                    for _ in range(8)])
    finally:
        netem.clear()
        serve.shutdown()
    delayed = []
    for node in cluster.nodes:
        client = rpc.RpcClient(tuple(node.address), cluster.authkey)
        try:
            sched = client.call(("netem", "schedule"))
        finally:
            client.close()
        delayed.append(any(edge.startswith("node->") and "delay" in spec
                           for edge, spec, _ in sched))
    out.append(any(delayed))
    return out


@pytest.mark.parametrize("affinity", [False, True],
                         ids=["affinity_off", "affinity_on"])
def test_chaos_sigkill_rounds_on_two_nodes(affinity):
    from ray_tpu.core import runtime_context as ref_ctx
    from ray_tpu.core.cluster.fixture import Cluster as RefCluster
    from ray_tpu.core.config import config as ref_cfg
    from ray_tpu_torch.core import runtime_context as port_ctx
    from ray_tpu_torch.core.cluster import Cluster as PortCluster
    from ray_tpu_torch.core.config import config as port_cfg

    seed = 33 if affinity else 7
    flags = {"RTPU_SERVE_REQUEST_REPLAY": "1",
             "RTPU_SERVE_CACHE_AFFINITY": str(int(affinity))}
    env = dict(flags, RTPU_NETEM=f"{seed}:node->node=delay,ms=1,jitter=2")
    prev = (ref_ctx.get_core_or_none(), port_ctx.get_core_or_none())
    ref_ctx.set_core(None)
    port_ctx.set_core(None)
    saved = {k: os.environ.get(k) for k in flags}
    os.environ.update(flags)
    ref_cfg.reload()
    port_cfg.reload()
    clusters = {}
    got = {}
    try:
        for rt, cls in ((ray_tpu, RefCluster), (ray_tpu_torch, PortCluster)):
            c = cls(num_nodes=2, num_workers_per_node=2,
                    object_store_memory=64 << 20,
                    node_resources=[{"pool": 1}, {"pool": 1}], env=env)
            clusters[rt] = c
            assert c.wait_for_nodes(2)
            c.connect()

        def run(rt):
            try:
                got[rt] = _drill(rt, clusters[rt], affinity,
                                 pin=rt is ray_tpu_torch)
            except BaseException as e:  # noqa: BLE001 — raised below
                got[rt] = e

        threads = [threading.Thread(target=run, args=(rt,))
                   for rt in clusters]
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
    finally:
        for c in clusters.values():
            c.shutdown()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        ref_cfg.reload()
        port_cfg.reload()
        ref_ctx.set_core(prev[0])
        port_ctx.set_core(prev[1])
    for rt in (ray_tpu, ray_tpu_torch):
        if isinstance(got.get(rt), BaseException):
            raise got[rt]
    ref, port = got[ray_tpu], got[ray_tpu_torch]
    # replies and duplicates equal; replicas and nodes seen each round
    assert [port[i] for i in (1, 3, 4)] == [ref[i] for i in (1, 3, 4)]
    assert ref[0] == ref[2] == (2, 1) and port[0] == port[2] == (2, 2)
    assert ref[1] == [i * 2 + 1 for i in range(10)]
    assert ref[3] == [(10 + i) * 2 + 1 for i in range(10)]
    assert ref[4] == [[]] * 8 and port[5] is True
