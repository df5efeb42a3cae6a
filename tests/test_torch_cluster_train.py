"""The Train gang and Tune on a cluster driver, the port against
``ray_tpu``.

``test_spread_gang_trains_across_nodes`` takes the place of
``tests/test_train_multiproc.py::test_multiproc_gang_through_cluster_plane``
(a JAX mesh across two node servers): a two-worker gloo ``TorchTrainer``
gang ``SPREAD`` over two fixture nodes meets in rank 0's ``TCPStore``
on its node's address, trains a linear model data-parallel, and ends at
the weights one process computes over the whole batch; its ranks also
reduce over the host group ``"train"``, whose one coordinator both
nodes' ranks find.
``test_resource_changing_scheduler_sees_every_node`` and
``test_gang_without_a_free_card_raises_placement_group_error`` run one
program through both packages on their ``Cluster`` fixtures: Tune's
``ResourceChangingScheduler`` sizes its trials against the CPUs of every
node, and a gang that asks for a card while an actor holds the
cluster's only one fails with ``PlacementGroupError`` (naming the
available resources) and leaves no placement group behind.
"""

from __future__ import annotations

import os
import threading
from importlib import import_module

import numpy as np
import pytest

import ray_tpu
import ray_tpu.state
import ray_tpu_torch
import ray_tpu_torch.core.runtime_context


@pytest.fixture(scope="module")
def both():
    """A two-node cluster of each package (two CPUs a node), each driver
    installed in its package's runtime context."""
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
            c = cls(num_nodes=2, num_workers_per_node=2,
                    object_store_memory=64 << 20)
            clusters.append(c)
            assert c.wait_for_nodes(2)
            c.connect()
        yield {ray_tpu: clusters[0], ray_tpu_torch: clusters[1]}
    finally:
        for c in clusters:
            c.shutdown()
        ref_ctx.set_core(prev[0])
        port_ctx.set_core(prev[1])


def _both(program, *args):
    """``program(package, *args)`` for both packages at once, in two
    threads (their runtimes are independent); both results."""
    got = {}

    def run(rt):
        try:
            got[rt] = program(rt, *args)
        except BaseException as e:  # noqa: BLE001 — compared below
            got[rt] = e

    threads = [threading.Thread(target=run, args=(rt,))
               for rt in (ray_tpu, ray_tpu_torch)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    for rt in (ray_tpu, ray_tpu_torch):
        if isinstance(got.get(rt), BaseException):
            raise got[rt]
    return got[ray_tpu], got[ray_tpu_torch]


# ----------------------------------------------------- a gang across nodes

_X = np.random.default_rng(0).standard_normal((64, 8)).astype(np.float32)
_Y = _X @ np.arange(1, 9, dtype=np.float32) + 0.5
_STEPS, _LR = 5, 0.1


def _spread_loop(config):
    """Each rank fits its half of the batch; the gradients are averaged
    over the default group."""
    import os as _os

    import torch
    import torch.distributed as dist

    from ray_tpu_torch import train
    from ray_tpu_torch.parallel import collective

    ctx = train.get_context()
    rank, world = ctx.get_world_rank(), ctx.get_world_size()
    x = torch.from_numpy(config["x"]).chunk(world)[rank]
    y = torch.from_numpy(config["y"]).chunk(world)[rank]
    w = torch.zeros(x.shape[1], requires_grad=True)
    b = torch.zeros((), requires_grad=True)
    for step in range(config["steps"]):
        loss = ((x @ w + b - y) ** 2).mean()
        loss.backward()
        with torch.no_grad():
            for p in (w, b):
                dist.all_reduce(p.grad)
                p -= config["lr"] * p.grad / world
                p.grad = None
        host = float(collective.get_group("train").allreduce(
            np.array([rank + 1.0]))[0])
        train.report({"step": step, "loss": float(loss), "rank": rank,
                      "host_sum": host,
                      "node": _os.environ.get("RTPU_NODE_ID"),
                      "backend": dist.get_backend(),
                      "world": dist.get_world_size(),
                      "w": w.detach().numpy().tolist(), "b": float(b)})


def _one_process_fit():
    import torch

    x, y = torch.from_numpy(_X), torch.from_numpy(_Y)
    halves = list(zip(x.chunk(2), y.chunk(2)))
    w = torch.zeros(x.shape[1], requires_grad=True)
    b = torch.zeros((), requires_grad=True)
    for _ in range(_STEPS):
        for xs, ys in halves:
            ((xs @ w + b - ys) ** 2).mean().backward()
        with torch.no_grad():
            for p in (w, b):
                p -= _LR * p.grad / 2
                p.grad = None
    return w.detach().numpy(), float(b.detach())


def test_spread_gang_trains_across_nodes(both, tmp_path):
    from ray_tpu_torch import train

    res = train.TorchTrainer(
        _spread_loop,
        train_loop_config={"x": _X, "y": _Y, "steps": _STEPS, "lr": _LR},
        torch_config=train.TorchConfig(device="cpu", distributed=True),
        scaling_config=train.ScalingConfig(num_workers=2,
                                           placement_strategy="SPREAD"),
        run_config=train.RunConfig(storage_path=str(tmp_path),
                                   name="spread")).fit()
    assert res.error is None
    hist = res.metrics_history
    assert hist[0]["backend"] == "gloo" and hist[0]["world"] == 2
    # the host group's coordinator is one actor for both nodes' ranks
    assert {m["host_sum"] for m in hist} == {3.0}
    assert hist[-1]["loss"] < hist[0]["loss"]
    nodes = {n["node_id"].hex()
             for n in ray_tpu_torch.core.runtime_context.get_core().nodes()}
    w, b = _one_process_fit()
    np.testing.assert_allclose(hist[-1]["w"], w, rtol=1e-5, atol=1e-6)
    assert abs(hist[-1]["b"] - b) < 1e-5
    # rank 0's reports: the gang's other rank ran on the other node
    assert hist[-1]["node"] in nodes and len(nodes) == 2


def test_rank0_host_is_its_nodes_address(both):
    """The rendezvous host is the address rank 0's node advertises."""
    from ray_tpu_torch.train import backend
    from ray_tpu_torch.train.config import ScalingConfig
    from ray_tpu_torch.train.worker_group import WorkerGroup

    port = both[ray_tpu_torch]
    wg = WorkerGroup(ScalingConfig(num_workers=1))
    wg.start()
    try:
        host = backend._rank0_host(wg)
        addrs = {tuple(n.address)[0] for n in port.nodes}
        assert host in addrs
    finally:
        wg.shutdown()


# --------------------------------------------------- Tune's cluster view


def _rcs_program(rt, tmp):
    tune = import_module(rt.__name__ + ".tune")
    train = import_module(rt.__name__ + ".train")
    seen = []

    def objective(config):
        for step in range(3):
            tune.report({"score": float(step),
                         "training_iteration": step + 1})

    def allocate(total_cpus, num_running, trial, base):
        seen.append(total_cpus)
        return dict(base)

    sched = tune.ResourceChangingScheduler(
        resources_allocation_function=allocate)
    grid = tune.Tuner(
        objective, param_space={"x": tune.grid_search([0])},
        tune_config=tune.TuneConfig(metric="score", mode="max",
                                    scheduler=sched),
        run_config=train.RunConfig(storage_path=os.path.join(
            tmp, rt.__name__), name="rcs")).fit()
    return (sched._total_cpus, sorted(set(seen)),
            [t.last_result.get("score") for t in grid._trials],
            list(grid.errors))


def test_resource_changing_scheduler_sees_every_node(both, tmp_path):
    ref, port = _both(_rcs_program, str(tmp_path))
    assert port == ref
    total = ray_tpu.state.cluster_resources()["CPU"]
    assert ref[0] == total == 4 and ref[1] == [4.0]
    assert ref[2] == [2.0] and ref[3] == []


# ---------------------------------------------- a gang without a card


def _too_big_program(rt):
    """A one-GPU gang worker while an actor holds the cluster's one card:
    the group never becomes ready. The reference's card is a custom
    ``GPU`` resource on its node; the port's node detects one
    (``gpus=1``)."""
    train = import_module(rt.__name__ + ".train")
    exc = import_module(rt.__name__ + ".exceptions")
    util = import_module(rt.__name__ + ".util")
    gpu = {"num_gpus": 1} if rt is ray_tpu_torch else {
        "resources": {"GPU": 1}}
    scaling = (train.ScalingConfig(num_workers=1, use_gpu=True)
               if rt is ray_tpu_torch else
               train.ScalingConfig(num_workers=1,
                                   resources_per_worker={"GPU": 1}))

    @rt.remote
    class Holder:
        def ping(self):
            return 1

    holder = Holder.options(**gpu).remote()
    rt.get(holder.ping.remote(), timeout=60)
    wg_mod = import_module(rt.__name__ + ".train.worker_group")
    before = set(util.placement_group_table())
    wg = wg_mod.WorkerGroup(scaling)
    try:
        wg.start()
        return "started", None, None
    except exc.PlacementGroupError as e:
        err = e
    finally:
        if wg.workers:
            wg.shutdown()
        rt.kill(holder)
    left = [k for k in util.placement_group_table() if k not in before]
    state = import_module(rt.__name__ + ".state")
    return (type(err).__name__,
            "cannot be satisfied from available resources" in str(err)
            and state.cluster_resources()["GPU"] == 1.0, left)


def test_gang_without_a_free_card_raises_placement_group_error(both):
    from ray_tpu.core.config import config as ref_cfg
    from ray_tpu_torch.core.config import config as port_cfg

    ref, port = both[ray_tpu], both[ray_tpu_torch]
    added = [(ref, ref.add_node(num_workers=1, resources={"GPU": 1})),
             (port, port.add_node(num_workers=1, gpus=1))]
    os.environ["RTPU_TRAIN_PG_READY_TIMEOUT_S"] = "2"
    ref_cfg.reload()
    port_cfg.reload()
    try:
        assert ref.wait_for_nodes(3) and port.wait_for_nodes(3)
        got = _both(_too_big_program)
    finally:
        os.environ.pop("RTPU_TRAIN_PG_READY_TIMEOUT_S", None)
        ref_cfg.reload()
        port_cfg.reload()
        for c, node in added:
            c.remove_node(node, graceful=True)
    assert got[1] == got[0] == ("PlacementGroupError", True, [])
