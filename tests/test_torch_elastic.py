"""Elastic gang training through the port: ``tests/test_fault_tolerance.py``'s
chaos drill and its floor case, on ``ray_tpu_torch``'s runtime.

The loop is the reference's data-parallel SGD on a fixed linear
regression in float64, deterministic at any world size (step ``s``'s
global batch comes from an rng keyed by ``s``; each rank takes the
``rank::world`` slice; the allreduced gradient SUM is normalized by the
global batch): the loss curve of a gang that shrinks and grows must equal
an uninterrupted run's at rtol 1e-8, and rank 0's process must survive
every resize. The port's case: a shrink under ``TorchConfig(
distributed=True)`` on gloo, where the gradient is summed over the
default process group, 3 workers to 2 — the group is re-formed at world
size 2, and the steps after the shrink equal an uninterrupted 2-worker
run resumed from the same checkpoint; and a survivor's loop error that a
peer's death caused, seen before the death itself, is a resize too.
"""

import os

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch.core import runtime_context

pytest.importorskip("torch")


@pytest.fixture
def local_rt():
    prev = runtime_context.get_core_or_none()
    runtime_context.set_core(None)
    yield
    ray_tpu_torch.shutdown()
    runtime_context.set_core(prev)


@pytest.fixture
def fault_injection():
    from ray_tpu_torch.core import fault_injection as fi

    fi.clear()
    yield fi
    fi.clear()


def _elastic_sgd_loop(config):
    """Data-parallel SGD on a fixed linear-regression problem, float64;
    the gradient is summed over the host group ``"train"``, or over the
    default process group when ``config["dist"]``. A step takes at least
    ``config["step_s"]`` seconds when given."""
    import json as _json
    import os as _os
    import tempfile
    import time as _time

    import numpy as np

    from ray_tpu_torch import train
    from ray_tpu_torch.parallel import collective

    ctx = train.get_context()
    rank, world = ctx.get_world_rank(), ctx.get_world_size()
    dim, gb = 4, int(config["global_batch"])
    true_w = np.arange(1.0, dim + 1.0)
    weights = np.zeros(dim, dtype=np.float64)
    start = 0
    ckpt = train.get_checkpoint()
    if ckpt is not None:
        with ckpt.as_directory() as d:
            state = _json.load(open(_os.path.join(d, "state.json")))
        start = state["step"] + 1
        weights = np.asarray(state["w"], dtype=np.float64)
    dist_world = 0
    if config.get("dist"):
        import torch
        import torch.distributed as dist

        dist_world = dist.get_world_size()
    for step in range(start, int(config["steps"])):
        if train.preempted():
            # maintenance SIGTERM observed at the step boundary — the
            # previous step's checkpoint is already persisted
            raise train.PreemptedError(f"rank {rank} preempted")
        _time.sleep(float(config.get("step_s", 0.0)))
        rng = np.random.default_rng(1000 + step)  # keyed by step ONLY
        X = rng.normal(size=(gb, dim))
        y = X @ true_w
        Xs, ys = X[rank::world], y[rank::world]
        grad = Xs.T @ (Xs @ weights - ys)  # local SUM over the shard
        if config.get("dist"):
            t = torch.from_numpy(grad)
            dist.all_reduce(t)
            grad = t.numpy()
        elif world > 1:
            grad = np.asarray(
                collective.allreduce(grad, group_name="train"))
        weights = weights - float(config["lr"]) * grad / gb
        loss = float(np.mean((X @ weights - y) ** 2))
        with tempfile.TemporaryDirectory() as d:
            with open(_os.path.join(d, "state.json"), "w") as f:
                _json.dump({"step": step, "w": weights.tolist()}, f)
            train.report(
                {"step": step, "loss": loss, "world": world,
                 "dist_world": dist_world, "pid": _os.getpid()},
                checkpoint=train.Checkpoint.from_directory(d))


def _fit_elastic(loop_cfg, scaling, storage_path, max_failures=0,
                 distributed=False, resume=None):
    from ray_tpu_torch import train
    from ray_tpu_torch.train import FailureConfig, RunConfig, TorchConfig

    trainer = train.DataParallelTrainer(
        _elastic_sgd_loop,
        train_loop_config=dict(loop_cfg, dist=distributed),
        backend_config=TorchConfig(device="cpu", host_collectives=True,
                                   distributed=distributed, timeout_s=10.0),
        scaling_config=scaling,
        run_config=RunConfig(storage_path=storage_path, name="elastic",
                             failure_config=FailureConfig(
                                 max_failures=max_failures)),
        resume_from_checkpoint=resume,
    )
    return trainer.fit()


def test_elastic_chaos_shrink_grow_loss_parity(local_rt, fault_injection,
                                               tmp_path, monkeypatch):
    """The chaos drill: a 4-worker elastic gang rides through an abrupt
    SIGKILL (shrink to 3), grows back when the cooldown expires, then
    rides through a scheduled SIGTERM preemption — and the per-step loss
    curve is identical to an uninterrupted 4-worker run. Rank 0's worker
    process survives every resize (warm resume, not a cold gang
    restart). A step takes at least 20 ms: the port's runtime runs one in
    a few ms here, and 80 of them can end inside the 0.4 s grow cooldown,
    leaving the gang no moment to grow back in."""
    from ray_tpu_torch.core.config import config
    from ray_tpu_torch.train import ScalingConfig

    fi = fault_injection
    monkeypatch.setenv("RTPU_ELASTIC_GROW_COOLDOWN_S", "0.4")
    config.reload()
    try:
        ray_tpu_torch.init(num_workers=6, object_store_memory=128 << 20)
        steps = 80
        loop_cfg = {"steps": steps, "global_batch": 16, "lr": 0.05,
                    "step_s": 0.02}

        base = _fit_elastic(loop_cfg, ScalingConfig(num_workers=4),
                            str(tmp_path / "base"))
        assert base.error is None, base.error
        base_loss = {m["step"]: m["loss"] for m in base.metrics_history}
        assert len(base_loss) == steps

        # abrupt preemption (SIGKILL) after batch 3; scheduled
        # preemption (SIGTERM, checkpoint grace) after batch 45
        fi.inject("gang_resize", "kill", target="3")
        fi.inject("gang_resize", "sigterm", target="45")
        el = _fit_elastic(loop_cfg,
                          ScalingConfig(num_workers=4, min_workers=2),
                          str(tmp_path / "elastic"))
        assert el.error is None, el.error

        # deterministic resume: replayed steps overwrite their first
        # attempt (last occurrence wins), and every step's loss matches
        # the uninterrupted run
        el_loss, pids0 = {}, set()
        for m in el.metrics_history:
            el_loss[m["step"]] = m["loss"]
            pids0.add(m["pid"])
        assert set(el_loss) == set(base_loss)
        for s in sorted(base_loss):
            assert np.isclose(el_loss[s], base_loss[s],
                              rtol=1e-8, atol=1e-12), \
                f"step {s}: {el_loss[s]} != {base_loss[s]}"

        # the gang really shrank, and grew back when capacity returned
        worlds = [m["world"] for m in el.metrics_history]
        assert min(worlds) < 4, "the gang never shrank"
        shrinks = [e for e in el.elastic_stats if e["event"] == "shrink"]
        grows = [e for e in el.elastic_stats if e["event"] == "grow"]
        assert len(shrinks) >= 2, el.elastic_stats  # kill + sigterm
        assert len(grows) >= 1, el.elastic_stats
        assert all(e["resume_s"] > 0 for e in el.elastic_stats)
        assert {e["cause"] for e in shrinks} >= {"ActorDiedError",
                                                 "PreemptedError"}

        # warm resume: rank 0's process was never replaced
        assert len(pids0) == 1, f"rank-0 worker was replaced: {pids0}"
    finally:
        monkeypatch.delenv("RTPU_ELASTIC_GROW_COOLDOWN_S")
        config.reload()


def test_elastic_below_min_workers_cold_restarts(local_rt, fault_injection,
                                                 tmp_path):
    """Shrinking below min_workers must NOT limp along at a world size
    the user forbade: the resize path raises TrainingWorkerError and
    recovery goes through the classic cold gang restart (consuming the
    failure budget), resuming from the last consistent checkpoint."""
    from ray_tpu_torch.train import ScalingConfig

    fi = fault_injection
    ray_tpu_torch.init(num_workers=4, object_store_memory=64 << 20)
    fi.inject("gang_resize", "kill", target="1")
    res = _fit_elastic({"steps": 6, "global_batch": 8, "lr": 0.05},
                       ScalingConfig(num_workers=2, min_workers=2),
                       str(tmp_path / "floor"), max_failures=1)
    assert res.error is None, res.error
    assert not res.elastic_stats, res.elastic_stats  # no in-place resize
    step_seq = [m["step"] for m in res.metrics_history]
    assert set(step_seq) == set(range(6))
    # the restart resumed from the batch-1 checkpoint, not from scratch
    assert step_seq.count(0) == 1, step_seq


def test_elastic_shrink_reforms_the_process_group(local_rt, fault_injection,
                                                  tmp_path):
    """A 3-worker gang on gloo (``distributed=True``, the gradient summed
    over the default group) loses rank 2 after batch 2: the survivors
    leave the broken group and join one of world size 2, resume from step
    2's checkpoint, and give the losses of an uninterrupted 2-worker run
    resumed from that checkpoint."""
    from ray_tpu_torch.train import Checkpoint, ScalingConfig

    fi = fault_injection
    ray_tpu_torch.init(num_workers=5, object_store_memory=64 << 20)
    loop_cfg = {"steps": 6, "global_batch": 12, "lr": 0.05}
    fi.inject("gang_resize", "kill", target="2")
    el = _fit_elastic(loop_cfg, ScalingConfig(num_workers=3, min_workers=2),
                      str(tmp_path / "elastic"), distributed=True)
    assert el.error is None, el.error
    fi.clear()
    shrinks = [e for e in el.elastic_stats if e["event"] == "shrink"]
    assert [(e["old_world"], e["new_world"], e["cause"])
            for e in shrinks] == [(3, 2, "ActorDiedError")], el.elastic_stats
    seen = [(m["step"], m["world"], m["dist_world"])
            for m in el.metrics_history]
    assert seen[:3] == [(0, 3, 3), (1, 3, 3), (2, 3, 3)], seen
    after = {m["step"]: m for m in el.metrics_history[3:]}
    assert sorted(after) == [3, 4, 5], seen
    assert all((m["world"], m["dist_world"]) == (2, 2)
               for m in after.values()), seen
    assert len({m["pid"] for m in el.metrics_history}) == 1   # rank 0 kept

    ckpt = os.path.join(el.path, "checkpoint_000002")
    two = _fit_elastic(loop_cfg, ScalingConfig(num_workers=2),
                       str(tmp_path / "two"), distributed=True,
                       resume=Checkpoint.from_directory(ckpt))
    assert two.error is None, two.error
    want = {m["step"]: m["loss"] for m in two.metrics_history}
    assert sorted(want) == [3, 4, 5]
    for s in want:
        assert np.isclose(after[s]["loss"], want[s], rtol=1e-8,
                          atol=1e-12), (s, after[s]["loss"], want[s])


def _peer_death_loop(config):
    """Three steps with a checkpoint each. At step 1 of the two-worker
    incarnation rank 1 publishes its pid and sleeps (the test stops it,
    then kills it), and rank 0 fails as a collective with a dead peer
    fails, once the test says the peer is stopped."""
    import json as _json
    import os as _os
    import tempfile
    import time as _time

    from ray_tpu_torch import train

    ctx = train.get_context()
    rank, world = ctx.get_world_rank(), ctx.get_world_size()
    start = 0
    ckpt = train.get_checkpoint()
    if ckpt is not None:
        with ckpt.as_directory() as d:
            start = _json.load(open(_os.path.join(d, "state.json")))[
                "step"] + 1
    for step in range(start, 3):
        if step == 1 and world == 2:
            if rank == 1:
                tmp = config["pid_file"] + ".tmp"
                with open(tmp, "w") as f:
                    f.write(str(_os.getpid()))
                _os.rename(tmp, config["pid_file"])
                _time.sleep(600)
            while not _os.path.exists(config["go_file"]):
                _time.sleep(0.01)
            raise RuntimeError("Connection closed by peer")
        with tempfile.TemporaryDirectory() as d:
            with open(_os.path.join(d, "state.json"), "w") as f:
                _json.dump({"step": step}, f)
            train.report({"step": step, "world": world,
                          "pid": _os.getpid()},
                         checkpoint=train.Checkpoint.from_directory(d))


def test_loop_error_from_a_dead_peer_is_a_resize(local_rt, tmp_path):
    """A collective of the default group fails on the survivor as soon as
    a peer dies (gloo), which can be before the runtime reports the
    death. Made deterministic: rank 1 is stopped, rank 0's loop raises,
    and only then is rank 1 killed. The harvest probes the peers, finds
    rank 1 dead, and resizes instead of failing the run."""
    import signal
    import threading
    import time

    from ray_tpu_torch import train
    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchConfig

    ray_tpu_torch.init(num_workers=3, object_store_memory=64 << 20)
    pid_file, go_file = str(tmp_path / "pid"), str(tmp_path / "go")

    def chaos():
        deadline = time.monotonic() + 60
        while not os.path.exists(pid_file) and time.monotonic() < deadline:
            time.sleep(0.01)
        pid = int(open(pid_file).read())
        os.kill(pid, signal.SIGSTOP)
        open(go_file, "w").close()
        time.sleep(1.0)   # the harvest holds rank 0's error by now
        os.kill(pid, signal.SIGKILL)

    t = threading.Thread(target=chaos, daemon=True)
    t.start()
    res = train.DataParallelTrainer(
        _peer_death_loop,
        train_loop_config={"pid_file": pid_file, "go_file": go_file},
        backend_config=TorchConfig(device="cpu"),
        scaling_config=ScalingConfig(num_workers=2, min_workers=1),
        run_config=RunConfig(storage_path=str(tmp_path / "res"),
                             name="peer")).fit()
    t.join(timeout=30)
    assert not t.is_alive()
    assert res.error is None, res.error
    assert [(m["step"], m["world"]) for m in res.metrics_history] == [
        (0, 2), (1, 1), (2, 1)]
    assert [(e["event"], e["old_world"], e["new_world"], e["cause"])
            for e in res.elastic_stats] == [("shrink", 2, 1,
                                             "ActorDiedError")]
    assert len({m["pid"] for m in res.metrics_history}) == 1


def test_resize_keeps_an_unobserved_preemption(local_rt):
    """A survivor whose SIGTERM landed after its last step boundary has
    not acted on it yet: the resize must keep its flag, so its loop
    bows out at the next boundary. (``ray_tpu``'s ``on_resize`` re-arms
    every worker, which clears the flag and loses the preemption.)"""
    import signal
    import time

    from ray_tpu_torch.train import ScalingConfig, TorchConfig, session
    from ray_tpu_torch.train.backend_executor import BackendExecutor

    ray_tpu_torch.init(num_workers=3, object_store_memory=64 << 20)
    ex = BackendExecutor(TorchConfig(device="cpu"),
                         ScalingConfig(num_workers=2, min_workers=1))
    ex.start()
    try:
        wg = ex.worker_group
        pid = ray_tpu_torch.get(wg.workers[0].node_info.remote())["pid"]
        assert wg.execute_single(0, session.preempted) is False
        os.kill(pid, signal.SIGTERM)   # trap_sigterm: the flag, no exit
        deadline = time.monotonic() + 10
        while not wg.execute_single(0, session.preempted):
            assert time.monotonic() < deadline, "SIGTERM never flagged"
            time.sleep(0.01)
        wg.remove_positions({1})
        wg.generation += 1
        wg.reassign_ranks()
        ex.backend.on_resize(wg, ex.backend_config)
        assert wg.execute_single(0, session.preempted) is True
    finally:
        ex.shutdown()
