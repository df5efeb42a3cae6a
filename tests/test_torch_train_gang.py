"""The port's Train gang against ``ray_tpu``'s.

The gang tests of ``tests/test_train.py`` that need no Data and no JAX
math run in this process through ``ray_tpu`` (the reference) and through
``ray_tpu_torch``, each on its own runtime, and must give equal metrics
histories, kept checkpoints, restart counts (the distinct worker pids a
run reported from) and error types. Then the port alone: a two-worker
data-parallel Llama on gloo (``TorchConfig(device="cpu",
distributed=True)``), each worker on half of a global batch with its
gradients averaged over the group, held for 3 AdamW steps to
``ray_tpu``'s ``loss_fn`` with ``optax.adamw`` on the whole batch (rtol
1e-5 on the losses, as ``tests/test_torch_train.py``); GPU placement on
injected GPU ids (no card needed: the ids only travel into
``CUDA_VISIBLE_DEVICES``); and the refusals.
"""

import importlib
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import ray_tpu
import ray_tpu_torch
from ray_tpu import train as ref_train
from ray_tpu_torch import train as port_train

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def pkgs():
    ray_tpu.init(num_workers=4, object_store_memory=64 << 20)
    ray_tpu_torch.init(num_workers=4, object_store_memory=64 << 20)
    try:
        yield {"ref": ref_train, "port": port_train}
    finally:
        ray_tpu_torch.shutdown()
        ray_tpu.shutdown()


def _cpu_backend(train):
    """The reference's JaxConfig(platform=None) and the port's
    TorchConfig(device="cpu"): host collectives, nothing on a device."""
    if train is ref_train:
        return train.JaxConfig(platform=None, host_collectives=True)
    return train.TorchConfig(device="cpu", host_collectives=True)


def _fit(train, tmp_path, loop, name, *, loop_cfg=None, workers=1,
         backend=None, **run_kw):
    run = train.RunConfig(storage_path=str(tmp_path / name / "results"),
                          name="exp", **run_kw)
    return train.DataParallelTrainer(
        loop, train_loop_config=loop_cfg, backend_config=backend,
        scaling_config=train.ScalingConfig(num_workers=workers),
        run_config=run).fit()


def _both(pkgs, tmp_path, make_loop, **kw):
    """The program through each package: {"ref": Result, "port": Result}."""
    return {key: _fit(train, tmp_path, make_loop(train), key,
                      **{k: (v(train) if callable(v) else v)
                         for k, v in kw.items()})
            for key, train in pkgs.items()}


def _history(res):
    """metrics_history with pids replaced by their order of first
    appearance: the restart count is the number of distinct pids."""
    pids = {}
    out = []
    for m in res.metrics_history:
        m = dict(m)
        if "pid" in m:
            m["pid"] = pids.setdefault(m["pid"], len(pids))
        out.append(m)
    return out


def _kept(res):
    """The trial dir's checkpoints: name -> state.json."""
    out = {}
    for p in sorted(os.listdir(res.path)):
        if p.startswith("checkpoint_"):
            with open(os.path.join(res.path, p, "state.json")) as f:
                out[p] = json.load(f)
    return out


def _error(res):
    e = res.error
    return None if e is None else (type(e).__name__,
                                   type(e.__cause__).__name__)


# ------------------------------------------------------- the gang tests


def _single_loop(train):
    def loop(config):
        for step in range(3):
            train.report({"step": step, "loss": 1.0 / (step + 1),
                          "lr": config["lr"]})
    return loop


def test_single_worker_report(pkgs, tmp_path):
    res = _both(pkgs, tmp_path, _single_loop, loop_cfg={"lr": 0.1})
    for r in res.values():
        assert r.error is None
        assert r.metrics["step"] == 2 and r.metrics["lr"] == 0.1
        assert len(r.metrics_history) == 3
    assert _history(res["port"]) == _history(res["ref"])


def _context_loop(train):
    col = importlib.import_module(
        train.__name__.rsplit(".", 1)[0] + ".parallel.collective")

    def loop(config):
        import numpy as np

        ctx = train.get_context()
        assert ctx.get_world_size() == 2
        total = col.allreduce(
            np.array([float(ctx.get_world_rank() + 1)]), group_name="train")
        train.report({"rank": ctx.get_world_rank(),
                      "allreduced": float(total[0])})
    return loop


def test_multi_worker_context_and_collective(pkgs, tmp_path):
    res = _both(pkgs, tmp_path, _context_loop, workers=2,
                backend=_cpu_backend)
    for r in res.values():
        assert r.error is None, r.error
        assert r.metrics["rank"] == 0
        assert r.metrics["allreduced"] == 3.0  # 1 + 2
    assert _history(res["port"]) == _history(res["ref"])


def _ckpt_loop(train):
    def loop(config):
        import tempfile

        for step in range(4):
            with tempfile.TemporaryDirectory() as d:
                with open(os.path.join(d, "state.json"), "w") as f:
                    json.dump({"step": step}, f)
                train.report({"step": step, "score": float(step)},
                             checkpoint=train.Checkpoint.from_directory(d))
    return loop


def test_checkpointing_and_retention(pkgs, tmp_path):
    res = _both(pkgs, tmp_path, _ckpt_loop,
                checkpoint_config=lambda t: t.CheckpointConfig(
                    num_to_keep=2, checkpoint_score_attribute="score"))
    for r in res.values():
        assert r.error is None
        # best checkpoint by score is the last one (score=3)
        with r.checkpoint.as_directory() as d:
            state = json.load(open(os.path.join(d, "state.json")))
        assert state["step"] == 3
        # retention: only 2 checkpoint dirs remain in the trial dir
        assert len(_kept(r)) == 2
    assert _kept(res["port"]) == _kept(res["ref"])
    assert _history(res["port"]) == _history(res["ref"])
    assert os.path.basename(res["port"].checkpoint.path) == \
        os.path.basename(res["ref"].checkpoint.path)


def _restart_loop(train):
    def loop(config):
        import tempfile

        ckpt = train.get_checkpoint()
        start = 0
        if ckpt is not None:
            with ckpt.as_directory() as d:
                start = json.load(open(os.path.join(d, "state.json")))[
                    "step"] + 1
        for step in range(start, 4):
            if step == 2 and not os.path.exists(config["marker"]):
                open(config["marker"], "w").close()
                raise RuntimeError("injected failure at step 2")
            with tempfile.TemporaryDirectory() as d:
                with open(os.path.join(d, "state.json"), "w") as f:
                    json.dump({"step": step, "resumed_from": start}, f)
                train.report({"step": step, "resumed_from": start,
                              "pid": os.getpid()},
                             checkpoint=train.Checkpoint.from_directory(d))
    return loop


def test_failure_restart_resumes_from_checkpoint(pkgs, tmp_path):
    res = {key: _fit(train, tmp_path, _restart_loop(train), key,
                     loop_cfg={"marker": str(tmp_path / f"crashed_{key}")},
                     failure_config=train.FailureConfig(max_failures=1))
           for key, train in pkgs.items()}
    for r in res.values():
        assert r.error is None
        assert r.metrics["step"] == 3
        # second attempt resumed from the checkpoint at step 1
        assert r.metrics["resumed_from"] == 2
    hist = _history(res["port"])
    assert hist == _history(res["ref"])
    assert len({m["pid"] for m in hist}) == 2   # one restart
    assert _kept(res["port"]) == _kept(res["ref"])


def _failing_loop(train):
    def loop(config):
        raise ValueError("always fails")
    return loop


def test_failure_exhausts_retries(pkgs, tmp_path):
    res = _both(pkgs, tmp_path, _failing_loop,
                failure_config=lambda t: t.FailureConfig(max_failures=1))
    for r in res.values():
        assert r.error is not None
        assert "always fails" in str(r.error)
    assert _error(res["port"]) == _error(res["ref"]) == (
        "TrainingWorkerError", "ValueError")


def _uneven_loop(train):
    def loop(config):
        ctx = train.get_context()
        n = 2 if ctx.get_world_rank() == 0 else 1
        for step in range(n):
            train.report({"step": step})
    return loop


def test_uneven_reports_raise(pkgs, tmp_path):
    res = _both(pkgs, tmp_path, _uneven_loop, workers=2)
    for r in res.values():
        assert r.error is not None
    assert _error(res["port"]) == _error(res["ref"])
    assert _history(res["port"]) == _history(res["ref"])


# --------------------------------------------- data-parallel Llama (gloo)


def _dp_llama_loop(config):
    import torch
    import torch.distributed as dist

    from ray_tpu_torch import train
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.models.convert import params_from_numpy

    torch.set_num_threads(1)
    ctx = train.get_context()
    rank, world = ctx.get_world_rank(), ctx.get_world_size()
    cfg = llama.LlamaConfig.tiny()
    params = params_from_numpy(config["params"], "cpu")
    leaves = [p.requires_grad_() for _, p in llama.param_leaves(params)]
    opt = torch.optim.AdamW(leaves, lr=3e-4, weight_decay=0.01)
    toks = torch.from_numpy(config["tokens"])
    half = toks.shape[0] // world
    mine = toks[rank * half:(rank + 1) * half]
    for step in range(3):
        opt.zero_grad(set_to_none=True)
        loss = llama.loss_fn(cfg, params, {"tokens": mine})
        loss.backward()
        for p in leaves:
            dist.all_reduce(p.grad)
            p.grad /= world
        opt.step()
        mean = loss.detach().clone()
        dist.all_reduce(mean)
        train.report({"step": step, "loss": float(mean / world),
                      "world": dist.get_world_size(),
                      "backend": dist.get_backend()})


def test_data_parallel_llama_matches_optax(pkgs, tmp_path):
    """Two workers on gloo, half of a 4 x 65 batch each, gradients
    averaged over the group: the losses of 3 AdamW steps equal
    ``ray_tpu``'s loss_fn + optax.adamw on the whole batch."""
    jax = pytest.importorskip("jax")
    optax = pytest.importorskip("optax")
    import jax.numpy as jnp

    from ray_tpu.models import llama as jl

    jcfg = jl.LlamaConfig.tiny(attn_impl="reference")
    p = jax.tree_util.tree_map(np.asarray,
                               jl.init_params(jcfg, jax.random.PRNGKey(7)))
    toks = np.random.default_rng(8).integers(0, 256, (4, 65)).astype(
        np.int32)

    tx = optax.adamw(3e-4, weight_decay=0.01)
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    state = tx.init(jp)
    want = []
    for _ in range(3):
        loss, grads = jax.value_and_grad(lambda pp: jl.loss_fn(
            jcfg, pp, {"tokens": jnp.asarray(toks)}))(jp)
        updates, state = tx.update(grads, state, jp)
        jp = optax.apply_updates(jp, updates)
        want.append(float(loss))

    res = port_train.TorchTrainer(
        _dp_llama_loop,
        train_loop_config={"params": p, "tokens": toks},
        torch_config=port_train.TorchConfig(device="cpu", distributed=True),
        scaling_config=port_train.ScalingConfig(num_workers=2),
        run_config=port_train.RunConfig(storage_path=str(tmp_path),
                                        name="dp")).fit()
    assert res.error is None, res.error
    got = [m["loss"] for m in res.metrics_history]
    assert {(m["world"], m["backend"]) for m in res.metrics_history} == {
        (2, "gloo")}
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got[-1] < got[0]


# ------------------------------------------------------ GPUs, refusals


@pytest.fixture
def gpu_node(pkgs):
    """A port runtime with injected GPU ids in place of the module's, for
    the test's length."""
    from ray_tpu_torch.core import runtime_context
    from ray_tpu_torch.core.resources import GpuSet
    from ray_tpu_torch.core.runtime import Runtime

    prev = runtime_context.get_core()
    made = []

    def make(n):
        if made:
            made.pop().shutdown()
        core = Runtime(num_workers=2, object_store_memory=32 << 20,
                       gpus=GpuSet(n))
        made.append(core)
        runtime_context.set_core(core)
        return core

    try:
        yield make
    finally:
        for core in made:
            core.shutdown()
        runtime_context.set_core(prev)


def _gpu_loop(config):
    import os

    from ray_tpu_torch import train

    train.report({"visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
                  "ids": os.environ.get("RTPU_GPU_IDS")})


def test_gpu_workers_get_one_id_each(gpu_node, tmp_path, monkeypatch):
    """Two ``use_gpu`` workers on two GPUs: one distinct id each in
    ``CUDA_VISIBLE_DEVICES``, given back after the run. On one GPU the
    same gang raises PlacementGroupError naming the GPU bundle, and never
    runs on the CPU."""
    from ray_tpu_torch.core.config import config
    from ray_tpu_torch.exceptions import PlacementGroupError
    from ray_tpu_torch.train.backend import BackendConfig
    from ray_tpu_torch.train.backend_executor import BackendExecutor

    scaling = port_train.ScalingConfig(num_workers=2, use_gpu=True)
    core = gpu_node(2)
    ex = BackendExecutor(BackendConfig(), scaling)
    ex.start()
    try:
        ids = [i["gpu_ids"] for i in ray_tpu_torch.get(
            [w.node_info.remote() for w in ex.worker_group.workers])]
        visible = ex.worker_group.execute(
            lambda: __import__("os").environ.get("CUDA_VISIBLE_DEVICES"))
    finally:
        ex.shutdown()
    assert sorted(ids) == ["0", "1"] and visible == ids, (ids, visible)
    gang = port_train.DataParallelTrainer(
        _gpu_loop, scaling_config=scaling,
        run_config=port_train.RunConfig(storage_path=str(tmp_path),
                                        name="gpu"))
    res = gang.fit()
    assert res.error is None, res.error
    m = res.metrics
    assert m["visible"] == m["ids"] and m["visible"] in ("0", "1"), m
    assert core.state_summary()["resources"]["available"]["GPU"] == 2.0

    core = gpu_node(1)
    monkeypatch.setenv("RTPU_TRAIN_PG_READY_TIMEOUT_S", "2")
    config.reload()
    try:
        with pytest.raises(PlacementGroupError, match="'GPU': 1.0"):
            gang.fit()
    finally:
        monkeypatch.delenv("RTPU_TRAIN_PG_READY_TIMEOUT_S")
        config.reload()
    summary = core.state_summary()
    assert summary["resources"]["available"]["GPU"] == 1.0
    assert not summary["actors"], summary["actors"]


def test_device_none_without_gpus_is_refused(pkgs, tmp_path):
    """TorchConfig(device=None) trains on the card each worker holds:
    without ``use_gpu`` it raises at fit(), before any worker starts."""
    from ray_tpu_torch.core import runtime_context

    before = len(runtime_context.get_core().state_summary()["actors"])
    trainer = port_train.TorchTrainer(
        _gpu_loop, scaling_config=port_train.ScalingConfig(num_workers=2),
        run_config=port_train.RunConfig(storage_path=str(tmp_path)))
    with pytest.raises(ValueError, match="use_gpu=True"):
        trainer.fit()
    assert len(runtime_context.get_core().state_summary()["actors"]) == \
        before
    assert os.listdir(tmp_path) == []   # no experiment dir either


def test_train_import_loads_no_torch():
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys, ray_tpu_torch.train as t; "
         "print('torch' in sys.modules, 'jax' in sys.modules, "
         "sorted(n for n in ('TorchConfig', 'TorchTrainer', "
         "'DataParallelTrainer', 'ScalingConfig', 'WorkerGroup', "
         "'BackendExecutor', 'StorageContext', 'preempted') "
         "if hasattr(t, n)) == sorted(('TorchConfig', 'TorchTrainer', "
         "'DataParallelTrainer', 'ScalingConfig', 'WorkerGroup', "
         "'BackendExecutor', 'StorageContext', 'preempted')))"],
        cwd=ROOT, capture_output=True, text=True, check=True, timeout=120)
    assert out.stdout.split() == ["False", "False", "True"]
    from ray_tpu_torch.train import TorchPredictor, dist_checkpoint
    assert callable(dist_checkpoint.save) and TorchPredictor.predict
