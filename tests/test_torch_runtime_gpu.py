"""GPUs as a resource of the port's runtime, and the slice on the CPU.

The runtime gets an injected set of 4 GPU ids (no card is needed: the
ids only travel into ``CUDA_VISIBLE_DEVICES``), as
``tests/test_placement_groups.py`` injects a simulated TPU slice. The
cases mirror that file's TPU ones: a GPU actor's worker sees its ids,
bundles are bound to ids and give them back, GPUs are actor-scoped,
plain workers see no card, and a GPU actor that cannot be placed stays
pending.

The last case serves the tiny preset from an actor of each runtime:
``ray_tpu``'s ``PagedLLMEngine`` in a JAX-on-CPU worker and the port's in
a worker of the port's runtime, driven through actor calls (submit, then
poll collect) as a replica's router drives one. The weights go to both
actors as numpy through each runtime's ``put``; the transcripts must be
identical.
"""

import os
import time

import numpy as np
import pytest

import ray_tpu
import ray_tpu_torch
from ray_tpu_torch.core import runtime_context
from ray_tpu_torch.core.resources import GpuSet
from ray_tpu_torch.util import (PlacementGroupSchedulingStrategy,
                                placement_group, placement_group_table,
                                remove_placement_group)

TINY = dict(model_config={"preset": "tiny"}, num_slots=4, max_len=96,
            prefill_buckets=[16], max_new_tokens=8, chunk_steps=4)


@pytest.fixture(scope="module")
def core():
    from ray_tpu_torch.core.runtime import Runtime

    rt = Runtime(num_workers=2, object_store_memory=64 << 20,
                 gpus=GpuSet(4))
    runtime_context.set_core(rt)
    try:
        yield rt
    finally:
        rt.shutdown()
        runtime_context.set_core(None)


def _free_ids(core):
    with core._lock:
        return sorted(core.gpus._free)


@ray_tpu_torch.remote
class Probe:
    """Reports what its worker process was given."""

    def env(self):
        return (os.environ.get("CUDA_VISIBLE_DEVICES"),
                os.environ.get("RTPU_GPU_IDS"), os.getpid())


def test_node_reports_its_gpus(core):
    total = core.state_summary()["resources"]["total"]
    assert total["GPU"] == 4.0


def test_gpu_actor_sees_its_ids_and_returns_them(core):
    a = Probe.options(num_gpus=2).remote()
    visible, ids, pid = ray_tpu_torch.get(a.env.remote(), timeout=60)
    assert visible == ids and len(visible.split(",")) == 2
    assert _free_ids(core) == sorted(set("0123") - set(visible.split(",")))
    # a dedicated worker: never one of the pool's
    with core._lock:
        pool = {w.proc.pid for w in core._workers.values()
                if w.actor_id is None}
    assert pid not in pool
    ray_tpu_torch.kill(a)
    assert _free_ids(core) == ["0", "1", "2", "3"]


def test_strict_pack_binds_and_releases_ids(core):
    pg = placement_group([{"GPU": 2}, {"GPU": 2}], strategy="STRICT_PACK")
    assert pg.wait(10)
    b0, b1 = pg.gpus_for_bundle(0), pg.gpus_for_bundle(1)
    assert sorted(b0 + b1) == ["0", "1", "2", "3"] and _free_ids(core) == []
    assert placement_group_table()[pg.id.hex()]["gpu_ids"] == [b0, b1]
    a = Probe.options(num_gpus=2, scheduling_strategy=(
        PlacementGroupSchedulingStrategy(pg, 1))).remote()
    visible, _, _ = ray_tpu_torch.get(a.env.remote(), timeout=60)
    assert visible.split(",") == b1
    ray_tpu_torch.kill(a)
    remove_placement_group(pg)
    assert _free_ids(core) == ["0", "1", "2", "3"]


def test_group_waits_for_ids_held_elsewhere(core):
    whole = placement_group([{"GPU": 4}], strategy="STRICT_PACK")
    assert whole.wait(10) and len(whole.gpus_for_bundle(0)) == 4
    pending = placement_group([{"GPU": 1}])
    assert not pending.wait(0.2)
    remove_placement_group(whole)
    assert pending.wait(10) and len(pending.gpus_for_bundle(0)) == 1
    remove_placement_group(pending)
    with pytest.raises(ValueError, match="never fit"):
        placement_group([{"GPU": 5}])


def test_gpu_actor_without_ids_stays_pending(core):
    pg = placement_group([{"GPU": 4}])
    assert pg.wait(10)
    a = Probe.options(num_gpus=1).remote()
    ref = a.env.remote()
    ready, _ = ray_tpu_torch.wait([ref], timeout=0.5)
    assert ready == []
    remove_placement_group(pg)   # the ids come back: the actor starts
    visible, _, _ = ray_tpu_torch.get(ref, timeout=60)
    assert len(visible.split(",")) == 1
    ray_tpu_torch.kill(a)


def test_task_num_gpus_rejected(core):
    @ray_tpu_torch.remote
    def uses_gpu():
        return "ran"

    with pytest.raises(ValueError, match="actor-scoped"):
        uses_gpu.options(num_gpus=1).remote()


def test_cpu_workers_see_no_card(core):
    @ray_tpu_torch.remote
    def probe():
        import torch

        return os.environ.get("CUDA_VISIBLE_DEVICES"), \
            torch.cuda.is_available()

    assert ray_tpu_torch.get(probe.remote(), timeout=60) == ("", False)
    a = Probe.remote()   # a CPU actor takes a pool worker: no card either
    assert ray_tpu_torch.get(a.env.remote(), timeout=60)[:2] == ("", None)
    ray_tpu_torch.kill(a)


def test_detection_never_imports_torch(monkeypatch):
    monkeypatch.setenv("RTPU_GPUS", "3")
    assert GpuSet.detect().ids == ["0", "1", "2"]
    monkeypatch.delenv("RTPU_GPUS")
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "2,5")
    assert GpuSet.detect().ids == ["2", "5"]
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    assert GpuSet.detect() is None


# ------------------------------------------------------------ the slice


def _drain(submit, collect, reqs, timeout_s=180):
    for rid, prompt in reqs:
        submit(rid, prompt)
    out = {}
    deadline = time.monotonic() + timeout_s
    while len(out) < len(reqs) and time.monotonic() < deadline:
        out.update(collect())
    assert len(out) == len(reqs), f"only {sorted(out)} finished"
    return {k: v["tokens"] for k, v in out.items()}


def test_actor_hosted_engines_match(core):
    import jax

    from ray_tpu.models import llama as jl

    params = jax.tree_util.tree_map(
        np.asarray, jl.init_params(jl.LlamaConfig.tiny(),
                                   jax.random.PRNGKey(0)))
    rng = np.random.default_rng(7)
    reqs = [(f"r{i}", [int(t) for t in rng.integers(1, 250, n)])
            for i, n in enumerate((3, 23, 9, 40))]

    @ray_tpu.remote
    class RefReplica:
        def __init__(self, params_np):
            import jax as _jax

            from ray_tpu.serve.paged_engine import PagedLLMEngine

            self.eng = PagedLLMEngine(page_size=8, **TINY)
            # the reference engine draws its weights itself: hold them to
            # the ones that came through the reference's put
            same = _jax.tree_util.tree_map(
                lambda a, b: bool(np.array_equal(np.asarray(a), b)),
                self.eng._params, params_np)
            self.same = all(_jax.tree_util.tree_leaves(same))

        def same_weights(self):
            return self.same

        def submit(self, rid, prompt):
            self.eng.submit(rid, prompt)

        def collect(self):
            return self.eng.collect()

        def stop(self):
            self.eng.shutdown()

    @ray_tpu_torch.remote
    class PortReplica:
        def __init__(self, params_np):
            import torch

            from ray_tpu_torch.models.convert import params_from_numpy
            from ray_tpu_torch.serve.paged_engine import PagedLLMEngine

            torch.set_num_threads(1)
            self.eng = PagedLLMEngine(
                page_size=8, params=params_from_numpy(params_np, "cpu"),
                device="cpu", **TINY)

        def submit(self, rid, prompt):
            self.eng.submit(rid, prompt)

        def collect(self):
            return self.eng.collect()

        def stop(self):
            self.eng.shutdown()

    ray_tpu.init(num_workers=1, object_store_memory=64 << 20)
    try:
        ref = RefReplica.remote(ray_tpu.put(params))
        port = PortReplica.remote(ray_tpu_torch.put(params))
        assert ray_tpu.get(ref.same_weights.remote(), timeout=180)
        want = _drain(lambda r, p: ray_tpu.get(ref.submit.remote(r, p)),
                      lambda: ray_tpu.get(ref.collect.remote()), reqs)
        got = _drain(
            lambda r, p: ray_tpu_torch.get(port.submit.remote(r, p)),
            lambda: ray_tpu_torch.get(port.collect.remote()), reqs)
        ray_tpu.get(ref.stop.remote())
        ray_tpu_torch.get(port.stop.remote())
        ray_tpu_torch.kill(port)
    finally:
        ray_tpu.shutdown()
    assert len(want) == 4 and all(len(t) == 8 for t in want.values())
    assert got == want
