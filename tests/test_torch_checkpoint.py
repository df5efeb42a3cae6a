"""The port's sharded checkpoints and predictor against ``ray_tpu``'s.

``ray_tpu_torch.train.dist_checkpoint`` (on ``torch.distributed.checkpoint``)
against ``ray_tpu.train.orbax_checkpoint``: 4 gloo ranks save a tree
whose leaves are sharded under {fsdp 4} (placed by
``parallel.sharding``), replicated, and not tensors; each rank writes
only its own shards; 4 ranks restore it under {fsdp 2, tp 2}, 2 ranks
under {fsdp 2}, and this process without a mesh, the values equal to the
saved tree and to the reference's orbax round trip of the same numpy tree
(``tests/test_train.py``'s reshard case). ``TorchPredictor`` against
``JaxPredictor`` on one ``params.pkl`` and the tiny Llama's forward of
each package, at 2e-5.
"""

import os
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ray_tpu_torch.train import dist_checkpoint as dc  # noqa: E402
from ray_tpu_torch.train.predictor import (Predictor,  # noqa: E402
                                           TorchPredictor)

torch.set_num_threads(1)


def _tree():
    """The saved tree, as numpy: a leaf split over fsdp on dim 0, one on
    dim 1 (tp on the restore side), a replicated one, a list and a step
    that is not a tensor."""
    rng = np.random.default_rng(5)
    return {"w": np.arange(64, dtype=np.float32).reshape(8, 8),
            "nested": {"m": rng.standard_normal((4, 8)).astype(np.float32),
                       "b": rng.standard_normal(6).astype(np.float32)},
            "h": rng.standard_normal((8, 4)).astype(np.float32),
            "seq": [np.int64(3), rng.standard_normal(3).astype(np.float32)],
            "step": 7}


# the placements of each sharded leaf, by mesh axis -> tensor dim
SPLITS = {"w": {"fsdp": 0}, "nested.m": {"tp": 1, "fsdp": 1},
          "h": {"fsdp": 0}}


def _placed(tree, mesh):
    """``tree`` as the port holds it under ``mesh``: the ``SPLITS``
    leaves as DTensors placed by a ``parallel.sharding.Sharding`` (a
    dim split over an axis the mesh has), the other arrays as plain
    tensors every rank holds alike."""
    from torch.distributed.tensor import Replicate, Shard

    from ray_tpu_torch.parallel import Sharding, device_put_sharded

    def conv(v, path):
        if isinstance(v, dict):
            return {k: conv(x, f"{path}{k}.") for k, x in v.items()}
        if isinstance(v, list):
            return [conv(x, f"{path}{i}.") for i, x in enumerate(v)]
        if not isinstance(v, np.ndarray):
            return v
        t = torch.from_numpy(v.copy())
        split = SPLITS.get(path[:-1])
        if mesh is None or split is None:
            return t
        names = mesh.mesh_dim_names
        pl = tuple(Shard(split[a]) if a in split else Replicate()
                   for a in names)
        return device_put_sharded(t, Sharding(mesh, pl))
    return conv(tree, "")


def _zeros_like(tree):
    def z(v):
        if isinstance(v, dict):
            return {k: z(x) for k, x in v.items()}
        if isinstance(v, list):
            return [z(x) for x in v]
        return torch.zeros_like(v) if isinstance(v, torch.Tensor) else None
    return z(tree)


def _whole(tree):
    """Every tensor leaf as numpy (DTensors gathered: collective)."""
    def w(v):
        if isinstance(v, dict):
            return {k: w(x) for k, x in v.items()}
        if isinstance(v, list):
            return [w(x) for x in v]
        if hasattr(v, "full_tensor"):
            return v.full_tensor().numpy()
        return v.numpy() if isinstance(v, torch.Tensor) else v
    return w(tree)


def _kinds(dtensor) -> tuple:
    return tuple(p.dim if p.is_shard() else "R" for p in dtensor.placements)


def _save_ranks(rank, world, tree, path):
    """4 ranks: save under {fsdp 4}; record each leaf's chunks and the
    rank files; restore under {fsdp 2, tp 2} and whole; the ``force``
    rules."""
    import torch.distributed as dist
    import torch.distributed.checkpoint as dcp

    from ray_tpu_torch.parallel import MeshSpec, build_mesh

    state = _placed(tree, build_mesh(MeshSpec({"fsdp": world})))
    dc.save(path, state)
    out = {}
    if rank == 0:
        md = dcp.FileSystemReader(path).read_metadata()
        out["chunks"] = {k: len(m.chunks) for k, m in
                         md.state_dict_metadata.items() if hasattr(m, "size")}
        # the file that holds each chunk of the split leaf "w"
        out["w_files"] = sorted({
            md.storage_data[i].relative_path
            for i in md.storage_data if i.fqn == "w"})
    mesh22 = build_mesh(MeshSpec({"fsdp": 2, "tp": 2}))
    like = _zeros_like(_placed(tree, mesh22))
    got = dc.restore(path, like=like)
    out["placements"] = {k: _kinds(got[k]) for k in ("w", "h")}
    out["nested.m"] = _kinds(got["nested"]["m"])
    out["local_w"] = got["w"].to_local().numpy()
    out["resharded"] = _whole(got)
    out["whole"] = _whole(dc.restore(path))
    try:
        dc.save(path, state, force=False)
    except FileExistsError as e:
        out["exists"] = str(e)
    dist.barrier()
    return out


def _restore_ranks(rank, world, tree, path):
    """2 ranks restore the 4 ranks' checkpoint under {fsdp 2}."""
    from ray_tpu_torch.parallel import MeshSpec, build_mesh

    mesh = build_mesh(MeshSpec({"fsdp": world}))
    got = dc.restore(path, like=_zeros_like(_placed(tree, mesh)))
    return {"local_w": got["w"].to_local().numpy(), "values": _whole(got)}


def _assert_tree_equal(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _assert_tree_equal(got[k], want[k])
    elif isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_tree_equal(g, w)
    elif isinstance(want, np.ndarray) or np.isscalar(want) \
            and not isinstance(want, (int, str)):
        np.testing.assert_array_equal(np.asarray(got), want)
    else:
        assert got == want and type(got) is type(want)


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """The 4-rank save (and its restores), then the 2-rank restore."""
    from tests._torch_ranks import run_ranks

    d = tmp_path_factory.mktemp("ckpt")
    path = str(d / "ck")
    four = run_ranks(_save_ranks, 4, _tree(), path, store_dir=str(d),
                     timeout_s=120)
    two = run_ranks(_restore_ranks, 2, _tree(), path, store_dir=str(d),
                    timeout_s=120)
    return path, four, two


def test_each_rank_writes_only_its_shards(saved):
    _, four, _ = saved
    r0 = four[0]
    # the split leaves: one chunk per rank, each in that rank's file
    assert r0["chunks"]["w"] == r0["chunks"]["h"] == 4
    assert r0["chunks"]["nested.m"] == 4
    assert r0["w_files"] == [f"__{r}_0.distcp" for r in range(4)]
    # the replicated leaves: written once
    assert r0["chunks"]["nested.b"] == 1 and r0["chunks"]["seq.1"] == 1


def test_restore_reshards_onto_another_mesh(saved):
    """{fsdp 4} -> {fsdp 2, tp 2} on 4 ranks: every rank's local block is
    its block of the saved value under the new placements."""
    _, four, _ = saved
    want = _tree()
    for rank, r in enumerate(four):
        assert r["placements"] == {"w": (0, "R"), "h": (0, "R")}
        assert r["nested.m"] == (1, 1)
        np.testing.assert_array_equal(
            r["local_w"], want["w"][4 * (rank // 2):4 * (rank // 2) + 4])
        _assert_tree_equal(r["resharded"], want)
        _assert_tree_equal(r["whole"], want)
        assert "exists" in r["exists"]


def test_restore_on_fewer_processes(saved):
    """4 processes saved, 2 restore under {fsdp 2}."""
    _, _, two = saved
    want = _tree()
    for rank, r in enumerate(two):
        np.testing.assert_array_equal(r["local_w"],
                                      want["w"][4 * rank:4 * rank + 4])
        _assert_tree_equal(r["values"], want)


def test_restore_without_a_mesh_matches_orbax(saved, tmp_path):
    """This process alone (no process group) reads the 4 ranks'
    checkpoint whole, and into plain tensors; both equal the
    reference's orbax round trip of the same numpy tree."""
    import jax.numpy as jnp

    from ray_tpu.train import orbax_checkpoint as oc

    path, _, _ = saved
    want = _tree()
    ref_tree = dict(want, w=jnp.asarray(want["w"]), h=jnp.asarray(want["h"]))
    ref = oc.restore(oc.save(str(tmp_path / "orbax"), ref_tree))
    whole = dc.restore(path)
    _assert_tree_equal(whole, want)
    got = dc.restore(path, like=_zeros_like(_placed(want, None)))
    _assert_tree_equal(_whole(got), want)
    for k in ("w", "h"):
        np.testing.assert_array_equal(whole[k].numpy(), np.asarray(ref[k]))
    np.testing.assert_array_equal(whole["nested"]["m"].numpy(),
                                  np.asarray(ref["nested"]["m"]))
    assert whole["step"] == int(ref["step"]) == 7


def test_force_and_leaves_that_are_not_tensors(tmp_path):
    """``force=True`` replaces a checkpoint whole (no file of the old one
    survives); ``force=False`` refuses an existing path; ints, strings
    and None round-trip; a subtree restores alone."""
    path = str(tmp_path / "ck")
    dc.save(path, {"a": torch.ones(3), "old": torch.zeros(2), "step": 1})
    with pytest.raises(FileExistsError):
        dc.save(path, {"a": torch.ones(3)}, force=False)
    new = {"a": torch.arange(3.0), "step": 7, "tag": "run-1", "none": None,
           "bf16": torch.full((2,), 1.5, dtype=torch.bfloat16)}
    assert dc.save(path, new) == os.path.abspath(path)
    back = dc.restore(path)
    assert set(back) == {"a", "step", "tag", "none", "bf16"}
    assert back["step"] == 7 and back["tag"] == "run-1"
    assert back["none"] is None
    assert back["bf16"].dtype == torch.bfloat16
    assert torch.equal(back["a"], new["a"])
    like = {"a": torch.empty(3)}
    assert dc.restore(path, like=like) is like
    assert torch.equal(like["a"], new["a"])


# --------------------------------------------------------------- predictor


def _tiny():
    import jax

    from ray_tpu.models import llama as jl
    from ray_tpu_torch.models import llama

    jcfg = jl.LlamaConfig.tiny()
    tree = jax.tree_util.tree_map(
        np.asarray, jl.init_params(jcfg, jax.random.PRNGKey(0)))
    return jcfg, llama.LlamaConfig.tiny(), tree


class _Ckpt:
    """An object with ``.path``, as a Train ``Checkpoint`` is."""

    def __init__(self, path):
        self.path = path


def test_torch_predictor_matches_jax_predictor(tmp_path):
    """One ``params.pkl``, the tiny Llama's forward in each package: the
    predictions agree at 2e-5, ``predict`` keeps the batch's other
    columns and runs under ``torch.inference_mode()``."""
    from ray_tpu.models import llama as jl
    from ray_tpu.train.predictor import JaxPredictor
    from ray_tpu_torch.models import llama

    jcfg, cfg, tree = _tiny()
    with open(tmp_path / "params.pkl", "wb") as f:
        pickle.dump(tree, f)
    modes = []

    def apply(params, tokens):
        modes.append(torch.is_inference_mode_enabled())
        return llama.forward(cfg, params, tokens)

    rng = np.random.default_rng(0)
    batch = {"data": rng.integers(0, jcfg.vocab_size, (2, 12)).astype(
        np.int32), "id": np.arange(2)}
    ref = JaxPredictor.from_checkpoint(
        str(tmp_path), apply_fn=lambda p, x: jl.forward(jcfg, p, x))
    port = TorchPredictor.from_checkpoint(_Ckpt(str(tmp_path)), apply,
                                          device="cpu")
    want = ref.predict(batch)
    got = port.predict(batch)
    assert modes == [True]
    assert got["predictions"].shape == (2, 12, jcfg.vocab_size)
    np.testing.assert_allclose(got["predictions"], want["predictions"],
                               atol=2e-5, rtol=2e-5)
    np.testing.assert_array_equal(got["id"], batch["id"])
    assert got["data"] is batch["data"]


def test_predictor_loads_params_through_restore(tmp_path):
    """``load_params=restore`` over a ``dist_checkpoint`` of the params:
    the predictions equal those from ``params.pkl``; the output column
    is renamed; the base class is abstract as the reference's."""
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.models.convert import params_from_numpy

    _, cfg, tree = _tiny()
    with open(tmp_path / "params.pkl", "wb") as f:
        pickle.dump(tree, f)
    ck = dc.save(str(tmp_path / "dcp"), params_from_numpy(tree, "cpu"))
    batch = {"tokens": np.array([[1, 2, 3, 4, 5]], np.int64)}

    def apply(p, x):
        return llama.forward(cfg, p, x).argmax(-1)

    kw = dict(input_column="tokens", output_column="next", device="cpu")
    a = TorchPredictor.from_checkpoint(str(tmp_path), apply, **kw)
    b = TorchPredictor.from_checkpoint(ck, apply, load_params=dc.restore,
                                       **kw)
    np.testing.assert_array_equal(a.predict(batch)["next"],
                                  b.predict(batch)["next"])
    with pytest.raises(NotImplementedError):
        Predictor.from_checkpoint(ck)
    with pytest.raises(NotImplementedError):
        Predictor().predict(batch)
