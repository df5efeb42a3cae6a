"""The port's parallelism layer (``ray_tpu_torch.parallel``) against
``ray_tpu.parallel`` on the CPU.

The port runs on 8 spawned gloo ranks (``tests/_torch_ranks.run_ranks``,
one launch for the whole file, with its own timeout); the reference on
its 8 virtual CPU devices (``tests/conftest.py``). Rank ``i`` stands
where the reference puts device ``i``:

- mesh layouts (``build_mesh``, ``local_mesh``, ``build_hybrid_mesh``'s
  pseudo-slices) equal the reference's device ids;
- logical-axis rules give the reference's ``PartitionSpec``s;
- every collective gives the reference's outputs, and its gradient the
  reference's: each rank differentiates ``sum(out * c_r)`` with its own
  weights ``c_r``, and the reference differentiates the sum of those
  per-rank losses through ``shard_map`` (1e-6).

jax is imported inside the tests: the spawned ranks import this module.
"""

import numpy as np
import pytest

from ray_tpu_torch.parallel.mesh import MeshSpec

# (name, mesh axes, op, x's global shape): x is split over the axis on
# dim 0; the op's keyword arguments follow
OPS = [
    ("psum", {"tp": 8}, "psum", (16, 3), {}),
    ("psum_tuple", {"dp": 2, "fsdp": 2, "tp": 2}, "psum", (16, 3),
     {"axis": ("dp", "fsdp")}),
    ("all_gather", {"dp": 8}, "all_gather", (16, 3), {"gather_axis": 0}),
    ("all_gather_dim1", {"dp": 8}, "all_gather", (16, 3),
     {"gather_axis": 1}),
    ("all_gather_untiled", {"dp": 8}, "all_gather", (16, 3),
     {"gather_axis": 0, "tiled": False}),
    ("all_gather_tuple", {"dp": 2, "fsdp": 4}, "all_gather", (16, 3),
     {"axis": ("dp", "fsdp"), "gather_axis": 0}),
    ("reduce_scatter", {"fsdp": 8}, "reduce_scatter", (128, 4),
     {"scatter_axis": 0}),
    ("reduce_scatter_tuple", {"dp": 2, "fsdp": 4}, "reduce_scatter",
     (128, 4), {"axis": ("dp", "fsdp"), "scatter_axis": 0}),
    ("all_to_all", {"sp": 8}, "all_to_all", (8, 8, 2),
     {"split_axis": 1, "concat_axis": 0}),
    ("all_to_all_heads", {"sp": 8}, "all_to_all", (16, 16, 8, 2),
     {"split_axis": 2, "concat_axis": 1}),
    ("ring_permute", {"sp": 8}, "ring_permute", (8, 2), {"shift": 1}),
    ("ring_permute_3", {"sp": 8}, "ring_permute", (8, 2), {"shift": 3}),
    ("pbroadcast", {"tp": 8}, "pbroadcast", (8, 2), {"src": 3}),
    ("pmean", {"tp": 8}, "pmean", (16, 3), {}),
]
NO_GRAD = ("pmax", "pmin")

MESHES = {"fsdp2_tp4": {"fsdp": 2, "tp": 4},
          "dp2_fsdp2_tp2": {"tp": 2, "dp": 2, "fsdp": 2},
          "pp2_sp2_dp2": {"pp": 2, "sp": 2, "dp": 2},
          "dp8": {"dp": 8}}
HYBRID = {"two_slice": ({"fsdp": 4}, {"dp": 2}),
          "dcn_inner": ({"dp": 4}, {"fsdp": 2}),
          "fsdp_tp": ({"fsdp": 2, "tp": 2}, {"dp": 2}),
          "shared_axis": ({"fsdp": 2}, {"fsdp": 2, "dp": 2})}
LOGICAL = {"bse": ("batch", "seq", "embed"), "em": ("embed", "mlp"),
           "bsm": ("batch", "seq", "mlp"),
           "vocab": ("vocab", "embed"), "expert": ("expert", "embed", "mlp")}


def _inputs():
    rng = np.random.default_rng(0)
    x = {name: rng.standard_normal(shape).astype(np.float32)
         for name, _, _, shape, _ in OPS}
    x["pmax"] = x["pmin"] = x["psum"]
    return x, rng


def _axis(name, axes, kw):
    return kw.get("axis", next(iter(axes)) if len(axes) == 1 else None)


def _collectives_ranks(rank, world, xs, cs, matmul):
    """The rank body: every layout, placement and collective case."""
    import torch

    from ray_tpu_torch.parallel import (build_hybrid_mesh, build_mesh,
                                        device_put_sharded, local_mesh,
                                        named_sharding)
    from ray_tpu_torch.parallel import device_collectives as dc
    from ray_tpu_torch.parallel.sharding import (logical_to_placements,
                                                 placements_to_spec)

    out = {}

    def layout(m):
        return tuple(m.mesh_dim_names), m.mesh.tolist()

    for key, axes in MESHES.items():
        out[f"mesh/{key}"] = layout(build_mesh(MeshSpec(axes)))
    try:
        build_mesh(MeshSpec({"tp": 3}))
    except ValueError as e:
        out["wrong_count"] = str(e)
    out["local"] = layout(local_mesh())
    out["local_tp4"] = layout(local_mesh(tp=4))
    for key, (ici, dcn) in HYBRID.items():
        out[f"hybrid/{key}"] = layout(build_hybrid_mesh(ici, dcn))

    m = build_mesh(MeshSpec({"fsdp": 2, "ep": 2, "tp": 2}))
    for key, logical in LOGICAL.items():
        try:
            out[f"spec/{key}"] = placements_to_spec(
                logical_to_placements(logical, m), m, len(logical))
        except ValueError as e:
            out[f"spec/{key}"] = str(e)
    x = device_put_sharded(torch.arange(8 * 16.).reshape(8, 16),
                           named_sharding(m, "batch", "mlp"))
    out["device_put"] = (placements_to_spec(x.placements, m, 2),
                         x.to_local().numpy())

    # megatron row-parallel matmul: contract over the tp-split dim, psum
    tp8 = build_mesh(MeshSpec({"tp": 8}))
    a, w = (torch.from_numpy(t) for t in matmul)
    blk = 16 // 8
    out["matmul"] = dc.psum(a[:, rank * blk:(rank + 1) * blk]
                            @ w[rank * blk:(rank + 1) * blk], "tp",
                            mesh=tp8).numpy()

    meshes = {}
    for name, axes, op, _, kw in OPS + [(n, {"tp": 8}, n, None, {})
                                        for n in NO_GRAD]:
        key = tuple(sorted(axes.items()))
        mesh = meshes.get(key) or meshes.setdefault(
            key, build_mesh(MeshSpec(axes)))
        kw = dict(kw)
        axis = kw.pop("axis", _axis(name, axes, kw))
        n = dc.axis_size(axis, mesh=mesh)
        i = dc.axis_index(axis, mesh=mesh)
        xg = torch.from_numpy(xs[name])
        xl = xg.chunk(n, 0)[i].clone().requires_grad_(name not in NO_GRAD)
        y = getattr(dc, op)(xl, axis, mesh=mesh, **kw)
        rec = {"y": y.detach().numpy(), "n": n, "i": i}
        if name not in NO_GRAD:
            (y * torch.from_numpy(cs[name][rank])).sum().backward()
            rec["grad"] = xl.grad.numpy()
        out[f"op/{name}"] = rec
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    from concurrent.futures import ThreadPoolExecutor

    from tests._torch_ranks import run_ranks

    xs, rng = _inputs()
    # each rank's loss weights have the shape of its output
    shapes = {}
    for name, axes, op, shape, kw in OPS:
        n = int(np.prod([axes[a] for a in np.atleast_1d(
            kw.get("axis", list(axes)[0]))]))
        local = (shape[0] // n,) + tuple(shape[1:])
        if op == "all_gather":
            d = kw["gather_axis"]
            local = list(local)
            if kw.get("tiled", True):
                local[d] *= n
            else:
                local.insert(d, n)
        elif op == "reduce_scatter":
            local = (local[0] // n,) + local[1:]
        elif op == "all_to_all":
            local = list(local)
            local[kw["split_axis"]] //= n
            local[kw["concat_axis"]] *= n
        shapes[name] = tuple(local)
    cs = {name: rng.standard_normal((8,) + shapes[name]).astype(np.float32)
          for name in shapes}
    matmul = (np.ones((4, 16), np.float32),
              rng.standard_normal((16, 32)).astype(np.float32))
    # the reference runs in threads while the ranks run
    with ThreadPoolExecutor(4) as pool:
        ranks = pool.submit(run_ranks, _collectives_ranks, 8, xs, cs, matmul,
                            store_dir=str(tmp_path_factory.mktemp("gloo")),
                            timeout_s=240)
        refs = {case[0]: pool.submit(_reference_op, case, xs, cs)
                for case in OPS}
        refs = {k: f.result() for k, f in refs.items()}
        res = ranks.result()
    return {"res": res, "xs": xs, "cs": cs, "matmul": matmul, "refs": refs}


def _jax_mesh(axes):
    from ray_tpu.parallel import MeshSpec as JMeshSpec
    from ray_tpu.parallel import build_mesh as jbuild

    return jbuild(JMeshSpec(axes))


def _ids(mesh):
    return np.vectorize(lambda d: d.id)(mesh.devices).tolist()


# ------------------------------------------------------------ mesh specs


def test_mesh_spec_matches_reference():
    from ray_tpu.parallel import MeshSpec as JMeshSpec

    for axes in ({"tp": 2, "dp": 2, "fsdp": 2}, {"ep": 2, "sp": 4},
                 {"pp": 2, "tp": 4}):
        spec, ref = MeshSpec(axes), JMeshSpec(axes)
        assert (spec.axis_names, spec.shape, spec.size, spec.ordered) == \
            (ref.axis_names, ref.shape, ref.size, ref.ordered)
        assert spec.with_axis("dp", 3).axes == ref.with_axis("dp", 3).axes
    assert MeshSpec({"tp": 2, "dp": 2, "fsdp": 2}).axis_names == \
        ("dp", "fsdp", "tp")


def test_mesh_spec_validation():
    with pytest.raises(ValueError):
        MeshSpec({"bogus": 2})
    with pytest.raises(ValueError):
        MeshSpec({"dp": 0})


@pytest.mark.parametrize("kw", [{"tp": 4}, {"tp": 2, "sp": 2},
                                {"pp": 2, "ep": 2}, {"tp": 8}])
def test_from_devices_matches_reference(kw):
    from ray_tpu.parallel import MeshSpec as JMeshSpec

    assert MeshSpec.from_devices(8, **kw).axes == \
        JMeshSpec.from_devices(8, **kw).axes
    with pytest.raises(ValueError):
        MeshSpec.from_devices(8, tp=3)
    assert MeshSpec.data_parallel(8).axes == {"fsdp": 8}
    assert MeshSpec.data_parallel(8, sharded=False).axes == {"dp": 8}


# -------------------------------------------------------------- layouts


@pytest.mark.parametrize("key", sorted(MESHES))
def test_build_mesh_layout_matches_reference(ranks, key):
    ref = _jax_mesh(MESHES[key])
    for out in ranks["res"]:
        names, layout = out[f"mesh/{key}"]
        assert names == tuple(ref.axis_names)
        assert layout == _ids(ref)


def test_build_mesh_wrong_count(ranks):
    assert "needs 3 devices, got 8" in ranks["res"][0]["wrong_count"]


def test_local_mesh_matches_reference(ranks):
    from ray_tpu.parallel import local_mesh as jlocal

    for key, ref in (("local", jlocal()), ("local_tp4", jlocal(tp=4))):
        names, layout = ranks["res"][0][key]
        assert names == tuple(ref.axis_names) and layout == _ids(ref)


@pytest.mark.parametrize("key", sorted(HYBRID))
def test_hybrid_mesh_layout_matches_reference(ranks, key):
    import jax

    from ray_tpu.parallel import build_hybrid_mesh as jhybrid

    ici, dcn = HYBRID[key]
    ref = jhybrid(ici, dcn, devices=jax.devices())
    for out in ranks["res"]:
        names, layout = out[f"hybrid/{key}"]
        assert names == tuple(ref.axis_names)
        assert layout == _ids(ref)


# ------------------------------------------------------------- shardings


def _norm(entry):
    return None if entry is None else (
        (entry,) if isinstance(entry, str) else tuple(entry))


@pytest.mark.parametrize("key", sorted(LOGICAL))
def test_logical_placements_match_pspec(ranks, key):
    from ray_tpu.parallel import logical_to_pspec

    ref = logical_to_pspec(LOGICAL[key],
                           _jax_mesh({"fsdp": 2, "ep": 2, "tp": 2}))
    got = ranks["res"][0][f"spec/{key}"]
    want = tuple(_norm(e) for e in ref)
    named = [a for e in want if e for a in e]
    if len(named) > len(set(named)):
        # one mesh axis on two dims: a spec, but no placement of a tensor
        assert "would shard dims" in got
    else:
        assert got == want


def test_named_sharding_device_put(ranks):
    from jax.sharding import PartitionSpec as P

    from ray_tpu.parallel import named_sharding as jnamed

    m = _jax_mesh({"fsdp": 2, "ep": 2, "tp": 2})
    ref = jnamed(m, "batch", "mlp").spec
    assert ref == P(("fsdp",), "tp")
    full = np.arange(8 * 16.).reshape(8, 16)
    for r, out in enumerate(ranks["res"]):
        spec, local = out["device_put"]
        assert spec == tuple(_norm(e) for e in ref)
        fsdp, tp = r // 4, r % 2
        np.testing.assert_array_equal(
            local, full[fsdp * 4:(fsdp + 1) * 4, tp * 8:(tp + 1) * 8])


# ----------------------------------------------------------- collectives


def test_sharded_matmul_psum(ranks):
    a, w = ranks["matmul"]
    for out in ranks["res"]:
        np.testing.assert_allclose(out["matmul"], a @ w, rtol=1e-5)


def _axis_order(name, axes, kw):
    """The ranks holding axis index 0, 1, ...: ranks of one index hold
    equal values (the first one stands for them)."""
    n = int(np.prod([axes[a] for a in np.atleast_1d(
        kw.get("axis", list(axes)[0]))]))
    if n == 8:
        return list(range(8))
    return [r for r in range(8) if r % 2 == 0][:n]


def _reference_op(case, xs, cs):
    """(per-rank outputs concatenated on dim 0, the gradient of the sum
    of every rank's sum(out * c_r)) through the reference's collectives
    under shard_map on the same mesh."""
    name, axes, op, _, kw = case
    x, c = xs[name], cs[name][_axis_order(name, axes, kw)]
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from ray_tpu.parallel import device_collectives as jdc

    mesh = _jax_mesh(axes)
    kw = dict(kw)
    axis = kw.pop("axis", _axis(name, axes, kw))
    spec = P(axis)

    def body(xl, cl):
        if op == "pmean":
            y = jdc.pmean(xl, axis)
        else:
            y = getattr(jdc, op)(xl, axis, **kw)
        return y, jnp.sum(y * cl[0])[None]

    f = shard_map(body, mesh=mesh, in_specs=(spec, spec),
                  out_specs=(spec, spec))
    y, _ = jax.jit(f)(x, c)
    g = jax.jit(jax.grad(lambda xx: f(xx, c)[1].sum()))(x)
    return np.asarray(y), np.asarray(g)


@pytest.mark.parametrize("case", OPS, ids=[c[0] for c in OPS])
def test_collective_and_gradient_match_reference(ranks, case):
    name, axes, op, _, kw = case
    res = [out[f"op/{name}"] for out in ranks["res"]]
    order = _axis_order(name, axes, kw)
    assert [res[r]["i"] for r in order] == list(range(len(order)))
    want_y, want_g = ranks["refs"][name]
    got_y = np.concatenate([res[r]["y"] for r in order])
    np.testing.assert_allclose(got_y, want_y, rtol=1e-6, atol=1e-6)
    if len(order) == 8:
        got_g = np.concatenate([res[r]["grad"] for r in order])
        np.testing.assert_allclose(got_g, want_g, rtol=1e-6, atol=1e-6)
    # else: a tuple axis of a larger mesh, where ranks sharing an index
    # carry their own loss weights: the next test checks those gradients


def test_tuple_axis_gradients_sum_over_sharing_ranks(ranks):
    """On {dp 2, fsdp 2, tp 2}, psum over (dp, fsdp): each rank's
    gradient is the sum of the loss weights of the ranks of its psum
    group (the transpose of psum is psum)."""
    res = [out["op/psum_tuple"] for out in ranks["res"]]
    c = ranks["cs"]["psum_tuple"]
    for r, rec in enumerate(res):
        group = [q for q in range(8) if q % 2 == r % 2]   # same tp index
        np.testing.assert_allclose(rec["grad"], c[group].sum(0),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("op", NO_GRAD)
def test_pmax_pmin(ranks, op):
    x = ranks["xs"][op]
    want = getattr(np, {"pmax": "max", "pmin": "min"}[op])(
        x.reshape(8, 2, 3), axis=0)
    for out in ranks["res"]:
        np.testing.assert_array_equal(out[f"op/{op}"]["y"], want)


def test_ring_permute_rotates(ranks):
    x = ranks["xs"]["ring_permute"]
    got = np.stack([out["op/ring_permute"]["y"] for out in ranks["res"]])
    np.testing.assert_array_equal(got, np.roll(x.reshape(8, 1, 2), 1, 0))


def test_pbroadcast(ranks):
    x = ranks["xs"]["pbroadcast"]
    for out in ranks["res"]:
        np.testing.assert_array_equal(out["op/pbroadcast"]["y"], x[3:4])
