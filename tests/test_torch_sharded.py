"""The models' mesh surface in the port against ``ray_tpu`` on the CPU:
the dry-run configurations of ``__graft_entry__.dryrun_multichip``
(``MULTICHIP_r05.json``), each loss and every gathered gradient leaf.

The port runs on 8 spawned gloo ranks (one launch for the file, with
its own timeout), its params DTensors placed by ``param_shardings``; the
oracle is the ``ray_tpu`` function under the same mesh on the JAX
package's 8 virtual CPU devices, on the same weights (converted through
numpy) and tokens. Losses at 1e-5 relative, gathered gradients
(``full_tensor()``) at 1e-4 of each leaf's largest value:

- Llama tiny with ring attention on {tp 2, sp 2, fsdp 2} (and under
  remat, and its global logits from ``forward(mesh=)``);
- Llama tiny with q/k/v biases, tied embeddings and a loss mask on
  {dp 2, fsdp 2, tp 2} (the vocabulary split over tp for the tied head);
- Llama tiny (2 KV heads) on {dp 2, tp 4}, without and with q/k/v
  biases (and its global logits): tp does not divide the KV heads;
- Mixtral tiny on {dp 2, ep 4}, and with a capacity low enough that
  tokens overflow: the same (token, choice) pairs drop, ``moe_layer``'s
  outputs and aux loss match, and on {dp 2, sp 2, ep 2} with ring
  attention, where the slots count across sequence blocks;
- ``loss_fn_pp`` at pp 4 x dp 2, and pp 2 x sp 2 x dp 2 with ring and
  with Ulysses (also against the sequential loss);
- two slices, dp(DCN) 2 x fsdp(ICI) 4, against flat fsdp 8;
- fsdp 8's gradients against the port's own unsharded gradients: the
  check that fails when a rank backpropagates a partial loss through
  un-summed shards;
- ``param_shardings`` of Llama, GPT-2 and Mixtral and the two caches'
  shardings, axis by axis against the reference's ``PartitionSpec``s.

jax is imported inside the tests: the spawned ranks import this module.
"""

import numpy as np
import pytest

TINY_SEQ = dict(num_layers=4, remat=False)

# name -> (model, config overrides, mesh axes | ("hybrid", ici, dcn),
#          tokens shape, num_microbatches (0: loss_fn), with a mask,
#          (params seed, tokens seed) of jax.random: the dry run's own
#          seeds where it runs the configuration)
SCENARIOS = {
    "ring_tp_sp_fsdp": ("llama", {"attn_impl": "ring"},
                        {"tp": 2, "sp": 2, "fsdp": 2}, (4, 17), 0, False,
                        (0, 1)),
    "ring_remat": ("llama", {"attn_impl": "ring", "remat": True},
                   {"tp": 2, "sp": 2, "fsdp": 2}, (4, 17), 0, False,
                   (10, 11)),
    "bias_tied_mask": ("llama", {"attn_qkv_bias": True,
                                 "tie_embeddings": True},
                       {"dp": 2, "fsdp": 2, "tp": 2}, (8, 17), 0, True,
                       (12, 13)),
    "moe_dp_ep": ("mixtral", {}, {"dp": 2, "ep": 4}, (4, 17), 0, False,
                  (2, 3)),
    "moe_drop": ("mixtral", {"capacity_factor": 0.25}, {"dp": 2, "ep": 4},
                 (4, 33), 0, False, (14, 15)),
    "moe_sp_ring": ("mixtral", {"capacity_factor": 0.25,
                                "attn_impl": "ring"},
                    {"dp": 2, "sp": 2, "ep": 2}, (4, 33), 0, False,
                    (16, 17)),
    "pp4": ("llama", TINY_SEQ, {"pp": 4, "dp": 2}, (8, 17), 4, False,
            (5, 6)),
    "pp_ring": ("llama", dict(TINY_SEQ, attn_impl="ring"),
                {"pp": 2, "sp": 2, "dp": 2}, (8, 33), 4, False, (7, 8)),
    "pp_ulysses": ("llama", dict(TINY_SEQ, attn_impl="ulysses"),
                   {"pp": 2, "sp": 2, "dp": 2}, (8, 33), 4, False, (7, 8)),
    # tp 4 over the tiny preset's 2 KV heads: each rank gathers q/k/v
    # from its column shards (heads_gathered), as GSPMD does
    "gqa_tp4": ("llama", {}, {"dp": 2, "tp": 4}, (4, 17), 0, False,
                (20, 21)),
    "gqa_tp4_bias": ("llama", {"attn_qkv_bias": True}, {"dp": 2, "tp": 4},
                     (4, 17), 0, True, (22, 23)),
    "two_slice": ("llama", {}, ("hybrid", {"fsdp": 4}, {"dp": 2}), (8, 33),
                  0, False, (0, 3)),
    "flat_fsdp8": ("llama", {}, {"fsdp": 8}, (8, 33), 0, False, (0, 3)),
}
# the dry run's printed losses (MULTICHIP_r05.json "tail"), by the line
# that prints them
RECORDED = {"ring_tp_sp_fsdp": "dryrun_multichip ok",
            "moe_dp_ep": "dryrun_multichip moe ok",
            "pp4": "dryrun pipeline-parallel ok",
            "pp_ring": "dryrun pp x ring-attention ok",
            "pp_ulysses": "dryrun pp x ulysses ok",
            "two_slice": "dryrun two-slice ok"}
LOGITS = ("ring_tp_sp_fsdp", "gqa_tp4")
DROP = "moe_drop"

# param_shardings / cache shardings cases: name -> (model, overrides, axes)
SHARDINGS = {
    "llama_dp_fsdp_tp": ("llama", {"attn_qkv_bias": True},
                         {"dp": 2, "fsdp": 2, "tp": 2}),
    "llama_tied_fsdp_sp_tp": ("llama", {"tie_embeddings": True},
                              {"fsdp": 2, "sp": 2, "tp": 2}),
    "gpt2_fsdp_tp": ("gpt2", {}, {"fsdp": 4, "tp": 2}),
    "mixtral_fsdp_ep_tp": ("mixtral", {}, {"fsdp": 2, "ep": 2, "tp": 2}),
    "mixtral_dp_ep": ("mixtral", {}, {"dp": 2, "ep": 4}),
}
CACHE_MESHES = {"fsdp4_tp2": {"fsdp": 4, "tp": 2},
                "dp2_tp4": {"dp": 2, "tp": 4}}


def _mesh(axes):
    from ray_tpu_torch.parallel import MeshSpec, build_hybrid_mesh, build_mesh

    if isinstance(axes, tuple):
        return build_hybrid_mesh(axes[1], axes[2])
    return build_mesh(MeshSpec(axes))


def _config(mod, model, kw):
    cls = {"llama": "LlamaConfig", "mixtral": "MixtralConfig",
           "gpt2": "GPT2Config"}[model]
    return getattr(mod, cls).tiny(**kw)


def _grads(params):
    from ray_tpu_torch.models.llama import param_leaves

    return {n: p.grad.full_tensor().numpy() for n, p in param_leaves(params)}


def _run(name, tree, batch, extra):
    import torch

    from ray_tpu_torch.models import llama, mixtral
    from ray_tpu_torch.models.convert import params_from_numpy
    from ray_tpu_torch.parallel import device_put_sharded

    model, kw, axes, _, M, *_ = SCENARIOS[name]
    mod = {"llama": llama, "mixtral": mixtral}[model]
    cfg = _config(mod, model, kw)
    mesh = _mesh(axes)
    params = device_put_sharded(params_from_numpy(tree, device="cpu"),
                                mod.param_shardings(cfg, mesh))
    for _, p in llama.param_leaves(params):
        p.requires_grad_()
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    if M:
        loss = llama.loss_fn_pp(cfg, params, batch, mesh, M)
    else:
        loss = mod.loss_fn(cfg, params, batch, mesh=mesh)
    loss.backward()
    rec = {"loss": float(loss), "grads": _grads(params)}
    with torch.no_grad():
        if name in LOGITS:
            rec["logits"] = llama.forward(cfg, params, batch["tokens"][:, :-1],
                                          mesh=mesh).numpy()
        if name == DROP:
            rec["moe"] = _moe_direct(cfg, params, mesh, extra)
    return rec


def _moe_direct(cfg, params, mesh, x_global):
    """Layer 0's ``moe_layer`` and router on global hidden states: the
    global outputs, aux loss and kept (token, choice) mask."""
    import torch

    from ray_tpu_torch.models import mixtral, sharded
    from ray_tpu_torch.parallel import device_collectives as dc

    spmd, _ = mixtral._spmd(cfg, params, mesh)
    p = spmd.weights(sharded.layer_shards(params["layers"], 0))
    x = spmd.data_rows(torch.from_numpy(x_global))
    out, aux = mixtral.moe_layer(cfg, p, x, spmd)
    *_, keep, _ = mixtral.route(cfg, p, x.reshape(-1, x.shape[-1]), spmd,
                                rows=x.shape[0])
    keep = dc.all_gather(keep.view(x.shape[0], -1).int(), spmd.data_axes,
                         mesh=mesh)
    return {"out": sharded.gather_tokens(out, spmd).numpy(),
            "aux": float(aux), "keep": keep.numpy()}


def _shardings():
    from ray_tpu_torch.models import gpt2, llama, llama_decode, llama_paged
    from ray_tpu_torch.models import mixtral
    from ray_tpu_torch.parallel.sharding import placements_to_spec

    mods = {"llama": llama, "gpt2": gpt2, "mixtral": mixtral}
    out = {}

    def specs(tree, shapes):
        if isinstance(tree, dict) and not hasattr(tree, "placements"):
            return {k: specs(v, shapes[k]) for k, v in tree.items()}
        return placements_to_spec(tree.placements, tree.mesh, len(shapes))

    for name, (model, kw, axes) in SHARDINGS.items():
        mod = mods[model]
        cfg = _config(mod, model, kw)
        out[name] = specs(mod.param_shardings(cfg, _mesh(axes)),
                          mod.logical_axes_without_layer(cfg))
    cfg = llama.LlamaConfig.tiny()
    for name, axes in CACHE_MESHES.items():
        mesh = _mesh(axes)
        out[f"cache/{name}"] = {
            k: placements_to_spec(v.placements, mesh, 5)
            for k, v in llama_decode.cache_shardings(cfg, mesh).items()}
        out[f"paged/{name}"] = {
            k: placements_to_spec(v.placements, mesh, 5)
            for k, v in llama_paged.paged_cache_shardings(cfg, mesh).items()}
    return out


def _extras():
    """``with_logical_constraint`` and the errors a mesh raises."""
    import torch

    from ray_tpu_torch.models import llama
    from ray_tpu_torch.parallel import with_logical_constraint

    out = {}
    mesh = _mesh({"dp": 2, "fsdp": 2, "tp": 2})
    x = torch.arange(8 * 4.).reshape(8, 4)
    d = with_logical_constraint(x, ("batch", "mlp"), mesh)
    out["constraint"] = (str(d.placements), d.to_local().numpy())
    r = with_logical_constraint(d, (None, None), mesh)
    out["constraint_replicated"] = r.to_local().numpy()
    cfg = llama.LlamaConfig.tiny(num_layers=4, attn_impl="ring")
    try:
        llama.loss_fn_pp(cfg, {}, {"tokens": torch.zeros(8, 17).long()},
                         _mesh({"pp": 4, "dp": 2}), 4)
    except ValueError as e:
        out["pp_no_sp"] = str(e)
    return out


def _sharded_ranks(rank, world, trees, batches, moe_x):
    out = {name: _run(name, trees[name], batches[name],
                      moe_x if name == DROP else None)
           for name in SCENARIOS}
    out["shardings"] = _shardings()
    out["extras"] = _extras()
    return out


# ----------------------------------------------------------- the oracle


def _jax_setup():
    import jax

    from ray_tpu.models import llama as jl
    from ray_tpu.models import mixtral as jm

    data = {}
    for name, (model, kw, _, shape, _, masked, seeds) in SCENARIOS.items():
        mod = {"llama": jl, "mixtral": jm}[model]
        cfg = _config(mod, model, kw)
        params = mod.init_params(cfg, jax.random.PRNGKey(seeds[0]))
        batch = {"tokens": np.asarray(jax.random.randint(
            jax.random.PRNGKey(seeds[1]), shape, 0, cfg.vocab_size))}
        if masked:
            batch["mask"] = (np.random.default_rng(seeds[1]).random(shape)
                             < 0.7).astype(np.float32)
        data[name] = (cfg, params, batch)
    moe_x = np.random.default_rng(99).standard_normal(
        (4, 32, 64)).astype(np.float32)
    return data, moe_x


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The ranks' results and the reference's losses and gradients; the
    reference compiles in threads while the ranks run."""
    from concurrent.futures import ThreadPoolExecutor

    import jax

    from tests._torch_ranks import run_ranks

    data, moe_x = _jax_setup()
    trees = {n: jax.tree_util.tree_map(np.asarray, d[1])
             for n, d in data.items()}
    batches = {n: d[2] for n, d in data.items()}
    with ThreadPoolExecutor(4) as pool:
        ranks = pool.submit(run_ranks, _sharded_ranks, 8, trees, batches,
                            moe_x, timeout_s=300,
                            store_dir=str(tmp_path_factory.mktemp("gloo")))
        refs = {n: pool.submit(_reference, n, data) for n in SCENARIOS}
        refs = {n: f.result() for n, f in refs.items()}
        res = ranks.result()
    return {"data": data, "trees": trees, "moe_x": moe_x, "res": res,
            "refs": refs}


def _jax_mesh(axes):
    from ray_tpu.parallel import MeshSpec, build_hybrid_mesh, build_mesh

    if isinstance(axes, tuple):
        return build_hybrid_mesh(axes[1], axes[2])
    return build_mesh(MeshSpec(axes))


def _reference(name, data):
    """The reference's (loss, {leaf: grad}) under the same mesh."""
    import jax

    from ray_tpu.models import llama as jl
    from ray_tpu.models import mixtral as jm
    from ray_tpu.parallel.sharding import named_sharding, shard_pytree_like

    model, _, axes, _, M, *_ = SCENARIOS[name]
    cfg, params, batch = data[name]
    mod = {"llama": jl, "mixtral": jm}[model]
    mesh = _jax_mesh(axes)
    if M:
        f = lambda p: jl.loss_fn_pp(cfg, p, batch, mesh,  # noqa: E731
                                    num_microbatches=M)
    else:
        params = jax.device_put(params, shard_pytree_like(
            mod.logical_axes_without_layer(cfg), mesh))
        b = {k: jax.device_put(v, named_sharding(
            mesh, "batch", *([None] * (v.ndim - 1))))
            for k, v in batch.items()}
        f = lambda p: mod.loss_fn(cfg, p, b, mesh=mesh)  # noqa: E731
    loss, grads = jax.jit(jax.value_and_grad(f))(params)
    flat = {".".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(grads)}
    return float(loss), flat


def _close_grads(got, want, rel=1e-4):
    assert set(got) == set(want)
    for k in want:
        scale = float(np.abs(want[k]).max()) or 1.0
        err = float(np.abs(got[k] - want[k]).max())
        assert err <= rel * scale, (k, err, scale)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_loss_and_grads_match_reference(run, name):
    loss, grads = run["refs"][name]
    for out in run["res"]:
        assert out[name]["loss"] == pytest.approx(loss, rel=1e-5)
    # gathered gradients are the same full tensor on every rank
    for out in run["res"][1:]:
        for k, g in out[name]["grads"].items():
            np.testing.assert_array_equal(g, run["res"][0][name]["grads"][k])
    _close_grads(run["res"][0][name]["grads"], grads)


def test_dryrun_losses_match_multichip_record(run):
    """On the dry run's own seeds the port prints the reference's
    recorded losses (MULTICHIP_r05.json, 4 decimals)."""
    import json
    import pathlib
    import re

    rec = json.loads((pathlib.Path(__file__).parents[1]
                      / "MULTICHIP_r05.json").read_text())["tail"]
    for name, prefix in RECORDED.items():
        line = next(x for x in rec.splitlines() if x.startswith(prefix))
        want = float(re.findall(r"(\d+\.\d{4})\)?$", line)[0])
        assert round(run["res"][0][name]["loss"], 4) == want, (name, line)


def test_pipeline_losses_match_sequential(run):
    """pp and pp x sp losses equal the plain sequential loss, as the dry
    run asserts for the reference."""
    import torch

    from ray_tpu_torch.models import llama
    from ray_tpu_torch.models.convert import params_from_numpy

    for name in ("pp4", "pp_ring", "pp_ulysses"):
        kw = SCENARIOS[name][1]
        cfg = llama.LlamaConfig.tiny(**dict(kw, attn_impl="reference"))
        params = params_from_numpy(run["trees"][name], device="cpu")
        tokens = torch.from_numpy(run["data"][name][2]["tokens"])
        want = float(llama.loss_fn(cfg, params, {"tokens": tokens}))
        assert run["res"][0][name]["loss"] == pytest.approx(want, rel=1e-5)


def test_forward_mesh_gives_global_logits(run):
    """Ring over {tp 2, sp 2, fsdp 2}, and tp 4 over 2 KV heads."""
    from ray_tpu.models import llama as jl

    for name in LOGITS:
        cfg, params, batch = run["data"][name]
        want = np.asarray(jl.forward(cfg, params, batch["tokens"][:, :-1],
                                     mesh=_jax_mesh(SCENARIOS[name][2])))
        for out in run["res"]:
            np.testing.assert_allclose(out[name]["logits"], want, atol=2e-5,
                                       rtol=1e-5)


def test_moe_drops_the_reference_tokens(run):
    """Layer 0's ``moe_layer`` on global hidden states over {dp 2, ep 4}
    at capacity factor 0.25: the outputs and aux loss are the
    reference's, and the kept (token, choice) pairs are those of the
    reference's arrival-order rule over the GLOBAL token order."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import mixtral as jm

    cfg, params, _ = run["data"][DROP]
    x = run["moe_x"]
    p0 = jax.tree_util.tree_map(lambda a: a[0], params["layers"])
    want_out, want_aux = jm.moe_layer(cfg, p0, jnp.asarray(x))
    # the reference's slots: cumsum of one-hot choices in flattened order
    n, E, K = x.shape[0] * x.shape[1], cfg.num_experts, cfg.top_k
    logits = jnp.dot(jnp.asarray(x).reshape(n, -1), p0["router"],
                     preferred_element_type=jnp.float32)
    _, top_e = jax.lax.top_k(jax.nn.softmax(logits, -1), K)
    flat = np.asarray(jax.nn.one_hot(top_e, E, dtype=jnp.int32)
                      ).reshape(n * K, E)
    pos = ((np.cumsum(flat, 0) - 1) * flat).sum(-1)
    want_keep = (pos < jm._capacity(cfg, n)).reshape(x.shape[0], -1)
    assert 0 < want_keep.sum() < want_keep.size      # tokens do overflow
    for out in run["res"]:
        moe = out[DROP]["moe"]
        np.testing.assert_array_equal(moe["keep"].astype(bool), want_keep)
        np.testing.assert_allclose(moe["out"], np.asarray(want_out),
                                   atol=2e-5, rtol=1e-5)
        assert moe["aux"] == pytest.approx(float(want_aux), rel=1e-5)


def test_fsdp_grads_equal_unsharded(run):
    """fsdp 8 (and two slices): every gathered gradient equals the port's
    own unsharded gradient. A rank that backpropagated its partial loss
    through un-summed shards would hold 1/8 of the batch's gradient."""
    import torch

    from ray_tpu_torch.models import llama
    from ray_tpu_torch.models.convert import params_from_numpy

    cfg = llama.LlamaConfig.tiny()
    for name in ("flat_fsdp8", "two_slice"):
        params = params_from_numpy(run["trees"][name], device="cpu")
        for _, p in llama.param_leaves(params):
            p.requires_grad_()
        tokens = torch.from_numpy(run["data"][name][2]["tokens"])
        loss = llama.loss_fn(cfg, params, {"tokens": tokens})
        loss.backward()
        want = {n: p.grad.numpy() for n, p in llama.param_leaves(params)}
        assert run["res"][0][name]["loss"] == pytest.approx(float(loss),
                                                           rel=1e-5)
        _close_grads(run["res"][0][name]["grads"], want)


def test_two_slice_matches_flat_fsdp(run):
    """The dry run's assertion: the hierarchy changes where collectives
    run, not the math (same weights and tokens as the flat mesh)."""
    a, b = run["res"][0]["two_slice"], run["res"][0]["flat_fsdp8"]
    assert a["loss"] == pytest.approx(b["loss"], abs=1e-4)
    _close_grads(a["grads"], b["grads"])


def _norm(entry):
    return None if entry is None else (
        (entry,) if isinstance(entry, str) else tuple(entry))


def _ref_specs(tree):
    if isinstance(tree, dict):
        return {k: _ref_specs(v) for k, v in tree.items()}
    return tuple(_norm(e) for e in tree.spec)


@pytest.mark.parametrize("name", sorted(SHARDINGS))
def test_param_shardings_match_reference(run, name):
    from ray_tpu.models import gpt2 as jg
    from ray_tpu.models import llama as jl
    from ray_tpu.models import mixtral as jm

    model, kw, axes = SHARDINGS[name]
    mod = {"llama": jl, "gpt2": jg, "mixtral": jm}[model]
    cfg = _config(mod, model, kw)
    want = _ref_specs(mod.param_shardings(cfg, _jax_mesh(axes)))

    def pad(spec, n):   # the reference's spec may stop before the last dim
        return tuple(spec) + (None,) * (n - len(spec))

    def cmp(got, want):
        if isinstance(want, dict):
            assert set(got) == set(want)
            for k in want:
                cmp(got[k], want[k])
        else:
            assert got == pad(want, len(got))
    cmp(run["res"][0]["shardings"][name], want)


@pytest.mark.parametrize("mesh", sorted(CACHE_MESHES))
def test_cache_shardings_match_reference(run, mesh):
    from ray_tpu.models import llama as jl
    from ray_tpu.models import llama_decode as jd
    from ray_tpu.models import llama_paged as jp

    cfg = jl.LlamaConfig.tiny()
    jmesh = _jax_mesh(CACHE_MESHES[mesh])
    for key, fn in (("cache", jd.cache_shardings),
                    ("paged", jp.paged_cache_shardings)):
        want = {k: tuple(_norm(e) for e in v.spec) + (None,) * (
            5 - len(v.spec)) for k, v in fn(cfg, jmesh).items()}
        assert run["res"][0]["shardings"][f"{key}/{mesh}"] == want


def test_with_logical_constraint(run):
    x = np.arange(8 * 4.).reshape(8, 4)
    for r, out in enumerate(run["res"]):
        placements, local = out["extras"]["constraint"]
        assert placements == "(Shard(dim=0), Shard(dim=0), Shard(dim=1))"
        dp, fsdp, tp = r // 4, (r // 2) % 2, r % 2
        row = (dp * 2 + fsdp) * 2
        np.testing.assert_array_equal(
            local, x[row:row + 2, tp * 2:(tp + 1) * 2])
        np.testing.assert_array_equal(
            out["extras"]["constraint_replicated"], x)


def test_mesh_errors_match_reference(run):
    import jax

    from ray_tpu.models import llama as jl

    cfg = jl.LlamaConfig.tiny(num_layers=4, attn_impl="ring")
    with pytest.raises(ValueError) as ref:
        jl.loss_fn_pp(cfg, jl.init_params(cfg, jax.random.PRNGKey(0)),
                      {"tokens": np.zeros((8, 17), np.int32)},
                      _jax_mesh({"pp": 4, "dp": 2}), 4)
    assert run["res"][0]["extras"]["pp_no_sp"] == str(ref.value)


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_sequence_parallel_without_mesh_raises(impl):
    import torch

    from ray_tpu.models import llama as jl
    from ray_tpu_torch.models import llama

    cfg = llama.LlamaConfig.tiny(attn_impl=impl)
    params = llama.init_params(cfg, seed=0, device="cpu")
    tokens = torch.zeros(2, 9, dtype=torch.long)
    with pytest.raises(ValueError) as got:
        llama.loss_fn(cfg, params, {"tokens": tokens})
    import jax

    jcfg = jl.LlamaConfig.tiny(attn_impl=impl)
    with pytest.raises(ValueError) as ref:
        jl.loss_fn(jcfg, jl.init_params(jcfg, jax.random.PRNGKey(0)),
                   {"tokens": np.zeros((2, 9), np.int32)})
    assert str(got.value) == str(ref.value)
