"""GPT-2 and Mixtral in the port against the JAX package, and the plain
versions of the kernels at the new shapes (a GQA group of 7, head dim
256) against the Pallas kernels in interpret mode, on the CPU.

- ``forward``, ``loss_fn`` and every gradient leaf of both models on the
  same weights (the JAX init converted through numpy) and tokens, in
  fp32: logits and loss within 1e-4, each gradient leaf within 1e-4 of
  its max, with and without remat.
- ``moe_layer`` with a capacity small enough to drop tokens drops the
  same (token, choice) pairs as the reference and gives its outputs;
  one expert with top-1 is the dense SwiGLU MLP.
- ``attention_block`` is the reference's sub-block, q/k/v biases
  included.
"""

import dataclasses
import math

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from ray_tpu.models import gpt2 as jgpt2  # noqa: E402
from ray_tpu.models import llama as jllama  # noqa: E402
from ray_tpu.models import mixtral as jmixtral  # noqa: E402
from ray_tpu.ops import attention as jattn  # noqa: E402
from ray_tpu.ops import layers as jlayers  # noqa: E402
from ray_tpu.ops import paged_attention as jpaged  # noqa: E402
from ray_tpu_torch.models import gpt2 as tgpt2  # noqa: E402
from ray_tpu_torch.models import llama as tllama  # noqa: E402
from ray_tpu_torch.models import mixtral as tmixtral  # noqa: E402
from ray_tpu_torch.models.convert import (params_from_numpy,  # noqa: E402
                                          params_to_numpy)
from ray_tpu_torch.ops import attention as tattn  # noqa: E402
from ray_tpu_torch.ops import layers as tlayers  # noqa: E402
from ray_tpu_torch.ops import paged_attention as tpaged  # noqa: E402

torch.set_num_threads(1)

MODELS = {"gpt2": (jgpt2, tgpt2), "mixtral": (jmixtral, tmixtral)}


def _np(x):
    return np.asarray(x.detach().numpy() if hasattr(x, "detach") else x)


def _leaves(tree, prefix=""):
    out = {}
    for key in sorted(tree):
        v = tree[key]
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{key}."))
        else:
            out[prefix + key] = v
    return out


def _setup(model, remat=False, **over):
    """(jax cfg, port cfg, numpy params from the JAX init, tokens)."""
    jmod, tmod = MODELS[model]
    jcfg = jmod.GPT2Config.tiny(remat=remat, **over) if model == "gpt2" \
        else jmod.MixtralConfig.tiny(remat=remat, **over)
    tcfg = tmod.GPT2Config.tiny(remat=remat, **over) if model == "gpt2" \
        else tmod.MixtralConfig.tiny(remat=remat, **over)
    params = jax.tree_util.tree_map(
        np.asarray, jmod.init_params(jcfg, jax.random.PRNGKey(0)))
    tokens = np.random.default_rng(7).integers(0, jcfg.vocab_size, (2, 17))
    return jcfg, tcfg, params, tokens


@pytest.mark.parametrize("model", sorted(MODELS))
def test_init_params_tree_matches_jax(model):
    jcfg, tcfg, params, _ = _setup(model)
    got = _leaves(MODELS[model][1].init_params(tcfg, seed=0, device="cpu"))
    want = _leaves(params)
    assert sorted(got) == sorted(want)
    for name, leaf in want.items():
        assert tuple(got[name].shape) == leaf.shape, name
        assert got[name].dtype == torch.float32, name


@pytest.mark.parametrize("model", sorted(MODELS))
@pytest.mark.parametrize("remat", [False, True])
def test_forward_loss_and_grads_match_jax(model, remat):
    jmod, tmod = MODELS[model]
    jcfg, tcfg, params, tokens = _setup(model, remat=remat)
    batch_j = {"tokens": jnp.asarray(tokens)}
    want_out = jmod.forward(jcfg, params, jnp.asarray(tokens[:, :-1]))
    want_loss, want_grads = jax.value_and_grad(
        lambda p: jmod.loss_fn(jcfg, p, batch_j))(params)

    tparams = params_from_numpy(params, device="cpu")
    leaves = tllama.param_leaves(tparams)
    for _, leaf in leaves:
        leaf.requires_grad_()
    got_out = tmod.forward(tcfg, tparams, torch.from_numpy(tokens[:, :-1]))
    if model == "mixtral":
        (got_out, got_aux), (want_out, want_aux) = got_out, want_out
        np.testing.assert_allclose(_np(got_aux), _np(want_aux), atol=1e-6)
    np.testing.assert_allclose(_np(got_out), _np(want_out), atol=1e-4,
                               rtol=0)
    loss = tmod.loss_fn(tcfg, tparams, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=1e-5)
    loss.backward()
    want = _leaves(want_grads)
    for name, leaf in leaves:
        w = np.asarray(want[name])
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(_np(leaf.grad) - w).max())
        assert err <= 1e-4 * scale, (name, err, scale)


def _moe_inputs(seed, n_tokens, **over):
    jcfg = jmixtral.MixtralConfig.tiny(**over)
    tcfg = tmixtral.MixtralConfig.tiny(**over)
    params = jax.tree_util.tree_map(
        np.asarray, jmixtral.init_params(jcfg, jax.random.PRNGKey(seed)))
    p = {k: v[0] for k, v in params["layers"].items()}
    x = np.random.default_rng(seed).standard_normal(
        (2, n_tokens // 2, jcfg.hidden_size)).astype(np.float32)
    return jcfg, tcfg, p, x


def _jax_keep(cfg, p, x):
    """The reference's capacity assignment, step for step in jnp: which
    (token, choice) pairs of the flattened [n*K] order keep a slot."""
    n = x.shape[0] * x.shape[1]
    xt = jnp.asarray(x).reshape(n, -1)
    probs = jax.nn.softmax(jnp.dot(xt, jnp.asarray(p["router"]),
                                   preferred_element_type=jnp.float32), -1)
    _, top_e = jax.lax.top_k(probs, cfg.top_k)
    flat = jax.nn.one_hot(top_e, cfg.num_experts,
                          dtype=jnp.int32).reshape(n * cfg.top_k, -1)
    pos = ((jnp.cumsum(flat, axis=0) - 1) * flat).sum(-1)
    return np.asarray(pos < jmixtral._capacity(cfg, n))


@pytest.mark.parametrize("capacity_factor", [0.5, 0.25])
def test_moe_layer_drops_like_jax(capacity_factor):
    jcfg, tcfg, p, x = _moe_inputs(11, 96, capacity_factor=capacity_factor)
    want, want_aux = jmixtral.moe_layer(jcfg, p, jnp.asarray(x))
    tp = params_from_numpy(p, device="cpu")
    got, got_aux = tmixtral.moe_layer(tcfg, tp, torch.from_numpy(x))
    _, _, _, keep, _ = tmixtral.route(tcfg, tp, torch.from_numpy(x)
                                      .reshape(96, -1))
    keep = _np(keep)
    assert 0 < int((~keep).sum()) < keep.size      # some pairs dropped
    np.testing.assert_array_equal(keep, _jax_keep(jcfg, p, x))
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=0)
    np.testing.assert_allclose(float(got_aux), float(want_aux), rtol=1e-6)
    assert tmixtral._capacity(tcfg, 96) == jmixtral._capacity(jcfg, 96)


def test_moe_layer_one_expert_top1_is_the_dense_mlp():
    jcfg, tcfg, p, x = _moe_inputs(12, 32, num_experts=1, top_k=1,
                                   capacity_factor=1.0)
    tp = params_from_numpy(p, device="cpu")
    got, _ = tmixtral.moe_layer(tcfg, tp, torch.from_numpy(x))
    dense = tlayers.swiglu(torch.from_numpy(x), tp["e_gate"][0],
                           tp["e_up"][0], tp["e_down"][0])
    want = jlayers.swiglu(jnp.asarray(x), jnp.asarray(p["e_gate"][0]),
                          jnp.asarray(p["e_up"][0]),
                          jnp.asarray(p["e_down"][0]))
    np.testing.assert_allclose(_np(got), _np(dense), atol=1e-5, rtol=0)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("knob", [{"remat_policy": "save_qkv"},
                                  {"scan_layers": False}])
def test_mixtral_rejects_dense_llama_knobs(knob):
    jcfg, tcfg, params, tokens = _setup("mixtral", **knob)
    with pytest.raises(ValueError) as want:
        jmixtral.forward(jcfg, params, jnp.asarray(tokens))
    with pytest.raises(ValueError) as got:
        tmixtral.forward(tcfg, params_from_numpy(params, device="cpu"),
                         torch.from_numpy(tokens))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("bias", [False, True])
def test_attention_block_matches_jax(bias):
    jcfg = jllama.LlamaConfig.tiny(attn_qkv_bias=bias)
    tcfg = tllama.LlamaConfig.tiny(attn_qkv_bias=bias)
    params = jax.tree_util.tree_map(
        np.asarray, jllama.init_params(jcfg, jax.random.PRNGKey(3)))
    p = {k: v[1] for k, v in params["layers"].items()}
    if bias:
        rng = np.random.default_rng(5)
        p.update({k: rng.standard_normal(p[k].shape).astype(np.float32)
                  for k in ("bq", "bk", "bv")})
    x = np.random.default_rng(6).standard_normal((2, 9, 64)).astype(
        np.float32)
    cos, sin = jlayers.rope_frequencies(16, 9, jcfg.rope_theta,
                                        dtype=jnp.float32)
    want = jllama.attention_block(jcfg, jnp.asarray(x), p, cos, sin)
    tcos, tsin = tlayers.rope_frequencies(16, 9, tcfg.rope_theta,
                                          dtype=torch.float32)
    got = tllama.attention_block(tcfg, torch.from_numpy(x),
                                 params_from_numpy(p, device="cpu"),
                                 tcos, tsin)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=0)


def test_params_from_numpy_carries_expert_stacks():
    jcfg, tcfg, params, _ = _setup("mixtral")
    got = params_from_numpy(params, device="cpu", dtype=torch.bfloat16)
    e = got["layers"]["e_gate"]
    assert e.dim() == 4 and e.dtype == torch.bfloat16
    assert tuple(e.shape) == params["layers"]["e_gate"].shape
    back = params_to_numpy(got)["layers"]["e_down"]
    np.testing.assert_allclose(back, params["layers"]["e_down"], rtol=1e-2)


# ----------------------------------------------- kernels at the new shapes


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("kvh,group,hd", [(2, 7, 32), (1, 8, 256),
                                          (2, 1, 256), (1, 3, 64)])
def test_paged_plain_matches_pallas_interpret(kvh, group, hd):
    """The paged wrapper's plain version at a GQA group of 7 (Qwen2),
    head dim 256 (Gemma: G 1 and G 8) and G 3, against the Pallas page
    walk in interpret mode; ragged contexts with an empty slot."""
    S, page, maxp, P = 4, 8, 6, 30
    q = _rand(30, S, kvh, group, hd)
    kp = _rand(31, P, kvh, page, hd)
    vp = _rand(32, P, kvh, page, hd)
    ctx = np.array([0, 5, 17, 48], np.int32)
    bt = np.random.default_rng(33).integers(0, P, (S, maxp)).astype(np.int32)
    with jax.default_matmul_precision("highest"):
        want = jpaged.paged_attention(
            *map(jnp.asarray, (q, kp, vp, bt, ctx)), interpret=True)
    got = tpaged.paged_attention(*map(torch.from_numpy, (q, kp, vp, bt,
                                                         ctx)))
    live = ctx > 0
    o_t, m_t, l_t = map(_np, got)
    o_j, m_j, l_j = map(np.asarray, want)
    np.testing.assert_allclose(o_t[live] / l_t[live][..., None],
                               o_j[live] / l_j[live][..., None], atol=2e-5)
    np.testing.assert_allclose(m_t[live], m_j[live], atol=2e-5)
    np.testing.assert_allclose(l_t, l_j, rtol=1e-5, atol=1e-6)
    assert float(np.abs(o_t[0]).max()) == 0.0


@pytest.mark.parametrize("heads,kv_heads,d,causal", [
    (2, 2, 256, True), (2, 1, 256, False), (7, 1, 32, True)])
def test_flash_plain_matches_pallas_interpret(heads, kv_heads, d, causal):
    """The flash forward and backward wrappers' plain versions at head dim
    256 and at a GQA group of 7, against the Pallas forward, dQ and
    dK/dV kernels in interpret mode."""
    b, s = 1, 128
    q, k, v = (_rand(40 + i, b, s, h, d)
               for i, h in enumerate((heads, kv_heads, kv_heads)))
    g = _rand(44, b, s, heads, d)
    scale = 1.0 / math.sqrt(d)
    jq, jk, jv, jg = map(jnp.asarray, (q, k, v, g))
    with jax.default_matmul_precision("highest"):
        out, lse = jattn._flash_forward(jq, jk, jv, causal, scale, 64, 64,
                                        True)
        want = jattn._flash_backward(jq, jk, jv, out, lse, jg, causal,
                                     scale, 64, 64, True)
    o_t, lse_t = tattn.flash_forward(*map(torch.from_numpy, (q, k, v)),
                                     causal, scale)
    np.testing.assert_allclose(_np(o_t), np.asarray(out), atol=2e-5)
    np.testing.assert_allclose(_np(lse_t), np.asarray(lse)[..., 0],
                               atol=2e-5)
    got = tattn.flash_backward(
        *map(torch.from_numpy, (q, k, v, np.array(out))),
        torch.from_numpy(np.asarray(lse)[..., 0].copy()),
        torch.from_numpy(g), causal, scale)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(_np(a), np.asarray(w), err_msg=name,
                                   rtol=2e-4, atol=1e-4)
