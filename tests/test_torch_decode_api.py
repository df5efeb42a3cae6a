"""The single-prompt decode API of the port against ``ray_tpu``'s:
``llama.init_shapes`` against ``jax.eval_shape`` of ``init_params``,
``llama_decode.prefill`` and ``insert_sequence`` against
``ray_tpu/models/llama_decode.py`` on the same weights and tokens (2e-5;
the insert exactly), and prefill, insert and one decode step chained.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from ray_tpu.models import llama as jl  # noqa: E402
from ray_tpu.models import llama_decode as jd  # noqa: E402
from ray_tpu_torch.models import llama as tl  # noqa: E402
from ray_tpu_torch.models import llama_decode as td  # noqa: E402
from ray_tpu_torch.models.convert import params_from_numpy  # noqa: E402

torch.set_num_threads(1)

VARIANTS = {
    "base": {},
    "qkv_bias": {"attn_qkv_bias": True},
    "gemma_deltas": {"mlp_act": "gelu_tanh", "embed_scale": 8.0,
                     "tie_embeddings": True},
}


def _configs(variant):
    kw = VARIANTS[variant]
    return jl.LlamaConfig.tiny(**kw), tl.LlamaConfig.tiny(**kw)


def _params(jcfg, seed=0):
    p = jax.tree_util.tree_map(
        np.asarray, jl.init_params(jcfg, jax.random.PRNGKey(seed)))
    if "bq" in p["layers"]:
        rng = np.random.default_rng(seed)
        for k in ("bq", "bk", "bv"):
            p["layers"][k] = rng.normal(
                0, 0.5, p["layers"][k].shape).astype(np.float32)
    return jax.tree_util.tree_map(jnp.asarray, p), params_from_numpy(p,
                                                                     "cpu")


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


@pytest.mark.parametrize("preset,variant", [
    ("tiny", "base"), ("tiny", "qkv_bias"), ("tiny", "gemma_deltas"),
    ("llama3_8b", "base")])
def test_init_shapes_matches_eval_shape(preset, variant):
    kw = VARIANTS[variant]
    jcfg = getattr(jl.LlamaConfig, preset)(**kw)
    tcfg = getattr(tl.LlamaConfig, preset)(**kw)
    want = dict(_jax_shape_leaves(jcfg))
    got = dict(tl.param_leaves(tl.init_shapes(tcfg)))
    assert sorted(got) == sorted(want)
    for path, t in got.items():
        assert t.is_meta, path
        assert tuple(t.shape) == tuple(want[path].shape), path
        assert str(t.dtype).removeprefix("torch.") == str(
            want[path].dtype), path
    if preset == "tiny":   # the real init has the same tree
        real = dict(tl.param_leaves(tl.init_params(tcfg, 0, "cpu")))
        assert {k: (v.shape, v.dtype) for k, v in real.items()} == \
            {k: (v.shape, v.dtype) for k, v in got.items()}


def _jax_shape_leaves(jcfg):
    flat = jax.tree_util.tree_flatten_with_path(jl.init_shapes(jcfg))[0]
    for path, s in flat:
        yield ".".join(str(getattr(k, "key", k)) for k in path), s


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_prefill_matches_reference(variant):
    jcfg, tcfg = _configs(variant)
    jparams, tparams = _params(jcfg)
    toks = np.random.default_rng(1).integers(1, 256, (1, 32)).astype(
        np.int32)
    want_logits, want_kv, want_x = jd.prefill(jcfg, jparams,
                                              jnp.asarray(toks))
    logits, kv, x = td.prefill(tcfg, tparams, torch.from_numpy(toks))
    assert tuple(logits.shape) == (32, 256) and logits.dtype == torch.float32
    assert tuple(kv["k"].shape) == (2, 32, 2, 16)
    np.testing.assert_allclose(_np(logits), _np(want_logits), atol=2e-5,
                               rtol=2e-5)
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(kv[name]), _np(want_kv[name]),
                                   atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(_np(x), _np(want_x), atol=2e-5, rtol=2e-5)


def test_prefill_flash_route_matches_reference():
    """``prefill_flash=True`` at a 128-multiple takes ``flash_attention``
    (its plain version on CPU tensors): the same function."""
    jcfg, _ = _configs("base")
    tcfg = tl.LlamaConfig.tiny(prefill_flash=True)
    jparams, tparams = _params(jcfg)
    toks = np.random.default_rng(2).integers(1, 256, (1, 128)).astype(
        np.int32)
    want_logits, want_kv, _ = jd.prefill(jcfg, jparams, jnp.asarray(toks))
    logits, kv, _ = td.prefill(tcfg, tparams, torch.from_numpy(toks))
    np.testing.assert_allclose(_np(logits), _np(want_logits), atol=2e-5,
                               rtol=2e-5)
    np.testing.assert_allclose(_np(kv["v"]), _np(want_kv["v"]), atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("slot", [0, 2])
def test_insert_sequence_matches_reference(slot):
    rng = np.random.default_rng(3)
    L, S, T, KVH, hd, P = 2, 3, 48, 2, 16, 20
    cache = {n: rng.normal(size=(L, S, T, KVH, hd)).astype(np.float32)
             for n in ("k", "v")}
    kv = {n: rng.normal(size=(L, P, KVH, hd)).astype(np.float32)
          for n in ("k", "v")}
    want = jd.insert_sequence({n: jnp.asarray(a) for n, a in cache.items()},
                              {n: jnp.asarray(a) for n, a in kv.items()},
                              jnp.asarray(slot, jnp.int32))
    got = td.insert_sequence({n: torch.from_numpy(a.copy())
                              for n, a in cache.items()},
                             {n: torch.from_numpy(a) for n, a in kv.items()},
                             slot)
    for n in ("k", "v"):
        np.testing.assert_array_equal(_np(got[n]), _np(want[n]))
        np.testing.assert_array_equal(_np(got[n])[:, slot, :P], kv[n])


def test_prefill_insert_decode_chain_matches_reference():
    """prefill, insert into slot 1, one decode step from the prompt's
    argmax: the decode logits agree with the reference's chain."""
    jcfg, tcfg = _configs("base")
    jparams, tparams = _params(jcfg)
    plen, T, S = 21, 64, 2
    toks = np.zeros((1, 32), np.int32)
    toks[0, :plen] = np.random.default_rng(4).integers(1, 256, plen)

    def chain(d, cfg, params, arr, init_cache):
        logits, kv, _ = d.prefill(cfg, params, arr(toks))
        cache = d.insert_sequence(init_cache(cfg, S, T), kv, 1)
        nxt = int(np.argmax(_np(logits)[plen - 1]))
        _, out = d.decode_step(cfg, params, cache,
                               arr(np.array([0, nxt], np.int32)),
                               arr(np.array([0, plen], np.int32)),
                               np.array([False, True]))
        return nxt, _np(out)[1]

    want = chain(jd, jcfg, jparams, jnp.asarray,
                 lambda c, s, t: jd.init_cache(c, s, t))
    got = chain(td, tcfg, tparams, torch.from_numpy,
                lambda c, s, t: td.init_cache(c, s, t, "cpu"))
    assert got[0] == want[0]
    np.testing.assert_allclose(got[1], want[1], atol=2e-5, rtol=2e-5)
