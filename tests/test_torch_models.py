"""The PyTorch port's Llama inference path against the JAX package.

Tiny configs, fp32, on the CPU. Weights are drawn by ``ray_tpu``'s
``init_params`` and converted through numpy (``params_from_numpy``), so
both packages compute with the same weights. Tolerances: 1e-4 on logits
(the reference's own model tests), token-exact greedy decoding, and the
reference's int8 tolerance for weight-only quantization.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from ray_tpu.models import llama as jl  # noqa: E402
from ray_tpu.models import llama_decode as jd  # noqa: E402
from ray_tpu.models import llama_paged as jp  # noqa: E402
from ray_tpu_torch.models import llama as tl  # noqa: E402
from ray_tpu_torch.models import llama_decode as td  # noqa: E402
from ray_tpu_torch.models import llama_paged as tp  # noqa: E402
from ray_tpu_torch.models.convert import (params_from_numpy,  # noqa: E402
                                          params_to_numpy)

torch.set_num_threads(1)
CPU = torch.device("cpu")

VARIANTS = {
    "base": {},
    "qkv_bias": {"attn_qkv_bias": True},
    "gelu_tanh_embed_scale": {"mlp_act": "gelu_tanh", "embed_scale": 8.0},
    "tied": {"tie_embeddings": True},
    "llama3_rope": {"rope_scaling": (("rope_type", "llama3"),
                                     ("factor", 8.0),
                                     ("original_max_position_embeddings",
                                      32))},
}


def _configs(name, **extra):
    kw = dict(VARIANTS[name], **extra)
    return (jl.LlamaConfig.tiny(attn_impl="reference", **kw),
            tl.LlamaConfig.tiny(**kw))


def _params(jcfg, seed=0):
    """JAX init (random biases where present) -> (jax params, port params)."""
    p = jax.tree_util.tree_map(
        np.asarray, jl.init_params(jcfg, jax.random.PRNGKey(seed)))
    if "bq" in p["layers"]:
        rng = np.random.default_rng(seed)
        for k in ("bq", "bk", "bv"):
            p["layers"][k] = rng.normal(
                0, 0.5, p["layers"][k].shape).astype(np.float32)
    return jax.tree_util.tree_map(jnp.asarray, p), params_from_numpy(p, CPU)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _tokens(seed, *shape):
    return np.random.default_rng(seed).integers(1, 250, shape).astype(
        np.int32)


# --------------------------------------------------------------- llama.py


def test_init_params_matches_reference_structure():
    for name in ("base", "qkv_bias", "tied"):
        jcfg, tcfg = _configs(name)
        want = jax.tree_util.tree_map(
            lambda a: (tuple(a.shape), str(a.dtype)),
            jl.init_params(jcfg, jax.random.PRNGKey(0)))
        got = tl.init_params(tcfg, seed=0, device="cpu")
        got_meta = {k: ({kk: (tuple(vv.shape), str(vv.dtype)[6:])
                         for kk, vv in v.items()} if isinstance(v, dict)
                        else (tuple(v.shape), str(v.dtype)[6:]))
                    for k, v in got.items()}
        assert got_meta == want
    # fan-in scaled truncated normal, reproducible from the seed
    a = tl.init_params(tcfg, seed=3, device="cpu")["layers"]["wq"]
    b = tl.init_params(tcfg, seed=3, device="cpu")["layers"]["wq"]
    assert torch.equal(a, b)
    assert float(a.abs().max()) <= 3.0 / np.sqrt(tcfg.hidden_size) + 1e-6


def test_entry_points_need_cuda_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    cfg = tl.LlamaConfig.tiny()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tl.init_params(cfg, seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        td.init_cache(cfg, 2, 16)


def test_config_maps_dtype_names_and_rejects_unported_attention():
    cfg = tl.LlamaConfig.llama3_8b(dtype="bfloat16", param_dtype="float32")
    assert cfg.dtype is torch.bfloat16 and cfg.param_dtype is torch.float32
    assert (cfg.hidden_size, cfg.num_layers, cfg.num_heads,
            cfg.num_kv_heads, cfg.head_dim_, cfg.intermediate_size,
            cfg.vocab_size) == (4096, 32, 32, 8, 128, 14336, 128256)
    # ring and ulysses are ported (they need a mesh); an unknown
    # attention still raises
    for impl in ("ring", "ulysses"):
        assert tl.LlamaConfig.tiny(attn_impl=impl).attn_impl == impl
    with pytest.raises(ValueError, match="attn_impl"):
        tl.LlamaConfig.tiny(attn_impl="bogus")


def test_params_numpy_roundtrip():
    jcfg, _ = _configs("qkv_bias")
    _, tparams = _params(jcfg)
    back = params_from_numpy(params_to_numpy(tparams), CPU)
    assert set(back) == set(tparams)
    for k, v in tparams["layers"].items():
        assert torch.equal(back["layers"][k], v)
    q = td.quantize_decode_params(tparams)
    qback = params_from_numpy(params_to_numpy(q), CPU)
    assert qback["layers"]["wq"]["q"].dtype == torch.int8
    assert torch.equal(qback["layers"]["wq"]["q"], q["layers"]["wq"]["q"])


@pytest.mark.parametrize("attn_impl", ["reference", "flash"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_forward_matches_jax(variant, attn_impl):
    jcfg, tcfg = _configs(variant)
    jparams, tparams = _params(jcfg)
    tcfg = tl.LlamaConfig.tiny(attn_impl=attn_impl, **VARIANTS[variant])
    toks = _tokens(1, 2, 64)
    want = jl.forward(jcfg, jparams, jnp.asarray(toks))
    got = tl.forward(tcfg, tparams, torch.from_numpy(toks))
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-4, rtol=1e-4)


# -------------------------------------------------------- llama_decode.py


@pytest.fixture(scope="module")
def tiny():
    jcfg, tcfg = _configs("base")
    jparams, tparams = _params(jcfg, seed=5)
    return jcfg, tcfg, jparams, tparams


def _prefilled(tiny, S=3, T=48, P=16):
    """Both packages' caches after a batched prefill into slots 2, 0."""
    jcfg, tcfg, jparams, tparams = tiny
    toks = _tokens(2, 2, P)
    last = np.array([P - 1, 9], np.int32)
    slots = np.array([2, 0], np.int32)
    valid = np.array([True, True])
    jlog, jkv = jd.prefill_batch(jcfg, jparams, jnp.asarray(toks),
                                 jnp.asarray(last))
    tlog, tkv = td.prefill_batch(tcfg, tparams, torch.from_numpy(toks),
                                 torch.from_numpy(last))
    jc = jd.insert_many(jd.init_cache(jcfg, S, T), jkv, jnp.asarray(slots),
                        jnp.asarray(valid))
    tc = td.insert_many(td.init_cache(tcfg, S, T, "cpu"), tkv, slots, valid)
    return (jlog, jkv, jc), (tlog, tkv, tc)


def test_prefill_batch_and_insert_match_jax(tiny):
    (jlog, jkv, jc), (tlog, tkv, tc) = _prefilled(tiny)
    np.testing.assert_allclose(_np(tlog), _np(jlog), atol=1e-4, rtol=1e-4)
    for k in ("k", "v"):
        np.testing.assert_allclose(_np(tkv[k]), _np(jkv[k]), atol=1e-5)
        np.testing.assert_allclose(_np(tc[k]), _np(jc[k]), atol=1e-5)
    # an invalid row leaves the cache untouched
    jcfg, tcfg, _, _ = tiny
    c = td.init_cache(tcfg, 3, 48, "cpu")
    td.insert_many(c, tkv, np.array([1, 2]), np.array([False, False]))
    assert float(c["k"].abs().max()) == 0.0


def test_decode_step_matches_jax(tiny):
    jcfg, tcfg, jparams, tparams = tiny
    (_, _, jc), (_, _, tc) = _prefilled(tiny)
    toks = np.array([7, 0, 9], np.int32)
    pos = np.array([10, 0, 16], np.int32)
    act = np.array([True, False, True])
    jc, jlog = jd.decode_step(jcfg, jparams, jc, jnp.asarray(toks),
                              jnp.asarray(pos), jnp.asarray(act))
    tc, tlog = td.decode_step(tcfg, tparams, tc, torch.from_numpy(toks),
                              torch.from_numpy(pos), act)
    np.testing.assert_allclose(_np(tlog), _np(jlog), atol=1e-4, rtol=1e-4)
    for k in ("k", "v"):
        np.testing.assert_allclose(_np(tc[k]), _np(jc[k]), atol=1e-5)


def test_decode_chunk_greedy_matches_jax(tiny):
    jcfg, tcfg, jparams, tparams = tiny
    (_, _, jc), (_, _, tc) = _prefilled(tiny)
    toks = np.array([7, 0, 9], np.int32)
    pos = np.array([10, 0, 16], np.int32)
    act = np.array([True, False, True])
    jc, jout, jnxt, jpos = jd.decode_chunk(
        jcfg, jparams, jc, jnp.asarray(toks), jnp.asarray(pos),
        jnp.asarray(act), 6, sample=False)
    tc, tout, tnxt, tpos = td.decode_chunk(
        tcfg, tparams, tc, torch.from_numpy(toks), torch.from_numpy(pos),
        act, 6, sample=False)
    np.testing.assert_array_equal(_np(tout), _np(jout))
    np.testing.assert_array_equal(_np(tnxt), _np(jnxt))
    np.testing.assert_array_equal(_np(tpos), _np(jpos))
    for k in ("k", "v"):
        np.testing.assert_allclose(_np(tc[k]), _np(jc[k]), atol=1e-4)


def test_sample_tokens_greedy_rows_and_top_k():
    logits = torch.tensor([[0.0, 3.0, 1.0, 2.0], [5.0, 0.0, 4.0, 1.0]])
    gen = torch.Generator().manual_seed(0)
    temps = torch.tensor([0.0, 1.0])
    for _ in range(20):
        out = td.sample_tokens(logits, gen, temps, top_k=2)
        assert out.dtype == torch.int32
        assert int(out[0]) == 1                # temperature 0: argmax
        assert int(out[1]) in (0, 2)           # top-2 of row 1


def test_quantize_decode_params_matches_jax(tiny):
    jcfg, tcfg, jparams, tparams = tiny
    jq = jd.quantize_decode_params(jparams)
    tq = td.quantize_decode_params(tparams)
    for k in ("wq", "w_down"):
        np.testing.assert_array_equal(_np(tq["layers"][k]["q"]),
                                      _np(jq["layers"][k]["q"]))
        np.testing.assert_allclose(_np(tq["layers"][k]["s"]),
                                   _np(jq["layers"][k]["s"]), rtol=1e-6)
    toks = np.array([5, 9], np.int32)
    pos = np.array([3, 7], np.int32)
    act = np.ones((2,), bool)
    _, jlog = jd.decode_step(jcfg, jq, jd.init_cache(jcfg, 2, 32),
                             jnp.asarray(toks), jnp.asarray(pos),
                             jnp.asarray(act))
    _, tlog = td.decode_step(tcfg, tq, td.init_cache(tcfg, 2, 32, "cpu"),
                             torch.from_numpy(toks), torch.from_numpy(pos),
                             act)
    np.testing.assert_allclose(_np(tlog), _np(jlog), atol=1e-5, rtol=1e-5)
    # bounded error against the unquantized weights
    _, tlo = td.decode_step(tcfg, tparams, td.init_cache(tcfg, 2, 32, "cpu"),
                            torch.from_numpy(toks), torch.from_numpy(pos),
                            act)
    lo, lq = _np(tlo), _np(tlog)
    assert np.abs(lq - lo).max() / max(np.abs(lo).max(), 1e-6) < 0.05


# --------------------------------------------------------- llama_paged.py


def _paged_prefill(tiny, page=8, P=12, MAXP=6):
    """Both pools after a two-chunk prefill of one 23-token sequence."""
    jcfg, tcfg, jparams, tparams = tiny
    toks = _tokens(4, 23)
    bt = np.array([5, 2, 9, 0, 0, 0], np.int32)
    jc = jp.init_paged_cache(jcfg, P, page)
    tc = tp.init_paged_cache(tcfg, P, page, "cpu")
    logits = []
    for ctx0, n in ((0, 16), (16, 7)):
        row = np.zeros((1, 16), np.int32)
        row[0, :n] = toks[ctx0:ctx0 + n]
        jc, jl_ = jp.prefill_chunk(jcfg, jparams, jc, jnp.asarray(row),
                                   jnp.asarray(bt), jnp.asarray(ctx0),
                                   jnp.asarray(n))
        tc, tl_ = tp.prefill_chunk(tcfg, tparams, tc, torch.from_numpy(row),
                                   torch.from_numpy(bt), ctx0, n)
        logits.append((jl_, tl_))
    return jc, tc, logits


def test_prefill_chunk_matches_jax(tiny):
    jc, tc, logits = _paged_prefill(tiny)
    for jl_, tl_ in logits:
        np.testing.assert_allclose(_np(tl_), _np(jl_), atol=1e-4, rtol=1e-4)
    for k in ("k", "v"):
        np.testing.assert_allclose(_np(tc[k]), _np(jc[k]), atol=1e-5)


def test_paged_decode_step_matches_pallas_interpret(tiny):
    """Paged decode with JAX's Pallas page-gather kernel (interpret
    mode) against the port's wrapper on CPU tensors; an inactive slot
    with a stale table row must leave the pool untouched."""
    jcfg, tcfg, jparams, tparams = tiny
    jc, tc, _ = _paged_prefill(tiny)
    # slot 1 is inactive and its stale row names slot 0's page 5
    bt = np.array([[5, 2, 9, 0, 0, 0], [5, 0, 0, 0, 0, 0],
                   [7, 0, 0, 0, 0, 0]], np.int32)
    toks = np.array([11, 3, 4], np.int32)
    pos = np.array([23, 4, 7], np.int32)
    act = np.array([True, False, True])
    with jax.default_matmul_precision("highest"):
        jc2, jlog = jp.paged_decode_step(
            jcfg, jparams, jc, jnp.asarray(toks), jnp.asarray(pos),
            jnp.asarray(act), jnp.asarray(bt), use_kernel=True,
            interpret=True)
    tc2, tlog = tp.paged_decode_step(tcfg, tparams, tc,
                                     torch.from_numpy(toks),
                                     torch.from_numpy(pos), act,
                                     torch.from_numpy(bt))
    np.testing.assert_allclose(_np(tlog), _np(jlog), atol=1e-4, rtol=1e-4)
    for k in ("k", "v"):
        np.testing.assert_allclose(_np(tc2[k]), _np(jc2[k]), atol=1e-5)


def test_paged_decode_chunk_matches_jax(tiny):
    jcfg, tcfg, jparams, tparams = tiny
    jc, tc, logits = _paged_prefill(tiny)
    first = int(np.argmax(_np(logits[-1][0])[0]))
    bt = np.array([[5, 2, 9, 1, 0, 0]], np.int32)
    args = (np.array([first], np.int32), np.array([23], np.int32))
    act = np.array([True])
    jc, jout, jnxt, jpos = jp.paged_decode_chunk(
        jcfg, jparams, jc, *map(jnp.asarray, args), jnp.asarray(act),
        jnp.asarray(bt), 8, sample=False)
    tc, tout, tnxt, tpos = tp.paged_decode_chunk(
        tcfg, tparams, tc, *map(torch.from_numpy, args), act,
        torch.from_numpy(bt), 8, sample=False)
    np.testing.assert_array_equal(_np(tout), _np(jout))
    np.testing.assert_array_equal(_np(tnxt), _np(jnxt))
    np.testing.assert_array_equal(_np(tpos), _np(jpos))
