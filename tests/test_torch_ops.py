"""The PyTorch port's ops against the JAX package on the same inputs.

Inputs come from a numpy seed and go through both packages in fp32 on
the CPU. Pallas kernels run in interpret mode on the JAX side; on the
port's side CPU tensors take each kernel's plain PyTorch version, which
is the arithmetic the CUDA kernel is held to on the card (chip_smoke.py).
Tolerances: 2e-5 absolute for attention (as tests/test_ops.py), 1e-5
relative for the layers.
"""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from ray_tpu.ops import attention as jattn  # noqa: E402
from ray_tpu.ops import layers as jlayers  # noqa: E402
from ray_tpu.ops import paged_attention as jpaged  # noqa: E402
from ray_tpu_torch.ops import _build  # noqa: E402
from ray_tpu_torch.ops import attention as tattn  # noqa: E402
from ray_tpu_torch.ops import layers as tlayers  # noqa: E402
from ray_tpu_torch.ops import paged_attention as tpaged  # noqa: E402

torch.set_num_threads(1)
ROOT = pathlib.Path(__file__).resolve().parent.parent


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


# ------------------------------------------------------------------ layers


def test_rms_norm_matches_jax():
    x, w = _rand(0, 4, 7, 64), _rand(1, 64)
    want = jlayers.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5)
    got = tlayers.rms_norm(_t(x), _t(w), 1e-5)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-6)


ROPE_SCALINGS = {
    "none": None,
    "llama3": {"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
               "high_freq_factor": 4.0,
               "original_max_position_embeddings": 64},
    "linear": {"rope_type": "linear", "factor": 4.0},
    "yarn": {"rope_type": "yarn", "factor": 4.0,
             "original_max_position_embeddings": 32},
}


@pytest.mark.parametrize("kind", sorted(ROPE_SCALINGS))
def test_rope_frequencies_match_jax(kind):
    sc = ROPE_SCALINGS[kind]
    jc, js = jlayers.rope_frequencies(64, 256, 10_000.0, scaling=sc)
    tc, ts = tlayers.rope_frequencies(64, 256, 10_000.0, scaling=sc)
    np.testing.assert_allclose(_np(tc), _np(jc), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(ts), _np(js), rtol=1e-5, atol=1e-5)


def test_rope_frequencies_reject_unknown_scaling():
    with pytest.raises(ValueError, match="unsupported rope_scaling"):
        tlayers.rope_frequencies(64, 16, scaling={"rope_type": "ntk"})


@pytest.mark.parametrize("explicit_positions", [False, True])
def test_apply_rope_matches_jax(explicit_positions):
    x = _rand(2, 3, 10, 4, 32)
    jc, js = jlayers.rope_frequencies(32, 64)
    tc, ts = tlayers.rope_frequencies(32, 64)
    if explicit_positions:
        pos = np.random.default_rng(3).integers(0, 64, (3, 10))
        want = jlayers.apply_rope(jnp.asarray(x), jc, js, jnp.asarray(pos))
        got = tlayers.apply_rope(_t(x), tc, ts, _t(pos))
    else:
        want = jlayers.apply_rope(jnp.asarray(x), jc, js)
        got = tlayers.apply_rope(_t(x), tc, ts)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("act", ["silu", "gelu_tanh", "gelu"])
def test_swiglu_matches_jax(act):
    x = _rand(4, 5, 32)
    wg, wu, wd = (_rand(5, 32, 48, scale=0.2), _rand(6, 32, 48, scale=0.2),
                  _rand(7, 48, 32, scale=0.2))
    want = jlayers.swiglu(*map(jnp.asarray, (x, wg, wu, wd)), act=act)
    got = tlayers.swiglu(*map(_t, (x, wg, wu, wd)), act=act)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-6)


def test_swiglu_rejects_unknown_activation():
    x = torch.zeros(2, 4)
    w = torch.zeros(4, 4)
    with pytest.raises(ValueError, match="unknown gated-MLP activation"):
        tlayers.swiglu(x, w, w, w, act="relu")


def test_repeat_kv_matches_jax():
    x = _rand(8, 2, 5, 3, 8)
    np.testing.assert_array_equal(
        _np(tlayers.repeat_kv(_t(x), 4)),
        _np(jlayers.repeat_kv(jnp.asarray(x), 4)))


# --------------------------------------------------------------- attention

# (b, sq, sk, heads, kv_heads, d, causal)
ATTN_CASES = {
    "causal": (2, 128, 128, 4, 4, 32, True),
    "noncausal": (2, 128, 128, 4, 4, 32, False),
    "gqa": (2, 128, 128, 4, 2, 32, True),
    "sk_gt_sq": (1, 64, 128, 4, 2, 32, True),
}


def _qkv(case, seed=10):
    b, sq, sk, h, kvh, d, _ = ATTN_CASES[case]
    return (_rand(seed, b, sq, h, d), _rand(seed + 1, b, sk, kvh, d),
            _rand(seed + 2, b, sk, kvh, d))


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_attention_reference_matches_jax(case):
    q, k, v = _qkv(case)
    causal = ATTN_CASES[case][-1]
    want = jattn.attention_reference(*map(jnp.asarray, (q, k, v)), causal)
    got = tattn.attention_reference(*map(_t, (q, k, v)), causal)
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-5)


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_flash_attention_matches_pallas_interpret(case):
    """The port's flash wrapper on CPU tensors (the kernel's plain
    version) against the Pallas kernel in interpret mode: O and the
    fp32 logsumexp the backward kernels will consume."""
    q, k, v = _qkv(case)
    causal = ATTN_CASES[case][-1]
    want = jattn.flash_attention(*map(jnp.asarray, (q, k, v)), causal=causal,
                                 use_pallas=True, interpret=True,
                                 block_q=64, block_k=64)
    got = tattn.flash_attention(*map(_t, (q, k, v)), causal=causal,
                                block_q=64, block_k=64)
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-5)
    scale = 1.0 / np.sqrt(q.shape[-1])
    _, lse_j = jattn._flash_forward(*map(jnp.asarray, (q, k, v)), causal,
                                    scale, 64, 64, True)
    _, lse_t = tattn.flash_forward(*map(_t, (q, k, v)), causal, scale)
    assert tuple(lse_t.shape) == (q.shape[0] * q.shape[2], q.shape[1])
    np.testing.assert_allclose(_np(lse_t), _np(lse_j)[..., 0], atol=2e-5)


def test_flash_attention_rejects_ragged():
    q = torch.zeros(1, 100, 2, 32)
    with pytest.raises(ValueError, match="divisible"):
        tattn.flash_attention(q, q, q, block_q=64, block_k=64)
    # the default blocks accept the same length, as in the reference
    assert tattn.flash_attention(q, q, q).shape == q.shape


# ---------------------------------------------------------------- paged


def _paged_case(seed=20, S=5, KVH=2, G=2, hd=32, page=8, MAXP=6, P=32):
    rng = np.random.default_rng(seed)
    q = _rand(seed, S, KVH, G, hd)
    kp = _rand(seed + 1, P, KVH, page, hd)
    vp = _rand(seed + 2, P, KVH, page, hd)
    ctx = np.array([0, 5, 17, 48, 8], np.int32)[:S]
    bt = rng.integers(0, P, (S, MAXP)).astype(np.int32)
    return q, kp, vp, bt, ctx


def test_paged_attention_matches_pallas_interpret():
    """Ragged contexts including an empty slot; table entries past ctx
    hold ids out of the pool's range (the Pallas index map clamps them
    away, the port's plain gather clamps them into the pool)."""
    q, kp, vp, bt, ctx = _paged_case()
    page = kp.shape[2]
    for s, c in enumerate(ctx):
        bt[s, -(-c // page):] = 10_000 + s
    with jax.default_matmul_precision("highest"):
        o_j, m_j, l_j = jpaged.paged_attention(
            *map(jnp.asarray, (q, kp, vp, bt, ctx)), interpret=True)
    o_t, m_t, l_t = tpaged.paged_attention(*map(_t, (q, kp, vp, bt, ctx)))
    live = ctx > 0
    np.testing.assert_allclose(_np(o_t)[live] / _np(l_t)[live][..., None],
                               _np(o_j)[live] / _np(l_j)[live][..., None],
                               atol=2e-5)
    np.testing.assert_allclose(_np(m_t)[live], _np(m_j)[live], atol=2e-5)
    np.testing.assert_allclose(_np(l_t), _np(l_j), rtol=1e-5, atol=1e-6)
    # the ctx-0 triple is exact: acc 0, l 0, m -1e30
    assert float(np.abs(_np(o_t)[0]).max()) == 0.0
    assert float(_np(l_t)[0].max()) == 0.0
    assert np.all(_np(m_t)[0] == np.float32(-1e30))


def test_paged_attention_reference_matches_jax_clamped_gather():
    """Out-of-range table ids are clamped into the pool exactly as the
    JAX gather clamps them."""
    q, kp, vp, bt, ctx = _paged_case(seed=30)
    bt[1, 0] = 500            # past the pool: both sides read page P-1
    bt[3, 2] = -3             # negative: both sides count from the end
    with jax.default_matmul_precision("highest"):
        want = jpaged.paged_attention_reference(
            *map(jnp.asarray, (q, kp, vp, bt, ctx)))
    got = tpaged.paged_attention_reference(*map(_t, (q, kp, vp, bt, ctx)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), rtol=1e-5, atol=2e-5)


def test_kernel_wrappers_reject_other_devices():
    """Only CPU tensors take the plain versions; any other non-CUDA
    device raises instead of silently computing somewhere else."""
    q = torch.zeros(1, 64, 2, 64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tattn.flash_forward(q, q, q)
    qp = torch.zeros(2, 1, 2, 64, device="meta")
    pool = torch.zeros(4, 1, 8, 64, device="meta")
    bt = torch.zeros(2, 3, dtype=torch.int32, device="meta")
    ctx = torch.zeros(2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tpaged.paged_attention(qp, pool, pool, bt, ctx)


# ------------------------------------------------------------------ build


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    if pathlib.Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("a CUDA toolkit is installed at /usr/local/cuda")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


def test_kernel_library_is_keyed_by_source_hash():
    srcs = {p.name for p in _build.sources()}
    assert {"flash_fwd.cu", "flash_bwd.cu", "paged_attention.cu",
            "errors.cu"} <= srcs
    h = _build.source_hash()
    assert h == _build.source_hash() and len(h) == 16
    assert h in _build.library_path().name
    assert _build.library_path().parent == _build.BUILD_DIR
    gitignore = (ROOT / ".gitignore").read_text().split()
    assert "ray_tpu_torch/_build/" in gitignore


# ------------------------------------------------------------- boundaries


def _imported_modules(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_neither_jax_nor_ray_tpu():
    # _build/ holds build outputs, not the package's sources
    files = sorted(f for f in (ROOT / "ray_tpu_torch").rglob("*.py")
                   if "_build" not in f.relative_to(ROOT).parts)
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    bad = [(f.relative_to(ROOT).as_posix(), mod)
           for f in files for mod in _imported_modules(f)
           if mod.split(".")[0] in ("jax", "jaxlib", "ray_tpu")]
    assert bad == []


def test_port_top_level_import_is_light():
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys, ray_tpu_torch; print('torch' in sys.modules, "
         "'jax' in sys.modules)"],
        cwd=ROOT, capture_output=True, text=True, check=True, timeout=120)
    assert out.stdout.split() == ["False", "False"]
