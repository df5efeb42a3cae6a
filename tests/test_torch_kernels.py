"""The port's kernel plumbing and the arithmetic of its bf16 Hopper kernels,
on the CPU.

- Every ``extern "C"`` entry point in ``ray_tpu_torch/csrc/*.cu`` has a
  ctypes signature in ``_build._SIGNATURES`` with the same arguments
  (pointers as ``c_void_p``): a mismatch would cut a pointer silently on
  the card.
- ``flash_route`` sends each (dtype, head dim, device, kernel) to the
  wgmma kernels, the 3xTF32 kernels (the fp32 forward, dQ and dK/dV),
  the scalar kernels (bf16 at head dim 16 and 32), the plain versions,
  or a ``ValueError``.
- The bf16 forward, dQ and dK/dV kernels (``csrc/flash_fwd_sm90.cu``,
  ``csrc/flash_bwd_dq_sm90.cu``, ``csrc/flash_bwd_dkv_sm90.cu``) and
  their head-dim-256 versions (``csrc/flash_fwd_sm90_d256.cu``,
  ``csrc/flash_bwd_dq_sm90_d256.cu``, ``csrc/flash_bwd_dkv_sm90_d256.cu``)
  emulated in plain torch: fp32 products of bf16 inputs, the scale
  applied to S in fp32 through exp2, 128-key (64 at d 256) tiles of
  online softmax in the forward, P (and dS) rounded to bf16 before the
  second products, and at d 256 each half of d's dK/dV accumulated on
  its own. The emulation agrees with the
  Pallas kernels in interpret mode on the same bf16 inputs within 2e-2
  (atol and rtol): the tolerance the card holds the kernels to
  (chip_smoke.py phase 1).
- The split-K paged kernel (``csrc/paged_attention.cu``) emulated in
  plain torch: fp32 partials ``(acc_i, m_i, l_i)`` over runs of pages,
  merged in split order. It agrees with the Pallas page-walk kernel in
  interpret mode in fp32 within 1e-5, for splits of 1, 2 and 3 pages.
- ``params_from_numpy`` resolves its default device like every other
  entry point of the port.
"""

import ctypes
import math
import re

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from ray_tpu.ops import attention as jattn  # noqa: E402
from ray_tpu.ops import paged_attention as jpaged  # noqa: E402
from ray_tpu_torch.models.convert import params_from_numpy  # noqa: E402
from ray_tpu_torch.ops import _build  # noqa: E402
from ray_tpu_torch.ops import attention as tattn  # noqa: E402
from ray_tpu_torch.ops import paged_attention as tpaged  # noqa: E402
from ray_tpu_torch.ops.layers import repeat_kv  # noqa: E402

torch.set_num_threads(1)

LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
TILE = 128   # keys per tile of the forward kernel

# ------------------------------------------------------------ signatures

_EXTERN_C = re.compile(
    r'extern\s+"C"\s+[\w\s\*]*?\b(rtt_\w+)\s*\(([^)]*)\)\s*\{', re.S)


def _c_entry_points():
    """{name: [ctypes type per argument]} parsed from csrc/*.cu."""
    found = {}
    for path in _build.sources():
        for name, args in _EXTERN_C.findall(path.read_text()):
            types = []
            for arg in (a.strip() for a in args.split(",") if a.strip()):
                if "*" in arg:
                    types.append(ctypes.c_void_p)
                elif arg.split()[0] == "float":
                    types.append(ctypes.c_float)
                else:
                    assert arg.split()[0] == "int", (name, arg)
                    types.append(ctypes.c_int)
            assert name not in found, f"{name} defined twice"
            found[name] = types
    return found


def test_every_c_entry_point_has_a_signature():
    assert set(_c_entry_points()) == set(_build._SIGNATURES)


@pytest.mark.parametrize("name", sorted(_build._SIGNATURES))
def test_c_entry_point_signature_matches_source(name):
    parsed = _c_entry_points()
    assert name in parsed, f"{name} has no extern \"C\" definition"
    assert _build._SIGNATURES[name] == parsed[name]


# --------------------------------------------------------------- routing

_ROUTES = [
    (torch.bfloat16, 128, "cuda", "sm90"),
    (torch.bfloat16, 64, "cuda", "sm90"),
    (torch.float32, 128, "cuda", "tf32x3"),
    (torch.float32, 64, "cuda", "tf32x3"),
    (torch.bfloat16, 128, "cpu", "plain"),
    (torch.float32, 32, "cpu", "plain"),
    (torch.float16, 96, "cpu", "plain"),
    (torch.float16, 128, "cuda", None),
    (torch.bfloat16, 96, "cuda", None),
    (torch.float32, 256, "cuda", "tf32x3"),
    (torch.bfloat16, 128, "meta", None),
    (torch.bfloat16, 256, "cuda", "sm90"),
    (torch.float32, 96, "cuda", None),
    (torch.bfloat16, 512, "cuda", None),
    (torch.float32, 16, "cuda", "tf32x3"),
    (torch.bfloat16, 16, "cuda", "scalar"),
    (torch.float32, 32, "cuda", "tf32x3"),
    (torch.bfloat16, 32, "cuda", "scalar"),
    (torch.bfloat16, 8, "cuda", None),
    (torch.bfloat16, 16, "cpu", "plain"),
]


@pytest.mark.parametrize("dtype,d,device,route", _ROUTES)
def test_flash_route(dtype, d, device, route):
    """The forward's route (``kernel`` defaults to ``"fwd"``)."""
    if route is None:
        with pytest.raises(ValueError):
            tattn.flash_route(dtype, d, device)
    else:
        assert tattn.flash_route(dtype, d, device) == route


# each kernel's route at head dim 256 and below the wgmma tile: bf16 d 256
# runs all three wgmma kernels; fp32 runs all three in 3xTF32 at every
# head dim; bf16 below the wgmma tile runs the scalar kernels
_KERNEL_ROUTES = [
    (torch.bfloat16, 256, "fwd", "sm90"),
    (torch.bfloat16, 256, "dq", "sm90"),
    (torch.bfloat16, 256, "dkv", "sm90"),
    (torch.float32, 256, "fwd", "tf32x3"),
    (torch.float32, 256, "dq", "tf32x3"),
    (torch.float32, 256, "dkv", "tf32x3"),
    (torch.bfloat16, 128, "dq", "sm90"),
    (torch.bfloat16, 64, "dkv", "sm90"),
    (torch.bfloat16, 16, "dq", "scalar"),
    (torch.bfloat16, 32, "dkv", "scalar"),
    (torch.float32, 16, "dkv", "tf32x3"),
    (torch.float32, 128, "dq", "tf32x3"),
    (torch.float32, 64, "dkv", "tf32x3"),
    (torch.float32, 16, "dq", "tf32x3"),
    (torch.float32, 32, "dq", "tf32x3"),
    (torch.float32, 64, "dq", "tf32x3"),
    (torch.bfloat16, 32, "dq", "scalar"),
]


@pytest.mark.parametrize("dtype,d,kernel,route", _KERNEL_ROUTES)
def test_flash_route_per_kernel(dtype, d, kernel, route):
    assert tattn.flash_route(dtype, d, "cuda", kernel) == route
    assert tattn.flash_route(dtype, d, "cpu", kernel) == "plain"


def test_flash_route_rejects_unknown_kernel():
    with pytest.raises(ValueError, match="unknown kernel"):
        tattn.flash_route(torch.bfloat16, 128, "cuda", "bwd")


# ------------------------------------------------- bf16 kernel arithmetic

# (b, sq, sk, heads, kv_heads, d, causal)
BF16_CASES = {
    "causal": (1, 256, 256, 4, 2, 64, True),
    "noncausal": (1, 256, 256, 4, 2, 64, False),
    "sq_lt_sk": (1, 128, 512, 4, 2, 64, True),
}


def _visible(sq, sk):
    qi = torch.arange(sq)[:, None]
    return qi + (sk - sq) >= torch.arange(sk)[None, :]


def emulate_fwd_sm90(q, k, v, causal, scale, tile=TILE):
    """The bf16 forward kernel's arithmetic on bf16 q [b, sq, H, d] and
    k, v [b, sk, KVH, d], online softmax over ``tile``-key tiles (128 in
    ``flash_fwd_sm90.cu``, 64 in ``flash_fwd_sm90_d256.cu``): returns (O
    bf16, lse fp32 [b*H, sq])."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    qf = q.float()
    kf = repeat_kv(k, h // k.shape[2]).float()
    vf = repeat_kv(v, h // k.shape[2]).float()
    vis = _visible(sq, sk)
    m = torch.full((b, h, sq, 1), -1e30)
    l = torch.zeros(b, h, sq, 1)
    acc = torch.zeros(b, h, sq, d)
    for k0 in range(0, sk, tile):
        t = torch.einsum("bqhd,bkhd->bhqk", qf, kf[:, k0:k0 + tile])
        t = t * (scale * LOG2E)
        if causal:
            t = torch.where(vis[:, k0:k0 + tile], t, -1e30)
        m_new = torch.maximum(m, t.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(t - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.einsum(
            "bhqk,bkhd->bhqd", p.bfloat16().float(), vf[:, k0:k0 + tile])
        m = m_new
    l_safe = l.clamp_min(1e-30)
    out = (acc / l_safe).transpose(1, 2).bfloat16()
    lse = ((m + torch.log2(l_safe)) * LN2).reshape(b * h, sq)
    return out, lse


def emulate_dkv_sm90(q, k, v, o, lse, do, causal, scale, halves=1):
    """The bf16 dK/dV kernel's arithmetic: returns (dk, dv) in bf16. With
    ``halves=2`` (``flash_bwd_dkv_sm90_d256.cu``) each half of d is
    accumulated on its own, from the same bf16 P^T and dS^T, as the two
    consumer warpgroups do."""
    b, sq, h, d = q.shape
    _, sk, kvh, _ = k.shape
    qf, dof = q.float(), do.float()
    kf = repeat_kv(k, h // kvh).float()
    vf = repeat_kv(v, h // kvh).float()
    delta = (dof * o.float()).sum(-1).transpose(1, 2)[..., None]
    t = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * (scale * LOG2E)
    p = torch.exp2(t - lse.reshape(b, h, sq, 1) * LOG2E)
    if causal:
        p = torch.where(_visible(sq, sk), p, 0.0)
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", dof, vf) - delta)
    pb, dsb = p.bfloat16().float(), ds.bfloat16().float()
    w = d // halves
    dv = torch.cat([torch.einsum("bhqk,bqhd->bkhd", pb, dof[..., i:i + w])
                    for i in range(0, d, w)], -1)
    dk = torch.cat([torch.einsum("bhqk,bqhd->bkhd", dsb, qf[..., i:i + w])
                    for i in range(0, d, w)], -1) * scale
    dk = dk.reshape(b, sk, kvh, h // kvh, d).sum(3)
    dv = dv.reshape(b, sk, kvh, h // kvh, d).sum(3)
    return dk.bfloat16(), dv.bfloat16()


def emulate_dq_sm90(q, k, v, o, lse, do, causal, scale):
    """The bf16 dQ kernels' arithmetic (``flash_bwd_dq_sm90.cu`` and, at
    d 256, ``flash_bwd_dq_sm90_d256.cu``): P in exp2 from lse * log2 e,
    dS rounded to bf16 before the dQ product; returns dq in bf16."""
    b, sq, h, d = q.shape
    _, sk, kvh, _ = k.shape
    qf, dof = q.float(), do.float()
    kf = repeat_kv(k, h // kvh).float()
    vf = repeat_kv(v, h // kvh).float()
    delta = (dof * o.float()).sum(-1).transpose(1, 2)[..., None]
    t = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * (scale * LOG2E)
    p = torch.exp2(t - lse.reshape(b, h, sq, 1) * LOG2E)
    if causal:
        p = torch.where(_visible(sq, sk), p, 0.0)
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", dof, vf) - delta)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.bfloat16().float(), kf) * scale
    return dq.bfloat16()


def _bf16_inputs(case, seed, cases=BF16_CASES):
    """Inputs as float32 numpy arrays whose values are bf16-exact."""
    b, sq, sk, h, kvh, d, _ = cases[case]
    rng = np.random.default_rng(seed)
    shapes = [(b, sq, h, d), (b, sk, kvh, d), (b, sk, kvh, d), (b, sq, h, d)]
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            .bfloat16().float().numpy() for s in shapes]


def _jbf16(a):
    return jnp.asarray(a).astype(jnp.bfloat16)


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor)
                      else jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("case", sorted(BF16_CASES))
def test_fwd_sm90_arithmetic_matches_pallas_interpret(case):
    q, k, v, _ = _bf16_inputs(case, seed=50)
    causal = BF16_CASES[case][-1]
    scale = 1.0 / math.sqrt(q.shape[-1])
    want_o, want_lse = jattn._flash_forward(
        _jbf16(q), _jbf16(k), _jbf16(v), causal, scale, 64, 64, True)
    got_o, got_lse = emulate_fwd_sm90(
        *(torch.from_numpy(a).bfloat16() for a in (q, k, v)), causal, scale)
    assert got_o.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(got_o), _f32(want_o), atol=2e-2,
                               rtol=2e-2)
    np.testing.assert_allclose(_f32(got_lse), _f32(want_lse)[..., 0],
                               atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("case", sorted(BF16_CASES))
def test_dkv_sm90_arithmetic_matches_pallas_interpret(case):
    q, k, v, g = _bf16_inputs(case, seed=60)
    causal = BF16_CASES[case][-1]
    scale = 1.0 / math.sqrt(q.shape[-1])
    jq, jk, jv, jg = map(_jbf16, (q, k, v, g))
    out, lse = jattn._flash_forward(jq, jk, jv, causal, scale, 64, 64, True)
    _, want_dk, want_dv = jattn._flash_backward(
        jq, jk, jv, out, lse, jg, causal, scale, 64, 64, True)
    tq, tk, tv, tg = (torch.from_numpy(a).bfloat16() for a in (q, k, v, g))
    to = torch.from_numpy(np.array(jnp.asarray(out, jnp.float32)))
    tlse = torch.from_numpy(np.array(lse)[..., 0])
    got_dk, got_dv = emulate_dkv_sm90(tq, tk, tv, to.bfloat16(), tlse, tg,
                                      causal, scale)
    for name, got, want in (("dk", got_dk, want_dk), ("dv", got_dv, want_dv)):
        assert tuple(got.shape) == want.shape, name
        np.testing.assert_allclose(_f32(got), _f32(want), atol=2e-2,
                                   rtol=2e-2, err_msg=name)


def _check_dq_sm90_against_pallas(cases, case, seed):
    q, k, v, g = _bf16_inputs(case, seed=seed, cases=cases)
    causal = cases[case][-1]
    scale = 1.0 / math.sqrt(q.shape[-1])
    jq, jk, jv, jg = map(_jbf16, (q, k, v, g))
    out, lse = jattn._flash_forward(jq, jk, jv, causal, scale, 64, 64, True)
    want_dq, _, _ = jattn._flash_backward(
        jq, jk, jv, out, lse, jg, causal, scale, 64, 64, True)
    tq, tk, tv, tg = (torch.from_numpy(a).bfloat16() for a in (q, k, v, g))
    to = torch.from_numpy(np.array(jnp.asarray(out, jnp.float32)))
    tlse = torch.from_numpy(np.array(lse)[..., 0])
    got_dq = emulate_dq_sm90(tq, tk, tv, to.bfloat16(), tlse, tg, causal,
                             scale)
    assert got_dq.dtype == torch.bfloat16
    assert tuple(got_dq.shape) == want_dq.shape
    np.testing.assert_allclose(_f32(got_dq), _f32(want_dq), atol=2e-2,
                               rtol=2e-2)


@pytest.mark.parametrize("case", sorted(BF16_CASES))
def test_dq_sm90_arithmetic_matches_pallas_interpret(case):
    _check_dq_sm90_against_pallas(BF16_CASES, case, seed=65)


# the head-dim-256 kernels' cases: (b, sq, sk, heads, kv_heads, d, causal)
D256_CASES = {
    "causal_128": (1, 128, 128, 2, 1, 256, True),
    "causal_256": (1, 256, 256, 2, 1, 256, True),
    "noncausal_256": (1, 256, 256, 2, 1, 256, False),
    "sq_lt_sk": (1, 128, 256, 2, 1, 256, True),
}


@pytest.mark.parametrize("case", sorted(D256_CASES))
def test_fwd_sm90_d256_arithmetic_matches_pallas_interpret(case):
    """``flash_fwd_sm90_d256.cu``'s arithmetic: 64-key tiles."""
    q, k, v, _ = _bf16_inputs(case, seed=52, cases=D256_CASES)
    causal = D256_CASES[case][-1]
    scale = 1.0 / math.sqrt(q.shape[-1])
    want_o, want_lse = jattn._flash_forward(
        _jbf16(q), _jbf16(k), _jbf16(v), causal, scale, 64, 64, True)
    got_o, got_lse = emulate_fwd_sm90(
        *(torch.from_numpy(a).bfloat16() for a in (q, k, v)), causal, scale,
        tile=64)
    assert got_o.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(got_o), _f32(want_o), atol=2e-2,
                               rtol=2e-2)
    np.testing.assert_allclose(_f32(got_lse), _f32(want_lse)[..., 0],
                               atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("case", sorted(D256_CASES))
def test_dkv_sm90_d256_arithmetic_matches_pallas_interpret(case):
    """``flash_bwd_dkv_sm90_d256.cu``'s arithmetic: P^T and dS^T rounded
    to bf16, each half of d accumulated on its own."""
    q, k, v, g = _bf16_inputs(case, seed=62, cases=D256_CASES)
    causal = D256_CASES[case][-1]
    scale = 1.0 / math.sqrt(q.shape[-1])
    jq, jk, jv, jg = map(_jbf16, (q, k, v, g))
    out, lse = jattn._flash_forward(jq, jk, jv, causal, scale, 64, 64, True)
    _, want_dk, want_dv = jattn._flash_backward(
        jq, jk, jv, out, lse, jg, causal, scale, 64, 64, True)
    tq, tk, tv, tg = (torch.from_numpy(a).bfloat16() for a in (q, k, v, g))
    to = torch.from_numpy(np.array(jnp.asarray(out, jnp.float32)))
    tlse = torch.from_numpy(np.array(lse)[..., 0])
    got_dk, got_dv = emulate_dkv_sm90(tq, tk, tv, to.bfloat16(), tlse, tg,
                                      causal, scale, halves=2)
    for name, got, want in (("dk", got_dk, want_dk), ("dv", got_dv, want_dv)):
        assert tuple(got.shape) == want.shape, name
        np.testing.assert_allclose(_f32(got), _f32(want), atol=2e-2,
                                   rtol=2e-2, err_msg=name)


@pytest.mark.parametrize("case", sorted(D256_CASES))
def test_dq_sm90_d256_arithmetic_matches_pallas_interpret(case):
    """``flash_bwd_dq_sm90_d256.cu``'s arithmetic: dS rounded to bf16 per
    element, dQ accumulated in fp32; its 32-key tiles and its two halves
    of d change only the order of the fp32 sums, so the emulation is the
    d-128 kernel's."""
    _check_dq_sm90_against_pallas(D256_CASES, case, seed=67)


@pytest.mark.parametrize("case", sorted(BF16_CASES))
def test_sm90_emulation_rounds_p_to_bf16(case):
    """The emulated forward differs from the fp32 plain version only by
    the bf16 rounding of P and O, not by more."""
    q, k, v, _ = _bf16_inputs(case, seed=70)
    causal = BF16_CASES[case][-1]
    scale = 1.0 / math.sqrt(q.shape[-1])
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    emu_o, emu_lse = emulate_fwd_sm90(tq.bfloat16(), tk.bfloat16(),
                                      tv.bfloat16(), causal, scale)
    plain_o, plain_lse = tattn.flash_forward_plain(tq, tk, tv, causal, scale)
    np.testing.assert_allclose(_f32(emu_lse), _f32(plain_lse), atol=1e-5)
    diff = (emu_o.float() - plain_o).abs().max().item()
    assert 0.0 < diff <= 2e-2


# ------------------------------------------------------ split-K paged


def emulate_paged_split(q, k_pages, v_pages, block_table, ctx_len, scale,
                        pps):
    """The split-K paged kernel's arithmetic in fp32: each run of ``pps``
    pages below ceil(ctx/page) gives a partial (acc_i, m_i, l_i) with its
    own max; the partials merge in split order. Returns (acc, m, l)."""
    S, KVH, G, hd = q.shape
    P, _, page, _ = k_pages.shape
    maxp = block_table.shape[1]
    ids = tpaged.clamp_page_ids(block_table, P)
    acc = torch.zeros(S, KVH, G, hd)
    m = torch.full((S, KVH, G), -1e30)
    l = torch.zeros(S, KVH, G)
    for s in range(S):
        ctx = int(ctx_len[s])
        n_pages = min(-(-ctx // page), maxp)
        parts = []
        for p0 in range(0, n_pages, pps):
            pages = ids[s, p0:min(p0 + pps, n_pages)]
            keys = k_pages[pages].float().movedim(1, 0).reshape(KVH, -1, hd)
            vals = v_pages[pages].float().movedim(1, 0).reshape(KVH, -1, hd)
            n = min(ctx, (p0 + len(pages)) * page) - p0 * page
            t = torch.einsum("kgd,ktd->kgt", q[s].float() * scale,
                             keys[:, :n])
            m_i = t.amax(-1)
            p_i = torch.exp(t - m_i[..., None])
            parts.append((torch.einsum("kgt,ktd->kgd", p_i, vals[:, :n]),
                          m_i, p_i.sum(-1)))
        if not parts:
            continue
        m[s] = torch.stack([m_i for _, m_i, _ in parts]).amax(0)
        for a_i, m_i, l_i in parts:
            f = torch.exp(m_i - m[s])
            acc[s] += a_i * f[..., None]
            l[s] += l_i * f
    return acc, m, l


def _split_case(seed, page=16, maxp=6, P=40):
    """Contexts 0, 1, a run of two pages exactly and the full table; one
    table entry below ctx lies past the pool, entries past ctx hold ids no
    kernel may read."""
    rng = np.random.default_rng(seed)
    S, KVH, G, hd = 4, 2, 4, 32
    ctx = np.array([0, 1, 2 * page, maxp * page], np.int32)
    q = rng.standard_normal((S, KVH, G, hd)).astype(np.float32)
    kp = rng.standard_normal((P, KVH, page, hd)).astype(np.float32)
    vp = rng.standard_normal((P, KVH, page, hd)).astype(np.float32)
    bt = rng.integers(0, P, (S, maxp)).astype(np.int32)
    for s, c in enumerate(ctx):
        bt[s, -(-c // page):] = 10_000 + s
    bt[3, 4] = P + 3          # below ctx: read as page P - 1 by both sides
    return q, kp, vp, bt, ctx


@pytest.mark.parametrize("pps", [1, 2, 3])
def test_paged_split_emulation_matches_pallas_interpret(pps):
    q, kp, vp, bt, ctx = _split_case(seed=80 + pps)
    scale = 1.0 / math.sqrt(q.shape[-1])
    with jax.default_matmul_precision("highest"):
        want = jpaged.paged_attention(
            *map(jnp.asarray, (q, kp, vp, bt, ctx)), interpret=True)
    got = emulate_paged_split(*map(torch.from_numpy, (q, kp, vp, bt, ctx)),
                              scale, pps)
    for name, g, w in zip(("acc", "m", "l"), got, want):
        np.testing.assert_allclose(_f32(g), _f32(w), atol=1e-5, rtol=1e-5,
                                   err_msg=name)
    # the ctx-0 slot's triple is exact
    assert float(got[0][0].abs().max()) == 0.0
    assert float(got[2][0].max()) == 0.0
    assert bool((got[1][0] == -1e30).all())


@pytest.mark.parametrize("slots,kv_heads,maxp,want", [
    (8, 8, 16, (1, 16)),      # the serving shape: one page a block
    (5, 8, 64, (3, 22)),      # chip_smoke.py's split-boundary pool
    (1, 1, 4, (1, 4)),
    (512, 8, 16, (16, 1)),    # enough slots: one walk per (slot, head)
])
def test_split_pages_covers_the_table(slots, kv_heads, maxp, want):
    pps, n_split = tpaged.split_pages(slots, kv_heads, maxp)
    assert (pps, n_split) == want
    assert (n_split - 1) * pps < maxp <= n_split * pps


@pytest.mark.parametrize("hd,group,page,ok", [
    (128, 4, 64, True), (64, 1, 16, True), (128, 8, 32, True),
    (96, 4, 64, False), (128, 3, 64, True), (128, 4, 8, False),
    (128, 7, 64, True), (256, 1, 64, True), (256, 8, 64, True),
    (128, 9, 64, False), (256, 4, 8, False),
    (16, 2, 64, True), (32, 2, 64, True), (16, 8, 16, True),
    (32, 1, 64, True), (48, 2, 64, False), (8, 2, 64, False),
])
def test_paged_kernel_shapes(hd, group, page, ok):
    """On the card the wrapper raises before any launch for a head dim,
    group size or page size the kernel is not built for (the CPU's plain
    version takes any)."""
    if ok:
        tpaged.check_kernel_shape(hd, group, page)
    else:
        with pytest.raises(ValueError, match="not supported on the card"):
            tpaged.check_kernel_shape(hd, group, page)


# ------------------------------------------------------------- convert


def test_params_from_numpy_defaults_to_the_card():
    tree = {"w": np.ones((2, 3), np.float32),
            "layer": {"q": np.ones(4, np.int8)}}
    if torch.cuda.is_available():
        assert params_from_numpy(tree)["w"].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            params_from_numpy(tree)
    got = params_from_numpy(tree, device="cpu")
    assert got["w"].device.type == "cpu" and got["w"].dtype == torch.float32
    assert got["layer"]["q"].device.type == "cpu"
    assert got["layer"]["q"].dtype == torch.int8
