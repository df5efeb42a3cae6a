"""The 3xTF32 arithmetic of the port's fp32 attention kernels, on the CPU.

``csrc/flash_fwd_tf32x3.cu``, ``csrc/flash_bwd_dq_tf32x3.cu`` and
``csrc/flash_bwd_dkv_tf32x3.cu`` run their fp32 products on the tensor
cores (mma.sync m16n8k8 in TF32): each
operand is split into ``hi = tf32(x)`` (rounded as cvt.rna does: 10
explicit mantissa bits, ties away from zero) and ``lo = x - hi``, which
the tensor core truncates to TF32, and ``hi*lo + lo*hi + hi*hi`` is
summed into one fp32 accumulator, 8 reduction steps at a time. This file
emulates that product in plain torch and shows, on inputs made with numpy
from a seed:

- at d 16 to 256, 3xTF32's error against a float64 product is within 4x
  fp32 matmul's own, while one TF32 product's is above 1e-4 of the
  result's largest entry (above the 1e-4 the card holds fp32 to);
- a blocked flash forward, dQ and dK/dV written with that product, in
  the kernels' tile order (64-key tiles at d <= 64, else 32, in the
  forward; 64-key tiles at d <= 32, 32 at d 64, else 16, in dQ, its
  accumulator restarted and added into dQ every 512 keys; 64-row query
  tiles, 32 at d 256, over the GQA group in dK/dV), match ``ray_tpu.ops.attention``'s
  Pallas kernels in interpret mode at the reference's fp32 tolerance of
  2e-5, causal and not, at G 1, 4 and 7 (and dQ over 640 keys, past a
  restart); the same blocks with one TF32 product do not.
"""

import math

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from ray_tpu.ops import attention as jattn  # noqa: E402
from ray_tpu_torch.ops.layers import repeat_kv  # noqa: E402

torch.set_num_threads(1)

TOL = 2e-5     # the reference's fp32 attention tolerance
STEP = 8       # the reduction depth of one m16n8k8 product


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32).to(torch.int64)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to TF32 as cvt.rna.tf32.f32 rounds: to nearest, ties
    away from zero, keeping 10 explicit mantissa bits (the low 13 bits of
    the pattern cleared; adding half of their weight to the sign-magnitude
    pattern rounds the magnitude half up)."""
    return ((_bits(x) + 0x1000) & ~0x1FFF).to(torch.int32).view(torch.float32)


def tf32_truncated(x: torch.Tensor) -> torch.Tensor:
    """fp32 as the tensor core reads a TF32 operand: the low 13 bits of the
    pattern dropped."""
    return (_bits(x) & ~0x1FFF).to(torch.int32).view(torch.float32)


def mm3(a, b, acc=None):
    """``acc + a @ b`` in 3xTF32, 8 reduction steps at a time: each step
    adds hi(a) lo(b), then lo(a) hi(b), then hi(a) hi(b)."""
    a_hi, b_hi = tf32(a), tf32(b)
    a_lo, b_lo = tf32_truncated(a - a_hi), tf32_truncated(b - b_hi)
    out = acc if acc is not None else a.new_zeros(
        (*a.shape[:-1], b.shape[-1]))
    for k0 in range(0, a.shape[-1], STEP):
        ks = slice(k0, k0 + STEP)
        out = out + a_hi[..., ks] @ b_lo[..., ks, :]
        out = out + a_lo[..., ks] @ b_hi[..., ks, :]
        out = out + a_hi[..., ks] @ b_hi[..., ks, :]
    return out


def mm1(a, b, acc=None):
    """``acc + a @ b`` with one TF32 product a step."""
    a1, b1 = tf32(a), tf32(b)
    out = acc if acc is not None else a.new_zeros(
        (*a.shape[:-1], b.shape[-1]))
    for k0 in range(0, a.shape[-1], STEP):
        ks = slice(k0, k0 + STEP)
        out = out + a1[..., ks] @ b1[..., ks, :]
    return out


def test_tf32_rounds_to_nearest_ties_away():
    one = 1.0
    ulp = 2.0 ** -10            # TF32's spacing at 1
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 2 * 0.99,
                      one + ulp * 1.5, 3.0e-39], dtype=torch.float32)
    want = [one + ulp, -(one + ulp), one, one + 2 * ulp]
    assert tf32(x)[:4].tolist() == want
    assert (tf32(x).view(torch.int32) & 0x1FFF == 0).all()
    assert tf32_truncated(x)[:4].tolist() == [one, -one, one, one + ulp]


@pytest.mark.parametrize("d", [16, 32, 64, 128, 256])
def test_3xtf32_product_is_as_exact_as_fp32(d):
    rng = np.random.default_rng(d)
    a = torch.from_numpy(rng.standard_normal((256, d)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((d, 256)).astype(np.float32))
    ref = a.double() @ b.double()
    top = float(ref.abs().max())

    def err(x):
        return float((x.double() - ref).abs().max()) / top

    fp32, three, one = err(a @ b), err(mm3(a, b)), err(mm1(a, b))
    assert three <= 4 * fp32, (three, fp32)
    assert one > 1e-4, one


# (b, s, heads, kv heads, d): G 1, 4 and 7; d 64 and 16 take 64-key tiles
# in the forward, d 128 32-key ones
CASES = {
    "g1_d64": (1, 128, 2, 2, 64),
    "g4_d128": (1, 128, 4, 1, 128),
    "g7_d16": (2, 128, 7, 1, 16),
}


# dQ's cases add 640 keys: its accumulator restarts after 512
DQ_CASES = dict(CASES, g4_d16_long=(1, 640, 4, 1, 16))


def _inputs(case, seed):
    b, s, h, kvh, d = DQ_CASES[case]
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, s, h, d), (b, s, kvh, d), (b, s, kvh, d),
                          (b, s, h, d))]


def emulate_fwd(q, k, v, causal, scale, mm):
    """``flash_fwd_tf32x3.cu``'s arithmetic: q scaled first, K/V tiles of
    64 keys (d <= 64) or 32, an online softmax in fp32 with masked scores
    at -1e30, O = acc / max(l, 1e-30); returns (O [b, sq, H, d], lse
    [b*H, sq])."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    bk = 64 if d <= 64 else 32
    qf = (q * scale).transpose(1, 2)
    kf = repeat_kv(k, h // k.shape[2]).transpose(1, 2)
    vf = repeat_kv(v, h // k.shape[2]).transpose(1, 2)
    pos = torch.arange(sq)[:, None] + (sk - sq)
    m = torch.full((b, h, sq, 1), -1e30)
    l = torch.zeros(b, h, sq, 1)
    acc = torch.zeros(b, h, sq, d)
    for k0 in range(0, sk, bk):
        s = mm(qf, kf[:, :, k0:k0 + bk].transpose(-1, -2))
        if causal:
            s = torch.where(pos >= torch.arange(k0, k0 + s.shape[-1]), s,
                            -1e30)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = mm(p, vf[:, :, k0:k0 + bk], acc * alpha)
        m = m_new
    l_safe = l.clamp_min(1e-30)
    out = (acc / l_safe).transpose(1, 2)
    return out, (m + torch.log(l_safe)).reshape(b * h, sq)


def emulate_dkv(q, k, v, o, lse, do, causal, scale, mm):
    """``flash_bwd_dkv_tf32x3.cu``'s arithmetic: for each key, the query
    heads of its GQA group in turn and query tiles in order (64 rows, 32
    at d 256), S^T =
    K Q^T and dP^T = V dO^T, P^T = exp(S^T * scale - lse) (masked at
    -1e30), dS^T = P^T (dP^T - delta); dV += P^T dO, dK += dS^T Q, dK
    scaled at the end. Returns (dK, dV) [b, sk, KVH, d]."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    grp = h // kvh
    bq = 64 if d <= 128 else 32
    delta = (do * o).sum(-1)                        # [b, sq, h]
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)   # [b, kvh, sk, d]
    lse = lse.reshape(b, h, sq)
    visible = (torch.arange(sq)[None, :] + (sk - sq)
               >= torch.arange(sk)[:, None])        # [sk, sq]
    dk = torch.zeros(b, kvh, sk, d)
    dv = torch.zeros(b, kvh, sk, d)
    for g in range(grp):          # query head kv * grp + g
        qg = q[:, :, g::grp].transpose(1, 2)
        dog = do[:, :, g::grp].transpose(1, 2)
        lse_g, delta_g = lse[:, g::grp], delta[:, :, g::grp].transpose(1, 2)
        for q0 in range(0, sq, bq):
            rows = slice(q0, q0 + bq)
            x = mm(kt, qg[:, :, rows].transpose(-1, -2)) * scale
            dpt = mm(vt, dog[:, :, rows].transpose(-1, -2))
            if causal:
                x = torch.where(visible[:, rows], x, -1e30)
            p = torch.exp(x - lse_g[:, :, None, rows])
            ds = p * (dpt - delta_g[:, :, None, rows])
            dv = mm(p, dog[:, :, rows], dv)
            dk = mm(ds, qg[:, :, rows], dk)
    return (dk * scale).transpose(1, 2), dv.transpose(1, 2)


def emulate_dq(q, k, v, o, lse, do, causal, scale, mm):
    """``flash_bwd_dq_tf32x3.cu``'s arithmetic: q scaled first, K/V tiles
    of 64 keys (d <= 32), 32 (d 64) or 16, S = Q K^T and dP = dO V^T,
    P = exp(S - lse) (masked at -1e30), dS = P (dP - delta); dQ += dS K
    into an accumulator that is restarted every 512 keys after being
    added, times the scale, into dQ in fp32. (At d 256 the kernel sums S and dP over
    the two halves of d in two warps; the cases here stop at d 128.)
    Returns dQ [b, sq, H, d]."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    bk = 64 if d <= 32 else 32 if d == 64 else 16
    flush = 512
    qf = (q * scale).transpose(1, 2)
    dof = do.transpose(1, 2)
    kf = repeat_kv(k, h // k.shape[2]).transpose(1, 2)
    vf = repeat_kv(v, h // k.shape[2]).transpose(1, 2)
    lse = lse.reshape(b, h, sq, 1)
    delta = (do * o).sum(-1).transpose(1, 2)[..., None]   # [b, h, sq, 1]
    pos = torch.arange(sq)[:, None] + (sk - sq)
    dq = torch.zeros(b, h, sq, d)
    acc = torch.zeros(b, h, sq, d)
    for k0 in range(0, sk, bk):
        keys = slice(k0, k0 + bk)
        s = mm(qf, kf[:, :, keys].transpose(-1, -2))
        if causal:
            s = torch.where(pos >= torch.arange(k0, k0 + s.shape[-1]), s,
                            -1e30)
        p = torch.exp(s - lse)
        ds = p * (mm(dof, vf[:, :, keys].transpose(-1, -2)) - delta)
        acc = mm(ds, kf[:, :, keys], acc)
        if (k0 + bk) % flush == 0 or k0 + bk >= sk:
            dq = dq + acc * scale
            acc = torch.zeros_like(acc)
    return dq.transpose(1, 2)


def _np(x):
    return np.asarray(x, dtype=np.float32)


def _worst(got, want):
    return max(float(np.abs(_np(g) - _np(w)).max()) for g, w in zip(got, want))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("case", sorted(CASES))
def test_fwd_tf32x3_matches_pallas_interpret(case, causal):
    q, k, v, _ = _inputs(case, seed=70)
    scale = 1.0 / math.sqrt(q.shape[-1])
    want_o, want_lse = jattn._flash_forward(
        *map(jnp.asarray, (q, k, v)), causal, scale, 64, 64, True)
    want = (want_o, _np(want_lse)[..., 0])
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = emulate_fwd(tq, tk, tv, causal, scale, mm3)
    for name, g, w in zip(("O", "lse"), got, want):
        np.testing.assert_allclose(_np(g), _np(w), atol=TOL, rtol=TOL,
                                   err_msg=name)
    one = emulate_fwd(tq, tk, tv, causal, scale, mm1)
    assert _worst(one, want) > TOL


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("case", sorted(CASES))
def test_dkv_tf32x3_matches_pallas_interpret(case, causal):
    q, k, v, g = _inputs(case, seed=71)
    scale = 1.0 / math.sqrt(q.shape[-1])
    jq, jk, jv, jg = map(jnp.asarray, (q, k, v, g))
    out, lse = jattn._flash_forward(jq, jk, jv, causal, scale, 64, 64, True)
    _, want_dk, want_dv = jattn._flash_backward(
        jq, jk, jv, out, lse, jg, causal, scale, 64, 64, True)
    args = (*map(torch.from_numpy, (q, k, v, _np(out))),
            torch.from_numpy(_np(lse)[..., 0]), torch.from_numpy(g))
    got = emulate_dkv(*args, causal, scale, mm3)
    for name, gt, w in zip(("dk", "dv"), got, (want_dk, want_dv)):
        assert tuple(gt.shape) == w.shape, name
        np.testing.assert_allclose(_np(gt), _np(w), atol=TOL, rtol=TOL,
                                   err_msg=name)
    one = emulate_dkv(*args, causal, scale, mm1)
    assert _worst(one, (want_dk, want_dv)) > TOL


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("case", sorted(DQ_CASES))
def test_dq_tf32x3_matches_pallas_interpret(case, causal):
    q, k, v, g = _inputs(case, seed=72)
    scale = 1.0 / math.sqrt(q.shape[-1])
    jq, jk, jv, jg = map(jnp.asarray, (q, k, v, g))
    out, lse = jattn._flash_forward(jq, jk, jv, causal, scale, 64, 64, True)
    want, _, _ = jattn._flash_backward(
        jq, jk, jv, out, lse, jg, causal, scale, 64, 64, True)
    args = (*map(torch.from_numpy, (q, k, v, _np(out))),
            torch.from_numpy(_np(lse)[..., 0]), torch.from_numpy(g))
    got = emulate_dq(*args, causal, scale, mm3)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(_np(got), _np(want), atol=TOL, rtol=TOL)
    one = emulate_dq(*args, causal, scale, mm1)
    assert _worst((one,), (want,)) > TOL
