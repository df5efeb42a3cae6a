"""The port's kernel plumbing and the arithmetic of its bf16 Hopper kernels,
on the CPU.

- Every ``extern "C"`` entry point in ``ray_tpu_torch/csrc/*.cu`` has a
  ctypes signature in ``_build._SIGNATURES`` with the same arguments
  (pointers as ``c_void_p``): a mismatch would cut a pointer silently on
  the card.
- ``flash_route`` sends each (dtype, head dim, device) to the wgmma
  kernels, the scalar kernels, the plain versions, or a ``ValueError``.
- The bf16 forward and dK/dV kernels (``csrc/flash_fwd_sm90.cu``,
  ``csrc/flash_bwd_dkv_sm90.cu``) emulated in plain torch: fp32 products
  of bf16 inputs, the scale applied to S in fp32 through exp2, 128-key
  tiles of online softmax in the forward, and P (and dS) rounded to bf16
  before the second products. The emulation agrees with the Pallas
  kernels in interpret mode on the same bf16 inputs within 2e-2 (atol
  and rtol): the tolerance the card holds the kernels to (chip_smoke.py
  phase 1).
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
from ray_tpu_torch.models.convert import params_from_numpy  # noqa: E402
from ray_tpu_torch.ops import _build  # noqa: E402
from ray_tpu_torch.ops import attention as tattn  # noqa: E402
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
    (torch.float32, 128, "cuda", "scalar"),
    (torch.float32, 64, "cuda", "scalar"),
    (torch.bfloat16, 128, "cpu", "plain"),
    (torch.float32, 32, "cpu", "plain"),
    (torch.float16, 96, "cpu", "plain"),
    (torch.float16, 128, "cuda", None),
    (torch.bfloat16, 96, "cuda", None),
    (torch.float32, 256, "cuda", None),
    (torch.bfloat16, 128, "meta", None),
]


@pytest.mark.parametrize("dtype,d,device,route", _ROUTES)
def test_flash_route(dtype, d, device, route):
    if route is None:
        with pytest.raises(ValueError):
            tattn.flash_route(dtype, d, device)
    else:
        assert tattn.flash_route(dtype, d, device) == route


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


def emulate_fwd_sm90(q, k, v, causal, scale):
    """The bf16 forward kernel's arithmetic on bf16 q [b, sq, H, d] and
    k, v [b, sk, KVH, d]: returns (O bf16, lse fp32 [b*H, sq])."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    qf = q.float()
    kf = repeat_kv(k, h // k.shape[2]).float()
    vf = repeat_kv(v, h // k.shape[2]).float()
    vis = _visible(sq, sk)
    m = torch.full((b, h, sq, 1), -1e30)
    l = torch.zeros(b, h, sq, 1)
    acc = torch.zeros(b, h, sq, d)
    for k0 in range(0, sk, TILE):
        t = torch.einsum("bqhd,bkhd->bhqk", qf, kf[:, k0:k0 + TILE])
        t = t * (scale * LOG2E)
        if causal:
            t = torch.where(vis[:, k0:k0 + TILE], t, -1e30)
        m_new = torch.maximum(m, t.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(t - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.einsum(
            "bhqk,bkhd->bhqd", p.bfloat16().float(), vf[:, k0:k0 + TILE])
        m = m_new
    l_safe = l.clamp_min(1e-30)
    out = (acc / l_safe).transpose(1, 2).bfloat16()
    lse = ((m + torch.log2(l_safe)) * LN2).reshape(b * h, sq)
    return out, lse


def emulate_dkv_sm90(q, k, v, o, lse, do, causal, scale):
    """The bf16 dK/dV kernel's arithmetic: returns (dk, dv) in bf16."""
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
    dv = torch.einsum("bhqk,bqhd->bkhd", p.bfloat16().float(), dof)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.bfloat16().float(), qf) * scale
    dk = dk.reshape(b, sk, kvh, h // kvh, d).sum(3)
    dv = dv.reshape(b, sk, kvh, h // kvh, d).sum(3)
    return dk.bfloat16(), dv.bfloat16()


def _bf16_inputs(case, seed):
    """Inputs as float32 numpy arrays whose values are bf16-exact."""
    b, sq, sk, h, kvh, d, _ = BF16_CASES[case]
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
