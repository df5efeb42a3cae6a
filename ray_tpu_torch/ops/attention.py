"""Attention: the plain reference and the flash-attention kernels.

Counterpart of ``ray_tpu/ops/attention.py``. Two wrappers, each of which
launches its CUDA kernels on CUDA tensors and runs its plain PyTorch
version on CPU tensors. There is no other route and no fallback: a CUDA
tensor the kernels cannot take raises.

- ``flash_forward``: kernel 1 (replaces the Pallas ``_flash_kernel``),
  returning O and the fp32 row logsumexp.
- ``flash_backward``: kernels 3 and 4 (replace ``_flash_bwd_dq_kernel``
  and ``_flash_bwd_dkv_kernel``), recomputing the probabilities from that
  logsumexp.

``flash_route`` picks each kernel from the inputs' device, dtype and
head dim. bf16 on the card takes the Hopper kernels that run wgmma on
bf16 tiles fed by TMA: at head dim 64 or 128 all three
(``csrc/flash_fwd_sm90.cu``, ``csrc/flash_bwd_dq_sm90.cu``,
``csrc/flash_bwd_dkv_sm90.cu``); at head dim 256 (Gemma) all three
too (``csrc/flash_fwd_sm90_d256.cu``, ``csrc/flash_bwd_dq_sm90_d256.cu``,
``csrc/flash_bwd_dkv_sm90_d256.cu``). fp32 on the card takes, for all
three, the kernels that run mma.sync in 3xTF32 (each operand split into
two TF32 halves, three products summed in fp32: within a few ulps of an
fp32 product; ``csrc/flash_fwd_tf32x3.cu``,
``csrc/flash_bwd_dq_tf32x3.cu``, ``csrc/flash_bwd_dkv_tf32x3.cu``). bf16
at head dim 16 and 32 (the tiny presets' widths, below a wgmma tile's
64-column box) takes the scalar kernels (``csrc/flash_fwd.cu``,
``csrc/flash_bwd.cu``), bf16 as storage with fp32 arithmetic.

``flash_attention`` is the ``torch.autograd.Function`` over the two, the
counterpart of the reference's ``custom_vjp``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ray_tpu_torch.ops.layers import repeat_kv

DEFAULT_BLOCK_Q = 512
DEFAULT_BLOCK_K = 512
_NEG_INF = -1e30


def _auto_block(seq: int, target: int) -> int:
    """Largest power-of-two block <= target dividing seq (floor 128), the
    reference's block rule; here it only decides which lengths
    ``_check_blocks`` accepts. The CUDA kernel tiles by 64 and masks
    ragged edges itself."""
    c = target
    while c > 128:
        if seq % c == 0:
            return c
        c //= 2
    return c


def _check_blocks(sq: int, sk: int, block_q: int, block_k: int):
    block_q = min(block_q, sq)
    block_k = min(block_k, sk)
    if sq % block_q or sk % block_k:
        raise ValueError(
            f"seq lengths ({sq}, {sk}) must be divisible by blocks "
            f"({block_q}, {block_k}); pad inputs first")
    return block_q, block_k


def _causal_mask(sq: int, sk: int, device) -> torch.Tensor:
    """[sq, sk] visibility with query row i at key position sk - sq + i."""
    qi = torch.arange(sq, device=device)[:, None]
    ki = torch.arange(sk, device=device)[None, :]
    return qi + (sk - sq) >= ki


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True,
                        sm_scale: Optional[float] = None) -> torch.Tensor:
    """Plain softmax attention, fp32 scores and softmax, GQA-aware.

    q [b, sq, H, d]; k, v [b, sk, KVH, d] -> [b, sq, H, d] in q's dtype.
    """
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    n_rep = q.shape[2] // k.shape[2]
    k = repeat_kv(k, n_rep)
    v = repeat_kv(v, n_rep)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * sm_scale
    if causal:
        mask = _causal_mask(scores.shape[-2], scores.shape[-1], q.device)
        scores = torch.where(mask, scores, _NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).float(),
                       v.float())
    return out.to(q.dtype)


def flash_forward_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True,
                        sm_scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """What the flash kernel computes, in plain PyTorch and fp32: the
    scale applied to q, masked scores at -1e30, probabilities kept in
    fp32 for the value product. Returns (O in q's dtype, lse f32
    [b*H, sq])."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    b, sq, h, d = q.shape
    n_rep = h // k.shape[2]
    kf = repeat_kv(k, n_rep).float()
    vf = repeat_kv(v, n_rep).float()
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * sm_scale, kf)
    if causal:
        s = torch.where(_causal_mask(sq, k.shape[1], q.device), s, _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l_safe = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhqk,bkhd->bqhd", p / l_safe, vf)
    lse = (m + torch.log(l_safe))[..., 0].reshape(b * h, sq)
    return out.to(q.dtype), lse


# the three kernels, and the dtypes and head dims they take on the card:
# fp32 runs all three in 3xTF32 at every head dim, bf16 the wgmma kernels
# at _SM90_HEAD_DIMS and the scalar ones below
_KERNELS = ("fwd", "dq", "dkv")
_CARD_DTYPES = (torch.float32, torch.bfloat16)
_HEAD_DIMS = (16, 32, 64, 128, 256)
_SM90_HEAD_DIMS = (64, 128, 256)


def flash_route(dtype: torch.dtype, head_dim: int, device,
                kernel: str = "fwd") -> str:
    """Which kernel computes ``kernel`` (``"fwd"``, ``"dq"`` or
    ``"dkv"``) for inputs of this dtype, head dim and device: ``"sm90"``
    (bf16 on the card at head dim 64, 128 or 256: the wgmma kernels),
    ``"tf32x3"`` (fp32 on the card at head dim 16, 32, 64, 128 or 256,
    all three kernels: 3xTF32 on the tensor cores), ``"scalar"`` (bf16
    on the card at head dim 16 and 32: the scalar kernels, fp32
    arithmetic), ``"plain"`` (the CPU: the plain PyTorch versions, any
    dtype and head dim). Anything else raises ``ValueError``: there is
    no fallback."""
    if kernel not in _KERNELS:
        raise ValueError(f"flash attention: unknown kernel {kernel!r} "
                         "(fwd, dq or dkv)")
    kind = torch.device(device).type
    if kind == "cpu":
        return "plain"
    if kind != "cuda":
        raise ValueError(f"flash attention: unsupported device {device}")
    if head_dim not in _HEAD_DIMS:
        raise ValueError(f"flash attention: head_dim {head_dim} not "
                         f"supported on the card {_HEAD_DIMS}")
    if dtype not in _CARD_DTYPES:
        raise ValueError(f"flash attention: dtype {dtype} not supported on "
                         "the card (float32 or bfloat16)")
    if dtype == torch.bfloat16 and head_dim in _SM90_HEAD_DIMS:
        return "sm90"
    if dtype == torch.float32:
        return "tf32x3"
    return "scalar"


def _check_cuda(name: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    dtype = tensors[0].dtype
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: inputs on different devices")
        if t.dtype != dtype:
            raise ValueError(f"{name}: inputs of different dtypes")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
        if t.data_ptr() % 16:
            # the kernels copy 16-byte chunks (TMA, cp.async, vector loads)
            raise ValueError(f"{name}: inputs must be 16-byte aligned")


def flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, sm_scale: Optional[float] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel 1's wrapper: (O [b, sq, H, d] in q's dtype, lse f32
    [b*H, sq]). The route is ``flash_route``'s: CPU tensors take
    ``flash_forward_plain``; CUDA tensors (contiguous) launch
    ``csrc/flash_fwd_sm90.cu`` or, at head dim 256,
    ``csrc/flash_fwd_sm90_d256.cu`` (route ``"sm90"``),
    ``csrc/flash_fwd_tf32x3.cu`` (route ``"tf32x3"``) or
    ``csrc/flash_fwd.cu`` (route ``"scalar"``) on the current stream, or
    raise."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    b, sq, h, d = q.shape
    _, sk, kvh, _ = k.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"flash_forward: shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    if h % kvh:
        raise ValueError(f"flash_forward: {h} heads not a multiple of "
                         f"{kvh} kv heads")
    route = flash_route(q.dtype, d, q.device)
    if route == "plain":
        return flash_forward_plain(q, k, v, causal, sm_scale)
    _check_cuda("flash_forward", q, k, v)
    from ray_tpu_torch.ops import _build

    lib = _build.load()
    out = torch.empty_like(q)
    lse = torch.empty((b * h, sq), dtype=torch.float32, device=q.device)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr())
    shape = (b, sq, sk, h, kvh)
    flags = (int(bool(causal)), float(sm_scale))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if route == "sm90" and d == 256:
            err = lib.rtt_flash_fwd_sm90_d256(*ptrs, *shape, *flags, stream)
        elif route == "sm90":
            err = lib.rtt_flash_fwd_sm90(*ptrs, *shape, d, *flags, stream)
        elif route == "tf32x3":
            err = lib.rtt_flash_fwd_tf32x3(*ptrs, *shape, d, *flags, stream)
        else:
            err = lib.rtt_flash_fwd(*ptrs, *shape, d, *flags, stream)
    _build.check(lib, err, f"flash_forward {route} kernel")
    flash_forward.launches += 1
    if route == "sm90":
        flash_forward.sm90_launches += 1
    elif route == "tf32x3":
        flash_forward.tf32x3_launches += 1
    return out, lse


# kernel launches, for chip_smoke.py: all routes, the bf16 wgmma route and
# the fp32 3xTF32 route (the scalar route's are the rest)
flash_forward.launches = 0
flash_forward.sm90_launches = 0
flash_forward.tf32x3_launches = 0


def flash_backward_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         o: torch.Tensor, lse: torch.Tensor,
                         do: torch.Tensor, causal: bool = True,
                         sm_scale: Optional[float] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """What the two backward kernels compute, in plain PyTorch and fp32:
    ``delta = rowsum(dO * O)``; ``P = exp(S * scale - lse)`` with masked
    scores at -1e30 under the causal offset; ``dS = P * (dO V^T -
    delta)``; ``dq = scale * dS K``, ``dk = scale * dS^T Q`` and ``dv =
    P^T dO``, the last two summed over each GQA group. Returns (dq, dk,
    dv) in q's, k's and v's dtypes."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    b, sq, h, d = q.shape
    _, sk, kvh, _ = k.shape
    n_rep = h // kvh
    qf, dof = q.float(), do.float()
    kf = repeat_kv(k, n_rep).float()
    vf = repeat_kv(v, n_rep).float()
    delta = (dof * o.float()).sum(-1).transpose(1, 2)[..., None]
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * sm_scale
    if causal:
        s = torch.where(_causal_mask(sq, sk, q.device), s, _NEG_INF)
    p = torch.exp(s - lse.reshape(b, h, sq, 1))
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", dof, vf) - delta)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * sm_scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * sm_scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    # query head kv * n_rep + r reads kv head kv (repeat_kv's order)
    dk = dk.reshape(b, sk, kvh, n_rep, d).sum(3)
    dv = dv.reshape(b, sk, kvh, n_rep, d).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                   causal: bool = True, sm_scale: Optional[float] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernels 3 and 4's wrapper: (dq, dk, dv) of attention with output
    ``o`` and row logsumexp ``lse`` [b*H, sq] (``flash_forward``'s) under
    the cotangent ``do``. Each kernel's route is ``flash_route``'s: CPU
    tensors take ``flash_backward_plain``; CUDA tensors (contiguous)
    launch, on the current stream, the dQ kernel of
    ``csrc/flash_bwd_dq_sm90.cu`` or, at head dim 256,
    ``csrc/flash_bwd_dq_sm90_d256.cu`` (route ``"sm90"``), of
    ``csrc/flash_bwd_dq_tf32x3.cu`` (route ``"tf32x3"``) or of
    ``csrc/flash_bwd.cu`` (route ``"scalar"``), then the dK/dV kernel of
    ``csrc/flash_bwd_dkv_sm90.cu`` or, at head dim 256,
    ``csrc/flash_bwd_dkv_sm90_d256.cu`` (route ``"sm90"``), of
    ``csrc/flash_bwd_dkv_tf32x3.cu`` (route ``"tf32x3"``) or of
    ``csrc/flash_bwd.cu`` (route ``"scalar"``), or raise. ``delta =
    rowsum(dO * O)`` is computed here with torch ops, as XLA computes it
    outside the Pallas kernels."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    b, sq, h, d = q.shape
    _, sk, kvh, _ = k.shape
    if (k.shape != v.shape or k.shape[0] != b or k.shape[3] != d
            or o.shape != q.shape or do.shape != q.shape
            or tuple(lse.shape) != (b * h, sq)):
        raise ValueError(
            f"flash_backward: shapes q {tuple(q.shape)} k {tuple(k.shape)} "
            f"v {tuple(v.shape)} o {tuple(o.shape)} do {tuple(do.shape)} "
            f"lse {tuple(lse.shape)}")
    if h % kvh:
        raise ValueError(f"flash_backward: {h} heads not a multiple of "
                         f"{kvh} kv heads")
    dq_route = flash_route(q.dtype, d, q.device, "dq")
    dkv_route = flash_route(q.dtype, d, q.device, "dkv")
    if dq_route == "plain":
        return flash_backward_plain(q, k, v, o, lse, do, causal, sm_scale)
    _check_cuda("flash_backward", q, k, v, o, do)
    if (lse.device != q.device or lse.dtype != torch.float32
            or not lse.is_contiguous()):
        raise ValueError("flash_backward: lse must be a contiguous float32 "
                         "tensor on q's device")
    from ray_tpu_torch.ops import _build

    lib = _build.load()
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).reshape(
        b * h, sq).contiguous()
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    ins = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
           lse.data_ptr(), delta.data_ptr())
    shape = (b, sq, sk, h, kvh)
    flags = (int(bool(causal)), float(sm_scale))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if dq_route == "sm90" and d == 256:
            err = lib.rtt_flash_bwd_dq_sm90_d256(*ins, dq.data_ptr(), *shape,
                                                 *flags, stream)
        elif dq_route == "sm90":
            err = lib.rtt_flash_bwd_dq_sm90(*ins, dq.data_ptr(), *shape, d,
                                            *flags, stream)
        elif dq_route == "tf32x3":
            err = lib.rtt_flash_bwd_dq_tf32x3(*ins, dq.data_ptr(), *shape, d,
                                              *flags, stream)
        else:
            err = lib.rtt_flash_bwd_dq(*ins, dq.data_ptr(), *shape, d,
                                       *flags, stream)
        _build.check(lib, err, f"flash_backward {dq_route} dQ kernel")
        flash_backward.dq_launches += 1
        if dq_route == "sm90":
            flash_backward.dq_sm90_launches += 1
        elif dq_route == "tf32x3":
            flash_backward.dq_tf32x3_launches += 1
        outs = (dk.data_ptr(), dv.data_ptr())
        if dkv_route == "sm90" and d == 256:
            err = lib.rtt_flash_bwd_dkv_sm90_d256(*ins, *outs, *shape,
                                                  *flags, stream)
        elif dkv_route == "sm90":
            err = lib.rtt_flash_bwd_dkv_sm90(*ins, *outs, *shape, d, *flags,
                                             stream)
        elif dkv_route == "tf32x3":
            err = lib.rtt_flash_bwd_dkv_tf32x3(*ins, *outs, *shape, d,
                                               *flags, stream)
        else:
            err = lib.rtt_flash_bwd_dkv(*ins, *outs, *shape, d, *flags,
                                        stream)
        _build.check(lib, err, f"flash_backward {dkv_route} dK/dV kernel")
        flash_backward.dkv_launches += 1
        if dkv_route == "sm90":
            flash_backward.dkv_sm90_launches += 1
        elif dkv_route == "tf32x3":
            flash_backward.dkv_tf32x3_launches += 1
    return dq, dk, dv


# kernel launches, for chip_smoke.py: all routes, and the bf16 wgmma
# route and the fp32 3xTF32 route of each kernel
flash_backward.dq_launches = 0
flash_backward.dq_sm90_launches = 0
flash_backward.dq_tf32x3_launches = 0
flash_backward.dkv_launches = 0
flash_backward.dkv_sm90_launches = 0
flash_backward.dkv_tf32x3_launches = 0


class _FlashAttention(torch.autograd.Function):
    """Forward through kernel 1, backward through kernels 3 and 4 (on
    CPU tensors, or when ``plain``, through their plain versions); saves
    q, k, v, O and the fp32 lse, as the reference's ``custom_vjp`` does."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale, plain):
        fwd = flash_forward_plain if plain else flash_forward
        out, lse = fwd(q, k, v, causal, sm_scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.sm_scale, ctx.plain = causal, sm_scale, plain
        return out

    @staticmethod
    def backward(ctx, grad):
        q, k, v, out, lse = ctx.saved_tensors
        bwd = flash_backward_plain if ctx.plain else flash_backward
        dq, dk, dv = bwd(q, k, v, out, lse, grad.contiguous(), ctx.causal,
                         ctx.sm_scale)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, sm_scale: Optional[float] = None,
                    block_q: Optional[int] = None,
                    block_k: Optional[int] = None,
                    use_pallas: Optional[bool] = None,
                    interpret: bool = False) -> torch.Tensor:
    """Flash attention, differentiable. q [b, sq, H, d]; k/v [b, sk,
    KVH, d].

    ``use_pallas`` and ``interpret`` are the reference's switches, here
    for the hand-written kernels: ``None`` picks by the tensors' device
    (the kernels on the card, their plain versions on the CPU);
    ``False`` runs ``attention_reference`` on either device; ``True``
    runs the kernels, and on CPU tensors, where no kernel runs, needs
    ``interpret=True``, which runs the kernels' plain versions (as the
    reference emulates its Pallas kernels off the TPU) on either device.
    Lengths must divide the blocks (default: the largest power-of-two
    divisor up to 512), else the reference's ``ValueError``.
    """
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if use_pallas is False:
        return attention_reference(q, k, v, causal, sm_scale)
    if use_pallas and not interpret and q.device.type != "cuda":
        raise ValueError(
            f"flash_attention(use_pallas=True): the kernels run on CUDA "
            f"tensors only, not {q.device.type}; pass interpret=True to "
            "run their plain versions")
    if block_q is None:
        block_q = _auto_block(q.shape[1], DEFAULT_BLOCK_Q)
    if block_k is None:
        block_k = _auto_block(k.shape[1], DEFAULT_BLOCK_K)
    _check_blocks(q.shape[1], k.shape[1], block_q, block_k)
    return _FlashAttention.apply(q, k, v, causal, sm_scale,
                                 bool(interpret))
