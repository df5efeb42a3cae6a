"""Attention: the plain reference and the flash-attention forward kernel.

Counterpart of ``ray_tpu/ops/attention.py``. ``flash_forward`` is the
wrapper of kernel 1 (``csrc/flash_fwd.cu``, which replaces the Pallas
``_flash_kernel``): on CUDA tensors it launches the kernel, on CPU
tensors it runs ``flash_forward_plain``, the same function in plain
PyTorch. There is no other route and no fallback: a CUDA tensor the
kernel cannot take raises.

Only the forward is ported in this slice. The backward kernels (the
Pallas ``_flash_bwd_dq_kernel`` / ``_flash_bwd_dkv_kernel``) consume the
fp32 logsumexp that ``flash_forward`` returns; until they exist,
``flash_attention`` refuses inputs that require grad rather than
differentiate through the plain version.
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


_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


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
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"{name}: dtype {dtype} not supported "
                         "(float32 or bfloat16)")


def flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, sm_scale: Optional[float] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel 1's wrapper: (O [b, sq, H, d] in q's dtype, lse f32
    [b*H, sq]). CPU tensors take ``flash_forward_plain``; CUDA tensors
    launch ``csrc/flash_fwd.cu`` on the current stream (head_dim 64 or
    128, float32 or bfloat16, contiguous) or raise."""
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
    if q.device.type == "cpu":
        return flash_forward_plain(q, k, v, causal, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_forward: unsupported device {q.device}")
    _check_cuda("flash_forward", q, k, v)
    if d not in (64, 128):
        raise ValueError(f"flash_forward: head_dim {d} not supported "
                         "(64 or 128)")
    from ray_tpu_torch.ops import _build

    lib = _build.load()
    out = torch.empty_like(q)
    lse = torch.empty((b * h, sq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.rtt_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), _DTYPE_CODES[q.dtype], b, sq, sk, h, kvh, d,
            int(bool(causal)), float(sm_scale), stream)
    _build.check(lib, err, "flash_forward kernel")
    flash_forward.launches += 1
    return out, lse


flash_forward.launches = 0  # kernel launches, for chip_smoke.py


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, sm_scale: Optional[float] = None,
                    block_q: Optional[int] = None,
                    block_k: Optional[int] = None) -> torch.Tensor:
    """Flash attention forward. q [b, sq, H, d]; k/v [b, sk, KVH, d].

    Lengths must divide the blocks (default: the largest power-of-two
    divisor up to 512), else the reference's ``ValueError``. Forward
    only: inputs that require grad raise until the backward kernels are
    ported.
    """
    if any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash_attention has no backward in ray_tpu_torch yet: the "
            "dQ and dK/dV kernels come with the training slice; run "
            "under torch.no_grad() or use attention_reference")
    if block_q is None:
        block_q = _auto_block(q.shape[1], DEFAULT_BLOCK_Q)
    if block_k is None:
        block_k = _auto_block(k.shape[1], DEFAULT_BLOCK_K)
    _check_blocks(q.shape[1], k.shape[1], block_q, block_k)
    return flash_forward(q, k, v, causal, sm_scale)[0]
