"""Transformer building blocks: RMSNorm, RoPE, gated MLP, repeat_kv.

Plain PyTorch counterparts of ``ray_tpu/ops/layers.py``. In JAX these
are elementwise chains that XLA fuses; here they are eager tensor code.
None of them is a Pallas kernel in the reference, so none is a CUDA
kernel here. Layouts match the reference: activations
``[..., seq, heads, head_dim]``, weights ``[in, out]``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm accumulated in fp32, cast back to the input dtype."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * weight.float()).to(x.dtype)


def rope_frequencies(head_dim: int, max_seq_len: int,
                     theta: float = 10_000.0, dtype=torch.float32,
                     scaling: Optional[dict] = None,
                     device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """RoPE cos/sin tables ``[max_seq_len, head_dim // 2]``.

    ``scaling`` is the HF ``rope_scaling`` dict: ``llama3`` (Llama-3.x
    long-context frequency bands), ``linear`` (position interpolation)
    or ``yarn`` (NTK-by-parts with the attention factor applied to the
    tables), each as transformers' ``modeling_rope_utils`` computes it.
    """
    inv_freq = 1.0 / (theta ** (
        torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
        / head_dim))
    attention_factor = 1.0
    if scaling:
        rope_type = scaling.get("rope_type") or scaling.get("type")
        if rope_type == "llama3":
            factor = float(scaling["factor"])
            low = float(scaling.get("low_freq_factor", 1.0))
            high = float(scaling.get("high_freq_factor", 4.0))
            old_len = float(scaling.get(
                "original_max_position_embeddings", 8192))
            wavelen = 2.0 * math.pi / inv_freq
            smooth = (old_len / wavelen - low) / (high - low)
            scaled = ((1.0 - smooth) * (inv_freq / factor)
                      + smooth * inv_freq)
            inv_freq = torch.where(
                wavelen < old_len / high, inv_freq,
                torch.where(wavelen > old_len / low, inv_freq / factor,
                            scaled))
        elif rope_type == "linear":
            inv_freq = inv_freq / float(scaling["factor"])
        elif rope_type == "yarn":
            factor = float(scaling["factor"])
            beta_fast = float(scaling.get("beta_fast") or 32)
            beta_slow = float(scaling.get("beta_slow") or 1)
            old_len = float(scaling.get("original_max_position_embeddings")
                            or max_seq_len)
            mscale = scaling.get("mscale")
            mscale_all_dim = scaling.get("mscale_all_dim")

            def get_mscale(scale, ms=1.0):
                if scale <= 1:
                    return 1.0
                return 0.1 * ms * math.log(scale) + 1.0

            attention_factor = scaling.get("attention_factor")
            if attention_factor is None:
                if mscale and mscale_all_dim:
                    attention_factor = float(
                        get_mscale(factor, mscale)
                        / get_mscale(factor, mscale_all_dim))
                else:
                    attention_factor = get_mscale(factor)

            def correction_dim(num_rotations):
                return (head_dim * math.log(
                    old_len / (num_rotations * 2 * math.pi))
                    ) / (2 * math.log(theta))

            low = correction_dim(beta_fast)
            high = correction_dim(beta_slow)
            if scaling.get("truncate", True):
                low, high = math.floor(low), math.ceil(high)
            low, high = max(low, 0), min(high, head_dim - 1)
            if low == high:
                high += 0.001  # prevent singularity
            ramp = torch.clamp(
                (torch.arange(head_dim // 2, dtype=torch.float32,
                              device=device) - low) / (high - low),
                0.0, 1.0)
            extrapolation = 1.0 - ramp
            inv_freq = ((inv_freq / factor) * (1.0 - extrapolation)
                        + inv_freq * extrapolation)
        else:
            raise ValueError(
                f"unsupported rope_scaling type {rope_type!r} "
                f"(implemented: 'llama3', 'linear', 'yarn')")
    t = torch.arange(max_seq_len, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)
    return ((torch.cos(freqs) * attention_factor).to(dtype),
            (torch.sin(freqs) * attention_factor).to(dtype))


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Rotate ``x [..., seq, heads, head_dim]`` by the tables at
    ``positions [..., seq]`` (default ``arange(seq)``). Positions are
    clamped into the table, as a JAX gather clamps them."""
    seq = x.shape[-3]
    if positions is None:
        c = cos[:seq][:, None, :]
        s = sin[:seq][:, None, :]
    else:
        idx = positions.long().clamp(0, cos.shape[0] - 1)
        c = cos[idx][..., None, :]
        s = sin[idx][..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    cf, sf = c.float(), s.float()
    out = torch.cat([x1 * cf - x2 * sf, x2 * cf + x1 * sf], dim=-1)
    return out.to(x.dtype)


_ACTS = {
    "silu": F.silu,
    "gelu_tanh": lambda t: F.gelu(t, approximate="tanh"),
    "gelu": F.gelu,
}


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor, act: str = "silu") -> torch.Tensor:
    """Gated MLP ``down(act(x @ gate) * (x @ up))``; ``act`` is ``silu``
    (SwiGLU), ``gelu_tanh`` (GeGLU) or ``gelu`` (erf). Unknown names
    raise. Products run in the input dtype (fp32 accumulation inside
    the matmul) and the intermediates stay in it, as in the reference."""
    try:
        act_fn = _ACTS[act]
    except KeyError:
        raise ValueError(f"unknown gated-MLP activation {act!r} "
                         "(silu | gelu_tanh | gelu)") from None
    gate = torch.matmul(x, w_gate)
    up = torch.matmul(x, w_up)
    return torch.matmul(act_fn(gate) * up, w_down)


def repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """``[b, s, kv_heads, hd] -> [b, s, kv_heads * n_rep, hd]``."""
    if n_rep == 1:
        return x
    b, s, h, d = x.shape
    return x[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(
        b, s, h * n_rep, d)
