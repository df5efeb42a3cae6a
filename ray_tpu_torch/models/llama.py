"""Llama-3-style decoder-only transformer: the inference surface.

Counterpart of ``ray_tpu/models/llama.py``. Parameters are a plain dict
with the reference's keys and STACKED layers (``[L, in, out]``
matmul weights, ``[L, h]`` norms), so ``models/convert.py`` moves them
between the two packages through numpy and both compute with the same
weights. The layer stack is a Python loop over the leading dim.

Remat, scan, the loss and pipeline parallelism belong to the training
slice and are not here.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Any, Dict, Optional

import numpy as np
import torch

from ray_tpu_torch.ops.attention import attention_reference, flash_attention
from ray_tpu_torch.ops.layers import (apply_rope, rms_norm, rope_frequencies,
                                      swiglu)


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card; without CUDA that raises rather
    than quietly running on the host. Pass ``"cpu"`` to run there."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "ray_tpu_torch runs on a CUDA card by default and none is "
                "available; pass device='cpu' to run on the host")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def as_dtype(d) -> torch.dtype:
    """A torch dtype from a dtype or its name (``"bfloat16"``)."""
    return getattr(torch, d) if isinstance(d, str) else d


def to_device(x, device, dtype: Optional[torch.dtype] = None
              ) -> torch.Tensor:
    """Host data (numpy, list, tensor) as a tensor on ``device``. A host
    to CUDA copy goes through pinned memory with ``non_blocking=True``:
    a pageable copy would wait for all queued device work and stall
    the engine's on-device chaining."""
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    if dtype is not None:
        t = t.to(dtype)
    device = torch.device(device)
    if t.device.type == "cpu" and device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def host_array(x) -> np.ndarray:
    """numpy view of host data; a device tensor is copied (a sync)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128_256
    hidden_size: int = 4096
    intermediate_size: int = 14_336
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    head_dim: Optional[int] = None
    max_seq_len: int = 8192
    rope_theta: float = 500_000.0
    rms_norm_eps: float = 1e-5
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    attn_impl: str = "reference"  # reference | flash
    # Qwen2-style additive q/k/v projection biases
    attn_qkv_bias: bool = False
    # Gemma deltas: GeGLU gate ("gelu_tanh") and sqrt(hidden) embed scale
    mlp_act: str = "silu"  # silu | gelu_tanh | gelu
    embed_scale: float = 1.0
    # serving prefill attention: None = the flash kernel when the tensors
    # are on CUDA, the reference path on the CPU
    prefill_flash: Optional[bool] = None
    tie_embeddings: bool = False
    # optional HF rope_scaling dict, as a tuple of items (hashable)
    rope_scaling: Optional[tuple] = None

    def __post_init__(self):
        object.__setattr__(self, "dtype", as_dtype(self.dtype))
        object.__setattr__(self, "param_dtype", as_dtype(self.param_dtype))
        if self.attn_impl not in ("reference", "flash"):
            raise ValueError(
                f"attn_impl={self.attn_impl!r}: the port has 'reference' "
                "and 'flash' (ring/ulysses come with the training slice)")

    @property
    def rope_scaling_dict(self):
        return dict(self.rope_scaling) if self.rope_scaling else None

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.hidden_size // self.num_heads

    # ---- presets -----------------------------------------------------------

    @classmethod
    def llama3_8b(cls, **kw) -> "LlamaConfig":
        return cls(**kw)

    @classmethod
    def llama3_1b_proxy(cls, **kw) -> "LlamaConfig":
        cfg = cls(hidden_size=2048, intermediate_size=5504, num_layers=16,
                  num_heads=16, num_kv_heads=8, vocab_size=32_000)
        return replace(cfg, **kw)

    @classmethod
    def tiny(cls, **kw) -> "LlamaConfig":
        cfg = cls(vocab_size=256, hidden_size=64, intermediate_size=128,
                  num_layers=2, num_heads=4, num_kv_heads=2, max_seq_len=128,
                  dtype=torch.float32)
        return replace(cfg, **kw)


def init_params(cfg: LlamaConfig, seed: int = 0,
                device=None) -> Dict[str, Any]:
    """Truncated-normal (+-3 sigma) fan-in-scaled weights in
    ``cfg.param_dtype``, drawn on ``device`` from a ``torch.Generator``
    seeded with ``seed``; same keys and stacked shapes as the reference.
    The draws differ from ``jax.random``'s: tests that need both
    packages on the same weights convert them (models/convert.py)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    h, ffn, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    hd = cfg.head_dim_
    qd, kvd = cfg.num_heads * hd, cfg.num_kv_heads * hd

    def norm_init(shape, fan_in):
        out = torch.empty(shape, dtype=cfg.param_dtype, device=device)
        # drawn in fp32 one layer at a time: the 8B stacks never need an
        # fp32 copy of the whole stack
        for part in (out if len(shape) == 3 else [out]):
            buf = torch.empty(part.shape, dtype=torch.float32, device=device)
            torch.nn.init.trunc_normal_(buf, 0.0, 1.0, -3.0, 3.0,
                                        generator=gen)
            part.copy_(buf.mul_(1.0 / math.sqrt(fan_in)))
        return out

    def ones(shape):
        return torch.ones(shape, dtype=cfg.param_dtype, device=device)

    params = {
        "embed": norm_init((cfg.vocab_size, h), h),
        "layers": {
            "attn_norm": ones((L, h)),
            "wq": norm_init((L, h, qd), h),
            "wk": norm_init((L, h, kvd), h),
            "wv": norm_init((L, h, kvd), h),
            "wo": norm_init((L, qd, h), qd),
            "mlp_norm": ones((L, h)),
            "w_gate": norm_init((L, h, ffn), h),
            "w_up": norm_init((L, h, ffn), h),
            "w_down": norm_init((L, ffn, h), ffn),
        },
        "final_norm": ones((h,)),
    }
    if cfg.attn_qkv_bias:
        zeros = lambda n: torch.zeros((L, n), dtype=cfg.param_dtype,  # noqa: E731
                                      device=device)
        params["layers"].update(bq=zeros(qd), bk=zeros(kvd), bv=zeros(kvd))
    if not cfg.tie_embeddings:
        params["lm_head"] = norm_init((h, cfg.vocab_size), h)
    return params


def layer_params(params: Dict[str, Any], l: int) -> Dict[str, Any]:
    """Layer ``l``'s slice of the stacked layer params (views, int8
    ``{"q", "s"}`` leaves included)."""
    def take(v):
        if isinstance(v, dict):
            return {k: x[l] for k, x in v.items()}
        return v[l]
    return {k: take(v) for k, v in params["layers"].items()}


def embed(cfg: LlamaConfig, params, tokens: torch.Tensor) -> torch.Tensor:
    """Token embedding in cfg.dtype; ids are clamped into the vocabulary
    as the reference's gather clamps them."""
    ids = tokens.long().clamp(0, cfg.vocab_size - 1)
    x = params["embed"][ids].to(cfg.dtype)
    if cfg.embed_scale != 1.0:
        x = x * torch.tensor(cfg.embed_scale, dtype=cfg.dtype)
    return x


def _attend(cfg: LlamaConfig, q, k, v):
    if cfg.attn_impl == "flash":
        return flash_attention(q, k, v, causal=True)
    return attention_reference(q, k, v, causal=True)


def attention_block(cfg: LlamaConfig, x, p, cos, sin):
    """Pre-norm attention sub-block with residual."""
    b, s, _ = x.shape
    hd = cfg.head_dim_
    h1 = rms_norm(x, p["attn_norm"], cfg.rms_norm_eps)
    q = torch.matmul(h1, p["wq"].to(cfg.dtype))
    k = torch.matmul(h1, p["wk"].to(cfg.dtype))
    v = torch.matmul(h1, p["wv"].to(cfg.dtype))
    if "bq" in p:
        q = q + p["bq"].to(cfg.dtype)
        k = k + p["bk"].to(cfg.dtype)
        v = v + p["bv"].to(cfg.dtype)
    q = apply_rope(q.reshape(b, s, cfg.num_heads, hd), cos, sin)
    k = apply_rope(k.reshape(b, s, cfg.num_kv_heads, hd), cos, sin)
    v = v.reshape(b, s, cfg.num_kv_heads, hd)
    attn = _attend(cfg, q, k, v).reshape(b, s, cfg.num_heads * hd)
    return x + torch.matmul(attn, p["wo"].to(cfg.dtype))


def _layer(cfg: LlamaConfig, x, p, cos, sin):
    x = attention_block(cfg, x, p, cos, sin)
    h2 = rms_norm(x, p["mlp_norm"], cfg.rms_norm_eps)
    return x + swiglu(h2, p["w_gate"].to(cfg.dtype), p["w_up"].to(cfg.dtype),
                      p["w_down"].to(cfg.dtype), act=cfg.mlp_act)


@torch.no_grad()
def forward(cfg: LlamaConfig, params: Dict[str, Any],
            tokens: torch.Tensor) -> torch.Tensor:
    """tokens [b, s] -> logits [b, s, vocab] float32."""
    x = embed(cfg, params, tokens)
    cos, sin = rope_frequencies(cfg.head_dim_, tokens.shape[1],
                                cfg.rope_theta, dtype=cfg.dtype,
                                scaling=cfg.rope_scaling_dict,
                                device=x.device)
    for l in range(cfg.num_layers):
        x = _layer(cfg, x, layer_params(params, l), cos, sin)
    return _final_head(cfg, params, x)


def _final_head(cfg: LlamaConfig, params, x: torch.Tensor) -> torch.Tensor:
    """Final norm + (tied) LM head. The logits are fp32 products of the
    cfg.dtype operands, as the reference's ``preferred_element_type``
    gives them: rounding them to bf16 would tie greedy argmaxes."""
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return torch.matmul(x.float(), head.to(cfg.dtype).float())


def num_params(params) -> int:
    def count(v):
        if isinstance(v, dict):
            return sum(count(x) for x in v.values())
        return v.numel()
    return count(params)
