"""GPT-2 family: decoder-only, learned positions, LayerNorm, GELU MLP.

Counterpart of ``ray_tpu/models/gpt2.py``: the same parameter tree
(stacked ``[L, ...]`` layers, Conv1D-oriented ``[in, out]`` weights, the
LM head tied to ``wte``), the same fp32 norms and bias adds around
products in ``cfg.dtype``, and remat as ``torch.utils.checkpoint``
around each layer. Attention is ``llama._attend``: ``flash_attention``
on CUDA tensors (the ``wgmma`` kernels at head dim 64 in bf16) and the
reference on the CPU. ``logical_axes`` and ``param_shardings`` give the
placements of the reference's rule table; like the reference, GPT-2 has
no mesh forward.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Any, Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch.models.llama import (_attend, as_dtype,
                                        cross_entropy_loss, layer_params,
                                        resolve_device, without_layer)


@dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50_257
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    max_seq_len: int = 1024
    ln_eps: float = 1e-5
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    # auto = the flash kernels when the activations are CUDA tensors, the
    # reference on the CPU
    attn_impl: str = "auto"  # auto | flash | reference
    remat: bool = True

    def __post_init__(self):
        object.__setattr__(self, "dtype", as_dtype(self.dtype))
        object.__setattr__(self, "param_dtype", as_dtype(self.param_dtype))
        if self.attn_impl not in ("auto", "reference", "flash"):
            raise ValueError(f"attn_impl={self.attn_impl!r}: the port has "
                             "'auto', 'reference' and 'flash'")

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @classmethod
    def gpt2_125m(cls, **kw) -> "GPT2Config":
        return replace(cls(), **kw)

    @classmethod
    def tiny(cls, **kw) -> "GPT2Config":
        return replace(
            cls(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
                max_seq_len=128, dtype=torch.float32, remat=False), **kw)


def logical_axes(cfg: GPT2Config) -> Dict[str, Any]:
    L = ("layer",)
    return {
        "wte": ("vocab", "embed"),
        "wpe": (None, "embed"),
        "layers": {
            "ln1_g": L + ("embed",), "ln1_b": L + ("embed",),
            "w_qkv": L + ("embed", "qkv"), "b_qkv": L + ("qkv",),
            "w_proj": L + ("qkv", "embed"), "b_proj": L + ("embed",),
            "ln2_g": L + ("embed",), "ln2_b": L + ("embed",),
            "w_fc": L + ("embed", "mlp"), "b_fc": L + ("mlp",),
            "w_out": L + ("mlp", "embed"), "b_out": L + ("embed",),
        },
        "lnf_g": ("embed",), "lnf_b": ("embed",),
    }


def logical_axes_without_layer(cfg: GPT2Config):
    return without_layer(logical_axes(cfg))


def param_shardings(cfg: GPT2Config, mesh):
    from ray_tpu_torch.parallel.sharding import shard_pytree_like

    return shard_pytree_like(logical_axes_without_layer(cfg), mesh)


def init_params(cfg: GPT2Config, seed: int = 0,
                device=None) -> Dict[str, Any]:
    """Normal(0, 0.02) weights (0.01 for positions, 0.02/sqrt(2L) for
    the residual projections), unit LayerNorm gains and zero biases, in
    ``cfg.param_dtype``, drawn on ``device`` from a ``torch.Generator``
    seeded with ``seed``; the reference's keys and shapes (its draws come
    from ``jax.random`` and differ)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    h, L, pd = cfg.hidden_size, cfg.num_layers, cfg.param_dtype

    def ninit(shape, scale=0.02):
        out = torch.empty(shape, dtype=torch.float32, device=device)
        return out.normal_(0.0, scale, generator=gen).to(pd)

    def const(shape, value):
        return torch.full(shape, value, dtype=pd, device=device)

    resid = 0.02 / math.sqrt(2 * L)
    return {
        "wte": ninit((cfg.vocab_size, h)),
        "wpe": ninit((cfg.max_seq_len, h), 0.01),
        "layers": {
            "ln1_g": const((L, h), 1.0), "ln1_b": const((L, h), 0.0),
            "w_qkv": ninit((L, h, 3 * h)), "b_qkv": const((L, 3 * h), 0.0),
            "w_proj": ninit((L, h, h), resid), "b_proj": const((L, h), 0.0),
            "ln2_g": const((L, h), 1.0), "ln2_b": const((L, h), 0.0),
            "w_fc": ninit((L, h, 4 * h)), "b_fc": const((L, 4 * h), 0.0),
            "w_out": ninit((L, 4 * h, h), resid),
            "b_out": const((L, h), 0.0),
        },
        "lnf_g": const((h,), 1.0),
        "lnf_b": const((h,), 0.0),
    }


def _layer_norm(x, g, b, eps):
    """LayerNorm in fp32, cast back to x's dtype."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps) * g.float()
            + b.float()).to(x.dtype)


def _linear(cfg: GPT2Config, x, w, b):
    """x @ w in cfg.dtype, plus the bias in fp32: an fp32 result."""
    return torch.matmul(x, w.to(cfg.dtype)).float() + b.float()


def _layer(cfg: GPT2Config, x, p):
    b, s, h = x.shape
    nh, hd = cfg.num_heads, cfg.head_dim
    h1 = _layer_norm(x, p["ln1_g"], p["ln1_b"], cfg.ln_eps)
    qkv = _linear(cfg, h1, p["w_qkv"], p["b_qkv"]).to(cfg.dtype)
    q, k, v = (t.reshape(b, s, nh, hd) for t in qkv.split(h, dim=-1))
    attn = _attend(cfg, q.contiguous(), k.contiguous(), v.contiguous())
    x = x + _linear(cfg, attn.reshape(b, s, h), p["w_proj"],
                    p["b_proj"]).to(cfg.dtype)
    h2 = _layer_norm(x, p["ln2_g"], p["ln2_b"], cfg.ln_eps)
    # jax.nn.gelu's default is the tanh approximation; F.gelu's is erf
    act = F.gelu(_linear(cfg, h2, p["w_fc"], p["b_fc"]),
                 approximate="tanh").to(cfg.dtype)
    return x + _linear(cfg, act, p["w_out"], p["b_out"]).to(cfg.dtype)


def forward(cfg: GPT2Config, params: Dict[str, Any],
            tokens: torch.Tensor) -> torch.Tensor:
    """tokens [b, s] -> logits [b, s, vocab] float32, the head tied to
    ``wte``. Differentiable; with ``cfg.remat`` every layer reruns its
    forward in the backward."""
    s = tokens.shape[1]
    ids = tokens.long().clamp(0, cfg.vocab_size - 1)   # the gather's clamp
    x = (params["wte"].to(cfg.dtype)[ids]
         + params["wpe"].to(cfg.dtype)[:s][None])
    for l in range(cfg.num_layers):
        p = layer_params(params, l)
        if cfg.remat:
            x = checkpoint(_layer, cfg, x, p, use_reentrant=False)
        else:
            x = _layer(cfg, x, p)
    x = _layer_norm(x, params["lnf_g"], params["lnf_b"], cfg.ln_eps)
    # fp32 products of the cfg.dtype operands (preferred_element_type)
    return torch.matmul(x.float(), params["wte"].to(cfg.dtype).float().T)


def loss_fn(cfg: GPT2Config, params, batch: Dict[str, torch.Tensor]
            ) -> torch.Tensor:
    """Next-token cross entropy, as ``llama.loss_fn``."""
    tokens = batch["tokens"]
    logits = forward(cfg, params, tokens[:, :-1])
    mask = batch.get("mask")
    if mask is not None:
        mask = mask[:, 1:]
    return cross_entropy_loss(logits, tokens[:, 1:], mask)
