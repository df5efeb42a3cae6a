"""Llama-3-style decoder-only transformer: the inference and training
surface.

Counterpart of ``ray_tpu/models/llama.py``. Parameters are a plain dict
with the reference's keys and STACKED layers (``[L, in, out]``
matmul weights, ``[L, h]`` norms), so ``models/convert.py`` moves them
between the two packages through numpy and both compute with the same
weights. The layer stack is a Python loop over the leading dim.

``forward`` is differentiable and ``loss_fn`` is the training objective:
a train step is ``loss_fn(...).backward()`` then an optimizer step
(``torch.optim.AdamW`` for the reference's ``optax.adamw``). Remat is
``torch.utils.checkpoint`` around each layer. ``mesh`` arguments,
``loss_fn_pp``, ``logical_axes`` and ``param_shardings`` wait for the
port of ``parallel/``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

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
    # auto = the flash kernels when the activations are CUDA tensors, the
    # reference on the CPU (the reference package resolves it per backend)
    attn_impl: str = "auto"  # auto | flash | reference
    # Qwen2-style additive q/k/v projection biases
    attn_qkv_bias: bool = False
    # Gemma deltas: GeGLU gate ("gelu_tanh") and sqrt(hidden) embed scale
    mlp_act: str = "silu"  # silu | gelu_tanh | gelu
    embed_scale: float = 1.0
    # serving prefill attention: None = the flash kernel when the tensors
    # are on CUDA, the reference path on the CPU
    prefill_flash: Optional[bool] = None
    # torch.utils.checkpoint around each layer: the backward recomputes
    # the layer's forward instead of keeping its activations
    remat: bool = True
    # partial remat: this many TRAILING layers keep their activations
    # (0 = every layer rematerialized)
    remat_store_layers: int = 0
    # "full" recomputes the whole layer; "save_qkv" keeps the post-rope
    # q, k and the v projection and recomputes the rest (see _remat_layer)
    remat_policy: str = "full"  # full | save_qkv
    # The reference's lax.scan over the stack (True) or unrolled loop
    # (False). Eager PyTorch always runs a Python loop, so the knob
    # changes nothing here but its conflict with remat_store_layers,
    # which raises as in the reference.
    scan_layers: bool = True
    tie_embeddings: bool = False
    # optional HF rope_scaling dict, as a tuple of items (hashable)
    rope_scaling: Optional[tuple] = None

    def __post_init__(self):
        object.__setattr__(self, "dtype", as_dtype(self.dtype))
        object.__setattr__(self, "param_dtype", as_dtype(self.param_dtype))
        if self.attn_impl not in ("auto", "reference", "flash"):
            raise ValueError(
                f"attn_impl={self.attn_impl!r}: the port has 'auto', "
                "'reference' and 'flash' (ring/ulysses come with the "
                "port of parallel/)")
        if self.remat_policy not in ("full", "save_qkv"):
            raise ValueError(
                f"unknown remat_policy {self.remat_policy!r} "
                "(full | save_qkv)")

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
                  dtype=torch.float32, remat=False)
        return replace(cfg, **kw)


def trunc_normal_init(gen: torch.Generator, shape, fan_in: int,
                      dtype: torch.dtype) -> torch.Tensor:
    """Truncated-normal (+-3 sigma) weights scaled by 1/sqrt(fan_in), in
    ``dtype`` on the generator's device. Stacks (3-D and up) are drawn
    in fp32 one layer at a time, so the 8B stacks never need an fp32
    copy of the whole stack."""
    out = torch.empty(shape, dtype=dtype, device=gen.device)
    for part in (out if len(shape) >= 3 else [out]):
        buf = torch.empty(part.shape, dtype=torch.float32, device=gen.device)
        torch.nn.init.trunc_normal_(buf, 0.0, 1.0, -3.0, 3.0, generator=gen)
        part.copy_(buf.mul_(1.0 / math.sqrt(fan_in)))
    return out


def _param_layout(cfg: LlamaConfig) -> Dict[str, Any]:
    """Every parameter leaf as ``(shape, init)``, in the order
    ``init_params`` draws them: ``init`` is the fan-in of a
    truncated-normal leaf, or ``"ones"`` / ``"zeros"``."""
    h, ffn, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    hd = cfg.head_dim_
    qd, kvd = cfg.num_heads * hd, cfg.num_kv_heads * hd
    layout = {
        "embed": ((cfg.vocab_size, h), h),
        "layers": {
            "attn_norm": ((L, h), "ones"),
            "wq": ((L, h, qd), h),
            "wk": ((L, h, kvd), h),
            "wv": ((L, h, kvd), h),
            "wo": ((L, qd, h), qd),
            "mlp_norm": ((L, h), "ones"),
            "w_gate": ((L, h, ffn), h),
            "w_up": ((L, h, ffn), h),
            "w_down": ((L, ffn, h), ffn),
        },
        "final_norm": ((h,), "ones"),
    }
    if cfg.attn_qkv_bias:
        layout["layers"].update(bq=((L, qd), "zeros"),
                                bk=((L, kvd), "zeros"),
                                bv=((L, kvd), "zeros"))
    if not cfg.tie_embeddings:
        layout["lm_head"] = ((h, cfg.vocab_size), h)
    return layout


def _map_layout(layout, fn):
    return {k: _map_layout(v, fn) if isinstance(v, dict) else fn(*v)
            for k, v in layout.items()}


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

    def make(shape, init):
        if init == "ones":
            return torch.ones(shape, dtype=cfg.param_dtype, device=device)
        if init == "zeros":
            return torch.zeros(shape, dtype=cfg.param_dtype, device=device)
        return trunc_normal_init(gen, shape, init, cfg.param_dtype)

    return _map_layout(_param_layout(cfg), make)


def init_shapes(cfg: LlamaConfig) -> Dict[str, Any]:
    """The tree ``init_params`` returns, as ``device="meta"`` tensors:
    the shapes and dtypes with no storage and no draws (the reference's
    ``jax.eval_shape`` of its ``init_params``)."""
    return _map_layout(
        _param_layout(cfg),
        lambda shape, _: torch.empty(shape, dtype=cfg.param_dtype,
                                     device="meta"))


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
    impl = cfg.attn_impl
    if impl == "auto":
        impl = "flash" if q.is_cuda else "reference"
    if impl == "flash":
        return flash_attention(q, k, v, causal=True)
    return attention_reference(q, k, v, causal=True)


def _qkv(cfg: LlamaConfig, h1, p, cos, sin):
    """Post-rope q, k and the v projection of the normed input ``h1``."""
    b, s, _ = h1.shape
    hd = cfg.head_dim_
    q = torch.matmul(h1, p["wq"].to(cfg.dtype))
    k = torch.matmul(h1, p["wk"].to(cfg.dtype))
    v = torch.matmul(h1, p["wv"].to(cfg.dtype))
    if "bq" in p:
        q = q + p["bq"].to(cfg.dtype)
        k = k + p["bk"].to(cfg.dtype)
        v = v + p["bv"].to(cfg.dtype)
    q = apply_rope(q.reshape(b, s, cfg.num_heads, hd), cos, sin)
    k = apply_rope(k.reshape(b, s, cfg.num_kv_heads, hd), cos, sin)
    return q, k, v.reshape(b, s, cfg.num_kv_heads, hd)


def _attn_out(cfg: LlamaConfig, x, q, k, v, p):
    """x + wo(attend(q, k, v)): the attention sub-block's residual."""
    b, s, _ = x.shape
    attn = _attend(cfg, q, k, v).reshape(b, s, cfg.num_heads * cfg.head_dim_)
    return x + torch.matmul(attn, p["wo"].to(cfg.dtype))


def _attn_mlp(cfg: LlamaConfig, x, q, k, v, p):
    """The layer from attention on: ``_attn_out``, then the pre-norm MLP
    with its residual."""
    x = _attn_out(cfg, x, q, k, v, p)
    h2 = rms_norm(x, p["mlp_norm"], cfg.rms_norm_eps)
    return x + swiglu(h2, p["w_gate"].to(cfg.dtype), p["w_up"].to(cfg.dtype),
                      p["w_down"].to(cfg.dtype), act=cfg.mlp_act)


def attention_block(cfg: LlamaConfig, x, p, cos, sin):
    """Pre-norm attention sub-block with its residual, x + wo(attend(
    qkv)), the optional ``bq``/``bk``/``bv`` included: the part of a
    layer every model of the family shares (Mixtral puts its MoE after
    it). Counterpart of the reference's ``attention_block``."""
    h1 = rms_norm(x, p["attn_norm"], cfg.rms_norm_eps)
    return _attn_out(cfg, x, *_qkv(cfg, h1, p, cos, sin), p)


def _layer(cfg: LlamaConfig, x, p, cos, sin):
    h1 = rms_norm(x, p["attn_norm"], cfg.rms_norm_eps)
    return _attn_mlp(cfg, x, *_qkv(cfg, h1, p, cos, sin), p)


def _remat_layer(cfg: LlamaConfig, x, p, cos, sin):
    """One layer under ``torch.utils.checkpoint``.

    ``full``: the layer's forward reruns in its backward; only its input
    is kept. ``save_qkv``: the layer is split after the projections. The
    attention-and-MLP part is checkpointed, which keeps its inputs: the
    post-rope q, k and the v projection (the reference's ``q_rope``,
    ``k_rope`` and ``v_proj``). The projections run outside the
    checkpoint so that their backward needs no rerun, which keeps more
    than the reference's names: the normed input ``h1`` and the
    ``cfg.dtype`` casts of wq/wk/wv, as the matmuls' saved operands
    (the norm itself is checkpointed and reruns).
    """
    if cfg.remat_policy == "full":
        return checkpoint(_layer, cfg, x, p, cos, sin, use_reentrant=False)
    h1 = checkpoint(rms_norm, x, p["attn_norm"], cfg.rms_norm_eps,
                    use_reentrant=False)
    q, k, v = _qkv(cfg, h1, p, cos, sin)
    return checkpoint(_attn_mlp, cfg, x, q, k, v, p, use_reentrant=False)


def forward(cfg: LlamaConfig, params: Dict[str, Any],
            tokens: torch.Tensor) -> torch.Tensor:
    """tokens [b, s] -> logits [b, s, vocab] float32. Differentiable;
    with ``cfg.remat`` every layer but the last ``remat_store_layers``
    is rematerialized in the backward."""
    n_store = min(cfg.remat_store_layers, cfg.num_layers) \
        if cfg.remat else 0
    if not cfg.scan_layers and n_store > 0:
        raise ValueError(
            "scan_layers=False and remat_store_layers>0 conflict: "
            "partial remat is a scan-path knob in the reference package "
            "(its unrolled loop opts out of it)")
    x = embed(cfg, params, tokens)
    cos, sin = rope_frequencies(cfg.head_dim_, tokens.shape[1],
                                cfg.rope_theta, dtype=cfg.dtype,
                                scaling=cfg.rope_scaling_dict,
                                device=x.device)
    n_remat = cfg.num_layers - n_store if cfg.remat else 0
    for l in range(cfg.num_layers):
        layer = _remat_layer if l < n_remat else _layer
        x = layer(cfg, x, layer_params(params, l), cos, sin)
    return _final_head(cfg, params, x)


def _final_head(cfg: LlamaConfig, params, x: torch.Tensor) -> torch.Tensor:
    """Final norm + (tied) LM head. The logits are fp32 products of the
    cfg.dtype operands, as the reference's ``preferred_element_type``
    gives them: rounding them to bf16 would tie greedy argmaxes."""
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return torch.matmul(x.float(), head.to(cfg.dtype).float())


def cross_entropy_loss(logits: torch.Tensor, targets: torch.Tensor,
                       mask: Optional[torch.Tensor] = None,
                       z_loss: float = 0.0) -> torch.Tensor:
    """Token-level CE in fp32 with optional z-loss regularization; with a
    mask, the masked mean over ``max(mask.sum(), 1)`` tokens."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    true_logit = logits.gather(-1, targets.long()[..., None])[..., 0]
    nll = lse - true_logit
    if z_loss:
        nll = nll + z_loss * lse.square()
    if mask is not None:
        mask = mask.to(nll.dtype)
        return (nll * mask).sum() / mask.sum().clamp_min(1)
    return nll.mean()


def loss_fn(cfg: LlamaConfig, params, batch: Dict[str, torch.Tensor]
            ) -> torch.Tensor:
    """batch: {"tokens": [b, s], optional "mask": [b, s]}; next-token
    prediction, the mask read from position 1 on."""
    tokens = batch["tokens"]
    logits = forward(cfg, params, tokens[:, :-1])
    mask = batch.get("mask")
    if mask is not None:
        mask = mask[:, 1:]
    return cross_entropy_loss(logits, tokens[:, 1:], mask)


def param_leaves(params, prefix: str = "") -> list:
    """(dotted path, leaf) pairs of a nested param dict, in sorted key
    order: the leaves an optimizer takes, named as gradients are
    compared."""
    out = []
    for key in sorted(params):
        v = params[key]
        out += (param_leaves(v, f"{prefix}{key}.") if isinstance(v, dict)
                else [(prefix + key, v)])
    return out


def num_params(params) -> int:
    def count(v):
        if isinstance(v, dict):
            return sum(count(x) for x in v.values())
        return v.numel()
    return count(params)
