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
``torch.utils.checkpoint`` around each layer.

Under a mesh (``forward`` / ``loss_fn(mesh=)``, ``loss_fn_pp``) every
rank runs its shard of the program with explicit collectives
(``models/sharded.py``): params are DTensors placed by
``param_shardings`` from the reference's ``logical_axes``, tp splits the
heads, the MLP and the vocabulary Megatron-style, the batch splits over
(dp, fsdp), the sequence over sp (``attn_impl`` ring or ulysses), and
the layer stack over pp.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch.models import sharded
from ray_tpu_torch.ops.attention import attention_reference, flash_attention
from ray_tpu_torch.ops.layers import (apply_rope, rms_norm, rope_frequencies,
                                      swiglu)
from ray_tpu_torch.ops.ring_attention import ring_attention_local
from ray_tpu_torch.ops.ulysses import ulysses_attention_local
from ray_tpu_torch.parallel import device_collectives as dc


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
    # reference on the CPU (the reference package resolves it per
    # backend); ring / ulysses: sequence parallel over a mesh's sp axis
    attn_impl: str = "auto"  # auto | flash | reference | ring | ulysses
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
        if self.attn_impl not in ("auto", "reference", "flash", "ring",
                                  "ulysses"):
            raise ValueError(
                f"unknown attn_impl {self.attn_impl!r} (auto | flash | "
                "reference | ring | ulysses)")
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


def _attend(cfg: LlamaConfig, q, k, v, spmd=None):
    impl = cfg.attn_impl
    if impl == "auto":
        impl = "flash" if q.is_cuda else "reference"
    seq_axis = spmd.seq_axis if spmd is not None else None
    if impl in ("ring", "ulysses"):
        if seq_axis is None:
            raise ValueError(
                f"attn_impl={impl!r} requires a mesh with an 'sp' axis")
        if impl == "ring":
            return ring_attention_local(q, k, v, seq_axis, causal=True,
                                        mesh=spmd.mesh)
        return ulysses_attention_local(q, k, v, seq_axis, causal=True,
                                       mesh=spmd.mesh)
    if seq_axis is not None and spmd.size(seq_axis) > 1:
        raise ValueError(
            f"attn_impl={impl!r} attends over a whole sequence, and the "
            f"mesh's sp={spmd.size(seq_axis)} splits it: use 'ring' or "
            "'ulysses'")
    if impl == "flash":
        return flash_attention(q, k, v, causal=True)
    return attention_reference(q, k, v, causal=True)


def _tp_sum(spmd, x):
    return x if spmd is None else spmd.tp_sum(x)


def heads_gathered(cfg: LlamaConfig, spmd) -> bool:
    """Whether tp splits the heads unevenly (it does not divide the KV
    heads): each rank then gathers the whole q/k/v projections from its
    column shards, attends every head and keeps its block of the
    output, as GSPMD computes the reference's placements."""
    return spmd is not None and not spmd.heads_local(cfg.num_heads,
                                                     cfg.num_kv_heads)


def _qkv(cfg: LlamaConfig, h1, p, cos, sin, spmd=None):
    """Post-rope q, k and the v projection of the normed input ``h1``;
    the head counts follow the weights (a rank's heads under tp), or
    are every head (``heads_gathered``)."""
    b, s, _ = h1.shape
    hd = cfg.head_dim_
    q = torch.matmul(h1, p["wq"].to(cfg.dtype))
    k = torch.matmul(h1, p["wk"].to(cfg.dtype))
    v = torch.matmul(h1, p["wv"].to(cfg.dtype))
    if "bq" in p:
        q = q + p["bq"].to(cfg.dtype)
        k = k + p["bk"].to(cfg.dtype)
        v = v + p["bv"].to(cfg.dtype)
    if heads_gathered(cfg, spmd):
        q, k, v = (spmd.tp_gather(t) for t in (q, k, v))
    q = apply_rope(q.reshape(b, s, -1, hd), cos, sin)
    k = apply_rope(k.reshape(b, s, -1, hd), cos, sin)
    return q, k, v.reshape(b, s, -1, hd)


def _attn_out(cfg: LlamaConfig, x, q, k, v, p, spmd=None):
    """x + wo(attend(q, k, v)): the attention sub-block's residual (under
    tp, wo's rows are this rank's heads and the products are summed)."""
    b, s, _ = x.shape
    attn = _attend(cfg, q, k, v, spmd).reshape(b, s, -1)
    if heads_gathered(cfg, spmd):
        attn = spmd.tp_block(attn)
    return x + _tp_sum(spmd, torch.matmul(attn, p["wo"].to(cfg.dtype)))


def _attn_mlp(cfg: LlamaConfig, x, q, k, v, p, spmd=None):
    """The layer from attention on: ``_attn_out``, then the pre-norm MLP
    with its residual."""
    x = _attn_out(cfg, x, q, k, v, p, spmd)
    h2 = rms_norm(x, p["mlp_norm"], cfg.rms_norm_eps)
    return x + _tp_sum(spmd, swiglu(
        h2, p["w_gate"].to(cfg.dtype), p["w_up"].to(cfg.dtype),
        p["w_down"].to(cfg.dtype), act=cfg.mlp_act))


def attention_block(cfg: LlamaConfig, x, p, cos, sin, spmd=None):
    """Pre-norm attention sub-block with its residual, x + wo(attend(
    qkv)), the optional ``bq``/``bk``/``bv`` included: the part of a
    layer every model of the family shares (Mixtral puts its MoE after
    it). Counterpart of the reference's ``attention_block``; ``spmd``
    (``models/sharded.py``) runs it on a rank's shards of a mesh."""
    h1 = rms_norm(x, p["attn_norm"], cfg.rms_norm_eps)
    return _attn_out(cfg, x, *_qkv(cfg, h1, p, cos, sin, spmd), p, spmd)


def _layer(cfg: LlamaConfig, x, p, cos, sin, spmd=None):
    if spmd is not None:
        p = spmd.weights(p)
    h1 = rms_norm(x, p["attn_norm"], cfg.rms_norm_eps)
    return _attn_mlp(cfg, x, *_qkv(cfg, h1, p, cos, sin, spmd), p, spmd)


def _remat_layer(cfg: LlamaConfig, x, p, cos, sin, spmd=None):
    """One layer under ``torch.utils.checkpoint``.

    ``full``: the layer's forward reruns in its backward; only its input
    is kept (under a mesh the layer's weight gathers rerun too, as FSDP
    regathers). ``save_qkv``: the layer is split after the projections.
    The attention-and-MLP part is checkpointed, which keeps its inputs:
    the post-rope q, k and the v projection (the reference's ``q_rope``,
    ``k_rope`` and ``v_proj``). The projections run outside the
    checkpoint so that their backward needs no rerun, which keeps more
    than the reference's names: the normed input ``h1`` and the
    ``cfg.dtype`` casts of wq/wk/wv, as the matmuls' saved operands
    (the norm itself is checkpointed and reruns; under a mesh the
    gathered weights are kept).
    """
    if cfg.remat_policy == "full":
        return checkpoint(_layer, cfg, x, p, cos, sin, spmd,
                          use_reentrant=False)
    if spmd is not None:
        p = spmd.weights(p)
    h1 = checkpoint(rms_norm, x, p["attn_norm"], cfg.rms_norm_eps,
                    use_reentrant=False)
    q, k, v = _qkv(cfg, h1, p, cos, sin, spmd)
    return checkpoint(_attn_mlp, cfg, x, q, k, v, p, spmd,
                      use_reentrant=False)


def _layers(cfg: LlamaConfig, params, x, cos, sin, spmd=None):
    """The decoder stack; with ``cfg.remat`` every layer but the last
    ``remat_store_layers`` is rematerialized in the backward."""
    n_store = min(cfg.remat_store_layers, cfg.num_layers) \
        if cfg.remat else 0
    if not cfg.scan_layers and n_store > 0:
        raise ValueError(
            "scan_layers=False and remat_store_layers>0 conflict: "
            "partial remat is a scan-path knob in the reference package "
            "(its unrolled loop opts out of it)")
    n_remat = cfg.num_layers - n_store if cfg.remat else 0
    for l in range(cfg.num_layers):
        layer = _remat_layer if l < n_remat else _layer
        p = layer_params(params, l) if spmd is None else \
            sharded.layer_shards(params["layers"], l)
        x = layer(cfg, x, p, cos, sin, spmd)
    return x


def _rope(cfg: LlamaConfig, seq: int, device):
    return rope_frequencies(cfg.head_dim_, seq, cfg.rope_theta,
                            dtype=cfg.dtype, scaling=cfg.rope_scaling_dict,
                            device=device)


def forward(cfg: LlamaConfig, params: Dict[str, Any],
            tokens: torch.Tensor, mesh=None) -> torch.Tensor:
    """tokens [b, s] -> logits [b, s, vocab] float32. Differentiable;
    with ``cfg.remat`` every layer but the last ``remat_store_layers``
    is rematerialized in the backward. With a ``mesh`` every rank passes
    the same global tokens and DTensor params (``param_shardings``),
    runs its shard of the program and returns the global logits."""
    if mesh is not None:
        spmd, top = _spmd(cfg, params, mesh)
        logits = _final_head(cfg, top, _sharded_hidden(
            cfg, params, top, sharded.global_tensor(tokens), spmd))
        if spmd.tp > 1:
            logits = dc.all_gather(logits, "tp", mesh=mesh, gather_axis=-1)
        return sharded.gather_tokens(logits, spmd)
    x = embed(cfg, params, tokens)
    cos, sin = _rope(cfg, tokens.shape[1], x.device)
    return _final_head(cfg, params, _layers(cfg, params, x, cos, sin))


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


def loss_fn(cfg: LlamaConfig, params, batch: Dict[str, torch.Tensor],
            mesh=None) -> torch.Tensor:
    """batch: {"tokens": [b, s], optional "mask": [b, s]}; next-token
    prediction, the mask read from position 1 on. With a ``mesh`` (see
    ``forward``) every rank returns the global loss, and its
    ``backward()`` leaves each DTensor param's gradient as the unsharded
    loss gives it, placed as the param."""
    tokens = batch["tokens"]
    mask = batch.get("mask")
    if mesh is None:
        logits = forward(cfg, params, tokens[:, :-1])
        return cross_entropy_loss(logits, tokens[:, 1:],
                                  None if mask is None else mask[:, 1:])
    spmd, top = _spmd(cfg, params, mesh)
    tokens = sharded.global_tensor(tokens)
    x = _sharded_hidden(cfg, params, top, tokens[:, :-1], spmd)
    nll = sharded.vocab_nll(_final_head(cfg, top, x), _local_tokens(
        spmd, tokens[:, 1:]), spmd)
    if mask is not None:
        mask = _local_tokens(spmd, sharded.global_tensor(mask)[:, 1:])
    return sharded.objective(sharded.global_mean(nll, mask, spmd), spmd)


def _local_tokens(spmd, x: torch.Tensor) -> torch.Tensor:
    return spmd.seq_chunk(spmd.data_rows(x))


def _spmd(cfg: LlamaConfig, params, mesh, keep=("tp",), pp: bool = False,
          shardings=None):
    """This rank's ``Spmd`` view of the mesh for the params (checked to
    be placed by ``shardings``, default ``param_shardings``), and the
    non-layer weights gathered for compute (the vocabulary kept split
    over tp when tp is kept)."""
    sharded.check_placements(params, shardings or param_shardings(cfg, mesh))
    names = mesh.mesh_dim_names
    tp = mesh.size(names.index("tp")) if "tp" in names and "tp" in keep \
        else 1
    # the column widths tp splits (not the head counts: a rank may hold
    # part of a head, see heads_gathered); the reference's device_put
    # refuses a dim that does not divide
    hd = cfg.head_dim_
    for what, n in (("q projection width", cfg.num_heads * hd),
                    ("kv projection width", cfg.num_kv_heads * hd),
                    ("intermediate_size", cfg.intermediate_size),
                    ("vocab_size", cfg.vocab_size)):
        if n % tp:
            raise ValueError(f"{what}={n} does not split over the mesh's "
                             f"tp={tp}")
    seq_par = cfg.attn_impl in ("ring", "ulysses")
    seq_axis = "sp" if "sp" in names and (seq_par or not pp) else None
    spmd = sharded.Spmd(mesh, keep, seq_axis,
                        sharded.layer_placements(params["layers"]),
                        ("pp",) if pp else ())
    top = {k: sharded.gather(*sharded.dtensor_leaf(v), spmd)
           for k, v in params.items() if k != "layers"}
    return spmd, top


def _sharded_embed(cfg: LlamaConfig, top, ids, spmd):
    x = sharded.vocab_embed(top["embed"], ids, spmd, cfg.vocab_size,
                            cfg.dtype)
    if cfg.embed_scale != 1.0:
        x = x * torch.tensor(cfg.embed_scale, dtype=cfg.dtype)
    return x


def _sharded_hidden(cfg: LlamaConfig, params, top, inputs, spmd,
                    layers=None):
    """What ``layers`` (default ``_layers``; Mixtral passes its own)
    returns for this rank's block [b_local, s_local] of the global
    ``inputs`` [b, s]: its final hidden states."""
    x = _sharded_embed(cfg, top, _local_tokens(spmd, inputs), spmd)
    cos, sin = (spmd.seq_chunk(t, dim=0)
                for t in _rope(cfg, inputs.shape[1], x.device))
    return (layers or _layers)(cfg, params, x, cos, sin, spmd)


def loss_fn_pp(cfg: LlamaConfig, params, batch: Dict[str, torch.Tensor],
               mesh, num_microbatches: int) -> torch.Tensor:
    """Pipeline-parallel next-token loss: the layer stack is split over
    the mesh's ``pp`` axis and microbatches flow through the GPipe
    schedule of ``parallel/pipeline.py`` (``loss.backward()`` reverses
    it). Embed and head run on every stage; only the decoder blocks
    pipeline, their weights gathered whole (tp does not split them here,
    as in the reference's pipeline program). Each microbatch's rows are
    split over the data axes; with ``attn_impl`` ring or ulysses the
    sequence is split over sp too. num_microbatches must divide the
    batch and should be >> pp to amortize the bubble."""
    from ray_tpu_torch.parallel.pipeline import pipeline_apply

    if cfg.remat_store_layers:
        raise ValueError(
            "remat_store_layers applies to the sequential forward only; "
            "under pipeline parallelism every stage is fully "
            "rematerialized (a silent no-op here would mislead tuning)")
    if cfg.remat_policy != "full" or not cfg.scan_layers:
        raise ValueError(
            "remat_policy/scan_layers are sequential-forward knobs; the "
            "pipeline schedule always scans stages under full remat — "
            "drop them rather than read tuning signal from a no-op")
    shape = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    if "pp" not in shape:
        raise ValueError("loss_fn_pp needs a mesh with a 'pp' axis")
    seq_par = cfg.attn_impl in ("ring", "ulysses")
    if seq_par and shape.get("sp", 1) <= 1:
        raise ValueError(
            f"attn_impl={cfg.attn_impl!r} with pipeline parallelism "
            "requires a mesh with an 'sp' axis (> 1)")
    P = shape["pp"]
    if cfg.num_layers % P:
        raise ValueError(
            f"num_layers={cfg.num_layers} must divide the mesh's "
            f"pp={P} (each stage holds num_layers/pp blocks)")
    spmd, top = _spmd(cfg, params, mesh, keep=(), pp=True)
    tokens = sharded.global_tensor(batch["tokens"])
    b, s = tokens.shape[0], tokens.shape[1] - 1
    M = num_microbatches
    if b % M:
        raise ValueError(f"batch {b} must divide into {M} microbatches")

    def local(x):
        # each microbatch's rows split over the data axes, as the
        # reference's P(None, data_axes, sp) splits the [M, b/M, ...] set
        x = x.reshape(M, b // M, *x.shape[1:])
        x = torch.stack([spmd.data_rows(x[m]) for m in range(M)])
        return spmd.seq_chunk(x.flatten(0, 1))

    x = _sharded_embed(cfg, top, local(tokens[:, :-1]), spmd)
    mbs = x.reshape(M, x.shape[0] // M, *x.shape[1:])
    cos, sin = (spmd.seq_chunk(t, dim=0) for t in _rope(cfg, s, x.device))
    # this stage's layers: the stack's gradient is summed over pp (each
    # stage fills its own layers' rows)
    p_idx = dc.axis_index("pp", mesh=mesh)
    per = cfg.num_layers // P
    stack = {k: dc.pvary(sharded.dtensor_leaf(v)[0], "pp", mesh=mesh)[
        p_idx * per:(p_idx + 1) * per] for k, v in params["layers"].items()}

    def stage_fn(layers, xmb):
        layer = _remat_layer if cfg.remat else _layer
        for j in range(per):
            xmb = layer(cfg, xmb, {k: w[j] for k, w in layers.items()},
                        cos, sin, spmd)
        return xmb

    outs = pipeline_apply(stage_fn, stack, mbs, "pp", mesh=mesh)
    # outputs live on the LAST stage; sum so that every stage holds them
    outs = dc.psum(outs * float(p_idx == P - 1), "pp", mesh=mesh)
    nll = sharded.vocab_nll(_final_head(cfg, top, outs.flatten(0, 1)),
                            local(tokens[:, 1:]), spmd)
    mask = batch.get("mask")
    if mask is not None:
        mask = local(sharded.global_tensor(mask)[:, 1:])
    return sharded.objective(sharded.global_mean(nll, mask, spmd), spmd)


# Logical axis names for every parameter (parallel/sharding.py maps them
# onto the mesh; the leading "layer" dim of stacked params is unsharded:
# the pipeline splits it itself).
def logical_axes(cfg: LlamaConfig) -> Dict[str, Any]:
    L = ("layer",)
    return {
        "embed": ("vocab", "embed"),
        "layers": {
            "attn_norm": L + ("embed",),
            "wq": L + ("embed", "qkv"),
            "wk": L + ("embed", "qkv"),
            "wv": L + ("embed", "qkv"),
            "wo": L + ("qkv", "embed"),
            "mlp_norm": L + ("embed",),
            "w_gate": L + ("embed", "mlp"),
            "w_up": L + ("embed", "mlp"),
            "w_down": L + ("mlp", "embed"),
            # qkv biases shard with their projections' column split
            **({"bq": L + ("qkv",), "bk": L + ("qkv",),
                "bv": L + ("qkv",)} if cfg.attn_qkv_bias else {}),
        },
        "final_norm": ("embed",),
        # tied embeddings reuse params["embed"]; no separate lm_head leaf
        **({} if cfg.tie_embeddings else {"lm_head": ("embed", "vocab")}),
    }


def without_layer(tree):
    """A logical-axes tree with the stacked 'layer' dim mapped to None."""
    if isinstance(tree, dict):
        return {k: without_layer(v) for k, v in tree.items()}
    return tuple(None if a == "layer" else a for a in tree)


def logical_axes_without_layer(cfg: LlamaConfig):
    return without_layer(logical_axes(cfg))


def param_shardings(cfg: LlamaConfig, mesh):
    """``Sharding`` (mesh, DTensor placements) tree for params on a mesh;
    ``parallel.device_put_sharded(params, param_shardings(cfg, mesh))``
    places them."""
    from ray_tpu_torch.parallel.sharding import shard_pytree_like

    return shard_pytree_like(logical_axes_without_layer(cfg), mesh)


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
