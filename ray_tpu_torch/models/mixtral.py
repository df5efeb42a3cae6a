"""Mixtral-style sparse MoE transformer.

Counterpart of ``ray_tpu/models/mixtral.py``: the Llama backbone
(``llama.attention_block``: rms_norm, rope, GQA, the flash kernels on
the card) with the dense MLP replaced by a top-k routed mixture of
SwiGLU experts, stacked ``[L, E, ...]``, under static-capacity dispatch
and the Switch load-balancing loss.

``moe_layer`` keeps the reference's semantics: a softmax router in fp32,
the top-k weights renormalised, the aux loss on the top-1 assignment,
and capacity slots assigned by a cumulative sum over the flattened
``[n*K]`` (token, choice) order, so that the same (token, choice) pairs
overflow and are dropped. The reference builds dense one-hot dispatch
and combine tensors (``[n, E, C]``) for the TPU's matrix unit; here the
same assignment moves rows by index (``index_copy`` into the expert
buffers, a gather back), which computes the same sums without the
``n * E * C`` one-hots. ``logical_axes`` and ``param_shardings`` wait for
the port of ``parallel/``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch.models import llama
from ray_tpu_torch.ops.layers import rms_norm, rope_frequencies


@dataclass(frozen=True)
class MixtralConfig(llama.LlamaConfig):
    num_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    @classmethod
    def mixtral_8x7b(cls, **kw) -> "MixtralConfig":
        cfg = cls(hidden_size=4096, intermediate_size=14336, num_layers=32,
                  num_heads=32, num_kv_heads=8, vocab_size=32000,
                  num_experts=8, top_k=2)
        return replace(cfg, **kw)

    @classmethod
    def moe_proxy(cls, **kw) -> "MixtralConfig":
        cfg = cls(hidden_size=1024, intermediate_size=2816, num_layers=8,
                  num_heads=8, num_kv_heads=4, vocab_size=32000,
                  num_experts=8, top_k=2)
        return replace(cfg, **kw)

    @classmethod
    def tiny(cls, **kw) -> "MixtralConfig":
        cfg = cls(vocab_size=256, hidden_size=64, intermediate_size=128,
                  num_layers=2, num_heads=4, num_kv_heads=2,
                  max_seq_len=128, dtype=torch.float32, remat=False,
                  num_experts=4, top_k=2)
        return replace(cfg, **kw)


def init_params(cfg: MixtralConfig, seed: int = 0,
                device=None) -> Dict[str, Any]:
    """``llama.init_params`` without the dense MLP, plus the router and
    the expert stacks (truncated normal, fan-in scaled) from a second
    generator seeded from ``seed``; the reference's keys and shapes."""
    device = llama.resolve_device(device)
    params = llama.init_params(cfg, seed, device)
    for name in ("w_gate", "w_up", "w_down"):
        params["layers"].pop(name)
    h, ffn, L, E = (cfg.hidden_size, cfg.intermediate_size,
                    cfg.num_layers, cfg.num_experts)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) * 1_000_003 + 7)
    pd = cfg.param_dtype
    params["layers"].update({
        "router": llama.trunc_normal_init(gen, (L, h, E), h, pd),
        "e_gate": llama.trunc_normal_init(gen, (L, E, h, ffn), h, pd),
        "e_up": llama.trunc_normal_init(gen, (L, E, h, ffn), h, pd),
        "e_down": llama.trunc_normal_init(gen, (L, E, ffn, h), ffn, pd),
    })
    return params


def _capacity(cfg: MixtralConfig, num_tokens: int) -> int:
    cap = int(math.ceil(cfg.capacity_factor * num_tokens * cfg.top_k
                        / cfg.num_experts))
    return max(8, ((cap + 7) // 8) * 8)  # a multiple of 8, as the reference


def route(cfg: MixtralConfig, p, xt: torch.Tensor):
    """The router of ``moe_layer`` on tokens xt [n, h]: (top_w [n, K]
    renormalised fp32 weights, top_e [n, K] experts, pos [n*K] capacity
    slot of each (token, choice) in flattened order, keep [n*K] whether
    that slot is below the capacity, aux loss)."""
    n = xt.shape[0]
    E, K = cfg.num_experts, cfg.top_k
    # fp32 products of the cfg.dtype operands (preferred_element_type)
    logits = torch.matmul(xt.float(), p["router"].to(cfg.dtype).float())
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = torch.topk(probs, K, dim=-1)
    top_w = top_w / top_w.sum(-1, keepdim=True).clamp_min(1e-9)
    # Switch aux loss: mean router prob times the fraction of tokens whose
    # top-1 choice is each expert
    ce = torch.bincount(top_e[:, 0], minlength=E).to(probs.dtype) / n
    aux = cfg.router_aux_coef * E * torch.sum(probs.mean(dim=0) * ce)
    # slot of each (token, choice): how many earlier entries of the
    # flattened [n*K] order chose the same expert
    flat_e = top_e.reshape(n * K)
    onehot = F.one_hot(flat_e, E)
    pos = (torch.cumsum(onehot, dim=0) - 1).gather(1, flat_e[:, None])[:, 0]
    return top_w, top_e, pos, pos < _capacity(cfg, n), aux


def moe_layer(cfg: MixtralConfig, p, x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Routed expert MLP. x [b, s, h] -> (out [b, s, h], aux loss)."""
    b, s, h = x.shape
    n = b * s
    E, K = cfg.num_experts, cfg.top_k
    C = _capacity(cfg, n)
    xt = x.reshape(n, h)
    top_w, top_e, pos, keep, aux = route(cfg, p, xt)
    # tokens -> expert buffers [E, C, h]: each kept (token, choice) row
    # lands in its expert's slot; the rest of the buffer stays zero
    slot = top_e.reshape(n * K) * C + pos.clamp(max=C - 1)
    kept = keep.nonzero()[:, 0]
    ex_in = xt.new_zeros(E * C, h).index_copy(0, slot[kept],
                                              xt[kept // K]).view(E, C, h)
    # the experts' SwiGLU, grouped
    g = torch.matmul(ex_in, p["e_gate"].to(cfg.dtype))
    u = torch.matmul(ex_in, p["e_up"].to(cfg.dtype))
    act = (F.silu(g.float()) * u.float()).to(cfg.dtype)
    ex_out = torch.matmul(act, p["e_down"].to(cfg.dtype))
    # back to tokens, weighted by the gates (a dropped choice weighs 0)
    w = (top_w * keep.view(n, K)).to(cfg.dtype).float()
    back = ex_out.reshape(E * C, h)[slot].view(n, K, h).float()
    out = (back * w[..., None]).sum(dim=1).to(cfg.dtype)
    return out.reshape(b, s, h), aux


def _layer(cfg: MixtralConfig, x, p, cos, sin):
    """One decoder block: the shared llama attention, then the MoE MLP."""
    x = llama.attention_block(cfg, x, p, cos, sin)
    h2 = rms_norm(x, p["mlp_norm"], cfg.rms_norm_eps)
    moe_out, aux = moe_layer(cfg, p, h2)
    return x + moe_out, aux


def forward(cfg: MixtralConfig, params, tokens: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens [b, s] -> (logits [b, s, vocab] fp32, aux loss summed over
    the layers). Differentiable; with ``cfg.remat`` every layer reruns
    its forward in the backward."""
    if cfg.remat_policy != "full" or not cfg.scan_layers:
        raise ValueError(
            "remat_policy/scan_layers are dense-Llama knobs; the MoE "
            "forward always scans under full remat — drop them rather "
            "than read tuning signal from a no-op")
    x = llama.embed(cfg, params, tokens)
    cos, sin = rope_frequencies(cfg.head_dim_, tokens.shape[1],
                                cfg.rope_theta, dtype=cfg.dtype,
                                scaling=cfg.rope_scaling_dict,
                                device=x.device)
    aux = x.new_zeros((), dtype=torch.float32)
    for l in range(cfg.num_layers):
        p = llama.layer_params(params, l)
        if cfg.remat:
            x, a = checkpoint(_layer, cfg, x, p, cos, sin,
                              use_reentrant=False)
        else:
            x, a = _layer(cfg, x, p, cos, sin)
        aux = aux + a
    return llama._final_head(cfg, params, x), aux


def loss_fn(cfg: MixtralConfig, params, batch: Dict[str, torch.Tensor]
            ) -> torch.Tensor:
    """Next-token cross entropy plus the routers' aux loss."""
    tokens = batch["tokens"]
    logits, aux = forward(cfg, params, tokens[:, :-1])
    mask = batch.get("mask")
    if mask is not None:
        mask = mask[:, 1:]
    return llama.cross_entropy_loss(logits, tokens[:, 1:], mask) + aux
