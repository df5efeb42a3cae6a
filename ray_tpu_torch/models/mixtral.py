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
``n * E * C`` one-hots.

Under a mesh (``forward`` / ``loss_fn(mesh=)``) the experts split over
``ep`` and each rank runs its own on the tokens it holds; the tokens are
the same on every ep rank, so the combine is summed over ep (and over
tp, which splits each expert's MLP as in the dense model). The reference
routes inside one global program, so the capacity counts the global
tokens, slots are assigned in the global token order, and the aux
loss's means are global: each rank offsets its slots by the per-expert
counts of the tokens before its own (an exclusive prefix over the data
and sequence shards), so the same (token, choice) pairs overflow.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch.models import llama, sharded
from ray_tpu_torch.ops.layers import rms_norm
from ray_tpu_torch.parallel import device_collectives as dc


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


def logical_axes(cfg: MixtralConfig) -> Dict[str, Any]:
    """Parameter logical axes; expert dims map to the ep mesh axis."""
    base = llama.logical_axes(cfg)
    L = ("layer",)
    for name in ("w_gate", "w_up", "w_down"):
        base["layers"].pop(name)
    base["layers"].update({
        "router": L + ("embed", "expert"),
        "e_gate": L + ("expert", "embed", "mlp"),
        "e_up": L + ("expert", "embed", "mlp"),
        "e_down": L + ("expert", "mlp", "embed"),
    })
    return base


def logical_axes_without_layer(cfg: MixtralConfig):
    return llama.without_layer(logical_axes(cfg))


def param_shardings(cfg: MixtralConfig, mesh):
    from ray_tpu_torch.parallel.sharding import shard_pytree_like

    return shard_pytree_like(logical_axes_without_layer(cfg), mesh)


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


def route(cfg: MixtralConfig, p, xt: torch.Tensor, spmd=None,
          rows: int = 1):
    """The router of ``moe_layer`` on tokens xt [n, h]: (top_w [n, K]
    renormalised fp32 weights, top_e [n, K] experts, pos [n*K] capacity
    slot of each (token, choice) in flattened order, keep [n*K] whether
    that slot is below the capacity, aux loss). Under a mesh ``xt`` is
    this rank's tokens, ``rows`` batch rows of them; slots, capacity and
    aux are the global ones."""
    n = xt.shape[0]
    E, K = cfg.num_experts, cfg.top_k
    # fp32 products of the cfg.dtype operands (preferred_element_type)
    logits = torch.matmul(xt.float(), p["router"].to(cfg.dtype).float())
    axes = spmd.token_axes if spmd is not None else ()
    mesh = spmd.mesh if spmd is not None else None
    if spmd is not None and spmd.kept("ep"):
        # the router's expert columns are split over ep
        logits = dc.all_gather(logits, "ep", mesh=mesh, gather_axis=-1)
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = torch.topk(probs, K, dim=-1)
    top_w = top_w / top_w.sum(-1, keepdim=True).clamp_min(1e-9)
    n_all = n * (dc.axis_size(axes, mesh=mesh) if axes else 1)
    # Switch aux loss: mean router prob times the fraction of tokens whose
    # top-1 choice is each expert, over every token of the batch
    ce = torch.bincount(top_e[:, 0], minlength=E).to(probs.dtype)
    me = probs.sum(dim=0)
    if axes:
        ce = dc.psum(ce, axes, mesh=mesh)
        me = dc.psum(me, axes, mesh=mesh)
    aux = cfg.router_aux_coef * E * torch.sum((me / n_all) * (ce / n_all))
    # slot of each (token, choice): how many earlier entries of the
    # flattened [n*K] order chose the same expert
    flat_e = top_e.reshape(n * K)
    onehot = F.one_hot(flat_e, E)
    pos = (torch.cumsum(onehot, dim=0) - 1).gather(1, flat_e[:, None])[:, 0]
    if axes:
        pos = pos + _slot_offsets(onehot, flat_e, rows, spmd)
    return top_w, top_e, pos, pos < _capacity(cfg, n_all), aux


def _slot_offsets(onehot, flat_e, rows, spmd):
    """Per entry, the entries of its expert that come before this rank's
    in the global (row, position, choice) order but not in this rank's
    own order: the counts of earlier rows and of earlier sequence blocks
    of the same row, over every rank, less the earlier rows held here."""
    mesh, seq = spmd.mesh, spmd.seq_axis
    per_row = onehot.view(rows, -1, onehot.shape[1]).sum(dim=1)   # [b, E]
    table = per_row[:, None]
    if seq and spmd.size(seq) > 1:
        table = dc.all_gather(table, seq, mesh=mesh, gather_axis=1)
    table = dc.all_gather(table, spmd.data_axes, mesh=mesh, gather_axis=0)
    flat = table.flatten(0, 1)                         # [B * sp, E]
    before = (torch.cumsum(flat, dim=0) - flat).view(table.shape)
    r0 = dc.axis_index(spmd.data_axes, mesh=mesh) * rows
    c = spmd.index(seq) if seq else 0
    here = torch.cumsum(per_row, dim=0) - per_row
    base = before[r0:r0 + rows, c] - here                      # [b, E]
    row_of = torch.arange(flat_e.shape[0], device=flat_e.device) // (
        flat_e.shape[0] // rows)
    return base[row_of, flat_e]


def moe_layer(cfg: MixtralConfig, p, x: torch.Tensor, spmd=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Routed expert MLP. x [b, s, h] -> (out [b, s, h], aux loss). Under
    a mesh, this rank's experts (``p``'s expert stacks) on its tokens,
    summed over ep and tp."""
    b, s, h = x.shape
    n = b * s
    K = cfg.top_k
    xt = x.reshape(n, h)
    top_w, top_e, pos, keep, aux = route(cfg, p, xt, spmd, rows=b)
    axes = spmd.token_axes if spmd is not None else ()
    C = _capacity(cfg, n * (dc.axis_size(axes, mesh=spmd.mesh)
                            if axes else 1))
    E_loc = p["e_gate"].shape[0]
    e0 = spmd.index("ep") * E_loc if spmd is not None and spmd.kept("ep") \
        else 0
    flat_e = top_e.reshape(n * K)
    mine = keep & (flat_e >= e0) & (flat_e < e0 + E_loc)
    # tokens -> this rank's expert buffers [E_loc, C, h]: each kept
    # (token, choice) row lands in its expert's slot; the rest stays zero
    slot = (flat_e - e0).clamp(0, E_loc - 1) * C + pos.clamp(max=C - 1)
    kept = mine.nonzero()[:, 0]
    ex_in = xt.new_zeros(E_loc * C, h).index_copy(
        0, slot[kept], xt[kept // K]).view(E_loc, C, h)
    # the experts' SwiGLU, grouped
    g = torch.matmul(ex_in, p["e_gate"].to(cfg.dtype))
    u = torch.matmul(ex_in, p["e_up"].to(cfg.dtype))
    act = (F.silu(g.float()) * u.float()).to(cfg.dtype)
    ex_out = torch.matmul(act, p["e_down"].to(cfg.dtype))
    # back to tokens, weighted by the gates (a dropped choice weighs 0)
    w = (top_w * mine.view(n, K)).to(cfg.dtype).float()
    back = ex_out.reshape(E_loc * C, h)[slot].view(n, K, h).float()
    out = (back * w[..., None]).sum(dim=1)
    if spmd is not None:
        out = dc.psum(out, spmd.kept("ep", "tp"), mesh=spmd.mesh)
    return out.to(cfg.dtype).reshape(b, s, h), aux


def _layer(cfg: MixtralConfig, x, p, cos, sin, spmd=None):
    """One decoder block: the shared llama attention, then the MoE MLP."""
    if spmd is not None:
        p = spmd.weights(p)
    x = llama.attention_block(cfg, x, p, cos, sin, spmd)
    h2 = rms_norm(x, p["mlp_norm"], cfg.rms_norm_eps)
    moe_out, aux = moe_layer(cfg, p, h2, spmd)
    return x + moe_out, aux


def _layers(cfg: MixtralConfig, params, x, cos, sin, spmd=None):
    aux = x.new_zeros((), dtype=torch.float32)
    for l in range(cfg.num_layers):
        p = llama.layer_params(params, l) if spmd is None else \
            sharded.layer_shards(params["layers"], l)
        if cfg.remat:
            x, a = checkpoint(_layer, cfg, x, p, cos, sin, spmd,
                              use_reentrant=False)
        else:
            x, a = _layer(cfg, x, p, cos, sin, spmd)
        aux = aux + a
    return x, aux


def _spmd(cfg: MixtralConfig, params, mesh):
    names = mesh.mesh_dim_names
    ep = mesh.size(names.index("ep")) if "ep" in names else 1
    if cfg.num_experts % ep:
        raise ValueError(f"num_experts={cfg.num_experts} does not split "
                         f"over the mesh's ep={ep}")
    return llama._spmd(cfg, params, mesh, keep=("tp", "ep"),
                       shardings=param_shardings(cfg, mesh))


def _check_knobs(cfg: MixtralConfig) -> None:
    if cfg.remat_policy != "full" or not cfg.scan_layers:
        raise ValueError(
            "remat_policy/scan_layers are dense-Llama knobs; the MoE "
            "forward always scans under full remat — drop them rather "
            "than read tuning signal from a no-op")


def _sharded(cfg: MixtralConfig, params, inputs, mesh):
    """(spmd, gathered non-layer weights, this rank's final hidden
    states, aux) for the global ``inputs``."""
    spmd, top = _spmd(cfg, params, mesh)
    x, aux = llama._sharded_hidden(cfg, params, top, inputs, spmd, _layers)
    return spmd, top, x, aux


def forward(cfg: MixtralConfig, params, tokens: torch.Tensor, mesh=None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens [b, s] -> (logits [b, s, vocab] fp32, aux loss summed over
    the layers). Differentiable; with ``cfg.remat`` every layer reruns
    its forward in the backward. With a ``mesh``, as ``llama.forward``:
    every rank returns the global logits."""
    _check_knobs(cfg)
    if mesh is not None:
        spmd, top, x, aux = _sharded(cfg, params,
                                     sharded.global_tensor(tokens), mesh)
        logits = llama._final_head(cfg, top, x)
        if spmd.tp > 1:
            logits = dc.all_gather(logits, "tp", mesh=mesh, gather_axis=-1)
        return sharded.gather_tokens(logits, spmd), aux
    x = llama.embed(cfg, params, tokens)
    cos, sin = llama._rope(cfg, tokens.shape[1], x.device)
    x, aux = _layers(cfg, params, x, cos, sin)
    return llama._final_head(cfg, params, x), aux


def loss_fn(cfg: MixtralConfig, params, batch: Dict[str, torch.Tensor],
            mesh=None) -> torch.Tensor:
    """Next-token cross entropy plus the routers' aux loss; with a
    ``mesh``, the global loss on every rank (see ``llama.loss_fn``)."""
    tokens = batch["tokens"]
    mask = batch.get("mask")
    if mesh is None:
        logits, aux = forward(cfg, params, tokens[:, :-1])
        return llama.cross_entropy_loss(
            logits, tokens[:, 1:], None if mask is None else mask[:, 1:]) \
            + aux
    _check_knobs(cfg)
    tokens = sharded.global_tensor(tokens)
    spmd, top, x, aux = _sharded(cfg, params, tokens[:, :-1], mesh)
    nll = sharded.vocab_nll(llama._final_head(cfg, top, x),
                            llama._local_tokens(spmd, tokens[:, 1:]), spmd)
    if mask is not None:
        mask = llama._local_tokens(spmd,
                                   sharded.global_tensor(mask)[:, 1:])
    return sharded.objective(sharded.global_mean(nll, mask, spmd) + aux,
                             spmd)
