"""Paged-KV inference for the Llama family: chunked prefill and
block-table decode over a shared page pool.

Counterpart of ``ray_tpu/models/llama_paged.py``. The cache is a POOL
``[L, P, KVH, page, hd]``; a sequence owns an ordered page list (its
block-table row, kept on the host by serve/paged_engine.py).

- ``prefill_chunk`` runs one prompt chunk against the history pages plus
  itself causally, in plain PyTorch (the reference does this step in
  XLA, not Pallas).
- ``paged_decode_step`` takes history attention from the page-walk
  kernel (ops/paged_attention.py: the CUDA kernel on the card, its plain
  version on the CPU), or from the plain gather when the caller passes
  ``use_kernel=False`` as the reference's switch, and merges the
  in-flight token's self term into the ``(acc, m, l)`` triple exactly.

The pool is updated IN PLACE where the reference donates it. Rows the
reference drops (pad rows of a chunk, inactive slots) are removed on the
host before the scatter: torch has no drop mode, and an inactive slot's
stale block-table row may name a page another slot now writes.

Under a tensor-parallel mesh (``make_paged_engine_fns(mesh=)``,
``init_paged_cache(mesh=)``) each rank holds its KV-head shard of the
pool and runs the dense engine's Megatron split
(``llama_decode``'s module docstring); the paged kernel runs on the
rank's KV heads. Where tp does not divide the KV heads the pool is
replicated and every rank attends every head (q gathered whole), then
keeps its block of the output.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from ray_tpu_torch.models import sharded
from ray_tpu_torch.models.llama import (LlamaConfig, host_array, layer_params,
                                        resolve_device, to_device)
from ray_tpu_torch.models.llama_decode import (_embed, _head, _kept_rows,
                                               _kv_head_sharding, _mlp,
                                               _out_proj, _project_qkv,
                                               local_cache, pick_tokens,
                                               serving_params)
from ray_tpu_torch.ops.layers import apply_rope, rope_frequencies
from ray_tpu_torch.ops.paged_attention import (clamp_page_ids,
                                               paged_attention,
                                               paged_attention_reference)

_NEG_INF = -1e30


def init_paged_cache(cfg: LlamaConfig, num_pages: int, page_size: int,
                     device=None, mesh=None) -> Dict[str, torch.Tensor]:
    """Pool ``[L, P, KVH, page, hd]``: one page of one kv head is a
    contiguous ``page * hd`` run, which the kernel stages whole. With a
    ``mesh``, DTensors placed by ``paged_cache_shardings`` (a rank's KV
    heads are then a contiguous pool of their own)."""
    device = resolve_device(device)
    shape = (cfg.num_layers, num_pages, cfg.num_kv_heads, page_size,
             cfg.head_dim_)
    if mesh is not None:
        return {k: sharded.zeros_sharded(shape, cfg.dtype, device, sh)
                for k, sh in paged_cache_shardings(cfg, mesh).items()}
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}


def paged_cache_shardings(cfg: LlamaConfig, mesh):
    """Page-pool placements under tensor parallelism: the KV-head dim of
    [L, P, KVH, page, hd] over ``tp`` (the dense cache's rule), or
    replicated when tp does not divide KVH. The placements only."""
    return _kv_head_sharding(cfg, mesh, 2)


@torch.no_grad()
def prefill_chunk(cfg: LlamaConfig, params, cache: Dict[str, torch.Tensor],
                  tokens: torch.Tensor, block_table: torch.Tensor,
                  ctx0: int, n_valid: int, spmd=None
                  ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """One prompt chunk of ONE sequence: tokens [1, C] (padded) at global
    positions ctx0 .. ctx0+n_valid-1; block_table [MAXP] covers the pages
    allocated so far (history and this chunk). Attends to positions
    < ctx0 through the pages plus itself causally, writes its valid rows'
    K/V into the pool in place, and returns (cache, logits [1, vocab]
    f32 at the chunk's last valid token)."""
    ctx0, n_valid = int(ctx0), int(n_valid)
    pool = local_cache(cache)
    dev = pool["k"].device
    C = tokens.shape[1]
    hd = cfg.head_dim_
    num_pages, KVH, page = pool["k"].shape[1:4]
    bt = clamp_page_ids(to_device(block_table, dev), num_pages)
    MAXP = bt.shape[0]
    T_hist = MAXP * page
    x = _embed(cfg, params, to_device(tokens, dev), spmd)    # [1, C, h]
    cos, sin = rope_frequencies(hd, T_hist, cfg.rope_theta, dtype=cfg.dtype,
                                scaling=cfg.rope_scaling_dict, device=dev)
    pos_c = ctx0 + torch.arange(C, device=dev)                # [C]
    hist_mask = (torch.arange(T_hist, device=dev) < ctx0)[None, None, None]
    ci = torch.arange(C, device=dev)
    self_mask = (ci[:, None] >= ci[None, :])[:, None, None]   # [C,1,1,C]
    scale = 1.0 / math.sqrt(hd)
    # pool slots of the valid rows: page bt[pos // page], offset pos % page
    pos_v = pos_c[:n_valid]
    pidx = bt[(pos_v // page).clamp(0, MAXP - 1)]
    poff = pos_v % page
    for l in range(cfg.num_layers):
        p = layer_params(params, l)
        kp, vp = pool["k"][l], pool["v"][l]                   # [P,KVH,pg,hd]
        q, k, v, _ = _project_qkv(cfg, p, x, spmd)
        q = apply_rope(q, cos, sin, positions=pos_c[None])
        k = apply_rope(k, cos, sin, positions=pos_c[None])
        ks = kp[bt].movedim(1, 0).reshape(KVH, T_hist, hd)
        vs = vp[bt].movedim(1, 0).reshape(KVH, T_hist, hd)
        q2 = q[0].reshape(C, KVH, -1, hd).float()
        s_hist = torch.einsum("ckgd,ktd->ckgt", q2, ks.float()) * scale
        s_hist = torch.where(hist_mask, s_hist, _NEG_INF)
        s_self = torch.einsum("ckgd,ukd->ckgu", q2, k[0].float()) * scale
        s_self = torch.where(self_mask, s_self, _NEG_INF)
        probs = torch.softmax(torch.cat([s_hist, s_self], -1),
                              dim=-1).to(cfg.dtype)
        attn = (torch.einsum("ckgt,ktd->ckgd", probs[..., :T_hist], vs)
                + torch.einsum("ckgu,ukd->ckgd", probs[..., T_hist:], v[0]))
        x = x + _out_proj(cfg, p, attn.reshape(1, C, -1), spmd)
        x = x + _mlp(cfg, p, x, spmd)
        kp[pidx, :, poff] = k[0, :n_valid]
        vp[pidx, :, poff] = v[0, :n_valid]
    x_last = x[:, max(n_valid - 1, 0)]                        # [1, h]
    return cache, _head(cfg, params, x_last, spmd)


def history_attention(use_kernel: Optional[bool], device):
    """The reference's ``use_kernel`` switch: ``None`` takes
    ``paged_attention`` (the kernel on CUDA tensors, its plain version on
    CPU ones), ``False`` the gather ``paged_attention_reference`` on
    either device, ``True`` the kernel, which needs a CUDA device."""
    if use_kernel is None:
        return paged_attention
    if not use_kernel:
        return paged_attention_reference
    if torch.device(device).type != "cuda":
        raise ValueError(
            f"use_kernel=True: the paged kernel runs on CUDA tensors only, "
            f"not {torch.device(device).type}")
    return paged_attention


def _paged_decode(cfg: LlamaConfig, params, cache, tokens, positions, rows,
                  block_table, cos, sin, use_kernel=None, spmd=None):
    """One paged decode step on the (local) pool; returns logits [S,
    vocab] f32."""
    S = tokens.shape[0]
    hd = cfg.head_dim_
    page = cache["k"].shape[3]
    MAXP = block_table.shape[1]
    scale = 1.0 / math.sqrt(hd)
    x = _embed(cfg, params, tokens, spmd)[:, None]            # [S, 1, h]
    pos = positions.long()
    # pool slots of the active rows' new tokens
    r_pos = pos[rows]
    pidx = block_table[rows, (r_pos // page).clamp(0, MAXP - 1)].long()
    poff = r_pos % page
    attend = history_attention(use_kernel, x.device)
    for l in range(cfg.num_layers):
        p = layer_params(params, l)
        kp, vp = cache["k"][l], cache["v"][l]
        q, k, v, _ = _project_qkv(cfg, p, x, spmd)
        q = apply_rope(q, cos, sin, positions=pos[:, None])
        k = apply_rope(k, cos, sin, positions=pos[:, None])
        k1, v1 = k[:, 0], v[:, 0]                             # [S, KVH, hd]
        q2 = q[:, 0].reshape(S, k1.shape[1], -1, hd)
        acc, m, lsum = attend(q2, kp, vp, block_table, positions)
        # exact merge of the in-flight token's self term
        s_self = torch.einsum("skgd,skd->skg", q2.float(),
                              k1.float()) * scale
        m_tot = torch.maximum(m, s_self)
        alpha = torch.exp(m - m_tot)
        p_self = torch.exp(s_self - m_tot)
        num = acc * alpha[..., None] + p_self[..., None] * v1[:, :, None, :].float()
        den = lsum * alpha + p_self
        attn = (num / den.clamp_min(1e-30)[..., None]).to(cfg.dtype)
        x = x + _out_proj(cfg, p, attn.reshape(S, 1, -1), spmd)
        x = x + _mlp(cfg, p, x, spmd)
        kp[pidx, :, poff] = k1[rows]
        vp[pidx, :, poff] = v1[rows]
    return _head(cfg, params, x[:, 0], spmd)


def _decode_inputs(cfg, cache, tokens, positions, block_table):
    dev = cache["k"].device
    page = cache["k"].shape[3]
    bt = to_device(block_table, dev, torch.int32).contiguous()
    cos, sin = rope_frequencies(cfg.head_dim_, bt.shape[1] * page,
                                cfg.rope_theta, dtype=cfg.dtype,
                                scaling=cfg.rope_scaling_dict, device=dev)
    return (dev, bt, cos, sin, to_device(tokens, dev, torch.int32),
            to_device(positions, dev, torch.int32))


@torch.no_grad()
def paged_decode_step(cfg: LlamaConfig, params,
                      cache: Dict[str, torch.Tensor], tokens: torch.Tensor,
                      positions: torch.Tensor, active,
                      block_table: torch.Tensor,
                      use_kernel: Optional[bool] = None, spmd=None
                      ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """One token for every slot over paged KV. tokens/positions/active
    [S] as the dense decode_step; block_table [S, MAXP]; ``use_kernel``
    as ``history_attention``. The new K/V of active slots lands in the
    pool in place. Returns (cache, logits)."""
    pool = local_cache(cache)
    dev, bt, cos, sin, toks, pos = _decode_inputs(cfg, pool, tokens,
                                                  positions, block_table)
    logits = _paged_decode(cfg, params, pool, toks, pos,
                           _kept_rows(active, dev), bt, cos, sin,
                           use_kernel, spmd)
    return cache, logits


@torch.no_grad()
def paged_decode_chunk(cfg: LlamaConfig, params,
                       cache: Dict[str, torch.Tensor], tokens: torch.Tensor,
                       positions: torch.Tensor, active,
                       block_table: torch.Tensor, num_steps: int,
                       generator: Optional[torch.Generator] = None,
                       temperature: Optional[torch.Tensor] = None,
                       top_k: int = 0, sample: bool = True,
                       use_kernel: Optional[bool] = None, spmd=None
                       ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor,
                                  torch.Tensor, torch.Tensor]:
    """``num_steps`` paged decode steps chained on the device, with the
    dense decode_chunk's return contract. The block table must already
    cover positions + num_steps tokens of every active slot."""
    pool = local_cache(cache)
    dev, bt, cos, sin, toks, pos = _decode_inputs(cfg, pool, tokens,
                                                  positions, block_table)
    S = toks.shape[0]
    act = to_device(host_array(active).astype(bool), dev)
    rows = _kept_rows(active, dev)
    if temperature is None:
        temperature = torch.zeros((S,), dtype=torch.float32, device=dev)
    outs = []
    for _ in range(num_steps):
        logits = _paged_decode(cfg, params, pool, toks, pos, rows, bt,
                               cos, sin, use_kernel, spmd)
        nxt = pick_tokens(logits, generator, temperature, top_k, sample,
                          spmd)
        toks = torch.where(act, nxt, toks)
        pos = pos + act.to(torch.int32)
        outs.append(toks)
    return cache, torch.stack(outs), toks, pos


def make_paged_engine_fns(cfg: LlamaConfig, params, mesh=None,
                          use_kernel: Optional[bool] = None):
    """(prefill_fn(cache, tokens, block_table, ctx0, n_valid),
    chunk_fn(cache, tokens, positions, active, block_table, num_steps,
    generator, temperature, top_k, sample)) bound to cfg, params and
    ``use_kernel`` (``history_attention``'s switch; ``True`` raises here
    for params off the card). Pool geometry lives in the cache and table
    tensors. ``mesh``: tensor-parallel serving, as
    ``llama_decode.make_engine_fns``; the kernel keeps running, on each
    rank's KV heads (the reference turns its kernel off under a mesh,
    which GSPMD cannot partition)."""
    spmd = None
    if mesh is not None:
        spmd, params = serving_params(cfg, params, mesh)
    history_attention(use_kernel, params["embed"].device)

    def pre(cache, tokens, block_table, ctx0, n_valid):
        return prefill_chunk(cfg, params, cache, tokens, block_table, ctx0,
                             n_valid, spmd)

    def dec_chunk(cache, tokens, positions, active, block_table, num_steps,
                  generator=None, temperature=None, top_k=0, sample=True):
        return paged_decode_chunk(cfg, params, cache, tokens, positions,
                                  active, block_table, num_steps, generator,
                                  temperature, top_k, sample, use_kernel,
                                  spmd)

    return pre, dec_chunk
