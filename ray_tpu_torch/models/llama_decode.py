"""KV-cached inference for the Llama model over a dense slot cache:
batched prefill, single-token decode, on-device chained decode chunks.

Counterpart of ``ray_tpu/models/llama_decode.py``. The serving cache is a
fixed tensor ``[layers, slots, max_len, kv_heads, head_dim]``; slot
admission and eviction are host bookkeeping (serve/llm_engine.py).

Where the reference relies on buffer donation, this module updates the
cache IN PLACE: ``insert_many``, ``decode_step`` and ``decode_chunk``
write into the cache tensors they are given and return the same dict.
Out-of-range scatters, which JAX drops (``mode="drop"``), are handled by
selecting the kept rows first: ``active``/``valid`` masks are read on
the host (pass them as numpy or CPU tensors to keep a step free of host
syncs) and position overflows write the old value back.

Prefill attention takes the flash kernel (ops/attention.py) when the
tensors are on CUDA and the bucket is a multiple of 128, else the
reference path, as ``_prefill_attention`` routes in the reference.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch.models.llama import (LlamaConfig, embed, host_array,
                                        layer_params, resolve_device,
                                        to_device)
from ray_tpu_torch.ops.attention import attention_reference, flash_attention
from ray_tpu_torch.ops.layers import (apply_rope, rms_norm, rope_frequencies,
                                      swiglu)

_NEG_INF = -1e30


def init_cache(cfg: LlamaConfig, num_slots: int, max_len: int,
               device=None) -> Dict[str, torch.Tensor]:
    device = resolve_device(device)
    shape = (cfg.num_layers, num_slots, max_len, cfg.num_kv_heads,
             cfg.head_dim_)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}


def _kv_head_sharding(cfg: LlamaConfig, mesh, kv_dim: int):
    """A cache's placements under tensor parallelism: its KV-head dim
    (``kv_dim``) split over ``tp`` when tp divides KVH, replicated
    otherwise (GQA with few KV heads; Q heads still split)."""
    from torch.distributed.tensor import Replicate, Shard

    from ray_tpu_torch.parallel.sharding import Sharding

    names = tuple(mesh.mesh_dim_names)
    tp = mesh.size(names.index("tp")) if "tp" in names else 1
    split = tp > 1 and cfg.num_kv_heads % tp == 0
    sh = Sharding(mesh, tuple(Shard(kv_dim) if split and a == "tp"
                              else Replicate() for a in names))
    return {"k": sh, "v": sh}


def cache_shardings(cfg: LlamaConfig, mesh):
    """Slot-cache placements for tensor-parallel decode: the KV-head dim
    of [L, S, T, KVH, hd] over ``tp`` (each card holds its heads' cache),
    or replicated when tp does not divide KVH. The placements only: the
    engines serve on one card."""
    return _kv_head_sharding(cfg, mesh, 3)


def _w(p, name: str, dtype):
    """Weight leaf in ``dtype``: a plain tensor, or an int8 weight-only
    leaf ``{"q": int8 [..., in, out], "s": f32 [..., 1, out]}``
    dequantized here (plain torch; no fused dequant kernel)."""
    v = p[name]
    if isinstance(v, dict):
        return v["q"].to(dtype) * v["s"].to(dtype)
    return v.to(dtype)


# matmul weights eligible for weight-only quantization
_QUANT_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def quantize_decode_params(params: Dict[str, Any]) -> Dict[str, Any]:
    """Per-output-channel symmetric int8 weight-only quantization:
    each ``[..., in, out]`` matmul weight becomes ``{"q": int8, "s": f32}``
    with ``s = max|w| / 127`` per output column (round half to even, as
    ``jnp.round``)."""

    def qz(w):
        w32 = w.float()
        s = w32.abs().amax(dim=-2, keepdim=True).clamp_min(1e-8) / 127.0
        q = torch.clamp(torch.round(w32 / s), -127, 127).to(torch.int8)
        return {"q": q, "s": s}

    out = dict(params)
    layers = dict(params["layers"])
    for k in _QUANT_KEYS:
        if k in layers:
            layers[k] = qz(layers[k])
    out["layers"] = layers
    if "lm_head" in params:
        out["lm_head"] = qz(params["lm_head"])
    return out


def _project_qkv(cfg: LlamaConfig, p, x):
    """x [b, s, h] -> q [b,s,H,hd], k/v [b,s,KVH,hd] (rope NOT applied)."""
    b, s, _ = x.shape
    hd = cfg.head_dim_
    h1 = rms_norm(x, p["attn_norm"], cfg.rms_norm_eps)
    q = torch.matmul(h1, _w(p, "wq", cfg.dtype))
    k = torch.matmul(h1, _w(p, "wk", cfg.dtype))
    v = torch.matmul(h1, _w(p, "wv", cfg.dtype))
    if "bq" in p:
        q = q + p["bq"].to(cfg.dtype)
        k = k + p["bk"].to(cfg.dtype)
        v = v + p["bv"].to(cfg.dtype)
    return (q.reshape(b, s, cfg.num_heads, hd),
            k.reshape(b, s, cfg.num_kv_heads, hd),
            v.reshape(b, s, cfg.num_kv_heads, hd), h1)


def _mlp(cfg: LlamaConfig, p, x):
    h2 = rms_norm(x, p["mlp_norm"], cfg.rms_norm_eps)
    return swiglu(h2, _w(p, "w_gate", cfg.dtype), _w(p, "w_up", cfg.dtype),
                  _w(p, "w_down", cfg.dtype), act=cfg.mlp_act)


def _out_proj(cfg: LlamaConfig, p, attn):
    return torch.matmul(attn, _w(p, "wo", cfg.dtype))


def _lm_head(cfg: LlamaConfig, params, x_normed):
    """fp32 logits of the cfg.dtype operands of the (tied) LM head."""
    head = (params["embed"].to(cfg.dtype).T if cfg.tie_embeddings
            else _w(params, "lm_head", cfg.dtype))
    return torch.matmul(x_normed.float(), head.float())


def _head(cfg: LlamaConfig, params, x):
    """Final norm + LM head."""
    return _lm_head(cfg, params,
                    rms_norm(x, params["final_norm"], cfg.rms_norm_eps))


def _prefill_attention(cfg: LlamaConfig, q, k, v):
    """Causal prefill attention: the flash kernel when ``prefill_flash``
    allows it (None = the tensors are on CUDA) and the sequence is a
    multiple of 128; any other length takes the reference path."""
    use_flash = cfg.prefill_flash
    if use_flash is None:
        use_flash = q.is_cuda
    if use_flash and q.shape[1] % 128 == 0:
        return flash_attention(q, k, v, causal=True)
    return attention_reference(q, k, v, causal=True)


def _prefill_stack(cfg: LlamaConfig, params, tokens: torch.Tensor):
    """The layer stack over padded prompts tokens [B, P]: returns the
    last layer's output [B, P, h] (before the final norm) and the
    per-layer K/V, each [L, B, P, KVH, hd]."""
    x = embed(cfg, params, tokens)
    B, P = tokens.shape
    cos, sin = rope_frequencies(cfg.head_dim_, P, cfg.rope_theta,
                                dtype=cfg.dtype,
                                scaling=cfg.rope_scaling_dict,
                                device=x.device)
    ks, vs = [], []
    for l in range(cfg.num_layers):
        p = layer_params(params, l)
        q, k, v, _ = _project_qkv(cfg, p, x)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        attn = _prefill_attention(cfg, q, k, v)
        x = x + _out_proj(cfg, p, attn.reshape(B, P, -1))
        x = x + _mlp(cfg, p, x)
        ks.append(k)
        vs.append(v)
    return x, torch.stack(ks), torch.stack(vs)


@torch.no_grad()
def prefill(cfg: LlamaConfig, params, tokens: torch.Tensor
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], torch.Tensor]:
    """One prompt, tokens [1, P] (P the padded bucket length). Returns
    (logits [P, vocab] f32 at every position, kv {"k","v": [L, P, KVH,
    hd]}, the final-normed hidden states [1, P, h]), as the reference's
    ``prefill``: the caller inserts kv into a slot (``insert_sequence``)
    and samples from the logits row of the true last prompt token."""
    tokens = to_device(tokens, params["embed"].device)
    x, k, v = _prefill_stack(cfg, params, tokens)
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    return _lm_head(cfg, params, x[0]), {"k": k[:, 0], "v": v[:, 0]}, x


@torch.no_grad()
def prefill_batch(cfg: LlamaConfig, params, tokens: torch.Tensor,
                  last_idx: torch.Tensor
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """B prompts in one pass. tokens [B, P] (rows padded to the bucket),
    last_idx [B] (each row's last true prompt index). Returns
    (logits_last [B, vocab] f32, kv {"k","v": [L, B, P, KVH, hd]})."""
    x, k, v = _prefill_stack(cfg, params, tokens)
    B, P = tokens.shape
    idx = to_device(last_idx, x.device, torch.long).clamp(0, P - 1)
    x_last = x[torch.arange(B, device=x.device), idx]
    return _head(cfg, params, x_last), {"k": k, "v": v}


@torch.no_grad()
def insert_many(cache: Dict[str, torch.Tensor], kv: Dict[str, torch.Tensor],
                slots, valid) -> Dict[str, torch.Tensor]:
    """Write prefilled rows into their cache slots, in place. kv
    [L, B, P, KVH, hd]; slots [B]; valid [B] bool (invalid rows leave
    the cache untouched)."""
    slots_h = host_array(slots).astype(np.int64)
    keep = np.nonzero(host_array(valid))[0]
    if keep.size:
        dev = cache["k"].device
        rows = to_device(keep, dev)
        dst = to_device(slots_h[keep], dev)
        P = kv["k"].shape[2]
        cache["k"][:, dst, :P] = kv["k"][:, rows]
        cache["v"][:, dst, :P] = kv["v"][:, rows]
    return cache


@torch.no_grad()
def insert_sequence(cache: Dict[str, torch.Tensor],
                    kv: Dict[str, torch.Tensor], slot: int
                    ) -> Dict[str, torch.Tensor]:
    """Write one prefilled sequence's K/V [L, P, KVH, hd] into cache
    slot ``slot`` (positions 0..P-1), in place; cache [L, S, T, KVH,
    hd] with P <= T."""
    slot = int(slot)
    P = kv["k"].shape[1]
    cache["k"][:, slot, :P] = kv["k"]
    cache["v"][:, slot, :P] = kv["v"]
    return cache


def _kept_rows(active, device) -> torch.Tensor:
    """Indices of the active rows, selected on the host."""
    return to_device(np.nonzero(host_array(active))[0], device)


def _decode(cfg: LlamaConfig, params, cache, tokens, positions, rows,
            cos, sin):
    """One decode step over all slots; writes the new K/V of ``rows``
    into the cache in place and returns logits [S, vocab] f32."""
    S = tokens.shape[0]
    T = cache["k"].shape[2]
    hd = cfg.head_dim_
    rep = cfg.num_heads // cfg.num_kv_heads
    x = embed(cfg, params, tokens)[:, None]                 # [S, 1, h]
    pos = positions.long()
    hist = (torch.arange(T, device=x.device)[None]
            < pos[:, None])[:, None, None]                   # [S,1,1,T]
    tgt = pos[rows].clamp(max=T - 1)
    fits = (pos[rows] < T)[:, None, None]
    sqrt_hd = math.sqrt(hd)
    for l in range(cfg.num_layers):
        p = layer_params(params, l)
        ck, cv = cache["k"][l], cache["v"][l]                # [S, T, KVH, hd]
        q, k, v, _ = _project_qkv(cfg, p, x)
        q = apply_rope(q, cos, sin, positions=pos[:, None])
        k = apply_rope(k, cos, sin, positions=pos[:, None])
        k1, v1 = k[:, 0], v[:, 0]                            # [S, KVH, hd]
        q2 = q[:, 0].reshape(S, cfg.num_kv_heads, rep, hd)
        # history from the old cache plus an explicit self term, the
        # reference's HBM discipline (no repeated-KV copy)
        scores = torch.einsum("skrd,stkd->skrt", q2.float(),
                              ck.float()) / sqrt_hd
        scores = torch.where(hist, scores, _NEG_INF)
        self_s = torch.einsum("skrd,skd->skr", q2.float(),
                              k1.float()) / sqrt_hd
        probs = torch.softmax(torch.cat([scores, self_s[..., None]], -1),
                              dim=-1).to(cfg.dtype)
        attn = (torch.einsum("skrt,stkd->skrd", probs[..., :T], cv)
                + probs[..., T][..., None] * v1[:, :, None, :])
        x = x + _out_proj(cfg, p, attn.reshape(S, 1, -1))
        x = x + _mlp(cfg, p, x)
        # the in-flight rows land after this layer's attention read the
        # old cache; a position past the cache rewrites the old value
        ck[rows, tgt] = torch.where(fits, k1[rows], ck[rows, tgt])
        cv[rows, tgt] = torch.where(fits, v1[rows], cv[rows, tgt])
    return _head(cfg, params, x[:, 0])


@torch.no_grad()
def decode_step(cfg: LlamaConfig, params, cache: Dict[str, torch.Tensor],
                tokens: torch.Tensor, positions: torch.Tensor, active
                ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """One token for every slot. tokens [S] (last sampled token),
    positions [S] (where the new token is written), active [S] bool.
    Updates the cache in place; returns (cache, logits [S, vocab])."""
    dev = cache["k"].device
    cos, sin = rope_frequencies(cfg.head_dim_, cache["k"].shape[2],
                                cfg.rope_theta, dtype=cfg.dtype,
                                scaling=cfg.rope_scaling_dict, device=dev)
    logits = _decode(cfg, params, cache, to_device(tokens, dev),
                     to_device(positions, dev), _kept_rows(active, dev),
                     cos, sin)
    return cache, logits


def sample_tokens(logits: torch.Tensor, generator: Optional[torch.Generator],
                  temperature: torch.Tensor, top_k: int = 0) -> torch.Tensor:
    """Per-slot sampling: temperature 0 is greedy; ``top_k`` (0 = off)
    masks everything below the k-th logit. The draws come from
    ``generator``; they cannot reproduce ``jax.random.categorical``."""
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    if top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[:, -1:]
        logits = torch.where(logits < kth, float("-inf"), logits)
    temp = temperature.clamp_min(1e-6)[:, None]
    probs = torch.softmax(logits / temp, dim=-1)
    sampled = torch.multinomial(probs, 1, generator=generator)[:, 0]
    return torch.where(temperature <= 0.0, greedy, sampled.to(torch.int32))


@torch.no_grad()
def decode_chunk(cfg: LlamaConfig, params, cache: Dict[str, torch.Tensor],
                 tokens: torch.Tensor, positions: torch.Tensor, active,
                 num_steps: int, generator: Optional[torch.Generator] = None,
                 temperature: Optional[torch.Tensor] = None, top_k: int = 0,
                 sample: bool = True
                 ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor,
                            torch.Tensor, torch.Tensor]:
    """``num_steps`` decode steps, each step's token feeding the next on
    the device. Returns (cache, out [num_steps, S] int32, next_tokens [S],
    next_positions [S]); the last two chain into the next chunk without
    a host round trip. Inactive slots keep their token and position."""
    dev = cache["k"].device
    S = tokens.shape[0]
    act = to_device(host_array(active).astype(bool), dev)
    rows = _kept_rows(active, dev)
    if temperature is None:
        temperature = torch.zeros((S,), dtype=torch.float32, device=dev)
    cos, sin = rope_frequencies(cfg.head_dim_, cache["k"].shape[2],
                                cfg.rope_theta, dtype=cfg.dtype,
                                scaling=cfg.rope_scaling_dict, device=dev)
    toks = to_device(tokens, dev, torch.int32)
    pos = to_device(positions, dev, torch.int32)
    outs = []
    for _ in range(num_steps):
        logits = _decode(cfg, params, cache, toks, pos, rows, cos, sin)
        if sample:
            nxt = sample_tokens(logits, generator, temperature, top_k)
        else:
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        toks = torch.where(act, nxt, toks)
        pos = pos + act.to(torch.int32)
        outs.append(toks)
    return cache, torch.stack(outs), toks, pos


def make_engine_fns(cfg: LlamaConfig, params, num_slots: int, max_len: int):
    """(prefill_fn(tokens, last_idx), insert_fn(cache, kv, slots, valid),
    decode_fn(cache, tokens, positions, active), chunk_fn(...)) bound to
    cfg and params, the shape the engine expects."""

    def pre_batch(tokens, last_idx):
        return prefill_batch(cfg, params, tokens, last_idx)

    def dec(cache, tokens, positions, active):
        return decode_step(cfg, params, cache, tokens, positions, active)

    def dec_chunk(cache, tokens, positions, active, num_steps,
                  generator=None, temperature=None, top_k=0, sample=True):
        return decode_chunk(cfg, params, cache, tokens, positions, active,
                            num_steps, generator, temperature, top_k, sample)

    return pre_batch, insert_many, dec, dec_chunk
