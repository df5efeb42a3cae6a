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

Tensor-parallel serving (``make_engine_fns(mesh=)``, ``init_cache(mesh=)``)
is the reference's Megatron split run as explicit SPMD: every rank of
the mesh's ``tp`` axis runs the same step on its weight shards
(``param_shardings``) and its KV-head shard of the cache
(``cache_shardings``), with a ``psum`` after ``wo`` and after
``w_down``, the vocabulary of embed and LM head split, and the logits
all-gathered before the argmax; a sampled token is drawn by tp rank 0
and broadcast. The kernels run on each rank's local heads. Where tp does
not divide the KV heads the cache is replicated and each rank gathers
q/k/v whole (``llama.heads_gathered``).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch.models import sharded
from ray_tpu_torch.models.llama import (LlamaConfig, _sharded_embed,
                                        _tp_sum, embed, heads_gathered,
                                        host_array,
                                        layer_params, param_shardings,
                                        resolve_device, to_device)
from ray_tpu_torch.ops.attention import attention_reference, flash_attention
from ray_tpu_torch.ops.layers import (apply_rope, rms_norm, rope_frequencies,
                                      swiglu)
from ray_tpu_torch.parallel import device_collectives as dc
from ray_tpu_torch.parallel import device_put_sharded

_NEG_INF = -1e30


def init_cache(cfg: LlamaConfig, num_slots: int, max_len: int,
               device=None, mesh=None) -> Dict[str, torch.Tensor]:
    """Zero slot cache [L, S, T, KVH, hd]; with a ``mesh``, DTensors
    placed by ``cache_shardings`` (each rank allocates its shard only)."""
    device = resolve_device(device)
    shape = (cfg.num_layers, num_slots, max_len, cfg.num_kv_heads,
             cfg.head_dim_)
    if mesh is not None:
        return {k: sharded.zeros_sharded(shape, cfg.dtype, device, sh)
                for k, sh in cache_shardings(cfg, mesh).items()}
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}


def local_cache(cache: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """This rank's shards of a cache (DTensor leaves' local tensors, which
    share their storage: writes land in the DTensors)."""
    return {k: v.to_local() if hasattr(v, "to_local") else v
            for k, v in cache.items()}


def serving_spmd(mesh) -> Optional[sharded.Spmd]:
    """The ``Spmd`` view the serving functions take: tp's shards stay
    local; every other axis of the mesh is gathered."""
    return None if mesh is None else sharded.Spmd(mesh, keep=("tp",))


def serving_params(cfg: LlamaConfig, params, mesh):
    """(Spmd, this rank's compute weights) for serving on ``mesh``:
    ``params`` are DTensors placed by ``param_shardings``, or a plain
    tree every rank holds whole (placed here, as the reference's
    ``device_put``)."""
    shardings = param_shardings(cfg, mesh)
    if not hasattr(params["embed"], "to_local"):
        params = device_put_sharded(params, shardings)
    sharded.check_placements(params, shardings)
    spmd = serving_spmd(mesh)
    return spmd, sharded.local_tree(params, spmd)


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


def _project_qkv(cfg: LlamaConfig, p, x, spmd=None):
    """x [b, s, h] -> q [b,s,H,hd], k/v [b,s,KVH,hd] (rope NOT applied);
    under tp a rank's heads, or every head (``heads_gathered``)."""
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
    if heads_gathered(cfg, spmd):
        q, k, v = (spmd.tp_gather(t) for t in (q, k, v))
    return (q.reshape(b, s, -1, hd), k.reshape(b, s, -1, hd),
            v.reshape(b, s, -1, hd), h1)


def _mlp(cfg: LlamaConfig, p, x, spmd=None):
    h2 = rms_norm(x, p["mlp_norm"], cfg.rms_norm_eps)
    return _tp_sum(spmd, swiglu(
        h2, _w(p, "w_gate", cfg.dtype), _w(p, "w_up", cfg.dtype),
        _w(p, "w_down", cfg.dtype), act=cfg.mlp_act))


def _out_proj(cfg: LlamaConfig, p, attn, spmd=None):
    if heads_gathered(cfg, spmd):
        attn = spmd.tp_block(attn)
    return _tp_sum(spmd, torch.matmul(attn, _w(p, "wo", cfg.dtype)))


def _embed(cfg: LlamaConfig, params, tokens, spmd=None):
    if spmd is None:
        return embed(cfg, params, tokens)
    return _sharded_embed(cfg, params, tokens, spmd)


def _lm_head(cfg: LlamaConfig, params, x_normed, spmd=None):
    """fp32 logits of the cfg.dtype operands of the (tied) LM head; under
    tp each rank's vocabulary block, gathered."""
    head = (params["embed"].to(cfg.dtype).T if cfg.tie_embeddings
            else _w(params, "lm_head", cfg.dtype))
    logits = torch.matmul(x_normed.float(), head.float())
    if spmd is not None and spmd.tp > 1:
        logits = spmd.tp_gather(logits)
    return logits


def _head(cfg: LlamaConfig, params, x, spmd=None):
    """Final norm + LM head."""
    return _lm_head(cfg, params,
                    rms_norm(x, params["final_norm"], cfg.rms_norm_eps),
                    spmd)


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


def _prefill_stack(cfg: LlamaConfig, params, tokens: torch.Tensor,
                   spmd=None):
    """The layer stack over padded prompts tokens [B, P]: returns the
    last layer's output [B, P, h] (before the final norm) and the
    per-layer K/V, each [L, B, P, KVH, hd] (a rank's KV heads under
    tp)."""
    x = _embed(cfg, params, tokens, spmd)
    B, P = tokens.shape
    cos, sin = rope_frequencies(cfg.head_dim_, P, cfg.rope_theta,
                                dtype=cfg.dtype,
                                scaling=cfg.rope_scaling_dict,
                                device=x.device)
    ks, vs = [], []
    for l in range(cfg.num_layers):
        p = layer_params(params, l)
        q, k, v, _ = _project_qkv(cfg, p, x, spmd)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        attn = _prefill_attention(cfg, q, k, v)
        x = x + _out_proj(cfg, p, attn.reshape(B, P, -1), spmd)
        x = x + _mlp(cfg, p, x, spmd)
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
                  last_idx: torch.Tensor, spmd=None
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """B prompts in one pass. tokens [B, P] (rows padded to the bucket),
    last_idx [B] (each row's last true prompt index). Returns
    (logits_last [B, vocab] f32, kv {"k","v": [L, B, P, KVH, hd]});
    with ``spmd`` (``serving_params``) on this rank's shards."""
    x, k, v = _prefill_stack(cfg, params, tokens, spmd)
    B, P = tokens.shape
    idx = to_device(last_idx, x.device, torch.long).clamp(0, P - 1)
    x_last = x[torch.arange(B, device=x.device), idx]
    return _head(cfg, params, x_last, spmd), {"k": k, "v": v}


@torch.no_grad()
def insert_many(cache: Dict[str, torch.Tensor], kv: Dict[str, torch.Tensor],
                slots, valid) -> Dict[str, torch.Tensor]:
    """Write prefilled rows into their cache slots, in place. kv
    [L, B, P, KVH, hd]; slots [B]; valid [B] bool (invalid rows leave
    the cache untouched)."""
    slots_h = host_array(slots).astype(np.int64)
    keep = np.nonzero(host_array(valid))[0]
    if keep.size:
        c = local_cache(cache)
        dev = c["k"].device
        rows = to_device(keep, dev)
        dst = to_device(slots_h[keep], dev)
        P = kv["k"].shape[2]
        c["k"][:, dst, :P] = kv["k"][:, rows]
        c["v"][:, dst, :P] = kv["v"][:, rows]
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
            cos, sin, spmd=None):
    """One decode step over all slots; writes the new K/V of ``rows``
    into the (local) cache in place and returns logits [S, vocab] f32."""
    S = tokens.shape[0]
    T = cache["k"].shape[2]
    hd = cfg.head_dim_
    x = _embed(cfg, params, tokens, spmd)[:, None]          # [S, 1, h]
    pos = positions.long()
    hist = (torch.arange(T, device=x.device)[None]
            < pos[:, None])[:, None, None]                   # [S,1,1,T]
    tgt = pos[rows].clamp(max=T - 1)
    fits = (pos[rows] < T)[:, None, None]
    sqrt_hd = math.sqrt(hd)
    for l in range(cfg.num_layers):
        p = layer_params(params, l)
        ck, cv = cache["k"][l], cache["v"][l]                # [S, T, KVH, hd]
        q, k, v, _ = _project_qkv(cfg, p, x, spmd)
        q = apply_rope(q, cos, sin, positions=pos[:, None])
        k = apply_rope(k, cos, sin, positions=pos[:, None])
        k1, v1 = k[:, 0], v[:, 0]                            # [S, KVH, hd]
        q2 = q[:, 0].reshape(S, k1.shape[1], -1, hd)
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
        x = x + _out_proj(cfg, p, attn.reshape(S, 1, -1), spmd)
        x = x + _mlp(cfg, p, x, spmd)
        # the in-flight rows land after this layer's attention read the
        # old cache; a position past the cache rewrites the old value
        ck[rows, tgt] = torch.where(fits, k1[rows], ck[rows, tgt])
        cv[rows, tgt] = torch.where(fits, v1[rows], cv[rows, tgt])
    return _head(cfg, params, x[:, 0], spmd)


@torch.no_grad()
def decode_step(cfg: LlamaConfig, params, cache: Dict[str, torch.Tensor],
                tokens: torch.Tensor, positions: torch.Tensor, active,
                spmd=None) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """One token for every slot. tokens [S] (last sampled token),
    positions [S] (where the new token is written), active [S] bool.
    Updates the cache in place; returns (cache, logits [S, vocab])."""
    c = local_cache(cache)
    dev = c["k"].device
    cos, sin = rope_frequencies(cfg.head_dim_, c["k"].shape[2],
                                cfg.rope_theta, dtype=cfg.dtype,
                                scaling=cfg.rope_scaling_dict, device=dev)
    logits = _decode(cfg, params, c, to_device(tokens, dev),
                     to_device(positions, dev), _kept_rows(active, dev),
                     cos, sin, spmd)
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


def pick_tokens(logits: torch.Tensor, generator: Optional[torch.Generator],
                temperature: torch.Tensor, top_k: int, sample: bool,
                spmd=None) -> torch.Tensor:
    """The next token of every slot: ``sample_tokens``, or the argmax when
    ``sample`` is off. Under tp every rank holds the same gathered
    logits, so the argmax agrees; a draw is made by tp rank 0 alone and
    broadcast (the ranks' generators are not assumed equal)."""
    if not sample:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    if spmd is None or spmd.tp == 1:
        return sample_tokens(logits, generator, temperature, top_k)
    if spmd.index("tp") == 0:
        nxt = sample_tokens(logits, generator, temperature, top_k)
    else:
        nxt = torch.zeros(logits.shape[0], dtype=torch.int32,
                          device=logits.device)
    return dc.pbroadcast(nxt, "tp", 0, mesh=spmd.mesh)


@torch.no_grad()
def decode_chunk(cfg: LlamaConfig, params, cache: Dict[str, torch.Tensor],
                 tokens: torch.Tensor, positions: torch.Tensor, active,
                 num_steps: int, generator: Optional[torch.Generator] = None,
                 temperature: Optional[torch.Tensor] = None, top_k: int = 0,
                 sample: bool = True, spmd=None
                 ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor,
                            torch.Tensor, torch.Tensor]:
    """``num_steps`` decode steps, each step's token feeding the next on
    the device. Returns (cache, out [num_steps, S] int32, next_tokens [S],
    next_positions [S]); the last two chain into the next chunk without
    a host round trip. Inactive slots keep their token and position."""
    c = local_cache(cache)
    dev = c["k"].device
    S = tokens.shape[0]
    act = to_device(host_array(active).astype(bool), dev)
    rows = _kept_rows(active, dev)
    if temperature is None:
        temperature = torch.zeros((S,), dtype=torch.float32, device=dev)
    cos, sin = rope_frequencies(cfg.head_dim_, c["k"].shape[2],
                                cfg.rope_theta, dtype=cfg.dtype,
                                scaling=cfg.rope_scaling_dict, device=dev)
    toks = to_device(tokens, dev, torch.int32)
    pos = to_device(positions, dev, torch.int32)
    outs = []
    for _ in range(num_steps):
        logits = _decode(cfg, params, c, toks, pos, rows, cos, sin, spmd)
        nxt = pick_tokens(logits, generator, temperature, top_k, sample,
                          spmd)
        toks = torch.where(act, nxt, toks)
        pos = pos + act.to(torch.int32)
        outs.append(toks)
    return cache, torch.stack(outs), toks, pos


def make_engine_fns(cfg: LlamaConfig, params, num_slots: int, max_len: int,
                    mesh=None):
    """(prefill_fn(tokens, last_idx), insert_fn(cache, kv, slots, valid),
    decode_fn(cache, tokens, positions, active), chunk_fn(...)) bound to
    cfg and params, the shape the engine expects.

    ``mesh``: tensor-parallel serving (``serving_params``): every rank of
    the mesh calls the returned functions in the same order with the
    same host inputs, on its cache from ``init_cache(mesh=)``; they run
    the Megatron split with explicit collectives (the module's
    docstring)."""
    spmd = None
    if mesh is not None:
        spmd, params = serving_params(cfg, params, mesh)

    def pre_batch(tokens, last_idx):
        return prefill_batch(cfg, params, tokens, last_idx, spmd)

    def dec(cache, tokens, positions, active):
        return decode_step(cfg, params, cache, tokens, positions, active,
                           spmd)

    def dec_chunk(cache, tokens, positions, active, num_steps,
                  generator=None, temperature=None, top_k=0, sample=True):
        return decode_chunk(cfg, params, cache, tokens, positions, active,
                            num_steps, generator, temperature, top_k, sample,
                            spmd)

    return pre_batch, insert_many, dec, dec_chunk
