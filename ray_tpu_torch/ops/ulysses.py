"""Ulysses sequence parallelism: all-to-all head/sequence re-sharding.

Counterpart of ``ray_tpu/ops/ulysses.py``. Ranks swap their sequence
shard for a head shard with one tiled all-to-all, attend over the whole
sequence for their heads with the local kernel, and swap back. The
tiled concatenation orders blocks by rank, so the gathered sequence is
in global order and a plain causal mask is exact.

The local attention is picked by device, as the reference picks it by
backend: CUDA tensors go to ``flash_attention`` (the hand-written
kernels: forward, and dQ and dK/dV in the backward), CPU tensors to
``attention_reference``.

GQA: when the KV heads do not divide over the axis, KV is first repeated
by the least factor r = n / gcd(kv_heads, n), as the reference does.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from ray_tpu_torch.ops.layers import repeat_kv
from ray_tpu_torch.ops.ring_attention import local_chunk
from ray_tpu_torch.parallel.device_collectives import (all_gather,
                                                       all_to_all,
                                                       axis_size)


def ulysses_attention_local(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, axis_name: str,
                            causal: bool = True,
                            sm_scale: Optional[float] = None,
                            attn_fn: Optional[Callable] = None, *,
                            mesh) -> torch.Tensor:
    """Ulysses body on this rank's shards: q [batch, chunk, heads,
    head_dim], k/v possibly fewer (GQA) heads -> [batch, chunk, heads,
    head_dim]. Every rank of ``axis_name`` calls it."""
    n = axis_size(axis_name, mesh=mesh)
    h, kvh = q.shape[2], k.shape[2]
    if h % n:
        raise ValueError(
            f"ulysses attention requires num_heads ({h}) divisible by the "
            f"'{axis_name}' axis size ({n}); use ring attention otherwise")
    if kvh % n:
        r = n // math.gcd(kvh, n)
        k = repeat_kv(k, r)
        v = repeat_kv(v, r)

    # [b, chunk, h, d] -> [b, seq, h/n, d]
    qh, kh, vh = (all_to_all(t, axis_name, mesh=mesh, split_axis=2,
                             concat_axis=1) for t in (q, k, v))
    if attn_fn is None:
        if q.is_cuda:
            from ray_tpu_torch.ops.attention import flash_attention as attn_fn
        else:
            from ray_tpu_torch.ops.attention import \
                attention_reference as attn_fn
    out = attn_fn(qh, kh, vh, causal=causal, sm_scale=sm_scale)
    # [b, seq, h/n, d] -> [b, chunk, h, d]
    return all_to_all(out, axis_name, mesh=mesh, split_axis=1,
                      concat_axis=2)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      mesh, axis_name: str = "sp", causal: bool = True,
                      sm_scale: Optional[float] = None,
                      attn_fn: Optional[Callable] = None) -> torch.Tensor:
    """Global entry: every rank passes the same global q/k/v [batch, seq,
    heads, head_dim] and returns the global output."""
    out = ulysses_attention_local(
        *(local_chunk(t, axis_name, mesh=mesh) for t in (q, k, v)),
        axis_name, causal, sm_scale, attn_fn, mesh=mesh)
    return all_gather(out, axis_name, mesh=mesh, gather_axis=1)
