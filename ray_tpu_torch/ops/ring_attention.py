"""Ring attention: exact attention over sequence shards on the "sp" axis.

Counterpart of ``ray_tpu/ops/ring_attention.py``, with its math: each
rank holds 1/n of the sequence; KV blocks rotate around the ring (a
differentiable ``ring_permute``, whose backward rotates the gradients
back) while each rank accumulates online-softmax statistics in fp32, so
no rank holds more than [chunk, chunk] scores. Causality uses absolute
positions: rank r owns positions [r*chunk, (r+1)*chunk); a KV block
that started on rank j is attended fully when j < r, causally when
j == r and not at all when j > r. GQA repeats the KV heads blockwise.

Plain tensor ops, no kernel: the reference runs none here either.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ray_tpu_torch.ops.layers import repeat_kv
from ray_tpu_torch.parallel.device_collectives import (all_gather,
                                                       axis_index,
                                                       axis_size,
                                                       ring_permute)

_NEG_INF = -1e30


def ring_attention_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         axis_name: str, causal: bool = True,
                         sm_scale: Optional[float] = None, *,
                         mesh) -> torch.Tensor:
    """Ring attention body on this rank's shards: q [b, chunk, heads, d],
    k/v [b, chunk, kv_heads, d] -> [b, chunk, heads, d]. Every rank of
    ``axis_name`` calls it."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    n = axis_size(axis_name, mesh=mesh)
    my_rank = axis_index(axis_name, mesh=mesh)
    b, chunk, h, d = q.shape
    n_rep = h // k.shape[2]

    qf = q.float() * sm_scale
    q_pos = my_rank * chunk + torch.arange(chunk, device=q.device)
    acc = q.new_zeros((b, h, chunk, d), dtype=torch.float32)
    m = q.new_full((b, h, chunk, 1), _NEG_INF, dtype=torch.float32)
    l = q.new_zeros((b, h, chunk, 1), dtype=torch.float32)
    k_cur, v_cur = k, v
    for i in range(n):
        # the block held now started `i` hops upstream
        src_rank = (my_rank - i) % n
        k_rep = repeat_kv(k_cur, n_rep).float()
        v_rep = repeat_kv(v_cur, n_rep).float()
        s = torch.einsum("bqhd,bkhd->bhqk", qf, k_rep)
        if causal:
            k_pos = src_rank * chunk + torch.arange(chunk, device=q.device)
            s = torch.where(q_pos[:, None] >= k_pos[None, :], s, _NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bhqk,bkhd->bhqd", p, v_rep)
        m = m_new
        if i < n - 1:   # the reference's last rotation feeds nothing
            k_cur = ring_permute(k_cur, axis_name, 1, mesh=mesh)
            v_cur = ring_permute(v_cur, axis_name, 1, mesh=mesh)
    out = acc / l.clamp_min(1e-30)
    return out.transpose(1, 2).to(q.dtype)


def local_chunk(x: torch.Tensor, axis_name: str, *, mesh,
                dim: int = 1) -> torch.Tensor:
    """This rank's block of ``dim`` when it is sharded over the axis."""
    n = axis_size(axis_name, mesh=mesh)
    if x.shape[dim] % n:
        raise ValueError(
            f"sequence length {x.shape[dim]} must be divisible by the "
            f"mesh's {axis_name}={n}")
    return x.chunk(n, dim)[axis_index(axis_name, mesh=mesh)]


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh,
                   axis_name: str = "sp", causal: bool = True,
                   sm_scale: Optional[float] = None) -> torch.Tensor:
    """Global entry: every rank passes the same global q/k/v [batch, seq,
    heads, head_dim]; each attends for its sequence block, and the blocks
    are gathered back, so every rank returns the global output."""
    out = ring_attention_local(
        *(local_chunk(t, axis_name, mesh=mesh) for t in (q, k, v)),
        axis_name, causal, sm_scale, mesh=mesh)
    return all_gather(out, axis_name, mesh=mesh, gather_axis=1)
