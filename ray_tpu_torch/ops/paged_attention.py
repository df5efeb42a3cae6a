"""Paged-KV decode attention: the plain gather path and the page-walk
kernel.

Counterpart of ``ray_tpu/ops/paged_attention.py``. The KV cache is a
pool of pages ``[num_pages, KVH, page, hd]`` shared by all sequences;
each slot owns an ordered list of page ids (its block-table row).
Both functions compute HISTORY attention only (positions < ctx_len) and
return the un-normalised ``(acc, m, l)`` triple, so the caller merges
the in-flight token's self term exactly (models/llama_paged.py).

``paged_attention`` is the wrapper of kernel 2 (``csrc/paged_attention.cu``,
which replaces the Pallas ``_paged_kernel``): CUDA tensors launch its two
passes, CPU tensors run ``paged_attention_reference``. No fallback. The
kernel splits each slot's pages over blocks (split-K, ``split_pages``
picks the pages per block from the shapes alone) and a second pass
merges the fp32 partials ``(acc_i, m_i, l_i)`` in split order:
``m = max m_i``, ``l = sum l_i e^(m_i - m)``, ``acc = sum acc_i
e^(m_i - m)``, with no float atomics, so the result is deterministic.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

_NEG_INF = -1e30
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# what the kernel is built for: head dims, query rows per kv head (a
# runtime count under row maxima 1, 2, 4 and 8), and the page size's
# granule (its 16-key sub-tiles)
_KERNEL_HEAD_DIMS = (16, 32, 64, 128, 256)
_KERNEL_MAX_GROUP = 8
_KERNEL_PAGE_MULTIPLE = 16
# blocks the split pass aims at: ~8 per SM of an H100's 132, so that
# enough pages are in flight to keep the memory busy
_TARGET_BLOCKS = 1024


def split_pages(num_slots: int, kv_heads: int, max_pages: int
                ) -> Tuple[int, int]:
    """(pages per split, number of splits) of the split-K kernel, from
    shapes alone (reading ``ctx_len`` back would synchronise): enough
    splits, up to one a page, that the grid of ``num_slots * kv_heads *
    splits`` blocks reaches ``_TARGET_BLOCKS``."""
    units = num_slots * kv_heads
    target = max(1, min(max_pages, -(-_TARGET_BLOCKS // units)))
    pps = -(-max_pages // target)
    return pps, -(-max_pages // pps)


def clamp_page_ids(ids: torch.Tensor, num_pages: int) -> torch.Tensor:
    """Page ids as a JAX gather reads them: negative ids count from the
    end of the pool, the rest are clamped into it."""
    ids = ids.long()
    return torch.where(ids < 0, ids + num_pages, ids).clamp(0, num_pages - 1)


def paged_attention_reference(q: torch.Tensor, k_pages: torch.Tensor,
                              v_pages: torch.Tensor,
                              block_table: torch.Tensor,
                              ctx_len: torch.Tensor,
                              sm_scale: Optional[float] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """History attention over paged KV by gathering every table entry.

    q [S, KVH, G, hd] (rope applied); k_pages/v_pages [P, KVH, page, hd];
    block_table [S, MAXP] int32 (entries past a slot's context are
    masked; out-of-range ids are read as the JAX gather reads them,
    see ``clamp_page_ids``); ctx_len [S] int32 history length (EXCLUDING the
    in-flight token). Returns (acc f32 [S, KVH, G, hd], m f32 [S, KVH, G],
    l f32 [S, KVH, G]); a ctx-0 slot gives acc 0, l 0, m -1e30.
    """
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    S, KVH, G, hd = q.shape
    P, _, page, _ = k_pages.shape
    MAXP = block_table.shape[1]
    T = MAXP * page
    ids = clamp_page_ids(block_table, P)
    # [S, MAXP, KVH, page, hd] -> [S, KVH, T, hd]
    ks = k_pages[ids].movedim(2, 1).reshape(S, KVH, T, hd)
    vs = v_pages[ids].movedim(2, 1).reshape(S, KVH, T, hd)
    scores = torch.einsum("skgd,sktd->skgt", q.float(), ks.float()) * sm_scale
    mask = (torch.arange(T, device=q.device)[None]
            < ctx_len.to(q.device)[:, None].long())            # [S, T]
    mask = mask[:, None, None]
    scores = torch.where(mask, scores, _NEG_INF)
    m = scores.amax(dim=-1)
    p = torch.where(mask, torch.exp(scores - m[..., None]), 0.0)
    l = p.sum(dim=-1)
    acc = torch.einsum("skgt,sktd->skgd", p.to(vs.dtype).float(), vs.float())
    return acc, m, l


def check_kernel_shape(head_dim: int, group: int, page: int) -> None:
    """Raise ``ValueError`` unless the kernel is built for this head dim,
    number of query rows per kv head and page size."""
    if (head_dim not in _KERNEL_HEAD_DIMS
            or not 1 <= group <= _KERNEL_MAX_GROUP
            or page % _KERNEL_PAGE_MULTIPLE):
        raise ValueError(
            f"paged_attention: head_dim {head_dim}, {group} query rows per "
            f"kv head and page {page} not supported on the card (head_dim "
            f"{_KERNEL_HEAD_DIMS}, rows 1 to {_KERNEL_MAX_GROUP}, page a "
            f"multiple of {_KERNEL_PAGE_MULTIPLE})")


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, block_table: torch.Tensor,
                    ctx_len: torch.Tensor,
                    sm_scale: Optional[float] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel 2's wrapper; shapes and result as
    ``paged_attention_reference``. On CUDA the block table and ctx_len
    are int32, head_dim is 16, 32, 64, 128 or 256, G is 1 to 8 and the
    page size a multiple of 16; the kernel reads only entries of pages <
    ceil(ctx/page), and clamps those as ``clamp_page_ids`` does. Two
    launches on the current stream: the split pass into fp32 partials,
    then the merge."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    S, KVH, G, hd = q.shape
    if (k_pages.shape != v_pages.shape or k_pages.dim() != 4
            or k_pages.shape[1] != KVH or k_pages.shape[3] != hd
            or block_table.dim() != 2 or block_table.shape[0] != S
            or tuple(ctx_len.shape) != (S,)):
        raise ValueError(
            f"paged_attention: shapes q {tuple(q.shape)} pages "
            f"{tuple(k_pages.shape)}/{tuple(v_pages.shape)} table "
            f"{tuple(block_table.shape)} ctx {tuple(ctx_len.shape)}")
    if q.device.type == "cpu":
        return paged_attention_reference(q, k_pages, v_pages, block_table,
                                          ctx_len, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: unsupported device {q.device}")
    for t in (k_pages, v_pages, block_table, ctx_len):
        if t.device != q.device:
            raise ValueError("paged_attention: inputs on different devices")
    for t in (q, k_pages, v_pages, block_table, ctx_len):
        if not t.is_contiguous():
            raise ValueError("paged_attention: inputs must be contiguous")
    if q.dtype not in _DTYPE_CODES or k_pages.dtype != q.dtype \
            or v_pages.dtype != q.dtype:
        raise ValueError(f"paged_attention: dtypes q {q.dtype} pages "
                         f"{k_pages.dtype} (float32 or bfloat16, equal)")
    if block_table.dtype != torch.int32 or ctx_len.dtype != torch.int32:
        raise ValueError("paged_attention: block_table and ctx_len must "
                         "be int32")
    P, _, page, _ = k_pages.shape
    maxp = block_table.shape[1]
    check_kernel_shape(hd, G, page)
    if any(t.data_ptr() % 16 for t in (q, k_pages, v_pages)):
        raise ValueError("paged_attention: q and the pools must be 16-byte "
                         "aligned")
    from ray_tpu_torch.ops import _build

    lib = _build.load()
    pps, n_split = split_pages(S, KVH, maxp)
    # one fp32 buffer (one allocation a call): the outputs acc
    # [S, KVH, G, hd], m and l [S, KVH, G], then the partials acc
    # [S, KVH, n_split, G, hd], m and l [S, KVH, n_split, G]
    out_rows = S * KVH * G
    rows = out_rows * n_split
    buf = torch.empty((out_rows + rows) * (hd + 2), dtype=torch.float32,
                      device=q.device)
    acc = buf[:out_rows * hd].view(S, KVH, G, hd)
    m = buf[out_rows * hd:out_rows * (hd + 1)].view(S, KVH, G)
    l = buf[out_rows * (hd + 1):out_rows * (hd + 2)].view(S, KVH, G)
    p_acc = buf.data_ptr() + out_rows * (hd + 2) * 4
    p_m = p_acc + rows * hd * 4
    p_l = p_m + rows * 4
    shape = (S, KVH, G, hd, page)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.rtt_paged_attention(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_table.data_ptr(), ctx_len.data_ptr(), p_acc, p_m, p_l,
            _DTYPE_CODES[q.dtype], *shape, P, maxp, pps, n_split,
            float(sm_scale), stream)
        _build.check(lib, err, "paged_attention split kernel")
        paged_attention.launches += 1
        err = lib.rtt_paged_merge(
            p_acc, p_m, p_l, ctx_len.data_ptr(), acc.data_ptr(),
            m.data_ptr(), l.data_ptr(), *shape, maxp, pps, n_split, stream)
        _build.check(lib, err, "paged_attention merge kernel")
        paged_attention.merge_launches += 1
    return acc, m, l


# kernel launches, for chip_smoke.py: the split pass (one a call) and the
# merge
paged_attention.launches = 0
paged_attention.merge_launches = 0
