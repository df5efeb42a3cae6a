"""Paged-KV continuous-batching engine: page pool, prefix cache and
chunked prefill on top of the pipelined LLMEngine loop.

Counterpart of ``ray_tpu/serve/paged_engine.py``:

- the KV cache is a pool of ``num_pages x page_size`` tokens shared by all
  slots, so memory tracks the tokens in flight;
- full prompt pages are content-hashed in a chain (a hash names the
  whole prefix up to its page), and a new request reuses matching pages
  with a refcount bump and prefills only its tail;
- prompts run through bucket-sized prefill chunks, interleaved with
  decode chunks.

Decode history attention goes through the page-walk CUDA kernel
(ops/paged_attention.py) on the card. The allocator and ``_bucket`` are
this package's own copies; ``chain_hash`` is byte-for-byte the
reference's blake2b, so residency digests and page handoffs agree with
``ray_tpu`` replicas.
"""

from __future__ import annotations

import collections
import hashlib
import logging
import queue as _q
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch.models import llama_decode, llama_paged
from ray_tpu_torch.serve import tp as tp_group
from ray_tpu_torch.serve.llm_engine import LLMEngine, _bucket, _HostCopy

log = logging.getLogger(__name__)


class _PageAllocator:
    """Page pool with refcounts and a chained-hash prefix cache.

    Pages whose refcount drops to 0 stay cached (LRU) if they carry a
    prefix hash; eviction reclaims them only when the free list runs
    dry.
    """

    def __init__(self, num_pages: int, page_size: int):
        self.page_size = page_size
        self.num_pages = num_pages
        self.free: List[int] = list(range(num_pages))
        self.ref = [0] * num_pages
        self.hash2page: Dict[int, int] = {}
        self.page2hash: Dict[int, int] = {}
        # chain_hash -> None; order = LRU for ref==0 cached pages
        self.lru: "collections.OrderedDict[int, None]" = \
            collections.OrderedDict()

    @staticmethod
    def chain_hash(prev: int, page_tokens: Tuple[int, ...]) -> int:
        """Process-stable fingerprint of the prefix ending at this page:
        blake2b over prev-hash || token bytes (builtin hash() is salted
        per process, so digests across replicas could never match)."""
        h = hashlib.blake2b(prev.to_bytes(8, "little"), digest_size=8)
        for t in page_tokens:
            h.update(int(t).to_bytes(8, "little", signed=True))
        return int.from_bytes(h.digest(), "little")

    def alloc(self, n: int) -> Optional[List[int]]:
        """n fresh pages (refcount 1), evicting cold cached prefixes as
        needed; None (and no side effects) if the pool cannot cover."""
        while len(self.free) < n and self.lru:
            h, _ = self.lru.popitem(last=False)
            pg = self.hash2page.pop(h)
            self.page2hash.pop(pg, None)
            self.free.append(pg)
        if len(self.free) < n:
            return None
        out = [self.free.pop() for _ in range(n)]
        for p in out:
            self.ref[p] = 1
        return out

    def retain(self, page: int):
        self.ref[page] += 1
        h = self.page2hash.get(page)
        if h is not None:
            self.lru.pop(h, None)

    def release(self, page: int):
        self.ref[page] -= 1
        if self.ref[page] > 0:
            return
        h = self.page2hash.get(page)
        if h is not None:
            self.lru[h] = None        # cached: reclaimable, not free
        else:
            self.free.append(page)

    def match_prefix(self, tokens: List[int], max_tokens: int
                     ) -> Tuple[List[int], List[int], int]:
        """Longest cached chain of full pages covering <= max_tokens.
        Returns (pages retained for the caller, chain hashes per full
        page of the WHOLE prompt, matched token count)."""
        ps = self.page_size
        hashes: List[int] = []
        prev = 0
        for i in range(len(tokens) // ps):
            prev = self.chain_hash(prev, tuple(tokens[i * ps:(i + 1) * ps]))
            hashes.append(prev)
        pages: List[int] = []
        for i, h in enumerate(hashes):
            if (i + 1) * ps > max_tokens:
                break
            pg = self.hash2page.get(h)
            if pg is None:
                break
            self.retain(pg)
            pages.append(pg)
        return pages, hashes, len(pages) * ps

    def register(self, h: int, page: int):
        """Publish page as the cached copy of prefix h (first writer
        wins; the caller keeps its refcount either way)."""
        if h not in self.hash2page and page not in self.page2hash:
            self.hash2page[h] = page
            self.page2hash[page] = h

    def clear_prefix_cache(self):
        """Drop all cached prefixes (page contents may be lost); in-use
        refcounts are untouched."""
        for h, pg in list(self.hash2page.items()):
            if h in self.lru:
                self.free.append(pg)
        self.hash2page.clear()
        self.page2hash.clear()
        self.lru.clear()


class PagedLLMEngine(LLMEngine):
    """LLMEngine over a paged KV pool. Extra knobs:

    page_size: tokens per page (default 64).
    num_pages: pool size (default slots x ceil(max_len / page), the dense
        equivalent; lower oversubscribes, higher adds prefix-cache room).
    use_kernel: the reference's switch for decode attention: None (the
        default) takes ``ops.paged_attention``, the CUDA kernel on the
        card and its plain version on the CPU; False the plain gather on
        either device; True the kernel, and raises on the CPU. Under tp
        the kernel runs on each rank's KV heads.

    Under tp the block tables are rank 0's; a chunk carries them to the
    followers when they changed.
    """

    _TP_SHARED = LLMEngine._TP_SHARED + ("_page_size", "_num_pages_arg",
                                         "_use_kernel")

    def __init__(self, *args, page_size: int = 64,
                 num_pages: Optional[int] = None,
                 use_kernel: Optional[bool] = None, **kw):
        self._page_size = int(page_size)
        self._num_pages_arg = num_pages
        self._use_kernel = use_kernel
        self._prefill_tokens_computed = 0
        self._prefix_hit_tokens = 0
        super().__init__(*args, **kw)

    # ---- program set ----------------------------------------------------

    def _init_programs(self):
        ps = self._page_size
        self._maxp = -(-self._max_len // ps)
        num_pages = (self._num_pages_arg
                     if self._num_pages_arg is not None
                     else self._num_slots * self._maxp)
        self._alloc = _PageAllocator(num_pages, ps)
        self._prefill_chunk, self._decode_chunk = \
            llama_paged.make_paged_engine_fns(self._cfg, self._params,
                                              self._mesh, self._use_kernel)
        self._cache = llama_paged.init_paged_cache(
            self._cfg, num_pages, ps, self._device, mesh=self._mesh)
        # chunked prefill replaces the dense engine's max_len-1 overflow
        # bucket: long prompts run as a sequence of bucket-sized chunks
        self._buckets = ([b for b in self._buckets
                          if b != self._max_len - 1]
                         or [min(128, self._max_len - 1)])
        self._slot_bt: Dict[int, List[int]] = {}
        self._slot_hashes: Dict[int, List[int]] = {}
        self._slot_owned_from: Dict[int, int] = {}
        self._bt_np = np.zeros((self._num_slots, self._maxp), np.int32)
        self._bt_dirty = True
        self._bt_dev = None
        # paged admission is per request (block tables are per slot)
        self._admit_batch = 1
        # pool-exhausted requests park here and retry HEAD-of-line, so a
        # large request is never starved by smaller admits behind it
        self._retry: "collections.deque[tuple]" = collections.deque()

    def _reset_device_state(self):
        super()._reset_device_state()
        # page contents are gone: cached prefixes must not be reused
        self._alloc.clear_prefix_cache()

    def _op_reset(self):
        self._cache = llama_paged.init_paged_cache(
            self._cfg, self._alloc.num_pages, self._page_size, self._device,
            mesh=self._mesh)
        self._zero_chain()
        self._bt_dirty = True

    def _parked_and_queued(self) -> List[tuple]:
        out = list(self._retry)
        self._retry.clear()
        return out + super()._parked_and_queued()

    # ---- slot lifecycle --------------------------------------------------

    def _drop_slot(self, slot: int):
        pages = self._slot_bt.pop(slot, [])
        hashes = self._slot_hashes.pop(slot, [])
        owned_from = self._slot_owned_from.pop(slot, 0)
        for i, pg in enumerate(pages):
            # publish this slot's own full prompt pages for reuse before
            # releasing (shared pages are already published)
            if owned_from <= i < len(hashes):
                self._alloc.register(hashes[i], pg)
            self._alloc.release(pg)
        super()._drop_slot(slot)

    # ---- admission: prefix match + chunked prefill -----------------------

    def _admit(self) -> bool:
        admitted = False
        while self._free and (self._retry or not self._in.empty()):
            if self._retry:
                item = self._retry.popleft()
            else:
                try:
                    item = self._in.get_nowait()
                except _q.Empty:
                    break
            req_id, toks, max_new, t0, temp, stop = item
            with self._done_lock:
                if self._cancelled.pop(req_id, None) is not None:
                    continue
            try:
                toks = [int(t) for t in toks]
                if not toks:
                    raise ValueError("empty prompt")
            except (TypeError, ValueError) as e:
                with self._done_lock:
                    self._done[req_id] = ValueError(
                        f"request rejected: {e!r}")
                continue
            if len(toks) >= self._max_len:
                toks = toks[: self._max_len - 1]
            plen = len(toks)
            ps = self._page_size
            total_pages = -(-plen // ps)
            if total_pages > self._alloc.num_pages:
                # no decode finish can ever free enough pages: requeueing
                # would livelock admission
                with self._done_lock:
                    self._done[req_id] = RuntimeError(
                        f"prompt needs {total_pages} KV pages but the "
                        f"pool has only {self._alloc.num_pages}; raise "
                        f"num_pages or shorten the prompt")
                continue
            # at least the prompt's LAST token must run through prefill
            # (its logits seed generation): cap the match
            shared, hashes, matched = self._alloc.match_prefix(
                toks, plen - 1)
            fresh = self._alloc.alloc(total_pages - len(shared))
            if fresh is None:
                for pg in shared:
                    self._alloc.release(pg)
                # pool exhausted: park head-of-line, stop admitting
                self._retry.appendleft(item)
                break
            slot = self._free.pop()
            pages = shared + fresh
            self._slot_bt[slot] = pages
            self._slot_hashes[slot] = hashes
            self._slot_owned_from[slot] = len(shared)
            self._prefix_hit_tokens += matched
            self._set_bt_row(slot, pages)
            try:
                firsts = self._run_prefill(slot, toks, matched, temp)
            except tp_group.TpGroupError as e:
                self._slot_hashes[slot] = []
                self._drop_slot(slot)
                self._fail_request(req_id, e)
                raise
            except Exception as e:  # noqa: BLE001 — fail THIS request
                log.exception("prefill failed")
                # this slot's fresh pages hold no valid K/V: they must
                # NOT be published as cached prefixes
                self._slot_hashes[slot] = []
                self._drop_slot(slot)
                with self._done_lock:
                    self._done[req_id] = ValueError(
                        f"request rejected: {e!r}")
                continue
            self._slot_temp[slot] = temp
            self._slot_stop[slot] = stop
            self._slot_req[slot] = req_id
            self._slot_tokens[slot] = []
            self._slot_budget[slot] = max_new
            self._slot_pos[slot] = plen
            self._slot_plen[slot] = plen
            self._sched[slot] = 1
            self._slot_start[slot] = t0
            self._inflight.append(("admit", {
                "firsts": firsts, "batch": [(req_id, slot)]}))
            admitted = True
        return admitted

    def _has_parked_requests(self) -> bool:
        return bool(self._retry)

    def _set_bt_row(self, slot: int, pages: List[int]):
        self._bt_np[slot, :] = 0
        self._bt_np[slot, :len(pages)] = pages
        self._bt_dirty = True

    def _bt_device(self) -> torch.Tensor:
        if self._bt_dirty or self._bt_dev is None:
            self._bt_dev = self._h2d(self._bt_np)
            self._bt_dirty = False
        return self._bt_dev

    def _run_prefill(self, slot: int, toks: List[int], ctx0: int,
                     temp: float) -> _HostCopy:
        """Chunked prefill of toks[ctx0:]; returns the first token's
        host copy (reaped asynchronously)."""
        self._prefill_tokens_computed += len(toks) - ctx0
        return _HostCopy(self._device_call(
            "_op_prefill", slot, self._bt_np[slot].copy(),
            np.asarray(toks, np.int32), ctx0, temp))

    def _op_prefill(self, slot: int, bt_row: np.ndarray, toks: np.ndarray,
                    ctx0: int, temp: float) -> torch.Tensor:
        """Device call: the prompt's chunks from ``ctx0`` on through the
        pool, then its first token spliced into the chain state."""
        bt_row = self._h2d(bt_row)
        logits = None
        plen = len(toks)
        while ctx0 < plen:
            n = min(plen - ctx0, self._buckets[-1])
            C = _bucket(n, self._buckets)
            row = np.zeros((1, C), np.int32)
            row[0, :n] = toks[ctx0:ctx0 + n]
            self._cache, logits = self._prefill_chunk(
                self._cache, self._h2d(row), bt_row, ctx0, n)
            ctx0 += n
        firsts = self._first_tokens(logits, np.array([temp], np.float32))
        self._merge(firsts, np.array([slot]), np.array([True]),
                    np.array([plen], np.int32))
        return firsts

    # ---- dispatch hooks: grow block tables, paged chunk ------------------

    def _prepare_dispatch(self, elig: List[int], k: int) -> List[int]:
        """Grow block tables to cover pos+k tokens; slots the pool cannot
        cover stall this chunk (pages free up as neighbours finish)."""
        ps = self._page_size
        ready = []
        for s in elig:
            need = -(-min(self._slot_pos[s] + k, self._max_len) // ps)
            cur = self._slot_bt[s]
            if need > len(cur):
                got = self._alloc.alloc(need - len(cur))
                if got is None:
                    continue
                cur.extend(got)
                self._set_bt_row(s, cur)
            ready.append(s)
        return ready

    def _dispatch_stalled(self, elig: List[int]) -> None:
        if self._inflight:
            return  # pages will free as in-flight chunks finish slots
        # allocator wedged with nothing in flight: fail the youngest slot
        # to guarantee progress (a cancelled victim gets no result)
        victim = max(elig, key=lambda s: self._slot_start[s])
        req_id = self._slot_req.pop(victim)
        with self._done_lock:
            if self._cancelled.pop(req_id, None) is None:
                self._done[req_id] = RuntimeError(
                    "kv page pool exhausted; raise num_pages")
        self._drop_slot(victim)

    def _run_chunk(self, act, k, temps, sampling):
        bt = self._bt_np.copy() if self._bt_dirty else None
        return self._device_call("_op_chunk", act, k, temps, sampling, bt)

    def _op_chunk(self, act, k, temps, sampling, bt=None):
        """Device call: one paged decode chunk; ``bt`` is rank 0's block
        table when it changed since the last chunk."""
        if bt is not None:
            self._bt_np = bt
            self._bt_dirty = True
        (self._cache, out, self._chain_toks, self._chain_pos) = \
            self._decode_chunk(
                self._cache, self._chain_toks, self._chain_pos, act,
                self._bt_device(), k, self._gen, self._h2d(temps),
                self._top_k if sampling else 0, sampling)
        return out

    # ---- disaggregation surface ----------------------------------------

    def _pool_split(self) -> bool:
        """Whether the ranks hold KV-head blocks of the pool (tp divides
        the KV heads), not whole copies of it."""
        return any(pl.is_shard() for pl in
                   getattr(self._cache["k"], "placements", ()))

    def export_pages(self, pages: List[int], cache: Optional[dict] = None
                     ) -> tuple:
        """The K/V contents of ``pages`` (pool indices) as a pair of
        [L, n, KVH, page, hd] tensors on this engine's device. ``cache``
        defaults to this engine's pool; another is read on this rank
        alone (a prefill worker's staging pool). Under tp, rank 0 sends
        the export as a device call, every rank takes its KV-head block
        and rank 0 gathers the blocks; where the pool is replicated,
        rank 0's copy is the answer. The caller holds refs on the pages
        meanwhile."""
        if cache is None and self._pool_split():
            return self._device_call("_op_export_pages", list(pages))
        pool = llama_decode.local_cache(self._cache if cache is None
                                        else cache)
        return self._take_pages(pool, pages)

    def _take_pages(self, pool: dict, pages: List[int]) -> tuple:
        idx = self._h2d(np.asarray(pages, np.int64))
        return pool["k"].index_select(1, idx), pool["v"].index_select(1, idx)

    def _op_export_pages(self, pages: List[int]):
        """Device call: this rank's KV-head block of ``pages``, gathered
        whole to rank 0 (None elsewhere)."""
        k, v = self._take_pages(llama_decode.local_cache(self._cache), pages)
        return self._gather_heads(k), self._gather_heads(v)

    def _gather_heads(self, block: torch.Tensor) -> Optional[torch.Tensor]:
        rank0 = self._link.rank == 0
        blocks = ([torch.empty_like(block) for _ in range(self._link.world)]
                  if rank0 else None)
        torch.distributed.gather(block.contiguous(), blocks, dst=0)
        if not rank0:
            return None
        sh = llama_paged.paged_cache_shardings(self._cfg, self._mesh)["k"]
        whole = block.new_empty(block.shape[:2] + (self._cfg.num_kv_heads,)
                                + block.shape[3:])
        for r, b in enumerate(blocks):
            tp_group.rank_block(whole, sh, r).copy_(b)
        return whole

    def import_pages(self, k, v, hashes: List[int]) -> int:
        """Adopt exported pages into this pool as CACHED prefixes: pages
        are allocated, filled in place, registered under their chain
        hashes and released into the LRU, so the next matching prompt
        retains them through ``match_prefix``. Hashes already resident
        are skipped. Returns the number of pages adopted (0, with
        nothing allocated, when the pool cannot cover or all are
        cached). Under tp rank 0 takes whole tensors, decides alone, and
        sends each rank its KV-head block. Engine-thread only, or on an
        idle engine, like every allocator update."""
        alloc = self._alloc
        keep = [i for i, h in enumerate(hashes)
                if h not in alloc.hash2page]
        if not keep:
            return 0
        dst = alloc.alloc(len(keep))
        if dst is None:
            return 0
        if len(keep) != len(hashes):
            sel = torch.as_tensor(keep, dtype=torch.long, device=k.device)
            k, v = k.index_select(1, sel), v.index_select(1, sel)
        self._device_call("_op_import_pages", dst, local=(k, v))
        for i, pg in zip(keep, dst):
            alloc.register(hashes[i], pg)
            alloc.release(pg)
        return len(keep)

    def _op_import_pages(self, dst: List[int], k=None, v=None):
        """Device call: write rank 0's whole pages ``k``, ``v`` into pool
        pages ``dst``. Over several ranks rank 0 scatters each its
        KV-head block, or broadcasts the pages to a replicated pool."""
        if self._link is not None and self._link.world > 1:
            k, v = self._spread_heads(k, len(dst)), \
                self._spread_heads(v, len(dst))
        self._write_pages(dst, k, v)

    def _spread_heads(self, whole: Optional[torch.Tensor], n: int
                      ) -> torch.Tensor:
        pool = llama_decode.local_cache(self._cache)["k"]
        block = pool.new_empty((pool.shape[0], n) + tuple(pool.shape[2:]))
        if not self._pool_split():
            if whole is not None:
                block.copy_(whole)
            torch.distributed.broadcast(block, src=0)
            return block
        sh = llama_paged.paged_cache_shardings(self._cfg, self._mesh)["k"]
        blocks = (None if whole is None else
                  [tp_group.rank_block(whole.to(block), sh, r)
                   .contiguous() for r in range(self._link.world)])
        torch.distributed.scatter(block, blocks, src=0)
        return block

    def _write_pages(self, dst: List[int], k: torch.Tensor,
                     v: torch.Tensor) -> None:
        pool = llama_decode.local_cache(self._cache)
        idx = self._h2d(np.asarray(dst, np.int64))
        pool["k"].index_copy_(1, idx, k.to(pool["k"]))
        pool["v"].index_copy_(1, idx, v.to(pool["v"]))

    def residency_digest(self, max_entries: int = 4096) -> dict:
        """Bounded snapshot of the cached prefix fingerprints, for
        cache-aware routing. Safe from the request thread: one dict
        snapshot; a torn read only stales the digest until the next
        report."""
        alloc = self._alloc
        try:
            hashes = list(alloc.hash2page)
        except RuntimeError:  # resized mid-iteration: report next tick
            hashes = []
        if len(hashes) > max_entries:
            hashes = hashes[-max_entries:]
        return {"page_size": alloc.page_size, "hashes": hashes,
                "num_pages": alloc.num_pages}

    def stats(self) -> dict:
        st = super().stats()
        st["queued"] += len(self._retry)  # parked pool-exhausted requests
        st.update(
            free_pages=len(self._alloc.free),
            cached_prefix_pages=len(self._alloc.lru),
            prefix_hit_tokens=self._prefix_hit_tokens,
            prefill_tokens_computed=self._prefill_tokens_computed)
        return st
