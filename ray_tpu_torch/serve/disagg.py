"""Disaggregated serving: prefill/decode split inside one engine
process, KV pages handed from prefill workers to the decode loop.

Counterpart of ``ray_tpu/serve/disagg.py``. Continuous batching
interleaves prefill and decode chunks on one loop
(serve/paged_engine.py), so a burst of long prompts steals decode ticks
and inflates every running request's inter-token latency.
Disaggregation moves heavy prompt prefill off the decode loop:
dedicated prefill worker threads run the same prefill-chunk function
against a private staging page pool, then hand the finished KV pages to
the decode engine on a queue. The decode engine adopts them as cached
prefixes (``PagedLLMEngine.import_pages``) and admits the request
normally: its ``match_prefix`` hits the imported chain and prefills
only the tail (the prompt's last partial page, whose logits seed
generation).

On the card every worker runs its chunks on its own CUDA stream, so
prefill overlaps the decode loop's stream instead of queueing behind
it. The worker records an event after the page export and ships it
with the pages; the decode thread makes its stream wait on that event
before it reads them, and marks them used on its stream so that the
caching allocator cannot hand their memory back to the worker early.

Durability: every diverted request is recorded in a handoff lease
BEFORE it leaves the submit path. A lost handoff (worker death, a
dropped message at fault site ``prefill_handoff``, a full staging pool)
is recovered by the decode tick's lease sweep, which resubmits the
original request for local prefill: no request is lost, a lost handoff
costs latency only. Dead worker threads are respawned by the decode
tick's health check.

The reference's second transport, the compiled-DAG ``DeviceChannel``
that carries the pages when the process has an object store, is not
ported: the port has no object store, and without one the reference
takes the direct queue too.

Staging memory: each worker's pool has the engine pool's geometry
(``num_pages`` x ``page_size``), so each worker holds as much KV memory
as the engine itself.

Under tensor parallelism (``tp=N`` or ``mesh=``, ``serve/tp.py``) the
workers are threads of rank 0 and a worker's prefill is a tp step. NCCL
kernels wait on their peers, so collectives that two threads issue in
different orders on different ranks deadlock, on one communicator or on
several: every collective goes out in ONE order. A worker's prefill is
therefore a device call on the engine's command link (``_op_stage``),
under the lock the decode loop's calls take; only the host-side issue is
serialised, the card still runs it on the worker's stream. Each follower
runs the calls in that order on its shard of the slot's staging pool
(its own stream too) and keeps its KV-head block of the pages, keyed by
request id, until rank 0's import names it. The import is a device call
of the decode loop: rank 0 decides which pages to adopt and where, every
rank writes its own block, and no page crosses ranks. Rank 0 decides
every other outcome too and tells the followers: a worker's failure or
a ``drop`` frees the blocks by a device call from the worker, a
``kill_worker`` by one from the decode loop's health check.
"""

from __future__ import annotations

import logging
import queue as _q
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ray_tpu_torch.core import fault_injection
from ray_tpu_torch.models import llama_decode, llama_paged
from ray_tpu_torch.serve import tp as tp_group
from ray_tpu_torch.serve.llm_engine import _bucket
from ray_tpu_torch.serve.paged_engine import PagedLLMEngine, _PageAllocator

log = logging.getLogger(__name__)


class _WorkerKilled(Exception):
    """Raised inside a prefill worker by the ``prefill_handoff``
    ``kill_worker`` fault action: ends the worker loop with no cleanup
    and no handoff, as a dead thread looks to the engine."""


class DisaggPagedEngine(PagedLLMEngine):
    """PagedLLMEngine with disaggregated prefill workers.

    Extra knobs:

    prefill_workers: dedicated prefill threads (default: the
        ``serve_prefill_workers`` flag).
    handoff_timeout_s: lease on each prefill-to-decode handoff; past it
        the decode loop prefills the request locally (default 5.0).
    divert_min_tokens: prompts at least this long are diverted (default:
        the largest prefill bucket; shorter prompts prefill in one chunk
        anyway, so diverting them would only add a handoff).
    """

    def __init__(self, *args, prefill_workers: Optional[int] = None,
                 handoff_timeout_s: float = 5.0,
                 divert_min_tokens: Optional[int] = None, **kw):
        if prefill_workers is None:
            from ray_tpu_torch.core.config import config

            prefill_workers = config.serve_prefill_workers
        self._n_workers = max(0, int(prefill_workers))
        self._handoff_timeout_s = float(handoff_timeout_s)
        self._divert_min_arg = divert_min_tokens
        self._prefill_q: "_q.Queue" = _q.Queue()
        self._handoff_q: "_q.Queue" = _q.Queue()
        # guards the leases, the counters and ``_staged``, which the
        # request thread, the workers and the engine thread all update
        self._handoff_lock = threading.Lock()
        # req_id -> (submit item, lease deadline); the durability record
        self._handoff_pending: Dict[str, tuple] = {}
        self._wstates: Dict[int, dict] = {}
        self._wthreads: List[threading.Thread] = []
        self._disagg_diverted = 0
        self._disagg_handoffs = 0
        self._disagg_recovered = 0
        self._disagg_imported_pages = 0
        self._disagg_staging_hit_tokens = 0
        # req_id -> (prefill worker, staging-cache hit tokens) of the
        # latest prefills, for ``prefill_log``
        self._prefill_log: Dict[str, tuple] = {}
        # under tp: rank 0's prefills whose blocks the followers hold and
        # no handoff carries yet (req_id -> slot); a follower's staging
        # state per worker slot and the blocks it keeps (req_id -> (k, v,
        # ready))
        self._staged: Dict[str, int] = {}
        self._slot_states: Dict[int, dict] = {}
        self._stash: Dict[str, tuple] = {}
        super().__init__(*args, **kw)
        if self._link is not None and self._link.rank != 0:
            return   # a follower: rank 0 has shut the engine down
        self._divert_min_tokens = (self._divert_min_arg
                                   if self._divert_min_arg is not None
                                   else self._buckets[-1])
        for widx in range(self._n_workers):
            self._spawn_worker(widx)

    # ---- submit: divert heavy prompts to the prefill plane ---------------

    def _enqueue(self, item: tuple) -> None:
        plen = min(len(item[1]), self._max_len - 1)
        if (self._wthreads and plen >= self._divert_min_tokens
                and (plen - 1) // self._page_size >= 1):
            # lease FIRST: from here on, losing the handoff anywhere can
            # only delay the request, never lose it
            with self._handoff_lock:
                self._handoff_pending[item[0]] = (
                    item, time.monotonic() + self._handoff_timeout_s)
                self._disagg_diverted += 1
            self._prefill_q.put(item)
            return
        self._in.put(item)

    # ---- prefill workers -------------------------------------------------

    def _init_programs(self):
        super()._init_programs()
        # the work queued so far on this thread's stream (the weights and
        # the pool, drawn, loaded or placed there): every prefill stream
        # waits for this event first, since it does not follow that stream
        self._built = None
        if self._device.type == "cuda":
            self._built = torch.cuda.Event()
            self._built.record(torch.cuda.current_stream(self._device))

    def _spawn_worker(self, widx: int):
        th = threading.Thread(target=self._worker_loop, args=(widx,),
                              daemon=True, name=f"prefill-worker-{widx}")
        # started before it is published, so the health check never
        # takes a thread that is about to start for a dead one
        th.start()
        if widx < len(self._wthreads):
            self._wthreads[widx] = th
        else:
            self._wthreads.append(th)

    def _make_worker_state(self) -> dict:
        """The worker's own stream (on the card), staging pool and
        allocator; the pool is allocated on that stream (under tp, this
        rank's shard of it). The stream first waits for ``_built``: a
        prefill on it must not read weights whose writes are still
        queued on another stream."""
        stream = None
        if self._device.type == "cuda":
            torch.cuda.set_device(self._device)
            stream = torch.cuda.Stream(self._device)
            stream.wait_event(self._built)
        with torch.cuda.stream(stream):
            cache = llama_paged.init_paged_cache(
                self._cfg, self._alloc.num_pages, self._page_size,
                self._device, mesh=self._mesh)
        return {"alloc": _PageAllocator(self._alloc.num_pages,
                                        self._page_size),
                "cache": cache, "stream": stream}

    def _worker_loop(self, widx: int):
        ws = self._make_worker_state()
        self._wstates[widx] = ws
        with torch.no_grad(), torch.cuda.stream(ws["stream"]):
            while not self._stop:
                try:
                    item = self._prefill_q.get(timeout=0.1)
                except _q.Empty:
                    continue
                if item is None:
                    break
                try:
                    self._worker_prefill(widx, ws, item)
                except _WorkerKilled:
                    return  # no cleanup; _heal_workers respawns

    def _worker_prefill(self, widx: int, ws: dict, item: tuple):
        req_id = item[0]
        try:
            toks = [int(t) for t in item[1]][: self._max_len - 1]
            ps = self._page_size
            n_full = (len(toks) - 1) // ps
            if n_full < 1:
                raise ValueError("prompt too short to divert")
            head = np.asarray(toks[:n_full * ps], np.int32)
            alloc = ws["alloc"]
            # worker-side prefix cache: repeated prefixes re-export
            # without recompute (the staging pool keeps its own LRU)
            shared, hashes, matched = alloc.match_prefix(head.tolist(),
                                                         len(head))
            fresh = alloc.alloc(n_full - len(shared))
            if fresh is None:
                for pg in shared:
                    alloc.release(pg)
                raise RuntimeError("staging pool exhausted")
            with self._handoff_lock:
                self._disagg_staging_hit_tokens += matched
                self._prefill_log[req_id] = (widx, matched)
                if len(self._prefill_log) > 4096:
                    del self._prefill_log[next(iter(self._prefill_log))]
            pages = shared + fresh
            bt_row = np.zeros((self._maxp,), np.int32)
            bt_row[:len(pages)] = pages
            if self._link is not None:
                with self._handoff_lock:
                    self._staged[req_id] = widx
            k, v, ready = self._device_call(
                "_op_stage", req_id, widx, bt_row, head, matched,
                local=(ws,))
            for i, pg in enumerate(pages):
                if i >= len(shared):
                    alloc.register(hashes[i], pg)
                alloc.release(pg)
        except Exception:  # noqa: BLE001 — degraded: local prefill
            log.warning("prefill worker failed on %s; prefilling it "
                        "locally", req_id, exc_info=True)
            self._unstage(req_id)
            self._expire_now(req_id)
            return
        if fault_injection.enabled():
            action = fault_injection.fire("prefill_handoff", req_id)
            if action == "drop":
                self._unstage(req_id)
                return  # lease expiry recovers the request
            if action == "kill_worker":
                raise _WorkerKilled(req_id)
        with self._handoff_lock:
            self._staged.pop(req_id, None)
        self._handoff_q.put((req_id, hashes, k, v, ready))

    def _op_stage(self, req_id: str, widx: int, bt_row: np.ndarray,
                  head: np.ndarray, ctx0: int, ws: Optional[dict] = None
                  ) -> tuple:
        """Device call: prefill ``head`` (whole pages) from ``ctx0`` into
        the staging pool pages of ``bt_row`` of worker slot ``widx`` and
        copy them out: (k, v, ready), this rank's KV-head block of the
        pages and the event that marks the copy (None off the card). The
        copy is taken on the slot's stream, ahead of any later write to
        the released pages. Rank 0 passes its worker's state; a follower
        keeps its block for the import."""
        follower = ws is None
        if follower:
            ws = self._slot_states.get(widx)
            if ws is None:
                ws = self._slot_states[widx] = self._make_worker_state()
        with torch.cuda.stream(ws["stream"]):
            bt_dev = self._h2d(bt_row)
            while ctx0 < len(head):
                n = min(len(head) - ctx0, self._buckets[-1])
                C = _bucket(n, self._buckets)
                row = np.zeros((1, C), np.int32)
                row[0, :n] = head[ctx0:ctx0 + n]
                ws["cache"], _ = self._prefill_chunk(
                    ws["cache"], self._h2d(row), bt_dev, ctx0, n)
                ctx0 += n
            k, v = self._take_pages(llama_decode.local_cache(ws["cache"]),
                                    bt_row[:len(head) // self._page_size])
            ready = None
            if ws["stream"] is not None:
                ready = torch.cuda.Event()
                ready.record(ws["stream"])
        if follower:
            self._stash[req_id] = (k, v, ready)
        return k, v, ready

    def _unstage(self, req_id: str) -> None:
        """Free the followers' blocks of a prefill that will not be
        handed off."""
        with self._handoff_lock:
            staged = self._staged.pop(req_id, None) is not None
        if staged:
            try:
                self._device_call("_op_forget", [req_id])
            except RuntimeError:
                log.warning("could not free the followers' blocks of %s",
                            req_id, exc_info=True)

    def _expire_now(self, req_id: str):
        """Resubmit a leased request for local prefill now (the worker
        knows its handoff will never arrive)."""
        with self._handoff_lock:
            rec = self._handoff_pending.pop(req_id, None)
            if rec is not None:
                self._disagg_recovered += 1
        if rec is not None:
            self._in.put(rec[0])

    def _op_forget(self, req_ids: List[str]):
        """Device call: drop the blocks this rank keeps for ``req_ids``
        (rank 0 keeps none)."""
        for rid in req_ids:
            self._stash.pop(rid, None)

    # ---- decode side: adopt handoffs, sweep leases, heal workers ---------

    def _drain_handoffs(self):
        while True:
            try:
                req_id, hashes, k, v, ready = self._handoff_q.get_nowait()
            except _q.Empty:
                return
            with self._handoff_lock:
                lease = self._handoff_pending.pop(req_id, None)
            try:
                n = self._adopt(req_id, hashes, k, v, ready)
            except tp_group.TpGroupError:
                raise
            except Exception:  # noqa: BLE001 — admission re-prefills
                log.warning("import of %s's pages failed", req_id,
                            exc_info=True)
                n = 0
            with self._handoff_lock:
                self._disagg_imported_pages += n
                if lease is not None:
                    self._disagg_handoffs += 1
            if lease is not None:
                # a pool-full import adopted 0 pages: admission finds no
                # cached prefix and prefills the whole prompt locally
                self._in.put(lease[0])

    def _adopt(self, req_id: str, hashes: List[int], k, v, ready) -> int:
        """Import a handoff's pages as cached prefixes (as
        ``import_pages``). Rank 0 decides which pages and where; every
        rank writes its own block, rank 0's from the handoff and a
        follower's from its ``_op_stage``, so no page crosses ranks. The
        call goes out even when nothing is kept: it frees the followers'
        blocks."""
        alloc = self._alloc
        keep = [i for i, h in enumerate(hashes)
                if h not in alloc.hash2page]
        dst = alloc.alloc(len(keep)) if keep else None
        if dst is None:
            keep, dst = [], []
        try:
            self._device_call("_op_adopt", req_id, keep, dst,
                              local=(k, v, ready))
        except BaseException:
            for pg in dst:
                alloc.release(pg)
            raise
        for i, pg in zip(keep, dst):
            alloc.register(hashes[i], pg)
            alloc.release(pg)
        return len(keep)

    def _op_adopt(self, req_id: str, keep: List[int], dst: List[int],
                  k=None, v=None, ready=None):
        """Device call: write this rank's block of a handoff's ``keep``
        pages into pool pages ``dst``."""
        if k is None:
            # the command link runs the stage before this import
            k, v, ready = self._stash.pop(req_id)
        if not keep:
            return
        if ready is not None:
            stream = torch.cuda.current_stream(self._device)
            stream.wait_event(ready)
            k.record_stream(stream)
            v.record_stream(stream)
        if len(keep) != k.shape[1]:
            sel = torch.as_tensor(keep, dtype=torch.long, device=k.device)
            k, v = k.index_select(1, sel), v.index_select(1, sel)
        self._write_pages(dst, k, v)

    def _sweep_leases(self):
        now = time.monotonic()
        expired = []
        with self._handoff_lock:
            for rid, (item, deadline) in list(
                    self._handoff_pending.items()):
                if now > deadline:
                    expired.append(item)
                    del self._handoff_pending[rid]
            self._disagg_recovered += len(expired)
        for item in expired:
            self._in.put(item)

    def _heal_workers(self):
        if self._stop:
            return
        for widx, th in enumerate(self._wthreads):
            if not th.is_alive():
                # a killed worker's prefill is never handed off: the
                # followers free its blocks
                with self._handoff_lock:
                    lost = [r for r, w in self._staged.items() if w == widx]
                    for r in lost:
                        del self._staged[r]
                if lost:
                    self._device_call("_op_forget", lost)
                self._spawn_worker(widx)

    def _tick(self):
        self._heal_workers()
        self._drain_handoffs()
        self._sweep_leases()
        super()._tick()

    # ---- surface ---------------------------------------------------------

    def _has_parked_requests(self) -> bool:
        with self._handoff_lock:
            pending = bool(self._handoff_pending)
        return pending or super()._has_parked_requests()

    def prefill_log(self) -> Dict[str, tuple]:
        """req_id -> (the prefill worker that took it, the tokens its
        staging cache already held) for the latest diverted prefills:
        which worker wins a request is a race, and its staging cache
        decides how the prompt's pages are computed."""
        with self._handoff_lock:
            return dict(self._prefill_log)

    def stats(self) -> dict:
        st = super().stats()
        with self._handoff_lock:
            pending = len(self._handoff_pending)
            st.update(
                disagg_diverted=self._disagg_diverted,
                disagg_handoffs=self._disagg_handoffs,
                disagg_recovered=self._disagg_recovered,
                disagg_imported_pages=self._disagg_imported_pages,
                disagg_staging_hit_tokens=self._disagg_staging_hit_tokens,
                disagg_pending=pending)
        st["queued"] += pending
        st["prefill_workers"] = sum(1 for t in self._wthreads
                                    if t.is_alive())
        return st

    def _stop_workers(self, wait_s: float):
        for _ in self._wthreads:
            self._prefill_q.put(None)
        for th in self._wthreads:
            th.join(timeout=wait_s)

    def _close(self):
        """Stop the workers (a prefill under tp is collective: let it
        finish), then release the group."""
        self._stop_workers(2.0 if self._link is None
                           else tp_group.TP_TIMEOUT_S)
        super()._close()

    def shutdown(self):
        super().shutdown()
        self._stop_workers(2.0)
        self._wstates.clear()


def engine_class() -> type:
    """The serving engine class deployments should bind: the
    disaggregated engine when the ``serve_disagg`` flag is on, the plain
    paged engine otherwise."""
    from ray_tpu_torch.core.config import config

    return DisaggPagedEngine if config.serve_disagg else PagedLLMEngine
