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
from ray_tpu_torch.models import llama_paged
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

    # the reference builds its staging pools under the engine's mesh; the
    # port's prefill workers are threads of one process
    _TP_WAITS = ("DisaggPagedEngine under tensor parallelism is not ported "
                 "yet (ROADMAP queue 1, 'Tensor-parallel serving: what "
                 "waits')")

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
        # guards the leases and the counters, which the request thread,
        # the workers and the engine thread all update
        self._handoff_lock = threading.Lock()
        # req_id -> (submit item, lease deadline); the durability record
        self._handoff_pending: Dict[str, tuple] = {}
        self._wstates: Dict[int, dict] = {}
        self._wthreads: List[threading.Thread] = []
        self._disagg_diverted = 0
        self._disagg_handoffs = 0
        self._disagg_recovered = 0
        self._disagg_imported_pages = 0
        super().__init__(*args, **kw)
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
        allocator; the pool is allocated on that stream."""
        stream = None
        if self._device.type == "cuda":
            torch.cuda.set_device(self._device)
            stream = torch.cuda.Stream(self._device)
        with torch.cuda.stream(stream):
            cache = llama_paged.init_paged_cache(
                self._cfg, self._alloc.num_pages, self._page_size,
                self._device)
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
                    self._worker_prefill(ws, item)
                except _WorkerKilled:
                    return  # no cleanup; _heal_workers respawns

    def _worker_prefill(self, ws: dict, item: tuple):
        req_id = item[0]
        try:
            toks = [int(t) for t in item[1]][: self._max_len - 1]
            ps = self._page_size
            n_full = (len(toks) - 1) // ps
            if n_full < 1:
                raise ValueError("prompt too short to divert")
            head = toks[:n_full * ps]
            alloc = ws["alloc"]
            # worker-side prefix cache: repeated prefixes re-export
            # without recompute (the staging pool keeps its own LRU)
            shared, hashes, matched = alloc.match_prefix(head, len(head))
            fresh = alloc.alloc(n_full - len(shared))
            if fresh is None:
                for pg in shared:
                    alloc.release(pg)
                raise RuntimeError("staging pool exhausted")
            pages = shared + fresh
            bt_row = np.zeros((self._maxp,), np.int32)
            bt_row[:len(pages)] = pages
            bt_dev = self._h2d(bt_row)
            ctx0 = matched
            while ctx0 < len(head):
                n = min(len(head) - ctx0, self._buckets[-1])
                C = _bucket(n, self._buckets)
                row = np.zeros((1, C), np.int32)
                row[0, :n] = head[ctx0:ctx0 + n]
                ws["cache"], _ = self._prefill_chunk(
                    ws["cache"], self._h2d(row), bt_dev, ctx0, n)
                ctx0 += n
            # the gather COPIES the pages out of the staging pool on this
            # worker's stream, ahead of any later write to the released
            # pages; the decode side waits on ``ready`` before reading
            k, v = self.export_pages(pages, cache=ws["cache"])
            ready = None
            if ws["stream"] is not None:
                ready = torch.cuda.Event()
                ready.record(ws["stream"])
            for i, pg in enumerate(pages):
                if i >= len(shared):
                    alloc.register(hashes[i], pg)
                alloc.release(pg)
        except Exception:  # noqa: BLE001 — degraded: local prefill
            log.warning("prefill worker failed on %s; prefilling it "
                        "locally", req_id, exc_info=True)
            self._expire_now(req_id)
            return
        if fault_injection.enabled():
            action = fault_injection.fire("prefill_handoff", req_id)
            if action == "drop":
                return  # lease expiry recovers the request
            if action == "kill_worker":
                raise _WorkerKilled(req_id)
        self._handoff_q.put((req_id, hashes, k, v, ready))

    def _expire_now(self, req_id: str):
        """Resubmit a leased request for local prefill now (the worker
        knows its handoff will never arrive)."""
        with self._handoff_lock:
            rec = self._handoff_pending.pop(req_id, None)
            if rec is not None:
                self._disagg_recovered += 1
        if rec is not None:
            self._in.put(rec[0])

    # ---- decode side: adopt handoffs, sweep leases, heal workers ---------

    def _drain_handoffs(self):
        while True:
            try:
                req_id, hashes, k, v, ready = self._handoff_q.get_nowait()
            except _q.Empty:
                return
            with self._handoff_lock:
                lease = self._handoff_pending.pop(req_id, None)
            if ready is not None:
                stream = torch.cuda.current_stream(self._device)
                stream.wait_event(ready)
                k.record_stream(stream)
                v.record_stream(stream)
            try:
                n = self.import_pages(k, v, hashes)
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

    def stats(self) -> dict:
        st = super().stats()
        with self._handoff_lock:
            pending = len(self._handoff_pending)
            st.update(
                disagg_diverted=self._disagg_diverted,
                disagg_handoffs=self._disagg_handoffs,
                disagg_recovered=self._disagg_recovered,
                disagg_imported_pages=self._disagg_imported_pages,
                disagg_pending=pending)
        st["queued"] += pending
        st["prefill_workers"] = sum(1 for t in self._wthreads
                                    if t.is_alive())
        return st

    def shutdown(self):
        super().shutdown()
        for _ in self._wthreads:
            self._prefill_q.put(None)
        for th in self._wthreads:
            th.join(timeout=2.0)
        self._wstates.clear()


def engine_class() -> type:
    """The serving engine class deployments should bind: the
    disaggregated engine when the ``serve_disagg`` flag is on, the plain
    paged engine otherwise."""
    from ray_tpu_torch.core.config import config

    return DisaggPagedEngine if config.serve_disagg else PagedLLMEngine
