"""Continuous-batching LLM engine over the dense slot cache: the Serve
replica body of the PyTorch port.

Counterpart of ``ray_tpu/serve/llm_engine.py`` with the same constructor
keywords and the same mailbox (``submit`` / ``collect`` / ``peek`` /
``cancel`` / ``stats`` / ``shutdown``). A fixed set of sequence slots
shares one decode chunk; new requests join between chunks by a batched
prefill into free slots.

Decode is a PIPELINED loop: each dispatch runs k decode steps whose
sampled tokens feed the next step on the device, and the next chunk's
inputs are this chunk's output tensors, so the host never waits between
chunks. Each chunk's tokens are copied to pinned host memory with
``non_blocking=True`` behind a recorded CUDA event; ``_reap`` waits on
the event of the OLDEST record, one pipeline depth behind the dispatch
frontier. Host data reaches the device through pinned non-blocking
copies too, so nothing in the loop synchronises the card.

PyTorch runs eagerly: there is nothing to compile ahead, so the engine
has no ``_precompile``.

Tensor parallelism (``tp=N`` or ``mesh=``) runs one process per rank
(``serve/tp.py``): this engine is rank 0 and keeps the mailbox and every
host decision; each device call (``_op_*``) is broadcast to the other
ranks, which run it on their shards (``_follow``).
"""

from __future__ import annotations

import collections
import logging
import queue
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ray_tpu_torch.models import llama, llama_decode
from ray_tpu_torch.serve import tp as tp_group

log = logging.getLogger(__name__)


def _bucket(n: int, buckets: List[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


class _HostCopy:
    """A device tensor's values on their way to the host: a pinned
    non-blocking copy plus the event that marks its arrival (CPU
    tensors are already there)."""

    def __init__(self, t: torch.Tensor):
        if t.device.type == "cuda":
            self.host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self.host.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(t.device))
        else:
            self.host = t
            self.event = None

    def numpy(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


class LLMEngine:
    """Continuous-batched generation on the Llama family (tiny to 8B).

    ``model_config={"hf_model": path}`` serves an HF checkpoint of the
    llama, qwen2 or gemma family (``models/hf_weights.py``; loading a
    path needs ``transformers``); its other keys override the loaded
    config. Beyond the reference's keywords: ``params`` serves given
    weights (converted from ``ray_tpu`` or shared between engines)
    instead of ``init_params(cfg, seed=0)``; ``device`` defaults to the
    CUDA card and raises without one (pass ``"cpu"`` to run on the host).

    ``tp=N`` serves over N ranks this engine starts (one device each:
    ``cuda:0`` .. ``cuda:N-1``, or N gloo ranks on the CPU); ``mesh=`` over
    the ranks of the caller's process group, where every rank builds the
    engine with the same arguments and every rank but 0 follows rank 0's
    device calls inside its constructor until rank 0 shuts down (its
    ``submit`` raises). Rank 0's weights are scattered to the ranks; the
    other ranks' ``params`` are not read. The kernels run on each rank's
    local heads (the reference turns its kernels off under a mesh).
    """

    # the attributes a follower takes from rank 0 before it builds the
    # device programs (subclasses add theirs)
    _TP_SHARED = ("_cfg", "_num_slots", "_max_len", "_buckets", "_top_k",
                  "_seed")

    def __init__(self, model_config: Optional[dict] = None,
                 num_slots: int = 8, max_len: int = 256,
                 prefill_buckets: Optional[List[int]] = None,
                 max_new_tokens: int = 32, eos_id: int = -1,
                 greedy: bool = True, chunk_steps: int = 8,
                 tp: int = 1, mesh=None, top_k: int = 0,
                 sampling_seed: int = 0, pipeline_depth: int = 2,
                 params: Optional[Dict[str, Any]] = None, device=None):
        cfg_kw = dict(model_config or {})
        hf_model = cfg_kw.pop("hf_model", None)
        preset = cfg_kw.pop("preset", "tiny")
        quantize = cfg_kw.pop("quantize", None)
        self._device = llama.resolve_device(device)
        self._mesh = mesh
        self._link = None
        # one device call at a time on the command link, from the engine
        # thread, a prefill worker or a caller's export/import: the
        # followers run the calls, and so issue their collectives, in
        # the order the link carries them
        self._call_lock = threading.Lock()
        self._fatal: Optional[BaseException] = None
        sharded = tp > 1 or mesh is not None
        if sharded:
            if mesh is None and self._device.type == "cuda" \
                    and torch.cuda.device_count() < tp:
                raise ValueError(f"tp={tp} needs {tp} devices, found "
                                 f"{torch.cuda.device_count()}")
            if mesh is None and torch.distributed.is_initialized():
                raise ValueError(
                    f"LLMEngine(tp={tp}) starts a process group of its own, "
                    "and this process already holds one: run one engine "
                    "process per rank in that group and pass mesh= instead")
        if quantize not in (None, "int8"):
            raise ValueError(
                f"unsupported quantize={quantize!r} (only 'int8')")
        if sharded and quantize is not None:
            raise ValueError(
                "quantize='int8' currently serves single-chip "
                "(tp=1); drop quantize or tp")
        if mesh is not None and torch.distributed.get_rank() != 0:
            self._link = tp_group.Link(mesh)
            self._follow()
            return
        if hf_model is not None:
            if params is not None:
                raise ValueError("pass hf_model or params=, not both")
            from dataclasses import replace

            from ray_tpu_torch.models.hf_weights import (from_hf,
                                                         hf_model_type)

            # refuse before from_hf materialises the checkpoint
            mt = hf_model_type(hf_model)
            if mt not in ("llama", "qwen2", "gemma"):
                raise ValueError(
                    "the continuous-batching engine serves llama-family "
                    f"dense checkpoints (llama/qwen2/gemma); got {mt!r}")
            cfg, params = from_hf(hf_model,
                                  dtype=cfg_kw.pop("param_dtype", None),
                                  device=self._device)
            cfg = replace(cfg, **cfg_kw)
        else:
            cfg = getattr(llama.LlamaConfig, preset)(**cfg_kw)
        self._cfg = cfg
        self._params = (params if params is not None else
                        llama.init_params(cfg, 0, self._device))
        del params   # so that the placement below can free a whole tree
        if quantize is not None:
            self._params = llama_decode.quantize_decode_params(self._params)
        self._num_slots = num_slots
        self._max_len = max_len
        # max_len-1 terminates the bucket list so over-length (truncated)
        # prompts still land in a bucket
        self._buckets = sorted(set(
            [b for b in (prefill_buckets or [32, 64, 128])
             if b < max_len] + [max_len - 1]))
        self._max_new = max_new_tokens
        self._eos = eos_id
        self._greedy = greedy
        self._top_k = max(0, min(int(top_k), cfg.vocab_size - 1))
        self._seed = int(sampling_seed)
        self._gen = torch.Generator(device=self._device)
        self._gen.manual_seed(self._seed)
        if sharded:
            # the other ranks join now, then every rank builds its shard
            # (the whole copy is dropped)
            self._link = (tp_group.Link(mesh) if mesh is not None else
                          tp_group.spawn(type(self), tp, self._device))
            self._mesh = self._link.mesh
            try:
                self._link.share({k: getattr(self, k)
                                  for k in self._TP_SHARED})
                self._params = tp_group.place_params(
                    self._params, llama.param_shardings(cfg, self._mesh),
                    self._link, self._device)
                self._init_programs()
            except BaseException:
                self._link.close()
                raise
        else:
            self._init_programs()
        self._spmd = llama_decode.serving_spmd(self._mesh)
        # tokens decoded per dispatched chunk, a power of two
        chunk_steps = max(1, int(chunk_steps))
        self._chunk_steps = 1 << (chunk_steps.bit_length() - 1)
        self._depth = max(1, int(pipeline_depth))
        self._inflight: "collections.deque[tuple]" = collections.deque()

        # on-device chain state: the last sampled token and next write
        # position per slot, produced by one chunk, consumed by the next
        self._zero_chain()

        # slot bookkeeping (host side)
        self._free = list(range(num_slots))
        self._slot_req: Dict[int, str] = {}
        self._slot_tokens: Dict[int, List[int]] = {}
        self._slot_budget: Dict[int, int] = {}
        self._slot_pos: Dict[int, int] = {}     # next write pos (speculative)
        self._slot_plen: Dict[int, int] = {}    # prompt length
        self._sched: Dict[int, int] = {}        # tokens dispatched (incl 1st)
        self._slot_start: Dict[int, float] = {}
        self._slot_ttft: Dict[int, float] = {}
        self._slot_temp: Dict[int, float] = {}
        self._slot_stop: Dict[int, frozenset] = {}

        self._in: "queue.Queue[tuple]" = queue.Queue()
        self._cancelled: Dict[str, float] = {}  # req_id -> cancel time
        self._done: Dict[str, Any] = {}
        self._seen_ids: Dict[str, float] = {}  # req_id -> submit time
        self._done_lock = threading.Lock()
        self._steps = 0
        self._stop = False
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="llm-engine")
        self._thread.start()

    def _zero_chain(self):
        self._chain_toks = torch.zeros((self._num_slots,), dtype=torch.int32,
                                       device=self._device)
        self._chain_pos = torch.zeros((self._num_slots,), dtype=torch.int32,
                                      device=self._device)

    def _init_programs(self):
        """Bind the model functions and allocate the device cache.
        PagedLLMEngine overrides this (and the admission/dispatch hooks)
        to swap the dense slot cache for the page pool."""
        (self._prefill_batch, self._insert_many, _,
         self._decode_chunk) = llama_decode.make_engine_fns(
            self._cfg, self._params, self._num_slots, self._max_len,
            mesh=self._mesh)
        # burst admission: up to this many prompts prefill in one batch
        self._admit_batch = max(1, min(8, self._num_slots))
        self._cache = llama_decode.init_cache(
            self._cfg, self._num_slots, self._max_len, self._device,
            mesh=self._mesh)

    # ---- tensor parallelism (serve/tp.py) -----------------------------------

    def _follow(self):
        """A follower rank: take rank 0's settings and weight shards, build
        the same programs, then run each device call rank 0 broadcasts
        until it shuts down."""
        settings = self._link.share()
        if not isinstance(settings, dict):   # rank 0 failed to start
            self._link.close()
            return
        self.__dict__.update(settings)
        self._spmd = llama_decode.serving_spmd(self._mesh)
        self._gen = torch.Generator(device=self._device)
        self._gen.manual_seed(self._seed)
        self._params = tp_group.place_params(
            None, llama.param_shardings(self._cfg, self._mesh), self._link,
            self._device)
        self._init_programs()
        self._zero_chain()
        with torch.no_grad():
            while True:
                op, args = self._link.recv()
                if op == "shutdown":
                    break
                if not op.startswith("_op_"):
                    raise ValueError(f"follower: unknown command {op!r}")
                try:
                    getattr(self, op)(*args)
                except Exception:  # noqa: BLE001 — rank 0 fails the step
                    log.exception("follower step %s failed", op)
        self._close()

    def _close(self):
        """Release the tensor-parallel group: rank 0's engine thread on
        its way out, a follower after rank 0's shutdown command."""
        if self._link is not None:
            self._link.close()

    def _device_call(self, op: str, *args, local: tuple = ()):
        """Run device call ``op`` (an ``_op_*`` method) here, after sending
        it to the followers under tp; ``local`` are arguments for rank
        0's call only (tensors the followers hold their shards of). A
        broken group raises ``TpGroupError``."""
        if self._link is None or self._link.world == 1:
            return getattr(self, op)(*args, *local)   # no one follows
        try:
            with self._call_lock:
                self._link.send(op, args)
                return getattr(self, op)(*args, *local)
        except tp_group.TpGroupError:
            raise
        except RuntimeError as e:
            self._link.check_alive()
            if isinstance(e, torch.distributed.DistError):
                raise tp_group.TpGroupError(
                    f"tensor-parallel collective failed: {e!r}") from e
            raise

    # ---- mailbox (called from the actor's request thread) ------------------

    def submit(self, req_id: str, prompt_tokens: List[int],
               max_new_tokens: Optional[int] = None,
               temperature: float = 0.0,
               stop_ids: Optional[List[int]] = None) -> None:
        """temperature 0 = greedy; >0 samples (engine-level ``top_k``
        masks the tail). ``stop_ids``: extra per-request stop tokens
        (kept in the output). A duplicate ``req_id`` is dropped, so a
        router replay of a delivered submit runs the generation once."""
        if self._link is not None and self._link.rank != 0:
            raise RuntimeError("submit goes to rank 0's engine; this rank "
                               "follows it")
        if self._fatal is not None:
            raise RuntimeError(f"engine stopped: {self._fatal!r}") \
                from self._fatal
        now = time.monotonic()
        with self._done_lock:
            if len(self._seen_ids) > 2048:
                cutoff = now - 600.0
                self._seen_ids = {r: t for r, t in self._seen_ids.items()
                                  if t > cutoff}
            if req_id in self._seen_ids:
                return
            self._seen_ids[req_id] = now
        self._enqueue((req_id, list(prompt_tokens),
                       max_new_tokens or self._max_new, now,
                       float(temperature),
                       frozenset(int(t) for t in (stop_ids or ()))))

    def _enqueue(self, item: tuple) -> None:
        """Hook: hand an accepted request to admission (the
        disaggregated engine diverts long prompts to its prefill
        workers here)."""
        self._in.put(item)

    def collect(self, req_ids: Optional[List[str]] = None) -> Dict[str, Any]:
        """Drain finished requests (only ``req_ids`` if given)."""
        with self._done_lock:
            if req_ids is None:
                out, self._done = self._done, {}
            else:
                out = {r: self._done.pop(r) for r in req_ids
                       if r in self._done}
        return out

    def peek(self, req_ids: Optional[List[str]] = None,
             since: Optional[Dict[str, int]] = None) -> Dict[str, Any]:
        """Non-destructive progress snapshot:
        {req_id: {"tokens": [...], "offset": k, "done": bool}} with the
        tokens from ``since[req_id]`` on."""
        since = since or {}

        def view(rid, toks, done):
            off = since.get(rid, 0)
            return {"tokens": list(toks[off:]), "offset": off,
                    "done": done}

        out: Dict[str, Any] = {}
        for slot, rid in list(self._slot_req.items()):
            if req_ids is not None and rid not in req_ids:
                continue
            toks = self._slot_tokens.get(slot)
            if toks is not None:
                out[rid] = view(rid, toks, False)
        with self._done_lock:
            for rid, res in self._done.items():
                if req_ids is not None and rid not in req_ids:
                    continue
                if isinstance(res, Exception):
                    out[rid] = {"error": repr(res), "done": True}
                else:
                    out[rid] = view(rid, res["tokens"], True)
        return out

    def cancel(self, req_id: str) -> None:
        """Abort a request; the engine thread finishes a generating slot
        at its next tick (result discarded), drops a queued request at
        admission, and a finished-but-uncollected result is removed."""
        with self._done_lock:
            if self._done.pop(req_id, None) is None:
                self._cancelled[req_id] = time.monotonic()

    def stats(self) -> dict:
        return {"active": self._num_slots - len(self._free),
                "queued": self._in.qsize(), "steps": self._steps,
                "slots": self._num_slots,
                "inflight_chunks": len(self._inflight)}

    def shutdown(self):
        self._stop = True
        if self._link is not None and self._link.rank == 0:
            # the engine thread stops the followers as it exits
            self._thread.join(timeout=tp_group.TP_TIMEOUT_S)

    # ---- engine loop -------------------------------------------------------

    def _h2d(self, a, dtype=None) -> torch.Tensor:
        return llama.to_device(a, self._device, dtype)

    def _has_parked_requests(self) -> bool:
        """Whether admission holds requests outside ``_in`` (the paged
        engine parks pool-exhausted requests for head-of-line retry)."""
        return False

    def _first_tokens(self, logits: torch.Tensor, temps: np.ndarray):
        """Each prompt's first token, on the device."""
        return llama_decode.pick_tokens(
            logits, self._gen, self._h2d(temps, torch.float32), self._top_k,
            bool(temps.any()), self._spmd)

    def _merge(self, firsts: torch.Tensor, slots: np.ndarray,
               valid: np.ndarray, new_pos: np.ndarray) -> None:
        """Splice admitted slots into the chain state on the device; the
        kept rows are chosen on the host (no drop-mode scatter)."""
        keep = np.nonzero(valid)[0]
        if not keep.size:
            return
        dst = self._h2d(slots[keep].astype(np.int64))
        self._chain_toks.index_copy_(
            0, dst, firsts.index_select(0, self._h2d(keep)))
        self._chain_pos.index_copy_(
            0, dst, self._h2d(new_pos[keep].astype(np.int32)))

    def _admit(self) -> bool:
        """Prefill waiting requests into free slots in batches of up to
        ``_admit_batch``; the first tokens are reaped asynchronously with
        the decode pipeline. Returns True if any request was admitted."""
        admitted = False
        while self._free and not self._in.empty():
            pending = []
            while (len(pending) < min(len(self._free), self._admit_batch)
                   and not self._in.empty()):
                try:
                    pending.append(self._in.get_nowait())
                except queue.Empty:
                    break
            if not pending:
                break
            batch = []   # (req_id, toks, max_new, t0, temp, stop, slot)
            for req_id, toks, max_new, t0, temp, stop in pending:
                with self._done_lock:
                    was_cancelled = (
                        self._cancelled.pop(req_id, None) is not None)
                if was_cancelled:
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
                batch.append((req_id, toks, max_new, t0, temp, stop,
                              self._free.pop()))
            if not batch:
                continue
            try:
                B = 1 if len(batch) == 1 else self._admit_batch
                P = _bucket(max(len(t) for _, t, _, _, _, _, _ in batch),
                            self._buckets)
                rows = np.zeros((B, P), np.int32)
                last = np.zeros((B,), np.int32)
                slots = np.zeros((B,), np.int64)
                valid = np.zeros((B,), bool)
                temps = np.zeros((B,), np.float32)
                plens = np.zeros((B,), np.int32)
                for i, (_, toks, _, _, temp, _, slot) in enumerate(batch):
                    rows[i, :len(toks)] = toks
                    last[i] = len(toks) - 1
                    slots[i], valid[i] = slot, True
                    temps[i] = temp
                    plens[i] = len(toks)
                firsts_h = _HostCopy(self._device_call(
                    "_op_admit", rows, last, slots, valid, temps, plens))
            except tp_group.TpGroupError as e:
                for req_id, _, _, _, _, _, slot in batch:
                    self._free.append(slot)
                    self._fail_request(req_id, e)
                raise
            except Exception as e:  # noqa: BLE001 — fail THESE requests
                log.exception("prefill failed")
                for req_id, _, _, _, _, _, slot in batch:
                    self._free.append(slot)
                    with self._done_lock:
                        self._done[req_id] = ValueError(
                            f"request rejected: {e!r}")
                continue
            entries = []
            for req_id, toks, max_new, t0, temp, stop, slot in batch:
                self._slot_temp[slot] = temp
                self._slot_stop[slot] = stop
                self._slot_req[slot] = req_id
                self._slot_tokens[slot] = []
                self._slot_budget[slot] = max_new
                self._slot_pos[slot] = len(toks)
                self._slot_plen[slot] = len(toks)
                self._sched[slot] = 1
                self._slot_start[slot] = t0
                entries.append((req_id, slot))
                admitted = True
            self._inflight.append(("admit", {"firsts": firsts_h,
                                             "batch": entries}))
        return admitted

    def _op_admit(self, rows, last, slots, valid, temps, plens):
        """Device call: prefill a batch, insert it into its slots, pick
        the first tokens and splice them into the chain state."""
        logits, kv = self._prefill_batch(self._h2d(rows), self._h2d(last))
        self._cache = self._insert_many(self._cache, kv, slots, valid)
        firsts = self._first_tokens(logits, temps)
        self._merge(firsts, slots, valid, plens)
        return firsts

    def _maybe_finish(self, slot: int, last_token: int) -> bool:
        toks = self._slot_tokens[slot]
        if (last_token == self._eos
                or last_token in self._slot_stop.get(slot, ())
                or len(toks) >= self._slot_budget[slot]
                or self._slot_plen[slot] + len(toks) >= self._max_len - 1):
            req_id = self._slot_req.pop(slot)
            ttft = self._slot_ttft.get(
                slot, time.monotonic() - self._slot_start[slot])
            with self._done_lock:
                if self._cancelled.pop(req_id, None) is None:
                    self._done[req_id] = {
                        "tokens": list(toks),
                        "ttft_s": ttft,
                        "latency_s": (time.monotonic()
                                      - self._slot_start[slot]),
                    }
            self._drop_slot(slot)
            return True
        return False

    def _drop_slot(self, slot: int):
        for d in (self._slot_tokens, self._slot_budget, self._slot_pos,
                  self._slot_plen, self._sched, self._slot_start,
                  self._slot_ttft, self._slot_temp, self._slot_stop):
            d.pop(slot, None)
        self._free.append(slot)

    def _reset_device_state(self):
        """Recover from a failed step: in-place cache updates may have
        been cut midway, so rebuild everything the dispatch chain
        touches."""
        self._inflight.clear()
        self._device_call("_op_reset")

    def _op_reset(self):
        self._cache = llama_decode.init_cache(
            self._cfg, self._num_slots, self._max_len, self._device,
            mesh=self._mesh)
        self._zero_chain()

    def _fail_request(self, req_id: str, err: BaseException) -> None:
        with self._done_lock:
            if self._cancelled.pop(req_id, None) is None:
                self._done[req_id] = RuntimeError(f"engine stopped: {err!r}")

    def _fail_all(self, err: BaseException) -> None:
        """The tensor-parallel group broke: every request the engine holds
        fails with ``err``, and the engine stops."""
        self._fatal = err
        for req_id in list(self._slot_req.values()) + [
                item[0] for item in self._parked_and_queued()]:
            self._fail_request(req_id, err)
        self._slot_req.clear()
        self._stop = True

    def _parked_and_queued(self) -> List[tuple]:
        out = []
        while True:
            try:
                out.append(self._in.get_nowait())
            except queue.Empty:
                return out

    def _run(self):
        try:
            self._loop()
        finally:
            self._close()

    def _loop(self):
        with torch.no_grad():
            if self._device.type == "cuda":
                torch.cuda.set_device(self._device)
            while not self._stop:
                try:
                    self._tick()
                except tp_group.TpGroupError as e:
                    log.error("tensor-parallel group lost: %r", e)
                    self._fail_all(e)
                except Exception as e:  # noqa: BLE001 — fail in-flight, live on
                    log.exception("engine step failed")
                    failed = list(self._slot_req.items())
                    with self._done_lock:
                        for slot, req_id in failed:
                            # cancelled requests get no result even on
                            # engine failure (cancel()'s contract)
                            if self._cancelled.pop(req_id, None) is None:
                                self._done[req_id] = RuntimeError(
                                    f"engine step failed: {e!r}")
                    for slot, _ in failed:
                        self._slot_req.pop(slot, None)
                        self._drop_slot(slot)
                    try:
                        self._reset_device_state()
                    except tp_group.TpGroupError as e2:
                        self._fail_all(e2)

    def _prepare_dispatch(self, elig: List[int], k: int) -> List[int]:
        """Hook: reserve what the chunk needs for ``k`` more tokens per
        slot; returns the slots dispatchable now (the paged engine grows
        block tables here and stalls slots the pool cannot cover)."""
        return elig

    def _dispatch_stalled(self, elig: List[int]) -> None:
        """Hook: called when _prepare_dispatch returned no slots."""

    def _run_chunk(self, act, k, temps, sampling):
        """Run the decode chunk (host inputs: ``act`` and ``temps`` [S]);
        updates the cache and chain state, returns [k, S]."""
        return self._device_call("_op_chunk", act, k, temps, sampling)

    def _op_chunk(self, act, k, temps, sampling):
        """Device call: one decode chunk (the paged engine adds its block
        table)."""
        (self._cache, out, self._chain_toks, self._chain_pos) = \
            self._decode_chunk(
                self._cache, self._chain_toks, self._chain_pos, act, k,
                self._gen, self._h2d(temps), self._top_k if sampling else 0,
                sampling)
        return out

    def _dispatch(self) -> bool:
        """Dispatch one decode chunk over the eligible slots; its inputs
        are the previous chunk's device outputs, so this only enqueues
        work."""
        elig = [s for s in self._slot_req
                if self._sched[s] < self._slot_budget[s]
                and self._slot_pos[s] < self._max_len - 1]
        if not elig:
            return False
        # with requests waiting, chunk toward the earliest known finish
        # so the waiter is admitted promptly
        k = self._chunk_steps
        if not self._in.empty() or self._has_parked_requests():
            to_finish = min(self._slot_budget[s] - self._sched[s]
                            for s in elig)
            k = max(1, min(k, to_finish))
        k = min(k, max(1, self._max_len - 1
                       - max(self._slot_pos[s] for s in elig)))
        k = 1 << (k.bit_length() - 1)
        ready = self._prepare_dispatch(elig, k)
        if not ready:
            self._dispatch_stalled(elig)
            return False
        S = self._num_slots
        act = np.zeros((S,), bool)
        temps = np.zeros((S,), np.float32)
        for s in ready:
            act[s] = True
            temps[s] = self._slot_temp.get(s, 0.0)
        sampling = bool(temps.any())
        out = self._run_chunk(act, k, temps, sampling)
        self._inflight.append(("chunk", {
            "out": _HostCopy(out),
            "slots": {s: self._slot_req[s] for s in ready}}))
        for s in ready:
            self._slot_pos[s] += k
            self._sched[s] += k
        return True

    def _reap(self):
        """Wait for the OLDEST in-flight record's host copy and fold its
        tokens into the slot bookkeeping; tokens of slots recycled since
        dispatch are dropped by the slot -> request match."""
        kind, rec = self._inflight.popleft()
        if kind == "admit":
            firsts = rec["firsts"].numpy()
            now = time.monotonic()
            for i, (req_id, slot) in enumerate(rec["batch"]):
                if self._slot_req.get(slot) != req_id:
                    continue
                self._slot_ttft[slot] = now - self._slot_start[slot]
                tok = int(firsts[i])
                self._slot_tokens[slot].append(tok)
                self._maybe_finish(slot, tok)
            return
        out = rec["out"].numpy()  # [k, S]
        self._steps += out.shape[0]
        for slot, req_id in rec["slots"].items():
            if self._slot_req.get(slot) != req_id:
                continue
            for step in range(out.shape[0]):
                tok = int(out[step, slot])
                self._slot_tokens[slot].append(tok)
                if self._maybe_finish(slot, tok):
                    break

    def _tick(self):
        # cancel handling on the engine thread, where slot bookkeeping is
        # single-threaded
        with self._done_lock:
            cancelled = set(self._cancelled)
        if cancelled:
            for slot, rid in list(self._slot_req.items()):
                if rid in cancelled:
                    self._slot_budget[slot] = 0
                    self._maybe_finish(slot, -1)
            cutoff = time.monotonic() - 600.0
            with self._done_lock:
                for rid, t in list(self._cancelled.items()):
                    if t < cutoff:
                        del self._cancelled[rid]
        self._admit()
        dispatched = self._dispatch()
        # keep at most `depth` records in flight; when nothing was
        # dispatched, drain so finished slots free up
        if self._inflight and (len(self._inflight) > self._depth
                               or not dispatched):
            self._reap()
        if not dispatched and not self._inflight:
            if self._in.empty():
                time.sleep(0.002)
