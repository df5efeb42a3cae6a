"""Serving latency of one checkout's engines on the card.

    python3 ray_tpu_torch/tools/serve_latency.py [--tree DIR] [--reps 2]
    python3 ray_tpu_torch/tools/serve_latency.py --disagg-repeats 5

Imports ``ray_tpu_torch`` from ``DIR`` (default: the checkout holding
this file) and the engine settings and requests (``SERVE_8B``,
``serve_8b_requests``, ``published_config``) from the ``chip_smoke.py``
of the checkout holding this file, so two checkouts serve the same work.
Run a parent and a change in turns on one card, e.g. with the parent
unpacked under ``_tree/parent``::

    for t in _tree/parent . . _tree/parent; do
        python3 ray_tpu_torch/tools/serve_latency.py --tree $t; done

By default the engines of ``chip_smoke.py`` phases 3 (Llama-3-8B bf16,
dense and paged), 9(b) (the disaggregated engine: 2 prefill workers on
their own streams, divert floor 128) and 6 (Qwen2-7B and Gemma-7B bf16,
dense and paged), on random weights from seed 0, serve phase 3's 8
requests (7 at once, then the last), each run on a fresh engine: one
warm-up run, then ``--reps`` runs. For each run it prints the wall time
of the 8 requests, TTFT and ITL p50/p99 as ``chip_smoke.py`` computes
them (ITL: (latency - TTFT) / (tokens - 1)), whole-request latency
p50/p99 and the decode steps; then one JSON object with the card's name
and power limit and every run's numbers.

``--disagg-repeats N`` instead serves phase 9(b)'s bf16 disaggregated
engine once without a mesh and then N times with ``mesh={tp 1}`` (NCCL
at world size 1), all on the same inputs, and prints for each
``mesh={tp 1}`` run which requests' transcripts equal the first run's,
and for each request the prefill worker that took it and the tokens its
staging cache already held (``DisaggPagedEngine.prefill_log()``). bf16
transcripts of that engine differ between runs; this reproduces it. Each
run also logs every decode chunk it dispatches (its steps and, for each
active request, the position its first step writes); for each request
whose transcript parts from the no-mesh run's, the tool prints the token
where they part and the chunk that produced it in both runs (its steps,
its active requests and the token's step within it), or "prefill" for
the first token, and counts the partings whose two chunks had the same
composition. A parting in a chunk of the same composition would be a
run-to-run difference of the port itself; one where the compositions
differ is the bf16 rounding of a decode batch of other rows.

Needs one card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_settings", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _log_chunks(eng) -> list:
    """Record each decode chunk ``eng`` dispatches: its steps ``k`` and,
    for each active request, the position its first step writes and the
    request's prompt length (read on the engine thread at dispatch)."""
    import numpy as np

    log = []
    run_chunk = eng._run_chunk

    def logged(act, k, *a):
        log.append({"k": int(k), "reqs": {
            eng._slot_req[s]: (eng._slot_pos[s], eng._slot_plen[s])
            for s in np.nonzero(act)[0].tolist()}})
        return run_chunk(act, k, *a)
    eng._run_chunk = logged
    return log


def _producer(chunks: list, req: str, t: int):
    """The chunk that produced token ``t`` (t >= 1: token 0 comes from
    the prefill) of ``req``, and the token's step within it."""
    for c in chunks:
        if req in c["reqs"]:
            pos, plen = c["reqs"][req]
            first = pos - plen + 1
            if first <= t < first + c["k"]:
                return c, t - first
    return None, None


def _parting(want: dict, got: dict, q: str) -> dict:
    """Where request ``q``'s transcript in run ``got`` parts from
    ``want``'s, and the chunks that produced that token in each."""
    a, b = want["tokens"][q], got["tokens"][q]
    t = next((i for i in range(min(len(a), len(b))) if a[i] != b[i]),
             min(len(a), len(b)))
    if t == 0:
        return {"req": q, "token": 0, "where": "prefill", "same": None}
    ca, sa = _producer(want["chunks"], q, t)
    cb, sb = _producer(got["chunks"], q, t)

    def shape(c, step):
        return None if c is None else {"k": c["k"], "step": step,
                                       "active": sorted(c["reqs"])}

    wa, wb = shape(ca, sa), shape(cb, sb)
    return {"req": q, "token": t, "where": "decode", "want": wa,
            "got": wb, "same": wa is not None and wa == wb}


def _run(cs, make, first, last) -> dict:
    """One run on a fresh engine: the numbers of its 8 requests, and
    the engine's transcripts, prefill log and decode-chunk log."""
    import numpy as np
    import torch

    eng = make()
    chunks = _log_chunks(eng)
    if hasattr(eng, "_wstates"):
        deadline = time.monotonic() + 30
        while len(eng._wstates) < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = cs.drain(eng, first, 300)
    out.update(cs.drain(eng, last, 120))
    wall = time.perf_counter() - t0
    st = eng.stats()
    log = eng.prefill_log() if hasattr(eng, "prefill_log") else {}
    cs.stop(eng)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    cs.check(all(len(r["tokens"]) == 32 for r in out.values()),
             "a request got fewer than 32 tokens")
    lat = [r["latency_s"] * 1e3 for r in out.values()]
    return {"wall_s": wall, **cs._latency_ms(out),
            "latency_p50": float(np.percentile(lat, 50)),
            "latency_p99": float(np.percentile(lat, 99)),
            "steps": st["steps"],
            "tokens": {r: v["tokens"] for r, v in out.items()},
            "prefill_log": log, "chunks": chunks}


def _line(what: str, rep: str, r: dict) -> str:
    return (f"{what} {rep}: wall {r['wall_s']:.3f} s; TTFT p50/p99 "
            f"{r['ttft_p50']:.2f}/{r['ttft_p99']:.2f} ms; ITL p50/p99 "
            f"{r['itl_p50']:.3f}/{r['itl_p99']:.3f} ms; latency p50/p99 "
            f"{r['latency_p50']:.2f}/{r['latency_p99']:.2f} ms; decode "
            f"steps {r['steps']}")


def latency(cs, dev, reps: int) -> list:
    from dataclasses import replace

    import torch

    from ray_tpu_torch.models import llama
    from ray_tpu_torch.serve.disagg import DisaggPagedEngine
    from ray_tpu_torch.serve.llm_engine import LLMEngine
    from ray_tpu_torch.serve.paged_engine import PagedLLMEngine

    rows = []
    for model in ("Llama-3-8B", "Qwen2-7B", "Gemma-7B"):
        if model == "Llama-3-8B":
            cfg = llama.LlamaConfig.llama3_8b(dtype=torch.bfloat16,
                                              param_dtype=torch.bfloat16)
            mc = cs.SERVE_8B["model_config"]
        else:
            cfg = replace(cs.published_config(model), dtype=torch.bfloat16,
                          param_dtype=torch.bfloat16, max_seq_len=1024)
            mc = cs._model_config(cfg)
        params = llama.init_params(cfg, seed=0, device=dev)
        first, last = cs.serve_8b_requests(cfg.vocab_size)
        kw = dict(cs.SERVE_8B, model_config=mc, params=params, device=dev)
        engines = [("dense", lambda: LLMEngine(**kw)),
                   ("paged", lambda: PagedLLMEngine(page_size=64, **kw))]
        if model == "Llama-3-8B":
            engines.append(("disagg", lambda: DisaggPagedEngine(
                prefill_workers=2, divert_min_tokens=128,
                handoff_timeout_s=cs.CLEAN_LEASE_S, page_size=64, **kw)))
        for name, make in engines:
            for rep in range(reps + 1):
                r = _run(cs, make, first, last)
                tag = "warm-up" if rep == 0 else f"run {rep}/{reps}"
                print(_line(f"{model} {name}", tag, r), flush=True)
                r.pop("tokens")
                r.pop("prefill_log")
                r.pop("chunks")
                rows.append({"model": model, "engine": name, "rep": rep,
                             **r})
        del params, kw, engines, make
        gc.collect()
        torch.cuda.empty_cache()
    return rows


def disagg_repeats(cs, dev, n: int) -> list:
    import torch

    from ray_tpu_torch.models import llama
    from ray_tpu_torch.parallel import (MeshSpec, build_mesh,
                                        init_process_group)
    from ray_tpu_torch.serve.disagg import DisaggPagedEngine

    cfg = llama.LlamaConfig.llama3_8b(dtype=torch.bfloat16,
                                      param_dtype=torch.bfloat16)
    params = llama.init_params(cfg, seed=0, device=dev)
    first, last = cs.serve_8b_requests(cfg.vocab_size)
    dkw = dict(cs.SERVE_8B, params=params, device=dev, page_size=64,
               prefill_workers=2, divert_min_tokens=128,
               handoff_timeout_s=cs.CLEAN_LEASE_S)

    def log_line(log):
        return " ".join(f"{r}:w{w}/{h}" for r, (w, h) in sorted(log.items()))

    want = _run(cs, lambda: DisaggPagedEngine(**dkw), first, last)
    print(f"no mesh: prefill worker/hit tokens "
          f"{log_line(want['prefill_log'])}; TTFT p50 "
          f"{want['ttft_p50']:.2f} ms", flush=True)
    rows = []
    agree = dict.fromkeys(want["tokens"], 0)
    partings = []
    with tempfile.TemporaryDirectory() as store:
        init_process_group(0, 1, dev, store_path=os.path.join(store, "pg"))
        try:
            mesh = build_mesh(MeshSpec({"tp": 1}))
            for rep in range(n):
                r = _run(cs, lambda: DisaggPagedEngine(mesh=mesh, **dkw),
                         first, last)
                same = sorted(q for q in want["tokens"]
                              if r["tokens"][q] == want["tokens"][q])
                for q in same:
                    agree[q] += 1
                parts = [_parting(want, r, q) for q in sorted(want["tokens"])
                         if q not in same]
                partings += parts
                print(f"mesh={{tp 1}} run {rep + 1}/{n}: equal to the "
                      f"no-mesh run {' '.join(same)} ({len(same)}/8); "
                      f"prefill worker/hit tokens "
                      f"{log_line(r['prefill_log'])}; TTFT p50 "
                      f"{r['ttft_p50']:.2f} ms", flush=True)
                for p in parts:
                    print(f"  {p['req']} parts at token {p['token']}: "
                          + ("prefill" if p["where"] == "prefill" else
                             f"no-mesh chunk {p['want']}, this run's "
                             f"{p['got']}, same composition {p['same']}"),
                          flush=True)
                rows.append({"rep": rep + 1, "equal": same,
                             "prefill_log": {q: list(v) for q, v in
                                             r["prefill_log"].items()},
                             "partings": parts})
        finally:
            import torch.distributed as dist

            dist.destroy_process_group()
    print(f"runs agreeing with the no-mesh run per request over {n}: "
          f"{' '.join(f'{q}:{k}' for q, k in sorted(agree.items()))}",
          flush=True)
    decode = [p for p in partings if p["where"] == "decode"]
    print(f"partings: {len(partings)}, {len(partings) - len(decode)} at "
          f"the prefill's token; of the {len(decode)} in decode, "
          f"{sum(bool(p['same']) for p in decode)} in a chunk of the same "
          f"composition (steps, active requests, step) in both runs",
          flush=True)
    return rows


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(ROOT))
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--disagg-repeats", type=int, default=0)
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch

    import ray_tpu_torch

    assert Path(ray_tpu_torch.__file__).resolve().is_relative_to(tree)
    if not torch.cuda.is_available():
        sys.exit("serve_latency: no CUDA device")
    cs = _chip_smoke()
    dev = torch.device("cuda")
    from ray_tpu_torch.ops import _build

    _build.load()
    card = cs.smi_line()
    print(card, flush=True)
    if args.disagg_repeats:
        rows = disagg_repeats(cs, dev, args.disagg_repeats)
    else:
        rows = latency(cs, dev, args.reps)
    print(json.dumps({"tree": args.tree, "card": card, "runs": rows}),
          flush=True)


if __name__ == "__main__":
    main()
