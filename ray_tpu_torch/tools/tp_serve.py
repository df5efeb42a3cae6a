"""Tensor-parallel serving across the cards of one machine.

    python -m ray_tpu_torch.tools.tp_serve [--tp N]   # default: every card

Serves the requests of ``chip_smoke.py``'s phase 3 (8 greedy prompts of
100 to 500 tokens, the last sharing the second's first 128 tokens, 32
new tokens each; 8 slots, max_len 1024, buckets 128/512, chunks of 8,
pages of 64) through ``LLMEngine``, ``PagedLLMEngine`` and
``DisaggPagedEngine`` (2 prefill workers, divert floor 128, as phase
9(b)) at tp 1 and at tp N (N - 1 follower processes on the other cards,
NCCL between them), on the same random weights from seed 0:

1. Llama-3-8B width with 2 layers in fp32: the tp-N transcripts of the
   three engines must equal the tp-1 dense engine's (the per-layer
   ``psum`` sums in another order, which fp32 greedy tokens do not feel
   here), the disaggregated engine must hand off every diverted prompt,
   and every engine shuts down within ``SHUTDOWN_S``. Then the pages of
   the second prompt, exported from a tp-N paged engine, are imported
   into a tp-1 one: the last prompt must hit them (128 tokens) and
   decode the exporter's tokens.
2. Llama-3-8B bf16, 32 layers: wall time, TTFT and ITL p50/p99 of each
   engine at tp 1 and tp N, how many transcripts agree (printed, not
   required in bf16), rank 0's kernel launches (flash forward and paged
   split passes) and rank 0's peak memory above what its card held before
   the engine (at tp N that includes its weight shard).

Prints the cards' name and power limit first and one JSON object last.
Exits non-zero when a check fails or fewer than 2 cards are visible.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

# the engine settings and requests of chip_smoke.py's phase 3
SERVE = dict(num_slots=8, max_len=1024, prefill_buckets=[128, 512],
             chunk_steps=8, max_new_tokens=32, eos_id=-1)
LENS = (100, 157, 214, 271, 328, 385, 442, 500)
# seconds an engine may take to stop its followers
SHUTDOWN_S = 20.0
# the disaggregated engine's settings in chip_smoke.py's phase 9(b)
DISAGG = dict(page_size=64, prefill_workers=2, divert_min_tokens=128,
              handoff_timeout_s=60.0)


def requests(vocab_size: int):
    rng = np.random.default_rng(12)
    prompts = [[int(t) for t in rng.integers(1, vocab_size, m)]
               for m in LENS]
    prompts[7] = prompts[1][:128] + prompts[7][128:]
    return ([(f"q{i}", prompts[i]) for i in range(7)],
            [("q7", prompts[7])])


def _drain(eng, reqs, timeout_s: float) -> dict:
    for rid, prompt in reqs:
        eng.submit(rid, prompt)
    out: dict = {}
    deadline = time.monotonic() + timeout_s
    while len(out) < len(reqs) and time.monotonic() < deadline:
        out.update(eng.collect())
        time.sleep(0.005)
    bad = [r for r, _ in reqs if not isinstance(out.get(r), dict)]
    if bad:
        raise RuntimeError(f"requests {bad} failed or timed out: "
                           f"{[out.get(r) for r in bad]}")
    return out


def _latency(out: dict) -> dict:
    ttft = [r["ttft_s"] * 1e3 for r in out.values()]
    itl = [(r["latency_s"] - r["ttft_s"]) / max(len(r["tokens"]) - 1, 1)
           * 1e3 for r in out.values()]
    return {"ttft_p50": float(np.percentile(ttft, 50)),
            "ttft_p99": float(np.percentile(ttft, 99)),
            "itl_p50": float(np.percentile(itl, 50)),
            "itl_p99": float(np.percentile(itl, 99))}


def serve(cls, cfg, params, dev, tp: int, **kw) -> dict:
    """One engine's run of the requests: transcripts, wall, latency,
    rank 0's launches and peak memory."""
    from ray_tpu_torch.ops.attention import flash_forward
    from ray_tpu_torch.ops.paged_attention import paged_attention

    first, last = requests(cfg.vocab_size)
    flash_forward.launches = paged_attention.launches = 0
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
    mc = {"preset": "llama3_8b", "num_layers": cfg.num_layers,
          "dtype": cfg.dtype, "param_dtype": cfg.param_dtype}
    eng = cls(model_config=mc, params=params, device=dev, tp=tp, **SERVE,
              **kw)
    t0 = time.perf_counter()
    try:
        out = _drain(eng, first, 600)
        out.update(_drain(eng, last, 300))
        wall = time.perf_counter() - t0
        st = eng.stats()
    finally:
        t1 = time.perf_counter()
        eng.shutdown()
        stop = time.perf_counter() - t1
    peak = ((torch.cuda.max_memory_allocated(dev) - base) / 2**30
            if dev.type == "cuda" else 0.0)
    return {"tokens": {r: v["tokens"] for r, v in out.items()},
            "wall_s": wall, "shutdown_s": stop, **_latency(out),
            "flash_launches": flash_forward.launches,
            "paged_launches": paged_attention.launches,
            "rank0_peak_gib": peak,
            "handed_off": st.get("disagg_handoffs", 0) == st.get(
                "disagg_diverted", 0)}


def export_import(cfg, params, dev, tp: int) -> dict:
    """The second prompt's 2 cached pages exported from a tp-``tp`` paged
    engine (gathered to rank 0) and imported into a tp-1 one; the last
    prompt, which shares them, then decodes on each."""
    from ray_tpu_torch.serve.paged_engine import PagedLLMEngine

    first, last = requests(cfg.vocab_size)
    mc = {"preset": "llama3_8b", "num_layers": cfg.num_layers,
          "dtype": cfg.dtype, "param_dtype": cfg.param_dtype}
    kw = dict(model_config=mc, params=params, device=dev, page_size=64,
              **SERVE)
    src = PagedLLMEngine(tp=tp, **kw)
    try:
        _drain(src, first[1:2], 300)
        prompt = first[1][1]
        pages, hashes, _ = src._alloc.match_prefix(prompt, len(prompt))
        k, v = src.export_pages(pages)
        for pg in pages:
            src._alloc.release(pg)
        want = _drain(src, last, 300)["q7"]["tokens"]
    finally:
        src.shutdown()
    dst = PagedLLMEngine(tp=1, **kw)
    try:
        imported = dst.import_pages(k, v, hashes)
        got = _drain(dst, last, 300)["q7"]["tokens"]
        hit = dst._prefix_hit_tokens
    finally:
        dst.shutdown()
    return {"pages": len(pages), "imported": imported, "hit_tokens": hit,
            "shape": tuple(k.shape), "equal": got == want}


def run(dev: torch.device, tp: int) -> dict:
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.serve.disagg import DisaggPagedEngine
    from ray_tpu_torch.serve.llm_engine import LLMEngine
    from ray_tpu_torch.serve.paged_engine import PagedLLMEngine

    engines = (("dense", LLMEngine, {}),
               ("paged", PagedLLMEngine, {"page_size": 64}),
               ("disagg", DisaggPagedEngine, DISAGG))
    result: dict = {"tp": tp}
    ok = True
    # 1: fp32, 2 layers at full width: tp N gives tp 1's tokens
    cfg = llama.LlamaConfig.llama3_8b(num_layers=2, dtype=torch.float32,
                                      param_dtype=torch.float32)
    params = llama.init_params(cfg, seed=0, device=dev)
    ref = serve(LLMEngine, cfg, params, dev, 1)["tokens"]
    for name, cls, kw in engines:
        res = serve(cls, cfg, params, dev, tp, **kw)
        same = sum(res["tokens"][r] == ref[r] for r in ref)
        ok &= (same == len(ref) and res["shutdown_s"] < SHUTDOWN_S
               and res["handed_off"])
        result[f"fp32_{name}_tp{tp}_equal"] = same
        print(f"fp32 2 layers, {name} tp {tp}: {same}/{len(ref)} "
              f"transcripts equal the tp-1 dense engine's; shutdown "
              f"{res['shutdown_s']:.2f} s; every diverted prompt handed "
              f"off: {res['handed_off']}", flush=True)
    moved = export_import(cfg, params, dev, tp)
    ok &= (moved["imported"] == moved["pages"] == 2
           and moved["hit_tokens"] == 128 and moved["equal"])
    result[f"fp32_export_tp{tp}_import_tp1"] = moved
    print(f"fp32 2 layers, export at tp {tp}, import at tp 1: "
          f"{moved['imported']} of {moved['pages']} pages ({moved['shape']} "
          f"each of k, v), prefix hit {moved['hit_tokens']} tokens, the "
          f"exporter's tokens: {moved['equal']}", flush=True)
    del params
    # 2: bf16, 32 layers: latency and agreement
    cfg = llama.LlamaConfig.llama3_8b(dtype=torch.bfloat16,
                                      param_dtype=torch.bfloat16)
    params = llama.init_params(cfg, seed=0, device=dev)
    for name, cls, kw in engines:
        runs = {n: serve(cls, cfg, params, dev, n, **kw) for n in (1, tp)}
        same = sum(runs[tp]["tokens"][r] == runs[1]["tokens"][r]
                   for r in runs[1]["tokens"])
        for n, r in runs.items():
            print(f"bf16 32 layers, {name} tp {n}: wall {r['wall_s']:.2f} "
                  f"s (shutdown {r['shutdown_s']:.2f} s), TTFT p50/p99 {r['ttft_p50']:.2f}/{r['ttft_p99']:.2f} "
                  f"ms, ITL p50/p99 {r['itl_p50']:.3f}/{r['itl_p99']:.3f} "
                  f"ms; rank 0: flash launches {r['flash_launches']}, "
                  f"paged launches {r['paged_launches']}, peak "
                  f"{r['rank0_peak_gib']:.2f} GiB above what cuda:0 held "
                  f"before the engine", flush=True)
            result[f"bf16_{name}_tp{n}"] = {
                k: v for k, v in r.items() if k != "tokens"}
        print(f"bf16 32 layers, {name}: tp {tp} and tp 1 transcripts "
              f"identical for {same}/8 (not required in bf16)", flush=True)
        result[f"bf16_{name}_agree"] = same
        ok &= all(len(t) == 32 for r in runs.values()
                  for t in r["tokens"].values())
    result["ok"] = bool(ok)
    return result


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tp", type=int, default=0,
                    help="ranks (default: every visible card)")
    tp = ap.parse_args().tp or torch.cuda.device_count()
    if not torch.cuda.is_available() or tp < 2 \
            or torch.cuda.device_count() < tp:
        print(f"tp_serve: needs at least 2 cards and tp <= the cards "
              f"({torch.cuda.device_count()} visible, tp {tp})",
              file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; tp {tp}",
          flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    result = run(torch.device("cuda", 0), tp)
    print(json.dumps(result), flush=True)
    sys.exit(0 if result["ok"] else 1)


if __name__ == "__main__":
    main()
