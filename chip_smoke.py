#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (ray_tpu_torch) on one card.

    python3 chip_smoke.py            # runs every phase; needs one CUDA card

Phases, each printing what it finds; any failure exits non-zero:

0. the card's name and power limit; build the CUDA kernels from
   ray_tpu_torch/csrc (timed), with ptxas's registers and spills; the
   six wgmma kernels (the bf16 flash forward, dQ and dK/dV at d 64/128
   and at d 256) must contain HGMMA instructions in the built library's
   SASS (cuobjdump), and the three d-256 ones no spill; the fifteen
   3xTF32 instances (the fp32 forward, dQ and dK/dV at d 16-256) HMMA
   (mma.sync) instructions, and those at d <= 128 no spill.
1. each kernel against its plain PyTorch version on the card: the flash
   forward at the serving shapes, s 2048 and the training shape (b 4,
   s 2048, bf16), the flash backward (dQ and dK/dV) at b 1/4, s
   128/512/2048, causal and not, sk 512 > sq 128 and d 64, both with
   ragged lengths (s 100, s 1000, sq 128 / sk 300) and d 64 in bf16, fp32
   at b 1 x s 4096 causal (G 4: 1,536 adds into one dQ accumulator
   without its restarts), the
   paged kernel at the decode shape and on a 64-page table whose
   contexts land on the split boundaries of its split-K grid, with ctx
   0 exact, out-of-pool ids below ctx read as clamped, and two calls on
   the same inputs equal bit for bit. fp32 (the 3xTF32 forward, dQ and
   dK/dV) at atol 1e-4 (the backward also rtol 1e-4: dK sums up to sk*G
   products an element), bf16 (the wgmma kernels) at atol/rtol 2e-2
   against the plain version in fp32 on the same bf16 inputs; every bf16
   forward, dQ and dK/dV launch must take the wgmma route, every fp32
   forward, dQ and dK/dV the 3xTF32 one. Times of each kernel, its plain
   version and one PyTorch call computing the same function
   (scaled_dot_product_attention, its backward for the dQ/dK/dV pair),
   with the least time the card could take (for fp32 work, the 3xTF32
   floor at 495 / 3 TFLOP/s, the 67 TFLOP/s SIMT bound printed beside
   it). The backward is timed at the training shape, the paged wrapper
   (its split and merge launches) at the decode shape; the fp32 kernels
   at d 128 at the same shapes, and the fp32 dQ and dK/dV pair against
   SDPA's fp32 backward.
   Phase 1 also holds the paged kernel at the published shapes that
   Qwen2 and Gemma give it (G 7 under the row maximum 8 at hd 128 and
   64, G 1 and G 8 at hd 256; fp32 and bf16; the old contexts and a 64-page
   table; timed at the decode shape), the flash forward, dQ and dK/dV at
   head dim 256 (16/16 heads; every bf16 launch on the wgmma route, every
   fp32 launch on the 3xTF32 route; timed at b 8 x s 512
   and, the backward, b 2 x s 2048), the head dims 16 and 32 of the tiny
   presets (the flash kernels, fp32 and bf16, and the paged kernel under
   every row maximum), and the 3xTF32 kernels at d 16, 32, 64, 128 and
   256 by GQA groups 1, 4, 7 and 8, causal and not.
2. fp32, 2 layers, at full Llama-3-8B, Qwen2-7B and Gemma-7B width: the
   dense engine (flash prefill) and the paged engine (paged decode) give
   identical greedy transcripts, which agree with a cache-free forward
   pass through the reference attention.
3. bf16 Llama-3-8B, all 32 layers, one shared set of random weights:
   the dense engine, then the paged engine (with a prefix-cache hit),
   each answer 8 requests with 32 tokens; the launch counters show
   their kernels ran, every flash launch on the wgmma route; TTFT and
   ITL medians.
4. fp32, 2 layers, batch 2 x seq 256, at full Llama-3-8B width and then
   full Gemma-7B width (head dim 256): the loss and
   every gradient leaf through the flash kernels match the reference
   attention's (max |dg| <= 1e-4 max |g| per leaf), and full remat
   matches no remat.
5. training: the run of ``ray_tpu_torch.tools.profile_train`` (Llama-3-8B
   width, 8 layers, fp32 params, bf16 compute, full remat, batch 4 x seq
   2048), 5 AdamW steps on one batch of random tokens; the loss is
   finite and falls, the launch counters show the
   forward (twice under remat) and both backward kernels ran on every
   layer of every step, all three on the wgmma route; step
   time, tokens/s, MFU, peak memory.
6. Qwen2-7B and Gemma-7B at full width (configs from
   ``llama_config_from_hf`` on their published config.json values, bf16
   random weights from seed 0, 28 layers each) through the dense and
   then the paged engine with phase 3's requests: the flash forward
   launches once a layer a prefill batch, on the wgmma route (head dim
   128 and 256), the paged kernel once a layer a decode step; TTFT and
   ITL medians.
7. training GPT-2 125M whole (batch 8 x 1024), Mixtral-8x7B width cut
   to 2 layers (batch 4 x 2048) and Gemma-7B width cut to 4 layers
   (batch 2 x 2048), 5 AdamW steps each: losses fall, every layer's
   forward, dQ and dK/dV run on their routes (all wgmma, Gemma's at head
   dim 256 too); step time, tokens/s, MFU, peak memory.
8. the tiny presets on the card (head dim 16): ``LLMEngine()`` and
   ``PagedLLMEngine()`` with their defaults (Llama tiny, fp32) answer
   prompts that pad to the 128 bucket with the same greedy transcripts,
   which agree with a cache-free forward; ``loss_fn`` and its backward
   on the Llama, GPT-2 and Mixtral tiny presets through the kernels
   match the reference attention's gradients (1e-4 of each leaf's max).
   The counters show the d-16 flash and hd-16 paged kernels ran.
9. disaggregated prefill/decode and the decode API. (a) fp32, 2 layers
   at Llama-3-8B width, phase 3's requests: ``DisaggPagedEngine`` (2
   prefill workers, divert floor 128, a 60 s handoff lease) gives the
   ``PagedLLMEngine``'s greedy tokens with every prompt of 128 tokens
   or more diverted and handed off, no page leaked, and again under a
   dropped handoff and a killed worker (0.5 s lease; recovered, both
   workers alive after). (b) bf16
   Llama-3-8B, 32 layers, phase 3's weights and requests: the paged
   engine, then the disaggregated one with its workers on streams of
   their own; TTFT and ITL p50/p99 of each, the paged kernel's
   launches, the staging pool's size; how many transcripts agree
   (printed, not required in bf16). (c) ``prefill`` of one 512-token
   prompt launches the flash forward once a layer and matches
   ``prefill_batch`` (bf16 atol/rtol 2e-2); ``insert_sequence`` writes
   a dense-cache slot exactly; ``init_shapes`` has ``init_params``'s
   shapes and dtypes.
10. the RL learners (PPO, IMPALA, APPO on the conv module at Catch's 10
   x 10 x 1; DQN, CQL on the Q MLP and BC, MARWIL on the MLP at
   CartPole's 4 / 2; SAC at Pendulum's 3 / 1; DreamerV3 at CartPole's 4 /
   2 with the reference's defaults, batch 8 x 16), each built on the card
   and on the CPU from the same parameters and given the same 3 batches
   (PPO the same permutations, SAC and DreamerV3 the same noise): the first
   gradients agree at atol 1e-5 / rtol 1e-4 and the parameters after
   the 3 updates within 0.2 lr an optimizer step; the losses of each
   update at rtol 1e-4 against a CPU learner that starts that update
   from the card learner's state (``rl_phase`` says why); ms per
   update on the card (median of 10).
11. the parallel layer (``ray_tpu_torch.parallel``, the models' mesh
   surface) at world size 1 over NCCL: one card cannot hold two ranks of
   one communicator, so multi-rank numerics are held on the CPU by the
   gloo tests. Phase 5's Llama-3-8B width, 8 layers, 4 x 2048 (fp32
   params, bf16 compute, full remat): ``loss_fn(mesh={fsdp 1, sp 1, tp
   1})`` with Ulysses (the wgmma flash forward, dQ and dK/dV on the local
   heads, launches counted) and with ring attention (plain ops, no
   launch), ``loss_fn_pp`` at pp 1 with 4 microbatches; Mixtral-8x7B
   width, 2 layers, under {dp 1, ep 1}. Each loss and every gathered
   gradient leaf are held to the mesh-free run on the same weights and
   attention math (the flash kernels; ring's fp32 math to the reference
   attention) at bf16 atol/rtol 2e-2 (atol scaled by the leaf's largest
   value); ms a
   step (loss and backward) of each beside the mesh-free step. The phase
   destroys its process group.
12. tensor-parallel serving at world size 1 over NCCL (multi-rank serving
   is held on the CPU by ``tests/test_torch_tp_serve.py``): phase 3's
   Llama-3-8B bf16 weights and requests through both engines with
   ``mesh={tp 1}`` give phase 3's greedy tokens request by request with
   the same flash (wgmma) and paged launches; TTFT and ITL p50/p99 beside
   phase 3's; the engine's peak memory on top of the weights stays below
   a second copy of them; ``LLMEngine(tp=2)`` on one card raises the
   reference's ValueError.
13. sharded checkpoints, the predictor, and disaggregated serving and
   page export/import under ``mesh=``. (a) Phase 5's run (rebuilt from
   ``profile_train``) after its 5 AdamW steps: params and AdamW state
   through ``train.dist_checkpoint.save`` into the temporary directory
   (its free space printed first; the params alone if it cannot hold
   both), freed, restored into fresh tensors on the card: every leaf's
   checksum (the sum of its bytes as integers) and the step-6 loss
   equal those from before the save, bit for bit; save and restore
   seconds and GB/s. (b) ``TorchPredictor.from_checkpoint`` over the
   same checkpoint, ``llama.forward`` on 8 x 512 tokens: the argmax
   equals the in-memory forward's, the flash forward launches once a
   layer on the wgmma route; the predict time. (c) at world size 1 over
   NCCL, phase 9's disaggregated engine (2 workers) with ``mesh={tp
   1}``: fp32 at 2 layers gives phase 9(a)'s paged tokens for 8/8
   requests; bf16 at 32 layers on phase 3's weights and requests hands
   off every prompt of 128 tokens or more, leaks no page, and prints
   TTFT and ITL p50/p99 beside 9(b)'s and how many transcripts equal
   9(b)'s (bf16 disaggregated transcripts differ between runs: the two
   workers race for q7, whose worker may hold q1's pages in its staging
   cache); q1's pages exported from one ``mesh={tp 1}`` paged engine
   and imported into another, where q7 hits them (128 tokens) and
   decodes the exporter's q7 tokens.

Phases 2, 4, 8 and 9(a) (fp32) check that every flash forward, dQ and
dK/dV launch took the 3xTF32 kernels.

The second line from the end is the kernel table as JSON, one row per
kernel and instance route (launches of the serving kernels from phases
3 and 6, of the backward kernels from phases 5 and 7's Gemma run, of
the fp32 kernels from phase 2's Llama dense engine and phase 4's
Llama and Gemma runs; the d-128 wgmma rows add phase 11's sharded
runs and phase 13's training, losses and predictor, the d-128 forward
and G-4 paged rows phase 12's engines, the G-4 paged row phase 13's);
the last line is ``{"ok": true, "device": {...}}``. Without CUDA, or
without the ray_tpu_torch package beside it, the script exits non-zero
before any result.
"""

from __future__ import annotations

import gc
import json
import logging
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# fp32 work in 3xTF32 on the tensor cores: three TF32 products (495
# TFLOP/s dense) for each fp32 one; the floor of the 3xTF32 kernels
TF32X3_FLOPS = 495e12 / 3

# config.json values of the published models phases 4 and 6 build
# (Qwen/Qwen2-7B, google/gemma-7b), written out so that the configs build
# without transformers or a download; llama_config_from_hf reads them as
# attributes
PUBLISHED = {
    "Qwen2-7B": dict(vocab_size=152064, hidden_size=3584,
                     intermediate_size=18944, num_hidden_layers=28,
                     num_attention_heads=28, num_key_value_heads=4,
                     max_position_embeddings=131072, rope_theta=1000000.0,
                     rms_norm_eps=1e-6, tie_word_embeddings=False,
                     use_sliding_window=False, hidden_act="silu"),
    "Gemma-7B": dict(vocab_size=256000, hidden_size=3072,
                     intermediate_size=24576, num_hidden_layers=28,
                     num_attention_heads=16, num_key_value_heads=16,
                     head_dim=256, max_position_embeddings=8192,
                     rope_theta=10000.0, rms_norm_eps=1e-6,
                     tie_word_embeddings=True,
                     hidden_activation="gelu_pytorch_tanh"),
}


def published_config(model: str):
    """The port's LlamaConfig of a ``PUBLISHED`` model, through
    ``llama_config_from_hf``: Qwen2 with its q/k/v biases; Gemma with the
    deltas ``gemma_from_hf`` applies (GeGLU, sqrt(hidden) embed scale,
    tied head; its norms' +1 lives in the weights)."""
    import math
    import types
    from dataclasses import replace

    from ray_tpu_torch.models.hf_weights import llama_config_from_hf

    attrs = types.SimpleNamespace(**PUBLISHED[model])
    cfg = llama_config_from_hf(attrs, attn_qkv_bias=model == "Qwen2-7B")
    if model == "Gemma-7B":
        cfg = replace(cfg, mlp_act="gelu_tanh",
                      embed_scale=math.sqrt(attrs.hidden_size))
    return cfg


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30, check=True).stdout.strip().splitlines()
    return out[0] if out else ""


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of one ``fn`` call by CUDA events, each call
    after a 512 MB write that evicts the 50 MB L2: the serving path
    finds its inputs cold, behind other layers' weights. The write keeps
    the card busy for longer than the host takes to enqueue a call, so
    the events time the call's launches back to back on the card, not
    the host's Python between them."""
    flush = torch.empty(128 << 20, dtype=torch.float32, device="cuda")
    for _ in range(warmup):
        fn()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def kernel_ms(fn, names, iters: int = 10) -> dict:
    """Mean device time of each named kernel over ``iters`` calls of
    ``fn`` (which may launch several kernels), from ``torch.profiler``,
    each call after the same L2-evicting write as ``time_ms``."""
    flush = torch.empty(128 << 20, dtype=torch.float32, device="cuda")
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    us = dict.fromkeys(names, 0.0)
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        for n in names:
            if n in evt.name:
                us[n] += evt.time_range.elapsed_us()
    for n in names:
        check(us[n] > 0, f"the profiler saw no {n} launch")
    return {n: us[n] / 1e3 / iters for n in names}


def bound_ms(nbytes: float, flops: float, dtype, rate=None) -> tuple:
    """The larger of the bytes' time at the HBM rate and the operations'
    at ``rate`` (default: the dtype's peak), with which one it is."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / (rate or PEAK_FLOPS[dtype]) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def fp32_bounds(nbytes: float, flops: float) -> tuple:
    """(SIMT bound, 3xTF32 floor, bound_by) of fp32 work: at 67 TFLOP/s of
    fp32 FMAs, and at 495 / 3 on the tensor cores; the floor is the row's
    ``bound_ms``."""
    simt, _ = bound_ms(nbytes, flops, torch.float32)
    floor, by = bound_ms(nbytes, flops, torch.float32, TF32X3_FLOPS)
    return simt, floor, by


def close(got: torch.Tensor, want: torch.Tensor, atol: float,
          rtol: float) -> tuple:
    diff = (got.float() - want.float()).abs()
    ok = bool((diff <= atol + rtol * want.float().abs()).all())
    return ok, float(diff.max()) if diff.numel() else 0.0


# ---------------------------------------------------------------- phase 0

# the wgmma kernels and their instances (d 64 and 128, or d 256 alone):
# their SASS must hold HGMMA (warpgroup MMA) instructions
WGMMA_KERNELS = {"flash_fwd_sm90_kernel": 2, "flash_bwd_dq_sm90_kernel": 2,
                 "flash_bwd_dkv_sm90_kernel": 2,
                 "flash_fwd_sm90_d256_kernel": 1,
                 "flash_bwd_dq_sm90_d256_kernel": 1,
                 "flash_bwd_dkv_sm90_d256_kernel": 1}
# the kernels that must build without a spill
NO_SPILL_KERNELS = ("flash_fwd_sm90_d256_kernel",
                    "flash_bwd_dq_sm90_d256_kernel",
                    "flash_bwd_dkv_sm90_d256_kernel")
# the 3xTF32 kernels and their instances (d 16, 32, 64, 128, 256): their
# SASS must hold HMMA (mma.sync) instructions, and the instances at d <=
# 128 must build without a spill
TF32X3_KERNELS = {"flash_fwd_tf32x3_kernel": 5,
                  "flash_bwd_dq_tf32x3_kernel": 5,
                  "flash_bwd_dkv_tf32x3_kernel": 5}


def head_dim_of(name: str) -> int:
    """The head-dim template argument of a mangled kernel name."""
    m = re.search(r"ILi(\d+)E", name)
    return int(m.group(1)) if m else 0


def ptxas_usage(log: str) -> dict:
    """{mangled kernel name: (registers, spill stores, spill loads)} from
    the ``-Xptxas=-v`` lines of the build log."""
    usage, name, spills = {}, None, (0, 0)
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "spill stores" in line and name:
            nums = [int(w) for w in line.replace(",", " ").split()
                    if w.isdigit()]
            spills = (nums[1], nums[2])
        elif "Used" in line and "registers" in line and name:
            regs = int(line.split("Used")[1].split()[0])
            usage[name] = (regs, *spills)
            name, spills = None, (0, 0)
    return usage


def sass_counts(lib_path, opcodes) -> dict:
    """{opcode: {mangled kernel name: instructions}} for every kernel in
    the built library, from ``cuobjdump -sass``."""
    from ray_tpu_torch.ops import _build

    tool = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    out = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                         text=True, timeout=300, check=True).stdout
    counts, name = {op: {} for op in opcodes}, None
    for line in out.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            for op in opcodes:
                counts[op][name] = 0
        elif name:
            for op in opcodes:
                if re.search(rf"\b{op}\.", line):
                    counts[op][name] += 1
    return counts


def build_phase() -> None:
    from ray_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.load()
    print(f"  kernels built in {_build.last_build_seconds:.1f} s "
          f"(load {time.perf_counter() - t0:.1f} s): "
          f"{_build.library_path().name}", flush=True)
    log_path = _build.BUILD_DIR / "build.log"
    if log_path.exists():
        log = log_path.read_text()
        usage = ptxas_usage(log)
        for name, (regs, st, ld) in usage.items():
            print(f"  ptxas: {name}: {regs} registers, spill stores {st} "
                  f"bytes, spill loads {ld} bytes", flush=True)
        for line in log.splitlines():
            if "warning" in line.lower():
                print(f"  ptxas: {line.strip()}", flush=True)
        for kernel in NO_SPILL_KERNELS:
            found = {n: u for n, u in usage.items() if kernel in n}
            check(len(found) == 1 and all(u[1] == u[2] == 0
                                          for u in found.values()),
                  f"{kernel}: want one instance without spills, ptxas "
                  f"reported {found}")
        for kernel in TF32X3_KERNELS:
            spilled = {n: u for n, u in usage.items() if kernel in n
                       and head_dim_of(n) <= 128 and (u[1] or u[2])}
            check(not spilled, f"{kernel}: instances at d <= 128 spill: "
                  f"{spilled}")
    sass = sass_counts(_build.library_path(), ("HGMMA", "HMMA"))
    for op, kernels in (("HGMMA", WGMMA_KERNELS), ("HMMA", TF32X3_KERNELS)):
        for kernel, want in kernels.items():
            found = {n: c for n, c in sass[op].items() if kernel in n}
            check(len(found) == want, f"{kernel}: want {want} instance(s) "
                  f"in the SASS, found {sorted(found)}")
            for n, c in sorted(found.items()):
                print(f"  sass: {n}: {c} {op} instructions", flush=True)
                check(c > 0, f"{n} has no {op} instruction")


# ---------------------------------------------------------------- phase 1


def _ragged_cases(dts):
    """(b, sq, sk, d, causal, dt) cases beyond the serving and training
    shapes: lengths that are not multiples of the tiles, and d 64."""
    return [(b, sq, sk, d, c, dt) for dt in dts
            for b, sq, sk, d in ((1, 100, 100, 128), (1, 1000, 1000, 128),
                                 (2, 128, 300, 128), (2, 512, 512, 64),
                                 (1, 128, 300, 64), (1, 1000, 1000, 64))
            for c in (True, False)]


def flash_phase(dev) -> list:
    from ray_tpu_torch.ops.attention import flash_forward, flash_forward_plain

    H, KVH = 32, 8
    g = torch.Generator(device=dev).manual_seed(1)
    worst = worst_fp32 = 0.0   # bf16 (the wgmma kernel), fp32 (3xTF32)
    dts = (torch.float32, torch.bfloat16)
    cases = [(b, s, s, 128, c, dt) for dt in dts
             for b in (1, 8) for s in (128, 512) for c in (True, False)]
    cases += [(b, sq, sk, 128, c, dt) for dt in dts
              for b, sq, sk, c in ((2, 128, 512, True), (1, 2048, 2048, True),
                                   (1, 2048, 2048, False))]
    cases += _ragged_cases(dts)
    n_bf16 = sum(dt == torch.bfloat16 for *_, dt in cases)
    before = counters()
    for b, sq, sk, D, causal, dt in cases:
        q = torch.randn(b, sq, H, D, generator=g, device=dev).to(dt)
        k = torch.randn(b, sk, KVH, D, generator=g, device=dev).to(dt)
        v = torch.randn(b, sk, KVH, D, generator=g, device=dev).to(dt)
        o, lse = flash_forward(q, k, v, causal)
        o_ref, lse_ref = flash_forward_plain(q.float(), k.float(),
                                             v.float(), causal)
        torch.cuda.synchronize()
        tol = (1e-4, 0.0) if dt == torch.float32 else (2e-2, 2e-2)
        ok_o, err_o = close(o, o_ref, *tol)
        ok_l, err_l = close(lse, lse_ref, *tol)
        print(f"  flash b={b} sq={sq} sk={sk} d={D} causal={causal} "
              f"{str(dt)[6:]}: max|dO|={err_o:.3e} max|dlse|={err_l:.3e}",
              flush=True)
        check(ok_o and ok_l, f"flash kernel disagrees with its plain "
              f"version (b={b} sq={sq} sk={sk} d={D} causal={causal} {dt})")
        if dt == torch.float32:
            worst_fp32 = max(worst_fp32, err_o, err_l)
        else:
            worst = max(worst, err_o, err_l)
    n = {key: c - before[key] for key, c in counters().items()}
    n_fp32 = len(cases) - n_bf16
    check(n["fwd_sm90"] == n_bf16 and n["fwd_tf32x3"] == n_fp32,
          f"flash forward routes: want {n_bf16} bf16 launches on the wgmma "
          f"kernel and {n_fp32} fp32 on the 3xTF32 one, got {n}")

    # timing at the dense engine's largest prefill: 8 prompts in the
    # 512 bucket, causal; bf16 (the wgmma kernel, the row below) and fp32
    # (the 3xTF32 kernel of the fp32 engines, phase 2)
    D = 128
    b, s = 8, 512
    sdpa = torch.nn.functional.scaled_dot_product_attention
    pairs = s * (s + 1) // 2                        # visible (q, k) pairs
    flops = 4.0 * b * H * pairs * D
    timed = {}
    for dt in (torch.float32, torch.bfloat16):
        q = torch.randn(b, s, H, D, generator=g, device=dev).to(dt)
        k = torch.randn(b, s, KVH, D, generator=g, device=dev).to(dt)
        v = torch.randn(b, s, KVH, D, generator=g, device=dev).to(dt)
        ms = time_ms(lambda: flash_forward(q, k, v, True))
        plain_ms = time_ms(lambda: flash_forward_plain(q, k, v, True),
                           iters=5)
        qt = q.transpose(1, 2).contiguous()
        kt = k.repeat_interleave(H // KVH, dim=2).transpose(1, 2).contiguous()
        vt = v.repeat_interleave(H // KVH, dim=2).transpose(1, 2).contiguous()
        lib_ms = time_ms(lambda: sdpa(qt, kt, vt, is_causal=True))
        size = q.element_size()
        nbytes = ((2 * b * s * H * D + 2 * b * s * KVH * D) * size
                  + b * H * s * 4)
        if dt == torch.float32:
            simt, bnd, by = fp32_bounds(nbytes, flops)
            what = (f"SIMT bound {simt:.4f} ms, 3xTF32 floor {bnd:.4f} ms "
                    f"({by})")
        else:
            bnd, by = bound_ms(nbytes, flops, dt)
            what = f"bound {bnd:.4f} ms ({by})"
        print(f"  flash timing b={b} s={s} causal {str(dt)[6:]}: kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, "
              f"{what}", flush=True)
        timed[dt] = (ms, plain_ms, lib_ms, bnd, by)
    fp32_row = dict(zip(("ms", "plain_ms", "library_ms", "bound_ms",
                         "bound_by"), timed[torch.float32]))
    fp32_row.update(name="flash_attention_fwd_tf32x3_d128", route="cuda",
                    source="ray_tpu_torch/csrc/flash_fwd_tf32x3.cu",
                    replaces="ray_tpu/ops/attention.py:78",
                    max_abs_err=worst_fp32)
    ms, plain_ms, lib_ms, bnd, by = timed[torch.bfloat16]
    dt = torch.bfloat16
    # and at the training shape, checked and timed; the table's row keeps
    # the serving shape's time
    b, s = 4, 2048
    q = torch.randn(b, s, H, D, generator=g, device=dev).to(dt)
    k = torch.randn(b, s, KVH, D, generator=g, device=dev).to(dt)
    v = torch.randn(b, s, KVH, D, generator=g, device=dev).to(dt)
    o, lse = flash_forward(q, k, v, True)
    o_ref, lse_ref = flash_forward_plain(q.float(), k.float(), v.float(),
                                         True)
    torch.cuda.synchronize()
    ok_o, err_o = close(o, o_ref, 2e-2, 2e-2)
    ok_l, err_l = close(lse, lse_ref, 2e-2, 2e-2)
    print(f"  flash b={b} sq={s} sk={s} causal=True bfloat16: "
          f"max|dO|={err_o:.3e} max|dlse|={err_l:.3e}", flush=True)
    check(ok_o and ok_l, f"flash kernel disagrees with its plain version "
          f"at the training shape (b={b} s={s} bf16)")
    worst = max(worst, err_o, err_l)
    del o, lse, o_ref, lse_ref
    t_ms = time_ms(lambda: flash_forward(q, k, v, True), iters=10)
    t_plain = time_ms(lambda: flash_forward_plain(q, k, v, True), iters=3)
    qt = q.transpose(1, 2).contiguous()
    kt = k.repeat_interleave(H // KVH, dim=2).transpose(1, 2).contiguous()
    vt = v.repeat_interleave(H // KVH, dim=2).transpose(1, 2).contiguous()
    t_lib = time_ms(lambda: sdpa(qt, kt, vt, is_causal=True), iters=10)
    pairs = s * (s + 1) // 2
    t_bnd, t_by = bound_ms(
        (2 * b * s * H * D + 2 * b * s * KVH * D) * 2 + b * H * s * 4,
        4.0 * b * H * pairs * D, dt)
    print(f"  flash timing b={b} s={s} causal bf16 (training shape): kernel "
          f"{t_ms:.4f} ms, plain {t_plain:.4f} ms, sdpa {t_lib:.4f} ms, "
          f"bound {t_bnd:.4f} ms ({t_by})", flush=True)
    return [{"name": "flash_attention_fwd", "route": "cuda",
             "source": "ray_tpu_torch/csrc/flash_fwd_sm90.cu",
             "replaces": "ray_tpu/ops/attention.py:78",
             "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
             "bound_ms": bnd, "bound_by": by, "library_ms": lib_ms},
            fp32_row]


def flash_bwd_phase(dev) -> list:
    from ray_tpu_torch.ops.attention import (flash_backward,
                                             flash_backward_plain,
                                             flash_forward_plain)

    H, KVH = 32, 8
    g = torch.Generator(device=dev).manual_seed(4)

    def inputs(b, sq, sk, D, causal, dt):
        q = torch.randn(b, sq, H, D, generator=g, device=dev).to(dt)
        k = torch.randn(b, sk, KVH, D, generator=g, device=dev).to(dt)
        v = torch.randn(b, sk, KVH, D, generator=g, device=dev).to(dt)
        do = torch.randn(b, sq, H, D, generator=g, device=dev).to(dt)
        o, lse = flash_forward_plain(q.float(), k.float(), v.float(), causal)
        return q, k, v, o.to(dt).contiguous(), lse, do

    dts = (torch.float32, torch.bfloat16)
    worst = {(k, dt): 0.0 for k in ("dq", "dkv") for dt in dts}
    cases = [(b, s, s, 128, c, dt) for dt in dts
             for b in (1, 4) for s in (128, 512, 2048) for c in (True, False)]
    cases += [(4, 128, 512, 128, True, dt) for dt in dts]
    cases += _ragged_cases(dts)
    # 4096 keys: 1,536 truncating adds into one dQ accumulator at G 4
    # without its restart every 512 keys
    cases += [(1, 4096, 4096, 128, True, torch.float32)]
    n_bf16 = sum(dt == torch.bfloat16 for *_, dt in cases)
    before = counters()
    for b, sq, sk, D, causal, dt in cases:
        q, k, v, o, lse, do = inputs(b, sq, sk, D, causal, dt)
        got = flash_backward(q, k, v, o, lse, do, causal)
        want = flash_backward_plain(q.float(), k.float(), v.float(),
                                    o.float(), lse, do.float(), causal)
        torch.cuda.synchronize()
        tol = (1e-4, 1e-4) if dt == torch.float32 else (2e-2, 2e-2)
        res = [close(a, w, *tol) for a, w in zip(got, want)]
        print(f"  flash bwd b={b} sq={sq} sk={sk} d={D} causal={causal} "
              f"{str(dt)[6:]}: max|ddq|={res[0][1]:.3e} "
              f"max|ddk|={res[1][1]:.3e} max|ddv|={res[2][1]:.3e} "
              f"(max|dq| {float(want[0].abs().max()):.3e})",
              flush=True)
        check(all(ok for ok, _ in res), f"flash backward kernels disagree "
              f"with their plain version (b={b} sq={sq} sk={sk} d={D} "
              f"causal={causal} {dt})")
        worst["dq", dt] = max(worst["dq", dt], res[0][1])
        worst["dkv", dt] = max(worst["dkv", dt], res[1][1], res[2][1])
        del q, k, v, o, lse, do, got, want
    n = {key: c - before[key] for key, c in counters().items()}
    n_fp32 = len(cases) - n_bf16
    check(n["dq_sm90"] == n["dkv_sm90"] == n_bf16
          and n["dq_tf32x3"] == n["dkv_tf32x3"] == n_fp32
          and n["dq"] == n["dkv"] == len(cases),
          f"flash backward routes: want {n_bf16} bf16 dQ and dK/dV launches "
          f"on the wgmma kernels and {n_fp32} fp32 dQ and dK/dV on the "
          f"3xTF32 ones, got {n}")

    # timing at the training shape: b 4, s 2048, causal; bf16 (the wgmma
    # kernels) and fp32 (the fp32 gradients' kernels, phase 4: the 3xTF32
    # dQ and dK/dV)
    b, s, D = 4, 2048, 128
    G = H // KVH
    pairs = s * (s + 1) // 2                        # visible (q, k) pairs
    rows = []
    for dt in (torch.bfloat16, torch.float32):
        fp32 = dt == torch.float32
        q, k, v, o, lse, do = inputs(b, s, s, D, True, dt)
        keys = (("flash_bwd_dq_tf32x3_kernel", "flash_bwd_dkv_tf32x3_kernel")
                if fp32 else
                ("flash_bwd_dq_sm90_kernel", "flash_bwd_dkv_sm90_kernel"))
        ks = kernel_ms(lambda: flash_backward(q, k, v, o, lse, do, True),
                       keys)
        plain_ms = time_ms(lambda: flash_backward_plain(q, k, v, o, lse, do,
                                                        True), iters=3)
        qt = q.transpose(1, 2).detach().requires_grad_()
        kt = k.repeat_interleave(G, dim=2).transpose(1, 2).detach()
        vt = v.repeat_interleave(G, dim=2).transpose(1, 2).detach()
        kt.requires_grad_()
        vt.requires_grad_()
        out = torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True)
        dot = do.transpose(1, 2)
        lib_ms = time_ms(lambda: torch.autograd.grad(
            out, (qt, kt, vt), dot, retain_graph=True), iters=10)
        del out
        size = q.element_size()
        ins = ((2 * b * s * H * D + 2 * b * s * KVH * D) * size
               + 2 * b * H * s * 4)
        names = (("flash_attention_bwd_dq_tf32x3_d128",
                  "flash_bwd_dq_tf32x3.cu"),
                 ("flash_attention_bwd_dkv_tf32x3_d128",
                  "flash_bwd_dkv_tf32x3.cu")) if fp32 else (
                 ("flash_attention_bwd_dq", "flash_bwd_dq_sm90.cu"),
                 ("flash_attention_bwd_dkv", "flash_bwd_dkv_sm90.cu"))
        for kind, key, flops, outs, src_line, (name, src) in (
                ("dq", keys[0], 6.0 * b * H * pairs * D, b * s * H * D * size,
                 207, names[0]),
                ("dkv", keys[1], 8.0 * b * H * pairs * D,
                 2 * b * s * KVH * D * size, 253, names[1])):
            bnd, by = bound_ms(ins + outs, flops, dt)
            what = f"bound {bnd:.4f} ms ({by})"
            if fp32:
                simt, bnd, by = fp32_bounds(ins + outs, flops)
                what = (f"SIMT bound {simt:.4f} ms, 3xTF32 floor {bnd:.4f} "
                        f"ms ({by})")
            print(f"  {name} timing b={b} s={s} causal {str(dt)[6:]}: "
                  f"kernel {ks[key]:.4f} ms, {what}; plain dq+dk+dv "
                  f"{plain_ms:.4f} ms, sdpa backward dq+dk+dv {lib_ms:.4f} ms",
                  flush=True)
            rows.append({"name": name, "route": "cuda",
                         "source": f"ray_tpu_torch/csrc/{src}",
                         "replaces": f"ray_tpu/ops/attention.py:{src_line}",
                         "max_abs_err": worst[kind, dt], "ms": ks[key],
                         "plain_ms": plain_ms, "bound_ms": bnd,
                         "bound_by": by, "library_ms": lib_ms})
        if fp32:
            pair = rows[-2]["ms"] + rows[-1]["ms"]
            print(f"  fp32 dQ + dK/dV pair b={b} s={s}: {pair:.4f} ms, "
                  f"sdpa fp32 backward {lib_ms:.4f} ms ({pair / lib_ms:.3f}x)",
                  flush=True)
        else:
            # both kernels recompute S and dP: one fused backward would do
            # 10*d FLOPs a visible pair and query head, not the pair's 6*d
            # + 8*d
            fused, fused_by = bound_ms(
                ins + b * s * H * D * size + 2 * b * s * KVH * D * size,
                10.0 * b * H * pairs * D, dt)
            split = rows[0]["bound_ms"] + rows[1]["bound_ms"]
            pair = rows[0]["ms"] + rows[1]["ms"]
            print(f"  flash backward floor b={b} s={s}: {fused:.4f} ms "
                  f"({fused_by}) for one fused kernel, {split:.4f} ms for "
                  f"the dQ and dK/dV pair; the pair measured {pair:.4f} ms",
                  flush=True)
        del q, k, v, o, lse, do, qt, kt, vt
    return rows


def _paged_inputs(dev, dt, g, ctx, KVH=8, G=4, hd=128, page=64, maxp=16):
    S = len(ctx)
    P = S * maxp + 8
    q = torch.randn(S, KVH, G, hd, generator=g, device=dev).to(dt)
    kp = torch.randn(P, KVH, page, hd, generator=g, device=dev).to(dt)
    vp = torch.randn(P, KVH, page, hd, generator=g, device=dev).to(dt)
    ids = torch.randperm(P, generator=torch.Generator().manual_seed(2))
    bt = torch.full((S, maxp), 2 ** 30, dtype=torch.int32)  # never read
    used = 0
    for s, c in enumerate(ctx):
        n = -(-c // page)
        bt[s, :n] = ids[used:used + n].to(torch.int32)
        used += n
    bt_plain = torch.where(bt == 2 ** 30, 0, bt)   # the plain gather
    ctx_t = torch.tensor(ctx, dtype=torch.int32)
    return (q, kp, vp, bt.to(dev), bt_plain.to(dev), ctx_t.to(dev))


def _paged_check(what, got, want, ctx, tol) -> float:
    """Holds the kernel's (acc, m, l) to the plain version's: each of the
    three, the normalised output of live slots, and the exact ctx-0
    triple. Returns max |d out|."""
    acc, m, l = got
    ra, rm, rl = want
    oks = [close(acc, ra, *tol), close(m, rm, *tol), close(l, rl, *tol)]
    live = ctx > 0
    ok_n, err = close(acc[live] / l[live][..., None],
                      ra[live] / rl[live][..., None], *tol)
    empty_ok = (bool((acc[~live] == 0).all()) and
                bool((l[~live] == 0).all()) and
                bool((m[~live] == -1e30).all()))
    print(f"  paged {what}: max|d out|={err:.3e} max|d acc,m,l|="
          f"{max(e for _, e in oks):.3e} ctx0 exact={empty_ok}", flush=True)
    check(all(o for o, _ in oks) and ok_n and empty_ok,
          f"paged kernel disagrees with its plain version ({what})")
    return err


def paged_phase(dev, ctx_main) -> dict:
    from ray_tpu_torch.ops.paged_attention import (paged_attention,
                                                   paged_attention_reference,
                                                   split_pages)

    g = torch.Generator(device=dev).manual_seed(3)
    worst = 0.0
    ctx_check = [0, 1, 63, 64, 65, 300, 517, 1024]   # 1024 = full MAXP
    for dt in (torch.float32, torch.bfloat16):
        tol = (1e-4, 1e-5) if dt == torch.float32 else (2e-2, 2e-2)
        name = str(dt)[6:]
        q, kp, vp, bt, bt_plain, ctx = _paged_inputs(dev, dt, g, ctx_check)
        got = paged_attention(q, kp, vp, bt, ctx)
        want = paged_attention_reference(q.float(), kp.float(), vp.float(),
                                         bt_plain, ctx)
        torch.cuda.synchronize()
        worst = max(worst, _paged_check(f"ctx={ctx_check} {name}", got,
                                        want, ctx, tol))
        # two calls on the same inputs agree bit for bit: the splits merge
        # in order, with no float atomics
        again = paged_attention(q, kp, vp, bt, ctx)
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        print(f"  paged {name}: two calls bit-identical: {same}", flush=True)
        check(same, f"two paged calls on the same inputs differ ({dt})")
        # ids outside the pool below ctx are read as clamp_page_ids reads
        # them (negative from the end, the rest clamped), by both versions
        P = kp.shape[0]
        bad = bt.clone()
        bad[1, 0], bad[5, 1], bad[6, 2], bad[7, 15] = -1, P + 7, -P - 5, 2 ** 30
        got = paged_attention(q, kp, vp, bad, ctx)
        want = paged_attention_reference(q.float(), kp.float(), vp.float(),
                                         bad, ctx)
        torch.cuda.synchronize()
        worst = max(worst, _paged_check(f"out-of-pool ids below ctx {name}",
                                        got, want, ctx, tol))
        # a 64-page table: contexts on the split boundaries of the grid
        maxp, page = 64, 64
        pps, n_split = split_pages(5, 8, maxp)
        run = pps * page                       # tokens of one split
        ctx_split = [1, run - 1, run, run + 1, maxp * page]
        q, kp, vp, bt, bt_plain, ctx = _paged_inputs(dev, dt, g, ctx_split,
                                                     maxp=maxp)
        got = paged_attention(q, kp, vp, bt, ctx)
        want = paged_attention_reference(q.float(), kp.float(), vp.float(),
                                         bt_plain, ctx)
        torch.cuda.synchronize()
        worst = max(worst, _paged_check(
            f"MAXP {maxp}, {pps} pages x {n_split} splits, ctx={ctx_split} "
            f"{name}", got, want, ctx, tol))
        del q, kp, vp, got, want, again
        # the other instances the kernel is built for: G 1, 2 and 8, hd 64
        for kvh, grp, hd in ((2, 1, 128), (8, 2, 64), (4, 8, 128)):
            q, kp, vp, bt, bt_plain, ctx = _paged_inputs(
                dev, dt, g, ctx_check, KVH=kvh, G=grp, hd=hd)
            got = paged_attention(q, kp, vp, bt, ctx)
            want = paged_attention_reference(q.float(), kp.float(),
                                             vp.float(), bt_plain, ctx)
            torch.cuda.synchronize()
            worst = max(worst, _paged_check(
                f"KVH {kvh} G {grp} hd {hd} {name}", got, want, ctx, tol))

    ms, plain_ms, bnd, by = _paged_timing(dev, torch.bfloat16, g, ctx_main)
    return {"name": "paged_attention", "route": "cuda",
            "source": "ray_tpu_torch/csrc/paged_attention.cu",
            "replaces": "ray_tpu/ops/paged_attention.py:83",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bnd, "bound_by": by, "library_ms": None}


def _paged_timing(dev, dt, g, ctx_main, KVH=8, G=4, hd=128, what=""):
    """The wrapper's two launches (split and merge) together at the paged
    engine's decode shape: (ms, plain ms, bound ms, bound by)."""
    from ray_tpu_torch.ops.paged_attention import (paged_attention,
                                                   paged_attention_reference,
                                                   split_pages)

    q, kp, vp, bt, bt_plain, ctx = _paged_inputs(dev, dt, g, ctx_main,
                                                 KVH=KVH, G=G, hd=hd)
    ms = time_ms(lambda: paged_attention(q, kp, vp, bt, ctx), iters=50)
    plain_ms = time_ms(lambda: paged_attention_reference(
        q, kp, vp, bt_plain, ctx), iters=20)
    S = q.shape[0]
    page = kp.shape[2]
    size = q.element_size()
    tok = sum(ctx_main)
    pages = sum(-(-c // page) for c in ctx_main)
    nbytes = (q.numel() * size + 2 * tok * KVH * hd * size + pages * 4
              + S * 4 + S * KVH * G * (hd + 2) * 4)
    flops = 4.0 * tok * KVH * G * hd
    bnd, by = bound_ms(nbytes, flops, dt)
    pps, n_split = split_pages(S, KVH, bt.shape[1])
    print(f"  paged timing {what}S={S} KVH={KVH} G={G} hd={hd} "
          f"ctx={ctx_main} {str(dt)[6:]} ({pps} page(s) x {n_split} "
          f"splits): split + merge {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"bound {bnd:.4f} ms ({by})", flush=True)
    return ms, plain_ms, bnd, by


# (model, kv heads, query rows per kv head, head dim) of the published
# configurations the paged kernel's new instances serve
PAGED_FAMILIES = (("Qwen2-7B", 4, 7, 128), ("Qwen2-0.5B", 2, 7, 64),
                  ("Gemma-7B", 16, 1, 256), ("Gemma-2B", 1, 8, 256))


def paged_families_phase(dev, ctx_main) -> list:
    """The paged kernel at the GQA groups and head dims of Qwen2 and
    Gemma, fp32 and bf16: the old contexts (ctx 0 among them) and a
    64-page table, each against the plain version; then timed at the
    decode shape in both dtypes. Rows for the Qwen2-7B (G 7 under the
    row maximum 8) and Gemma-7B (hd 256) instances, which the served
    models launch; the errors of Qwen2-0.5B's (G 7, hd 64) and Gemma-2B's
    (G 8, hd 256) instances join those rows."""
    from ray_tpu_torch.ops.paged_attention import (paged_attention,
                                                   paged_attention_reference,
                                                   split_pages)

    g = torch.Generator(device=dev).manual_seed(5)
    ctx_check = [0, 1, 63, 64, 65, 300, 517, 1024]
    rows = {}
    for model, kvh, grp, hd in PAGED_FAMILIES:
        worst = 0.0
        for dt in (torch.float32, torch.bfloat16):
            tol = (1e-4, 1e-5) if dt == torch.float32 else (2e-2, 2e-2)
            name = f"{model} KVH {kvh} G {grp} hd {hd} {str(dt)[6:]}"
            maxp = 64
            pps, n_split = split_pages(5, kvh, maxp)
            run = pps * 64
            for ctxs, mp in ((ctx_check, 16),
                             ([1, run - 1, run, run + 1, maxp * 64], maxp)):
                q, kp, vp, bt, bt_plain, ctx = _paged_inputs(
                    dev, dt, g, ctxs, KVH=kvh, G=grp, hd=hd, maxp=mp)
                got = paged_attention(q, kp, vp, bt, ctx)
                want = paged_attention_reference(q.float(), kp.float(),
                                                 vp.float(), bt_plain, ctx)
                torch.cuda.synchronize()
                worst = max(worst, _paged_check(
                    f"{name} MAXP {mp} ctx={ctxs}", got, want, ctx, tol))
                del q, kp, vp, got, want
        times = {dt: _paged_timing(dev, dt, g, ctx_main, KVH=kvh, G=grp,
                                   hd=hd, what=f"{model} ")
                 for dt in (torch.float32, torch.bfloat16)}
        rows[model] = (worst, times[torch.bfloat16])
    out = []
    for model, key, also in (("Qwen2-7B", "gm8_hd128", "Qwen2-0.5B"),
                             ("Gemma-7B", "gm1_hd256", "Gemma-2B")):
        worst, (ms, plain_ms, bnd, by) = rows[model]
        worst = max(worst, rows[also][0])
        out.append({"name": f"paged_attention_{key}", "route": "cuda",
                    "source": "ray_tpu_torch/csrc/paged_attention.cu",
                    "replaces": "ray_tpu/ops/paged_attention.py:83",
                    "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bnd, "bound_by": by, "library_ms": None})
    return out


def flash_d256_phase(dev) -> list:
    """The flash forward, dQ and dK/dV at head dim 256 (Gemma's), fp32 and
    bf16, 16/16 heads, each against its plain version, with masks on
    ragged lengths and sq < sk: every bf16 launch on the wgmma route,
    every fp32 launch on the 3xTF32 route. Timed at the Gemma serving
    prefill (b 8 x s 512)
    and, for the backward, at b 2 x s 2048, beside
    scaled_dot_product_attention and its backward."""
    from ray_tpu_torch.ops.attention import (flash_backward,
                                             flash_backward_plain,
                                             flash_forward,
                                             flash_forward_plain)

    H = KVH = 16
    D = 256
    g = torch.Generator(device=dev).manual_seed(6)
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def inputs(b, sq, sk, dt):
        return [torch.randn(b, n, H, D, generator=g, device=dev).to(dt)
                for n in (sq, sk, sk, sq)]

    worst = {(k, dt): 0.0 for k in ("fwd", "dq", "dkv")
             for dt in (torch.float32, torch.bfloat16)}
    dts = (torch.float32, torch.bfloat16)
    before = counters()
    n_calls = {dt: 0 for dt in dts}
    for b, sq, sk, causal in ((8, 512, 512, True), (1, 100, 100, True),
                              (2, 128, 300, True), (1, 512, 512, False),
                              (2, 2048, 2048, True)):
        for dt in dts:
            q, k, v, do = inputs(b, sq, sk, dt)
            o, lse = flash_forward(q, k, v, causal)
            o_ref, lse_ref = flash_forward_plain(q.float(), k.float(),
                                                 v.float(), causal)
            got = flash_backward(q, k, v, o, lse, do, causal)
            want = flash_backward_plain(q.float(), k.float(), v.float(),
                                        o.float(), lse, do.float(), causal)
            torch.cuda.synchronize()
            n_calls[dt] += 1
            fp32 = dt == torch.float32
            tol_f = (1e-4, 0.0) if fp32 else (2e-2, 2e-2)
            tol_b = (1e-4, 1e-4) if fp32 else (2e-2, 2e-2)
            res = [close(o, o_ref, *tol_f), close(lse, lse_ref, *tol_f)]
            res += [close(a, w, *tol_b) for a, w in zip(got, want)]
            print(f"  flash d=256 b={b} sq={sq} sk={sk} causal={causal} "
                  f"{str(dt)[6:]}: max|dO|={res[0][1]:.3e} "
                  f"max|dlse|={res[1][1]:.3e} max|ddq|={res[2][1]:.3e} "
                  f"max|ddk|={res[3][1]:.3e} max|ddv|={res[4][1]:.3e}",
                  flush=True)
            check(all(ok for ok, _ in res), f"d-256 flash kernels disagree "
                  f"with their plain versions (b={b} sq={sq} sk={sk} "
                  f"causal={causal} {dt})")
            worst["fwd", dt] = max(worst["fwd", dt], res[0][1], res[1][1])
            worst["dq", dt] = max(worst["dq", dt], res[2][1])
            worst["dkv", dt] = max(worst["dkv", dt], res[3][1], res[4][1])
            del q, k, v, do, o, lse, o_ref, lse_ref, got, want
    n = {key: c - before[key] for key, c in counters().items()}
    n_bf16 = n_calls[torch.bfloat16]
    total = sum(n_calls.values())
    n_fp32 = total - n_bf16
    print(f"  d=256 launches: forward {n['fwd']} (wgmma {n['fwd_sm90']}, "
          f"3xTF32 {n['fwd_tf32x3']}), dQ {n['dq']} (wgmma {n['dq_sm90']}, "
          f"3xTF32 {n['dq_tf32x3']}), dK/dV {n['dkv']} (wgmma "
          f"{n['dkv_sm90']}, 3xTF32 {n['dkv_tf32x3']})", flush=True)
    check(n["fwd"] == n["dq"] == n["dkv"] == total
          and n["fwd_sm90"] == n["dq_sm90"] == n["dkv_sm90"] == n_bf16
          and n["fwd_tf32x3"] == n["dq_tf32x3"] == n["dkv_tf32x3"] == n_fp32,
          f"d-256 routes: want the {n_bf16} bf16 launches of each kernel "
          f"on wgmma and every fp32 launch on 3xTF32, got {n}")

    rows = {}
    # the forward at the Gemma serving prefill: 8 prompts of 512, causal
    b, s = 8, 512
    for dt in dts:
        q, k, v, _ = inputs(b, s, s, dt)
        ms = time_ms(lambda: flash_forward(q, k, v, True), iters=10)
        plain_ms = time_ms(lambda: flash_forward_plain(q, k, v, True),
                           iters=3)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        lib_ms = time_ms(lambda: sdpa(qt, kt, vt, is_causal=True), iters=10)
        size = q.element_size()
        fp32 = dt == torch.float32
        nbytes = 4 * b * s * H * D * size + b * H * s * 4
        flops = 4.0 * b * H * (s * (s + 1) // 2) * D
        if fp32:
            simt, bnd, by = fp32_bounds(nbytes, flops)
            what = (f"SIMT bound {simt:.4f} ms, 3xTF32 floor {bnd:.4f} ms "
                    f"({by})")
        else:
            bnd, by = bound_ms(nbytes, flops, dt)
            what = f"bound {bnd:.4f} ms ({by})"
        print(f"  flash d=256 timing b={b} s={s} causal {str(dt)[6:]}: "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa "
              f"{lib_ms:.4f} ms, {what}", flush=True)
        name, src = (("flash_attention_fwd_tf32x3_d256",
                      "flash_fwd_tf32x3.cu") if fp32
                     else ("flash_attention_fwd_sm90_d256",
                           "flash_fwd_sm90_d256.cu"))
        rows[name] = {"name": name, "route": "cuda",
                      "source": f"ray_tpu_torch/csrc/{src}",
                      "replaces": "ray_tpu/ops/attention.py:78",
                      "max_abs_err": worst["fwd", dt], "ms": ms,
                      "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by,
                      "library_ms": lib_ms}
        del q, k, v, qt, kt, vt
    # the backward at b 2 x s 2048, causal: bf16 runs the two wgmma
    # kernels, fp32 the two 3xTF32 ones
    b, s = 2, 2048
    pairs = s * (s + 1) // 2
    for dt in dts:
        fp32 = dt == torch.float32
        q, k, v, do = inputs(b, s, s, dt)
        o, lse = flash_forward_plain(q.float(), k.float(), v.float(), True)
        o = o.to(dt).contiguous()
        dq_kernel, dkv_kernel = (
            ("flash_bwd_dq_tf32x3_kernel", "flash_bwd_dkv_tf32x3_kernel")
            if fp32 else
            ("flash_bwd_dq_sm90_d256_kernel",
             "flash_bwd_dkv_sm90_d256_kernel"))
        ks = kernel_ms(lambda: flash_backward(q, k, v, o, lse, do, True),
                       (dq_kernel, dkv_kernel))
        plain_ms = time_ms(lambda: flash_backward_plain(q, k, v, o, lse, do,
                                                        True), iters=3)
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v))
        out = sdpa(qt, kt, vt, is_causal=True)
        dot = do.transpose(1, 2)
        lib_ms = time_ms(lambda: torch.autograd.grad(
            out, (qt, kt, vt), dot, retain_graph=True), iters=10)
        del out
        size = q.element_size()
        ins = 4 * b * s * H * D * size + 2 * b * H * s * 4
        (dq_name, dq_src), (dkv_name, dkv_src) = (
            (("flash_attention_bwd_dq_tf32x3_d256",
              "flash_bwd_dq_tf32x3.cu"),
             ("flash_attention_bwd_dkv_tf32x3_d256",
              "flash_bwd_dkv_tf32x3.cu")) if fp32 else
            (("flash_attention_bwd_dq_sm90_d256",
              "flash_bwd_dq_sm90_d256.cu"),
             ("flash_attention_bwd_dkv_sm90_d256",
              "flash_bwd_dkv_sm90_d256.cu")))
        for name, key, flops, outs, line, src, kind in (
                (dq_name, dq_kernel, 6.0 * b * H * pairs * D,
                 b * s * H * D * size, 207, dq_src, "dq"),
                (dkv_name, dkv_kernel, 8.0 * b * H * pairs * D,
                 2 * b * s * KVH * D * size, 253, dkv_src, "dkv")):
            bnd, by = bound_ms(ins + outs, flops, dt)
            what = f"bound {bnd:.4f} ms ({by})"
            if fp32:
                simt, bnd, by = fp32_bounds(ins + outs, flops)
                what = (f"SIMT bound {simt:.4f} ms, 3xTF32 floor {bnd:.4f} "
                        f"ms ({by})")
            print(f"  {name} d=256 timing b={b} s={s} causal "
                  f"{str(dt)[6:]}: kernel {ks[key]:.4f} ms, {what}; plain "
                  f"dq+dk+dv {plain_ms:.4f} ms, sdpa backward dq+dk+dv "
                  f"{lib_ms:.4f} ms", flush=True)
            rows[name] = {"name": name, "route": "cuda",
                          "source": f"ray_tpu_torch/csrc/{src}",
                          "replaces": f"ray_tpu/ops/attention.py:{line}",
                          "max_abs_err": worst[kind, dt], "ms": ks[key],
                          "plain_ms": plain_ms, "bound_ms": bnd,
                          "bound_by": by, "library_ms": lib_ms}
        if fp32:
            pair = rows[dq_name]["ms"] + rows[dkv_name]["ms"]
            print(f"  fp32 dQ + dK/dV pair d=256 b={b} s={s}: {pair:.4f} ms, "
                  f"sdpa fp32 backward {lib_ms:.4f} ms ({pair / lib_ms:.3f}x)",
                  flush=True)
        else:
            # the d-256 dK/dV kernel computes S^T and dP^T in both consumer
            # warpgroups: 12*d FLOPs a visible pair, not the function's 8*d
            own, _ = bound_ms(ins + 2 * b * s * KVH * D * size,
                              12.0 * b * H * pairs * D, dt)
            print(f"  flash_attention_bwd_dkv_sm90_d256: its own bound "
                  f"(12*d FLOPs a visible pair) {own:.4f} ms", flush=True)
        del q, k, v, do, o, lse, qt, kt, vt
    return list(rows.values())


def flash_small_d_phase(dev) -> None:
    """The tiny presets' head dims 16 and 32, fp32 and bf16, 4/2 heads:
    the flash forward, dQ and dK/dV (bf16 on the scalar route, fp32 on the
    3xTF32 route) causal, non-causal, ragged
    and sq < sk, and the paged kernel under each row maximum (G 1, 2, 4
    and 8) on the old contexts, each against its plain version."""
    from ray_tpu_torch.ops.attention import (flash_backward,
                                             flash_backward_plain,
                                             flash_forward,
                                             flash_forward_plain)
    from ray_tpu_torch.ops.paged_attention import (paged_attention,
                                                   paged_attention_reference)

    H, KVH = 4, 2
    g = torch.Generator(device=dev).manual_seed(8)
    before = counters()
    n_calls = 0
    for D in (16, 32):
        for dt in (torch.float32, torch.bfloat16):
            fp32 = dt == torch.float32
            for b, sq, sk, causal in ((2, 128, 128, True),
                                      (2, 128, 128, False),
                                      (1, 100, 100, True),
                                      (2, 128, 300, True)):
                q, do = (torch.randn(b, sq, H, D, generator=g, device=dev)
                         .to(dt) for _ in range(2))
                k, v = (torch.randn(b, sk, KVH, D, generator=g, device=dev)
                        .to(dt) for _ in range(2))
                o, lse = flash_forward(q, k, v, causal)
                o_ref, lse_ref = flash_forward_plain(q.float(), k.float(),
                                                     v.float(), causal)
                got = flash_backward(q, k, v, o, lse, do, causal)
                want = flash_backward_plain(q.float(), k.float(), v.float(),
                                            o.float(), lse, do.float(),
                                            causal)
                torch.cuda.synchronize()
                n_calls += 1
                tol_f = (1e-4, 0.0) if fp32 else (2e-2, 2e-2)
                tol_b = (1e-4, 1e-4) if fp32 else (2e-2, 2e-2)
                res = [close(o, o_ref, *tol_f), close(lse, lse_ref, *tol_f)]
                res += [close(a, w, *tol_b) for a, w in zip(got, want)]
                print(f"  flash d={D} b={b} sq={sq} sk={sk} causal={causal}"
                      f" {str(dt)[6:]}: max err O, lse, dq, dk, dv "
                      f"{', '.join(f'{e:.3e}' for _, e in res)}", flush=True)
                check(all(ok for ok, _ in res), f"d-{D} flash kernels "
                      f"disagree with their plain versions (b={b} sq={sq} "
                      f"sk={sk} causal={causal} {dt})")
            ctx_check = [0, 1, 63, 64, 65, 300, 517, 1024]
            tol = (1e-4, 1e-5) if fp32 else (2e-2, 2e-2)
            for grp in (1, 2, 4, 8):
                q, kp, vp, bt, bt_plain, ctx = _paged_inputs(
                    dev, dt, g, ctx_check, KVH=2, G=grp, hd=D)
                got = paged_attention(q, kp, vp, bt, ctx)
                want = paged_attention_reference(q.float(), kp.float(),
                                                 vp.float(), bt_plain, ctx)
                torch.cuda.synchronize()
                _paged_check(f"KVH 2 G {grp} hd {D} {str(dt)[6:]}", got,
                             want, ctx, tol)
    n = {key: c - before[key] for key, c in counters().items()}
    check(n["fwd"] == n["dq"] == n["dkv"] == n_calls
          and n["fwd_sm90"] == n["dq_sm90"] == n["dkv_sm90"] == 0
          and n["fwd_tf32x3"] == n["dq_tf32x3"] == n["dkv_tf32x3"]
          == n_calls // 2 and n["paged"] == n["paged_merge"] == 16,
          f"d-16/32 launches: want {n_calls} of each flash kernel, the "
          f"fp32 half on the 3xTF32 route, the rest scalar, and 16 paged "
          f"calls, got {n}")


def flash_tf32x3_phase(dev) -> None:
    """The 3xTF32 kernels (the fp32 forward, dQ and dK/dV) at every head
    dim they are built for (16, 32, 64, 128, 256) and GQA groups 1, 4, 7
    and 8 (2 kv heads), causal and not, at a length ragged to the
    kernels' tiles (sq = sk = 200): O and lse at atol 1e-4, dQ, dK and dV
    at atol/rtol 1e-4, each against its plain version."""
    from ray_tpu_torch.ops.attention import (flash_backward,
                                             flash_backward_plain,
                                             flash_forward,
                                             flash_forward_plain)

    KVH, s = 2, 200
    g = torch.Generator(device=dev).manual_seed(9)
    before = counters()
    n_calls, worst = 0, [0.0] * 5
    for D in (16, 32, 64, 128, 256):
        for grp in (1, 4, 7, 8):
            for causal in (True, False):
                H = KVH * grp
                q, do = (torch.randn(1, s, H, D, generator=g, device=dev)
                         for _ in range(2))
                k, v = (torch.randn(1, s, KVH, D, generator=g, device=dev)
                        for _ in range(2))
                o, lse = flash_forward(q, k, v, causal)
                o_ref, lse_ref = flash_forward_plain(q, k, v, causal)
                got = flash_backward(q, k, v, o, lse, do, causal)
                want = flash_backward_plain(q, k, v, o, lse, do, causal)
                torch.cuda.synchronize()
                n_calls += 1
                res = [close(o, o_ref, 1e-4, 0.0),
                       close(lse, lse_ref, 1e-4, 0.0)]
                res += [close(a, w, 1e-4, 1e-4) for a, w in zip(got, want)]
                worst = [max(w, e) for w, (_, e) in zip(worst, res)]
                check(all(ok for ok, _ in res), f"3xTF32 flash kernels "
                      f"disagree with their plain versions (d={D} G={grp} "
                      f"causal={causal}): max err O, lse, dq, dk, dv "
                      f"{', '.join(f'{e:.3e}' for _, e in res)}")
    n = {key: c - before[key] for key, c in counters().items()}
    print(f"  3xTF32 d 16-256 x G 1/4/7/8 x causal/not ({n_calls} calls): "
          f"worst err O, lse, dq, dk, dv "
          f"{', '.join(f'{e:.3e}' for e in worst)}", flush=True)
    check(n["fwd"] == n["fwd_tf32x3"] == n["dkv"] == n["dkv_tf32x3"]
          == n["dq"] == n["dq_tf32x3"] == n_calls,
          f"3xTF32 phase routes: want {n_calls} forward, dQ and dK/dV "
          f"launches on 3xTF32, got {n}")


# ------------------------------------------------------------ phases 2, 3


def drain(engine, reqs, timeout_s: float) -> dict:
    for rid, prompt in reqs:
        engine.submit(rid, prompt)
    out = {}
    deadline = time.monotonic() + timeout_s
    while len(out) < len(reqs) and time.monotonic() < deadline:
        check(engine._thread.is_alive(), "engine thread died")
        out.update(engine.collect())
        time.sleep(0.005)
    for rid, _ in reqs:
        check(rid in out, f"request {rid} timed out")
        check(not isinstance(out[rid], Exception),
              f"request {rid} failed: {out[rid]!r}")
    return out


def stop(engine) -> None:
    engine.shutdown()
    engine._thread.join(timeout=60)
    check(not engine._thread.is_alive(), "engine thread did not stop")


def counters_reset():
    from ray_tpu_torch.ops.attention import flash_backward, flash_forward
    from ray_tpu_torch.ops.paged_attention import paged_attention

    flash_forward.launches = flash_forward.sm90_launches = 0
    flash_forward.tf32x3_launches = 0
    paged_attention.launches = paged_attention.merge_launches = 0
    flash_backward.dq_launches = flash_backward.dq_sm90_launches = 0
    flash_backward.dq_tf32x3_launches = 0
    flash_backward.dkv_launches = flash_backward.dkv_sm90_launches = 0
    flash_backward.dkv_tf32x3_launches = 0


def counters() -> dict:
    """Kernel launches since the last reset: the flash forward (all
    routes, the bf16 wgmma route and the fp32 3xTF32 route), paged (split
    and merge passes), dQ and dK/dV (each: all routes, the wgmma route and
    the 3xTF32 route)."""
    from ray_tpu_torch.ops.attention import flash_backward, flash_forward
    from ray_tpu_torch.ops.paged_attention import paged_attention

    return {"fwd": flash_forward.launches,
            "fwd_sm90": flash_forward.sm90_launches,
            "fwd_tf32x3": flash_forward.tf32x3_launches,
            "paged": paged_attention.launches,
            "paged_merge": paged_attention.merge_launches,
            "dq": flash_backward.dq_launches,
            "dq_sm90": flash_backward.dq_sm90_launches,
            "dq_tf32x3": flash_backward.dq_tf32x3_launches,
            "dkv": flash_backward.dkv_launches,
            "dkv_sm90": flash_backward.dkv_sm90_launches,
            "dkv_tf32x3": flash_backward.dkv_tf32x3_launches}


def _model_config(cfg) -> dict:
    """An engine's ``model_config`` that rebuilds ``cfg`` field by field."""
    from dataclasses import fields

    return {"preset": "llama3_8b",
            **{f.name: getattr(cfg, f.name) for f in fields(cfg)}}


def fp32_phase(dev, cfg, name) -> int:
    """fp32, ``cfg`` at 2 layers: the dense and paged engines' greedy
    transcripts are identical and every token is the argmax of a
    cache-free forward through the reference attention. Returns the dense
    engine's flash forward launches."""
    from dataclasses import replace

    from ray_tpu_torch.models import llama
    from ray_tpu_torch.serve.llm_engine import LLMEngine
    from ray_tpu_torch.serve.paged_engine import PagedLLMEngine

    cfg = replace(cfg, num_layers=2, dtype=torch.float32,
                  param_dtype=torch.float32)
    mc = _model_config(cfg)
    params = llama.init_params(cfg, seed=0, device=dev)
    rng = np.random.default_rng(11)
    reqs = [(f"f{i}", [int(t) for t in rng.integers(1, cfg.vocab_size, n)])
            for i, n in enumerate((37, 64, 100, 128))]
    kw = dict(model_config=mc, num_slots=4, max_len=256,
              prefill_buckets=[128], max_new_tokens=16, chunk_steps=8,
              eos_id=-1, params=params, device=dev)
    counters_reset()
    dense = LLMEngine(**kw)
    got_d = {r: v["tokens"] for r, v in drain(dense, reqs, 120).items()}
    stop(dense)
    fl = counters()["fwd"]
    check(fl > 0, "fp32 dense engine never launched the flash kernel")
    check(counters()["fwd_tf32x3"] == fl,
          f"fp32 dense engine: {counters()['fwd_tf32x3']} of {fl} flash "
          f"forward launches on the 3xTF32 kernel")
    counters_reset()
    paged = PagedLLMEngine(page_size=64, **kw)
    got_p = {r: v["tokens"] for r, v in drain(paged, reqs, 120).items()}
    stop(paged)
    check(counters()["fwd_tf32x3"] == counters()["fwd"],
          f"fp32 paged engine: flash forward launches off the 3xTF32 "
          f"kernel: {counters()}")
    pa2 = counters()["paged"]
    check(pa2 > 0, "fp32 paged engine never launched the paged kernel")
    check(counters()["paged_merge"] == pa2,
          "fp32 paged engine: split and merge launches differ")
    print(f"  fp32 2-layer {name}: dense flash launches {fl}, paged "
          f"launches {pa2}; transcripts identical: {got_d == got_p}",
          flush=True)
    check(got_d == got_p, f"fp32 dense and paged transcripts differ:\n"
          f"{got_d}\n{got_p}")
    # teacher-forced check against the cache-free forward pass through
    # the reference attention (independent of the flash kernel the dense
    # engine ran): every generated token is its argmax (up to a 1e-3
    # near-tie)
    oracle = replace(cfg, attn_impl="reference")
    for rid, prompt in reqs:
        seq = prompt + got_d[rid]
        with torch.no_grad():
            logits = llama.forward(oracle, params,
                                   torch.tensor([seq], device=dev))
        lg = logits[0, len(prompt) - 1:len(seq) - 1]
        chosen = lg.gather(1, torch.tensor(got_d[rid], device=dev)[:, None])
        gap = float((lg.max(dim=1).values - chosen[:, 0]).max())
        check(torch.isfinite(logits).all().item(), "non-finite logits")
        check(gap <= 1e-3, f"{rid}: engine token is not the reference "
              f"argmax (logit gap {gap})")
    print(f"  fp32 2-layer {name}: transcripts agree with llama.forward",
          flush=True)
    return fl


# ------------------------------------------------------------ phases 4, 5


def grad_phase(dev, cfg, mod=None, seq: int = 256) -> dict:
    """fp32 gradients of ``cfg`` (2 layers, batch 2 x ``seq``) through the
    flash kernels against the reference attention's and against no
    remat; ``mod`` (default ``models.llama``) gives ``init_params`` and
    ``loss_fn``. Returns the launch counts of the flash run."""
    from dataclasses import replace

    from ray_tpu_torch.models import llama

    mod = mod or llama
    cfg = replace(cfg, num_layers=2, dtype=torch.float32,
                  param_dtype=torch.float32, attn_impl="flash", remat=True)
    params = mod.init_params(cfg, seed=0, device=dev)
    leaves = llama.param_leaves(params)
    for _, leaf in leaves:
        leaf.requires_grad_()
    toks = torch.from_numpy(np.random.default_rng(13).integers(
        0, cfg.vocab_size, (2, seq + 1))).to(dev)

    def loss_and_grads(c):
        for _, leaf in leaves:
            leaf.grad = None
        loss = mod.loss_fn(c, params, {"tokens": toks})
        loss.backward()
        torch.cuda.synchronize()
        return loss.item(), [leaf.grad for _, leaf in leaves]

    counters_reset()
    l_flash, g_flash = loss_and_grads(cfg)
    n = counters()
    check(n["dq"] == n["dkv"] == cfg.num_layers,
          f"flash gradients took {n['dq']} dQ and {n['dkv']} dK/dV "
          f"launches, want {cfg.num_layers} each")
    check(n["fwd_sm90"] == n["dq_sm90"] == n["dkv_sm90"] == 0
          and n["fwd_tf32x3"] == n["fwd"] and n["dq_tf32x3"] == n["dq"]
          and n["dkv_tf32x3"] == n["dkv"],
          f"fp32 gradients: want every forward, dQ and dK/dV launch on the "
          f"3xTF32 kernels, got {n}")
    runs = {"reference attention": replace(cfg, attn_impl="reference"),
            "no remat": replace(cfg, remat=False)}
    for what, c in runs.items():
        l_other, g_other = loss_and_grads(c)
        worst = 0.0
        for (name, _), a, b in zip(leaves, g_flash, g_other):
            check(bool(torch.isfinite(a).all()), f"non-finite grad {name}")
            ratio = float((a - b).abs().max() / b.abs().max().clamp_min(
                1e-30))
            worst = max(worst, ratio)
            check(ratio <= 1e-4, f"flash vs {what}: grad {name} max|dg| = "
                  f"{ratio:.3e} max|g|")
        dl = abs(l_flash - l_other)
        print(f"  fp32 2-layer grads, flash vs {what}: loss {l_flash:.6f} "
              f"vs {l_other:.6f} (|d| {dl:.2e}); worst leaf max|dg|/max|g| "
              f"{worst:.3e} over {len(leaves)} leaves", flush=True)
        check(dl <= 1e-4 * abs(l_other), f"flash vs {what}: loss differs")
        del g_other
    return n


def tiny_phase(dev) -> None:
    """The tiny presets (head dim 16) on the card: both engines with
    their defaults (Llama tiny, fp32) on prompts that pad to the 128
    bucket give identical greedy transcripts, each token the argmax of a
    cache-free forward through the reference attention; fp32 gradients
    of the Llama, GPT-2 and Mixtral tiny presets through the kernels
    match the reference attention's. The d-16 flash kernels and the
    hd-16 paged kernel must have run."""
    from dataclasses import replace

    from ray_tpu_torch.models import gpt2, llama, mixtral
    from ray_tpu_torch.serve.llm_engine import LLMEngine
    from ray_tpu_torch.serve.paged_engine import PagedLLMEngine

    rng = np.random.default_rng(14)
    reqs = [(f"t{i}", [int(t) for t in rng.integers(1, 256, m)])
            for i, m in enumerate((70, 90, 110, 127))]
    got = {}
    for name, make in (("dense", LLMEngine), ("paged", PagedLLMEngine)):
        counters_reset()
        eng = make(device=dev)
        got[name] = {r: v["tokens"]
                     for r, v in drain(eng, reqs, 120).items()}
        cfg, params = eng._cfg, eng._params
        stop(eng)
        n = counters()
        print(f"  tiny {name} engine (head dim {cfg.head_dim_}, "
              f"{str(cfg.dtype)[6:]}): flash launches {n['fwd']} (3xTF32 "
              f"{n['fwd_tf32x3']}), paged launches {n['paged']} (merges "
              f"{n['paged_merge']})", flush=True)
        check(n["fwd_tf32x3"] == n["fwd"],
              f"tiny {name} engine: fp32 flash launches off the 3xTF32 "
              f"kernel: {n}")
        if name == "dense":
            check(n["fwd"] > 0, "tiny dense engine: no flash launch")
        else:
            check(n["paged"] > 0 and n["paged_merge"] == n["paged"],
                  "tiny paged engine: no paged split and merge launches")
    check(got["dense"] == got["paged"], f"tiny dense and paged transcripts "
          f"differ:\n{got['dense']}\n{got['paged']}")
    oracle = replace(cfg, attn_impl="reference")
    for rid, prompt in reqs:
        seq = prompt + got["dense"][rid]
        with torch.no_grad():
            logits = llama.forward(oracle, params,
                                   torch.tensor([seq], device=dev))
        lg = logits[0, len(prompt) - 1:len(seq) - 1]
        chosen = lg.gather(1, torch.tensor(got["dense"][rid],
                                           device=dev)[:, None])
        gap = float((lg.max(dim=1).values - chosen[:, 0]).max())
        check(gap <= 1e-3, f"tiny {rid}: engine token is not the reference "
              f"argmax (logit gap {gap})")
    print("  tiny engines: transcripts identical and agree with "
          "llama.forward", flush=True)
    for name, mod, cfg in (("Llama", llama, llama.LlamaConfig.tiny()),
                           ("GPT-2", gpt2, gpt2.GPT2Config.tiny()),
                           ("Mixtral", mixtral,
                            mixtral.MixtralConfig.tiny())):
        n = grad_phase(dev, cfg, mod, seq=128)
        print(f"  tiny {name} gradients: flash forward {n['fwd']}, dQ "
              f"{n['dq']}, dK/dV {n['dkv']} launches (all 3xTF32)",
              flush=True)


def train_phase(dev) -> dict:
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.tools import profile_train as run

    L, steps, b, s = run.LAYERS, 5, run.BATCH, run.SEQ
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  device memory allocated before: "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB", flush=True)
    cfg, params, opt, toks = run.build_train_run(dev)
    check(cfg.remat and cfg.remat_policy == "full" and
          cfg.dtype == torch.bfloat16 and cfg.param_dtype == torch.float32,
          "training config is not fp32 params, bf16 compute, full remat")
    n = llama.num_params(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, walls = [], []
    counters_reset()
    for _ in range(steps):
        t0 = time.perf_counter()
        loss = run.train_step(cfg, params, opt, toks)
        losses.append(loss.item())
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    runs = counters()
    fwd, dq, dkv = runs["fwd"], runs["dq"], runs["dkv"]
    peak = torch.cuda.max_memory_allocated()
    step_s = statistics.median(walls[1:])
    tok = b * s
    qdim = cfg.num_heads * cfg.head_dim_
    flops = 6.0 * n * tok + 3.0 * 2.0 * 2.0 * 0.5 * L * s * tok * qdim
    print(f"  {n / 1e9:.3f}e9 params; losses "
          f"{' '.join(f'{x:.4f}' for x in losses)}", flush=True)
    print(f"  step {step_s * 1e3:.1f} ms (median of steps 2-{steps}; first "
          f"{walls[0] * 1e3:.1f} ms), {tok / step_s:.1f} tokens/s, MFU "
          f"{flops / step_s / PEAK_FLOPS[torch.bfloat16]:.4f} of 989 "
          f"TFLOP/s, peak memory {peak / 2**30:.2f} GiB", flush=True)
    print(f"  training launches: flash forward {fwd} (wgmma route "
          f"{runs['fwd_sm90']}), dQ {dq} (wgmma route {runs['dq_sm90']}), "
          f"dK/dV {dkv} (wgmma route {runs['dkv_sm90']})", flush=True)
    check(all(np.isfinite(losses)), f"non-finite loss: {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    check(fwd == 2 * L * steps, f"flash forward launched {fwd} times, want "
          f"{2 * L * steps} (twice a layer a step under remat)")
    check(dq == dkv == L * steps, f"dQ/dK/dV launched {dq}/{dkv} times, "
          f"want {L * steps} each")
    check(runs["fwd_sm90"] == fwd and runs["dq_sm90"] == dq
          and runs["dkv_sm90"] == dkv,
          f"bf16 training took the wgmma kernels for {runs['fwd_sm90']} of "
          f"{fwd} forward, {runs['dq_sm90']} of {dq} dQ and "
          f"{runs['dkv_sm90']} of {dkv} dK/dV launches")
    del params, opt, loss
    gc.collect()
    torch.cuda.empty_cache()
    return {"flash_attention_fwd": runs["fwd_sm90"],
            "flash_attention_bwd_dq": runs["dq_sm90"],
            "flash_attention_bwd_dkv": runs["dkv_sm90"]}


# phase 3's engine settings and requests, which phase 9 serves again
SERVE_8B = dict(model_config={"preset": "llama3_8b", "dtype": "bfloat16",
                              "param_dtype": "bfloat16"},
                num_slots=8, max_len=1024, prefill_buckets=[128, 512],
                chunk_steps=8, max_new_tokens=32, eos_id=-1)
SERVE_8B_LENS = (100, 157, 214, 271, 328, 385, 442, 500)


def serve_8b_requests(vocab_size: int) -> tuple:
    """Phase 3's 8 prompts (seed 12): the first 7, then the last, which
    shares prompt 1's first 128 tokens (2 full pages of 64 that prompt 1
    publishes to the prefix cache when it finishes)."""
    rng = np.random.default_rng(12)
    prompts = [[int(t) for t in rng.integers(1, vocab_size, m)]
               for m in SERVE_8B_LENS]
    prompts[7] = prompts[1][:128] + prompts[7][128:]
    return ([(f"q{i}", prompts[i]) for i in range(7)],
            [("q7", prompts[7])])


def serve_8b_phase(dev) -> tuple:
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.serve.llm_engine import LLMEngine
    from ray_tpu_torch.serve.paged_engine import PagedLLMEngine

    t0 = time.perf_counter()
    cfg = llama.LlamaConfig.llama3_8b(dtype=torch.bfloat16,
                                      param_dtype=torch.bfloat16)
    params = llama.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    n = llama.num_params(params)
    print(f"  Llama-3-8B bf16: {n / 1e9:.3f}e9 params on the card in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    first, last = serve_8b_requests(cfg.vocab_size)
    kw = dict(SERVE_8B, params=params, device=dev)
    result = {}
    for name, make in (("dense", lambda: LLMEngine(**kw)),
                       ("paged", lambda: PagedLLMEngine(page_size=64, **kw))):
        counters_reset()
        eng = make()
        t1 = time.perf_counter()
        out = drain(eng, first, 300)
        out.update(drain(eng, last, 120))
        wall = time.perf_counter() - t1
        st = eng.stats()
        stop(eng)
        n = counters()
        launches = (n["fwd"], n["paged"])
        check(n["paged_merge"] == n["paged"],
              f"{name}: {n['paged']} paged split launches but "
              f"{n['paged_merge']} merges")
        check(n["fwd_sm90"] == n["fwd"],
              f"{name}: {n['fwd_sm90']} of {n['fwd']} bf16 flash launches "
              f"took the wgmma kernel")
        del eng
        torch.cuda.empty_cache()
        for rid, res in out.items():
            check(len(res["tokens"]) == 32,
                  f"{name} {rid}: {len(res['tokens'])} tokens, want 32")
            check(all(0 <= t < cfg.vocab_size for t in res["tokens"]),
                  f"{name} {rid}: token out of vocabulary")
        ttft = statistics.median(r["ttft_s"] for r in out.values()) * 1e3
        itl = statistics.median((r["latency_s"] - r["ttft_s"]) / 31
                                for r in out.values()) * 1e3
        print(f"  8B {name}: 8 requests x 32 tokens in {wall:.2f} s; "
              f"TTFT p50 {ttft:.2f} ms, ITL p50 {itl:.3f} ms; flash "
              f"launches {launches[0]}, paged launches {launches[1]}",
              flush=True)
        if name == "paged":
            print(f"  8B paged: prefix_hit_tokens "
                  f"{st['prefix_hit_tokens']}", flush=True)
            check(st["prefix_hit_tokens"] >= 128,
                  "the shared 128-token prefix did not hit the cache")
        result[name] = {"tokens": {r: v["tokens"] for r, v in out.items()},
                        "launches": launches, "lat": _latency_ms(out)}
    check(result["dense"]["launches"][0] > 0,
          "dense engine never launched the flash kernel")
    check(result["paged"]["launches"][1] > 0,
          "paged engine never launched the paged kernel")
    same = sum(result["dense"]["tokens"][r] == result["paged"]["tokens"][r]
               for r in result["dense"]["tokens"])
    print(f"  8B bf16: dense and paged transcripts identical for {same}/8 "
          f"requests (not required in bf16)", flush=True)
    return ({"flash_attention_fwd": result["dense"]["launches"][0],
             "paged_attention": result["paged"]["launches"][1]}, result)


# ------------------------------------------------------------ phases 6, 7


def _counted(eng):
    """Count the engine's prefill batches (dense engine) and dispatched
    decode steps, by wrapping its two dispatch methods."""
    n = {"prefill_batches": 0, "decode_steps": 0}
    if hasattr(eng, "_prefill_batch"):
        prefill = eng._prefill_batch

        def counted_prefill(*a):
            n["prefill_batches"] += 1
            return prefill(*a)
        eng._prefill_batch = counted_prefill
    run_chunk = eng._run_chunk

    def counted_chunk(act, k, *a):
        n["decode_steps"] += k
        return run_chunk(act, k, *a)
    eng._run_chunk = counted_chunk
    return n


def serve_family_phase(dev, model) -> dict:
    """A published model at full width, bf16 random weights from seed 0,
    through the dense and then the paged engine with phase 3's request
    mix. The flash forward must launch once a layer a prefill batch (and
    on the route its head dim takes), the paged kernel once a layer a
    decode step. Returns the launches of its kernels."""
    from dataclasses import replace

    from ray_tpu_torch.models import llama
    from ray_tpu_torch.serve.llm_engine import LLMEngine
    from ray_tpu_torch.serve.paged_engine import PagedLLMEngine

    t0 = time.perf_counter()
    cfg = replace(published_config(model), dtype=torch.bfloat16,
                  param_dtype=torch.bfloat16, max_seq_len=1024)
    L = cfg.num_layers
    params = llama.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    print(f"  {model} bf16: {llama.num_params(params) / 1e9:.3f}e9 params, "
          f"{L} layers, G {cfg.num_heads // cfg.num_kv_heads}, head_dim "
          f"{cfg.head_dim_}, on the card in {time.perf_counter() - t0:.1f} s",
          flush=True)
    first, last = serve_8b_requests(cfg.vocab_size)
    kw = dict(SERVE_8B, model_config=_model_config(cfg), params=params,
              device=dev)
    from ray_tpu_torch.ops.attention import flash_route

    sm90 = flash_route(cfg.dtype, cfg.head_dim_, dev, "fwd") == "sm90"
    out_launches = {}
    for name, make in (("dense", lambda: LLMEngine(**kw)),
                       ("paged", lambda: PagedLLMEngine(page_size=64, **kw))):
        counters_reset()
        eng = make()
        n_run = _counted(eng)
        t1 = time.perf_counter()
        out = drain(eng, first, 300)
        out.update(drain(eng, last, 120))
        wall = time.perf_counter() - t1
        st = eng.stats()
        stop(eng)
        n = counters()
        del eng
        torch.cuda.empty_cache()
        for rid, res in out.items():
            check(len(res["tokens"]) == 32,
                  f"{model} {name} {rid}: {len(res['tokens'])} tokens")
            check(all(0 <= t < cfg.vocab_size for t in res["tokens"]),
                  f"{model} {name} {rid}: token out of vocabulary")
        ttft = statistics.median(r["ttft_s"] for r in out.values()) * 1e3
        itl = statistics.median((r["latency_s"] - r["ttft_s"]) / 31
                                for r in out.values()) * 1e3
        print(f"  {model} {name}: 8 requests x 32 tokens in {wall:.2f} s; "
              f"TTFT p50 {ttft:.2f} ms, ITL p50 {itl:.3f} ms; prefill "
              f"batches {n_run['prefill_batches']}, decode steps "
              f"{n_run['decode_steps']}; flash forward launches {n['fwd']} "
              f"(wgmma route {n['fwd_sm90']}), paged launches "
              f"{n['paged']} (merges {n['paged_merge']})", flush=True)
        if name == "dense":
            want = L * n_run["prefill_batches"]
            check(n_run["prefill_batches"] > 0 and n["fwd"] == want,
                  f"{model} dense: {n['fwd']} flash forward launches, want "
                  f"{L} layers x {n_run['prefill_batches']} prefill batches")
            check(n["fwd_sm90"] == (n["fwd"] if sm90 else 0),
                  f"{model} dense: {n['fwd_sm90']} of {n['fwd']} flash "
                  f"launches on the wgmma route, want "
                  f"{'all' if sm90 else 'none (the scalar route)'}")
            out_launches["fwd"] = n["fwd"]
        else:
            want = L * n_run["decode_steps"]
            check(n_run["decode_steps"] > 0 and n["paged"] == want
                  and n["paged_merge"] == want,
                  f"{model} paged: {n['paged']} split and "
                  f"{n['paged_merge']} merge launches, want {L} layers x "
                  f"{n_run['decode_steps']} decode steps")
            print(f"  {model} paged: prefix_hit_tokens "
                  f"{st['prefix_hit_tokens']}", flush=True)
            check(st["prefix_hit_tokens"] >= 128,
                  f"{model}: the shared 128-token prefix did not hit")
            out_launches["paged"] = n["paged"]
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out_launches


def _train(dev, name, mod, cfg, params, toks, steps, n_active, heads,
           head_dim) -> dict:
    """``steps`` AdamW(3e-4, weight decay 0.01) steps of ``mod.loss_fn``
    on one batch: losses finite and falling, every layer's flash forward
    (twice under remat), dQ and dK/dV each step, each on the route
    ``flash_route`` gives it at ``head_dim``. Prints step time, tokens/s,
    MFU (bench.py's formula on ``n_active`` params a token and heads x
    head dim) and peak memory; returns the launch counts."""
    from ray_tpu_torch.models.llama import param_leaves
    from ray_tpu_torch.ops.attention import flash_route

    routes = {k: flash_route(cfg.dtype, head_dim, dev, k)
              for k in ("fwd", "dq", "dkv")}
    qdim = heads * head_dim

    leaves = [p.requires_grad_() for _, p in param_leaves(params)]
    opt = torch.optim.AdamW(leaves, lr=3e-4, weight_decay=0.01)
    L = cfg.num_layers
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, walls = [], []
    counters_reset()
    for _ in range(steps):
        t0 = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        loss = mod.loss_fn(cfg, params, {"tokens": toks})
        loss.backward()
        opt.step()
        losses.append(loss.item())
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    runs = counters()
    peak = torch.cuda.max_memory_allocated()
    step_s = statistics.median(walls[1:])
    b, s = toks.shape[0], toks.shape[1] - 1
    tok = b * s
    flops = 6.0 * n_active * tok + 3.0 * 2.0 * 2.0 * 0.5 * L * s * tok \
        * qdim
    print(f"  {name}: losses {' '.join(f'{x:.4f}' for x in losses)}",
          flush=True)
    print(f"  {name}: step {step_s * 1e3:.1f} ms (median of steps 2-{steps};"
          f" first {walls[0] * 1e3:.1f} ms), {tok / step_s:.1f} tokens/s, "
          f"MFU {flops / step_s / PEAK_FLOPS[torch.bfloat16]:.4f} of 989 "
          f"TFLOP/s on {n_active / 1e9:.3f}e9 params a token, peak memory "
          f"{peak / 2**30:.2f} GiB", flush=True)
    print(f"  {name}: launches flash forward {runs['fwd']} (wgmma route "
          f"{runs['fwd_sm90']}), dQ {runs['dq']} (wgmma route "
          f"{runs['dq_sm90']}), dK/dV {runs['dkv']} (wgmma route "
          f"{runs['dkv_sm90']}); routes at head dim {head_dim}: {routes}",
          flush=True)
    check(all(np.isfinite(losses)), f"{name}: non-finite loss: {losses}")
    check(losses[-1] < losses[0], f"{name}: loss did not fall: {losses}")
    for kernel, want in (("fwd", 2 * L * steps), ("dq", L * steps),
                         ("dkv", L * steps)):
        on_sm90 = want if routes[kernel] == "sm90" else 0
        check(runs[kernel] == want and runs[f"{kernel}_sm90"] == on_sm90,
              f"{name}: {runs[kernel]} {kernel} launches "
              f"({runs[f'{kernel}_sm90']} wgmma), want {want} on the "
              f"{routes[kernel]} route")
    del opt, leaves, loss
    return runs


def train_families_phase(dev) -> dict:
    """GPT-2 125M whole (12 layers, head dim 64) on tokens of 1025, so
    that the model sees 1024; then Mixtral-8x7B width (hidden 4096, ffn
    14336, 8 experts top-2, 32/8 heads) cut to 2 layers for memory, batch
    4 x 2048; then Gemma-7B width (hidden 3072, ffn 24576, 16/16 heads,
    head dim 256, GeGLU, vocab 256000, tied) cut to 4 layers for memory,
    batch 2 x 2048. fp32 params, bf16 compute, full remat, 5 steps each."""
    from ray_tpu_torch.models import gpt2, llama, mixtral

    runs = {}
    rng = np.random.default_rng(0)
    cfg = gpt2.GPT2Config.gpt2_125m()
    params = gpt2.init_params(cfg, seed=0, device=dev)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                         (8, 1025))).to(dev)
    n = llama.num_params(params)
    print(f"  GPT-2 125M: {n / 1e9:.4f}e9 params, batch 8 x 1024",
          flush=True)
    runs["gpt2"] = _train(dev, "GPT-2 125M", gpt2, cfg, params, toks, 5, n,
                          cfg.num_heads, cfg.head_dim)
    del params, toks
    gc.collect()
    torch.cuda.empty_cache()

    cfg = mixtral.MixtralConfig.mixtral_8x7b(num_layers=2)
    params = mixtral.init_params(cfg, seed=0, device=dev)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                         (4, 2049))).to(dev)
    n = llama.num_params(params)
    expert = 3 * cfg.hidden_size * cfg.intermediate_size * cfg.num_layers
    n_active = n - (cfg.num_experts - cfg.top_k) * expert
    print(f"  Mixtral-8x7B width, 2 layers: {n / 1e9:.3f}e9 params "
          f"({n_active / 1e9:.3f}e9 active a token), batch 4 x 2048, "
          f"capacity {mixtral._capacity(cfg, 4 * 2048)} a expert",
          flush=True)
    runs["mixtral"] = _train(dev, "Mixtral-8x7B width", mixtral, cfg, params,
                             toks, 5, n_active, cfg.num_heads, cfg.head_dim_)
    del params, toks
    gc.collect()
    torch.cuda.empty_cache()

    # Gemma-7B width: head dim 256, the wgmma forward, dQ and dK/dV in
    # bf16; profile_train's gemma_7b run, held to the published config
    from dataclasses import replace

    from ray_tpu_torch.tools.profile_train import train_config

    cfg = train_config("gemma_7b")
    check(cfg == replace(published_config("Gemma-7B"), num_layers=4,
                         dtype=torch.bfloat16, param_dtype=torch.float32,
                         remat=True, remat_policy="full"),
          f"profile_train's gemma_7b config is not Gemma-7B's: {cfg}")
    params = llama.init_params(cfg, seed=0, device=dev)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                         (2, 2049))).to(dev)
    n = llama.num_params(params)
    print(f"  Gemma-7B width, 4 layers: {n / 1e9:.3f}e9 params, batch 2 x "
          f"2048, head dim {cfg.head_dim_}", flush=True)
    runs["gemma"] = _train(dev, "Gemma-7B width", llama, cfg, params, toks,
                           5, n, cfg.num_heads, cfg.head_dim_)
    del params, toks
    gc.collect()
    torch.cuda.empty_cache()
    return runs


# ---------------------------------------------------------- phases 9, 10


def _latency_ms(out: dict) -> dict:
    """TTFT and ITL (per generated token after the first) p50 and p99
    over the requests, in ms."""
    ttft = [r["ttft_s"] * 1e3 for r in out.values()]
    itl = [(r["latency_s"] - r["ttft_s"]) / max(len(r["tokens"]) - 1, 1)
           * 1e3 for r in out.values()]
    return {"ttft_p50": float(np.percentile(ttft, 50)),
            "ttft_p99": float(np.percentile(ttft, 99)),
            "itl_p50": float(np.percentile(itl, 50)),
            "itl_p99": float(np.percentile(itl, 99))}


# the handoff lease of the runs without a fault: long enough that only a
# lost handoff outlives it. Under the 5 s default a handoff that lands
# late expires and is prefilled again locally, which costs latency only
# but reads as a recovery; phase 9(b)'s handoffs reach the decode loop
# seconds after submit, and the host's speed differs 2x between machines.
CLEAN_LEASE_S = 60.0


def _check_disagg(st: dict, n_diverted: int, what: str,
                  recovered: bool = False) -> None:
    check(st["disagg_diverted"] == n_diverted,
          f"{what}: {st['disagg_diverted']} diverted, want {n_diverted}")
    if recovered:
        check(st["disagg_recovered"] >= 1, f"{what}: nothing recovered")
    else:
        check(st["disagg_handoffs"] == n_diverted
              and st["disagg_recovered"] == 0,
              f"{what}: {st['disagg_handoffs']} handoffs, "
              f"{st['disagg_recovered']} recovered; want {n_diverted}, 0")
    check(st["disagg_pending"] == 0, f"{what}: leases still pending")


def _check_pool(eng, what: str) -> None:
    alloc = eng._alloc
    check(len(alloc.free) + len(alloc.lru) == alloc.num_pages,
          f"{what}: {len(alloc.free)} free + {len(alloc.lru)} cached pages "
          f"of {alloc.num_pages}: pages leaked")


def _stop_disagg(eng) -> None:
    stop(eng)
    for th in eng._wthreads:
        check(not th.is_alive(), "a prefill worker did not stop")


def _serve_once(make, reqs_first, reqs_last, timeout_s):
    eng = make()
    out = drain(eng, reqs_first, timeout_s)
    out.update(drain(eng, reqs_last, timeout_s))
    return eng, out


def disagg_fp32_phase(dev) -> dict:
    """9(a): fp32 Llama-3-8B width, 2 layers: the disaggregated engine
    (2 prefill workers, divert floor 128) gives the plain paged engine's
    greedy tokens on phase 3's requests, with every prompt of 128 tokens
    or more diverted and handed off, and none lost or leaked under a
    dropped handoff and a killed worker. Returns the paged engine's
    tokens."""
    from dataclasses import replace

    from ray_tpu_torch.core import fault_injection
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.serve.disagg import DisaggPagedEngine
    from ray_tpu_torch.serve.paged_engine import PagedLLMEngine

    cfg = replace(llama.LlamaConfig.llama3_8b(), num_layers=2,
                  dtype=torch.float32, param_dtype=torch.float32)
    params = llama.init_params(cfg, seed=0, device=dev)
    first, last = serve_8b_requests(cfg.vocab_size)
    n_div = sum(len(p) >= 128 for _, p in first + last)
    kw = dict(SERVE_8B, model_config=_model_config(cfg), params=params,
              device=dev, page_size=64)
    counters_reset()
    eng, out = _serve_once(lambda: PagedLLMEngine(**kw), first, last, 120)
    stop(eng)
    want = {r: v["tokens"] for r, v in out.items()}
    dkw = dict(kw, prefill_workers=2, divert_min_tokens=128)
    runs = (("clean", None, CLEAN_LEASE_S), ("drop", "drop", 0.5),
            ("kill_worker", "kill_worker", 0.5))
    for name, action, timeout in runs:
        if action is not None:
            fault_injection.inject("prefill_handoff", action, times=1)
        eng, out = _serve_once(
            lambda: DisaggPagedEngine(handoff_timeout_s=timeout, **dkw),
            first, last, 120)
        fault_injection.clear()
        got = {r: v["tokens"] for r, v in out.items()}
        st = eng.stats()
        if action == "kill_worker":
            deadline = time.monotonic() + 10
            while (eng.stats()["prefill_workers"] < 2
                   and time.monotonic() < deadline):
                time.sleep(0.01)
            st = eng.stats()
            check(st["prefill_workers"] == 2,
                  f"kill_worker: {st['prefill_workers']} of 2 workers alive")
        _stop_disagg(eng)
        print(f"  fp32 2-layer disagg ({name}): tokens identical to the "
              f"paged engine's: {got == want}; diverted "
              f"{st['disagg_diverted']}, handoffs {st['disagg_handoffs']}, "
              f"recovered {st['disagg_recovered']}, imported pages "
              f"{st['disagg_imported_pages']}, workers alive "
              f"{st['prefill_workers']}", flush=True)
        check(got == want, f"fp32 disagg ({name}) tokens differ from the "
              f"paged engine's:\n{got}\n{want}")
        _check_disagg(st, n_div, f"fp32 disagg ({name})",
                      recovered=action is not None)
        _check_pool(eng, f"fp32 disagg ({name})")
        del eng
    c = counters()
    print(f"  fp32 2-layer disagg runs: flash forward launches {c['fwd']} "
          f"(3xTF32 {c['fwd_tf32x3']}), paged {c['paged']}", flush=True)
    check(c["fwd_tf32x3"] == c["fwd"] and c["dq_tf32x3"] == c["dq"]
          and c["dkv_tf32x3"] == c["dkv"],
          f"fp32 disagg: flash launches off the 3xTF32 kernels: {c}")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return want


def disagg_serve_phase(dev) -> dict:
    """9(b): bf16 Llama-3-8B, all 32 layers, phase 3's weights (seed 0)
    and requests: the plain paged engine, then the disaggregated one (2
    prefill workers on their own streams, divert floor 128). Returns the
    latencies and the staging pool's size."""
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.serve.disagg import DisaggPagedEngine
    from ray_tpu_torch.serve.paged_engine import PagedLLMEngine

    cfg = llama.LlamaConfig.llama3_8b(dtype=torch.bfloat16,
                                      param_dtype=torch.bfloat16)
    params = llama.init_params(cfg, seed=0, device=dev)
    first, last = serve_8b_requests(cfg.vocab_size)
    n_div = sum(len(p) >= 128 for _, p in first + last)
    kw = dict(SERVE_8B, params=params, device=dev, page_size=64)
    result = {}
    for name in ("paged", "disagg"):
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        counters_reset()
        if name == "paged":
            eng = PagedLLMEngine(**kw)
        else:
            eng = DisaggPagedEngine(prefill_workers=2,
                                    divert_min_tokens=128,
                                    handoff_timeout_s=CLEAN_LEASE_S, **kw)
            deadline = time.monotonic() + 30
            while len(eng._wstates) < 2 and time.monotonic() < deadline:
                time.sleep(0.01)
            torch.cuda.synchronize()
            check(len(eng._wstates) == 2, "prefill workers did not start")
            streams = [ws["stream"] for ws in eng._wstates.values()]
            check(all(s is not None and s != torch.cuda.default_stream(dev)
                      for s in streams) and streams[0] != streams[1],
                  "prefill workers do not run on streams of their own")
        torch.cuda.synchronize()
        pool_mib = (torch.cuda.memory_allocated() - before) / 2**20
        t1 = time.perf_counter()
        out = drain(eng, first, 300)
        out.update(drain(eng, last, 120))
        wall = time.perf_counter() - t1
        st = eng.stats()
        n = counters()
        if name == "disagg":
            staging = sum(t.numel() * t.element_size()
                          for t in eng._wstates[0]["cache"].values()) / 2**20
            _stop_disagg(eng)
            _check_disagg(st, n_div, "8B bf16 disagg")
        else:
            stop(eng)
        _check_pool(eng, f"8B bf16 {name}")
        del eng
        torch.cuda.empty_cache()
        for rid, res in out.items():
            check(len(res["tokens"]) == 32,
                  f"{name} {rid}: {len(res['tokens'])} tokens, want 32")
        check(n["paged"] > 0 and n["paged_merge"] == n["paged"],
              f"8B {name}: paged split/merge launches {n['paged']}/"
              f"{n['paged_merge']}")
        lat = _latency_ms(out)
        print(f"  8B bf16 {name}: 8 requests x 32 tokens in {wall:.2f} s; "
              f"TTFT p50 {lat['ttft_p50']:.2f} ms p99 "
              f"{lat['ttft_p99']:.2f} ms; ITL p50 {lat['itl_p50']:.3f} ms "
              f"p99 {lat['itl_p99']:.3f} ms; paged launches {n['paged']}; "
              f"device memory allocated by the engine {pool_mib:.1f} MiB",
              flush=True)
        if name == "disagg":
            print(f"  8B bf16 disagg: diverted {st['disagg_diverted']}, "
                  f"handoffs {st['disagg_handoffs']}, recovered "
                  f"{st['disagg_recovered']}, imported pages "
                  f"{st['disagg_imported_pages']}; staging pool "
                  f"{staging:.1f} MiB per worker (2 workers)", flush=True)
        result[name] = {"tokens": {r: v["tokens"] for r, v in out.items()},
                        "latency_ms": lat, "paged": n["paged"],
                        "engine_mib": pool_mib,
                        "staging_hit": st.get("disagg_staging_hit_tokens")}
    same = sum(result["paged"]["tokens"][r] == result["disagg"]["tokens"][r]
               for r in result["paged"]["tokens"])
    print(f"  8B bf16: disagg and paged transcripts identical for {same}/8 "
          f"requests (not required in bf16: the chunk boundaries differ)",
          flush=True)
    result["staging_mib"] = staging
    return result


def decode_api_phase(dev) -> None:
    """9(c): bf16 Llama-3-8B, 32 layers: ``prefill`` of one 512-token
    prompt launches the flash forward once a layer and agrees with
    ``prefill_batch`` and with the reference attention's ``prefill``;
    ``insert_sequence`` writes its K/V into a dense cache exactly;
    ``init_shapes`` has ``init_params``'s shapes and dtypes."""
    from dataclasses import replace

    from ray_tpu_torch.models import llama, llama_decode

    cfg = llama.LlamaConfig.llama3_8b(dtype=torch.bfloat16,
                                      param_dtype=torch.bfloat16)
    params = llama.init_params(cfg, seed=0, device=dev)
    shapes = dict(llama.param_leaves(llama.init_shapes(cfg)))
    real = dict(llama.param_leaves(params))
    check(sorted(shapes) == sorted(real) and all(
        shapes[k].is_meta and shapes[k].shape == real[k].shape
        and shapes[k].dtype == real[k].dtype for k in real),
        "init_shapes differs from init_params")
    toks = torch.tensor(np.random.default_rng(15).integers(
        1, cfg.vocab_size, (1, 512)), dtype=torch.int32, device=dev)
    counters_reset()
    logits, kv, x = llama_decode.prefill(cfg, params, toks)
    torch.cuda.synchronize()
    n = counters()
    check(n["fwd"] == cfg.num_layers and n["fwd_sm90"] == n["fwd"],
          f"prefill: {n['fwd']} flash launches ({n['fwd_sm90']} wgmma), "
          f"want {cfg.num_layers} on the wgmma route")
    check(tuple(logits.shape) == (512, cfg.vocab_size)
          and logits.dtype == torch.float32
          and tuple(kv["k"].shape) == (cfg.num_layers, 512, 8, 128)
          and bool(torch.isfinite(logits).all()),
          "prefill: wrong shapes or non-finite logits")
    blog, bkv = llama_decode.prefill_batch(
        cfg, params, toks, torch.tensor([511], device=dev))
    errs = {}
    for what, got, want in (("logits", logits[511], blog[0]),
                            ("k", kv["k"], bkv["k"][:, 0]),
                            ("v", kv["v"], bkv["v"][:, 0])):
        ok, errs[what] = close(got, want, 2e-2, 2e-2)
        check(ok, f"prefill {what} differs from prefill_batch: "
              f"{errs[what]:.3e}")
    # printed, not asserted: the two attentions round differently in
    # bf16 and 32 layers carry the difference on (phase 1 holds the
    # kernel to its plain version)
    rlog, rkv, _ = llama_decode.prefill(
        replace(cfg, prefill_flash=False), params, toks)
    ref_err = {what: close(got, want, 0.0, 0.0)[1]
               for what, got, want in (("logits", logits, rlog),
                                       ("k", kv["k"], rkv["k"]),
                                       ("v", kv["v"], rkv["v"]))}
    cache = llama_decode.init_cache(cfg, 2, 1024, dev)
    llama_decode.insert_sequence(cache, kv, 1)
    check(all(torch.equal(cache[n_][:, 1, :512], kv[n_]) for n_ in "kv")
          and not cache["k"][:, 0].any() and not cache["k"][:, 1,
                                                           512:].any(),
          "insert_sequence did not write the slot exactly")
    print(f"  decode API: prefill of 512 tokens launched the flash forward "
          f"{n['fwd']} times (wgmma {n['fwd_sm90']}); against prefill_batch "
          f"max|d| logits {errs['logits']:.3e} k {errs['k']:.3e} v "
          f"{errs['v']:.3e}; against the reference attention (printed "
          f"only) logits "
          f"{ref_err['logits']:.3e} k {ref_err['k']:.3e} v "
          f"{ref_err['v']:.3e}; insert_sequence exact; init_shapes matches "
          f"{len(real)} leaves", flush=True)
    del params, cache, logits, kv, x, blog, bkv, rlog, rkv
    gc.collect()
    torch.cuda.empty_cache()


# the RL learners of phase 10: name -> (learner factory, batch maker,
# update call, optimizer steps per update, learning rate)
def _rl_cases():
    from ray_tpu_torch.rllib import (appo, dqn, dreamer, impala, learner,
                                     offline, rl_module, sac)

    catch = (10, 10, 1)
    rng = np.random.default_rng(16)
    f32 = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731

    def ppo_batch(n=4096, d=100, a=3):
        return {"obs": f32(n, d), "actions": rng.integers(0, a, n),
                "logp_old": np.full(n, np.log(1 / a), np.float32)
                + 0.1 * f32(n), "advantages": f32(n), "returns": f32(n)}

    def impala_batch(T=32, N=128, d=100, a=3):
        dones = rng.random((T, N)) < 0.05
        return {"obs": f32(T, N, d), "next_obs": f32(T, N, d),
                "actions": rng.integers(0, a, (T, N)),
                "behavior_logits": f32(T, N, a), "rewards": f32(T, N),
                "dones": dones, "terminateds": dones & (rng.random((T, N))
                                                        < 0.5)}

    def q_batch(lead, d=4, a=2):
        return {"obs": f32(*lead, d), "next_obs": f32(*lead, d),
                "actions": rng.integers(0, a, lead), "rewards": f32(*lead),
                "dones": (rng.random(lead) < 0.05).astype(np.float32)}

    def sac_batch(U=4, B=4096):
        return {"obs": f32(U, B, 3), "next_obs": f32(U, B, 3),
                "actions": rng.uniform(-2, 2, (U, B)).astype(np.float32),
                "rewards": f32(U, B),
                "dones": np.zeros((U, B), np.float32)}

    def bc_batch(n=4096):
        b = ppo_batch(n, 4, 2)
        return {"obs": b["obs"], "actions": b["actions"],
                "returns": b["returns"]}

    cnn = lambda: rl_module.CNNModule(catch, 3)   # noqa: E731
    qmlp = lambda: rl_module.QMLPModule(4, 2)     # noqa: E731
    mlp = lambda: rl_module.MLPModule(4, 2)       # noqa: E731
    perm_rng = np.random.default_rng(17)
    ppo_perms = lambda: np.stack([perm_rng.permutation(4096)  # noqa: E731
                                  for _ in range(10)]).reshape(10, 8, 512)
    noise = lambda: rng.normal(size=(4, 2, 4096, 1)).astype(  # noqa: E731
        np.float32)

    def seq_batch(B=8, L=16, d=4, a=2):
        first = (rng.random((B, L)) < 0.05).astype(np.float32)
        first[:, 0] = 1.0
        return {"obs": f32(B, L, d), "actions": rng.integers(0, a, (B, L)),
                "rewards": f32(B, L),
                "dones": (rng.random((B, L)) < 0.05).astype(np.float32),
                "is_first": first}

    def gumbel(*s):
        u = rng.uniform(np.finfo(np.float32).tiny, 1.0, s)
        return (-np.log(-np.log(u))).astype(np.float32)

    # the reference's defaults: 8 x 8 latents, horizon 10, 64 starts
    dreamer_noise = lambda: {  # noqa: E731
        "post": gumbel(16, 8, 8, 8), "act": gumbel(10, 64, 2),
        "prior": gumbel(10, 64, 8, 8), "pick": rng.permutation(128)[:64]}
    return {
        "PPO (CNN, Catch)": (
            lambda d, p: learner.PPOLearner(cnn(), minibatch_size=512,
                                            device=d, params=p),
            ppo_batch, lambda lrn, b, x: lrn.update(b, perms=x), ppo_perms,
            80, 3e-4),
        "IMPALA (CNN, Catch)": (
            lambda d, p: impala.ImpalaLearner(cnn(), device=d, params=p),
            impala_batch, lambda lrn, b, x: lrn.update(b), None, 1, 6e-4),
        "APPO (CNN, Catch)": (
            lambda d, p: appo.AppoLearner(cnn(), lr=3e-4, device=d,
                                          params=p),
            impala_batch, lambda lrn, b, x: lrn.update(b), None, 1, 3e-4),
        "DQN (QMLP, CartPole)": (
            lambda d, p: dqn.DQNLearner(qmlp(), device=d, params=p),
            lambda: q_batch((4, 4096)),
            lambda lrn, b, x: {"loss": lrn.update_many(b)[0]}, None, 4,
            1e-3),
        "CQL (QMLP, CartPole)": (
            lambda d, p: offline.CQLLearner(qmlp(), device=d, params=p),
            lambda: q_batch((4096,)),
            lambda lrn, b, x: {"loss": lrn.update(b)}, None, 1, 1e-3),
        "BC (MLP, CartPole)": (
            lambda d, p: offline.BCLearner(mlp(), device=d, params=p),
            bc_batch, lambda lrn, b, x: {"loss": lrn.update(b)}, None, 1,
            1e-3),
        "MARWIL (MLP, CartPole)": (
            lambda d, p: offline.MARWILLearner(mlp(), device=d, params=p),
            bc_batch, lambda lrn, b, x: {"loss": lrn.update(b)}, None, 1,
            1e-3),
        "SAC (Pendulum)": (
            lambda d, p: sac.SACLearner(
                rl_module.SquashedGaussianModule(3, 1, -2.0, 2.0),
                rl_module.TwinQModule(3, 1), device=d, params=p),
            sac_batch, lambda lrn, b, x: lrn.update_many(b, noise=x), noise,
            4, 3e-4),
        "DreamerV3 (CartPole)": (
            lambda d, p: dreamer.DreamerV3Learner(4, 2, device=d, params=p),
            # imag_return is held out: near 0 it is a cancellation of
            # +-15 bins, whose last bits a relative limit cannot hold
            seq_batch, lambda lrn, b, x: {
                k: v for k, v in lrn.update(b, noise=x).items()
                if k != "imag_return"}, dreamer_noise, 1, 4e-4),
    }


def _rl_params(lrn):
    """A learner's weights as the tree its ``params=`` takes."""
    from ray_tpu_torch.rllib.rl_module import to_numpy

    if hasattr(lrn, "critic"):
        return {"pi": to_numpy(lrn.actor), "q": to_numpy(lrn.critic)}
    if hasattr(lrn, "wm"):
        return {"wm": to_numpy(lrn.wm), "ac": to_numpy(lrn.ac)}
    return to_numpy(lrn.module)


def _rl_state(lrn) -> dict:
    """Every trained tensor of a learner, by dotted path."""
    from ray_tpu_torch.rllib.rl_module import tree_leaves

    state = tree_leaves(_rl_params(lrn))
    for name in ("log_alpha", "ret_lo", "ret_hi"):
        if hasattr(lrn, name):
            state[name] = getattr(lrn, name).detach().cpu().numpy()
    return state


def _rl_copy_state(dst, src) -> None:
    """Set learner ``dst`` to ``src``'s state across devices: every
    network, optimizer (moments and step count), trained tensor and
    counter. The state dicts are copied first, so that the two learners
    share no tensor (a CPU optimizer would otherwise adopt the other's
    step tensor)."""
    import copy

    for name, val in vars(src).items():
        if isinstance(val, (torch.nn.Module, torch.optim.Optimizer)):
            getattr(dst, name).load_state_dict(
                copy.deepcopy(val.state_dict()))
        elif isinstance(val, torch.Tensor):
            with torch.no_grad():
                getattr(dst, name).copy_(val)
        elif isinstance(val, (int, float)) and not isinstance(val, bool):
            setattr(dst, name, val)


def _rl_grads(lrn) -> dict:
    """Attach a hook keeping the first gradients of each kind."""
    from ray_tpu_torch.rllib.rl_module import tree_leaves

    store = {}

    def hook(kind, g):
        store.setdefault(kind, tree_leaves(g))
    lrn.grad_hook = hook
    return store


def rl_phase(dev) -> dict:
    """10: each learner built on the card and on the CPU from the same
    parameters, 3 updates on the same seeded batches (and the same
    permutations or noise): the first gradients agree, and so do the
    parameters after the 3 updates; the losses agree update by update,
    each against a CPU learner that starts that update from the card
    learner's state; ms per update on the card.

    Why the losses are held update by update: two devices round
    differently, and a free-running trajectory amplifies that. A weight
    whose gradient is within rounding of zero takes Adam steps of up to
    lr whose sign the rounding picks, and a PPO sample whose ratio lies
    within rounding of 1 +- clip switches the branch of the clipped
    surrogate. Over PPO's 240 optimizer steps (3 updates of 80) such
    events move its third update's losses past rtol 1e-4 while the
    parameters stay inside their bound; the free-running difference is
    printed beside the held one. cuDNN runs its deterministic
    algorithms here, so that two runs of the phase read the same
    numbers."""
    out = {}
    deterministic = torch.backends.cudnn.deterministic
    for name, (make, make_batch, call, extra, steps, lr) in \
            _rl_cases().items():
        params = _rl_params(make("cpu", None))
        batches = [make_batch() for _ in range(3)]
        extras = [extra() if extra else None for _ in range(3)]
        torch.backends.cudnn.deterministic = True
        lrns = {"card": make(dev, params), "cpu": make("cpu", params)}
        anchor = make("cpu", params)
        grads = {d: _rl_grads(lrns[d]) for d in lrns}
        loss_err = free_err = 0.0
        for u, (b, x) in enumerate(zip(batches, extras)):
            _rl_copy_state(anchor, lrns["card"])
            mc = call(lrns["card"], b, x)
            mp = call(anchor, b, x)
            mf = call(lrns["cpu"], b, x)
            for k in mp:
                loss_err = max(loss_err, abs(mc[k] - mp[k])
                               / max(abs(mp[k]), 1e-30))
                free_err = max(free_err, abs(mc[k] - mf[k])
                               / max(abs(mf[k]), 1e-30))
                check(abs(mc[k] - mp[k]) <= 1e-4 * abs(mp[k]),
                      f"{name}: update {u + 1} {k} {mc[k]} on the card, "
                      f"{mp[k]} on the CPU from the same state")
        torch.cuda.synchronize()
        torch.backends.cudnn.deterministic = deterministic
        grad_err = 0.0
        for kind in grads["cpu"]:
            for leaf, want in grads["cpu"][kind].items():
                got = grads["card"][kind][leaf]
                d = np.abs(got - want)
                grad_err = max(grad_err, float(d.max()))
                check(bool((d <= 1e-5 + 1e-4 * np.abs(want)).all()),
                      f"{name}: first {kind} gradient {leaf} differs by "
                      f"{float(d.max()):.3e}")
        sc, sp = _rl_state(lrns["card"]), _rl_state(lrns["cpu"])
        bound = 0.2 * lr * steps * 3
        param_err = max(float(np.abs(sc[k] - sp[k]).max()) for k in sp)
        check(param_err <= bound, f"{name}: parameters differ by "
              f"{param_err:.3e} after 3 updates (bound {bound:.3e})")
        # ms per update on the card: median of 10 after 2 warm-ups
        lrn = lrns["card"]
        lrn.grad_hook = None
        times = []
        for i in range(12):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call(lrn, batches[i % 3], extras[i % 3])
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        ms = statistics.median(times[2:])
        print(f"  {name}: card vs CPU over 3 updates ({steps} optimizer "
              f"steps each): max rel |d loss| {loss_err:.3e} update by "
              f"update ({free_err:.3e} free-running, printed only), "
              f"first-grad "
              f"max|d| {grad_err:.3e}, params max|d| {param_err:.3e} "
              f"(bound {bound:.3e}); {ms:.3f} ms per update on the card",
              flush=True)
        out[name] = ms
        del lrns, lrn, anchor
        gc.collect()
        torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------- phase 11

MESH_STEPS = 3   # loss + backward steps of each phase-11 run
# ring at bf16 compute against its mesh-free math: at this shape the bf16
# gradients of two correct attention implementations differ by about 2e-2
# of a leaf's largest value (phase 11 prints the flash kernels' spread
# against ring's math: 2.348e-02 on an H100 80GB HBM3 at 700 W, where ring
# reads 1.818e-02), so the limit sits above that spread
RING_BF16_TOL = 3e-2


def _grad_tree(params) -> dict:
    """Each param leaf's gradient, whole (a DTensor's ``full_tensor()``)."""
    from torch.distributed.tensor import DTensor

    from ray_tpu_torch.models.llama import param_leaves

    return {n: (p.grad.full_tensor() if isinstance(p.grad, DTensor)
                else p.grad).detach() for n, p in param_leaves(params)}


def _spread(grads: dict, ref_grads: dict) -> float:
    """The worst leaf's max|dg| / max|g| of two gradient trees."""
    worst = 0.0
    for name, want in ref_grads.items():
        got = grads[name].to(want.device).float()
        scale = float(want.float().abs().max()) or 1.0
        worst = max(worst, float((got - want.float()).abs().max()) / scale)
    return worst


def _mesh_run(what, loss_fn, params, ref=None, tol=2e-2,
              keep=False) -> tuple:
    """``MESH_STEPS`` steps of ``loss_fn().backward()`` on ``params``:
    (last loss, ms a step (median of steps 2 on), the launch counters of
    all steps, and with ``keep`` the last step's gradients on the host).
    With ``ref`` (loss, host gradients of a mesh-free run), the loss and
    every gradient leaf are held to it at atol/rtol ``tol`` (atol scaled
    by the leaf's largest value)."""
    from ray_tpu_torch.models.llama import param_leaves

    leaves = [p for _, p in param_leaves(params)]
    walls = []
    counters_reset()
    for _ in range(MESH_STEPS):
        for p in leaves:
            p.grad = None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = loss_fn(params)
        loss.backward()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    runs = counters()
    loss = loss.item()
    ms = statistics.median(walls[1:]) * 1e3
    grads = _grad_tree(params)
    line = f"  {what}: loss {loss:.6f}, {ms:.1f} ms a step"
    if ref is not None:
        ref_loss, ref_grads = ref
        ok, _ = close(torch.tensor(loss), torch.tensor(ref_loss), tol, tol)
        check(ok and np.isfinite(loss),
              f"{what}: loss {loss} against the mesh-free {ref_loss}")
        worst = 0.0
        for name, want in ref_grads.items():
            want = want.to(grads[name].device)
            scale = float(want.float().abs().max()) or 1.0
            ok, err = close(grads[name], want, tol * scale, tol)
            check(ok, f"{what}: gradient {name} off by {err} (max "
                      f"{scale})")
            worst = max(worst, err / scale)
        line += (f"; loss - mesh-free {loss - ref_loss:+.3e}, worst gradient "
                 f"leaf max|dg|/max|g| {worst:.3e}")
    grads = {k: v.cpu() for k, v in grads.items()} if keep else None
    for p in leaves:
        p.grad = None
    print(line + f"; launches {runs}", flush=True)
    return loss, ms, runs, grads


def mesh_phase(dev) -> dict:
    """11: the parallel layer at world size 1 over NCCL (one card cannot
    hold two ranks of one communicator), full width: phase 5's Llama-3-8B
    width, 8 layers, 4 x 2048 (fp32 params, bf16 compute, full remat),
    ``loss_fn(mesh={fsdp 1, sp 1, tp 1})`` with Ulysses (the wgmma flash
    kernels on the local heads) and with ring attention, ``loss_fn_pp``
    at pp 1 with 4 microbatches, then Mixtral-8x7B width with 2 layers
    under {dp 1, ep 1}. Each run's loss and gathered gradients are held
    to the mesh-free run on the same weights with the same attention
    math (the flash kernels; for ring, attention in fp32 at fp32 and at
    bf16 compute); ms a step (loss and backward) beside the mesh-free
    step. Returns the sharded runs' flash launches (the Ulysses,
    pipeline and Mixtral runs)."""
    import tempfile
    from dataclasses import replace
    from unittest import mock

    import torch.distributed as dist

    from ray_tpu_torch.models import llama, mixtral
    from ray_tpu_torch.ops.attention import attention_reference
    from ray_tpu_torch.parallel import (MeshSpec, build_mesh,
                                        device_put_sharded,
                                        init_process_group)
    from ray_tpu_torch.tools import profile_train as run

    def place(mod, cfg, params, axes):
        mesh = build_mesh(MeshSpec(axes))
        placed = device_put_sharded(_detached(params),
                                    mod.param_shardings(cfg, mesh))
        for _, p in llama.param_leaves(placed):
            p.requires_grad_()
        return mesh, placed

    total = {"fwd_sm90": 0, "dq_sm90": 0, "dkv_sm90": 0}

    def count(runs, want_fwd, want_bwd, what):
        check(runs["fwd"] == runs["fwd_sm90"] == want_fwd and
              runs["dq"] == runs["dq_sm90"] == want_bwd and
              runs["dkv"] == runs["dkv_sm90"] == want_bwd,
              f"{what}: flash launches {runs}, want {want_fwd} forward and "
              f"{want_bwd} dQ and dK/dV, all on the wgmma route")
        for k in total:
            total[k] += runs[k]

    with tempfile.TemporaryDirectory() as store:
        init_process_group(0, 1, dev, store_path=os.path.join(store, "pg"))
        try:
            cfg, params, opt, toks = run.build_train_run(dev)
            del opt
            L, steps = cfg.num_layers, MESH_STEPS
            batch = {"tokens": toks}
            print(f"  world size {dist.get_world_size()} over "
                  f"{dist.get_backend()}; Llama-3-8B width, {L} layers, "
                  f"batch {toks.shape[0]} x {toks.shape[1] - 1}", flush=True)
            ref_loss, ref_ms, _, grads = _mesh_run(
                "mesh-free", lambda p: llama.loss_fn(cfg, p, batch), params,
                keep=True)
            ref = (ref_loss, grads)
            mesh, placed = place(llama, cfg, params,
                                 {"fsdp": 1, "sp": 1, "tp": 1})
            ucfg = replace(cfg, attn_impl="ulysses")
            _, ms, runs, _ = _mesh_run(
                "ulysses on {fsdp 1, sp 1, tp 1}",
                lambda p: llama.loss_fn(ucfg, p, batch, mesh=mesh), placed,
                ref)
            count(runs, 2 * L * steps, L * steps, "ulysses")
            print(f"  ulysses: {ms:.1f} ms a step against the mesh-free "
                  f"{ref_ms:.1f}", flush=True)
            M = 4
            pmesh, pplaced = place(llama, cfg, params, {"pp": 1})
            _, ms, runs, _ = _mesh_run(
                f"loss_fn_pp at pp 1, {M} microbatches",
                lambda p: llama.loss_fn_pp(cfg, p, batch, pmesh, M), pplaced,
                ref)
            count(runs, 2 * L * M * steps, L * M * steps, "pipeline")
            print(f"  pipeline: {ms:.1f} ms a step against the mesh-free "
                  f"{ref_ms:.1f}", flush=True)
            del pplaced
            # ring keeps its probabilities in fp32, as the reference's ring
            # does (tests/test_torch_seqpar.py holds the two together in
            # bf16), where the flash kernels and attention_reference round
            # them to bf16 for the value product. So ring is held to
            # mesh-free runs of its own math: attention_reference on q/k/v
            # upcast to fp32, its output rounded to the compute dtype; at
            # fp32 compute to 1e-4 of each leaf's largest value (phase 4's
            # limit), at bf16 compute to RING_BF16_TOL, beside the spread
            # between the flash run and that math.
            def fp32_attention(q, k, v, causal=True):
                return attention_reference(q.float(), k.float(), v.float(),
                                           causal).to(q.dtype)

            cfg32 = replace(cfg, dtype=torch.float32)
            for what, rcfg, tol in (("fp32 compute", cfg32, 1e-4),
                                    ("bf16 compute", cfg, RING_BF16_TOL)):
                fcfg = replace(rcfg, attn_impl="reference")
                with mock.patch.object(llama, "attention_reference",
                                       fp32_attention):
                    ref_loss, fref_ms, _, grads = _mesh_run(
                        f"mesh-free, {what}, attention in fp32",
                        lambda p: llama.loss_fn(fcfg, p, batch), params,
                        keep=True)
                if rcfg.dtype == torch.bfloat16:
                    print(f"  flash against attention in fp32, bf16 compute: "
                          f"loss {ref[0] - ref_loss:+.3e}, worst gradient "
                          f"leaf max|dg|/max|g| "
                          f"{_spread(ref[1], grads):.3e}", flush=True)
                rcfg = replace(rcfg, attn_impl="ring")
                _, ms, runs, _ = _mesh_run(
                    f"ring on {{fsdp 1, sp 1, tp 1}}, {what}",
                    lambda p: llama.loss_fn(rcfg, p, batch, mesh=mesh),
                    placed, (ref_loss, grads), tol=tol)
                check(runs["fwd"] == runs["dq"] == 0,
                      f"ring launched flash kernels: {runs}")
                print(f"  ring, {what}: {ms:.1f} ms a step against the "
                      f"mesh-free {fref_ms:.1f} (attention in fp32) and "
                      f"{ref_ms:.1f} (flash)", flush=True)
                del grads
            del placed, params, ref
            gc.collect()
            torch.cuda.empty_cache()

            mcfg = mixtral.MixtralConfig.mixtral_8x7b(num_layers=2)
            mparams = mixtral.init_params(mcfg, seed=0, device=dev)
            for _, p in llama.param_leaves(mparams):
                p.requires_grad_()
            mtoks = torch.from_numpy(np.random.default_rng(0).integers(
                0, mcfg.vocab_size, (4, 2049))).to(dev)
            mbatch = {"tokens": mtoks}
            ref_loss, ref_ms, _, grads = _mesh_run(
                "Mixtral-8x7B width, 2 layers, mesh-free",
                lambda p: mixtral.loss_fn(mcfg, p, mbatch), mparams,
                keep=True)
            ref = (ref_loss, grads)
            mesh, placed = place(mixtral, mcfg, mparams, {"dp": 1, "ep": 1})
            _, ms, runs, _ = _mesh_run(
                "Mixtral on {dp 1, ep 1}",
                lambda p: mixtral.loss_fn(mcfg, p, mbatch, mesh=mesh),
                placed, ref)
            count(runs, 2 * mcfg.num_layers * steps,
                  mcfg.num_layers * steps, "Mixtral")
            print(f"  Mixtral: {ms:.1f} ms a step against the mesh-free "
                  f"{ref_ms:.1f}", flush=True)
            del placed, mparams, ref
        finally:
            dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    return total


# ------------------------------------------------------------- phase 12


def tp_serve_phase(dev, phase3: dict) -> dict:
    """12: tensor-parallel serving at world size 1 over NCCL (one card
    cannot hold two ranks of one communicator: multi-rank serving is held
    on the CPU by tests/test_torch_tp_serve.py). Phase 3's Llama-3-8B bf16
    weights (seed 0) and requests through both engines with
    ``mesh={tp 1}``: the same greedy tokens as phase 3's mesh-free
    engines request by request, the same kernel launches on the same
    routes, TTFT and ITL beside phase 3's, and the engine's memory on top
    of the weights below a second copy of them. ``LLMEngine(tp=2)`` on
    one card raises the reference's ValueError. Returns the launches."""
    import tempfile

    import torch.distributed as dist

    from ray_tpu_torch.models import llama
    from ray_tpu_torch.parallel import MeshSpec, build_mesh
    from ray_tpu_torch.parallel import init_process_group
    from ray_tpu_torch.serve.llm_engine import LLMEngine
    from ray_tpu_torch.serve.paged_engine import PagedLLMEngine

    n = torch.cuda.device_count()
    try:
        LLMEngine(tp=n + 1, device=dev)
        check(False, f"LLMEngine(tp={n + 1}) on {n} card(s) did not raise")
    except ValueError as e:
        want = f"tp={n + 1} needs {n + 1} devices, found {n}"
        check(str(e) == want, f"LLMEngine(tp={n + 1}): {e!r}, want {want!r}")
        print(f"  LLMEngine(tp={n + 1}) on {n} card(s): ValueError({e})",
              flush=True)
    cfg = llama.LlamaConfig.llama3_8b(dtype=torch.bfloat16,
                                      param_dtype=torch.bfloat16)
    params = llama.init_params(cfg, seed=0, device=dev)
    weights = sum(p.numel() * p.element_size()
                  for _, p in llama.param_leaves(params))
    first, last = serve_8b_requests(cfg.vocab_size)
    out_launches = {}
    with tempfile.TemporaryDirectory() as store:
        init_process_group(0, 1, dev, store_path=os.path.join(store, "pg"))
        try:
            mesh = build_mesh(MeshSpec({"tp": 1}))
            kw = dict(SERVE_8B, params=params, device=dev, mesh=mesh)
            for name, make in (("dense", lambda: LLMEngine(**kw)),
                               ("paged", lambda: PagedLLMEngine(
                                   page_size=64, **kw))):
                torch.cuda.synchronize()
                gc.collect()
                torch.cuda.empty_cache()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                counters_reset()
                eng = make()
                check(hasattr(eng._params["embed"], "placements"),
                      f"{name}: the engine's weights are not DTensors")
                out = drain(eng, first, 300)
                out.update(drain(eng, last, 120))
                stop(eng)
                c = counters()
                peak = torch.cuda.max_memory_allocated() - base
                del eng
                want = phase3[name]
                for rid, res in out.items():
                    check(res["tokens"] == want["tokens"][rid],
                          f"{name} mesh={{tp 1}} {rid}: tokens differ from "
                          f"phase 3's")
                check(c["paged_merge"] == c["paged"]
                      and c["fwd_sm90"] == c["fwd"],
                      f"{name} mesh={{tp 1}}: launches {c}")
                got = (c["fwd"], c["paged"])
                check(got == want["launches"],
                      f"{name} mesh={{tp 1}}: flash and paged launches "
                      f"{got}, phase 3 {want['launches']}")
                check(peak < weights,
                      f"{name} mesh={{tp 1}}: {peak / 2**30:.2f} GiB on top "
                      f"of the weights, a second copy is "
                      f"{weights / 2**30:.2f}")
                lat, ref = _latency_ms(out), want["lat"]
                print(f"  8B {name} mesh={{tp 1}}: tokens equal phase 3's for "
                      f"8/8 requests; flash launches {got[0]} (wgmma "
                      f"{c['fwd_sm90']}), paged launches {got[1]}; TTFT "
                      f"p50/p99 {lat['ttft_p50']:.2f}/{lat['ttft_p99']:.2f} "
                      f"ms (phase 3 {ref['ttft_p50']:.2f}/"
                      f"{ref['ttft_p99']:.2f}), ITL p50/p99 "
                      f"{lat['itl_p50']:.3f}/{lat['itl_p99']:.3f} ms (phase 3 "
                      f"{ref['itl_p50']:.3f}/{ref['itl_p99']:.3f}); peak "
                      f"{peak / 2**30:.2f} GiB on top of the "
                      f"{weights / 2**30:.2f} GiB of weights", flush=True)
                out_launches[name] = got
        finally:
            dist.destroy_process_group()
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return {"flash_attention_fwd": out_launches["dense"][0],
            "paged_attention": out_launches["paged"][1]}


# ---------------------------------------------------------------- phase 13


def _leaf_sums(tree, prefix="") -> dict:
    """{leaf path: the sum of the leaf's bytes read as integers of its
    element size} of every tensor leaf (the int64 sum of int32 words for
    fp32, of int16 words for bf16)."""
    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaf_sums(v, f"{prefix}{k}."))
        elif isinstance(v, torch.Tensor):
            words = v.detach().reshape(-1).view(ints[v.element_size()])
            out[prefix + k] = int(words.sum(dtype=torch.int64))
    return out


def _train_state(params, opt) -> dict:
    """Phase 5's run state as one tree: the params and AdamW's moments
    and step counts, keyed by the params' leaf names."""
    from ray_tpu_torch.models import llama

    leaves = llama.param_leaves(params)
    st = opt.state
    return {"params": {n: p.detach() for n, p in leaves},
            "exp_avg": {n: st[p]["exp_avg"] for n, p in leaves},
            "exp_avg_sq": {n: st[p]["exp_avg_sq"] for n, p in leaves},
            "adam_step": {n: st[p]["step"] for n, p in leaves}}


def _tree_bytes(tree) -> int:
    return sum(_tree_bytes(v) if isinstance(v, dict) else
               v.numel() * v.element_size() for v in tree.values()
               if isinstance(v, (dict, torch.Tensor)))


def _nested(flat: dict) -> dict:
    """``{"layers.wq": t}`` -> ``{"layers": {"wq": t}}``."""
    tree: dict = {}
    for name, leaf in flat.items():
        *head, last = name.split(".")
        node = tree
        for k in head:
            node = node.setdefault(k, {})
        node[last] = leaf
    return tree


def _empty_like_tree(tree, dev) -> dict:
    return {k: _empty_like_tree(v, dev) if isinstance(v, dict) else
            (torch.empty(v[0], dtype=v[1], device=v[2] if v[2] == "cpu"
                         else dev) if isinstance(v, tuple) else None)
            for k, v in tree.items()}


def _tree_meta(tree) -> dict:
    """(shape, dtype, device type) of every tensor leaf; other leaves as
    they are."""
    return {k: _tree_meta(v) if isinstance(v, dict) else
            ((tuple(v.shape), v.dtype, v.device.type)
             if isinstance(v, torch.Tensor) else v)
            for k, v in tree.items()}


def checkpoint_phase(dev) -> dict:
    """13(a) and (b): phase 5's run (``profile_train.build_train_run``,
    5 AdamW steps) is saved with ``train.dist_checkpoint.save`` (params
    and AdamW state, or the params alone when the temporary directory
    cannot hold both), freed, and restored into fresh tensors on the
    card: every leaf's checksum and the step-6 loss must be those from
    before the save, bit for bit. Then ``TorchPredictor.from_checkpoint``
    over the same checkpoint (the params restored onto the card) runs
    ``llama.forward`` on 8 x 512 tokens: its argmax equals the in-memory
    forward's, through the wgmma flash forward. Returns the launches."""
    import shutil
    import tempfile

    from ray_tpu_torch.models import llama
    from ray_tpu_torch.tools import profile_train as run
    from ray_tpu_torch.train import dist_checkpoint as dc
    from ray_tpu_torch.train.predictor import TorchPredictor

    gc.collect()
    torch.cuda.empty_cache()
    counters_reset()
    cfg, params, opt, toks = run.build_train_run(dev)
    for _ in range(5):
        run.train_step(cfg, params, opt, toks)
    opt.zero_grad(set_to_none=True)
    batch = torch.from_numpy(np.random.default_rng(13).integers(
        0, cfg.vocab_size, (8, 512))).to(dev)
    with torch.no_grad():
        loss6 = llama.loss_fn(cfg, params, {"tokens": toks}).item()
        want_argmax = llama.forward(cfg, params, batch).argmax(-1)
    state = _train_state(params, opt)
    state["step"] = 5
    sums = _leaf_sums(state)
    meta = _tree_meta(state)
    state_bytes = _tree_bytes(state)
    param_bytes = _tree_bytes(state["params"])
    tmp = tempfile.mkdtemp(prefix="rtpu_ckpt_")
    free = shutil.disk_usage(tmp).free
    whole = free > 1.1 * state_bytes + (1 << 30)
    print(f"  checkpoint directory {tmp}: {free / 1e9:.1f} GB free; the "
          f"state (params and AdamW) is {state_bytes / 1e9:.2f} GB, the "
          f"params {param_bytes / 1e9:.2f} GB: saving "
          f"{'both' if whole else 'the params alone'}", flush=True)
    check(whole or free > 1.1 * param_bytes + (1 << 30),
          "the temporary directory cannot hold the params")
    if not whole:
        state = {"params": state["params"], "step": 5}
        meta = _tree_meta(state)
        sums = {k: v for k, v in sums.items() if k.startswith("params.")}
    path = os.path.join(tmp, "ck")
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dc.save(path, state)
        save_s = time.perf_counter() - t0
        size = sum(os.path.getsize(os.path.join(path, f))
                   for f in os.listdir(path))
        del state, params, opt
        gc.collect()
        torch.cuda.empty_cache()
        like = _empty_like_tree(meta, dev)
        like["step"] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        back = dc.restore(path, like=like)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        got = _leaf_sums(back)
        bad = [k for k in sums if got.get(k) != sums[k]]
        check(not bad and set(got) == set(sums),
              f"restored checksums differ on {len(bad)} leaves: {bad[:4]}")
        check(back["step"] == 5, f"restored step {back['step']!r}")
        restored = _nested(back["params"])
        with torch.no_grad():
            loss6_back = llama.loss_fn(cfg, restored,
                                       {"tokens": toks}).item()
        print(f"  saved {size / 1e9:.2f} GB in {save_s:.2f} s "
              f"({size / 1e9 / save_s:.2f} GB/s), restored in "
              f"{restore_s:.2f} s ({size / 1e9 / restore_s:.2f} GB/s) to "
              f"the card; {len(got)} leaf checksums equal; step-6 loss "
              f"{loss6_back!r} from the restore, {loss6!r} before the save",
              flush=True)
        check(loss6_back == loss6, "the step-6 loss from the restored state "
              "differs from the one before the save")
        del back, like, restored
        gc.collect()
        torch.cuda.empty_cache()
        # (b) the predictor over the same checkpoint
        pmeta = {"params": meta["params"]}

        def load_params(p):
            return _nested(dc.restore(
                p, like=_empty_like_tree(pmeta, dev))["params"])

        pred = TorchPredictor.from_checkpoint(
            path, lambda p, x: llama.forward(cfg, p, x),
            load_params=load_params, device=dev)
        host = {"data": batch.cpu().numpy()}
        pred.predict(host)   # warm-up
        before = counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = pred.predict(host)
        predict_s = time.perf_counter() - t0
        c = counters()
        fwd = c["fwd"] - before["fwd"]
        fwd_sm90 = c["fwd_sm90"] - before["fwd_sm90"]
        same = bool(np.array_equal(out["predictions"].argmax(-1),
                                   want_argmax.cpu().numpy()))
        print(f"  TorchPredictor over the checkpoint: 8 x 512 tokens in "
              f"{predict_s * 1e3:.1f} ms (logits to host numpy included); "
              f"argmax equal to the in-memory forward's: {same}; flash "
              f"forward launches {fwd} (wgmma {fwd_sm90})", flush=True)
        check(same, "the predictor's argmax differs from the in-memory "
              "forward's")
        check(fwd == cfg.num_layers and fwd_sm90 == fwd,
              f"predict launched the flash forward {fwd} times, {fwd_sm90} "
              f"on the wgmma route; want {cfg.num_layers}, all wgmma")
        del pred, out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    c = counters()
    check(c["fwd_sm90"] == c["fwd"] and c["dq_sm90"] == c["dq"]
          and c["dkv_sm90"] == c["dkv"], f"phase 13 launches off the wgmma "
          f"route: {c}")
    return {"flash_attention_fwd": c["fwd"],
            "flash_attention_bwd_dq": c["dq"],
            "flash_attention_bwd_dkv": c["dkv"]}


def tp_disagg_phase(dev, phase9a: dict, phase9b: dict) -> dict:
    """13(c): at world size 1 over NCCL, phase 9's disaggregated engine
    (2 workers, divert floor 128) with ``mesh={tp 1}``: in fp32 at 2
    layers it gives phase 9(a)'s paged tokens for 8/8 requests, every
    prompt of 128 tokens or more handed off, no page leaked; in bf16 at
    32 layers (phase 3's weights and requests) TTFT and ITL beside
    9(b)'s, and how many transcripts equal 9(b)'s (printed: bf16
    disaggregated transcripts differ between runs, the two workers
    racing for q7 among the causes). Then q1's pages exported from one
    ``mesh={tp 1}`` bf16 paged engine and imported into another, where
    q7 hits them (128 tokens) and decodes the exporter's q7 tokens.
    Returns the paged launches."""
    import tempfile
    from dataclasses import replace

    import torch.distributed as dist

    from ray_tpu_torch.models import llama
    from ray_tpu_torch.parallel import MeshSpec, build_mesh
    from ray_tpu_torch.parallel import init_process_group
    from ray_tpu_torch.serve.disagg import DisaggPagedEngine
    from ray_tpu_torch.serve.paged_engine import PagedLLMEngine

    paged = 0
    with tempfile.TemporaryDirectory() as store:
        init_process_group(0, 1, dev, store_path=os.path.join(store, "pg"))
        try:
            mesh = build_mesh(MeshSpec({"tp": 1}))
            dkw = dict(prefill_workers=2, divert_min_tokens=128,
                       handoff_timeout_s=CLEAN_LEASE_S, device=dev,
                       mesh=mesh, page_size=64)
            cfg = replace(llama.LlamaConfig.llama3_8b(), num_layers=2,
                          dtype=torch.float32, param_dtype=torch.float32)
            params = llama.init_params(cfg, seed=0, device=dev)
            first, last = serve_8b_requests(cfg.vocab_size)
            n_div = sum(len(p) >= 128 for _, p in first + last)
            counters_reset()
            eng = DisaggPagedEngine(**dict(SERVE_8B, **dkw,
                                           model_config=_model_config(cfg),
                                           params=params))
            out = drain(eng, first, 120)
            out.update(drain(eng, last, 120))
            st = eng.stats()
            _stop_disagg(eng)
            _check_disagg(st, n_div, "fp32 disagg mesh={tp 1}")
            _check_pool(eng, "fp32 disagg mesh={tp 1}")
            del eng, params
            paged += counters()["paged"]
            equal = sum(out[r]["tokens"] == phase9a[r] for r in phase9a)
            print(f"  fp32 2-layer disagg mesh={{tp 1}}: tokens equal phase "
                  f"9(a)'s paged engine's for {equal}/{len(phase9a)} "
                  f"requests; diverted {st['disagg_diverted']}, handoffs "
                  f"{st['disagg_handoffs']}", flush=True)
            check(equal == len(phase9a), "fp32 disagg mesh={tp 1}: tokens "
                  "differ from phase 9(a)'s paged engine's")
            gc.collect()
            torch.cuda.empty_cache()
            cfg = llama.LlamaConfig.llama3_8b(dtype=torch.bfloat16,
                                              param_dtype=torch.bfloat16)
            params = llama.init_params(cfg, seed=0, device=dev)
            kw = dict(SERVE_8B, params=params, device=dev, mesh=mesh,
                      page_size=64)
            counters_reset()
            eng = DisaggPagedEngine(params=params, **dict(SERVE_8B, **dkw))
            out = drain(eng, first, 300)
            out.update(drain(eng, last, 120))
            st = eng.stats()
            _stop_disagg(eng)
            _check_disagg(st, n_div, "8B bf16 disagg mesh={tp 1}")
            _check_pool(eng, "8B bf16 disagg mesh={tp 1}")
            del eng
            c = counters()
            check(c["paged"] > 0 and c["paged_merge"] == c["paged"],
                  f"disagg mesh={{tp 1}}: paged launches {c}")
            check(all(len(r["tokens"]) == 32 for r in out.values()),
                  "disagg mesh={tp 1}: a request got fewer than 32 tokens")
            paged += c["paged"]
            want = phase9b["disagg"]
            equal = sum(out[r]["tokens"] == want["tokens"][r] for r in out)
            lat, ref = _latency_ms(out), want["latency_ms"]
            print(f"  8B bf16 disagg mesh={{tp 1}}: tokens equal phase "
                  f"9(b)'s disaggregated ones for {equal}/8 requests "
                  f"(printed, not required in bf16; staging-cache reuse "
                  f"{st['disagg_staging_hit_tokens']} tokens, 9(b) "
                  f"{want['staging_hit']}); TTFT p50/p99 "
                  f"{lat['ttft_p50']:.2f}/{lat['ttft_p99']:.2f} ms (9(b) "
                  f"{ref['ttft_p50']:.2f}/{ref['ttft_p99']:.2f}), ITL "
                  f"p50/p99 {lat['itl_p50']:.3f}/{lat['itl_p99']:.3f} ms "
                  f"(9(b) {ref['itl_p50']:.3f}/{ref['itl_p99']:.3f}); "
                  f"paged launches {c['paged']}", flush=True)
            # export from one mesh={tp 1} engine, import into another
            counters_reset()
            src = PagedLLMEngine(**kw)
            drain(src, first[1:2], 120)
            alloc = src._alloc
            q1 = first[1][1]
            pages, hashes, _ = alloc.match_prefix(q1, len(q1))
            k, v = src.export_pages(pages)
            for pg in pages:
                alloc.release(pg)
            want_q7 = drain(src, last, 120)["q7"]["tokens"]
            hit_src = src._prefix_hit_tokens
            stop(src)
            dst = PagedLLMEngine(**kw)
            n_imp = dst.import_pages(k, v, hashes)
            got_q7 = drain(dst, last, 120)["q7"]["tokens"]
            hit_dst = dst._prefix_hit_tokens
            stop(dst)
            _check_pool(dst, "import mesh={tp 1}")
            c = counters()
            paged += c["paged"]
            print(f"  export/import mesh={{tp 1}}: {len(pages)} pages of q1 "
                  f"({tuple(k.shape)} each of k, v) imported {n_imp}; q7's "
                  f"prefix hit {hit_dst} tokens (exporter {hit_src}); tokens "
                  f"equal the exporter's: {got_q7 == want_q7}", flush=True)
            check(n_imp == len(pages) == 2 and hit_dst == hit_src == 128,
                  "export/import mesh={tp 1}: no prefix hit")
            check(got_q7 == want_q7, "export/import mesh={tp 1}: q7's tokens "
                  "differ from the exporter's")
        finally:
            dist.destroy_process_group()
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return {"paged_attention": paged}


def _detached(params) -> dict:
    return {k: _detached(v) if isinstance(v, dict) else v.detach()
            for k, v in params.items()}


def main() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import ray_tpu_torch.ops._build  # noqa: F401  (the package is here)
    except ImportError as e:
        print(f"chip_smoke: ray_tpu_torch not found beside the script: {e}",
              file=sys.stderr)
        sys.exit(2)
    logging.basicConfig(level=logging.WARNING)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    print(f"phase 0: card {smi_line()}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    build_phase()

    ctx_main = [m + 16 for m in SERVE_8B_LENS]  # mid-decode history
    print("phase 1: kernels against their plain versions", flush=True)
    kernels = flash_phase(dev)
    kernels.append(paged_phase(dev, ctx_main))
    kernels += flash_bwd_phase(dev)
    kernels += paged_families_phase(dev, ctx_main)
    kernels += flash_d256_phase(dev)
    flash_small_d_phase(dev)
    flash_tf32x3_phase(dev)
    print("phase 2: fp32 full width, 2 layers, dense vs paged: Llama-3-8B, "
          "Qwen2-7B, Gemma-7B", flush=True)
    from ray_tpu_torch.models.llama import LlamaConfig

    llama_fp32_fwd = fp32_phase(dev, LlamaConfig.llama3_8b(), "Llama-3-8B")
    for model in ("Qwen2-7B", "Gemma-7B"):
        fp32_phase(dev, published_config(model), model)
        gc.collect()
        torch.cuda.empty_cache()
    print("phase 3: Llama-3-8B bf16, 32 layers, dense then paged",
          flush=True)
    launches, phase3 = serve_8b_phase(dev)
    gc.collect()
    torch.cuda.empty_cache()
    print("phase 4: fp32 full width, 2 layers, gradients through the "
          "kernels: Llama-3-8B (head dim 128), then Gemma-7B (head dim "
          "256)", flush=True)
    llama_fp32 = grad_phase(dev, LlamaConfig.llama3_8b())
    gc.collect()
    torch.cuda.empty_cache()
    gemma_fp32 = grad_phase(dev, published_config("Gemma-7B"))
    gc.collect()
    torch.cuda.empty_cache()
    print("phase 5: training, Llama-3-8B width, 8 layers, 5 AdamW steps",
          flush=True)
    train = train_phase(dev)
    print("phase 6: Qwen2-7B and Gemma-7B bf16, full width, dense then "
          "paged", flush=True)
    qwen2 = serve_family_phase(dev, "Qwen2-7B")
    gemma = serve_family_phase(dev, "Gemma-7B")
    print("phase 7: training GPT-2 125M, Mixtral-8x7B width and Gemma-7B "
          "width", flush=True)
    families = train_families_phase(dev)
    print("phase 8: the tiny presets (head dim 16) on the card", flush=True)
    tiny_phase(dev)
    print("phase 9: disaggregated prefill/decode and the decode API: "
          "Llama-3-8B fp32 2 layers, then bf16 32 layers", flush=True)
    disagg_fp32 = disagg_fp32_phase(dev)
    disagg = disagg_serve_phase(dev)
    decode_api_phase(dev)
    print("phase 10: the RL learners, card against CPU", flush=True)
    rl_phase(dev)
    print("phase 11: the parallel layer at world size 1 over NCCL: "
          "Llama-3-8B width (Ulysses, ring, pp 1), Mixtral-8x7B width "
          "{dp 1, ep 1}", flush=True)
    sharded = mesh_phase(dev)
    print("phase 12: tensor-parallel serving at world size 1 over NCCL: "
          "Llama-3-8B bf16, both engines with mesh={tp 1}", flush=True)
    tp_serve = tp_serve_phase(dev, phase3)
    print("phase 13: sharded checkpoints and the predictor (Llama-3-8B "
          "width, 8 layers), then the disaggregated engine and page "
          "export/import with mesh={tp 1}", flush=True)
    ckpt = checkpoint_phase(dev)
    tp_disagg = tp_disagg_phase(dev, disagg_fp32, disagg)
    # the serving kernels' counts come from phases 3 and 6, the backward
    # kernels' from phase 5 (wgmma, d 128) and phase 7's Gemma run (the
    # wgmma dQ and dK/dV at d 256), the fp32 rows' from phase 2's Llama
    # dense engine (the d-128 3xTF32 forward) and phase 4's Llama (the
    # d-128 3xTF32 dQ and dK/dV) and Gemma (d 256) runs; the
    # forward's training counts are printed in 5 and 7
    gemma_train = families["gemma"]
    launches.update(flash_attention_bwd_dq=train["flash_attention_bwd_dq"],
                    flash_attention_bwd_dkv=train["flash_attention_bwd_dkv"],
                    flash_attention_fwd_tf32x3_d128=llama_fp32_fwd,
                    flash_attention_bwd_dq_tf32x3_d128=llama_fp32[
                        "dq_tf32x3"],
                    flash_attention_bwd_dkv_tf32x3_d128=llama_fp32["dkv"],
                    flash_attention_fwd_sm90_d256=gemma["fwd"],
                    flash_attention_fwd_tf32x3_d256=gemma_fp32["fwd"],
                    paged_attention_gm8_hd128=qwen2["paged"],
                    paged_attention_gm1_hd256=gemma["paged"],
                    flash_attention_bwd_dq_sm90_d256=gemma_train["dq_sm90"],
                    flash_attention_bwd_dq_tf32x3_d256=gemma_fp32[
                        "dq_tf32x3"],
                    flash_attention_bwd_dkv_tf32x3_d256=gemma_fp32["dkv"],
                    flash_attention_bwd_dkv_sm90_d256=gemma_train[
                        "dkv_sm90"])
    # phase 11's sharded runs launch the d-128 wgmma flash kernels too
    for name, key in (("flash_attention_fwd", "fwd_sm90"),
                      ("flash_attention_bwd_dq", "dq_sm90"),
                      ("flash_attention_bwd_dkv", "dkv_sm90")):
        launches[name] += sharded[key]
    # and phase 12's engines the serving kernels, phase 13 the training
    # kernels (its run, its losses, the predictor) and the paged kernel
    for part in (tp_serve, ckpt, tp_disagg):
        for name, n in part.items():
            launches[name] += n
    for rec in kernels:
        rec["launches"] = launches[rec["name"]]
    order = ("name", "route", "source", "replaces", "launches",
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms")
    table = [{k: rec[k] for k in order} for rec in kernels]
    print(f"all phases passed in {time.perf_counter() - t_start:.1f} s",
          flush=True)
    print(smi_line(), flush=True)
    print(json.dumps({"kernels": table}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
