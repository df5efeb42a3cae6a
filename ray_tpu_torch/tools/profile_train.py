"""Where the time of one training step goes, on the card.

    python -m ray_tpu_torch.tools.profile_train [--model gemma_7b]

Builds a training run that ``chip_smoke.py`` also takes
(``build_train_run``; ``train_config`` gives its config): by default
(``llama3_8b``, phase 5) Llama-3-8B width with 8 layers, batch 4 x seq
2048; ``gemma_7b`` (phase 7's Gemma run) google/gemma-7b's published
width (hidden 3072, ffn 24576, 16/16 heads, head dim 256, vocab 256000,
GeGLU, sqrt(hidden) embed scale, tied embedding) with 4 layers, batch 2
x seq 2048. Both: fp32 params, bf16 compute, full remat, random weights
from seed 0 and random tokens from numpy seed 0, and
``torch.optim.AdamW(lr=3e-4, weight_decay=0.01)``. A step
(``train_step``) is ``loss_fn`` -> ``backward`` -> ``AdamW.step``.
Depth is cut for memory alone: 32 (28) layers at 16 B a param (fp32
params, grads and two moments) would not fit in 80 GB. After two warm-up
steps it prints the host wall time of a step (median of 3 unprofiled
steps), the device busy time from one ``torch.profiler`` step (sum of
kernel times; one stream, so kernels do not overlap), the device idle
share, the kernels that take the most device time, and the shares of:
the flash forward, dQ and dK/dV kernels (any route); the LM head's fp32
GEMMs (matrix products with the vocabulary in an input's shape, forward
and backward); and the fp32 copies around them in ``llama._final_head``
(copies with the vocabulary in an input's shape). Needs one card;
imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import math
import re
import time
from collections import defaultdict

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from ray_tpu_torch.models import llama

# (layers, batch, seq) of each run
RUNS = {"llama3_8b": (8, 4, 2048), "gemma_7b": (4, 2, 2048)}
LAYERS, BATCH, SEQ = RUNS["llama3_8b"]

# the attention kernels, by name prefix (the wgmma and scalar routes; the
# breakdown names the kernels each prefix matched)
_KERNELS = {"flash forward (kernel 1)": "flash_fwd",
            "flash dQ (kernel 3)": "flash_bwd_dq",
            "flash dK/dV (kernel 4)": "flash_bwd_dkv"}


def train_config(model: str = "llama3_8b") -> llama.LlamaConfig:
    """The config of a ``RUNS`` entry: fp32 params, bf16 compute, full
    remat (the ``LlamaConfig`` defaults)."""
    layers = RUNS[model][0]
    if model == "llama3_8b":
        return llama.LlamaConfig.llama3_8b(num_layers=layers)
    # google/gemma-7b's config.json, as llama_config_from_hf and
    # gemma_from_hf read it
    return llama.LlamaConfig(
        vocab_size=256_000, hidden_size=3072, intermediate_size=24_576,
        num_layers=layers, num_heads=16, num_kv_heads=16, head_dim=256,
        max_seq_len=8192, rope_theta=10_000.0, rms_norm_eps=1e-6,
        tie_embeddings=True, mlp_act="gelu_tanh",
        embed_scale=math.sqrt(3072))


def _kernel_times(prof) -> dict:
    """Device microseconds per kernel name. Ranges that annotate the
    device timeline (``Optimizer.step#AdamW.step``) are left out: the
    kernels inside them are counted already."""
    out = defaultdict(float)
    for evt in prof.events():
        if (evt.device_type == torch.autograd.DeviceType.CUDA
                and not evt.is_user_annotation):
            out[evt.name] += evt.time_range.elapsed_us()
    return out


def _vocab_op_us(prof, names, vocab: int) -> float:
    """Device microseconds of the ops in ``names`` that have ``vocab`` in
    an input's shape."""
    total = 0.0
    for evt in prof.key_averages(group_by_input_shape=True):
        if evt.key in names and any(
                isinstance(s, (list, tuple)) and vocab in s
                for s in evt.input_shapes):
            total += evt.device_time_total
    return total


def build_train_run(device=None, model: str = "llama3_8b", cfg=None,
                    batch: int = None, seq: int = None):
    """(cfg, params, optimizer, tokens) of a ``RUNS`` entry: the params
    require grad and the optimizer holds them; tokens are
    ``[batch, seq + 1]``. ``cfg``, ``batch`` and ``seq`` replace the
    entry's (a rehearsal on the CPU passes small ones)."""
    dev = llama.resolve_device(device)
    _, run_batch, run_seq = RUNS[model]
    batch, seq = batch or run_batch, seq or run_seq
    cfg = cfg or train_config(model)
    params = llama.init_params(cfg, seed=0, device=dev)
    leaves = [p.requires_grad_() for _, p in llama.param_leaves(params)]
    opt = torch.optim.AdamW(leaves, lr=3e-4, weight_decay=0.01)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (batch, seq + 1))).to(dev)
    return cfg, params, opt, toks


def train_step(cfg, params, opt, toks, reduce_grads=None) -> torch.Tensor:
    """One step: ``loss_fn`` -> ``backward`` -> ``reduce_grads(opt)``
    when given (a data-parallel gang averages the gradients there) ->
    ``opt.step()``. Returns the loss (not synchronised)."""
    opt.zero_grad(set_to_none=True)
    loss = llama.loss_fn(cfg, params, {"tokens": toks})
    loss.backward()
    if reduce_grads is not None:
        reduce_grads(opt)
    opt.step()
    return loss


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", choices=sorted(RUNS), default="llama3_8b")
    model = ap.parse_args().model
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, params, opt, toks = build_train_run(model=model)
    layers, batch, seq = RUNS[model]
    print(f"{model} width, {layers} layers, batch {batch} x seq {seq}, "
          f"fp32 params, bf16 compute, full remat, AdamW; "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    def step():
        train_step(cfg, params, opt, toks)
        torch.cuda.synchronize()

    for _ in range(2):
        step()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        step()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall = sorted(walls)[1]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        step()
    kt = _kernel_times(prof)
    if not kt:
        print(f"train step: wall {wall:.3f} ms; the profiler recorded no "
              "device time (device busy: not measured)", flush=True)
        return
    busy = sum(kt.values()) / 1e3
    print(f"train step: wall {wall:.3f} ms (median of 3), device busy "
          f"{busy:.3f} ms, idle share {1 - busy / wall:.3f}", flush=True)
    print("top device items:", flush=True)
    for k, us in sorted(kt.items(), key=lambda kv: -kv[1])[:12]:
        print(f"  {us / 1e3:10.3f} ms  {100 * us / 1e3 / busy:5.1f}%  "
              f"{k[:100]}", flush=True)
    print("shares of device busy time:", flush=True)
    for label, key in _KERNELS.items():
        hits = {name: t for name, t in kt.items() if key in name}
        us = sum(hits.values())
        # which kernel ran, by route: e.g. flash_bwd_dq_sm90_d256_kernel
        ran = sorted({re.search(r"flash_\w+", n).group() for n in hits})
        print(f"  {us / 1e3:10.3f} ms  {100 * us / 1e3 / busy:5.1f}%  "
              f"{label}: {', '.join(ran) or 'none'}", flush=True)
    for label, names in (("LM-head fp32 GEMMs (fwd + bwd)",
                          ("aten::mm", "aten::addmm", "aten::bmm")),
                         ("fp32 copies of _final_head", ("aten::copy_",))):
        us = _vocab_op_us(prof, names, cfg.vocab_size)
        print(f"  {us / 1e3:10.3f} ms  {100 * us / 1e3 / busy:5.1f}%  "
              f"{label}", flush=True)


if __name__ == "__main__":
    main()
