"""Where the time of one training step goes, on the card.

    python -m ray_tpu_torch.tools.profile_train

Builds the training run that ``chip_smoke.py`` phase 5 also takes
(``build_train_run``): Llama-3-8B width with 8 layers, fp32 params,
bf16 compute, full remat, batch 4 x seq 2048, random weights from seed
0 and random tokens from numpy seed 0, and
``torch.optim.AdamW(lr=3e-4, weight_decay=0.01)``. A step
(``train_step``) is ``loss_fn`` -> ``backward`` -> ``AdamW.step``.
Depth is cut for memory alone: 32 layers at 16 B a param (fp32 params,
grads and two moments) would not fit in 80 GB. After two warm-up steps it
prints the host wall time of a step (median of 3 unprofiled steps), the
device busy time from one ``torch.profiler`` step (sum of kernel times;
one stream, so kernels do not overlap), the device idle share, the
kernels that take the most device time, and the shares of: the flash
forward, dQ and dK/dV kernels; the LM head's fp32 GEMMs (matrix
products with the vocabulary in an input's shape, forward and
backward); and the fp32 copies around them in ``llama._final_head``
(copies with the vocabulary in an input's shape). Needs one card;
imports nothing of JAX.
"""

from __future__ import annotations

import time
from collections import defaultdict

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from ray_tpu_torch.models import llama

LAYERS, BATCH, SEQ = 8, 4, 2048

# the bf16 step's attention kernels, all on the wgmma route
_KERNELS = {"flash forward (kernel 1)": "flash_fwd_sm90_kernel",
            "flash dQ (kernel 3)": "flash_bwd_dq_sm90_kernel",
            "flash dK/dV (kernel 4)": "flash_bwd_dkv_sm90_kernel"}


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


def build_train_run(device=None):
    """(cfg, params, optimizer, tokens) of the training run: the params
    require grad and the optimizer holds them; tokens are
    ``[BATCH, SEQ + 1]``."""
    dev = llama.resolve_device(device)
    cfg = llama.LlamaConfig.llama3_8b(num_layers=LAYERS)
    params = llama.init_params(cfg, seed=0, device=dev)
    leaves = [p.requires_grad_() for _, p in llama.param_leaves(params)]
    opt = torch.optim.AdamW(leaves, lr=3e-4, weight_decay=0.01)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (BATCH, SEQ + 1))).to(dev)
    return cfg, params, opt, toks


def train_step(cfg, params, opt, toks) -> torch.Tensor:
    """One step: ``loss_fn`` -> ``backward`` -> ``opt.step()``. Returns
    the loss (not synchronised)."""
    opt.zero_grad(set_to_none=True)
    loss = llama.loss_fn(cfg, params, {"tokens": toks})
    loss.backward()
    opt.step()
    return loss


def main() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, params, opt, toks = build_train_run()
    print(f"Llama-3-8B width, {LAYERS} layers, batch {BATCH} x "
          f"seq {SEQ}, fp32 params, bf16 compute, full remat, AdamW; "
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
        us = sum(t for name, t in kt.items() if key in name)
        print(f"  {us / 1e3:10.3f} ms  {100 * us / 1e3 / busy:5.1f}%  "
              f"{label}", flush=True)
    for label, names in (("LM-head fp32 GEMMs (fwd + bwd)",
                          ("aten::mm", "aten::addmm", "aten::bmm")),
                         ("fp32 copies of _final_head", ("aten::copy_",))):
        us = _vocab_op_us(prof, names, cfg.vocab_size)
        print(f"  {us / 1e3:10.3f} ms  {100 * us / 1e3 / busy:5.1f}%  "
              f"{label}", flush=True)


if __name__ == "__main__":
    main()
