"""Pipeline parallelism: the GPipe schedule as one SPMD program.

Counterpart of ``ray_tpu/parallel/pipeline.py``. The stacked layer dim
is split over the mesh's ``pp`` axis (each stage holds L/P layers), and
every stage runs the same M+P-1 ticks: stage 0 injects microbatch t,
every stage applies its layers to what it holds, the last stage keeps
its result as finished microbatch t-P+1, and the activations rotate one
stage on by a differentiable ``ring_permute``. ``loss.backward()``
through the schedule runs the reverse permutations, which is the GPipe
backward, as ``jax.grad`` through the reference's ``lax.scan`` is.

Every stage computes on every tick, bubbles included, and keeps every
tick in the graph as the reference's ``jnp.where`` does (the branch not
taken gets a zero gradient): PyTorch differentiates each rank's graph on
its own, so every stage's loss must reach every tick's permutation, or
a rank would skip a permutation's backward that its peer waits on. The
permutations' backwards then run on every stage in the same order.
Bubble fraction (P-1)/(M+P-1): pick num_microbatches >> pp.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from ray_tpu_torch.parallel.device_collectives import (axis_index,
                                                       axis_size,
                                                       ring_permute)


def pipeline_apply(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                   stage_params: Any, microbatches: torch.Tensor,
                   axis_name: str = "pp", *, mesh) -> torch.Tensor:
    """Run ``microbatches [M, ...]`` through a P-stage pipeline over
    ``axis_name`` of ``mesh``. ``stage_params`` is this stage's layer
    slice, ``microbatches`` the whole set (stage 0 reads it). Returns
    outputs [M, ...] valid on the LAST stage, zeros elsewhere (combine
    with a masked psum, or read them on the last stage).
    Differentiable end to end."""
    P = axis_size(axis_name, mesh=mesh)
    p = axis_index(axis_name, mesh=mesh)
    M = microbatches.shape[0]
    state = torch.zeros_like(microbatches[0])
    outs = [torch.zeros_like(microbatches[0])] * M
    last = p == P - 1
    for t in range(M + P - 1):
        mb = t - p                          # the microbatch this stage sees
        i = min(max(mb, 0), M - 1)
        # stage 0 injects fresh microbatches; later stages take what
        # their predecessor passed on
        x = _where(p == 0, microbatches[i], state)
        y = stage_fn(stage_params, x)
        # the last stage's result on an active tick is a finished
        # microbatch; bubble ticks write nowhere
        outs[i] = _where(last and 0 <= mb < M, y, outs[i])
        state = ring_permute(y, axis_name, 1, mesh=mesh)
    return torch.stack(outs)


def _where(cond: bool, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a if cond else b`` with both in the autograd graph."""
    return torch.where(torch.tensor(cond, device=a.device), a, b)
