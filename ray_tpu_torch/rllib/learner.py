"""PPO learner, and the pieces every learner of the port shares.

Counterpart of ``ray_tpu/rllib/learner.py``. The reference runs a whole
PPO epoch set as one jitted ``lax.scan``; here each minibatch is an
eager step on the learner's device (the card unless the caller passes
``"cpu"``), and the metrics reach the host once, at the end of the
update.

Shared by the learners (``impala``, ``appo``, ``dqn``, ``sac``,
``offline``):

- ``batch_to_device``: numpy batches in, tensors on the device (floats
  as float32, booleans as float32 masks, integers as int64 indices), as
  the reference's ``jnp.asarray`` gives them to its losses;
- ``clip_by_global_norm_``: optax's clip, ``g * max_norm / max(|g|,
  max_norm)`` over all leaves (not ``clip_grad_norm_``, which divides by
  ``|g| + 1e-6``);
- ``Adam``: ``torch.optim.Adam`` with ``eps=1e-8``, which computes what
  ``optax.adam`` computes;
- ``apply_grads``: one optimizer step from a loss. Every learner has a
  ``grad_hook`` attribute (None by default); when set it is called as
  ``grad_hook(kind, grads)`` after the gradients are taken and before
  they are clipped and applied, ``grads`` in the reference's tree
  layout as numpy, so a test can hold them to ``jax.grad``.
"""

from __future__ import annotations

import copy
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch.rllib.rl_module import (params_from_numpy, resolve_device,
                                           to_numpy)


def batch_to_device(batch: Dict[str, np.ndarray], device
                    ) -> Dict[str, torch.Tensor]:
    out = {}
    for k, v in batch.items():
        if k == "_indices":   # replay-buffer bookkeeping, not data
            continue
        a = np.asarray(v)
        if a.dtype.kind == "b" or a.dtype.kind == "f":
            t = torch.as_tensor(a.astype(np.float32, copy=False))
        else:
            t = torch.as_tensor(a.astype(np.int64, copy=False))
        out[k] = t.to(device)
    return out


def Adam(params, lr: float) -> torch.optim.Adam:
    return torch.optim.Adam(params, lr=lr, eps=1e-8)


@torch.no_grad()
def clip_by_global_norm_(params, max_norm: float) -> None:
    grads = [p.grad for p in params]
    norm = torch.sqrt(sum(g.square().sum() for g in grads))
    scale = max_norm / torch.clamp(norm, min=max_norm)
    for g in grads:
        g.mul_(scale)


def apply_grads(opt: torch.optim.Optimizer, params: list, loss: torch.Tensor,
                hook: Optional[Callable] = None, kind: str = "params",
                tree: Optional[Callable] = None,
                max_norm: Optional[float] = None) -> None:
    """Gradients of ``loss`` with respect to ``params`` only (a loss
    that runs through another network leaves that one's grads alone),
    then ``hook(kind, tree())``, the optional clip, and the step."""
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    for p, g in zip(params, grads):
        # a head the loss does not reach (BC's value head) gets zeros,
        # as jax.grad gives it
        p.grad = torch.zeros_like(p) if g is None else g
    if hook is not None:
        hook(kind, tree())
    if max_norm is not None:
        clip_by_global_norm_(params, max_norm)
    opt.step()


@torch.no_grad()
def polyak_(target: torch.nn.Module, online: torch.nn.Module,
            tau: float) -> None:
    """target <- target + tau * (online - target), leaf by leaf."""
    for t, p in zip(target.parameters(), online.parameters()):
        t.add_(tau * (p - t))


def frozen_copy(module: torch.nn.Module) -> torch.nn.Module:
    return copy.deepcopy(module).requires_grad_(False)


def select_logp(logp_all: torch.Tensor, actions: torch.Tensor
                ) -> torch.Tensor:
    return logp_all.gather(-1, actions[..., None])[..., 0]


def entropy(logp_all: torch.Tensor) -> torch.Tensor:
    return -(logp_all.exp() * logp_all).sum(-1).mean()


class PPOLearner:
    """Clipped-surrogate PPO: ``num_epochs`` passes of minibatch SGD
    over each batch, minibatches drawn by a permutation from the
    learner's generator, ``clip_by_global_norm`` then Adam.

    Beyond the reference's knobs: ``device`` (default the card),
    ``params`` (a reference-layout numpy tree to start from instead of
    the seeded draw)."""

    def __init__(self, module, lr: float = 3e-4, clip: float = 0.2,
                 vf_coef: float = 0.5, ent_coef: float = 0.01,
                 num_epochs: int = 10, minibatch_size: int = 256,
                 max_grad_norm: float = 0.5, seed: int = 0, device=None,
                 params=None):
        self.device = resolve_device(device)
        self.module = module.init_params(seed, self.device)
        if params is not None:
            params_from_numpy(self.module, params)
        self.opt = Adam(self.module.parameters(), lr)
        self._clip = clip
        self._vf_coef = vf_coef
        self._ent_coef = ent_coef
        self._num_epochs = num_epochs
        self._mb = minibatch_size
        self._max_grad_norm = max_grad_norm
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed + 1)
        self.grad_hook = None

    def _loss(self, batch):
        logits, value = self.module(batch["obs"])
        logp_all = F.log_softmax(logits, dim=-1)
        logp = select_logp(logp_all, batch["actions"])
        ratio = torch.exp(logp - batch["logp_old"])
        adv = batch["advantages"]
        pg = -torch.minimum(
            ratio * adv,
            torch.clamp(ratio, 1 - self._clip, 1 + self._clip) * adv).mean()
        vf = 0.5 * (value - batch["returns"]).square().mean()
        ent = entropy(logp_all)
        loss = pg + self._vf_coef * vf - self._ent_coef * ent
        return loss, {"pg_loss": pg, "vf_loss": vf, "entropy": ent}

    def update(self, batch: Dict[str, np.ndarray],
               perms: Optional[np.ndarray] = None) -> Dict[str, float]:
        """One training round: ``num_epochs`` passes of minibatch SGD.
        ``perms`` ([num_epochs, num_minibatches, minibatch_size] row
        indices) replaces the generator's permutations, so that two
        learners can be held to each other minibatch by minibatch."""
        b = batch_to_device(batch, self.device)
        n = b["obs"].shape[0]
        num_mb = n // self._mb
        if perms is None:
            perms = torch.stack([
                torch.randperm(n, generator=self._gen,
                               device=self.device)[: num_mb * self._mb]
                for _ in range(self._num_epochs)]).reshape(
                    self._num_epochs, num_mb, self._mb)
        else:
            perms = torch.as_tensor(np.asarray(perms, np.int64),
                                    device=self.device)
        params = list(self.module.parameters())
        aux = {}
        for epoch in perms:
            for idx in epoch:
                loss, aux = self._loss({k: v[idx] for k, v in b.items()})
                apply_grads(self.opt, params, loss, self.grad_hook,
                            "params", lambda: to_numpy(self.module, True),
                            self._max_grad_norm)
        return {k: float(v.detach()) for k, v in aux.items()}

    def get_weights(self):
        return to_numpy(self.module)
