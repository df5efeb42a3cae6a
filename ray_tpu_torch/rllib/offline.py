"""Offline RL learners: behaviour cloning, conservative Q-learning and
MARWIL.

Counterpart of the learners in ``ray_tpu/rllib/offline.py``. The
reference feeds them from a ``ray_tpu.data`` Dataset (``train_offline``)
and reads and writes sample batches as JSON lines and parquet; those
need the port's Data library and wait for it. Each ``update(batch)``
here takes a numpy batch, takes one Adam step on the learner's device
and returns the loss as a Python float.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch.rllib.dqn import double_q_target
from ray_tpu_torch.rllib.learner import (Adam, apply_grads, batch_to_device,
                                         frozen_copy, polyak_, select_logp)
from ray_tpu_torch.rllib.rl_module import (params_from_numpy, resolve_device,
                                           to_numpy)


class _OfflineLearner:
    """The module on its device, Adam, the gradient hook. ``device``
    and ``params`` as ``PPOLearner``'s."""

    def __init__(self, module, lr: float, seed: int, device, params):
        self.device = resolve_device(device)
        self.module = module.init_params(seed, self.device)
        if params is not None:
            params_from_numpy(self.module, params)
        self.opt = Adam(self.module.parameters(), lr)
        self.grad_hook = None

    def _apply(self, loss):
        apply_grads(self.opt, list(self.module.parameters()), loss,
                    self.grad_hook, "params",
                    lambda: to_numpy(self.module, True))

    def get_weights(self):
        return to_numpy(self.module)


class BCLearner(_OfflineLearner):
    """Behaviour cloning for discrete actions: maximize logp(a_data | s)."""

    def __init__(self, module, lr: float = 1e-3, seed: int = 0,
                 device=None, params=None):
        super().__init__(module, lr, seed, device, params)

    def _loss(self, mb):
        logits, _ = self.module(mb["obs"])
        return -select_logp(F.log_softmax(logits, dim=-1),
                            mb["actions"]).mean()

    def update(self, batch: Dict[str, np.ndarray]) -> float:
        loss = self._loss(batch_to_device(
            {k: batch[k] for k in ("obs", "actions")}, self.device))
        self._apply(loss)
        return float(loss.detach())


class CQLLearner(_OfflineLearner):
    """Discrete CQL(H): the double-DQN squared TD loss plus ``alpha_cql
    * (logsumexp_a Q(s, a) - Q(s, a_data))`` (Kumar et al. 2020), with a
    Polyak target."""

    def __init__(self, module, lr: float = 1e-3, gamma: float = 0.99,
                 tau: float = 0.01, alpha_cql: float = 1.0, seed: int = 0,
                 device=None, params=None):
        super().__init__(module, lr, seed, device, params)
        self.target = frozen_copy(self.module)
        self._gamma = gamma
        self._tau = tau
        self._alpha = alpha_cql

    def _loss(self, mb):
        q = self.module(mb["obs"])
        q_sa = q.gather(-1, mb["actions"][:, None])[:, 0]
        target = double_q_target(self.module, self.target, mb, self._gamma)
        td_loss = (q_sa - target).square().mean()
        conservative = (torch.logsumexp(q, dim=-1) - q_sa).mean()
        return td_loss + self._alpha * conservative

    def update(self, batch: Dict[str, np.ndarray]) -> float:
        loss = self._loss(batch_to_device(
            {k: batch[k] for k in ("obs", "actions", "rewards", "next_obs",
                                   "dones")}, self.device))
        self._apply(loss)
        polyak_(self.target, self.module, self._tau)
        return float(loss.detach())


class MARWILLearner(_OfflineLearner):
    """Monotonic Advantage Re-Weighted Imitation Learning (Wang et al.
    2018): cloning weighted by ``exp(beta * clip(adv / norm, -5, 5))``
    with ``adv = R - V(s)`` and a host-side running norm of the squared
    advantage; a value head regresses the returns."""

    def __init__(self, module, lr: float = 1e-3, beta: float = 1.0,
                 vf_coef: float = 1.0, seed: int = 0, device=None,
                 params=None):
        super().__init__(module, lr, seed, device, params)
        self._beta = beta
        self._vf_coef = vf_coef
        self._ma_adv_sq = 1.0

    def _loss(self, mb, adv_norm):
        logits, values = self.module(mb["obs"])
        logp_a = select_logp(F.log_softmax(logits, dim=-1), mb["actions"])
        adv = (mb["returns"] - values).detach()
        weight = torch.exp(self._beta * torch.clamp(adv / adv_norm,
                                                    -5.0, 5.0))
        pg_loss = -(weight * logp_a).mean()
        vf_loss = (values - mb["returns"]).square().mean()
        return pg_loss + self._vf_coef * vf_loss, adv.square().mean()

    def update(self, batch: Dict[str, np.ndarray]) -> float:
        adv_norm = torch.tensor(max(self._ma_adv_sq, 1e-8) ** 0.5,
                                dtype=torch.float32, device=self.device)
        loss, adv_sq = self._loss(batch_to_device(
            {k: batch[k] for k in ("obs", "actions", "returns")},
            self.device), adv_norm)
        self._apply(loss)
        self._ma_adv_sq = 0.99 * self._ma_adv_sq + 0.01 * float(adv_sq)
        return float(loss.detach())
