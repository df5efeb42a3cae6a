"""DQN learner: double DQN with a Huber TD loss, optional
prioritized-replay weights and a Polyak target.

Counterpart of ``DQNLearner`` in ``ray_tpu/rllib/dqn.py``. The
reference runs a train iteration's U minibatch updates in one jitted
``lax.scan``; here ``update_many`` loops over them on the learner's
device and brings the losses and TD errors to the host once. The
``DQN`` driver and its replay buffers wait for the port's actor
runtime.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ray_tpu_torch.rllib.learner import (Adam, apply_grads, batch_to_device,
                                         frozen_copy, polyak_)
from ray_tpu_torch.rllib.rl_module import (params_from_numpy, resolve_device,
                                           to_numpy)


def huber(x: torch.Tensor, delta: float = 1.0) -> torch.Tensor:
    a = x.abs()
    return torch.where(a <= delta, 0.5 * x * x, delta * (a - 0.5 * delta))


def double_q_target(module, target, mb, gamma: float) -> torch.Tensor:
    """r + gamma (1 - done) Q_target(s', argmax_a Q_online(s', a)): the
    online net picks a', the target net evaluates it. No gradient."""
    with torch.no_grad():
        a_next = torch.argmax(module(mb["next_obs"]), dim=-1)
        q_next = target(mb["next_obs"]).gather(
            -1, a_next[:, None])[:, 0]
        return mb["rewards"] + gamma * (1.0 - mb["dones"]) * q_next


class DQNLearner:
    """``device`` and ``params`` as ``PPOLearner``'s; the target net
    starts as a copy of the (loaded) online net."""

    def __init__(self, module, lr: float = 1e-3, gamma: float = 0.99,
                 tau: float = 0.01, max_grad_norm: float = 10.0,
                 seed: int = 0, device=None, params=None):
        self.device = resolve_device(device)
        self.module = module.init_params(seed, self.device)
        if params is not None:
            params_from_numpy(self.module, params)
        self.target = frozen_copy(self.module)
        self.opt = Adam(self.module.parameters(), lr)
        self._gamma = gamma
        self._tau = tau
        self._max_grad_norm = max_grad_norm
        self.grad_hook = None

    def _loss(self, mb):
        q = self.module(mb["obs"])
        q_sa = q.gather(-1, mb["actions"][:, None])[:, 0]
        td = q_sa - double_q_target(self.module, self.target, mb,
                                    self._gamma)
        h = huber(td)
        if "weights" in mb:
            h = mb["weights"] * h
        return h.mean(), td.detach()

    def update_many(self, batches: Dict[str, np.ndarray]):
        """Run U stacked minibatches ([U, B, ...]) in order. Returns
        (mean loss, td_errors [U, B] numpy) for priority updates."""
        jb = batch_to_device(batches, self.device)
        params = list(self.module.parameters())
        losses, tds = [], []
        for u in range(jb["rewards"].shape[0]):
            loss, td = self._loss({k: v[u] for k, v in jb.items()})
            apply_grads(self.opt, params, loss, self.grad_hook, "params",
                        lambda: to_numpy(self.module, True),
                        self._max_grad_norm)
            polyak_(self.target, self.module, self._tau)
            losses.append(loss.detach())
            tds.append(td)
        return (float(torch.stack(losses).mean()),
                torch.stack(tds).cpu().numpy())

    def get_weights(self):
        return to_numpy(self.module)
