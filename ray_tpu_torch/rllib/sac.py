"""SAC learner: twin-Q critics with a Polyak target, a tanh-squashed
Gaussian actor (reparameterized) and a learned temperature toward the
target entropy -|A| (Haarnoja et al. 2018).

Counterpart of ``SACLearner`` in ``ray_tpu/rllib/sac.py``. The
reference draws its Gaussian noise with ``jax.random`` inside the
jitted scan; here ``update_many`` draws it from the learner's generator
as one tensor ``[U, 2, B, D]`` (per update: the critic target's draw,
then the actor's) and passes it to the update, so a caller can feed
any draws, ``jax.random``'s included. The ``SAC`` driver waits for the
port's actor runtime.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch.rllib.learner import (Adam, apply_grads, batch_to_device,
                                         frozen_copy, polyak_)
from ray_tpu_torch.rllib.rl_module import (params_from_numpy, resolve_device,
                                           to_numpy)

_LOG_2PI = math.log(2 * math.pi)
_LOG_2 = math.log(2.0)


class SACLearner:
    """``device`` as ``PPOLearner``'s; ``params`` is ``{"pi": actor
    tree, "q": critic tree}`` in the reference's layout (the target
    critic starts as a copy of the loaded one)."""

    def __init__(self, actor, critic, lr: float = 3e-4, gamma: float = 0.99,
                 tau: float = 0.005, init_alpha: float = 0.1, seed: int = 0,
                 device=None, params=None):
        self.device = resolve_device(device)
        self.actor = actor.init_params(seed, self.device)
        self.critic = critic.init_params(seed + 1, self.device)
        if params is not None:
            params_from_numpy(self.actor, params["pi"])
            params_from_numpy(self.critic, params["q"])
        self.q_target = frozen_copy(self.critic)
        self.log_alpha = torch.nn.Parameter(torch.log(torch.tensor(
            init_alpha, dtype=torch.float32, device=self.device)))
        self.pi_opt = Adam(self.actor.parameters(), lr)
        self.q_opt = Adam(self.critic.parameters(), lr)
        self.a_opt = Adam([self.log_alpha], lr)
        self._gamma = gamma
        self._tau = tau
        self._target_entropy = -float(actor.action_dim)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed + 2)
        self.grad_hook = None

    def _pi_sample(self, obs, noise):
        """Squashed-Gaussian action in the env's frame and its log-prob
        (diagonal Gaussian, tanh change of variables, affine rescale)."""
        mu, log_std = self.actor(obs)
        std = torch.exp(log_std)
        pre = mu + std * noise
        logp = (-0.5 * (((pre - mu) / std) ** 2 + 2 * log_std
                        + _LOG_2PI)).sum(-1)
        logp = logp - (2 * (_LOG_2 - pre - F.softplus(-2 * pre))).sum(-1)
        logp = logp - math.log(self.actor.action_scale) \
            * self.actor.action_dim
        action = torch.tanh(pre) * self.actor.action_scale \
            + self.actor.action_center
        return action, logp

    def _step(self, mb, noise):
        alpha = self.log_alpha.detach().exp()
        with torch.no_grad():
            a_next, logp_next = self._pi_sample(mb["next_obs"], noise[0])
            tq1, tq2 = self.q_target(mb["next_obs"], a_next)
            target = mb["rewards"] + self._gamma * (1.0 - mb["dones"]) \
                * (torch.minimum(tq1, tq2) - alpha * logp_next)
        q1, q2 = self.critic(mb["obs"], mb["actions"])
        ql = (q1 - target).square().mean() + (q2 - target).square().mean()
        apply_grads(self.q_opt, list(self.critic.parameters()), ql,
                    self.grad_hook, "q",
                    lambda: to_numpy(self.critic, True))

        a, logp = self._pi_sample(mb["obs"], noise[1])
        q1, q2 = self.critic(mb["obs"], a)
        pl = (alpha * logp - torch.minimum(q1, q2)).mean()
        apply_grads(self.pi_opt, list(self.actor.parameters()), pl,
                    self.grad_hook, "pi",
                    lambda: to_numpy(self.actor, True))

        logp = logp.detach()
        al = -(self.log_alpha.exp() * (logp + self._target_entropy)).mean()
        apply_grads(self.a_opt, [self.log_alpha], al, self.grad_hook,
                    "alpha",
                    lambda: self.log_alpha.grad.detach().cpu().numpy())

        polyak_(self.q_target, self.critic, self._tau)
        return {"q_loss": ql, "pi_loss": pl, "alpha": alpha,
                "entropy": -logp.mean()}

    def update_many(self, batches: Dict[str, np.ndarray],
                    noise: Optional[torch.Tensor] = None
                    ) -> Dict[str, float]:
        """U stacked minibatches ([U, B, ...]) in order: critic, actor,
        temperature, Polyak target. ``noise`` [U, 2, B, D] standard
        normal draws (default: from the learner's generator). Returns
        the last update's metrics."""
        jb = batch_to_device(batches, self.device)
        if jb["actions"].ndim == 2:   # [U, B] -> [U, B, 1]
            jb["actions"] = jb["actions"][..., None]
        U, B = jb["rewards"].shape
        if noise is None:
            noise = torch.randn((U, 2, B, self.actor.action_dim),
                                generator=self._gen, device=self.device)
        else:
            noise = torch.as_tensor(noise, dtype=torch.float32).to(
                self.device)
        metrics = {}
        for u in range(U):
            metrics = self._step({k: v[u] for k, v in jb.items()},
                                 noise[u])
        return {k: float(v.detach()) for k, v in metrics.items()}

    def get_weights(self):
        return to_numpy(self.actor)
