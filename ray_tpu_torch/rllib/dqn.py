"""DQN learner: double DQN with a Huber TD loss, optional
prioritized-replay weights and a Polyak target.

Counterpart of ``DQNLearner`` in ``ray_tpu/rllib/dqn.py``. The
reference runs a train iteration's U minibatch updates in one jitted
``lax.scan``; here ``update_many`` loops over them on the learner's
device and brings the losses and TD errors to the host once.

The ``DQN`` driver: an ``OffPolicyRunner`` gang collects epsilon-greedy
transitions (epsilon decays linearly with the env steps) into a replay
buffer on the driver; once ``learning_starts`` transitions are in, each
iteration samples ``updates_per_iter`` stacked minibatches and runs
them through ``update_many``, and prioritized replay takes its new
priorities from the returned TD errors.
"""

from __future__ import annotations

import time
from typing import Any, Dict

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch.rllib.algorithm import AlgorithmConfig, RunnerDriver
from ray_tpu_torch.rllib.learner import (Adam, apply_grads, batch_to_device,
                                         frozen_copy, polyak_)
from ray_tpu_torch.rllib.replay_buffer import (PrioritizedReplayBuffer,
                                               ReplayBuffer)
from ray_tpu_torch.rllib.rl_module import (QMLPModule, params_from_numpy,
                                           resolve_device, to_numpy)


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


class DQNConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.lr = 1e-3
        self.num_env_runners = 2
        self.num_envs_per_runner = 8
        self.rollout_len = 32           # steps per runner per iteration
        self.module_hidden = (128, 128)
        self.train_kwargs = {
            "buffer_size": 50_000,
            "learning_starts": 1_000,
            "batch_size": 64,
            "updates_per_iter": 16,
            "tau": 0.01,
            "epsilon_initial": 1.0,
            "epsilon_final": 0.05,
            "epsilon_decay_steps": 10_000,
            "prioritized_replay": False,
            "max_grad_norm": 10.0,
        }

    def build(self) -> "DQN":
        return DQN(self)


class DQN(RunnerDriver):
    def __init__(self, config: DQNConfig):
        from ray_tpu_torch.rllib.env_runner import OffPolicyRunner
        from ray_tpu_torch.rllib.envs import make_env

        self.config = config
        kw = config.train_kwargs
        probe = make_env(config.env_name, 1)
        self.module_spec = {"obs_dim": probe.obs_dim,
                            "num_actions": probe.num_actions,
                            "hidden": config.module_hidden}
        self.learner = DQNLearner(QMLPModule(**self.module_spec),
                                  lr=config.lr, gamma=config.gamma,
                                  tau=kw["tau"],
                                  max_grad_norm=kw["max_grad_norm"],
                                  seed=config.seed,
                                  device=config.learner_device)
        if kw["prioritized_replay"]:
            self.buffer = PrioritizedReplayBuffer(kw["buffer_size"],
                                                  seed=config.seed)
        else:
            self.buffer = ReplayBuffer(kw["buffer_size"], seed=config.seed)
        self.runners = [
            OffPolicyRunner.remote(config.env_name,
                                   config.num_envs_per_runner,
                                   self.module_spec, kind="dqn",
                                   seed=config.seed + 1000 * i)
            for i in range(config.num_env_runners)
        ]
        self._init_driver()

    def _epsilon(self) -> float:
        kw = self.config.train_kwargs
        frac = min(1.0, self.env_steps / kw["epsilon_decay_steps"])
        return kw["epsilon_initial"] + frac * (
            kw["epsilon_final"] - kw["epsilon_initial"])

    def train(self) -> Dict[str, Any]:
        t0 = time.perf_counter()
        kw = self.config.train_kwargs
        weights = self.learner.get_weights()
        w_ref = ray_tpu_torch.put(weights)
        eps = self._epsilon()
        batches = ray_tpu_torch.get(
            [r.sample_transitions.remote(w_ref, self.config.rollout_len,
                                         epsilon=eps)
             for r in self.runners], timeout=300)
        for b in batches:
            self._record_returns(b)
            self.env_steps += len(b["rewards"])
            self.buffer.add_batch(b)

        loss = float("nan")
        if len(self.buffer) >= kw["learning_starts"]:
            stacked = self.buffer.sample_many(kw["updates_per_iter"],
                                              kw["batch_size"])
            indices = stacked.pop("_indices", None)
            loss, tds = self.learner.update_many(stacked)
            if indices is not None:
                self.buffer.update_priorities(indices, tds)
        self.iteration += 1
        return {
            "training_iteration": self.iteration,
            "episode_return_mean": self._mean_return(),
            "num_env_steps_sampled": self.env_steps,
            "epsilon": eps,
            "loss": loss,
            "time_this_iter_s": time.perf_counter() - t0,
        }
