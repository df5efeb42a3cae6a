"""Algorithm base: config + train-iteration driver over the runner gang.

Counterpart of ``ray_tpu/rllib/algorithm.py`` (after RLlib's
``Algorithm.train`` and ``AlgorithmConfig``) on the port's runtime. The
driver loop each iteration: put the learner's weights (numpy, copied
from the card) in the object store -> parallel ``sample()`` on the
EnvRunner gang -> ``learner.update`` on the card -> metrics.

Beyond the reference's sections, ``learners(device=)`` (named after
upstream RLlib's ``learners()`` section) places every learner a driver
builds: the card unless the caller passes ``"cpu"``. Without CUDA and
without ``device="cpu"``, ``build()`` raises, as every entry point of
the port does.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import numpy as np

import ray_tpu_torch


class AlgorithmConfig:
    """Fluent config (a subset of RLlib's AlgorithmConfig)."""

    def __init__(self):
        self.env_name = "CartPole-v1"
        self.num_env_runners = 2
        self.num_envs_per_runner = 8
        self.rollout_len = 128
        self.gamma = 0.99
        self.lr = 3e-4
        self.train_kwargs: Dict[str, Any] = {}
        self.module_hidden = (64, 64)
        self.seed = 0
        self.learner_device: Optional[str] = None

    def environment(self, env: str) -> "AlgorithmConfig":
        self.env_name = env
        return self

    def env_runners(self, num_env_runners: int = 2,
                    num_envs_per_env_runner: int = 8,
                    rollout_fragment_length: int = 128
                    ) -> "AlgorithmConfig":
        self.num_env_runners = num_env_runners
        self.num_envs_per_runner = num_envs_per_env_runner
        self.rollout_len = rollout_fragment_length
        return self

    def training(self, lr: float = None, gamma: float = None,
                 **kwargs) -> "AlgorithmConfig":
        if lr is not None:
            self.lr = lr
        if gamma is not None:
            self.gamma = gamma
        self.train_kwargs.update(kwargs)
        return self

    def rl_module(self, hidden=(64, 64)) -> "AlgorithmConfig":
        self.module_hidden = tuple(hidden)
        return self

    def learners(self, device: Optional[str] = None) -> "AlgorithmConfig":
        """Where the learners run: None (the CUDA card; raises at
        ``build()`` without one) or a device such as ``"cpu"``."""
        self.learner_device = device
        return self

    def debugging(self, seed: int = 0) -> "AlgorithmConfig":
        self.seed = seed
        return self


def module_spec_of(probe, hidden) -> dict:
    """A policy+value module spec for a vec env: pixel envs advertise
    ``obs_shape``, and the module factory then builds the conv encoder
    instead of the MLP."""
    spec = {"obs_dim": probe.obs_dim, "num_actions": probe.num_actions,
            "hidden": hidden}
    if getattr(probe, "obs_shape", None):
        spec["obs_shape"] = tuple(probe.obs_shape)
    return spec


class RunnerDriver:
    """Shared driver plumbing: a learner + a runner gang + episode-return
    bookkeeping. Every driver (PPO/IMPALA/DQN/SAC/multi-agent PPO)
    extends this."""

    learner = None
    runners: List[Any] = []

    def _init_driver(self):
        self.iteration = 0
        self.env_steps = 0
        self._recent_returns: List[float] = []

    def _record_returns(self, batch: Dict[str, np.ndarray]) -> None:
        """Consume the episode_returns column of a runner batch."""
        self._recent_returns.extend(batch.pop("episode_returns").tolist())

    def _mean_return(self) -> float:
        self._recent_returns = self._recent_returns[-100:]
        return (float(np.mean(self._recent_returns))
                if self._recent_returns else 0.0)

    def evaluate(self, num_episodes: int = 8) -> float:
        return float(ray_tpu_torch.get(
            self._eval_runner().evaluate.remote(
                self.learner.get_weights(), num_episodes), timeout=120))

    def _eval_runner(self):
        return self.runners[0]

    def stop(self):
        for r in self.runners:
            try:
                ray_tpu_torch.kill(r)
            except Exception:  # noqa: BLE001
                pass


class Algorithm(RunnerDriver):
    """Drives a learner + an EnvRunner gang. Subclasses build the learner."""

    def __init__(self, config: AlgorithmConfig):
        from ray_tpu_torch.rllib.env_runner import EnvRunner
        from ray_tpu_torch.rllib.envs import make_env

        self.config = config
        self.module_spec = module_spec_of(make_env(config.env_name, 1),
                                          config.module_hidden)
        self.learner = self._build_learner()
        self.runners = [
            EnvRunner.remote(config.env_name, config.num_envs_per_runner,
                             config.rollout_len, self.module_spec,
                             gamma=config.gamma,
                             lam=config.train_kwargs.get("lam", 0.95),
                             seed=config.seed + 1000 * i)
            for i in range(config.num_env_runners)
        ]
        self._init_driver()

    def _build_learner(self):
        raise NotImplementedError

    def train(self) -> Dict[str, Any]:
        """One training iteration (RLlib's Algorithm.train())."""
        t0 = time.perf_counter()
        weights = self.learner.get_weights()
        w_ref = ray_tpu_torch.put(weights)
        batches = ray_tpu_torch.get(
            [r.sample.remote(w_ref) for r in self.runners], timeout=300)
        for b in batches:
            self._record_returns(b)
        batch = {
            k: np.concatenate([b[k] for b in batches]) for k in batches[0]
        }
        # advantage normalization (standard PPO practice)
        adv = batch["advantages"]
        batch["advantages"] = ((adv - adv.mean())
                               / (adv.std() + 1e-8)).astype(np.float32)
        metrics = self.learner.update(batch)
        self.iteration += 1
        self.env_steps += batch["obs"].shape[0]
        return {
            "training_iteration": self.iteration,
            "episode_return_mean": self._mean_return(),
            "num_env_steps_sampled": self.env_steps,
            "time_this_iter_s": time.perf_counter() - t0,
            **metrics,
        }
