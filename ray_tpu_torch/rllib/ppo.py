"""PPO driver: the EnvRunner gang and ``learner.PPOLearner`` on the card.

Counterpart of ``ray_tpu/rllib/ppo.py`` (after RLlib's PPO).
"""

from __future__ import annotations

from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.learner import PPOLearner
from ray_tpu_torch.rllib.rl_module import build_pv_module


class PPOConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.train_kwargs = {
            "clip": 0.2, "vf_coef": 0.5, "ent_coef": 0.01,
            "num_epochs": 10, "minibatch_size": 256, "lam": 0.95,
            "max_grad_norm": 0.5,
        }

    def build(self) -> "PPO":
        return PPO(self)


class PPO(Algorithm):
    def _build_learner(self) -> PPOLearner:
        cfg = self.config
        kw = dict(cfg.train_kwargs)
        kw.pop("lam", None)
        return PPOLearner(build_pv_module(self.module_spec), lr=cfg.lr,
                          seed=cfg.seed, device=cfg.learner_device, **kw)
