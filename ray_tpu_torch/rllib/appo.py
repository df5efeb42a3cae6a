"""APPO learner: the IMPALA learner with a clipped surrogate loss
against a periodically updated target network.

Counterpart of ``AppoLearner`` in ``ray_tpu/rllib/appo.py``: V-trace
advantages come from the TARGET ("old") policy's outputs, the PPO ratio
is corrected by the behaviour-to-target importance ratio clipped to
[0, 2], and the target network copies the live weights every
``target_update_freq`` updates. The ``APPO`` driver is the IMPALA
runner gang with this learner, as RLlib's APPO subclasses IMPALA.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ray_tpu_torch.rllib.impala import (IMPALA, IMPALAConfig,
                                        ImpalaLearner)
from ray_tpu_torch.rllib.learner import entropy, frozen_copy


class AppoLearner(ImpalaLearner):
    def __init__(self, module, clip_param: float = 0.4,
                 target_update_freq: int = 8, **kw):
        super().__init__(module, **kw)
        self._clip = clip_param
        self._target_update_freq = target_update_freq
        self._updates = 0
        self.target = frozen_copy(self.module)

    def _loss(self, batch):
        T, N = batch["rewards"].shape
        obs_flat = batch["obs"].reshape(T * N, -1)
        logits, values = self.module(obs_flat)
        logits = logits.reshape(T, N, -1)
        values = values.reshape(T, N)
        with torch.no_grad():
            tgt_logits, tgt_values = self.target(obs_flat)
            _, tgt_next_values = self.target(
                batch["next_obs"].reshape(T * N, -1))
        tgt_logits = tgt_logits.reshape(T, N, -1)
        tgt_values = tgt_values.reshape(T, N)
        tgt_next_values = tgt_next_values.reshape(T, N)

        logp_all, cur_logp, behavior_logp = self._logps(logits, batch)
        _, tgt_logp, _ = self._logps(tgt_logits, batch)
        disc_boot = self._gamma * (1.0 - batch["terminateds"])
        cont = 1.0 - batch["dones"]
        vs, pg_adv = self._vtrace(tgt_logp, behavior_logp, tgt_values,
                                  tgt_next_values, batch["rewards"],
                                  disc_boot, cont)
        is_ratio = torch.clamp(torch.exp(behavior_logp - tgt_logp), 0.0, 2.0)
        ratio = is_ratio * torch.exp(cur_logp - behavior_logp)
        surr = torch.minimum(
            pg_adv * ratio,
            pg_adv * torch.clamp(ratio, 1.0 - self._clip, 1.0 + self._clip))
        pg_loss = -surr.mean()
        vf_loss = 0.5 * (vs - values).square().mean()
        ent = entropy(logp_all)
        loss = pg_loss + self._vf_coef * vf_loss - self._ent_coef * ent
        return loss, {"pg_loss": pg_loss, "vf_loss": vf_loss,
                      "entropy": ent}

    def update(self, batch: Dict[str, np.ndarray]) -> Dict[str, float]:
        out = super().update(batch)
        self._updates += 1
        if self._updates % self._target_update_freq == 0:
            self.target.load_state_dict(self.module.state_dict())
        return out


class APPOConfig(IMPALAConfig):
    def __init__(self):
        super().__init__()
        self.lr = 3e-4
        self.train_kwargs = {
            "vf_coef": 0.5, "ent_coef": 0.01, "rho_bar": 1.0,
            "c_bar": 1.0, "max_grad_norm": 40.0,
            "clip_param": 0.4, "target_update_freq": 8,
            "batches_per_iter": 8,
        }

    def build(self) -> "APPO":
        return APPO(self)


class APPO(IMPALA):
    """IMPALA runner gang + APPO learner."""

    LEARNER_CLS = AppoLearner
