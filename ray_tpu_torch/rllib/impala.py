"""IMPALA learner: V-trace off-policy correction (Espeholt et al. 2018,
eqs. (1)-(4)).

Counterpart of ``ImpalaLearner`` in ``ray_tpu/rllib/impala.py``. The
reference's reversed ``lax.scan`` for the v_s recursion is a reverse
loop over the T time steps on the learner's device.

The ``IMPALA`` driver is the asynchronous actor-learner: each EnvRunner
always has one ``sample_sequences()`` in flight; the driver waits for
ANY runner's time-major batch (``ray_tpu_torch.wait``), resubmits that
runner at once with the learner's current weights, and updates the
learner with the batch (V-trace corrects the policy lag).
"""

from __future__ import annotations

import time
from typing import Any, Dict, List

import numpy as np
import torch
import torch.nn.functional as F

import ray_tpu_torch
from ray_tpu_torch.rllib.algorithm import (AlgorithmConfig, RunnerDriver,
                                           module_spec_of)
from ray_tpu_torch.rllib.learner import (Adam, apply_grads, batch_to_device,
                                         entropy, select_logp)
from ray_tpu_torch.rllib.rl_module import (build_pv_module,
                                           params_from_numpy, resolve_device,
                                           to_numpy)


class ImpalaLearner:
    """One SGD step per time-major batch ``[T, N, ...]``: V-trace
    targets, policy gradient, value and entropy terms,
    ``clip_by_global_norm`` then Adam. ``device`` and ``params`` as
    ``PPOLearner``'s."""

    def __init__(self, module, lr: float = 6e-4, gamma: float = 0.99,
                 vf_coef: float = 0.5, ent_coef: float = 0.01,
                 rho_bar: float = 1.0, c_bar: float = 1.0,
                 max_grad_norm: float = 40.0, seed: int = 0, device=None,
                 params=None):
        self.device = resolve_device(device)
        self.module = module.init_params(seed, self.device)
        if params is not None:
            params_from_numpy(self.module, params)
        self.opt = Adam(self.module.parameters(), lr)
        self._gamma = gamma
        self._vf_coef = vf_coef
        self._ent_coef = ent_coef
        self._rho_bar = rho_bar
        self._c_bar = c_bar
        self._max_grad_norm = max_grad_norm
        self.grad_hook = None

    @torch.no_grad()
    def _vtrace(self, target_logp, behavior_logp, values, next_values,
                rewards, disc_boot, cont):
        """v_s and the pg advantage for [T, N] time-major inputs.

        ``next_values`` are V(s'_true) per step, ``disc_boot =
        gamma*(1-terminated)`` masks the bootstrap only at real
        terminations, and ``cont = 1-done`` stops the v_s recursion at
        every episode boundary. Both outputs carry no gradient.
        """
        rho = torch.exp(target_logp - behavior_logp)
        rho_c = torch.clamp(rho, max=self._rho_bar)
        c = torch.clamp(rho, max=self._c_bar)
        deltas = rho_c * (rewards + disc_boot * next_values - values)
        acc = torch.zeros_like(values[0])
        out = [None] * values.shape[0]
        for t in range(values.shape[0] - 1, -1, -1):
            acc = deltas[t] + self._gamma * cont[t] * c[t] * acc
            out[t] = acc
        vs = torch.stack(out) + values
        # within a trajectory the next target is vs[t+1]; at a boundary
        # it is the (terminal-masked) bootstrap value itself
        vs_shift = torch.cat([vs[1:], next_values[-1:]], dim=0)
        vs_next = cont * vs_shift + (1.0 - cont) * next_values
        pg_adv = rho_c * (rewards + disc_boot * vs_next - values)
        return vs, pg_adv

    def _logps(self, logits, batch):
        """Log-probs of all actions under ``logits`` and the taken
        action's, and the behaviour policy's log-prob of it."""
        logp_all = F.log_softmax(logits, dim=-1)
        b_logp_all = F.log_softmax(batch["behavior_logits"], dim=-1)
        return (logp_all, select_logp(logp_all, batch["actions"]),
                select_logp(b_logp_all, batch["actions"]))

    def _loss(self, batch):
        T, N = batch["rewards"].shape
        logits, values = self.module(batch["obs"].reshape(T * N, -1))
        logits = logits.reshape(T, N, -1)
        values = values.reshape(T, N)
        with torch.no_grad():
            _, next_values = self.module(
                batch["next_obs"].reshape(T * N, -1))
        next_values = next_values.reshape(T, N)
        logp_all, target_logp, behavior_logp = self._logps(logits, batch)
        disc_boot = self._gamma * (1.0 - batch["terminateds"])
        cont = 1.0 - batch["dones"]
        vs, pg_adv = self._vtrace(target_logp, behavior_logp,
                                  values.detach(), next_values,
                                  batch["rewards"], disc_boot, cont)
        pg_loss = -(target_logp * pg_adv).mean()
        vf_loss = 0.5 * (vs - values).square().mean()
        ent = entropy(logp_all)
        loss = pg_loss + self._vf_coef * vf_loss - self._ent_coef * ent
        return loss, {"pg_loss": pg_loss, "vf_loss": vf_loss,
                      "entropy": ent}

    def update(self, batch: Dict[str, np.ndarray]) -> Dict[str, float]:
        loss, aux = self._loss(batch_to_device(batch, self.device))
        apply_grads(self.opt, list(self.module.parameters()), loss,
                    self.grad_hook, "params",
                    lambda: to_numpy(self.module, True),
                    self._max_grad_norm)
        return {k: float(v.detach()) for k, v in aux.items()}

    def get_weights(self):
        return to_numpy(self.module)


class IMPALAConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.lr = 6e-4
        self.num_env_runners = 2
        self.num_envs_per_runner = 8
        self.rollout_len = 40
        self.train_kwargs = {
            "vf_coef": 0.5, "ent_coef": 0.01, "rho_bar": 1.0,
            "c_bar": 1.0, "max_grad_norm": 40.0,
            "batches_per_iter": 8,
        }

    def build(self) -> "IMPALA":
        return IMPALA(self)


class IMPALA(RunnerDriver):
    """Async driver: one in-flight rollout per runner, the learner
    consumes batches in completion order (the IMPALA architecture)."""

    LEARNER_CLS = ImpalaLearner

    def __init__(self, config: IMPALAConfig):
        from ray_tpu_torch.rllib.env_runner import EnvRunner
        from ray_tpu_torch.rllib.envs import make_env

        self.config = config
        kw = dict(config.train_kwargs)
        self._batches_per_iter = kw.pop("batches_per_iter")
        self.module_spec = module_spec_of(make_env(config.env_name, 1),
                                          config.module_hidden)
        self.learner = self.LEARNER_CLS(build_pv_module(self.module_spec),
                                        lr=config.lr, gamma=config.gamma,
                                        seed=config.seed,
                                        device=config.learner_device, **kw)
        self.runners = [
            EnvRunner.remote(config.env_name, config.num_envs_per_runner,
                             config.rollout_len, self.module_spec,
                             seed=config.seed + 1000 * i)
            for i in range(config.num_env_runners)
        ]
        self._inflight: Dict[Any, Any] = {}   # ref -> runner
        self._init_driver()

    def _submit(self, runner) -> None:
        w_ref = ray_tpu_torch.put(self.learner.get_weights())
        ref = runner.sample_sequences.remote(w_ref)
        self._inflight[ref] = runner

    def train(self) -> Dict[str, Any]:
        t0 = time.perf_counter()
        for r in self.runners:
            if r not in self._inflight.values():
                self._submit(r)
        accum: Dict[str, List[float]] = {}
        for _ in range(self._batches_per_iter):
            ready, _ = ray_tpu_torch.wait(list(self._inflight),
                                          num_returns=1, timeout=300)
            if not ready:
                raise TimeoutError(
                    "no EnvRunner rollout completed within 300s "
                    f"({len(self._inflight)} in flight)")
            ref = ready[0]
            runner = self._inflight.pop(ref)
            batch = ray_tpu_torch.get(ref)
            self._submit(runner)   # immediately refill with fresh weights
            self._record_returns(batch)
            self.env_steps += batch["rewards"].size
            for k, v in self.learner.update(batch).items():
                accum.setdefault(k, []).append(v)
        metrics = {k: float(np.mean(v)) for k, v in accum.items()}
        self.iteration += 1
        return {
            "training_iteration": self.iteration,
            "episode_return_mean": self._mean_return(),
            "num_env_steps_sampled": self.env_steps,
            "time_this_iter_s": time.perf_counter() - t0,
            **metrics,
        }

    def _eval_runner(self):
        # prefer a runner with no sample in flight
        busy = set(self._inflight.values())
        return next((r for r in self.runners if r not in busy),
                    self.runners[0])
