"""EnvRunner: an actor collecting vectorized rollouts.

Counterpart of ``ray_tpu/rllib/env_runner.py`` on the port's runtime
(after RLlib's single-agent EnvRunner). The gang of runners samples in
parallel, one actor each, from weights broadcast as numpy trees in the
reference's layout each round (``learner.get_weights()``); GAE is
computed runner-side so the learner batch arrives ready. A runner acts
through its module's ``apply_np`` / ``sample_np`` on those numpy
weights: runners are plain CPU actors (``CUDA_VISIBLE_DEVICES=""``), and
only the learner runs on the card. The conv module's ``apply_np``
convolves with torch on the CPU; every other module is numpy. A runner
keeps torch to one intra-op thread: a gang shares the host's cores, and
torch's default of one thread a core makes the runners' small
convolutions contend.

Termination vs truncation: envs report both (gymnasium split). Collected
batches carry ``next_obs`` holding the TRUE successor state (the env's
``final_obs`` at episode boundaries, never the auto-reset obs) plus a
``terminateds`` mask, so targets bootstrap through time-limit
truncations (r + gamma*V(s')) instead of treating them as value-0
terminals; GAE / V-trace propagation still stops at every episode
boundary.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch.rllib.envs import make_env
from ray_tpu_torch.rllib.rl_module import (QMLPModule, SquashedGaussianModule,
                                           build_pv_module)


class _EpisodeTracker:
    """Shared episode-return bookkeeping across runner kinds."""

    def _init_tracking(self):
        self._ep_ret = np.zeros(self.env.n, np.float64)
        self._completed: list = []

    def _track_episodes(self, rew: np.ndarray, done: np.ndarray) -> None:
        self._ep_ret += rew
        if done.any():
            for i in np.nonzero(done)[0]:
                self._completed.append(self._ep_ret[i])
                self._ep_ret[i] = 0.0

    def _drain_completed(self) -> np.ndarray:
        completed, self._completed = self._completed, []
        return np.asarray(completed, np.float64)


def _true_next_obs(env, nxt: np.ndarray, done: np.ndarray) -> np.ndarray:
    """The successor obs for targets: final_obs where the episode ended
    (auto-reset replaced it in ``nxt``), nxt elsewhere."""
    if not done.any():
        return nxt
    out = nxt.copy()
    out[done] = env.final_obs[done]
    return out


@ray_tpu_torch.remote
class EnvRunner(_EpisodeTracker):
    def __init__(self, env_name: str, num_envs: int, rollout_len: int,
                 module_spec: dict, gamma: float = 0.99, lam: float = 0.95,
                 seed: int = 0):
        self.env_name = env_name
        self.env = make_env(env_name, num_envs, seed=seed)
        self.module = build_pv_module(module_spec)
        self.rollout_len = rollout_len
        self.gamma = gamma
        self.lam = lam
        self.rng = np.random.default_rng(seed + 1)
        self.obs = self.env.reset()
        self._init_tracking()
        torch.set_num_threads(1)   # one of a gang on the host's cores

    def sample(self, weights) -> Dict[str, np.ndarray]:
        """Collect rollout_len vectorized steps; returns a flat GAE batch
        plus episode stats."""
        T, N = self.rollout_len, self.env.n
        obs_buf = np.empty((T, N, self.env.obs_dim), np.float32)
        next_buf = np.empty((T, N, self.env.obs_dim), np.float32)
        act_buf = np.empty((T, N), np.int32)
        logp_buf = np.empty((T, N), np.float32)
        val_buf = np.empty((T, N), np.float32)
        rew_buf = np.empty((T, N), np.float32)
        term_buf = np.empty((T, N), bool)
        done_buf = np.empty((T, N), bool)

        obs = self.obs
        for t in range(T):
            logits, value = self.module.apply_np(weights, obs)
            # sample from the categorical (gumbel trick, vectorized)
            g = self.rng.gumbel(size=logits.shape)
            actions = np.argmax(logits + g, axis=-1)
            logp = logits - _logsumexp(logits)
            logp_t = np.take_along_axis(
                logp, actions[:, None], axis=-1)[:, 0]
            nxt, rew, term, trunc = self.env.step(actions)
            done = term | trunc
            obs_buf[t], act_buf[t] = obs, actions
            next_buf[t] = _true_next_obs(self.env, nxt, done)
            logp_buf[t], val_buf[t] = logp_t, value
            rew_buf[t], term_buf[t], done_buf[t] = rew, term, done
            self._track_episodes(rew, done)
            obs = nxt
        self.obs = obs
        # V(s'_true) per step: for non-boundary steps that's val_buf[t+1]
        # (same weights, same state — no recompute); fresh evaluation only
        # for boundary columns (final_obs) and the last row
        next_val = np.empty((T, N), np.float32)
        next_val[:-1] = val_buf[1:]
        fresh_t, fresh_i = np.nonzero(done_buf[:-1])
        fresh_obs = [next_buf[fresh_t, fresh_i]] if len(fresh_t) else []
        fresh_obs.append(next_buf[T - 1])
        _, fresh_vals = self.module.apply_np(
            weights, np.concatenate(fresh_obs, axis=0))
        if len(fresh_t):
            next_val[fresh_t, fresh_i] = fresh_vals[:len(fresh_t)]
        next_val[T - 1] = fresh_vals[len(fresh_t):]

        # GAE(lambda): bootstrap masked only by TERMINATION; the gae
        # accumulation stops at any episode boundary
        adv = np.zeros((T, N), np.float32)
        gae = np.zeros(N, np.float32)
        for t in reversed(range(T)):
            not_term = 1.0 - term_buf[t].astype(np.float32)
            not_done = 1.0 - done_buf[t].astype(np.float32)
            delta = (rew_buf[t] + self.gamma * next_val[t] * not_term
                     - val_buf[t])
            gae = delta + self.gamma * self.lam * not_done * gae
            adv[t] = gae
        ret = adv + val_buf

        return {
            "obs": obs_buf.reshape(T * N, -1),
            "actions": act_buf.reshape(-1).astype(np.int32),
            "logp_old": logp_buf.reshape(-1),
            "advantages": adv.reshape(-1),
            "returns": ret.reshape(-1),
            "episode_returns": self._drain_completed(),
        }

    def sample_sequences(self, weights) -> Dict[str, np.ndarray]:
        """Time-major rollout for off-policy-corrected learners (IMPALA).

        Returns [T, N, ...] arrays with BEHAVIOR logits (the learner
        recomputes target logits and applies V-trace; reference:
        rllib/algorithms/impala/impala.py). ``next_obs`` carries true
        successors so the learner can bootstrap every step, including
        through truncations.
        """
        T, N = self.rollout_len, self.env.n
        obs_buf = np.empty((T, N, self.env.obs_dim), np.float32)
        next_buf = np.empty((T, N, self.env.obs_dim), np.float32)
        act_buf = np.empty((T, N), np.int32)
        logits_buf = np.empty((T, N, self.env.num_actions), np.float32)
        rew_buf = np.empty((T, N), np.float32)
        term_buf = np.empty((T, N), bool)
        done_buf = np.empty((T, N), bool)

        obs = self.obs
        for t in range(T):
            logits, _ = self.module.apply_np(weights, obs)
            g = self.rng.gumbel(size=logits.shape)
            actions = np.argmax(logits + g, axis=-1)
            nxt, rew, term, trunc = self.env.step(actions)
            done = term | trunc
            obs_buf[t], act_buf[t] = obs, actions
            next_buf[t] = _true_next_obs(self.env, nxt, done)
            logits_buf[t], rew_buf[t] = logits, rew
            term_buf[t], done_buf[t] = term, done
            self._track_episodes(rew, done)
            obs = nxt
        self.obs = obs
        return {
            "obs": obs_buf,
            "next_obs": next_buf,
            "actions": act_buf,
            "behavior_logits": logits_buf,
            "rewards": rew_buf,
            "terminateds": term_buf,
            "dones": done_buf,
            "episode_returns": self._drain_completed(),
        }

    def evaluate(self, weights, num_episodes: int = 8) -> float:
        """Mean greedy-policy episode return."""
        env = make_env(self.env_name, num_episodes,
                       seed=int(self.rng.integers(1 << 30)))
        obs = env.reset()
        total = np.zeros(num_episodes, np.float64)
        finished = np.zeros(num_episodes, bool)
        for _ in range(env.max_steps + 1):
            logits, _ = self.module.apply_np(weights, obs)
            obs, rew, term, trunc = env.step(np.argmax(logits, axis=-1))
            total += rew * (~finished)
            finished |= term | trunc
            if finished.all():
                break
        return float(total.mean())


@ray_tpu_torch.remote
class OffPolicyRunner(_EpisodeTracker):
    """Transition-collecting actor for replay-based algorithms (DQN/SAC).

    Reference: rllib/env/single_agent_env_runner.py in the off-policy
    algorithms' sample loop. Keeps env state across calls; the policy is
    epsilon-greedy over a Q module (discrete) or a squashed Gaussian
    (continuous), selected by ``kind``. Stored transitions are
    (s, a, r, s'_true, terminated): time-limit truncations keep their
    bootstrap.
    """

    def __init__(self, env_name: str, num_envs: int, module_spec: dict,
                 kind: str = "dqn", seed: int = 0):
        self.env_name = env_name
        self.env = make_env(env_name, num_envs, seed=seed)
        if kind == "dqn":
            self.module = QMLPModule(**module_spec)
        elif kind == "sac":
            self.module = SquashedGaussianModule(**module_spec)
        else:
            raise ValueError(f"unknown runner kind {kind!r}")
        self.kind = kind
        self.rng = np.random.default_rng(seed + 1)
        self.obs = self.env.reset()
        self._init_tracking()
        torch.set_num_threads(1)   # one of a gang on the host's cores

    def _act(self, weights, obs, epsilon: float) -> np.ndarray:
        if self.kind == "dqn":
            q = self.module.apply_np(weights, obs)
            greedy = np.argmax(q, axis=-1)
            explore = self.rng.random(len(obs)) < epsilon
            random_a = self.rng.integers(0, self.env.num_actions,
                                         size=len(obs))
            return np.where(explore, random_a, greedy).astype(np.int32)
        return self.module.sample_np(weights, obs, self.rng).astype(
            np.float32)

    def sample_transitions(self, weights, num_steps: int,
                           epsilon: float = 0.0) -> Dict[str, np.ndarray]:
        """Collect num_steps vectorized steps of (s, a, r, s', term)."""
        N = self.env.n
        cols = {
            "obs": np.empty((num_steps, N, self.env.obs_dim), np.float32),
            "rewards": np.empty((num_steps, N), np.float32),
            "next_obs": np.empty((num_steps, N, self.env.obs_dim),
                                 np.float32),
            "dones": np.empty((num_steps, N), np.float32),
        }
        actions = []
        obs = self.obs
        for t in range(num_steps):
            a = self._act(weights, obs, epsilon)
            nxt, rew, term, trunc = self.env.step(a)
            done = term | trunc
            cols["obs"][t] = obs
            actions.append(a)
            cols["rewards"][t] = rew
            cols["next_obs"][t] = _true_next_obs(self.env, nxt, done)
            # the replay "done" masks the bootstrap => termination only
            cols["dones"][t] = term.astype(np.float32)
            self._track_episodes(rew, done)
            obs = nxt
        self.obs = obs
        act = np.stack(actions)
        out = {k: v.reshape((num_steps * N,) + v.shape[2:])
               for k, v in cols.items()}
        out["actions"] = act.reshape((num_steps * N,) + act.shape[2:])
        out["episode_returns"] = self._drain_completed()
        return out

    def evaluate(self, weights, num_episodes: int = 8) -> float:
        """Mean deterministic-policy episode return."""
        env = make_env(self.env_name, num_episodes,
                       seed=int(self.rng.integers(1 << 30)))
        obs = env.reset()
        total = np.zeros(num_episodes, np.float64)
        finished = np.zeros(num_episodes, bool)
        for _ in range(env.max_steps + 1):
            if self.kind == "dqn":
                a = np.argmax(self.module.apply_np(weights, obs), axis=-1)
            else:
                a = self.module.sample_np(weights, obs, self.rng,
                                          deterministic=True)
            obs, rew, term, trunc = env.step(a)
            total += rew * (~finished)
            finished |= term | trunc
            if finished.all():
                break
        return float(total.mean())


def _logsumexp(x: np.ndarray) -> np.ndarray:
    m = x.max(axis=-1, keepdims=True)
    return m + np.log(np.exp(x - m).sum(axis=-1, keepdims=True))
