"""Multi-agent RL: several policies learning in one environment.

Counterpart of ``ray_tpu/rllib/multi_agent.py`` on the port's runtime
(after RLlib's multi-agent env and policy map): agent ids map to policy
ids via a ``policy_mapping_fn``; each policy trains on the transitions of
the agents it controls (``policies_to_train`` freezes the rest). One
``PPOLearner`` a policy, on the card unless ``learners(device=)`` says
otherwise; the runners collect vectorized dict-of-agent rollouts
host-side and ship per-policy GAE batches.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch.rllib.algorithm import AlgorithmConfig, RunnerDriver
from ray_tpu_torch.rllib.env_runner import _EpisodeTracker, _logsumexp
from ray_tpu_torch.rllib.learner import PPOLearner
from ray_tpu_torch.rllib.rl_module import MLPModule


class MultiAgentCoordination:
    """Vectorized 2-agent coordination game (a standard multi-agent
    testbed, cf. RLlib's two-step/RPS example envs): both agents pick one
    of K actions each step; both receive +1 when the actions match, 0
    otherwise. Observations are the one-hot previous joint action, so
    coordination ("always play action j") is learnable from history.
    Episodes truncate after ``episode_len`` steps.
    """

    agents = ("a0", "a1")
    num_actions = 3
    episode_len = 8

    def __init__(self, num_envs: int, seed: int = 0):
        self.n = num_envs
        self.obs_dim = 2 * self.num_actions
        self.rng = np.random.default_rng(seed)
        self.prev = np.zeros((num_envs, 2), np.int64)
        self.steps = np.zeros(num_envs, np.int64)
        self.reset()

    def _obs(self) -> Dict[str, np.ndarray]:
        eye = np.eye(self.num_actions, dtype=np.float32)
        joint = np.concatenate([eye[self.prev[:, 0]], eye[self.prev[:, 1]]],
                               axis=1)
        # each agent sees the same joint history
        return {a: joint.copy() for a in self.agents}

    def reset(self) -> Dict[str, np.ndarray]:
        self.prev = self.rng.integers(0, self.num_actions, size=(self.n, 2))
        self.steps[:] = 0
        return self._obs()

    def step(self, actions: Dict[str, np.ndarray]):
        a0 = np.asarray(actions["a0"])
        a1 = np.asarray(actions["a1"])
        match = (a0 == a1).astype(np.float32)
        self.prev = np.stack([a0, a1], axis=1)
        self.steps += 1
        truncated = self.steps >= self.episode_len
        terminated = np.zeros(self.n, bool)
        self.final_obs = self._obs()
        if truncated.any():
            idx = np.nonzero(truncated)[0]
            self.prev[idx] = self.rng.integers(
                0, self.num_actions, size=(len(idx), 2))
            self.steps[idx] = 0
        rew = {a: match.copy() for a in self.agents}
        return self._obs(), rew, terminated, truncated


MULTI_AGENT_ENVS = {"Coordination-v0": MultiAgentCoordination}


def make_multi_agent_env(name: str, num_envs: int, seed: int = 0):
    try:
        return MULTI_AGENT_ENVS[name](num_envs, seed=seed)
    except KeyError:
        raise ValueError(f"unknown multi-agent env {name!r}; registered: "
                         f"{sorted(MULTI_AGENT_ENVS)}") from None


@ray_tpu_torch.remote
class MultiAgentEnvRunner(_EpisodeTracker):
    """Collects joint rollouts; returns one GAE batch per POLICY (agent
    transitions are routed through policy_mapping_fn and concatenated)."""

    def __init__(self, env_name: str, num_envs: int, rollout_len: int,
                 module_spec: dict, policy_ids: List[str],
                 policy_mapping: Dict[str, str], gamma: float = 0.99,
                 lam: float = 0.95, seed: int = 0):
        self.env = make_multi_agent_env(env_name, num_envs, seed=seed)
        self.modules = {pid: MLPModule(**module_spec)
                        for pid in policy_ids}
        self.policy_mapping = policy_mapping
        self.rollout_len = rollout_len
        self.gamma = gamma
        self.lam = lam
        self.rng = np.random.default_rng(seed + 1)
        self.obs = self.env.reset()
        self._init_tracking()
        torch.set_num_threads(1)   # one of a gang on the host's cores

    def sample(self, weights_by_policy: Dict[str, Any]
               ) -> Dict[str, Any]:
        env = self.env
        T, N = self.rollout_len, env.n
        agents = env.agents
        buf = {a: {"obs": np.empty((T, N, env.obs_dim), np.float32),
                   "next_obs": np.empty((T, N, env.obs_dim), np.float32),
                   "actions": np.empty((T, N), np.int32),
                   "logp": np.empty((T, N), np.float32),
                   "value": np.empty((T, N), np.float32),
                   "reward": np.empty((T, N), np.float32)}
               for a in agents}
        term_buf = np.empty((T, N), bool)
        done_buf = np.empty((T, N), bool)

        obs = self.obs
        for t in range(T):
            actions = {}
            for a in agents:
                pid = self.policy_mapping[a]
                w = weights_by_policy[pid]
                logits, value = self.modules[pid].apply_np(w, obs[a])
                g = self.rng.gumbel(size=logits.shape)
                act = np.argmax(logits + g, axis=-1)
                logp = logits - _logsumexp(logits)
                buf[a]["obs"][t] = obs[a]
                buf[a]["actions"][t] = act
                buf[a]["logp"][t] = np.take_along_axis(
                    logp, act[:, None], axis=-1)[:, 0]
                buf[a]["value"][t] = value
                actions[a] = act
            nxt, rew, term, trunc = env.step(actions)
            done = term | trunc
            for a in agents:
                buf[a]["reward"][t] = rew[a]
                true_next = nxt[a].copy()
                if done.any():
                    true_next[done] = env.final_obs[a][done]
                buf[a]["next_obs"][t] = true_next
            term_buf[t], done_buf[t] = term, done
            # per-env mean-over-agents return tracking
            mean_rew = sum(rew[a] for a in agents) / len(agents)
            self._track_episodes(mean_rew, done)
            obs = nxt
        self.obs = obs

        # per-agent GAE, then group by policy
        per_policy: Dict[str, List[Dict[str, np.ndarray]]] = {}
        not_term = 1.0 - term_buf.astype(np.float32)
        not_done = 1.0 - done_buf.astype(np.float32)
        for a in agents:
            b = buf[a]
            pid = self.policy_mapping[a]
            # V(s'_true): values[t+1] for non-boundary steps (same weights,
            # same state); fresh forward only for boundary columns + last
            # row — mirrors the single-agent runner's optimization
            next_value = np.empty((T, N), np.float32)
            next_value[:-1] = b["value"][1:]
            fresh_t, fresh_i = np.nonzero(done_buf[:-1])
            fresh = ([b["next_obs"][fresh_t, fresh_i]] if len(fresh_t)
                     else [])
            fresh.append(b["next_obs"][T - 1])
            _, fresh_vals = self.modules[pid].apply_np(
                weights_by_policy[pid], np.concatenate(fresh, axis=0))
            if len(fresh_t):
                next_value[fresh_t, fresh_i] = fresh_vals[:len(fresh_t)]
            next_value[T - 1] = fresh_vals[len(fresh_t):]

            adv = np.zeros((T, N), np.float32)
            gae = np.zeros(N, np.float32)
            for t in reversed(range(T)):
                delta = (b["reward"][t]
                         + self.gamma * next_value[t] * not_term[t]
                         - b["value"][t])
                gae = delta + self.gamma * self.lam * not_done[t] * gae
                adv[t] = gae
            ret = adv + b["value"]
            batch = {
                "obs": b["obs"].reshape(T * N, -1),
                "actions": b["actions"].reshape(-1),
                "logp_old": b["logp"].reshape(-1),
                "advantages": adv.reshape(-1),
                "returns": ret.reshape(-1),
            }
            per_policy.setdefault(pid, []).append(batch)

        out = {
            pid: {k: np.concatenate([b[k] for b in batches])
                  for k in batches[0]}
            for pid, batches in per_policy.items()
        }
        out["episode_returns"] = self._drain_completed()
        out["num_env_steps"] = T * N
        return out


class MultiAgentPPOConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.env_name = "Coordination-v0"
        self.policies: List[str] = ["shared"]
        self.policy_mapping_fn: Callable[[str], str] = lambda aid: "shared"
        self.policies_to_train: Optional[List[str]] = None
        self.train_kwargs = {
            "clip": 0.2, "vf_coef": 0.5, "ent_coef": 0.01,
            "num_epochs": 6, "minibatch_size": 128, "lam": 0.95,
            "max_grad_norm": 0.5,
        }

    def multi_agent(self, *, policies: List[str],
                    policy_mapping_fn: Callable[[str], str],
                    policies_to_train: Optional[List[str]] = None
                    ) -> "MultiAgentPPOConfig":
        self.policies = list(policies)
        self.policy_mapping_fn = policy_mapping_fn
        self.policies_to_train = policies_to_train
        return self

    def build(self) -> "MultiAgentPPO":
        return MultiAgentPPO(self)


class MultiAgentPPO(RunnerDriver):
    """PPO over a policy map: one PPOLearner per policy, runners route
    agent trajectories to their policies (reference: the multi-agent
    Algorithm path + MultiRLModule)."""

    def __init__(self, config: MultiAgentPPOConfig):
        probe = make_multi_agent_env(config.env_name, 1)
        self.config = config
        self.module_spec = {"obs_dim": probe.obs_dim,
                            "num_actions": probe.num_actions,
                            "hidden": config.module_hidden}
        mapping = {a: config.policy_mapping_fn(a) for a in probe.agents}
        unknown = set(mapping.values()) - set(config.policies)
        if unknown:
            raise ValueError(
                f"policy_mapping_fn produced unknown policies {unknown}")
        kw = dict(config.train_kwargs)
        kw.pop("lam", None)
        self.learners: Dict[str, PPOLearner] = {
            pid: PPOLearner(MLPModule(**self.module_spec), lr=config.lr,
                            seed=config.seed + i,
                            device=config.learner_device, **kw)
            for i, pid in enumerate(config.policies)
        }
        self.to_train = (set(config.policies_to_train)
                         if config.policies_to_train is not None
                         else set(config.policies))
        self.runners = [
            MultiAgentEnvRunner.remote(
                config.env_name, config.num_envs_per_runner,
                config.rollout_len, self.module_spec, config.policies,
                mapping, gamma=config.gamma,
                lam=config.train_kwargs.get("lam", 0.95),
                seed=config.seed + 1000 * i)
            for i in range(config.num_env_runners)
        ]
        self._init_driver()

    def train(self) -> Dict[str, Any]:
        t0 = time.perf_counter()
        weights = {pid: ln.get_weights()
                   for pid, ln in self.learners.items()}
        w_ref = ray_tpu_torch.put(weights)
        results = ray_tpu_torch.get([r.sample.remote(w_ref)
                               for r in self.runners], timeout=300)
        metrics: Dict[str, float] = {}
        for res in results:
            self._record_returns(res)
            self.env_steps += res.pop("num_env_steps")
        for pid in self.to_train:
            batches = [res[pid] for res in results if pid in res]
            if not batches:
                continue
            batch = {k: np.concatenate([b[k] for b in batches])
                     for k in batches[0]}
            adv = batch["advantages"]
            batch["advantages"] = ((adv - adv.mean())
                                   / (adv.std() + 1e-8)).astype(np.float32)
            for k, v in self.learners[pid].update(batch).items():
                metrics[f"{pid}/{k}"] = v
        self.iteration += 1
        return {
            "training_iteration": self.iteration,
            "episode_return_mean": self._mean_return(),
            "num_env_steps_sampled": self.env_steps,
            "time_this_iter_s": time.perf_counter() - t0,
            **metrics,
        }

    def evaluate(self, num_episodes: int = 64) -> float:
        """Mean per-env greedy joint return over one episode, locally."""
        env = make_multi_agent_env(self.config.env_name, num_episodes,
                                   seed=self.config.seed + 999)
        weights = {pid: ln.get_weights()
                   for pid, ln in self.learners.items()}
        mapping = {a: self.config.policy_mapping_fn(a) for a in env.agents}
        modules = {pid: MLPModule(**self.module_spec)
                   for pid in self.config.policies}
        obs = env.reset()
        total = np.zeros(num_episodes, np.float64)
        finished = np.zeros(num_episodes, bool)
        for _ in range(getattr(env, "episode_len", 1000) + 1):
            actions = {}
            for a in env.agents:
                pid = mapping[a]
                logits, _ = modules[pid].apply_np(weights[pid], obs[a])
                actions[a] = np.argmax(logits, axis=-1)
            obs, rew, term, trunc = env.step(actions)
            mean_rew = sum(rew[a] for a in env.agents) / len(env.agents)
            total += mean_rew * (~finished)
            finished |= term | trunc
            if finished.all():
                break
        return float(total.mean())
