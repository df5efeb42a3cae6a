"""Built-in vectorized environments (numpy, no gym dependency).

The port's copy of ``ray_tpu/rllib/envs.py``: the same dynamics, the
same draws from ``np.random.default_rng(seed)`` in the same order, so
that the two packages give the same trajectories bit for bit from one
seed and one action sequence.

The interface is the vectorized subset the EnvRunners need, with the
gymnasium termination split: reset() -> obs [N, obs_dim]; step(actions
[N]) -> (obs, reward [N], terminated [N], truncated [N]). Done envs
auto-reset; the TRUE final observation of a finished episode is stashed
in ``final_obs`` (the post-reset obs goes into the returned batch), so
learners can bootstrap through time-limit truncations instead of
treating them as terminal.
"""

from __future__ import annotations

import numpy as np


class CartPoleVec:
    """Classic CartPole-v1 dynamics (Barto-Sutton-Anderson), vectorized.

    Matches the gymnasium implementation's constants: episode ends on
    |x| > 2.4, |theta| > 12deg, or 500 steps; reward 1 per step. Done envs
    auto-reset.
    """

    obs_dim = 4
    num_actions = 2
    max_steps = 500

    def __init__(self, num_envs: int, seed: int = 0):
        self.n = num_envs
        self.rng = np.random.default_rng(seed)
        self.state = np.zeros((num_envs, 4), np.float64)
        self.steps = np.zeros(num_envs, np.int64)
        self.reset()

    def _sample_state(self, n: int) -> np.ndarray:
        return self.rng.uniform(-0.05, 0.05, size=(n, 4))

    def reset(self) -> np.ndarray:
        self.state = self._sample_state(self.n)
        self.steps[:] = 0
        return self.state.astype(np.float32)

    def step(self, actions: np.ndarray):
        gravity, masscart, masspole = 9.8, 1.0, 0.1
        total_mass = masscart + masspole
        length = 0.5
        polemass_length = masspole * length
        force_mag, tau = 10.0, 0.02

        x, x_dot, theta, theta_dot = self.state.T
        force = np.where(actions == 1, force_mag, -force_mag)
        costheta, sintheta = np.cos(theta), np.sin(theta)
        temp = (force + polemass_length * theta_dot**2 * sintheta) / total_mass
        thetaacc = (gravity * sintheta - costheta * temp) / (
            length * (4.0 / 3.0 - masspole * costheta**2 / total_mass))
        xacc = temp - polemass_length * thetaacc * costheta / total_mass

        x = x + tau * x_dot
        x_dot = x_dot + tau * xacc
        theta = theta + tau * theta_dot
        theta_dot = theta_dot + tau * thetaacc
        self.state = np.stack([x, x_dot, theta, theta_dot], axis=1)
        self.steps += 1

        terminated = (np.abs(x) > 2.4) | (np.abs(theta) > 12 * np.pi / 180)
        truncated = ~terminated & (self.steps >= self.max_steps)
        done = terminated | truncated
        reward = np.ones(self.n, np.float32)
        self.final_obs = self.state.astype(np.float32)
        if done.any():
            idx = np.nonzero(done)[0]
            self.state[idx] = self._sample_state(len(idx))
            self.steps[idx] = 0
        return self.state.astype(np.float32), reward, terminated, truncated


class PendulumVec:
    """Classic Pendulum-v1 swing-up (continuous torque), vectorized.

    Matches the gymnasium constants: g=10, m=1, l=1, dt=0.05, torque
    clipped to [-2, 2], theta_dot clipped to [-8, 8], 200-step episodes,
    reward = -(angle^2 + 0.1*thetadot^2 + 0.001*torque^2). obs is
    [cos(theta), sin(theta), theta_dot]. Done envs auto-reset.
    """

    obs_dim = 3
    action_dim = 1
    action_low = -2.0
    action_high = 2.0
    max_steps = 200

    def __init__(self, num_envs: int, seed: int = 0):
        self.n = num_envs
        self.rng = np.random.default_rng(seed)
        self.theta = np.zeros(num_envs)
        self.theta_dot = np.zeros(num_envs)
        self.steps = np.zeros(num_envs, np.int64)
        self.reset()

    def _obs(self) -> np.ndarray:
        return np.stack([np.cos(self.theta), np.sin(self.theta),
                         self.theta_dot], axis=1).astype(np.float32)

    def _sample(self, n: int):
        return (self.rng.uniform(-np.pi, np.pi, size=n),
                self.rng.uniform(-1.0, 1.0, size=n))

    def reset(self) -> np.ndarray:
        self.theta, self.theta_dot = self._sample(self.n)
        self.steps[:] = 0
        return self._obs()

    def step(self, actions: np.ndarray):
        g, m, length, dt = 10.0, 1.0, 1.0, 0.05
        u = np.clip(np.asarray(actions, np.float64).reshape(self.n, -1)[:, 0],
                    self.action_low, self.action_high)
        th = ((self.theta + np.pi) % (2 * np.pi)) - np.pi  # normalize
        cost = th**2 + 0.1 * self.theta_dot**2 + 0.001 * u**2

        acc = (3 * g / (2 * length) * np.sin(self.theta)
               + 3.0 / (m * length**2) * u)
        self.theta_dot = np.clip(self.theta_dot + acc * dt, -8.0, 8.0)
        self.theta = self.theta + self.theta_dot * dt
        self.steps += 1

        truncated = self.steps >= self.max_steps  # never terminates
        terminated = np.zeros(self.n, bool)
        self.final_obs = self._obs()
        if truncated.any():
            idx = np.nonzero(truncated)[0]
            th0, thd0 = self._sample(len(idx))
            self.theta[idx], self.theta_dot[idx] = th0, thd0
            self.steps[idx] = 0
        return self._obs(), (-cost).astype(np.float32), terminated, truncated


class CatchPixelsVec:
    """Procedural PIXEL-observation env (the image ships no ALE; this is
    the Atari-shaped stand-in the CNN path trains on): a ball falls down
    a GRID x GRID frame, a 3-cell paddle slides along the bottom row,
    reward +1 on catch / -1 on miss at the bottom, episode length = GRID-1
    steps. Observations are raw pixels, flattened [N, GRID*GRID] float32
    (module reshapes to (H, W, 1) — see rl_module.CNNModule). Random play
    scores ~-0.25; a learned policy approaches +1.
    """

    GRID = 10
    obs_dim = GRID * GRID
    obs_shape = (GRID, GRID, 1)
    num_actions = 3  # left, stay, right
    max_steps = GRID - 1

    def __init__(self, num_envs: int, seed: int = 0):
        self.n = num_envs
        self.rng = np.random.default_rng(seed)
        self.ball = np.zeros((num_envs, 2), np.int64)   # row, col
        self.paddle = np.zeros(num_envs, np.int64)      # center col
        self.reset()

    def _respawn(self, idx):
        self.ball[idx, 0] = 0
        self.ball[idx, 1] = self.rng.integers(0, self.GRID, size=len(idx))
        self.paddle[idx] = self.rng.integers(1, self.GRID - 1,
                                             size=len(idx))

    def _render(self) -> np.ndarray:
        g = self.GRID
        frame = np.zeros((self.n, g, g), np.float32)
        env_i = np.arange(self.n)
        frame[env_i, self.ball[:, 0], self.ball[:, 1]] = 1.0
        for d in (-1, 0, 1):
            cols = np.clip(self.paddle + d, 0, g - 1)
            frame[env_i, g - 1, cols] = 0.5
        return frame.reshape(self.n, -1)

    def reset(self) -> np.ndarray:
        self._respawn(np.arange(self.n))
        return self._render()

    def step(self, actions: np.ndarray):
        self.paddle = np.clip(self.paddle + (actions.astype(np.int64) - 1),
                              1, self.GRID - 2)
        self.ball[:, 0] += 1
        at_bottom = self.ball[:, 0] >= self.GRID - 1
        caught = at_bottom & (np.abs(self.ball[:, 1] - self.paddle) <= 1)
        reward = np.where(at_bottom,
                          np.where(caught, 1.0, -1.0), 0.0
                          ).astype(np.float32)
        terminated = at_bottom
        truncated = np.zeros(self.n, bool)
        self.final_obs = self._render()
        if at_bottom.any():
            self._respawn(np.nonzero(at_bottom)[0])
        return self._render(), reward, terminated, truncated


ENVS = {"CartPole-v1": CartPoleVec, "Pendulum-v1": PendulumVec,
        "CatchPixels-v0": CatchPixelsVec}


def make_env(name: str, num_envs: int, seed: int = 0):
    try:
        return ENVS[name](num_envs, seed=seed)
    except KeyError:
        raise ValueError(
            f"unknown env {name!r}; registered: {sorted(ENVS)}") from None
