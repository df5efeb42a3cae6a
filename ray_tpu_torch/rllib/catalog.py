"""Model catalog: spaces -> default RL modules.

Counterpart of ``ray_tpu/rllib/catalog.py`` (after RLlib's
ModelCatalog): the one place that maps (observation space, action
space, model_config) onto one of the port's ``rl_module`` classes, with
a registry for user-supplied custom models. The catalog ships its own
minimal space types; ``Catalog.spaces_of(env)`` derives them from the
vec-env attribute convention (obs_dim / obs_shape / num_actions /
action_dim) of ``rllib/envs.py``.

Selection rules:

- 3-D Box obs + Discrete actions  -> ``CNNModule`` (conv encoder)
- 1-D Box obs + Discrete actions  -> ``MLPModule`` (policy+value)
- 1-D Box obs + Box actions       -> ``SquashedGaussianModule``
- Q-networks via ``get_q_module``: Discrete -> ``QMLPModule``,
  Box -> ``TwinQModule`` (twin critics)
- ``model_config={"custom_model": name}`` routes to a registered
  factory

The modules come back unplaced, their weights not yet drawn: a learner
(or the caller, through ``init_params(seed, device)``) puts them on a
device.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence, Tuple

from ray_tpu_torch.rllib.rl_module import (
    CNNModule,
    MLPModule,
    QMLPModule,
    SquashedGaussianModule,
    TwinQModule,
)


class Discrete:
    """n distinct actions (gym.spaces.Discrete's role)."""

    def __init__(self, n: int):
        self.n = int(n)

    def __repr__(self):
        return f"Discrete({self.n})"


class Box:
    """Real-valued tensor space (gym.spaces.Box's role)."""

    def __init__(self, shape: Sequence[int], low: float = -float("inf"),
                 high: float = float("inf")):
        self.shape = tuple(int(s) for s in shape)
        self.low = float(low)
        self.high = float(high)

    def __repr__(self):
        return f"Box(shape={self.shape})"


class Catalog:
    _custom: Dict[str, Callable] = {}

    @classmethod
    def register_custom_model(cls, name: str, factory: Callable):
        """factory(obs_space, action_space, model_config) -> module."""
        cls._custom[name] = factory

    @classmethod
    def spaces_of(cls, env) -> Tuple[Box, Any]:
        """(obs_space, action_space) of a vec env: obs_dim, or the pixel
        layout obs_shape; num_actions, or action_dim."""
        obs_shape = getattr(env, "obs_shape", None)
        obs = Box(obs_shape if obs_shape else (env.obs_dim,))
        if getattr(env, "num_actions", None):
            act: Any = Discrete(env.num_actions)
        else:
            act = Box((env.action_dim,), low=-1.0, high=1.0)
        return obs, act

    @classmethod
    def get_module(cls, obs_space: Box, action_space,
                   model_config: Optional[dict] = None):
        """Default policy(+value) module for the space pair."""
        mc = dict(model_config or {})
        custom = mc.pop("custom_model", None)
        if custom is not None:
            return cls._custom[custom](obs_space, action_space, mc)
        hidden = tuple(mc.get("hidden", (64, 64)))
        if isinstance(action_space, Discrete):
            if len(obs_space.shape) == 3:
                kw = {k: mc[k] for k in ("channels", "kernels", "strides")
                      if k in mc}
                return CNNModule(obs_space.shape, action_space.n,
                                 hidden=mc.get("hidden", (128,)), **kw)
            if len(obs_space.shape) == 1:
                return MLPModule(obs_space.shape[0], action_space.n,
                                 hidden=hidden)
            raise ValueError(
                f"no default model for obs shape {obs_space.shape}")
        if isinstance(action_space, Box):
            if len(obs_space.shape) != 1:
                raise ValueError(
                    "continuous control needs flat observations; got "
                    f"{obs_space.shape}")
            return SquashedGaussianModule(
                obs_space.shape[0], action_space.shape[0],
                action_low=action_space.low, action_high=action_space.high,
                hidden=mc.get("hidden", (128, 128)))
        raise ValueError(f"unsupported action space {action_space!r}")

    @classmethod
    def get_q_module(cls, obs_space: Box, action_space,
                     model_config: Optional[dict] = None):
        """Default Q-network for the space pair (DQN / SAC critics)."""
        mc = dict(model_config or {})
        hidden = tuple(mc.get("hidden", (128, 128)))
        if isinstance(action_space, Discrete):
            return QMLPModule(obs_space.shape[0], action_space.n,
                              hidden=hidden)
        if isinstance(action_space, Box):
            return TwinQModule(obs_space.shape[0], action_space.shape[0],
                               hidden=hidden)
        raise ValueError(f"unsupported action space {action_space!r}")
