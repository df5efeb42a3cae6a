"""RL modules: the policy, value and Q networks the learners train.

Counterpart of ``ray_tpu/rllib/rl_module.py``. There a module is a
spec object with ``init_params(seed)`` and a pure ``apply(params,
obs)`` over a jax pytree; here it is an ``nn.Module`` that holds its
parameters, with the same constructor arguments, and its ``forward``
computes what the reference's ``apply`` computes.

- ``init_params(seed, device)`` draws the weights in place on
  ``device`` (the card unless the caller passes ``"cpu"``) from a
  ``torch.Generator`` seeded with ``seed``, with the reference's
  scales. The draws differ from ``jax.random``'s: code that needs both
  packages on the same weights carries them over with
  ``params_from_numpy``.
- ``to_numpy(module)`` is the parameter tree in the reference's layout
  (``{"trunk": [{"w": [in, out], "b"}, ...], "pi": ..., "v": ...}``,
  conv kernels HWIO) as numpy arrays, and ``params_from_numpy(module,
  tree)`` loads such a tree. Dense weights are stored ``[in, out]`` as
  the reference stores them; conv kernels are stored OIHW for
  ``conv2d`` and transposed on the way in and out.
- ``apply_np(params_np, obs)`` is the host-side mirror for runners:
  numpy over a numpy tree (the conv module convolves with torch on the
  CPU where the reference jits its ``apply`` for the host).

Observations of the conv module travel flat, ``[B, H*W*C]``, as in the
reference. Its activations are NCHW inside and go back to NHWC before
the flatten, so the first dense layer's rows keep the reference's
order.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ray_tpu_torch.models.llama import resolve_device


class _Dense(nn.Module):
    """``x @ w + b`` with ``w`` stored ``[in, out]``."""

    def __init__(self, n_in: int, n_out: int):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(n_in, n_out))
        self.b = nn.Parameter(torch.zeros(n_out))

    def forward(self, x):
        return x @ self.w + self.b

    def draw(self, gen: torch.Generator, scale: float):
        with torch.no_grad():
            self.w.copy_(torch.randn(self.w.shape, generator=gen,
                                     device=self.w.device) * scale)
            self.b.zero_()


class _Conv(nn.Module):
    """VALID convolution with a square kernel, stored OIHW."""

    def __init__(self, cin: int, cout: int, k: int, stride: int):
        super().__init__()
        self.stride = stride
        self.w = nn.Parameter(torch.zeros(cout, cin, k, k))
        self.b = nn.Parameter(torch.zeros(cout))

    def forward(self, x):
        return F.conv2d(x, self.w, self.b, stride=self.stride)

    def draw(self, gen: torch.Generator, scale: float):
        with torch.no_grad():
            self.w.copy_(torch.randn(self.w.shape, generator=gen,
                                     device=self.w.device) * scale)
            self.b.zero_()


def _stack(sizes: Sequence[int]) -> nn.ModuleList:
    return nn.ModuleList(_Dense(a, b) for a, b in zip(sizes[:-1],
                                                      sizes[1:]))


def _draw_stack(layers, gen, out_scale_last: float):
    """He-init dense stack with the last layer down-scaled (the
    reference's ``_init_mlp``)."""
    for i, layer in enumerate(layers):
        a = layer.w.shape[0]
        layer.draw(gen, out_scale_last if i == len(layers) - 1
                   else math.sqrt(2.0 / a))


def _mlp(layers, x, act=torch.tanh):
    """``act`` on the hidden layers, linear last."""
    for layer in layers[:-1]:
        x = act(layer(x))
    return layers[-1](x)


def _mlp_np(layers, x, act=np.tanh):
    for layer in layers[:-1]:
        x = act(x @ layer["w"] + layer["b"])
    return x @ layers[-1]["w"] + layers[-1]["b"]


class _RLModule(nn.Module):
    def init_params(self, seed: int = 0, device=None) -> "_RLModule":
        """Move to ``device`` and draw every weight there from a
        generator seeded with ``seed``; returns the module."""
        device = resolve_device(device)
        self.to(device)
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed))
        self._draw(gen)
        return self


class MLPModule(_RLModule):
    """Policy+value MLP with a shared tanh trunk (discrete actions)."""

    def __init__(self, obs_dim: int, num_actions: int,
                 hidden: Sequence[int] = (64, 64)):
        super().__init__()
        self.obs_dim = obs_dim
        self.num_actions = num_actions
        self.hidden = tuple(hidden)
        self.trunk = _stack((obs_dim,) + self.hidden)
        h = ((obs_dim,) + self.hidden)[-1]
        self.pi = _Dense(h, num_actions)
        self.v = _Dense(h, 1)

    def _draw(self, gen):
        for layer in self.trunk:
            layer.draw(gen, math.sqrt(2.0 / layer.w.shape[0]))
        self.pi.draw(gen, 0.01)
        self.v.draw(gen, 1.0)

    def forward(self, obs) -> Tuple[torch.Tensor, torch.Tensor]:
        """obs [B, obs_dim] -> (logits [B, A], value [B])."""
        x = obs
        for layer in self.trunk:
            x = torch.tanh(layer(x))
        return self.pi(x), self.v(x)[..., 0]

    def apply_np(self, params_np, obs: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
        x = obs
        for layer in params_np["trunk"]:
            x = np.tanh(x @ layer["w"] + layer["b"])
        logits = x @ params_np["pi"]["w"] + params_np["pi"]["b"]
        value = (x @ params_np["v"]["w"] + params_np["v"]["b"])[..., 0]
        return logits, value


class CNNModule(_RLModule):
    """Policy+value conv encoder for pixel observations: relu convs
    (VALID), a tanh trunk, policy and value heads."""

    def __init__(self, obs_shape: Sequence[int], num_actions: int,
                 channels: Sequence[int] = (16, 32),
                 kernels: Sequence[int] = (4, 3),
                 strides: Sequence[int] = (2, 1),
                 hidden: Sequence[int] = (128,), obs_dim: int = 0):
        del obs_dim  # derived from obs_shape; accepted for spec parity
        super().__init__()
        self.obs_shape = tuple(obs_shape)      # (H, W, C)
        self.obs_dim = int(np.prod(obs_shape))
        self.num_actions = num_actions
        self.channels = tuple(channels)
        self.kernels = tuple(kernels)
        self.strides = tuple(strides)
        self.hidden = tuple(hidden)
        cin = self.obs_shape[-1]
        convs = []
        for cout, k, s in zip(self.channels, self.kernels, self.strides):
            convs.append(_Conv(cin, cout, k, s))
            cin = cout
        self.conv = nn.ModuleList(convs)
        sizes = (self._conv_out_size(),) + self.hidden
        self.trunk = _stack(sizes)
        self.pi = _Dense(sizes[-1], num_actions)
        self.v = _Dense(sizes[-1], 1)

    def _conv_out_size(self) -> int:
        h, w, _ = self.obs_shape
        for k, s in zip(self.kernels, self.strides):
            h = (h - k) // s + 1
            w = (w - k) // s + 1
        return h * w * self.channels[-1]

    def _draw(self, gen):
        for layer in self.conv:
            _, cin, k, _ = layer.w.shape
            layer.draw(gen, math.sqrt(2.0 / (k * k * cin)))
        for layer in self.trunk:
            layer.draw(gen, math.sqrt(2.0 / layer.w.shape[0]))
        self.pi.draw(gen, 0.01)
        self.v.draw(gen, 1.0)

    def forward(self, obs) -> Tuple[torch.Tensor, torch.Tensor]:
        """obs [B, H*W*C] -> (logits [B, A], value [B])."""
        x = obs.reshape((-1,) + self.obs_shape).permute(0, 3, 1, 2)
        for layer in self.conv:
            x = torch.relu(layer(x))
        # flatten in NHWC order, the reference's
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        for layer in self.trunk:
            x = torch.tanh(layer(x))
        return self.pi(x), self.v(x)[..., 0]

    def apply_np(self, params_np, obs: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """Runner-side inference with torch on the CPU over a numpy
        tree."""
        with torch.no_grad():
            x = torch.tensor(np.asarray(obs, np.float32))
            x = x.reshape((-1,) + self.obs_shape).permute(0, 3, 1, 2)
            for layer, s in zip(params_np["conv"], self.strides):
                w = torch.tensor(np.asarray(layer["w"], np.float32))
                x = torch.relu(F.conv2d(
                    x, w.permute(3, 2, 0, 1),
                    torch.tensor(np.asarray(layer["b"], np.float32)),
                    stride=s))
            x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1).numpy()
        for layer in params_np["trunk"]:
            x = np.tanh(x @ layer["w"] + layer["b"])
        logits = x @ params_np["pi"]["w"] + params_np["pi"]["b"]
        value = (x @ params_np["v"]["w"] + params_np["v"]["b"])[..., 0]
        return logits, value


def build_pv_module(spec: dict) -> _RLModule:
    """Policy+value module from a spec dict: pixel specs (obs_shape) get
    the conv encoder, vector specs the MLP."""
    if spec.get("obs_shape"):
        return CNNModule(**spec)
    return MLPModule(**{k: v for k, v in spec.items()
                        if k != "obs_shape"})


class QMLPModule(_RLModule):
    """State-action value MLP for discrete actions (DQN family):
    forward(obs) -> Q [B, num_actions]."""

    def __init__(self, obs_dim: int, num_actions: int,
                 hidden: Sequence[int] = (128, 128)):
        super().__init__()
        self.obs_dim = obs_dim
        self.num_actions = num_actions
        self.hidden = tuple(hidden)
        self.q = _stack((obs_dim,) + self.hidden + (num_actions,))

    def _draw(self, gen):
        _draw_stack(self.q, gen, 0.01)

    def forward(self, obs):
        return _mlp(self.q, obs)

    def apply_np(self, params_np, obs: np.ndarray) -> np.ndarray:
        return _mlp_np(params_np["q"], obs)


LOG_STD_MIN, LOG_STD_MAX = -20.0, 2.0


class SquashedGaussianModule(_RLModule):
    """Tanh-squashed Gaussian policy for continuous actions (SAC actor):
    forward(obs) -> (mu [B, D], log_std [B, D]); sampling and the tanh
    log-prob correction live in the learner and the runner."""

    def __init__(self, obs_dim: int, action_dim: int,
                 action_low: float = -1.0, action_high: float = 1.0,
                 hidden: Sequence[int] = (128, 128)):
        super().__init__()
        self.obs_dim = obs_dim
        self.action_dim = action_dim
        self.action_low = float(action_low)
        self.action_high = float(action_high)
        self.hidden = tuple(hidden)
        self.pi = _stack((obs_dim,) + self.hidden + (2 * action_dim,))

    @property
    def action_scale(self) -> float:
        return (self.action_high - self.action_low) / 2.0

    @property
    def action_center(self) -> float:
        return (self.action_high + self.action_low) / 2.0

    def _draw(self, gen):
        _draw_stack(self.pi, gen, 0.01)

    def forward(self, obs):
        mu, log_std = torch.chunk(_mlp(self.pi, obs), 2, dim=-1)
        return mu, log_std.clamp(LOG_STD_MIN, LOG_STD_MAX)

    def apply_np(self, params_np, obs: np.ndarray):
        out = _mlp_np(params_np["pi"], obs)
        mu, log_std = np.split(out, 2, axis=-1)
        return mu, np.clip(log_std, LOG_STD_MIN, LOG_STD_MAX)

    def sample_np(self, params_np, obs: np.ndarray, rng: np.random.Generator,
                  deterministic: bool = False) -> np.ndarray:
        """Environment-frame action (squashed and rescaled), runner-side."""
        mu, log_std = self.apply_np(params_np, obs)
        pre = mu if deterministic else (
            mu + np.exp(log_std) * rng.standard_normal(mu.shape))
        return np.tanh(pre) * self.action_scale + self.action_center


class TwinQModule(_RLModule):
    """Two independent Q(s, a) critics (SAC / TD3 style), relu hidden
    layers: forward(obs, action) -> (q1 [B], q2 [B])."""

    def __init__(self, obs_dim: int, action_dim: int,
                 hidden: Sequence[int] = (128, 128)):
        super().__init__()
        self.obs_dim = obs_dim
        self.action_dim = action_dim
        self.hidden = tuple(hidden)
        sizes = (obs_dim + action_dim,) + self.hidden + (1,)
        self.q1 = _stack(sizes)
        self.q2 = _stack(sizes)

    def _draw(self, gen):
        _draw_stack(self.q1, gen, 1.0)
        _draw_stack(self.q2, gen, 1.0)

    def forward(self, obs, action):
        x0 = torch.cat([obs, action], dim=-1)
        return tuple(_mlp(q, x0, act=torch.relu)[..., 0]
                     for q in (self.q1, self.q2))


# ---- parameter trees in the reference's layout -----------------------------


def _tree(m: nn.Module, leaf) -> Any:
    """The module's reference-layout tree, ``leaf(layer, name)`` at each
    ``w`` / ``b``: a ModuleList is a list, a layer a ``{"w", "b"}``
    dict, any other module a dict of its children."""
    if isinstance(m, nn.ModuleList):
        return [_tree(c, leaf) for c in m]
    if isinstance(m, (_Dense, _Conv)):
        return {"w": leaf(m, "w"), "b": leaf(m, "b")}
    return {name: _tree(c, leaf) for name, c in m.named_children()}


def _ref_layout(layer: nn.Module, name: str, t: torch.Tensor) -> np.ndarray:
    a = t.detach().float().cpu().numpy().copy()
    if name == "w" and isinstance(layer, _Conv):
        a = a.transpose(2, 3, 1, 0)    # OIHW -> HWIO
    return a


def to_numpy(module: nn.Module, grad: bool = False) -> Any:
    """The parameters (or, with ``grad``, their ``.grad``) as numpy in
    the reference's tree layout."""
    def leaf(layer, name):
        p = getattr(layer, name)
        return _ref_layout(layer, name, p.grad if grad else p)
    return _tree(module, leaf)


def params_from_numpy(module: nn.Module, tree) -> nn.Module:
    """Load a reference-layout tree of numpy arrays (or jax arrays) into
    ``module``'s parameters in place; returns the module."""
    def load(m, t):
        if isinstance(m, nn.ModuleList):
            if len(t) != len(m):
                raise ValueError(f"tree has {len(t)} layers, module "
                                 f"{len(m)}")
            for c, x in zip(m, t):
                load(c, x)
        elif isinstance(m, (_Dense, _Conv)):
            for name in ("w", "b"):
                a = np.asarray(t[name], np.float32)
                if name == "w" and isinstance(m, _Conv):
                    a = a.transpose(3, 2, 0, 1)    # HWIO -> OIHW
                p = getattr(m, name)
                if tuple(a.shape) != tuple(p.shape):
                    raise ValueError(f"shape {a.shape} for a parameter "
                                     f"of shape {tuple(p.shape)}")
                with torch.no_grad():
                    p.copy_(torch.from_numpy(a.copy()))
        else:
            for name, c in m.named_children():
                load(c, t[name])
    load(module, tree)
    return module


def tree_leaves(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """Dotted path -> leaf of a nested dict/list tree (``trunk.0.w``)."""
    if isinstance(tree, dict):
        out: Dict[str, np.ndarray] = {}
        for k in sorted(tree):
            out.update(tree_leaves(tree[k], f"{prefix}{k}."))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(tree_leaves(v, f"{prefix}{i}."))
        return out
    return {prefix[:-1]: np.asarray(tree)}
