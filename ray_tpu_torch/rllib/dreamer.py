"""DreamerV3's learner: a world model, and an actor-critic trained in its
imagination.

Counterpart of ``DreamerV3Learner`` in ``ray_tpu/rllib/dreamer.py``
(Hafner et al. 2023, arXiv:2301.04104, in the reference's compact form):
an RSSM world model (a GRU deterministic state and categorical
stochastic latents with unimix, sampled straight-through), symlog
observation and twohot reward losses, a continue head, KL balancing
with free bits; imagination rollouts of ``horizon`` steps from a
subsample of the batch's posterior states; lambda-returns over the
predicted continues and a REINFORCE actor whose advantages are scaled
by a percentile EMA of the returns.

The reference draws every categorical sample with ``jax.random`` inside
its jitted update. Here every draw is an explicit input of ``update``
(``noise=``, default: drawn from the learner's generator), as
``SACLearner.update_many(noise=)`` takes its Gaussian draws: the Gumbel
noise of each categorical (``jax.random.categorical`` is the argmax of
logits plus Gumbel noise) and the start-state pick (the first
``imag_starts`` entries of a permutation, as ``jax.random.choice``
without replacement makes it). A caller can so feed the draws the
reference's keys make. The ``DreamerV3`` driver and its sequence replay
wait for the port's runtime with the other RLlib drivers.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ray_tpu_torch.rllib.learner import Adam, apply_grads, batch_to_device
from ray_tpu_torch.rllib.rl_module import (_Dense, _tree, params_from_numpy,
                                           resolve_device, to_numpy,
                                           tree_leaves)


def symlog(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * torch.log1p(torch.abs(x))


def symexp(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * torch.expm1(torch.abs(x))


class TwoHot:
    """Twohot encoding over symlog-spaced bins (the paper's robust
    regression head for rewards and values)."""

    def __init__(self, low: float = -15.0, high: float = 15.0, n: int = 41,
                 device=None):
        # jnp.linspace's float32 values: low (1 - t) + high t, t = i / (n
        # - 1), the last one exact
        t = np.arange(n - 1, dtype=np.float32) / np.float32(n - 1)
        bins = np.append(np.float32(low) * (1 - t) + np.float32(high) * t,
                         np.float32(high))
        self.bins = torch.as_tensor(bins, device=device)
        self.low, self.high, self.n = low, high, n

    def encode(self, y: torch.Tensor) -> torch.Tensor:
        """y [...] real -> [..., n] twohot weights of symlog(y)."""
        y = symlog(y).clamp(self.low, self.high)
        idx = (torch.searchsorted(self.bins, y.contiguous(), right=True)
               - 1).clamp(0, self.n - 2)   # left bin of the bracket
        left, right = self.bins[idx], self.bins[idx + 1]
        w_right = ((y - left) / (right - left)).clamp(0.0, 1.0)
        return (F.one_hot(idx, self.n) * (1.0 - w_right)[..., None]
                + F.one_hot(idx + 1, self.n) * w_right[..., None])

    def decode(self, logits: torch.Tensor) -> torch.Tensor:
        """[..., n] logits -> [...] real expectation in symexp space."""
        return symexp((torch.softmax(logits, -1) * self.bins).sum(-1))


def _linear(gen: torch.Generator, din: int, dout: int,
            scale: float = 1.0) -> _Dense:
    """The reference's ``_linear``: truncated-normal (+-2) weights scaled
    by ``scale / sqrt(din)``, zero bias (drawn from ``gen``)."""
    layer = _Dense(din, dout).to(gen.device)
    with torch.no_grad():
        nn.init.trunc_normal_(layer.w, 0.0, 1.0, -2.0, 2.0, generator=gen)
        layer.w.mul_(scale / math.sqrt(din))
    return layer


def _stack(gen, sizes) -> nn.ModuleList:
    return nn.ModuleList(_linear(gen, a, b) for a, b in sizes)


def _norm_silu(x: torch.Tensor) -> torch.Tensor:
    """LayerNorm (no affine) + SiLU, the paper's block activation."""
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return F.silu((x - mean) * torch.rsqrt(var + 1e-5))


def _mlp(layers, x: torch.Tensor) -> torch.Tensor:
    for layer in layers:
        x = _norm_silu(layer(x))
    return x


class _Net(nn.Module):
    """Named children in the reference's tree layout (``"in"`` is a
    Python keyword, so children are set by name)."""

    def __init__(self, children: Dict[str, nn.Module]):
        super().__init__()
        for name, child in children.items():
            self.add_module(name, child)

    def __getitem__(self, name: str) -> nn.Module:
        return self._modules[name]


def _adam_state(state):
    """The ``ScaleByAdamState`` (count, mu, nu) inside an optax chain's
    state."""
    if hasattr(state, "mu") and hasattr(state, "nu"):
        return state
    if isinstance(state, (tuple, list)):
        for s in state:
            found = _adam_state(s)
            if found is not None:
                return found
    return None


def _param_paths(module: nn.Module) -> Dict[str, torch.Tensor]:
    """Dotted path (as ``tree_leaves`` names them) -> parameter."""
    def flat(tree, prefix):
        if isinstance(tree, torch.Tensor):
            return {prefix[:-1]: tree}
        items = sorted(tree.items()) if isinstance(tree, dict) \
            else enumerate(tree)
        out = {}
        for k, v in items:
            out.update(flat(v, f"{prefix}{k}."))
        return out
    return flat(_tree(module, lambda layer, name: getattr(layer, name)), "")


def gumbel(shape, gen: torch.Generator, device) -> torch.Tensor:
    """Standard Gumbel draws, ``-log(-log(u))`` as ``jax.random.gumbel``
    makes them from uniforms in [tiny, 1)."""
    u = torch.rand(shape, generator=gen, device=device)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))


class DreamerV3Learner:
    """World model + actor-critic, each stepped once per ``update``.

    Constructor arguments as the reference's, plus ``device`` (the card
    unless the caller passes ``"cpu"``) and ``params`` (``{"wm": tree,
    "ac": tree}`` in the reference's layout, e.g. its ``wm_params`` and
    ``ac_params`` as numpy). Both optimizers are optax's chain of a
    global-norm clip at 100 and Adam. ``grad_hook(kind, grads)`` sees
    the ``"wm"`` and ``"ac"`` gradients before the clip."""

    def __init__(self, obs_dim: int, num_actions: int, *, deter=128,
                 stoch_vars=8, stoch_classes=8, units=128, lr=4e-4,
                 ac_lr=1e-4, gamma=0.99, lam=0.95, horizon=10,
                 entropy=1e-3, unimix=0.01, free_bits=1.0,
                 imag_starts=64, seed=0, device=None, params=None):
        self.device = resolve_device(device)
        self.obs_dim, self.num_actions = obs_dim, num_actions
        self.deter = deter
        self.V, self.K = stoch_vars, stoch_classes
        self.z_dim = stoch_vars * stoch_classes
        self.gamma, self.lam = gamma, lam
        self.horizon = horizon
        self.entropy = entropy
        self.unimix = unimix
        self.free_bits = free_bits
        self.imag_starts = imag_starts
        self.twohot = TwoHot(device=self.device)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed))
        U, D, Z, A = units, deter, self.z_dim, num_actions
        nb = self.twohot.n
        self.wm = _Net({
            "enc": _stack(gen, [(obs_dim, U), (U, U)]),
            "in": _linear(gen, Z + A, U),
            "gru": _linear(gen, U + D, 3 * D),
            "prior": _stack(gen, [(D, U)]),
            "prior_out": _linear(gen, U, Z),
            "post": _stack(gen, [(D + U, U)]),
            "post_out": _linear(gen, U, Z),
            "dec": _stack(gen, [(D + Z, U), (U, U)]),
            "dec_out": _linear(gen, U, obs_dim),
            "rew": _stack(gen, [(D + Z, U)]),
            "rew_out": _linear(gen, U, nb, scale=0.0),
            "cont": _stack(gen, [(D + Z, U)]),
            "cont_out": _linear(gen, U, 1),
        })
        self.ac = _Net({
            "actor": _stack(gen, [(D + Z, U), (U, U)]),
            "actor_out": _linear(gen, U, A, scale=0.01),
            "critic": _stack(gen, [(D + Z, U), (U, U)]),
            "critic_out": _linear(gen, U, nb, scale=0.0),
        })
        if params is not None:
            params_from_numpy(self.wm, params["wm"])
            params_from_numpy(self.ac, params["ac"])
        self.wm_opt = Adam(self.wm.parameters(), lr)
        self.ac_opt = Adam(self.ac.parameters(), ac_lr)
        # percentile EMA for return normalization (paper eq. 9)
        self.ret_lo = torch.zeros((), device=self.device)
        self.ret_hi = torch.zeros((), device=self.device)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(int(seed) + 1)
        self.grad_hook = None

    def load_opt_state(self, wm_opt, ac_opt, ret_lo=0.0,
                       ret_hi=0.0) -> None:
        """Carry the reference learner's optimizer states (its ``wm_opt``
        and ``ac_opt``, optax chains of numpy or jax leaves: Adam's step
        count and moments) and return-range EMA into this learner, so
        that it continues where the reference stands."""
        for module, opt, state in ((self.wm, self.wm_opt, wm_opt),
                                   (self.ac, self.ac_opt, ac_opt)):
            adam = _adam_state(state)
            mu, nu = tree_leaves(adam.mu), tree_leaves(adam.nu)
            step = torch.tensor(float(np.asarray(adam.count)))
            for path, p in _param_paths(module).items():
                opt.state[p] = {
                    "step": step.clone(),
                    "exp_avg": torch.as_tensor(mu[path]).to(p.device).clone(),
                    "exp_avg_sq": torch.as_tensor(nu[path]).to(
                        p.device).clone()}
        self.ret_lo = torch.tensor(float(np.asarray(ret_lo)),
                                   device=self.device)
        self.ret_hi = torch.tensor(float(np.asarray(ret_hi)),
                                   device=self.device)

    # ---- RSSM pieces -----------------------------------------------------

    def _uni_logits(self, logits):
        """Unimix: 1% uniform mixed into the categorical (paper §B)."""
        logits = logits.reshape(logits.shape[:-1] + (self.V, self.K))
        probs = torch.softmax(logits, -1)
        return torch.log((1 - self.unimix) * probs + self.unimix / self.K)

    def _sample_z(self, logits, noise):
        """Straight-through one-hot sample of V categoricals (the argmax
        of logits plus Gumbel ``noise``); returns flat [., V*K]."""
        hot = F.one_hot(torch.argmax(logits + noise, -1), self.K).float()
        probs = torch.softmax(logits, -1)
        hot = probs + (hot - probs).detach()
        return hot.reshape(hot.shape[:-2] + (self.z_dim,))

    def _gru(self, h, x):
        wm = self.wm
        x = _norm_silu(wm["in"](x))
        reset, cand, update = wm["gru"](torch.cat([x, h], -1)).chunk(3, -1)
        cand = torch.tanh(torch.sigmoid(reset) * cand)
        update = torch.sigmoid(update - 1.0)
        return update * cand + (1 - update) * h

    def _prior(self, h):
        return self._uni_logits(self.wm["prior_out"](
            _mlp(self.wm["prior"], h)))

    def _post(self, h, emb):
        x = _mlp(self.wm["post"], torch.cat([h, emb], -1))
        return self._uni_logits(self.wm["post_out"](x))

    def _wm_step(self, h, z, a_onehot, emb, is_first, noise):
        """One posterior RSSM step with episode-boundary reset."""
        mask = (1.0 - is_first)[..., None]
        h = self._gru(h * mask, torch.cat([z * mask, a_onehot * mask], -1))
        post_logits = self._post(h, emb)
        return h, self._sample_z(post_logits, noise), post_logits

    def _head(self, name, feat):
        return self.wm[name + "_out"](_mlp(self.wm[name], feat))

    # ---- world-model loss -------------------------------------------------

    @staticmethod
    def _kl(lhs, rhs):
        """KL(cat(lhs) || cat(rhs)) summed over the latent variables."""
        lp, rp = F.log_softmax(lhs, -1), F.log_softmax(rhs, -1)
        return (lp.exp() * (lp - rp)).sum(-1).sum(-1)

    def _wm_loss(self, b, noise):
        obs, acts = b["obs"], b["actions"]        # [B, L, obs], [B, L]
        cont = 1.0 - b["dones"]
        B, L = obs.shape[:2]
        emb = _mlp(self.wm["enc"], symlog(obs))
        a_prev = torch.cat([
            torch.zeros((B, 1, self.num_actions), device=obs.device),
            F.one_hot(acts[:, :-1], self.num_actions).float()], 1)
        h = torch.zeros((B, self.deter), device=obs.device)
        z = torch.zeros((B, self.z_dim), device=obs.device)
        hs, zs, post_l, prior_l = [], [], [], []
        for t in range(L):
            h, z, post = self._wm_step(h, z, a_prev[:, t], emb[:, t],
                                       b["is_first"][:, t], noise[t])
            hs.append(h)
            zs.append(z)
            post_l.append(post)
            prior_l.append(self._prior(h))
        hs, zs = torch.stack(hs, 1), torch.stack(zs, 1)
        post_l, prior_l = torch.stack(post_l, 1), torch.stack(prior_l, 1)
        feat = torch.cat([hs, zs], -1)
        recon = self._head("dec", feat)
        rew_logits = self._head("rew", feat)
        cont_logit = self._head("cont", feat)[..., 0]
        recon_loss = ((recon - symlog(obs)) ** 2).sum(-1)
        rew_loss = -(self.twohot.encode(b["rewards"])
                     * F.log_softmax(rew_logits, -1)).sum(-1)
        cont_loss = (torch.clamp_min(cont_logit, 0) - cont_logit * cont
                     + torch.log1p(torch.exp(-cont_logit.abs())))
        # KL balancing (paper eq. 5), both terms free-bits clipped
        dyn = self._kl(post_l.detach(), prior_l)
        rep = self._kl(post_l, prior_l.detach())
        kl = (0.5 * torch.clamp_min(dyn, self.free_bits)
              + 0.1 * torch.clamp_min(rep, self.free_bits))
        return (recon_loss + rew_loss + cont_loss + kl).mean(), hs, zs

    # ---- actor-critic loss ------------------------------------------------

    def _actor_logits(self, feat):
        return self.ac["actor_out"](_mlp(self.ac["actor"], feat))

    @torch.no_grad()
    def _imagine(self, h, z, act_noise, prior_noise):
        """Roll the prior ``horizon`` steps with the actor's actions; the
        world model is a constant here (REINFORCE needs no gradient
        through the dynamics), and so are the sampled trajectories."""
        feats, acts = [], []
        for t in range(self.horizon):
            feat = torch.cat([h, z], -1)
            a = torch.argmax(self._actor_logits(feat) + act_noise[t], -1)
            a_hot = F.one_hot(a, self.num_actions).float()
            h = self._gru(h, torch.cat([z, a_hot], -1))
            z = self._sample_z(self._prior(h), prior_noise[t])
            feats.append(feat)
            acts.append(a)
        return torch.stack(feats), torch.stack(acts), torch.cat([h, z], -1)

    def _ac_loss(self, h, z, noise):
        feats, acts, last = self._imagine(h, z, noise["act"], noise["prior"])
        all_feats = torch.cat([feats, last[None]], 0)
        # the heads' pre-action-state convention, as the reference trains
        # them on auto-reset data
        with torch.no_grad():
            rewards = self.twohot.decode(self._head("rew", all_feats[:-1]))
            disc = self.gamma * torch.sigmoid(
                self._head("cont", all_feats[:-1])[..., 0])
        v_logits = self.ac["critic_out"](_mlp(self.ac["critic"], all_feats))
        values = self.twohot.decode(v_logits)            # [H+1, N]
        with torch.no_grad():
            acc, rets = values[-1], []
            for t in reversed(range(self.horizon)):
                acc = rewards[t] + disc[t] * ((1 - self.lam) * values[t + 1]
                                              + self.lam * acc)
                rets.append(acc)
            rets = torch.stack(rets[::-1])               # [H, N]
            # don't learn past predicted terminations
            weights = torch.cat([torch.ones_like(disc[:1]),
                                 torch.cumprod(disc[:-1], 0)], 0)
            flat = rets.flatten()
            lo, hi = torch.quantile(flat, 0.05), torch.quantile(flat, 0.95)
            new_lo = 0.99 * self.ret_lo + 0.01 * lo
            new_hi = 0.99 * self.ret_hi + 0.01 * hi
            scale = torch.clamp_min(new_hi - new_lo, 1.0)
            adv = (rets - values[:-1]) / scale
        logp = F.log_softmax(self._actor_logits(feats), -1)
        lp_a = logp.gather(-1, acts[..., None])[..., 0]
        ent = -(logp.exp() * logp).sum(-1)
        actor_loss = -(weights * (lp_a * adv + self.entropy * ent)).mean()
        critic_ce = -(self.twohot.encode(rets)
                      * F.log_softmax(v_logits[:-1], -1)).sum(-1)
        loss = actor_loss + (weights * critic_ce).mean()
        return loss, new_lo, new_hi, rets.mean(), ent.mean().detach()

    # ---- the update -------------------------------------------------------

    def draw_noise(self, B: int, L: int) -> Dict[str, torch.Tensor]:
        """The update's draws from the learner's generator, in ``update``'s
        ``noise`` layout."""
        n = B * L
        N = self.imag_starts if self.imag_starts and self.imag_starts < n \
            else n
        g = lambda *s: gumbel(s, self._gen, self.device)  # noqa: E731
        out = {"post": g(L, B, self.V, self.K),
               "act": g(self.horizon, N, self.num_actions),
               "prior": g(self.horizon, N, self.V, self.K)}
        if N < n:
            out["pick"] = torch.randperm(n, generator=self._gen,
                                         device=self.device)[:N]
        return out

    def update(self, batch: Dict[str, np.ndarray],
               noise: Optional[Dict] = None) -> Dict[str, float]:
        """One world-model step, then one actor-critic step in the updated
        model's imagination. ``batch``: ``obs`` [B, L, obs_dim],
        ``actions`` [B, L] (the action taken at t), ``rewards``,
        ``dones``, ``is_first`` [B, L]. ``noise`` (default
        ``draw_noise``): Gumbel draws ``post`` [L, B, V, K] (the
        posterior samples), ``act`` [H, N, A] and ``prior`` [H, N, V, K]
        (imagination), and ``pick`` [N], the start states' indices into
        the flattened [B * L] posterior states when ``imag_starts`` < B
        * L (N = ``imag_starts``, else B * L)."""
        b = batch_to_device(batch, self.device)
        B, L = b["actions"].shape
        if noise is None:
            noise = self.draw_noise(B, L)
        else:
            noise = {k: torch.as_tensor(v).to(self.device)
                     for k, v in noise.items()}
        wm_loss, hs, zs = self._wm_loss(b, noise["post"].float())
        apply_grads(self.wm_opt, list(self.wm.parameters()), wm_loss,
                    self.grad_hook, "wm", lambda: to_numpy(self.wm, True),
                    max_norm=100.0)
        h = hs.detach().reshape(-1, self.deter)
        z = zs.detach().reshape(-1, self.z_dim)
        if "pick" in noise:
            pick = noise["pick"].long()
            h, z = h[pick], z[pick]
        ac_loss, lo, hi, ret_mean, ent = self._ac_loss(
            h, z, {k: noise[k].float() for k in ("act", "prior")})
        apply_grads(self.ac_opt, list(self.ac.parameters()), ac_loss,
                    self.grad_hook, "ac", lambda: to_numpy(self.ac, True),
                    max_norm=100.0)
        self.ret_lo, self.ret_hi = lo, hi
        return {k: float(v.detach()) for k, v in (
            ("wm_loss", wm_loss), ("ac_loss", ac_loss),
            ("imag_return", ret_mean), ("entropy", ent))}

    # ---- acting ----------------------------------------------------------

    @torch.no_grad()
    def act(self, state, obs, is_first, noise: Optional[Dict] = None,
            greedy: bool = False):
        """One policy step: ``state`` (h, z, previous actions) from
        ``init_state`` or the last call; ``noise`` (default from the
        learner's generator): Gumbel draws ``post`` [n, V, K] and ``act``
        [n, A]. Returns (the next state, the actions as numpy)."""
        h, z, a_prev = state
        obs = torch.as_tensor(np.asarray(obs, np.float32)).to(self.device)
        first = torch.as_tensor(np.asarray(is_first, np.float32)).to(
            self.device)
        n = obs.shape[0]
        if noise is None:
            noise = {"post": gumbel((n, self.V, self.K), self._gen,
                                    self.device),
                     "act": gumbel((n, self.num_actions), self._gen,
                                   self.device)}
        noise = {k: torch.as_tensor(v, dtype=torch.float32).to(self.device)
                 for k, v in noise.items()}
        emb = _mlp(self.wm["enc"], symlog(obs))
        a_hot = F.one_hot(a_prev.long(), self.num_actions).float()
        h, z, _ = self._wm_step(h, z, a_hot, emb, first, noise["post"])
        logits = self._actor_logits(torch.cat([h, z], -1))
        a = torch.argmax(logits if greedy else logits + noise["act"],
                         -1).to(torch.int32)
        return (h, z, a), a.cpu().numpy()

    def init_state(self, n: int):
        return (torch.zeros((n, self.deter), device=self.device),
                torch.zeros((n, self.z_dim), device=self.device),
                torch.zeros((n,), dtype=torch.int32, device=self.device))
