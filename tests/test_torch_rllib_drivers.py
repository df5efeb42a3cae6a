"""The port's RLlib drivers against ``ray_tpu.rllib``.

Environments and replay buffers are held to the reference's bit for bit
from one seed and one action sequence. The catalog's program runs
through both packages. Everything else runs in one module-scoped
fixture, each package on its own runtime (3 workers):

- Runners: ``EnvRunner``, both kinds of ``OffPolicyRunner`` and
  ``MultiAgentEnvRunner`` as actors on each runtime, given the
  reference module's weights. The numpy modules' batches and
  ``evaluate`` returns are equal bit for bit; the conv module's
  ``apply_np`` (torch on the CPU against XLA on the CPU) is not
  bit-exact, so its float columns agree at 1e-5, the tolerance of
  ``test_torch_rllib.py``'s ``apply_np`` check, and its actions,
  rewards and episode flags exactly.
- Drivers: PPO (MLP on CartPole, CNN on Catch), IMPALA and APPO (one
  runner: completion order is fixed), DQN (uniform and prioritized),
  SAC, multi-agent PPO and DreamerV3, 3 iterations each through both
  packages, the port's learners on the CPU (``learners(device="cpu")``).
  The reference runs first while its learners are recorded: their
  state after every update and the draws of every update and ``act``
  (PPO's permutations, SAC's Gaussian noise, DreamerV3's Gumbel noise
  and start picks and, for ``act``, the recurrent state it is given),
  all computed from the reference learner's own keys as
  ``test_torch_rllib.py`` and ``test_torch_dreamer.py`` compute them.
  The port's drivers then run with their learners wrapped in the test:
  before each call the wrapped learner takes the reference learner's
  state at that point (parameters, targets, Adam's moments and step),
  and each update gets the reference's draws. DreamerV3's ``act`` first
  holds the recurrent state the port driver carried from its last step
  to the reference's (h and z at 1e-5, the previous actions exactly),
  then acts from the reference's state. So every port update
  starts from the reference learner's state on the port driver's own
  batch, and the weights the port's runners act on are the
  reference's: trajectories cannot part through rounding in a learner.
  The result dicts have the same keys; counters, epsilon and
  ``episode_return_mean`` are equal; losses agree at atol 1e-5 / rtol
  1e-4 (``test_torch_dreamer.py``'s and ``chip_smoke.py`` phase 10's
  limits; SAC's q loss on Pendulum is ~1e3, where float32 holds ~1e-4
  absolute); the batches each learner was given are equal (bit for bit,
  or at 1e-5 in float columns for the conv runners).
- Port-only: IMPALA with 2 runners keeps one sample in flight per
  runner; ``policies_to_train`` freezes the other policy bit for bit;
  ``learners(device=None)`` raises without CUDA, and ``stop()`` leaves
  the runners dead.
"""

import threading
import traceback

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import ray_tpu  # noqa: E402
import ray_tpu.rllib as rl  # noqa: E402
import ray_tpu_torch  # noqa: E402
import ray_tpu_torch.rllib as prl  # noqa: E402
from ray_tpu.rllib import env_runner as ref_runner  # noqa: E402
from ray_tpu.rllib import envs as ref_envs  # noqa: E402
from ray_tpu.rllib import multi_agent as ref_ma  # noqa: E402
from ray_tpu.rllib import replay_buffer as ref_rb  # noqa: E402
from ray_tpu.rllib import rl_module as ref_rm  # noqa: E402
from ray_tpu_torch.rllib import dreamer as pdr  # noqa: E402
from ray_tpu_torch.rllib import env_runner as port_runner  # noqa: E402
from ray_tpu_torch.rllib import envs as port_envs  # noqa: E402
from ray_tpu_torch.rllib import multi_agent as port_ma  # noqa: E402
from ray_tpu_torch.rllib import replay_buffer as port_rb  # noqa: E402
from ray_tpu_torch.rllib import rl_module as port_rm  # noqa: E402

torch.set_num_threads(1)

ATOL, RTOL = 1e-5, 1e-4
EXACT = ("training_iteration", "num_env_steps_sampled", "epsilon",
         "episode_return_mean", "iteration", "env_steps")


def _np(tree):
    """A copy of a jax tree as numpy (the reference donates buffers)."""
    return jax.tree_util.tree_map(lambda a: np.array(a, copy=True), tree)


# ------------------------------------------------------------ environments

ENV_NAMES = ["CartPole-v1", "Pendulum-v1", "CatchPixels-v0"]


def _env_actions(rng, env, n):
    if getattr(env, "num_actions", None):
        return rng.integers(0, env.num_actions, n)
    return rng.uniform(-2.5, 2.5, (n, env.action_dim))


@pytest.mark.parametrize("name", ENV_NAMES)
def test_env_trajectories_equal_bit_for_bit(name):
    ref, port = ref_envs.make_env(name, 6, seed=3), port_envs.make_env(
        name, 6, seed=3)
    np.testing.assert_array_equal(port.reset(), ref.reset())
    rng = np.random.default_rng(0)
    ends = 0
    for _ in range(260):
        a = _env_actions(rng, ref, 6)
        want, got = ref.step(a), port.step(a.copy())
        for w, g in zip(want, got):
            assert w.dtype == g.dtype
            np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(port.final_obs, ref.final_obs)
        ends += int((want[2] | want[3]).sum())
    assert ends > 0   # the auto-reset draws were compared too
    with pytest.raises(ValueError, match="unknown env"):
        port_envs.make_env("Nope-v0", 1)


def test_multi_agent_env_equal_bit_for_bit():
    ref = ref_ma.make_multi_agent_env("Coordination-v0", 5, seed=2)
    port = port_ma.make_multi_agent_env("Coordination-v0", 5, seed=2)
    for a in ref.agents:
        np.testing.assert_array_equal(port.reset()[a], ref.reset()[a])
    rng = np.random.default_rng(1)
    for _ in range(30):
        acts = {a: rng.integers(0, 3, 5) for a in ref.agents}
        (ro, rr, rt_, rtr), (po, pr, pt, ptr) = ref.step(acts), port.step(
            {a: v.copy() for a, v in acts.items()})
        for a in ref.agents:
            np.testing.assert_array_equal(po[a], ro[a])
            np.testing.assert_array_equal(pr[a], rr[a])
            np.testing.assert_array_equal(port.final_obs[a],
                                          ref.final_obs[a])
        np.testing.assert_array_equal(pt, rt_)
        np.testing.assert_array_equal(ptr, rtr)
    with pytest.raises(ValueError, match="unknown multi-agent env"):
        port_ma.make_multi_agent_env("Nope-v0", 1)


# ---------------------------------------------------------- replay buffers


def _transitions(rng, n):
    return {"obs": rng.normal(size=(n, 4)).astype(np.float32),
            "actions": rng.integers(0, 2, n).astype(np.int32),
            "rewards": rng.normal(size=n).astype(np.float32),
            "dones": (rng.random(n) < 0.1).astype(np.float32)}


@pytest.mark.parametrize("prioritized", [False, True])
def test_replay_buffer_samples_equal_bit_for_bit(prioritized):
    if prioritized:
        ref, port = (m.PrioritizedReplayBuffer(50, alpha=0.7, beta=0.5,
                                               seed=4)
                     for m in (ref_rb, port_rb))
    else:
        ref, port = ref_rb.ReplayBuffer(50, seed=4), port_rb.ReplayBuffer(
            50, seed=4)
    rng = np.random.default_rng(5)
    for step in range(6):   # 6 x 13 rows wrap the 50-row ring
        b = _transitions(rng, 13)
        ref.add_batch(b)
        port.add_batch({k: v.copy() for k, v in b.items()})
        assert len(port) == len(ref)
        if not prioritized:
            want, got = ref.sample(7), port.sample(7)
            for k in want:
                np.testing.assert_array_equal(got[k], want[k])
        want, got = ref.sample_many(3, 5), port.sample_many(3, 5)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
        if prioritized:
            td = rng.normal(size=(3, 5)) * (step + 1)
            ref.update_priorities(want["_indices"], td)
            port.update_priorities(got["_indices"], td.copy())
            np.testing.assert_array_equal(port._probs(), ref._probs())
            assert port._max_prio == ref._max_prio


def test_dreamer_sequence_replay_equal_bit_for_bit():
    """``_SeqReplay`` through its ring's wrap: windows never straddle the
    write head, and the same numpy generator draws the same windows."""
    from ray_tpu.rllib import dreamer as ref_dr

    ref, port = ref_dr._SeqReplay(3, 4, capacity=10), pdr._SeqReplay(
        3, 4, capacity=10)
    rng = np.random.default_rng(6)
    r_rng, p_rng = np.random.default_rng(7), np.random.default_rng(7)
    for step in range(25):
        row = (rng.normal(size=(3, 4)).astype(np.float32),
               rng.integers(0, 2, 3), rng.normal(size=3),
               (rng.random(3) < 0.2).astype(np.float32),
               (rng.random(3) < 0.2).astype(np.float32))
        ref.add(*row)
        port.add(*(np.copy(x) for x in row))
        assert (len(port), port.full) == (len(ref), ref.full)
        if len(ref) >= 6:
            want, got = ref.sample(r_rng, 5, 6), port.sample(p_rng, 5, 6)
            assert sorted(got) == sorted(want)
            for k in want:
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k])
    assert port.full


# ------------------------------------------------------------------ catalog


def _catalog_program(pkg, envs, rm, weights_of):
    """``test_rllib.py::test_model_catalog_space_dispatch``'s program,
    returning what it asserts on."""
    Box, Catalog, Discrete = pkg.Box, pkg.Catalog, pkg.Discrete
    out = []
    m = Catalog.get_module(Box((4,)), Discrete(2))
    out.append((type(m).__name__, m.obs_dim))
    m = Catalog.get_module(Box((8, 8, 1)), Discrete(3))
    out.append((type(m).__name__, m.obs_shape))
    m = Catalog.get_module(Box((3,)), Box((1,), low=-2.0, high=2.0))
    out.append((type(m).__name__, m.action_low, m.action_high))
    out.append(type(Catalog.get_q_module(Box((4,)), Discrete(2))).__name__)
    out.append(type(Catalog.get_q_module(Box((3,)), Box((1,)))).__name__)
    for name in ENV_NAMES:
        obs, act = Catalog.spaces_of(envs.make_env(name, 1))
        out.append((repr(obs), repr(act), obs.shape,
                    getattr(act, "n", None), getattr(act, "low", None)))

    class Tiny(rm.MLPModule):
        pass

    Catalog.register_custom_model(
        "tiny", lambda o, a, mc: Tiny(o.shape[0], a.n, hidden=(8,)))
    m = Catalog.get_module(Box((4,)), Discrete(2), {"custom_model": "tiny"})
    out.append((isinstance(m, Tiny), m.hidden))
    m = Catalog.get_module(Box((4,)), Discrete(2))
    logits, v = m.apply_np(weights_of(m), np.zeros((5, 4), np.float32))
    out.append((logits.shape, v.shape))
    for bad in ((Box((2, 2)), Discrete(2)), (Box((4, 4, 1)), Box((1,))),
                (Box((4,)), "space")):
        try:
            Catalog.get_module(*bad)
            out.append("no error")
        except ValueError as e:
            out.append(str(e))
    return out


def test_catalog_program_matches_reference():
    want = _catalog_program(
        rl, ref_envs, ref_rm,
        lambda m: {k: _np(v) for k, v in m.init_params(0).items()})
    got = _catalog_program(
        prl, port_envs, port_rm,
        lambda m: port_rm.to_numpy(m.init_params(0, "cpu")))
    assert got == want
    assert isinstance(prl.Catalog.get_module(prl.Box((10, 10, 1)),
                                             prl.Discrete(3)),
                      port_rm.CNNModule)


# -------------------------------------------------- learner state and draws


def _adam_into(module, opt, optax_state):
    """Load the Adam moments and step count inside an optax chain's state
    into ``opt``'s state for ``module``'s parameters (conv moments
    transposed HWIO -> OIHW like the kernels)."""
    adam = pdr._adam_state(optax_state)
    mu = port_rm.tree_leaves(adam.mu)
    nu = port_rm.tree_leaves(adam.nu)
    step = torch.tensor(float(np.asarray(adam.count)))

    def t(a, p):
        a = np.asarray(a, np.float32)
        if a.ndim == 4:
            a = a.transpose(3, 2, 0, 1)
        return torch.from_numpy(a.copy()).to(p.device)

    for path, p in pdr._param_paths(module).items():
        opt.state[p] = {"step": step.clone(), "exp_avg": t(mu[path], p),
                        "exp_avg_sq": t(nu[path], p)}


def _load_scalar(param, opt, value, optax_state):
    adam = pdr._adam_state(optax_state)
    with torch.no_grad():
        param.copy_(torch.tensor(float(np.asarray(value))))
    opt.state[param] = {
        "step": torch.tensor(float(np.asarray(adam.count))),
        "exp_avg": torch.tensor(float(np.asarray(adam.mu))),
        "exp_avg_sq": torch.tensor(float(np.asarray(adam.nu)))}


# What each learner kind snapshots on the reference (attribute names) and
# how a port learner takes such a snapshot.
SNAP = {
    "ppo": ("params", "opt_state"),
    "impala": ("params", "opt_state"),
    "appo": ("params", "opt_state", "target_params", "_updates"),
    "dqn": ("params", "target_params", "opt_state"),
    "sac": ("pi_params", "q_params", "q_target", "log_alpha", "pi_opt",
            "q_opt", "a_opt"),
    "dreamer": ("wm_params", "ac_params", "wm_opt", "ac_opt", "ret_lo",
                "ret_hi"),
}


def _load(kind, lrn, s):
    load = port_rm.params_from_numpy
    if kind in ("ppo", "impala", "appo", "dqn"):
        load(lrn.module, s["params"])
        _adam_into(lrn.module, lrn.opt, s["opt_state"])
        if kind == "appo":
            load(lrn.target, s["target_params"])
            lrn._updates = int(s["_updates"])
        if kind == "dqn":
            load(lrn.target, s["target_params"])
    elif kind == "sac":
        load(lrn.actor, s["pi_params"])
        load(lrn.critic, s["q_params"])
        load(lrn.q_target, s["q_target"])
        _adam_into(lrn.actor, lrn.pi_opt, s["pi_opt"])
        _adam_into(lrn.critic, lrn.q_opt, s["q_opt"])
        _load_scalar(lrn.log_alpha, lrn.a_opt, s["log_alpha"], s["a_opt"])
    else:
        load(lrn.wm, s["wm_params"])
        load(lrn.ac, s["ac_params"])
        lrn.load_opt_state(s["wm_opt"], s["ac_opt"], s["ret_lo"],
                           s["ret_hi"])


def _ppo_perms(lrn, n):
    """The permutations ``ray_tpu``'s PPO update draws from its key."""
    _, key = jax.random.split(lrn._rng)
    E, mb = lrn._num_epochs, lrn._mb
    num_mb = n // mb
    return np.stack([np.asarray(jax.random.permutation(k, n))[:num_mb * mb]
                     for k in jax.random.split(key, E)]).reshape(
                         E, num_mb, mb)


def _sac_noise(lrn, U, B, D):
    """The normals ``ray_tpu``'s SAC update draws: per update one for the
    critic target's sample, one for the actor's."""
    _, key = jax.random.split(lrn._rng)
    out = np.zeros((U, 2, B, D), np.float32)
    for u, k in enumerate(jax.random.split(key, U)):
        for j, kk in enumerate(jax.random.split(k)):
            out[u, j] = np.asarray(jax.random.normal(kk, (B, D)))
    return out


def _gumbel(k, *s):
    return np.asarray(jax.random.gumbel(k, s))


def _dreamer_noise(lrn, key, B, L):
    """The draws ``ray_tpu``'s DreamerV3 ``_update_impl`` makes from
    ``key`` (``test_torch_dreamer.py::_noise``)."""
    V, K, H, A, n = lrn.V, lrn.K, lrn.horizon, lrn.num_actions, B * L
    k1, k2 = jax.random.split(key)
    post, k = [], k1
    for _ in range(L):
        k, sub = jax.random.split(k)
        post.append(_gumbel(sub, B, V, K))
    out = {"post": np.stack(post)}
    N = n
    if lrn.imag_starts and lrn.imag_starts < n:
        k2, ksub = jax.random.split(k2)
        N = lrn.imag_starts
        out["pick"] = np.asarray(jax.random.permutation(ksub, n))[:N]
    act, prior, k = [], [], k2
    for _ in range(H):
        k, ka, kp = jax.random.split(k, 3)
        act.append(_gumbel(ka, N, A))
        prior.append(_gumbel(kp, N, V, K))
    out.update(act=np.stack(act), prior=np.stack(prior))
    return out


class _Shadow:
    """A reference learner recorded, and a port learner replaying it.

    ``record(ref)`` wraps the reference learner: the state before its
    first call and after every update, the draws of every update and
    ``act`` and the batches it was given. ``replay(port)`` wraps the
    port learner: before every call it takes the reference's state at
    that point, and each update and ``act`` gets the reference's draws.
    """

    def __init__(self, kind):
        self.kind = kind
        self.states, self.draws, self.acts = [], [], []
        self.ref_batches, self.port_batches = [], []
        self.port_acts = 0

    def _snap(self, lrn):
        self.states.append({k: _np(getattr(lrn, k)) for k in SNAP[self.kind]})

    def record(self, lrn):
        self._snap(lrn)
        kind = self.kind
        if kind == "dreamer":
            update, act = lrn.update, lrn.act

            def rec_update(batch, key):
                B, L = batch["actions"].shape
                self.draws.append(_dreamer_noise(lrn, key, B, L))
                self.ref_batches.append(_np(batch))
                out = update(batch, key)
                self._snap(lrn)
                return out

            def rec_act(state, obs, is_first, key, greedy=False):
                k1, k2 = jax.random.split(key)
                n = obs.shape[0]
                self.acts.append((len(self.states) - 1, _np(state), {
                    "post": _gumbel(k1, n, lrn.V, lrn.K),
                    "act": _gumbel(k2, n, lrn.num_actions)}))
                return act(state, obs, is_first, key, greedy)

            lrn.update, lrn.act = rec_update, rec_act
            return
        name = "update_many" if kind in ("dqn", "sac") else "update"
        update = getattr(lrn, name)

        def rec(batch):
            if kind == "ppo":
                self.draws.append(_ppo_perms(lrn, len(batch["obs"])))
            elif kind == "sac":
                U, B = batch["rewards"].shape
                self.draws.append(_sac_noise(lrn, U, B,
                                             lrn.actor.action_dim))
            self.ref_batches.append(_np(batch))
            out = update(batch)
            self._snap(lrn)
            return out

        setattr(lrn, name, rec)

    def replay(self, lrn):
        kind = self.kind
        done = [0]        # updates taken
        loaded = [None]   # the reference state index the port holds

        def hold():
            if loaded[0] != done[0]:
                _load(kind, lrn, self.states[done[0]])
                loaded[0] = done[0]

        def after_update():
            done[0] += 1

        if kind == "dreamer":
            update, act = lrn.update, lrn.act

            def rep_update(batch, noise=None):
                hold()
                self.port_batches.append(batch)
                out = update(batch, noise=self.draws[done[0]])
                after_update()
                return out

            calls = iter(self.acts)

            def rep_act(state, obs, is_first, noise=None, greedy=False):
                hold()
                version, ref_state, ref_noise = next(calls)
                assert version == done[0]
                # the driver carries its RSSM state: (h, z) at the
                # runners' 1e-5, the previous actions exactly; only then
                # the reference's state, so near-ties cannot part the two
                _assert_same(tuple(s.cpu().numpy() for s in state),
                             ref_state, ATOL,
                             f"dreamer act {self.port_acts} state")
                self.port_acts += 1
                state = tuple(torch.as_tensor(np.asarray(s)) for s in
                              ref_state)
                return act(state, obs, is_first, ref_noise, greedy)

            lrn.update, lrn.act = rep_update, rep_act
            return
        get_weights = lrn.get_weights

        def rep_get_weights():
            hold()
            return get_weights()

        lrn.get_weights = rep_get_weights
        name = "update_many" if kind in ("dqn", "sac") else "update"
        update = getattr(lrn, name)

        def rep(batch):
            hold()
            self.port_batches.append(batch)
            if kind == "ppo":
                out = update(batch, perms=self.draws[done[0]])
            elif kind == "sac":
                out = update(batch, noise=self.draws[done[0]])
            else:
                out = update(batch)
            after_update()
            return out

        setattr(lrn, name, rep)


# --------------------------------------------------------------- programs
# A program is a pair of halves: the reference's (None for a port-only
# program), and the port's, which gets what the reference's returned.

PROGRAMS = {}


def program(fn):
    PROGRAMS[fn.__name__] = fn
    return fn


def _ref_weights(module, seed):
    return _np(module.init_params(seed))


def _runner_program(make, calls):
    """One runner on each runtime, the same calls on both."""
    def half(runner_mod, ma_mod, api):
        actor = make(runner_mod, ma_mod)
        try:
            return [api.get(getattr(actor, method).remote(*args),
                            timeout=120) for method, args in calls]
        finally:
            api.kill(actor)

    return (lambda: half(ref_runner, ref_ma, ray_tpu),
            lambda ref: {"ref": ref,
                         "port": half(port_runner, port_ma, ray_tpu_torch)})


@program
def runner_mlp():
    w = _ref_weights(ref_rm.MLPModule(4, 2, hidden=(16, 16)), 1)
    spec = {"obs_dim": 4, "num_actions": 2, "hidden": (16, 16)}
    return _runner_program(
        lambda m, ma: m.EnvRunner.remote("CartPole-v1", 4, 24, spec,
                                         gamma=0.97, seed=7),
        [("sample", (w,)), ("sample_sequences", (w,)), ("sample", (w,)),
         ("evaluate", (w, 3))])


@program
def runner_cnn():
    mod = ref_rm.CNNModule((10, 10, 1), 3, channels=(4, 8), hidden=(16,))
    w = _ref_weights(mod, 2)
    spec = {"obs_dim": 100, "num_actions": 3, "obs_shape": (10, 10, 1),
            "channels": (4, 8), "hidden": (16,)}
    return _runner_program(
        lambda m, ma: m.EnvRunner.remote("CatchPixels-v0", 4, 12, spec,
                                         seed=3),
        [("sample", (w,)), ("sample_sequences", (w,)),
         ("evaluate", (w, 3))])


@program
def runner_dqn():
    w = _ref_weights(ref_rm.QMLPModule(4, 2, hidden=(16,)), 3)
    spec = {"obs_dim": 4, "num_actions": 2, "hidden": (16,)}
    return _runner_program(
        lambda m, ma: m.OffPolicyRunner.remote("CartPole-v1", 4, spec,
                                               kind="dqn", seed=5),
        [("sample_transitions", (w, 60, 0.5)),
         ("sample_transitions", (w, 10, 0.0)), ("evaluate", (w, 3))])


@program
def runner_sac():
    spec = {"obs_dim": 3, "action_dim": 1, "action_low": -2.0,
            "action_high": 2.0, "hidden": (16,)}
    w = _ref_weights(ref_rm.SquashedGaussianModule(**spec), 4)
    return _runner_program(
        lambda m, ma: m.OffPolicyRunner.remote("Pendulum-v1", 3, spec,
                                               kind="sac", seed=6),
        [("sample_transitions", (w, 205)), ("sample_transitions", (w, 5)),
         ("evaluate", (w, 2))])


@program
def runner_multi_agent():
    spec = {"obs_dim": 6, "num_actions": 3, "hidden": (16,)}
    w = {"p0": _ref_weights(ref_rm.MLPModule(**spec), 1),
         "p1": _ref_weights(ref_rm.MLPModule(**spec), 2)}
    return _runner_program(
        lambda m, ma: ma.MultiAgentEnvRunner.remote(
            "Coordination-v0", 4, 10, spec, ["p0", "p1"],
            {"a0": "p0", "a1": "p1"}, gamma=0.9, seed=8),
        [("sample", (w,)), ("sample", (w,))])


def _learners(algo):
    return (algo.learners if isinstance(getattr(algo, "learners", None),
                                        dict) else {"": algo.learner})


def _iterate(algo, iters):
    """``iters`` results of ``train()`` and what the driver holds after
    them; the runners are stopped."""
    try:
        res = [algo.train() for _ in range(iters)]
        extra = {}
        if hasattr(algo, "buffer"):
            extra["size"] = len(algo.buffer)
            if hasattr(algo.buffer, "_prio"):
                extra["prio"] = algo.buffer._prio.copy()
                extra["max_prio"] = algo.buffer._max_prio
        if hasattr(algo, "_inflight"):
            extra["inflight"] = len(algo._inflight)
    finally:
        algo.stop()
    return {"results": res, "extra": extra}


def _drive(build, kind, iters=3):
    """The reference's driver with its learners recorded, then the
    port's with its learners replaying them."""
    def ref_half():
        algo = build("ref")
        shadows = {}
        for pid, lrn in _learners(algo).items():
            shadows[pid] = _Shadow(kind)
            shadows[pid].record(lrn)
        return shadows, _iterate(algo, iters)

    def port_half(ref):
        shadows, ref_out = ref
        algo = build("port")
        for pid, lrn in _learners(algo).items():
            shadows[pid].replay(lrn)
        out = _iterate(algo, iters)
        return {"ref": ref_out, "port": out,
                "batches": {pid: (s.ref_batches, s.port_batches)
                            for pid, s in shadows.items()}}

    return ref_half, port_half


def _pkg(side):
    return rl if side == "ref" else prl


def _cpu(cfg, side):
    return cfg.learners(device="cpu") if side == "port" else cfg


@program
def ppo_mlp_cartpole():
    def build(side):
        cfg = (_pkg(side).PPOConfig().environment("CartPole-v1")
               .env_runners(num_env_runners=2, num_envs_per_env_runner=4,
                            rollout_fragment_length=32)
               .training(lr=1e-3, num_epochs=2, minibatch_size=64)
               .debugging(seed=0))
        return _cpu(cfg, side).build()
    return _drive(build, "ppo")


@program
def ppo_cnn_catch():
    def build(side):
        cfg = (_pkg(side).PPOConfig().environment("CatchPixels-v0")
               .env_runners(num_env_runners=2, num_envs_per_env_runner=4,
                            rollout_fragment_length=16)
               .training(lr=1e-3, num_epochs=2, minibatch_size=64)
               .rl_module(hidden=(32,)).debugging(seed=0))
        return _cpu(cfg, side).build()
    return _drive(build, "ppo")


@program
def impala_cartpole():
    def build(side):
        cfg = (_pkg(side).IMPALAConfig().environment("CartPole-v1")
               .env_runners(num_env_runners=1, num_envs_per_env_runner=4,
                            rollout_fragment_length=16)
               .training(lr=1e-3, batches_per_iter=3).debugging(seed=1))
        return _cpu(cfg, side).build()
    return _drive(build, "impala")


@program
def appo_catch():
    def build(side):
        cfg = (_pkg(side).APPOConfig().environment("CatchPixels-v0")
               .env_runners(num_env_runners=1, num_envs_per_env_runner=4,
                            rollout_fragment_length=12)
               .training(batches_per_iter=2, target_update_freq=2)
               .rl_module(hidden=(32,)).debugging(seed=2))
        return _cpu(cfg, side).build()
    return _drive(build, "appo")


def _dqn(prioritized):
    def build(side):
        cfg = (_pkg(side).DQNConfig().environment("CartPole-v1")
               .env_runners(num_env_runners=2, num_envs_per_env_runner=4,
                            rollout_fragment_length=16)
               .rl_module(hidden=(32, 32)).debugging(seed=3))
        cfg.train_kwargs.update(learning_starts=128, updates_per_iter=4,
                                batch_size=32, epsilon_decay_steps=500,
                                prioritized_replay=prioritized)
        return _cpu(cfg, side).build()
    return _drive(build, "dqn")


@program
def dqn_uniform():
    return _dqn(False)


@program
def dqn_prioritized():
    return _dqn(True)


@program
def sac_pendulum():
    def build(side):
        cfg = (_pkg(side).SACConfig().environment("Pendulum-v1")
               .env_runners(num_env_runners=2, num_envs_per_env_runner=4,
                            rollout_fragment_length=8)
               .rl_module(hidden=(32, 32)).debugging(seed=4))
        cfg.train_kwargs.update(learning_starts=64, updates_per_iter=2,
                                batch_size=32)
        return _cpu(cfg, side).build()
    return _drive(build, "sac")


def _multi_agent(to_train):
    def build(side):
        cfg = (_pkg(side).MultiAgentPPOConfig()
               .environment("Coordination-v0")
               .env_runners(num_env_runners=2, num_envs_per_env_runner=4,
                            rollout_fragment_length=16)
               .training(lr=1e-3, gamma=0.95, num_epochs=2,
                         minibatch_size=64)
               .debugging(seed=5)
               .multi_agent(policies=["p0", "p1"],
                            policy_mapping_fn=lambda a: ("p0" if a == "a0"
                                                         else "p1"),
                            policies_to_train=to_train))
        return _cpu(cfg, side).build()
    return build


@program
def multi_agent_ppo():
    return _drive(_multi_agent(None), "ppo")


@program
def multi_agent_frozen():
    build = _multi_agent(["p0"])
    ref_half, port_half = _drive(build, "ppo")

    def frozen(ref):
        out = port_half(ref)
        algo = build("port")   # unwrapped: its own draws
        try:
            before = algo.learners["p1"].get_weights()
            trained = algo.learners["p0"].get_weights()
            res = algo.train()
            out["frozen"] = (before, algo.learners["p1"].get_weights(), res,
                             trained, algo.learners["p0"].get_weights(),
                             algo.evaluate(8))
        finally:
            algo.stop()
        return out

    return ref_half, frozen


@program
def dreamer_cartpole():
    def build(side):
        cfg = (_pkg(side).DreamerV3Config().environment("CartPole-v1")
               .env_runners(num_envs_per_env_runner=4).debugging(seed=6))
        cfg.train_kwargs.update(
            steps_per_iter=8, update_every=8, learning_starts=32,
            seq_len=8, batch_size=4, deter=32, units=32, stoch_vars=4,
            stoch_classes=4, imag_starts=16, horizon=5)
        return _cpu(cfg, side).build()
    return _drive(build, "dreamer")


@program
def impala_two_runners_in_flight():
    def port_half(_):
        cfg = (prl.IMPALAConfig().environment("CartPole-v1")
               .env_runners(num_env_runners=2, num_envs_per_env_runner=2,
                            rollout_fragment_length=8)
               .training(batches_per_iter=3).learners(device="cpu"))
        algo = cfg.build()
        seen = []
        try:
            for _ in range(3):
                algo.train()
                seen.append((len(algo._inflight),
                             sorted(id(r) for r in algo._inflight.values()),
                             sorted(id(r) for r in algo.runners)))
            seen.append(algo.evaluate(2))
        finally:
            algo.stop()
        return seen

    return None, port_half


@program
def stop_kills_runners():
    def port_half(_):
        algo = (prl.PPOConfig().env_runners(num_env_runners=2,
                                            num_envs_per_env_runner=2,
                                            rollout_fragment_length=8)
                .learners(device="cpu").build())
        w = algo.learner.get_weights()
        first = ray_tpu_torch.get(algo.runners[0].sample.remote(w),
                                  timeout=60)["obs"].shape
        algo.stop()
        errors = []
        for r in algo.runners:
            try:
                ray_tpu_torch.get(r.sample.remote(w), timeout=60)
                errors.append(None)
            except Exception as e:  # noqa: BLE001 - the type is the result
                errors.append(type(e).__name__)
        return first, errors

    return None, port_half


# ------------------------------------------------------------ the fixture

# the port-only programs first, then the runners, then the drivers
ORDER = ["impala_two_runners_in_flight", "stop_kills_runners",
         "runner_mlp", "runner_cnn", "runner_dqn", "runner_sac",
         "runner_multi_agent", "ppo_mlp_cartpole", "dreamer_cartpole"]
ORDER += [name for name in PROGRAMS if name not in ORDER]


def _run(fn, *args):
    try:
        return fn(*args)
    except Exception:  # noqa: BLE001 - reported by the test
        return ("raised", traceback.format_exc()[-3000:])


def _raised(out):
    return isinstance(out, tuple) and len(out) == 2 and out[0] == "raised"


@pytest.fixture(scope="module")
def outcomes():
    """Every program, the reference's and the port's runtimes up at once
    (3 workers each), one half after the other: the reference's half,
    then the port's, which gets what the reference's returned."""
    ray_tpu.init(num_workers=3, object_store_memory=128 << 20)
    ray_tpu_torch.init(num_workers=3, object_store_memory=128 << 20)
    got = {}

    def run_all():
        for name in ORDER:
            pair = _run(PROGRAMS[name])
            if _raised(pair):
                got[name] = pair
                continue
            ref = None if pair[0] is None else _run(pair[0])
            got[name] = ref if _raised(ref) else _run(pair[1], ref)

    try:
        t = threading.Thread(target=run_all)
        t.start()
        t.join(timeout=600)
        assert not t.is_alive(), "a program hung"
    finally:
        ray_tpu_torch.shutdown()
        ray_tpu.shutdown()
    return got


def _outcome(outcomes, name):
    out = outcomes[name]
    if _raised(out):
        pytest.fail(f"{name} raised:\n{out[1]}")
    return out


def _assert_same(got, want, tol, what):
    """Equal structure; arrays equal (``tol`` None) or float arrays within
    ``tol`` and the rest equal."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), what
        for k in want:
            _assert_same(got[k], want[k], tol, f"{what}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, tol, f"{what}[{i}]")
    else:
        g, w = np.asarray(got), np.asarray(want)
        assert g.dtype == w.dtype and g.shape == w.shape, (
            f"{what}: {g.dtype}{g.shape} against {w.dtype}{w.shape}")
        if tol is None or w.dtype.kind != "f":
            np.testing.assert_array_equal(g, w, err_msg=what)
        else:
            np.testing.assert_allclose(g, w, atol=tol, rtol=0, err_msg=what)


# the runners whose module is numpy: bit for bit; the conv runner: 1e-5
RUNNERS = {"runner_mlp": None, "runner_dqn": None, "runner_sac": None,
           "runner_multi_agent": None, "runner_cnn": ATOL}


@pytest.mark.parametrize("name", sorted(RUNNERS))
def test_runner_batches_match_reference(outcomes, name):
    out = _outcome(outcomes, name)
    _assert_same(out["port"], out["ref"], RUNNERS[name], name)
    # something happened: episodes ended inside the rollouts
    assert any(len(b.get("episode_returns", ())) for b in out["ref"]
               if isinstance(b, dict))


def _assert_results(got, want, what):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert sorted(g) == sorted(w), f"{what} iteration {i + 1} keys"
        for k in w:
            if k == "time_this_iter_s":
                continue
            if k in EXACT:
                assert g[k] == w[k], f"{what} iteration {i + 1} {k}"
            else:
                np.testing.assert_allclose(
                    g[k], w[k], atol=ATOL, rtol=RTOL,
                    err_msg=f"{what} iteration {i + 1} {k}")


# batches bit for bit but where the conv runners act, and where the
# importance weights of prioritized replay come from the port's TD errors
DRIVERS = {"ppo_mlp_cartpole": None, "ppo_cnn_catch": ATOL,
           "impala_cartpole": None, "appo_catch": ATOL,
           "dqn_uniform": None, "dqn_prioritized": ATOL,
           "sac_pendulum": None, "multi_agent_ppo": None,
           "multi_agent_frozen": None, "dreamer_cartpole": None}


@pytest.mark.parametrize("name", sorted(DRIVERS))
def test_driver_iterations_match_reference(outcomes, name):
    out = _outcome(outcomes, name)
    ref, port = out["ref"], out["port"]
    _assert_results(port["results"], ref["results"], name)
    assert any(len(want) for want, _ in out["batches"].values()), (
        f"{name}: no update in 3 iterations")
    for pid, (want, got) in out["batches"].items():
        _assert_same(got, want, DRIVERS[name], f"{name} {pid} batches")
    for k, w in ref["extra"].items():
        if k == "prio":
            np.testing.assert_allclose(port["extra"][k], w, rtol=RTOL,
                                       atol=ATOL)
            assert not np.all(w[:port["extra"]["size"]] == w[0])
        elif k == "max_prio":
            np.testing.assert_allclose(port["extra"][k], w, rtol=RTOL)
        else:
            assert port["extra"][k] == w, f"{name} {k}"


def test_multi_agent_policies_to_train_freezes(outcomes):
    out = _outcome(outcomes, "multi_agent_frozen")
    before, after, res, trained0, trained1, ret = out["frozen"]
    _assert_same(after, before, None, "frozen policy")
    assert any(not np.array_equal(a, b) for a, b in zip(
        port_rm.tree_leaves(trained1).values(),
        port_rm.tree_leaves(trained0).values()))
    assert not any(k.startswith("p1/") for k in res)
    assert any(k.startswith("p0/") for k in res)
    assert 0.0 <= ret <= 8.0


def test_impala_keeps_one_sample_in_flight_per_runner(outcomes):
    seen = _outcome(outcomes, "impala_two_runners_in_flight")
    for n, inflight, runners in seen[:-1]:
        assert n == 2 and inflight == runners
    assert np.isfinite(seen[-1])


def test_stop_leaves_the_runners_dead(outcomes):
    shape, errors = _outcome(outcomes, "stop_kills_runners")
    assert shape == (16, 4)
    assert errors == ["ActorDiedError", "ActorDiedError"]


def test_drivers_build_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is valid here")
    for cfg in (prl.PPOConfig(), prl.IMPALAConfig(), prl.APPOConfig(),
                prl.DQNConfig(), prl.SACConfig(), prl.MultiAgentPPOConfig(),
                prl.DreamerV3Config()):
        with pytest.raises(RuntimeError, match="CUDA"):
            cfg.learners().build()


def test_multi_agent_mapping_validation():
    cfg = prl.MultiAgentPPOConfig().learners(device="cpu").multi_agent(
        policies=["only"], policy_mapping_fn=lambda a: "nope")
    with pytest.raises(ValueError, match="unknown policies"):
        cfg.build()


def test_exports():
    names = ("AlgorithmConfig", "PPO", "PPOConfig", "IMPALA",
             "IMPALAConfig", "APPO", "APPOConfig", "DQN", "DQNConfig", "SAC",
             "SACConfig", "DreamerV3", "DreamerV3Config", "MultiAgentPPO",
             "MultiAgentPPOConfig", "Catalog", "Box", "Discrete",
             "ReplayBuffer", "PrioritizedReplayBuffer", "BCLearner",
             "CQLLearner", "MARWILLearner", "train_offline", "MLPModule",
             "QMLPModule", "SquashedGaussianModule", "TwinQModule",
             "PolicyClient", "PolicyServerInput")
    for name in names:
        assert hasattr(rl, name) and hasattr(prl, name), name
