"""The port's RL modules and learners against ``ray_tpu.rllib``.

Each module's forward and ``apply_np`` are held to the reference's
``apply`` on the reference's own parameters, carried over through numpy.
V-trace is held to the reference's ``_vtrace`` and to a direct numpy
recursion. Each learner takes one update (two for the stacked
``update_many`` learners) from the same parameters and batch as its
``ray_tpu`` counterpart: the metrics agree at 1e-5; the first gradients,
which the port's ``grad_hook`` sees before the clip and the step and the
reference's optimizer records (a wrapper around its optax chain), at
atol 1e-5 / rtol 1e-4; the parameters after the update within 0.2 lr
per step (Adam's first step is g/(|g| + eps), so a gradient within
rounding of zero can move a weight by up to that much).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
optax = pytest.importorskip("optax")

import jax.numpy as jnp  # noqa: E402

from ray_tpu.rllib import rl_module as jrm  # noqa: E402
from ray_tpu_torch.rllib import rl_module as trm  # noqa: E402
from ray_tpu_torch.rllib.appo import AppoLearner  # noqa: E402
from ray_tpu_torch.rllib.dqn import DQNLearner  # noqa: E402
from ray_tpu_torch.rllib.impala import ImpalaLearner  # noqa: E402
from ray_tpu_torch.rllib.learner import PPOLearner  # noqa: E402
from ray_tpu_torch.rllib.offline import (BCLearner, CQLLearner,  # noqa: E402
                                         MARWILLearner)
from ray_tpu_torch.rllib.sac import SACLearner  # noqa: E402

torch.set_num_threads(1)

OBS, ACT = 4, 3
CNN_SHAPE = (10, 10, 1)   # Catch's frames
CNN_KW = dict(channels=(4, 8), hidden=(32,))


def _leaves(tree):
    return trm.tree_leaves(jax.tree_util.tree_map(np.asarray, tree))


def _assert_tree_close(got, want, atol, rtol=0.0, what=""):
    g, w = _leaves(got), _leaves(want)
    assert sorted(g) == sorted(w), what
    for k in w:
        np.testing.assert_allclose(g[k], w[k], atol=atol, rtol=rtol,
                                   err_msg=f"{what} {k}")


# ------------------------------------------------------------------ modules

MODULES = {
    "mlp": (lambda: jrm.MLPModule(OBS, ACT, hidden=(16, 16)),
            lambda: trm.MLPModule(OBS, ACT, hidden=(16, 16)), OBS),
    "cnn": (lambda: jrm.CNNModule(CNN_SHAPE, ACT, **CNN_KW),
            lambda: trm.CNNModule(CNN_SHAPE, ACT, **CNN_KW),
            int(np.prod(CNN_SHAPE))),
    "qmlp": (lambda: jrm.QMLPModule(OBS, ACT, hidden=(16, 16)),
             lambda: trm.QMLPModule(OBS, ACT, hidden=(16, 16)), OBS),
    "squashed_gaussian": (
        lambda: jrm.SquashedGaussianModule(3, 2, -2.0, 2.0, hidden=(16,)),
        lambda: trm.SquashedGaussianModule(3, 2, -2.0, 2.0, hidden=(16,)),
        3),
}


@pytest.mark.parametrize("kind", sorted(MODULES))
def test_module_forward_and_apply_np_match_reference(kind):
    make_j, make_t, d = MODULES[kind]
    jm, tm = make_j(), make_t()
    params = jax.tree_util.tree_map(np.asarray, jm.init_params(3))
    tm.init_params(0, "cpu")
    trm.params_from_numpy(tm, params)
    # the carry-over round-trips exactly (conv kernels HWIO <-> OIHW)
    _assert_tree_close(trm.to_numpy(tm), params, 0.0, what="round trip")
    obs = np.random.default_rng(1).normal(size=(9, d)).astype(np.float32)
    want = jm.apply(params, jnp.asarray(obs))
    want = want if isinstance(want, tuple) else (want,)
    with torch.no_grad():
        got = tm(torch.from_numpy(obs))
    got = got if isinstance(got, tuple) else (got,)
    got_np = tm.apply_np(params, obs)
    got_np = got_np if isinstance(got_np, tuple) else (got_np,)
    for w, g, gn in zip(want, got, got_np):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)
        np.testing.assert_allclose(gn, np.asarray(w), atol=1e-5)


def test_twin_q_matches_reference():
    jm, tm = jrm.TwinQModule(3, 2, hidden=(16,)), trm.TwinQModule(
        3, 2, hidden=(16,))
    params = jax.tree_util.tree_map(np.asarray, jm.init_params(5))
    trm.params_from_numpy(tm.init_params(0, "cpu"), params)
    rng = np.random.default_rng(2)
    obs = rng.normal(size=(9, 3)).astype(np.float32)
    act = rng.normal(size=(9, 2)).astype(np.float32)
    want = jm.apply(params, jnp.asarray(obs), jnp.asarray(act))
    with torch.no_grad():
        got = tm(torch.from_numpy(obs), torch.from_numpy(act))
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


def test_build_pv_module_picks_the_encoder():
    assert isinstance(trm.build_pv_module(
        {"obs_dim": 100, "num_actions": 3, "obs_shape": CNN_SHAPE}),
        trm.CNNModule)
    assert isinstance(trm.build_pv_module(
        {"obs_dim": 4, "num_actions": 2, "obs_shape": None}), trm.MLPModule)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        trm.MLPModule(OBS, ACT).init_params(0)
    with pytest.raises(RuntimeError, match="CUDA"):
        PPOLearner(trm.MLPModule(OBS, ACT))


# ------------------------------------------------------------------ v-trace


def _vtrace_inputs(seed, boundaries):
    rng = np.random.default_rng(seed)
    T, N = 7, 3
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    values, rewards = f(T, N), f(T, N)
    next_values = f(T, N)
    cont = np.ones((T, N), np.float32)
    disc = np.full((T, N), 0.99, np.float32)
    if boundaries:
        cont[2, 0] = cont[4, 1] = 0.0
        disc[4, 1] = 0.0          # a termination; [2, 0] is a truncation
    return (f(T, N) * 0.3, f(T, N) * 0.3, values, next_values, rewards,
            disc, cont)


@pytest.mark.parametrize("boundaries", [False, True])
def test_vtrace_matches_reference(boundaries):
    from ray_tpu.rllib.impala import ImpalaLearner as JaxImpala

    args = _vtrace_inputs(0, boundaries)
    ref = JaxImpala(jrm.MLPModule(4, 2), gamma=0.99)
    want = ref._vtrace(*map(jnp.asarray, args))
    port = ImpalaLearner(trm.MLPModule(4, 2), gamma=0.99, device="cpu")
    got = port._vtrace(*map(torch.from_numpy, args))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


def test_vtrace_matches_numpy_recursion():
    """Copied from tests/test_rllib.py: a boundary-free trajectory with
    a single bootstrap (Espeholt et al. 2018, eq. 1)."""
    rng = np.random.default_rng(0)
    T, N = 7, 3
    gamma = 0.99
    target_logp = rng.normal(size=(T, N)).astype(np.float32) * 0.3
    behavior_logp = rng.normal(size=(T, N)).astype(np.float32) * 0.3
    values = rng.normal(size=(T, N)).astype(np.float32)
    bootstrap = rng.normal(size=N).astype(np.float32)
    rewards = rng.normal(size=(T, N)).astype(np.float32)
    next_values = np.concatenate([values[1:], bootstrap[None]], axis=0)
    disc_boot = np.full((T, N), gamma, np.float32)
    cont = np.ones((T, N), np.float32)

    learner = ImpalaLearner(trm.MLPModule(4, 2), gamma=gamma, rho_bar=1.0,
                            c_bar=1.0, device="cpu")
    vs, pg_adv = learner._vtrace(*map(torch.from_numpy, (
        target_logp, behavior_logp, values, next_values, rewards,
        disc_boot, cont)))
    vs, pg_adv = vs.numpy(), pg_adv.numpy()

    rho = np.minimum(1.0, np.exp(target_logp - behavior_logp))
    c = np.minimum(1.0, np.exp(target_logp - behavior_logp))
    deltas = rho * (rewards + gamma * next_values - values)
    vs_ref = np.zeros((T + 1, N), np.float32)
    vs_ref[T] = bootstrap
    acc = np.zeros(N, np.float32)
    for t in reversed(range(T)):
        acc = deltas[t] + gamma * c[t] * acc
        vs_ref[t] = values[t] + acc
    adv_ref = rho * (rewards + gamma * vs_ref[1:] - values)

    assert np.allclose(vs, vs_ref[:T], atol=1e-4)
    assert np.allclose(pg_adv, adv_ref, atol=1e-4)


# ----------------------------------------------------------------- learners


def _first_grads(tx):
    """``tx`` that also keeps the first gradient it is given (before
    whatever ``tx`` does to it) in its state: ``state[1]``."""
    def init(p):
        return (tx.init(p), jax.tree_util.tree_map(jnp.zeros_like, p),
                jnp.zeros((), jnp.int32))

    def update(g, s, p=None):
        inner, first, n = s
        u, inner = tx.update(g, inner, p)
        first = jax.tree_util.tree_map(
            lambda a, b: jnp.where(n == 0, a, b), g, first)
        return u, (inner, first, n + 1)

    return optax.GradientTransformation(init, update)


def _record(learner, tx="tx", state="opt_state", params="params"):
    setattr(learner, tx, _first_grads(getattr(learner, tx)))
    setattr(learner, state, getattr(learner, tx).init(
        getattr(learner, params)))


def _hook(store):
    def hook(kind, grads):
        store.setdefault(kind, grads)
    return hook


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _f32(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _ppo_batch(rng, n, d):
    return {"obs": _f32(rng, n, d),
            "actions": rng.integers(0, ACT, n).astype(np.int32),
            "logp_old": np.log(np.full(n, 1.0 / ACT, np.float32))
            + _f32(rng, n) * 0.1,
            "advantages": _f32(rng, n), "returns": _f32(rng, n)}


def _impala_batch(rng, T, N, d):
    dones = rng.random((T, N)) < 0.15
    return {"obs": _f32(rng, T, N, d), "next_obs": _f32(rng, T, N, d),
            "actions": rng.integers(0, ACT, (T, N)).astype(np.int32),
            "behavior_logits": _f32(rng, T, N, ACT),
            "rewards": _f32(rng, T, N), "dones": dones,
            "terminateds": dones & (rng.random((T, N)) < 0.5)}


def _q_batch(rng, lead, d, weights=False):
    b = {"obs": _f32(rng, *lead, d), "next_obs": _f32(rng, *lead, d),
         "actions": rng.integers(0, ACT, lead).astype(np.int32),
         "rewards": _f32(rng, *lead),
         "dones": (rng.random(lead) < 0.2).astype(np.float32)}
    if weights:
        b["weights"] = rng.uniform(0.2, 1.0, lead).astype(np.float32)
    return b


def _pv_modules(encoder):
    if encoder == "cnn":
        return (jrm.CNNModule(CNN_SHAPE, ACT, **CNN_KW),
                trm.CNNModule(CNN_SHAPE, ACT, **CNN_KW),
                int(np.prod(CNN_SHAPE)))
    return (jrm.MLPModule(OBS, ACT, hidden=(16, 16)),
            trm.MLPModule(OBS, ACT, hidden=(16, 16)), OBS)


@pytest.mark.parametrize("encoder", ["mlp", "cnn"])
@pytest.mark.parametrize("algo", ["ppo", "impala", "appo"])
def test_policy_learner_update_matches_reference(algo, encoder):
    from ray_tpu.rllib.appo import AppoLearner as JaxAppo
    from ray_tpu.rllib.impala import ImpalaLearner as JaxImpala
    from ray_tpu.rllib.learner import PPOLearner as JaxPPO

    jm, tm, d = _pv_modules(encoder)
    rng = np.random.default_rng(4)
    lr = 1e-3
    if algo == "ppo":
        n = 24
        kw = dict(lr=lr, num_epochs=1, minibatch_size=n)
        ref, cls = JaxPPO(jm, **kw), PPOLearner
        batch = _ppo_batch(rng, n, d)
    else:
        kw = dict(lr=lr, gamma=0.97)
        if algo == "appo":
            kw["target_update_freq"] = 1
        ref, cls = ((JaxImpala(jm, **kw), ImpalaLearner) if algo == "impala"
                    else (JaxAppo(jm, **kw), AppoLearner))
        batch = _impala_batch(rng, 5, 4, d)
    params = _np_tree(ref.params)
    port = cls(tm, device="cpu", params=params, **kw)
    _record(ref)
    grads = {}
    port.grad_hook = _hook(grads)

    want = ref.update(batch)
    got = port.update(batch)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-5, err_msg=k)
    _assert_tree_close(grads["params"], ref.opt_state[1], 1e-5, 1e-4,
                       "grad")
    _assert_tree_close(port.get_weights(), ref.get_weights(), 0.2 * lr,
                       what="params")
    if algo == "appo":   # the target copied the stepped weights
        _assert_tree_close(trm.to_numpy(port.target),
                           _np_tree(ref.target_params), 0.2 * lr,
                           what="target")


@pytest.mark.parametrize("per_weights", [False, True])
def test_dqn_update_many_matches_reference(per_weights):
    from ray_tpu.rllib.dqn import DQNLearner as JaxDQN

    lr, U = 1e-3, 2
    ref = JaxDQN(jrm.QMLPModule(OBS, ACT, hidden=(16, 16)), lr=lr,
                 tau=0.1)
    params = _np_tree(ref.params)
    port = DQNLearner(trm.QMLPModule(OBS, ACT, hidden=(16, 16)), lr=lr,
                      tau=0.1, device="cpu", params=params)
    _record(ref)
    grads = {}
    port.grad_hook = _hook(grads)
    batches = _q_batch(np.random.default_rng(5), (U, 32), OBS, per_weights)
    batches["_indices"] = np.zeros((U, 32), np.int64)  # PER bookkeeping
    want_loss, want_td = ref.update_many(batches)
    got_loss, got_td = port.update_many(batches)
    np.testing.assert_allclose(got_loss, want_loss, atol=1e-5)
    assert got_td.shape == (U, 32)
    np.testing.assert_allclose(got_td, want_td, atol=1e-4)
    _assert_tree_close(grads["params"], ref.opt_state[1], 1e-5, 1e-4,
                       "grad")
    _assert_tree_close(port.get_weights(), ref.get_weights(), 0.2 * lr * U,
                       what="params")
    _assert_tree_close(trm.to_numpy(port.target),
                       _np_tree(ref.target_params), 0.2 * lr * U,
                       what="target")


def _sac_noise(ref, U, B, D):
    """The draws ``ray_tpu``'s SAC update makes from its key: per
    update, one for the critic target's sample, one for the actor's."""
    _, key = jax.random.split(ref._rng)
    out = np.zeros((U, 2, B, D), np.float32)
    for u, k in enumerate(jax.random.split(key, U)):
        for j, kk in enumerate(jax.random.split(k)):
            out[u, j] = np.asarray(jax.random.normal(kk, (B, D)))
    return out


def test_sac_update_many_matches_reference():
    from ray_tpu.rllib.sac import SACLearner as JaxSAC

    lr, U, B, D = 1e-3, 2, 32, 1
    mods = lambda m: (m.SquashedGaussianModule(3, D, -2.0, 2.0,  # noqa: E731
                                               hidden=(16, 16)),
                      m.TwinQModule(3, D, hidden=(16, 16)))
    ref = JaxSAC(*mods(jrm), lr=lr, tau=0.05)
    params = {"pi": _np_tree(ref.pi_params), "q": _np_tree(ref.q_params)}
    port = SACLearner(*mods(trm), lr=lr, tau=0.05, device="cpu",
                      params=params)
    _record(ref, "pi_tx", "pi_opt", "pi_params")
    _record(ref, "q_tx", "q_opt", "q_params")
    _record(ref, "a_tx", "a_opt", "log_alpha")
    grads = {}
    port.grad_hook = _hook(grads)
    rng = np.random.default_rng(6)
    batches = {"obs": _f32(rng, U, B, 3), "next_obs": _f32(rng, U, B, 3),
               "actions": rng.uniform(-2, 2, (U, B)).astype(np.float32),
               "rewards": _f32(rng, U, B),
               "dones": (rng.random((U, B)) < 0.2).astype(np.float32)}
    noise = _sac_noise(ref, U, B, D)
    want = ref.update_many(batches)
    got = port.update_many(batches, noise=noise)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-5, err_msg=k)
    _assert_tree_close(grads["q"], ref.q_opt[1], 1e-5, 1e-4, "q grad")
    _assert_tree_close(grads["pi"], ref.pi_opt[1], 1e-5, 1e-4, "pi grad")
    np.testing.assert_allclose(grads["alpha"], np.asarray(ref.a_opt[1]),
                               atol=1e-5, rtol=1e-4)
    tol = 0.2 * lr * U
    _assert_tree_close(port.get_weights(), ref.get_weights(), tol,
                       what="pi")
    _assert_tree_close(trm.to_numpy(port.critic), _np_tree(ref.q_params),
                       tol, what="q")
    _assert_tree_close(trm.to_numpy(port.q_target), _np_tree(ref.q_target),
                       tol, what="q target")
    np.testing.assert_allclose(float(port.log_alpha.detach()),
                               float(ref.log_alpha), atol=tol)


@pytest.mark.parametrize("algo", ["bc", "cql", "marwil"])
def test_offline_learner_update_matches_reference(algo):
    from ray_tpu.rllib import offline as joff

    lr = 1e-3
    rng = np.random.default_rng(7)
    if algo == "cql":
        jm, tm = (m.QMLPModule(OBS, ACT, hidden=(16, 16))
                  for m in (jrm, trm))
        ref, cls = joff.CQLLearner(jm, lr=lr, tau=0.1), CQLLearner
        kw = dict(tau=0.1)
        batch = _q_batch(rng, (32,), OBS)
    else:
        jm, tm = (m.MLPModule(OBS, ACT, hidden=(16, 16))
                  for m in (jrm, trm))
        ref, cls = ((joff.BCLearner(jm, lr=lr), BCLearner) if algo == "bc"
                    else (joff.MARWILLearner(jm, lr=lr), MARWILLearner))
        kw = {}
        batch = _ppo_batch(rng, 32, OBS)
    params = _np_tree(ref.params)
    port = cls(tm, lr=lr, device="cpu", params=params, **kw)
    _record(ref)
    grads = {}
    port.grad_hook = _hook(grads)
    for step in range(2):
        want = ref.update(batch)
        got = port.update(batch)
        np.testing.assert_allclose(got, want, atol=1e-5,
                                   err_msg=f"loss {step}")
        if step == 0:
            _assert_tree_close(grads["params"], ref.opt_state[1], 1e-5,
                               1e-4, "grad")
    _assert_tree_close(port.get_weights(), ref.get_weights(), 0.4 * lr,
                       what="params")
    if algo == "marwil":
        np.testing.assert_allclose(port._ma_adv_sq, ref._ma_adv_sq,
                                   rtol=1e-5)


# ------------------------------------------- chip_smoke.py's state copy
#
# Phase 10 of chip_smoke.py holds each update's losses on the card to a
# CPU learner that starts that update from the card learner's state
# (``_rl_copy_state``). That is sound only if the copy carries every
# piece of state an update reads: here a learner whose weights,
# optimizer moments, step counts and counters all differ is copied from
# another, and the two must then run on bit for bit.


def _copy_cases():
    rng = np.random.default_rng(8)
    mlp = lambda: trm.MLPModule(OBS, ACT, hidden=(16,))    # noqa: E731
    qmlp = lambda: trm.QMLPModule(OBS, ACT, hidden=(16,))  # noqa: E731

    def sac():
        return SACLearner(trm.SquashedGaussianModule(3, 1, -2.0, 2.0,
                                                     hidden=(16,)),
                          trm.TwinQModule(3, 1, hidden=(16,)),
                          device="cpu")

    def sac_batch():
        return ({"obs": _f32(rng, 2, 16, 3), "next_obs": _f32(rng, 2, 16, 3),
                 "actions": rng.uniform(-2, 2, (2, 16)).astype(np.float32),
                 "rewards": _f32(rng, 2, 16),
                 "dones": np.zeros((2, 16), np.float32)},
                torch.as_tensor(_f32(rng, 2, 2, 16, 1)))

    def ppo_batch():
        perms = np.stack([rng.permutation(32) for _ in range(2)])
        return _ppo_batch(rng, 32, OBS), perms.reshape(2, 2, 16)

    return {
        "ppo": (lambda: PPOLearner(mlp(), num_epochs=2, minibatch_size=16,
                                   device="cpu"), ppo_batch,
                lambda lrn, b: lrn.update(b[0], perms=b[1])),
        "impala": (lambda: ImpalaLearner(mlp(), device="cpu"),
                   lambda: _impala_batch(rng, 4, 8, OBS),
                   lambda lrn, b: lrn.update(b)),
        "appo": (lambda: AppoLearner(mlp(), target_update_freq=2,
                                     device="cpu"),
                 lambda: _impala_batch(rng, 4, 8, OBS),
                 lambda lrn, b: lrn.update(b)),
        "dqn": (lambda: DQNLearner(qmlp(), device="cpu"),
                lambda: _q_batch(rng, (2, 16), OBS),
                lambda lrn, b: lrn.update_many(b)),
        "cql": (lambda: CQLLearner(qmlp(), device="cpu"),
                lambda: _q_batch(rng, (16,), OBS),
                lambda lrn, b: lrn.update(b)),
        "bc": (lambda: BCLearner(mlp(), device="cpu"),
               lambda: _ppo_batch(rng, 16, OBS),
               lambda lrn, b: lrn.update(b)),
        "marwil": (lambda: MARWILLearner(mlp(), device="cpu"),
                   lambda: _ppo_batch(rng, 16, OBS),
                   lambda lrn, b: lrn.update(b)),
        "sac": (sac, sac_batch,
                lambda lrn, b: lrn.update_many(b[0], noise=b[1])),
    }


def _full_state(lrn) -> dict:
    """Every network's and optimizer's state, tensor and counter of a
    learner, as numpy and Python numbers."""
    out = {}
    for name, val in vars(lrn).items():
        if isinstance(val, (torch.nn.Module, torch.optim.Optimizer)):
            flat = trm.tree_leaves(val.state_dict()["state"]
                                   if isinstance(val, torch.optim.Optimizer)
                                   else dict(val.state_dict()))
            out.update({f"{name}.{k}": np.asarray(v)
                        for k, v in flat.items()})
        elif isinstance(val, torch.Tensor):
            out[name] = val.detach().numpy().copy()
        elif isinstance(val, (int, float)) and not isinstance(val, bool):
            out[name] = val
    return out


@pytest.mark.parametrize("algo", sorted(_copy_cases()))
def test_chip_smoke_state_copy_continues_bit_for_bit(algo):
    import chip_smoke

    make, make_batch, call = _copy_cases()[algo]
    src, dst = make(), make()
    with torch.no_grad():
        for val in vars(dst).values():
            if isinstance(val, torch.nn.Module):
                for p in val.parameters():
                    p.add_(0.1)
    call(dst, make_batch())
    call(src, make_batch())
    assert not all(np.array_equal(a, b) for a, b in zip(
        _full_state(src).values(), _full_state(dst).values()))
    for _ in range(2):
        chip_smoke._rl_copy_state(dst, src)
        b = make_batch()
        np.testing.assert_equal(call(dst, b), call(src, b))
        got, want = _full_state(dst), _full_state(src)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
