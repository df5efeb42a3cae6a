"""The port's DreamerV3 learner against ``ray_tpu.rllib.dreamer``.

The helpers (``symlog``, ``symexp``, ``TwoHot``) are held to the
reference's on the same values. The learner starts from the reference's
own parameters (carried over through numpy) and takes 3 updates on the
same batches with the same draws: the reference makes its draws with
``jax.random`` inside its jitted update, and the test replays its key
path (the Gumbel noise of each ``jax.random.categorical`` and the
permutation behind ``jax.random.choice``) and feeds the port those
arrays. Each update's metrics agree at atol 1e-5 (rtol 1e-4), the
first world-model and actor-critic gradients (which the reference's
optimizers record through a wrapper of their optax chains) at atol 1e-5
/ rtol 1e-4, the parameters after the 3 updates within 0.2 lr a step,
as in ``test_torch_rllib.py``. ``act`` is held to the reference's with
fed noise.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
optax = pytest.importorskip("optax")

import jax.numpy as jnp  # noqa: E402

from ray_tpu.rllib import dreamer as jd  # noqa: E402
from ray_tpu_torch.rllib import dreamer as td  # noqa: E402
from ray_tpu_torch.rllib import rl_module as trm  # noqa: E402

torch.set_num_threads(1)

OBS, ACT, B, L = 4, 2, 4, 8
KW = dict(deter=32, stoch_vars=4, stoch_classes=4, units=32, horizon=5,
          imag_starts=16, lr=1e-3, ac_lr=1e-3)


def _leaves(tree):
    return trm.tree_leaves(jax.tree_util.tree_map(np.asarray, tree))


def _close_tree(got, want, atol, rtol=0.0, what=""):
    g, w = _leaves(got), _leaves(want)
    assert sorted(g) == sorted(w), what
    for k in w:
        np.testing.assert_allclose(g[k], w[k], atol=atol, rtol=rtol,
                                   err_msg=f"{what} {k}")


def _first_grads(tx):
    """``tx`` that also keeps the first gradient it is given in its state
    (``state[1]``), as ``test_torch_rllib.py`` records them."""
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


def _batch(rng):
    first = (rng.random((B, L)) < 0.1).astype(np.float32)
    first[:, 0] = 1.0
    return {"obs": rng.normal(size=(B, L, OBS)).astype(np.float32) * 2,
            "actions": rng.integers(0, ACT, (B, L)).astype(np.int32),
            "rewards": rng.normal(size=(B, L)).astype(np.float32),
            "dones": (rng.random((B, L)) < 0.1).astype(np.float32),
            "is_first": first}


def _noise(ref, key):
    """The draws ``ray_tpu``'s ``_update_impl`` makes from ``key``."""
    g = lambda k, *s: np.asarray(jax.random.gumbel(k, s))  # noqa: E731
    V, K, H, n = ref.V, ref.K, ref.horizon, B * L
    k1, k2 = jax.random.split(key)
    post, k = [], k1
    for _ in range(L):
        k, sub = jax.random.split(k)
        post.append(g(sub, B, V, K))
    out = {"post": np.stack(post)}
    N = n
    if ref.imag_starts < n:
        k2, ksub = jax.random.split(k2)
        N = ref.imag_starts
        out["pick"] = np.asarray(jax.random.permutation(ksub, n))[:N]
    act, prior, k = [], [], k2
    for _ in range(H):
        k, ka, kp = jax.random.split(k, 3)
        act.append(g(ka, N, ACT))
        prior.append(g(kp, N, V, K))
    out.update(act=np.stack(act), prior=np.stack(prior))
    return out


def test_symlog_symexp_twohot_match_reference():
    x = np.concatenate([np.linspace(-40, 40, 97), [0.0, -1e-3, 3e5]]
                       ).astype(np.float32)
    t = torch.from_numpy(x)
    np.testing.assert_allclose(td.symlog(t).numpy(),
                               np.asarray(jd.symlog(x)), rtol=1e-6)
    np.testing.assert_allclose(td.symexp(td.symlog(t)).numpy(),
                               np.asarray(jd.symexp(jd.symlog(x))),
                               rtol=1e-5)
    ref, port = jd.TwoHot(), td.TwoHot()
    # XLA may fuse the reference's linspace arithmetic: a last-bit spread
    np.testing.assert_allclose(port.bins.numpy(), np.asarray(ref.bins),
                               atol=2e-6)
    np.testing.assert_allclose(port.encode(t).numpy(),
                               np.asarray(ref.encode(x)), atol=1e-5)
    logits = np.random.default_rng(0).normal(size=(5, 41)).astype(
        np.float32) * 3
    np.testing.assert_allclose(port.decode(torch.from_numpy(logits)).numpy(),
                               np.asarray(ref.decode(logits)), rtol=1e-5,
                               atol=1e-6)


def test_updates_match_reference():
    ref = jd.DreamerV3Learner(OBS, ACT, seed=3, **KW)
    params = {"wm": jax.tree_util.tree_map(np.asarray, ref.wm_params),
              "ac": jax.tree_util.tree_map(np.asarray, ref.ac_params)}
    port = td.DreamerV3Learner(OBS, ACT, device="cpu", params=params, **KW)
    for tx, st, p in (("wm_tx", "wm_opt", "wm_params"),
                      ("ac_tx", "ac_opt", "ac_params")):
        setattr(ref, tx, _first_grads(getattr(ref, tx)))
        setattr(ref, st, getattr(ref, tx).init(getattr(ref, p)))
    grads = {}
    port.grad_hook = lambda kind, g: grads.setdefault(kind, g)
    rng = np.random.default_rng(1)
    for u in range(3):
        batch, key = _batch(rng), jax.random.PRNGKey(10 + u)
        noise = _noise(ref, key)
        want = ref.update(batch, key)
        got = port.update(batch, noise=noise)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], atol=1e-5,
                                       rtol=1e-4, err_msg=f"update {u} {k}")
        if u == 0:
            _close_tree(grads["wm"], ref.wm_opt[1], 1e-5, 1e-4, "wm grad")
            _close_tree(grads["ac"], ref.ac_opt[1], 1e-5, 1e-4, "ac grad")
    tol = 0.2 * KW["lr"] * 3
    _close_tree(trm.to_numpy(port.wm), ref.wm_params, tol, what="wm")
    _close_tree(trm.to_numpy(port.ac), ref.ac_params, tol, what="ac")
    np.testing.assert_allclose(
        [float(port.ret_lo), float(port.ret_hi)],
        [float(ref.ret_lo), float(ref.ret_hi)], atol=1e-5, rtol=1e-4)


def test_optimizer_state_carries_over():
    """A port learner loaded with the reference's params and optax states
    after one reference update takes the reference's second update."""
    ref = jd.DreamerV3Learner(OBS, ACT, seed=5, **KW)
    rng = np.random.default_rng(3)
    key = jax.random.PRNGKey(30)
    ref.update(_batch(rng), key)
    params = {"wm": jax.tree_util.tree_map(np.asarray, ref.wm_params),
              "ac": jax.tree_util.tree_map(np.asarray, ref.ac_params)}
    port = td.DreamerV3Learner(OBS, ACT, device="cpu", params=params, **KW)
    port.load_opt_state(ref.wm_opt, ref.ac_opt, ref.ret_lo, ref.ret_hi)
    batch, key = _batch(rng), jax.random.PRNGKey(31)
    noise = _noise(ref, key)
    want = ref.update(batch, key)
    got = port.update(batch, noise=noise)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-5, rtol=1e-4,
                                   err_msg=k)
    tol = 0.2 * KW["lr"]
    _close_tree(trm.to_numpy(port.wm), ref.wm_params, tol, what="wm")
    _close_tree(trm.to_numpy(port.ac), ref.ac_params, tol, what="ac")


@pytest.mark.parametrize("greedy", [False, True])
def test_act_with_fed_noise_matches_reference(greedy):
    ref = jd.DreamerV3Learner(OBS, ACT, seed=4, **KW)
    params = {"wm": jax.tree_util.tree_map(np.asarray, ref.wm_params),
              "ac": jax.tree_util.tree_map(np.asarray, ref.ac_params)}
    port = td.DreamerV3Learner(OBS, ACT, device="cpu", params=params, **KW)
    n = 6
    rng = np.random.default_rng(2)
    rstate, pstate = ref.init_state(n), port.init_state(n)
    first = np.ones(n, np.float32)
    for step in range(3):
        obs = rng.normal(size=(n, OBS)).astype(np.float32)
        key = jax.random.PRNGKey(20 + step)
        k1, k2 = jax.random.split(key)
        noise = {"post": np.asarray(jax.random.gumbel(
            k1, (n, ref.V, ref.K))),
            "act": np.asarray(jax.random.gumbel(k2, (n, ACT)))}
        rstate, ra = ref.act(rstate, jnp.asarray(obs), jnp.asarray(first),
                             key, greedy=greedy)
        pstate, pa = port.act(pstate, obs, first, noise, greedy=greedy)
        np.testing.assert_array_equal(pa, ra)
        np.testing.assert_allclose(pstate[0].numpy(), np.asarray(rstate[0]),
                                   atol=1e-5)
        np.testing.assert_allclose(pstate[1].numpy(), np.asarray(rstate[1]),
                                   atol=1e-6)
        first = (rng.random(n) < 0.3).astype(np.float32)


def test_default_draws_come_from_the_learner():
    """Without ``noise`` the draws come from the learner's generator: two
    learners with one seed take the same update."""
    rng = np.random.default_rng(5)
    batch = _batch(rng)
    a, b = (td.DreamerV3Learner(OBS, ACT, device="cpu", seed=7, **KW)
            for _ in range(2))
    assert a.update(batch) == b.update(batch)
    (_, _, x), _ = a.act(a.init_state(3), batch["obs"][:3, 0], np.ones(3))
    assert x.shape == (3,)
