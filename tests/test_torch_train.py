"""The PyTorch port's training path against the JAX package.

Inputs come from numpy seeds and go through both packages in fp32 on the
CPU. The JAX flash backward runs its Pallas kernels in interpret mode;
the port's wrappers run their plain PyTorch versions on CPU tensors,
which is the arithmetic the CUDA kernels are held to on the card
(chip_smoke.py). Tolerances: 2e-5 absolute for attention gradients (as
tests/test_ops.py), rtol 2e-4 / atol 1e-4 where an arange-weighted
cotangent makes them O(100), 1e-4 for model losses and gradients.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
optax = pytest.importorskip("optax")
import jax.numpy as jnp  # noqa: E402

from ray_tpu.models import llama as jl  # noqa: E402
from ray_tpu.ops import attention as jattn  # noqa: E402
from ray_tpu_torch.models import llama as tl  # noqa: E402
from ray_tpu_torch.models.convert import params_from_numpy  # noqa: E402
from ray_tpu_torch.ops import attention as tattn  # noqa: E402
from ray_tpu_torch.tools.profile_train import train_step  # noqa: E402

torch.set_num_threads(1)

# (b, sq, sk, heads, kv_heads, d, causal), as tests/test_torch_ops.py
ATTN_CASES = {
    "causal": (2, 128, 128, 4, 4, 32, True),
    "noncausal": (2, 128, 128, 4, 4, 32, False),
    "gqa": (2, 128, 128, 4, 2, 32, True),
    "sk_gt_sq": (1, 64, 128, 4, 2, 32, True),
}


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _qkv(case, seed=10):
    b, sq, sk, h, kvh, d, _ = ATTN_CASES[case]
    return (_rand(seed, b, sq, h, d), _rand(seed + 1, b, sk, kvh, d),
            _rand(seed + 2, b, sk, kvh, d))


def _cotangent(case, seed=13):
    """A random cotangent; for GQA the arange-weighted one of
    tests/test_ops.py, which varies dO per element along d."""
    b, sq, _, h, _, d, _ = ATTN_CASES[case]
    if case == "gqa":
        return np.broadcast_to(np.arange(d, dtype=np.float32),
                               (b, sq, h, d)).copy()
    return _rand(seed, b, sq, h, d)


def _attn_tol(case):
    return dict(rtol=2e-4, atol=1e-4) if case == "gqa" else dict(atol=2e-5)


# --------------------------------------------------------------- backward


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_flash_backward_matches_pallas_interpret(case):
    """The backward wrapper on CPU tensors (the kernels' plain version)
    against the Pallas dQ and dK/dV kernels in interpret mode, on the
    same O and lse from the JAX forward."""
    q, k, v = _qkv(case)
    g = _cotangent(case)
    causal = ATTN_CASES[case][-1]
    scale = 1.0 / np.sqrt(q.shape[-1])
    jq, jk, jv, jg = map(jnp.asarray, (q, k, v, g))
    out, lse = jattn._flash_forward(jq, jk, jv, causal, scale, 64, 64, True)
    want = jattn._flash_backward(jq, jk, jv, out, lse, jg, causal, scale,
                                 64, 64, True)
    got = tattn.flash_backward(_t(q), _t(k), _t(v), _t(out),
                               _t(np.asarray(lse)[..., 0]), _t(g), causal,
                               scale)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert tuple(a.shape) == b.shape, name
        np.testing.assert_allclose(_np(a), _np(b), err_msg=name,
                                   **_attn_tol(case))


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_flash_attention_grad_matches_jax_grad(case):
    """torch.autograd through the port's flash_attention (its autograd
    Function) against jax.grad through the Pallas custom_vjp."""
    q, k, v = _qkv(case, seed=40)
    g = _cotangent(case, seed=43)
    causal = ATTN_CASES[case][-1]

    def jloss(q_, k_, v_):
        o = jattn.flash_attention(q_, k_, v_, causal=causal, use_pallas=True,
                                  interpret=True, block_q=64, block_k=64)
        return (o * jnp.asarray(g)).sum()

    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    out = tattn.flash_attention(tq, tk, tv, causal=causal, block_q=64,
                                block_k=64)
    got = torch.autograd.grad((out * _t(g)).sum(), (tq, tk, tv))
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(_np(a), _np(b), err_msg=name,
                                   **_attn_tol(case))


def test_flash_backward_checks_shapes_and_devices():
    q = torch.zeros(1, 64, 2, 32)
    lse = torch.zeros(2, 64)
    with pytest.raises(ValueError, match="shapes"):
        tattn.flash_backward(q, q, q, q, lse[:1], q)
    qm = torch.zeros(1, 64, 2, 64, device="meta")
    lm = torch.zeros(2, 64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tattn.flash_backward(qm, qm, qm, qm, lm, qm)


# ------------------------------------------------------------------ loss


@pytest.mark.parametrize("z_loss", [0.0, 1e-3])
@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_loss_matches_jax(masked, z_loss):
    logits = _rand(50, 3, 7, 32, scale=3.0)
    targets = np.random.default_rng(51).integers(0, 32, (3, 7))
    mask = (np.random.default_rng(52).random((3, 7)) > 0.3).astype(
        np.float32) if masked else None
    want, jgrad = jax.value_and_grad(
        lambda lg: jl.cross_entropy_loss(
            lg, jnp.asarray(targets),
            None if mask is None else jnp.asarray(mask), z_loss))(
        jnp.asarray(logits))
    tlog = _t(logits).requires_grad_()
    got = tl.cross_entropy_loss(tlog, _t(targets),
                                None if mask is None else _t(mask), z_loss)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    np.testing.assert_allclose(_np(tlog.grad), _np(jgrad), atol=1e-7)


def test_cross_entropy_loss_all_masked_divides_by_one():
    logits = torch.zeros(2, 3, 8)
    loss = tl.cross_entropy_loss(logits, torch.zeros(2, 3, dtype=torch.long),
                                 torch.zeros(2, 3))
    assert float(loss) == 0.0


# -------------------------------------------------------------- loss_fn

VARIANTS = {
    "base": {},
    "qkv_bias": {"attn_qkv_bias": True},
    "tied": {"tie_embeddings": True},
}


def _jparams(jcfg, seed=0):
    """JAX init (random biases where present) as numpy leaves."""
    p = jax.tree_util.tree_map(
        np.asarray, jl.init_params(jcfg, jax.random.PRNGKey(seed)))
    if "bq" in p["layers"]:
        rng = np.random.default_rng(seed)
        for k in ("bq", "bk", "bv"):
            p["layers"][k] = rng.normal(
                0, 0.5, p["layers"][k].shape).astype(np.float32)
    return p


def _torch_loss_and_grads(cfg, np_params, batch):
    params = params_from_numpy(np_params, "cpu")
    for _, leaf in tl.param_leaves(params):
        leaf.requires_grad_()
    tbatch = {k: _t(v) for k, v in batch.items()}
    loss = tl.loss_fn(cfg, params, tbatch)
    loss.backward()
    return loss.item(), {n: _np(leaf.grad)
                         for n, leaf in tl.param_leaves(params)}


def _tokens(seed, b=2, s=65):
    return np.random.default_rng(seed).integers(0, 256, (b, s)).astype(
        np.int32)


@pytest.fixture(scope="module")
def jax_base_grads():
    """JAX loss and gradients of the base tiny config, shared by the
    remat tests."""
    jcfg = jl.LlamaConfig.tiny(attn_impl="reference")
    p = _jparams(jcfg, seed=3)
    batch = {"tokens": _tokens(4)}
    loss, grads = jax.value_and_grad(
        lambda pp: jl.loss_fn(jcfg, pp, {"tokens": jnp.asarray(
            batch["tokens"])}))(jax.tree_util.tree_map(jnp.asarray, p))
    return p, batch, float(loss), dict(tl.param_leaves(
        jax.tree_util.tree_map(np.asarray, grads)))


def _assert_grads_close(got, want, tol=1e-4):
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=tol,
                                   atol=tol, err_msg=name)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_param_leaves_match_jax_tree(variant):
    """param_leaves names every leaf of the port's params as the JAX
    package's tree is named, with the same shapes, and covers them all."""
    jcfg = jl.LlamaConfig.tiny(**VARIANTS[variant])
    tcfg = tl.LlamaConfig.tiny(**VARIANTS[variant])
    params = tl.init_params(tcfg, seed=0, device="cpu")
    got = {n: tuple(x.shape) for n, x in tl.param_leaves(params)}
    want = {n: tuple(x.shape) for n, x in tl.param_leaves(
        jax.tree_util.tree_map(np.asarray, _jparams(jcfg)))}
    assert got == want
    assert sum(x.numel() for _, x in tl.param_leaves(params)) == \
        tl.num_params(params)


@pytest.mark.parametrize("attn_impl", ["reference", "flash"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_loss_fn_and_grads_match_jax(variant, attn_impl):
    """Loss and every gradient leaf of tiny Llama, with a token mask."""
    jcfg = jl.LlamaConfig.tiny(attn_impl="reference", **VARIANTS[variant])
    tcfg = tl.LlamaConfig.tiny(attn_impl=attn_impl, **VARIANTS[variant])
    p = _jparams(jcfg, seed=1)
    toks = _tokens(2)
    mask = (np.random.default_rng(3).random(toks.shape) > 0.2).astype(
        np.float32)
    jbatch = {"tokens": jnp.asarray(toks), "mask": jnp.asarray(mask)}
    want_loss, jgrads = jax.value_and_grad(
        lambda pp: jl.loss_fn(jcfg, pp, jbatch))(
        jax.tree_util.tree_map(jnp.asarray, p))
    got_loss, got = _torch_loss_and_grads(tcfg, p,
                                          {"tokens": toks, "mask": mask})
    np.testing.assert_allclose(got_loss, float(want_loss), rtol=1e-5)
    _assert_grads_close(got, dict(tl.param_leaves(jax.tree_util.tree_map(
        np.asarray, jgrads))))


REMAT_VARIANTS = {
    "off": dict(remat=False),
    "full": dict(remat=True),
    "save_qkv": dict(remat=True, remat_policy="save_qkv"),
    "store_1": dict(remat=True, remat_store_layers=1),
    "store_all": dict(remat=True, remat_store_layers=5),
    "unrolled": dict(remat=True, scan_layers=False),
    "unrolled_save_qkv": dict(remat=True, scan_layers=False,
                              remat_policy="save_qkv"),
}


@pytest.mark.parametrize("attn_impl", ["reference", "flash"])
@pytest.mark.parametrize("remat", sorted(REMAT_VARIANTS))
def test_remat_variants_match_jax_and_no_remat(remat, attn_impl,
                                               jax_base_grads):
    """Every remat setting gives the loss and gradients of remat=False,
    which match the JAX package's."""
    p, batch, jloss, jgrads = jax_base_grads
    tcfg = tl.LlamaConfig.tiny(attn_impl=attn_impl, **REMAT_VARIANTS[remat])
    loss, grads = _torch_loss_and_grads(tcfg, p, batch)
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    _assert_grads_close(grads, jgrads)
    base_loss, base = _torch_loss_and_grads(
        tl.LlamaConfig.tiny(attn_impl=attn_impl), p, batch)
    assert loss == pytest.approx(base_loss, rel=1e-6)
    _assert_grads_close(grads, base, tol=1e-6)


def test_remat_value_errors_match_jax():
    """The reference's ValueErrors: an unknown remat policy at config
    time, and scan_layers=False with remat_store_layers>0 at forward."""
    for pkg in (jl, tl):
        with pytest.raises(ValueError, match="remat_policy"):
            pkg.LlamaConfig.tiny(remat_policy="nope")
    jcfg = jl.LlamaConfig.tiny(remat=True, scan_layers=False,
                               remat_store_layers=1)
    tcfg = tl.LlamaConfig.tiny(remat=True, scan_layers=False,
                               remat_store_layers=1)
    p = _jparams(jcfg)
    toks = _tokens(5, 1, 9)
    with pytest.raises(ValueError, match="conflict"):
        jl.loss_fn(jcfg, jax.tree_util.tree_map(jnp.asarray, p),
                   {"tokens": jnp.asarray(toks)})
    with pytest.raises(ValueError, match="conflict"):
        tl.loss_fn(tcfg, params_from_numpy(p, "cpu"), {"tokens": _t(toks)})
    # without remat there is nothing to store: both accept it
    tl.loss_fn(tl.LlamaConfig.tiny(remat=False, scan_layers=False,
                                   remat_store_layers=1),
               params_from_numpy(p, "cpu"), {"tokens": _t(toks)})


def test_config_defaults_match_jax():
    for field in ("attn_impl", "remat", "remat_store_layers",
                  "remat_policy", "scan_layers"):
        assert getattr(tl.LlamaConfig(), field) == \
            getattr(jl.LlamaConfig(), field), field
        assert getattr(tl.LlamaConfig.tiny(), field) == \
            getattr(jl.LlamaConfig.tiny(), field), field
    assert tl.LlamaConfig().attn_impl == "auto"
    assert tl.LlamaConfig.tiny().remat is False


def test_auto_attention_is_the_reference_on_cpu(monkeypatch):
    """attn_impl="auto" resolves by the activations' device: on CPU
    tensors it never reaches flash_attention; "flash" does."""
    calls = []
    real = tl.flash_attention

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(tl, "flash_attention", spy)
    cfg = tl.LlamaConfig.tiny()
    params = tl.init_params(cfg, seed=0, device="cpu")
    toks = torch.from_numpy(_tokens(6, 1, 16))
    with torch.no_grad():
        auto = tl.forward(cfg, params, toks)
        assert calls == []
        flash = tl.forward(tl.LlamaConfig.tiny(attn_impl="flash"), params,
                           toks)
    assert len(calls) == cfg.num_layers
    torch.testing.assert_close(auto, flash, atol=1e-5, rtol=1e-5)


# ----------------------------------------------------------------- AdamW

# Adam divides each update by sqrt(v): where a gradient entry is near 0,
# the two packages' last-digit differences in it become different update
# directions, up to 2 * lr apart per step, while most entries agree to a
# few fp32 ulps (~1e-7). The params are held to lr / 3 = 1e-4 absolute,
# ten times the largest difference seen over three steps (1.1e-5, one
# w_up entry); the losses, which average over every entry, at rtol 1e-5.
ADAM_PARAM_ATOL = 3e-4 / 3


@pytest.mark.parametrize("attn_impl", ["reference", "flash"])
def test_adamw_steps_match_optax(attn_impl):
    """Three train steps (loss_fn, backward, torch.optim.AdamW) against
    jax.value_and_grad + optax.adamw(3e-4, weight_decay=0.01) from the
    same params on the same batch."""
    jcfg = jl.LlamaConfig.tiny(attn_impl="reference")
    tcfg = tl.LlamaConfig.tiny(attn_impl=attn_impl)
    p = _jparams(jcfg, seed=7)
    toks = _tokens(8)

    tx = optax.adamw(3e-4, weight_decay=0.01)
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    state = tx.init(jp)
    jlosses = []
    for _ in range(3):
        loss, grads = jax.value_and_grad(lambda pp: jl.loss_fn(
            jcfg, pp, {"tokens": jnp.asarray(toks)}))(jp)
        updates, state = tx.update(grads, state, jp)
        jp = optax.apply_updates(jp, updates)
        jlosses.append(float(loss))

    params = params_from_numpy(p, "cpu")
    leaves = [leaf.requires_grad_() for _, leaf in tl.param_leaves(params)]
    opt = torch.optim.AdamW(leaves, lr=3e-4, weight_decay=0.01)
    tlosses = [train_step(tcfg, params, opt, _t(toks)).item()
               for _ in range(3)]

    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
    assert tlosses[-1] < tlosses[0]
    want = dict(tl.param_leaves(jax.tree_util.tree_map(np.asarray, jp)))
    for name, leaf in tl.param_leaves(params):
        np.testing.assert_allclose(_np(leaf), want[name], rtol=0,
                                   atol=ADAM_PARAM_ATOL, err_msg=name)
