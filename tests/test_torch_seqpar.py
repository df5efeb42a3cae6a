"""Ring and Ulysses attention in the port against ``ray_tpu``'s on the
CPU (the cases of ``tests/test_ops.py``'s ring and Ulysses tests).

The port runs on 8 spawned gloo ranks (one launch for the file, with
its own timeout): every rank passes the same global q/k/v to the global
entry and returns the global output; for gradients each rank
differentiates the sum of its own block's output, and the blocks' input
gradients are put together. The oracle is ``ray_tpu``'s
``ring_attention`` / ``ulysses_attention`` under the same mesh on the 8
virtual devices, on the same numpy inputs, at the reference tests' 2e-5.
On CPU tensors Ulysses attends locally through ``attention_reference``,
as the reference does off the TPU. The ``BF16`` cases run ring again on
the same inputs rounded to bf16 (the models' compute dtype), outputs and
gradients against the reference's ring in bf16, at 2e-3 of each array's
largest value: both keep the scores, probabilities and accumulators in
fp32 and round only what they return. Rounding the probabilities to
bf16 before the value product, as the flash kernels do, moves the
outputs past that limit (``test_ring_bf16_limit_rejects_rounded_probs``),
so the limit tells the two maths apart.

jax is imported inside the tests: the spawned ranks import this module.
"""

import numpy as np
import pytest

# name -> (op, mesh axes, b, s, h, kvh, d, causal, grad)
CASES = {
    "ring_causal": ("ring", {"sp": 8}, 2, 256, 4, 4, 32, True, False),
    "ring_full": ("ring", {"sp": 8}, 2, 256, 4, 4, 32, False, False),
    "ring_gqa": ("ring", {"sp": 8}, 1, 128, 4, 2, 16, True, False),
    "ring_grad": ("ring", {"sp": 8}, 1, 64, 2, 2, 16, True, True),
    "ring_gqa_grad": ("ring", {"sp": 8}, 1, 64, 4, 2, 16, True, True),
    "ring_dp2_sp4": ("ring", {"dp": 2, "sp": 4}, 2, 64, 4, 2, 16, True,
                     True),
    "ulysses_causal": ("ulysses", {"sp": 8}, 2, 256, 8, 8, 32, True, False),
    "ulysses_full": ("ulysses", {"sp": 8}, 2, 256, 8, 8, 32, False, False),
    "ulysses_gqa_kv4": ("ulysses", {"sp": 8}, 1, 128, 8, 4, 16, True,
                        False),
    "ulysses_gqa_kv2": ("ulysses", {"sp": 8}, 1, 128, 8, 2, 16, True,
                        False),
    "ulysses_grad": ("ulysses", {"sp": 8}, 1, 64, 8, 8, 16, True, True),
    "ulysses_gqa_grad": ("ulysses", {"sp": 8}, 1, 64, 8, 2, 16, True, True),
    "ulysses_dp2_sp4": ("ulysses", {"dp": 2, "sp": 4}, 2, 64, 4, 2, 16,
                        True, True),
}

# ring cases run a second time in bf16, with gradients
BF16 = ("ring_causal", "ring_full", "ring_gqa_grad", "ring_dp2_sp4")
BF16_TOL = 2e-3


def _inputs():
    rng = np.random.default_rng(0)
    out = {}
    for name, (_, _, b, s, h, kvh, d, _, _) in CASES.items():
        out[name] = tuple(rng.standard_normal(shape).astype(np.float32)
                          for shape in ((b, s, h, d), (b, s, kvh, d),
                                        (b, s, kvh, d)))
    return out


def _seqpar_ranks(rank, world, inputs):
    import torch

    from ray_tpu_torch.ops.ring_attention import (local_chunk,
                                                  ring_attention,
                                                  ring_attention_local)
    from ray_tpu_torch.ops.ulysses import (ulysses_attention,
                                           ulysses_attention_local)
    from ray_tpu_torch.parallel import MeshSpec, build_mesh

    glob = {"ring": ring_attention, "ulysses": ulysses_attention}
    local = {"ring": ring_attention_local,
             "ulysses": ulysses_attention_local}
    meshes, out = {}, {}
    for name, (op, axes, *_, causal, grad) in CASES.items():
        key = tuple(axes.items())
        mesh = meshes.get(key) or meshes.setdefault(
            key, build_mesh(MeshSpec(axes)))
        q, k, v = (torch.from_numpy(t) for t in inputs[name])
        rec = {"out": glob[op](q, k, v, mesh, "sp", causal).numpy()}
        if grad:
            ql, kl, vl = (local_chunk(t, "sp", mesh=mesh).clone()
                          .requires_grad_() for t in (q, k, v))
            local[op](ql, kl, vl, "sp", causal, mesh=mesh).sum().backward()
            rec["grads"] = [t.grad.numpy() for t in (ql, kl, vl)]
        out[name] = rec
    for name in BF16:
        op, axes, *_, causal, _ = CASES[name]
        mesh = meshes[tuple(axes.items())]
        q, k, v = (torch.from_numpy(t).to(torch.bfloat16)
                   for t in inputs[name])
        rec = {"out": glob[op](q, k, v, mesh, "sp", causal).float().numpy()}
        ql, kl, vl = (local_chunk(t, "sp", mesh=mesh).clone()
                      .requires_grad_() for t in (q, k, v))
        local[op](ql, kl, vl, "sp", causal, mesh=mesh).sum().backward()
        rec["grads"] = [t.grad.float().numpy() for t in (ql, kl, vl)]
        out[name + "_bf16"] = rec
    mesh = meshes[(("sp", 8),)]
    bad = torch.zeros(1, 64, 6, 16)
    try:
        ulysses_attention(bad, bad, bad, mesh)
    except ValueError as e:
        out["indivisible"] = str(e)
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """(inputs, the ranks' results, the reference's); the reference
    compiles in threads while the ranks run."""
    from concurrent.futures import ThreadPoolExecutor

    from tests._torch_ranks import run_ranks

    inputs = _inputs()
    with ThreadPoolExecutor(4) as pool:
        ranks = pool.submit(run_ranks, _seqpar_ranks, 8, inputs,
                            store_dir=str(tmp_path_factory.mktemp("gloo")),
                            timeout_s=240)
        refs = {n: pool.submit(_reference, n, *inputs[n]) for n in CASES}
        refs.update({n + "_bf16": pool.submit(_reference, n, *inputs[n],
                                              bf16=True) for n in BF16})
        refs = {n: f.result() for n, f in refs.items()}
        res = ranks.result()
    return inputs, res, refs


def _reference(name, q, k, v, bf16=False):
    import jax
    import jax.numpy as jnp

    from ray_tpu.ops.ring_attention import ring_attention
    from ray_tpu.ops.ulysses import ulysses_attention
    from ray_tpu.parallel import MeshSpec, build_mesh

    op, axes, *_, causal, grad = CASES[name]
    mesh = build_mesh(MeshSpec(axes))
    fn = {"ring": ring_attention, "ulysses": ulysses_attention}[op]

    def f(*a):
        return fn(*a, mesh, axis_name="sp", causal=causal)

    grad = grad or bf16
    dtype = jnp.bfloat16 if bf16 else jnp.float32
    args = tuple(jnp.asarray(t, dtype) for t in (q, k, v))
    out = np.asarray(jax.jit(f)(*args), np.float32)
    grads = [np.asarray(g, np.float32) for g in jax.jit(jax.grad(
        lambda *a: f(*a).sum(), argnums=(0, 1, 2)))(*args)] if grad else None
    return out, grads


def _held(res, refs, name, key, close):
    """Every rank's global output, and the input gradients put together
    from the ranks' blocks, against the reference's, by ``close``."""
    want, want_grads = refs[key]
    for out in res:
        close(out[key]["out"], want)
    if want_grads is None:
        return
    # rank r's blocks sit at its sp index; dp ranks repeat them
    _, axes, *_ = CASES[name]
    sp = axes["sp"]
    for g_i, want_g in enumerate(want_grads):
        for group in range(len(res) // sp):   # every dp group holds them
            blocks = [res[group * sp + r][key]["grads"][g_i]
                      for r in range(sp)]
            close(np.concatenate(blocks, axis=1), want_g)


@pytest.mark.parametrize("name", sorted(CASES))
def test_matches_reference(ranks, name):
    _, res, refs = ranks
    _held(res, refs, name, name,
          lambda got, want: np.testing.assert_allclose(got, want, atol=2e-5))


@pytest.mark.parametrize("name", BF16)
def test_ring_bf16_matches_reference(ranks, name):
    """Ring in bf16, held to the reference's ring in bf16 at ``BF16_TOL``
    of each array's largest value."""
    def close(got, want):
        np.testing.assert_allclose(
            got, want, rtol=0, atol=BF16_TOL * float(np.abs(want).max()))

    _, res, refs = ranks
    _held(res, refs, name, name + "_bf16", close)


@pytest.mark.parametrize("name", BF16)
def test_ring_bf16_limit_rejects_rounded_probs(ranks, name):
    """The bf16 limit is tight enough to see the probabilities rounded to
    bf16 before the value product: ``attention_reference`` does so, and
    lands outside it against the reference's ring."""
    import torch

    from ray_tpu_torch.ops.attention import attention_reference

    inputs, _, refs = ranks
    want = refs[name + "_bf16"][0]
    q, k, v = (torch.from_numpy(t).to(torch.bfloat16) for t in inputs[name])
    rounded = attention_reference(q, k, v, causal=CASES[name][7])
    err = np.abs(rounded.float().numpy() - want).max()
    assert err > BF16_TOL * np.abs(want).max()


def test_ulysses_rejects_indivisible_heads(ranks):
    import jax.numpy as jnp

    from ray_tpu.ops.ulysses import ulysses_attention
    from ray_tpu.parallel import MeshSpec, build_mesh

    res = ranks[1]
    q = jnp.zeros((1, 64, 6, 16))
    with pytest.raises(ValueError, match="divisible") as ref:
        ulysses_attention(q, q, q, build_mesh(MeshSpec({"sp": 8})))
    for out in res:
        assert out["indivisible"] == str(ref.value)


def test_ring_attention_equals_full_attention(ranks):
    """Beside the reference: the port's ring output is the port's own
    unsharded attention."""
    import torch

    from ray_tpu_torch.ops.attention import attention_reference

    inputs, res, _ = ranks
    for name in ("ring_causal", "ring_full", "ring_gqa"):
        q, k, v = (torch.from_numpy(t) for t in inputs[name])
        want = attention_reference(q, k, v, causal=CASES[name][7]).numpy()
        np.testing.assert_allclose(res[0][name]["out"], want, atol=2e-5)
