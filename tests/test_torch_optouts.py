"""The reference's kernel switches in the PyTorch port, on the CPU.

``flash_attention(use_pallas=, interpret=)`` and
``PagedLLMEngine(use_kernel=)`` (through ``make_paged_engine_fns``)
behave as ``ray_tpu``'s: ``False`` runs the plain attention on either
device, ``True`` asks for the kernels, which on CPU tensors means the
kernels' plain versions with ``interpret=True`` (the reference's Pallas
interpreter) and a ``ValueError`` without it. Inputs come from a numpy
seed; attention is held at 2e-5 (as tests/test_ops.py), engines to
identical greedy transcripts.
"""

import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from ray_tpu.models import llama as jl  # noqa: E402
from ray_tpu.ops import attention as jattn  # noqa: E402
from ray_tpu_torch.models import llama as tl  # noqa: E402
from ray_tpu_torch.models import llama_paged as tpaged_model  # noqa: E402
from ray_tpu_torch.models.convert import params_from_numpy  # noqa: E402
from ray_tpu_torch.ops import attention as tattn  # noqa: E402
from ray_tpu_torch.serve.paged_engine import PagedLLMEngine  # noqa: E402

torch.set_num_threads(1)

# (b, sq, sk, heads, kv_heads, d, causal)
CASES = {
    "causal_gqa": (2, 128, 128, 4, 2, 32, True),
    "noncausal": (1, 128, 128, 4, 4, 16, False),
    "sk_gt_sq": (1, 64, 128, 4, 2, 32, True),
}


def _inputs(case, seed):
    b, sq, sk, h, kvh, d, _ = CASES[case]
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, sq, h, d), (b, sk, kvh, d), (b, sk, kvh, d),
                      (b, sq, h, d))]


def _grads_jax(fn, q, k, v, g):
    out, vjp = jax.vjp(fn, *map(jnp.asarray, (q, k, v)))
    return [np.asarray(x) for x in (out, *vjp(jnp.asarray(g)))]


def _grads_torch(fn, q, k, v, g):
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = fn(tq, tk, tv)
    out.backward(torch.from_numpy(g))
    return [x.detach().numpy() for x in (out, tq.grad, tk.grad, tv.grad)]


@pytest.mark.parametrize("case", sorted(CASES))
def test_use_pallas_false_matches_reference(case):
    """``use_pallas=False``: the plain attention, output and gradients."""
    q, k, v, g = _inputs(case, seed=20)
    causal = CASES[case][-1]
    want = _grads_jax(lambda *a: jattn.flash_attention(
        *a, causal=causal, use_pallas=False), q, k, v, g)
    got = _grads_torch(lambda *a: tattn.flash_attention(
        *a, causal=causal, use_pallas=False), q, k, v, g)
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a, b, atol=2e-5, err_msg=name)


@pytest.mark.parametrize("case", sorted(CASES))
def test_use_pallas_interpret_matches_pallas_interpret(case):
    """``use_pallas=True, interpret=True``: the kernels' plain versions
    against the Pallas kernels in interpret mode, forward and backward."""
    q, k, v, g = _inputs(case, seed=21)
    causal = CASES[case][-1]
    kw = dict(causal=causal, use_pallas=True, interpret=True, block_q=64,
              block_k=64)
    want = _grads_jax(lambda *a: jattn.flash_attention(*a, **kw), q, k, v,
                      g)
    got = _grads_torch(lambda *a: tattn.flash_attention(*a, **kw), q, k, v,
                       g)
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a, b, atol=2e-5, err_msg=name)


def test_use_pallas_true_without_interpret_raises_on_cpu():
    q = torch.zeros(1, 128, 2, 16)
    with pytest.raises(ValueError, match="interpret=True"):
        tattn.flash_attention(q, q, q, use_pallas=True)
    # the default picks by device: the plain versions on the CPU
    assert tattn.flash_attention(q, q, q).shape == q.shape


def test_use_pallas_false_skips_the_block_check():
    """As in the reference, ``use_pallas=False`` never reaches the kernels'
    block rule, so lengths that do not divide a block are accepted."""
    q = torch.randn(1, 100, 2, 16)
    with pytest.raises(ValueError, match="divisible"):
        tattn.flash_attention(q, q, q, block_q=64, block_k=64)
    out = tattn.flash_attention(q, q, q, block_q=64, block_k=64,
                                use_pallas=False)
    torch.testing.assert_close(out, tattn.attention_reference(q, q, q))


# ---------------------------------------------------------------- paged

TINY = dict(model_config={"preset": "tiny"}, num_slots=4, max_len=96,
            prefill_buckets=[16], max_new_tokens=8, chunk_steps=4)


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(1, 250, n)] for n in lens]


def _run(engine, reqs, timeout_s=120):
    try:
        for rid, prompt in reqs:
            engine.submit(rid, prompt)
        out = {}
        deadline = time.time() + timeout_s
        while len(out) < len(reqs) and time.time() < deadline:
            out.update(engine.collect())
            time.sleep(0.005)
        return {k: v["tokens"] for k, v in out.items()}
    finally:
        engine.shutdown()


def test_paged_engine_use_kernel_false_matches_reference():
    """``PagedLLMEngine(use_kernel=False)`` gives the reference's
    ``PagedLLMEngine(use_kernel=False)`` transcripts on the same weights,
    and the same as the default on the CPU."""
    from ray_tpu.serve.paged_engine import PagedLLMEngine as JaxPaged

    reqs = [(f"r{i}", p) for i, p in enumerate(_prompts(8, (5, 21, 40)))]
    want = _run(JaxPaged(page_size=8, use_kernel=False, **TINY), reqs)
    params = params_from_numpy(jax.tree_util.tree_map(
        np.asarray, jl.init_params(jl.LlamaConfig.tiny(),
                                   jax.random.PRNGKey(0))), "cpu")
    got = _run(PagedLLMEngine(page_size=8, use_kernel=False, params=params,
                              device="cpu", **TINY), reqs)
    assert len(want) == 3 and all(len(t) == 8 for t in want.values())
    assert got == want
    default = _run(PagedLLMEngine(page_size=8, params=params, device="cpu",
                                  **TINY), reqs)
    assert default == want


def test_paged_use_kernel_true_raises_on_cpu():
    with pytest.raises(ValueError, match="CUDA"):
        PagedLLMEngine(use_kernel=True, device="cpu", **TINY)
    cfg = tl.LlamaConfig.tiny()
    params = tl.init_params(cfg, 0, "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        tpaged_model.make_paged_engine_fns(cfg, params, use_kernel=True)


def test_paged_decode_step_use_kernel_false_is_the_gather():
    """``paged_decode_step(use_kernel=False)`` takes the gather: the same
    logits as the default on the CPU (the kernel's plain version), whose
    arithmetic is the gather's."""
    cfg = tl.LlamaConfig.tiny()
    params = tl.init_params(cfg, 0, "cpu")
    rng = np.random.default_rng(9)
    cache = tpaged_model.init_paged_cache(cfg, 12, 8, "cpu")
    for key in cache:
        cache[key].copy_(torch.from_numpy(rng.standard_normal(
            tuple(cache[key].shape)).astype(np.float32)))
    bt = torch.from_numpy(rng.permutation(12)[:8].reshape(2, 4)
                          .astype(np.int32))
    toks = torch.tensor([3, 7], dtype=torch.int32)
    pos = torch.tensor([5, 20], dtype=torch.int32)
    active = np.array([True, True])
    outs = []
    for use_kernel in (None, False):
        c = {k: v.clone() for k, v in cache.items()}
        _, logits = tpaged_model.paged_decode_step(cfg, params, c, toks, pos,
                                                   active, bt, use_kernel)
        outs.append(logits)
    torch.testing.assert_close(outs[0], outs[1], atol=1e-5, rtol=1e-5)
