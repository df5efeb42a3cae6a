"""Tensor-parallel serving in the port against ``ray_tpu`` on the CPU.

``LLMEngine(tp=N, device="cpu")`` starts N - 1 follower processes (gloo
ranks) beside the caller's rank 0; its greedy transcripts must equal the
port's single engine's and the JAX engine's ``LLMEngine(tp=N)`` on the
same weights (the JAX engine draws its own from PRNGKey(0); the port gets
them converted through numpy). The reference's own case
(``tests/test_serve.py``'s tensor-parallel test): its prompts, the tiny
preset with 4 KV heads (the cache split over tp 4) and with its own 2
(tp does not divide them: the cache replicated, q/k/v gathered). Then
the paged engine at tp 4 against the dense engine (the reference's dry
run), q/k/v biases, a sampled request, cancel and a duplicate request id
at tp 2, the refusals, the disaggregated engine at tp 2, a killed
follower, and ``mesh=`` over ranks the caller started
(``tests/_torch_ranks.py``), with a page export there.

Every engine is shut down in ``finally``, every wait has a deadline.
"""

import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ray_tpu_torch.models.convert import params_from_numpy  # noqa: E402
from ray_tpu_torch.serve.llm_engine import LLMEngine  # noqa: E402
from ray_tpu_torch.serve.paged_engine import PagedLLMEngine  # noqa: E402

torch.set_num_threads(1)

# the reference's tensor-parallel test (tests/test_serve.py)
PROMPTS = [[7, 3, 9, 1], [5, 5, 2], [11, 4, 6, 8, 2], [1, 2]]
KW = dict(num_slots=4, max_len=32, prefill_buckets=[8], max_new_tokens=6,
          chunk_steps=2)
PRESETS = {"kv4": {"preset": "tiny", "num_kv_heads": 4},
           "kv2": {"preset": "tiny"}}


def _wait(engine, ids, timeout_s=60):
    """Collect until every id in ``ids`` has a result (or the deadline)."""
    out = {}
    deadline = time.time() + timeout_s
    while not set(ids) <= set(out) and time.time() < deadline:
        out.update(engine.collect())
        time.sleep(0.005)
    return out


def _drain(engine, reqs, timeout_s=60):
    """reqs: (req_id, prompt, submit kwargs); results by request id."""
    for rid, prompt, kw in reqs:
        engine.submit(rid, prompt, **kw)
    return _wait(engine, [r[0] for r in reqs], timeout_s)


def _tokens(engine, reqs=None, timeout_s=60):
    reqs = reqs or [(f"r{i}", p, {}) for i, p in enumerate(PROMPTS)]
    try:
        out = _drain(engine, reqs, timeout_s)
    finally:
        engine.shutdown()
    assert len(out) == len(reqs), out
    return {k: v["tokens"] for k, v in out.items()}


def _params(**kw):
    """The JAX engine's weights (``init_params(PRNGKey(0))``) as numpy."""
    import jax

    from ray_tpu.models import llama as jl

    cfg = jl.LlamaConfig.tiny(**kw)
    return jax.tree_util.tree_map(np.asarray,
                                  jl.init_params(cfg, jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def reference():
    """The JAX engines' transcripts, single and tp 4, for both presets."""
    from ray_tpu.serve.llm_engine import LLMEngine as JaxEngine

    out = {}
    for name, mc in PRESETS.items():
        out[name] = {"single": _tokens(JaxEngine(model_config=mc, **KW)),
                     "tp4": _tokens(JaxEngine(model_config=mc, tp=4, **KW))}
    return out


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_tp4_matches_single_and_reference(reference, name):
    """4 KV heads: each rank holds one KV head of the cache; 2 KV heads:
    the cache replicated, Q heads and MLP still split."""
    mc = PRESETS[name]
    tree = _params(**{k: v for k, v in mc.items() if k != "preset"})
    single = _tokens(LLMEngine(model_config=mc, params=params_from_numpy(
        tree, "cpu"), device="cpu", **KW))
    tp4 = _tokens(LLMEngine(model_config=mc, tp=4, params=params_from_numpy(
        tree, "cpu"), device="cpu", **KW))
    assert all(len(t) == 6 for t in tp4.values())
    assert single == reference[name]["single"]
    assert tp4 == single == reference[name]["tp4"]


def test_paged_tp4_matches_dense(reference):
    """The reference's dry run: the tp 4 paged engine's tokens match the
    dense engine's."""
    mc = PRESETS["kv4"]
    tree = _params(num_kv_heads=4)
    paged = _tokens(PagedLLMEngine(model_config=mc, tp=4, page_size=8,
                                   params=params_from_numpy(tree, "cpu"),
                                   device="cpu", **KW))
    assert paged == reference["kv4"]["tp4"]


def test_tp2_qkv_bias_matches_single():
    """Qwen2's q/k/v biases shard with their projections' columns."""
    mc = {"preset": "tiny", "attn_qkv_bias": True}
    tree = _params(attn_qkv_bias=True)
    rng = np.random.default_rng(3)
    for b in ("bq", "bk", "bv"):
        tree["layers"][b] = (0.5 * rng.standard_normal(
            tree["layers"][b].shape)).astype(np.float32)
    kw = dict(KW, max_new_tokens=8)
    single = _tokens(LLMEngine(model_config=mc, params=params_from_numpy(
        tree, "cpu"), device="cpu", **kw))
    tp2 = _tokens(LLMEngine(model_config=mc, tp=2, params=params_from_numpy(
        tree, "cpu"), device="cpu", **kw))
    assert tp2 == single


def test_tp2_serves_qwen2_checkpoint_like_hf(tmp_path):
    """``hf_model`` at tp 2: rank 0 loads the checkpoint and scatters it,
    the q/k/v biases with their projections; the transcripts are HF's
    ``generate``'s."""
    from tests.test_torch_hf_weights import _hf_model

    hf = _hf_model("qwen2")
    hf.save_pretrained(str(tmp_path))
    want = {f"r{i}": hf.generate(torch.tensor([p]), max_new_tokens=6,
                                 do_sample=False)[0, len(p):].tolist()
            for i, p in enumerate(PROMPTS)}
    mc = {"hf_model": str(tmp_path), "dtype": "float32",
          "param_dtype": "float32"}
    assert _tokens(LLMEngine(model_config=mc, tp=2, device="cpu",
                             **KW)) == want


def test_tp2_cancel_and_duplicate_ids():
    """At tp 2 a cancelled request gives no result and a duplicate request
    id is dropped (the mailbox is rank 0's)."""
    eng = LLMEngine(tp=2, device="cpu", **KW)
    try:
        eng.submit("long", PROMPTS[1], 20)
        eng.cancel("long")
        eng.submit("dup", PROMPTS[3])
        eng.submit("dup", PROMPTS[3])
        eng.submit("after", PROMPTS[3])
        out = _wait(eng, ["dup", "after"])
        time.sleep(0.2)
        out.update(eng.collect())
    finally:
        eng.shutdown()
    assert set(out) == {"dup", "after"}
    assert out["dup"]["tokens"] == out["after"]["tokens"]


def test_tp2_sampled_tokens_equal_tp1():
    """A sampled request at tp 2 (drawn by rank 0, broadcast) equals tp
    1's with the same ``sampling_seed``."""
    tree = _params()
    reqs = [("s", PROMPTS[0], {"temperature": 0.9}),
            ("g", PROMPTS[2], {})]
    kw = dict(KW, max_new_tokens=10, sampling_seed=5)
    single = _tokens(LLMEngine(params=params_from_numpy(tree, "cpu"),
                               device="cpu", **kw), reqs)
    tp2 = _tokens(LLMEngine(tp=2, params=params_from_numpy(tree, "cpu"),
                            device="cpu", **kw), reqs)
    assert tp2 == single
    assert single["s"] != single["g"]


def test_refusals_match_reference():
    """int8 under tp, with the reference's message; a CUDA engine with
    more ranks than cards, with the reference's."""
    from ray_tpu.serve.llm_engine import LLMEngine as JaxEngine

    mc = {"preset": "tiny", "quantize": "int8"}
    with pytest.raises(ValueError) as ref:
        JaxEngine(model_config=mc, tp=2, **KW)
    with pytest.raises(ValueError) as got:
        LLMEngine(model_config=mc, tp=2, device="cpu", **KW)
    assert str(got.value) == str(ref.value)
    if torch.cuda.is_available():
        n = torch.cuda.device_count()
        with pytest.raises(ValueError,
                           match=f"tp={n + 1} needs {n + 1} devices, "
                           f"found {n}"):
            LLMEngine(tp=n + 1, **KW)


def test_disaggregated_engine_refuses_tp():
    """The disaggregated engine under tp, which it refused until its
    workers got lanes of their own: ``DisaggPagedEngine(tp=2)`` diverts
    the long prompts to its prefill worker and gives the single paged
    engine's tokens; ``mesh=`` that is not a mesh of the caller's group
    is still refused before any rank starts."""
    from ray_tpu_torch.serve.disagg import DisaggPagedEngine

    reqs = [(f"d{i}", p, {}) for i, p in
            enumerate([list(range(1, 21)), list(range(3, 14)), PROMPTS[0]])]
    tree = _params()
    single = _tokens(PagedLLMEngine(page_size=8, device="cpu",
                                    params=params_from_numpy(tree, "cpu"),
                                    **KW), reqs)
    eng = DisaggPagedEngine(tp=2, page_size=8, device="cpu",
                            prefill_workers=1, divert_min_tokens=9,
                            handoff_timeout_s=60.0,
                            params=params_from_numpy(tree, "cpu"), **KW)
    try:
        out = _drain(eng, reqs)
        st = eng.stats()
    finally:
        eng.shutdown()
    assert {k: v["tokens"] for k, v in out.items()} == single
    assert st["disagg_diverted"] == st["disagg_handoffs"] == 2
    assert st["disagg_recovered"] == 0
    with pytest.raises((ValueError, RuntimeError)):
        DisaggPagedEngine(device="cpu", page_size=8, mesh=object(), **KW)


def test_killed_follower_fails_requests_and_shutdown_reaps():
    """A follower killed mid-run: rank 0 fails the request within the
    bound instead of hanging, ``submit`` then raises, and ``shutdown``
    leaves no live follower."""
    eng = LLMEngine(tp=2, device="cpu", **KW)
    procs = list(eng._link._procs)
    try:
        first = _drain(eng, [("a", PROMPTS[0], {})])
        assert len(first["a"]["tokens"]) == 6
        procs[0].kill()
        procs[0].join(timeout=10)
        t0 = time.monotonic()
        out = _drain(eng, [("b", PROMPTS[1], {"max_new_tokens": 20})],
                     timeout_s=60)
        assert isinstance(out["b"], RuntimeError), out
        assert time.monotonic() - t0 < 60
        with pytest.raises(RuntimeError, match="engine stopped"):
            eng.submit("c", PROMPTS[2])
    finally:
        eng.shutdown()
    assert not any(p.is_alive() for p in procs)


def test_shutdown_stops_every_follower():
    eng = PagedLLMEngine(tp=2, page_size=8, device="cpu", **KW)
    procs = list(eng._link._procs)
    assert len(procs) == 1 and procs[0].is_alive()
    _tokens(eng, [("a", PROMPTS[0], {})])
    assert not any(p.is_alive() for p in procs)
    import torch.distributed as dist

    assert not dist.is_initialized()


# ------------------------------------------------ mesh= over caller's ranks


# a prompt of two full pages of 8, which the paged engines publish to
# their prefix caches
LONG = list(range(1, 21))


def _export_long(eng):
    """Serve ``LONG``, then export its two cached pages (numpy)."""
    _drain(eng, [("long", LONG, {})])
    alloc = eng._alloc
    pages, _, _ = alloc.match_prefix(LONG, 16)
    k, v = eng.export_pages(pages)
    for pg in pages:
        alloc.release(pg)
    return k.numpy(), v.numpy()


def _mesh_ranks(rank, world, tree):
    """Every rank builds the engine on the caller's group; rank 0 serves
    and returns the transcripts (the others return after shutdown). Also:
    ``tp=`` inside a process that holds a group is refused."""
    from ray_tpu_torch.parallel import MeshSpec, build_mesh

    from ray_tpu_torch.models import llama, llama_decode

    mesh = build_mesh(MeshSpec({"tp": world}))
    # the reference's make_engine_fns(mesh=) takes a whole tree every
    # rank holds, and places it itself
    cfg = llama.LlamaConfig.tiny(num_kv_heads=4)
    pre, *_ = llama_decode.make_engine_fns(
        cfg, params_from_numpy(tree, "cpu"), 4, 32, mesh=mesh)
    out = {"logits": pre(torch.tensor([PROMPTS[0] + [0] * 4]),
                         torch.tensor([3]))[0].numpy()}
    for cls, kw in ((LLMEngine, {}), (PagedLLMEngine, {"page_size": 8})):
        eng = cls(model_config=PRESETS["kv4"], mesh=mesh,
                  params=params_from_numpy(tree, "cpu"), device="cpu",
                  **kw, **KW)
        if rank == 0:
            if cls is PagedLLMEngine:
                out["export_pages"] = _export_long(eng)
            out[cls.__name__] = _tokens(eng)
        else:
            with pytest.raises(RuntimeError, match="rank 0"):
                eng.submit("x", [1])
    try:
        LLMEngine(tp=2, device="cpu")
    except ValueError as e:
        out["tp_in_group"] = str(e)
    return out


@pytest.mark.parametrize("world", [1, 2])
def test_mesh_engines_match_reference(reference, tmp_path, world):
    """``mesh=`` at world size 1 (what one card runs) and over 2 ranks of
    the caller's group: both engines give the reference's tokens."""
    from tests._torch_ranks import run_ranks

    res = run_ranks(_mesh_ranks, world, _params(num_kv_heads=4),
                    store_dir=str(tmp_path), timeout_s=120)
    from ray_tpu_torch.models import llama, llama_decode

    tree = _params(num_kv_heads=4)
    want_logits, _ = llama_decode.prefill_batch(
        llama.LlamaConfig.tiny(num_kv_heads=4), params_from_numpy(tree, "cpu"),
        torch.tensor([PROMPTS[0] + [0] * 4]), torch.tensor([3]))
    for r in res:
        np.testing.assert_allclose(r["logits"], want_logits.numpy(),
                                   atol=1e-5, rtol=1e-5)
    want = reference["kv4"]["tp4"]
    assert res[0]["LLMEngine"] == want
    assert res[0]["PagedLLMEngine"] == want
    # export_pages under mesh= (rank 0 gathers the KV-head blocks at
    # world 2) equals the mesh-free engine's export of the same pages
    eng = PagedLLMEngine(model_config=PRESETS["kv4"], page_size=8,
                         params=params_from_numpy(tree, "cpu"),
                         device="cpu", **KW)
    try:
        want_k, want_v = _export_long(eng)
    finally:
        eng.shutdown()
    got_k, got_v = res[0]["export_pages"]
    assert got_k.shape == (2, 2, 4, 8, 16)
    np.testing.assert_allclose(got_k, want_k, atol=2e-5, rtol=0)
    np.testing.assert_allclose(got_v, want_v, atol=2e-5, rtol=0)
    for r in res:
        assert "mesh=" in r["tp_in_group"]
