"""The PyTorch port's serving engines against the JAX engines.

Greedy transcripts of the port's LLMEngine and PagedLLMEngine must be
token-identical to the JAX engines' on the same weights (the JAX engine
draws its own from PRNGKey(0); the port gets them converted through
numpy). The JAX engines run once per module: they compile on first use.
The rest holds the port's engines to the reference's engine contract:
prefix caching, chunked prefill, pool pressure, cancel, duplicate
request ids, sampling and stop tokens, the chain hash, page export and
import.
"""

import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from ray_tpu.models import llama as jl  # noqa: E402
from ray_tpu_torch.models.convert import params_from_numpy  # noqa: E402
from ray_tpu_torch.serve.llm_engine import LLMEngine  # noqa: E402
from ray_tpu_torch.serve.paged_engine import (PagedLLMEngine,  # noqa: E402
                                              _PageAllocator)

torch.set_num_threads(1)

# the reference engine suite's settings (tests/test_serve_paged.py)
TINY = dict(model_config={"preset": "tiny"}, num_slots=4, max_len=96,
            prefill_buckets=[16], max_new_tokens=8, chunk_steps=4)
PORT = dict(TINY, device="cpu")


def _drain(engine, reqs, timeout_s=120):
    """submit/poll helper; reqs: list of (req_id, prompt, kwargs)."""
    for rid, prompt, kw in reqs:
        engine.submit(rid, prompt, **kw)
    out = {}
    deadline = time.time() + timeout_s
    while len(out) < len(reqs) and time.time() < deadline:
        out.update(engine.collect())
        time.sleep(0.005)
    return out


def _tokens(out):
    return {k: v["tokens"] for k, v in out.items()}


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(1, 250, n)] for n in lens]


def _run(engine, reqs, timeout_s=120):
    try:
        return _drain(engine, reqs, timeout_s)
    finally:
        engine.shutdown()


@pytest.fixture(scope="module")
def reference():
    """The JAX engines' greedy transcripts for the reference suite's
    mixed batch (3/23/9/40-token prompts: one spans three 16-token
    prefill chunks), and the same weights for the port."""
    from ray_tpu.serve.llm_engine import LLMEngine as JaxEngine
    from ray_tpu.serve.paged_engine import PagedLLMEngine as JaxPaged

    reqs = [(f"r{i}", p, {}) for i, p in enumerate(_prompts(7, (3, 23, 9,
                                                                 40)))]
    dense = _tokens(_run(JaxEngine(**TINY), reqs))
    paged = _tokens(_run(JaxPaged(page_size=8, **TINY), reqs))
    params = jax.tree_util.tree_map(
        np.asarray, jl.init_params(jl.LlamaConfig.tiny(),
                                   jax.random.PRNGKey(0)))
    return {"reqs": reqs, "dense": dense, "paged": paged,
            "params": params_from_numpy(params, "cpu")}


def test_dense_engine_matches_jax_engine(reference):
    got = _tokens(_run(LLMEngine(params=reference["params"], **PORT),
                       reference["reqs"]))
    assert len(reference["dense"]) == 4
    assert got == reference["dense"]


def test_paged_engine_matches_jax_engine(reference):
    eng = PagedLLMEngine(page_size=8, params=reference["params"], **PORT)
    got = _tokens(_run(eng, reference["reqs"]))
    assert got == reference["paged"] == reference["dense"]
    assert eng._prefill_tokens_computed == 3 + 23 + 9 + 40


def test_chain_hash_matches_reference():
    from ray_tpu.serve.paged_engine import _PageAllocator as JaxAllocator

    for prev, toks in ((0, tuple(range(8))), (12345, (7, 8, 9)),
                       (2 ** 63 + 5, (-1, 0, 2 ** 40))):
        assert (_PageAllocator.chain_hash(prev, toks)
                == JaxAllocator.chain_hash(prev, toks))
    prompt = list(range(100, 140))
    a, b = _PageAllocator(8, 8), JaxAllocator(8, 8)
    assert a.match_prefix(prompt, 39)[1] == b.match_prefix(prompt, 39)[1]


def test_prefix_cache_reuses_pages():
    """A repeated prefix skips prefill for its cached full pages, and
    sharing changes the work, not the tokens."""
    shared = _prompts(3, (32,))[0]               # 4 full pages of 8
    p1, p2 = shared + [11, 12, 13], shared + [99, 98]
    eng = PagedLLMEngine(page_size=8, **PORT)
    try:
        out1 = _drain(eng, [("a", p1, {})])
        before = eng._prefill_tokens_computed
        assert eng._prefix_hit_tokens == 0
        out2 = _drain(eng, [("b", p2, {})])
        assert eng._prefix_hit_tokens == 32
        assert eng._prefill_tokens_computed - before == 2
        digest = eng.residency_digest()
        assert digest["page_size"] == 8 and len(digest["hashes"]) >= 4
        assert eng.stats()["prefix_hit_tokens"] == 32
    finally:
        eng.shutdown()
    cold = _tokens(_run(PagedLLMEngine(page_size=8, **PORT),
                        [("a", p1, {}), ("b", p2, {})]))
    assert cold == {"a": out1["a"]["tokens"], "b": out2["b"]["tokens"]}


def test_long_prompt_chunked_prefill_matches_dense():
    prompt = _prompts(5, (70,))[0]
    want = _tokens(_run(LLMEngine(**PORT), [("x", prompt, {})]))
    eng = PagedLLMEngine(page_size=8, **PORT)
    got = _tokens(_run(eng, [("x", prompt, {})]))
    assert eng._prefill_tokens_computed == 70     # five 16-token chunks
    assert got == want


def test_small_pool_requeues_until_pages_free():
    reqs = [(f"q{i}", p, {}) for i, p in enumerate(_prompts(9, [17] * 6))]
    out = _run(PagedLLMEngine(page_size=8, num_pages=8, **PORT), reqs, 180)
    assert sorted(out) == sorted(r[0] for r in reqs)
    assert all(len(v["tokens"]) == 8 for v in out.values())


def test_oversized_prompt_rejected_and_head_of_line_retry():
    eng = PagedLLMEngine(page_size=8, num_pages=8, **PORT)
    try:
        huge, s0, big = _prompts(13, (80, 9, 49))
        out = _drain(eng, [("huge", huge, {}), ("s0", s0, {})])
        assert isinstance(out["huge"], RuntimeError)
        assert "pages" in str(out["huge"])
        assert len(out["s0"]["tokens"]) == 8
        # a 7-page request parked behind a running one is admitted
        # before the small requests submitted after it
        eng.submit("s1", s0)
        time.sleep(0.05)
        order = []
        for rid, p in [("big", big)] + [(f"t{i}", s0) for i in range(3)]:
            eng.submit(rid, p)
        deadline = time.time() + 120
        while len(order) < 5 and time.time() < deadline:
            order.extend(eng.collect())
            time.sleep(0.005)
        assert sorted(order) == ["big", "s1", "t0", "t1", "t2"]
        assert order.index("big") < order.index("t1")
    finally:
        eng.shutdown()


@pytest.mark.parametrize("engine", ["dense", "paged"])
def test_cancel_frees_the_slot(engine):
    kw = dict(PORT, max_new_tokens=3000, max_len=64, chunk_steps=2)
    eng = (LLMEngine(**kw) if engine == "dense"
           else PagedLLMEngine(page_size=8, **kw))
    try:
        free0 = len(eng._alloc.free) if engine == "paged" else None
        eng.submit("victim", [1, 2, 3, 4, 5])
        deadline = time.time() + 60
        while not eng._slot_req and time.time() < deadline:
            time.sleep(0.005)
        assert eng._slot_req, "request never admitted"
        eng.cancel("victim")
        deadline = time.time() + 60
        while eng._slot_req and time.time() < deadline:
            time.sleep(0.005)
        assert not eng._slot_req, "slot not freed after cancel"
        assert len(eng._free) == kw["num_slots"]
        if engine == "paged":
            assert len(eng._alloc.free) + len(eng._alloc.lru) == free0
        assert eng.collect() == {}
    finally:
        eng.shutdown()


def test_duplicate_request_id_runs_once():
    eng = LLMEngine(**PORT)
    try:
        prompt = [5, 6, 7]
        eng.submit("dup", prompt)
        eng.submit("dup", [9, 9, 9, 9])   # replay of a delivered submit
        out = _drain(eng, [])
        deadline = time.time() + 60
        while "dup" not in out and time.time() < deadline:
            out.update(eng.collect())
            time.sleep(0.005)
        time.sleep(0.2)
        out.update(eng.collect())
        assert list(out) == ["dup"]
        alone = _tokens(_run(LLMEngine(**PORT), [("x", prompt, {})]))
        assert out["dup"]["tokens"] == alone["x"]
    finally:
        eng.shutdown()


def test_sampling_and_stop_ids():
    """Sampled slots diverge while the greedy slot in the same batch
    stays deterministic; a per-request stop token ends generation and is
    kept in the output."""
    prompt = [5, 3, 7]
    out = _run(PagedLLMEngine(page_size=8, top_k=20, **PORT),
               [("g", prompt, {}), ("s1", prompt, {"temperature": 1.0}),
                ("s2", prompt, {"temperature": 1.0})])
    toks = _tokens(out)
    assert all(len(t) == 8 for t in toks.values())
    assert toks["s1"] != toks["g"] or toks["s2"] != toks["g"]
    greedy = _tokens(_run(LLMEngine(**PORT), [("g", prompt, {})]))["g"]
    assert toks["g"] == greedy
    stop_tok = greedy[3]
    got = _run(LLMEngine(**PORT), [("b", prompt, {"stop_ids": [stop_tok]})])
    assert got["b"]["tokens"] == greedy[:greedy.index(stop_tok) + 1]


def test_peek_stats_and_quantized_engine():
    eng = LLMEngine(**dict(PORT, model_config={"preset": "tiny",
                                               "quantize": "int8"}))
    try:
        out = _drain(eng, [("r1", [1, 2, 3, 4], {})])
        assert len(out["r1"]["tokens"]) == 8
        assert out["r1"]["ttft_s"] <= out["r1"]["latency_s"]
        st = eng.stats()
        assert st["slots"] == 4 and st["active"] == 0 and st["steps"] > 0
        eng.submit("r2", [1, 2, 3, 4])
        deadline = time.time() + 60
        seen = {}
        while time.time() < deadline:
            seen = eng.peek(["r2"], since={"r2": 2})
            if seen.get("r2", {}).get("done"):
                break
            time.sleep(0.005)
        assert seen["r2"]["offset"] == 2
        assert seen["r2"]["tokens"] == out["r1"]["tokens"][2:]
    finally:
        eng.shutdown()


def test_export_import_pages_roundtrip():
    """Pages exported from one engine and imported into another become
    cached prefixes there: the same prompt then hits the cache and
    yields the same tokens."""
    shared = _prompts(21, (24,))[0]
    prompt = shared + [4, 5]
    src = PagedLLMEngine(page_size=8, **PORT)
    try:
        want = _drain(src, [("a", prompt, {})])["a"]["tokens"]
        alloc = src._alloc
        hashes = alloc.match_prefix(prompt, len(prompt) - 1)[1][:3]
        pages = [alloc.hash2page[h] for h in hashes]
        k, v = src.export_pages(pages)
        assert tuple(k.shape[:2]) == (2, 3)
    finally:
        src.shutdown()
    dst = PagedLLMEngine(page_size=8, **PORT)
    try:
        # the engine is idle, so its pool may be filled from this thread
        assert dst.import_pages(k, v, hashes) == 3
        assert dst.import_pages(k, v, hashes) == 0   # already resident
        out = _drain(dst, [("a", prompt, {})])
        assert dst._prefix_hit_tokens == 24
        assert out["a"]["tokens"] == want
    finally:
        dst.shutdown()


def test_unported_options_raise():
    """int8 weights under tensor parallelism, and an hf_model outside the
    llama family (gpt2, mixtral), are refused before any weights load or
    any rank starts, with the reference's ValueErrors."""
    from transformers import GPT2Config, GPT2LMHeadModel

    gpt2 = GPT2LMHeadModel(GPT2Config(vocab_size=64, n_embd=32, n_layer=1,
                                      n_head=2, n_positions=32))
    with pytest.raises(ValueError, match="llama-family.*'gpt2'"):
        LLMEngine(model_config={"hf_model": gpt2}, device="cpu")
    with pytest.raises(ValueError, match="quantize='int8' currently serves "
                       r"single-chip \(tp=1\); drop quantize or tp"):
        LLMEngine(model_config={"preset": "tiny", "quantize": "int8"}, tp=2,
                  device="cpu")
    with pytest.raises(ValueError, match="quantize"):
        LLMEngine(model_config={"preset": "tiny", "quantize": "int4"},
                  device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            LLMEngine(**TINY)
