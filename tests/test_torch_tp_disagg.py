"""Page export/import and disaggregated serving under tensor parallelism,
the port against ``ray_tpu``.

The port's engines run with ``mesh=`` over gloo ranks
(``tests/_torch_ranks.py``): 4 ranks serve the tiny preset in fp32 with 4
KV heads (each rank holds one KV head of the page pool) and with its own
2 (tp does not divide them: the pool is replicated). The reference runs
the same engines at tp 4 on the CPU's virtual devices, on the same
weights (``init_params(PRNGKey(0))``, converted through numpy), in a
thread while the ranks run. Held:

- ``export_pages`` of a served prompt's pages equals the reference's
  export of the same prompt's pages (atol 2e-5);
- ``import_pages`` of them into a fresh engine, then the same prompt:
  a prefix hit that gives the reference's tokens;
- ``DisaggPagedEngine`` (2 prefill workers) gives the transcripts and
  counters of the reference's ``DisaggPagedEngine`` under its mesh.

Then 2 ranks at tp 2: a dropped handoff and a killed worker lose no
request and leak no page, on rank 0 or in a follower's stash.
"""

import threading
import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

TINY = dict(num_slots=4, max_len=96, prefill_buckets=[16],
            max_new_tokens=8, chunk_steps=4, page_size=8)
PRESETS = {"kv4": {"preset": "tiny", "num_kv_heads": 4},
           "kv2": {"preset": "tiny"}}
COUNTERS = ("disagg_diverted", "disagg_handoffs", "disagg_recovered",
            "disagg_imported_pages", "disagg_pending")


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(1, 250, n)] for n in lens]


# the 23/40/70-token prompts divert (the 16-token floor); the 70-token
# one's 8 full pages are the ones exported
REQS = [(f"r{i}", p) for i, p in enumerate(_prompts(7, (3, 23, 9, 40, 70)))]
HIT = REQS[4][1]


def _drain(engine, reqs, timeout_s=120):
    for rid, prompt in reqs:
        engine.submit(rid, prompt)
    out = {}
    deadline = time.time() + timeout_s
    while len(out) < len(reqs) and time.time() < deadline:
        out.update(engine.collect())
        time.sleep(0.005)
    return out


def _tokens(out):
    return {k: v["tokens"] for k, v in out.items()}


def _pool_balanced(eng) -> bool:
    alloc = eng._alloc
    return len(alloc.free) + len(alloc.lru) == alloc.num_pages


def _export(eng, prompt):
    """The cached pages of ``prompt``'s full pages, exported (numpy),
    with their hashes; the refs match_prefix takes are given back."""
    alloc = eng._alloc
    pages, hashes, _ = alloc.match_prefix(prompt, len(prompt))
    k, v = eng.export_pages(pages)
    for pg in pages:
        alloc.release(pg)
    return np.asarray(k), np.asarray(v), hashes


def _tree(**kw):
    from ray_tpu.models import llama as jl

    cfg = jl.LlamaConfig.tiny(**kw)
    return jax.tree_util.tree_map(np.asarray,
                                  jl.init_params(cfg, jax.random.PRNGKey(0)))


def _reference():
    """The JAX engines at tp 4: the paged engine's transcripts and
    export, the disaggregated engine's transcripts and counters."""
    from ray_tpu.serve.disagg import DisaggPagedEngine as JaxDisagg
    from ray_tpu.serve.paged_engine import PagedLLMEngine as JaxPaged

    out = {}
    for name, mc in PRESETS.items():
        eng = JaxPaged(model_config=mc, tp=4, **TINY)
        try:
            paged = _tokens(_drain(eng, REQS))
            export = _export(eng, HIT)
        finally:
            eng.shutdown()
        eng = JaxDisagg(model_config=mc, tp=4, prefill_workers=2, **TINY)
        try:
            disagg = _tokens(_drain(eng, REQS))
            st = eng.stats()
        finally:
            eng.shutdown()
        out[name] = {"paged": paged, "export": export, "disagg": disagg,
                     "stats": {k: st[k] for k in COUNTERS}}
    return out


def _parity_ranks(rank, world, trees):
    """Every rank builds each engine with ``mesh={tp world}``; rank 0
    serves and reports, the followers report the blocks their
    disaggregated engine still keeps after the shutdown."""
    from ray_tpu_torch.models.convert import params_from_numpy
    from ray_tpu_torch.parallel import MeshSpec, build_mesh
    from ray_tpu_torch.serve.disagg import DisaggPagedEngine
    from ray_tpu_torch.serve.paged_engine import PagedLLMEngine

    mesh = build_mesh(MeshSpec({"tp": world}))
    out = {}
    for name, mc in PRESETS.items():
        params = params_from_numpy(trees[name], "cpu")
        kw = dict(model_config=mc, mesh=mesh, params=params, device="cpu",
                  **TINY)
        res = out[name] = {}
        eng = PagedLLMEngine(**kw)
        if rank == 0:
            try:
                res["paged"] = _tokens(_drain(eng, REQS))
                res["split"] = eng._pool_split()
                res["export"] = _export(eng, HIT)
            finally:
                eng.shutdown()
        eng = PagedLLMEngine(**kw)
        if rank == 0:
            k, v, hashes = res["export"]
            try:
                res["imported"] = [
                    eng.import_pages(torch.from_numpy(k), torch.from_numpy(v),
                                     hashes),
                    eng.import_pages(torch.from_numpy(k), torch.from_numpy(v),
                                     hashes)]
                res["hit"] = _tokens(_drain(eng, [("hit", HIT)]))["hit"]
                res["hit_tokens"] = eng._prefix_hit_tokens
            finally:
                eng.shutdown()
            res["import_balanced"] = _pool_balanced(eng)
        eng = DisaggPagedEngine(prefill_workers=2, handoff_timeout_s=60.0,
                                **kw)
        if rank == 0:
            try:
                res["disagg"] = _tokens(_drain(eng, REQS))
                st = eng.stats()
                res["stats"] = {k: st[k] for k in COUNTERS}
            finally:
                eng.shutdown()
            res["disagg_balanced"] = _pool_balanced(eng)
        else:
            res["stash"] = len(eng._stash)
            res["slots"] = len(eng._slot_states)
    return out


def _chaos_ranks(rank, world, tree):
    """tp 2, one prefill worker: a clean run, a dropped handoff and a
    killed worker (armed on rank 0, where the handoff happens)."""
    from ray_tpu_torch.core import fault_injection
    from ray_tpu_torch.models.convert import params_from_numpy
    from ray_tpu_torch.parallel import MeshSpec, build_mesh
    from ray_tpu_torch.serve.disagg import DisaggPagedEngine

    mesh = build_mesh(MeshSpec({"tp": world}))
    kw = dict(model_config={"preset": "tiny"}, mesh=mesh, device="cpu",
              params=params_from_numpy(tree, "cpu"), prefill_workers=1,
              **TINY)
    first = [("victim", _prompts(11, (40,))[0]),
             ("bystander", _prompts(12, (40,))[0])]
    after = [("after", _prompts(14, (40,))[0])]
    out = {}
    for case, action, lease in (("clean", None, 60.0), ("drop", "drop", 0.5),
                                ("kill_worker", "kill_worker", 0.5)):
        eng = DisaggPagedEngine(handoff_timeout_s=lease, **kw)
        if rank != 0:
            out[case] = {"stash": len(eng._stash)}
            continue
        if action is not None:
            fault_injection.inject("prefill_handoff", action, "victim",
                                   times=1)
        try:
            got = _drain(eng, first)
            got.update(_drain(eng, after))
            deadline = time.time() + 30
            while (eng.stats()["prefill_workers"] < 1
                   and time.time() < deadline):
                time.sleep(0.01)
            st = eng.stats()
        finally:
            fault_injection.clear()
            eng.shutdown()
        out[case] = {"tokens": _tokens(got), "stats": st,
                     "staged": len(eng._staged),
                     "balanced": _pool_balanced(eng)}
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The 4-rank parity launch while the reference runs in a thread,
    then the 2-rank chaos launch."""
    from tests._torch_ranks import run_ranks

    d = str(tmp_path_factory.mktemp("tp_disagg"))
    trees = {"kv4": _tree(num_kv_heads=4), "kv2": _tree()}
    ref: dict = {}
    th = threading.Thread(target=lambda: ref.update(_reference()))
    th.start()
    try:
        parity = run_ranks(_parity_ranks, 4, trees, store_dir=d,
                           timeout_s=240)
        chaos = run_ranks(_chaos_ranks, 2, trees["kv2"], store_dir=d,
                          timeout_s=180)
    finally:
        th.join()
    return ref, parity, chaos


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_export_pages_matches_reference(runs, name):
    """4 KV heads: rank 0 gathers each rank's head of the pages; 2: rank
    0's replicated pool is the answer."""
    ref, parity, _ = runs
    got = parity[0][name]
    assert got["split"] == (name == "kv4")
    assert got["paged"] == ref[name]["paged"]
    k, v, hashes = got["export"]
    rk, rv, rhashes = ref[name]["export"]
    assert hashes == rhashes and len(hashes) == len(HIT) // 8
    assert k.shape == rk.shape == (2, len(hashes), PRESETS[name].get(
        "num_kv_heads", 2), 8, 16)
    np.testing.assert_allclose(k, rk, atol=2e-5, rtol=0)
    np.testing.assert_allclose(v, rv, atol=2e-5, rtol=0)


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_import_then_prefix_hit_gives_reference_tokens(runs, name):
    """Rank 0 decides and scatters (broadcasts at 2 KV heads); the same
    prompt then reuses the 8 pages and decodes the reference's tokens;
    a second import of resident hashes adopts nothing."""
    ref, parity, _ = runs
    got = parity[0][name]
    assert got["imported"] == [len(HIT) // 8, 0]
    assert got["hit_tokens"] == 8 * (len(HIT) // 8)
    assert got["hit"] == ref[name]["paged"]["r4"]
    assert got["import_balanced"]


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_disaggregated_matches_reference_mesh(runs, name):
    """Two workers whose prefills run on every rank: the reference's
    tokens and counters, no page leaked, and every follower keeps no
    block once the imports have named them."""
    ref, parity, _ = runs
    got = parity[0][name]
    assert got["disagg"] == ref[name]["disagg"]
    assert got["stats"] == ref[name]["stats"]
    assert got["stats"]["disagg_diverted"] == 3
    assert got["stats"]["disagg_imported_pages"] > 0
    assert got["disagg_balanced"]
    for follower in parity[1:]:
        assert follower[name]["stash"] == 0
        assert 1 <= follower[name]["slots"] <= 2


@pytest.mark.parametrize("case", ["drop", "kill_worker"])
def test_handoff_faults_at_tp2_lose_nothing(runs, case):
    """A dropped handoff and a killed worker: the victim recovers through
    its lease with the clean run's tokens, the killed worker is
    respawned and serves the next diversion, and neither rank 0's pool
    nor the follower's stash keeps anything."""
    _, _, chaos = runs
    clean, got = chaos[0]["clean"], chaos[0][case]
    assert clean["stats"]["disagg_recovered"] == 0
    assert got["tokens"] == clean["tokens"]
    assert set(got["tokens"]) == {"victim", "bystander", "after"}
    st = got["stats"]
    assert st["disagg_recovered"] >= 1 and st["disagg_pending"] == 0
    assert st["prefill_workers"] == 1
    assert got["balanced"] and got["staged"] == 0
    assert chaos[1][case]["stash"] == 0
    assert chaos[1]["clean"]["stash"] == 0
