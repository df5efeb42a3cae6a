"""The port's disaggregated prefill/decode engine against ``ray_tpu``'s.

On the tiny preset (fp32) and the same weights, the port's
``DisaggPagedEngine`` gives the greedy tokens of ``ray_tpu``'s
``DisaggPagedEngine`` and of the port's plain paged engine, with the
same divert, handoff and adoption counts. Handoff chaos (``drop``,
``kill_worker``, a seed sweep of drops) loses no request and leaks no
page; ``engine_class()`` follows ``RTPU_SERVE_DISAGG``. The cases port
``tests/test_serve_disagg.py``'s queue-transport tests (the
DeviceChannel transport is not ported).
"""

import os
import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from ray_tpu.models import llama as jl  # noqa: E402
from ray_tpu_torch.core import fault_injection  # noqa: E402
from ray_tpu_torch.core.config import config  # noqa: E402
from ray_tpu_torch.models.convert import params_from_numpy  # noqa: E402
from ray_tpu_torch.serve.disagg import (DisaggPagedEngine,  # noqa: E402
                                        engine_class)
from ray_tpu_torch.serve.paged_engine import PagedLLMEngine  # noqa: E402

torch.set_num_threads(1)

TINY = dict(model_config={"preset": "tiny"}, num_slots=4, max_len=96,
            prefill_buckets=[16], max_new_tokens=8, chunk_steps=4)
COUNTERS = ("disagg_diverted", "disagg_handoffs", "disagg_recovered",
            "disagg_imported_pages", "disagg_pending")


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


def _run(engine, reqs):
    try:
        out = _drain(engine, reqs)
        return out, engine.stats()
    finally:
        engine.shutdown()


def _assert_no_leaked_pages(eng):
    alloc = eng._alloc
    assert len(alloc.free) + len(alloc.lru) == alloc.num_pages


def _prompts(seed=7, lens=(3, 23, 9, 40, 70)):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(1, 250, n)] for n in lens]


@pytest.fixture(scope="module")
def params():
    """``ray_tpu``'s engine weights (PRNGKey(0)) for the port."""
    tree = jax.tree_util.tree_map(
        np.asarray, jl.init_params(jl.LlamaConfig.tiny(),
                                   jax.random.PRNGKey(0)))
    return params_from_numpy(tree, "cpu")


def _port(cls, params, **kw):
    return cls(page_size=8, params=params, device="cpu", **TINY, **kw)


def test_disagg_matches_reference_and_plain_paged(params):
    """Token-identical to ``ray_tpu``'s disaggregated engine and to the
    port's plain paged engine on a mixed batch; the 23/40/70-token
    prompts (at least the 16-token floor, a full head page) take the
    prefill plane, as in the reference."""
    from ray_tpu.serve.disagg import DisaggPagedEngine as JaxDisagg

    reqs = [(f"r{i}", p) for i, p in enumerate(_prompts())]
    ref_eng = JaxDisagg(page_size=8, prefill_workers=1, **TINY)
    want, want_st = _run(ref_eng, reqs)
    plain, _ = _run(_port(PagedLLMEngine, params), reqs)
    eng = _port(DisaggPagedEngine, params, prefill_workers=1)
    got, st = _run(eng, reqs)

    assert set(got) == set(want) == set(plain)
    assert _tokens(got) == _tokens(want)
    assert _tokens(got) == _tokens(plain)
    assert {k: st[k] for k in COUNTERS} == {k: want_st[k] for k in COUNTERS}
    assert st["disagg_diverted"] == st["disagg_handoffs"] == 3
    assert st["disagg_imported_pages"] > 0
    assert st["disagg_recovered"] == 0
    _assert_no_leaked_pages(eng)


@pytest.mark.parametrize("workers", [0, 2])
def test_worker_count_keeps_the_tokens(params, workers):
    """No workers: nothing diverts (the plain paged path); two workers
    share the queue. The tokens are the plain engine's either way."""
    reqs = [(f"w{i}", p) for i, p in enumerate(_prompts(9, (40, 70, 33,
                                                             50)))]
    plain, _ = _run(_port(PagedLLMEngine, params), reqs)
    eng = _port(DisaggPagedEngine, params, prefill_workers=workers)
    got, st = _run(eng, reqs)
    assert _tokens(got) == _tokens(plain)
    assert st["disagg_diverted"] == (4 if workers else 0)
    assert st["disagg_handoffs"] == st["disagg_diverted"]
    _assert_no_leaked_pages(eng)


def test_divert_floor_defaults_to_largest_bucket(params):
    eng = _port(DisaggPagedEngine, params, prefill_workers=1)
    try:
        assert eng._divert_min_tokens == eng._buckets[-1] == 16
    finally:
        eng.shutdown()
    eng = _port(DisaggPagedEngine, params, prefill_workers=1,
                divert_min_tokens=64)
    got, st = _run(eng, [(f"f{i}", p) for i, p in
                         enumerate(_prompts(3, (40, 70)))])
    assert len(got) == 2 and st["disagg_diverted"] == 1


def test_duplicate_request_id_is_dropped(params):
    """A replayed submit of a diverted request runs once: the port keeps
    the engines' ``_seen_ids`` check on the disaggregated submit (the
    reference's bypasses it)."""
    prompt = _prompts(5, (40,))[0]
    eng = _port(DisaggPagedEngine, params, prefill_workers=1)
    try:
        eng.submit("dup", prompt)
        got = _drain(eng, [("dup", prompt)])
        time.sleep(0.2)   # a second run would finish in this window
        got.update(eng.collect())
        st = eng.stats()
    finally:
        eng.shutdown()
    assert list(got) == ["dup"] and got["dup"]["tokens"]
    assert st["disagg_diverted"] == st["disagg_handoffs"] == 1
    _assert_no_leaked_pages(eng)


def test_dropped_handoff_recovers(params):
    """``drop`` loses the victim's KV handoff; the lease sweep resubmits
    it for local prefill. No request lost, tokens unchanged, no page
    leaked."""
    reqs = [("victim", p) for p in _prompts(11, (40,))] + \
        [("bystander", p) for p in _prompts(12, (40,))]
    clean, _ = _run(_port(DisaggPagedEngine, params, prefill_workers=1),
                    reqs)
    eng = _port(DisaggPagedEngine, params, prefill_workers=1,
                handoff_timeout_s=0.5)
    fault_injection.inject("prefill_handoff", "drop", "victim", times=1)
    try:
        got, st = _run(eng, reqs)
    finally:
        fault_injection.clear()
    assert _tokens(got) == _tokens(clean)
    assert st["disagg_recovered"] >= 1
    assert st["disagg_pending"] == 0
    _assert_no_leaked_pages(eng)


def test_worker_kill_respawns_and_recovers(params):
    """``kill_worker`` ends the worker thread mid-request with no
    handoff: the victim recovers through its lease, the health check
    respawns the worker, which serves the next diversion."""
    first = [("victim", _prompts(13, (40,))[0])]
    second = [("after", _prompts(14, (40,))[0])]
    plain, _ = _run(_port(PagedLLMEngine, params), first + second)
    eng = _port(DisaggPagedEngine, params, prefill_workers=1,
                handoff_timeout_s=0.5)
    fault_injection.inject("prefill_handoff", "kill_worker", "victim",
                           times=1)
    try:
        got = _drain(eng, first)
        assert eng.stats()["disagg_recovered"] >= 1
        got.update(_drain(eng, second))
        st = eng.stats()
    finally:
        fault_injection.clear()
        eng.shutdown()
    assert _tokens(got) == _tokens(plain)
    assert st["prefill_workers"] == 1   # the dead thread was replaced
    assert st["disagg_handoffs"] >= 1
    _assert_no_leaked_pages(eng)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_handoff_chaos_seed_sweep(params, seed):
    """Per seed, a random half of the diverted requests loses its
    handoff: every request completes and the pool balances."""
    rng = np.random.default_rng(seed)
    reqs = [(f"s{seed}-r{i}", [int(t) for t in rng.integers(1, 250, 40)])
            for i in range(4)]
    victims = [reqs[i][0] for i in rng.choice(4, size=2, replace=False)]
    eng = _port(DisaggPagedEngine, params, prefill_workers=1,
                handoff_timeout_s=0.3)
    for rid in victims:
        fault_injection.inject("prefill_handoff", "drop", rid, times=1)
    try:
        got, st = _run(eng, reqs)
    finally:
        fault_injection.clear()
    assert set(got) == {rid for rid, _ in reqs}
    assert all(got[rid]["tokens"] for rid, _ in reqs)
    assert st["disagg_recovered"] >= len(victims)
    assert st["disagg_pending"] == 0
    _assert_no_leaked_pages(eng)


def test_engine_class_resolves_serve_disagg_flag():
    assert engine_class() is PagedLLMEngine   # default off
    os.environ["RTPU_SERVE_DISAGG"] = "1"
    try:
        config.reload()
        assert engine_class() is DisaggPagedEngine
    finally:
        del os.environ["RTPU_SERVE_DISAGG"]
        config.reload()
    assert engine_class() is PagedLLMEngine


def test_prefill_workers_flag_sets_the_default(params):
    config.reload({"RTPU_SERVE_PREFILL_WORKERS": "2"})
    try:
        eng = _port(DisaggPagedEngine, params)
        try:
            deadline = time.time() + 10
            while (eng.stats()["prefill_workers"] < 2
                   and time.time() < deadline):
                time.sleep(0.01)
            assert eng.stats()["prefill_workers"] == 2
        finally:
            eng.shutdown()
    finally:
        config.reload()


@pytest.mark.parametrize("raw,action,times,target", [
    ("drop", "drop", 1, "*"),
    ("kill_worker:3", "kill_worker", 3, "*"),
    ("drop:-1:req-7", "drop", -1, "req-7"),
])
def test_fault_env_spec(raw, action, times, target):
    """``RTPU_FAULT_PREFILL_HANDOFF=<action>[:<times>[:<match>]]`` arms
    the site as the reference's env surface does."""
    try:
        assert fault_injection.load_env(
            {"RTPU_FAULT_PREFILL_HANDOFF": raw}) == 1
        if target != "*":
            assert fault_injection.fire("prefill_handoff", "other") is None
        key = "any-request" if target == "*" else target + "-x"
        fired = [fault_injection.fire("prefill_handoff", key)
                 for _ in range(4)]
        n = 4 if times == -1 else times
        assert fired == [action] * n + [None] * (4 - n)
    finally:
        fault_injection.load_env({})
        fault_injection.clear()
    assert not fault_injection.enabled()
    with pytest.raises(ValueError):
        fault_injection.inject("no_such_site", "evict")
