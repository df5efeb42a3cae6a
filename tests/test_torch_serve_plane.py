"""The port's serving plane under overload, affinity and replica loss,
against ``ray_tpu``'s.

The programs of ``tests/test_serve_overload.py``,
``test_serve_affinity.py`` and ``test_serve_replay.py`` run through
``ray_tpu`` (the reference) and ``ray_tpu_torch``; the outcomes must be
equal: values, or typed errors compared by type name and fields. Unit
programs (QoS, affinity scoring, the ledger, replica health,
``Router._pick`` on hand-built state, the controller's report
aggregation) run one package after the other; the programs on a live
runtime run both packages at once, in two threads (the runtimes are
independent; flags are set for both around the call).

Left out: ``serve_demand_signal`` (``autoscaler_v2``, not ported). The
SIGKILL chaos drill runs here without its RTPU_NETEM delay, whose
node-to-node edges do not exist on one node; with the delay it runs on
two nodes in ``tests/test_torch_cluster_chaos.py``.
The engine programs share one two-replica engine deployment a package
(tiny, fp32; the port's on the reference's weights): a replica
SIGKILLed under flag-off traffic, stream resumes spliced at the
watermark with affinity off and on, and a real SIGKILL of the replica
serving a stream, which the router resumes on the other replica.
"""

from __future__ import annotations

import contextlib
import json
import os
import pickle
import random
import signal
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np
import pytest

import ray_tpu
import ray_tpu_torch

torch = pytest.importorskip("torch")

PS = 8  # page size of the affinity programs


def _ns(pkg):
    import importlib

    name = pkg.__name__
    mods = {k: importlib.import_module(f"{name}.{m}") for k, m in (
        ("serve", "serve"), ("ctx", "core.runtime_context"),
        ("fi", "core.fault_injection"), ("cfg", "core.config"),
        ("exc", "exceptions"), ("qos", "serve.qos"),
        ("retry", "serve.retry"), ("affinity", "serve.affinity"),
        ("router", "serve.router"), ("controller", "serve.controller"),
        ("http_proxy", "serve.http_proxy"),
        ("paged", "serve.paged_engine"), ("llm_engine", "serve.llm_engine"))}
    return SimpleNamespace(rt=pkg, port=pkg is ray_tpu_torch,
                           config=mods.pop("cfg").config, **mods)


REF, PORT = _ns(ray_tpu), _ns(ray_tpu_torch)


def _outcome(program, p, *args):
    try:
        return program(p, *args)
    except Exception as e:  # noqa: BLE001 — compared by type name
        return ("raised", type(e).__name__, str(e))


def assert_same(program, *args, live: bool = False):
    """Both packages' outcomes of ``program``, which must be equal; a
    ``live`` program runs both at once."""
    if live:
        with ThreadPoolExecutor(2) as pool:
            futs = [pool.submit(_outcome, program, p, *args)
                    for p in (REF, PORT)]
            out = [f.result() for f in futs]
    else:
        out = [_outcome(program, p, *args) for p in (REF, PORT)]
    assert out[1] == out[0], out
    return out[0]


@contextlib.contextmanager
def flags(**env):
    """``RTPU_<NAME>`` variables set for both packages' flag tables."""
    for k, v in env.items():
        os.environ[f"RTPU_{k.upper()}"] = str(v)
    for p in (REF, PORT):
        p.config.reload()
    try:
        yield
    finally:
        for k in env:
            os.environ.pop(f"RTPU_{k.upper()}", None)
        for p in (REF, PORT):
            p.fi.clear()
            p.config.reload()


@pytest.fixture(scope="module")
def pkgs():
    """Both runtimes (4 workers each), with the reference's tiny-preset
    weights (PRNGKey(0)) as numpy for the port's engine replicas."""
    import jax

    from ray_tpu.models import llama

    params = llama.init_params(llama.LlamaConfig.tiny(),
                               jax.random.PRNGKey(0))
    PORT.params = jax.tree_util.tree_map(np.asarray, params)
    started = []
    try:
        for p in (REF, PORT):
            prev = p.ctx.get_core_or_none()
            p.ctx.set_core(None)
            p.rt.init(num_workers=4, object_store_memory=128 << 20)
            started.append((p, prev))
        yield
    finally:
        for p, prev in reversed(started):
            p.serve.shutdown()
            core = p.ctx.get_core_or_none()
            if core is not None:
                core.shutdown()
            p.ctx.set_core(prev)


def _post(port, path, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=60)


def _typed(e):
    """A typed serve error as its type name and public fields."""
    return (type(e).__name__,
            {k: v for k, v in vars(e).items() if not k.startswith("_")
             and not isinstance(v, BaseException)})


# ------------------------------------------------------- unit programs


def p_typed_errors_pickle(p):
    e = p.exc.BackpressureError("shed it", deployment="dep", queue_depth=7,
                                estimated_wait_s=1.25, retry_after_s=2.5)
    e2 = pickle.loads(pickle.dumps(e))
    u = p.exc.ReplicaUnavailableError(deployment="gone")
    u2 = pickle.loads(pickle.dumps(u))
    cause = p.exc.ActorDiedError("replica gone", cause="oom")
    r = p.exc.ReplicaUnavailableError(deployment="d", attempts=3,
                                      last_cause=cause)
    r2 = pickle.loads(pickle.dumps(r))
    return (_typed(e2), str(e2) == str(e),
            str(pickle.loads(pickle.dumps(e2))) == str(e),
            isinstance(e2, p.exc.RayTpuError), _typed(u2), str(u2),
            _typed(r2), type(r2.last_cause).__name__, str(r2) == str(r))


def p_qos_units(p):
    qos = p.qos
    norm = [qos.normalize_priority(x)
            for x in (None, "low", "HIGH", 0, 99, -3)]
    try:
        qos.normalize_priority("urgent")
        bad = None
    except ValueError:
        bad = "ValueError"
    depth = [qos.depth_limit(*a) for a in ((9, 0), (9, 1), (9, 2), (1, 0),
                                           (0, 0))]
    est = qos.TtftEstimator(alpha=0.5)
    seen = [est.estimated_wait_s(10, 2)]
    est.observe("r1", 1.0)
    est.observe("r2", 3.0)
    seen += [est.mean_ttft_s(), est.estimated_wait_s(2, 2)]
    est.drop_replica("r2")
    seen += [est.mean_ttft_s(), sorted(est.drain_samples()),
             est.drain_samples(), qos.retry_after_hint(0.0, 0.0),
             qos.retry_after_hint(1.0, 4.0)]
    t = qos.TtftEstimator(0.5)
    t.observe("r1", 0.1)
    t.observe("r1", 0.2)
    t.observe("r2", 0.05)
    snap = t.snapshot()
    t.drop_replica("r1")
    seen += [snap, "r1" in t.snapshot()]
    return norm, bad, depth, seen


def p_qos_from_config(p):
    out = [p.qos.qos_from_config({"priority": "high", "max_queue_depth": 5,
                                  "deadline_s": 2.0})]
    for bad in ({"deadline_s": 0}, {"max_queue_depth": -1}):
        try:
            p.qos.qos_from_config(bad)
            out.append(None)
        except ValueError:
            out.append("ValueError")
    os.environ["RTPU_SERVE_MAX_QUEUE_DEPTH"] = "4"
    try:
        p.config.reload()
        out.append(p.qos.qos_from_config({})["max_queue_depth"])
    finally:
        del os.environ["RTPU_SERVE_MAX_QUEUE_DEPTH"]
        p.config.reload()
    out.append(p.qos.qos_from_config({})["max_queue_depth"])
    return out


def p_deployment_qos_validation(p):
    serve = p.serve
    out = []
    for kw in ({"priority": "urgent"}, {"deadline_s": -1.0}):
        try:
            serve.deployment(**kw)(lambda x: x)
            out.append(None)
        except ValueError:
            out.append("ValueError")
    d = serve.deployment(priority="low", max_queue_depth=3)(lambda x: x)
    out.append(d.config["priority"])
    try:
        d.options(max_queue_depth=-2)
        out.append(None)
    except ValueError:
        out.append("ValueError")
    return out


def _digest(p, tokens, ts=None):
    return p.affinity.ResidencyDigest(
        PS, p.affinity.chain_hashes(tokens, PS), ts=ts)


def p_affinity_scoring(p):
    aff = p.affinity
    toks = list(range(100, 100 + 4 * PS))
    alloc = p.paged._PageAllocator(num_pages=16, page_size=PS)
    _, alloc_hashes, _ = alloc.match_prefix(toks, len(toks))
    out = [aff.chain_hashes(toks, PS) == alloc_hashes,
           aff.chain_hashes([1] + toks[1:], PS)[-1] != alloc_hashes[-1]]
    toks = list(range(5 * PS + 3))
    hashes = aff.chain_hashes(toks, PS)
    out += [aff.matched_prefix_tokens(toks, _digest(p, toks)),
            aff.matched_prefix_tokens(toks, _digest(p, toks[: 2 * PS])),
            aff.matched_prefix_tokens(toks, aff.ResidencyDigest(
                PS, [hashes[0]] + hashes[2:])),
            aff.matched_prefix_tokens(toks, aff.ResidencyDigest(PS, []))]
    toks = list(range(4 * PS))
    reps = [("r1", None), ("r2", None), ("r3", None)]
    dg = _digest(p, toks)
    kw = dict(min_prefix_tokens=16, load_penalty=64.0)
    now = time.monotonic()
    out += [aff.score_replicas(toks, reps, {"r2": dg}, {}, **kw),
            aff.score_replicas(toks, reps, {"r1": dg, "r2": dg},
                               {"r1": 3, "r2": 0}, **kw),
            aff.score_replicas(toks, reps, {"r1": dg, "r2": dg}, {}, **kw),
            aff.score_replicas(toks[:PS], reps[:2],
                               {"r2": _digest(p, toks[:PS])}, {}, **kw),
            aff.score_replicas(toks, reps[:2],
                               {"r2": _digest(p, toks, now - 10.0)}, {},
                               now=now, **kw),
            aff.score_replicas(toks, reps[:2], {"r2": dg}, {"r2": 50},
                               **kw),
            aff.score_replicas(None, reps[:2], {"r2": dg}, {}, **kw)]
    ok = aff.ResidencyDigest.from_report({"page_size": PS,
                                          "hashes": [1, 2]})
    out.append(sorted(ok.hashes))
    out += [aff.ResidencyDigest.from_report(bad) is None
            for bad in (None, 42, [], {"hashes": [1]}, {"page_size": "x"})]
    return out


def _bare_router(p, replica_ids, inflight=None):
    """A Router with hand-built state (no control plane)."""
    r = p.router.Router.__new__(p.router.Router)
    r._lock = threading.Lock()
    r._name = "aff-test"
    r._replicas = [(rid, f"handle-{rid}") for rid in replica_ids]
    r._inflight = dict(inflight or {rid: 0 for rid in replica_ids})
    r._mux_affinity = {}
    r._residency = {}
    r._session_affinity = {}
    r._ttft = p.qos.TtftEstimator(0.5)
    r._ledger = p.retry.RequestLedger()
    r._health = p.retry.ReplicaHealth()
    r._refresh = lambda force=False: None  # no controller
    return r


def p_pick_with_affinity(p):
    toks = list(range(4 * PS))
    out = []
    r = _bare_router(p, ["r1", "r2", "r3"])
    r._residency["r2"] = _digest(p, toks)
    for seed in range(10):
        random.seed(seed)
        out.append(r._pick(prompt_tokens=toks)[0])
    r = _bare_router(p, ["r1", "r2"], inflight={"r1": 0, "r2": 50})
    r._residency["r2"] = _digest(p, toks)
    random.seed(0)
    out.append(r._pick(prompt_tokens=toks)[0])
    r = _bare_router(p, ["r1", "r2"], inflight={"r1": 0, "r2": 1})
    r._residency["r2"] = _digest(p, toks, ts=time.monotonic() - 10.0)
    random.seed(1)
    out.append(sorted({r._pick(prompt_tokens=toks)[0] for _ in range(20)}))
    r = _bare_router(p, ["r1", "r2", "r3"])
    r._residency["r2"] = _digest(p, toks)
    out += [r._pick(prompt_tokens=toks, session_id="s1")[0],
            r._pick(session_id="s1")[0]]
    r._drop_replica("r2")
    out += ["r2" in r._residency, "s1" in r._session_affinity]
    random.seed(3)
    nxt = r._pick(prompt_tokens=toks, session_id="s1")[0]
    out += [nxt, r._session_affinity["s1"] == nxt]
    r = _bare_router(p, ["r1", "r2"], inflight={"r1": 0, "r2": 10})
    r._session_affinity["s1"] = "r2"
    random.seed(2)
    out.append(r._pick(session_id="s1")[0])
    return out


def p_pick_flag_off_is_seed_pow2(p):
    toks = list(range(4 * PS))
    r = _bare_router(p, ["r1", "r2", "r3"],
                     inflight={"r1": 5, "r2": 0, "r3": 2})
    r._residency["r1"] = _digest(p, toks)
    random.seed(1234)
    got = [r._pick(prompt_tokens=toks, session_id="s")[0]
           for _ in range(50)]
    return p.config.serve_cache_affinity, got, r._session_affinity


def p_controller_reports(p):
    c = p.controller.ServeController()
    try:
        c.deploy("d", b"", {"num_replicas": 0})
        c.report_load("d", "legacy", 2)
        c.report_load("d", "qos", 1, 7, [12.0, 40.0])
        c.report_load("d", "aff", 1, 0, None,
                      {"replicas": {"rep-0": 3}, "cached_chains": 3})
        st = c.status()["d"]
        out = [st["queue_depth"], st["ttft_p99_ms"],
               st["cached_prefix_chains"],
               c.demand_snapshot()["d"]["cached_prefix_chains"]]
        c.deploy("e", b"", {"num_replicas": 0})
        c.report_load("e", "router-a", 0, None, None,
                      {"replicas": {"rep-0": 5, "rep-1": 2}})
        c.report_load("e", "router-b", 0, None, None,
                      {"replicas": {"rep-0": 4, "rep-2": 7}})
        out.append(c.status()["e"]["cached_prefix_chains"])
        with c._lock:
            info = c._deployments["e"]
            summary, _ = info.residency["router-b"]
            info.residency["router-b"] = (summary, time.monotonic() - 4.0)
        out += [c.demand_snapshot()["e"]["cached_prefix_chains"],
                "router-b" in c._deployments["e"].residency]
        return out
    finally:
        c.shutdown()


def p_retry_units(p):
    led = p.retry.RequestLedger()
    n1, n2 = led.open(), led.open()
    led.note_attempt(n1, "r1")
    led.note_attempt(n1, "r2")
    led.note_attempt(n2, "r1")
    out = [n1 != n2, led.stats()]
    led.close(n1)
    led.close(n1)
    out.append(led.stats()["open"])
    H = p.retry.ReplicaHealth
    h = H()
    out.append([h.note_failure("r1") for _ in range(H.STREAK_LIMIT - 1)])
    h.note_ok("r1")
    out.append([h.note_failure("r1") for _ in range(H.STREAK_LIMIT)])
    out += [h.is_ejected("r1"), h.ejected_ids(),
            h.filter([("r1", 0), ("r2", 0)]), h.filter([("r1", 0)]),
            h.is_ejected("r1", now=time.monotonic() + H.COOLDOWN_S + 1)]
    snap = {"slow": (0.5, 10), "f1": (0.01, 10), "f2": (0.012, 10)}
    h = H()
    out += [h.note_ttft("slow", snap, ratio=3.0), h.is_ejected("slow"),
            H().note_ttft("slow", {"slow": (0.5, 2), "f1": (0.01, 10)}, 3.0),
            H().note_ttft("slow", {"slow": (0.5, 10), "f1": (0.01, 1)}, 3.0),
            H().note_ttft("a", {"a": (0.004, 10), "b": (0.001, 10)}, 3.0)]
    R = p.router.Router
    out += [R._resume_call(([0, 1, 2, 3], 10), {}, [7, 8, 9]),
            R._resume_call((), {"prompt_tokens": [1], "max_new_tokens": 4},
                           [5, 6]),
            R._resume_call(([1], 3), {}, [4, 5, 6]),
            R._resume_call(([1, 2], 5), {}, [])]
    return out


# -------------------------------------------------- overload programs


def p_depth_shedding_by_priority_class(p):
    @p.serve.deployment(name="gated", max_queue_depth=6)
    def gated(dt):
        time.sleep(dt)
        return dt

    handle = p.serve.run(gated)
    router = handle._get_router()
    futs = [handle.options(priority="high").remote(0.8) for _ in range(6)]
    out = [router._depth]
    for prio in ("low", "normal", "high"):
        try:
            handle.options(priority=prio).remote(0.0)
            out.append(None)
        except p.exc.BackpressureError as e:
            out.append((type(e).__name__, e.deployment, e.queue_depth,
                        e.retry_after_s >= 0.1))
    out.append([f.result(timeout=60) for f in futs])
    deadline = time.monotonic() + 5
    while router._depth and time.monotonic() < deadline:
        time.sleep(0.02)
    out += [router._depth,
            handle.options(priority="low").remote(0.0).result(timeout=30)]
    return out


def p_deadline_admission_and_replica_shed(p):
    serve = p.serve

    @serve.deployment(name="slowest", deadline_s=30.0)
    def slowest(x):
        return x

    handle = serve.run(slowest)
    handle._get_router()._ttft.observe("seed", 5.0)
    out = []
    try:
        handle.options(deadline_s=0.5).remote(1)
    except p.exc.BackpressureError as e:
        out += ["estimated wait" in str(e), e.estimated_wait_s > 0.5]
    out.append(handle.options(deadline_s=60.0).remote(7).result(timeout=30))

    @serve.deployment(name="queuey")
    def queuey(dt):
        time.sleep(dt)
        return dt

    handle = serve.run(queuey)
    blocker = handle.remote(0.6)
    time.sleep(0.2)
    late = handle.options(deadline_s=0.1).remote(0.0)
    try:
        late.result(timeout=30)
    except p.exc.BackpressureError as e:
        out.append(("BackpressureError",
                    "deadline expired before execution" in str(e)))
    out += [blocker.result(timeout=30),
            handle.remote(0.05).result(timeout=30)]
    return out


def p_qos_off_admission_is_noop(p):
    @p.serve.deployment(name="plain")
    def plain(x):
        return x * 3

    handle = p.serve.run(plain)
    router = handle._get_router()
    out = [router._qos["max_queue_depth"], router._qos["deadline_s"],
           router._report_enabled]
    futs = [handle.remote(i) for i in range(8)]
    out += [[f.result(timeout=30) for f in futs], router._depth,
            router._report_thread]
    return out


def p_http_proxy_429_and_503(p):
    @p.serve.deployment(name="qecho", max_queue_depth=4)
    def qecho(x):
        return x

    p.serve.run(qecho)
    proxy = p.http_proxy.start_http()
    port = proxy.address[1]
    out = []
    try:
        p.fi.inject("serve_overload", "shed", "qecho", times=1)
        try:
            _post(port, "qecho", {"args": [1]})
        except urllib.error.HTTPError as e:
            body = json.loads(e.read())
            out += [e.code, int(e.headers["Retry-After"]) >= 1,
                    body["type"], body["deployment"],
                    body["retry_after_s"] >= 0.1]
        out.append(json.loads(_post(port, "qecho", {"args": [1]}).read()))
        try:
            _post(port, "never_deployed", {"args": []})
        except urllib.error.HTTPError as e:
            body = json.loads(e.read())
            out += [e.code, body["type"], body["deployment"]]
    finally:
        p.fi.clear()
        p.http_proxy.stop_http()
    return out


def p_stream_mid_flight_shed(p):
    @p.serve.deployment(name="ticker")
    def ticker(n):
        for i in range(n):
            time.sleep(0.1)
            yield i

    handle = p.serve.run(ticker)
    proxy = p.http_proxy.start_http()
    try:
        with _post(proxy.address[1], "ticker",
                   {"args": [50], "stream": True,
                    "deadline_s": 0.45}) as resp:
            status = resp.status
            events = []
            for raw in resp:
                line = raw.decode().strip()
                if line.startswith("data: "):
                    events.append(line[len("data: "):])
    finally:
        p.http_proxy.stop_http()
    last = json.loads(events[-1])
    router = handle._get_router()
    deadline = time.monotonic() + 5
    while router._depth and time.monotonic() < deadline:
        time.sleep(0.02)
    return (status, events[-1] != "[DONE]", last["type"],
            "deadline" in last["error"], last["retry_after_s"] >= 0.1,
            any("tokens" in json.loads(e) for e in events[:-1]),
            router._depth, list(handle.stream(3)))


def p_controller_publishes_serve_demand(p):
    @p.serve.deployment(name="demandy", max_queue_depth=16)
    def demandy(x):
        time.sleep(0.05)
        return x

    handle = p.serve.run(demandy)
    [f.result(timeout=30) for f in [handle.remote(i) for i in range(10)]]
    core = p.ctx.get_core_or_none()
    payload = None
    deadline = time.monotonic() + 15
    while time.monotonic() < deadline:
        payload = core.kv_op("get", p.controller.SERVE_DEMAND_KEY)
        if (isinstance(payload, dict)
                and "demandy" in payload.get("deployments", {})
                and payload["deployments"]["demandy"]["ttft_p99_ms"] > 0):
            break
        time.sleep(0.2)
    dep = payload["deployments"]["demandy"]
    st = p.serve.status()["demandy"]
    controller = p.rt.get_actor(p.controller.CONTROLLER_NAME)
    legacy = p.rt.get(controller.report_load.remote("demandy", "legacy-r",
                                                    2), timeout=30)
    return (dep["ttft_p99_ms"] >= dep["ttft_p50_ms"] > 0,
            dep["queue_depth"] >= 0,
            abs(payload["ts"] - time.time()) < 30,
            "queue_depth" in st and "ttft_p99_ms" in st, legacy)


def p_chaos_sustained_mixed_overload(p):
    @p.serve.deployment(name="mixed", num_replicas=2, max_queue_depth=8)
    def mixed(dt):
        time.sleep(dt)
        return dt

    handle = p.serve.run(mixed)
    p.fi.inject("serve_overload", "shed", "mixed", times=5)
    try:
        def service_time(i):
            return 0.6 if i % 13 == 0 else 0.25 if i % 5 == 0 else 0.03

        results = {"low": [], "normal": [], "high": []}
        sheds = {"low": 0, "normal": 0, "high": 0}
        typed = []
        lock = threading.Lock()
        inflight = []
        for i in range(50):
            for prio in ("low", "normal", "high"):
                t_submit = time.monotonic()
                try:
                    fut = handle.options(priority=prio).remote(
                        service_time(i))
                except p.exc.BackpressureError as e:
                    typed.append(e.deployment == "mixed"
                                 and e.retry_after_s >= 0.1)
                    with lock:
                        sheds[prio] += 1
                    continue

                def reap(fut=fut, prio=prio, t0=t_submit):
                    try:
                        fut.result(timeout=90)
                        with lock:
                            results[prio].append(time.monotonic() - t0)
                    except p.exc.BackpressureError:
                        with lock:
                            sheds[prio] += 1

                t = threading.Thread(target=reap, daemon=True)
                t.start()
                inflight.append(t)
            time.sleep(0.02)
        for t in inflight:
            t.join(timeout=120)
        router = handle._get_router()
        deadline = time.monotonic() + 10
        while router._depth and time.monotonic() < deadline:
            time.sleep(0.05)
        return (not any(t.is_alive() for t in inflight), all(typed),
                sum(sheds.values()) > 0,
                sum(len(v) for v in results.values()) > 0,
                sheds["low"] >= sheds["high"], bool(results["high"]),
                p.qos.percentile(results["high"], 99) < 15.0,
                p.serve.status()["mixed"]["running"],
                handle.options(priority="low").remote(0.01).result(
                    timeout=30),
                router._depth)
    finally:
        p.fi.clear()


# ---------------------------------------------------- replay programs


def p_replay_unary(p):
    """Lost request (``die``), lost reply (``die_after``, exactly once
    through the nonce memo) and a batch replayed member by member."""
    serve = p.serve
    out = []

    @serve.deployment(name="lostreq", num_replicas=1)
    def double(x):
        return x * 2

    handle = serve.run(double)
    out.append(handle.remote(1).result(timeout=30))
    p.fi.inject("serve_replica_kill", "die", "lostreq", times=1)
    out.append(handle.remote(5).result(timeout=30))

    @serve.deployment(name="once", num_replicas=1)
    class Once:
        def __init__(self):
            self.calls = 0

        def __call__(self, x):
            self.calls += 1
            return x * 2

        def count(self):
            return self.calls

    handle = serve.run(Once.bind())
    out.append(handle.remote(1).result(timeout=30))
    p.fi.inject("serve_replica_kill", "die_after", "once", times=1)
    out.append(handle.remote(21).result(timeout=30))
    p.fi.clear()
    out.append(handle.count.remote().result(timeout=30))

    @serve.deployment(name="bdedup", max_batch_size=4,
                      batch_wait_timeout_s=0.05, num_replicas=1)
    class BatchCounter:
        def __init__(self):
            self.seen = []

        def __call__(self, items):
            self.seen.extend(items)
            return [i + 100 for i in items]

        def seen_items(self):
            return list(self.seen)

    handle = serve.run(BatchCounter.bind())
    out.append(handle.remote(0).result(timeout=30))
    p.fi.inject("serve_replica_kill", "die_after", "bdedup", times=1)
    futs = [handle.remote(i) for i in range(1, 5)]
    out.append([f.result(timeout=60) for f in futs])
    p.fi.clear()
    out.append(sorted(handle.seen_items.remote().result(timeout=30)))
    return out


def p_replay_budget_exhausted(p):
    @p.serve.deployment(name="exh", num_replicas=1)
    def f(x):
        return x

    handle = p.serve.run(f)
    out = [handle.remote(0).result(timeout=30)]
    p.fi.inject("serve_replica_kill", "die", "exh", times=-1)
    try:
        handle.remote(1).result(timeout=60)
    except p.exc.ReplicaUnavailableError as e:
        out += [type(e).__name__, e.attempts,
                type(e.last_cause).__name__, "2 attempt" in str(e)]
    finally:
        p.fi.clear()
    return out


def p_chaos_sigkill_rounds(p, affinity: bool):
    name = f"chaos{int(affinity)}"

    @p.serve.deployment(name=name, num_replicas=2)
    class Victim:
        def __init__(self):
            self.seen = []

        def __call__(self, x):
            self.seen.append(x)
            return x * 2 + 1

        def pid(self):
            return os.getpid()

        def dupes(self):
            return sorted(x for x in set(self.seen)
                          if self.seen.count(x) > 1)

    handle = p.serve.run(Victim.bind())
    killed = set()
    base = 0
    out = []
    for _ in range(2):
        pids = set()
        deadline = time.monotonic() + 60
        while len(pids) < 2 and time.monotonic() < deadline:
            pids.add(handle.pid.remote().result(timeout=30))
        out.append(len(pids))
        victim = sorted(pids - killed)[0]
        futs = [handle.remote(base + i) for i in range(10)]
        os.kill(victim, signal.SIGKILL)
        killed.add(victim)
        out.append([f.result(timeout=60) for f in futs])
        base += 10
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            if p.serve.status()[name]["running"] >= 2:
                break
            time.sleep(0.3)
    out.append([handle.dupes.remote().result(timeout=30)
                for _ in range(8)])
    p.serve.delete(name)
    return out


def p_gray_replica_ejected_and_replaced(p):
    @p.serve.deployment(name="gray", num_replicas=2)
    class SlowOnDemand:
        def __init__(self):
            self.slow = False

        def __call__(self, x):
            if self.slow:
                time.sleep(0.3)
            return os.getpid()

        def make_slow(self):
            self.slow = True
            return os.getpid()

    handle = p.serve.run(SlowOnDemand.bind())
    pids = set()
    deadline = time.monotonic() + 60
    while len(pids) < 2 and time.monotonic() < deadline:
        pids.add(handle.remote(0).result(timeout=30))
    slow_pid = handle.make_slow.remote().result(timeout=30)
    served = []
    for i in range(60):
        t0 = time.monotonic()
        served.append(handle.remote(i).result(timeout=30))
        if (len(served) >= 10
                and set(served[-10:]) == (pids - {slow_pid})
                and time.monotonic() - t0 < 0.2):
            break
    ejected = set(served[-5:]) == pids - {slow_pid}
    deadline = time.monotonic() + 45
    replaced = False
    while time.monotonic() < deadline:
        now_pids = {handle.remote(0).result(timeout=30) for _ in range(6)}
        if slow_pid not in now_pids and len(now_pids) == 2:
            replaced = True
            break
        time.sleep(0.5)
    p.serve.delete("gray")
    return len(pids), ejected, replaced


def _engine_deployment(p):
    """Two replicas of the tiny engine (fp32, one token a chunk): the
    reference's class, or the port's on the CPU with the reference's
    weights (made here, so pickled by value into the replicas)."""
    base = p.llm_engine.LLMEngine
    if p.port:
        class Engine(base):
            def __init__(self, params, **kw):
                from ray_tpu_torch.models.convert import params_from_numpy

                super().__init__(params=params_from_numpy(params, "cpu"),
                                 device="cpu", **kw)

            def pid(self):
                return os.getpid()
        extra = {"params": p.params}
    else:
        class Engine(base):
            def pid(self):
                return os.getpid()
        extra = {}
    dep = p.serve.deployment(name="llmres", engine=True, num_cpus=0.1,
                             num_replicas=2)(Engine).bind(
        model_config={"preset": "tiny"}, num_slots=4, max_len=64,
        prefill_buckets=[16], max_new_tokens=12, chunk_steps=1, **extra)
    return p.serve.run(dep, timeout=300)


def _pids(handle, n=2, timeout_s=120):
    pids = set()
    deadline = time.monotonic() + timeout_s
    while len(pids) < n and time.monotonic() < deadline:
        pids.add(handle.pid.remote().result(timeout=60))
    return pids


def p_engine_poll_replica_death(p):
    """Flag off: a SIGKILLed engine replica's in-flight requests are
    redispatched to the healthy one, not failed."""
    handle = _engine_deployment(p)
    pids = _pids(handle)
    futs = [handle.remote([5, 11, 2, i], 8) for i in range(6)]
    time.sleep(0.5)
    victim = sorted(pids)[0]
    os.kill(victim, signal.SIGKILL)
    tokens = [f.result(timeout=180)["tokens"] for f in futs]
    # two live replicas again (the controller has dropped the corpse and
    # started another) before the next program: ``ray_tpu``'s router
    # would retry a corpse its controller still lists
    after = _pids(handle)
    return len(pids), tokens, len(after) == 2 and victim not in after


def p_stream_resume_exact_splice(p):
    """Replay on: an injected mid-stream replica loss (``stream_resume``)
    splices at the watermark."""
    handle = p.serve.get_deployment_handle("llmres")
    prompt = [5, 11, 2]
    reference = handle.remote(prompt).result(timeout=300)["tokens"]
    p.fi.inject("stream_resume", "drop", "llmres", times=1)
    chunks = list(handle.stream(prompt, 12))
    p.fi.clear()
    return reference, [t for c in chunks for t in c] == reference


def p_stream_survives_sigkill(p):
    """Replay on: the replica serving a stream is SIGKILLed after its
    first chunk; the router resumes on the other replica, and the spliced
    tokens equal an unkilled run's."""
    handle = p.serve.get_deployment_handle("llmres")
    _pids(handle)
    prompt = [9, 4, 1, 7]
    unkilled = handle.remote(prompt).result(timeout=300)["tokens"]
    router = handle._get_router()
    gen = handle.stream(prompt, 12)
    got = list(next(gen))
    with router._lock:
        busy = [rid for rid, n in router._inflight.items() if n > 0]
        handles = dict(router._replicas)
    pid = p.rt.get(handles[busy[0]].call_method.remote("pid", (), {}),
                   timeout=30)
    os.kill(pid, signal.SIGKILL)
    for chunk in gen:
        got += chunk
    return len(busy), got == unkilled, len(got)


# --------------------------------------------------------------- tests


@pytest.mark.parametrize("program", [
    p_typed_errors_pickle, p_qos_units, p_qos_from_config,
    p_deployment_qos_validation, p_affinity_scoring, p_retry_units,
    p_controller_reports,
], ids=lambda f: f.__name__[2:])
def test_unit_program_matches_reference(program):
    assert_same(program)


def test_pick_with_affinity_matches_reference():
    with flags(serve_cache_affinity=1):
        out = assert_same(p_pick_with_affinity)
    assert out[:10] == ["r2"] * 10 and out[10:12] == ["r1", ["r1"]]


def test_pick_flag_off_is_seed_pow2():
    """Affinity off: the same RNG draws and choices in both packages."""
    flag, got, sessions = assert_same(p_pick_flag_off_is_seed_pow2)
    assert flag is False and sessions == {}
    random.seed(1234)
    reps = ["r1", "r2", "r3"]
    load = {"r1": 5, "r2": 0, "r3": 2}
    want = []
    for _ in range(50):
        a, b = random.sample(reps, 2)
        want.append(a if load[a] <= load[b] else b)
    assert got == want


@pytest.mark.parametrize("program", [
    p_depth_shedding_by_priority_class,
    p_deadline_admission_and_replica_shed, p_qos_off_admission_is_noop,
    p_stream_mid_flight_shed, p_controller_publishes_serve_demand,
    p_chaos_sustained_mixed_overload,
], ids=lambda f: f.__name__[2:])
def test_overload_program_matches_reference(pkgs, program):
    assert_same(program, live=True)


def test_http_proxy_maps_typed_errors(pkgs):
    """429 with Retry-After for a shed, 503 for a deployment with no
    replicas, typed bodies."""
    with flags(serve_replica_wait_s=0.5):
        out = assert_same(p_http_proxy_429_and_503, live=True)
    assert out[:5] == [429, True, "BackpressureError", "qecho", True]
    assert out[5:] == [{"result": 1}, 503, "ReplicaUnavailableError",
                       "never_deployed"]


def test_replay_unary_and_batch(pkgs):
    with flags(serve_request_replay=1):
        out = assert_same(p_replay_unary, live=True)
    assert out == [2, 10, 2, 42, 2, 100, [101, 102, 103, 104],
                   [0, 1, 2, 3, 4]]


def test_replay_budget_exhausted_is_typed(pkgs):
    with flags(serve_request_replay=1, serve_replay_max_attempts=2):
        out = assert_same(p_replay_budget_exhausted, live=True)
    assert out == [0, "ReplicaUnavailableError", 2, "ActorDiedError", True]


@pytest.mark.parametrize("affinity", [False, True],
                         ids=["affinity_off", "affinity_on"])
def test_chaos_sigkill_rounds_zero_lost_requests(pkgs, affinity):
    with flags(serve_request_replay=1, serve_cache_affinity=int(affinity)):
        out = assert_same(p_chaos_sigkill_rounds, affinity, live=True)
    assert out[0] == 2 and out[1] == [i * 2 + 1 for i in range(10)]
    assert out[-1] == [[]] * 8


def test_gray_replica_ejected_and_replaced(pkgs):
    with flags(serve_replica_ejection=1):
        assert assert_same(p_gray_replica_ejected_and_replaced,
                           live=True) == (2, True, True)


def test_engine_replica_loss(pkgs):
    """One two-replica engine deployment a package, in order: a replica
    SIGKILLed under flag-off traffic (every request still completes),
    injected stream resumes with affinity off and on, then a real SIGKILL
    of the replica serving a stream (replay on): every spliced stream
    equals an unkilled run, and the port's tokens equal the
    reference's."""
    n, tokens, replaced = assert_same(p_engine_poll_replica_death,
                                      live=True)
    assert n == 2 and all(len(t) == 8 for t in tokens) and replaced
    for affinity in (0, 1):
        with flags(serve_request_replay=1, serve_cache_affinity=affinity):
            tokens, spliced = assert_same(p_stream_resume_exact_splice,
                                          live=True)
            assert len(tokens) == 12 and spliced
    with flags(serve_request_replay=1):
        assert assert_same(p_stream_survives_sigkill, live=True) == \
            (1, True, 12)


def test_stream_survives_sigkill_of_the_only_replica(pkgs):
    """Replay on, one replica: SIGKILLing it after a stream's first chunk
    leaves no replica to resume on until the controller starts another.
    The port's router waits for that replacement (``_await_replacement``)
    and the spliced tokens equal an unkilled run's. ``ray_tpu``'s router
    retries the corpse, which the controller has not dropped yet, and
    spends its replay budget in milliseconds: its stream fails with
    ReplicaUnavailableError ("failed after 3 attempt(s)")."""
    p = PORT

    class Solo(p.llm_engine.LLMEngine):
        def __init__(self, params, **kw):
            from ray_tpu_torch.models.convert import params_from_numpy

            super().__init__(params=params_from_numpy(params, "cpu"),
                             device="cpu", **kw)

        def pid(self):
            return os.getpid()

    with flags(serve_request_replay=1, serve_replica_wait_s=60):
        handle = p.serve.run(p.serve.deployment(
            name="llmsolo", engine=True, num_cpus=0.1)(Solo).bind(
                p.params, model_config={"preset": "tiny"}, num_slots=4,
                max_len=64, prefill_buckets=[16], max_new_tokens=40,
                chunk_steps=1), timeout=300)
        prompt = [9, 4, 1, 7]
        unkilled = handle.remote(prompt, 40).result(timeout=120)["tokens"]
        victim = handle.pid.remote().result(timeout=60)
        gen = handle.stream(prompt, 40)
        got = list(next(gen))
        os.kill(victim, signal.SIGKILL)
        for chunk in gen:
            got += chunk
        after = handle.pid.remote().result(timeout=60)
        p.serve.delete("llmsolo")
    assert after != victim
    assert got == unkilled and len(got) == 40
