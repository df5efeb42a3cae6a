"""The port's serving plane (``ray_tpu_torch.serve``) against ``ray_tpu``'s.

Each program runs through ``ray_tpu`` (the reference) and through
``ray_tpu_torch``, each on its own runtime in this process, and the two
outcomes must be equal: values, or exception type names. The programs
are ``tests/test_serve.py``'s but the cross-node pipeline (cluster
mode); its engine-only programs are held to the reference elsewhere
(batched admission, sampling and stop ids in ``test_torch_engine.py``,
tensor parallelism in ``test_torch_tp_serve.py``, HF and Qwen2
checkpoints in ``test_torch_hf_weights.py``). Both halves of a program
run at once, in two threads.

The engine deployment serves the tiny preset in fp32. The reference's
replicas draw their weights with ``jax.random.PRNGKey(0)``; the port's
get the same weights converted through numpy (``models/convert.py``), so
greedy tokens through the port's router equal the reference's through
its router, and ``LLMPipeline`` replies are equal too.
"""

from __future__ import annotations

import json
import os
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np
import pytest

import ray_tpu
import ray_tpu_torch

torch = pytest.importorskip("torch")


def _ns(pkg):
    import importlib

    name = pkg.__name__
    mods = {k: importlib.import_module(f"{name}.{m}") for k, m in (
        ("serve", "serve"), ("ctx", "core.runtime_context"),
        ("http_proxy", "serve.http_proxy"), ("api", "serve.api"),
        ("llm_engine", "serve.llm_engine"))}
    return SimpleNamespace(rt=pkg, port=pkg is ray_tpu_torch, **mods)


@pytest.fixture(scope="module")
def ref_params():
    """The tiny preset's weights as the reference's replicas draw them
    (PRNGKey(0)), as numpy."""
    import jax

    from ray_tpu.models import llama

    params = llama.init_params(llama.LlamaConfig.tiny(),
                               jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def pkgs(ref_params):
    started = []
    try:
        for pkg in (ray_tpu, ray_tpu_torch):
            ns = _ns(pkg)
            prev = ns.ctx.get_core_or_none()
            ns.ctx.set_core(None)
            pkg.init(num_workers=4, object_store_memory=128 << 20)
            ns.params = ref_params
            started.append((ns, prev))
        yield [ns for ns, _ in started]
    finally:
        for ns, prev in reversed(started):
            ns.serve.shutdown()
            core = ns.ctx.get_core_or_none()
            if core is not None:
                core.shutdown()
            ns.ctx.set_core(prev)


def _outcome(program, p, *args):
    try:
        return program(p, *args)
    except Exception as e:  # noqa: BLE001 — compared by type name
        return ("raised", type(e).__name__, str(e))


def assert_same(pkgs, program, *args):
    """Run ``program`` through both packages at once (two threads: the
    runtimes are independent, and the reference's replicas spend most
    of their time compiling) and return the reference's outcome, which
    the port's must equal."""
    with ThreadPoolExecutor(2) as pool:
        futs = [pool.submit(_outcome, program, p, *args) for p in pkgs]
        out = [f.result() for f in futs]
    assert out[1] == out[0], out
    return out[0]


def engine_class(p):
    """The deployment's engine class: the reference's as it is; the
    port's on the CPU with the reference's weights (a class made here is
    pickled by value into the replica)."""
    base = p.llm_engine.LLMEngine
    if not p.port:
        return base, {}

    class PortEngine(base):
        def __init__(self, params, **kw):
            from ray_tpu_torch.models.convert import params_from_numpy

            super().__init__(params=params_from_numpy(params, "cpu"),
                             device="cpu", **kw)

    return PortEngine, {"params": p.params}


def _post(port, path, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=120)


# ------------------------------------------------------------ programs


def p_function_deployment(p):
    @p.serve.deployment
    def doubler(x):
        return x * 2

    handle = p.serve.run(doubler)
    futs = [handle.remote(i) for i in range(10)]
    return (handle.remote(21).result(timeout=30),
            [f.result(timeout=30) for f in futs])


def p_class_deployment_and_methods(p):
    @p.serve.deployment(name="counter", num_replicas=1)
    class Counter:
        def __init__(self, start):
            self.n = start

        def __call__(self, k):
            return self.n + k

        def bump(self, by=1):
            self.n += by
            return self.n

    handle = p.serve.run(Counter.bind(100))
    return (handle.remote(5).result(timeout=30),
            handle.bump.remote(3).result(timeout=30),
            p.serve.status()["counter"]["running"])


def p_batching(p):
    @p.serve.deployment(name="batched", max_batch_size=8,
                        batch_wait_timeout_s=0.05)
    def embed(items):
        return [x + 1 for x in items]

    handle = p.serve.run(embed)
    futs = [handle.remote(i) for i in range(16)]
    return [f.result(timeout=30) for f in futs]


def p_scale_and_pow2_balancing(p):
    @p.serve.deployment(name="who", num_replicas=2)
    class Who:
        def __call__(self):
            return os.getpid()

    handle = p.serve.run(Who.bind())
    return len({handle.remote().result(timeout=30) for _ in range(20)})


def p_replica_death_recovery(p):
    @p.serve.deployment(name="fragile", num_replicas=1)
    class Fragile:
        def __call__(self, x):
            return x + 1

        def die(self):
            os._exit(1)

    handle = p.serve.run(Fragile.bind())
    first = handle.remote(1).result(timeout=30)
    try:
        handle.die.remote().result(timeout=10)
    except Exception:  # noqa: BLE001 — the replica died under the call
        pass
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        try:
            if handle.remote(5).result(timeout=10) == 6:
                return first, True
        except Exception:  # noqa: BLE001 — replacement not up yet
            time.sleep(0.3)
    return first, False


def p_http_proxy(p):
    @p.serve.deployment(name="adder")
    def adder(a, b):
        return a + b

    p.serve.run(adder)
    proxy = p.http_proxy.start_http()
    try:
        out = json.loads(_post(proxy.address[1], "adder",
                               {"args": [2, 3]}).read())
        return out["result"]
    finally:
        p.http_proxy.stop_http()


def p_grpc_ingress(p):
    import grpc

    @p.serve.deployment
    def triple(x):
        return x * 3

    p.serve.run(triple, name="triple")
    proxy = p.serve.start_grpc()
    try:
        ch = grpc.insecure_channel(f"127.0.0.1:{proxy.port}")
        call = ch.unary_unary("/ray_tpu.serve.Ingress/Call")
        ok = json.loads(call(json.dumps(
            {"deployment": "triple", "args": [14]}).encode(), timeout=60))
        bad = json.loads(call(json.dumps(
            {"deployment": "nope", "args": [1]}).encode(), timeout=60))
        ch.close()
        return ok, "error" in bad
    finally:
        p.serve.stop_grpc()
        p.serve.delete("triple")


def p_declarative_config_deploy(p, tmp_path):
    cfg = tmp_path / f"serve_{p.rt.__name__}.yaml"
    cfg.write_text("""
applications:
  - name: dbl
    import_path: tests.serve_targets:double
    num_replicas: 1
  - name: scale
    import_path: tests.serve_targets:Scaler
    init_kwargs: {factor: 5}
""")
    deployed = sorted(p.serve.deploy_config(str(cfg)))
    vals = (p.api.DeploymentHandle("dbl").remote(4).result(timeout=60),
            p.api.DeploymentHandle("scale").remote(4).result(timeout=60))
    cfg.write_text("""
applications:
  - name: dbl
    import_path: tests.serve_targets:double
""")
    p.serve.deploy_config(str(cfg))
    deadline = time.time() + 30
    while time.time() < deadline:
        status = p.serve.status()
        if "scale" not in status:
            break
        time.sleep(0.2)
    pruned = "dbl" in status and "scale" not in status
    p.serve.delete("dbl")
    return deployed, vals, pruned


def p_model_multiplexing(p):
    serve = p.serve

    @serve.deployment(num_replicas=2)
    class Mux:
        def __init__(self):
            self.loads = []

        @serve.multiplexed(max_num_models_per_replica=2)
        def get_model(self, model_id: str):
            self.loads.append(model_id)
            return {"id": model_id, "scale": int(model_id[1:])}

        def __call__(self, x):
            mid = serve.get_multiplexed_model_id()
            model = self.get_model(mid)
            return (mid, model["scale"] * x, len(self.loads))

    h = serve.run(Mux, name="mux")
    outs = [h.options(multiplexed_model_id=mid).remote(10).result(
        timeout=60)[:2] for mid in ("m2", "m3", "m5")]
    counts = [h.options(multiplexed_model_id="m7").remote(1).result(
        timeout=60)[2] for _ in range(6)]
    serve.delete("mux")
    return outs, counts[-1] == counts[1]


def p_llm_engine(p):
    """One engine replica (tiny, fp32) behind the router: concurrent
    unary requests, then a stream, then the proxy's SSE of one prompt,
    then a stream abandoned after its first chunk, which must free its
    slot and leave the mailbox empty."""
    cls, extra = engine_class(p)
    dep = p.serve.deployment(name="llm", engine=True, num_cpus=0.1)(
        cls).bind(model_config={"preset": "tiny"}, num_slots=4, max_len=64,
                  prefill_buckets=[16], max_new_tokens=40, chunk_steps=1,
                  **extra)
    handle = p.serve.run(dep, timeout=300)
    out = {}
    prompts = [[3, 17, 42], [7, 7], [100, 5, 9, 11], [1]]
    futs = [handle.remote(q, 8) for q in prompts]
    outs = [f.result(timeout=300) for f in futs]
    out["unary"] = [o["tokens"] for o in outs]
    out["timing"] = all(o["ttft_s"] >= 0 and o["latency_s"] >= o["ttft_s"]
                        for o in outs)
    out["slots"] = handle.stats.remote().result(timeout=30).get("slots", 4)

    prompt = [5, 11, 2]
    unary = handle.remote(prompt).result(timeout=300)["tokens"]
    chunks = list(handle.stream(prompt))
    proxy = p.http_proxy.start_http(port=0)
    try:
        with _post(proxy.address[1], "llm",
                   {"args": [prompt], "stream": True}) as resp:
            out["sse"] = resp.headers["Content-Type"].startswith(
                "text/event-stream")
            events = []
            for line in resp:
                line = line.decode().strip()
                if line.startswith("data: "):
                    body = line[len("data: "):]
                    if body == "[DONE]":
                        break
                    events.append(json.loads(body))
    finally:
        p.http_proxy.stop_http()
    out["stream"] = (unary, len(chunks) >= 2,
                     [t for c in chunks for t in c] == unary,
                     [t for e in events for t in e["tokens"]] == unary)

    gen = handle.stream([1, 2, 3], 10_000)
    first = next(gen)
    gen.close()  # abandon: GeneratorExit cancels the request
    deadline = time.time() + 30
    while time.time() < deadline:
        stats = handle.stats.remote().result(30)
        if stats["active"] == 0 and stats["queued"] == 0:
            break
        time.sleep(0.2)
    out["abandon"] = (len(first) >= 1, stats["active"],
                      handle.peek.remote().result(30))
    p.serve.delete("llm")
    return out


def p_serve_dag_mode_llm_pipeline(p):
    dep = p.serve.deployment(p.serve.LLMPipeline).options(name="llm-dag")
    if p.port:  # the reference's weights, on the CPU
        dep = dep.bind(params=p.params, device="cpu")
    h = p.serve.run(dep, name="llm-dag")
    out = h.remote("hello tpu").result(timeout=180)
    out2 = h.remote("hello tpu").result(timeout=180)
    p.serve.delete("llm-dag")
    return out, out2 == out


def p_model_composition(p):
    serve = p.serve

    @serve.deployment(name="embedder", num_replicas=1)
    def embedder(x):
        return [v * 2 for v in x]

    @serve.deployment(name="scorer", num_replicas=1)
    def scorer(x):
        return sum(x)

    emb_handle = serve.run(embedder)
    score_handle = serve.run(scorer)

    @serve.deployment(name="pipeline", num_replicas=1)
    class Pipeline:
        def __init__(self, emb, score):
            self.emb = emb
            self.score = score

        def __call__(self, x):
            e = self.emb.remote(x).result(60)
            return self.score.remote(e).result(60)

    pipe = serve.run(Pipeline.bind(emb_handle, score_handle), timeout=120)
    return pipe.remote([1, 2, 3]).result(120)


def p_autoscaling_scales_up_and_down(p):
    import threading as _th

    @p.serve.deployment(name="autoscaled", num_cpus=0.05,
                        autoscaling_config={
                            "min_replicas": 1, "max_replicas": 3,
                            "target_ongoing_requests": 1,
                            "upscale_delay_s": 0.2,
                            "downscale_delay_s": 1.0,
                        })
    def slow(x):
        time.sleep(0.4)
        return x

    handle = p.serve.run(slow, timeout=120)
    controller = p.rt.get_actor("SERVE_CONTROLLER")
    stop = time.time() + 6
    results = []

    def fire():
        while time.time() < stop:
            try:
                results.append(handle.remote(1).result(60))
            except Exception:  # noqa: BLE001 — rolling replicas
                pass

    threads = [_th.Thread(target=fire) for _ in range(9)]
    for t in threads:
        t.start()
    peak = 0
    deadline = time.time() + 25
    while time.time() < deadline:
        st = p.rt.get(controller.status.remote(), timeout=30)
        peak = max(peak, st["autoscaled"]["running"])
        if peak >= 3:
            break
        time.sleep(0.3)
    for t in threads:
        t.join()
    deadline = time.time() + 30
    down = 99
    while time.time() < deadline:
        st = p.rt.get(controller.status.remote(), timeout=30)
        down = st["autoscaled"]["target"]
        if down == 1:
            break
        time.sleep(0.3)
    p.serve.delete("autoscaled")
    return peak >= 2, down, len(results) > 0


def p_long_poll_topology_push(p):
    @p.serve.deployment(name="lp", num_replicas=1, num_cpus=0.05)
    def f(x):
        return x + 1

    handle = p.serve.run(f.bind(), timeout=300)
    first = handle.remote(1).result(timeout=60)
    controller = p.rt.get_actor("SERVE_CONTROLLER")
    router = handle._get_router()
    seeded = len(router._replicas)
    pulls0 = p.rt.get(controller.control_plane_stats.remote(),
                      timeout=30)["get_replicas_calls"]
    time.sleep(2.5)
    pulls1 = p.rt.get(controller.control_plane_stats.remote(),
                      timeout=30)["get_replicas_calls"]
    controller.scale.remote("lp", 2)
    deadline = time.monotonic() + 120
    while time.monotonic() < deadline:
        _, reps = p.rt.get(controller.get_replicas.remote("lp"), timeout=30)
        if len(reps) == 2:
            break
        time.sleep(0.005)
    t0 = time.monotonic()
    while time.monotonic() < deadline and len(router._replicas) < 2:
        time.sleep(0.001)
    dt = time.monotonic() - t0
    pushed = len(router._replicas) == 2
    p.serve.delete("lp")
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline and not router._deployment_gone:
        time.sleep(0.01)
    return (first, seeded, pulls1 == pulls0, pushed, dt < 1.0,
            router._deployment_gone)


def p_stream_generator_deployment(p):
    @p.serve.deployment(name="tokens")
    def tokens(n):
        for i in range(int(n)):
            time.sleep(0.01)
            yield f"tok{i}"

    handle = p.serve.run(tokens.bind())
    t0 = time.perf_counter()
    got, first = [], None
    for item in handle.stream(20):
        if first is None:
            first = time.perf_counter() - t0
        got.append(item)
    total = time.perf_counter() - t0
    p.serve.delete("tokens")
    return got, first < total / 2


def p_stream_class_deployment_with_mux(p):
    serve = p.serve

    @serve.deployment(name="muxgen")
    class Gen:
        def __call__(self, n):
            mid = serve.get_multiplexed_model_id()
            for i in range(int(n)):
                yield (mid, i)

    handle = serve.run(Gen.bind())
    out = list(handle.options(multiplexed_model_id="m1").stream(5))
    serve.delete("muxgen")
    return out


def p_stream_non_generator_raises(p):
    @p.serve.deployment(name="plainfn")
    def plain(x):
        return x + 1

    handle = p.serve.run(plain.bind())
    try:
        list(handle.stream(1))
        raised = None
    except TypeError as e:
        raised = ("TypeError", "generator" in str(e))
    out = handle.remote(1).result(timeout=30)
    p.serve.delete("plainfn")
    return raised, out


# --------------------------------------------------------------- tests


@pytest.mark.parametrize("program", [
    p_function_deployment, p_class_deployment_and_methods, p_batching,
    p_scale_and_pow2_balancing, p_replica_death_recovery, p_http_proxy,
    p_grpc_ingress, p_model_multiplexing, p_model_composition,
    p_autoscaling_scales_up_and_down, p_long_poll_topology_push,
    p_stream_generator_deployment, p_stream_class_deployment_with_mux,
    p_stream_non_generator_raises,
], ids=lambda f: f.__name__[2:])
def test_program_matches_reference(pkgs, program):
    assert_same(pkgs, program)


def test_declarative_config_deploy(pkgs, tmp_path):
    deployed, vals, pruned = assert_same(pkgs, p_declarative_config_deploy,
                                         tmp_path)
    assert deployed == ["dbl", "scale"] and vals == (8, 20) and pruned


def test_llm_engine_through_the_router(pkgs):
    """The port's greedy tokens through its router equal the
    reference's, unary and streamed (handle.stream and SSE); an
    abandoned stream frees its slot."""
    out = assert_same(pkgs, p_llm_engine)
    assert all(len(t) == 8 for t in out["unary"]) and out["timing"]
    assert out["slots"] == 4 and out["sse"]
    unary, *same = out["stream"]
    assert len(unary) == 40 and all(same)
    assert out["abandon"] == (True, 0, {})


def test_llm_pipeline_reply_matches_reference(pkgs):
    """DAG mode: the port's tokenize -> generate -> detokenize pipeline
    on the reference's weights answers what the reference's answers."""
    out, stable = assert_same(pkgs, p_serve_dag_mode_llm_pipeline)
    assert isinstance(out, str) and len(out.split()) >= 2 and stable


def test_gpu_replica_sees_its_card(pkgs):
    """A ``num_gpus=1`` deployment (``num_tpus`` in the reference) runs
    its replica as a GPU actor: the worker's ``CUDA_VISIBLE_DEVICES``
    names one id of the runtime's ``"GPU"`` resource (2 ids injected
    here, no card needed), which the replica gives back when the
    deployment is deleted."""
    from ray_tpu_torch.core import runtime_context
    from ray_tpu_torch.core.resources import GpuSet
    from ray_tpu_torch.core.runtime import Runtime
    from ray_tpu_torch import serve

    prev = runtime_context.get_core_or_none()
    rt = Runtime(num_workers=1, object_store_memory=64 << 20,
                 gpus=GpuSet(2))
    runtime_context.set_core(rt)
    try:
        @serve.deployment(name="onecard", num_gpus=1)
        def where():
            return (os.environ.get("CUDA_VISIBLE_DEVICES"),
                    os.environ.get("RTPU_GPU_IDS"))

        handle = serve.run(where)
        visible, ids = handle.remote().result(timeout=60)
        assert visible == ids and len(visible.split(",")) == 1
        with rt._lock:
            assert len(rt.gpus._free) == 1
        serve.delete("onecard")
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            with rt._lock:
                if len(rt.gpus._free) == 2:
                    break
            time.sleep(0.1)
        with rt._lock:
            assert len(rt.gpus._free) == 2
    finally:
        serve.shutdown()
        rt.shutdown()
        runtime_context.set_core(prev)
