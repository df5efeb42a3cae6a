"""The port's compiled DAGs (``ray_tpu_torch.dag``) against ``ray_tpu``'s.

Each program runs twice in this process: through ``ray_tpu`` (the
reference) and through ``ray_tpu_torch``, each on its own runtime. The
two must give equal values, or raise exceptions of the same type name.
The programs are ``tests/test_dag.py``'s and ``test_dag_spin.py``'s but
the cross-node, socket-channel and RPC ones, which wait for the port's
cluster mode. The dispatch-latency program prints the DAG's and the
actor calls' latencies instead of comparing them (a wall-clock ratio
that a loaded box breaks).

The device lane carries torch tensors in the port where the reference
carries jax Arrays: the unit round trip and the forced same-actor edge
hold identity (the consumer gets the producer's object) in both. The
port-only cases check that a tensor on a plain shm edge arrives as a CPU
tensor with its bits, that the placement probe loads no torch in a CPU
worker, and the socket refusal; on the card (``-m card``) a tuple of
CUDA tensors crosses a DeviceChannel between two streams.
"""

from __future__ import annotations

import os
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

import ray_tpu
import ray_tpu_torch

torch = pytest.importorskip("torch")


def _ns(pkg):
    """The modules a program uses, from one package."""
    import importlib

    name = pkg.__name__
    mods = {k: importlib.import_module(f"{name}.{m}") for k, m in (
        ("dag", "dag"), ("channel", "dag.channel"),
        ("ctx", "core.runtime_context"), ("cfg", "core.config"),
        ("exc", "exceptions"), ("dag_mode", "serve.dag_mode"))}
    return SimpleNamespace(rt=pkg, config=mods.pop("cfg").config, **mods)


@pytest.fixture(scope="module")
def pkgs():
    """Both runtimes (4 workers each) for the module."""
    started = []
    try:
        for pkg in (ray_tpu, ray_tpu_torch):
            ns = _ns(pkg)
            prev = ns.ctx.get_core_or_none()
            ns.ctx.set_core(None)
            pkg.init(num_workers=4, object_store_memory=128 << 20)
            started.append((ns, prev))
        yield [ns for ns, _ in started]
    finally:
        for ns, prev in reversed(started):
            core = ns.ctx.get_core_or_none()
            if core is not None:
                core.shutdown()
            ns.ctx.set_core(prev)


def both(pkgs, program, *args):
    """(reference's outcome, port's outcome): a value, or ("raised",
    type name, message)."""
    out = []
    for p in pkgs:
        try:
            out.append(program(p, *args))
        except Exception as e:  # noqa: BLE001 — compared by type name
            out.append(("raised", type(e).__name__, str(e)))
    return out


def assert_same(pkgs, program, *args):
    ref, port = both(pkgs, program, *args)
    assert port == ref, (ref, port)
    return ref


# ------------------------------------------------------------ programs
# each takes a package namespace (``_ns``) and returns a value that must
# be equal for both packages


def p_channel_spsc_roundtrip(p):
    store = p.ctx.get_core().store
    ch = p.channel.Channel.create(store, capacity=1 << 16)
    reader = p.channel.Channel.open(store, ch.descriptor())
    out = []

    def consume():
        for _ in range(50):
            out.append(reader.read(timeout_ms=10_000))

    t = threading.Thread(target=consume)
    t.start()
    for i in range(50):
        ch.write({"i": i, "arr": np.arange(10) * i})
    t.join(20)
    got = [(o["i"], o["arr"].tolist()) for o in out]
    ch.close()
    try:
        reader.read(timeout_ms=5000)
        closed = None
    except Exception as e:  # noqa: BLE001 — compared by type name
        closed = type(e).__name__
    ch.release()
    reader.release()
    return got, closed


def p_pipeline_execute_and_errors(p):
    @p.rt.remote
    class Stage:
        def __init__(self, add):
            self.add = add

        def step(self, x):
            if x == "boom":
                raise ValueError("kaboom")
            return x + self.add

    a, b, c = Stage.remote(1), Stage.remote(10), Stage.remote(100)
    dag = p.dag.compile_pipeline([(a, "step"), (b, "step"), (c, "step")])
    seen = []
    try:
        seen += [dag.execute(0), dag.execute(5)]
        try:
            dag.execute("boom")
        except ValueError as e:
            seen.append(("ValueError", str(e)))
        seen.append(dag.execute(1))
    finally:
        dag.teardown()
    try:
        dag.execute(1)
    except RuntimeError as e:
        seen.append(("RuntimeError", str(e)))
    return seen


def p_bind_style_compile(p):
    @p.rt.remote
    class M:
        def double(self, x):
            return x * 2

        def inc(self, x):
            return x + 1

    m1, m2 = M.remote(), M.remote()
    with p.dag.InputNode() as inp:
        node = p.dag.bind(m2, "inc", p.dag.bind(m1, "double", inp))
    dag = node.experimental_compile()
    try:
        return dag.execute(21)
    finally:
        dag.teardown()


def p_pipeline_overlaps_stages(p):
    @p.rt.remote
    class Slow:
        def step(self, x):
            time.sleep(0.1)
            return x

    s = [Slow.remote() for _ in range(3)]
    dag = p.dag.compile_pipeline([(a, "step") for a in s])
    try:
        dag.execute(0)  # warm the loops
        t0 = time.perf_counter()
        resolvers = [dag.execute_async(i) for i in range(4)]
        outs = [r() for r in resolvers]
        dt = time.perf_counter() - t0
    finally:
        dag.teardown()
    # serial would be 4 calls x 3 stages x 0.1 s = 1.2 s
    return outs, dt < 0.95


def p_dispatch_latency(p):
    @p.rt.remote
    class Id:
        def step(self, x):
            return x

    actors = [Id.remote() for _ in range(3)]
    n = 100

    def measure_actor():
        for a in actors:
            p.rt.get(a.step.remote(0), timeout=30)
        t0 = time.perf_counter()
        for i in range(n):
            v = i
            for a in actors:
                v = p.rt.get(a.step.remote(v), timeout=30)
        return (time.perf_counter() - t0) / n

    dag = p.dag.compile_pipeline([(a, "step") for a in actors])
    try:
        dag.execute(0)
        t0 = time.perf_counter()
        ok = all(dag.execute(i) == i for i in range(n))
        dag_lat = (time.perf_counter() - t0) / n
        actor_lat = measure_actor()
    finally:
        dag.teardown()
    print(f"{p.rt.__name__}: 3-stage dag.execute {dag_lat * 1e6:.0f} us, "
          f"3 chained actor calls {actor_lat * 1e6:.0f} us")
    return ok


def _math_actor(p):
    @p.rt.remote
    class Math:
        def double(self, x):
            return x * 2

        def square(self, x):
            return x * x

        def join(self, a, b):
            return a + b

    return Math


def p_diamond_fan_out_fan_in(p, spin_us=None):
    Math = _math_actor(p)
    a, b, c = Math.remote(), Math.remote(), Math.remote()
    with p.dag.InputNode() as inp:
        out = p.dag.bind(c, "join", p.dag.bind(a, "double", inp),
                         p.dag.bind(b, "square", inp))
    dag = p.dag.compile_dag(out, spin_us=spin_us)
    try:
        joined = [dag.execute(x) for x in range(5)]
    finally:
        dag.teardown()
    with p.dag.InputNode() as inp:
        multi = p.dag.MultiOutputNode([p.dag.bind(a, "double", inp),
                                       p.dag.bind(b, "square", inp)])
    dag = p.dag.compile_dag(multi, spin_us=spin_us)
    try:
        return joined, dag.execute(7)
    finally:
        dag.teardown()


def p_diamond_error_propagation(p):
    @p.rt.remote
    class M:
        def ok(self, x):
            return x

        def boom(self, x):
            raise ValueError("branch exploded")

        def join(self, a, b):
            return (a, b)

    a, b, c = M.remote(), M.remote(), M.remote()
    with p.dag.InputNode() as inp:
        out = p.dag.bind(c, "join", p.dag.bind(a, "ok", inp),
                         p.dag.bind(b, "boom", inp))
    dag = p.dag.compile_dag(out)
    seen = []
    try:
        for x in (1, 2):  # the pairing stays intact after an error
            try:
                dag.execute(x)
            except ValueError as e:
                seen.append(str(e))
    finally:
        dag.teardown()
    return seen


def p_spin_budget_no_busy_burn(p):
    store = p.ctx.get_core().store
    ch = p.channel.Channel.create(store, capacity=1 << 12, spin_us=2000)
    reader = p.channel.Channel.open(store, ch.descriptor())
    try:
        t0_wall, t0_cpu = time.monotonic(), time.process_time()
        try:
            reader.read(timeout_ms=600)
            raised = None
        except TimeoutError as e:
            raised = type(e).__name__
        wall = time.monotonic() - t0_wall
        cpu = time.process_time() - t0_cpu
    finally:
        ch.release()
        reader.release()
    # the 2 ms budget spent, then parked: a busy burn would cost ~wall
    return reader._spin_us, raised, wall >= 0.55, cpu < 0.25


def p_timeout_poisons_dag(p):
    @p.rt.remote
    class Slow:
        def step(self, x):
            time.sleep(float(x))
            return x

    dag = p.dag.compile_pipeline([(Slow.remote(), "step")], spin_us=200)
    seen = []
    try:
        seen.append(dag.execute(0))
        for x, t in ((2.0, 150), (0, 60_000)):
            try:
                dag.execute(x, timeout_ms=t)
            except (TimeoutError, RuntimeError) as e:
                seen.append((type(e).__name__, "broken" in str(e)))
    finally:
        dag.teardown()
    return seen


def p_teardown_drains(p):
    @p.rt.remote
    class Id:
        def step(self, x):
            return x

    dag = p.dag.compile_pipeline([(Id.remote(), "step"),
                                  (Id.remote(), "step")], spin_us=100)
    dag.execute(0)
    resolvers = [dag.execute_async(i) for i in range(3)]  # in flight
    del resolvers
    t0 = time.monotonic()
    dag.teardown()  # must drain 3 results + the sentinel, not hang
    quick = time.monotonic() - t0 < 10
    try:
        dag.execute(0)
        return quick, None
    except RuntimeError as e:
        return quick, type(e).__name__


def _array(p, values):
    """The package's device payload: a jax Array or a torch tensor."""
    if p.rt is ray_tpu:
        import jax.numpy as jnp

        return jnp.asarray(values)
    return torch.as_tensor(values)


def p_device_channel_unit_roundtrip(p):
    store = p.ctx.get_core().store
    ch = p.channel.DeviceChannel.create(store, capacity=1 << 12,
                                        spin_us=100)
    reader = p.channel.DeviceChannel.open(store, ch.descriptor())
    reg = p.channel._DEVICE_HANDOFF
    seen = []
    try:
        arr = _array(p, np.arange(8))
        ch.write(("v", arr))
        tag, out = reader.read()
        seen.append((tag, out is arr))  # no serialize round trip
        pair = (arr, _array(p, np.ones(2)))
        ch.write(("v", pair))
        tag, out = reader.read()
        seen.append((tag, all(a is b for a, b in zip(out, pair))))
        ch.write(("v", {"host": 1}))  # not an array: the pickled path
        seen.append(reader.read())
        ch.write(("e", ValueError("boom")))
        tag, out = reader.read()
        seen.append((tag, type(out).__name__))
        # leftover handoff entries are dropped on release
        ch.write(("v", _array(p, np.ones(2))))
        seen.append(any(k[0] == ch._key for k in reg))
    finally:
        ch.release()
        reader.release()
    seen.append(any(k[0] == ch._key for k in reg))
    return seen


def _two_stage(p):
    @p.rt.remote
    class Two:
        def first(self, x):
            return x + 1

        def second(self, x):
            return x * 10

    return Two.remote()


def p_device_edges_fall_back_to_shm(p):
    """``device='auto'`` without an accelerator: every edge is plain
    shm, and the DAG works."""
    t = _two_stage(p)
    with p.dag.InputNode() as inp:
        out = p.dag.bind(t, "second", p.dag.bind(t, "first", inp))
    dag = p.dag.compile_dag(out, device="auto")
    try:
        kinds = [type(c).__name__ for c in dag._shm_chans]
        return kinds, dag.execute(4)
    finally:
        dag.teardown()


def p_device_edge_forced_same_actor(p):
    """``device='force'`` puts the same-process edge on a DeviceChannel:
    the producer's array reaches the consumer as the SAME object."""
    port = p.rt is ray_tpu_torch

    @p.rt.remote
    class Holder:
        def make(self, x):
            if port:
                import torch as _t

                self._made = _t.arange(int(x))
            else:
                import jax.numpy as jnp

                self._made = jnp.arange(int(x))
            return self._made

        def check(self, arr):
            return bool(arr is self._made)

    h = Holder.remote()
    with p.dag.InputNode() as inp:
        out = p.dag.bind(h, "check", p.dag.bind(h, "make", inp))
    seen = []
    for mode in ("force", "off"):
        dag = p.dag.compile_dag(out, device=mode, spin_us=100)
        try:
            seen.append(([type(c).__name__ for c in dag._shm_chans],
                         dag.execute(8)))
        finally:
            dag.teardown()
    return seen


def p_compile_failure_names_missing_actor(p, monkeypatch):
    core = p.ctx.get_core()

    def _addr(aid):
        raise p.exc.ActorDiedError(f"unknown actor {aid}")

    monkeypatch.setattr(core, "_actor_addr", _addr, raising=False)
    os.environ["RTPU_DAG_COMPILE_ACTOR_WAIT_S"] = "0.3"
    p.config.reload()
    try:
        class Fake:
            _actor_id = "ghost-actor-42"

        t0 = time.monotonic()
        try:
            p.dag.compile_pipeline([(Fake(), "step")])
            raised = None
        except ValueError as e:
            raised = ("ValueError", "ghost-actor-42" in str(e),
                      ".step" in str(e))
        return raised, time.monotonic() - t0 < 3.0
    finally:
        monkeypatch.delattr(core, "_actor_addr", raising=False)
        os.environ.pop("RTPU_DAG_COMPILE_ACTOR_WAIT_S", None)
        p.config.reload()


def p_serve_dag_mode_on_spin_lane(p):
    class Add:
        def __init__(self, n):
            self._n = n

        def run(self, x):
            return x + self._n

    dep = p.dag_mode.PipelineDeployment(
        [(Add, "run", (1,)), (Add, "run", (10,))], spin_us=100)
    try:
        seen = [dep._spin_us, dep._dag._spin_us, dep(5)]
        try:
            dep(5, _deadline=time.time() - 1)
        except p.exc.BackpressureError as e:
            seen.append(type(e).__name__)
        return seen
    finally:
        dep.shutdown()


def p_serve_dag_spin_us_inherits_global(p):
    class Ident:
        def run(self, x):
            return x

    seen = []
    os.environ["RTPU_DAG_SPIN_US"] = "77"
    p.config.reload()
    try:
        dep = p.dag_mode.PipelineDeployment([(Ident, "run", ())])
        try:
            seen.append(dep._spin_us)
        finally:
            dep.shutdown()
        os.environ["RTPU_SERVE_DAG_SPIN_US"] = "0"
        p.config.reload()
        dep = p.dag_mode.PipelineDeployment([(Ident, "run", ())])
        try:
            seen += [dep._spin_us, dep(3)]
        finally:
            dep.shutdown()
    finally:
        os.environ.pop("RTPU_DAG_SPIN_US", None)
        os.environ.pop("RTPU_SERVE_DAG_SPIN_US", None)
        p.config.reload()
    return seen


# --------------------------------------------------------------- tests


@pytest.mark.parametrize("program", [
    p_channel_spsc_roundtrip, p_pipeline_execute_and_errors,
    p_bind_style_compile, p_pipeline_overlaps_stages,
    p_diamond_error_propagation, p_spin_budget_no_busy_burn,
    p_timeout_poisons_dag, p_teardown_drains,
    p_device_edges_fall_back_to_shm, p_device_edge_forced_same_actor,
    p_serve_dag_mode_on_spin_lane, p_serve_dag_spin_us_inherits_global,
], ids=lambda f: f.__name__[2:])
def test_program_matches_reference(pkgs, program):
    assert_same(pkgs, program)


@pytest.mark.parametrize("spin_us", [None, 0, 200])
def test_diamond_fan_out_fan_in(pkgs, spin_us):
    """Fan-out + fan-in and a MultiOutputNode, on the default lane, pure
    block and a 200 us spin: the spin lane changes latency only."""
    joined, multi = assert_same(pkgs, p_diamond_fan_out_fan_in, spin_us)
    assert joined == [2 * x + x * x for x in range(5)] and multi == [14, 49]


def test_dispatch_latency_printed(pkgs, capsys):
    """A 3-stage pipeline answers 100 calls in order; the latencies of
    dag.execute and of chained actor calls are printed, not compared."""
    assert assert_same(pkgs, p_dispatch_latency) is True
    with capsys.disabled():
        print(capsys.readouterr().out, end="")


def test_device_channel_unit_roundtrip(pkgs):
    """A tensor (the port) or a jax Array (the reference) and a tuple of
    them cross by reference; host values and errors ride the pickled
    path; release purges the registry."""
    seen = assert_same(pkgs, p_device_channel_unit_roundtrip)
    assert seen == [("v", True), ("v", True), ("v", {"host": 1}),
                    ("e", "ValueError"), True, False]


def test_compile_failure_names_missing_actor(pkgs, monkeypatch):
    raised, quick = assert_same(pkgs, p_compile_failure_names_missing_actor,
                                monkeypatch)
    assert raised == ("ValueError", True, True) and quick


def test_shm_edge_carries_tensors_as_cpu_tensors(pkgs):
    """A tensor on a plain shm edge arrives as a CPU tensor with its
    dtype, shape and bits (bf16 included), through a stage in a CPU
    worker, whose ``CUDA_VISIBLE_DEVICES`` is empty."""
    p = pkgs[1]

    @p.rt.remote
    class Stage:
        def view(self, t):
            return (t.dtype, tuple(t.shape), t.device.type,
                    os.environ.get("CUDA_VISIBLE_DEVICES"),
                    t.view(torch.int16) if t.dtype == torch.bfloat16
                    else t)

    s = Stage.remote()
    g = torch.Generator().manual_seed(0)
    x = torch.randn(3, 5, generator=g).to(torch.bfloat16)
    dag = p.dag.compile_pipeline([(s, "view")], device="off")
    try:
        dt, shape, devtype, visible, bits = dag.execute(x)
        y = dag.execute(x.float())
    finally:
        dag.teardown()
    assert (dt, shape, devtype, visible) == (torch.bfloat16, (3, 5),
                                             "cpu", "")
    assert torch.equal(bits, x.view(torch.int16))
    assert torch.equal(y[-1], x.float())


def test_devinfo_probe_loads_no_torch(pkgs):
    """The placement probe answers (pid, False) in a CPU worker without
    importing torch; the resident-loop entry point runs (a refusal
    before the port's DAG lane)."""
    p = pkgs[1]

    @p.rt.remote
    class Plain:
        def state(self):
            import sys

            return os.getpid(), "torch" in sys.modules

    a = Plain.remote()
    pid, had_torch = p.rt.get(a.state.remote(), timeout=60)
    core = p.ctx.get_core()
    ref = core.submit_actor_task(a._actor_id, "__rtpu_dag_devinfo__", (),
                                 {}, 1)[0]
    assert tuple(p.rt.get(ref, timeout=30)) == (pid, False)
    assert p.rt.get(a.state.remote(), timeout=30) == (pid, had_torch)
    p.rt.kill(a)


@pytest.fixture
def gpu_core(pkgs):
    """The port's runtime with 2 injected GPU ids (no card: the ids only
    travel into ``CUDA_VISIBLE_DEVICES``), current for the test."""
    from ray_tpu_torch.core import runtime_context
    from ray_tpu_torch.core.resources import GpuSet
    from ray_tpu_torch.core.runtime import Runtime

    prev = runtime_context.get_core_or_none()
    rt = Runtime(num_workers=1, object_store_memory=64 << 20,
                 gpus=GpuSet(2))
    runtime_context.set_core(rt)
    try:
        yield rt
    finally:
        rt.shutdown()
        runtime_context.set_core(prev)


def test_auto_device_edge_on_a_gpu_actor(gpu_core):
    """``device='auto'`` puts the edge between two methods of one GPU
    actor on a DeviceChannel (its probe answers ``(pid, True)`` from
    ``RTPU_GPU_IDS``): the consumer gets the producer's tensor. With
    ``'off'`` the same edge is shm and the tensor is a copy."""
    from ray_tpu_torch.dag import InputNode, bind, compile_dag
    from ray_tpu_torch.dag.channel import Channel, DeviceChannel

    @ray_tpu_torch.remote(num_gpus=1)
    class Holder:
        def make(self, x):
            import torch as _t

            self._made = _t.arange(int(x))
            return self._made

        def check(self, t):
            return bool(t is self._made), os.environ["RTPU_GPU_IDS"]

    h = Holder.remote()
    ref = gpu_core.submit_actor_task(h._actor_id, "__rtpu_dag_devinfo__",
                                     (), {}, 1)[0]
    assert ray_tpu_torch.get(ref, timeout=60)[1] is True
    with InputNode() as inp:
        out = bind(h, "check", bind(h, "make", inp))
    for mode, kind, same in (("auto", DeviceChannel, True),
                             ("off", Channel, False)):
        dag = compile_dag(out, device=mode)
        try:
            assert [type(c) for c in dag._shm_chans] == [kind]
            got, ids = dag.execute(8)
            assert got is same and len(ids.split(",")) == 1
        finally:
            dag.teardown()
    ray_tpu_torch.kill(h)


def test_socket_channels_refused():
    """Cross-node edges (socket channels) are no longer refused: a
    ``"sock"`` descriptor opens a ``SocketChannel`` whose reader
    publishes its port under ``dagchan:<id>``, and a writer with the same
    key hands it values, a CPU tensor among them, in order; a writer with
    another key is turned away."""
    import torch

    from ray_tpu_torch.dag import SocketChannel
    from ray_tpu_torch.dag.channel import ChannelClosed, open_endpoint

    table = {}

    def kv(op, key, value=None):
        if op == "put":
            table[key] = value
        elif op == "get":
            return table.get(key)
        elif op == "del":
            table.pop(key, None)

    key, cid = b"k" * 16, SocketChannel.create_id()
    desc = ("sock", cid, "127.0.0.1")
    reader = open_endpoint(desc, kv=kv, role="reader", authkey=key)
    assert isinstance(reader, SocketChannel) and reader.descriptor() == desc
    assert isinstance(table[f"dagchan:{cid}"], int)
    got = []
    t = threading.Thread(target=lambda: got.extend(
        reader.read(timeout_ms=20_000) for _ in range(3)), daemon=True)
    t.start()
    with pytest.raises(PermissionError):
        open_endpoint(desc, kv=kv, role="writer", authkey=b"x" * 16,
                      timeout_ms=3000).write("stolen", timeout_ms=3000)
    writer = open_endpoint(desc, kv=kv, role="writer", authkey=key)
    for v in ("a", torch.arange(6, dtype=torch.bfloat16), ("v", 2)):
        writer.write(v, timeout_ms=20_000)
    writer.close()
    t.join(30)
    assert got[0] == "a" and got[2] == ("v", 2)
    assert got[1].dtype == torch.bfloat16 and got[1].tolist() == list(
        range(6))
    with pytest.raises(ChannelClosed):
        reader.read(timeout_ms=20_000)
    writer.release()
    reader.release()
    assert f"dagchan:{cid}" not in table


@pytest.mark.parametrize("pkg", ["dag", "serve"])
def test_packages_export_the_reference_names(pkg):
    """``ray_tpu_torch.dag`` and ``ray_tpu_torch.serve`` export what
    ``ray_tpu.dag`` and ``ray_tpu.serve`` export."""
    import importlib

    def public(name):
        mod = importlib.import_module(name)
        return {n for n in getattr(mod, "__all__", dir(mod))
                if not n.startswith("_")
                and not isinstance(getattr(mod, n), type(importlib))}

    assert public(f"ray_tpu_torch.{pkg}") >= public(f"ray_tpu.{pkg}")


@pytest.mark.card
def test_device_channel_cuda_tensors_across_streams():
    """On the card: a tuple of CUDA tensors written on one stream is
    read on another as the same tensors (equal ``data_ptr``), with the
    values the writer's stream produced, after the reader's stream waited
    on the writer's event."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the chip with "
                    "python -m pytest -m card tests/test_torch_dag.py")
    from ray_tpu_torch.core.object_store.store import ShmObjectStore
    from ray_tpu_torch.dag.channel import DeviceChannel

    store = ShmObjectStore.create(f"/rtpt_dagtest_{os.getpid()}", 16 << 20)
    ch = DeviceChannel.create(store, capacity=1 << 12)
    reader = DeviceChannel.open(store, ch.descriptor())
    try:
        writer_s, reader_s = torch.cuda.Stream(), torch.cuda.Stream()
        with torch.cuda.stream(writer_s):
            a = torch.zeros(1 << 24, device="cuda")
            torch.cuda._sleep(50_000_000)  # the write lands late
            a.fill_(3.0)
            b = torch.arange(16, device="cuda")
            ch.write(("v", (a, b)))
        with torch.cuda.stream(reader_s):
            tag, (ra, rb) = reader.read()
            total = ra.sum()
        torch.cuda.synchronize()
        assert tag == "v" and ra.data_ptr() == a.data_ptr()
        assert rb.data_ptr() == b.data_ptr()
        assert float(total) == 3.0 * (1 << 24)
    finally:
        ch.release()
        reader.release()
        store.close()
