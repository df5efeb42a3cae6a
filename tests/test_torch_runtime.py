"""The port's single-node runtime against ``ray_tpu``'s.

Each program runs twice in this process: through ``ray_tpu`` (the
reference) and through ``ray_tpu_torch``, each with its own runtime
(2 workers, a small store). The two must give equal results, or raise
exceptions of the same type name with causes of the same type name. The
programs are taken from ``tests/test_core_api.py``, ``test_actors.py``
and ``test_object_store.py``; a program that needs a slow task blocks it
in ``time.sleep`` and cancels it with ``force=True`` (its worker is
killed; in ``ray_tpu`` a SIGINT for a task batched behind another is
lost), so nothing here waits on a clock.

The port-only cases hold torch tensors to the numpy contract (bit for
bit, and a stored tensor's ``get`` is a view into the shm store) and
check that starting the runtime imports no torch.
"""

import ctypes
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import pytest

import ray_tpu
import ray_tpu_torch

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def pkgs():
    ray_tpu.init(num_workers=2, object_store_memory=64 << 20)
    ray_tpu_torch.init(num_workers=2, object_store_memory=64 << 20)
    try:
        yield (ray_tpu, ray_tpu_torch)
    finally:
        ray_tpu_torch.shutdown()
        ray_tpu.shutdown()


# ------------------------------------------------------------ programs
# each takes the package (``ray_tpu`` or ``ray_tpu_torch``) and returns a
# value that must be equal for both


def p_task_chain(rt):
    @rt.remote
    def inc(x):
        return x + 1

    ref = inc.remote(0)
    for _ in range(10):
        ref = inc.remote(ref)
    return rt.get(ref)


def p_get_list_and_kwargs(rt):
    @rt.remote
    def f(a, b=10, *, c=100):
        return a * a + b + c

    return rt.get([f.remote(i, b=2, c=3) for i in range(20)])


def p_put_get_numpy(rt):
    arr = np.random.default_rng(0).random(300_000)

    @rt.remote
    def total(x):
        return float(np.sum(x)), x.dtype.str, x.shape

    ref = rt.put(arr)
    return (np.array_equal(rt.get(ref), arr), rt.get(total.remote(ref)))


def p_num_returns(rt):
    @rt.remote(num_returns=3)
    def three():
        return 1, 2, 3

    @rt.remote
    def pair():
        return ("x", "y")

    a, b = pair.options(num_returns=2).remote()
    return rt.get(list(three.remote())), rt.get(a), rt.get(b)


def p_wait_then_cancel(rt):
    @rt.remote
    def sleepy(t):
        time.sleep(t)
        return t

    fast, slow = sleepy.remote(0.0), sleepy.remote(60.0)
    ready, rest = rt.wait([fast, slow], num_returns=1, timeout=30)
    seen = (ready == [fast], rest == [slow])
    rt.cancel(slow, force=True)
    return seen, rt.get(slow, timeout=30)


def p_wait_none_ready(rt):
    @rt.remote
    def forever():
        time.sleep(60)

    ref = forever.remote()
    ready, rest = rt.wait([ref], num_returns=1, timeout=0.2)
    rt.cancel(ref, force=True)
    return len(ready), len(rest)


def p_nested_submission(rt):
    @rt.remote
    def leaf(x):
        return x * 2

    @rt.remote
    def branch(x):
        return rt.get(leaf.remote(x)) + 1

    return rt.get(branch.remote(10))


def p_nested_refs(rt):
    @rt.remote
    def make():
        return 7

    @rt.remote
    def deref(d):
        return rt.get(d["ref"]) + rt.get(d["more"][0])

    return rt.get(deref.remote({"ref": make.remote(),
                                "more": [rt.put(5)]}))


def p_error_cause(rt):
    @rt.remote
    def fail():
        raise KeyError("missing-thing")

    return rt.get(fail.remote())


def p_error_through_dependency(rt):
    @rt.remote
    def fail():
        raise ValueError("upstream")

    @rt.remote
    def consume(x):
        return x

    return rt.get(consume.remote(fail.remote()))


def p_get_timeout(rt):
    @rt.remote
    def slow():
        time.sleep(60)

    ref = slow.remote()
    try:
        return rt.get(ref, timeout=0.2)
    finally:
        rt.cancel(ref, force=True)


def p_actor_ordering(rt):
    @rt.remote
    class Log:
        def __init__(self, start):
            self.items = [start]

        def append(self, x):
            self.items.append(x)

        def get_items(self):
            return self.items

    log = Log.remote(-1)
    for i in range(50):
        log.append.remote(i)
    out = rt.get(log.get_items.remote())
    rt.kill(log)
    return out


def p_named_actor(rt):
    @rt.remote
    class Registry:
        def __init__(self):
            self.d = {}

        def put_item(self, k, v):
            self.d[k] = v

        def get_item(self, k):
            return self.d.get(k)

    a = Registry.options(name="reg-test").remote()
    h = rt.get_actor("reg-test")
    rt.get(h.put_item.remote("k", 42))
    out = rt.get(a.get_item.remote("k"))
    rt.kill(a)
    return out


def p_actor_handle_in_task(rt):
    @rt.remote
    class Sink:
        def __init__(self):
            self.total = 0

        def add(self, n):
            self.total += n
            return self.total

    @rt.remote
    def feeder(sink, n):
        return rt.get(sink.add.remote(n))

    sink = Sink.remote()
    rt.get([feeder.remote(sink, i) for i in range(5)])
    out = rt.get(sink.add.remote(0))
    rt.kill(sink)
    return out


def p_actor_method_error(rt):
    @rt.remote
    class Bad:
        def fail(self):
            raise RuntimeError("actor-task-error")

        def ok(self):
            return "fine"

    bad = Bad.remote()
    try:
        rt.get(bad.fail.remote())
    except Exception as e:  # noqa: BLE001 — the error is the result
        first = (type(e).__name__, type(e.cause).__name__)
    out = (first, rt.get(bad.ok.remote()))
    rt.kill(bad)
    return out


def p_actor_constructor_error(rt):
    @rt.remote
    class Broken:
        def __init__(self):
            raise ValueError("ctor-boom")

        def m(self):
            return 1

    return rt.get(Broken.remote().m.remote(), timeout=30)


def p_kill_actor(rt):
    @rt.remote
    class Victim:
        def ping(self):
            return "pong"

    v = Victim.remote()
    assert rt.get(v.ping.remote()) == "pong"
    rt.kill(v)
    return rt.get(v.ping.remote(), timeout=30)


def p_actor_restart(rt):
    @rt.remote(max_restarts=1)
    class Phoenix:
        def __init__(self):
            self.calls = 0

        def pid(self):
            self.calls += 1
            return os.getpid(), self.calls

        def crash(self):
            os._exit(1)

    p = Phoenix.remote()
    pid1, n1 = rt.get(p.pid.remote())
    p.crash.remote()
    # the call buffers through the restart and runs on the new process,
    # whose state starts afresh
    pid2, n2 = rt.get(p.pid.remote(), timeout=60)
    rt.kill(p)
    return pid2 != pid1, n1, n2


def p_free_then_get(rt):
    ref = rt.put(np.zeros(4 << 20, np.uint8))
    freed = (rt.free(ref), rt.free(ref))
    try:
        rt.get(ref, timeout=10)
    except rt.exceptions.ObjectLostError as e:
        return freed, type(e).__name__, "freed" in str(e)


def p_zero_copy_numpy(rt):
    arr = np.arange(1_000_000, dtype=np.float32)
    out = rt.get(rt.put(arr))
    return out.base is not None, out.flags.writeable, np.array_equal(out, arr)


def _store_module(rt):
    import importlib

    return (importlib.import_module(rt.__name__ + ".core.object_store.store"),
            importlib.import_module(rt.__name__ + ".core.ids"))


def p_store_lifecycle(rt):
    st, ids = _store_module(rt)
    s = st.ShmObjectStore.create(
        f"/rtst_{os.getpid()}_{os.urandom(4).hex()}", 32 << 20)
    try:
        oid = ids.ObjectID.from_random()
        dst = s.create_object(oid, 128)
        unsealed = s.contains(oid)
        dst[:] = b"x" * 128
        s.seal(oid)
        sealed = s.contains(oid)
        try:
            s.create_object(oid, 10)
            dup = None
        except st.ObjectStoreFullError as e:
            dup = type(e).__name__
        client = st.ShmObjectStore.connect(s.name)
        mv = client.get(oid, timeout_ms=1000)
        data = bytes(mv)
        mv.release()
        client.release(oid)
        client.close()
        s.delete(oid)
        return unsealed, sealed, dup, data, s.contains(oid)
    finally:
        s.close()


def p_store_eviction(rt):
    st, ids = _store_module(rt)
    s = st.ShmObjectStore.create(
        f"/rtst_{os.getpid()}_{os.urandom(4).hex()}", 32 << 20)
    try:
        pinned = ids.ObjectID.from_random()
        s.put(pinned, b"p" * (1 << 20))
        mv = s.get(pinned, timeout_ms=1000)
        oids = []
        for i in range(40):  # 40 MB into a 32 MB store
            oid = ids.ObjectID.from_random()
            s.put(oid, bytes([i]) * (1 << 20))
            oids.append(oid)
        out = (s.stats()["evictions"] > 0, s.contains(oids[0]),
               s.contains(oids[-1]), s.contains(pinned), bytes(mv[:1]))
        mv.release()
        s.release(pinned)
        return out
    finally:
        s.close()


def p_store_too_large(rt):
    st, ids = _store_module(rt)
    s = st.ShmObjectStore.create(
        f"/rtst_{os.getpid()}_{os.urandom(4).hex()}", 32 << 20)
    try:
        s.create_object(ids.ObjectID.from_random(), 1 << 30)
    finally:
        s.close()


def p_store_get_timeout(rt):
    st, ids = _store_module(rt)
    s = st.ShmObjectStore.create(
        f"/rtst_{os.getpid()}_{os.urandom(4).hex()}", 32 << 20)
    try:
        s.get(ids.ObjectID.from_random(), timeout_ms=50)
    finally:
        s.close()


PROGRAMS = [p_task_chain, p_get_list_and_kwargs, p_put_get_numpy,
            p_num_returns, p_wait_then_cancel, p_wait_none_ready,
            p_nested_submission, p_nested_refs, p_error_cause,
            p_error_through_dependency, p_get_timeout, p_actor_ordering,
            p_named_actor, p_actor_handle_in_task, p_actor_method_error,
            p_actor_constructor_error, p_kill_actor, p_actor_restart,
            p_free_then_get, p_zero_copy_numpy, p_store_lifecycle,
            p_store_eviction, p_store_too_large, p_store_get_timeout]


def _outcome(prog, rt):
    try:
        return ("ok", prog(rt))
    except Exception as e:  # noqa: BLE001 — the error is the result
        cause = getattr(e, "cause", None)
        return ("raised", type(e).__name__,
                type(cause).__name__ if isinstance(cause, BaseException)
                else None)


@pytest.mark.parametrize("prog", PROGRAMS, ids=lambda p: p.__name__[2:])
def test_same_program_same_result(pkgs, prog):
    want = _outcome(prog, ray_tpu)
    got = _outcome(prog, ray_tpu_torch)
    assert got == want


def test_programs_raise_what_the_reference_raises(pkgs):
    """The error programs do raise (so the parity above is not two
    equal successes)."""
    want = {p_error_cause: ("raised", "TaskError", "KeyError"),
            p_error_through_dependency: ("raised", "TaskError",
                                         "ValueError"),
            p_get_timeout: ("raised", "GetTimeoutError", None),
            p_kill_actor: ("raised", "ActorDiedError", None),
            p_store_too_large: ("raised", "ObjectStoreFullError", None),
            p_store_get_timeout: ("raised", "ObjectTimeoutError", None)}
    for prog, out in want.items():
        assert _outcome(prog, ray_tpu_torch) == out, prog.__name__


# ------------------------------------------------------------ port only


def _in_store(t: "torch.Tensor") -> bool:
    from ray_tpu_torch.core import runtime_context

    mv = runtime_context.get_core().store._mv
    base = ctypes.addressof(ctypes.c_uint8.from_buffer(mv))
    return base <= t.data_ptr() and \
        t.data_ptr() + t.numel() * t.element_size() <= base + mv.nbytes


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_tensor_roundtrip_is_exact_and_zero_copy(pkgs, dtype):
    rt = ray_tpu_torch
    g = torch.Generator().manual_seed(3)
    t = torch.randn(256, 1024, generator=g).to(dtype)   # 0.5 / 1 MiB
    out = rt.get(rt.put(t))
    assert out.dtype == dtype and out.shape == t.shape
    assert torch.equal(out.view(torch.int16 if dtype == torch.bfloat16
                                else torch.int32),
                       t.view(torch.int16 if dtype == torch.bfloat16
                              else torch.int32))
    assert _in_store(out)

    @rt.remote
    def double(x):
        return x.dtype, x * 2

    got_dtype, doubled = rt.get(double.remote(t))
    assert got_dtype == dtype and torch.equal(doubled, t * 2)
    # a non-contiguous view and a small (inline) tensor take the same path
    assert torch.equal(rt.get(rt.put(t.t())), t.t())
    small = t[:2, :3]
    assert torch.equal(rt.get(rt.put(small)), small)


def test_runtime_imports_no_torch():
    code = ("import sys, ray_tpu_torch; ray_tpu_torch.init(num_workers=1, "
            "object_store_memory=32 << 20)\n"
            "@ray_tpu_torch.remote\n"
            "def f():\n"
            "    import sys; return 'torch' in sys.modules\n"
            "print('torch' in sys.modules, ray_tpu_torch.get(f.remote()), "
            "'jax' in sys.modules)\n"
            "ray_tpu_torch.shutdown()\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert out.stdout.split() == ["False", "False", "False"]


def test_serialize_while_another_thread_imports_torch(monkeypatch):
    """A value is pickled while another thread is still importing torch
    (a Train worker's result sent as its loop's first ``import torch``
    runs): ``sys.modules`` then holds a half-built torch with no
    ``strided``, and the tensor reducer must wait for the finished
    module, not raise (the call's result and its error were both lost,
    and the caller waited forever)."""
    import types
    from importlib.machinery import ModuleSpec

    from ray_tpu_torch.core import serialization

    half = types.ModuleType("torch")
    half.__spec__ = ModuleSpec("torch", None)
    half.__spec__._initializing = True
    monkeypatch.setitem(sys.modules, "torch", half)
    monkeypatch.setattr(serialization, "_torch_uint8", None)
    monkeypatch.setattr(serialization, "_torch_strided", None)
    monkeypatch.setattr(serialization._Pickler, "dispatch_table",
                        serialization._Pickler.dispatch_table)
    assert serialization.loaded_torch() is None
    assert serialization.unpack(serialization.pack({"a": [1, 2]})) == \
        {"a": [1, 2]}
    assert serialization._torch_uint8 is None


def test_listener_queues_a_burst_of_worker_connects():
    """Workers cold-spawned together connect at once, two connections
    each, before the accept loop takes any: the driver's socket queues
    them. A full queue refuses a non-blocking connect with EAGAIN (under
    gVisor a blocking one too, and the worker dies before its hello); at
    ``Listener``'s default backlog of 1 the third connect here is
    refused."""
    import socket

    from ray_tpu_torch.core import runtime as rtm

    path = os.path.join(tempfile.mkdtemp(prefix="rtpt_listen_"), "s")
    lst = rtm.listen(path)
    socks = []
    try:
        for _ in range(64):
            s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            socks.append(s)
            s.setblocking(False)
            s.connect(path)   # BlockingIOError once the queue is full
    finally:
        for s in socks:
            s.close()
        lst.close()
        shutil.rmtree(os.path.dirname(path), ignore_errors=True)


def test_worker_that_connects_before_its_spawner_returns():
    """A zygote fork can say hello before the spawning thread has run
    again (a loaded host); the runtime must already know its id, or it
    drops the connection and the worker dies. The spawner is slowed here
    after the fork to make the race certain."""
    code = ("import time, ray_tpu_torch as rt\n"
            "from ray_tpu_torch.core import runtime as R\n"
            "orig = R._ForkedProc.__init__\n"
            "def slow(self, pid):\n"
            "    time.sleep(0.3)\n"
            "    orig(self, pid)\n"
            "R._ForkedProc.__init__ = slow\n"
            "rt.init(num_workers=2, object_store_memory=32 << 20)\n"
            "@rt.remote\n"
            "def f(x):\n"
            "    return x + 1\n"
            "print(rt.get([f.remote(i) for i in range(4)], timeout=60))\n"
            "rt.shutdown()\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert out.stdout.split("\n")[0] == "[1, 2, 3, 4]"


def test_host_without_pidfd_cold_spawns_workers():
    """Without ``os.pidfd_open`` a zygote fork cannot be watched (every
    fork would read as dead at once): the runtime then starts no zygote
    and cold-spawns its workers, and tasks and actors run."""
    code = ("import os, ray_tpu_torch as rt\n"
            "def nopidfd(pid, flags=0):\n"
            "    raise OSError(38, 'Function not implemented')\n"
            "os.pidfd_open = nopidfd\n"
            "rt.init(num_workers=2, object_store_memory=32 << 20)\n"
            "from ray_tpu_torch.core import runtime_context\n"
            "assert runtime_context.get_core()._zygote is None\n"
            "@rt.remote\n"
            "def f(x):\n"
            "    return x + 1\n"
            "@rt.remote\n"
            "class A:\n"
            "    def m(self):\n"
            "        return 'ok'\n"
            "print(rt.get([f.remote(i) for i in range(4)], timeout=60),\n"
            "      rt.get(A.remote().m.remote(), timeout=60))\n"
            "rt.shutdown()\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert out.stdout.split("\n")[0] == "[1, 2, 3, 4] ok"


_ZYGOTE_ACTOR = (
    "import os, sys, time, ray_tpu_torch as rt\n"
    "from ray_tpu_torch.core import runtime_context\n"
    "rt.init(num_workers=1, object_store_memory=32 << 20)\n"
    "core = runtime_context.get_core()\n"
    "@rt.remote\n"
    "class A:\n"
    "    def where(self):\n"
    "        return os.getpid(), os.getppid()\n"
    "a = A.remote()\n"
    "pid, ppid = rt.get(a.where.remote(), timeout=60)\n"
    "assert ppid == core._zygote.pid, (ppid, core._zygote.pid)\n"
    "print(pid, flush=True)\n"
    "if sys.argv[1] == 'zygote':\n"
    "    core._zygote.kill()\n"
    "    core._zygote.wait()\n"
    "    time.sleep(1.5)\n"
    "    print(rt.get(a.where.remote(), timeout=60)[0], flush=True)\n"
    "    rt.shutdown()\n"
    "else:\n"
    "    time.sleep(600)\n")


def test_zygote_fork_outlives_a_killed_zygote():
    """The runtime kills a zygote it finds wedged and starts another; the
    workers that zygote forked watch the runtime's process, not their
    parent, and an actor on one keeps answering."""
    out = subprocess.run([sys.executable, "-c", _ZYGOTE_ACTOR, "zygote"],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120, check=True)
    before, after = out.stdout.split()[:2]
    assert before == after


def test_zygote_fork_exits_with_its_runtime():
    """A zygote's fork exits once the process that runs its runtime is
    SIGKILLed, though its own parent, the zygote, is not the one that
    died."""
    proc = subprocess.Popen([sys.executable, "-c", _ZYGOTE_ACTOR, "owner"],
                            cwd=ROOT, stdout=subprocess.PIPE, text=True)
    try:
        pid = int(proc.stdout.readline())
        born = _stat(pid)[19]  # the start time tells a reused pid apart
        proc.kill()
        proc.wait()
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            st = _stat(pid)
            if not st or st[19] != born or st[0] == "Z":
                break
            time.sleep(0.1)
        else:
            os.kill(pid, 9)
            raise AssertionError(f"worker {pid} outlived its runtime")
    finally:
        proc.kill()
        proc.wait()


def _stat(pid: int) -> list:
    """``/proc/<pid>/stat``'s fields after the command (the state first),
    or [] once the process is gone."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()
    except OSError:
        return []


@pytest.mark.parametrize("tmpdir_len", ["short", "long"])
def test_session_files_stay_under_tmpdir(tmp_path, tmpdir_len):
    """The session's directory, logs, socket and spill directory lie
    under ``tempfile.gettempdir()`` and go at shutdown. A TMPDIR too long
    for an AF_UNIX path puts the socket in the abstract namespace. The
    short directory is short by construction (made under ``/tmp``, not
    under pytest's base directory, whose length varies)."""
    if tmpdir_len == "short":
        tmp = Path(tempfile.mkdtemp(prefix="t", dir="/tmp"))
        made_here = True
    else:
        tmp = tmp_path / ("t" * 100)
        tmp.mkdir()
        made_here = False
    code = ("import os, tempfile, ray_tpu_torch as rt\n"
            "from ray_tpu_torch.core import runtime_context\n"
            "rt.init(num_workers=1, object_store_memory=32 << 20)\n"
            "core = runtime_context.get_core()\n"
            "tmp = tempfile.gettempdir()\n"
            "@rt.remote\n"
            "def f(x):\n"
            "    import tempfile\n"
            "    return x + 1, tempfile.gettempdir()\n"
            "print(rt.get(f.remote(1), timeout=60) == (2, tmp),\n"
            "      os.path.isdir(core.log_dir),\n"
            "      core.log_dir.startswith(tmp + os.sep),\n"
            "      core._spill_dir.startswith(tmp + os.sep),\n"
            "      core._sock_path.startswith(tmp + os.sep))\n"
            "rt.shutdown()\n"
            "print([n for n in os.listdir(tmp) if n != 'rtpt_spill'])\n")
    try:
        out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                             env=dict(os.environ, TMPDIR=str(tmp)),
                             capture_output=True, text=True, timeout=120,
                             check=True)
    finally:
        if made_here:
            shutil.rmtree(tmp, ignore_errors=True)
    sock_in_tmp = "True" if tmpdir_len == "short" else "False"
    assert out.stdout.split("\n")[:2] == [
        f"True True True True {sock_in_tmp}", "[]"]


_CANCEL_BATCHED = """
import os, sys, time
import ray_tpu_torch as rt
from ray_tpu_torch.core import runtime_context
from ray_tpu_torch.exceptions import TaskCancelledError

d, when = sys.argv[1], sys.argv[2]
rt.init(num_workers=1, object_store_memory=32 << 20)


def wait_for(path):
    while not os.path.exists(path):
        time.sleep(0.01)


@rt.remote
def hold(gate):
    wait_for(gate)
    return 0


@rt.remote
def first(gate, slow_tail):
    if slow_tail:
        # this task's clean-up, after its result is sent, lingers, so the
        # SIGINT the driver sends when the task behind becomes the head
        # lands there
        from ray_tpu_torch.core import worker_proc

        restore = worker_proc._re_restore

        def restore_then_linger(saved):
            worker_proc._re_restore = restore
            restore(saved)
            time.sleep(1.0)

        worker_proc._re_restore = restore_then_linger
    wait_for(gate)
    return os.getpid()


@rt.remote
def whoami():
    return os.getpid()


@rt.remote
def second(out):
    for _ in range(100):
        time.sleep(0.02)
    open(out, "w").close()
    return 2


h = hold.remote(os.path.join(d, "g0"))
a = first.remote(os.path.join(d, "g1"), when == "while_first_cleans_up")
b = second.remote(os.path.join(d, "done"))
open(os.path.join(d, "g0"), "w").close()   # a and b leave as one batch
core = runtime_context.get_core()
deadline = time.monotonic() + 30
while time.monotonic() < deadline:
    batched = [len(w.inflight) for w in core._workers.values()]
    if 2 in batched:
        break
    time.sleep(0.01)
assert rt.get(h, timeout=30) == 0
if when in ("while_first_runs", "while_first_cleans_up"):
    rt.cancel(b)
open(os.path.join(d, "g1"), "w").close()
pid = rt.get(a, timeout=30)
if when == "after_first_finished":
    rt.cancel(b)
try:
    rt.get(b, timeout=30)
    outcome = "returned"
except TaskCancelledError:
    outcome = "cancelled"
time.sleep(2.5)   # past second()'s whole run had it not been stopped
same_worker = rt.get(whoami.remote(), timeout=30) == pid
print(batched, outcome, os.path.exists(os.path.join(d, "done")), same_worker)
rt.shutdown()
"""


@pytest.mark.parametrize("when", ["while_first_runs", "after_first_finished",
                                  "while_first_cleans_up"])
def test_cancel_stops_a_task_batched_behind_another(tmp_path, when):
    """``cancel`` without ``force`` of the second task of a pipelined
    batch, issued while the first runs or after it has finished: the
    second never reaches its end (the file it writes last never appears)
    and ``get`` raises TaskCancelledError, and the worker lives on. In
    ``while_first_cleans_up`` the first task's clean-up after its result
    is sent lingers, so the SIGINT the driver sends when the second
    becomes the head lands there: it must neither end the worker nor be
    lost. ``ray_tpu`` lets the task run to its end in the first case
    (ROADMAP.md section 3)."""
    out = subprocess.run([sys.executable, "-c", _CANCEL_BATCHED,
                          str(tmp_path), when], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert out.stdout.split("\n")[0] == "[2] cancelled False True"


def test_every_flag_row_has_a_reader():
    """Each row of the port's flag table is read by port code: setting
    an ``RTPU_*`` variable of the table always changes something."""
    from ray_tpu_torch.core import config as config_mod

    table = Path(config_mod.__file__).resolve()
    src = "\n".join(p.read_text()
                    for p in (ROOT / "ray_tpu_torch").rglob("*.py")
                    if p.resolve() != table)
    unread = [f.name for f in config_mod.flags()
              if f"config.{f.name}" not in src and f.env_var not in src]
    assert unread == []


def test_refusals_name_their_slice(pkgs):
    """``init(address=...)`` with no GCS (and ``"ray://..."`` with no
    proxy) behind the address raises the reference's typed connect
    errors, with nothing initialised; the compiled-DAG entry points run,
    and a socket descriptor (a cross-node edge) is no longer refused: it
    opens a reader that publishes its port in the runtime's KV."""
    from ray_tpu_torch.core import runtime_context

    code = ("import {pkg} as rt\n"
            "for addr in ('127.0.0.1:1', 'ray://127.0.0.1:1'):\n"
            "    try:\n"
            "        rt.init(address=addr)\n"
            "    except Exception as e:\n"
            "        print(type(e).__name__, isinstance(\n"
            "            e, __import__('{pkg}.core.cluster.rpc',\n"
            "                          fromlist=['x']).RpcError))\n"
            "print(rt.is_initialized())\n")
    env = dict(os.environ, RTPU_CLUSTER_AUTHKEY="00112233",
               RTPU_GCS_RECONNECT_TIMEOUT_S="1", JAX_PLATFORMS="cpu")
    procs = [subprocess.Popen([sys.executable, "-c", code.format(pkg=pkg)],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for pkg in ("ray_tpu", "ray_tpu_torch")]
    outs = [p.communicate(timeout=120)[0].split("\n")[:3] for p in procs]
    assert outs[1] == outs[0] == ["GcsUnavailableError True",
                                  "RpcError True", "False"]

    @ray_tpu_torch.remote
    class Stage:
        def ping(self):
            return "pong"

    a = Stage.remote()
    assert ray_tpu_torch.get(a.ping.remote()) == "pong"
    core = runtime_context.get_core()
    ref = core.submit_actor_task(a.actor_id, "__rtpu_dag_devinfo__", (), {},
                                 1)[0]
    pid, is_gpu = ray_tpu_torch.get(ref, timeout=30)
    assert pid != os.getpid() and is_gpu is False
    from ray_tpu_torch.dag.channel import open_endpoint

    ch = open_endpoint(("sock", "0123", "127.0.0.1"), kv=core.kv_op,
                       role="reader", authkey=core._authkey)
    assert isinstance(core.kv_op("get", "dagchan:0123"), int)
    ch.release()
    assert core.kv_op("get", "dagchan:0123") is None
    assert ray_tpu_torch.get(a.ping.remote()) == "pong"
    ray_tpu_torch.kill(a)
