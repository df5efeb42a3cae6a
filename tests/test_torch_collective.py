"""The port's host collectives against ``ray_tpu``'s.

Each program runs in this process through ``ray_tpu`` (the reference)
and through ``ray_tpu_torch``, each on its own runtime: three member
actors of a package join a ``host`` group and run every op on the same
numpy inputs (allreduce sum/prod/min/max below and above the ring
threshold, allgather, reducescatter, broadcast, barrier, send/recv); the
results must be equal. The port's members then run the ops on torch
tensors (float32 against the reference's float32 numpy results, bit for
bit; bf16, which numpy cannot hold, against the reduction in rank
order), and a two-worker gang holds the ``torch`` backend (gloo over the
gang's default group) to the ``host`` backend's results. The tests of
``tests/test_parallel.py`` and ``tests/test_fault_tolerance.py`` that
cover the host group are ported as they are.
"""

import os
import time

import numpy as np
import pytest

import ray_tpu
import ray_tpu_torch

torch = pytest.importorskip("torch")

from ray_tpu.parallel import collective as ref_col  # noqa: E402
from ray_tpu_torch.parallel import collective as port_col  # noqa: E402

WORLD = 3
SMALL, LARGE = 1000, 200_000   # float64: 8 KB (star) and 1.6 MB (ring)


@pytest.fixture(scope="module")
def pkgs():
    ray_tpu.init(num_workers=4, object_store_memory=128 << 20)
    ray_tpu_torch.init(num_workers=4, object_store_memory=128 << 20)
    try:
        yield {"ref": (ray_tpu, ref_col), "port": (ray_tpu_torch, port_col)}
    finally:
        ray_tpu_torch.shutdown()
        ray_tpu.shutdown()


def _member_cls(rt, col):
    @rt.remote
    class Member:
        def __init__(self, world, rank, name):
            self.group = col.init_collective_group(
                world, rank, backend="host", group_name=name)

        def run(self, op, x, arg=None):
            g = self.group
            if op == "allreduce":
                return g.allreduce(x, arg)
            if op == "allgather":
                return g.allgather(x)
            if op == "reducescatter":
                return g.reducescatter(x, arg)
            if op == "broadcast":
                return g.broadcast(x, src_rank=arg)
            if op == "barrier":
                g.barrier()
                return g.rank
            if op == "sendrecv":
                if g.rank == 0:
                    g.send(x, dst_rank=g.world_size - 1, tag=arg)
                    return None
                if g.rank == g.world_size - 1:
                    return g.recv(src_rank=0, tag=arg)
                return None
            raise ValueError(op)

        def close(self):
            col.destroy_collective_group(self.group.name)

    return Member


def _members(rt, col, name):
    cls = _member_cls(rt, col)
    return [cls.remote(WORLD, r, name) for r in range(WORLD)]


def _run(rt, members, op, xs, arg=None):
    return rt.get([m.run.remote(op, x, arg) for m, x in zip(members, xs)],
                  timeout=120)


def _inputs(seed, n, dtype=np.float64):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(n).astype(dtype) for _ in range(WORLD)]


OPS = [("allreduce", op, n) for op in ("sum", "prod", "min", "max")
       for n in (SMALL, LARGE)]
OPS += [("allgather", None, SMALL), ("reducescatter", "sum", SMALL),
        ("reducescatter", "max", LARGE), ("broadcast", 1, SMALL),
        ("barrier", None, SMALL), ("sendrecv", 7, SMALL)]


def _equal(a, b):
    if isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    elif a is None or isinstance(a, int):
        assert a == b
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert np.asarray(a).dtype == np.asarray(b).dtype


def test_host_ring_allreduce_matches_star(pkgs):
    """Large payloads take the ring path (peer-to-peer chunk refs); the
    result must match the star path exactly, in both packages. First in
    the file: on a pool that actors drained, ``ray_tpu``'s dispatcher can
    batch the three members onto one worker, where they wait on each
    other forever (ROADMAP.md section 3; the port's dispatcher counts
    the workers it owes, ``test_rendezvous_tasks_on_a_drained_pool``)."""
    outs = {}
    for key, (rt, col) in pkgs.items():
        @rt.remote
        def member(rank, world, n):
            import numpy as np

            g = col.init_collective_group(world, rank,
                                          group_name=f"ring{world}")
            arr = np.arange(n, dtype=np.float64) * (rank + 1)
            out = g.allreduce(arr, op="sum")
            col.destroy_collective_group(f"ring{world}")
            return out[:5], float(out.sum())

        world, n = 3, 300_000  # 2.4MB > ring threshold
        outs[key] = rt.get([member.remote(r, world, n)
                            for r in range(world)], timeout=120)
        base = np.arange(n, dtype=np.float64)
        expect = base * (1 + 2 + 3)
        for head, total in outs[key]:
            np.testing.assert_allclose(head, expect[:5])
            assert abs(total - expect.sum()) < 1e-6
        col.destroy_coordinator(f"ring{world}")
    _equal([list(o) for o in outs["port"]], [list(o) for o in outs["ref"]])


def test_host_ops_match_reference(pkgs):
    """Every op on the same numpy inputs through both packages' host
    groups: equal results on every rank."""
    got = {}
    for key, (rt, col) in pkgs.items():
        members = _members(rt, col, "ops")
        got[key] = [_run(rt, members, name, _inputs(i, n), arg)
                    for i, (name, arg, n) in enumerate(OPS)]
        rt.get([m.close.remote() for m in members])
        for m in members:
            rt.kill(m)
        col.destroy_coordinator("ops")
    for (name, arg, n), ref, port in zip(OPS, got["ref"], got["port"]):
        assert type(port) is type(ref)
        _equal(port, ref)
    # and they are the right answers
    xs = _inputs(0, SMALL)
    np.testing.assert_array_equal(got["port"][0][2], xs[0] + xs[1] + xs[2])


def _bf16_reduce(ts, op):
    out = ts[0].clone()
    for t in ts[1:]:
        out = {"sum": out + t, "prod": out * t,
               "min": torch.minimum(out, t),
               "max": torch.maximum(out, t)}[op]
    return out


def test_host_ops_on_tensors(pkgs):
    """Torch tensors in, tensors of the same dtype out. float32 gives
    the reference's float32 numpy results bit for bit (star and ring);
    bf16 the reduction in rank order (star) and exact integer sums
    (ring)."""
    rt, col = pkgs["port"]
    rref, rcol = pkgs["ref"]
    members = _members(rt, col, "tensors")
    refs = _members(rref, rcol, "tensors")
    try:
        for i, (name, arg, n) in enumerate(OPS):
            xs = _inputs(100 + i, n, np.float32)
            want = _run(rref, refs, name, xs, arg)
            got = _run(rt, members, name, [torch.from_numpy(x) for x in xs],
                       arg)
            for g, w in zip(got, want):
                if isinstance(w, list):
                    assert all(isinstance(t, torch.Tensor)
                               and t.dtype == torch.float32 for t in g)
                    _equal([t.numpy() for t in g], w)
                elif isinstance(w, np.ndarray):
                    assert isinstance(g, torch.Tensor)
                    assert g.dtype == torch.float32 and g.device.type == "cpu"
                    _equal(g.numpy(), w)
                else:
                    assert g == w
        # bf16, which never goes through numpy
        for op in ("sum", "prod", "min", "max"):
            ts = [torch.from_numpy(x).to(torch.bfloat16)
                  for x in _inputs(7, SMALL, np.float32)]
            got = _run(rt, members, "allreduce", ts, op)
            want = _bf16_reduce(ts, op)
            for g in got:
                assert g.dtype == torch.bfloat16
                assert torch.equal(g, want), op
        big = [torch.from_numpy(np.random.default_rng(r).integers(
            -8, 9, 600_000)).to(torch.bfloat16) for r in range(WORLD)]
        got = _run(rt, members, "allreduce", big, "sum")
        want = (big[0].float() + big[1].float() + big[2].float()).to(
            torch.bfloat16)
        for g in got:   # 1.2 MB: the ring
            assert g.dtype == torch.bfloat16 and torch.equal(g, want)
        ts = [torch.full((4, 3), float(r), dtype=torch.bfloat16)
              for r in range(WORLD)]
        gathered = _run(rt, members, "allgather", ts)
        for g in gathered:
            assert [float(t[0, 0]) for t in g] == [0.0, 1.0, 2.0]
            assert all(t.dtype == torch.bfloat16 for t in g)
        got = _run(rt, members, "sendrecv", ts, 3)
        assert got[0] is None and torch.equal(got[-1], ts[0])
    finally:
        for pkg, ms, c in ((rt, members, col), (rref, refs, rcol)):
            for m in ms:
                pkg.kill(m)
            c.destroy_coordinator("tensors")


def test_xla_backend_names_torch():
    with pytest.raises(ValueError, match="'torch'"):
        port_col.CollectiveGroup("g", 2, 0, backend="xla")
    with pytest.raises(ValueError, match="'host' or 'torch'"):
        port_col.CollectiveGroup("g", 2, 0, backend="nccl")


def _torch_vs_host_loop(config):
    import numpy as np
    import torch
    import torch.distributed as dist

    from ray_tpu_torch import train
    from ray_tpu_torch.parallel import collective

    ctx = train.get_context()
    rank, world = ctx.get_world_rank(), ctx.get_world_size()
    dev = collective.init_collective_group(world, rank, backend="torch",
                                           group_name="dev")
    host = collective.get_group("train")
    x = np.random.default_rng(rank).standard_normal(1000)
    t = torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    out = {"world": dist.get_world_size(), "backend": dist.get_backend()}
    for op in ("sum", "prod", "min", "max"):
        a, b = dev.allreduce(x, op), host.allreduce(x, op)
        out[op] = isinstance(a, np.ndarray) and bool(np.array_equal(a, b))
        a, b = dev.allreduce(t, op), host.allreduce(t, op)
        out[f"{op}_bf16"] = a.dtype == torch.bfloat16 and bool(
            torch.equal(a, b))
    out["allgather"] = all(np.array_equal(a, b) for a, b in zip(
        dev.allgather(x), host.allgather(x)))
    out["reducescatter"] = bool(np.array_equal(dev.reducescatter(x),
                                               host.reducescatter(x)))
    out["broadcast"] = bool(np.array_equal(dev.broadcast(x, 1),
                                           host.broadcast(x, 1)))
    dev.barrier()
    out["sum_value"] = float(dev.allreduce(x)[0])
    train.report(out)


def test_torch_backend_gives_host_sums(pkgs, tmp_path):
    """A two-worker gang on gloo (``TorchConfig(device="cpu",
    distributed=True)``): every op of the ``torch`` backend gives the
    ``host`` backend's results, numpy and bf16."""
    from ray_tpu_torch import train

    res = train.TorchTrainer(
        _torch_vs_host_loop,
        torch_config=train.TorchConfig(device="cpu", distributed=True),
        scaling_config=train.ScalingConfig(num_workers=2),
        run_config=train.RunConfig(storage_path=str(tmp_path),
                                   name="dev")).fit()
    assert res.error is None, res.error
    m = res.metrics
    assert (m["world"], m["backend"]) == (2, "gloo")
    flags = {k: v for k, v in m.items() if isinstance(v, bool)}
    assert len(flags) == 11 and all(flags.values()), flags
    x = [np.random.default_rng(r).standard_normal(1000) for r in range(2)]
    assert m["sum_value"] == float(x[0][0] + x[1][0])


def test_host_collective_group_across_actors(pkgs):
    """tests/test_parallel.py's case, through both packages."""
    got = {}
    for key, (rt, col) in pkgs.items():
        @rt.remote
        class Member:
            def __init__(self, rank, world):
                self.group = col.init_collective_group(
                    world, rank, backend="host", group_name="t-ar")

            def do_allreduce(self, v):
                return self.group.allreduce(np.array([v], np.float32))

            def do_gather(self, v):
                return self.group.allgather(np.array([v]))

            def do_bcast(self, v):
                return self.group.broadcast(np.array([v]), src_rank=1)

            def do_sendrecv(self, v):
                if self.group.rank == 0:
                    self.group.send(np.array([v]), dst_rank=1, tag=7)
                    return None
                return self.group.recv(src_rank=0, tag=7)

        members = [Member.remote(i, 3) for i in range(3)]
        out = rt.get([m.do_allreduce.remote(float(i + 1))
                      for i, m in enumerate(members)], timeout=60)
        for o in out:
            np.testing.assert_array_equal(o, [6.0])
        gathered = rt.get([m.do_gather.remote(i)
                           for i, m in enumerate(members)], timeout=60)
        for g in gathered:
            assert [int(x[0]) for x in g] == [0, 1, 2]
        bc = rt.get([m.do_bcast.remote(i * 10)
                     for i, m in enumerate(members)], timeout=60)
        for b in bc:
            np.testing.assert_array_equal(b, [10])
        sr = rt.get([m.do_sendrecv.remote(99) for m in members[:2]],
                    timeout=60)
        assert sr[0] is None
        np.testing.assert_array_equal(sr[1], [99])
        got[key] = (out, gathered, bc, sr)
        for m in members:
            rt.kill(m)
        col.destroy_coordinator("t-ar")
    _equal(list(got["port"]), list(got["ref"]))


def test_collective_abort_unblocks_member_fast(pkgs, tmp_path):
    """A member blocked in an in-flight collective fails over to
    CollectiveAbortedError (naming the reason — here, the dead rank)
    within ~a poll interval of the abort, not the 120 s op timeout."""
    rt, col = pkgs["port"]
    ready = str(tmp_path / "member_ready")

    @rt.remote
    class Member:
        def run(self, world, rank, ready_path):
            import time as _time

            import numpy as np

            g = col.init_collective_group(world, rank, group_name="abrt")
            open(ready_path, "w").close()
            t0 = _time.monotonic()
            try:
                g.allreduce(np.ones(3))
            except col.CollectiveAbortedError as e:
                return _time.monotonic() - t0, str(e)
            return None, "allreduce completed?!"

    m = Member.remote()
    ref = m.run.remote(2, 0, ready)  # rank 1 never joins: the op blocks
    deadline = time.monotonic() + 30
    while not os.path.exists(ready) and time.monotonic() < deadline:
        time.sleep(0.01)
    assert os.path.exists(ready), "member never started"
    time.sleep(0.5)  # member is now blocked polling the coordinator
    t0 = time.monotonic()
    assert col.abort_group(
        "abrt", reason="gang resize: lost rank(s) [1] (ActorDiedError)")
    blocked_s, msg = rt.get(ref, timeout=30)
    unblock_s = time.monotonic() - t0
    assert unblock_s < 2.0, f"abort took {unblock_s:.2f}s to propagate"
    assert blocked_s >= 0.4, "member was not actually blocked"
    assert "lost rank(s) [1]" in msg and "'abrt'" in msg
    # a second abort on the same group is idempotent; a missing group
    # reports False instead of raising
    assert col.abort_group("abrt", reason="again")
    assert not col.abort_group("no_such_group")
    rt.kill(m)
    col.destroy_coordinator("abrt")


def test_rendezvous_tasks_on_a_drained_pool(pkgs):
    """Actors take pool workers, which the runtime replaces only when
    queued work finds the pool empty. Three default tasks that meet in a
    host group must still run side by side, not batched onto the one
    idle worker behind each other."""
    from ray_tpu_torch.core import runtime_context

    rt, col = pkgs["port"]

    @rt.remote
    class Hog:
        def ping(self):
            return os.getpid()

    core = runtime_context.get_core()

    def pool():
        with core._lock:
            return core._pool_deficit, sum(
                1 for w in core._workers.values()
                if w.alive and w.actor_id is None and w.env_key is None)

    @rt.remote
    def busy(t):
        time.sleep(t)
        return t

    @rt.remote
    def member(rank, world, name):
        import numpy as np

        g = col.init_collective_group(world, rank, group_name=name)
        out = g.allreduce(np.arange(300_000, dtype=np.float64) * (rank + 1))
        col.destroy_collective_group(name)
        return float(out[1])

    # Each round: actors take idle pool workers down to one, which a task
    # keeps busy, so the three members queue while the runtime spawns
    # back what it owes. Batched two to a worker they would wait on each
    # other; how the spawns interleave with the submissions varies, so
    # the scenario runs three times.
    for round_ in range(3):
        rt.get(busy.remote(0.0))   # an emptied pool refills one worker
        hogs = []
        while pool()[1] > 1 and len(hogs) < 16:
            hogs.append(Hog.remote())
            rt.get(hogs[-1].ping.remote(), timeout=60)
        for h in hogs:
            rt.kill(h)
        owed, alive = pool()
        assert alive == 1 and owed >= 2, (round_, alive, owed)
        held = busy.remote(1.0)
        time.sleep(0.2)
        name = f"drained{round_}"
        assert rt.get([member.remote(r, 3, name) for r in range(3)],
                      timeout=30) == [6.0] * 3, round_
        assert rt.get(held) == 1.0
        col.destroy_coordinator(name)
