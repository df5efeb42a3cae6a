"""Locality-aware scheduling and pull admission on the port against
``ray_tpu`` (``tests/test_locality.py``).

``test_port_*`` run that file's programs on the port, held to its own
assertions (``_torch_port_copy.py``), the locality counters and the
``state_summary`` lines read through ``ray_tpu_torch.state``.
``test_parity_*`` run the scorer's decisions through both packages.
"""

from __future__ import annotations

from tests._torch_port_copy import export, port_copy, ref_tests

_loc = port_copy("test_locality.py")
export(_loc, globals(), ref_tests(_loc), fixtures=["fake_cluster"])


def _picks(pkg):
    """The node index ``_pick_node`` chooses over a fixed scenario list
    on a GCS with three fake nodes (n3 alone has ``special``)."""
    gcs_mod = __import__(pkg + ".core.cluster.gcs", fromlist=["x"])
    rpc = __import__(pkg + ".core.cluster.rpc", fromlist=["x"])
    cc = __import__(pkg + ".core.cluster.cluster_core", fromlist=["x"])
    gcs = gcs_mod.GcsServer(authkey=b"k")
    c = rpc.RpcClient(gcs.address, b"k")
    addrs = [("127.0.0.1", 9001), ("127.0.0.1", 9002), ("127.0.0.1", 9003)]
    for i, res in enumerate(({"CPU": 4}, {"CPU": 4},
                             {"CPU": 4, "special": 1})):
        c.call(("register_node", bytes([49 + i]) * 16, addrs[i], res, {},
                {}))
    core = cc.ClusterCore(gcs.address, authkey=b"k")
    mb = 1 << 20
    scenarios = [
        ({"num_cpus": 1}, {b"d1": ([addrs[1]], 8 * mb)}),
        ({"num_cpus": 1}, {b"d1": ([addrs[0]], 8 * mb),
                           b"d2": ([addrs[2]], 9 * mb)}),
        ({"resources": {"special": 1}}, {b"d1": ([addrs[0]], 64 * mb)}),
        ({"num_cpus": 1}, {b"d1": ([addrs[1]], 1024)}),
        ({"num_cpus": 1}, {b"d1": ([addrs[0], addrs[1]], 8 * mb)}),
    ]
    try:
        out = [addrs.index(core._pick_node(dict(o), False, dep_locs=d))
               for o, d in scenarios]
        with core._lock:
            stats = dict(core.locality_stats)
        return out, stats
    finally:
        core.shutdown()
        c.close()
        gcs.close()


def test_parity_locality_picks():
    ref = _picks("ray_tpu")
    assert _picks("ray_tpu_torch") == ref
    assert ref[0][:3] == [1, 2, 2]


def test_parity_pull_admission_order():
    """Admission grants in priority order (task args > get > wait),
    FIFO within a class, in both packages."""
    out = []
    for pkg in ("ray_tpu", "ray_tpu_torch"):
        pm = __import__(pkg + ".core.cluster.pull_manager", fromlist=["x"])
        mgr = pm.PullManager(100)
        assert mgr.acquire(100, [pm.PRIO_GET], timeout=1.0)
        import threading

        order = []
        boxes = [[pm.PRIO_WAIT], [pm.PRIO_GET], [pm.PRIO_TASK_ARGS],
                 [pm.PRIO_GET]]

        def want(i):
            assert mgr.acquire(60, boxes[i], timeout=10.0)
            order.append(i)
            mgr.release(60)

        threads = []
        for i in range(len(boxes)):
            t = threading.Thread(target=want, args=(i,))
            t.start()
            threads.append(t)
            while mgr.stats()["queued"] < i + 1:
                pass
        mgr.release(100)
        for t in threads:
            t.join(10)
        out.append(order)
    assert out[1] == out[0] == [2, 1, 3, 0]
