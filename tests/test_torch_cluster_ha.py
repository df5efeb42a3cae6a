"""Head-node availability and planned removal on the port against
``ray_tpu``: GCS failover and ride-through (``test_ha.py``), WAL replay
(``test_wal_replay.py``), drain and gray-failure quarantine (the first
two tests of ``test_drain.py``; its autoscaler drill waits for the
port's ``autoscaler_v2``).

``test_port_*`` run those programs on the port, held to the reference
tests' own assertions (``_torch_port_copy.py``); the reference halves
are the reference's own tests. ``test_parity_*`` run one program
through both packages and compare what they return.
"""

from __future__ import annotations

from tests import test_wal_replay as ref_wal
from tests._torch_port_copy import export, port_copy, ref_tests

_ha = port_copy("test_ha.py")
export(_ha, globals(), ref_tests(_ha), fixtures=["cfg_env"])
_wal = port_copy("test_wal_replay.py")
export(_wal, globals(), ref_tests(_wal))
_drain = port_copy("test_drain.py")
export(_drain, globals(), ["test_drain_migrates_actors_and_loses_no_work",
                           "test_gray_failure_quarantine_and_probe_restore"])


def _tables(mod, persist_dir):
    """The GCS tables (``_comparable``) after ``mod``'s op mix, live and
    as a copy of its directory rehydrates them, without the epoch (a
    random incarnation id)."""
    gcs = mod.GcsServer(port=0, authkey=mod.KEY,
                        persistence_path=persist_dir)
    try:
        for op in mod._seed_ops():
            gcs._handle(op, {})
        live = mod._comparable(gcs)
        again = mod._reopen_from_copy(persist_dir, persist_dir + "-copy")
        try:
            replayed = mod._comparable(again)
        finally:
            again.close()
    finally:
        gcs.close()
    for t in (live, replayed):
        for k in [k for k in t if "epoch" in k]:
            t.pop(k)
    return live, replayed


def test_parity_gcs_tables_after_op_mix(tmp_path):
    """Every WAL op of the mix applied to each package's GCS leaves the
    same tables, and replaying each one's log rebuilds them."""
    ref = _tables(ref_wal, str(tmp_path / "ref"))
    port = _tables(_wal, str(tmp_path / "port"))
    assert port[0] == ref[0]
    assert port[1] == ref[1] == ref[0]


def test_parity_lost_reply_keeps_maybe_applied(tmp_path):
    """A lost reply to a non-idempotent op (kv merge) raises RpcError
    with ``maybe_applied`` and is applied once; an idempotent one is
    re-sent: the same outcome in both packages (the L9 rule)."""
    outcomes = []
    for pkg in ("ray_tpu", "ray_tpu_torch"):
        gcs_mod = __import__(pkg + ".core.cluster.gcs", fromlist=["x"])
        rpc = __import__(pkg + ".core.cluster.rpc", fromlist=["x"])
        netem = __import__(pkg + ".core.netem", fromlist=["x"])
        gcs = gcs_mod.GcsServer(port=0, authkey=b"k" * 16)
        cli = rpc.RpcClient(gcs.address, b"k" * 16, connect_timeout=5.0)
        got = []
        try:
            netem.arm(3)
            netem.add_rule("*", "*", "lost_reply", {"times": 1})
            try:
                cli.call(("kv", "merge", "cnt", {"a": 1}))
                got.append("returned")
            except rpc.RpcError as e:
                got.append(("RpcError", e.maybe_applied))
            netem.add_rule("*", "*", "lost_reply", {"times": 1})
            got.append(cli.call(("kv", "put", "x", 1)))
            got.append(cli.call(("kv", "get", "cnt")))
            got.append(cli.call(("kv", "get", "x")))
        finally:
            netem.clear()
            netem.set_identity("driver")
            cli.close()
            gcs.close()
        outcomes.append(got)
    assert outcomes[1] == outcomes[0]
    assert outcomes[0][0] == ("RpcError", True)
