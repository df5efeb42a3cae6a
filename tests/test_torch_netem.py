"""The port's network-emulation shim and wire contract against
``ray_tpu``'s (``tests/test_netem.py``).

``test_port_*`` run that file's programs on the port (grammar, seeded
replay, partitions, dup and lost-reply sweeps, epoch fencing, shaping
on a live two-node cluster), held to its own assertions
(``_torch_port_copy.py``); the reference halves are the reference's own
tests. ``test_parity_*`` run one program through both packages and
compare, and ``test_wire_contract_totality`` holds the port's
``WIRE_CONTRACT`` to the port's ``_op_*`` arms and ``MSG_*``/``REQ_*``
tags, both ways.
"""

from __future__ import annotations

import ast
from pathlib import Path

from tests import test_netem as ref_netem
from tests._torch_port_copy import export, port_copy, ref_tests

ROOT = Path(__file__).resolve().parent.parent

_nm = port_copy("test_netem.py")


def test_parity_seeded_schedule():
    """One seed, one lossy workload: both packages deliver the same calls
    and record the same (rule, decision) schedule."""
    from ray_tpu.core import netem as ref_shim
    from ray_tpu_torch.core import netem as port_shim

    try:
        ref = ref_netem._seeded_workload(4242)
        port = _nm._seeded_workload(4242)
    finally:
        for shim in (ref_shim, port_shim):
            shim.clear()
            shim.set_identity("driver")
    assert ref[1], "the lossy workload must record a schedule"
    assert port == ref


def test_parity_parse_spec():
    from ray_tpu.core import netem as ref_shim
    from ray_tpu_torch.core import netem as port_shim

    for spec in ("7:driver->gcs=drop,p=0.5,times=3; node<->gcs=delay,ms=2",
                 "1:->9001=blackhole", "9:*->node=bw,kbps=64;gcs->*=dup",
                 "3:node->127.0.0.1:7001=lost_reply,at=server"):
        assert port_shim.parse_spec(spec) == ref_shim.parse_spec(spec)
    for bad in ("1:a->b=warp_drive", "1:a->b", ""):
        errs = []
        for shim in (ref_shim, port_shim):
            try:
                shim.parse_spec(bad)
                errs.append(None)
            except Exception as e:  # noqa: BLE001 — the type is the result
                errs.append(type(e).__name__)
        assert errs[1] == errs[0] == "ValueError"


def _op_arms(path: Path):
    """The ``_op_*`` method names of every class in ``path``."""
    tree = ast.parse(path.read_text())
    return {f.name[len("_op_"):] for c in ast.walk(tree)
            if isinstance(c, ast.ClassDef) for f in c.body
            if isinstance(f, ast.FunctionDef) and f.name.startswith("_op_")}


def _tags(path: Path):
    """The wire strings of ``MSG_*`` / ``REQ_*`` constants in ``path``."""
    tree = ast.parse(path.read_text())
    return {n.value.value for n in tree.body
            if isinstance(n, ast.Assign) and len(n.targets) == 1
            and isinstance(n.targets[0], ast.Name)
            and n.targets[0].id.startswith(("MSG_", "REQ_"))
            and isinstance(n.value, ast.Constant)}


def test_wire_contract_totality():
    """Every op a port client can put on a wire has exactly one contract
    entry, and every entry names an op that exists (the port's
    counterpart of the reference's L9 totality rule)."""
    from ray_tpu_torch.core.cluster import protocol_meta

    pkg = ROOT / "ray_tpu_torch" / "core"
    ops = (_op_arms(pkg / "cluster" / "gcs.py")
           | _op_arms(pkg / "cluster" / "node_server.py"))
    wire = ops | _tags(pkg / "protocol.py")
    contract = set(protocol_meta.WIRE_CONTRACT)
    assert wire - contract == set(), "ops without a contract entry"
    assert contract - wire == set(), "contract entries naming no op"
    assert set(protocol_meta.KV_SUBOP_CONTRACT) == {
        "put", "get", "del", "exists", "keys", "merge", "cas_merge"}
    # the resync table covers exactly the ops the GCS write-ahead logs
    from ray_tpu_torch.core.cluster.gcs import _WAL_OPS

    assert set(protocol_meta.RESYNC_COVERAGE) == set(_WAL_OPS)
    # the port's single new pipe tag is inert on the wire
    assert protocol_meta.WIRE_CONTRACT["task_cancelled"] == \
        protocol_meta.NON_RETRYABLE


# The copy's tests come after the parity ones: its module-scoped live
# cluster, once up, keeps making driver RPCs that would draw from a
# seeded rule's stream.
export(_nm, globals(), ref_tests(_nm), fixtures=["_netem_reset", "cluster"])
