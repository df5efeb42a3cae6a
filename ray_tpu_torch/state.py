"""State API: observability over nodes, actors, tasks, and objects.

Reference: python/ray/util/state/api.py:781 (list_nodes/list_actors/
list_tasks/list_objects, summarize_*). The port's copy of
``ray_tpu/state.py``. Works against both cores: the embedded runtime
answers from its own tables; a cluster driver aggregates the GCS
node/actor tables plus per-node state RPCs, so ``cluster_resources()``
and ``available_resources()`` sum every node's (its ``GPU`` too).
"""

from __future__ import annotations

from typing import Any, Dict, List

from ray_tpu_torch.core import runtime_context


def _core():
    return runtime_context.get_core()


def _is_cluster(core) -> bool:
    return hasattr(core, "_cluster_view")


def _node_summaries(core) -> List[dict]:
    from ray_tpu_torch.core.cluster.rpc import RpcError

    out = []
    for n in core.nodes():
        addr = tuple(n["address"])
        entry = {"node_id": n["node_id"].hex(), "address": list(addr),
                 "state": n["state"], "resources": n["resources"],
                 "labels": n.get("topology", {})}
        try:
            entry["summary"] = core._nodes.get(addr).call(("state",))
        except RpcError:
            entry["summary"] = None  # unreachable node
        out.append(entry)
    return out


def _workers_from(summaries: List[dict]) -> List[dict]:
    out = []
    for n in summaries:
        if n["summary"]:
            for w in n["summary"]["workers"]:
                out.append({**w, "node_id": n["node_id"]})
    return out


def _tasks_from(summaries: List[dict]) -> Dict[str, int]:
    total = {"queued": 0, "running": 0}
    for n in summaries:
        if n["summary"]:
            total["queued"] += n["summary"]["tasks"]["queued"]
            total["running"] += n["summary"]["tasks"]["running"]
    return total


def _objects_from(summaries: List[dict]) -> Dict[str, Any]:
    agg = {"tracked": 0, "resolved": 0, "pinned": 0, "spilled_bytes": 0,
           "store_bytes_in_use": 0}
    for n in summaries:
        s = n["summary"]
        if s:
            for k in ("tracked", "resolved", "pinned", "spilled_bytes"):
                agg[k] += s["objects"][k]
            agg["store_bytes_in_use"] += s["store"]["bytes_in_use"]
    return agg


def _transfer_from(summaries: List[dict]) -> Dict[str, Any]:
    """Cluster-wide data-plane movement: cross-node pull throughput,
    pull-admission occupancy, and sender-side backpressure, aggregated
    from each node's ("state",) reply."""
    agg: Dict[str, Any] = {"fetch_bytes": 0, "fetch_seconds": 0.0,
                           "fetch_count": 0, "fetch_gbps": 0.0,
                           "push_waits": 0, "pulls": []}
    for n in summaries:
        s = n["summary"]
        if not s:
            continue
        f = s.get("fetch")
        if f:
            agg["fetch_bytes"] += f["bytes"]
            agg["fetch_seconds"] += f["seconds"]
            agg["fetch_count"] += f["count"]
        agg["push_waits"] += s.get("push_waits", 0)
        if s.get("pulls") is not None:
            agg["pulls"].append({"node_id": n["node_id"], **s["pulls"]})
    if agg["fetch_seconds"] > 0:
        agg["fetch_gbps"] = round(
            agg["fetch_bytes"] * 8 / agg["fetch_seconds"] / 1e9, 3)
    return agg


def summarize_transfers() -> Dict[str, Any]:
    """Object-movement stats: bytes pulled cross-node, effective fetch
    throughput, per-node pull-manager occupancy, push backpressure. The
    single-node runtime has no cross-node plane: returns zeros."""
    core = _core()
    if _is_cluster(core):
        return _transfer_from(_node_summaries(core))
    return {"fetch_bytes": 0, "fetch_seconds": 0.0, "fetch_count": 0,
            "fetch_gbps": 0.0, "push_waits": 0, "pulls": []}


def locality_stats() -> Dict[str, int]:
    """This driver's locality-scheduling counters: submissions that
    landed on the node holding the most argument bytes (hits) vs not
    (misses), cross-node transfer bytes avoided (bytes_local) vs still
    required (bytes_remote), and directory lookup efficiency
    (batched_lookups, cache_hits). All zeros on the single-node core,
    where every argument is always local."""
    core = _core()
    if _is_cluster(core):
        with core._lock:
            return dict(core.locality_stats)
    return {"hits": 0, "misses": 0, "bytes_local": 0, "bytes_remote": 0,
            "batched_lookups": 0, "cache_hits": 0}


def list_nodes() -> List[dict]:
    core = _core()
    if _is_cluster(core):
        return [{"node_id": n["node_id"].hex(),
                 "address": list(n["address"]), "state": n["state"],
                 "resources": n["resources"]} for n in core.nodes()]
    s = core.state_summary()
    return [{"node_id": s["node_id"], "address": ["local", 0],
             "state": "ALIVE", "resources": s["resources"]["total"]}]


def list_actors() -> List[dict]:
    core = _core()
    if _is_cluster(core):
        table = core.gcs.call(("list_actors",))
        return [{"actor_id": aid.hex(), **{k: v for k, v in info.items()
                                           if k != "opts"}}
                for aid, info in table.items()]
    return core.state_summary()["actors"]


def list_workers() -> List[dict]:
    core = _core()
    if _is_cluster(core):
        return _workers_from(_node_summaries(core))
    return core.state_summary()["workers"]


def stack_dump() -> Dict[str, str]:
    """Live stacks of every worker across the cluster — the py-spy-style
    profiling surface (reference: dashboard worker-stack endpoint).
    Returns {worker_id_hex (prefixed by node in cluster mode): text}."""
    from ray_tpu_torch.core.cluster.rpc import RpcError

    core = _core()
    if _is_cluster(core):
        out: Dict[str, str] = {}
        for n in core.nodes():
            try:
                dumps = core._nodes.get(tuple(n["address"])).call(
                    ("stack_dump",))
            except RpcError:
                continue
            nid = n["node_id"].hex()[:8]
            out.update({f"{nid}:{wid}": text
                        for wid, text in dumps.items()})
        return out
    return core.stack_dump()


def summarize_tasks() -> Dict[str, Any]:
    core = _core()
    if _is_cluster(core):
        return _tasks_from(_node_summaries(core))
    return core.state_summary()["tasks"]


def summarize_objects() -> Dict[str, Any]:
    core = _core()
    if _is_cluster(core):
        return _objects_from(_node_summaries(core))
    s = core.state_summary()
    return {**s["objects"], "store_bytes_in_use": s["store"]["bytes_in_use"]}


def list_logs(node_id: str = None) -> List[dict]:
    """Session log files (name + size), per node in cluster mode
    (reference: ray.util.state.list_logs)."""
    from ray_tpu_torch.core.cluster.rpc import RpcError

    core = _core()
    if _is_cluster(core):
        out = []
        for n in core.nodes():
            if node_id and n["node_id"].hex() != node_id:
                continue
            try:
                files = core._nodes.get(tuple(n["address"])).call(
                    ("list_logs",))
            except RpcError:  # unreachable node
                files = []
            out.extend({**f, "node_id": n["node_id"].hex()} for f in files)
        return out
    from ray_tpu_torch.core.log_monitor import list_log_files

    return list_log_files(core.log_dir)


def get_log(filename: str, node_id: str = None,
            tail: int = 1000) -> str:
    """Tail of one session log file (reference: ray.util.state.get_log)."""
    from ray_tpu_torch.core.cluster.rpc import RpcError

    core = _core()
    if _is_cluster(core):
        for n in core.nodes():
            if node_id and n["node_id"].hex() != node_id:
                continue
            try:
                return core._nodes.get(tuple(n["address"])).call(
                    ("get_log", filename, tail))
            except (RpcError, FileNotFoundError):
                # transport failure or absent on this node: try the next
                # one; bad requests (ValueError) propagate untouched
                if node_id:
                    raise
                continue
        raise FileNotFoundError(
            f"log {filename!r} not found on any reachable node")
    from ray_tpu_torch.core.log_monitor import read_log_file

    return read_log_file(core.log_dir, filename, tail)


def cluster_resources() -> Dict[str, float]:
    core = _core()
    if _is_cluster(core):
        return core.cluster_resources()
    return core.state_summary()["resources"]["total"]


def available_resources() -> Dict[str, float]:
    core = _core()
    if _is_cluster(core):
        total: Dict[str, float] = {}
        for n in core.nodes():
            for k, v in n.get("avail", {}).items():
                total[k] = total.get(k, 0) + v
        return total
    return core.state_summary()["resources"]["available"]


def state_summary() -> Dict[str, Any]:
    """One-call overview (the dashboard-lite payload). In cluster mode the
    per-node fan-out happens exactly once, so the snapshot is internally
    consistent."""
    core = _core()
    if _is_cluster(core):
        summaries = _node_summaries(core)
        return {
            "nodes": list_nodes(),
            "actors": list_actors(),
            "tasks": _tasks_from(summaries),
            "objects": _objects_from(summaries),
            "transfers": _transfer_from(summaries),
            "scheduling": {"locality": locality_stats()},
            "cluster_resources": cluster_resources(),
            "available_resources": available_resources(),
        }
    return {
        "nodes": list_nodes(),
        "actors": list_actors(),
        "tasks": summarize_tasks(),
        "objects": summarize_objects(),
        "transfers": summarize_transfers(),
        "scheduling": {"locality": locality_stats()},
        "cluster_resources": cluster_resources(),
        "available_resources": available_resources(),
    }
