"""Cluster fixture: a multi-node cluster of real processes on one host.

The capability analogue of the reference's ``cluster_utils.Cluster``
(python/ray/cluster_utils.py:135): start a GCS + N node-server processes,
connect a driver, add/remove nodes mid-test. Each node is a full separate
process (own shm store, own worker pool) talking real TCP — the same code
path a multi-host deployment uses, just colocated.

GPUs: a node advertises only the cards ``add_node(gpus=...)`` gives it.
Every other node runs with ``RTPU_GPUS=0``: nodes of one host would each
detect the same ``/dev/nvidia*`` devices and hand out the same card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional, Tuple

from ray_tpu_torch.core.cluster.rpc import RpcClient, cluster_authkey, pick_port


def _read_tagged_line(proc: subprocess.Popen, tag: str, timeout: float = 30.0
                      ) -> str:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        line = proc.stdout.readline()
        if not line:
            if proc.poll() is not None:
                raise RuntimeError(
                    f"process exited ({proc.returncode}) before printing "
                    f"{tag}: {proc.stderr.read() if proc.stderr else ''}")
            time.sleep(0.01)
            continue
        line = line.decode() if isinstance(line, bytes) else line
        if line.startswith(tag):
            return line[len(tag):].strip()
    raise TimeoutError(f"timed out waiting for {tag}")


def _parse_addr(s: str) -> Tuple[str, int]:
    host, port = s.rsplit(":", 1)
    return host, int(port)


class NodeProc:
    """A node-server subprocess handle."""

    def __init__(self, proc: subprocess.Popen, address: Tuple[str, int]):
        self.proc = proc
        self.address = address

    def kill(self):
        """Hard-kill the node (simulates node failure)."""
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


class Cluster:
    """Start/stop a local multi-node cluster.

    Usage::

        cluster = Cluster(num_nodes=3, num_workers_per_node=2)
        core = cluster.connect()        # a ClusterCore bound to this cluster
        ...
        cluster.shutdown()
    """

    def __init__(self, num_nodes: int = 1, num_workers_per_node: int = 2,
                 object_store_memory: int = 128 << 20,
                 node_resources: Optional[List[dict]] = None,
                 env: Optional[Dict[str, str]] = None,
                 gcs_persist_dir: Optional[str] = None):
        self.authkey = os.urandom(16)
        self._env = dict(os.environ)
        self._env["RTPU_CLUSTER_AUTHKEY"] = self.authkey.hex()
        # node processes must not inherit a GPU claim: one card is
        # advertised by the one node add_node(gpus=) names
        self._env["RTPU_GPUS"] = "0"
        # the GCS and node processes run ``-m ray_tpu_torch...``: pin the
        # package's parent onto their path, whatever the working directory
        import ray_tpu_torch as _pkg

        root = os.path.dirname(os.path.dirname(os.path.abspath(_pkg.__file__)))
        pp = self._env.get("PYTHONPATH", "")
        if root not in pp.split(os.pathsep):
            self._env["PYTHONPATH"] = root + os.pathsep + pp if pp else root
        self._env.update(env or {})
        self.procs: List[subprocess.Popen] = []
        self.nodes: List[NodeProc] = []
        self._store_mem = object_store_memory
        self._nw = num_workers_per_node
        self._gcs_persist_dir = gcs_persist_dir

        # netem rules armed via partition()/gray(): (src endpoint,
        # src selector, dst selector, kind); heal() clears exactly these
        self._partitions: List[Tuple[object, str, str, str]] = []

        self._gcs_port = pick_port()
        self._start_gcs()

        for i in range(num_nodes):
            res = None
            if node_resources and i < len(node_resources):
                res = node_resources[i]
            self.add_node(resources=res)

    def _start_gcs(self):
        cmd = [sys.executable, "-m", "ray_tpu_torch.core.cluster.gcs",
               "--port", str(self._gcs_port)]
        if self._gcs_persist_dir:
            cmd += ["--persist-dir", self._gcs_persist_dir]
        self._gcs_proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
            env=self._env)
        self.procs.append(self._gcs_proc)
        self.gcs_address = _parse_addr(
            _read_tagged_line(self._gcs_proc, "GCS_ADDRESS "))

    def kill_gcs(self):
        """Hard-kill the GCS process (chaos: control-plane failure)."""
        if self._gcs_proc.poll() is None:
            self._gcs_proc.kill()
            self._gcs_proc.wait()
        if self._gcs_proc in self.procs:
            self.procs.remove(self._gcs_proc)

    def gcs_alive(self) -> bool:
        """Whether the GCS subprocess is still running (chaos tests use
        this to observe a fault-injected self-kill, e.g. gcs_kill)."""
        return self._gcs_proc.poll() is None

    def wait_gcs_dead(self, timeout: float = 30.0) -> bool:
        """Block until the GCS subprocess exits (e.g. an armed gcs_kill
        site fired). Reaps the handle so restart_gcs can follow."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self._gcs_proc.poll() is not None:
                if self._gcs_proc in self.procs:
                    self.procs.remove(self._gcs_proc)
                return True
            time.sleep(0.02)
        return False

    def restart_gcs(self, env_overrides: Optional[Dict[str, str]] = None):
        """Restart the GCS on the SAME port (requires gcs_persist_dir for
        state to survive); nodes re-register on their next heartbeat.
        ``env_overrides`` mutate the cluster env for the new process — a
        value of None deletes the var (e.g. disarm an RTPU_FAULT_* spec
        that already fired so the restarted head doesn't re-arm it)."""
        self.kill_gcs()
        for k, v in (env_overrides or {}).items():
            if v is None:
                self._env.pop(k, None)
            else:
                self._env[k] = v
        self._start_gcs()

    def add_node(self, num_workers: Optional[int] = None,
                 resources: Optional[dict] = None,
                 gpus=None, head: bool = False) -> NodeProc:
        """Start a node server. ``gpus``: a count (``RTPU_GPUS``, ids
        ``0..n-1``) or a list of device ids (``CUDA_VISIBLE_DEVICES``);
        None, the default, gives the node none. ``head`` runs the
        head-node services there (``--head``: the job agent)."""
        env = dict(self._env)
        if isinstance(gpus, int):
            env["RTPU_GPUS"] = str(gpus)
        elif gpus is not None:
            env.pop("RTPU_GPUS", None)
            env["CUDA_VISIBLE_DEVICES"] = ",".join(str(g) for g in gpus)
        cmd = [sys.executable, "-m", "ray_tpu_torch.core.cluster.node_server",
               "--gcs", f"{self.gcs_address[0]}:{self.gcs_address[1]}",
               "--num-workers", str(num_workers or self._nw),
               "--object-store-memory", str(self._store_mem)]
        if resources:
            cmd += ["--resources", json.dumps(resources)]
        if head:
            cmd.append("--head")
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.DEVNULL, env=env)
        self.procs.append(proc)
        addr = _parse_addr(_read_tagged_line(proc, "NODE_ADDRESS "))
        node = NodeProc(proc, addr)
        self.nodes.append(node)
        return node

    def remove_node(self, node: NodeProc, graceful: bool = False):
        """Remove a node; ungraceful kill exercises failure detection."""
        if graceful:
            try:
                # rtpu-lint: disable=L9 — test-fixture teardown: whether
                # the shutdown RPC applied is moot, kill() below ends
                # the process unconditionally
                RpcClient(node.address, self.authkey, connect_timeout=2.0
                          ).call(("shutdown_node",))
            # rtpu-lint: disable=L4 — graceful is best-effort: the node
            # often closes the connection mid-reply while shutting down;
            # kill() below is the guaranteed path either way
            except Exception:  # noqa: BLE001
                pass
            time.sleep(0.2)
        node.kill()
        if node in self.nodes:
            self.nodes.remove(node)

    def wait_for_nodes(self, count: Optional[int] = None,
                       timeout: float = 30.0) -> bool:
        client = RpcClient(self.gcs_address, self.authkey)
        try:
            return client.call(("wait_nodes", count or len(self.nodes),
                                timeout))
        finally:
            client.close()

    # ------------------------------------------------ network chaos (netem)

    def _netem_addr(self, ep) -> Optional[Tuple[str, int]]:
        """Resolve a partition endpoint to its listen address: "gcs",
        "driver" (no listen address — nothing dials the driver), a
        NodeProc, or an explicit (host, port) tuple."""
        if ep == "gcs":
            return self.gcs_address
        if ep == "driver":
            return None
        if isinstance(ep, NodeProc):
            return ep.address
        return tuple(ep)

    def _netem_ctl(self, ep, cmd: str, *args):
        """Deliver one netem control op to an endpoint's process. The
        driver is this process (in-process call); nodes and the GCS get
        a ``("netem", ...)`` RPC over their (unaffected) control edge."""
        from ray_tpu_torch.core import netem

        if ep == "driver":
            return netem.control(cmd, *args)
        addr = self._netem_addr(ep)
        client = RpcClient(addr, self.authkey, connect_timeout=5.0)
        try:
            return client.call(("netem", cmd) + args)
        finally:
            client.close()

    def partition(self, a, b, oneway: bool = False):
        """Sever the network edge a -> b (and b -> a unless ``oneway``)
        by arming client-side netem partition rules in the source
        process(es). Endpoints: "gcs", "driver", a NodeProc, or an
        address tuple. Reversed by heal()."""
        for src, dst in ((a, b),) if oneway else ((a, b), (b, a)):
            dst_addr = self._netem_addr(dst)
            if dst_addr is None:
                continue  # nothing dials the driver: no inbound edge
            dst_sel = f"{dst_addr[0]}:{dst_addr[1]}"
            self._netem_ctl(src, "add", "*", dst_sel, "partition", {})
            self._partitions.append((src, "*", dst_sel, "partition"))

    def gray(self, node: "NodeProc", ms: float = 300.0,
             jitter: float = 300.0, p: float = 0.05):
        """Make ``node`` a gray-failing node: every RPC it SENDS (its
        heartbeats included) takes drop probability ``p`` plus
        ``ms`` + U(0, ``jitter``) of delay — alive on the control plane,
        flaky on the wire. The GCS health scorer should QUARANTINE it
        while healthy nodes stay ALIVE. Reversed by heal()."""
        self._netem_ctl(node, "add", "*", "*", "delay",
                        {"ms": ms, "jitter": jitter})
        self._partitions.append((node, "*", "*", "delay"))
        if p > 0:
            self._netem_ctl(node, "add", "*", "*", "drop", {"p": p})
            self._partitions.append((node, "*", "*", "drop"))

    def heal(self):
        """Clear every netem rule armed through partition()/gray().
        Best-effort per endpoint: a process that died mid-chaos is
        skipped. Driver-sourced rules clear FIRST — they live in this
        process and can sever the very control edges the remote clears
        dial over (e.g. partition(driver, node) + partition(node, gcs):
        the node's rule is cleared via an RPC the driver's own rule
        would block)."""
        parts, self._partitions = self._partitions, []
        parts.sort(key=lambda p: p[0] != "driver")
        for src, src_sel, dst_sel, kind in parts:
            try:
                self._netem_ctl(src, "clear", src_sel, dst_sel, kind)
            # rtpu-lint: disable=L4 — heal is teardown-adjacent: a dead
            # endpoint can't hold a partition rule anyway
            except Exception:  # noqa: BLE001
                pass

    # --------------------------------------------- drain / lifecycle

    def _node_id_of(self, node: "NodeProc") -> bytes:
        client = RpcClient(self.gcs_address, self.authkey)
        try:
            listing = client.call(("list_nodes", False))
        finally:
            client.close()
        for n in listing["nodes"]:
            if tuple(n["address"]) == tuple(node.address):
                return n["node_id"]
        raise KeyError(f"node {node.address} not in the GCS table")

    def drain(self, node: "NodeProc") -> bool:
        """Begin planned removal of ``node`` (ALIVE -> DRAINING)."""
        node_id = self._node_id_of(node)
        client = RpcClient(self.gcs_address, self.authkey)
        try:
            return bool(client.call(("drain_node", node_id)))
        finally:
            client.close()

    def node_state(self, node: "NodeProc") -> Optional[str]:
        """The GCS lifecycle state of ``node`` (None once deregistered)."""
        client = RpcClient(self.gcs_address, self.authkey)
        try:
            listing = client.call(("list_nodes", False))
        finally:
            client.close()
        for n in listing["nodes"]:
            if tuple(n["address"]) == tuple(node.address):
                return n["state"]
        return None

    def wait_node_state(self, node: "NodeProc", state: str,
                        timeout: float = 30.0) -> bool:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.node_state(node) == state:
                return True
            time.sleep(0.05)
        return False

    def connect(self):
        """A ClusterCore driver bound to this cluster (also installs it as
        the process-wide core so the public API routes through it)."""
        from ray_tpu_torch.core import runtime_context
        from ray_tpu_torch.core.cluster.cluster_core import ClusterCore

        core = ClusterCore(self.gcs_address, authkey=self.authkey)
        runtime_context.set_core(core)
        return core

    def disconnect(self):
        from ray_tpu_torch.core import runtime_context

        core = runtime_context.get_core_or_none()
        if core is not None:
            core.shutdown()
        runtime_context.set_core(None)

    def shutdown(self):
        self.disconnect()
        for p in self.procs:
            if p.poll() is None:
                p.terminate()
        deadline = time.monotonic() + 5
        for p in self.procs:
            if p.poll() is None:
                try:
                    p.wait(max(0.1, deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    p.kill()
        self.procs.clear()
        self.nodes.clear()
        # a SIGKILLed node could not unlink its store's arena
        from ray_tpu_torch.core.runtime import _reap_stale_shm_arenas

        _reap_stale_shm_arenas()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
