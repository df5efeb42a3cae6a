"""Ray-Client-style proxy: many remote clients, one shared cluster.

Reference: python/ray/util/client/server/proxier.py — the client server
accepts thin clients on a single public endpoint and gives EACH ONE an
isolated driver (`SpecificServer` per client there; a per-tenant
``ClusterCore`` here), so tenants get separate ownership domains:
object refs, actors, and lineage created by one client are owned by
that client's core, and a disconnect (explicit or by idle timeout)
tears down exactly that tenant's state through the normal owner-death
cleanup — never another client's.

Wire model: the client ships the SAME core-client calls a local driver
makes (register_function / submit_task / create_actor / get_objects /
...), cloudpickled. ObjectRefs cross the boundary by id: the pickle
resolver rebinds them to whichever core deserializes them — the
tenant's ClusterCore on the proxy, the ``ProxyCore`` on the client —
so nested refs in args and returned refs both work unchanged.

Usage::

    # on a machine with cluster connectivity
    srv = ClientProxyServer(gcs_address)

    # anywhere that can reach the proxy
    ray_tpu_torch.init(address=f"ray://{srv.address[0]}:{srv.address[1]}")
"""

from __future__ import annotations

import pickle
import threading
import time
import uuid
from typing import Any, Dict, Optional, Tuple

from ray_tpu_torch.core import runtime_context
from ray_tpu_torch.core.cluster.rpc import RpcClient, RpcServer, cluster_authkey
from ray_tpu_torch.core.ids import NodeID, WorkerID

# the core-client surface a tenant may invoke (everything api.py and the
# remote-function/actor layers call on a driver core)
_ALLOWED_OPS = frozenset({
    "register_function", "submit_task", "create_actor",
    "submit_actor_task", "put_object", "get_objects", "wait",
    "kill_actor", "cancel_task", "free_objects", "get_named_actor",
    "get_actor_method_opts", "prepare_runtime_env",
})


class ClientProxyServer:
    """Multi-tenant proxy (reference: proxier.py:113 ProxyManager)."""

    def __init__(self, gcs_address: Tuple[str, int],
                 host: str = "127.0.0.1", port: int = 0,
                 authkey: Optional[bytes] = None,
                 idle_timeout_s: float = 60.0):
        self._gcs = tuple(gcs_address)
        self._authkey = authkey or cluster_authkey()
        self._idle_timeout_s = idle_timeout_s
        # _lock guards the tenant table (cheap ops only — heartbeats and
        # the reaper must never wait behind a slow tenant call);
        # _ctx_lock guards the brief runtime_context swaps around
        # pickling, where ObjectRefs rebind via the process-global
        # context. The core calls themselves run under NEITHER lock, so
        # tenants block and fetch concurrently.
        self._lock = threading.RLock()
        self._ctx_lock = threading.Lock()
        self._tenants: Dict[str, dict] = {}
        self._stop = False
        self._server = RpcServer(self._handle, self._authkey, host, port)
        self.address = self._server.address
        threading.Thread(target=self._reaper, daemon=True,
                         name="client-proxy-reaper").start()

    # ------------------------------------------------------------- handlers

    def _handle(self, msg: Any, ctx: dict) -> Any:
        op = msg[0]
        if op == "client_connect":
            return self._connect()
        if op == "client_touch":
            with self._lock:
                t = self._tenants.get(msg[1])
                if t is None:
                    raise KeyError(f"unknown client {msg[1]!r}")
                t["last"] = time.monotonic()
            return True
        if op == "client_disconnect":
            self._disconnect(msg[1])
            return True
        if op == "client_op":
            _, client_id, method, payload = msg
            return self._tenant_op(client_id, method, payload)
        raise ValueError(f"unknown proxy op {op!r}")

    def _connect(self) -> str:
        from ray_tpu_torch.core.cluster.cluster_core import ClusterCore

        client_id = uuid.uuid4().hex[:12]
        with self._lock:
            prev = runtime_context.get_core_or_none()
            try:
                runtime_context.set_core(None)
                core = ClusterCore(self._gcs, authkey=self._authkey)
            finally:
                runtime_context.set_core(prev)
            self._tenants[client_id] = {"core": core,
                                        "last": time.monotonic()}
        return client_id

    def _disconnect(self, client_id: str):
        with self._lock:
            t = self._tenants.pop(client_id, None)
        if t is not None:
            try:
                t["core"].shutdown()
            except Exception:  # noqa: BLE001 — tenant teardown best-effort
                pass

    def _tenant_op(self, client_id: str, method: str,
                   payload: bytes) -> bytes:
        if method not in _ALLOWED_OPS:
            raise ValueError(f"op {method!r} not allowed through the proxy")
        import cloudpickle

        with self._lock:
            t = self._tenants.get(client_id)
            if t is None:
                raise KeyError(f"unknown client {client_id!r}")
            t["last"] = time.monotonic()
            core = t["core"]
        with self._ctx_lock:
            prev = runtime_context.get_core_or_none()
            runtime_context.set_core(core)  # refs rebind to this tenant
            try:
                args, kwargs = pickle.loads(payload)
            finally:
                runtime_context.set_core(prev)
        result = getattr(core, method)(*args, **kwargs)
        with self._lock:
            t2 = self._tenants.get(client_id)
            if t2 is not None:  # a long get must not look idle
                t2["last"] = time.monotonic()
        with self._ctx_lock:
            prev = runtime_context.get_core_or_none()
            runtime_context.set_core(core)
            try:
                return cloudpickle.dumps(result)
            finally:
                runtime_context.set_core(prev)

    def _reaper(self):
        while not self._stop:
            time.sleep(min(5.0, self._idle_timeout_s / 4))
            cutoff = time.monotonic() - self._idle_timeout_s
            with self._lock:
                dead = [cid for cid, t in self._tenants.items()
                        if t["last"] < cutoff]
            for cid in dead:
                self._disconnect(cid)

    @property
    def num_tenants(self) -> int:
        with self._lock:
            return len(self._tenants)

    def close(self):
        self._stop = True
        with self._lock:
            cids = list(self._tenants)
        for cid in cids:
            self._disconnect(cid)
        self._server.close()


class ProxyCore:
    """Client-side core: the same duck-typed surface a local driver core
    exposes, each call forwarded to this client's tenant on the proxy
    (reference: util/client/worker.py Worker). Installed by
    ``ray_tpu_torch.init(address="ray://host:port")``."""

    is_client = True

    def __init__(self, address: Tuple[str, int],
                 authkey: Optional[bytes] = None,
                 heartbeat_s: float = 10.0):
        self._rpc = RpcClient(tuple(address), authkey or cluster_authkey())
        self._client_id = self._rpc.call(("client_connect",))
        self.node_id = NodeID.from_random()
        self.worker_id = WorkerID.from_random()
        self._closed = False
        self._hb_s = heartbeat_s
        threading.Thread(target=self._heartbeat, daemon=True,
                         name="proxy-core-hb").start()

    def _heartbeat(self):
        while not self._closed:
            time.sleep(self._hb_s)
            try:
                self._rpc.call(("client_touch", self._client_id))
            except Exception:  # noqa: BLE001 — next get/put will surface
                pass

    def _op(self, method: str, *args, **kwargs):
        import cloudpickle

        payload = cloudpickle.dumps((args, kwargs))
        out = self._rpc.call(
            ("client_op", self._client_id, method, payload))
        return pickle.loads(out)

    def __getattr__(self, name: str):
        if name.startswith("_") or name not in _ALLOWED_OPS:
            raise AttributeError(name)
        return lambda *a, **kw: self._op(name, *a, **kw)

    def shutdown(self):
        if not self._closed:
            self._closed = True
            try:
                self._rpc.call(("client_disconnect", self._client_id))
            except Exception:  # noqa: BLE001
                pass
            self._rpc.close()
