"""gRPC ingress for Serve deployments.

The port's copy of ``ray_tpu/serve/grpc_proxy.py``. The service keeps
the reference's name, so a client of one calls the other unchanged.
``grpc`` is imported when the proxy starts, never at import.

Reference: serve/_private/proxy.py:545 (gRPCProxy). There users register
generated servicers; here the ingress is a GENERIC gRPC service — no
protoc step — with one unary-unary method per routing shape:

    /ray_tpu.serve.Ingress/Call    request bytes = JSON
        {"deployment": "name", "args": [...], "kwargs": {...},
         "multiplexed_model_id": "m1"?}
        response bytes = JSON {"result": ...} | {"error": "..."}

Any gRPC client in any language can call it with the bytes in/out stubs
(grpc's generic serializer), which is the practical cross-language
surface a single-language framework can offer.
"""

from __future__ import annotations

import json
import threading
from typing import Dict, Optional

from ray_tpu_torch.serve.api import DeploymentHandle

SERVICE = "ray_tpu.serve.Ingress"


class GrpcProxy:
    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 timeout_s: float = 120.0):
        import grpc
        from concurrent import futures

        self._handles: Dict[str, DeploymentHandle] = {}
        self._timeout_s = timeout_s

        def call(request: bytes, context) -> bytes:
            name = None
            try:
                body = json.loads(request or b"{}")
                name = body["deployment"]
                handle = self._handles.get(name)
                if handle is None:
                    # fail FAST on unknown deployments: routing to one
                    # would otherwise pin a pool thread for the router's
                    # 30s replica wait (8 typos = a stalled ingress)
                    import ray_tpu_torch
                    from ray_tpu_torch.serve.api import CONTROLLER_NAME

                    controller = ray_tpu_torch.get_actor(CONTROLLER_NAME)
                    cfg = ray_tpu_torch.get(
                        controller.get_deployment_config.remote(name),
                        timeout=10)
                    if cfg is None:
                        return json.dumps(
                            {"error": f"unknown deployment {name!r}"}
                        ).encode()
                    handle = self._handles[name] = DeploymentHandle(name)
                mid = body.get("multiplexed_model_id")
                if mid is not None:
                    handle = handle.options(multiplexed_model_id=mid)
                result = handle.remote(
                    *body.get("args", ()), **body.get("kwargs", {})
                ).result(self._timeout_s)
                return json.dumps({"result": result}).encode()
            except Exception as e:  # noqa: BLE001
                # drop the cached handle: its router's config snapshot
                # may be stale (deleted/redeployed deployment)
                if name is not None:
                    self._handles.pop(name, None)
                return json.dumps({"error": repr(e)}).encode()

        self._call = call

        rpc = grpc.unary_unary_rpc_method_handler(
            call, request_deserializer=None, response_serializer=None)
        handler = grpc.method_handlers_generic_handler(
            SERVICE, {"Call": rpc})
        self._server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=8))
        self._server.add_generic_rpc_handlers((handler,))
        self.port = self._server.add_insecure_port(f"{host}:{port}")
        self.host = host
        self._server.start()

    def invalidate(self, name: Optional[str] = None):
        """Drop cached handle(s): a deleted/redeployed deployment must be
        re-resolved so the router sees the NEW config (batching/engine
        mode are snapshotted at router construction)."""
        if name is None:
            self._handles.clear()
        else:
            self._handles.pop(name, None)

    def stop(self):
        self._server.stop(grace=1.0)


_grpc_proxy: Optional[GrpcProxy] = None
_lock = threading.Lock()


def invalidate(name: Optional[str] = None):
    """serve.delete/shutdown hook (no-op when no proxy is running)."""
    with _lock:
        if _grpc_proxy is not None:
            _grpc_proxy.invalidate(name)


def start_grpc(host: str = "127.0.0.1", port: int = 0) -> GrpcProxy:
    global _grpc_proxy
    with _lock:
        if _grpc_proxy is None:
            _grpc_proxy = GrpcProxy(host, port)
        return _grpc_proxy


def stop_grpc():
    global _grpc_proxy
    with _lock:
        if _grpc_proxy is not None:
            _grpc_proxy.stop()
            _grpc_proxy = None
