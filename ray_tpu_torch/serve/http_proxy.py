"""HTTP ingress: a stdlib threaded proxy in front of Serve deployments.

The port's copy of ``ray_tpu/serve/http_proxy.py``.

Reference: serve/_private/proxy.py:1139 (uvicorn/ASGI there; stdlib
ThreadingHTTPServer here — no third-party deps). Routes
``POST /<deployment>`` with a JSON body ``{"args": [...], "kwargs": {}}``
to the deployment handle and returns the JSON-encoded result. QoS rides
the body: ``"priority"`` ("low"/"normal"/"high" or 0..2) and
``"deadline_s"`` become per-request overrides. Typed overload errors map
to real status codes — BackpressureError → 429 with a ``Retry-After``
header (the shed hint), ReplicaUnavailableError → 503 — so clients and
load balancers can tell "back off" from "capacity is gone" from "bug"
(a bare 500).
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional

from ray_tpu_torch.exceptions import BackpressureError, ReplicaUnavailableError
from ray_tpu_torch.serve.api import DeploymentHandle


class _Handler(BaseHTTPRequestHandler):
    handles: Dict[str, DeploymentHandle] = {}
    timeout_s = 120.0

    def log_message(self, *a):  # quiet
        pass

    def _reject_backpressure(self, e: BackpressureError) -> None:
        """429 Too Many Requests + Retry-After: the shed carries its
        own client back-off hint."""
        payload = json.dumps({
            "error": str(e),
            "type": "BackpressureError",
            "deployment": e.deployment,
            "queue_depth": e.queue_depth,
            "estimated_wait_s": e.estimated_wait_s,
            "retry_after_s": e.retry_after_s,
        }).encode()
        self.send_response(429)
        self.send_header("Retry-After",
                         str(max(1, round(e.retry_after_s))))
        self._finish(payload)

    def _reject_unavailable(self, e: ReplicaUnavailableError) -> None:
        """503 Service Unavailable: no replica exists to serve this —
        unlike a 429 shed, retrying sooner will not help."""
        payload = json.dumps({
            "error": str(e),
            "type": "ReplicaUnavailableError",
            "deployment": e.deployment,
        }).encode()
        self.send_response(503)
        self._finish(payload)

    def _finish(self, payload: bytes) -> None:
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)

    def do_POST(self):
        name = self.path.strip("/").split("/")[0]
        handle = self.handles.get(name)
        if handle is None:
            handle = self.handles[name] = DeploymentHandle(name)
        try:
            length = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(length) or b"{}")
            args = tuple(body.get("args", ()))
            kwargs = dict(body.get("kwargs", {}))
            priority = body.get("priority")
            deadline_s = body.get("deadline_s")
            if priority is not None or deadline_s is not None:
                handle = handle.options(priority=priority,
                                        deadline_s=deadline_s)
            if body.get("stream"):
                return self._stream(handle, args, kwargs)
            result = handle.remote(*args, **kwargs).result(self.timeout_s)
            payload = json.dumps({"result": result}).encode()
            self.send_response(200)
        except BackpressureError as e:
            return self._reject_backpressure(e)
        except ReplicaUnavailableError as e:
            return self._reject_unavailable(e)
        except Exception as e:  # noqa: BLE001
            payload = json.dumps({"error": repr(e)}).encode()
            self.send_response(500)
        self._finish(payload)
        return None

    def _stream(self, handle, args, kwargs):
        """Server-sent events: one ``data:`` line per new-token chunk,
        then ``data: [DONE]`` (the OpenAI-compatible shape). Admission
        runs eagerly in stream_request, so a shed/unavailable surfaces
        BEFORE the 200 status line goes out and maps to its real status
        code; after bytes have streamed the status is spent — a
        mid-flight shed closes the stream cleanly with a typed error
        event instead."""
        try:
            gen = handle.stream(*args, **kwargs)
        except BackpressureError as e:
            return self._reject_backpressure(e)
        except ReplicaUnavailableError as e:
            return self._reject_unavailable(e)
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.end_headers()
        try:
            for chunk in gen:
                self.wfile.write(
                    b"data: " + json.dumps({"tokens": chunk}).encode()
                    + b"\n\n")
                self.wfile.flush()
            self.wfile.write(b"data: [DONE]\n\n")
            self.wfile.flush()
        except Exception as e:  # noqa: BLE001 — mid-stream: emit an error
            try:
                err = {"error": repr(e)}
                if isinstance(e, BackpressureError):
                    # typed mid-flight shed: clients distinguish "your
                    # deadline expired, back off" from a server bug
                    err = {"error": str(e), "type": "BackpressureError",
                           "retry_after_s": e.retry_after_s}
                self.wfile.write(
                    b"data: " + json.dumps(err).encode() + b"\n\n")
                self.wfile.flush()
            except OSError:
                pass
        return None


class HttpProxy:
    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._server = ThreadingHTTPServer((host, port), _Handler)
        self.address = self._server.server_address
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True, name="serve-http")
        self._thread.start()

    def stop(self):
        self._server.shutdown()


_proxy: Optional[HttpProxy] = None


def start_http(host: str = "127.0.0.1", port: int = 0) -> HttpProxy:
    global _proxy
    if _proxy is None:
        _proxy = HttpProxy(host, port)
    return _proxy


def stop_http():
    global _proxy
    if _proxy is not None:
        _proxy.stop()
        _proxy = None
