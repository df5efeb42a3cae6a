"""Serve public API: @serve.deployment, serve.run, handles, @serve.batch.

The port's copy of ``ray_tpu/serve/api.py``.

Reference surface: python/ray/serve/api.py (deployment :280, run :580),
serve/handle.py (DeploymentHandle), serve/batching.py:80 (@serve.batch).
"""

from __future__ import annotations

import threading
from concurrent.futures import Future
from typing import Any, Callable, Dict, Optional, Union

import ray_tpu_torch
from ray_tpu_torch.serve.controller import (CONTROLLER_NAME,
                                            get_or_create_controller)


class DeploymentResponse:
    """Future-like result of handle.remote() (reference:
    serve/handle.py DeploymentResponse)."""

    def __init__(self, fut: Future):
        self._fut = fut

    def result(self, timeout: Optional[float] = None) -> Any:
        return self._fut.result(timeout)

    def done(self) -> bool:
        return self._fut.done()

    def exception(self, timeout: Optional[float] = None):
        return self._fut.exception(timeout)


class _MethodCaller:
    def __init__(self, handle: "DeploymentHandle", method: str):
        self._handle = handle
        self._method = method

    def remote(self, *args, **kwargs) -> DeploymentResponse:
        router = self._handle._get_router()
        return DeploymentResponse(
            router.call_method(self._method, args, kwargs))


class DeploymentHandle:
    """Client handle to a deployment; routes via a process-local Router."""

    def __init__(self, name: str):
        self._name = name
        self._router = None
        self._router_lock = threading.Lock()

    def _get_router(self):
        with self._router_lock:
            if self._router is None:
                from ray_tpu_torch.serve.router import Router

                controller = ray_tpu_torch.get_actor(CONTROLLER_NAME)
                self._router = Router(controller, self._name)
            return self._router

    def remote(self, *args, **kwargs) -> DeploymentResponse:
        return DeploymentResponse(self._get_router().request(args, kwargs))

    def options(self, *, multiplexed_model_id: Optional[str] = None,
                priority: Union[str, int, None] = None,
                deadline_s: Optional[float] = None,
                session_id: Optional[str] = None) -> "_OptionedHandle":
        """Per-request routing options (reference: handle.options):
        ``multiplexed_model_id`` routes to a replica that already holds
        that model variant and exposes the id to the deployment via
        serve.get_multiplexed_model_id(). ``priority`` ("low"/"normal"/
        "high" or 0..2) and ``deadline_s`` override the deployment's QoS
        defaults for requests issued through the returned handle view —
        under overload, lower classes shed first and requests whose
        deadline the router estimates unmeetable are rejected with
        BackpressureError. ``session_id`` pins the conversation to one
        replica when ``serve_cache_affinity`` is on, so multi-turn
        prompts keep hitting the replica whose paged KV cache holds the
        shared prefix (sticky unless that replica falls behind)."""
        return _OptionedHandle(self, multiplexed_model_id,
                               priority=priority, deadline_s=deadline_s,
                               session_id=session_id)

    def stream(self, *args, **kwargs):
        """Streaming responses: for generator deployments (the callable
        uses ``yield``) each yielded item arrives as it is produced via
        ``num_returns="streaming"``; engine deployments yield new-token
        lists from the mailbox (reference: handle streaming + serve.llm).
        """
        return self._get_router().stream_request(args, kwargs)

    def __getattr__(self, method: str) -> _MethodCaller:
        if method.startswith("_"):
            raise AttributeError(method)
        return _MethodCaller(self, method)

    def __reduce__(self):
        return (DeploymentHandle, (self._name,))

    def __del__(self):
        r = getattr(self, "_router", None)
        if r is not None:
            try:
                r.stop()
            except Exception:  # noqa: BLE001
                pass


class _OptionedHandle:
    """Handle view carrying per-request options (multiplexed model id,
    priority class, deadline). Supports the full handle surface:
    remote/stream/options chaining."""

    def __init__(self, handle: DeploymentHandle,
                 multiplexed_model_id: Optional[str],
                 priority: Union[str, int, None] = None,
                 deadline_s: Optional[float] = None,
                 session_id: Optional[str] = None):
        from ray_tpu_torch.serve.qos import normalize_priority

        self._handle = handle
        self._model_id = multiplexed_model_id
        # validate eagerly so a typo'd class name fails at .options(),
        # not deep in a router thread
        self._priority = (None if priority is None
                          else normalize_priority(priority))
        if deadline_s is not None and deadline_s <= 0:
            raise ValueError(
                f"deadline_s must be positive (got {deadline_s})")
        self._deadline_s = deadline_s
        self._session_id = session_id

    def remote(self, *args, **kwargs) -> DeploymentResponse:
        return DeploymentResponse(self._handle._get_router().request(
            args, kwargs, model_id=self._model_id,
            priority=self._priority, deadline_s=self._deadline_s,
            session_id=self._session_id))

    def options(self, *, multiplexed_model_id: Optional[str] = None,
                priority: Union[str, int, None] = None,
                deadline_s: Optional[float] = None,
                session_id: Optional[str] = None) -> "_OptionedHandle":
        # unset fields inherit from this view so chained .options()
        # calls compose instead of resetting
        return _OptionedHandle(
            self._handle,
            (multiplexed_model_id if multiplexed_model_id is not None
             else self._model_id),
            priority=priority if priority is not None else self._priority,
            deadline_s=(deadline_s if deadline_s is not None
                        else self._deadline_s),
            session_id=(session_id if session_id is not None
                        else self._session_id))

    def stream(self, *args, **kwargs):
        # the router rejects model_id only where it genuinely can't be
        # honored (engine mailbox); generator streams route mux-aware
        return self._handle._get_router().stream_request(
            args, kwargs, model_id=self._model_id,
            priority=self._priority, deadline_s=self._deadline_s,
            session_id=self._session_id)

    def __getattr__(self, method: str):
        if method.startswith("_"):
            raise AttributeError(method)
        if self._model_id is not None:
            # AttributeError keeps the attribute protocol intact
            # (hasattr/getattr-with-default must not explode)
            raise AttributeError(
                f"{method}: multiplexed_model_id applies to __call__ "
                f"requests (handle.remote); method calls are not "
                f"mux-routed")
        return getattr(self._handle, method)


class Deployment:
    """A deployable callable + its config (reference: serve/deployment.py)."""

    def __init__(self, target: Union[type, Callable], name: str,
                 config: Optional[Dict[str, Any]] = None):
        self._target = target
        self.name = name
        self.config = dict(config or {})
        self._init_args: tuple = ()
        self._init_kwargs: dict = {}

    def options(self, **kwargs) -> "Deployment":
        d = Deployment(self._target, kwargs.pop("name", self.name),
                       {**self.config, **kwargs})
        if any(k in d.config for k in ("priority", "max_queue_depth",
                                       "deadline_s")):
            from ray_tpu_torch.serve.qos import qos_from_config

            qos_from_config(d.config)  # validate eagerly, not at deploy
        d._init_args, d._init_kwargs = self._init_args, self._init_kwargs
        return d

    def bind(self, *args, **kwargs) -> "Deployment":
        d = Deployment(self._target, self.name, self.config)
        d._init_args, d._init_kwargs = args, kwargs
        return d

    def __call__(self, *a, **kw):
        raise RuntimeError(
            "deployments are not directly callable; use serve.run() and "
            "handle.remote()")


def deployment(_target=None, *, name: Optional[str] = None,
               num_replicas: int = 1, num_cpus: float = 0.1,
               num_gpus: float = 0, resources: Optional[dict] = None,
               max_batch_size: int = 0, batch_wait_timeout_s: float = 0.01,
               engine: bool = False,
               priority: Union[str, int, None] = None,
               max_queue_depth: Optional[int] = None,
               deadline_s: Optional[float] = None, **extra):
    """Decorator: wrap a class or function as a Deployment.

    QoS knobs (overload behavior; all optional, all overridable per
    request via ``handle.options()``): ``priority`` is the deployment's
    default priority class ("low"/"normal"/"high" or 0..2 — lower
    classes shed first under pressure), ``max_queue_depth`` bounds the
    per-router admission queue (0/unset = unbounded, falling back to the
    ``serve_max_queue_depth`` flag), ``deadline_s`` is a default
    end-to-end completion deadline — requests the router estimates
    unmeetable are rejected at admission with BackpressureError.

    ``num_gpus`` (the runtime's ``"GPU"`` resource; ``ray_tpu`` has
    ``num_tpus``) makes each replica a GPU actor whose worker sees its
    cards from ``cuda:0``: an engine deployment then serves on the card
    by default."""
    def wrap(target):
        if extra.get("autoscaling_config") and num_replicas != 1:
            raise ValueError(
                "num_replicas and autoscaling_config are mutually "
                "exclusive (the autoscaler owns the replica count; "
                "set min_replicas/max_replicas instead)")
        cfg = {"num_replicas": num_replicas, "num_cpus": num_cpus,
               "max_batch_size": max_batch_size,
               "batch_wait_timeout_s": batch_wait_timeout_s,
               "engine": engine, **extra}
        if num_gpus:
            cfg["num_gpus"] = num_gpus
        if resources:
            cfg["resources"] = resources
        if priority is not None:
            cfg["priority"] = priority
        if max_queue_depth is not None:
            cfg["max_queue_depth"] = max_queue_depth
        if deadline_s is not None:
            cfg["deadline_s"] = deadline_s
        if any(k in cfg for k in ("priority", "max_queue_depth",
                                  "deadline_s")):
            from ray_tpu_torch.serve.qos import qos_from_config

            qos_from_config(cfg)  # validate at decoration time
        return Deployment(target, name or target.__name__, cfg)
    return wrap(_target) if _target is not None else wrap


def batch(_fn=None, *, max_batch_size: int = 8,
          batch_wait_timeout_s: float = 0.01):
    """@serve.batch: mark a callable for router-side dynamic batching.
    The wrapped fn receives a LIST of inputs and returns a list of outputs
    (reference: serve/batching.py:80)."""
    def wrap(fn):
        fn.__serve_batch__ = {"max_batch_size": max_batch_size,
                              "batch_wait_timeout_s": batch_wait_timeout_s}
        return fn
    return wrap(_fn) if _fn is not None else wrap


# ------------------------------------------------------------------ control


def start():
    """Ensure the Serve control plane exists."""
    if not ray_tpu_torch.is_initialized():
        ray_tpu_torch.init()
    return get_or_create_controller()


def run(target: Deployment, name: Optional[str] = None,
        wait_for_healthy: bool = True, timeout: float = 120.0
        ) -> DeploymentHandle:
    """Deploy and return a handle (reference: serve.run, api.py:580)."""
    import cloudpickle

    controller = start()
    dep_name = name or target.name
    cfg = dict(target.config)
    cfg["init_args"] = target._init_args
    cfg["init_kwargs"] = target._init_kwargs
    # honor @serve.batch annotations on the callable
    fn = target._target
    marks = getattr(fn, "__serve_batch__", None) or getattr(
        getattr(fn, "__call__", None), "__serve_batch__", None)
    if marks and not cfg.get("max_batch_size"):
        cfg.update(marks)
    # generator deployments stream through ObjectRefGenerator: routers
    # read this to pick the handle.stream() transport
    import inspect

    call = fn if not isinstance(fn, type) else getattr(fn, "__call__", None)
    cfg["is_generator"] = bool(
        call is not None and (inspect.isgeneratorfunction(call)
                              or inspect.isasyncgenfunction(call)))
    ray_tpu_torch.get(controller.deploy.remote(
        dep_name, cloudpickle.dumps(fn), cfg), timeout=30)
    if wait_for_healthy:
        ok = ray_tpu_torch.get(
            controller.wait_healthy.remote(dep_name, timeout),
            timeout=timeout + 10)
        if not ok:
            raise TimeoutError(
                f"deployment {dep_name!r} did not become healthy")
    return DeploymentHandle(dep_name)


def get_deployment_handle(name: str) -> DeploymentHandle:
    return DeploymentHandle(name)


def status() -> Dict[str, Any]:
    controller = ray_tpu_torch.get_actor(CONTROLLER_NAME)
    return ray_tpu_torch.get(controller.status.remote(), timeout=30)


def delete(name: str):
    from ray_tpu_torch.serve import grpc_proxy
    from ray_tpu_torch.serve.router import stop_routers

    controller = ray_tpu_torch.get_actor(CONTROLLER_NAME)
    ray_tpu_torch.get(controller.delete_deployment.remote(name), timeout=30)
    stop_routers(name)
    grpc_proxy.invalidate(name)


def shutdown():
    from ray_tpu_torch.serve import grpc_proxy
    from ray_tpu_torch.serve.router import stop_routers

    stop_routers()
    grpc_proxy.invalidate()
    grpc_proxy.stop_grpc()
    try:
        controller = ray_tpu_torch.get_actor(CONTROLLER_NAME)
    except Exception:  # noqa: BLE001
        return
    try:
        ray_tpu_torch.get(controller.shutdown.remote(), timeout=30)
        ray_tpu_torch.kill(controller)
    except Exception:  # noqa: BLE001
        pass
