"""Actor API (reference: python/ray/actor.py — ActorClass :566, ActorHandle :1223).

An actor is a stateful worker: ``@ray_tpu_torch.remote`` on a class gives an
``ActorClass``; ``.remote(...)`` instantiates it in a dedicated worker
process; method calls are submitted in order and return ObjectRefs.
"""

from __future__ import annotations

import functools
import inspect
from typing import Any, List, Optional, Union

from ray_tpu_torch.core.ids import ActorID
from ray_tpu_torch.core.object_ref import ObjectRef
from ray_tpu_torch.core import runtime_context


class ActorMethod:
    """Bound method accessor: ``handle.method.remote(args)``."""

    def __init__(self, handle: "ActorHandle", name: str, num_returns=1,
                 max_task_retries=None, retry_exceptions=None):
        self._handle = handle
        self._name = name
        self._num_returns = num_returns
        # None = inherit the class-level default (resolved runtime-side
        # from the actor's opts); reference: max_task_retries /
        # retry_exceptions on ray.method (python/ray/actor.py:566)
        self._max_task_retries = max_task_retries
        self._retry_exceptions = retry_exceptions

    def options(self, num_returns=None, max_task_retries=None,
                retry_exceptions=None):
        """Per-call overrides. Unknown keyword arguments raise TypeError
        (a typo like ``max_retires=`` must not pass silently); ``None``
        keeps the method's current setting."""
        return ActorMethod(
            self._handle, self._name,
            self._num_returns if num_returns is None else num_returns,
            (self._max_task_retries if max_task_retries is None
             else max_task_retries),
            (self._retry_exceptions if retry_exceptions is None
             else retry_exceptions),
        )

    def remote(self, *args, **kwargs) -> Union[ObjectRef, List[ObjectRef]]:
        core = runtime_context.get_core()
        call_opts = {}
        if self._max_task_retries is not None:
            call_opts["max_task_retries"] = self._max_task_retries
        if self._retry_exceptions is not None:
            call_opts["retry_exceptions"] = self._retry_exceptions
        refs = core.submit_actor_task(
            self._handle._actor_id, self._name, args, kwargs,
            num_returns=self._num_returns, options=call_opts or None,
        )
        if self._num_returns == "streaming":
            from ray_tpu_torch.core.remote_function import _make_generator

            return _make_generator(core, refs[0].binary())
        return refs[0] if self._num_returns == 1 else refs

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Actor method {self._name!r} cannot be called directly; "
            f"use .{self._name}.remote()."
        )


class ActorHandle:
    """Serializable reference to a live actor."""

    def __init__(self, actor_id: ActorID, method_opts: Optional[dict] = None):
        self._actor_id = actor_id
        self._method_opts = method_opts or {}

    @property
    def actor_id(self) -> ActorID:
        return self._actor_id

    def __getattr__(self, name: str) -> ActorMethod:
        if name.startswith("_"):
            raise AttributeError(name)
        opts = self._method_opts.get(name, {})
        return ActorMethod(self, name,
                           num_returns=opts.get("num_returns", 1),
                           max_task_retries=opts.get("max_task_retries"),
                           retry_exceptions=opts.get("retry_exceptions"))

    def __reduce__(self):
        return (ActorHandle, (self._actor_id, self._method_opts))

    def __repr__(self):
        return f"ActorHandle({self._actor_id.hex()[:12]})"


class ActorClass:
    """A class decorated with ``@ray_tpu_torch.remote``."""

    def __init__(self, cls, default_options: Optional[dict] = None):
        self._cls = cls
        self._default_options = dict(default_options or {})
        functools.update_wrapper(self, cls, updated=[])

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Actor class {self._cls.__name__!r} cannot be instantiated "
            f"directly; use {self._cls.__name__}.remote()."
        )

    def options(self, **opts) -> "_ActorOptionWrapper":
        merged = dict(self._default_options)
        merged.update(opts)
        return _ActorOptionWrapper(self, merged)

    def remote(self, *args, **kwargs) -> ActorHandle:
        return self._remote(args, kwargs, self._default_options)

    def _remote(self, args, kwargs, options) -> ActorHandle:
        core = runtime_context.get_core()
        opts = dict(options)
        opts["has_async_methods"] = any(
            inspect.iscoroutinefunction(m)
            for _, m in inspect.getmembers(self._cls, inspect.isfunction)
        )
        # Collect per-method options set via @ray_tpu_torch.method(...) so that
        # handles (including deserialized ones) know e.g. num_returns.
        method_opts = {
            name: m.__rtpu_method_opts__
            for name, m in inspect.getmembers(self._cls, inspect.isfunction)
            if getattr(m, "__rtpu_method_opts__", None)
        }
        opts["method_opts"] = method_opts
        if opts.get("runtime_env") and hasattr(core, "prepare_runtime_env"):
            # package working_dir/py_modules paths into hash references
            opts["runtime_env"] = core.prepare_runtime_env(
                opts["runtime_env"])
        if hasattr(core, "register_function"):
            cls_fn_id = core.register_function(self._cls)
            actor_id = core.create_actor(cls_fn_id, args, kwargs, opts)
        else:
            # worker path: ship the pickled class on first use
            from ray_tpu_torch.core import serialization
            import hashlib

            pickled = serialization.pack(self._cls)
            fn_id = hashlib.blake2b(pickled, digest_size=16).digest()
            actor_id = core.create_actor_from_worker(
                fn_id, pickled, args, kwargs, opts)
        return ActorHandle(actor_id, method_opts)

    @property
    def underlying_class(self):
        return self._cls

    def __reduce__(self):
        return (_rebuild_actor_class, (self._cls, self._default_options))


def _rebuild_actor_class(cls, default_options):
    return ActorClass(cls, default_options)


class _ActorOptionWrapper:
    def __init__(self, ac: ActorClass, options: dict):
        self._ac = ac
        self._options = options

    def remote(self, *args, **kwargs):
        return self._ac._remote(args, kwargs, self._options)


def get_actor(name: str) -> ActorHandle:
    """Look up a named actor (reference: ray.get_actor, worker.py:2904)."""
    core = runtime_context.get_core()
    if hasattr(core, "get_named_actor"):
        aid = core.get_named_actor(name)
        return ActorHandle(aid, core.get_actor_method_opts(aid))
    return core.get_actor_handle(name)
