"""@remote functions (reference: python/ray/remote_function.py:40)."""

from __future__ import annotations

import functools
from typing import Any, List, Optional, Union

from ray_tpu_torch.core.object_ref import ObjectRef
from ray_tpu_torch.core import runtime_context


class RemoteFunction:
    """A function decorated with ``@ray_tpu_torch.remote``.

    Call with ``.remote(*args)`` → ObjectRef(s); ``.options(...)`` overrides
    per-call options (num_returns, num_cpus, resources, scheduling_strategy).
    """

    def __init__(self, fn, default_options: Optional[dict] = None):
        self._fn = fn
        self._default_options = dict(default_options or {})
        self._fn_id = None  # lazily registered per runtime
        self._fn_id_core = None
        self._pickled = None
        functools.update_wrapper(self, fn)

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Remote function {self._fn.__name__!r} cannot be called directly; "
            f"use {self._fn.__name__}.remote()."
        )

    def options(self, **opts) -> "_OptionWrapper":
        merged = dict(self._default_options)
        merged.update(opts)
        return _OptionWrapper(self, merged)

    def remote(self, *args, **kwargs) -> Union[ObjectRef, List[ObjectRef]]:
        return self._remote(args, kwargs, self._default_options)

    def _remote(self, args, kwargs, options) -> Union[ObjectRef, List[ObjectRef]]:
        core = runtime_context.get_core()
        num_returns = options.get("num_returns", 1)
        streaming = num_returns == "streaming"
        opts = {k: v for k, v in options.items() if k != "num_returns"}
        if opts.get("runtime_env") and hasattr(core, "prepare_runtime_env"):
            # package working_dir/py_modules paths into hash references
            opts["runtime_env"] = core.prepare_runtime_env(
                opts["runtime_env"])
        if hasattr(core, "submit_task") and hasattr(core, "register_function"):
            # driver path
            if self._fn_id is None or self._fn_id_core is not core:
                self._fn_id = core.register_function(self._fn)
                self._fn_id_core = core
            refs = core.submit_task(self._fn_id, args, kwargs,
                                    num_returns=num_returns, options=opts)
        else:
            # worker path: ship the pickled function on first use
            if self._pickled is None:
                from ray_tpu_torch.core import serialization
                import hashlib

                self._pickled = serialization.pack(self._fn)
                self._fn_id = hashlib.blake2b(
                    self._pickled, digest_size=16
                ).digest()
            refs = core.submit_task(self._fn_id, self._pickled, args, kwargs,
                                    num_returns, opts)
        if streaming:
            return _make_generator(core, refs[0].binary())
        return refs[0] if num_returns == 1 else refs

    @property
    def underlying_function(self):
        return self._fn

    def __reduce__(self):
        # Exclude runtime-bound state (fn_id cache holds the Runtime, which
        # is not picklable) so remote functions can be captured by other
        # remote functions' closures.
        return (_rebuild, (self._fn, self._default_options))


def _rebuild(fn, default_options):
    return RemoteFunction(fn, default_options)


def _make_generator(core, seed: bytes):
    """Wrap a streaming submission's seed id in an ObjectRefGenerator,
    capturing the producing node address when the core is cluster-aware
    (so the generator keeps working after being pickled cross-node)."""
    from ray_tpu_torch.core.object_ref import ObjectRefGenerator

    owner_of = getattr(core, "stream_owner", None)
    owner = owner_of(seed) if callable(owner_of) else None
    return ObjectRefGenerator(seed, core=core, owner=owner)


class _OptionWrapper:
    def __init__(self, rf: RemoteFunction, options: dict):
        self._rf = rf
        self._options = options

    def remote(self, *args, **kwargs):
        return self._rf._remote(args, kwargs, self._options)
