"""Model multiplexing: many model variants served by one replica pool.

The port's copy of ``ray_tpu/serve/multiplex.py``.

Reference: python/ray/serve/multiplex.py:39 (_ModelMultiplexWrapper) +
handle.options(multiplexed_model_id=...). A deployment marks its loader
with @serve.multiplexed(max_num_models_per_replica=N); each replica keeps
an LRU of loaded variants, requests carry a model id, and the router
prefers the replica that already holds the requested variant (cache-aware
routing), falling back to power-of-two when it is overloaded or gone.
"""

from __future__ import annotations

import contextvars
import functools
from collections import OrderedDict

_current_model_id: "contextvars.ContextVar[str]" = contextvars.ContextVar(
    "rtpu_mux_model_id", default="")

_MUX_KWARG = "__mux_model_id"  # reserved kwarg carrying the id on the wire


def get_multiplexed_model_id() -> str:
    """Inside a multiplexed deployment: the current request's model id
    (reference: serve.get_multiplexed_model_id)."""
    return _current_model_id.get()


def multiplexed(max_num_models_per_replica: int = 3):
    """Mark a loader method ``def load(self, model_id) -> model``: calls
    are cached per model id in an LRU bounded by
    ``max_num_models_per_replica`` (eviction simply drops the reference —
    JAX arrays free their HBM when the last ref dies)."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(self, model_id: str):
            cache: "OrderedDict" = self.__dict__.setdefault(
                "__rtpu_mux_cache__", OrderedDict())
            if model_id in cache:
                cache.move_to_end(model_id)
                return cache[model_id]
            model = fn(self, model_id)
            cache[model_id] = model
            while len(cache) > max_num_models_per_replica:
                cache.popitem(last=False)
            return model

        wrapper.__serve_multiplexed__ = True
        wrapper.max_num_models_per_replica = max_num_models_per_replica
        return wrapper

    return deco
