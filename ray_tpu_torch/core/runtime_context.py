"""Process-local runtime context: which core client this process uses.

Driver processes install a :class:`ray_tpu_torch.core.runtime.Runtime`; worker
processes install a :class:`ray_tpu_torch.core.worker_main.WorkerCore`. Both expose
the same core-client surface (submit_task/get_objects/put_object/...), the
analogue of the reference's per-process ``CoreWorker``
(src/ray/core_worker/core_worker.h:295).
"""

from __future__ import annotations

from typing import Optional

from ray_tpu_torch.exceptions import RuntimeNotInitializedError

_core = None


def set_core(core) -> None:
    global _core
    _core = core


def get_core():
    if _core is None:
        raise RuntimeNotInitializedError(
            "ray_tpu_torch is not initialized; call ray_tpu_torch.init() first."
        )
    return _core


def get_core_or_none():
    return _core


def is_initialized() -> bool:
    return _core is not None


class RuntimeContext:
    """User-visible context (reference: python/ray/runtime_context.py)."""

    @property
    def initialized(self) -> bool:
        return is_initialized()

    def get_node_id(self) -> Optional[str]:
        core = get_core_or_none()
        return core.node_id.hex() if core is not None else None

    def get_worker_id(self) -> Optional[str]:
        core = get_core_or_none()
        return core.worker_id.hex() if core is not None else None

    def get_actor_id(self) -> Optional[str]:
        core = get_core_or_none()
        aid = getattr(core, "current_actor_id", None)
        return aid.hex() if aid is not None else None

    def get_task_id(self) -> Optional[str]:
        core = get_core_or_none()
        tid = getattr(core, "current_task_id", None)
        return tid.hex() if tid is not None else None


def get_runtime_context() -> RuntimeContext:
    return RuntimeContext()
