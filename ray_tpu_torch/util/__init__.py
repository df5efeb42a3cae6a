"""ray_tpu_torch.util: placement groups and scheduling strategies (API
parity with the reference's ray.util namespace; the actor pool and the
queue come with the Train gang and Data).

Re-exports resolve lazily (PEP 562): deep core modules import
``ray_tpu_torch.util.debug_lock`` (the lock factory) at their own import
time, which executes this package ``__init__`` — eager re-imports of
``ray_tpu_torch.core.*`` here would close an import cycle through
``ray_tpu_torch.exceptions``.
"""

from typing import TYPE_CHECKING

_EXPORTS = {
    "PlacementGroup": ("ray_tpu_torch.core.placement_group", "PlacementGroup"),
    "placement_group": ("ray_tpu_torch.core.placement_group", "placement_group"),
    "placement_group_table": ("ray_tpu_torch.core.placement_group",
                              "placement_group_table"),
    "remove_placement_group": ("ray_tpu_torch.core.placement_group",
                               "remove_placement_group"),
    "NodeAffinitySchedulingStrategy": (
        "ray_tpu_torch.core.scheduling_strategies",
        "NodeAffinitySchedulingStrategy"),
    "PlacementGroupSchedulingStrategy": (
        "ray_tpu_torch.core.scheduling_strategies",
        "PlacementGroupSchedulingStrategy"),
}

__all__ = sorted(_EXPORTS) + ["host_node_pid"]

if TYPE_CHECKING:  # pragma: no cover — static analyzers only
    from ray_tpu_torch.core.placement_group import (  # noqa: F401
        PlacementGroup,
        placement_group,
        placement_group_table,
        remove_placement_group,
    )
    from ray_tpu_torch.core.scheduling_strategies import (  # noqa: F401
        NodeAffinitySchedulingStrategy,
        PlacementGroupSchedulingStrategy,
    )


def __getattr__(name: str):
    entry = _EXPORTS.get(name)
    if entry is None:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    import importlib

    value = getattr(importlib.import_module(entry[0]), entry[1])
    globals()[name] = value  # cache: resolve once
    return value


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))


def host_node_pid() -> int:
    """Pid of the node-server (or embedded-runtime driver) process that
    hosts this worker. Workers are spawned either directly (cold spawn)
    or by the node's fork zygote; this walks past any ``--zygote``
    ancestor so callers get a stable "which node am I on" answer
    (reference role: ray.get_runtime_context().get_node_id, but by
    process identity, which tests can match against fixture pids)."""
    import os

    pid = os.getppid()
    for _ in range(4):
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read().decode(errors="replace")
            if "--zygote" not in cmd:
                return pid
            with open(f"/proc/{pid}/stat") as f:
                pid = int(f.read().rsplit(")", 1)[1].split()[1])
        except (OSError, ValueError, IndexError):
            return pid
    return pid
