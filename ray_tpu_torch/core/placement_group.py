"""Placement groups: gang resource reservation with GPUs bound to bundles.

Reference behavior: python/ray/util/placement_group.py:145 (API),
gcs_placement_group_manager.h:230 (lifecycle) and the bundle policies
PACK/SPREAD/STRICT_PACK/STRICT_SPREAD
(raylet/scheduling/policy/bundle_scheduling_policy.h:31).

A bundle requesting ``{"GPU": n}`` is bound to ``n`` concrete GPU ids of
the node (``ray_tpu`` binds ``{"TPU": n}`` to ICI-contiguous chips of its
slice; a node's GPUs need no contiguity). STRICT_PACK keeps its meaning,
the whole group on one node.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

from ray_tpu_torch.core.ids import PlacementGroupID
from ray_tpu_torch.core.resources import ResourceSet
from ray_tpu_torch.exceptions import PlacementGroupError

VALID_STRATEGIES = ("PACK", "SPREAD", "STRICT_PACK", "STRICT_SPREAD")


class Bundle:
    """One reserved resource bundle inside a PG."""

    __slots__ = ("index", "spec", "reserved", "consumed", "gpu_ids",
                 "free_gpu_ids")

    def __init__(self, index: int, spec: Dict[str, float]):
        self.index = index
        self.spec = dict(spec)
        self.reserved = ResourceSet(spec)
        self.consumed = ResourceSet()
        self.gpu_ids: List[str] = []       # concrete GPU ids, if any
        self.free_gpu_ids: List[str] = []  # not yet assigned to an actor

    def take_gpus(self, n: int) -> List[str]:
        taken = self.free_gpu_ids[:n]
        self.free_gpu_ids = self.free_gpu_ids[n:]
        return taken

    def return_gpus(self, ids: List[str]):
        self.free_gpu_ids.extend(ids)

    def can_fit(self, req: ResourceSet) -> bool:
        return (self.consumed + req).is_subset_of(self.reserved)

    def acquire(self, req: ResourceSet):
        if not self.can_fit(req):
            raise PlacementGroupError(
                f"bundle {self.index} cannot fit {req.to_dict()} "
                f"(reserved={self.reserved.to_dict()}, "
                f"used={self.consumed.to_dict()})"
            )
        self.consumed = self.consumed + req

    def release(self, req: ResourceSet):
        self.consumed = self.consumed - req


class PlacementGroupState:
    """Driver-side state for one PG."""

    def __init__(self, pg_id: PlacementGroupID, bundles: List[Dict[str, float]],
                 strategy: str, name: Optional[str]):
        self.id = pg_id
        self.strategy = strategy
        self.name = name
        self.bundles = [Bundle(i, b) for i, b in enumerate(bundles)]
        self.ready_event = threading.Event()
        self.removed = False
        self.infeasible_reason: Optional[str] = None

    def total_request(self) -> ResourceSet:
        total = ResourceSet()
        for b in self.bundles:
            total = total + b.reserved
        return total

    def find_bundle(self, req: ResourceSet, index: int = -1) -> Optional[Bundle]:
        if index >= len(self.bundles):
            return None
        if index >= 0:
            b = self.bundles[index]
            return b if b.can_fit(req) else None
        for b in self.bundles:
            if b.can_fit(req):
                return b
        return None


class PlacementGroup:
    """User-facing handle (serializable)."""

    def __init__(self, pg_id: PlacementGroupID,
                 bundles: Optional[List[Dict[str, float]]] = None):
        self._id = pg_id
        self._bundles = bundles or []

    @property
    def id(self) -> PlacementGroupID:
        return self._id

    @property
    def bundle_specs(self) -> List[Dict[str, float]]:
        return list(self._bundles)

    @property
    def bundle_count(self) -> int:
        return len(self._bundles)

    def ready(self):
        """ObjectRef resolving to True once all bundles are reserved
        (reference: PlacementGroup.ready(), util/placement_group.py:74)."""
        from ray_tpu_torch.core import runtime_context

        core = runtime_context.get_core()
        return core.placement_group_ready_ref(self._id)

    def wait(self, timeout_seconds: float = 30.0) -> bool:
        from ray_tpu_torch.core import runtime_context

        core = runtime_context.get_core()
        return core.wait_placement_group(self._id, timeout_seconds)

    def gpus_for_bundle(self, index: int) -> List[str]:
        """Concrete GPU ids bound to a bundle (the counterpart of
        ``ray_tpu``'s ``chips_for_bundle``)."""
        from ray_tpu_torch.core import runtime_context

        core = runtime_context.get_core()
        return core.placement_group_gpus(self._id, index)

    def __reduce__(self):
        return (PlacementGroup, (self._id, self._bundles))

    def __repr__(self):
        return f"PlacementGroup({self._id.hex()[:12]}, {len(self._bundles)} bundles)"


def placement_group(bundles: List[Dict[str, float]], strategy: str = "PACK",
                    name: Optional[str] = None, lifetime: Optional[str] = None
                    ) -> PlacementGroup:
    """Reserve a gang of resource bundles.

    Mirrors ray.util.placement_group (util/placement_group.py:145).
    """
    if strategy not in VALID_STRATEGIES:
        raise ValueError(
            f"strategy must be one of {VALID_STRATEGIES}, got {strategy!r}"
        )
    if not bundles:
        raise ValueError("placement group requires at least one bundle")
    for b in bundles:
        if not b or any(v <= 0 for v in b.values()):
            raise ValueError(f"invalid bundle {b!r}")
    from ray_tpu_torch.core import runtime_context

    core = runtime_context.get_core()
    return core.create_placement_group(bundles, strategy, name)


def remove_placement_group(pg: PlacementGroup) -> None:
    from ray_tpu_torch.core import runtime_context

    runtime_context.get_core().remove_placement_group(pg.id)


def placement_group_table() -> Dict[str, dict]:
    from ray_tpu_torch.core import runtime_context

    return runtime_context.get_core().placement_group_table()
