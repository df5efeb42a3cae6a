"""Scheduling strategies (reference: python/ray/util/scheduling_strategies.py).

On the single-node runtime these mostly affect resource accounting (which
pool a task/actor draws from); the node-selection semantics activate with
the multi-node control plane.
"""

from __future__ import annotations

from typing import Optional


class PlacementGroupSchedulingStrategy:
    """Schedule into a placement group bundle's reserved resources."""

    def __init__(self, placement_group, placement_group_bundle_index: int = -1,
                 placement_group_capture_child_tasks: bool = False):
        self.placement_group = placement_group
        self.placement_group_bundle_index = placement_group_bundle_index
        self.placement_group_capture_child_tasks = placement_group_capture_child_tasks

    def _to_wire(self):
        return ("pg", self.placement_group.id.binary(),
                self.placement_group_bundle_index)


class NodeAffinitySchedulingStrategy:
    """Pin to a node (single-node: validated, then trivial)."""

    def __init__(self, node_id: str, soft: bool = False):
        self.node_id = node_id
        self.soft = soft

    def _to_wire(self):
        return ("node", self.node_id, self.soft)


# String strategies "DEFAULT" and "SPREAD" are accepted as-is.
