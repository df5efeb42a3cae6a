"""Alias module mirroring ray.util.scheduling_strategies."""

from ray_tpu_torch.core.scheduling_strategies import (  # noqa: F401
    NodeAffinitySchedulingStrategy,
    PlacementGroupSchedulingStrategy,
)
