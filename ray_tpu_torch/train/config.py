"""Train/AIR config dataclasses.

Reference surface: python/ray/air/config.py (ScalingConfig, RunConfig,
FailureConfig, CheckpointConfig). The port's copy of
``ray_tpu/train/config.py``: ``ScalingConfig`` speaks GPUs (``use_gpu``,
``gpus_per_worker``, the ``"GPU"`` resource) where the reference speaks
TPU chips, and has no ``topology`` (an ICI hint with no GPU
counterpart). The other three are copied as they are.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, Optional


@dataclass
class ScalingConfig:
    """How many training workers, and what each one holds.

    num_workers: size of the worker gang (one actor per worker).
    use_gpu: reserve GPUs for each worker; each worker is then an actor
        with ``num_gpus=gpus_per_worker``, in a worker process of its own
        whose ``CUDA_VISIBLE_DEVICES`` names its cards.
    gpus_per_worker: GPUs each worker owns (the "GPU" resource; default 1).
    resources_per_worker: extra custom resources per worker.
    placement_strategy: bundle placement (PACK/SPREAD/STRICT_PACK/STRICT_SPREAD).
    min_workers / max_workers: set min_workers to make the gang ELASTIC —
        a worker death becomes a resize event (shrink and continue from
        the last consistent checkpoint) instead of a gang failure, as long
        as at least min_workers survive; the gang grows back toward
        min(num_workers, max_workers) when capacity returns. Leave
        min_workers unset for the classic all-or-nothing gang.
    """

    num_workers: int = 1
    use_gpu: bool = False
    gpus_per_worker: Optional[int] = None
    num_cpus_per_worker: float = 1.0
    resources_per_worker: Optional[Dict[str, float]] = None
    placement_strategy: str = "PACK"
    min_workers: Optional[int] = None
    max_workers: Optional[int] = None

    def __post_init__(self):
        if self.min_workers is not None:
            if not 1 <= self.min_workers <= self.num_workers:
                raise ValueError(
                    f"min_workers={self.min_workers} must be in "
                    f"[1, num_workers={self.num_workers}]")
        if self.max_workers is not None and self.max_workers < self.num_workers:
            raise ValueError(
                f"max_workers={self.max_workers} must be >= "
                f"num_workers={self.num_workers}")

    @property
    def elastic(self) -> bool:
        return self.min_workers is not None

    @property
    def gpus(self) -> int:
        """GPUs of one worker (0 without ``use_gpu``)."""
        return int(self.gpus_per_worker or 1) if self.use_gpu else 0

    def bundle_for_worker(self) -> Dict[str, float]:
        b: Dict[str, float] = {}
        if self.num_cpus_per_worker:
            b["CPU"] = float(self.num_cpus_per_worker)
        if self.use_gpu:
            b["GPU"] = float(self.gpus)
        for k, v in (self.resources_per_worker or {}).items():
            b[k] = float(v)
        return b

    @property
    def total_gpus(self) -> int:
        return self.gpus * self.num_workers


@dataclass
class FailureConfig:
    """Gang fault tolerance: restart the whole worker group from the last
    checkpoint up to ``max_failures`` times (reference: air/config.py
    FailureConfig; executor restart in train/_internal/backend_executor.py)."""

    max_failures: int = 0
    # Preemptions (PreemptedError after a SIGTERM maintenance event) are
    # scheduled, not faults: they restart the gang WITHOUT consuming
    # max_failures, bounded by this cap so a mis-signalled fleet cannot
    # restart-loop forever.
    max_preemptions: int = 16


@dataclass
class CheckpointConfig:
    """Top-k checkpoint retention (reference: air/config.py CheckpointConfig,
    enforced by train/_internal/checkpoint_manager.py)."""

    num_to_keep: Optional[int] = None
    checkpoint_score_attribute: Optional[str] = None
    checkpoint_score_order: str = "max"
    checkpoint_frequency: int = 0

    def __post_init__(self):
        if self.checkpoint_score_order not in ("max", "min"):
            raise ValueError("checkpoint_score_order must be 'max' or 'min'")


@dataclass
class RunConfig:
    """Experiment-level config (reference: air/config.py RunConfig)."""

    name: Optional[str] = None
    storage_path: Optional[str] = None
    failure_config: FailureConfig = field(default_factory=FailureConfig)
    checkpoint_config: CheckpointConfig = field(default_factory=CheckpointConfig)
    verbose: int = 1
    log_to_file: bool = False

    def resolved_storage_path(self) -> str:
        if self.storage_path:
            return self.storage_path
        return os.environ.get(
            "RAY_TPU_STORAGE_PATH",
            os.path.join(os.path.expanduser("~"), "ray_tpu_results"),
        )
