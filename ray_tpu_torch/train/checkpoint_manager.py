"""Top-k checkpoint retention (reference:
python/ray/train/_internal/checkpoint_manager.py). The port's copy of
``ray_tpu/train/checkpoint_manager.py``."""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.config import CheckpointConfig
from ray_tpu_torch.train.storage import StorageContext, validate_checkpoint_dir

logger = logging.getLogger(__name__)


@dataclass
class _TrackedCheckpoint:
    checkpoint: Checkpoint
    index: int
    metrics: Dict[str, Any]

    def score(self, attr: str):
        return self.metrics.get(attr)


class CheckpointManager:
    def __init__(self, storage: StorageContext, config: CheckpointConfig):
        self.storage = storage
        self.config = config
        self.checkpoints: List[_TrackedCheckpoint] = []
        self._next_index = 0

    def register(self, local_dir: str, metrics: Dict[str, Any]) -> Checkpoint:
        """Persist a worker-written checkpoint dir and apply retention."""
        idx = self._next_index
        ckpt = self.storage.persist_checkpoint_dir(local_dir, idx)
        return self._track(ckpt, idx, metrics)

    def register_persisted(self, path: str, metrics: Dict[str, Any]) -> Checkpoint:
        """Track a checkpoint a worker already uploaded to storage."""
        return self._track(Checkpoint(path, self.storage.fs),
                           self._next_index, metrics)

    def _track(self, ckpt: Checkpoint, idx: int,
               metrics: Dict[str, Any]) -> Checkpoint:
        self._next_index = idx + 1
        self.checkpoints.append(_TrackedCheckpoint(ckpt, idx, dict(metrics)))
        self._enforce_retention()
        return ckpt

    @property
    def next_index(self) -> int:
        return self._next_index

    @property
    def latest(self) -> Optional[Checkpoint]:
        return self.checkpoints[-1].checkpoint if self.checkpoints else None

    def latest_consistent(self) -> Optional[Checkpoint]:
        """The newest tracked checkpoint that passes manifest validation.

        Torn/partial dirs (the persisting worker died mid-commit, or the
        dir was damaged after the fact) are dropped from tracking with a
        warning and the walk continues to the previous checkpoint —
        resume never crashes on a bad dir, it just loses fewer-than-all
        steps."""
        while self.checkpoints:
            tc = self.checkpoints[-1]
            if validate_checkpoint_dir(tc.checkpoint.path,
                                       tc.checkpoint.filesystem):
                return tc.checkpoint
            logger.warning(
                "checkpoint %s is torn/partial (manifest validation "
                "failed); falling back to the previous checkpoint",
                tc.checkpoint.path)
            self.checkpoints.pop()
        return None

    @property
    def best(self) -> Optional[Checkpoint]:
        attr = self.config.checkpoint_score_attribute
        if not self.checkpoints:
            return None
        if not attr:
            return self.latest
        scored = [c for c in self.checkpoints if c.score(attr) is not None]
        if not scored:
            return self.latest
        key = lambda c: c.score(attr)  # noqa: E731
        pick = max if self.config.checkpoint_score_order == "max" else min
        return pick(scored, key=key).checkpoint

    def _enforce_retention(self):
        k = self.config.num_to_keep
        if k is None or len(self.checkpoints) <= k:
            return
        attr = self.config.checkpoint_score_attribute
        # Never delete the most recent checkpoint (it's the resume point).
        candidates = self.checkpoints[:-1]
        if attr:
            order_max = self.config.checkpoint_score_order == "max"
            candidates = sorted(
                candidates,
                key=lambda c: (c.score(attr) is not None,
                               c.score(attr) if c.score(attr) is not None else 0),
                reverse=order_max,
            )
        n_delete = len(self.checkpoints) - k
        doomed = candidates[-n_delete:]
        for tc in doomed:
            self.storage.delete_checkpoint(tc.checkpoint)
            self.checkpoints.remove(tc)
