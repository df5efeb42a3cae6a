"""Result of a training/tuning run (reference: python/ray/air/result.py).
The port's copy of ``ray_tpu/train/result.py``; pandas stays a lazy
import (``metrics_dataframe`` alone needs it)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from ray_tpu_torch.train.checkpoint import Checkpoint


@dataclass
class Result:
    metrics: Dict[str, Any]
    checkpoint: Optional[Checkpoint] = None
    error: Optional[BaseException] = None
    path: str = ""
    metrics_history: List[Dict[str, Any]] = field(default_factory=list)
    # One entry per elastic resize the run rode through: {event:
    # "shrink"|"grow", old_world, new_world, cause, resume_s}.
    elastic_stats: List[Dict[str, Any]] = field(default_factory=list)

    @property
    def metrics_dataframe(self):
        import pandas as pd

        return pd.DataFrame(self.metrics_history)

    def __repr__(self):
        keys = {k: v for k, v in (self.metrics or {}).items()
                if not k.startswith("_")}
        return (f"Result(metrics={keys}, checkpoint={self.checkpoint}, "
                f"error={self.error!r})")
