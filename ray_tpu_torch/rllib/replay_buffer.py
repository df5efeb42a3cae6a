"""Replay buffers for the off-policy drivers (DQN / SAC).

The port's copy of ``ray_tpu/rllib/replay_buffer.py``: flat
preallocated numpy rings sampled from ``np.random.default_rng(seed)``
(the same draws, so samples and ``_indices`` equal the reference's bit
for bit), which feed a learner's stacked ``update_many``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np


class ReplayBuffer:
    """Uniform ring buffer over transition columns."""

    def __init__(self, capacity: int, seed: int = 0):
        self.capacity = int(capacity)
        self._cols: Optional[Dict[str, np.ndarray]] = None
        self._size = 0
        self._next = 0
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return self._size

    def add_batch(self, batch: Dict[str, np.ndarray]) -> None:
        n = len(next(iter(batch.values())))
        if self._cols is None:
            self._cols = {
                k: np.empty((self.capacity,) + np.asarray(v).shape[1:],
                            np.asarray(v).dtype)
                for k, v in batch.items()
            }
        idx = (self._next + np.arange(n)) % self.capacity
        for k, v in batch.items():
            self._cols[k][idx] = v
        self._next = int((self._next + n) % self.capacity)
        self._size = int(min(self._size + n, self.capacity))

    def sample_indices(self, batch_size: int) -> np.ndarray:
        return self._rng.integers(0, self._size, size=batch_size)

    def sample(self, batch_size: int) -> Dict[str, np.ndarray]:
        idx = self.sample_indices(batch_size)
        return {k: v[idx] for k, v in self._cols.items()}

    def sample_many(self, num_batches: int, batch_size: int
                    ) -> Dict[str, np.ndarray]:
        """Stacked [U, B, ...] columns for one-dispatch scan updates."""
        idx = self._rng.integers(0, self._size,
                                 size=(num_batches, batch_size))
        return {k: v[idx] for k, v in self._cols.items()}


class PrioritizedReplayBuffer(ReplayBuffer):
    """Proportional prioritized replay (PER, Schaul et al. 2015).

    Priorities are kept as a flat numpy array; sampling is a single
    vectorized choice over p^alpha — O(n) per sample round, fine for the
    <=1e6-entry buffers the drivers hold (no sum-tree).
    """

    def __init__(self, capacity: int, alpha: float = 0.6,
                 beta: float = 0.4, seed: int = 0):
        super().__init__(capacity, seed=seed)
        self.alpha = float(alpha)
        self.beta = float(beta)
        self._prio = np.zeros(capacity, np.float64)
        self._max_prio = 1.0

    def add_batch(self, batch: Dict[str, np.ndarray]) -> None:
        n = len(next(iter(batch.values())))
        idx = (self._next + np.arange(n)) % self.capacity
        super().add_batch(batch)
        self._prio[idx] = self._max_prio

    def _probs(self) -> np.ndarray:
        p = self._prio[: self._size] ** self.alpha
        return p / p.sum()

    def sample_many(self, num_batches: int, batch_size: int
                    ) -> Dict[str, np.ndarray]:
        probs = self._probs()
        idx = self._rng.choice(self._size, size=(num_batches, batch_size),
                               p=probs)
        weights = (self._size * probs[idx]) ** (-self.beta)
        weights /= weights.max()
        out = {k: v[idx] for k, v in self._cols.items()}
        out["weights"] = weights.astype(np.float32)
        out["_indices"] = idx
        return out

    def update_priorities(self, indices: np.ndarray,
                          td_errors: np.ndarray) -> None:
        prio = np.abs(np.asarray(td_errors, np.float64)).reshape(-1) + 1e-6
        self._prio[np.asarray(indices).reshape(-1)] = prio
        self._max_prio = max(self._max_prio, float(prio.max()))
