"""Crash-loop backoff for supervised jobs: exponential with FULL
jitter (reference: the AWS architecture-blog schedule the reference
runtime uses for actor restarts — delay ~ U(0, min(max, base * 2^n))).

Deterministic on (job_id, attempt): the agent that re-queues a crashed
job and the GCS orphan detector that re-queues a leased-out one compute
the SAME delay for the same attempt, so tests can replay the schedule
and two writers never fight over next_eligible_at.
"""

from __future__ import annotations

import random


def delay_for(job_id: str, attempt: int, base_s: float = 1.0,
              max_s: float = 30.0) -> float:
    """Seconds to wait before retry number ``attempt`` (0-based)."""
    cap = min(float(max_s), float(base_s) * (2 ** max(0, int(attempt))))
    return random.Random(f"{job_id}:{attempt}").uniform(0.0, cap)
