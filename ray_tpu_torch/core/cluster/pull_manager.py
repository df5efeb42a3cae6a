"""Pull admission control for cross-node object fetches.

Reference: src/ray/object_manager/pull_manager.h:52 — the reference caps
in-flight pulls by available object-store memory and services requests in
priority order (task arguments first, then explicit ray.get, then
ray.wait). Same policy here: each fetch reserves its payload size before
transferring; the budget derives from the store's capacity, so a wide
fetch fan-in queues instead of over-committing store + heap.

A pull larger than the whole budget is admitted only when nothing else is
in flight (a single oversized object must still make progress — the
reference relaxes its cap the same way)."""

from __future__ import annotations

import heapq
import threading
import time
from typing import Optional

from ray_tpu_torch.util.debug_lock import make_lock

PRIO_TASK_ARGS = 0
PRIO_GET = 1
PRIO_WAIT = 2

_PRIO_NAMES = {PRIO_TASK_ARGS: "task_args", PRIO_GET: "get",
               PRIO_WAIT: "wait"}


def prio_name(p: int) -> str:
    return _PRIO_NAMES.get(p, str(p))


class PullManager:
    """Byte-budgeted, priority-ordered admission for object pulls."""

    def __init__(self, budget_bytes: int):
        self.budget_bytes = max(1, budget_bytes)
        self._inflight = 0
        self._seq = 0
        self._waiting = []  # heap of (priority, seq); head = next admitted
        self._granted = set()
        self._cv = threading.Condition(make_lock("PullManager._cv"))

    def acquire(self, nbytes: int, priority=PRIO_GET,
                timeout: Optional[float] = None) -> bool:
        """Block until ``nbytes`` of transfer budget is granted (False on
        timeout). Strict priority: only the best-priority waiter is
        admitted next, so task-argument pulls overtake queued get/wait
        pulls during pressure.

        ``priority`` may be a 1-element mutable list ("priority box"): a
        concurrent upgrade (ensure_available from a more urgent
        requester) takes effect at the next wakeup WITHOUT losing the
        waiter's queue position — its original seq is kept, so smaller
        same-priority pulls can never leapfrog it (an oversized pull at
        the head eventually sees inflight==0 and is admitted)."""
        box = priority if isinstance(priority, list) else [priority]
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            me = [box[0], self._seq]  # mutable: priority may upgrade
            self._seq += 1
            heapq.heappush(self._waiting, me)
            try:
                while True:
                    if box[0] != me[0]:
                        # re-rank under the upgraded priority, SAME seq
                        me[0] = box[0]
                        heapq.heapify(self._waiting)
                    if self._waiting[0] is me and (
                            self._inflight == 0
                            or self._inflight + nbytes
                            <= self.budget_bytes):
                        self._inflight += nbytes
                        return True
                    remaining = (None if deadline is None
                                 else deadline - time.monotonic())
                    if remaining is not None and remaining <= 0:
                        return False
                    # bounded wait: a priority-box upgrade has no
                    # notifier, so re-check it at least once a second
                    self._cv.wait(1.0 if remaining is None
                                  else min(remaining, 1.0))
            finally:
                # success or timeout: leave the queue either way
                self._waiting.remove(me)
                heapq.heapify(self._waiting)
                self._cv.notify_all()

    def release(self, nbytes: int):
        with self._cv:
            self._inflight -= nbytes
            self._cv.notify_all()

    def stats(self) -> dict:
        with self._cv:
            return {"inflight_bytes": self._inflight,
                    "budget_bytes": self.budget_bytes,
                    "queued": len(self._waiting)}
