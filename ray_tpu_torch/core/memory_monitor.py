"""Node memory monitor + OOM worker-killing policy.

Reference: src/ray/common/memory_monitor.h:52 (threshold polling of
cgroup/host memory) and raylet/worker_killing_policy_group_by_owner.h
(group tasks by owner, kill the newest retriable task first, retries
don't consume the task's budget).

Two accounting modes:
- host (default): usage fraction of cgroup v2 limit when present, else
  /proc/meminfo (1 - MemAvailable/MemTotal). This is what production
  nodes run.
- bounded: ``RTPU_MEMORY_LIMIT_BYTES`` > 0 caps the WORKER TREE's
  summed RSS. Deterministic for tests and useful to fence the framework
  off from co-tenant processes on shared TPU-VM hosts.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

_PAGE = os.sysconf("SC_PAGE_SIZE")


def cgroup_memory() -> Optional[Tuple[int, int]]:
    """(used, limit) from cgroup v2, or None when unlimited/absent."""
    try:
        with open("/sys/fs/cgroup/memory.max") as f:
            raw = f.read().strip()
        if raw == "max":
            return None
        limit = int(raw)
        with open("/sys/fs/cgroup/memory.current") as f:
            used = int(f.read().strip())
        return used, limit
    except (OSError, ValueError):
        return None


def host_memory() -> Tuple[int, int]:
    """(used, total) from /proc/meminfo (available-based, like the
    reference's MemoryMonitor::GetLinuxMemoryBytes)."""
    total = avail = 0
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemTotal:"):
                total = int(line.split()[1]) * 1024
            elif line.startswith("MemAvailable:"):
                avail = int(line.split()[1]) * 1024
            if total and avail:
                break
    return total - avail, total


def process_rss(pid: int) -> int:
    try:
        with open(f"/proc/{pid}/statm") as f:
            return int(f.read().split()[1]) * _PAGE
    except (OSError, ValueError, IndexError):
        return 0


def _descendants(roots: List[int]) -> List[int]:
    """roots + every live descendant, via one /proc scan (tasks may fork
    helpers — multiprocessing pools, DataLoader workers — whose memory
    must count against the tree bound)."""
    children: dict = {}
    try:
        for entry in os.listdir("/proc"):
            if not entry.isdigit():
                continue
            try:
                with open(f"/proc/{entry}/stat") as f:
                    ppid = int(f.read().rsplit(")", 1)[1].split()[1])
            except (OSError, ValueError, IndexError):
                continue
            children.setdefault(ppid, []).append(int(entry))
    except OSError:
        return list(roots)
    out, queue = [], list(roots)
    seen = set()
    while queue:
        pid = queue.pop()
        if pid in seen:
            continue
        seen.add(pid)
        out.append(pid)
        queue.extend(children.get(pid, ()))
    return out


def tree_rss(pids: List[int]) -> int:
    return sum(process_rss(p) for p in _descendants(pids))


class MemoryMonitor:
    """Computes the current memory-usage fraction for the kill policy."""

    def __init__(self, limit_bytes: int = 0):
        self.limit_bytes = limit_bytes  # 0 -> host mode

    def usage_fraction(self, worker_pids: List[int]) -> float:
        if self.limit_bytes > 0:
            return tree_rss(worker_pids) / self.limit_bytes
        cg = cgroup_memory()
        if cg is not None:
            used, limit = cg
            return used / max(1, limit)
        used, total = host_memory()
        return used / max(1, total)
