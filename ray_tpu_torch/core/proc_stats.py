"""Per-process resource stats from /proc — no psutil in the image.

Reference: dashboard/modules/reporter/reporter_agent.py:428 collects
per-worker CPU/RSS via psutil; here the same numbers come straight from
/proc/<pid>/stat (utime+stime jiffies) and /proc/<pid>/status (VmRSS).
CPU percent is a delta between successive samples, so callers keep a
_CpuTracker per polling context.
"""

from __future__ import annotations

import os
import tempfile
import time
from typing import Dict, Optional

_CLK_TCK = os.sysconf("SC_CLK_TCK") if hasattr(os, "sysconf") else 100


def stack_dump_path(pid: int) -> str:
    """The one place the worker stack-dump path is defined (the SIGUSR1
    handler writes it, the collector reads it)."""
    return os.path.join(tempfile.gettempdir(), f"rtpt_stack_{pid}.txt")


def sample_pid(pid: int) -> Optional[Dict[str, float]]:
    """{'cpu_jiffies', 'rss_bytes', 'num_threads'} or None if gone."""
    try:
        with open(f"/proc/{pid}/stat", "rb") as f:
            parts = f.read().rsplit(b") ", 1)[1].split()
        # post-comm fields: index 11/12 are utime/stime, 17 num_threads
        utime, stime = int(parts[11]), int(parts[12])
        threads = int(parts[17])
        rss = 0
        with open(f"/proc/{pid}/status", "rb") as f:
            for line in f:
                if line.startswith(b"VmRSS:"):
                    rss = int(line.split()[1]) * 1024
                    break
        return {"cpu_jiffies": float(utime + stime),
                "rss_bytes": float(rss), "num_threads": float(threads)}
    except (OSError, ValueError, IndexError):
        return None


class CpuTracker:
    """Turns successive jiffy samples into cpu_percent per pid."""

    def __init__(self):
        self._last: Dict[int, tuple] = {}

    def prune(self, live_pids) -> None:
        """Drop samples for exited workers — a recycled pid must never
        diff against the dead process's jiffies."""
        live = set(live_pids)
        for pid in list(self._last):
            if pid not in live:
                del self._last[pid]

    def stats(self, pid: int) -> Optional[Dict[str, float]]:
        s = sample_pid(pid)
        if s is None:
            self._last.pop(pid, None)
            return None
        now = time.monotonic()
        prev = self._last.get(pid)
        self._last[pid] = (now, s["cpu_jiffies"])
        cpu_pct = 0.0
        if prev is not None and now > prev[0]:
            cpu_pct = ((s["cpu_jiffies"] - prev[1]) / _CLK_TCK
                       / (now - prev[0]) * 100.0)
        return {"cpu_percent": round(cpu_pct, 2),
                "rss_bytes": int(s["rss_bytes"]),
                "num_threads": int(s["num_threads"])}
