"""Worker log capture + streaming to the driver.

Reference: python/ray/_private/log_monitor.py — there, a per-node monitor
process tails ``session/logs/worker-*.out|err`` and publishes records over
GCS pubsub; the driver prints them with ``(pid=..., ip=...)`` prefixes.
Here the monitor is a daemon thread inside the driver runtime (and inside
each NodeServer) tailing the session's log directory; remote logs are
served through the node RPC plane (state API ``get_log``).
"""

from __future__ import annotations

import os
import sys
import threading
from typing import Dict, Optional, TextIO


def worker_log_paths(log_dir: str, worker_id_hex: str):
    short = worker_id_hex[:8]
    return (os.path.join(log_dir, f"worker-{short}.out"),
            os.path.join(log_dir, f"worker-{short}.err"))


class LogMonitor:
    """Tails every ``worker-*.out|err`` file in ``log_dir`` and forwards
    new lines to ``sink`` (driver stderr by default) with a
    ``(worker=<id> <stream>)`` prefix."""

    def __init__(self, log_dir: str, sink: Optional[TextIO] = None,
                 interval_s: float = 0.2, prefix_node: str = ""):
        self._log_dir = log_dir
        self._sink = sink
        self._interval = interval_s
        self._prefix_node = prefix_node
        self._offsets: Dict[str, int] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._partial: Dict[str, bytes] = {}

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "LogMonitor":
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="rtpu-log-monitor")
        self._thread.start()
        return self

    def stop(self, flush: bool = True) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
        if flush:
            self.poll_once()
            # a crashed worker's final write may lack the newline — force
            # the stashed partials out so nothing is silently dropped
            for name in list(self._partial):
                self._emit(name, b"\n")

    # -- tailing -----------------------------------------------------------

    def _run(self) -> None:
        while not self._stop.wait(self._interval):
            try:
                self.poll_once()
            # rtpu-lint: disable=L4 — crash-proof daemon loop: losing the
            # log monitor silently drops all worker output for the rest
            # of the session; whatever one poll hit, the next one retries
            except Exception:  # noqa: BLE001 — never kill the monitor
                pass

    def poll_once(self) -> None:
        """One scan over the log dir; forwards any appended lines."""
        try:
            names = sorted(os.listdir(self._log_dir))
        except OSError:
            return
        for name in names:
            if not (name.startswith("worker-")
                    and name.endswith((".out", ".err"))):
                continue
            path = os.path.join(self._log_dir, name)
            try:
                size = os.path.getsize(path)
            except OSError:
                continue
            off = self._offsets.get(name, 0)
            if size <= off:
                continue
            try:
                # binary mode: offsets are byte positions; text-mode reads
                # count characters and would duplicate/garble multibyte
                # output appended concurrently
                with open(path, "rb") as f:
                    f.seek(off)
                    chunk = f.read(size - off)
            except OSError:
                continue
            self._offsets[name] = off + len(chunk)
            self._emit(name, chunk)

    def _emit(self, name: str, chunk: bytes) -> None:
        sink = self._sink if self._sink is not None else sys.stderr
        # worker-<id8>.out -> (worker=<id8> out)
        stem, _, kind = name.rpartition(".")
        wid = stem[len("worker-"):]
        data = self._partial.pop(name, b"") + chunk
        lines = data.split(b"\n")
        # keep an unterminated tail for the next poll
        if lines and lines[-1]:
            self._partial[name] = lines[-1]
        node = f" node={self._prefix_node}" if self._prefix_node else ""
        for line in lines[:-1]:
            try:
                text = line.decode("utf-8", errors="replace")
                sink.write(f"(worker={wid}{node} {kind}) {text}\n")
            except (OSError, ValueError):
                return  # sink closed (interpreter teardown) — stop emitting
        try:
            sink.flush()
        except (OSError, ValueError):
            pass


def list_log_files(log_dir: str):
    """Names + sizes of session log files (state API ``list_logs``)."""
    out = []
    try:
        for name in sorted(os.listdir(log_dir)):
            p = os.path.join(log_dir, name)
            if os.path.isfile(p):
                out.append({"name": name, "size": os.path.getsize(p)})
    except OSError:
        pass
    return out


def read_log_file(log_dir: str, name: str, tail_lines: int = 1000) -> str:
    """Last ``tail_lines`` of one session log file (state API
    ``get_log``). ``name`` must be a bare filename inside the log dir."""
    if os.sep in name or name.startswith("."):
        raise ValueError(f"invalid log name {name!r}")
    path = os.path.join(log_dir, name)
    from collections import deque

    with open(path, "r", errors="replace") as f:
        # bounded memory: keep only the last tail_lines while scanning
        lines = deque(f, maxlen=tail_lines)
    return "".join(lines)
