"""Runtime lock-order sanitizer: ``DebugLock``/``DebugRLock`` and the
lock factory the core routes its ``threading.Lock()`` construction
through.

rtpu-lint L5 proves lock discipline *statically* (bounded-depth,
per-module); this module is the dynamic half — the analogue of the
reference runtime instrumenting its concurrency substrate
(``instrumented_io_context``) instead of auditing call sites by eye.
Armed via ``RTPU_SANITIZE=1`` (read at import; tests flip it with
:func:`arm`/:func:`disarm`), the factory hands out wrapped locks that

- record the **global acquisition-order graph**: an edge A -> B is
  added whenever a thread acquires B while holding A. Acquiring an
  edge that closes a cycle (the classic ABBA inversion — some thread
  ordered A before B, this one orders B before A) raises
  :class:`LockOrderError` at the *second* acquisition site, before the
  thread can actually deadlock;
- raise :class:`LockOrderError` on a same-thread re-acquisition of a
  non-reentrant ``DebugLock`` (guaranteed self-deadlock — the PR 5
  ``_enqueue`` shape, where a dep-ready callback fired under the
  runtime lock re-entered ``_queue_ready``);
- police **fire-outside-lock helpers**: call sites that dispatch
  foreign callables (stored callbacks, resolvers) declare themselves
  with :func:`check_fire_outside`; when armed, dispatching while this
  thread holds any tracked lock raises immediately instead of
  deadlocking whenever the callback happens to need that lock;
- keep per-lock hold-time stats and print a **held-longest report** to
  stderr at process exit (``atexit``), so a hang bisected under the
  sanitizer also names the locks worth staring at.

Disarmed (the default), :func:`make_lock`/:func:`make_rlock` return
plain ``threading`` primitives — zero overhead on hot paths; arming is
a one-flag swap because the core never calls ``threading.Lock()``
directly. Locks constructed *before* arming stay plain; arm first
(env var, or :func:`arm` before building the runtime).

This module is deliberately pure-stdlib with no ray_tpu_torch imports: it
must be importable from the deepest core modules without cycles.
"""

from __future__ import annotations

import atexit
import os
import sys
import threading
import time
from typing import Dict, List, Optional, Tuple, Union

__all__ = [
    "DebugLock", "DebugRLock", "LockOrderError", "arm", "disarm",
    "armed", "make_lock", "make_rlock", "make_condition",
    "check_fire_outside",
    "held_locks", "reset", "hold_stats", "report",
]


class LockOrderError(RuntimeError):
    """A lock acquisition that would (or could) deadlock: same-thread
    re-acquisition of a non-reentrant lock, an acquisition-order cycle
    between named locks, or a callback dispatched through a declared
    fire-outside-lock site while a tracked lock is held."""


_armed = os.environ.get("RTPU_SANITIZE", "") not in ("", "0")

# --- global state, guarded by one plain meta-lock (never a DebugLock) ----
_meta = threading.Lock()
# lock-order edges: name_a -> {name_b: (thread_name, site)} meaning some
# thread acquired b while holding a
_edges: Dict[str, Dict[str, Tuple[str, str]]] = {}
# per-lock hold stats: name -> [count, total_s, max_s, max_site]
_stats: Dict[str, list] = {}

_tls = threading.local()


def _held_stack() -> List["_Held"]:
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    return stack


class _Held:
    __slots__ = ("lock", "t0", "site")

    def __init__(self, lock, site):
        self.lock = lock
        self.t0 = time.monotonic()
        self.site = site


def armed() -> bool:
    return _armed


def arm() -> None:
    """Arm the sanitizer for locks constructed from now on."""
    global _armed
    _armed = True


def disarm() -> None:
    global _armed
    _armed = False


def reset() -> None:
    """Drop the recorded order graph and hold stats (test isolation)."""
    with _meta:
        _edges.clear()
        _stats.clear()


def held_locks() -> List[str]:
    """Names of tracked locks held by the calling thread, outermost
    first."""
    return [h.lock.name for h in _held_stack()]


def _call_site() -> str:
    """File:line of the nearest caller outside this module (so a
    ``with lock:`` reports the with-statement, not ``__enter__``)."""
    f = sys._getframe(1)
    while f is not None and f.f_code.co_filename == __file__:
        f = f.f_back
    if f is None:
        return "?"
    return f"{os.path.basename(f.f_code.co_filename)}:{f.f_lineno}"


def _path_exists(src: str, dst: str) -> Optional[List[str]]:
    """A recorded path src -> ... -> dst in the order graph, or None.
    Caller holds ``_meta``."""
    seen = {src}
    stack = [[src]]
    while stack:
        path = stack.pop()
        for nxt in _edges.get(path[-1], ()):
            if nxt == dst:
                return path + [nxt]
            if nxt not in seen:
                seen.add(nxt)
                stack.append(path + [nxt])
    return None


def _before_acquire(lock: "DebugLock", reentrant: bool) -> None:
    """Order/self-deadlock checks; runs BEFORE blocking on the inner
    lock so the offending thread raises instead of deadlocking."""
    stack = _held_stack()
    if any(h.lock is lock for h in stack):
        if reentrant:
            return  # RLock re-entry: no new edges
        raise LockOrderError(
            f"self-deadlock: thread {threading.current_thread().name!r} "
            f"re-acquired non-reentrant lock {lock.name!r} it already "
            f"holds (held since {stack[-1].site}); use an RLock or move "
            f"the inner acquisition outside the critical section")
    if not stack:
        return
    site = _call_site()
    me = threading.current_thread().name
    with _meta:
        for h in stack:
            a, b = h.lock.name, lock.name
            if a == b:
                continue
            back = _path_exists(b, a)
            if back is not None:
                owner, where = _edges[back[0]][back[1]]
                raise LockOrderError(
                    f"lock-order inversion: thread {me!r} acquires "
                    f"{b!r} at {site} while holding {a!r} (since "
                    f"{h.site}), but the established order is "
                    f"{' -> '.join(back)} (edge recorded by thread "
                    f"{owner!r} at {where}); an interleaving of the two "
                    f"threads deadlocks")
            _edges.setdefault(a, {}).setdefault(b, (me, site))


def _after_acquire(lock: "DebugLock") -> None:
    _held_stack().append(_Held(lock, _call_site()))


def _on_release(lock: "DebugLock") -> None:
    stack = _held_stack()
    for i in range(len(stack) - 1, -1, -1):
        if stack[i].lock is lock:
            h = stack.pop(i)
            dt = time.monotonic() - h.t0
            with _meta:
                s = _stats.setdefault(lock.name, [0, 0.0, 0.0, ""])
                s[0] += 1
                s[1] += dt
                if dt > s[2]:
                    s[2], s[3] = dt, h.site
            return


class DebugLock:
    """Order-tracked non-reentrant lock (``threading.Lock`` surface)."""

    _reentrant = False

    def __init__(self, name: str):
        self.name = name
        self._lock = self._make_inner()

    @staticmethod
    def _make_inner():
        return threading.Lock()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        _before_acquire(self, self._reentrant)
        got = self._lock.acquire(blocking, timeout)
        if got:
            _after_acquire(self)
        return got

    def release(self) -> None:
        _on_release(self)
        self._lock.release()

    def locked(self) -> bool:
        return self._lock.locked()

    def _is_owned(self) -> bool:
        # duck-typed by threading.Condition: our held-stack answers this
        # without the acquire(0) probe (which would distort the graph)
        return any(h.lock is self for h in _held_stack())

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def __repr__(self):
        state = "locked" if self._lock.locked() else "unlocked"
        return f"<{type(self).__name__} {self.name!r} {state}>"


class DebugRLock(DebugLock):
    """Order-tracked reentrant lock (``threading.RLock`` surface,
    including the ``Condition`` save/restore hooks)."""

    _reentrant = True

    @staticmethod
    def _make_inner():
        return threading.RLock()

    def locked(self) -> bool:
        return self._is_owned() or not self._lock.acquire(blocking=False) \
            or (self._lock.release() or False)

    # Condition.wait() on an RLock releases ALL recursion levels via
    # these hooks; mirror the held-stack so a thread parked in wait()
    # is not considered a holder.
    def _release_save(self):
        _on_release(self)
        return self._lock._release_save()

    def _acquire_restore(self, state):
        _before_acquire(self, reentrant=True)
        self._lock._acquire_restore(state)
        _after_acquire(self)


LockLike = Union[threading.Lock, DebugLock]


def make_lock(name: str) -> LockLike:
    """A ``threading.Lock`` — wrapped for order tracking when the
    sanitizer is armed. ``name`` is the stable identity in the global
    order graph (convention: ``Class.attr`` or ``module.global``)."""
    return DebugLock(name) if _armed else threading.Lock()


def make_rlock(name: str):
    return DebugRLock(name) if _armed else threading.RLock()


def make_condition(name: str) -> threading.Condition:
    """A ``threading.Condition`` over a factory lock (reentrant, like
    the bare ``Condition()`` default). ``Condition.wait`` releases the
    lock through the RLock save/restore hooks, so a thread parked in
    ``wait()`` is correctly not a holder in the order graph."""
    return threading.Condition(make_rlock(name))


def check_fire_outside(site: str) -> None:
    """Declare "this statement dispatches foreign callables and must run
    with no tracked lock held". No-op disarmed; armed, raises
    :class:`LockOrderError` when the calling thread holds any tracked
    lock — the PR 5 class of bug (callback fired under the runtime
    lock re-enters the runtime) caught at dispatch time, every time,
    not only on the interleaving that deadlocks."""
    if not _armed:
        return
    stack = _held_stack()
    if stack:
        held = ", ".join(
            f"{h.lock.name!r} (since {h.site})" for h in stack)
        raise LockOrderError(
            f"callback dispatch at fire-outside-lock site {site!r} "
            f"while holding {held}: a callback that needs any of these "
            f"locks deadlocks the holder — move the dispatch outside "
            f"the critical section")


def hold_stats() -> Dict[str, dict]:
    """Per-lock hold statistics recorded so far."""
    with _meta:
        return {name: {"count": s[0], "total_s": s[1], "max_s": s[2],
                       "max_site": s[3]}
                for name, s in _stats.items()}


def report(limit: int = 8, file=None) -> None:
    """Print the held-longest report (top ``limit`` locks by max single
    hold)."""
    stats = hold_stats()
    if not stats:
        return
    file = file or sys.stderr
    rows = sorted(stats.items(), key=lambda kv: -kv[1]["max_s"])[:limit]
    print(f"[rtpu-sanitize] lock hold report, pid {os.getpid()} "
          f"(longest single hold first):", file=file)
    for name, s in rows:
        print(f"[rtpu-sanitize]   {name:<40} max {s['max_s'] * 1e3:8.2f} ms"
              f" at {s['max_site'] or '?':<24} "
              f"({s['count']} holds, {s['total_s'] * 1e3:.2f} ms total)",
              file=file)


@atexit.register
def _exit_report():
    if _armed:
        report()
