"""Deterministic, targetable fault injection for chaos tests.

The probabilistic chaos knobs (``testing_kill_worker_prob``,
``testing_rpc_delay_ms``) exercise failure paths statistically; tests of
specific recovery machinery (lineage reconstruction, spill-file loss,
worker death mid-task) need each loss to happen to a *chosen* object at
a *named* site, an exact number of times. This module provides that:
product code calls ``fire(site, key)`` at instrumented sites and applies
the returned action; tests arm faults with ``inject`` (in-process) or
via the env/config surface (cross-process).

Sites and their actions (``key`` is the hex id the match is tested
against, prefix match; ``"*"`` matches everything):

=============  =======================  ==================================
site           key                      actions
=============  =======================  ==================================
``get``        object id (hex)          ``evict``, ``delete_spill``,
                                        ``corrupt_spill`` — applied to the
                                        object just before a driver-side
                                        get decodes it
``spill``      object id (hex)          ``delete``, ``corrupt`` — applied
                                        to the spill file right after the
                                        payload moved to disk
``dispatch``   function id (hex)        ``kill_worker`` — SIGKILL the
                                        worker a task batch was just sent
                                        to
``task``       function id (hex)        ``exit`` — the worker process
                                        exits before executing the task
                                        (worker-side; arm via env)
``actor_call``  "<actor hex>:<method>"  ``drop`` — the driver silently
                                        drops the dispatch (the call is
                                        in flight but the worker never
                                        sees it — a lost message);
                                        ``kill_worker`` — SIGKILL the
                                        actor's worker right after the
                                        call is sent
``actor_worker_kill``  same key         ``exit`` — the actor's worker
                                        exits before executing the call
                                        (in-flight kill); ``exit_after``
                                        — it executes the method and
                                        seals the results, then exits
                                        before the DONE report flushes
                                        (worker-side; arm via env)
``prefill_handoff``  request id         ``drop`` — the finished KV-page
                                        handoff from a disaggregated
                                        prefill worker to its decode
                                        engine is silently lost (pages
                                        computed, message never
                                        delivered); the decode side's
                                        handoff lease expires and the
                                        request re-prefills locally.
                                        ``kill_worker`` — the prefill
                                        worker aborts mid-stream before
                                        publishing anything (worker
                                        death); a fresh worker is
                                        respawned and the request
                                        recovers the same way. Fires on
                                        the worker thread inside the
                                        replica process, so in-process
                                        ``inject`` works
``gang_resize``  batch index (decimal)  ``kill`` — SIGKILL the
                                        highest-rank training worker
                                        right after the matching result
                                        batch is harvested (abrupt
                                        preemption); ``sigterm`` —
                                        deliver SIGTERM instead, giving
                                        the worker its checkpoint grace
                                        window (scheduled preemption).
                                        Fires driver-side inside
                                        BackendExecutor, so in-process
                                        ``inject`` works
=============  =======================  ==================================

Env/config surface: ``RTPU_FAULT_<SITE>=<action>[:<times>[:<match>]]``
(e.g. ``RTPU_FAULT_SPILL=delete:1``), or the ``fault_injection`` config
flag as comma-separated ``<site>=<action>[:<times>[:<match>]]`` specs.
``times`` defaults to 1; ``-1`` means unlimited. Workers inherit the
driver's environment, so env-armed faults fire in every process that
hits the site; in-process ``inject`` calls arm only the calling process.

The module also exposes direct helpers (``evict_object``,
``spill_object``, ``delete_spill_file``, ``corrupt_spill_file``,
``kill_producing_worker``) that apply a fault to a runtime immediately —
for tests that want to mutate state between calls rather than arm a
site.

The reference's sites of parts the port has not taken over yet (the
GCS, serve's router, the job agent) come with them.
"""

from __future__ import annotations

import os
import signal
import threading
from typing import Dict, List, Optional

from ray_tpu_torch.util.debug_lock import make_lock

SITES = ("get", "spill", "dispatch", "task", "actor_call",
         "actor_worker_kill", "prefill_handoff", "gang_resize")

_lock = make_lock("fault_injection._lock")
_specs: Dict[str, List[dict]] = {}
_armed = False


def enabled() -> bool:
    """Cheap guard for instrumented hot paths."""
    return _armed


def inject(site: str, action: str, target: str = "*",
           times: int = 1) -> None:
    """Arm ``action`` at ``site`` for keys matching ``target`` (hex
    prefix or ``"*"``), firing at most ``times`` times (-1 = always)."""
    if site not in SITES:
        raise ValueError(f"unknown fault site {site!r}; sites: {SITES}")
    global _armed
    with _lock:
        _specs.setdefault(site, []).append(
            {"action": action, "target": target, "times": times})
        _armed = True


def fire(site: str, key: str) -> Optional[str]:
    """Called by product code at an instrumented site. Returns the armed
    action to apply for ``key`` (consuming one firing), or None."""
    if not _armed:
        return None
    with _lock:
        for spec in _specs.get(site, ()):
            if spec["times"] == 0:
                continue
            t = spec["target"]
            if t != "*" and not key.startswith(t):
                continue
            if spec["times"] > 0:
                spec["times"] -= 1
            return spec["action"]
    return None


def clear() -> None:
    """Disarm every fault (in-process specs AND env-loaded ones)."""
    global _armed
    with _lock:
        _specs.clear()
        _armed = False


def _parse_spec(site: str, raw: str) -> Optional[dict]:
    parts = raw.split(":")
    if not parts[0]:
        return None
    action = parts[0].strip()
    times = int(parts[1]) if len(parts) > 1 and parts[1].strip() else 1
    target = parts[2].strip() if len(parts) > 2 and parts[2].strip() else "*"
    return {"action": action, "target": target, "times": times,
            "site": site}


def load_env(env: Optional[Dict[str, str]] = None) -> int:
    """(Re-)arm faults from RTPU_FAULT_<SITE> env vars and the
    ``fault_injection`` config flag. Returns the number of specs armed.
    Called once at import; tests that mutate os.environ call it again."""
    from ray_tpu_torch.core.config import config

    env = os.environ if env is None else env
    specs: List[dict] = []
    for site in SITES:
        raw = env.get(f"RTPU_FAULT_{site.upper()}")
        if raw:
            s = _parse_spec(site, raw)
            if s:
                specs.append(s)
    for item in (config.fault_injection or "").split(","):
        item = item.strip()
        if not item or "=" not in item:
            continue
        site, _, raw = item.partition("=")
        site = site.strip()
        if site in SITES:
            s = _parse_spec(site, raw)
            if s:
                specs.append(s)
    global _armed
    with _lock:
        # env-loaded specs replace prior env-loaded specs but keep
        # inject()-armed ones
        for lst in _specs.values():
            lst[:] = [s for s in lst if not s.get("env")]
        for s in specs:
            s["env"] = True
            _specs.setdefault(s.pop("site"), []).append(s)
        _armed = any(lst for lst in _specs.values())
    return len(specs)


# ---------------------------------------------------------------- helpers
# Direct-application forms of the site actions: each takes the Runtime
# (`core`) and an object ref / ObjectID / raw id bytes, applies the
# fault now, and returns whether it took effect.


def _oid_bytes(ref) -> bytes:
    if isinstance(ref, bytes):
        return ref
    if hasattr(ref, "id"):  # ObjectRef
        return ref.id.binary()
    return ref.binary()  # ObjectID


def evict_object(core, ref, timeout_s: float = 2.0) -> bool:
    """Evict a sealed object's shm container exactly as LRU pressure
    would: drop the owner's tracking pin and delete the container. The
    object-table entry keeps its stale ("shm", id) payload, so the next
    read surfaces ObjectLostError (or triggers reconstruction).

    Retries through the result-adoption handoff: _store_payload sets
    the entry event before the pin registration runs, and inside that
    window the container still holds its retained creator ref, so
    delete refuses. A getter woken by the event (or the interleaving
    fuzzer stretching the window) would otherwise see the injected
    loss silently no-op."""
    import time

    from ray_tpu_torch.core.ids import ObjectID

    oid_b = _oid_bytes(ref)
    oid = ObjectID(oid_b)
    deadline = time.monotonic() + timeout_s
    while True:
        with core._spill_lock:
            pinned = core._pinned.pop(oid_b, None) is not None
        try:
            if pinned:
                core.store.release(oid)
            core.store.delete(oid)
        # rtpu-lint: disable=L4 — chaos helper: the object being already
        # evicted/spilled/closed-with-the-store all count as "gone",
        # which is the success condition checked below
        except Exception:  # noqa: BLE001
            pass
        if not core.store.contains(oid):
            return True
        if time.monotonic() >= deadline:
            return False
        time.sleep(0.001)


def spill_object(core, ref) -> bool:
    """Force an object's container to disk now (deterministic stand-in
    for memory pressure). Returns True when the payload moved."""
    return core._spill_one(_oid_bytes(ref)) > 0


def _spill_path(core, ref) -> Optional[str]:
    from ray_tpu_torch.core.ids import ObjectID

    e = core._objects.get(ObjectID(_oid_bytes(ref)))
    if e is None or e.payload is None:
        return None
    kind, data = e.payload
    if kind != "spilled":
        return None
    return data[0] if isinstance(data, tuple) else data


def delete_spill_file(core, ref) -> bool:
    """Delete the spill file backing an already-spilled object."""
    from ray_tpu_torch.core import external_storage

    path = _spill_path(core, ref)
    if path is None:
        return False
    external_storage.delete(path)
    return True


def corrupt_spill_file(core, ref) -> bool:
    """Overwrite the head of an object's spill file with garbage."""
    from ray_tpu_torch.core import external_storage

    path = _spill_path(core, ref)
    if path is None:
        return False
    return external_storage.corrupt(path)


def kill_producing_worker(core, ref) -> bool:
    """SIGKILL the worker currently executing the task that produces
    ``ref`` (keyed by the task's first return id)."""
    oid_b = _oid_bytes(ref)
    spec = core._cancellable.get(oid_b)
    if spec is None:
        return False
    tid_b = spec.task_id.binary()
    with core._lock:
        procs = [w.proc for w in core._workers.values()
                 if tid_b in w.inflight and w.proc is not None]
    for proc in procs:
        try:
            os.kill(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
    return bool(procs)


load_env()
