"""Deterministic, targetable fault injection for chaos tests.

The port's copy of ``ray_tpu/core/fault_injection.py`` for the one site
its serving path instruments. Product code calls ``fire(site, key)`` at
the site and applies the returned action; tests arm faults with
``inject`` (in-process) or through the environment.

===================  ==========  =======================================
site                 key         actions
===================  ==========  =======================================
``prefill_handoff``  request id  ``drop``: the finished KV-page handoff
                                 from a disaggregated prefill worker is
                                 lost (pages computed, never delivered);
                                 the handoff lease expires and the
                                 request prefills locally.
                                 ``kill_worker``: the prefill worker
                                 thread dies before publishing anything;
                                 it is respawned and the request
                                 recovers the same way.
===================  ==========  =======================================

Env surface: ``RTPU_FAULT_<SITE>=<action>[:<times>[:<match>]]`` (e.g.
``RTPU_FAULT_PREFILL_HANDOFF=drop:2``). ``times`` defaults to 1 and -1
means unlimited; ``match`` is a key prefix, ``"*"`` (the default)
matches every key. ``load_env`` runs once at import.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional

SITES = ("prefill_handoff",)

_lock = threading.Lock()
_specs: Dict[str, List[dict]] = {}
_armed = False


def enabled() -> bool:
    """Cheap guard for instrumented hot paths."""
    return _armed


def inject(site: str, action: str, target: str = "*",
           times: int = 1) -> None:
    """Arm ``action`` at ``site`` for keys matching ``target`` (prefix
    or ``"*"``), firing at most ``times`` times (-1 = always)."""
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
    """Disarm every fault (in-process specs and env-loaded ones)."""
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
    """(Re-)arm faults from the ``RTPU_FAULT_<SITE>`` variables of
    ``env`` (default ``os.environ``). Env-loaded specs replace earlier
    env-loaded ones and keep ``inject``-armed ones. Returns the number
    of specs armed."""
    env = os.environ if env is None else env
    specs: List[dict] = []
    for site in SITES:
        raw = env.get(f"RTPU_FAULT_{site.upper()}")
        if raw:
            s = _parse_spec(site, raw)
            if s:
                specs.append(s)
    global _armed
    with _lock:
        for lst in _specs.values():
            lst[:] = [s for s in lst if not s.get("env")]
        for s in specs:
            s["env"] = True
            _specs.setdefault(s.pop("site"), []).append(s)
        _armed = any(lst for lst in _specs.values())
    return len(specs)


load_env()
