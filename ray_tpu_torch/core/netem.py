"""Deterministic network-emulation (netem) shim for the RPC substrate.

``cluster/rpc.py`` weaves this module into the client send/recv path and
the server dispatch loop, so per-edge wire faults — partitions, message
loss, delay, duplication, reorder, slow links — can be injected into the
REAL transport code paths (retry whitelist, ``maybe_applied`` tagging,
nonce dedup, HA ride-through) without monkeypatching. It is the
wire-level sibling of ``core/fault_injection.py`` (which models crash
and drop at *application* sites): same arming style, same seeded-replay
contract.

Rule grammar
------------
``RTPU_NETEM=<seed>:<rule>[;<rule>...]`` where each rule is::

    <src> -> <dst> = <kind>[,key=value...]     (one direction)
    <src> <-> <dst> = <kind>[,key=value...]    (both directions)

``src``/``dst`` select edge endpoints: ``*`` (any), a role tag
(``driver`` / ``gcs`` / ``node``), a ``host:port`` address, or a bare
port. Roles come from :func:`set_identity` (each cluster process
declares what it is) and :func:`tag_peer` (``HaGcsClient`` tags its
target ``gcs``); an untagged peer defaults to ``node`` — the only
servers in a cluster are the GCS and node servers, and the driver is
never a destination (nothing dials it).

Policy kinds (``KINDS``):

- ``drop`` — the send fails with :class:`NetemFault` *before* any bytes
  move (the transport sees an unsent message and retries safely);
- ``partition`` / ``blackhole`` — same mechanics as ``drop``; by
  convention armed unlimited (``times`` defaults to -1) to model a
  severed edge until :func:`clear`/``heal`` removes the rule;
- ``delay`` — sleep ``ms`` (+ ``jitter`` ms scaled by a seeded draw);
- ``reorder`` — seeded hold-back within an ``ms`` window, letting a
  concurrent message on another connection overtake this one;
- ``bw`` — sleep ``size_hint / kbps`` to model a slow link;
- ``dup`` — the request is sent TWICE on the same connection (the
  server applies it twice back-to-back; nonce dedup / idempotent ops
  must make the second apply a no-op);
- ``lost_reply`` — the request is sent, then the reply is discarded by
  raising :class:`NetemFault` before the receive (the transport sees
  ``sent=True``: only whitelist-idempotent ops may retry, and the
  server-side dedup must absorb the retry).

Common params: ``p=<prob>`` (fire probability, seeded draw; default 1),
``times=<n>`` (stop after n matches; -1 = unlimited, the default),
``at=server`` (apply in the receiving server's dispatch loop instead of
the sending client — server-marked rules never fire client-side, so a
rule is applied exactly once per message).

Determinism
-----------
Every probabilistic decision draws from a per-rule
``random.Random(f"{seed}\\x00{src}->{dst}={kind}")`` stream, so the
delivery schedule is a pure function of the seed, the rule table, and
each rule's own sequence of matches — never of wall-clock timing. The
recorded schedule (:func:`schedule`) is asserted identical across runs
of the same seeded workload in ``tests/test_netem.py`` (and the port's
against the reference's in ``tests/test_torch_netem.py``); export the
printed seed back through ``RTPU_NETEM`` to replay a failure.

Partitions are usually armed programmatically via the cluster fixture's
``partition(a, b, oneway=...)`` / ``heal()`` helpers, which deliver
rules into node/GCS processes over unaffected edges with the ``netem``
control RPC (:func:`control`).
"""

from __future__ import annotations

import os
import random
import time
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.util.debug_lock import make_lock

ENV = "RTPU_NETEM"

#: every policy kind the shim can arm (the netem tests arm each one).
KINDS = ("drop", "delay", "dup", "reorder", "bw", "partition",
         "blackhole", "lost_reply")

#: kinds that sever the edge outright (raise before any bytes move)
_FAULT_KINDS = ("drop", "partition", "blackhole")

#: schedule recording cap — enough for any seeded test workload while
#: bounding memory if a long-lived process stays armed
_SCHEDULE_CAP = 100_000


class NetemFault(OSError):
    """Injected wire fault. Subclasses :class:`OSError` so the
    transport's existing failure handling (pool teardown, retry
    whitelist, ``maybe_applied`` tagging) treats it exactly like a real
    socket error — the whole point is to exercise those paths."""


class _Rule:
    __slots__ = ("src", "dst", "kind", "params", "times", "rng", "env",
                 "rule_id")

    def __init__(self, src: str, dst: str, kind: str,
                 params: Optional[Dict[str, Any]], seed: int,
                 rule_id: int, env: bool = False):
        if kind not in KINDS:
            raise ValueError(
                f"unknown netem policy kind {kind!r}; kinds: {KINDS}")
        self.src = src
        self.dst = dst
        self.kind = kind
        self.params = dict(params or {})
        self.times = int(self.params.pop("times", -1))
        self.env = env
        self.rule_id = rule_id
        # per-rule deterministic stream: decisions are a pure function
        # of (seed, rule spec, this rule's own match counter)
        self.rng = random.Random(f"{seed}\x00{src}->{dst}={kind}")

    def spec(self) -> str:
        return f"{self.src}->{self.dst}={self.kind}"


_lock = make_lock("netem._lock")
_rules: List[_Rule] = []
_armed = False          # lock-free fast-path guard, like fault_injection
_seed = 0
_next_rule_id = 0
_identity_role = "?"
_identity_addr: Optional[str] = None
_peer_roles: Dict[str, str] = {}
_schedule: List[Tuple[str, str, str]] = []


def _addr_str(addr: Any) -> str:
    if isinstance(addr, str):
        return addr
    return f"{addr[0]}:{addr[1]}"


def enabled() -> bool:
    """Cheap guard for the transport hot path: one global load."""
    return _armed


def set_identity(role: str, address: Any = None) -> None:
    """Declare what this process is (``driver``/``gcs``/``node``) and,
    for servers, its listen address — rule ``src`` selectors match
    against these. Last caller wins (in-process multi-server tests)."""
    global _identity_role, _identity_addr
    with _lock:
        _identity_role = role
        _identity_addr = _addr_str(address) if address else None


def tag_peer(address: Any, role: str) -> None:
    """Record a peer address's role so ``dst`` selectors can match by
    role (``HaGcsClient`` tags its target ``gcs``; untagged peers
    default to ``node``)."""
    with _lock:
        _peer_roles[_addr_str(address)] = role


def _match(sel: str, role: Optional[str], addr: Optional[str]) -> bool:
    if sel == "*" or sel == role:
        return True
    if addr is None:
        return False
    return sel == addr or (sel.isdigit() and addr.endswith(":" + sel))


def _record(rule: _Rule, peer: str, decision: str) -> None:
    # caller holds _lock
    if len(_schedule) < _SCHEDULE_CAP:
        _schedule.append((f"{_identity_role}->{peer}", rule.spec(),
                          decision))


def arm(seed: int, rules: Optional[List[dict]] = None) -> None:
    """Reset the shim and arm a fresh rule table under ``seed``. Rule
    dicts carry ``src``/``dst``/``kind``/``params`` (the shape
    :func:`parse_spec` produces)."""
    global _seed, _next_rule_id, _armed
    with _lock:
        _seed = int(seed)
        _rules[:] = []
        _schedule[:] = []
        _next_rule_id = 0
        _armed = False
    for r in rules or []:
        add_rule(r["src"], r["dst"], r["kind"], dict(r.get("params") or {}))


def add_rule(src: str, dst: str, kind: str,
             params: Optional[Dict[str, Any]] = None,
             env: bool = False) -> int:
    """Append one rule; returns its id. First matching fault rule wins;
    shaping rules (delay/reorder/bw) and dup/lost_reply compose."""
    global _next_rule_id, _armed
    with _lock:
        rid = _next_rule_id
        _next_rule_id += 1
        _rules.append(_Rule(src, dst, kind, params, _seed, rid, env=env))
        _armed = True
        return rid


def clear(src: Optional[str] = None, dst: Optional[str] = None,
          kind: Optional[str] = None) -> int:
    """Remove rules matching every given selector (all rules with no
    arguments — full disarm). Returns the number removed."""
    global _armed
    with _lock:
        keep = [r for r in _rules
                if not ((src is None or r.src == src)
                        and (dst is None or r.dst == dst)
                        and (kind is None or r.kind == kind))]
        removed = len(_rules) - len(keep)
        _rules[:] = keep
        _armed = bool(_rules)
        return removed


def _size_hint(msg: Any) -> int:
    """Cheap top-level payload size estimate for ``bw`` shaping: framed
    overhead plus any bytes/str elements one or two levels deep (task
    payloads and object chunks live there)."""
    n = 64
    if isinstance(msg, tuple):
        for x in msg:
            if isinstance(x, (bytes, bytearray, str)):
                n += len(x)
            elif isinstance(x, (list, tuple)):
                for y in x:
                    if isinstance(y, (bytes, bytearray, str)):
                        n += len(y)
    return n


def plan_send(dst_addr: Any, msg: Any) -> Optional[str]:
    """Client-side hook, called before EACH request send — including the
    transport's built-in same-address retry, so a partition blocks the
    retry too. Sleeps for shaping rules, raises :class:`NetemFault` for
    fault rules, and returns ``"dup"`` / ``"lost_reply"`` for the two
    policies the transport must cooperate on."""
    dst = _addr_str(dst_addr)
    sleep_s = 0.0
    verdict: Optional[str] = None
    fault: Optional[str] = None
    with _lock:
        role = _peer_roles.get(dst, "node")
        for r in _rules:
            if r.times == 0 or r.params.get("at") == "server":
                continue
            if not _match(r.src, _identity_role, _identity_addr):
                continue
            if not _match(r.dst, role, dst):
                continue
            p = float(r.params.get("p", 1.0))
            if p < 1.0 and r.rng.random() >= p:
                _record(r, dst, "pass")
                continue
            if r.times > 0:
                r.times -= 1
            if r.kind in _FAULT_KINDS:
                fault = r.kind
                _record(r, dst, r.kind)
                break
            if r.kind == "delay":
                d = float(r.params.get("ms", 1.0)) / 1000.0
                d += (float(r.params.get("jitter", 0.0)) / 1000.0
                      * r.rng.random())
                sleep_s += d
                _record(r, dst, f"delay:{d * 1000:.3f}ms")
            elif r.kind == "reorder":
                d = (float(r.params.get("ms", 5.0)) / 1000.0
                     * r.rng.random())
                sleep_s += d
                _record(r, dst, f"reorder:{d * 1000:.3f}ms")
            elif r.kind == "bw":
                kbps = float(r.params.get("kbps", 1024.0))
                d = _size_hint(msg) / (kbps * 1024.0)
                sleep_s += d
                _record(r, dst, f"bw:{d * 1000:.3f}ms")
            elif r.kind == "dup":
                verdict = "dup"
                _record(r, dst, "dup")
            elif r.kind == "lost_reply":
                verdict = "lost_reply"
                _record(r, dst, "lost_reply")
    if sleep_s > 0.0:
        time.sleep(sleep_s)
    if fault is not None:
        raise NetemFault(
            f"netem {fault}: edge {_identity_role} -> {dst} is severed")
    return verdict


def plan_dispatch() -> None:
    """Server-side hook, called as a request is dequeued and before the
    handler runs. Applies only rules marked ``at=server`` whose ``dst``
    matches this process: ``delay`` sleeps inside the dispatch loop;
    fault kinds sever the connection mid-exchange (the client observes
    a sent-but-unanswered request — the ``maybe_applied`` path)."""
    sleep_s = 0.0
    fault: Optional[str] = None
    with _lock:
        for r in _rules:
            if r.times == 0 or r.params.get("at") != "server":
                continue
            if not _match(r.dst, _identity_role, _identity_addr):
                continue
            p = float(r.params.get("p", 1.0))
            if p < 1.0 and r.rng.random() >= p:
                _record(r, _identity_role, "pass")
                continue
            if r.times > 0:
                r.times -= 1
            if r.kind in _FAULT_KINDS:
                fault = r.kind
                _record(r, _identity_role, "inbound:" + r.kind)
                break
            if r.kind == "delay":
                d = float(r.params.get("ms", 1.0)) / 1000.0
                d += (float(r.params.get("jitter", 0.0)) / 1000.0
                      * r.rng.random())
                sleep_s += d
                _record(r, _identity_role, f"inbound-delay:{d * 1000:.3f}ms")
    if sleep_s > 0.0:
        time.sleep(sleep_s)
    if fault is not None:
        raise NetemFault(
            f"netem inbound {fault} at {_identity_role}: "
            f"request discarded before dispatch")


def schedule() -> List[Tuple[str, str, str]]:
    """The recorded delivery schedule: ordered ``(edge, rule-spec,
    decision)`` triples. Identical across runs of the same seeded
    workload — the replay contract the determinism test asserts."""
    with _lock:
        return list(_schedule)


def rules() -> List[str]:
    """Human-readable armed rule table (debugging/fixture asserts)."""
    with _lock:
        return [f"{r.spec()} params={r.params} times={r.times}"
                for r in _rules]


def parse_spec(raw: str) -> Tuple[int, List[dict]]:
    """Parse ``<seed>:<rule>[;<rule>...]`` (grammar in the module
    docstring) into ``(seed, rule dicts)``. Raises ``ValueError`` on a
    malformed spec — a silently ignored chaos plan is worse than a
    crash."""
    raw = (raw or "").strip()
    if not raw:
        raise ValueError("empty netem spec")
    head, _, tail = raw.partition(":")
    seed = int(head)
    out: List[dict] = []
    for item in tail.split(";"):
        item = item.strip()
        if not item:
            continue
        edge, _, policy = item.partition("=")
        if not policy:
            raise ValueError(f"netem rule {item!r} has no '=<kind>' policy")
        two_way = "<->" in edge
        src, _, dst = edge.partition("<->" if two_way else "->")
        src = src.strip() or "*"
        dst = dst.strip() or "*"
        parts = policy.split(",")
        kind = parts[0].strip()
        if kind not in KINDS:
            raise ValueError(
                f"unknown netem policy kind {kind!r}; kinds: {KINDS}")
        params: Dict[str, str] = {}
        for kv in parts[1:]:
            k, _, v = kv.partition("=")
            params[k.strip()] = v.strip()
        out.append({"src": src, "dst": dst, "kind": kind, "params": params})
        if two_way:
            out.append({"src": dst, "dst": src, "kind": kind,
                        "params": dict(params)})
    return seed, out


def load_env(env: Optional[Dict[str, str]] = None) -> int:
    """Arm from ``RTPU_NETEM`` (called once at import, so every cluster
    subprocess inheriting the env arms itself; tests that mutate
    ``os.environ`` call it again). Env-loaded rules replace prior
    env-loaded rules; programmatically armed rules are kept. Returns
    the number of rules armed."""
    global _seed, _armed
    src = os.environ if env is None else env
    raw = (src.get(ENV) or "").strip()
    if not raw:
        return 0
    seed, specs = parse_spec(raw)
    with _lock:
        _seed = seed
        _rules[:] = [r for r in _rules if not r.env]
    for s in specs:
        add_rule(s["src"], s["dst"], s["kind"], s["params"], env=True)
    with _lock:
        _armed = bool(_rules)
    return len(specs)


def control(cmd: str, *args: Any) -> Any:
    """Remote-control entry backing the ``netem`` RPC op on node/GCS
    servers: the cluster fixture arms partitions inside other processes
    by sending control messages over (still-healthy) edges."""
    if cmd == "add":
        return add_rule(*args)
    if cmd == "clear":
        return clear(*args)
    if cmd == "schedule":
        return schedule()
    if cmd == "rules":
        return rules()
    raise ValueError(f"unknown netem control command {cmd!r}")


load_env()
