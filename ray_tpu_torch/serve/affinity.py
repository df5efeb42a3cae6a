"""Prefix-cache-aware replica scoring for the serve router.

The port's copy of ``ray_tpu/serve/affinity.py``.

The paged engine's prefix cache (serve/paged_engine.py) only pays off
when a repeated prefix LANDS on the replica that holds it; blind pow-2
routing at N replicas hits the cache with probability ~1/N. This module
closes the loop: each engine replica publishes a bounded *residency
digest* — the stable chain-hash fingerprints of its cached page chains
(``PagedLLMEngine.residency_digest``) — and the router scores candidate
replicas by the number of prompt tokens whose KV the replica already
holds, minus a load penalty, exactly the way the locality scheduler
scores argument bytes minus a transfer penalty (core/locality.py).

Scoring model (flags in core/config.py):

    score(replica) = matched_prefix_tokens(prompt, digest)
                     - serve_affinity_load_penalty * inflight(replica)

A replica only competes when its match clears
``serve_affinity_min_prefix_tokens`` and its digest is fresh
(``max_age_s``); otherwise the router falls back to power-of-two
choices. Ties break toward the lighter replica, then lexicographic
replica id, so scoring is deterministic under a fixed request schedule
(tests pin this).

The digest is an estimate, not a promise: pages can be evicted between
report and arrival, in which case the engine simply prefills the tail it
expected to skip — affinity affects WHERE a request runs, never its
result.
"""

from __future__ import annotations

import time
from typing import Dict, Iterable, List, Optional, Tuple

from ray_tpu_torch.serve.paged_engine import _PageAllocator


class ResidencyDigest:
    """One replica's published prefix residency: the fingerprint set of
    its cached page chains, the page size they were chained at, and the
    wall-ts of the report (staleness gate)."""

    __slots__ = ("page_size", "hashes", "ts")

    def __init__(self, page_size: int, hashes: Iterable[int],
                 ts: Optional[float] = None):
        self.page_size = int(page_size)
        self.hashes = frozenset(hashes)
        self.ts = time.monotonic() if ts is None else float(ts)

    @classmethod
    def from_report(cls, payload: Optional[dict],
                    ts: Optional[float] = None
                    ) -> Optional["ResidencyDigest"]:
        """Parse an engine's ``residency_digest()`` payload; None (and
        no affinity) for malformed/absent reports — a replica without
        the surface must not break routing."""
        if not isinstance(payload, dict):
            return None
        try:
            return cls(payload["page_size"], payload.get("hashes") or (),
                       ts=ts)
        except (KeyError, TypeError, ValueError):
            return None


def chain_hashes(tokens: List[int], page_size: int) -> List[int]:
    """The prompt's chain fingerprints, one per FULL page — identical to
    what ``_PageAllocator.match_prefix`` computes replica-side (the
    stable blake2b chain), so a router-side hash either matches the
    replica's cached chain or nothing."""
    ps = int(page_size)
    out: List[int] = []
    prev = 0
    for i in range(len(tokens) // ps):
        prev = _PageAllocator.chain_hash(
            prev, tuple(tokens[i * ps:(i + 1) * ps]))
        out.append(prev)
    return out


def matched_prefix_tokens(tokens: List[int], digest: ResidencyDigest,
                          _hash_cache: Optional[dict] = None) -> int:
    """Estimated prompt tokens whose KV ``digest``'s replica already
    holds: the longest run of leading full pages whose chain hashes are
    all in the digest. ``_hash_cache`` memoizes per-page-size hash
    chains across replicas of one scoring pass."""
    ps = digest.page_size
    if ps <= 0 or not digest.hashes:
        return 0
    if _hash_cache is not None:
        hashes = _hash_cache.get(ps)
        if hashes is None:
            hashes = _hash_cache[ps] = chain_hashes(tokens, ps)
    else:
        hashes = chain_hashes(tokens, ps)
    n = 0
    for h in hashes:
        if h not in digest.hashes:
            break
        n += 1
    return n * ps


def score_replicas(tokens: Optional[List[int]],
                   replicas: List[Tuple[str, object]],
                   digests: Dict[str, ResidencyDigest],
                   inflight: Dict[str, int],
                   *, min_prefix_tokens: int, load_penalty: float,
                   max_age_s: float = 3.0,
                   now: Optional[float] = None) -> Optional[str]:
    """Pick the best cache holder for ``tokens`` among ``replicas``, or
    None when no replica clears the bar (stale/missing digests, match
    under ``min_prefix_tokens``) — the caller then falls back to pow-2.
    Deterministic: ties break to the lighter replica, then replica id.
    """
    if not tokens:
        return None
    now = time.monotonic() if now is None else now
    hash_cache: dict = {}
    best: Optional[Tuple[float, int, str]] = None  # (-score, load, rid)
    for rid, _ in replicas:
        dg = digests.get(rid)
        if dg is None or now - dg.ts > max_age_s:
            continue  # stale digest: this replica routes blind
        matched = matched_prefix_tokens(tokens, dg, hash_cache)
        if matched < max(1, int(min_prefix_tokens)):
            continue
        load = int(inflight.get(rid, 0))
        score = matched - load_penalty * load
        if score < 0:
            continue  # penalty ate the match: blind balancing is better
        key = (-score, load, rid)
        if best is None or key < best:
            best = key
    return best[2] if best is not None else None
