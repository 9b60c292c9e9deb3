"""Pluggable cache eviction and admission policies.

The paper's caches are plain LRU ("the cache may evict any resident
chunk"), but follow-on studies of the same infrastructure — the OSG data
federation (arXiv:2007.01408) and the SoCal repo lifecycle study
(arXiv:2205.05598) — show that at fleet scale the eviction policy and the
admission rule are the levers that decide hit rate and origin offload.
This module makes both pluggable on :class:`~repro_torch.core.cache.CacheServer`
without touching its pure state-machine API.

Eviction policies rank resident chunks for victim selection:

* ``lru``  — least-recently-used (the seed behaviour, still the default);
* ``lfu``  — least-frequently-used with LRU tie-break, which protects the
  hot head of a Zipf working set from long scan-like tails;
* ``ttl``  — LRU plus a freshness bound: chunks older than ``ttl_seconds``
  are expired on access (squid-style, matching the HTTP-proxy baseline);
* ``fifo`` — insertion order, the cheapest possible bookkeeping.

Admission policies decide whether a fetched chunk is cached at all.
``SizeAwareAdmission`` refuses objects whose size exceeds a fraction of
cache capacity — one multi-TB dataset must not flush a whole site cache
(the "hot-object storm" failure mode at fleet scale).
"""
from __future__ import annotations

import copy
from collections import OrderedDict
from typing import Dict, Optional, Set, Tuple

Key = Tuple[str, int]


class EvictionPolicy:
    """Victim-selection strategy over resident chunk keys.

    The cache owns payloads and byte accounting; the policy only maintains
    the ordering metadata it needs to answer :meth:`victim`.
    """

    name = "base"

    def on_admit(self, key: Key, size: int, now: float) -> None:
        raise NotImplementedError

    def on_access(self, key: Key, now: float) -> None:
        raise NotImplementedError

    def on_remove(self, key: Key) -> None:
        raise NotImplementedError

    def victim(self, pinned: Set[Key]) -> Optional[Key]:
        """Coldest non-pinned key, or None if everything is pinned."""
        raise NotImplementedError

    def expired(self, key: Key, now: float) -> bool:
        """TTL hook: True if the entry is stale and must be refetched."""
        return False


class LRUPolicy(EvictionPolicy):
    """Least-recently-used — the seed cache's behaviour."""

    name = "lru"

    def __init__(self) -> None:
        self._order: "OrderedDict[Key, None]" = OrderedDict()

    def on_admit(self, key: Key, size: int, now: float) -> None:
        self._order[key] = None

    def on_access(self, key: Key, now: float) -> None:
        self._order.move_to_end(key)

    def on_remove(self, key: Key) -> None:
        self._order.pop(key, None)

    def victim(self, pinned: Set[Key]) -> Optional[Key]:
        if not pinned:
            return next(iter(self._order), None)
        return next((k for k in self._order if k not in pinned), None)


class FIFOPolicy(LRUPolicy):
    """Insertion order, never promoted on access."""

    name = "fifo"

    def on_access(self, key: Key, now: float) -> None:
        pass


class LFUPolicy(EvictionPolicy):
    """Least-frequently-used, LRU tie-break.

    Keys live in an OrderedDict per access count; victim selection scans
    occupied frequency buckets coldest-first, so it is O(occupied
    buckets), not O(resident keys).
    """

    name = "lfu"

    def __init__(self) -> None:
        self._count: Dict[Key, int] = {}
        self._buckets: Dict[int, "OrderedDict[Key, None]"] = {}

    def _move(self, key: Key, src: int, dst: int) -> None:
        bucket = self._buckets[src]
        bucket.pop(key, None)
        if not bucket:
            del self._buckets[src]
        self._buckets.setdefault(dst, OrderedDict())[key] = None

    def on_admit(self, key: Key, size: int, now: float) -> None:
        self._count[key] = 1
        self._buckets.setdefault(1, OrderedDict())[key] = None

    def on_access(self, key: Key, now: float) -> None:
        c = self._count[key]
        self._count[key] = c + 1
        self._move(key, c, c + 1)

    def on_remove(self, key: Key) -> None:
        c = self._count.pop(key, None)
        if c is None:
            return
        bucket = self._buckets.get(c)
        if bucket is not None:
            bucket.pop(key, None)
            if not bucket:
                del self._buckets[c]

    def victim(self, pinned: Set[Key]) -> Optional[Key]:
        if not self._count:
            return None
        for c in sorted(self._buckets):
            for k in self._buckets[c]:
                if k not in pinned:
                    return k
        return None


class TTLPolicy(LRUPolicy):
    """LRU with a freshness bound (squid-style HTTP semantics).

    A chunk older than ``ttl_seconds`` is treated as a miss on lookup and
    evicted — the consistency story of the proxy baseline, expressed as a
    cache policy so the simulator can compare it against checksummed LRU.
    """

    name = "ttl"

    def __init__(self, ttl_seconds: float = 3600.0) -> None:
        super().__init__()
        self.ttl_seconds = ttl_seconds
        self._admitted: Dict[Key, float] = {}

    def on_admit(self, key: Key, size: int, now: float) -> None:
        super().on_admit(key, size, now)
        self._admitted[key] = now

    def on_remove(self, key: Key) -> None:
        super().on_remove(key)
        self._admitted.pop(key, None)

    def expired(self, key: Key, now: float) -> bool:
        t0 = self._admitted.get(key)
        return t0 is not None and (now - t0) > self.ttl_seconds


class AdmissionPolicy:
    """Decide whether a fetched chunk enters the cache at all."""

    name = "always"

    def admit(self, key: Key, object_size: int, chunk_size: int,
              capacity: int, usage: int) -> bool:
        return True


class SizeAwareAdmission(AdmissionPolicy):
    """Refuse objects larger than ``max_object_fraction`` of capacity.

    ``object_size`` is the whole logical object (not the chunk): one
    scan of a dataset comparable to the cache must not evict the hot set.
    """

    name = "size-aware"

    def __init__(self, max_object_fraction: float = 0.1) -> None:
        self.max_object_fraction = max_object_fraction

    def admit(self, key: Key, object_size: int, chunk_size: int,
              capacity: int, usage: int) -> bool:
        return object_size <= self.max_object_fraction * capacity


EVICTION_POLICIES = {
    "lru": LRUPolicy,
    "lfu": LFUPolicy,
    "ttl": TTLPolicy,
    "fifo": FIFOPolicy,
}


def make_eviction_policy(spec, ttl_seconds: float = 3600.0) -> EvictionPolicy:
    """Build a policy from a name (``"lru"``...) or copy an instance.

    An *instance* spec is deep-copied, never passed through: one policy
    object handed to ``SiteSpec``/``build_*_federation`` with
    ``cache_replicas > 1`` would otherwise be silently shared across
    every cache server of the site, cross-contaminating victim order
    (an access on replica A reordering replica B's LRU stack).
    """
    if isinstance(spec, EvictionPolicy):
        return copy.deepcopy(spec)
    try:
        cls = EVICTION_POLICIES[spec]
    except KeyError:
        raise ValueError(
            f"unknown eviction policy {spec!r}; "
            f"choose from {sorted(EVICTION_POLICIES)}") from None
    if cls is TTLPolicy:
        return TTLPolicy(ttl_seconds)
    return cls()
