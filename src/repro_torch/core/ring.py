"""Consistent-hash HA cache groups (paper §2's redirector-pair idiom,
generalized).

The paper keeps the *redirector* highly available with a two-member
round-robin pair.  At fleet scale the caches themselves need the same
treatment: a site (or region) runs a *group* of cache servers, and clients
route each object to a group member with consistent hashing, so

* the working set is partitioned across members (no duplicate residency,
  N× the effective capacity), and
* a dead member degrades to the next server on the ring — only its ~1/N
  share of the keyspace remaps, and requests fail over to a server that
  is warm for the remapped keys' neighbours rather than to the origin.

``HashRing`` is the generic structure (FNV-1a over virtual nodes — the
same hash family as the chunk checksums); ``CacheGroup`` binds it to
:class:`~repro_torch.core.cache.CacheServer` members with liveness-aware
routing and failover accounting.
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, List, Optional, Sequence, TYPE_CHECKING

from .chunk import fnv1a64

if TYPE_CHECKING:  # pragma: no cover - typing only
    from .cache import CacheServer

DEFAULT_VNODES = 64


class HashRing:
    """Consistent hashing with virtual nodes.

    Each member is hashed at ``vnodes`` points on a 64-bit ring; a key is
    owned by the first member clockwise of its hash.  ``successors``
    returns distinct members in ring order, which is the failover chain.
    """

    def __init__(self, members: Sequence[str] = (),
                 vnodes: int = DEFAULT_VNODES) -> None:
        self.vnodes = vnodes
        self._points: List[int] = []       # sorted vnode hashes
        self._owner: Dict[int, str] = {}   # vnode hash -> member
        self._members: List[str] = []
        for m in members:
            self.add(m)

    def __len__(self) -> int:
        return len(self._members)

    @property
    def members(self) -> List[str]:
        return list(self._members)

    @staticmethod
    def _hash(key: str) -> int:
        # FNV-1a alone clusters sequential keys (the trailing characters
        # barely reach the high bits, and ring placement *is* the high
        # bits); run it through a murmur3-style avalanche finalizer.
        h = fnv1a64(key.encode())
        h ^= h >> 33
        h = (h * 0xFF51AFD7ED558CCD) & 0xFFFFFFFFFFFFFFFF
        h ^= h >> 33
        h = (h * 0xC4CEB9FE1A85EC53) & 0xFFFFFFFFFFFFFFFF
        return h ^ (h >> 33)

    def add(self, member: str) -> None:
        if member in self._members:
            return
        self._members.append(member)
        for v in range(self.vnodes):
            h = self._hash(f"{member}#{v}")
            idx = bisect.bisect_left(self._points, h)
            self._points.insert(idx, h)
            self._owner[h] = member

    def remove(self, member: str) -> None:
        if member not in self._members:
            return
        self._members.remove(member)
        for v in range(self.vnodes):
            h = self._hash(f"{member}#{v}")
            idx = bisect.bisect_left(self._points, h)
            if idx < len(self._points) and self._points[idx] == h \
                    and self._owner.get(h) == member:
                self._points.pop(idx)
                del self._owner[h]

    def owner(self, key: str) -> Optional[str]:
        chain = self.successors(key, 1)
        return chain[0] if chain else None

    def successors(self, key: str, k: Optional[int] = None) -> List[str]:
        """First ``k`` distinct members clockwise of ``key`` (all by
        default) — the primary plus its failover chain."""
        if not self._points:
            return []
        want = len(self._members) if k is None else min(k, len(self._members))
        start = bisect.bisect_right(self._points, self._hash(key))
        out: List[str] = []
        for i in range(len(self._points)):
            m = self._owner[self._points[(start + i) % len(self._points)]]
            if m not in out:
                out.append(m)
                if len(out) == want:
                    break
        return out


@dataclasses.dataclass
class GroupStats:
    routes: int = 0
    failovers: int = 0    # primary dead → served by a ring successor
    remapped_keys: int = 0  # dead members skipped along the chain
    outages: int = 0      # members marked down (storm/blackout/upgrade)
    recoveries: int = 0   # members marked back up
    cold_restarts: int = 0  # recoveries that came back with empty storage
    auto_outages: int = 0   # subset of outages fired by health gauges
    auto_recoveries: int = 0  # subset of recoveries fired by health probes


class CacheGroup:
    """An HA group of cache servers behind one consistent-hash ring."""

    def __init__(self, name: str, members: Sequence["CacheServer"],
                 vnodes: int = DEFAULT_VNODES) -> None:
        self.name = name
        self.caches: Dict[str, "CacheServer"] = {c.name: c for c in members}
        self.ring = HashRing(list(self.caches), vnodes=vnodes)
        self.stats = GroupStats()

    @property
    def members(self) -> List["CacheServer"]:
        return list(self.caches.values())

    def add(self, cache: "CacheServer") -> None:
        self.caches[cache.name] = cache
        self.ring.add(cache.name)

    def remove(self, name: str) -> None:
        self.caches.pop(name, None)
        self.ring.remove(name)

    def alive(self) -> List["CacheServer"]:
        return [c for c in self.caches.values() if c.available]

    def route(self, path: str, exclude: Sequence[str] = (),
              live_only: bool = False,
              count_stats: bool = True) -> List["CacheServer"]:
        """Members in ring order for ``path`` — element 0 is the owner,
        the rest its failover chain.  A dead primary counts one failover
        (the key remaps to the next ring member).  Callers that do their
        own liveness handling (the client's retry loop) take the full
        chain; ``live_only`` pre-filters it.  Rankings that merely
        *include* this group without serving from it pass
        ``count_stats=False`` so fleet-wide reads don't inflate every
        group's counters."""
        if count_stats:
            self.stats.routes += 1
        chain = [self.caches[n] for n in self.ring.successors(path)
                 if n not in exclude]
        if count_stats and chain and not chain[0].available:
            # Failover depth: how many dead ring members the key skips
            # before reaching a live one (an outage storm can knock out
            # several consecutive successors at once).
            dead = 0
            for c in chain:
                if c.available:
                    break
                dead += 1
            self.stats.failovers += 1
            self.stats.remapped_keys += dead
        if live_only:
            return [c for c in chain if c.available]
        return chain

    def fill_chain(self, path: str) -> List["CacheServer"]:
        """Ring-ordered fill targets for a *child-tier* cache miss.

        Cache-to-cache fill uses the same consistent-hash ownership as
        client routing — so every child below this group funnels a given
        path to the same parent member (one parent copy per object, N×
        effective parent capacity) — but does not count route/failover
        stats: a fill is upstream traffic, not a client route.  Liveness
        filtering is the caller's job (it needs to see dead members to
        fall through to the origin deliberately).
        """
        return self.route(path, count_stats=False)

    def mark_down(self, name: str, auto: bool = False) -> None:
        """Outage injection: the member stays on the ring (its keyspace
        share fails over along the chain) but stops serving.  ``auto``
        tags gauge-driven demotions (health monitor) separately from
        scripted schedule entries; the available-guard already dedupes
        overlapping triggers — a member down is down once, whichever
        trigger fired first gets the counter."""
        cache = self.caches.get(name)
        if cache is not None and cache.available:
            cache.available = False
            self.stats.outages += 1
            if auto:
                self.stats.auto_outages += 1

    def mark_up(self, name: str, cold: bool = False,
                auto: bool = False) -> None:
        """Recovery; ``cold`` models a restart that lost its disk (the
        member returns owning its old keyspace but holding nothing)."""
        cache = self.caches.get(name)
        if cache is None:
            return
        if not cache.available:
            self.stats.recoveries += 1
            if cold:
                self.stats.cold_restarts += 1
                cache.clear()
            if auto:
                self.stats.auto_recoveries += 1
            cache.available = True

    def locus(self) -> Optional["CacheServer"]:
        """A representative member, for distance ranking of the group."""
        members = self.members
        return members[0] if members else None
