"""Write-back caching — the paper's §6 future work, implemented.

"Writeback cache will allow users to write output files to a cache rather
than back to the origin.  Once the files are written to StashCache, writing
to the origin will be scheduled in order to not overwhelm the origin."

Semantics here:
  * ``write`` lands chunks in the cache immediately (fast ack, dirty);
  * reads of a dirty object are served from the cache (read-your-writes);
  * ``drain`` pushes dirty chunks to the owning origin under a rate limit,
    at most ``max_inflight`` objects at a time — the scheduling that keeps
    the origin alive during e.g. a 512-worker checkpoint save.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple, Union

from .cache import CacheServer
from .chunk import ObjectMeta, chunk_object, synthetic_object
from .origin import Origin
from .redirector import RedirectorPair
from .transfer import NetworkModel, TransferStats


@dataclasses.dataclass
class WritebackStats:
    writes: int = 0
    bytes_written: int = 0
    drained_objects: int = 0
    drained_bytes: int = 0
    drain_seconds: float = 0.0


class WritebackCache:
    """Dirty-tracking overlay on a :class:`CacheServer`."""

    def __init__(self, cache: CacheServer, net: NetworkModel,
                 redirectors: RedirectorPair,
                 drain_rate_bytes_per_sec: float = 2e9,
                 max_inflight: int = 4) -> None:
        self.cache = cache
        self.net = net
        self.redirectors = redirectors
        self.drain_rate = drain_rate_bytes_per_sec
        self.max_inflight = max_inflight
        self._dirty: Deque[str] = deque()
        self._pending: Dict[str, Tuple[ObjectMeta, List]] = {}
        self.stats = WritebackStats()

    # ------------------------------------------------------------------
    def write(self, client_node: str, path: str,
              data: Union[bytes, int]) -> Tuple[ObjectMeta, TransferStats]:
        """Write an object into the cache; ack as soon as it is resident."""
        if isinstance(data, (bytes, bytearray)):
            meta, payloads = chunk_object(path, bytes(data))
        else:
            meta, payloads = synthetic_object(path, int(data))
        stats = TransferStats(method="writeback")
        for i, p in enumerate(payloads):
            self.cache.pin(path, i)  # dirty chunks must not be evicted
            # force: dirty data must land regardless of admission policy —
            # the write is acked against cache residency.
            self.cache.admit(path, i, p, force=True)
            stats.bytes += p.size
            stats.chunks += 1
        stats.seconds += self.net.transfer_time(
            client_node, self.cache.node.name, meta.size, streams=4)
        self.cache._metas[path] = meta
        self._pending[path] = (meta, payloads)
        self._dirty.append(path)
        self.stats.writes += 1
        self.stats.bytes_written += meta.size
        return meta, stats

    def dirty_paths(self) -> List[str]:
        return list(self._dirty)

    def is_dirty(self, path: str) -> bool:
        return path in self._pending

    # ------------------------------------------------------------------
    def drain(self, max_objects: Optional[int] = None) -> TransferStats:
        """Flush dirty objects to their origins under the rate limit.

        Processes waves of ``max_inflight`` concurrent pushes until the
        dirty set is empty (or ``max_objects`` reached) — the scheduling
        that keeps the origin alive while still finishing the flush.
        """
        stats = TransferStats(method="writeback-drain")
        budget = max_objects if max_objects is not None else len(self._dirty)
        while self._dirty and budget > 0:
            before = len(self._dirty)
            wave = self._drain_wave(min(self.max_inflight, budget))
            stats.add(wave)
            drained = before - len(self._dirty)
            if drained == 0:
                break
            budget -= drained
        return stats

    def _drain_wave(self, max_objects: int) -> TransferStats:
        stats = TransferStats(method="writeback-drain-wave")
        inflight = 0
        budget = max_objects
        while self._dirty and inflight < self.max_inflight and budget > 0:
            path = self._dirty.popleft()
            meta, payloads = self._pending.pop(path)
            origin = self.redirectors.locate_origin_for_write(path) \
                if hasattr(self.redirectors, "locate_origin_for_write") else None
            if origin is None:
                origin = self._owner_origin(path)
            # Rate-limited push: the origin is protected by design.
            wire = self.net.transfer_time(self.cache.node.name,
                                          origin.node.name, meta.size,
                                          streams=4)
            limited = meta.size / self.drain_rate
            seconds = max(wire, limited)
            if payloads[0].data is not None:
                origin.put_object(path, b"".join(p.data for p in payloads),
                                  mtime=meta.mtime)
            else:
                origin.put_object(path, meta.size, mtime=meta.mtime)
            for i in range(meta.num_chunks):
                self.cache.unpin(path, i)  # now clean → evictable
            stats.bytes += meta.size
            stats.seconds += seconds
            stats.chunks += meta.num_chunks
            self.stats.drained_objects += 1
            self.stats.drained_bytes += meta.size
            self.stats.drain_seconds += seconds
            inflight += 1
            budget -= 1
        return stats

    def _owner_origin(self, path: str) -> Origin:
        for r in self.redirectors.members:
            owner = r.namespace.resolve(path)
            if owner is not None and owner in r.origins:
                return r.origins[owner]
        # Unclaimed prefix: fall back to the first subscribed origin.
        return next(iter(self.redirectors.members[0].origins.values()))
