"""Site HTTP forward proxies — the baseline StashCache is evaluated against.

The paper's §4.1/§5 observations, reproduced here as behaviour:

* proxies are optimised for small files (software, conditions data): they
  have near-zero client startup cost (the nearest proxy arrives via the
  environment, no discovery round-trip);
* proxies are configured **not to cache large files**: in all paper tests
  the 2.3 GB and 10 GB files were never cached (``max_cacheable_bytes``);
* proxy entries **expire rapidly** — while looping over the paper's file
  list, the first files were already gone by the end of one pass (small
  capacity + TTL);
* transfers are single-stream HTTP (window-limited on the WAN), and a miss
  goes straight to the origin — there is no redirector/federation;
* no checksums: a corrupted cached object is served silently (§6 notes
  CVMFS's checksums as a differentiator).

Objects are cached whole (HTTP granularity), not chunked.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Dict, Optional, Tuple

from .chunk import ObjectMeta, Payload
from .origin import Origin
from .topology import Node
from .transfer import NetworkModel, TransferStats


@dataclasses.dataclass
class ProxyEntry:
    payload_bytes: int
    inserted_at: float
    corrupt: bool = False


@dataclasses.dataclass
class ProxyStats:
    hits: int = 0
    misses: int = 0
    uncacheable: int = 0
    expirations: int = 0
    evictions: int = 0
    bytes_served: int = 0
    bytes_from_origin: int = 0


class HTTPProxy:
    """A squid-like site forward proxy (whole-object, TTL, size-capped)."""

    def __init__(self, name: str, node: Node, origin: Origin,
                 net: NetworkModel,
                 capacity_bytes: int = 10 * 2**30,
                 max_cacheable_bytes: int = 1 * 2**30,
                 ttl_seconds: float = 3600.0,
                 mem_object_max: float = 4e9,
                 disk_bw: float = 0.9e9) -> None:
        self.name = name
        self.node = node
        self.origin = origin
        self.net = net
        self.capacity_bytes = capacity_bytes
        self.max_cacheable_bytes = max_cacheable_bytes
        self.ttl_seconds = ttl_seconds
        self.mem_object_max = mem_object_max
        self.disk_bw = disk_bw
        self._entries: "OrderedDict[str, ProxyEntry]" = OrderedDict()
        self.usage_bytes = 0
        self.stats = ProxyStats()

    # -- state machine (shared with the simulator) --------------------------
    def lookup(self, path: str, now: float) -> Optional[ProxyEntry]:
        entry = self._entries.get(path)
        if entry is None:
            self.stats.misses += 1
            return None
        if now - entry.inserted_at > self.ttl_seconds:
            # Rapid expiry: the behaviour that bit the paper's first
            # experiment design (§5).
            self._evict(path, expired=True)
            self.stats.misses += 1
            return None
        self._entries.move_to_end(path)
        self.stats.hits += 1
        return entry

    def cacheable(self, size: int) -> bool:
        return size <= self.max_cacheable_bytes

    def admit(self, path: str, size: int, now: float) -> bool:
        if not self.cacheable(size):
            self.stats.uncacheable += 1
            return False
        while self.usage_bytes + size > self.capacity_bytes and self._entries:
            self._evict(next(iter(self._entries)))
        self._entries[path] = ProxyEntry(size, now)
        self.usage_bytes += size
        return True

    def _evict(self, path: str, expired: bool = False) -> None:
        entry = self._entries.pop(path, None)
        if entry is not None:
            self.usage_bytes -= entry.payload_bytes
            if expired:
                self.stats.expirations += 1
            else:
                self.stats.evictions += 1

    def serve_rate_cap(self, object_size: int) -> float:
        if self.disk_bw and object_size > self.mem_object_max:
            return self.disk_bw
        return 0.0

    def corrupt(self, path: str) -> None:
        if path in self._entries:
            self._entries[path].corrupt = True

    def resident(self, path: str, now: float) -> bool:
        e = self._entries.get(path)
        return e is not None and (now - e.inserted_at) <= self.ttl_seconds

    # -- networked path ------------------------------------------------------
    def get_object(self, client_node: str, meta: ObjectMeta,
                   now: float = 0.0) -> Tuple[bool, TransferStats]:
        """Serve a whole object over single-stream HTTP.

        Returns (corrupt, stats).  A hit streams proxy→client; a miss
        streams origin→proxy→client (store-and-forward at HTTP granularity)
        and admits the object if it is under the cacheable size cap.
        """
        stats = TransferStats(method="http_proxy", source=self.name)
        entry = self.lookup(meta.path, now)
        corrupt = False
        if entry is None:
            # Miss: origin → proxy (single stream over the WAN), then serve.
            stats.seconds += self.net.transfer_time(
                self.origin.node.name, self.node.name, meta.size, streams=1)
            self.stats.bytes_from_origin += meta.size
            # Pull through the origin's real read path so its egress /
            # request counters see the proxy arm's load — otherwise
            # proxy-vs-stash comparisons under-report origin traffic.
            for ref in meta.chunk_refs():
                self.origin.read_chunk(meta.path, ref.index)
            self.admit(meta.path, meta.size, now)
            stats.cache_misses += 1
        else:
            corrupt = entry.corrupt
            stats.cache_hits += 1
        stats.seconds += self.net.transfer_time(
            self.node.name, client_node, meta.size, streams=1,
            rate_cap=self.serve_rate_cap(meta.size))
        stats.bytes += meta.size
        stats.chunks += 1
        self.stats.bytes_served += meta.size
        return corrupt, stats
