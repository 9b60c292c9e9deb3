"""StashCache cache servers (paper §3).

Regional caches capture client data requests, check local storage, and on a
miss locate the data via the redirector and pull it from the origin before
serving the client.  Space is transient: the server may reclaim (evict) any
resident chunk without breaking workflows — that is the property that makes
opportunistic *storage* viable as a *cache*.

Design split:
  * pure state-machine methods (``lookup`` / ``admit`` / ``evict_until``)
    are reused verbatim by the discrete-event simulator, which supplies its
    own timing/contention; and
  * the networked path (``get_chunk`` / ``fetch_object``) uses the
    uncontended :class:`~repro_torch.core.transfer.NetworkModel` and emits
    monitoring packets, serving the functional data loader.

Eviction and admission are pluggable (:mod:`repro_torch.core.policies`): the
seed's LRU remains the default, with LFU / TTL / FIFO variants and a
size-aware admission filter selectable per cache (and per site, via
:class:`~repro_torch.core.federation.SiteSpec`).  Policy behaviour is surfaced
through the monitoring pipeline as :class:`~repro_torch.core.monitoring.
CacheUsagePacket` gauges.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Optional, Set, Tuple, Union

from .chunk import ObjectMeta, Payload
from .monitoring import (CacheUsagePacket, FileClose, FileOpen,
                         MonitorCollector, UserLogin)
from .policies import (AdmissionPolicy, EvictionPolicy, make_eviction_policy)
from .redirector import RedirectorPair
from .topology import Node
from .transfer import NetworkModel, TransferStats


@dataclasses.dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    evictions: int = 0
    bytes_served: int = 0
    bytes_from_origin: int = 0
    bytes_from_parent: int = 0   # cache-to-cache fill (tiered federations)
    bytes_evicted: int = 0
    ttl_expired: int = 0
    admission_rejects: int = 0
    oversize_rejects: int = 0
    replacements: int = 0

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0


class CacheServer:
    """A chunk-granular cache server with a pluggable eviction policy."""

    _ids = itertools.count(1)

    def __init__(self, name: str, node: Node, capacity_bytes: int,
                 redirectors: Optional[RedirectorPair] = None,
                 net: Optional[NetworkModel] = None,
                 monitor: Optional[MonitorCollector] = None,
                 mem_object_max: float = 4e9,
                 disk_bw: float = 0.0,
                 policy: Union[str, EvictionPolicy] = "lru",
                 ttl_seconds: float = 3600.0,
                 admission: Optional[AdmissionPolicy] = None) -> None:
        self.name = name
        self.node = node
        self.capacity_bytes = capacity_bytes
        self.mem_object_max = mem_object_max
        self.disk_bw = disk_bw
        self.redirectors = redirectors
        self.net = net
        self.monitor = monitor
        self.available = True  # failure injection point
        # Cache hierarchy (multi-tier CDN): a cache with a parent group
        # fills misses from the parent tier's ring before the origin.
        # Wired by Federation._build from SiteSpec.parent; tier 1 = edge.
        self.parent_group = None  # Optional[repro_torch.core.ring.CacheGroup]
        self.tier = 1
        self.policy = make_eviction_policy(policy, ttl_seconds)
        self.admission = admission or AdmissionPolicy()
        # (path, chunk_index) -> Payload.  Pure storage: victim ordering
        # lives entirely in the policy object.  (Kept under the historic
        # `_lru` name — external invariant checks sum over it.)
        self._lru: Dict[Tuple[str, int], Payload] = {}
        self._pinned: Set[Tuple[str, int]] = set()
        self._metas: Dict[str, ObjectMeta] = {}
        self.usage_bytes = 0
        self.stats = CacheStats()
        self.clock = 0.0  # advanced by callers (simulator / client `now`)
        self._file_ids = itertools.count(1)
        self._user_ids = itertools.count(1)

    # ------------------------------------------------------------------
    # Pure cache state machine (shared with the simulator)
    # ------------------------------------------------------------------
    def tick(self, now: float) -> None:
        """Advance the cache's notion of time (TTL policies use it)."""
        if now > self.clock:
            self.clock = now

    def lookup(self, path: str, index: int) -> Optional[Payload]:
        key = (path, index)
        payload = self._lru.get(key)
        if payload is None:
            self.stats.misses += 1
            return None
        if self.policy.expired(key, self.clock):
            self._remove(key)
            self.stats.ttl_expired += 1
            self.stats.misses += 1
            return None
        self.policy.on_access(key, self.clock)
        self.stats.hits += 1
        return payload

    def resident(self, path: str, index: int) -> bool:
        """Peek without perturbing victim order or counters."""
        key = (path, index)
        return key in self._lru and not self.policy.expired(key, self.clock)

    def object_resident(self, meta: ObjectMeta) -> bool:
        return all(self.resident(meta.path, i) for i in range(meta.num_chunks))

    def admit(self, path: str, index: int, payload: Payload,
              object_size: Optional[int] = None,
              force: bool = False) -> bool:
        """Insert a chunk, evicting cold chunks to make room.  In-flight
        (pinned) chunks are never evicted.  Returns False when the
        admission policy refuses the object (size-aware admission) or
        when the payload alone exceeds ``capacity_bytes`` (it can never
        fit); ``force`` bypasses both (write-back dirty data must land,
        even over-committed)."""
        key = (path, index)
        if key in self._lru:
            if self.policy.expired(key, self.clock):
                self._remove(key)  # stale entry: fall through to re-admit
                self.stats.ttl_expired += 1
            elif (self._lru[key].size == payload.size
                  and self._lru[key].digest == payload.digest):
                # Identical replica (collapsed-forwarding re-admit race):
                # a pure touch.
                self.policy.on_access(key, self.clock)
                return True
            else:
                # Re-published chunk: the resident copy is stale.  Serving
                # it would hand out old bytes and leave any size delta
                # unaccounted — replace it (the LocalCache.put fix):
                # remove without counting an eviction, then fall through
                # to a fresh admission of the new payload.
                self._remove(key)
                self.stats.replacements += 1
        if object_size is None:
            meta = self._metas.get(path)
            object_size = meta.size if meta is not None else payload.size
        if not force and not self.admission.admit(
                key, object_size, payload.size,
                self.capacity_bytes, self.usage_bytes):
            self.stats.admission_rejects += 1
            return False
        if not force and payload.size > self.capacity_bytes:
            # Refusing outright beats draining the whole cache and then
            # over-committing: the chunk can never fit, and inserting it
            # anyway would leave usage_bytes > capacity_bytes forever.
            self.stats.oversize_rejects += 1
            return False
        self.evict_until(payload.size)
        self._lru[key] = payload
        self.policy.on_admit(key, payload.size, self.clock)
        self.usage_bytes += payload.size
        return True

    def evict_until(self, incoming: int) -> None:
        while self.usage_bytes + incoming > self.capacity_bytes and self._lru:
            victim = self.policy.victim(self._pinned)
            if victim is None:
                break  # everything pinned; over-commit rather than deadlock
            payload = self._remove(victim)
            self.stats.evictions += 1
            self.stats.bytes_evicted += payload.size

    def _remove(self, key: Tuple[str, int]) -> Optional[Payload]:
        payload = self._lru.pop(key, None)
        if payload is not None:
            self.usage_bytes -= payload.size
            self.policy.on_remove(key)
        return payload

    def serve_rate_cap(self, object_size: int) -> float:
        """xrootd disk caches stream large objects at disk speed."""
        if self.disk_bw and object_size > self.mem_object_max:
            return self.disk_bw
        return 0.0

    def pin(self, path: str, index: int) -> None:
        self._pinned.add((path, index))

    def unpin(self, path: str, index: int) -> None:
        self._pinned.discard((path, index))

    def drop(self, path: str, index: int) -> None:
        self._remove((path, index))

    def clear(self) -> None:
        """Cold restart: lose every resident chunk (and pin) without
        counting evictions — the disk came back empty, nothing was
        *chosen* as a victim.  Hit/miss history and located metas keep
        their values; only storage state resets."""
        self._pinned.clear()
        for key in list(self._lru):
            self._remove(key)

    def corrupt(self, path: str, index: int) -> None:
        """Bit-flip a resident chunk (integrity tests)."""
        key = (path, index)
        if key in self._lru:
            self._lru[key] = self._lru[key].corrupted()

    # ------------------------------------------------------------------
    # Networked path (functional federation)
    # ------------------------------------------------------------------
    def locate_meta(self, path: str) -> Optional[ObjectMeta]:
        if path in self._metas:
            return self._metas[path]
        origin = self.redirectors.locate(path) if self.redirectors else None
        if origin is None:
            return None
        meta = origin.meta(path)
        self._metas[path] = meta
        return meta

    def parent_caches(self, path: str):
        """Live parent-tier fill targets for ``path``, in ring order."""
        if self.parent_group is None:
            return []
        return [c for c in self.parent_group.fill_chain(path)
                if c.available and c is not self]

    def _obtain(self, path: str, index: int, streams: int,
                object_size: Optional[int] = None
                ) -> Tuple[Optional[Payload], float, bool]:
        """Ensure one chunk is in hand, counting a hit or miss here.

        On a miss the chunk fills from the parent tier's ring owner when
        one is alive (cache-to-cache fill; the parent recursively resolves
        *its* miss, so only the top tier pays the redirector RPC + origin
        pull), falling back to the flat redirector → origin path when
        there is no live parent.  Returns ``(payload, upstream_seconds,
        hit)`` — upstream_seconds excludes the cache → client hop.
        """
        payload = self.lookup(path, index)
        if payload is not None:
            return payload, 0.0, True
        parents = self.parent_caches(path)
        if parents:
            parent = parents[0]
            parent.tick(self.clock)
            # The fill request carries the child's object-size knowledge
            # (size-aware admission at the parent sees what the child saw).
            meta = self._metas.get(path)
            up_size = object_size if object_size is not None else (
                meta.size if meta is not None else None)
            self.pin(path, index)
            try:
                payload, secs, _ = parent._obtain(path, index, streams,
                                                  object_size=up_size)
                if payload is None:
                    return None, secs, False
                secs += self.net.transfer_time(
                    parent.node.name, self.node.name, payload.size,
                    streams=max(streams, 4))
                parent.stats.bytes_served += payload.size
                self.stats.bytes_from_parent += payload.size
                self.admit(path, index, payload, object_size=object_size)
            finally:
                self.unpin(path, index)
            return payload, secs, False
        origin = self.redirectors.locate(path) if self.redirectors else None
        if origin is None:
            return None, 0.0, False
        # redirector round-trip, then chunk pull over the WAN/DCN.
        redirector_node = self.redirectors.members[0].node.name
        secs = self.net.rpc_time(self.node.name, redirector_node)
        self.pin(path, index)
        try:
            payload = origin.read_chunk(path, index)
            secs += self.net.transfer_time(
                origin.node.name, self.node.name, payload.size,
                streams=max(streams, 4))
            self.stats.bytes_from_origin += payload.size
            self.admit(path, index, payload, object_size=object_size)
        finally:
            self.unpin(path, index)
        return payload, secs, False

    def get_chunk(self, client_node: str, path: str, index: int,
                  streams: int = 1) -> Tuple[Optional[Payload], TransferStats]:
        """Serve one chunk to a client; on miss, locate + pull from the
        parent tier (if any) or the origin.

        Time accounting covers: (miss only) the upstream fill — parent →
        cache transfer, plus the parent tier's own redirector RPC +
        origin pull when the parent missed too — then the cache → client
        transfer.
        """
        if not self.available:
            raise ConnectionError(f"cache {self.name} unavailable")
        stats = TransferStats(source=self.name)
        payload, upstream, hit = self._obtain(path, index, streams)
        if payload is None:
            return None, stats
        if hit:
            stats.cache_hits += 1
        else:
            stats.seconds += upstream
            stats.cache_misses += 1
        # cache → client hop (disk-bound for large objects).
        meta = self._metas.get(path)
        obj_size = meta.size if meta is not None else payload.size
        stats.seconds += self.net.transfer_time(
            self.node.name, client_node, payload.size, streams=streams,
            rate_cap=self.serve_rate_cap(obj_size))
        stats.bytes += payload.size
        stats.chunks += 1
        self.stats.bytes_served += payload.size
        return payload, stats

    # ------------------------------------------------------------------
    # Monitoring hooks (paper §3.2)
    # ------------------------------------------------------------------
    def open_session(self, client_host: str, protocol: str, now: float,
                     ipv6: bool = False) -> int:
        user_id = next(self._user_ids)
        if self.monitor:
            self.monitor.user_login(UserLogin(self.name, user_id, client_host,
                                              protocol, ipv6, now))
        return user_id

    def open_file(self, user_id: int, meta: ObjectMeta, now: float) -> int:
        file_id = next(self._file_ids)
        if self.monitor:
            self.monitor.file_open(FileOpen(self.name, file_id, user_id,
                                            meta.path, meta.size, now))
        return file_id

    def close_file(self, file_id: int, bytes_read: int, n_ops: int,
                   now: float, cache_hit: Optional[bool] = None,
                   bytes_written: int = 0) -> None:
        if self.monitor:
            self.monitor.file_close(
                FileClose(self.name, file_id, bytes_read, bytes_written,
                          n_ops, now), cache_hit=cache_hit)

    def report_usage(self, now: Optional[float] = None) -> CacheUsagePacket:
        """Emit a policy/usage gauge to the monitoring collector.

        This is the per-policy counter surface: hit/miss/eviction totals,
        TTL expiries and admission rejects, keyed by policy name, so the
        aggregators can build the policy-comparison tables the fleet
        benches report.
        """
        pkt = CacheUsagePacket(
            server=self.name, policy=self.policy.name,
            usage_bytes=self.usage_bytes, capacity_bytes=self.capacity_bytes,
            hits=self.stats.hits, misses=self.stats.misses,
            evictions=self.stats.evictions,
            bytes_evicted=self.stats.bytes_evicted,
            ttl_expired=self.stats.ttl_expired,
            admission_rejects=self.stats.admission_rejects,
            oversize_rejects=self.stats.oversize_rejects,
            tier=self.tier,
            bytes_from_parent=self.stats.bytes_from_parent,
            time=self.clock if now is None else now)
        if self.monitor:
            self.monitor.cache_usage(pkt)
        return pkt
