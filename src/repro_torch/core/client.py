"""Federation clients: CVMFS and ``stashcp`` (paper §3.1).

CVMFS gives a read-only POSIX view: partial reads fetch only the 24 MB
chunks an application touches, each verified against the catalog checksum,
with a small (default 1 GB) local LRU cache — deliberately small because
the working set won't fit a worker's disk and the nearby cache is assumed
fast.  Its GeoIP locator is built in (no per-read discovery cost).

``stashcp`` copies whole files with a three-way fallback chain:
  (1) CVMFS if available on the host,
  (2) the XRootD client (efficient multi-stream transfers),
  (3) plain curl against the cache's HTTP endpoint (fewest features).
Its startup is *slower* than a proxy download because the nearest cache
must be discovered via a remote GeoIP query — the small-file penalty the
paper measures (Fig. 8).

Beyond the paper: hedged fetches — if the nearest cache is down (or a
deadline passes in simulator-driven runs) the client retries against the
next-nearest cache, which is our straggler-mitigation hook for restart
storms on a TPU fleet.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple, Union

from .cache import CacheServer
from .chunk import ObjectMeta, Payload
from .indexer import Catalog
from .ring import CacheGroup
from .routing import RankingPolicy, make_ranking_policy, ranked_caches
from .topology import GeoIPService, Node
from .transfer import NetworkModel, TransferStats


@dataclasses.dataclass
class ClientStats:
    reads: int = 0
    copies: int = 0
    local_hits: int = 0
    local_misses: int = 0
    checksum_failures: int = 0
    cache_failovers: int = 0
    hedged_fetches: int = 0
    origin_fallbacks: int = 0  # every ranked cache dead → direct pull


class LocalCache:
    """CVMFS's on-worker cache (default 1 GB, LRU at chunk granularity)."""

    def __init__(self, capacity_bytes: int = 1 * 2**30) -> None:
        self.capacity_bytes = capacity_bytes
        self._lru: "OrderedDict[Tuple[str, int], Payload]" = OrderedDict()
        self.usage_bytes = 0

    def get(self, path: str, index: int) -> Optional[Payload]:
        key = (path, index)
        p = self._lru.get(key)
        if p is not None:
            self._lru.move_to_end(key)
        return p

    def put(self, path: str, index: int, payload: Payload) -> None:
        key = (path, index)
        old = self._lru.pop(key, None)
        if old is not None:
            # Re-fetched chunk: the new payload supersedes whatever was
            # resident (a checksum failure + drop/re-pull race can leave a
            # stale copy here) — replace it and account the size delta
            # rather than touching the stale entry and returning.
            self.usage_bytes -= old.size
        if payload.size > self.capacity_bytes:
            # Refusing outright beats draining the whole cache and then
            # overcommitting: the chunk can never fit, and inserting it
            # anyway would leave usage_bytes > capacity_bytes forever.
            return
        while self.usage_bytes + payload.size > self.capacity_bytes and self._lru:
            _, victim = self._lru.popitem(last=False)
            self.usage_bytes -= victim.size
        self._lru[key] = payload
        self.usage_bytes += payload.size

    def drop(self, path: str, index: int) -> None:
        p = self._lru.pop((path, index), None)
        if p is not None:
            self.usage_bytes -= p.size


class StashClient:
    """A worker-side federation client (CVMFS + stashcp semantics)."""

    def __init__(self, node: Node, caches: Sequence[CacheServer],
                 geoip: GeoIPService, net: NetworkModel,
                 catalog: Optional[Catalog] = None,
                 cvmfs_available: bool = True,
                 xrootd_available: bool = True,
                 local_cache_bytes: int = 1 * 2**30,
                 groups: Optional[Sequence[CacheGroup]] = None,
                 now: float = 0.0,
                 ranking: Union[str, RankingPolicy, None] = None,
                 device=None) -> None:
        self.node = node
        self.device = device    # where real chunks are verified
        self.caches = {c.name: c for c in caches}
        self.groups = list(groups) if groups else []
        for g in self.groups:
            for c in g.members:
                self.caches.setdefault(c.name, c)
        self.geoip = geoip
        self.net = net
        self.catalog = catalog
        self.cvmfs_available = cvmfs_available
        self.xrootd_available = xrootd_available
        self.local = LocalCache(local_cache_bytes)
        self.stats = ClientStats()
        self.now = now
        # Pluggable cache ranking (static GeoIP by default; "probe"
        # re-ranks on observed latency/failures — see core/routing.py).
        self.ranking = make_ranking_policy(ranking)
        # Optional ControlPlane (set by the owning plane): per-cache
        # circuit breakers + retry backoff replace blind failover.
        self.control = None

    # ------------------------------------------------------------------
    def _ranked_caches(self, exclude: Sequence[str] = (),
                       path: Optional[str] = None,
                       limit: Optional[int] = None) -> List[CacheServer]:
        """Cache servers in preference order for ``path``.

        Without HA groups (the paper's deployment) this is pure GeoIP
        distance.  With groups, the *groups* are ranked by distance and
        each contributes its members in consistent-hash ring order for
        the path — so a given object always lands on the same member of
        the nearest group, and a dead member degrades to the next ring
        member instead of straight to the origin.

        ``limit`` truncates the failover tail: a fleet-scale ranking over
        1000+ single-member groups otherwise walks every group's ring per
        request even though only the first few entries are ever tried.

        The ordering itself is the client's :class:`RankingPolicy`
        (static GeoIP by default) via the shared
        :func:`repro_torch.core.routing.ranked_caches` pipeline.
        """
        return ranked_caches(self.node.name, self.caches, self.groups,
                             self.geoip, policy=self.ranking, path=path,
                             exclude=exclude, limit=limit)

    def _meta(self, path: str, cache: Optional[CacheServer] = None
              ) -> Optional[ObjectMeta]:
        if self.catalog is not None and path in self.catalog:
            return self.catalog.lookup(path)
        if cache is not None:
            return cache.locate_meta(path)
        for c in self._ranked_caches(path=path):
            m = c.locate_meta(path)
            if m is not None:
                return m
        return None

    def _fetch_chunk(self, path: str, index: int, expected_digest: int,
                     streams: int, verify: bool
                     ) -> Tuple[Optional[Payload], TransferStats]:
        """Fetch one chunk with nearest-cache + failover + checksum retry.

        With a control plane attached, dead or erroring caches feed
        per-cache circuit breakers (an open breaker is skipped without
        paying the connect timeout) and each retry backs off
        exponentially — the backoff wall time lands in ``agg.seconds``
        so the caller's latency accounting sees it."""
        agg = TransferStats()
        tried: List[str] = []
        ctrl = self.control
        n_backoff = 0
        for cache in self._ranked_caches(path=path):
            if ctrl is not None:
                ctrl.maybe_recover(cache.name, self.now)
            if not cache.available:
                tried.append(cache.name)
                self.stats.cache_failovers += 1
                self.ranking.on_failure(cache.name)
                if ctrl is not None:
                    ctrl.on_failure(cache.name, self.now)
                continue
            if ctrl is not None and not ctrl.allow(cache.name, self.now):
                tried.append(cache.name)
                continue
            cache.tick(self.now)  # TTL policies expire against client time
            try:
                payload, st = cache.get_chunk(self.node.name, path, index,
                                              streams=streams)
            except ConnectionError:
                tried.append(cache.name)
                self.stats.cache_failovers += 1
                self.ranking.on_failure(cache.name)
                if ctrl is not None:
                    ctrl.on_failure(cache.name, self.now)
                    delay = ctrl.backoff(n_backoff)
                    n_backoff += 1
                    ctrl.stats.retries += 1
                    ctrl.stats.backoff_seconds += delay
                    agg.seconds += delay
                continue
            agg.add(st)
            agg.source = cache.name
            self.ranking.observe(cache.name, st.seconds)
            if ctrl is not None:
                ctrl.on_success(cache.name, self.now, seconds=st.seconds)
            if payload is None:
                return None, agg
            if verify and expected_digest and \
                    not payload.verify(self.device):
                # CVMFS consistency guarantee: drop the corrupt replica at
                # the cache, refetch once from upstream (§6).
                self.stats.checksum_failures += 1
                cache.drop(path, index)
                payload, st2 = cache.get_chunk(self.node.name, path, index,
                                               streams=streams)
                agg.add(st2)
                if payload is None or (expected_digest and
                                       not payload.verify(self.device)):
                    tried.append(cache.name)
                    continue
            return payload, agg
        return None, agg

    # ------------------------------------------------------------------
    # CVMFS: POSIX partial reads through the nearest cache
    # ------------------------------------------------------------------
    def read(self, path: str, offset: int = 0,
             length: Optional[int] = None
             ) -> Tuple[Optional[bytes], TransferStats]:
        """POSIX read: fetch only the chunks covering [offset, offset+len).

        Returns assembled bytes (None when payloads are synthetic) plus
        transfer accounting.  Verified against catalog chunk checksums.
        """
        if not self.cvmfs_available:
            raise RuntimeError("CVMFS not mounted on this host")
        meta = self._meta(path)
        if meta is None:
            raise FileNotFoundError(path)
        if length is None:
            length = meta.size - offset
        length = max(0, min(length, meta.size - offset))
        self.stats.reads += 1
        stats = TransferStats(method="cvmfs")
        pieces: List[Optional[bytes]] = []
        n_ops = 0
        ranked = self._ranked_caches(path=path) if self.caches else []
        cache_for_monitor = ranked[0] if ranked else None
        user_id = file_id = None
        if cache_for_monitor is not None:
            user_id = cache_for_monitor.open_session(
                self.node.name, "xrootd", self.now)
            file_id = cache_for_monitor.open_file(user_id, meta, self.now)
        for ref in meta.chunks_for_range(offset, length):
            n_ops += 1
            local = self.local.get(path, ref.index)
            if local is not None:
                self.stats.local_hits += 1
                stats.local_hits += 1
                payload = local
            else:
                self.stats.local_misses += 1
                payload, st = self._fetch_chunk(
                    path, ref.index, ref.digest, streams=2, verify=True)
                stats.add(st)
                if payload is None:
                    raise FileNotFoundError(f"{path}#{ref.index}")
                self.local.put(path, ref.index, payload)
            if payload.data is None:
                pieces.append(None)
            else:
                lo = max(offset, ref.offset) - ref.offset
                hi = min(offset + length, ref.offset + ref.length) - ref.offset
                pieces.append(payload.data[lo:hi])
        if cache_for_monitor is not None and file_id is not None:
            self.now += stats.seconds
            cache_for_monitor.close_file(
                file_id, stats.bytes, n_ops, self.now,
                cache_hit=stats.cache_misses == 0)
        if any(p is None for p in pieces):
            return None, stats
        return b"".join(pieces), stats

    # ------------------------------------------------------------------
    # stashcp: whole-file copy with the 3-way fallback chain
    # ------------------------------------------------------------------
    def copy(self, path: str, methods: Optional[Sequence[str]] = None
             ) -> Tuple[Optional[bytes], TransferStats]:
        """Whole-file copy through the fallback chain.  ``methods``
        restricts/reorders the chain (the unified data plane uses
        ``("xrootd", "http")`` so both engines fetch from the site cache
        rather than the worker-local CVMFS cache)."""
        chain: Tuple[str, ...] = (tuple(methods) if methods
                                  else ("cvmfs", "xrootd", "http"))
        unknown = set(chain) - {"cvmfs", "xrootd", "http"}
        if unknown:
            raise ValueError(f"unknown copy methods {sorted(unknown)}")
        self.stats.copies += 1
        errors: List[str] = []
        # stashcp pays a remote GeoIP lookup before anything moves (§5).
        startup = self.geoip.lookup_latency
        for method in chain:
            if method == "cvmfs" and not self.cvmfs_available:
                errors.append("cvmfs: not mounted")
                continue
            if method == "xrootd" and not self.xrootd_available:
                errors.append("xrootd: no client")
                continue
            try:
                data, stats = self._copy_via(path, method)
                stats.seconds += startup
                stats.method = f"stashcp/{method}"
                return data, stats
            except (FileNotFoundError, ConnectionError) as e:
                errors.append(f"{method}: {e}")
        raise FileNotFoundError(f"stashcp failed for {path}: {errors}")

    def _copy_via(self, path: str, method: str
                  ) -> Tuple[Optional[bytes], TransferStats]:
        if method == "cvmfs":
            return self.read(path)
        meta = self._meta(path)
        if meta is None:
            raise FileNotFoundError(path)
        # XRootD: multi-stream; curl/HTTP: single stream, no checksums.
        streams = 8 if method == "xrootd" else 1
        verify = method == "xrootd"
        stats = TransferStats(method=method)
        ranked = self._ranked_caches(path=path) if self.caches else []
        monitor_cache = ranked[0] if ranked else None
        user_id = file_id = None
        if monitor_cache is not None:
            user_id = monitor_cache.open_session(
                self.node.name, "xrootd" if method == "xrootd" else "http",
                self.now)
            file_id = monitor_cache.open_file(user_id, meta, self.now)
        pieces: List[Optional[bytes]] = []
        for ref in meta.chunk_refs():
            payload, st = self._fetch_chunk(path, ref.index, ref.digest,
                                            streams=streams, verify=verify)
            stats.add(st)
            if payload is None:
                raise FileNotFoundError(f"{path}#{ref.index}")
            pieces.append(payload.data)
        if monitor_cache is not None and file_id is not None:
            self.now += stats.seconds
            monitor_cache.close_file(file_id, stats.bytes, stats.chunks,
                                     self.now,
                                     cache_hit=stats.cache_misses == 0)
        if any(p is None for p in pieces):
            return None, stats
        return b"".join(pieces), stats
