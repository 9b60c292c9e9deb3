"""Federation assembly: origins + redirector pair + caches + proxies +
clients wired over a topology (paper Fig. 1 / Fig. 2).

Two deployment idioms are provided:

* :func:`build_osg_federation` — the paper's geography: caches at
  universities and Internet2 PoPs, one origin (Stash at UChicago), two HA
  redirectors, an HTTP proxy per site.
* :func:`build_fleet_federation` — the TPU mapping: one cache per pod (and
  optionally per rack), the origin is the dataset/checkpoint store, workers
  are TPU hosts.  This is the instance the data loader and checkpointing
  layers use.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

from .cache import CacheServer
from .client import StashClient
from .indexer import Catalog, Indexer
from .monitoring import MessageBus, MonitorCollector, UsageAggregator
from .origin import Origin
from .policies import SizeAwareAdmission
from .proxy import HTTPProxy
from .redirector import Redirector, RedirectorGroup, RedirectorPair
from .ring import CacheGroup
from .routing import RankingPolicy, StaticRankingPolicy, ranked_caches
from .topology import BandwidthProfile, Coord, GeoIPService, Topology
from .transfer import NetworkModel
from .writeback import WritebackCache

GB = 1e9
TB = 1e12


@dataclasses.dataclass(frozen=True)
class SiteSpec:
    """One site (university / I2 PoP / pod).

    ``cache_replicas`` > 1 turns the site cache into an HA
    :class:`~repro_torch.core.ring.CacheGroup`: the replicas partition the
    site's working set by consistent hashing and fail over to each other.
    ``eviction_policy`` / ``ttl_seconds`` / ``admission_max_fraction``
    select the per-cache policies (:mod:`repro_torch.core.policies`);
    ``admission_max_fraction`` < 1 refuses objects larger than that
    fraction of cache capacity.

    ``parent`` names another cache-bearing site whose group is this
    site's *parent tier*: the site's cache misses fill from the parent
    group's ring before the origin (multi-tier CDN, arXiv:2007.01408).
    ``region`` places the site on the continental backbone topology
    (``core/topology.py``): same-region cross-site traffic rides the
    regional network, cross-region traffic a backbone segment.
    """

    name: str
    workers: int = 4
    has_cache: bool = True
    has_proxy: bool = True
    cache_capacity: float = 8 * TB   # "several TBs of caching storage" (§1)
    profile: Optional[BandwidthProfile] = None
    cache_replicas: int = 1
    eviction_policy: str = "lru"
    ttl_seconds: float = 3600.0
    admission_max_fraction: float = 1.0
    parent: Optional[str] = None
    region: str = ""

    def cache_names(self) -> List[str]:
        """Cache-server names this site contributes to a built
        federation, in replica order — the one naming authority shared
        by ``_build`` and anything that must address caches before a
        federation exists (sweep outage axes)."""
        if not self.has_cache:
            return []
        return [f"{self.name}/cache" if i == 0 else f"{self.name}/cache{i}"
                for i in range(max(1, self.cache_replicas))]


@dataclasses.dataclass(frozen=True)
class TierSpec:
    """One level of a cache hierarchy: the sites at that level and the
    parent site they all fill from.

    A preset-building convenience — ``flatten()`` stamps ``parent`` onto
    copies of the sites, and a built federation only ever sees
    ``SiteSpec.parent`` — so hierarchies can be declared level-by-level:

        TierSpec(sites=[edge_a, edge_b], parent="us-east-backbone")
    """

    sites: List[SiteSpec] = dataclasses.field(default_factory=list)
    parent: Optional[str] = None

    def flatten(self) -> List[SiteSpec]:
        return [dataclasses.replace(s, parent=self.parent)
                for s in self.sites]


def site_tiers(sites: Sequence[SiteSpec]) -> Dict[str, int]:
    """Tier of each cache-bearing site: 1 = edge (client-facing), and a
    parent site sits one tier above its deepest child.  Validates the
    parent graph — parents must exist, hold a cache, and form no cycle.
    """
    by_name = {s.name: s for s in sites}
    tiers: Dict[str, int] = {}
    for s in sites:
        if not s.has_cache:
            if s.parent is not None:
                raise ValueError(
                    f"site {s.name!r} names a parent but has no cache")
            continue
        chain = [s.name]
        cur = s
        while cur.parent is not None:
            p = by_name.get(cur.parent)
            if p is None:
                raise ValueError(f"site {cur.name!r} names unknown parent "
                                 f"{cur.parent!r}")
            if not p.has_cache:
                raise ValueError(f"parent site {p.name!r} of {cur.name!r} "
                                 f"has no cache")
            if p.name in chain:
                raise ValueError("parent cycle: "
                                 + " -> ".join(chain + [p.name]))
            chain.append(p.name)
            cur = p
        for depth, name in enumerate(chain, start=1):
            tiers[name] = max(tiers.get(name, 1), depth)
    return tiers


@dataclasses.dataclass
class Federation:
    topology: Topology
    net: NetworkModel
    geoip: GeoIPService
    origins: List[Origin]
    redirectors: RedirectorGroup
    caches: Dict[str, CacheServer]
    groups: Dict[str, CacheGroup]
    proxies: Dict[str, HTTPProxy]
    monitor: MonitorCollector
    bus: MessageBus
    aggregator: UsageAggregator
    sites: List[SiteSpec]
    # where real bytes are digested and verified (None means cuda,
    # resolved when real bytes are first digested)
    device: Optional[str] = None

    # -- factories ----------------------------------------------------------
    def client(self, site: str, worker: int = 0,
               catalog: Optional[Catalog] = None,
               cvmfs: bool = True, xrootd: bool = True,
               ranking: Union[str, RankingPolicy, None] = None
               ) -> StashClient:
        name = f"{site}/worker{worker}"
        if name not in self.topology.nodes:
            prof = self.topology.profile(site)
            self.topology.add_node(name, Coord(site, rack=0, host=worker),
                                   prof.worker_nic)
        return StashClient(self.topology.nodes[name],
                           list(self.caches.values()), self.geoip, self.net,
                           catalog=catalog, cvmfs_available=cvmfs,
                           xrootd_available=xrootd,
                           groups=list(self.groups.values()),
                           ranking=ranking, device=self.device)

    def indexer(self, origin: Optional[Origin] = None) -> Indexer:
        return Indexer(origin or self.origins[0])

    def writeback(self, cache_name: str,
                  drain_rate: float = 2e9) -> WritebackCache:
        return WritebackCache(self.caches[cache_name], self.net,
                              self.redirectors,
                              drain_rate_bytes_per_sec=drain_rate,
                              device=self.device)

    def nearest_cache(self, client_node: str, path: str = "/") -> CacheServer:
        """The cache a client at ``client_node`` would actually be served
        by for ``path`` — the same ranked ordering clients use (group ring
        order within the nearest group), skipping dead members.  Falls
        back to the overall ranking head when everything is down.  A pure
        query: does not touch group route/failover counters."""
        ranked = ranked_caches(client_node, self.caches,
                               list(self.groups.values()), self.geoip,
                               StaticRankingPolicy(), path=path,
                               count_stats=False)
        for cache in ranked:
            if cache.available:
                return cache
        return ranked[0]

    # -- namespace-first origin routing -------------------------------------
    def resolve_origin(self, path: str) -> Optional[Origin]:
        """The origin whose exported prefix owns ``path``
        (longest-prefix match through the redirectors' namespace).

        This is how the unified data plane *publishes*: callers name data
        by path and the federation picks the origin — nobody holds origin
        references.  Returns None when no export claims the path.
        """
        for r in self.redirectors.members:
            owner = r.namespace.resolve(path)
            if owner is not None and owner in r.origins:
                return r.origins[owner]
        return None

    def add_origin(self, site: str, exports: Sequence[str],
                   name: Optional[str] = None) -> Origin:
        """Attach another origin exporting ``exports`` at ``site`` and
        subscribe it to the redirectors (multi-origin federations)."""
        prof = self.topology.profile(site)
        idx = len(self.origins)
        if name is None:
            # Never reuse a node name: after remove_origin, a plain
            # len(origins) counter would mint an existing origin's name
            # and hijack its node + namespace registration.
            while f"{site}/origin{idx}" in self.topology.nodes:
                idx += 1
            name = f"{site}/origin{idx}"
        if name in self.topology.nodes:
            raise ValueError(f"origin node {name!r} already exists")
        node = self.topology.add_node(name, Coord(site, rack=255, host=idx),
                                      prof.origin_nic)
        origin = Origin(node.name, node, exports=exports,
                        device=self.device)
        self.redirectors.subscribe(origin)
        self.origins.append(origin)
        return origin

    def remove_origin(self, origin: Union[Origin, str]) -> None:
        """Retire an origin: unsubscribe it (which unregisters its
        namespace prefixes — no dangling longest-prefix matches) and drop
        it from the federation's origin list."""
        name = origin.name if isinstance(origin, Origin) else origin
        self.redirectors.unsubscribe(name)
        self.origins = [o for o in self.origins if o.name != name]


def _build(sites: Sequence[SiteSpec], origin_site: str,
           origin_exports: Sequence[str] = ("/",),
           redirector_site: Optional[str] = None,
           proxy_max_cacheable: int = 1 * 2**30,
           proxy_ttl: float = 3600.0,
           monitor_drop_rate: float = 0.0,
           geoip_lookup_latency: float = 0.200,
           device=None) -> Federation:
    topo = Topology()
    for s in sites:
        topo.add_site(s.name, s.profile, region=s.region)
    net = NetworkModel(topo)
    geoip = GeoIPService(topo, lookup_latency=geoip_lookup_latency)
    bus = MessageBus()
    aggregator = UsageAggregator()
    bus.subscribe(aggregator)
    monitor = MonitorCollector(bus, drop_rate=monitor_drop_rate)

    oprof = topo.profile(origin_site)
    origin_node = topo.add_node(f"{origin_site}/origin",
                                Coord(origin_site, rack=255, host=0),
                                oprof.origin_nic)
    origin = Origin(f"{origin_site}/origin", origin_node,
                    exports=origin_exports, device=device)

    rsite = redirector_site or origin_site
    rprof = topo.profile(rsite)
    r1 = Redirector("redirector1", topo.add_node(
        f"{rsite}/redirector1", Coord(rsite, rack=254, host=0), rprof.cache_nic))
    r2 = Redirector("redirector2", topo.add_node(
        f"{rsite}/redirector2", Coord(rsite, rack=254, host=1), rprof.cache_nic))
    redirectors = RedirectorPair(r1, r2)
    redirectors.subscribe(origin)

    caches: Dict[str, CacheServer] = {}
    groups: Dict[str, CacheGroup] = {}
    proxies: Dict[str, HTTPProxy] = {}
    for s in sites:
        prof = topo.profile(s.name)
        if s.has_cache:
            admission = (SizeAwareAdmission(s.admission_max_fraction)
                         if s.admission_max_fraction < 1.0 else None)
            members = []
            for i, cache_name in enumerate(s.cache_names()):
                node = topo.add_node(cache_name,
                                     Coord(s.name, rack=253, host=i),
                                     prof.cache_nic)
                cache = CacheServer(
                    node.name, node, int(s.cache_capacity), redirectors, net,
                    monitor, mem_object_max=prof.cache_mem_max,
                    disk_bw=prof.cache_disk_bw, policy=s.eviction_policy,
                    ttl_seconds=s.ttl_seconds, admission=admission)
                caches[node.name] = cache
                members.append(cache)
            groups[s.name] = CacheGroup(s.name, members)
        if s.has_proxy:
            node = topo.add_node(f"{s.name}/proxy",
                                 Coord(s.name, rack=252, host=0),
                                 prof.proxy_nic)
            proxies[s.name] = HTTPProxy(
                node.name, node, origin, net,
                max_cacheable_bytes=proxy_max_cacheable,
                ttl_seconds=proxy_ttl, mem_object_max=prof.proxy_mem_max,
                disk_bw=prof.proxy_disk_bw)
    # Wire cache tiers: a site's caches fill misses from its parent
    # site's group before the origin.  site_tiers() validated the parent
    # graph (existence, cache-bearing, acyclic), so the wiring is a
    # straight second pass once every group exists.
    tiers = site_tiers(sites)
    for s in sites:
        if not s.has_cache:
            continue
        for cache in groups[s.name].members:
            cache.tier = tiers[s.name]
            if s.parent is not None:
                cache.parent_group = groups[s.parent]
    return Federation(topo, net, geoip, [origin], redirectors, caches,
                      groups, proxies, monitor, bus, aggregator, list(sites),
                      device)


@dataclasses.dataclass(frozen=True)
class FederationSpec:
    """Declarative federation description — the deployment half of a
    :class:`~repro_torch.core.api.ScenarioSpec`.

    A spec is data (sites + origin placement + knobs), ``build()`` turns
    it into a live :class:`Federation`.  The two deployment idioms the
    repo ships are constructors: :meth:`osg` (paper Fig. 2) and
    :meth:`fleet` (the TPU mapping).  Because the spec is inert, one
    ``ScenarioSpec`` can be executed on the analytic *and* the simulated
    engine, each against its own freshly-built federation.
    """

    sites: List[SiteSpec] = dataclasses.field(default_factory=list)
    origin_site: str = ""
    origin_exports: Tuple[str, ...] = ("/",)
    redirector_site: Optional[str] = None
    proxy_max_cacheable: int = 1 * 2**30
    proxy_ttl: float = 3600.0
    monitor_drop_rate: float = 0.0
    geoip_lookup_latency: float = 0.200

    def cache_names(self) -> List[str]:
        """Every cache-server name ``build()`` will create, in build
        order (site order, then replica index)."""
        return [n for s in self.sites for n in s.cache_names()]

    def site_tiers(self) -> Dict[str, int]:
        """Tier of each cache-bearing site (1 = edge), from the sites'
        ``parent`` links — same computation ``build()`` uses to stamp
        ``CacheServer.tier``, usable before a federation exists (sweep
        axes address tiers declaratively)."""
        return site_tiers(self.sites)

    def tier_depth(self) -> int:
        """Deepest tier in the hierarchy (1 for a flat federation)."""
        tiers = self.site_tiers()
        return max(tiers.values()) if tiers else 1

    def build(self, device=None) -> Federation:
        """The live federation; ``device`` digests and verifies its real
        bytes (``None`` means ``cuda``, resolved when real bytes are first
        digested, so a federation of synthetic payloads never needs a
        card)."""
        if not self.sites:
            raise ValueError("FederationSpec needs at least one site")
        return _build(self.sites, self.origin_site or self.sites[0].name,
                      origin_exports=self.origin_exports,
                      redirector_site=self.redirector_site,
                      proxy_max_cacheable=self.proxy_max_cacheable,
                      proxy_ttl=self.proxy_ttl,
                      monitor_drop_rate=self.monitor_drop_rate,
                      geoip_lookup_latency=self.geoip_lookup_latency,
                      device=device)

    @classmethod
    def osg(cls, workers_per_site: int = 4, monitor_drop_rate: float = 0.0,
            eviction_policy: str = "lru",
            cache_replicas: int = 1) -> "FederationSpec":
        """The paper's five-site OSG deployment (Fig. 2, §4.1)."""
        sites = [SiteSpec(name=n, workers=workers_per_site, profile=p,
                          eviction_policy=eviction_policy,
                          cache_replicas=cache_replicas)
                 for n, p in OSG_SITE_PROFILES.items()]
        return cls(sites=sites, origin_site="chicago",
                   monitor_drop_rate=monitor_drop_rate)

    @classmethod
    def fleet(cls, num_pods: int = 2, hosts_per_pod: int = 64,
              cache_capacity: float = 32 * TB,
              monitor_drop_rate: float = 0.0,
              eviction_policy: str = "lru", cache_replicas: int = 1,
              ttl_seconds: float = 3600.0,
              admission_max_fraction: float = 1.0) -> "FederationSpec":
        """TPU-fleet mapping: one cache group per pod, origin = dataset
        store.  Intra-pod links are ICI-class, cross-pod is DCN-class,
        the origin sits behind a storage-fabric link; GeoIP lookup
        latency is LAN-scale."""
        prof = BandwidthProfile(worker_nic=25e9, cache_nic=100e9,
                                proxy_nic=25e9, origin_nic=40e9,
                                site_uplink=50e9, wan_rtt=0.002,
                                lan_rtt=0.0002)
        sites = [SiteSpec(name=f"pod{p}", workers=hosts_per_pod,
                          cache_capacity=cache_capacity, profile=prof,
                          eviction_policy=eviction_policy,
                          cache_replicas=cache_replicas,
                          ttl_seconds=ttl_seconds,
                          admission_max_fraction=admission_max_fraction)
                 for p in range(num_pods)]
        sites.append(SiteSpec(name="storage", workers=0, has_cache=False,
                              has_proxy=False, profile=prof))
        return cls(sites=sites, origin_site="storage",
                   monitor_drop_rate=monitor_drop_rate,
                   geoip_lookup_latency=0.002)

    @classmethod
    def osdf(cls, regions: Sequence[str] = ("us-east", "us-west"),
             edges_per_region: int = 2, workers_per_edge: int = 4,
             l1_capacity: float = 2 * TB, l2_capacity: float = 16 * TB,
             eviction_policy: str = "lru", cache_replicas: int = 1,
             backbone_replicas: int = 1,
             origin_region: Optional[str] = None,
             monitor_drop_rate: float = 0.0) -> "FederationSpec":
        """OSDF-style tiered CDN (arXiv:2007.01408): per region,
        ``edges_per_region`` L1 edge sites fill from one regional L2
        backbone site; backbone misses pull from the origin over the
        continental backbone.  Edge sites hold workers; backbone sites
        are pure caches (workers=0) with the larger capacity.  The
        origin facility sits in ``origin_region`` (first region by
        default), so same-region backbones reach it over the regional
        network and remote ones over a backbone segment."""
        sites: List[SiteSpec] = []
        for r in regions:
            backbone = SiteSpec(name=f"{r}-backbone", workers=0,
                                has_proxy=False, region=r,
                                cache_capacity=l2_capacity,
                                cache_replicas=backbone_replicas,
                                eviction_policy=eviction_policy)
            tier = TierSpec(parent=backbone.name, sites=[
                SiteSpec(name=f"{r}-edge{i}", workers=workers_per_edge,
                         has_proxy=False, region=r,
                         cache_capacity=l1_capacity,
                         cache_replicas=cache_replicas,
                         eviction_policy=eviction_policy)
                for i in range(edges_per_region)])
            sites.extend(tier.flatten())
            sites.append(backbone)
        sites.append(SiteSpec(name="origin-facility", workers=0,
                              has_cache=False, has_proxy=False,
                              region=origin_region or regions[0]))
        return cls(sites=sites, origin_site="origin-facility",
                   monitor_drop_rate=monitor_drop_rate)


# Paper Fig. 2 deployment: the five test sites of §4.1 with bandwidth
# profiles calibrated to reproduce Table 3's signs (see bench docs).
# Profiles calibrated so the simulator reproduces Table 3's signs; the
# mechanisms are the paper's own observations: per-site proxy/cache NIC
# asymmetries (Fig. 6: Colorado prioritises proxy↔WAN bandwidth; its
# workers see far less bandwidth to the nearest — remote — StashCache
# cache) and disk-bound large-object serving ("proxies are optimized for
# small files").  cache_nic abstracts the worker→nearest-cache path, which
# for cache-less sites (Colorado, Bellarmine) is a remote Internet2 PoP.
OSG_SITE_PROFILES: Dict[str, BandwidthProfile] = {
    "colorado": BandwidthProfile(worker_nic=1.25e9, cache_nic=0.16e9,
                                 proxy_nic=5.0e9, site_uplink=12.5e9,
                                 proxy_disk_bw=2.5e9),
    "syracuse": BandwidthProfile(worker_nic=1.25e9, cache_nic=0.55e9,
                                 proxy_nic=1.25e9, site_uplink=12.5e9,
                                 proxy_disk_bw=0.6e9),
    "bellarmine": BandwidthProfile(worker_nic=1.25e9, cache_nic=1.25e9,
                                   proxy_nic=0.3e9, site_uplink=1.25e9,
                                   cache_disk_bw=0.17e9),
    "nebraska": BandwidthProfile(worker_nic=1.25e9, cache_nic=0.6e9,
                                 proxy_nic=1.0e9, site_uplink=12.5e9,
                                 proxy_disk_bw=0.9e9, cache_disk_bw=0.5e9),
    "chicago": BandwidthProfile(worker_nic=1.25e9, cache_nic=0.8e9,
                                proxy_nic=1.4e9, site_uplink=12.5e9,
                                proxy_disk_bw=0.8e9),
}


def build_osg_federation(workers_per_site: int = 4,
                         monitor_drop_rate: float = 0.0,
                         eviction_policy: str = "lru",
                         cache_replicas: int = 1,
                         device=None) -> Federation:
    return FederationSpec.osg(
        workers_per_site=workers_per_site,
        monitor_drop_rate=monitor_drop_rate,
        eviction_policy=eviction_policy,
        cache_replicas=cache_replicas).build(device)


def build_fleet_federation(num_pods: int = 2, hosts_per_pod: int = 64,
                           cache_capacity: float = 32 * TB,
                           monitor_drop_rate: float = 0.0,
                           eviction_policy: str = "lru",
                           cache_replicas: int = 1,
                           ttl_seconds: float = 3600.0,
                           admission_max_fraction: float = 1.0,
                           device=None) -> Federation:
    """TPU-fleet mapping: one cache group per pod, origin = dataset store.

    Intra-pod links are ICI-class, cross-pod is DCN-class, the origin sits
    behind a storage-fabric link.  GeoIP lookup latency is LAN-scale.
    ``cache_replicas`` > 1 gives each pod an HA consistent-hash cache
    group; ``eviction_policy`` selects the per-cache policy fleet-wide.
    ``device`` digests real bytes (``None`` means ``cuda``).
    """
    return FederationSpec.fleet(
        num_pods=num_pods, hosts_per_pod=hosts_per_pod,
        cache_capacity=cache_capacity,
        monitor_drop_rate=monitor_drop_rate,
        eviction_policy=eviction_policy, cache_replicas=cache_replicas,
        ttl_seconds=ttl_seconds,
        admission_max_fraction=admission_max_fraction).build(device)


def build_osdf_federation(regions: Sequence[str] = ("us-east", "us-west"),
                          edges_per_region: int = 2,
                          workers_per_edge: int = 4,
                          l1_capacity: float = 2 * TB,
                          l2_capacity: float = 16 * TB,
                          eviction_policy: str = "lru",
                          device=None) -> Federation:
    """Tiered OSDF-style CDN: regional L1 edges over L2 backbones."""
    return FederationSpec.osdf(
        regions=regions, edges_per_region=edges_per_region,
        workers_per_edge=workers_per_edge, l1_capacity=l1_capacity,
        l2_capacity=l2_capacity,
        eviction_policy=eviction_policy).build(device)
