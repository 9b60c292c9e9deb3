"""Topology & the GeoIP analogue.

The paper's clients find the nearest cache with GeoIP.  Inside a TPU fleet
there is no IP geolocation, so we replace geographic distance with
coordinate distance over ``(site/pod, rack, host)`` and classed link
bandwidths: intra-host > intra-rack (ICI) > intra-pod (ICI) > cross-pod
(DCN) > WAN-to-origin.  This preserves the semantics the paper relies on —
pick the cheapest cache first and fall outward — while being measurable in
a cluster (DESIGN.md §2, "GeoIP → mesh topology").

Links are shared, capacity-constrained resources: the site uplink is one
link no matter how many workers pull through it, which is exactly what the
Syracuse WAN graph (paper Fig. 5) is about.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Sequence, Tuple

GB = 1e9  # network giga (bytes)

# Continental backbone segments (one-way propagation latency, seconds) for
# multi-region federations: ~120 ms coast-to-coast RTT, ~180 ms
# transatlantic, ~200-360 ms transpacific.  Pairs are stored with sorted
# keys; unlisted pairs fall back to DEFAULT_BACKBONE_RTT.
CONTINENTAL_RTT: Dict[Tuple[str, str], float] = {
    ("us-east", "us-west"): 0.060,
    ("eu", "us-east"): 0.090,
    ("eu", "us-west"): 0.140,
    ("ap", "us-west"): 0.100,
    ("ap", "us-east"): 0.160,
    ("ap", "eu"): 0.180,
}
DEFAULT_BACKBONE_RTT = 0.080     # one-way, unlisted region pairs
DEFAULT_BACKBONE_BW = 100 * GB / 8
DEFAULT_REGIONAL_RTT = 0.006     # one-way, sites sharing a region
DEFAULT_REGIONAL_BW = 200 * GB / 8


@dataclasses.dataclass(frozen=True)
class Coord:
    """Location of a node: (site, rack, host).  ``site`` doubles as the
    pod index inside a fleet and the university/PoP in the OSG mapping."""

    site: str
    rack: int = 0
    host: int = 0

    def distance(self, other: "Coord") -> int:
        """0 same host, 1 same rack, 2 same site/pod, 3 remote."""
        if self.site != other.site:
            return 3
        if self.rack != other.rack:
            return 2
        if self.host != other.host:
            return 1
        return 0


@dataclasses.dataclass
class Link:
    """A shared, capacity-constrained network resource."""

    name: str
    bandwidth: float          # bytes/sec
    latency: float = 1e-4    # seconds, one-way
    active_flows: int = 0    # maintained by the fluid-flow simulator
    base_bandwidth: Optional[float] = dataclasses.field(default=None,
                                                        repr=False)

    def share(self) -> float:
        return self.bandwidth / max(1, self.active_flows)

    def degrade(self, factor: float) -> None:
        """Scale bandwidth to ``factor`` of the undegraded value
        (idempotent: repeated degrades compose against the original)."""
        if self.base_bandwidth is None:
            self.base_bandwidth = self.bandwidth
        self.bandwidth = self.base_bandwidth * factor

    def restore(self) -> None:
        if self.base_bandwidth is not None:
            self.bandwidth = self.base_bandwidth
            self.base_bandwidth = None


@dataclasses.dataclass
class Node:
    """Any endpoint: worker, cache, proxy, origin, redirector."""

    name: str
    coord: Coord
    nic: Link


@dataclasses.dataclass
class BandwidthProfile:
    """Per-site link speeds (bytes/sec).  Calibratable to the paper's site
    behaviour — e.g. Colorado prioritises proxy↔WAN bandwidth while its
    workers see less bandwidth to the nearest StashCache cache (§5)."""

    worker_nic: float = 10 * GB / 8          # 10 Gbps
    cache_nic: float = 10 * GB / 8           # caches guaranteed ≥10 Gbps (§1)
    proxy_nic: float = 10 * GB / 8
    origin_nic: float = 100 * GB / 8
    site_uplink: float = 100 * GB / 8        # site ↔ WAN/DCN
    wan: float = 100 * GB / 8                # research backbone
    wan_rtt: float = 0.030                   # 30 ms WAN
    lan_rtt: float = 0.0005                  # 0.5 ms LAN
    # Large objects are served from disk, not page cache — squid and
    # xrootd disk caches alike (paper §5: proxies are "optimized for
    # small files").  Objects larger than *_mem_max stream at *_disk_bw.
    proxy_mem_max: float = 4e9
    proxy_disk_bw: float = 0.9 * GB
    cache_mem_max: float = 4e9
    cache_disk_bw: float = 0.0               # 0 → not disk-bound


class Topology:
    """Registry of nodes + shared links and a path model.

    The path between two nodes traverses: src NIC → [src site uplink →
    WAN → dst site uplink] → dst NIC (site-internal hops skip the WAN).
    Fidelity is deliberately at the level the paper reasons about: NICs,
    site uplinks and the backbone — not per-switch fabrics.
    """

    def __init__(self) -> None:
        self.nodes: Dict[str, Node] = {}
        self.site_uplinks: Dict[str, Link] = {}
        self.wan = Link("wan", 100 * GB / 8, latency=0.015)
        self._profiles: Dict[str, BandwidthProfile] = {}
        # Region layer (multi-tier CDN topologies): sites may carry a
        # region; cross-site paths then ride the regional network (same
        # region) or a continental backbone segment (different regions)
        # instead of the single flat WAN link.  Region-less sites keep the
        # legacy WAN path, so flat federations are untouched.
        self.site_region: Dict[str, str] = {}
        self.region_nets: Dict[str, Link] = {}
        self.backbones: Dict[Tuple[str, str], Link] = {}

    # -- construction -----------------------------------------------------
    def add_site(self, site: str,
                 profile: Optional[BandwidthProfile] = None,
                 region: str = "") -> None:
        profile = profile or BandwidthProfile()
        self._profiles[site] = profile
        self.site_region[site] = region
        self.site_uplinks[site] = Link(f"{site}/uplink", profile.site_uplink,
                                       latency=profile.lan_rtt)

    def region_net(self, region: str) -> Link:
        """The shared intra-region network (one link class per region)."""
        link = self.region_nets.get(region)
        if link is None:
            link = Link(f"region/{region}", DEFAULT_REGIONAL_BW,
                        latency=DEFAULT_REGIONAL_RTT)
            self.region_nets[region] = link
        return link

    def backbone(self, ra: str, rb: str) -> Link:
        """The continental backbone segment between two regions (lazily
        created from :data:`CONTINENTAL_RTT`, symmetric in its key)."""
        key = (ra, rb) if ra <= rb else (rb, ra)
        link = self.backbones.get(key)
        if link is None:
            link = Link(f"backbone/{key[0]}-{key[1]}", DEFAULT_BACKBONE_BW,
                        latency=CONTINENTAL_RTT.get(key,
                                                    DEFAULT_BACKBONE_RTT))
            self.backbones[key] = link
        return link

    def set_backbone(self, ra: str, rb: str, bandwidth: Optional[float] = None,
                     rtt: Optional[float] = None) -> Link:
        """Override one backbone segment's bandwidth and/or round-trip
        time (``rtt`` is the full RTT; the link stores one-way latency)."""
        link = self.backbone(ra, rb)
        if bandwidth is not None:
            link.bandwidth = bandwidth
            link.base_bandwidth = None
        if rtt is not None:
            link.latency = rtt / 2.0
        return link

    def find_link(self, name: str) -> Optional[Link]:
        """Resolve a shared link by name — uplinks, WAN, regional nets,
        backbone segments, NICs — for fault injection (link degradation)."""
        if name == self.wan.name:
            return self.wan
        for table in (self.site_uplinks, self.region_nets):
            for link in table.values():
                if link.name == name:
                    return link
        for link in self.backbones.values():
            if link.name == name:
                return link
        node = self.nodes.get(name.split("/nic")[0])
        if node is not None and node.nic.name == name:
            return node.nic
        return None

    def profile(self, site: str) -> BandwidthProfile:
        return self._profiles[site]

    def add_node(self, name: str, coord: Coord, nic_bw: float,
                 latency: float = 1e-4) -> Node:
        if coord.site not in self.site_uplinks:
            self.add_site(coord.site)
        node = Node(name, coord, Link(f"{name}/nic", nic_bw, latency))
        self.nodes[name] = node
        return node

    # -- path & distance --------------------------------------------------
    def path(self, src: str, dst: str) -> List[Link]:
        a, b = self.nodes[src], self.nodes[dst]
        if a is b:
            return []  # loopback: crosses no shared network capacity
        links = [a.nic]
        if a.coord.site != b.coord.site:
            ra = self.site_region.get(a.coord.site, "")
            rb = self.site_region.get(b.coord.site, "")
            if ra and rb:
                middle = (self.region_net(ra) if ra == rb
                          else self.backbone(ra, rb))
            else:
                middle = self.wan
            links += [self.site_uplinks[a.coord.site], middle,
                      self.site_uplinks[b.coord.site]]
        links.append(b.nic)
        return links

    def rtt(self, src: str, dst: str) -> float:
        return 2.0 * sum(l.latency for l in self.path(src, dst))

    def bottleneck_bandwidth(self, src: str, dst: str) -> float:
        p = self.path(src, dst)
        return min(l.bandwidth for l in p) if p else float("inf")

    def distance(self, src: str, dst: str) -> Tuple[int, float]:
        """(coordinate distance, rtt) — the GeoIP sort key."""
        return (self.nodes[src].coord.distance(self.nodes[dst].coord),
                self.rtt(src, dst))


class GeoIPService:
    """Nearest-cache discovery (paper §3.1).

    CVMFS ships a built-in GeoIP locator; ``stashcp`` must *query a remote
    server* to learn its nearest cache, which is the startup cost the paper
    measures against HTTP proxies (whose nearest proxy is handed to them in
    the environment).  ``lookup_latency`` models that remote round-trip and
    is added to stashcp-style transfers by the client.
    """

    def __init__(self, topology: Topology, lookup_latency: float = 0.200):
        self.topology = topology
        self.lookup_latency = lookup_latency
        self.lookups = 0

    def nearest(self, client: str, caches: Sequence[str],
                exclude: Sequence[str] = ()) -> List[str]:
        self.lookups += 1
        # (distance, name): the name tie-break keeps rankings stable when
        # several caches sit at the same coordinate distance + RTT
        # (dict-iteration order is an accident of construction, not policy).
        ranked = sorted((c for c in caches if c not in exclude),
                        key=lambda c: (self.topology.distance(client, c), c))
        return ranked
