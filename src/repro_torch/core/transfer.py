"""Network/transfer model shared by the functional path and the simulator.

The functional federation (the one that actually feeds the JAX training
loop) moves real bytes instantly but *accounts* transfer time with an
uncontended model: per-path latency plus bytes over the effective
bandwidth.  Effective bandwidth honours two facts the paper leans on:

* the bottleneck link (NIC, site uplink or WAN backbone) caps throughput;
* a single TCP stream on a long-RTT path is window-limited, which is why
  XRootD's multi-stream transfers beat single-stream HTTP for large files
  over the WAN (§3.1), while on a LAN the proxy's single stream is fine.

Contention (many flows sharing a link) is modelled only by the
discrete-event simulator (``repro_torch.core.simulator``), which reuses this
module's per-stream cap.
"""
from __future__ import annotations

import dataclasses
from typing import List

from .topology import Link, Topology

# Default TCP window for the per-stream throughput cap.
DEFAULT_TCP_WINDOW = 16 * 2**20  # 16 MiB


@dataclasses.dataclass
class TransferStats:
    """Accounting for one logical transfer (possibly many chunks).

    ``local_hits`` counts chunks served from the *worker-local* CVMFS
    cache — those never reach the site cache tier, so they are kept out
    of ``cache_hits`` (which the engine-parity tests hold equal across
    planes) but still matter to consumers like the data loader whose
    hit-rate includes the best hit of all.
    """

    bytes: int = 0
    seconds: float = 0.0
    chunks: int = 0
    cache_hits: int = 0
    cache_misses: int = 0
    local_hits: int = 0
    method: str = ""
    source: str = ""

    def add(self, other: "TransferStats") -> "TransferStats":
        self.bytes += other.bytes
        self.seconds += other.seconds
        self.chunks += other.chunks
        self.cache_hits += other.cache_hits
        self.cache_misses += other.cache_misses
        self.local_hits += other.local_hits
        if other.source:
            self.source = other.source
        return self

    @property
    def mbps(self) -> float:
        if self.seconds <= 0:
            return float("inf")
        return self.bytes / self.seconds / 1e6


class NetworkModel:
    """Uncontended latency + bandwidth accounting over topology paths."""

    def __init__(self, topology: Topology,
                 tcp_window: int = DEFAULT_TCP_WINDOW) -> None:
        self.topology = topology
        self.tcp_window = tcp_window

    def per_stream_cap(self, rtt: float) -> float:
        """TCP window / RTT: the single-stream ceiling on long paths."""
        return self.tcp_window / max(rtt, 1e-6)

    def effective_bandwidth(self, src: str, dst: str, streams: int = 1) -> float:
        rtt = self.topology.rtt(src, dst)
        bottleneck = self.topology.bottleneck_bandwidth(src, dst)
        return min(bottleneck, max(1, streams) * self.per_stream_cap(rtt))

    def transfer_time(self, src: str, dst: str, nbytes: int,
                      streams: int = 1, handshakes: int = 1,
                      rate_cap: float = 0.0) -> float:
        """Seconds to move ``nbytes`` from src to dst, uncontended.
        ``rate_cap`` (bytes/s, 0=∞) models endpoint limits (disk)."""
        rtt = self.topology.rtt(src, dst)
        bw = self.effective_bandwidth(src, dst, streams)
        if rate_cap:
            bw = min(bw, rate_cap)
        return handshakes * rtt + nbytes / bw

    def rpc_time(self, src: str, dst: str) -> float:
        """A small request/response (redirector locate, GeoIP lookup...)."""
        return self.topology.rtt(src, dst)
