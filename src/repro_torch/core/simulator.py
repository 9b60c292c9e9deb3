"""Discrete-event, fluid-flow network simulator.

The paper's evaluation runs on a *contended* production network ("we have
no visibility into the resource contention of the network, caches, proxies,
or origin server").  To reproduce Table 3 / Figs 5–8 — and to project the
federation to a 1000+-node fleet — we simulate transfers as fluid flows
over shared links with **max-min fair sharing** plus a per-flow cap of
``streams × (tcp_window / rtt)`` (the same per-stream model as
:class:`~repro_torch.core.transfer.NetworkModel`, so the functional
path and the simulator agree in the uncontended limit).

Scenario logic is written as generator coroutines: ``yield sim.delay(s)``
(RPCs, GeoIP lookups) and ``yield sim.flow(src, dst, nbytes, streams)``
(bulk transfers).  Cache/proxy *state machines* are the very same objects
used by the functional federation — only timing differs.

The max-min allocation is re-solved whenever the *active flow set*
changes — but only once per distinct event time: all arrivals,
completions and callbacks at one timestamp are drained first, then a
single waterfilling pass covers the whole batch (a 1000-flow restart
storm at t=0 is one solve, not ~1000).  Between solves the next flow
completion comes from a finish-time heap rebuilt on each reallocation,
so pure-delay events cost O(log n) instead of an O(active) winner scan.
Two solvers are provided: the original ``scalar`` waterfilling loop, and
a ``vector`` solver that batches the per-link waterfilling across all
flows as PyTorch tensor ops (``repro_torch.kernels.maxmin``) on the
simulator's device.  ``auto`` (default) switches to the vector solver
once enough flows are concurrently active for the batching to pay for
its dispatch — which is what lets one ``FluidFlowSim`` drive 1000+-site
fleet scenarios.  The device is resolved when the simulator is built:
``None`` means ``cuda``, which raises without a card, whichever solver
is chosen; the CPU runs only when the caller names it.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
from typing import Callable, Dict, Generator, List, Optional, Tuple, Union

import torch

from ..device import resolve_device
from .cache import CacheServer
from .chunk import ObjectMeta, Payload
from .proxy import HTTPProxy
from .topology import Link, Topology
from .transfer import NetworkModel


def sparse_flow_problem(flow_specs) -> Tuple[List[float], List[List[int]],
                                             List[float]]:
    """Index a set of flows into the sparse max-min problem layout.

    ``flow_specs`` is an iterable of ``(links, cap)`` pairs — each a
    flow's traversed :class:`~repro_torch.core.topology.Link` objects and its
    TCP ceiling.  Links are deduplicated by identity into a compact
    index space; the result ``(link_caps, flow_links, flow_caps)`` feeds
    ``repro_torch.kernels.maxmin.maxmin_rates_sparse`` directly (one
    problem) or a batched solver (one problem per sweep cell).  Shared
    by the simulator's vector solver and the sweep engine's contention
    pricing so the two can never disagree on what a flow set means.
    """
    link_index: Dict[int, int] = {}
    link_caps: List[float] = []
    flow_links: List[List[int]] = []
    flow_caps: List[float] = []
    for links, cap in flow_specs:
        row = []
        for link in links:
            lid = id(link)
            idx = link_index.get(lid)
            if idx is None:
                idx = link_index[lid] = len(link_caps)
                link_caps.append(link.bandwidth)
            row.append(idx)
        flow_links.append(row)
        flow_caps.append(cap)
    return link_caps, flow_links, flow_caps


class _Waitable:
    pass


@dataclasses.dataclass
class _Delay(_Waitable):
    seconds: float


class Event(_Waitable):
    """One-shot condition (collapsed-forwarding waits, barriers...)."""

    def __init__(self, sim: "FluidFlowSim") -> None:
        self._sim = sim
        self.is_set = False
        self._waiters: List["_Proc"] = []

    def set(self) -> None:
        self.is_set = True
        for proc in self._waiters:
            self._sim._schedule(self._sim.t,
                                lambda p=proc: self._sim._step(p, None))
        self._waiters.clear()


class Flow(_Waitable):
    _ids = itertools.count()

    def __init__(self, src: str, dst: str, nbytes: float, streams: int,
                 links: List[Link], cap: float) -> None:
        self.id = next(Flow._ids)
        self.src, self.dst = src, dst
        self.remaining = float(max(nbytes, 1.0))
        self.nbytes = nbytes
        self.streams = streams
        self.links = links
        self.cap = cap            # streams × per-stream TCP ceiling
        self.rate = 0.0
        self.started_at: float = 0.0
        self.finished_at: Optional[float] = None
        self.waiter: Optional["_Proc"] = None


class _Proc:
    def __init__(self, gen: Generator, on_exit: Optional[Callable] = None):
        self.gen = gen
        self.on_exit = on_exit


class FluidFlowSim:
    """Event loop + max-min fair bandwidth allocation."""

    def __init__(self, topology: Topology,
                 net: Optional[NetworkModel] = None,
                 solver: str = "auto",
                 vector_threshold: int = 256,
                 device: Union[str, torch.device, None] = None) -> None:
        if solver not in ("auto", "scalar", "vector"):
            raise ValueError(f"unknown solver {solver!r}")
        self.device = resolve_device(device)
        self.topology = topology
        self.net = net or NetworkModel(topology)
        self.solver = solver
        self.vector_threshold = vector_threshold
        self.t = 0.0
        self._eventq: List[Tuple[float, int, Callable]] = []
        self._eid = itertools.count()
        self.active: List[Flow] = []
        self.completed_flows = 0
        self.reallocations = 0
        # Arrivals + completions: what a per-arrival solver would have
        # paid.  ``flow_events / reallocations`` is the coalescing win.
        self.flow_events = 0
        self._flows_dirty = True  # active set changed since last solve
        self._fin_heap: List[Tuple[float, int, Flow]] = []
        self.link_bytes: Dict[str, float] = {}
        # (cache name) -> {(path, chunk) -> Event}: collapsed-forwarding
        # registry, per cache server, owned by the sim so concurrent
        # scenarios on shared cache objects never cross-talk.
        self._inflight: Dict[str, Dict[Tuple[str, int], Event]] = {}

    # -- coroutine API -------------------------------------------------------
    def delay(self, seconds: float) -> _Delay:
        return _Delay(max(0.0, seconds))

    def event(self) -> Event:
        return Event(self)

    def inflight(self, server: str) -> Dict[Tuple[str, int], Event]:
        """Per-cache collapsed-forwarding table: (path, chunk) -> Event
        for pulls currently in flight at ``server``.  Shared by every
        download coroutine in this sim, whichever client issued it."""
        return self._inflight.setdefault(server, {})

    def flow(self, src: str, dst: str, nbytes: float,
             streams: int = 1, rate_cap: float = 0.0) -> Flow:
        links = self.topology.path(src, dst)
        rtt = self.topology.rtt(src, dst)
        cap = max(1, streams) * self.net.per_stream_cap(rtt)
        if rate_cap:
            cap = min(cap, rate_cap)
        return Flow(src, dst, nbytes, streams, links, cap)

    def spawn(self, gen: Generator, at: Optional[float] = None,
              on_exit: Optional[Callable] = None) -> None:
        proc = _Proc(gen, on_exit)
        self._schedule(self.t if at is None else at,
                       lambda: self._step(proc, None))

    def _schedule(self, t: float, fn: Callable) -> None:
        heapq.heappush(self._eventq, (t, next(self._eid), fn))

    def _step(self, proc: _Proc, value) -> None:
        try:
            waitable = proc.gen.send(value)
        except StopIteration:
            if proc.on_exit:
                proc.on_exit(self.t)
            return
        if isinstance(waitable, _Delay):
            self._schedule(self.t + waitable.seconds,
                           lambda: self._step(proc, None))
        elif isinstance(waitable, Flow):
            waitable.waiter = proc
            waitable.started_at = self.t
            self.active.append(waitable)
            self.flow_events += 1
            self._flows_dirty = True
        elif isinstance(waitable, Event):
            if waitable.is_set:
                self._schedule(self.t, lambda: self._step(proc, None))
            else:
                waitable._waiters.append(proc)
        else:  # pragma: no cover - defensive
            raise TypeError(f"cannot wait on {waitable!r}")

    # -- max-min fair allocation ----------------------------------------------
    def _reallocate(self) -> None:
        """One waterfilling pass over the current active set.  Called once
        per distinct event time at which the set changed, however many
        arrivals/completions that time coalesced."""
        self.reallocations += 1
        if self.solver == "vector" or (
                self.solver == "auto"
                and len(self.active) >= self.vector_threshold):
            self._reallocate_vector()
        else:
            self._reallocate_scalar()

    def _reallocate_vector(self) -> None:
        """Batched waterfilling over sparse flow→link rows, solved by
        ``repro_torch.kernels.maxmin`` as tensor ops on ``self.device``."""
        from ..kernels.maxmin import maxmin_rates_sparse

        flows = self.active
        if not flows:
            return
        link_caps, flow_links, flow_caps = sparse_flow_problem(
            (f.links, f.cap) for f in flows)
        rates = maxmin_rates_sparse(link_caps, flow_links, flow_caps,
                                    device=self.device)
        for f, r in zip(flows, rates):
            f.rate = float(r)

    def _reallocate_scalar(self) -> None:
        unfixed = set(range(len(self.active)))
        cap_left: Dict[int, float] = {}
        link_flows: Dict[int, List[int]] = {}
        links: Dict[int, Link] = {}
        for fi in unfixed:
            for link in self.active[fi].links:
                lid = id(link)
                links[lid] = link
                cap_left.setdefault(lid, link.bandwidth)
                link_flows.setdefault(lid, []).append(fi)
        for f in self.active:
            f.rate = 0.0
        while unfixed:
            # Most-constrained link's equal share.
            best_share, best_lid = float("inf"), None
            for lid, flows in link_flows.items():
                n = sum(1 for fi in flows if fi in unfixed)
                if n == 0:
                    continue
                share = cap_left[lid] / n
                if share < best_share:
                    best_share, best_lid = share, lid
            # Flows whose own TCP cap binds before the link share.
            capped = [fi for fi in unfixed if self.active[fi].cap < best_share]
            if capped:
                for fi in capped:
                    f = self.active[fi]
                    f.rate = f.cap
                    unfixed.discard(fi)
                    for link in f.links:
                        cap_left[id(link)] = max(
                            0.0, cap_left[id(link)] - f.rate)
                continue
            if best_lid is None:
                for fi in unfixed:
                    self.active[fi].rate = self.active[fi].cap
                break
            fixed_now = [fi for fi in link_flows[best_lid] if fi in unfixed]
            for fi in fixed_now:
                f = self.active[fi]
                f.rate = best_share
                unfixed.discard(fi)
                for link in f.links:
                    if id(link) != best_lid:
                        cap_left[id(link)] = max(
                            0.0, cap_left[id(link)] - f.rate)
            cap_left[best_lid] = 0.0

    def _rebuild_finish_heap(self) -> None:
        """Absolute finish times for the current rates.  Valid until the
        active set (and hence the allocation) next changes — rates are
        static in between, so absolute times stay correct as t advances."""
        heap = [(self.t + f.remaining / f.rate, f.id, f)
                for f in self.active if f.rate > 0]
        heapq.heapify(heap)
        self._fin_heap = heap

    # -- event loop -------------------------------------------------------------
    def run(self, until: Optional[float] = None) -> float:
        if until is not None and until < self.t:
            return self.t  # guard: resuming must never move time backward
        # Benchmarks poke the solvers directly between run() calls, which
        # rewrites rates out-of-band: always re-derive finish times on entry.
        self._rebuild_finish_heap()
        while self._eventq or self.active:
            # Rates only change when the active flow set does (links and
            # per-flow caps are static): solve once per distinct event
            # time, after *all* of that instant's arrivals/completions
            # have been drained, instead of re-waterfilling the fleet
            # between same-timestamp events.
            if self._flows_dirty:
                if self.active:
                    self._reallocate()
                self._flows_dirty = False
                self._rebuild_finish_heap()
            t_finish = self._fin_heap[0][0] if self._fin_heap else float("inf")
            t_event = self._eventq[0][0] if self._eventq else float("inf")
            t_next = min(t_finish, t_event)
            if until is not None and t_next > until:
                self._advance(until - self.t)
                self.t = until
                return self.t
            if t_next == float("inf"):
                break
            self._advance(t_next - self.t)
            self.t = t_next
            if t_finish <= t_next:
                # Drain every completion at this instant (ties are exact
                # for symmetric flows: identical arithmetic → identical
                # finish times), then compact the active list once.
                while self._fin_heap and self._fin_heap[0][0] <= self.t:
                    _, _, f = heapq.heappop(self._fin_heap)
                    f.remaining = 0.0
                    f.finished_at = self.t
                    self.completed_flows += 1
                    self.flow_events += 1
                    self._flows_dirty = True
                    if f.waiter is not None:
                        self._step(f.waiter, f)
                self.active = [f for f in self.active
                               if f.finished_at is None]
            while self._eventq and self._eventq[0][0] <= self.t:
                _, _, fn = heapq.heappop(self._eventq)
                fn()
        return self.t

    def _advance(self, dt: float) -> None:
        if dt <= 0:
            return
        for f in self.active:
            moved = f.rate * dt
            f.remaining = max(0.0, f.remaining - moved)
            for link in f.links:
                self.link_bytes[link.name] = \
                    self.link_bytes.get(link.name, 0.0) + moved


# ---------------------------------------------------------------------------
# Paper scenarios (used by benchmarks/bench_proxy_vs_stash.py etc.)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class DownloadResult:
    path: str
    size: int
    method: str
    seconds: float = 0.0
    cache_hit: bool = False
    start: float = 0.0
    source: str = ""      # cache/proxy that served the final hop
    failovers: int = 0    # dead caches skipped before one answered
    hedged: bool = False  # a backup fetch was raced against the primary
    waited: bool = False  # collapsed-forwarding wait (paid miss latency)
    shed: bool = False    # refused by an admission queue (load shedding)
    queue_seconds: float = 0.0  # time parked in admission queues


def fetch_chunks(sim: FluidFlowSim, cache: CacheServer, meta: ObjectMeta,
                 origin_node: str, redirector_node: str,
                 origin=None, pull_streams: int = 4,
                 refs=None) -> Generator:
    """Ensure ``meta``'s chunks (or the ``refs`` subset) are resident at
    ``cache``: redirector RPC + origin→cache pull on miss, collapsed
    forwarding on in-flight chunks (concurrent requests wait rather than
    re-pull).  Shared by ``stash_download`` and the routed simclient
    downloads so the two paths can never diverge on cache accounting.

    In a tiered federation a miss fills *cache-to-cache* first: the
    missing chunks are ensured at the parent tier's owning member (a
    recursive call — so the parent's own inflight registry collapses
    concurrent child fills, and an L2 miss recurses on up or pulls from
    the origin), then move over one parent→child flow.  Only the top
    tier pays the redirector RPC; a child with a live parent never asks
    the redirector.  A dead parent tier falls back to the flat
    origin-pull path.

    Returns "hit" (fully resident), "miss" (pulled from upstream),
    "waited" (collapsed-forwarding wait: full miss latency, no duplicate
    pull), or None when the cache died while we pulled/waited.  Passing
    the :class:`~repro_torch.core.origin.Origin` object counts its egress.
    """
    cache.tick(sim.t)  # TTL policies expire against simulated time
    inflight = sim.inflight(cache.name)
    missing, wait_for = [], []
    for r in (meta.chunk_refs() if refs is None else refs):
        key = (meta.path, r.index)
        if cache.resident(meta.path, r.index):
            cache.lookup(meta.path, r.index)          # counts the hit
        elif key in inflight:
            wait_for.append((r, inflight[key]))        # collapsed forwarding
        else:
            cache.stats.misses += 1
            inflight[key] = sim.event()
            missing.append(r)
    if missing:
        miss_bytes = sum(r.length for r in missing)
        parent = next(iter(cache.parent_caches(meta.path)), None)
        if parent is not None:
            status = yield from fetch_chunks(
                sim, parent, meta, origin_node, redirector_node,
                origin=origin, pull_streams=pull_streams, refs=missing)
            if status is None:
                parent = None  # parent died mid-fill: origin fallback
        if parent is not None:
            yield sim.flow(parent.node.name, cache.node.name, miss_bytes,
                           streams=pull_streams)
            parent.stats.bytes_served += miss_bytes
            cache.stats.bytes_from_parent += miss_bytes
        else:
            yield sim.delay(sim.net.rpc_time(cache.node.name,
                                             redirector_node))
            yield sim.flow(origin_node, cache.node.name, miss_bytes,
                           streams=pull_streams)
            cache.stats.bytes_from_origin += miss_bytes
            if origin is not None:
                origin.stats.egress_bytes += miss_bytes
                origin.stats.chunk_requests += len(missing)
        cache.tick(sim.t)
        for r in missing:
            cache.admit(meta.path, r.index,
                        Payload.synthetic(r.length, meta.path, r.index),
                        object_size=meta.size)
            ev = inflight.pop((meta.path, r.index), None)
            if ev is not None:
                ev.set()
    for r, ev in wait_for:
        if not ev.is_set:
            yield ev
        cache.tick(sim.t)
        # A waiter is only a hit if the pull actually landed — admission
        # may have rejected the chunk, in which case the cache never held
        # it and the read is a miss for the hit/miss latency splits.
        if cache.resident(meta.path, r.index):
            cache.stats.hits += 1
        else:
            cache.stats.misses += 1
    if not cache.available:
        return None
    if missing:
        return "miss"
    return "waited" if wait_for else "hit"


def stash_download(sim: FluidFlowSim, client_node: str, cache: CacheServer,
                   origin_node: str, redirector_node: str, meta: ObjectMeta,
                   geoip_latency: float, streams: int = 8,
                   result: Optional[DownloadResult] = None) -> Generator:
    """stashcp against one pre-chosen cache: GeoIP lookup →
    :func:`fetch_chunks` → cache→client multi-stream transfer.  (The
    routed, failover-aware variant lives in ``repro_torch.core.simclient``.)"""
    t0 = sim.t
    yield sim.delay(geoip_latency)
    status = yield from fetch_chunks(sim, cache, meta, origin_node,
                                     redirector_node)
    yield sim.flow(cache.node.name, client_node, meta.size, streams=streams,
                   rate_cap=cache.serve_rate_cap(meta.size))
    cache.stats.bytes_served += meta.size
    if result is not None:
        result.seconds = sim.t - t0
        # Collapsed-forwarding waiters paid full miss latency: only an
        # entirely-resident object counts as a cache hit.
        result.cache_hit = status == "hit"
        result.waited = status == "waited"
        result.source = cache.name
        result.start = t0


def proxy_download(sim: FluidFlowSim, client_node: str, proxy: HTTPProxy,
                   origin_node: str, meta: ObjectMeta,
                   result: Optional[DownloadResult] = None) -> Generator:
    """curl via the site squid: zero discovery cost, single-stream HTTP,
    whole-object granularity, TTL + size-cap admission."""
    t0 = sim.t
    entry = proxy.lookup(meta.path, sim.t)
    if entry is None:
        yield sim.flow(origin_node, proxy.node.name, meta.size, streams=1)
        proxy.stats.bytes_from_origin += meta.size
        proxy.origin.stats.egress_bytes += meta.size
        proxy.admit(meta.path, meta.size, sim.t)
    yield sim.flow(proxy.node.name, client_node, meta.size, streams=1,
                   rate_cap=proxy.serve_rate_cap(meta.size))
    proxy.stats.bytes_served += meta.size
    if result is not None:
        result.seconds = sim.t - t0
        result.cache_hit = entry is not None
        result.source = proxy.name
        result.start = t0


def direct_download(sim: FluidFlowSim, client_node: str, origin_node: str,
                    meta: ObjectMeta, streams: int = 1,
                    result: Optional[DownloadResult] = None) -> Generator:
    """No caching layer at all: every worker pulls from the origin (the
    WAN-saturating counterfactual behind paper Fig. 5)."""
    t0 = sim.t
    yield sim.flow(origin_node, client_node, meta.size, streams=streams)
    if result is not None:
        result.seconds = sim.t - t0
        result.start = t0
