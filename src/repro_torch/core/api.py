"""One federation access API — the unified data plane (paper §3).

The paper's value proposition is the *federation interface*: clients name
data by path, and the federation (redirectors, namespace, caches) resolves
and serves it.  This module is that interface as a typed protocol with two
interchangeable engines:

* :class:`AnalyticPlane` — instant execution over the functional
  federation (:class:`~repro_torch.core.client.StashClient` /
  :class:`~repro_torch.core.proxy.HTTPProxy`): transfers move real or synthetic
  bytes immediately and *account* time with the uncontended
  :class:`~repro_torch.core.transfer.NetworkModel`.
* :class:`SimulatedPlane` — the same requests replayed as coroutines on
  the fluid-flow discrete-event simulator
  (:class:`~repro_torch.core.simclient.SimStashClient` /
  :class:`~repro_torch.core.simulator.FluidFlowSim`), with max-min link
  contention, collapsed forwarding, hedged fetches and outage schedules.

Callers write ``plane.fetch("/ospool/file")`` identically on either plane
and get a :class:`FetchResult` back — the type that unifies the old
``TransferStats`` (analytic) and ``DownloadResult`` (simulated) shapes.
Path resolution is namespace-first: the owning origin comes from
longest-prefix match through :class:`~repro_torch.core.redirector.Redirector` /
:class:`~repro_torch.core.namespace.Namespace`, never from a held origin or
cache reference.

On top of the planes sits the declarative layer: a
:class:`ScenarioSpec` names a federation
(:class:`~repro_torch.core.federation.FederationSpec`), a workload
(:class:`WorkloadSpec` or an explicit request list), an optional
:class:`~repro_torch.core.simclient.OutageSchedule`, the solver and the engine;
:func:`run_scenario` builds a fresh federation, publishes the workload's
objects, executes every request on the chosen engine and aggregates a
:class:`ScenarioReport`.  Because the spec is inert data, the *same*
scenario runs on both engines — which is what the engine-parity tests
and the CI smoke assert.

This is the port of the reference's ``repro.core.api``, the batched
sweeps (``SweepSpec``, ``run_sweep``) and their fitted cache models
(``run_sweep(fit=...)``) included.  Device work runs on a device:
``ScenarioSpec.device`` and ``SimulatedPlane(device=...)`` name the
simulated engine's, and a sweep's template ``SweepSpec.base.device``
names its kernels' (the stack-distance scans and the batched max-min
solver, and the mixture fit of ``fit="mixture"``); ``None`` means
``cuda`` and raises without a card.  The analytic engine of
``run_scenario`` has no device work and takes none.  Real bytes
(``publish``, ``store`` and verified reads of them) are digested on the
federation's device (``FederationSpec.build(device)``, the builders'
``device``; ``run_scenario`` builds with ``ScenarioSpec.device``), the
same rule, resolved when real bytes are first digested: synthetic
payloads, which every scenario, sweep and plan moves, never need it.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
import re
import time
from typing import (Dict, Generator, List, Optional, Protocol, Sequence,
                    Set, Tuple, Union, runtime_checkable)

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.batched_maxmin import maxmin_rates_batch
from ..kernels.cache_model import (fit_histogram_model,
                                   fit_lognormal_mixtures, reuse_histogram)
from ..kernels.stack_distance import (cache_sim_batch, fifo_sim_batch,
                                      stack_distances_batch)
from .client import StashClient
from .controlplane import ControlPlane, ControlPlaneSpec
from .federation import Federation, FederationSpec, SiteSpec
from .routing import RankingPolicy
from .simclient import (OutageSchedule, ScenarioEngine, ScenarioReport,
                        apply_outage, tier_tallies)
from .simulator import direct_download, proxy_download, sparse_flow_problem
from .topology import Coord
from .transfer import TransferStats
from .workload import (AccessRequest, abusive_workload,
                       checkpoint_restart_workload, dataloader_workload,
                       flash_crowd_workload, generate_workload,
                       herd_workload, shard_serving_workload, split_bytes,
                       storm_workload)

GB = 10**9


# ---------------------------------------------------------------------------
# Typed request/response models
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class FetchRequest:
    """One named-data fetch: *what* (path), *where from* (site/worker),
    *how* (method) and *when* (arrival time, simulated plane).

    ``offset``/``length`` select a byte range (``length=-1`` = to EOF);
    only the analytic ``cvmfs`` method moves partial objects — the
    simulated plane and the whole-file methods account the full object.
    ``want_data=True`` asks for the assembled bytes on
    :attr:`FetchResult.data` (analytic plane; the simulator moves no
    real bytes).  ``avoid`` names a cache to skip for this request —
    the hedging hook consumers use to force the next-nearest replica.
    """

    path: str
    site: str = ""          # requesting site; "" = first worker-bearing site
    worker: int = 0
    method: str = "stash"   # "stash" | "cvmfs" | "proxy" | "direct"
    at: float = 0.0         # arrival time (sim clock; analytic outage clock)
    size: int = 0           # size hint for publishing synthetic objects
    streams: int = 0        # 0 = plane default
    tenant: str = ""        # fair-share / quota accounting unit
    offset: int = 0         # byte-range start (cvmfs partial reads)
    length: int = -1        # byte-range length; -1 = through EOF
    want_data: bool = False  # attach assembled bytes to the result
    avoid: str = ""         # cache name to skip (hedged refetch)

    METHODS = ("stash", "cvmfs", "proxy", "direct")

    def __post_init__(self) -> None:
        if self.method not in self.METHODS:
            raise ValueError(f"unknown fetch method {self.method!r}")
        if self.offset < 0:
            raise ValueError(f"negative offset {self.offset}")
        if self.length < -1:
            raise ValueError(f"bad length {self.length} (use -1 for EOF)")


@dataclasses.dataclass
class FetchResult:
    """What one fetch did — the unification of the analytic path's
    ``TransferStats`` and the simulator's ``DownloadResult``.

    ``seconds`` is accounted (analytic) or simulated (sim) wall time;
    ``bytes`` is what crossed the last hop to the worker; chunk-level
    ``cache_hits``/``cache_misses`` are exact on the analytic plane and
    derived from the hit/miss status on the simulated plane (per-chunk
    splits under concurrency live in the federation's ``CacheStats``).
    """

    path: str
    size: int = 0
    method: str = ""
    plane: str = ""         # "analytic" | "sim"
    seconds: float = 0.0
    bytes: int = 0
    chunks: int = 0
    cache_hit: bool = False
    cache_hits: int = 0
    cache_misses: int = 0
    waited: bool = False    # collapsed-forwarding wait (sim)
    hedged: bool = False    # a backup fetch was raced (sim)
    source: str = ""        # cache/proxy/origin that served the last hop
    failovers: int = 0
    start: float = 0.0
    ok: bool = True
    error: str = ""
    shed: bool = False      # refused by an admission queue (load shedding)
    queue_seconds: float = 0.0  # time parked in admission queues
    local_hits: int = 0     # chunks served by the worker-local CVMFS cache
    data: Optional[bytes] = None  # assembled bytes (want_data, analytic)

    @classmethod
    def from_transfer(cls, path: str, stats: TransferStats, *,
                      method: str, start: float = 0.0) -> "FetchResult":
        """Analytic-plane constructor: fold a ``TransferStats``."""
        return cls(path=path, size=stats.bytes, method=method,
                   plane="analytic", seconds=stats.seconds,
                   bytes=stats.bytes, chunks=stats.chunks,
                   cache_hit=(stats.cache_misses == 0
                              and stats.cache_hits > 0),
                   cache_hits=stats.cache_hits,
                   cache_misses=stats.cache_misses,
                   local_hits=stats.local_hits,
                   source=stats.source, start=start)


@dataclasses.dataclass
class StatResult:
    """Namespace-first metadata lookup: does the federation know the
    path, how big is it, and which origin exports it."""

    path: str
    found: bool
    size: int = 0
    num_chunks: int = 0
    chunk_size: int = 0
    origin: str = ""


# ---------------------------------------------------------------------------
# The protocol both engines implement
# ---------------------------------------------------------------------------
@runtime_checkable
class DataPlane(Protocol):
    """The one federation access API.

    Implementations hold a :class:`Federation`; callers hold only paths.
    ``fetch`` accepts a bare path (all defaults) or a
    :class:`FetchRequest`; ``fetch_all`` executes a workload — under
    contention with an optional outage schedule on the simulated plane,
    in request-time order with outage events interleaved on the analytic
    plane.  ``publish``/``stat`` route through the redirectors'
    namespace (longest-prefix), so multi-origin federations work without
    the caller ever naming an origin.
    """

    name: str
    fed: Federation

    def stat(self, path: str) -> StatResult: ...

    def publish(self, path: str, data: Union[bytes, int],
                mtime: float = 0.0) -> StatResult: ...

    def fetch(self, request: Union[str, FetchRequest]) -> FetchResult: ...

    def fetch_all(self, requests: Sequence[FetchRequest],
                  schedule: Optional[OutageSchedule] = None,
                  sequential: bool = False) -> List[FetchResult]: ...

    def store(self, path: str, data: Union[bytes, int], site: str = "",
              worker: int = 0) -> FetchResult: ...

    def drain(self, max_objects: Optional[int] = None) -> FetchResult: ...

    def paths(self, prefix: str = "/") -> List[str]: ...


class _PlaneBase:
    """Namespace-first resolution shared by both engines."""

    name = ""

    def __init__(self, fed: Federation) -> None:
        self.fed = fed
        # Per-cache write-back overlays, minted on first store() to that
        # cache (the write path of the unified API).
        self._writebacks: Dict[str, "WritebackCache"] = {}

    def stat(self, path: str) -> StatResult:
        try:
            origin = self.fed.redirectors.locate(path)
        except ConnectionError:
            origin = None
        if origin is None:
            return StatResult(path=path, found=False)
        meta = origin.meta(path)
        return StatResult(path=path, found=True, size=meta.size,
                          num_chunks=meta.num_chunks,
                          chunk_size=meta.chunk_size, origin=origin.name)

    def publish(self, path: str, data: Union[bytes, int],
                mtime: float = 0.0) -> StatResult:
        origin = self.fed.resolve_origin(path)
        if origin is None:
            raise KeyError(f"no origin exports a prefix of {path!r}")
        meta = origin.put_object(path, data, mtime=mtime)
        return StatResult(path=path, found=True, size=meta.size,
                          num_chunks=meta.num_chunks,
                          chunk_size=meta.chunk_size, origin=origin.name)

    def _default_site(self) -> str:
        for s in self.fed.sites:
            if s.workers > 0:
                return s.name
        return self.fed.sites[0].name

    def _req(self, request: Union[str, FetchRequest]) -> FetchRequest:
        req = (FetchRequest(path=request) if isinstance(request, str)
               else request)
        if not req.site:
            req = dataclasses.replace(req, site=self._default_site())
        return req

    # -- the write path ------------------------------------------------------
    def store(self, path: str, data: Union[bytes, int], site: str = "",
              worker: int = 0) -> FetchResult:
        """Write an object through the *write-back cache tier*: bytes land
        (pinned, dirty) in the cache nearest the requesting worker and the
        write acks against cache residency; :meth:`drain` pushes dirty
        objects to their owning origin under the drain rate limit.

        Writes are accounted with the uncontended network model on both
        engines (the simulator contends reads, not writes).
        """
        site = site or self._default_site()
        node = _worker_node(self.fed, site, worker)
        cache = self.fed.nearest_cache(node, path)
        wb = self._writebacks.get(cache.name)
        if wb is None:
            wb = self._writebacks[cache.name] = self.fed.writeback(cache.name)
        meta, st = wb.write(node, path, data)
        return FetchResult(path=path, size=meta.size, method="writeback",
                           plane=self.name, seconds=st.seconds,
                           bytes=st.bytes, chunks=st.chunks,
                           source=cache.name)

    def drain(self, max_objects: Optional[int] = None) -> FetchResult:
        """Flush every dirty write-back object to its origin."""
        agg = FetchResult(path="", method="writeback-drain",
                          plane=self.name)
        for name in sorted(self._writebacks):
            st = self._writebacks[name].drain(max_objects)
            agg.seconds += st.seconds
            agg.bytes += st.bytes
            agg.chunks += st.chunks
        agg.size = agg.bytes
        return agg

    def paths(self, prefix: str = "/") -> List[str]:
        """Every federation path under ``prefix``: origin catalogs plus
        dirty (not-yet-drained) write-back objects — read-your-writes."""
        out: Set[str] = set()
        for origin in self.fed.origins:
            for meta in origin.list_objects():
                if meta.path.startswith(prefix):
                    out.add(meta.path)
        for wb in self._writebacks.values():
            for p in wb.dirty_paths():
                if p.startswith(prefix):
                    out.add(p)
        return sorted(out)


# ---------------------------------------------------------------------------
# Engine 1: analytic (functional federation, uncontended accounting)
# ---------------------------------------------------------------------------
class AnalyticPlane(_PlaneBase):
    """Instant execution with :class:`NetworkModel` time accounting.

    ``stash`` fetches go through the real :class:`StashClient` fallback
    chain restricted to the cache-served methods (``xrootd``/``http``) —
    the worker-local CVMFS cache is *not* consulted, so the cache tier
    sees the same lookups the simulated plane produces (engine parity).
    ``cvmfs`` exposes the POSIX read path (worker-local chunk cache
    included); ``proxy`` is the squid baseline; ``direct`` bypasses the
    cache tier entirely.
    """

    name = "analytic"

    def __init__(self, fed: Federation, streams: int = 8,
                 ranking: Union[str, RankingPolicy, None] = None,
                 control: Optional[ControlPlaneSpec] = None) -> None:
        super().__init__(fed)
        self.streams = streams
        # string specs mint a fresh policy per client (per-client probe
        # state); a policy instance is shared deliberately.
        self.ranking = ranking
        self.clients: Dict[Tuple[str, int], StashClient] = {}
        group_of = {c.name: g for g in fed.groups.values()
                    for c in g.members}
        self.control = (ControlPlane(control, group_of=group_of)
                        if control is not None else None)

    def client(self, site: str, worker: int = 0) -> StashClient:
        key = (site, worker)
        c = self.clients.get(key)
        if c is None:
            c = self.fed.client(site, worker, ranking=self.ranking)
            c.control = self.control
            self.clients[key] = c
        return c

    # -- the one entry point -------------------------------------------------
    def fetch(self, request: Union[str, FetchRequest]) -> FetchResult:
        req = self._req(request)
        try:
            if req.avoid:
                return self._fetch_avoiding(req)
            return self._fetch(req)
        except (FileNotFoundError, ConnectionError, KeyError) as e:
            return FetchResult(path=req.path, method=req.method,
                               plane=self.name, start=req.at,
                               ok=False, error=f"{type(e).__name__}: {e}")

    def _fetch_avoiding(self, req: FetchRequest) -> FetchResult:
        """Serve ``req`` as if ``req.avoid`` were down — the hedged-
        refetch hook: consumers race a straggler against the
        next-nearest replica without reaching into the cache tier."""
        cache = self.fed.caches.get(req.avoid)
        if cache is None or not cache.available:
            return self._fetch(req)
        cache.available = False
        try:
            return self._fetch(req)
        finally:
            cache.available = True

    def _fetch(self, req: FetchRequest) -> FetchResult:
        client = self.client(req.site, req.worker)
        client.now = max(client.now, req.at)
        # Admission control happens at the cache the request would be
        # served from (the first live ranked cache).  ``reserve`` is
        # side-effect free, so a shed terminates the request without
        # touching the cache tier; the measured service time is
        # committed into the queue model after the transfer.
        queue_name = None
        queue_start = None
        if (self.control is not None and client.caches
                and req.method in ("stash", "cvmfs")):
            queue_name = next(
                (c.name for c in client._ranked_caches(path=req.path)
                 if c.available), None)
            if queue_name is not None:
                q = self.control.queue(queue_name)
                queue_start = q.reserve(req.at, req.tenant)
                if queue_start is None:
                    return FetchResult(
                        path=req.path, method="shed", plane=self.name,
                        start=req.at, ok=False, shed=True,
                        source=queue_name,
                        error="shed: admission queue full")
        data: Optional[bytes] = None
        if req.method == "stash":
            try:
                data, stats = client.copy(req.path,
                                          methods=("xrootd", "http"))
            except (FileNotFoundError, ConnectionError):
                # Every ranked cache failed: like the simulated client,
                # the federation degrades to a direct origin pull — but
                # only if the path actually exists.
                if not self.stat(req.path).found:
                    raise
                client.stats.origin_fallbacks += 1
                res = self._fetch_direct(req, client)
                res.method = "origin-direct"
                res.start = req.at
                return res
        elif req.method == "cvmfs":
            data, stats = client.read(
                req.path, offset=req.offset,
                length=req.length if req.length >= 0 else None)
        elif req.method == "proxy":
            res = self._fetch_proxy(req, client)
            res.start = req.at
            return res
        else:  # direct
            res = self._fetch_direct(req, client)
            res.start = req.at
            return res
        res = FetchResult.from_transfer(req.path, stats, method=req.method,
                                        start=req.at)
        if req.want_data:
            res.data = data
        if queue_name is not None and queue_start is not None:
            wait = self.control.queue(queue_name).commit(
                req.at, queue_start, res.seconds, req.tenant)
            res.queue_seconds = wait
            res.seconds += wait
        return res

    def _fetch_proxy(self, req: FetchRequest,
                     client: StashClient) -> FetchResult:
        proxy = self.fed.proxies.get(req.site)
        if proxy is None:
            raise KeyError(f"site {req.site!r} has no HTTP proxy")
        origin = self.fed.redirectors.locate(req.path)
        if origin is None:
            raise FileNotFoundError(req.path)
        meta = origin.meta(req.path)
        _, stats = proxy.get_object(client.node.name, meta, now=req.at)
        return FetchResult(
            path=req.path, size=meta.size, method="proxy",
            plane=self.name, seconds=stats.seconds, bytes=stats.bytes,
            chunks=stats.chunks, cache_hit=stats.cache_hits > 0,
            cache_hits=stats.cache_hits, cache_misses=stats.cache_misses,
            source=stats.source)

    def _fetch_direct(self, req: FetchRequest,
                      client: StashClient) -> FetchResult:
        origin = self.fed.redirectors.locate(req.path)
        if origin is None:
            raise FileNotFoundError(req.path)
        meta = origin.meta(req.path)
        streams = req.streams or self.streams
        seconds = self.fed.net.transfer_time(
            origin.node.name, client.node.name, meta.size, streams=streams)
        for ref in meta.chunk_refs():
            origin.read_chunk(req.path, ref.index)  # egress accounting
        return FetchResult(
            path=req.path, size=meta.size, method="direct",
            plane=self.name, seconds=seconds, bytes=meta.size,
            chunks=meta.num_chunks, cache_misses=meta.num_chunks,
            source=origin.name)

    def fetch_all(self, requests: Sequence[FetchRequest],
                  schedule: Optional[OutageSchedule] = None,
                  sequential: bool = False) -> List[FetchResult]:
        """Requests in arrival order, outage events interleaved by time.

        The analytic plane is sequential by construction (transfers are
        instantaneous), so ``sequential`` is accepted for protocol
        symmetry and ignored.
        """
        events = list(schedule) if schedule is not None else []
        group_of = {c.name: g for g in self.fed.groups.values()
                    for c in g.members} if events else {}
        results: List[Optional[FetchResult]] = [None] * len(requests)
        order = sorted(range(len(requests)),
                       key=lambda i: self._req(requests[i]).at)
        ei = 0
        for i in order:
            req = self._req(requests[i])
            while ei < len(events) and events[ei].time <= req.at:
                apply_outage(self.fed, events[ei], group_of=group_of)
                ei += 1
            results[i] = self.fetch(req)
        while ei < len(events):
            apply_outage(self.fed, events[ei], group_of=group_of)
            ei += 1
        return [r for r in results if r is not None]


# ---------------------------------------------------------------------------
# Engine 2: simulated (fluid-flow DES, contention + outages)
# ---------------------------------------------------------------------------
class SimulatedPlane(_PlaneBase):
    """The same API, replayed as coroutines under max-min contention.

    Wraps a :class:`~repro_torch.core.simclient.ScenarioEngine` for its sim,
    per-(site, worker) :class:`SimStashClient` pool and outage
    controller.  ``fetch`` runs one request to completion; ``fetch_all``
    spawns the whole workload (concurrently by arrival time, or
    ``sequential`` for protocols like the paper's 4-download experiment
    where requests must not compete) and runs the sim once.
    """

    name = "sim"

    def __init__(self, fed: Federation, solver: str = "auto",
                 streams: int = 8, hedge_after: Optional[float] = None,
                 max_attempts: int = 4, rank_limit: Optional[int] = 8,
                 router: str = "ring",
                 ranking: Union[str, RankingPolicy, None] = None,
                 control: Optional[ControlPlaneSpec] = None,
                 device: Union[str, torch.device, None] = None) -> None:
        super().__init__(fed)
        self.engine = ScenarioEngine(
            fed, solver=solver, streams=streams, hedge_after=hedge_after,
            max_attempts=max_attempts, rank_limit=rank_limit, router=router,
            ranking=ranking, control=control, device=device)
        self.streams = streams

    @property
    def control(self) -> Optional[ControlPlane]:
        return self.engine.control

    @property
    def sim(self):
        return self.engine.sim

    @property
    def clients(self):
        return self.engine._clients

    # -- coroutines ----------------------------------------------------------
    def _download(self, req: FetchRequest, res: FetchResult) -> Generator:
        sim = self.sim
        origin = self.fed.redirectors.locate(req.path)
        if origin is None:
            res.ok = False
            res.error = f"FileNotFoundError: {req.path}"
            return
        meta = origin.meta(req.path)
        res.size = meta.size
        res.chunks = meta.num_chunks
        if req.method in ("stash", "cvmfs"):
            # The simulator models no worker-local cache; cvmfs degrades
            # to the cache-served path (same chunks, same accounting).
            # Byte ranges and want_data degrade likewise: the fluid-flow
            # sim moves whole synthetic objects, never real bytes.
            sc = self.engine.client(req.site, req.worker)
            yield from sc.download(req.path, meta=meta, result=res,
                                   tenant=req.tenant)
            if res.shed:
                res.ok = False
                res.error = res.error or "shed: admission queue full"
        elif req.method == "proxy":
            proxy = self.fed.proxies.get(req.site)
            if proxy is None:
                res.ok = False
                res.error = f"KeyError: site {req.site!r} has no HTTP proxy"
                return
            wnode = self.engine.client(req.site, req.worker).node_name
            yield from proxy_download(sim, wnode, proxy, origin.node.name,
                                      meta, result=res)
            res.method = "proxy"
        else:  # direct
            wnode = self.engine.client(req.site, req.worker).node_name
            yield from direct_download(sim, wnode, origin.node.name, meta,
                                       streams=req.streams or self.streams,
                                       result=res)
            origin.stats.egress_bytes += meta.size
            res.source = origin.name
        if res.seconds > 0:
            res.bytes = meta.size
            if res.cache_hit:
                res.cache_hits = res.chunks
            else:
                res.cache_misses = res.chunks

    def _chain(self, pairs: List[Tuple[FetchRequest, FetchResult]]
               ) -> Generator:
        for req, res in pairs:
            if req.at > self.sim.t:
                yield self.sim.delay(req.at - self.sim.t)
            yield from self._download(req, res)

    # -- the one entry point -------------------------------------------------
    def fetch(self, request: Union[str, FetchRequest]) -> FetchResult:
        return self.fetch_all([self._req(request)], sequential=True)[0]

    def fetch_all(self, requests: Sequence[FetchRequest],
                  schedule: Optional[OutageSchedule] = None,
                  sequential: bool = False) -> List[FetchResult]:
        reqs = [self._req(r) for r in requests]
        results = [FetchResult(path=r.path, method=r.method,
                               plane=self.name) for r in reqs]
        if sequential:
            self.sim.spawn(self._chain(list(zip(reqs, results))))
        else:
            for req, res in zip(reqs, results):
                # A reused plane's clock has advanced past early arrival
                # times; never schedule into the past (the sim clock is
                # monotonic).
                self.sim.spawn(self._download(req, res),
                               at=max(req.at, self.sim.t))
        if schedule is not None and len(schedule):
            self.sim.spawn(self.engine._outage_controller(schedule))
        self.sim.run()
        return results


# ---------------------------------------------------------------------------
# Legacy adapter: a DataPlane facade over bare client/writeback objects
# ---------------------------------------------------------------------------
class ClientPlane:
    """Deprecation adapter: the :class:`DataPlane` surface over a bare
    :class:`~repro_torch.core.client.StashClient` and/or
    :class:`~repro_torch.core.writeback.WritebackCache`.

    Exists only so pre-redesign call sites
    (``FederatedDataLoader(client=...)``,
    ``FederatedCheckpointer(writeback=..., client=...)``) keep working;
    new code should build an :class:`AnalyticPlane` /
    :class:`SimulatedPlane` from a :class:`Federation` and let the plane
    mint clients.  The adapter serves ``cvmfs``/``stash`` fetches through
    the held client, stores through the held write-back cache, and has no
    federation (``fed is None``) — ``publish`` is unsupported.
    """

    name = "client"

    def __init__(self, client: Optional[StashClient] = None,
                 writeback=None) -> None:
        if client is None and writeback is None:
            raise ValueError("ClientPlane needs a client or a writeback")
        self.client = client
        self.writeback = writeback
        self.fed = None

    # -- reads ---------------------------------------------------------------
    def stat(self, path: str) -> StatResult:
        meta = None
        if self.client is not None:
            meta = self.client._meta(path)
        if meta is None and self.writeback is not None:
            meta = self.writeback.cache.locate_meta(path)
        if meta is None:
            return StatResult(path=path, found=False)
        return StatResult(path=path, found=True, size=meta.size,
                          num_chunks=meta.num_chunks,
                          chunk_size=meta.chunk_size)

    def publish(self, path: str, data: Union[bytes, int],
                mtime: float = 0.0) -> StatResult:
        raise NotImplementedError(
            "the legacy ClientPlane adapter holds no federation; "
            "publish through an AnalyticPlane/SimulatedPlane")

    def fetch(self, request: Union[str, FetchRequest]) -> FetchResult:
        req = (FetchRequest(path=request) if isinstance(request, str)
               else request)
        if self.client is None:
            return FetchResult(path=req.path, method=req.method,
                               plane=self.name, ok=False,
                               error="RuntimeError: adapter holds no client")
        try:
            if req.avoid:
                cache = self.client.caches.get(req.avoid)
                if cache is not None and cache.available:
                    cache.available = False
                    try:
                        return self._fetch(req)
                    finally:
                        cache.available = True
            return self._fetch(req)
        except (FileNotFoundError, ConnectionError, KeyError,
                RuntimeError) as e:
            return FetchResult(path=req.path, method=req.method,
                               plane=self.name, start=req.at,
                               ok=False, error=f"{type(e).__name__}: {e}")

    def _fetch(self, req: FetchRequest) -> FetchResult:
        if req.method == "cvmfs":
            data, stats = self.client.read(
                req.path, offset=req.offset,
                length=req.length if req.length >= 0 else None)
        elif req.method == "stash":
            data, stats = self.client.copy(req.path,
                                           methods=("xrootd", "http"))
        else:
            raise RuntimeError(
                f"legacy adapter serves stash/cvmfs only, not "
                f"{req.method!r}")
        res = FetchResult.from_transfer(req.path, stats, method=req.method,
                                        start=req.at)
        if req.want_data:
            res.data = data
        res.plane = self.name
        return res

    def fetch_all(self, requests: Sequence[FetchRequest],
                  schedule: Optional[OutageSchedule] = None,
                  sequential: bool = False) -> List[FetchResult]:
        if schedule is not None and len(schedule):
            raise NotImplementedError(
                "the legacy ClientPlane adapter cannot apply outages")
        return [self.fetch(r) for r in requests]

    # -- writes --------------------------------------------------------------
    def store(self, path: str, data: Union[bytes, int], site: str = "",
              worker: int = 0) -> FetchResult:
        if self.writeback is None:
            raise RuntimeError("adapter holds no write-back cache")
        node = (self.client.node.name if self.client is not None
                else self.writeback.cache.node.name)
        meta, st = self.writeback.write(node, path, data)
        return FetchResult(path=path, size=meta.size, method="writeback",
                           plane=self.name, seconds=st.seconds,
                           bytes=st.bytes, chunks=st.chunks,
                           source=self.writeback.cache.name)

    def drain(self, max_objects: Optional[int] = None) -> FetchResult:
        if self.writeback is None:
            raise RuntimeError("adapter holds no write-back cache")
        st = self.writeback.drain(max_objects)
        return FetchResult(path="", size=st.bytes, method="writeback-drain",
                           plane=self.name, seconds=st.seconds,
                           bytes=st.bytes, chunks=st.chunks)

    def paths(self, prefix: str = "/") -> List[str]:
        if self.writeback is None:
            raise RuntimeError("adapter holds no write-back cache")
        out: Set[str] = set()
        for r in self.writeback.redirectors.members:
            for origin in r.origins.values():
                for meta in origin.list_objects():
                    if meta.path.startswith(prefix):
                        out.add(meta.path)
        for p in self.writeback.dirty_paths():
            if p.startswith(prefix):
                out.add(p)
        return sorted(out)


# ---------------------------------------------------------------------------
# Declarative scenarios
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    """A declarative workload: a restart ``storm`` (every worker pulls
    the same object) or a production-shaped ``zipf`` trace (Table 2
    sizes, Table 1 experiment mix).  ``sites=None`` targets every
    worker-bearing site of the federation.

    The model-traffic kinds turn LM training/serving into federation
    workloads (see :meth:`from_model_config`): ``restart`` — every
    worker re-fetches a sharded checkpoint's manifest plus its
    model-parallel rank's shards; ``serve`` — Zipf-popular reads over a
    model's weight shards; ``dataloader`` — sequential striped dataset
    reads.  For those, ``path`` is the object prefix, ``n_objects`` the
    shard count and ``total_bytes`` the exact byte total the shard
    sizes sum to.
    """

    kind: str = "zipf"   # "zipf" | "storm" | "herd" | "abusive" |
    #                      "flash_crowd" | "restart" | "serve" | "dataloader"
    sites: Optional[Sequence[str]] = None
    # zipf trace knobs
    n_requests: int = 100
    duration: float = 3600.0
    working_set: int = 64
    zipf_a: float = 1.2
    seed: int = 0
    # storm / herd knobs
    path: str = "/ckpt/step/params"
    size: int = 2 * GB
    at: float = 0.0
    workers_per_site: int = 1
    jitter: float = 0.0
    # herd knobs (repeated synchronized waves on hot objects)
    waves: int = 1
    wave_gap: float = 30.0
    n_objects: int = 1
    # tenant mix (zipf/abusive): tenant name -> weight; None = tenant
    # defaults to the owning experiment
    tenants: Optional[Dict[str, float]] = None
    tenant: str = ""                 # fixed tenant for storm/herd traces
    # abusive-client knobs (zipf background + one cache-busting tenant)
    abusive_tenant: str = "abuser"
    abuse_factor: float = 4.0
    abuse_at: float = 0.0
    abuse_duration: float = 60.0
    # flash-crowd knobs (zipf background + one region hammering a small
    # hot set; ``size`` doubles as the hot-object size, ``n_objects`` as
    # the hot-set cardinality)
    hot_sites: Optional[Sequence[str]] = None
    crowd_factor: float = 3.0
    crowd_at: float = 0.0
    crowd_duration: float = 120.0
    # model-traffic knobs (restart/serve/dataloader; ``path`` is the
    # object prefix, ``n_objects`` the shard count, ``waves`` doubles as
    # the dataloader epoch count)
    total_bytes: int = 0             # exact checkpoint/model/dataset bytes
    manifest_bytes: int = 64_000     # restart: the shard manifest object
    tp_degree: int = 1               # restart: model-parallel shard fan-out
    step_gap: float = 1.0            # dataloader: seconds between shards
    model: str = ""                  # provenance (from_model_config)

    KINDS = ("zipf", "storm", "herd", "abusive", "flash_crowd",
             "restart", "serve", "dataloader")

    def __post_init__(self) -> None:
        if self.kind not in self.KINDS:
            raise ValueError(f"unknown workload kind {self.kind!r}")

    @classmethod
    def from_model_config(cls, cfg, kind: str = "restart", *,
                          dataset=None, shard_bytes: int = GB,
                          **overrides) -> "WorkloadSpec":
        """Build a model-traffic workload from an
        :class:`~repro_torch.configs.base.ArchConfig` — scenario authors never
        hand-compute shard sizes.

        ``restart``/``serve`` size the shard set from
        ``cfg.param_count()`` × the parameter dtype width (bfloat16 = 2
        bytes), split into ``ceil(total / shard_bytes)`` shards;
        ``dataloader`` sizes it from a
        :class:`~repro_torch.data.dataset.DatasetSpec` (a default one is
        derived from the config when not given).  The generated shard
        sizes are validated to sum *exactly* to the byte total, and a
        restart workload is additionally checked for full checkpoint
        coverage per site.
        """
        if kind not in ("restart", "serve", "dataloader"):
            raise ValueError(
                f"from_model_config builds restart/serve/dataloader "
                f"workloads, not {kind!r}")
        if kind == "dataloader":
            if dataset is None:
                from ..data.dataset import DatasetSpec
                dataset = DatasetSpec(cfg.name, vocab_size=cfg.vocab_size)
            total = dataset.shard_bytes * dataset.num_shards
            defaults = dict(kind=kind, path=dataset.prefix,
                            total_bytes=total,
                            n_objects=dataset.num_shards, model=cfg.name)
        else:
            width = {"bfloat16": 2, "float16": 2, "float32": 4,
                     "float64": 8, "int8": 1}.get(cfg.dtype)
            if width is None:
                raise ValueError(f"unknown parameter dtype {cfg.dtype!r}")
            total = cfg.param_count() * width
            n_shards = max(1, -(-total // int(shard_bytes)))
            prefix = (f"/ckpt/{cfg.name}/step_00000000" if kind == "restart"
                      else f"/models/{cfg.name}")
            defaults = dict(kind=kind, path=prefix, total_bytes=total,
                            n_objects=n_shards, model=cfg.name)
        defaults.update(overrides)
        spec = cls(**defaults)
        # The invariant the satellite asks for: generated request sizes
        # reconcile against the config's byte totals, exactly.
        sizes = split_bytes(spec.total_bytes, max(spec.n_objects, 1))
        if sum(sizes) != spec.total_bytes:
            raise ValueError(
                f"shard sizes sum to {sum(sizes)}, expected "
                f"{spec.total_bytes}")
        if spec.kind == "restart" and \
                spec.workers_per_site >= spec.tp_degree:
            per_site = sum(sz for p, sz in spec.object_bytes().items()
                           if not p.endswith("manifest.json"))
            if per_site != spec.total_bytes:
                raise ValueError(
                    f"restart workload covers {per_site} bytes per site, "
                    f"expected the full checkpoint ({spec.total_bytes})")
        return spec

    def object_bytes(self) -> Dict[str, int]:
        """Distinct object sizes this workload touches (single-site dry
        run; paths and sizes are site-independent) — what the byte-total
        validation and synthetic publishing reconcile against."""
        out: Dict[str, int] = {}
        for r in self._trace(["probe-site"]):
            out[r.path] = max(out.get(r.path, 0), r.size)
        return out

    def build(self, fed: Federation, method: str = "stash"
              ) -> List[FetchRequest]:
        sites = (list(self.sites) if self.sites
                 else [s.name for s in fed.sites if s.workers > 0])
        trace = self._trace(sites)
        hosts = {s.name: max(1, s.workers) for s in fed.sites}
        return [FetchRequest(path=r.path, site=r.site,
                             worker=r.worker % hosts.get(r.site, 1),
                             method=method, at=r.time, size=r.size,
                             tenant=(self.tenant or r.tenant
                                     or r.experiment))
                for r in trace]

    def _trace(self, sites: Sequence[str]) -> List[AccessRequest]:
        if self.kind == "restart":
            return checkpoint_restart_workload(
                sites, prefix=self.path, total_bytes=self.total_bytes,
                n_shards=max(self.n_objects, 1),
                workers_per_site=self.workers_per_site,
                tp_degree=self.tp_degree, at=self.at, jitter=self.jitter,
                seed=self.seed, manifest_bytes=self.manifest_bytes,
                tenant=self.tenant or "restart")
        if self.kind == "serve":
            return shard_serving_workload(
                sites, prefix=self.path, total_bytes=self.total_bytes,
                n_shards=max(self.n_objects, 1),
                n_requests=self.n_requests, duration=self.duration,
                zipf_a=self.zipf_a, seed=self.seed,
                tenant=self.tenant or "serving")
        if self.kind == "dataloader":
            return dataloader_workload(
                sites, prefix=self.path, total_bytes=self.total_bytes,
                n_shards=max(self.n_objects, 1),
                workers_per_site=self.workers_per_site,
                epochs=max(self.waves, 1), at=self.at,
                step_gap=self.step_gap,
                tenant=self.tenant or "dataloader")
        if self.kind == "storm":
            trace = storm_workload(sites, path=self.path, size=self.size,
                                   at=self.at,
                                   workers_per_site=self.workers_per_site,
                                   jitter=self.jitter, seed=self.seed)
        elif self.kind == "herd":
            trace = herd_workload(sites, path=self.path, size=self.size,
                                  at=self.at,
                                  workers_per_site=self.workers_per_site,
                                  jitter=self.jitter, seed=self.seed,
                                  waves=self.waves, wave_gap=self.wave_gap,
                                  n_objects=self.n_objects,
                                  tenant=self.tenant or "herd")
        elif self.kind == "abusive":
            trace = abusive_workload(sites, self.n_requests,
                                     duration=self.duration, seed=self.seed,
                                     working_set=self.working_set,
                                     zipf_a=self.zipf_a,
                                     tenants=self.tenants,
                                     abusive_tenant=self.abusive_tenant,
                                     abuse_factor=self.abuse_factor,
                                     abuse_at=self.abuse_at,
                                     abuse_duration=self.abuse_duration,
                                     abuse_size=self.size)
        elif self.kind == "flash_crowd":
            hot = (list(self.hot_sites) if self.hot_sites
                   else sites[:1])
            trace = flash_crowd_workload(sites, hot, self.n_requests,
                                         duration=self.duration,
                                         seed=self.seed,
                                         working_set=self.working_set,
                                         zipf_a=self.zipf_a,
                                         crowd_factor=self.crowd_factor,
                                         crowd_at=self.crowd_at,
                                         crowd_duration=self.crowd_duration,
                                         hot_objects=max(self.n_objects, 1),
                                         hot_size=self.size)
        else:
            trace = generate_workload(sites, self.n_requests,
                                      duration=self.duration,
                                      seed=self.seed,
                                      working_set=self.working_set,
                                      zipf_a=self.zipf_a,
                                      tenants=self.tenants)
        return trace


@dataclasses.dataclass(frozen=True)
class ScenarioSpec:
    """One scenario, declaratively: federation + workload + outages +
    solver + engine.  Executed by :func:`run_scenario`; the same spec
    runs on either engine (``engine="sim" | "analytic"``)."""

    name: str
    federation: FederationSpec
    workload: Union[WorkloadSpec, Sequence[FetchRequest],
                    Sequence[AccessRequest]]
    outages: Optional[OutageSchedule] = None
    engine: str = "sim"
    method: str = "stash"            # default for declarative workloads
    sequential: bool = False         # chain requests (no competition)
    solver: str = "auto"
    streams: int = 8
    hedge_after: Optional[float] = None
    max_attempts: int = 4
    rank_limit: Optional[int] = 8
    router: str = "ring"
    # cache-selection policy: "static" (GeoIP order, the vectorizable
    # default) or "probe" (latency-EWMA re-ranking); a RankingPolicy
    # instance is shared across the scenario's clients.
    ranking: Union[str, RankingPolicy, None] = "static"
    control: Optional[ControlPlaneSpec] = None
    # the simulator's device ("cuda", "cpu"; None means cuda); the
    # analytic engine ignores it
    device: Optional[str] = None

    def __post_init__(self) -> None:
        if self.engine not in ("sim", "analytic"):
            raise ValueError(f"unknown engine {self.engine!r}")

    def requests(self, fed: Federation) -> List[FetchRequest]:
        if isinstance(self.workload, WorkloadSpec):
            return self.workload.build(fed, method=self.method)
        hosts = {s.name: max(1, s.workers) for s in fed.sites}
        out: List[FetchRequest] = []
        for r in self.workload:
            if isinstance(r, AccessRequest):
                out.append(FetchRequest(
                    path=r.path, site=r.site,
                    worker=r.worker % hosts.get(r.site, 1),
                    method=self.method, at=r.time, size=r.size,
                    tenant=getattr(r, "tenant", "") or r.experiment))
            else:
                out.append(r)
        return out

    def plane(self, fed: Federation) -> DataPlane:
        if self.engine == "analytic":
            return AnalyticPlane(fed, streams=self.streams,
                                 ranking=self.ranking,
                                 control=self.control)
        return SimulatedPlane(
            fed, solver=self.solver, streams=self.streams,
            hedge_after=self.hedge_after, max_attempts=self.max_attempts,
            rank_limit=self.rank_limit, router=self.router,
            ranking=self.ranking, control=self.control, device=self.device)


def run_scenario(spec: ScenarioSpec,
                 federation: Optional[Federation] = None) -> ScenarioReport:
    """Execute one declarative scenario end to end.

    Builds a fresh federation from the spec (pass ``federation`` to reuse
    one), publishes every workload path that no origin holds yet
    (namespace-routed synthetic objects), executes the workload on the
    chosen engine, and aggregates the report.
    """
    fed = federation if federation is not None else \
        spec.federation.build(spec.device)
    plane = spec.plane(fed)
    reqs = spec.requests(fed)
    sizes: Dict[str, int] = {}
    for r in reqs:
        sizes[r.path] = max(sizes.get(r.path, 0), r.size)
    for path, size in sizes.items():
        # Only requests that *declare* a size get a synthetic object; a
        # sizeless request for an unpublished path must fail visibly
        # (ok=False / FileNotFoundError), not fetch 0 bytes happily.
        if size > 0 and not plane.stat(path).found:
            plane.publish(path, size)
    # Federation counters are lifetime totals; snapshot them so a reused
    # federation (``federation=``) reports only *this* scenario's deltas.
    base = _fed_totals(fed)
    results = plane.fetch_all(reqs, schedule=spec.outages,
                              sequential=spec.sequential)
    rep = _report(spec, fed, plane, results)
    for field, before in base.items():
        cur = getattr(rep, field)
        if isinstance(before, dict):
            setattr(rep, field, {k: cur.get(k, 0) - before.get(k, 0)
                                 for k in sorted(set(cur) | set(before))})
        else:
            setattr(rep, field, cur - before)
    return rep


def _fed_totals(fed: Federation) -> Dict[str, object]:
    """The federation-lifetime counters a ScenarioReport aggregates."""
    gstats = [g.stats for g in fed.groups.values()]
    cstats = [c.stats for c in fed.caches.values()]
    t_hits, t_misses, t_fills, parent_fill = tier_tallies(
        fed.caches.values())
    return {
        "cache_hits": sum(c.hits for c in cstats),
        "cache_misses": sum(c.misses for c in cstats),
        "origin_egress_bytes": sum(o.stats.egress_bytes
                                   for o in fed.origins),
        "parent_fill_bytes": parent_fill,
        "tier_hits": t_hits,
        "tier_misses": t_misses,
        "tier_fill_bytes": t_fills,
        "evictions": sum(c.evictions for c in cstats),
        "bytes_evicted": sum(c.bytes_evicted for c in cstats),
        "admission_rejects": sum(c.admission_rejects for c in cstats),
        "group_failovers": sum(s.failovers for s in gstats),
        "outages": sum(s.outages for s in gstats),
        "recoveries": sum(s.recoveries for s in gstats),
    }


def _report(spec: ScenarioSpec, fed: Federation, plane: DataPlane,
            results: List[FetchResult]) -> ScenarioReport:
    if isinstance(plane, SimulatedPlane):
        return plane.engine.report(results, name=spec.name)
    cstats = [c.stats for c in plane.clients.values()]
    gstats = [g.stats for g in fed.groups.values()]
    cp = plane.control.stats if plane.control is not None else None
    t_hits, t_misses, t_fills, parent_fill = tier_tallies(
        fed.caches.values())
    return ScenarioReport(
        name=spec.name,
        engine=plane.name,
        results=results,
        bytes_moved=sum(r.bytes for r in results),
        cache_hits=sum(c.stats.hits for c in fed.caches.values()),
        cache_misses=sum(c.stats.misses for c in fed.caches.values()),
        origin_egress_bytes=sum(o.stats.egress_bytes for o in fed.origins),
        parent_fill_bytes=parent_fill,
        tier_hits=t_hits, tier_misses=t_misses, tier_fill_bytes=t_fills,
        evictions=sum(c.stats.evictions for c in fed.caches.values()),
        bytes_evicted=sum(c.stats.bytes_evicted
                          for c in fed.caches.values()),
        admission_rejects=sum(c.stats.admission_rejects
                              for c in fed.caches.values()),
        cache_failovers=sum(s.cache_failovers for s in cstats),
        hedged_fetches=sum(s.hedged_fetches for s in cstats),
        origin_fallbacks=sum(s.origin_fallbacks for s in cstats),
        group_failovers=sum(s.failovers for s in gstats),
        outages=sum(s.outages for s in gstats),
        recoveries=sum(s.recoveries for s in gstats),
        sheds=sum(1 for r in results if getattr(r, "shed", False)),
        queue_waits=cp.queue_waits if cp else 0,
        queue_wait_seconds=cp.queue_wait_seconds if cp else 0.0,
        retries=cp.retries if cp else 0,
        breaker_opens=cp.breaker_opens if cp else 0,
        breaker_skips=cp.breaker_skips if cp else 0,
        auto_downs=cp.auto_downs if cp else 0,
        auto_ups=cp.auto_ups if cp else 0,
    )



# ---------------------------------------------------------------------------
# Batched scenario sweeps
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class SweepSpec:
    """A ScenarioSpec template crossed with parameter axes.

    ``axes`` maps an axis name to its values; the sweep is the full
    cross product in axis order (last axis fastest).  Axis names route
    to the template:

    * ``"workload.<field>"`` — a :class:`WorkloadSpec` field
      (``zipf_a``, ``working_set``, ``n_requests``, ``seed``, ...);
    * ``"federation.<field>"`` — a :class:`~repro_torch.core.federation.
      FederationSpec` field, or a :class:`~repro_torch.core.federation.
      SiteSpec` field (``cache_replicas``, ``cache_capacity``,
      ``eviction_policy``, ``workers``, ...) applied to every matching
      site;
    * ``"outage_rate"`` — synthetic axis: that fraction of the
      federation's caches cold-restarts mid-run (a
      :meth:`~repro_torch.core.simclient.OutageSchedule.restart_storm` at
      half the workload horizon, down for a quarter of it);
    * any other name — a :class:`ScenarioSpec` field (``engine``,
      ``method``, ``streams``, ``router``, ...).

    The spec is inert data, like :class:`ScenarioSpec`: the same sweep
    runs batched (:func:`run_sweep`) or serially (one
    :func:`run_scenario` per cell), which is what the parity tests
    compare.
    """

    name: str
    base: ScenarioSpec
    axes: Dict[str, Sequence] = dataclasses.field(default_factory=dict)

    def __len__(self) -> int:
        n = 1
        for vals in self.axes.values():
            n *= len(vals)
        return n

    def cells(self) -> List[Tuple[Dict[str, object], ScenarioSpec]]:
        """Materialize every cell: ``(params, scenario)`` pairs in
        cross-product order."""
        names = list(self.axes)
        out: List[Tuple[Dict[str, object], ScenarioSpec]] = []
        for combo in itertools.product(*(self.axes[n] for n in names)):
            params = dict(zip(names, combo))
            spec = self.base
            outage_rate = 0.0
            for axis, value in params.items():
                if axis == "outage_rate":
                    outage_rate = float(value)
                else:
                    spec = _apply_axis(spec, axis, value)
            if outage_rate > 0.0:
                storm = _outage_storm_for(spec, outage_rate)
                outages = (spec.outages.merge(storm)
                           if spec.outages is not None else storm)
                spec = dataclasses.replace(spec, outages=outages)
            tag = ",".join(f"{k}={v}" for k, v in params.items())
            spec = dataclasses.replace(
                spec, name=f"{self.name}/{tag}" if tag else self.name)
            out.append((params, spec))
        return out


_SCENARIO_FIELDS = {f.name for f in dataclasses.fields(ScenarioSpec)}


def _apply_axis(spec: ScenarioSpec, axis: str, value) -> ScenarioSpec:
    if axis.startswith("workload."):
        field = axis[len("workload."):]
        if not isinstance(spec.workload, WorkloadSpec):
            raise ValueError(f"axis {axis!r} needs a WorkloadSpec workload")
        if field not in {f.name for f in dataclasses.fields(WorkloadSpec)}:
            raise ValueError(f"unknown workload axis {axis!r}")
        return dataclasses.replace(
            spec, workload=dataclasses.replace(spec.workload,
                                               **{field: value}))
    if axis.startswith("federation."):
        field = axis[len("federation."):]
        fed = spec.federation
        fed_fields = {f.name for f in dataclasses.fields(FederationSpec)}
        site_fields = {f.name for f in dataclasses.fields(SiteSpec)}
        if field in fed_fields and field != "sites":
            return dataclasses.replace(
                spec, federation=dataclasses.replace(fed, **{field: value}))
        m = re.fullmatch(r"tier(\d+)\.(\w+)", field)
        if m:
            # "federation.tier<k>.<field>" — a site knob applied only to
            # the cache-bearing sites at hierarchy depth k (1 = edge),
            # which is what an L1 × L2 split-sizing sweep crosses.
            depth, sub = int(m.group(1)), m.group(2)
            if sub not in site_fields or sub in ("name", "parent"):
                raise ValueError(f"unknown federation axis {axis!r}")
            tiers = fed.site_tiers()
            if depth not in set(tiers.values()):
                raise ValueError(
                    f"axis {axis!r}: federation has no tier-{depth} sites")
            sites = [dataclasses.replace(s, **{sub: value})
                     if tiers.get(s.name) == depth else s
                     for s in fed.sites]
            return dataclasses.replace(
                spec, federation=dataclasses.replace(fed, sites=sites))
        if field not in site_fields or field == "name":
            # "name" would rename every site identically — reject it
            # like any other unsweepable axis rather than no-op.
            raise ValueError(f"unknown federation axis {axis!r}")
        # Site-level knob: apply to every site the field is meaningful
        # for (cache knobs to cache-bearing sites, workers to
        # worker-bearing ones), leaving pure-storage sites intact.
        cache_knobs = field not in ("workers", "profile")
        sites = [dataclasses.replace(s, **{field: value})
                 if (s.has_cache if cache_knobs else s.workers > 0)
                 else s
                 for s in fed.sites]
        return dataclasses.replace(
            spec, federation=dataclasses.replace(fed, sites=sites))
    if axis in _SCENARIO_FIELDS and axis not in ("name", "federation",
                                                 "workload", "outages"):
        return dataclasses.replace(spec, **{axis: value})
    raise ValueError(f"unknown sweep axis {axis!r}")


def _workload_horizon(workload) -> float:
    if isinstance(workload, WorkloadSpec):
        if workload.kind in ("zipf", "abusive", "flash_crowd", "serve"):
            return workload.duration
        if workload.kind == "dataloader":
            shards_per_worker = -(-max(workload.n_objects, 1)
                                  // max(workload.workers_per_site, 1))
            return (workload.at + max(workload.waves, 1)
                    * shards_per_worker * workload.step_gap + 60.0)
        return workload.at + workload.jitter + 60.0
    times = [r.at if isinstance(r, FetchRequest) else r.time
             for r in workload]
    return (max(times) if times else 0.0) + 60.0


def _outage_storm_for(spec: ScenarioSpec, rate: float) -> OutageSchedule:
    caches = spec.federation.cache_names()
    k = min(len(caches), max(1, math.ceil(rate * len(caches))))
    horizon = _workload_horizon(spec.workload)
    return OutageSchedule.restart_storm(
        caches[:k], at=0.5 * horizon, downtime=0.25 * horizon,
        stagger=0.0, cold=True)


@dataclasses.dataclass
class SweepCell:
    """One executed sweep cell: its parameter point, how it ran, and the
    :meth:`~repro_torch.core.simclient.ScenarioReport.summary` gauges (exactly
    what a serial :func:`run_scenario` of the same cell reports — the
    parity tests hold the two equal).  ``pricing`` carries the batched
    max-min gauges for cells priced by the vmapped waterfill."""

    params: Dict[str, object]
    name: str
    engine: str
    executor: str                     # "batched" | "serial"
    summary: Dict[str, object]
    pricing: Dict[str, float] = dataclasses.field(default_factory=dict)
    # ``fit=`` mode products (batched cells only; None otherwise).
    # These ride on the cell, *not* inside ``summary``, so the
    # batched-vs-serial parity comparisons stay byte-exact.
    reuse_histogram: Optional[Dict[str, Dict]] = None   # cache -> buckets
    models: Optional[Dict[str, object]] = None          # cache -> CacheModel


@dataclasses.dataclass
class SweepReport:
    """What :func:`run_sweep` produced: every cell plus execution
    telemetry (how many cells took the vectorized path, how many jitted
    waterfill calls priced the whole sweep)."""

    name: str
    axes: Dict[str, List]
    cells: List[SweepCell]
    wall_seconds: float = 0.0
    batched_cells: int = 0
    serial_cells: int = 0
    solver: Dict[str, object] = dataclasses.field(default_factory=dict)

    def cell(self, **params) -> SweepCell:
        for c in self.cells:
            if all(c.params.get(k) == v for k, v in params.items()):
                return c
        raise KeyError(f"no cell matches {params!r}")

    def marginal(self, axis: str, metric: str) -> List[Tuple[object, float]]:
        """Mean of ``metric`` per value of ``axis`` (cross-cell
        aggregate, in axis-value order)."""
        agg: Dict[object, List[float]] = {}
        for c in self.cells:
            agg.setdefault(c.params.get(axis), []).append(
                float(c.summary.get(metric, 0.0)))
        return [(v, sum(agg[v]) / len(agg[v]))
                for v in self.axes.get(axis, sorted(agg))]

    def fitted_models(self, **params) -> Dict[str, object]:
        """Per-cache fitted :class:`~repro_torch.kernels.cache_model.
        CacheModel` objects from a ``fit=`` sweep — the cell matching
        ``params``, else the first cell that carries models (cells of
        one routing column share one model dict)."""
        if params:
            return self.cell(**params).models or {}
        for c in self.cells:
            if c.models:
                return c.models
        return {}

    def reuse_histograms(self, **params) -> Dict[str, Dict]:
        """Per-cache reuse-distance histograms (JSON-safe bucket dicts)
        from a ``fit=`` sweep, resolved like :meth:`fitted_models`."""
        if params:
            return self.cell(**params).reuse_histogram or {}
        for c in self.cells:
            if c.reuse_histogram:
                return c.reuse_histogram
        return {}

    def summary(self) -> Dict:
        return {
            "name": self.name,
            "cells": len(self.cells),
            "axes": {k: list(v) for k, v in self.axes.items()},
            "wall_seconds": self.wall_seconds,
            "batched_cells": self.batched_cells,
            "serial_cells": self.serial_cells,
            "fitted_cells": sum(1 for c in self.cells if c.models),
            "solver": dict(self.solver),
        }


def _sweep_batchable(spec: ScenarioSpec) -> bool:
    """Static eligibility for the vectorized analytic executor.

    Evicting caches are *in* the regime: LRU cells resolve through the
    stack-distance kernel, FIFO and size-aware-admission cells through
    the vectorized cache state machine (both in
    :mod:`repro_torch.kernels.stack_distance`).  Only victim orders the
    kernels don't model (LFU frequency buckets, TTL expiry against the
    accounted clock) still fall back to a serial :func:`run_scenario`.
    """
    if spec.engine != "analytic":
        return False
    if spec.control is not None:
        # Control-plane cells carry cross-request queue/breaker state the
        # vectorized kernels don't model; they run serially (and the
        # sweep counts them in ``serial_cells``).
        return False
    if spec.method not in ("stash", "direct"):
        return False
    if spec.ranking not in (None, "static"):
        # probe ranking re-orders chains from observed latency — the
        # cross-request state the shared routing table can't carry
        return False
    if spec.outages is not None and any(
            getattr(ev, "kind", "cache") != "cache" for ev in spec.outages):
        # link degradation changes bandwidth mid-run; the batched
        # executor precomputes its timing constants once per column
        return False
    if not isinstance(spec.workload, WorkloadSpec):
        for r in spec.workload:
            if isinstance(r, FetchRequest) and (
                    r.method not in ("stash", "direct")
                    or r.offset or r.length >= 0 or r.avoid):
                # ranged / cache-avoiding requests move partial objects
                # the whole-object kernels don't model
                return False
    for s in spec.federation.sites:
        if s.has_cache and s.eviction_policy not in ("lru", "fifo"):
            return False
    if spec.federation.tier_depth() > 2:
        # the two-round executor derives exactly one parent stream per
        # fill target; deeper hierarchies replay serially
        return False
    return True


# The per-site knobs that select cache *policy* rather than routing:
# ranked chains, GeoIP order and ring ownership never read them, so
# cells differing only here share one pristine federation, one routing
# table and one set of per-cache request streams.
_POLICY_KNOBS = ("cache_capacity", "eviction_policy", "ttl_seconds",
                 "admission_max_fraction")
_SITE_KNOB_DEFAULTS = {f.name: f.default
                       for f in dataclasses.fields(SiteSpec)
                       if f.name in _POLICY_KNOBS}


def _routing_fedspec(fed: FederationSpec) -> FederationSpec:
    """``fed`` with every cache-bearing site's policy knobs canonicalized
    — the sharing key for federations, routing tables and streams."""
    sites = [dataclasses.replace(s, **_SITE_KNOB_DEFAULTS)
             if s.has_cache else s for s in fed.sites]
    return dataclasses.replace(fed, sites=sites)


def _cache_knobs(fed: FederationSpec) -> Dict[str, Tuple[float, str, float]]:
    """Per cache-server name: ``(capacity_bytes, policy, admission
    fraction)`` — the cell-specific half the shared federation lacks."""
    out: Dict[str, Tuple[float, str, float]] = {}
    for s in fed.sites:
        for name in s.cache_names():
            out[name] = (float(s.cache_capacity), s.eviction_policy,
                         float(s.admission_max_fraction))
    return out


class _SharedFederations:
    """Pristine federations shared across same-spec sweep cells.

    The vectorized executor never publishes objects or mutates cache
    storage, so every cell with an equal *routing-normalized*
    :class:`FederationSpec` (policy knobs canonicalized — see
    :func:`_routing_fedspec`) can route against one built federation —
    and share its liveness-independent ``(site, path) -> ranked cache
    names`` table, which is the expensive part of analytic routing."""

    def __init__(self) -> None:
        self._entries: List[Tuple[FederationSpec, Federation, Dict]] = []

    def get(self, spec: FederationSpec) -> Tuple[Federation, Dict]:
        for known, fed, routes in self._entries:
            if known == spec:
                return fed, routes
        fed = spec.build()
        state: Dict = {"routes": {}, "clients": {}, "cells": []}
        self._entries.append((spec, fed, state))
        return fed, state

    def __len__(self) -> int:
        return len(self._entries)


def _ranked_names(fed: Federation, state: Dict, site: str,
                  path: str) -> List[str]:
    key = (site, path)
    chain = state["routes"].get(key)
    if chain is None:
        client = state["clients"].get(site)
        if client is None:
            client = state["clients"][site] = fed.client(site, 0)
        chain = [c.name for c in client._ranked_caches(path=path)]
        state["routes"][key] = chain
    return chain


def _worker_node(fed: Federation, site: str, worker: int) -> str:
    """Ensure the worker node exists (mirrors ``Federation.client``
    without paying for a StashClient)."""
    name = f"{site}/worker{worker}"
    if name not in fed.topology.nodes:
        prof = fed.topology.profile(site)
        fed.topology.add_node(name, Coord(site, rack=0, host=worker),
                              prof.worker_nic)
    return name


class _CacheStream:
    """One cache server's chunk reference stream for one routing cell —
    everything a hit/miss kernel needs, all of it capacity- and
    policy-independent (eviction never feeds back into routing: a cache
    with nothing resident still *serves*, it just pulls first)."""

    __slots__ = ("req", "size", "prev", "reset", "seg", "eff_obj",
                 "miss_sec", "keys", "n_keys", "key_sizes",
                 "total_key_bytes", "eff_const", "variants",
                 "parent_ci", "fill_sec", "l2_sec", "l2_eff", "l2_seg",
                 "gpos", "pj", "is_fill")

    def __init__(self) -> None:
        self.req: List[int] = []       # request index per reference
        self.keys: List[int] = []      # stream-local (path, chunk) key id
        self.size: List[int] = []      # chunk bytes per reference
        self.prev: List[int] = []      # previous same-key ref (same
        #                                cold-restart segment), else -1
        self.reset: List[bool] = []    # cold restart before this ref
        self.seg: List[int] = []       # cold-restart segment per ref
        self.eff_obj: List[int] = []   # object size admission sees (the
        #                                chunk itself until the serving
        #                                cache has located the meta)
        self.miss_sec: List[float] = []  # redirector RPC + origin pull
        self.key_sizes: List[int] = []
        # tier-fill lane, per reference (all liveness-resolved, so they
        # are cell-policy-independent like everything else here):
        self.parent_ci: List[int] = []   # epoch-alive parent cache (-1:
        #                                  top tier / parent tier dead)
        self.fill_sec: List[float] = []  # parent -> this cache transfer
        self.l2_sec: List[float] = []    # parent's own origin-miss cost
        self.l2_eff: List[int] = []      # admission basis at the parent
        self.l2_seg: List[int] = []      # parent cold-restart segment
        self.gpos: List[int] = []        # global arrival position (the
        #                                  merge order for parent streams)
        self.pj: List[int] = []          # federation-global chunk id
        self.is_fill = None              # merged parent streams only
        # stack-distance variants, keyed by admitted-key signature: the
        # stream with one admission filter class applied (refused keys
        # dropped — they never enter the stack), with byte distances
        # and segment-end residency.  Shared by every cell whose
        # (fraction × capacity) threshold induces the same filter.
        self.variants: Dict[bytes, Dict[str, np.ndarray]] = {}

    def arrays(self) -> None:
        self.req = np.asarray(self.req, np.int64)
        self.keys = np.asarray(self.keys, np.int32)
        self.size = np.asarray(self.size, np.int64)
        self.prev = np.asarray(self.prev, np.int64)
        self.reset = np.asarray(self.reset, bool)
        self.seg = np.asarray(self.seg, np.int64)
        self.eff_obj = np.asarray(self.eff_obj, np.int64)
        self.miss_sec = np.asarray(self.miss_sec, np.float64)
        self.key_sizes = np.asarray(self.key_sizes, np.int64)
        self.parent_ci = np.asarray(self.parent_ci, np.int64)
        self.fill_sec = np.asarray(self.fill_sec, np.float64)
        self.l2_sec = np.asarray(self.l2_sec, np.float64)
        self.l2_eff = np.asarray(self.l2_eff, np.int64)
        self.l2_seg = np.asarray(self.l2_seg, np.int64)
        self.gpos = np.asarray(self.gpos, np.int64)
        self.pj = np.asarray(self.pj, np.int64)
        self.n_keys = len(self.key_sizes)
        # conservative residency bound: a capacity at or above the whole
        # distinct-key working set can never evict — those cells answer
        # hit/miss by compulsory-miss logic alone, no kernel involved
        self.total_key_bytes = int(self.key_sizes.sum())
        # is the admission-relevant object size constant per key?  (It
        # is, unless an outage made a non-head cache serve before the
        # meta was located.)  Constant → a size-aware filter refuses a
        # key always-or-never, which is what the filtered stack model
        # needs; varying → the slot state machine.
        if self.n_keys:
            lo = np.full(self.n_keys, np.iinfo(np.int64).max, np.int64)
            hi = np.zeros(self.n_keys, np.int64)
            np.minimum.at(lo, self.keys, self.eff_obj)
            np.maximum.at(hi, self.keys, self.eff_obj)
            self.eff_const = bool((lo[self.keys] == hi[self.keys]).all())
        else:
            self.eff_const = True


class _CellRouting:
    """The cell-policy-independent product of the vectorized executor:
    routing, liveness epochs, timing constants and per-cache reference
    streams (with stack distances precomputed).  Shared by every sweep
    cell that differs only in cache capacity / eviction policy /
    admission — the axes the hit/miss kernels resolve per cell."""


def _cell_routing(spec: ScenarioSpec, fed: Federation, state: Dict,
                  telemetry: Dict) -> Optional[_CellRouting]:
    """Route one analytic cell without touching cache policy: numpy
    epoch accounting over liveness-independent ranked chains, exactly as
    a serial :func:`run_scenario` would resolve it.

    Returns ``None`` when the cell leaves the vectorizable regime
    (unresolvable namespace — the serial path raises ``KeyError``),
    in which case the caller falls back to the serial executor.
    """
    reqs = spec.requests(fed)
    n = len(reqs)
    default_site = next((s.name for s in fed.sites if s.workers > 0),
                        fed.sites[0].name)

    # ---- request arrays (original order) -----------------------------------
    path_ids: Dict[str, int] = {}
    sizes: List[int] = []
    pid = np.empty(n, np.int64)
    at = np.empty(n, np.float64)
    sites: List[str] = []
    workers = np.empty(n, np.int64)
    methods: List[str] = []
    streams = np.empty(n, np.int64)
    for i, r in enumerate(reqs):
        p = path_ids.setdefault(r.path, len(path_ids))
        if p == len(sizes):
            sizes.append(0)
        sizes[p] = max(sizes[p], r.size)
        pid[i] = p
        at[i] = r.at
        sites.append(r.site or default_site)
        workers[i] = r.worker
        methods.append(r.method)
        streams[i] = r.streams or spec.streams
    P = len(path_ids)
    paths = list(path_ids)
    size = np.asarray(sizes, np.int64)
    found = size > 0

    owners: List[Optional[object]] = []
    for p in range(P):
        owner = fed.resolve_origin(paths[p])
        if owner is None and found[p]:
            return None  # serial run_scenario raises KeyError here
        owners.append(owner)
    # chunk count per path, from the owning origin's chunking (what a
    # serial run_scenario's publish would have produced)
    nchunks = np.asarray(
        [-(-size[p] // owners[p].chunk_size) if found[p] else 1
         for p in range(P)], np.int64)

    site_ids: Dict[str, int] = {}
    sid = np.asarray([site_ids.setdefault(s, len(site_ids)) for s in sites])
    site_names = list(site_ids)
    method_is_direct = np.asarray([m == "direct" for m in methods])

    # ---- routing (liveness-independent chains, shared across cells) --------
    cache_ids = {name: ci for ci, name in enumerate(fed.caches)}
    chains: Dict[Tuple[int, int], List[int]] = {}
    for si, pi in {(int(s), int(p))
                   for s, p, d in zip(sid, pid, method_is_direct) if not d}:
        names = _ranked_names(fed, state, site_names[si], paths[pi])
        chains[(si, pi)] = [cache_ids[nm] for nm in names]
    group_of = {c.name: g for g in fed.groups.values() for c in g.members}
    # primary cache (nearest group's ring owner) per chain — the one
    # whose liveness decides a counted group failover.
    primary: Dict[Tuple[int, int], int] = {}
    cache_names = list(fed.caches)
    for key, chain in chains.items():
        prim = -1
        for ci in chain:
            if cache_names[ci] in group_of:
                prim = ci
                break
        primary[key] = prim if prim >= 0 else (chain[0] if chain else -1)

    # ---- network constants (per site / cache / owner) ----------------------
    net, topo = fed.net, fed.topology
    wnode: Dict[Tuple[int, int], str] = {}
    for si, w in {(int(s), int(w)) for s, w in zip(sid, workers)}:
        wnode[(si, w)] = _worker_node(fed, site_names[si], w)

    # ---- chronological epochs between outage events ------------------------
    order = np.argsort(at, kind="stable")
    op = np.empty(n, np.int64)               # arrival rank per request
    op[order] = np.arange(n)
    events = list(spec.outages) if spec.outages is not None else []
    for ev in events:
        if ev.cache not in group_of and ev.cache not in fed.caches:
            raise KeyError(ev.cache)  # same failure as the serial plane
    alive = np.ones(len(cache_ids), bool)
    was_counted = {"outages": 0, "recoveries": 0}
    # cold-restart positions per cache, as arrival ranks: requests with
    # op >= the recorded rank see that cache's disk wiped
    resets: Dict[int, List[int]] = {}
    processed = 0

    chosen = np.full(n, -1, np.int64)        # serving cache (-1: none)
    parent_of = np.full(n, -1, np.int64)     # epoch-alive fill parent
    dead_before = np.zeros(n, np.int64)
    primary_dead = np.zeros(n, bool)
    fallback = np.zeros(n, bool)
    ok = np.ones(n, bool)

    caches = list(fed.caches.values())
    pchains: Dict[Tuple[int, int], List[int]] = {}

    def _parent_chain(serve_ci: int, pi: int) -> Sequence[int]:
        """The serving cache's parent-tier fill chain for one path —
        consistent-hash order, liveness-independent (aliveness is the
        per-epoch filter, exactly as ``CacheServer.parent_caches``)."""
        pg = caches[serve_ci].parent_group
        if pg is None:
            return ()
        key = (id(pg), pi)
        chain = pchains.get(key)
        if chain is None:
            chain = pchains[key] = [cache_ids[c.name]
                                    for c in pg.fill_chain(paths[pi])]
        return chain

    def apply_event(ev) -> None:
        ci = cache_ids[ev.cache]
        if ev.action == "down":
            if alive[ci]:
                alive[ci] = False
                if ev.cache in group_of:
                    was_counted["outages"] += 1
        else:
            if not alive[ci]:
                alive[ci] = True
                if ev.cache in group_of:
                    was_counted["recoveries"] += 1
                if ev.cold:
                    resets.setdefault(ci, []).append(processed)

    def run_epoch(idx: np.ndarray) -> None:
        """Vectorized routing for one liveness epoch (``idx`` are
        request indices in arrival order).  Hit/miss is *not* resolved
        here — that is the kernels' job, per cell — only which cache
        serves whom."""
        if idx.size == 0:
            return
        allstash = idx[~method_is_direct[idx]]
        stash = allstash[found[pid[allstash]]]
        # liveness-resolved serving cache per (site, path) this epoch
        for key, chain in chains.items():
            si, pi = key
            sel = allstash[(sid[allstash] == si) & (pid[allstash] == pi)]
            if sel.size == 0:
                continue
            # every stash request — found or not — walks the ranked
            # chain, so a dead ring owner counts its group failovers
            primary_dead[sel] = (primary[key] >= 0
                                 and not alive[primary[key]])
            fsel = sel[found[pid[sel]]]
            if fsel.size == 0:
                continue
            serve, dead = -1, 0
            for ci in chain:
                if alive[ci]:
                    serve = ci
                    break
                dead += 1
            chosen[fsel] = serve
            dead_before[fsel] = dead
            if serve >= 0:
                par = -1
                for qi in _parent_chain(serve, pi):
                    if alive[qi] and qi != serve:
                        par = qi
                        break
                parent_of[fsel] = par
        fallback[stash] = chosen[stash] < 0
        # not-found stash requests fail visibly, as on the serial plane
        nf = idx[~method_is_direct[idx] & ~found[pid[idx]]]
        ok[nf] = False
        direct = idx[method_is_direct[idx]]
        ok[direct] = found[pid[direct]]

    ei = 0
    pending: List[int] = []
    for i in order:
        while ei < len(events) and events[ei].time <= at[i]:
            run_epoch(np.asarray(pending, np.int64))
            processed += len(pending)
            pending = []
            apply_event(events[ei])
            ei += 1
        pending.append(int(i))
    run_epoch(np.asarray(pending, np.int64))
    processed += len(pending)
    while ei < len(events):
        apply_event(events[ei])
        ei += 1
    served_mask = chosen >= 0

    # ---- when does each cache learn an object's size? ----------------------
    # Admission sees the whole object only once the serving cache has
    # the meta cached — and only the liveness-independent chain *head*
    # is ever asked to locate it (``StashClient._meta`` returns at the
    # first non-None ``locate_meta``).  So a non-head cache serving
    # under an outage judges admission by the chunk payload until some
    # request whose chain it heads has touched the path.
    meta_rank: Dict[Tuple[int, int], int] = {}
    for i in range(n):
        if method_is_direct[i] or not found[pid[i]]:
            continue
        chain = chains.get((int(sid[i]), int(pid[i])))
        if chain:
            key = (chain[0], int(pid[i]))
            r = meta_rank.get(key)
            if r is None or op[i] < r:
                meta_rank[key] = int(op[i])

    # ---- timing constants + per-cache chunk reference streams --------------
    lookup = fed.geoip.lookup_latency
    bw_serve: Dict[Tuple[int, int], float] = {}
    rtt_serve: Dict[Tuple[int, int], float] = {}
    rpc_red: Dict[int, float] = {}
    bw_pull: Dict[Tuple[int, int], float] = {}
    rtt_pull: Dict[Tuple[int, int], float] = {}
    bw_fill: Dict[Tuple[int, int], float] = {}
    rtt_fill: Dict[Tuple[int, int], float] = {}
    red_node = fed.redirectors.members[0].node.name
    nreq = nchunks[pid]
    serve_base = np.zeros(n, np.float64)   # hit-path seconds per request
    streams_by_cache: Dict[int, _CacheStream] = {}
    key_ids: Dict[int, Dict[Tuple[int, int], int]] = {}
    last_ref: Dict[int, Dict[int, Tuple[int, int]]] = {}
    last_seg: Dict[int, int] = {}
    Cmax = int(nchunks.max()) if P else 1
    gpos = 0

    def _chunk_len(p: int, j: int) -> int:
        cs = owners[p].chunk_size
        return int(min(cs, size[p] - j * cs)) if size[p] else 0

    for i in order:
        if chosen[i] < 0:
            continue
        i, ci, p = int(i), int(chosen[i]), int(pid[i])
        si = int(sid[i])
        wn = wnode[(si, int(workers[i]))]
        cnode = caches[ci].node.name
        k = (ci, si)
        if k not in bw_serve:
            bw_serve[k] = net.effective_bandwidth(cnode, wn, streams=8)
            rtt_serve[k] = topo.rtt(cnode, wn)
        pk = (ci, p)
        if pk not in bw_pull:
            onode = owners[p].node.name
            bw_pull[pk] = net.effective_bandwidth(onode, cnode, streams=8)
            rtt_pull[pk] = topo.rtt(onode, cnode)
            if ci not in rpc_red:
                rpc_red[ci] = net.rpc_time(cnode, red_node)
        q = int(parent_of[i])
        if q >= 0:
            # miss fills cache-to-cache: parent -> this cache transfer,
            # plus the parent's own redirector RPC + origin pull if the
            # parent misses too (resolved by the round-2 kernels)
            pnode = caches[q].node.name
            fk = (q, ci)
            if fk not in bw_fill:
                bw_fill[fk] = net.effective_bandwidth(pnode, cnode,
                                                      streams=8)
                rtt_fill[fk] = topo.rtt(pnode, cnode)
            qk = (q, p)
            if qk not in bw_pull:
                onode = owners[p].node.name
                bw_pull[qk] = net.effective_bandwidth(onode, pnode,
                                                      streams=8)
                rtt_pull[qk] = topo.rtt(onode, pnode)
            if q not in rpc_red:
                rpc_red[q] = net.rpc_time(pnode, red_node)
            l2_base = rpc_red[q] + rtt_pull[qk]
            qcuts = resets.get(q, ())
            qseg = sum(1 for c in qcuts if c <= op[i])
        stream = streams_by_cache.get(ci)
        if stream is None:
            stream = streams_by_cache[ci] = _CacheStream()
            key_ids[ci] = {}
            last_ref[ci] = {}
            last_seg[ci] = 0
        cuts = resets.get(ci, ())
        seg = sum(1 for c in cuts if c <= op[i])
        fresh_seg = seg != last_seg[ci] and len(stream.req) > 0
        last_seg[ci] = seg
        known = meta_rank.get((ci, p), n + 1) <= op[i]
        # the *parent's* admission basis: the child forwards its located
        # object size upstream; failing that the parent falls back to
        # its own meta knowledge, then the chunk payload
        l2_known = known or (q >= 0
                             and meta_rank.get((q, p), n + 1) <= op[i])
        secs = lookup + nreq[i] * rtt_serve[k]
        miss_base = rpc_red[ci] + rtt_pull[pk]
        for j in range(int(nchunks[p])):
            csize = _chunk_len(p, j)
            kid = key_ids[ci].setdefault((p, j), len(key_ids[ci]))
            if kid == len(stream.key_sizes):
                stream.key_sizes.append(csize)
            prev_entry = last_ref[ci].get(kid)
            prev = (prev_entry[0] if prev_entry is not None
                    and prev_entry[1] == seg else -1)
            last_ref[ci][kid] = (len(stream.req), seg)
            basis = int(size[p]) if known else csize
            cap = caches[ci].serve_rate_cap(basis)
            secs += csize / (min(bw_serve[k], cap) if cap else bw_serve[k])
            stream.req.append(i)
            stream.keys.append(kid)
            stream.size.append(csize)
            stream.prev.append(prev)
            stream.reset.append(fresh_seg and j == 0)
            stream.seg.append(seg)
            stream.eff_obj.append(int(size[p]) if known else csize)
            stream.miss_sec.append(miss_base + csize / bw_pull[pk])
            stream.parent_ci.append(q)
            stream.gpos.append(gpos)
            stream.pj.append(p * Cmax + j)
            if q >= 0:
                stream.fill_sec.append(rtt_fill[fk] + csize / bw_fill[fk])
                stream.l2_sec.append(l2_base + csize / bw_pull[qk])
                stream.l2_eff.append(int(size[p]) if l2_known else csize)
                stream.l2_seg.append(qseg)
            else:
                stream.fill_sec.append(0.0)
                stream.l2_sec.append(0.0)
                stream.l2_eff.append(csize)
                stream.l2_seg.append(0)
            gpos += 1
        serve_base[i] = secs

    direct_like = ok & (fallback | method_is_direct)
    direct_sec = np.zeros(n, np.float64)
    for i in np.nonzero(direct_like)[0]:
        onode = owners[pid[i]].node.name
        wn = wnode[(int(sid[i]), int(workers[i]))]
        direct_sec[i] = net.transfer_time(onode, wn, int(size[pid[i]]),
                                          streams=int(streams[i]))

    for stream in streams_by_cache.values():
        stream.arrays()
    # The distance/replay scans are O(N) per reference (O(N²) per
    # stream); surface the longest stream so a sweep that drifts into
    # that regime is diagnosable from report.solver.
    if streams_by_cache:
        telemetry["max_stream_refs"] = max(
            telemetry.get("max_stream_refs", 0),
            max(len(s.req) for s in streams_by_cache.values()))

    # ---- cell-independent counters and flow constants ----------------------
    cache_failovers = int((nreq[served_mask] * dead_before[served_mask])
                          .sum())
    ranked_len = np.asarray([len(chains.get((int(s), int(p)), []))
                             for s, p in zip(sid, pid)])
    cache_failovers += int(2 * ranked_len[fallback].sum())
    # ranked-cache calls per request: n+2 (served), 6 (fallback: two
    # method attempts of meta+monitor+chunk0), 2 (not found: meta per
    # method) — each counting one group failover iff the nearest ring
    # owner is dead.
    stash_mask = ~method_is_direct
    calls = np.zeros(n, np.int64)
    calls[served_mask] = nreq[served_mask] + 2
    calls[fallback] = 6
    calls[stash_mask & ~ok] = 2

    serve_flow: Dict[int, Tuple[List, float]] = {}
    pull_flow: Dict[Tuple[int, int], Tuple[List, float]] = {}
    for i in range(n):
        if not ok[i]:
            continue
        p = int(pid[i])
        wn = wnode[(int(sid[i]), int(workers[i]))]
        if method_is_direct[i] or fallback[i]:
            src = owners[p].node.name
            links = topo.path(src, wn)
            cap_f = max(1, int(streams[i])) * net.per_stream_cap(
                topo.rtt(src, wn))
        else:
            ci = int(chosen[i])
            cnode = caches[ci].node.name
            q = int(parent_of[i])
            if q >= 0:
                # tiered miss path: child pulls from its parent, the
                # parent (on its own miss) pulls from the origin
                pnode = caches[q].node.name
                if (ci, p) not in pull_flow:
                    pull_flow[(ci, p)] = (
                        topo.path(pnode, cnode),
                        4 * net.per_stream_cap(topo.rtt(pnode, cnode)))
                if (q, p) not in pull_flow:
                    onode = owners[p].node.name
                    pull_flow[(q, p)] = (
                        topo.path(onode, pnode),
                        4 * net.per_stream_cap(topo.rtt(onode, pnode)))
            elif (ci, p) not in pull_flow:
                onode = owners[p].node.name
                pull_flow[(ci, p)] = (
                    topo.path(onode, cnode),
                    4 * net.per_stream_cap(topo.rtt(onode, cnode)))
            links = topo.path(cnode, wn)
            cap_f = max(1, spec.streams) * net.per_stream_cap(
                topo.rtt(cnode, wn))
            rc = caches[ci].serve_rate_cap(int(size[p]))
            if rc:
                cap_f = min(cap_f, rc)
        serve_flow[i] = (links, cap_f)

    fill_targets: Set[int] = set()
    for s in streams_by_cache.values():
        fill_targets.update(int(x) for x in np.unique(s.parent_ci)
                            if x >= 0)
    for q in fill_targets:
        sq = streams_by_cache.get(q)
        if sq is not None and (sq.parent_ci >= 0).any():
            # a fill target that itself fills upstream needs a third
            # kernel round; replay such cells serially
            return None

    routing = _CellRouting()
    routing.n = n
    routing.paths = paths
    routing.size = size
    routing.pid = pid
    routing.at = at
    routing.nchunks = nchunks
    routing.nreq = nreq
    routing.methods = methods
    routing.method_is_direct = method_is_direct
    routing.owner_names = [o.name if o is not None else "" for o in owners]
    routing.cache_names = cache_names
    routing.chosen = chosen
    routing.fallback = fallback
    routing.ok = ok
    routing.served_mask = served_mask
    routing.serve_base = serve_base
    routing.direct_sec = direct_sec
    routing.streams = streams_by_cache
    routing.fill_targets = fill_targets
    routing.cache_tier = [c.tier for c in caches]
    routing.all_tiers = sorted({c.tier for c in caches})
    routing.Cmax = Cmax
    routing.l2_cache = {}
    routing.counters = {
        "cache_failovers": cache_failovers,
        "group_failovers": int(calls[primary_dead].sum()),
        "origin_fallbacks": int(fallback.sum()),
        "outages": was_counted["outages"],
        "recoveries": was_counted["recoveries"],
    }
    routing.serve_flow = serve_flow
    routing.pull_flow = pull_flow
    # byte counters that never depend on cache policy
    sz_int = size[pid]
    moved = ok & (served_mask | fallback | method_is_direct)
    routing.bytes_moved = int(sz_int[moved].sum())
    routing.direct_egress = int(
        sz_int[ok & (fallback | method_is_direct)].sum())
    return routing


def _resolve_distances(wanted: Sequence[Tuple[_CacheStream, bytes,
                                              np.ndarray]],
                       telemetry: Dict, device: torch.device) -> None:
    """Build every stack-distance variant the sweep's cells asked for —
    one bucketed kernel call for the whole sweep, which is the "one
    pass prices every capacity in the column" contract.

    A variant is the stream restricted to one admission filter class
    (``mask`` marks admitted keys; refused keys never perturb the LRU
    stack, so dropping their references is exact)."""
    pending: List[Tuple[_CacheStream, bytes, np.ndarray]] = []
    seen_sigs: Set[Tuple[int, bytes]] = set()
    for stream, sig, mask in wanted:
        if sig in stream.variants or (id(stream), sig) in seen_sigs:
            continue
        seen_sigs.add((id(stream), sig))
        pending.append((stream, sig, mask))
    if not pending:
        return
    problems = []
    selections = []
    for stream, sig, mask in pending:
        sel = np.nonzero(mask[stream.keys])[0]
        fkeys, fseg = stream.keys[sel], stream.seg[sel]
        prev: List[int] = []
        last: Dict[int, Tuple[int, int]] = {}
        for fi, (k, sg) in enumerate(zip(fkeys, fseg)):
            entry = last.get(int(k))
            prev.append(entry[0] if entry is not None
                        and entry[1] == sg else -1)
            last[int(k)] = (fi, int(sg))
        selections.append((sel, fkeys, fseg))
        problems.append((prev, stream.size[sel].astype(np.float64)))
    kstats: Dict = {}
    dists = stack_distances_batch(problems, stats=kstats, device=device)
    telemetry["stack_calls"] = (telemetry.get("stack_calls", 0)
                                + kstats["solve_calls"])
    telemetry["stack_variants"] = (telemetry.get("stack_variants", 0)
                                   + len(pending))
    for (stream, sig, _), (sel, fkeys, fseg), dist in zip(
            pending, selections, dists):
        fsizes = stream.size[sel]
        # distance from each key's final per-segment reference to its
        # segment's end: resident at the wipe (or run end) iff
        # end_dist + size <= capacity, so at capacity C the eviction
        # count is (admitted misses) − (keys resident at segment ends)
        end_dist, end_size = [], []
        tot: Dict[int, int] = {}
        seen: Set[Tuple[int, int]] = set()
        for r in range(len(sel) - 1, -1, -1):
            sk = (int(fseg[r]), int(fkeys[r]))
            if sk in seen:
                continue
            seen.add(sk)
            end_dist.append(tot.get(sk[0], 0))
            end_size.append(int(fsizes[r]))
            tot[sk[0]] = tot.get(sk[0], 0) + int(fsizes[r])
        stream.variants[sig] = {
            "sel": sel, "dist": dist, "sizes": fsizes,
            "end_dist": np.asarray(end_dist, np.float64),
            "end_size": np.asarray(end_size, np.int64),
        }


def _merged_parent_stream(routing: _CellRouting, q: int,
                          hits_by_child: Dict[int, np.ndarray]
                          ) -> Optional[_CacheStream]:
    """The round-2 reference stream of one fill-target (parent-tier)
    cache: its directly-routed references merged, in global arrival
    order, with the cache-to-cache fills induced by every child miss
    under the cell's L1 policy points.  Shared by every cell whose
    children resolve identically (the L1 knob signature), so an
    L1 × L2 split-sizing sweep builds each parent stream once per L1
    point and answers every L2 capacity from it."""
    r = routing
    parts: List[Tuple[np.ndarray, ...]] = []
    sq = r.streams.get(q)
    if sq is not None and len(sq.req):
        m = len(sq.req)
        parts.append((sq.gpos, sq.req, sq.pj, sq.size, sq.seg,
                      sq.eff_obj, sq.miss_sec, np.zeros(m, bool)))
    for ci, s in r.streams.items():
        if ci == q or not len(s.req):
            continue
        mask = s.parent_ci == q
        if not mask.any():
            continue
        sel = mask & ~hits_by_child[ci]
        if not sel.any():
            continue
        parts.append((s.gpos[sel], s.req[sel], s.pj[sel], s.size[sel],
                      s.l2_seg[sel], s.l2_eff[sel], s.l2_sec[sel],
                      np.ones(int(sel.sum()), bool)))
    if not parts:
        return None
    gp = np.concatenate([p[0] for p in parts])
    o = np.argsort(gp, kind="stable")
    m = _CacheStream()
    m.gpos = gp[o]
    m.req = np.concatenate([p[1] for p in parts])[o]
    m.pj = np.concatenate([p[2] for p in parts])[o]
    m.size = np.concatenate([p[3] for p in parts])[o]
    m.seg = np.concatenate([p[4] for p in parts])[o]
    m.eff_obj = np.concatenate([p[5] for p in parts])[o]
    m.miss_sec = np.concatenate([p[6] for p in parts])[o]
    m.is_fill = np.concatenate([p[7] for p in parts])[o]
    uniq, inv = np.unique(m.pj, return_inverse=True)
    m.keys = inv.astype(np.int32)
    key_sizes = np.zeros(len(uniq), np.int64)
    key_sizes[inv] = m.size
    m.key_sizes = key_sizes
    nref = len(m.req)
    m.reset = np.zeros(nref, bool)
    if nref > 1:
        m.reset[1:] = m.seg[1:] != m.seg[:-1]
    # previous same-key reference within the same cold-restart segment
    idx = np.arange(nref)
    by_key = np.lexsort((idx, m.seg, m.keys))
    sk, ss = m.keys[by_key], m.seg[by_key]
    m.prev = np.full(nref, -1, np.int64)
    if nref > 1:
        same = (sk[1:] == sk[:-1]) & (ss[1:] == ss[:-1])
        m.prev[by_key[1:]] = np.where(same, by_key[:-1], -1)
    m.parent_ci = np.full(nref, -1, np.int64)
    m.fill_sec = np.zeros(nref, np.float64)
    m.l2_sec = np.zeros(nref, np.float64)
    m.l2_eff = np.zeros(nref, np.int64)
    m.l2_seg = np.zeros(nref, np.int64)
    m.arrays()
    return m


class _CellPlan:
    """One batched cell, waiting on its hit/miss resolution.

    Construction decides, per cache, how the cell's policy point is
    evaluated against the shared :class:`_CellRouting` streams:

    * capacity at or above the stream's whole distinct-key working set
      with nothing refused → nothing can ever evict: hit iff not a
      compulsory miss, no kernel involved;
    * ``lru`` whose admission filter is constant per key (always, bar
      outage meta-location races) → stack distances over the filtered
      stream (refused keys never enter the stack), computed lazily in
      one batched kernel call for the whole sweep and shared by every
      cell with the same filter class: ``hit iff distance + size <=
      capacity``; evictions = admitted misses − keys resident at each
      segment end;
    * ``fifo`` → the O(N log N) byte-frontier replay
      (:func:`~repro_torch.kernels.stack_distance.fifo_sim_batch`), which
      takes per-reference admit bits directly;
    * the residue (LRU whose admission basis flips mid-stream) → the
      exact slot state machine
      (:func:`~repro_torch.kernels.stack_distance.cache_sim_batch`).

    ``finalize`` then folds per-reference hits into the cell's
    :class:`~repro_torch.core.simclient.ScenarioReport` and pricing flow set.
    """

    def __init__(self, cspec: ScenarioSpec, routing: _CellRouting) -> None:
        self.spec = cspec
        self.routing = routing
        self.offset = 0                  # slot in the global sim problem list
        self.fifo_offset = 0             # slot in the global fifo list
        self.problems: List[Tuple] = []      # pending cache_sim problems
        self.fifo_problems: List[Tuple] = []  # pending fifo_sim problems
        self.dist_wanted: List[Tuple[_CacheStream, bytes, np.ndarray]] = []
        self._order: List[Tuple[int, str, object]] = []  # (cache, mode, arg)
        # round-2 state: parent-tier caches resolve against merged
        # direct+fill streams that depend on the children's hits, so
        # their problems are classified in prepare_l2, after round 1
        self.l2_offset = 0
        self.l2_fifo_offset = 0
        self.l2_problems: List[Tuple] = []
        self.l2_fifo_problems: List[Tuple] = []
        self.l2_dist_wanted: List[Tuple[_CacheStream, bytes,
                                        np.ndarray]] = []
        self._l2_order: List[Tuple[int, _CacheStream, str, object]] = []
        self._l1_res: Dict[int, Tuple] = {}
        self.knobs = knobs = _cache_knobs(cspec.federation)
        for ci in sorted(routing.streams):
            stream = routing.streams[ci]
            if not len(stream.req) or ci in routing.fill_targets:
                continue
            cap, policy, frac = knobs[routing.cache_names[ci]]
            mode, arg = self._classify(stream, cap, policy, frac,
                                       self.problems, self.fifo_problems,
                                       self.dist_wanted)
            self._order.append((ci, mode, arg))

    @staticmethod
    def _classify(stream: _CacheStream, cap: float, policy: str,
                  frac: float, problems: List, fifo_problems: List,
                  dist_wanted: List) -> Tuple[str, object]:
        refused = stream.size > cap
        if frac < 1.0:
            refused = refused | (stream.eff_obj > frac * cap)
        if not refused.any() and cap >= stream.total_key_bytes:
            return "fits", None
        if policy == "fifo":
            fifo_problems.append(
                (stream.keys, stream.size.astype(np.float64),
                 ~refused, stream.reset, stream.n_keys, float(cap)))
            return "fifo", len(fifo_problems) - 1
        if stream.eff_const:
            # the filter refuses a key always or never → exact as a
            # filtered stack; cells sharing the filter class share
            # the variant
            admitted = np.ones(stream.n_keys, bool)
            admitted[stream.keys[refused]] = False
            sig = admitted.tobytes()
            dist_wanted.append((stream, sig, admitted))
            return "dist", sig
        problems.append(
            (stream.keys, ~refused, stream.reset,
             stream.key_sizes.astype(np.float64), float(cap), False))
        return "sim", len(problems) - 1

    def _resolve(self, stream: _CacheStream, cap: float, frac: float,
                 mode: str, arg: object, sim_results: Sequence,
                 fifo_results: Sequence, sim_base: int,
                 fifo_base: int) -> Tuple:
        """(hits, evictions, bytes_evicted, admission_rejects) for one
        stream at one policy point, from the batched kernel answers."""
        policy_refused = (stream.eff_obj > frac * cap if frac < 1.0
                          else None)
        if mode == "fits":
            hits = stream.prev >= 0
            ev = evb = rejects = 0
        elif mode == "dist":
            v = stream.variants[arg]
            fhits = v["dist"] + v["sizes"] <= cap
            hits = np.zeros(len(stream.req), bool)
            hits[v["sel"][fhits]] = True
            resident = v["end_dist"] + v["end_size"] <= cap
            ev = int((~fhits).sum() - resident.sum())
            evb = int(v["sizes"][~fhits].sum()
                      - v["end_size"][resident].sum())
            # a constantly-refused key is never resident: every one of
            # its references re-asks admission
            rejects = (int(policy_refused.sum())
                       if policy_refused is not None else 0)
        else:
            results = fifo_results if mode == "fifo" else sim_results
            base = fifo_base if mode == "fifo" else sim_base
            hits, ev, evb = results[base + arg]
            rejects = (int((~hits & policy_refused).sum())
                       if policy_refused is not None else 0)
        return hits, ev, evb, rejects

    def _resolve_l1(self, sim_results: Sequence,
                    fifo_results: Sequence) -> None:
        if self._l1_res:
            return
        r = self.routing
        for ci, mode, arg in self._order:
            cap, _policy, frac = self.knobs[r.cache_names[ci]]
            self._l1_res[ci] = self._resolve(
                r.streams[ci], cap, frac, mode, arg, sim_results,
                fifo_results, self.offset, self.fifo_offset)

    def prepare_l2(self, sim_results: Sequence,
                   fifo_results: Sequence) -> None:
        """Resolve the children, derive (or reuse) each fill target's
        merged stream, and classify its round-2 problem."""
        r = self.routing
        if not r.fill_targets:
            return
        self._resolve_l1(sim_results, fifo_results)
        hits_by_child = {ci: res[0] for ci, res in self._l1_res.items()}
        for q in sorted(r.fill_targets):
            children = tuple(
                (ci, self.knobs[r.cache_names[ci]])
                for ci in sorted(r.streams)
                if ci != q and len(r.streams[ci].req)
                and (r.streams[ci].parent_ci == q).any())
            lkey = (q, children)
            if lkey not in r.l2_cache:
                r.l2_cache[lkey] = _merged_parent_stream(r, q,
                                                         hits_by_child)
            stream = r.l2_cache[lkey]
            if stream is None:
                continue
            capq, policyq, fracq = self.knobs[r.cache_names[q]]
            mode, arg = self._classify(stream, capq, policyq, fracq,
                                       self.l2_problems,
                                       self.l2_fifo_problems,
                                       self.l2_dist_wanted)
            self._l2_order.append((q, stream, mode, arg))

    def finalize(self, sim_results: List, fifo_results: List,
                 l2_sim_results: Sequence = (),
                 l2_fifo_results: Sequence = ()
                 ) -> Tuple[ScenarioReport, Tuple]:
        r = self.routing
        knobs = self.knobs
        n = r.n
        self._resolve_l1(sim_results, fifo_results)
        hit_chunks = np.zeros(n, np.int64)
        miss_chunks = np.zeros(n, np.int64)
        miss_secs = np.zeros(n, np.float64)
        egress = r.direct_egress
        evictions = bytes_evicted = admission_rejects = 0
        total_hits = total_misses = parent_fill = 0
        tier_hits = {t: 0 for t in r.all_tiers}
        tier_misses = {t: 0 for t in r.all_tiers}
        tier_fill = {t: 0 for t in r.all_tiers}
        req_pulled = np.zeros(n, bool)       # request had >= 1 miss
        l2_pulled: Set[Tuple[int, int]] = set()
        for ci, mode, arg in self._order:
            stream = r.streams[ci]
            hits, ev, evb, rejects = self._l1_res[ci]
            evictions += ev
            bytes_evicted += evb
            admission_rejects += rejects
            miss = ~hits
            np.add.at(hit_chunks, stream.req[hits], 1)
            np.add.at(miss_chunks, stream.req[miss], 1)
            # a miss with a live parent fills cache-to-cache (no
            # redirector RPC at the child); otherwise it pulls straight
            # from the origin, which is the only path that counts egress
            tiered = stream.parent_ci >= 0
            cost = np.where(tiered, stream.fill_sec, stream.miss_sec)
            np.add.at(miss_secs, stream.req[miss], cost[miss])
            egress += int(stream.size[miss & ~tiered].sum())
            parent_fill += int(stream.size[miss & tiered].sum())
            t = r.cache_tier[ci]
            nh, nm = int(hits.sum()), int(miss.sum())
            tier_hits[t] += nh
            tier_misses[t] += nm
            tier_fill[t] += int(stream.size[miss].sum())
            total_hits += nh
            total_misses += nm
            req_pulled[stream.req[miss]] = True
        for q, stream, mode, arg in self._l2_order:
            capq, _policyq, fracq = knobs[r.cache_names[q]]
            hits, ev, evb, rejects = self._resolve(
                stream, capq, fracq, mode, arg, l2_sim_results,
                l2_fifo_results, self.l2_offset, self.l2_fifo_offset)
            evictions += ev
            bytes_evicted += evb
            admission_rejects += rejects
            miss = ~hits
            # only directly-routed references touch request-level
            # counters; fill references surface as the parent's own
            # hit/miss tallies plus upstream seconds on the child's
            # request when the parent misses through to the origin
            direct = ~stream.is_fill
            np.add.at(hit_chunks, stream.req[hits & direct], 1)
            np.add.at(miss_chunks, stream.req[miss & direct], 1)
            np.add.at(miss_secs, stream.req[miss], stream.miss_sec[miss])
            egress += int(stream.size[miss].sum())
            t = r.cache_tier[q]
            nh, nm = int(hits.sum()), int(miss.sum())
            tier_hits[t] += nh
            tier_misses[t] += nm
            tier_fill[t] += int(stream.size[miss].sum())
            total_hits += nh
            total_misses += nm
            req_pulled[stream.req[miss & direct]] = True
            for p in np.unique(stream.pj[miss] // r.Cmax):
                l2_pulled.add((q, int(p)))

        seconds = r.serve_base + miss_secs + r.direct_sec

        results: List[FetchResult] = []
        flow_specs: List[Tuple[List, float]] = []
        flow_bytes: List[float] = []
        pulled: set = set()
        for i in range(n):
            p = int(r.pid[i])
            if not r.ok[i]:
                results.append(FetchResult(
                    path=r.paths[p], method=r.methods[i], plane="analytic",
                    start=r.at[i], ok=False,
                    error=f"FileNotFoundError: {r.paths[p]}"))
                continue
            if r.method_is_direct[i] or r.fallback[i]:
                results.append(FetchResult(
                    path=r.paths[p], size=int(r.size[p]),
                    method=("direct" if r.method_is_direct[i]
                            else "origin-direct"),
                    plane="analytic", seconds=seconds[i],
                    bytes=int(r.size[p]), chunks=int(r.nchunks[p]),
                    cache_misses=int(r.nchunks[p]),
                    source=r.owner_names[p], start=r.at[i]))
            else:
                ci = int(r.chosen[i])
                if req_pulled[i] and (ci, p) not in pulled:
                    pulled.add((ci, p))
                    links, cap_f = r.pull_flow[(ci, p)]
                    flow_specs.append((links, cap_f))
                    flow_bytes.append(float(r.size[p]))
                hit = miss_chunks[i] == 0
                results.append(FetchResult(
                    path=r.paths[p], size=int(r.size[p]), method="stash",
                    plane="analytic", seconds=seconds[i],
                    bytes=int(r.size[p]), chunks=int(r.nchunks[p]),
                    cache_hit=bool(hit), cache_hits=int(hit_chunks[i]),
                    cache_misses=int(miss_chunks[i]),
                    source=r.cache_names[ci], start=r.at[i]))
            links, cap_f = r.serve_flow[i]
            flow_specs.append((links, cap_f))
            flow_bytes.append(float(r.size[p]))
        for q, p in sorted(l2_pulled):
            # the parent's own origin pulls (fill misses); direct misses
            # at the parent were already priced through ``pulled``
            if (q, p) in pulled:
                continue
            entry = r.pull_flow.get((q, p))
            if entry is not None:
                links, cap_f = entry
                flow_specs.append((links, cap_f))
                flow_bytes.append(float(r.size[p]))

        report = ScenarioReport(
            name=self.spec.name, engine="analytic", results=results,
            bytes_moved=r.bytes_moved,
            cache_hits=total_hits,
            cache_misses=total_misses,
            origin_egress_bytes=egress,
            parent_fill_bytes=parent_fill,
            tier_hits=tier_hits, tier_misses=tier_misses,
            tier_fill_bytes=tier_fill,
            evictions=evictions, bytes_evicted=bytes_evicted,
            admission_rejects=admission_rejects,
            **r.counters)
        return report, (flow_specs, flow_bytes)


def _plan_cell_vectorized(cspec: ScenarioSpec, routing_fed: FederationSpec,
                          fed: Federation, state: Dict,
                          telemetry: Dict) -> Optional[_CellPlan]:
    """Build (or reuse) the cell's routing product and wrap it in a
    policy-point plan.  Routing is cached by the cell spec with its
    *name* cleared and its federation replaced by ``routing_fed`` (the
    normalized spec the caller already built to pick the shared
    federation) — the whole cache-policy sweep column shares one
    entry."""
    key = dataclasses.replace(cspec, name="", federation=routing_fed)
    routing = None
    for known, cached in state["cells"]:
        if known == key:
            routing = cached
            break
    if routing is None:
        routing = _cell_routing(key, fed, state, telemetry)
        if routing is None:
            return None
        state["cells"].append((key, routing))
    return _CellPlan(cspec, routing)


def _fit_streams(plan: "_CellPlan", l2: bool = False) -> List:
    """The streams whose models a fit sweep builds for ``plan``: its
    first-round caches' streams, or with ``l2`` its parent tier's merged
    streams."""
    if l2:
        return [stream for _q, stream, _m, _a in plan._l2_order]
    return [plan.routing.streams[ci] for ci, _m, _a in plan._order]


def _fit_wanted(plan: "_CellPlan", wanted: List, l2: bool = False) -> None:
    """Queue the *unfiltered* (all keys admitted) stack-distance
    variant of every stream the plan touches — the capacity-free reuse
    profile the differentiable cache models fit.  Rides the same
    batched kernel call as the cells' own variants; streams that
    already resolve through an all-admitted ``dist`` variant share it
    byte for byte."""
    for stream in _fit_streams(plan, l2):
        admitted = np.ones(stream.n_keys, bool)
        wanted.append((stream, admitted.tobytes(), admitted))


def _fit_round(streams: Sequence, fit, cache: Dict[int, Tuple],
               device: torch.device) -> None:
    """(histogram dict, CacheModel) of every stream of one kernel round
    into ``cache``, once a stream object (shared by every cell of its
    routing column), after the round's scans resolved its all-admitted
    variant; ``fit="mixture"`` fits the round's mixtures in one
    ``mixture_fit`` call on ``device``."""
    todo: Dict[int, Tuple] = {}
    for stream in streams:
        if id(stream) in cache or id(stream) in todo:
            continue
        v = stream.variants.get(np.ones(stream.n_keys, bool).tobytes())
        if v is None:
            continue
        if stream.is_fill is not None:
            of = 1.0   # merged parent streams miss straight to the origin
        else:
            tot = float(stream.size.sum())
            of = (float(stream.size[stream.parent_ci < 0].sum()) / tot
                  if tot > 0 else 1.0)
        todo[id(stream)] = (reuse_histogram(v["dist"], v["sizes"]), of)
    hists = [h for h, _ in todo.values()]
    fractions = [of for _, of in todo.values()]
    models = (fit_lognormal_mixtures(hists, origin_fractions=fractions,
                                     device=device)
              if fit == "mixture" else
              [fit_histogram_model(h, origin_fraction=of)
               for h, of in zip(hists, fractions)])
    for key, hist, model in zip(todo, hists, models):
        cache[key] = (hist.to_dict(), model)


def run_sweep(spec: SweepSpec, batched: bool = True,
              price_contention: bool = True, fit=False) -> SweepReport:
    """Execute every cell of a sweep.

    ``batched=True`` routes eligible analytic cells through the
    vectorized executor: pristine federations, routing tables and
    per-cache request streams shared across each cache-policy sweep
    column; hit/miss resolved by the stack-distance scan (one pass
    answers every LRU capacity in the column), the FIFO byte-frontier
    replay or the LRU/FIFO slot machine (capacity × policy × admission
    points of one stream share a call); and every cell's contention — the
    all-at-once storm counterfactual of its workload — priced by the
    pow2-bucketed batched max-min solver.  A handful of calls covers the
    whole sweep (``report.solver``).  The scans and the solver run on
    ``spec.base.device`` (``None`` means ``cuda`` and raises without a
    card; pass ``"cpu"`` for the plain PyTorch versions).  Ineligible
    cells (sim engine, proxy/cvmfs methods, LFU/TTL victim orders,
    control planes) fall back to a serial :func:`run_scenario`, so a
    mixed sweep still completes with identical semantics.
    ``batched=False`` is the all-serial baseline the parity tests compare
    against.

    ``fit=True`` additionally returns *fitted models* alongside the
    exact cells: every batched stream's unfiltered reuse-distance
    profile is resolved in the same batched scan calls, bucketed
    into a per-cache ``reuse_histogram`` and fitted into a
    differentiable :class:`~repro_torch.kernels.cache_model.CacheModel`
    (``fit="mixture"`` fits parametric lognormal mixtures instead of
    the nonparametric smoothed-histogram curve, one ``mixture_fit`` call
    a kernel round on the sweep's device).  Both ride on the cells —
    ``cell.reuse_histogram`` / ``cell.models``,
    :meth:`SweepReport.fitted_models` — never inside the summaries the
    parity tests compare, and feed :mod:`repro_torch.core.planner`.
    """
    t0 = time.perf_counter()
    device = resolve_device(spec.base.device) if batched else None
    shared = _SharedFederations()
    telemetry: Dict[str, object] = {}
    entries: List[Tuple[Dict, ScenarioSpec, Optional[_CellPlan],
                        Optional[ScenarioReport]]] = []
    sim_problems: List[Tuple] = []
    fifo_problems: List[Tuple] = []
    dist_wanted: List[Tuple[_CacheStream, bytes, np.ndarray]] = []
    batched_cells = serial_cells = 0
    for params, cspec in spec.cells():
        plan = None
        if batched and _sweep_batchable(cspec):
            routing_fed = _routing_fedspec(cspec.federation)
            fed, state = shared.get(routing_fed)
            plan = _plan_cell_vectorized(cspec, routing_fed, fed, state,
                                         telemetry)
        if plan is not None:
            plan.offset = len(sim_problems)
            plan.fifo_offset = len(fifo_problems)
            sim_problems.extend(plan.problems)
            fifo_problems.extend(plan.fifo_problems)
            dist_wanted.extend(plan.dist_wanted)
            if fit:
                _fit_wanted(plan, dist_wanted)
            batched_cells += 1
            entries.append((dict(params), cspec, plan, None))
        else:
            serial_cells += 1
            entries.append((dict(params), cspec, None, run_scenario(cspec)))

    if dist_wanted:
        _resolve_distances(dist_wanted, telemetry, device)
    fit_cache: Dict[int, Tuple] = {}
    if fit:
        _fit_round([s for _p, _c, plan, _r in entries if plan is not None
                    for s in _fit_streams(plan)], fit, fit_cache, device)
    sim_results: List = []
    fifo_results: List = []
    if fifo_problems:
        fifo_stats: Dict = {}
        fifo_results = fifo_sim_batch(fifo_problems, stats=fifo_stats,
                                      device=device)
        telemetry["fifo_calls"] = fifo_stats["solve_calls"]
        telemetry["fifo_problems"] = fifo_stats["problems"]
    if sim_problems:
        sim_stats: Dict = {}
        sim_results = cache_sim_batch(sim_problems, stats=sim_stats,
                                      device=device)
        telemetry["cache_sim_calls"] = sim_stats["solve_calls"]
        telemetry["cache_sim_problems"] = sim_stats["problems"]

    # round 2: parent-tier caches see their direct references merged
    # with the fills the children's misses induced, so their problems
    # only exist once round 1 is resolved — same batched kernels, one
    # more pass, still zero serial cells
    l2_sim_problems: List[Tuple] = []
    l2_fifo_problems: List[Tuple] = []
    l2_dist_wanted: List[Tuple[_CacheStream, bytes, np.ndarray]] = []
    for params, cspec, plan, report in entries:
        if plan is not None and plan.routing.fill_targets:
            plan.prepare_l2(sim_results, fifo_results)
            plan.l2_offset = len(l2_sim_problems)
            plan.l2_fifo_offset = len(l2_fifo_problems)
            l2_sim_problems.extend(plan.l2_problems)
            l2_fifo_problems.extend(plan.l2_fifo_problems)
            l2_dist_wanted.extend(plan.l2_dist_wanted)
            if fit:
                _fit_wanted(plan, l2_dist_wanted, l2=True)
    if l2_dist_wanted:
        _resolve_distances(l2_dist_wanted, telemetry, device)
    if fit:
        _fit_round([s for _p, _c, plan, _r in entries if plan is not None
                    for s in _fit_streams(plan, l2=True)], fit, fit_cache,
                   device)
    l2_sim_results: List = []
    l2_fifo_results: List = []
    if l2_fifo_problems:
        l2_fifo_stats: Dict = {}
        l2_fifo_results = fifo_sim_batch(l2_fifo_problems,
                                         stats=l2_fifo_stats, device=device)
        telemetry["fifo_calls"] = (telemetry.get("fifo_calls", 0)
                                   + l2_fifo_stats["solve_calls"])
        telemetry["fifo_problems"] = (telemetry.get("fifo_problems", 0)
                                      + l2_fifo_stats["problems"])
    if l2_sim_problems:
        l2_sim_stats: Dict = {}
        l2_sim_results = cache_sim_batch(l2_sim_problems,
                                         stats=l2_sim_stats, device=device)
        telemetry["cache_sim_calls"] = (
            telemetry.get("cache_sim_calls", 0)
            + l2_sim_stats["solve_calls"])
        telemetry["cache_sim_problems"] = (
            telemetry.get("cache_sim_problems", 0)
            + l2_sim_stats["problems"])
    if l2_sim_problems or l2_fifo_problems or l2_dist_wanted:
        telemetry["tier_rounds"] = 2

    cells: List[SweepCell] = []
    problems = []
    problem_bytes = []
    problem_cells: List[SweepCell] = []
    for params, cspec, plan, report in entries:
        if plan is not None:
            report, (flow_specs, flow_bytes) = plan.finalize(
                sim_results, fifo_results, l2_sim_results,
                l2_fifo_results)
            executor = "batched"
        else:
            flow_specs = flow_bytes = None
            executor = "serial"
        cell = SweepCell(params=params, name=cspec.name,
                         engine=cspec.engine, executor=executor,
                         summary=report.summary())
        if fit and plan is not None:
            r = plan.routing
            hists: Dict[str, Dict] = {}
            mods: Dict[str, object] = {}
            pairs = [(r.cache_names[ci], r.streams[ci])
                     for ci, _m, _a in plan._order]
            pairs += [(r.cache_names[q], stream)
                      for q, stream, _m, _a in plan._l2_order]
            for name, stream in pairs:
                if id(stream) in fit_cache:
                    hists[name], mods[name] = fit_cache[id(stream)]
            cell.reuse_histogram = hists
            cell.models = mods
        if executor == "batched" and price_contention and flow_specs:
            problems.append(sparse_flow_problem(flow_specs))
            problem_bytes.append(np.asarray(flow_bytes))
            problem_cells.append(cell)
        cells.append(cell)
    solver: Dict[str, object] = {"solve_calls": 0, "priced_cells": 0}
    if fit:
        telemetry["fit_streams"] = len(fit_cache)
    solver.update(telemetry)
    if problems:
        stats: Dict = {}
        rates = maxmin_rates_batch(problems, stats=stats, device=device)
        solver.update(stats)
        solver["priced_cells"] = len(problems)
        for cell, nbytes, rr in zip(problem_cells, problem_bytes, rates):
            rr = np.maximum(rr, 1e-9)
            cell.pricing = {
                "peak_flows": int(len(rr)),
                "min_rate": float(rr.min()) if len(rr) else 0.0,
                "mean_rate": float(rr.mean()) if len(rr) else 0.0,
                "storm_finish_seconds": float((nbytes / rr).max())
                if len(rr) else 0.0,
            }
    return SweepReport(
        name=spec.name, axes={k: list(v) for k, v in spec.axes.items()},
        cells=cells, wall_seconds=time.perf_counter() - t0,
        batched_cells=batched_cells, serial_cells=serial_cells,
        solver=solver)
