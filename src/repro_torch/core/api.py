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

This is the port of the reference's ``repro.core.api`` up to
``_report``; the batched sweeps (``SweepSpec``, ``run_sweep``) are not
ported yet.  The simulated engine's max-min solver runs on a device:
``ScenarioSpec.device`` and ``SimulatedPlane(device=...)`` name it,
``None`` means ``cuda`` and raises without a card.  The analytic engine
has no device work and takes none.
"""
from __future__ import annotations

import dataclasses
from typing import (Dict, Generator, List, Optional, Protocol, Sequence,
                    Set, Tuple, Union, runtime_checkable)

import torch

from .client import StashClient
from .controlplane import ControlPlane, ControlPlaneSpec
from .federation import Federation, FederationSpec
from .routing import RankingPolicy
from .simclient import (OutageSchedule, ScenarioEngine, ScenarioReport,
                        apply_outage, tier_tallies)
from .simulator import direct_download, proxy_download
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
    fed = federation if federation is not None else spec.federation.build()
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

