"""Simulator-native federation clients + outage-storm scenario engine.

The paper's headline numbers (Table 3, Figs 5–8) measure the *whole*
client chain — GeoIP ranking, redirector lookup, failover — on a
contended network.  ``stash_download`` (the PR-1 scenario coroutine)
hard-wires one pre-chosen cache, so none of the routing machinery is
ever exercised under contention.  This module closes that gap:

* :class:`SimStashClient` — a coroutine ``stashcp`` whose cache choice
  goes through the real :meth:`StashClient._ranked_caches` /
  :meth:`CacheGroup.route` machinery (consistent-hash ring ownership,
  dead-member failover chains, stray-cache geo tails) with per-cache
  collapsed forwarding (:meth:`FluidFlowSim.inflight`) and optional
  **hedged fetches**: if the chosen cache hasn't delivered within a
  deadline, a backup fetch is raced against it via the next ranked
  cache, first finisher wins (straggler mitigation for restart storms).
* :class:`OutageSchedule` — mid-run cache failure/recovery timelines:
  restart storms, regional blackouts, rolling upgrades (cold restarts
  lose their disk; warm ones keep it).
* :class:`ScenarioEngine` — replays :func:`~repro_torch.core.workload.
  generate_workload` / :func:`storm_workload` traces across a
  multi-site federation under an outage schedule, one simulator-driven
  client per (site, worker), and aggregates the result into a
  :class:`ScenarioReport`.

``router="modulo"`` swaps the consistent-hash routing for a
hash-mod-alive-caches baseline, which is what lets the fleet benches
compare ring vs modulo *with* link contention instead of the
functional-path approximation.
"""
from __future__ import annotations

import dataclasses
from typing import (Dict, Generator, Iterable, List, Optional, Sequence,
                    Tuple)

from .cache import CacheServer
from .chunk import ObjectMeta, fnv1a64
from .client import StashClient
from .controlplane import ControlPlane, ControlPlaneSpec
from .federation import Federation
from .origin import Origin
from .simulator import DownloadResult, Event, FluidFlowSim, fetch_chunks
from .workload import AccessRequest


# ---------------------------------------------------------------------------
# Coroutine combinators (timer races for hedged fetches)
# ---------------------------------------------------------------------------
def first_of(sim: FluidFlowSim, *events: Event) -> Event:
    """An event that fires when any of ``events`` fires (or now, if one
    already has).  Watchers are plain sim coroutines, so the combinator
    composes with flows/delays without special-casing the event loop."""
    trigger = sim.event()
    if any(ev.is_set for ev in events):
        trigger.set()
        return trigger

    def watch(ev: Event) -> Generator:
        yield ev
        trigger.set()  # idempotent: late watchers find no waiters

    for ev in events:
        sim.spawn(watch(ev))
    return trigger


# ---------------------------------------------------------------------------
# The simulator-native stashcp
# ---------------------------------------------------------------------------
class SimStashClient:
    """One worker's federation client, driven by the fluid-flow sim.

    Wraps a functional :class:`StashClient` purely for its *routing*
    brain (ring-aware `_ranked_caches`); all timing — GeoIP lookup,
    redirector RPC, origin pull, cache→client serve — happens as
    simulator delays and contended flows.
    """

    def __init__(self, sim: FluidFlowSim, client: StashClient,
                 origin: Origin, redirector_node: str,
                 streams: int = 8,
                 hedge_after: Optional[float] = None,
                 max_attempts: int = 4,
                 rank_limit: Optional[int] = 8,
                 router: str = "ring",
                 redirectors=None,
                 control: Optional[ControlPlane] = None) -> None:
        if router not in ("ring", "modulo"):
            raise ValueError(f"unknown router {router!r}")
        self.sim = sim
        self.client = client
        self.origin = origin
        self.redirector_node = redirector_node
        self.streams = streams
        self.hedge_after = hedge_after
        self.max_attempts = max_attempts
        self.rank_limit = rank_limit
        self.router = router
        self.control = control
        # Namespace-first path resolution: with a RedirectorGroup the
        # owning origin comes from longest-prefix match over the global
        # namespace (multi-origin federations); ``origin`` is only the
        # fallback when no export claims the path.
        self.redirectors = redirectors

    @property
    def node_name(self) -> str:
        return self.client.node.name

    @property
    def stats(self):
        return self.client.stats

    # -- routing ------------------------------------------------------------
    def _route(self, path: str,
               exclude: Sequence[str] = ()) -> List[CacheServer]:
        if self.router == "modulo":
            # Non-consistent baseline: hash mod the *alive* member count.
            # Any membership change renumbers nearly every key — the
            # origin-storm failure mode the ring exists to avoid.
            alive = sorted(c.name for c in self.client.caches.values()
                           if c.available and c.name not in exclude)
            if not alive:
                return []
            start = fnv1a64(path.encode()) % len(alive)
            return [self.client.caches[alive[(start + i) % len(alive)]]
                    for i in range(len(alive))]
        return self.client._ranked_caches(path=path, exclude=exclude,
                                          limit=self.rank_limit)

    def _owner(self, path: str) -> Origin:
        """The origin serving ``path`` — resolved through the
        redirectors' namespace (longest-prefix), not a held reference."""
        if self.redirectors is not None:
            try:
                origin = self.redirectors.locate(path)
            except ConnectionError:
                origin = None
            if origin is not None:
                return origin
        return self.origin

    def _meta(self, path: str) -> Optional[ObjectMeta]:
        owner = self._owner(path)
        if path in owner.store:
            return owner.meta(path)
        return self.client._meta(path)

    # -- the download coroutine ---------------------------------------------
    def download(self, path: str, meta: Optional[ObjectMeta] = None,
                 result: Optional[DownloadResult] = None,
                 tenant: str = "") -> Generator:
        """stashcp under contention: GeoIP → ranked caches → (failover as
        needed) → collapsed-forwarding fetch → (hedged) multi-stream
        serve.  Falls back to a direct origin pull only when every
        ranked cache is down (regional blackout).

        With a control plane attached, each per-cache attempt first
        passes the cache's circuit breaker and admission queue (which
        may park this coroutine or shed the request outright — a shed
        terminates the download, it does *not* fall through to the
        origin), and failed attempts retry with exponential backoff
        instead of hammering the next ranked cache immediately."""
        sim = self.sim
        ctrl = self.control
        t0 = sim.t
        self.stats.copies += 1
        yield sim.delay(self.client.geoip.lookup_latency)
        # One namespace resolution per download: every fetch arm (and
        # the blackout fallback) pulls from the same resolved owner.
        owner = self._owner(path)
        if meta is None:
            meta = (owner.meta(path) if path in owner.store
                    else self.client._meta(path))
        if meta is None:
            raise FileNotFoundError(path)
        failovers = 0
        attempts = 0
        n_backoff = 0
        for cache in self._route(path):
            if attempts >= self.max_attempts:
                break
            if ctrl is not None:
                ctrl.maybe_recover(cache.name, sim.t)
            if not cache.available:
                failovers += 1
                self.stats.cache_failovers += 1
                if ctrl is not None:
                    ctrl.on_failure(cache.name, sim.t)
                self.client.ranking.on_failure(cache.name)
                continue
            if ctrl is not None and not ctrl.allow(cache.name, sim.t):
                continue  # breaker open: skip without burning an attempt
            attempts += 1
            if self.hedge_after is None:
                kind, status, queued = yield from self._attempt(
                    cache, meta, owner, tenant)
                if kind == "shed":
                    self._finish_shed(result, t0, cache.name, failovers)
                    return
                if kind == "fail":
                    # died mid-pull: the key remaps down the ring chain
                    failovers += 1
                    self.stats.cache_failovers += 1
                    if attempts < self.max_attempts:
                        yield from self._backoff(n_backoff)
                        n_backoff += 1
                    continue
                outcome = {"winner": cache.name, "status": status,
                           "hedged": False, "queue_seconds": queued}
            else:
                outcome = yield from self._hedged_attempt(cache, meta,
                                                          owner, tenant)
                if outcome["winner"] is None:
                    if outcome.get("sheds"):
                        self._finish_shed(result, t0, cache.name,
                                          failovers)
                        return
                    failovers += 1
                    self.stats.cache_failovers += 1
                    if attempts < self.max_attempts:
                        yield from self._backoff(n_backoff)
                        n_backoff += 1
                    continue
            if result is not None:
                result.seconds = sim.t - t0
                result.start = t0
                result.cache_hit = outcome["status"] == "hit"
                result.waited = outcome["status"] == "waited"
                result.hedged = outcome["hedged"]
                result.source = outcome["winner"]
                result.failovers = failovers
                result.queue_seconds = outcome.get("queue_seconds", 0.0)
            return
        # Every ranked cache is dead (or attempts exhausted): the
        # federation degrades to the WAN-saturating direct pull.
        self.stats.origin_fallbacks += 1
        yield sim.flow(owner.node.name, self.node_name, meta.size,
                       streams=self.streams)
        owner.stats.egress_bytes += meta.size
        if result is not None:
            result.seconds = sim.t - t0
            result.start = t0
            result.cache_hit = False
            result.source = owner.name
            result.failovers = failovers
            result.method = "origin-direct"

    def _fetch_chunks(self, cache: CacheServer, meta: ObjectMeta,
                      owner: Origin) -> Generator:
        """Shared collapsed-forwarding fetch (see
        :func:`~repro_torch.core.simulator.fetch_chunks`), pulling from the
        namespace-resolved owner so its egress counters see the pull."""
        status = yield from fetch_chunks(
            self.sim, cache, meta, owner.node.name,
            self.redirector_node, origin=owner)
        return status

    def _serve_flow(self, cache: CacheServer, meta: ObjectMeta) -> Generator:
        yield self.sim.flow(cache.node.name, self.node_name, meta.size,
                            streams=self.streams,
                            rate_cap=cache.serve_rate_cap(meta.size))
        cache.stats.bytes_served += meta.size

    def _attempt(self, cache: CacheServer, meta: ObjectMeta,
                 owner: Origin, tenant: str = "") -> Generator:
        """One full attempt through ``cache``: admission (may queue this
        coroutine, or shed), collapsed-forwarding fetch, serve.

        Returns ``(kind, status, queue_seconds)`` where kind is "ok"
        (served; status is the fetch status), "shed" (refused by the
        admission queue) or "fail" (cache died mid-attempt).  With no
        control plane attached this is exactly the old fetch+serve
        path — byte-identical accounting."""
        sim = self.sim
        ctrl = self.control
        queued = 0.0
        if ctrl is not None:
            t_q = sim.t
            admitted = yield from ctrl.acquire(cache.name, tenant,
                                               meta.size)
            if not admitted:
                return ("shed", None, 0.0)
            queued = sim.t - t_q
        t_service = sim.t
        try:
            status = yield from self._fetch_chunks(cache, meta, owner)
            if status is None or not cache.available:
                if ctrl is not None:
                    ctrl.on_failure(cache.name, sim.t)
                self.client.ranking.on_failure(cache.name)
                return ("fail", None, queued)
            yield from self._serve_flow(cache, meta)
            if ctrl is not None:
                ctrl.on_success(cache.name, sim.t,
                                seconds=sim.t - t_service,
                                tenant=tenant, nbytes=meta.size)
            self.client.ranking.observe(cache.name, sim.t - t_service)
            return ("ok", status, queued)
        finally:
            if ctrl is not None:
                ctrl.release(cache.name, tenant)

    def _backoff(self, attempt: int) -> Generator:
        """Exponential pause between retries (no-op without control)."""
        ctrl = self.control
        if ctrl is None:
            return
        delay = ctrl.backoff(attempt)
        ctrl.stats.retries += 1
        ctrl.stats.backoff_seconds += delay
        if delay > 0:
            yield self.sim.delay(delay)

    def _finish_shed(self, result: Optional[DownloadResult], t0: float,
                     source: str, failovers: int) -> None:
        """Record an admission-queue refusal: the request terminates —
        seconds stays 0 (not completed), and it must NOT degrade into an
        origin-direct pull (shedding exists to protect the origin)."""
        if result is not None:
            result.start = t0
            result.shed = True
            result.source = source
            result.failovers = failovers
            result.method = "shed"

    def _attempt_arm(self, cache: CacheServer, meta: ObjectMeta,
                     owner: Origin, outcome: Dict,
                     done: Event, tenant: str = "") -> Generator:
        """One arm of a (possibly hedged) attempt: full fetch through
        ``cache`` (origin pull included) then serve.  Signals ``done``
        whether it won, lost, or failed; a losing arm's bytes still
        move — hedging is modeled as load, not magic.  Each arm holds
        its own admission slot; a shed arm records itself in
        ``outcome`` so the caller can tell "all arms shed" from "all
        arms failed"."""
        kind, status, queued = yield from self._attempt(cache, meta,
                                                        owner, tenant)
        if kind == "ok":
            if outcome["winner"] is None:
                outcome["winner"] = cache.name
                outcome["status"] = status
                outcome["queue_seconds"] = queued
        elif kind == "shed":
            outcome["sheds"] = outcome.get("sheds", 0) + 1
        done.set()

    def _hedged_attempt(self, cache: CacheServer, meta: ObjectMeta,
                        owner: Origin, tenant: str = "") -> Generator:
        """Timer race over the whole per-cache attempt: if ``cache``
        hasn't delivered within ``hedge_after`` seconds — origin pull
        and serve included, that's where stragglers come from — a
        backup attempt via the next ranked cache runs in parallel and
        the first finisher wins."""
        sim = self.sim
        outcome: Dict = {"winner": None, "status": None, "hedged": False,
                         "queue_seconds": 0.0}
        primary_done = sim.event()
        sim.spawn(self._attempt_arm(cache, meta, owner, outcome,
                                    primary_done, tenant))
        timer = sim.event()

        def alarm() -> Generator:
            yield sim.delay(self.hedge_after)
            timer.set()

        sim.spawn(alarm())
        yield first_of(sim, primary_done, timer)
        pending = [primary_done]
        if outcome["winner"] is None and not primary_done.is_set:
            # deadline passed with the primary still in flight: hedge
            backup = next(
                (c for c in self._route(meta.path, exclude=(cache.name,))
                 if c.available), None)
            if backup is not None:
                outcome["hedged"] = True
                self.stats.hedged_fetches += 1
                backup_done = sim.event()
                sim.spawn(self._attempt_arm(backup, meta, owner, outcome,
                                            backup_done, tenant))
                pending.append(backup_done)
        pending = [ev for ev in pending if not ev.is_set]
        while outcome["winner"] is None and pending:
            yield first_of(sim, *pending)
            pending = [ev for ev in pending if not ev.is_set]
        return outcome


# ---------------------------------------------------------------------------
# Outage schedules: restart storms, blackouts, rolling upgrades
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class OutageEvent:
    """One liveness transition: ``cache`` goes down or comes back up at
    ``time``.  ``cold`` recoveries lose all resident data (the restart
    wiped the disk); warm ones keep it (a network partition healing).

    ``kind="link"`` repurposes the event as a *network* transition: the
    ``cache`` field names a topology link (``backbone/eu-us-east``,
    ``region/us-west``, a site uplink, ...), "down" degrades its
    bandwidth to ``factor`` × nominal and "up" restores it.  Cache and
    link events interleave freely on one schedule."""

    time: float
    cache: str
    action: str  # "down" | "up"
    cold: bool = False
    kind: str = "cache"  # "cache" | "link"
    factor: float = 1.0  # link degradation multiplier (kind="link")

    def __post_init__(self) -> None:
        if self.action not in ("down", "up"):
            raise ValueError(f"unknown outage action {self.action!r}")
        if self.kind not in ("cache", "link"):
            raise ValueError(f"unknown outage kind {self.kind!r}")


class OutageSchedule:
    """A time-ordered list of :class:`OutageEvent`, with constructors
    for the three storm shapes the ROADMAP's 1000+-site north star
    cares about."""

    def __init__(self, events: Iterable[OutageEvent] = ()) -> None:
        self.events: Tuple[OutageEvent, ...] = tuple(sorted(
            events, key=lambda e: (e.time, e.cache, e.action)))

    def __iter__(self):
        return iter(self.events)

    def __len__(self) -> int:
        return len(self.events)

    def __eq__(self, other: object) -> bool:
        # Value equality lets the sweep executor share one routing/
        # stream computation across cells whose schedules are merely
        # equal-by-construction (e.g. the same outage_rate axis value).
        if not isinstance(other, OutageSchedule):
            return NotImplemented
        return self.events == other.events

    def __hash__(self) -> int:
        # Consistent with __eq__ (the canonical sorted event tuple):
        # lets schedules graduate from the linear sharing-key scan to
        # dict/set keys without falling back to identity, which
        # equality already avoids.
        return hash(self.events)

    def merge(self, other: "OutageSchedule") -> "OutageSchedule":
        return OutageSchedule([*self.events, *other.events])

    @staticmethod
    def restart_storm(caches: Sequence[str], at: float,
                      downtime: float = 30.0, stagger: float = 0.0,
                      cold: bool = True) -> "OutageSchedule":
        """Every listed cache restarts around ``at`` (``stagger`` spaces
        the kills), coming back ``downtime`` later — cold by default."""
        ev: List[OutageEvent] = []
        for i, name in enumerate(caches):
            t = at + i * stagger
            ev.append(OutageEvent(t, name, "down"))
            ev.append(OutageEvent(t + downtime, name, "up", cold=cold))
        return OutageSchedule(ev)

    @staticmethod
    def regional_blackout(caches: Sequence[str], at: float,
                          duration: float) -> "OutageSchedule":
        """All listed caches vanish together (a region's uplink died)
        and return together, warm — the data survived, the path didn't."""
        ev = [OutageEvent(at, n, "down") for n in caches]
        ev += [OutageEvent(at + duration, n, "up", cold=False)
               for n in caches]
        return OutageSchedule(ev)

    @staticmethod
    def rolling_upgrade(caches: Sequence[str], start: float,
                        downtime: float = 30.0, gap: float = 10.0,
                        cold: bool = True) -> "OutageSchedule":
        """One cache at a time: down, upgrade, back (cold), ``gap``
        seconds of full strength between members."""
        ev: List[OutageEvent] = []
        t = start
        for name in caches:
            ev.append(OutageEvent(t, name, "down"))
            ev.append(OutageEvent(t + downtime, name, "up", cold=cold))
            t += downtime + gap
        return OutageSchedule(ev)

    @staticmethod
    def link_degradation(links: Sequence[str], at: float, duration: float,
                         factor: float = 0.1) -> "OutageSchedule":
        """The listed topology links (backbone segments, regional nets,
        site uplinks — by :meth:`Topology.find_link` name) drop to
        ``factor`` × nominal bandwidth at ``at`` and recover ``duration``
        later.  The caches stay up: this is the backbone-degradation
        scenario, where tiered fill and origin traffic slow down but
        nothing fails over."""
        ev = [OutageEvent(at, n, "down", kind="link", factor=factor)
              for n in links]
        ev += [OutageEvent(at + duration, n, "up", kind="link")
               for n in links]
        return OutageSchedule(ev)


def apply_outage(fed: Federation, ev: OutageEvent,
                 group_of: Optional[Dict[str, "object"]] = None) -> None:
    """Apply one liveness transition to a federation.

    Group members go through :meth:`~repro_torch.core.ring.CacheGroup.mark_down`
    / ``mark_up`` so group stats track the storm; stray caches toggle
    ``available`` directly (cold recoveries wipe storage).  Shared by the
    simulated engine's outage controller and the analytic engine's
    request-time replay, so both planes agree on what an
    :class:`OutageSchedule` means.
    """
    if ev.kind == "link":
        link = fed.topology.find_link(ev.cache)
        if link is None:
            raise KeyError(f"no topology link named {ev.cache!r}")
        if ev.action == "down":
            link.degrade(ev.factor)
        else:
            link.restore()
        return
    if group_of is None:
        group_of = {c.name: g for g in fed.groups.values()
                    for c in g.members}
    group = group_of.get(ev.cache)
    if group is not None:
        if ev.action == "down":
            group.mark_down(ev.cache)
        else:
            group.mark_up(ev.cache, cold=ev.cold)
        return
    cache = fed.caches[ev.cache]
    if ev.action == "down":
        cache.available = False
    else:
        if ev.cold:
            cache.clear()
        cache.available = True


# ---------------------------------------------------------------------------
# Scenario engine: trace replay under contention + outages
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class ScenarioReport:
    """What one scenario produced, for benches and tests.

    The one report type for *both* execution planes: per-request rows
    (``DownloadResult`` from :meth:`ScenarioEngine.replay`,
    :class:`~repro_torch.core.api.FetchResult` from
    :func:`~repro_torch.core.api.run_scenario` — both carry ``seconds`` /
    ``cache_hit``) plus federation-level aggregates.  The simulator's
    event-loop telemetry (``reallocations`` / ``flow_events`` /
    ``completed_flows``) is zeroed on the analytic engine.
    """

    name: str = ""
    engine: str = "sim"
    results: List = dataclasses.field(default_factory=list)
    sim_seconds: float = 0.0
    bytes_moved: int = 0
    cache_hits: int = 0
    cache_misses: int = 0
    origin_egress_bytes: int = 0
    # cache hierarchy (collapses to tier 1 / zero on flat federations)
    parent_fill_bytes: int = 0   # bytes moved cache-to-cache (tier fills)
    tier_hits: Dict[int, int] = dataclasses.field(default_factory=dict)
    tier_misses: Dict[int, int] = dataclasses.field(default_factory=dict)
    tier_fill_bytes: Dict[int, int] = dataclasses.field(default_factory=dict)
    evictions: int = 0
    bytes_evicted: int = 0
    admission_rejects: int = 0
    cache_failovers: int = 0
    hedged_fetches: int = 0
    origin_fallbacks: int = 0
    group_failovers: int = 0
    outages: int = 0
    recoveries: int = 0
    reallocations: int = 0
    flow_events: int = 0
    completed_flows: int = 0
    # control plane (all zero when no ControlPlaneSpec was attached)
    sheds: int = 0
    queue_waits: int = 0
    queue_wait_seconds: float = 0.0
    retries: int = 0
    breaker_opens: int = 0
    breaker_skips: int = 0
    auto_downs: int = 0
    auto_ups: int = 0

    @property
    def hit_rate(self) -> float:
        done = [r for r in self.results if r.seconds > 0]
        return (sum(1 for r in done if r.cache_hit) / len(done)
                if done else 0.0)

    @property
    def coalescing_ratio(self) -> float:
        """Per-arrival solves the old loop would have run, over solves
        actually run."""
        return self.flow_events / max(self.reallocations, 1)

    def seconds_percentile(self, pct: float) -> float:
        done = sorted(r.seconds for r in self.results if r.seconds > 0)
        if not done:
            return 0.0
        idx = min(len(done) - 1, int(pct / 100.0 * len(done)))
        return done[idx]

    def summary(self) -> Dict:
        done = [r.seconds for r in self.results if r.seconds > 0]
        return {
            "name": self.name,
            "engine": self.engine,
            "requests": len(self.results),
            "completed": len(done),
            "sim_seconds": self.sim_seconds,
            "hit_rate": self.hit_rate,
            "mean_seconds": sum(done) / len(done) if done else 0.0,
            "p50_seconds": self.seconds_percentile(50),
            "p95_seconds": self.seconds_percentile(95),
            "p99_seconds": self.seconds_percentile(99),
            "bytes_moved": self.bytes_moved,
            "goodput": (self.bytes_moved / self.sim_seconds
                        if self.sim_seconds > 0 else 0.0),
            "cache_hits": self.cache_hits,
            "cache_misses": self.cache_misses,
            "evictions": self.evictions,
            "bytes_evicted": self.bytes_evicted,
            "admission_rejects": self.admission_rejects,
            "cache_failovers": self.cache_failovers,
            "hedged_fetches": self.hedged_fetches,
            "origin_fallbacks": self.origin_fallbacks,
            "group_failovers": self.group_failovers,
            "outages": self.outages,
            "recoveries": self.recoveries,
            "origin_egress_bytes": self.origin_egress_bytes,
            "parent_fill_bytes": self.parent_fill_bytes,
            "tier_hits": {str(k): v for k, v in sorted(self.tier_hits.items())},
            "tier_misses": {str(k): v
                            for k, v in sorted(self.tier_misses.items())},
            "tier_fill_bytes": {str(k): v for k, v
                                in sorted(self.tier_fill_bytes.items())},
            "reallocations": self.reallocations,
            "flow_events": self.flow_events,
            "coalescing_ratio": self.coalescing_ratio,
            "sheds": self.sheds,
            "shed_rate": (self.sheds / len(self.results)
                          if self.results else 0.0),
            "queue_waits": self.queue_waits,
            "queue_wait_seconds": self.queue_wait_seconds,
            "retries": self.retries,
            "breaker_opens": self.breaker_opens,
            "breaker_skips": self.breaker_skips,
            "auto_downs": self.auto_downs,
            "auto_ups": self.auto_ups,
        }


def tier_tallies(caches: Iterable[CacheServer]
                 ) -> Tuple[Dict[int, int], Dict[int, int],
                            Dict[int, int], int]:
    """Per-tier (hits, misses, fill_bytes) plus total cache-to-cache
    fill bytes, from the caches' own counters.  ``fill_bytes`` is what a
    tier pulled from *upstream* (parent tier or origin) — the quantity
    split-sizing sweeps minimize at the top tier.  Shared by both
    engines' report builders so tier accounting is parity-checkable."""
    hits: Dict[int, int] = {}
    misses: Dict[int, int] = {}
    fills: Dict[int, int] = {}
    parent_fill = 0
    for c in caches:
        t = c.tier
        hits[t] = hits.get(t, 0) + c.stats.hits
        misses[t] = misses.get(t, 0) + c.stats.misses
        fills[t] = (fills.get(t, 0) + c.stats.bytes_from_parent
                    + c.stats.bytes_from_origin)
        parent_fill += c.stats.bytes_from_parent
    return hits, misses, fills, parent_fill


class ScenarioEngine:
    """Replay an access trace through simulator-native clients, with an
    optional outage schedule running concurrently."""

    def __init__(self, fed: Federation, solver: str = "auto",
                 streams: int = 8, hedge_after: Optional[float] = None,
                 max_attempts: int = 4, rank_limit: Optional[int] = 8,
                 router: str = "ring", ranking: object = None,
                 control: Optional[ControlPlaneSpec] = None,
                 device: object = None) -> None:
        self.fed = fed
        # ``device``: the simulator's (None means cuda; see FluidFlowSim)
        self.sim = FluidFlowSim(fed.topology, fed.net, solver=solver,
                                device=device)
        self.streams = streams
        self.hedge_after = hedge_after
        self.max_attempts = max_attempts
        self.rank_limit = rank_limit
        self.router = router
        # "static" | "probe" | a RankingPolicy instance; string specs
        # mint a fresh policy per client (per-client probe state).
        self.ranking = ranking
        self.redirector_node = fed.redirectors.members[0].node.name
        self._clients: Dict[Tuple[str, int], SimStashClient] = {}
        self._hosts = {s.name: max(1, s.workers) for s in fed.sites}
        self._group_of = {c.name: g for g in fed.groups.values()
                          for c in g.members}
        # One shared control plane per scenario: clients share breakers,
        # queues and health gauges, as a site-local sidecar would.
        self.control = (ControlPlane(control, sim=self.sim,
                                     group_of=self._group_of)
                        if control is not None else None)

    # -- clients ------------------------------------------------------------
    def client(self, site: str, worker: int = 0) -> SimStashClient:
        key = (site, worker)
        sc = self._clients.get(key)
        if sc is None:
            sc = SimStashClient(
                self.sim, self.fed.client(site, worker,
                                          ranking=self.ranking),
                self.fed.origins[0], self.redirector_node,
                streams=self.streams, hedge_after=self.hedge_after,
                max_attempts=self.max_attempts, rank_limit=self.rank_limit,
                router=self.router, redirectors=self.fed.redirectors,
                control=self.control)
            self._clients[key] = sc
        return sc

    # -- outages ------------------------------------------------------------
    def apply_outage(self, ev: OutageEvent) -> None:
        apply_outage(self.fed, ev, group_of=self._group_of)
        if ev.kind == "link":
            # Bandwidth just changed under active flows: force a max-min
            # re-solve at the next loop step.
            self.sim._flows_dirty = True

    def _outage_controller(self, schedule: OutageSchedule) -> Generator:
        for ev in schedule:
            if ev.time > self.sim.t:
                yield self.sim.delay(ev.time - self.sim.t)
            self.apply_outage(ev)

    # -- replay -------------------------------------------------------------
    def replay(self, requests: Sequence[AccessRequest],
               schedule: Optional[OutageSchedule] = None) -> ScenarioReport:
        origin = self.fed.origins[0]
        for r in requests:
            if r.path not in origin.store:
                origin.put_object(r.path, r.size)  # synthetic payloads
        results: List[DownloadResult] = []
        for r in requests:
            sc = self.client(r.site, r.worker % self._hosts.get(r.site, 1))
            res = DownloadResult(r.path, r.size, "simclient")
            results.append(res)
            self.sim.spawn(
                sc.download(r.path, result=res,
                            tenant=getattr(r, "tenant", "") or r.experiment),
                at=r.time)
        if schedule is not None and len(schedule):
            self.sim.spawn(self._outage_controller(schedule))
        self.sim.run()
        return self.report(results)

    def report(self, results: List[DownloadResult],
               name: str = "") -> ScenarioReport:
        cstats = [sc.stats for sc in self._clients.values()]
        gstats = [g.stats for g in self.fed.groups.values()]
        # Rows may be DownloadResult (no per-row byte counter: a
        # completed download moved its whole object) or FetchResult
        # (carries ``bytes`` directly).
        bytes_moved = sum(
            getattr(r, "bytes", 0) or (r.size if r.seconds > 0 else 0)
            for r in results)
        cp = self.control.stats if self.control is not None else None
        t_hits, t_misses, t_fills, parent_fill = tier_tallies(
            self.fed.caches.values())
        return ScenarioReport(
            name=name,
            engine="sim",
            results=results,
            sim_seconds=self.sim.t,
            bytes_moved=bytes_moved,
            cache_hits=sum(c.stats.hits for c in self.fed.caches.values()),
            cache_misses=sum(c.stats.misses
                             for c in self.fed.caches.values()),
            evictions=sum(c.stats.evictions
                          for c in self.fed.caches.values()),
            bytes_evicted=sum(c.stats.bytes_evicted
                              for c in self.fed.caches.values()),
            admission_rejects=sum(c.stats.admission_rejects
                                  for c in self.fed.caches.values()),
            reallocations=self.sim.reallocations,
            flow_events=self.sim.flow_events,
            completed_flows=self.sim.completed_flows,
            cache_failovers=sum(s.cache_failovers for s in cstats),
            hedged_fetches=sum(s.hedged_fetches for s in cstats),
            origin_fallbacks=sum(s.origin_fallbacks for s in cstats),
            group_failovers=sum(s.failovers for s in gstats),
            outages=sum(s.outages for s in gstats),
            recoveries=sum(s.recoveries for s in gstats),
            origin_egress_bytes=sum(o.stats.egress_bytes
                                    for o in self.fed.origins),
            parent_fill_bytes=parent_fill,
            tier_hits=t_hits, tier_misses=t_misses,
            tier_fill_bytes=t_fills,
            sheds=sum(1 for r in results if getattr(r, "shed", False)),
            queue_waits=cp.queue_waits if cp else 0,
            queue_wait_seconds=cp.queue_wait_seconds if cp else 0.0,
            retries=cp.retries if cp else 0,
            breaker_opens=cp.breaker_opens if cp else 0,
            breaker_skips=cp.breaker_skips if cp else 0,
            auto_downs=cp.auto_downs if cp else 0,
            auto_ups=cp.auto_ups if cp else 0,
        )
