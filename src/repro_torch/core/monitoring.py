"""Monitoring pipeline (paper §3.2, Figs. 3–4, Table 1).

Each cache/origin emits a record per *user login*, *file open* and *file
close* (in production these are XRootD binary UDP packets).  A central
collector joins the three streams: on every file-close it combines the
matching open + login into one transfer record and publishes it to a
message bus, from which aggregators build usage tables (Table 1) and time
series (Fig. 4).

The collector must tolerate packet loss and out-of-order arrival — our
``MonitorCollector.drop_rate`` and the join-by-id logic model exactly that.
"""
from __future__ import annotations

import dataclasses
import math
import random
from collections import defaultdict
from typing import Callable, Dict, List, Optional


@dataclasses.dataclass(frozen=True)
class UserLogin:
    server: str
    user_id: int
    client_host: str
    protocol: str          # "xrootd" | "http"
    ipv6: bool
    time: float


@dataclasses.dataclass(frozen=True)
class FileOpen:
    server: str
    file_id: int
    user_id: int
    path: str
    file_size: int
    time: float


@dataclasses.dataclass(frozen=True)
class FileClose:
    server: str
    file_id: int
    bytes_read: int
    bytes_written: int
    n_ops: int
    time: float


@dataclasses.dataclass(frozen=True)
class CacheUsagePacket:
    """Periodic per-cache gauge: occupancy + eviction-policy counters.

    Emitted by :meth:`repro_torch.core.cache.CacheServer.report_usage`; the
    collector keeps the latest packet per server so aggregators can build
    per-policy comparison tables (hit rate, evictions, TTL expiries,
    admission rejects) next to the paper's per-experiment usage tables.
    """

    server: str
    policy: str
    usage_bytes: int
    capacity_bytes: int
    hits: int
    misses: int
    evictions: int
    bytes_evicted: int
    ttl_expired: int
    admission_rejects: int
    time: float
    oversize_rejects: int = 0
    tier: int = 1                # hierarchy level (1 = edge)
    bytes_from_parent: int = 0   # cache-to-cache fill received

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0


@dataclasses.dataclass
class TransferRecord:
    """The joined JSON message sent to the OSG message bus."""

    server: str
    path: str
    experiment: str
    client_host: str
    protocol: str
    file_size: int
    bytes_read: int
    bytes_written: int
    n_ops: int
    start_time: float
    end_time: float
    cache_hit: Optional[bool] = None


def experiment_of(path: str) -> str:
    """Top-level namespace prefix = the owning experiment (Table 1)."""
    parts = [p for p in path.split("/") if p]
    return parts[0] if parts else "unknown"


@dataclasses.dataclass
class FetchRollup:
    """Per-consumer rollup over :class:`~repro_torch.core.api.FetchResult`s —
    the unified stats model for data-plane consumers (data loader,
    checkpointer, serve engine).

    Every result a consumer sees goes through :meth:`add`; the rollup
    keeps the aggregate the consumer used to account privately
    (``bytes_fetched`` / ``fetch_seconds`` / ``hit_rate`` ...) plus a
    per-method breakdown, so :func:`consumer_table` can build the
    training/serving analogue of the paper's Table-1 usage table.
    ``local_hits`` (worker-local CVMFS chunks) count toward
    :attr:`hit_rate` — the best hit of all — but stay separate from
    ``cache_hits`` so site-tier accounting still reconciles against the
    federation's own counters.
    """

    consumer: str = ""
    fetches: int = 0
    stores: int = 0
    steps: int = 0               # consumer-defined unit (loader batches)
    bytes_fetched: int = 0
    bytes_stored: int = 0
    fetch_seconds: float = 0.0
    store_seconds: float = 0.0
    cache_hits: int = 0
    cache_misses: int = 0
    local_hits: int = 0
    chunks: int = 0
    hedged: int = 0
    sheds: int = 0
    errors: int = 0
    queue_seconds: float = 0.0
    by_method: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=dict)

    def add(self, res) -> "FetchRollup":
        """Fold one FetchResult (store results — method ``writeback*`` —
        land in the store lanes, everything else in the fetch lanes)."""
        method = res.method or "unknown"
        bucket = self.by_method.setdefault(
            method, {"count": 0, "bytes": 0, "seconds": 0.0})
        bucket["count"] += 1
        bucket["bytes"] += res.bytes
        bucket["seconds"] += res.seconds
        if method.startswith("writeback"):
            self.stores += 1
            self.bytes_stored += res.bytes
            self.store_seconds += res.seconds
        else:
            self.fetches += 1
            self.bytes_fetched += res.bytes
            self.fetch_seconds += res.seconds
        self.cache_hits += res.cache_hits
        self.cache_misses += res.cache_misses
        self.local_hits += getattr(res, "local_hits", 0)
        self.chunks += res.chunks
        if getattr(res, "hedged", False):
            self.hedged += 1
        if getattr(res, "shed", False):
            self.sheds += 1
        if not res.ok:
            self.errors += 1
        self.queue_seconds += getattr(res, "queue_seconds", 0.0)
        return self

    def tick(self) -> None:
        self.steps += 1

    @property
    def hit_rate(self) -> float:
        served = self.cache_hits + self.local_hits
        total = served + self.cache_misses
        return served / total if total else 0.0

    def merge(self, other: "FetchRollup") -> "FetchRollup":
        for f in ("fetches", "stores", "steps", "bytes_fetched",
                  "bytes_stored", "fetch_seconds", "store_seconds",
                  "cache_hits", "cache_misses", "local_hits", "chunks",
                  "hedged", "sheds", "errors", "queue_seconds"):
            setattr(self, f, getattr(self, f) + getattr(other, f))
        for m, b in other.by_method.items():
            mine = self.by_method.setdefault(
                m, {"count": 0, "bytes": 0, "seconds": 0.0})
            for k in mine:
                mine[k] += b[k]
        return self


def consumer_table(rollups) -> List[Dict[str, object]]:
    """Per-consumer usage rows (most bytes first) — the training/serving
    analogue of the paper's Table-1 per-experiment usage table."""
    rows = []
    for r in sorted(rollups, key=lambda r: -(r.bytes_fetched
                                             + r.bytes_stored)):
        rows.append({
            "consumer": r.consumer,
            "fetches": r.fetches,
            "stores": r.stores,
            "bytes_fetched": r.bytes_fetched,
            "bytes_stored": r.bytes_stored,
            "seconds": r.fetch_seconds + r.store_seconds,
            "hit_rate": round(r.hit_rate, 6),
            "hedged": r.hedged,
            "sheds": r.sheds,
            "errors": r.errors,
        })
    return rows


class MessageBus:
    """The OSG message bus: fan-out to subscribed databases/aggregators."""

    def __init__(self) -> None:
        self.subscribers: List[Callable[[TransferRecord], None]] = []
        self.published = 0

    def subscribe(self, fn: Callable[[TransferRecord], None]) -> None:
        self.subscribers.append(fn)

    def publish(self, record: TransferRecord) -> None:
        self.published += 1
        for fn in self.subscribers:
            fn(record)


class MonitorCollector:
    """Joins login/open/close packets into transfer records.

    ``drop_rate`` simulates UDP loss; a close whose open or login packet was
    lost is counted in ``unjoined`` rather than crashing the pipeline.
    """

    def __init__(self, bus: Optional[MessageBus] = None,
                 drop_rate: float = 0.0, seed: int = 0) -> None:
        self.bus = bus or MessageBus()
        self.drop_rate = drop_rate
        self._rng = random.Random(seed)
        self._logins: Dict[tuple, UserLogin] = {}
        self._opens: Dict[tuple, FileOpen] = {}
        self.cache_gauges: Dict[str, CacheUsagePacket] = {}
        self.unjoined = 0
        self.packets = 0

    def _delivered(self) -> bool:
        self.packets += 1
        return self._rng.random() >= self.drop_rate

    # -- packet sinks (called by cache/origin servers) ----------------------
    def user_login(self, ev: UserLogin) -> None:
        if self._delivered():
            self._logins[(ev.server, ev.user_id)] = ev

    def file_open(self, ev: FileOpen) -> None:
        if self._delivered():
            self._opens[(ev.server, ev.file_id)] = ev

    def cache_usage(self, pkt: CacheUsagePacket) -> None:
        """Gauge sink: keep the newest usage/policy packet per server."""
        if not self._delivered():
            return
        prev = self.cache_gauges.get(pkt.server)
        if prev is None or pkt.time >= prev.time:
            self.cache_gauges[pkt.server] = pkt

    def policy_table(self) -> List[tuple]:
        """Aggregate the latest gauges by eviction policy.

        Rows: ``(policy, caches, hit_rate, evictions, ttl_expired,
        admission_rejects, usage_bytes)`` sorted by policy name — the
        monitoring-side view of how each eviction policy is performing
        across the fleet.
        """
        agg: Dict[str, List[float]] = {}
        for pkt in self.cache_gauges.values():
            row = agg.setdefault(pkt.policy, [0, 0, 0, 0, 0, 0, 0])
            row[0] += 1
            row[1] += pkt.hits
            row[2] += pkt.misses
            row[3] += pkt.evictions
            row[4] += pkt.ttl_expired
            row[5] += pkt.admission_rejects
            row[6] += pkt.usage_bytes
        out = []
        for policy in sorted(agg):
            n, h, m, ev, ttl, rej, usage = agg[policy]
            out.append((policy, int(n), h / (h + m) if h + m else 0.0,
                        int(ev), int(ttl), int(rej), int(usage)))
        return out

    def tier_table(self) -> List[tuple]:
        """Aggregate the latest gauges by hierarchy tier.

        Rows: ``(tier, caches, hit_rate, bytes_from_parent,
        usage_bytes)`` sorted by tier — the monitoring-side view of how
        each level of a cache hierarchy is absorbing load (edge tiers
        should show the hits, upper tiers the cache-to-cache fill).
        """
        agg: Dict[int, List[float]] = {}
        for pkt in self.cache_gauges.values():
            row = agg.setdefault(pkt.tier, [0, 0, 0, 0, 0])
            row[0] += 1
            row[1] += pkt.hits
            row[2] += pkt.misses
            row[3] += pkt.bytes_from_parent
            row[4] += pkt.usage_bytes
        out = []
        for tier in sorted(agg):
            n, h, m, fill, usage = agg[tier]
            out.append((tier, int(n), h / (h + m) if h + m else 0.0,
                        int(fill), int(usage)))
        return out

    def file_close(self, ev: FileClose, cache_hit: Optional[bool] = None) -> None:
        if not self._delivered():
            return
        opened = self._opens.pop((ev.server, ev.file_id), None)
        if opened is None:
            self.unjoined += 1
            return
        login = self._logins.get((ev.server, opened.user_id))
        record = TransferRecord(
            server=ev.server,
            path=opened.path,
            experiment=experiment_of(opened.path),
            client_host=login.client_host if login else "unknown",
            protocol=login.protocol if login else "unknown",
            file_size=opened.file_size,
            bytes_read=ev.bytes_read,
            bytes_written=ev.bytes_written,
            n_ops=ev.n_ops,
            start_time=opened.time,
            end_time=ev.time,
            cache_hit=cache_hit,
        )
        self.bus.publish(record)


class SweepAggregator:
    """Per-cell aggregates for parameter sweeps (monitoring-side view).

    Ingests one ``(params, summary)`` row per sweep cell — exactly what
    :class:`~repro_torch.core.api.SweepCell` carries — and answers the
    questions an operator asks of a sweep: *how does a metric move along
    one axis, marginalized over the others?*  The tables sit next to
    :meth:`MonitorCollector.policy_table` as the aggregate surface the
    fleet benches publish.
    """

    def __init__(self) -> None:
        self.rows: List[tuple] = []   # (params, summary) per cell

    def add(self, params: Dict, summary: Dict) -> None:
        self.rows.append((dict(params), dict(summary)))

    def __len__(self) -> int:
        return len(self.rows)

    def axes(self) -> Dict[str, List]:
        """Observed axis values, in first-seen order per axis."""
        out: Dict[str, List] = {}
        for params, _ in self.rows:
            for k, v in params.items():
                vals = out.setdefault(k, [])
                if v not in vals:
                    vals.append(v)
        return out

    def marginal(self, axis: str, metric: str) -> List[tuple]:
        """``(value, cells, mean, min, max)`` of ``metric`` per value of
        ``axis``, marginalized over every other axis."""
        agg: Dict[object, List[float]] = {}
        order: List[object] = []
        for params, summary in self.rows:
            v = params.get(axis)
            if v not in agg:
                agg[v] = []
                order.append(v)
            agg[v].append(float(summary.get(metric, 0.0)))
        return [(v, len(agg[v]), sum(agg[v]) / len(agg[v]),
                 min(agg[v]), max(agg[v])) for v in order]

    def table(self, metric: str) -> List[tuple]:
        """One marginal row set per axis: ``(axis, value, cells, mean,
        min, max)`` — the flat per-cell aggregate a dashboard ingests."""
        out = []
        for axis in self.axes():
            for row in self.marginal(axis, metric):
                out.append((axis,) + row)
        return out

    POLICY_METRICS = ("hit_rate", "evictions", "bytes_evicted",
                      "admission_rejects")

    def policy_marginals(self, axis: Optional[str] = None) -> List[tuple]:
        """Per-eviction-policy marginals, the sweep-side sibling of
        :meth:`MonitorCollector.policy_table`.

        Rows: ``(policy, cells, hit_rate, evictions, bytes_evicted,
        admission_rejects)`` — means over every cell sharing the policy
        value, marginalized over all other axes.  ``axis`` defaults to
        the first observed axis whose name ends with
        ``"eviction_policy"`` (the sweep executor's spelling is
        ``"federation.eviction_policy"``).
        """
        if axis is None:
            axis = next((a for a in self.axes()
                         if a.endswith("eviction_policy")), None)
            if axis is None:
                return []
        means = {metric: {v: mean for v, _, mean, _, _
                          in self.marginal(axis, metric)}
                 for metric in self.POLICY_METRICS}
        return [(value, cells) + tuple(means[m][value]
                                       for m in self.POLICY_METRICS)
                for value, cells, *_ in self.marginal(axis, "hit_rate")]

    def hit_rate_curve(self, axis: Optional[str] = None,
                       metric: str = "hit_rate") -> List[tuple]:
        """``metric`` vs. capacity, one curve per sweep *column*.

        A column is one combination of every axis except ``axis``
        (default: the first observed axis whose name ends with
        ``"cache_capacity"`` — the sweep executor's spelling is
        ``"federation.cache_capacity"``).  Rows:
        ``(column_params, [(capacity, value), ...])`` with the curve
        sorted by capacity ascending — the validation table the
        planner's fitted ``H(C)`` curves are held against
        (``bench_plan``, notebooks)."""
        if axis is None:
            axis = next((a for a in self.axes()
                         if a.endswith("cache_capacity")), None)
            if axis is None:
                return []
        cols: Dict[tuple, List[tuple]] = {}
        order: List[tuple] = []
        for params, summary in self.rows:
            if axis not in params:
                continue
            key = tuple((k, v) for k, v in params.items() if k != axis)
            if key not in cols:
                cols[key] = []
                order.append(key)
            cols[key].append((params[axis],
                              float(summary.get(metric, 0.0))))
        return [(dict(key), sorted(cols[key])) for key in order]

    def model_residuals(self, predict: Callable[[Dict], Optional[float]],
                        metric: str = "hit_rate") -> List[tuple]:
        """Observed-vs-predicted validation table for a fitted model.

        ``predict`` maps a cell's params dict to the model's value for
        ``metric`` (return ``None`` to skip a cell — e.g. a policy the
        model does not cover).  Rows: ``(params, observed, predicted,
        residual)`` with ``residual = predicted − observed``; the
        forward-model acceptance gate asserts
        ``max(abs(residual)) <= 0.02`` over a held-out grid.  Plain
        numpy-free plumbing — the model side stays in
        :mod:`repro_torch.kernels.cache_model`, monitoring only tabulates."""
        rows: List[tuple] = []
        for params, summary in self.rows:
            pred = predict(params)
            if pred is None:
                continue
            obs = float(summary.get(metric, 0.0))
            rows.append((dict(params), obs, float(pred),
                         float(pred) - obs))
        return rows


class UsageAggregator:
    """Builds Table 1 (usage by experiment) and Fig. 4 (usage over time)."""

    def __init__(self, bucket_seconds: float = 86400.0) -> None:
        self.bucket_seconds = bucket_seconds
        self.by_experiment: Dict[str, int] = defaultdict(int)
        self.by_bucket: Dict[int, int] = defaultdict(int)
        self.records = 0

    def __call__(self, rec: TransferRecord) -> None:
        self.records += 1
        moved = rec.bytes_read + rec.bytes_written
        self.by_experiment[rec.experiment] += moved
        self.by_bucket[int(rec.end_time // self.bucket_seconds)] += moved

    def usage_table(self) -> List[tuple]:
        """(experiment, bytes) sorted descending — the paper's Table 1."""
        return sorted(self.by_experiment.items(), key=lambda kv: -kv[1])

    def time_series(self) -> List[tuple]:
        return sorted(self.by_bucket.items())


# ---------------------------------------------------------------------------
# Streaming health gauges (control plane)


class DecayGauge:
    """Exponentially time-decayed counter: ``add`` events, ``read`` a rate.

    The stored value decays with time constant ``tau`` so the gauge
    tracks *recent* behaviour without keeping a window of samples.
    Reads are pure — ``read(now)`` never mutates state — and monotone
    non-increasing under silence, which the property suite checks.
    """

    def __init__(self, tau: float = 60.0) -> None:
        self.tau = float(tau)
        self.value = 0.0
        self.t = 0.0

    def read(self, now: float) -> float:
        if now <= self.t:
            return self.value
        return self.value * math.exp(-(now - self.t) / self.tau)

    def add(self, x: float, now: float) -> None:
        self.value = self.read(now) + x
        self.t = max(self.t, now)


class SpaceSavingTopK:
    """Misra-Gries/space-saving heavy hitters over a bounded key table.

    Tracks the (approximately) top-``k`` keys by total weight using O(k)
    memory: an unseen key evicts the current minimum and inherits its
    count as the over-estimate error bound.
    """

    def __init__(self, k: int = 8) -> None:
        self.k = max(1, int(k))
        self.counts: Dict[str, float] = {}
        self.errors: Dict[str, float] = {}

    def add(self, key: str, weight: float = 1.0) -> None:
        if key in self.counts:
            self.counts[key] += weight
            return
        if len(self.counts) < self.k:
            self.counts[key] = weight
            self.errors[key] = 0.0
            return
        victim = min(self.counts, key=lambda kk: (self.counts[kk], kk))
        floor = self.counts.pop(victim)
        self.errors.pop(victim)
        self.counts[key] = floor + weight
        self.errors[key] = floor

    def top(self, n: Optional[int] = None) -> List[tuple]:
        """``(key, count, error)`` sorted by count descending."""
        rows = sorted(self.counts.items(), key=lambda kv: (-kv[1], kv[0]))
        if n is not None:
            rows = rows[:n]
        return [(k, c, self.errors[k]) for k, c in rows]


class CacheHealthMonitor:
    """Per-cache streaming health: decayed error/latency rates + hitters.

    ``observe`` feeds one transfer outcome; ``unhealthy`` answers whether
    the decayed error rate (errors / samples over the last ~``tau``
    seconds) or the latency EWMA has crossed its threshold, given enough
    recent samples to mean anything.  ``demand`` tracks per-tenant bytes
    in a space-saving sketch so operators can name the heavy hitters.

    This class only *measures*; acting on it (``mark_down(auto=True)``)
    is the job of :class:`repro_torch.core.controlplane.ControlPlane`.
    """

    LATENCY_ALPHA = 0.3

    def __init__(self, tau: float = 60.0, topk: int = 8) -> None:
        self.tau = float(tau)
        self._errors: Dict[str, DecayGauge] = {}
        self._totals: Dict[str, DecayGauge] = {}
        self._latency: Dict[str, float] = {}
        self.hitters = SpaceSavingTopK(topk)

    def _gauge(self, table: Dict[str, DecayGauge], cache: str) -> DecayGauge:
        g = table.get(cache)
        if g is None:
            g = DecayGauge(self.tau)
            table[cache] = g
        return g

    def observe(self, cache: str, ok: bool, latency: float,
                now: float) -> None:
        self._gauge(self._totals, cache).add(1.0, now)
        if not ok:
            self._gauge(self._errors, cache).add(1.0, now)
        elif latency > 0:
            prev = self._latency.get(cache)
            if prev is None:
                self._latency[cache] = latency
            else:
                a = self.LATENCY_ALPHA
                self._latency[cache] = a * latency + (1 - a) * prev

    def demand(self, tenant: str, nbytes: float = 0.0) -> None:
        self.hitters.add(tenant, max(float(nbytes), 1.0))

    def samples(self, cache: str, now: float) -> float:
        g = self._totals.get(cache)
        return g.read(now) if g is not None else 0.0

    def error_rate(self, cache: str, now: float) -> float:
        total = self.samples(cache, now)
        if total <= 0:
            return 0.0
        g = self._errors.get(cache)
        errors = g.read(now) if g is not None else 0.0
        return min(1.0, errors / total)

    def latency(self, cache: str) -> float:
        return self._latency.get(cache, 0.0)

    def unhealthy(self, cache: str, now: float, error_threshold: float,
                  min_samples: float = 4.0,
                  latency_threshold: Optional[float] = None) -> bool:
        if self.samples(cache, now) < min_samples:
            return False
        if self.error_rate(cache, now) >= error_threshold:
            return True
        if (latency_threshold is not None
                and self.latency(cache) >= latency_threshold):
            return True
        return False

    def reset(self, cache: str) -> None:
        self._errors.pop(cache, None)
        self._totals.pop(cache, None)
        self._latency.pop(cache, None)

    def top_tenants(self, n: int = 5) -> List[tuple]:
        return self.hitters.top(n)
