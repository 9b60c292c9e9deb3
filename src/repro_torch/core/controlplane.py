"""Production control plane: admission queues, circuit breakers, quotas.

The paper's caches serve opportunistic users who neither own the hardware
nor control demand.  Without a control plane, excess load just contends on
links (the fluid solver is work-conserving, so everything slows down
together) and outages have to be scripted.  This module supplies the three
mechanisms real federations use to stay up under abuse:

* **Admission queues** — each cache admits at most ``max_concurrent``
  transfers; excess arrivals wait in a bounded FIFO and are *shed* (an
  explicit refusal, not silent contention) once ``queue_depth`` waiters
  are already parked.
* **Per-tenant quotas / fair share** — a tenant may hold at most
  ``tenant_quota`` of a cache's service slots, and the dequeue order is
  max-min fair across tenants (fewest-slots-held first, FIFO within a
  tenant), so one abusive experiment cannot starve the rest.
* **Circuit breakers + backoff** — clients track per-cache failures and
  stop hammering a cache that keeps erroring (closed → open → half-open),
  retrying elsewhere with exponential backoff instead of blind failover.

Health-driven demotion (time-decayed error gauges firing
``CacheGroup.mark_down(auto=True)``) lives in :mod:`repro_torch.core.monitoring`;
:class:`ControlPlane` here is the runtime that binds all of it to a
federation for one scenario run.

Everything is engine-agnostic: the same :class:`ControlPlaneSpec` drives
the coroutine :class:`AdmissionQueue` under the fluid simulator and the
:class:`AnalyticQueue` c-server model under the analytic plane.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, Generator, List, Optional, Tuple

from .monitoring import CacheHealthMonitor

__all__ = [
    "ControlPlaneSpec",
    "ControlStats",
    "CircuitBreaker",
    "AdmissionQueue",
    "AnalyticQueue",
    "ControlPlane",
    "fair_shares",
]


# ---------------------------------------------------------------------------
# Declarative knobs


@dataclasses.dataclass(frozen=True)
class ControlPlaneSpec:
    """All control-plane knobs for one scenario, declaratively.

    ``tenant_quota`` is the fraction of a cache's ``max_concurrent``
    service slots a single tenant may hold (1.0 disables quotas).
    ``queue_depth`` bounds how many requests may *wait* at one cache;
    arrivals beyond that are shed.  Breaker/backoff knobs shape the
    client retry loop; health knobs shape gauge-driven auto demotion.
    """

    max_concurrent: int = 32
    queue_depth: int = 64
    tenant_quota: float = 1.0
    # client retry behaviour
    backoff_base: float = 0.1
    backoff_multiplier: float = 2.0
    backoff_max: float = 10.0
    # per-cache circuit breakers
    breaker_enabled: bool = True
    breaker_threshold: int = 5
    breaker_cooldown: float = 30.0
    # streaming-gauge health -> automatic mark_down / mark_up
    health_enabled: bool = True
    error_threshold: float = 0.5
    latency_threshold: Optional[float] = None
    min_samples: float = 4.0
    gauge_tau: float = 60.0
    health_cooldown: float = 60.0
    topk: int = 8

    def __post_init__(self):
        if self.max_concurrent < 1:
            raise ValueError("max_concurrent must be >= 1")
        if self.queue_depth < 0:
            raise ValueError("queue_depth must be >= 0")
        if not 0.0 < self.tenant_quota <= 1.0:
            raise ValueError("tenant_quota must be in (0, 1]")
        if self.breaker_threshold < 1:
            raise ValueError("breaker_threshold must be >= 1")

    def quota_slots(self) -> int:
        """Service slots a single tenant may hold at one cache."""
        if self.tenant_quota >= 1.0:
            return self.max_concurrent
        return max(1, int(self.max_concurrent * self.tenant_quota))


@dataclasses.dataclass
class ControlStats:
    """Counters for one scenario's control-plane activity."""

    sheds: int = 0
    queue_waits: int = 0
    queue_wait_seconds: float = 0.0
    retries: int = 0
    backoff_seconds: float = 0.0
    breaker_opens: int = 0
    breaker_skips: int = 0
    auto_downs: int = 0
    auto_ups: int = 0
    shed_by_tenant: Dict[str, int] = dataclasses.field(default_factory=dict)

    def record_shed(self, tenant: str) -> None:
        self.sheds += 1
        key = tenant or "default"
        self.shed_by_tenant[key] = self.shed_by_tenant.get(key, 0) + 1


# ---------------------------------------------------------------------------
# Fair share


def fair_shares(demands: List[float], capacity: float,
                weights: Optional[List[float]] = None) -> List[float]:
    """Max-min fair (water-filling) allocation of ``capacity`` to demands.

    Returns per-demand allocations such that no allocation exceeds its
    demand, the total never exceeds ``capacity``, and — when demand
    outstrips supply — unsatisfied tenants split the remainder in
    proportion to ``weights`` (equal by default).  Invariant used by the
    property tests: ``sum(alloc) == min(capacity, sum(demands))``.
    """
    n = len(demands)
    if n == 0:
        return []
    w = list(weights) if weights is not None else [1.0] * n
    if len(w) != n or any(x <= 0 for x in w):
        raise ValueError("weights must be positive and match demands")
    alloc = [0.0] * n
    remaining = max(0.0, capacity)
    active = [i for i in range(n) if demands[i] > 0]
    while active and remaining > 1e-12:
        total_w = sum(w[i] for i in active)
        # smallest normalised headroom decides how far this round fills
        level = min((demands[i] - alloc[i]) / w[i] for i in active)
        level = min(level, remaining / total_w)
        for i in active:
            alloc[i] += level * w[i]
        remaining -= level * total_w
        active = [i for i in active if demands[i] - alloc[i] > 1e-12]
    return alloc


# ---------------------------------------------------------------------------
# Circuit breaker FSM


class CircuitBreaker:
    """Classic 3-state breaker: closed → open → half-open → {open, closed}.

    ``allow`` answers "may I try this cache now?"; ``on_success`` /
    ``on_failure`` feed outcomes back.  The only legal transitions are
    closed→open (threshold consecutive failures), open→half-open (cooldown
    elapsed, one probe allowed), half-open→closed (probe succeeded) and
    half-open→open (probe failed) — the property suite checks exactly
    this edge set via :attr:`state`.
    """

    CLOSED = "closed"
    OPEN = "open"
    HALF_OPEN = "half-open"

    def __init__(self, threshold: int = 5, cooldown: float = 30.0):
        self.threshold = int(threshold)
        self.cooldown = float(cooldown)
        self.state = self.CLOSED
        self.failures = 0
        self.opened_at = 0.0
        self.opens = 0

    def allow(self, now: float) -> bool:
        if self.state == self.OPEN:
            if now >= self.opened_at + self.cooldown:
                self.state = self.HALF_OPEN
                return True
            return False
        return True  # closed, or half-open probe in flight

    def on_success(self, now: float) -> None:
        self.failures = 0
        if self.state == self.HALF_OPEN:
            self.state = self.CLOSED

    def on_failure(self, now: float) -> None:
        if self.state == self.HALF_OPEN:
            self.state = self.OPEN
            self.opened_at = now
            self.opens += 1
            return
        self.failures += 1
        if self.state == self.CLOSED and self.failures >= self.threshold:
            self.state = self.OPEN
            self.opened_at = now
            self.opens += 1


# ---------------------------------------------------------------------------
# Admission queues — coroutine (fluid sim) and analytic (c-server) flavours


class AdmissionQueue:
    """Bounded-concurrency admission at one cache, for the coroutine sim.

    ``acquire`` is a generator: it either grants a slot immediately,
    sheds (returns ``False`` without yielding a wait), or parks the
    caller on an :class:`~repro_torch.core.simulator.Event` until ``release``
    drains it back in.  Dequeue order is fair-share: among eligible
    waiters, the tenant currently holding the fewest slots goes first,
    FIFO within a tenant.
    """

    def __init__(self, sim, spec: ControlPlaneSpec,
                 stats: Optional[ControlStats] = None, name: str = ""):
        self.sim = sim
        self.spec = spec
        self.stats = stats if stats is not None else ControlStats()
        self.name = name
        self.in_service = 0
        self.by_tenant: Dict[str, int] = {}
        self.waiting: List[Tuple[str, object]] = []
        self.max_in_service = 0
        self.max_waiting = 0

    def can_admit(self, tenant: str = "") -> bool:
        if self.in_service >= self.spec.max_concurrent:
            return False
        if (self.spec.tenant_quota < 1.0
                and self.by_tenant.get(tenant, 0) >= self.spec.quota_slots()):
            return False
        return True

    def _grant(self, tenant: str) -> None:
        self.in_service += 1
        self.by_tenant[tenant] = self.by_tenant.get(tenant, 0) + 1
        self.max_in_service = max(self.max_in_service, self.in_service)

    def acquire(self, tenant: str = "") -> Generator:
        """Yield-from this; returns True (admitted) or False (shed)."""
        # Barge only past waiters that are themselves quota-blocked: a
        # same-tenant waiter or any admittable waiter keeps FIFO order.
        if self.can_admit(tenant) and not any(
                t == tenant or self.can_admit(t) for t, _ in self.waiting):
            self._grant(tenant)
            return True
        if len(self.waiting) >= self.spec.queue_depth:
            self.stats.record_shed(tenant)
            return False
        ev = self.sim.event()
        self.waiting.append((tenant, ev))
        self.max_waiting = max(self.max_waiting, len(self.waiting))
        t0 = self.sim.t
        yield ev
        self.stats.queue_waits += 1
        self.stats.queue_wait_seconds += self.sim.t - t0
        return True

    def release(self, tenant: str = "") -> None:
        self.in_service -= 1
        held = self.by_tenant.get(tenant, 0)
        if held <= 1:
            self.by_tenant.pop(tenant, None)
        else:
            self.by_tenant[tenant] = held - 1
        self._drain()

    def _drain(self) -> None:
        while self.waiting:
            best_i = None
            best_key: Optional[Tuple[int, int]] = None
            seen = set()
            for i, (tenant, _) in enumerate(self.waiting):
                if tenant in seen:
                    continue  # FIFO within a tenant: only its head competes
                seen.add(tenant)
                if not self.can_admit(tenant):
                    continue
                key = (self.by_tenant.get(tenant, 0), i)
                if best_key is None or key < best_key:
                    best_key, best_i = key, i
            if best_i is None:
                return
            tenant, ev = self.waiting.pop(best_i)
            self._grant(tenant)
            ev.set()


class AnalyticQueue:
    """c-server FIFO queue for the analytic plane's instant accounting.

    The analytic plane processes requests in arrival order, so a heap of
    per-slot free times reproduces queue waits exactly.  The shed
    decision (would this arrival have to wait while ``queue_depth``
    others already do?) depends only on the arrival time and current
    heap state — never on this request's own service time — so callers
    ``reserve`` before doing the transfer and ``commit`` the measured
    service time afterwards.
    """

    def __init__(self, spec: ControlPlaneSpec,
                 stats: Optional[ControlStats] = None):
        self.spec = spec
        self.stats = stats if stats is not None else ControlStats()
        self.free_at = [0.0] * spec.max_concurrent
        self.tenant_free: Dict[str, List[float]] = {}
        self._pending_starts: List[float] = []

    def reserve(self, t: float, tenant: str = "") -> Optional[float]:
        """Return the start time for an arrival at ``t``, or None = shed."""
        self._pending_starts = [s for s in self._pending_starts if s > t]
        start = max(t, self.free_at[0])
        if self.spec.tenant_quota < 1.0:
            th = self.tenant_free.setdefault(
                tenant, [0.0] * self.spec.quota_slots())
            start = max(start, th[0])
        if start > t and len(self._pending_starts) >= self.spec.queue_depth:
            self.stats.record_shed(tenant)
            return None
        return start

    def commit(self, t: float, start: float, seconds: float,
               tenant: str = "") -> float:
        """Occupy a slot for [start, start+seconds); return the wait."""
        heapq.heapreplace(self.free_at, start + seconds)
        if self.spec.tenant_quota < 1.0:
            th = self.tenant_free.setdefault(
                tenant, [0.0] * self.spec.quota_slots())
            heapq.heapreplace(th, start + seconds)
        wait = start - t
        if wait > 0:
            self._pending_starts.append(start)
            self.stats.queue_waits += 1
            self.stats.queue_wait_seconds += wait
        return wait


# ---------------------------------------------------------------------------
# Runtime


class ControlPlane:
    """Binds one :class:`ControlPlaneSpec` to a federation for a run.

    Lazily creates one breaker and one admission queue per cache, owns
    the shared :class:`ControlStats`, and bridges streaming health
    gauges to ``CacheGroup.mark_down(auto=True)`` / ``mark_up``.
    ``group_of`` maps cache name → its :class:`~repro_torch.core.ring.CacheGroup`
    so auto demotion routes through the ring (remaps keys, counts stats)
    exactly like a scripted outage would.
    """

    def __init__(self, spec: ControlPlaneSpec, sim=None,
                 group_of: Optional[Dict[str, object]] = None):
        self.spec = spec
        self.sim = sim
        self.group_of = group_of or {}
        self.stats = ControlStats()
        self.breakers: Dict[str, CircuitBreaker] = {}
        self.queues: Dict[str, object] = {}
        self.health = CacheHealthMonitor(tau=spec.gauge_tau, topk=spec.topk)
        self._auto_down: Dict[str, float] = {}

    # -- breakers ----------------------------------------------------------

    def breaker(self, name: str) -> CircuitBreaker:
        br = self.breakers.get(name)
        if br is None:
            br = CircuitBreaker(self.spec.breaker_threshold,
                                self.spec.breaker_cooldown)
            self.breakers[name] = br
        return br

    def allow(self, name: str, now: float) -> bool:
        """May the client attempt this cache now? (breaker gate)"""
        if not self.spec.breaker_enabled:
            return True
        if self.breaker(name).allow(now):
            return True
        self.stats.breaker_skips += 1
        return False

    def backoff(self, attempt: int) -> float:
        """Exponential backoff delay before the (attempt+1)-th retry."""
        return min(self.spec.backoff_base
                   * self.spec.backoff_multiplier ** attempt,
                   self.spec.backoff_max)

    # -- admission ---------------------------------------------------------

    def queue(self, name: str):
        q = self.queues.get(name)
        if q is None:
            if self.sim is not None:
                q = AdmissionQueue(self.sim, self.spec, self.stats, name)
            else:
                q = AnalyticQueue(self.spec, self.stats)
            self.queues[name] = q
        return q

    def acquire(self, name: str, tenant: str = "",
                nbytes: int = 0) -> Generator:
        """Sim engines: yield-from; returns True (admitted) / False (shed)."""
        self.health.demand(tenant or "default", nbytes)
        admitted = yield from self.queue(name).acquire(tenant)
        return admitted

    def release(self, name: str, tenant: str = "") -> None:
        q = self.queues.get(name)
        if q is not None:
            q.release(tenant)

    # -- outcome feedback + health ----------------------------------------

    def on_success(self, name: str, now: float, seconds: float = 0.0,
                   tenant: str = "", nbytes: int = 0) -> None:
        if self.spec.breaker_enabled:
            self.breaker(name).on_success(now)
        if self.spec.health_enabled:
            self.health.observe(name, ok=True, latency=seconds, now=now)

    def on_failure(self, name: str, now: float) -> None:
        if self.spec.breaker_enabled:
            br = self.breaker(name)
            was = br.state
            br.on_failure(now)
            if br.state == CircuitBreaker.OPEN and was != CircuitBreaker.OPEN:
                self.stats.breaker_opens += 1
        if self.spec.health_enabled:
            self.health.observe(name, ok=False, latency=0.0, now=now)
            self._health_check(name, now)

    def _health_check(self, name: str, now: float) -> None:
        """Demote via the ring when the streaming gauges say unhealthy."""
        if name in self._auto_down:
            return
        group = self.group_of.get(name)
        if group is None:
            return
        cache = group.caches.get(name)
        if cache is None or not cache.available:
            return  # already down (scripted or otherwise): nothing to demote
        if self.health.unhealthy(name, now, self.spec.error_threshold,
                                 self.spec.min_samples,
                                 self.spec.latency_threshold):
            group.mark_down(name, auto=True)
            self._auto_down[name] = now
            self.stats.auto_downs += 1
            self.health.reset(name)

    def maybe_recover(self, name: str, now: float) -> bool:
        """Lazy probe: re-admit an auto-demoted cache after its cooldown.

        Called from the client routing path (there is deliberately no
        periodic controller coroutine — it would keep the simulator's
        event loop alive forever).  Never touches a cache this control
        plane did not itself demote: if a scripted schedule already
        brought it back, just drop our record without double-counting.
        """
        t_down = self._auto_down.get(name)
        if t_down is None:
            return False
        group = self.group_of.get(name)
        cache = group.caches.get(name) if group is not None else None
        if cache is not None and cache.available:
            del self._auto_down[name]  # someone else recovered it
            return False
        if now < t_down + self.spec.health_cooldown:
            return False
        del self._auto_down[name]
        if group is not None:
            group.mark_up(name, auto=True)
            self.stats.auto_ups += 1
            self.health.reset(name)
            # fresh breaker so the recovered cache gets a clean probe
            self.breakers.pop(name, None)
        return True
