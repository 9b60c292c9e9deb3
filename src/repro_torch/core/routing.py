"""Pluggable cache-ranking policies (latency-aware routing).

The paper's clients pick a cache by *static* GeoIP distance (§3.1).  The
CDN follow-on (arXiv:2007.01408) replaced that with latency-driven
selection: clients probe the caches they use and re-rank when one starts
failing or slowing down — static distance is only the prior.  This module
makes the ranking a policy object so both client surfaces
(:class:`~repro_torch.core.client.StashClient` and
:class:`~repro_torch.core.simclient.SimStashClient`) share one implementation:

* :class:`StaticRankingPolicy` — the paper's behaviour, byte-identical
  to the historical inline ranking (GeoIP distance with the
  deterministic ``(distance, name)`` tie-break).
* :class:`ProbeRankingPolicy` — per-cache latency EWMAs self-calibrated
  against each cache's first observation, with multiplicative failure
  penalties that decay on success.  A cache that dies (or degrades)
  sinks in the ranking after a few failures and climbs back as probes
  succeed again — re-ranking under churn without a control plane.

``ranked_caches`` is the one ranking pipeline: groups ordered by the
policy over their ring loci, members in consistent-hash ring order
within a group, stray (ungrouped) caches policy-ranked at the tail.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union, TYPE_CHECKING

if TYPE_CHECKING:  # pragma: no cover - typing only
    from .cache import CacheServer
    from .ring import CacheGroup
    from .topology import GeoIPService


class RankingPolicy:
    """Orders candidate cache *names* for one client.

    ``order`` must be a total, deterministic order.  ``observe`` /
    ``on_failure`` are the probe feedback hooks; the static policy
    ignores them (which is what makes static rankings vectorizable in
    the batched sweep executor — they never depend on history).
    """

    name = "static"

    def order(self, client: str, names: Sequence[str],
              geoip: "GeoIPService",
              exclude: Sequence[str] = ()) -> List[str]:
        return geoip.nearest(client, names, exclude=exclude)

    def observe(self, cache_name: str, seconds: float) -> None:
        pass

    def on_failure(self, cache_name: str) -> None:
        pass


class StaticRankingPolicy(RankingPolicy):
    """Static GeoIP-distance ranking — the paper's client behaviour."""


class ProbeRankingPolicy(RankingPolicy):
    """Latency-probe ranking: static distance as prior, re-ranked by
    observed behaviour.

    Each cache's score is ``penalty × (ewma / base)`` where ``base`` is
    the first latency this client observed from the cache (so scores are
    relative slowdowns, comparable across caches serving different
    object mixes) and ``penalty`` multiplies by ``failure_penalty`` per
    failure and decays by ``recovery`` per subsequent success.  Unprobed
    caches score 1.0 and keep their static rank — the policy only
    *re-ranks* on evidence.
    """

    name = "probe"

    def __init__(self, alpha: float = 0.3, failure_penalty: float = 8.0,
                 recovery: float = 0.5) -> None:
        self.alpha = alpha
        self.failure_penalty = failure_penalty
        self.recovery = recovery
        self.ewma: Dict[str, float] = {}
        self.base: Dict[str, float] = {}
        self.penalty: Dict[str, float] = {}

    def score(self, name: str) -> float:
        base = self.base.get(name)
        rel = (self.ewma[name] / base) if base else 1.0
        return self.penalty.get(name, 1.0) * rel

    def order(self, client: str, names: Sequence[str],
              geoip: "GeoIPService",
              exclude: Sequence[str] = ()) -> List[str]:
        static = geoip.nearest(client, names, exclude=exclude)
        rank = {n: i for i, n in enumerate(static)}
        return sorted(static, key=lambda n: (self.score(n), rank[n]))

    def observe(self, cache_name: str, seconds: float) -> None:
        if seconds <= 0:
            return
        if cache_name not in self.base:
            self.base[cache_name] = seconds
            self.ewma[cache_name] = seconds
        else:
            self.ewma[cache_name] = (self.alpha * seconds
                                     + (1 - self.alpha) * self.ewma[cache_name])
        p = self.penalty.get(cache_name, 1.0)
        if p > 1.0:
            self.penalty[cache_name] = max(1.0, p * self.recovery)

    def on_failure(self, cache_name: str) -> None:
        self.penalty[cache_name] = min(
            self.penalty.get(cache_name, 1.0) * self.failure_penalty, 1e9)


RANKING_POLICIES = {"static": StaticRankingPolicy, "probe": ProbeRankingPolicy}


def make_ranking_policy(spec: Union[str, RankingPolicy, None]
                        ) -> RankingPolicy:
    if spec is None:
        return StaticRankingPolicy()
    if isinstance(spec, RankingPolicy):
        return spec
    try:
        return RANKING_POLICIES[spec]()
    except KeyError:
        raise ValueError(f"unknown ranking policy {spec!r}; "
                         f"expected one of {sorted(RANKING_POLICIES)}")


def ranked_caches(client: str, caches: Dict[str, "CacheServer"],
                  groups: Sequence["CacheGroup"], geoip: "GeoIPService",
                  policy: Optional[RankingPolicy] = None,
                  path: Optional[str] = None,
                  exclude: Sequence[str] = (),
                  limit: Optional[int] = None,
                  count_stats: bool = True) -> List["CacheServer"]:
    """Cache servers in preference order for ``path``.

    Without HA groups this is the pure policy order.  With groups, the
    *groups* are ranked (by their ring loci) and each contributes its
    members in consistent-hash ring order for the path — so a given
    object always lands on the same member of the nearest group, and a
    dead member degrades to the next ring member instead of straight to
    the origin.  Stray (ungrouped) caches participate policy-ranked at
    the tail.

    ``limit`` truncates the failover tail: a fleet-scale ranking over
    1000+ single-member groups otherwise walks every group's ring per
    request even though only the first few entries are ever tried.
    ``count_stats=False`` makes the ranking a pure query (convenience
    lookups like ``Federation.nearest_cache`` must not inflate the
    serving group's route/failover counters).
    """
    policy = policy or StaticRankingPolicy()
    if groups and path is not None:
        locus = {g.name: g.locus().name for g in groups
                 if g.locus() is not None}
        order = policy.order(client, list(locus.values()), geoip)
        by_locus = {locus[g.name]: g for g in groups if g.name in locus}
        ranked: List["CacheServer"] = []
        for locus_name in order:
            if limit is not None and len(ranked) >= limit:
                return ranked[:limit]
            # only the group that heads the ranking is actually being
            # routed to; the rest are its fleet-wide failover tail.
            members = by_locus[locus_name].route(
                path, exclude=exclude,
                count_stats=count_stats and not ranked)
            ranked.extend(members)
        # stray caches not in any group still participate, policy-ranked.
        grouped = {c.name for g in groups for c in g.members}
        stray = [n for n in caches if n not in grouped and n not in exclude]
        if stray:
            for n in policy.order(client, stray, geoip):
                ranked.append(caches[n])
        return ranked[:limit] if limit is not None else ranked
    order = policy.order(client, list(caches), geoip, exclude=exclude)
    ranked = [caches[n] for n in order]
    return ranked[:limit] if limit is not None else ranked
