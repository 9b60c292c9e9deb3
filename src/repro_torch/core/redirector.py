"""Redirectors — the data-discovery service (paper §3).

Caches query the redirector for the location of data; the redirector polls
its subscribed origins and returns the hostname of the one that holds the
path.  StashCache runs *two* redirectors in a round-robin, high-availability
configuration; ``RedirectorPair`` reproduces that: requests alternate
between the two, and a dead redirector is skipped transparently.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Union

from .namespace import Namespace
from .origin import Origin
from .topology import Node


@dataclasses.dataclass
class RedirectorStats:
    locate_requests: int = 0
    origin_polls: int = 0
    not_found: int = 0


class Redirector:
    """A single redirector instance."""

    def __init__(self, name: str, node: Node) -> None:
        self.name = name
        self.node = node
        self.namespace = Namespace()
        self.origins: Dict[str, Origin] = {}
        self.stats = RedirectorStats()
        self.available = True  # failure injection point

    def subscribe(self, origin: Origin) -> None:
        """Origins subscribe to the redirector (paper §3)."""
        self.origins[origin.name] = origin
        for prefix in origin.exports:
            self.namespace.register(prefix, origin.name)

    def unsubscribe(self, origin: Union[Origin, str]) -> None:
        """Unregister an origin *and* its namespace prefixes.

        Without the prefix cleanup, multi-origin scenarios that retire an
        origin leave dangling namespace entries whose longest-prefix match
        makes ``locate`` poll a dead owner forever.  Prefixes are taken
        from the namespace (not ``origin.exports``) so prefixes registered
        after subscription are cleaned up too.
        """
        name = origin.name if isinstance(origin, Origin) else origin
        self.origins.pop(name, None)
        for prefix in self.namespace.exports(name):
            self.namespace.unregister(prefix)

    def locate(self, path: str) -> Optional[Origin]:
        """Find the origin that holds ``path``.

        The namespace gives the candidate by longest-prefix match; the
        redirector then *asks the origin* whether it really has the file
        (the paper's query-the-origins step), falling back to polling all
        subscribed origins if the prefix owner denies it.
        """
        if not self.available:
            raise ConnectionError(f"redirector {self.name} unavailable")
        self.stats.locate_requests += 1
        owner = self.namespace.resolve(path)
        if owner is not None:
            self.stats.origin_polls += 1
            origin = self.origins[owner]
            if origin.has(path):
                return origin
        for origin in self.origins.values():
            if origin.name == owner:
                continue
            self.stats.origin_polls += 1
            if origin.has(path):
                return origin
        self.stats.not_found += 1
        return None


class RedirectorGroup:
    """N redirectors in round-robin, high-availability configuration.

    The paper runs exactly two; fleet deployments want the same idiom at
    arbitrary width (and the cache tier reuses the generalized failover
    semantics via :mod:`repro_torch.core.ring`): requests rotate across live
    members, dead members are skipped transparently and counted as
    failovers, and only when *every* member is down does the group raise.
    """

    def __init__(self, members: List[Redirector]) -> None:
        if not members:
            raise ValueError("a redirector group needs at least one member")
        self.members = list(members)
        self._next = 0
        self.failovers = 0

    def subscribe(self, origin: Origin) -> None:
        for r in self.members:
            r.subscribe(origin)

    def unsubscribe(self, origin: Union[Origin, str]) -> None:
        for r in self.members:
            r.unsubscribe(origin)

    def locate(self, path: str) -> Optional[Origin]:
        for attempt in range(len(self.members)):
            r = self.members[self._next % len(self.members)]
            self._next += 1
            if not r.available:
                self.failovers += 1
                continue
            return r.locate(path)
        raise ConnectionError("all redirectors unavailable")

    @property
    def stats(self) -> RedirectorStats:
        agg = RedirectorStats()
        for r in self.members:
            agg.locate_requests += r.stats.locate_requests
            agg.origin_polls += r.stats.origin_polls
            agg.not_found += r.stats.not_found
        return agg


class RedirectorPair(RedirectorGroup):
    """The paper's two-member deployment (§3)."""

    def __init__(self, primary: Redirector, secondary: Redirector) -> None:
        super().__init__([primary, secondary])
