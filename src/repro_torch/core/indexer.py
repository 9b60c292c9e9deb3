"""The CVMFS indexer (paper §3.1).

To give CVMFS a POSIX view of an origin, an indexer scans the remote origin
and gathers metadata: file names/directory structure, sizes, permissions and
*checksums along the chunk boundaries*.  Changes are detected by (mtime,
size); a changed file is re-indexed.  The paper notes the indexer "must scan
the entire filesystem each iteration, causing a delay proportional to the
number of files" — we model that cost explicitly (it is the reason stashcp
exists for indexing-latency-sensitive users).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from .chunk import ObjectMeta
from .origin import Origin


@dataclasses.dataclass
class Catalog:
    """The published filesystem image CVMFS clients mount."""

    entries: Dict[str, ObjectMeta] = dataclasses.field(default_factory=dict)
    generation: int = 0

    def lookup(self, path: str) -> Optional[ObjectMeta]:
        return self.entries.get(path)

    def listdir(self, prefix: str) -> list[str]:
        prefix = prefix.rstrip("/")
        out = set()
        for p in self.entries:
            if p.startswith(prefix + "/"):
                rest = p[len(prefix) + 1:]
                out.add(rest.split("/")[0])
        return sorted(out)

    def __contains__(self, path: str) -> bool:
        return path in self.entries


@dataclasses.dataclass
class IndexStats:
    files_scanned: int = 0
    files_reindexed: int = 0
    files_removed: int = 0
    scan_seconds: float = 0.0


class Indexer:
    """Scans an origin, publishing a fresh catalog each iteration."""

    def __init__(self, origin: Origin, scan_cost_per_file: float = 1e-3,
                 reindex_cost_per_byte: float = 1e-9) -> None:
        self.origin = origin
        self.scan_cost_per_file = scan_cost_per_file
        self.reindex_cost_per_byte = reindex_cost_per_byte
        self.catalog = Catalog()

    def scan(self) -> IndexStats:
        """Full-filesystem scan (the paper's proportional-delay behaviour)."""
        stats = IndexStats()
        seen = set()
        for meta in self.origin.list_objects():
            stats.files_scanned += 1
            stats.scan_seconds += self.scan_cost_per_file
            seen.add(meta.path)
            prev = self.catalog.entries.get(meta.path)
            changed = (prev is None or prev.mtime != meta.mtime
                       or prev.size != meta.size)
            if changed:
                # Re-index: re-read the file to recompute chunk checksums.
                stats.files_reindexed += 1
                stats.scan_seconds += meta.size * self.reindex_cost_per_byte
                self.catalog.entries[meta.path] = dataclasses.replace(
                    meta, chunk_digests=list(meta.chunk_digests))
        for stale in set(self.catalog.entries) - seen:
            del self.catalog.entries[stale]
            stats.files_removed += 1
        self.catalog.generation += 1
        return stats
