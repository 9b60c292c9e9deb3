"""The federation's global namespace (paper §3).

Every origin "is registered to serve a subset of the global namespace".
Resolution is longest-prefix match, so ``/ligo`` and ``/ligo/frames`` may be
exported by different origins.  The namespace itself holds no data — it is
the registry the redirector consults.
"""
from __future__ import annotations

from typing import Dict, List, Optional


def _norm(path: str) -> str:
    if not path.startswith("/"):
        path = "/" + path
    while "//" in path:
        path = path.replace("//", "/")
    return path.rstrip("/") or "/"


class Namespace:
    """Global namespace: prefix → origin-id registry."""

    def __init__(self) -> None:
        self._prefixes: Dict[str, str] = {}

    def register(self, prefix: str, origin_id: str) -> None:
        prefix = _norm(prefix)
        existing = self._prefixes.get(prefix)
        if existing is not None and existing != origin_id:
            raise ValueError(
                f"prefix {prefix!r} already exported by {existing!r}")
        self._prefixes[prefix] = origin_id

    def unregister(self, prefix: str) -> None:
        self._prefixes.pop(_norm(prefix), None)

    def resolve(self, path: str) -> Optional[str]:
        """Longest-prefix-match owner of ``path`` (None if unclaimed)."""
        path = _norm(path)
        best: Optional[str] = None
        best_len = -1
        for prefix, origin in self._prefixes.items():
            if path == prefix or path.startswith(prefix + "/") or prefix == "/":
                if len(prefix) > best_len:
                    best, best_len = origin, len(prefix)
        return best

    def exports(self, origin_id: str) -> List[str]:
        return sorted(p for p, o in self._prefixes.items() if o == origin_id)

    def __contains__(self, path: str) -> bool:
        return self.resolve(path) is not None
