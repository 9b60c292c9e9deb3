"""Data origins — the authoritative source of data in the federation (§3).

An origin is installed on the researcher's (or, in the TPU mapping, the
dataset/checkpoint) storage and exports a subset of the global namespace.
Caches contact the origin to retrieve data on a miss; the origin never
pushes.  Egress accounting on the origin is what the paper's WAN-offload
argument (Fig. 5) is measured against.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Tuple, Union

from .chunk import (DEFAULT_CHUNK_SIZE, ObjectMeta, Payload, chunk_object,
                    synthetic_object)
from .topology import Node


class ChunkStore:
    """Content store: object catalog + chunk payloads."""

    def __init__(self) -> None:
        self.objects: Dict[str, ObjectMeta] = {}
        self.chunks: Dict[Tuple[str, int], Payload] = {}

    def put(self, meta: ObjectMeta, payloads: Iterable[Payload]) -> None:
        self.objects[meta.path] = meta
        for i, p in enumerate(payloads):
            self.chunks[(meta.path, i)] = p

    def delete(self, path: str) -> None:
        meta = self.objects.pop(path, None)
        if meta is not None:
            for i in range(meta.num_chunks):
                self.chunks.pop((path, i), None)

    def get_chunk(self, path: str, index: int) -> Optional[Payload]:
        return self.chunks.get((path, index))

    def __contains__(self, path: str) -> bool:
        return path in self.objects

    @property
    def total_bytes(self) -> int:
        return sum(m.size for m in self.objects.values())


@dataclasses.dataclass
class OriginStats:
    chunk_requests: int = 0
    egress_bytes: int = 0
    locate_queries: int = 0


class Origin:
    """Authoritative data source exporting namespace prefixes."""

    def __init__(self, name: str, node: Node,
                 exports: Iterable[str] = ("/",),
                 chunk_size: int = DEFAULT_CHUNK_SIZE) -> None:
        self.name = name
        self.node = node
        self.exports = list(exports)
        self.chunk_size = chunk_size
        self.store = ChunkStore()
        self.stats = OriginStats()
        self.available = True  # failure injection point

    # -- data management ---------------------------------------------------
    def put_object(self, path: str, data: Union[bytes, int],
                   mtime: float = 0.0) -> ObjectMeta:
        """Store real bytes, or a synthetic object when given an int size."""
        if isinstance(data, (bytes, bytearray)):
            meta, payloads = chunk_object(path, bytes(data),
                                          self.chunk_size, mtime)
        else:
            meta, payloads = synthetic_object(path, int(data),
                                              self.chunk_size, mtime)
        self.store.put(meta, payloads)
        return meta

    def delete_object(self, path: str) -> None:
        self.store.delete(path)

    def touch(self, path: str, mtime: float,
              new_size: Optional[int] = None) -> None:
        """Modify an object in place (drives indexer re-index detection)."""
        meta = self.store.objects[path]
        if new_size is not None and new_size != meta.size:
            if self.store.get_chunk(path, 0) is not None and \
                    self.store.get_chunk(path, 0).data is not None:
                self.put_object(path, b"\x00" * new_size, mtime)
            else:
                self.put_object(path, new_size, mtime)
        else:
            meta.mtime = mtime

    # -- federation-facing API ----------------------------------------------
    def has(self, path: str) -> bool:
        """Redirector query: does this origin hold ``path``?"""
        self.stats.locate_queries += 1
        return self.available and path in self.store

    def meta(self, path: str) -> ObjectMeta:
        return self.store.objects[path]

    def read_chunk(self, path: str, index: int) -> Payload:
        if not self.available:
            raise ConnectionError(f"origin {self.name} unavailable")
        payload = self.store.get_chunk(path, index)
        if payload is None:
            raise FileNotFoundError(f"{path}#{index} not at origin {self.name}")
        self.stats.chunk_requests += 1
        self.stats.egress_bytes += payload.size
        return payload

    def list_objects(self) -> List[ObjectMeta]:
        return list(self.store.objects.values())
