"""Chunking, checksums and payloads — the unit of transfer in the federation.

StashCache's CVMFS client downloads data in 24 MB chunks and stores a
checksum *along the chunk boundaries* (paper §3.1).  Every object in our
federation is therefore decomposed into fixed-size chunks, each with a
64-bit FNV-1a digest.  A chunk digest is the integrity guarantee the paper
contrasts against HTTP proxies ("CVMFS calculates checksums of the data,
which guarantees consistency ... which HTTP proxies do not provide").

Payloads may be *real* (backed by bytes — used by the data loader and
checkpoint paths) or *synthetic* (size-only — used by the discrete-event
simulator where multi-GB files must not be materialised).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

# CVMFS chunk size used by the StashCache federation (paper §3.1).
DEFAULT_CHUNK_SIZE = 24 * 2**20

_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3
_MASK64 = 0xFFFFFFFFFFFFFFFF


def fnv1a64(data: bytes, seed: int = _FNV_OFFSET) -> int:
    """64-bit FNV-1a over ``data``.  Pure-python oracle for the Pallas
    ``chunk_checksum`` kernel (see ``repro_torch.kernels.chunk_checksum``)."""
    h = seed
    for b in data:
        h = ((h ^ b) * _FNV_PRIME) & _MASK64
    return h


def synthetic_digest(path: str, index: int, size: int) -> int:
    """Deterministic digest for size-only payloads (simulator mode)."""
    return fnv1a64(f"{path}#{index}:{size}".encode())


@dataclasses.dataclass(frozen=True)
class Payload:
    """A transferable block.  ``data is None`` marks a synthetic payload."""

    size: int
    data: Optional[bytes] = None
    digest: int = 0

    @staticmethod
    def from_bytes(data: bytes) -> "Payload":
        return Payload(size=len(data), data=data, digest=fnv1a64(data))

    @staticmethod
    def synthetic(size: int, path: str = "", index: int = 0) -> "Payload":
        return Payload(size=size, data=None,
                       digest=synthetic_digest(path, index, size))

    def verify(self) -> bool:
        """Checksum validation at the chunk boundary (CVMFS behaviour)."""
        if self.data is None:
            return True
        return fnv1a64(self.data) == self.digest

    def corrupted(self) -> "Payload":
        """Return a bit-flipped copy (for integrity tests); keeps digest."""
        if self.data is None:
            return self
        flipped = bytes([self.data[0] ^ 0xFF]) + self.data[1:]
        return Payload(size=self.size, data=flipped, digest=self.digest)


@dataclasses.dataclass(frozen=True)
class ChunkRef:
    """Reference to one chunk of an object in the global namespace."""

    path: str
    index: int
    offset: int
    length: int
    digest: int

    @property
    def key(self) -> str:
        return f"{self.path}#{self.index}"


@dataclasses.dataclass
class ObjectMeta:
    """Catalog entry produced by the indexer (paper §3.1): name, size,
    permissions, mtime and checksums along chunk boundaries."""

    path: str
    size: int
    mtime: float
    mode: int = 0o644
    chunk_size: int = DEFAULT_CHUNK_SIZE
    chunk_digests: List[int] = dataclasses.field(default_factory=list)

    @property
    def num_chunks(self) -> int:
        if self.size == 0:
            return 1
        return -(-self.size // self.chunk_size)

    def chunk_refs(self) -> List[ChunkRef]:
        refs = []
        for i in range(self.num_chunks):
            off = i * self.chunk_size
            length = min(self.chunk_size, self.size - off) if self.size else 0
            refs.append(ChunkRef(self.path, i, off, length,
                                 self.chunk_digests[i]
                                 if i < len(self.chunk_digests) else 0))
        return refs

    def chunks_for_range(self, offset: int, length: int) -> List[ChunkRef]:
        """Chunks covering ``[offset, offset+length)`` — CVMFS partial
        reads download only the portions an application touches."""
        if length <= 0:
            return []
        first = offset // self.chunk_size
        last = (offset + length - 1) // self.chunk_size
        return [r for r in self.chunk_refs() if first <= r.index <= last]


def chunk_object(path: str, data: bytes,
                 chunk_size: int = DEFAULT_CHUNK_SIZE,
                 mtime: float = 0.0) -> tuple[ObjectMeta, List[Payload]]:
    """Split real bytes into chunk payloads + catalog metadata."""
    payloads: List[Payload] = []
    digests: List[int] = []
    if len(data) == 0:
        p = Payload.from_bytes(b"")
        payloads.append(p)
        digests.append(p.digest)
    else:
        for off in range(0, len(data), chunk_size):
            p = Payload.from_bytes(data[off:off + chunk_size])
            payloads.append(p)
            digests.append(p.digest)
    meta = ObjectMeta(path=path, size=len(data), mtime=mtime,
                      chunk_size=chunk_size, chunk_digests=digests)
    return meta, payloads


def synthetic_object(path: str, size: int,
                     chunk_size: int = DEFAULT_CHUNK_SIZE,
                     mtime: float = 0.0) -> tuple[ObjectMeta, List[Payload]]:
    """Size-only object for the simulator (no bytes materialised)."""
    payloads: List[Payload] = []
    digests: List[int] = []
    n = max(1, -(-size // chunk_size)) if size else 1
    for i in range(n):
        length = min(chunk_size, size - i * chunk_size) if size else 0
        p = Payload.synthetic(length, path, i)
        payloads.append(p)
        digests.append(p.digest)
    meta = ObjectMeta(path=path, size=size, mtime=mtime,
                      chunk_size=chunk_size, chunk_digests=digests)
    return meta, payloads
