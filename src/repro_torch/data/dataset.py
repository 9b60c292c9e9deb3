"""Token datasets as federation objects.

Training data lives at the origin as fixed-size *shard files* of packed
token ids under ``/datasets/<name>/shard_XXXXX.bin`` — each shard is an
ordinary federation object, chunked and checksummed like everything else
(CVMFS chunk semantics give the loader partial reads: a worker fetches
only the 24 MB chunks covering its slice of a shard).

``SyntheticTokens`` generates deterministic shards (seeded per shard) so
examples/tests run without external data while exercising the full
origin→cache→client byte path.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from ..core.origin import Origin

TOKEN_DTYPE = np.int32


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str
    vocab_size: int
    tokens_per_shard: int = 1 << 20          # 4 MiB per shard at int32
    num_shards: int = 64
    seed: int = 1234

    @property
    def prefix(self) -> str:
        return f"/datasets/{self.name}"

    def shard_path(self, idx: int) -> str:
        return f"{self.prefix}/shard_{idx:05d}.bin"

    @property
    def shard_bytes(self) -> int:
        return self.tokens_per_shard * TOKEN_DTYPE().itemsize


class SyntheticTokens:
    """Deterministic synthetic token shards (a Zipf-ish unigram stream)."""

    def __init__(self, spec: DatasetSpec) -> None:
        self.spec = spec

    def shard_array(self, idx: int) -> np.ndarray:
        rng = np.random.default_rng(self.spec.seed + idx)
        # Zipf-like marginal over the vocab, cheap to sample.
        u = rng.random(self.spec.tokens_per_shard)
        toks = (self.spec.vocab_size *
                (u ** 2.2)).astype(TOKEN_DTYPE) % self.spec.vocab_size
        return toks

    def shard_bytes(self, idx: int) -> bytes:
        return self.shard_array(idx).tobytes()

    def publish(self, origin: Origin, shards: Optional[int] = None,
                mtime: float = 0.0) -> List[str]:
        """Upload shards to the origin (the researcher's data staging)."""
        paths = []
        for i in range(shards if shards is not None else self.spec.num_shards):
            path = self.spec.shard_path(i)
            origin.put_object(path, self.shard_bytes(i), mtime=mtime)
            paths.append(path)
        return paths


def decode_tokens(raw: bytes) -> np.ndarray:
    return np.frombuffer(raw, dtype=TOKEN_DTYPE)
