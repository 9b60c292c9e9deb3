"""FederatedDataLoader — the paper's data path feeding a train loop.

Each training step needs ``(global_batch × seq_len)`` tokens.  The loader
maps ``step → (shard, offset)`` deterministically (restart-safe: resuming
at step k re-reads exactly the right slice), issues ranged ``cvmfs``
:class:`~repro_torch.core.api.FetchRequest`s against the federation's
:class:`~repro_torch.core.api.DataPlane` (partial reads — only the chunks
overlapping the slice move), and assembles the batch.

Fleet behaviours layered on the paper's data plane:
  * **prefetch** — a sliding window of future steps is fetched eagerly so
    the accelerator never waits on the federation (double buffering);
  * **straggler mitigation / hedging** — if a fetch is a straggler vs the
    recent median (``hedge_after``×), it is re-issued with
    ``FetchRequest.avoid`` naming the cache that served it, racing the
    next-nearest replica;
  * **locality accounting** — every :class:`~repro_torch.core.api.FetchResult`
    folds into a :class:`~repro_torch.core.monitoring.FetchRollup`, the unified
    per-consumer stats model the monitoring pipeline aggregates (paper
    Fig. 4 / Table 1, but for training traffic).

Migration from the pre-DataPlane API:

    ===============================  =====================================
    before (deprecated)              after
    ===============================  =====================================
    ``FederatedDataLoader(          ``plane = AnalyticPlane(fed)``
    client, spec, ...)``             ``FederatedDataLoader(plane, spec,
                                     ..., site="pod0", worker=0)``
    ``loader.stats`` (LoaderStats)   ``loader.stats`` (FetchRollup —
                                     same field names plus per-method
                                     breakdown)
    ===============================  =====================================

Passing a bare ``StashClient`` still works — it is wrapped in a
:class:`~repro_torch.core.api.ClientPlane` with a ``DeprecationWarning``.

The port of ``repro.data.loader``: numpy and the federation only.
``batch(step)`` returns int32 numpy arrays, as the reference's does; the
trainer moves them to its device.
"""
from __future__ import annotations

import collections
import dataclasses
import warnings
from typing import Deque, Dict, Iterator, List, Tuple

import numpy as np

from ..core.api import ClientPlane, DataPlane, FetchRequest
from ..core.monitoring import FetchRollup
from .dataset import DatasetSpec, TOKEN_DTYPE, decode_tokens

# The loader's stats *are* the unified rollup now; the old name stays
# importable for pre-redesign call sites.
LoaderStats = FetchRollup


class FederatedDataLoader:
    """Deterministic step→tokens mapping over federation shard objects."""

    def __init__(self, plane: DataPlane, spec: DatasetSpec,
                 global_batch: int, seq_len: int,
                 rank: int = 0, world: int = 1,
                 prefetch: int = 2,
                 hedge_after: float = 4.0,
                 site: str = "", worker: int = 0) -> None:
        if not hasattr(plane, "fetch"):
            # Legacy call site: first argument was a bare StashClient.
            warnings.warn(
                "FederatedDataLoader(client=...) is deprecated; pass a "
                "DataPlane (e.g. AnalyticPlane(fed)) and site/worker",
                DeprecationWarning, stacklevel=2)
            plane = ClientPlane(client=plane)
        self.plane = plane
        self.spec = spec
        self.global_batch = global_batch
        self.seq_len = seq_len
        self.rank = rank
        self.world = world
        self.prefetch_depth = prefetch
        self.hedge_after = hedge_after
        self.site = site
        self.worker = worker
        self.stats = FetchRollup("loader")
        self._buffer: Dict[int, np.ndarray] = {}
        self._fetch_times: Deque[float] = collections.deque(maxlen=32)

    # -- step → data mapping -------------------------------------------------
    @property
    def tokens_per_step(self) -> int:
        # +1 token so labels are inputs shifted by one.
        per_rank_rows = self.global_batch // self.world
        return per_rank_rows * (self.seq_len + 1)

    def slices_for_step(self, step: int) -> List[Tuple[int, int, int]]:
        """[(shard_idx, token_offset, token_count)] covering this step's
        slice for this rank (deterministic, restart-safe)."""
        need = self.tokens_per_step
        start_tok = (step * self.global_batch // self.world
                     * (self.seq_len + 1)
                     + self.rank * need)
        out = []
        while need > 0:
            pos = start_tok % (self.spec.tokens_per_shard
                               * self.spec.num_shards)
            shard = pos // self.spec.tokens_per_shard
            off = pos % self.spec.tokens_per_shard
            take = min(need, self.spec.tokens_per_shard - off)
            out.append((shard, off, take))
            start_tok += take
            need -= take
        return out

    # -- fetching -----------------------------------------------------------
    def _fetch_slice(self, shard: int, tok_off: int,
                     tok_count: int) -> np.ndarray:
        itemsize = TOKEN_DTYPE().itemsize
        req = FetchRequest(
            path=self.spec.shard_path(shard), site=self.site,
            worker=self.worker, method="cvmfs",
            offset=tok_off * itemsize, length=tok_count * itemsize,
            want_data=True, tenant="loader")
        res = self.plane.fetch(req)
        self.stats.add(res)
        if not res.ok:
            raise RuntimeError(f"shard fetch failed: {res.error}")
        # Hedge: if this fetch is a straggler vs the recent median,
        # re-issue avoiding the cache that served it and take the fast
        # copy (the next-nearest replica races the straggler).
        if self._fetch_times and res.source and res.seconds > \
                self.hedge_after * float(np.median(self._fetch_times)):
            self.stats.hedged += 1
            res2 = self.plane.fetch(
                dataclasses.replace(req, avoid=res.source))
            self.stats.add(res2)
            if res2.ok and res2.seconds < res.seconds and \
                    res2.data is not None:
                res = res2
        self._fetch_times.append(res.seconds)
        if res.data is None:
            raise RuntimeError(
                f"plane {self.plane.name!r} returned no bytes for "
                f"{req.path!r}; the loader needs a byte-bearing plane "
                f"(analytic)")
        return decode_tokens(res.data)

    def fetch_step(self, step: int) -> np.ndarray:
        if step in self._buffer:
            return self._buffer.pop(step)
        parts = [self._fetch_slice(*s) for s in self.slices_for_step(step)]
        flat = np.concatenate(parts)
        rows = self.global_batch // self.world
        return flat.reshape(rows, self.seq_len + 1)

    def prefetch(self, next_step: int) -> None:
        for s in range(next_step, next_step + self.prefetch_depth):
            if s not in self._buffer:
                parts = [self._fetch_slice(*sl)
                         for sl in self.slices_for_step(s)]
                rows = self.global_batch // self.world
                self._buffer[s] = np.concatenate(parts).reshape(
                    rows, self.seq_len + 1)

    # -- the train-loop interface ----------------------------------------------
    def batch(self, step: int) -> Dict[str, np.ndarray]:
        arr = self.fetch_step(step)
        self.stats.tick()
        self.prefetch(step + 1)
        return {"tokens": arr[:, :-1].astype(np.int32),
                "labels": arr[:, 1:].astype(np.int32)}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1
