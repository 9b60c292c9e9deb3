"""Batched max-min waterfilling across heterogeneous problems.

The port of ``repro.kernels.batched_maxmin``.  The sweep engine
(:func:`repro_torch.core.api.run_sweep`) prices link contention for every
sweep cell: each cell contributes one (flows, links) max-min problem, its
storm-counterfactual flow set, and all cells are solved together.  This
module

* pads each problem to a power-of-two ``(Fp, Lp, width)`` bucket with the
  dummy-link layout of :func:`repro_torch.kernels.maxmin.pad_problem`,
* stacks same-bucket problems into a ``(B, ...)`` batch (B padded to a
  power of two with all-dummy problems) in one staging buffer,
* and solves each batch with one call of ``ops.maxmin_waterfill`` on
  ``device``: on the card one launch of the ``maxmin_waterfill`` kernel,
  a block a problem, each running its own rounds to its end (as under
  the reference's ``vmap`` of a ``while_loop``, a converged problem is
  left as it is), between one copy there and one back; on the CPU the
  plain version, every reduction per problem.

``stats`` carries the reference's telemetry (``solve_calls``,
``buckets``, ``problems``, ``padded_problems``); ``maxmin.COUNTS`` counts
the calls, rounds, host reads and copies.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..device import resolve_device
from .maxmin import COUNTS, Staging, _next_pow2, fix_loopback, pad_problem

# One problem: (link_caps, flow_links, flow_caps) in the same layout as
# maxmin_rates_sparse — per-flow rows of link indices, per-flow caps.
Problem = Tuple[Sequence[float], Sequence[Sequence[int]], Sequence[float]]


def _bucket_of(problem: Problem) -> Tuple[int, int, int]:
    link_caps, flow_links, _ = problem
    width = _next_pow2(max(map(len, flow_links), default=1), floor=4)
    return (_next_pow2(len(flow_links)),
            _next_pow2(len(link_caps) + 1),
            width)


def maxmin_rates_batch(problems: Sequence[Problem],
                       stats: Optional[Dict] = None,
                       device: Union[str, torch.device, None] = None
                       ) -> List[np.ndarray]:
    """Solve many independent max-min problems, one batched solve per
    bucket on ``device`` (``None`` means ``cuda``).

    Returns one ``(F_i,)`` float64 rate array per problem, in input order,
    including the loopback fix-up: flows crossing no capacity-bearing
    link get their own cap, not the padding rows' zero."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    if stats is not None:
        stats.update(solve_calls=0, buckets=[], problems=len(problems),
                     padded_problems=0)
    out: List[Optional[np.ndarray]] = [None] * len(problems)
    by_bucket: Dict[Tuple[int, int, int], List[int]] = {}
    for i, p in enumerate(problems):
        by_bucket.setdefault(_bucket_of(p), []).append(i)
    for (Fp, Lp, width), idxs in sorted(by_bucket.items()):
        B = _next_pow2(len(idxs), floor=1)
        staging = Staging(B, Fp, Lp, width, dev)
        staging.caps.fill(np.inf)
        staging.ids.fill(Lp - 1)
        staging.fcaps.fill(0.0)
        for bi, i in enumerate(idxs):
            pad_problem(*problems[i], Fp=Fp, Lp=Lp, width=width,
                        out=staging.problem(bi))
        rates = staging.solve()[:, :Fp]
        COUNTS.batched_calls += 1
        COUNTS.batched_problems += len(idxs)
        if stats is not None:
            stats["solve_calls"] += 1
            stats["buckets"].append((B, Fp, Lp, width))
            stats["padded_problems"] += B - len(idxs)
        for bi, i in enumerate(idxs):
            _, flow_links_i, flow_caps_i = problems[i]
            F = len(flow_links_i)
            res = rates[bi, :F].astype(np.float64)
            fix_loopback(res, staging.ids[bi, :F], flow_caps_i, Lp)
            out[i] = res
    COUNTS.host_seconds += time.perf_counter() - t0
    return [r if r is not None else np.zeros(0) for r in out]
