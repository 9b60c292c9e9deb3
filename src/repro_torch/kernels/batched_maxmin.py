"""Batched max-min waterfilling across heterogeneous problems.

The port of ``repro.kernels.batched_maxmin``.  The sweep engine
(:func:`repro_torch.core.api.run_sweep`) prices link contention for every
sweep cell: each cell contributes one (flows, links) max-min problem, its
storm-counterfactual flow set, and all cells are solved together.  This
module

* pads each problem to a power-of-two ``(Fp, Lp, width)`` bucket with the
  dummy-link layout of :func:`repro_torch.kernels.maxmin.pad_problem`,
* stacks same-bucket problems into a ``(B, ...)`` batch (B padded to a
  power of two with all-dummy problems), each with its own link table,
* and solves each batch with one call of the batched
  :func:`~repro_torch.kernels.maxmin.solve_waterfill` on ``device``:
  torch ops, every reduction per problem, one host read a round for the
  whole batch; a problem that has converged is left as it is while the
  others finish, as under the reference's ``vmap`` of a ``while_loop``.

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
from .maxmin import COUNTS, _next_pow2, device_problem, pad_problem, \
    solve_waterfill

# One problem: (link_caps, flow_links, flow_caps) in the same layout as
# maxmin_rates_sparse — per-flow rows of link indices, per-flow caps.
Problem = Tuple[Sequence[float], Sequence[Sequence[int]], Sequence[float]]


def _bucket_of(problem: Problem) -> Tuple[int, int, int]:
    link_caps, flow_links, _ = problem
    width = _next_pow2(max((len(ls) for ls in flow_links), default=1),
                       floor=4)
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
        caps = np.full((B, Lp), np.inf, np.float32)
        ids = np.full((B, Fp, width), Lp - 1, np.int32)
        fcaps = np.zeros((B, Fp), np.float32)
        for bi, i in enumerate(idxs):
            caps[bi], ids[bi], fcaps[bi] = pad_problem(
                *problems[i], Fp=Fp, Lp=Lp, width=width)
        rates = solve_waterfill(*device_problem(caps, ids, fcaps, dev))
        rates = rates[:, :Fp].cpu().numpy()
        if dev.type != "cpu":
            COUNTS.d2h += 1
            COUNTS.syncs += 1
        COUNTS.batched_calls += 1
        COUNTS.batched_problems += len(idxs)
        if stats is not None:
            stats["solve_calls"] += 1
            stats["buckets"].append((B, Fp, Lp, width))
            stats["padded_problems"] += B - len(idxs)
        for bi, i in enumerate(idxs):
            _, flow_links_i, flow_caps_i = problems[i]
            res = rates[bi, :len(flow_links_i)].astype(np.float64)
            # An all-dummy row is indistinguishable from padding inside
            # the solve but is a real flow bound only by its own cap.
            for fi, ls in enumerate(flow_links_i):
                if not ls:
                    res[fi] = flow_caps_i[fi]
            out[i] = res
    COUNTS.host_seconds += time.perf_counter() - t0
    return [r if r is not None else np.zeros(0) for r in out]
