"""Vectorized max-min fair-share waterfilling as PyTorch tensor ops.

The port of ``repro.kernels.maxmin``: the fluid-flow simulator re-solves
the max-min bandwidth allocation on every change of its active flow set,
and this module batches the whole waterfilling across flows on the
simulator's device, in float32 like the reference.

Membership is kept *sparse*: each flow carries a fixed-width row of link
indices, and every round is a segment-sum (active flows per link), a
gather (each flow's tightest link share) and a second segment-sum
(retiring capacity):

  share_l   = cap_left_l / active_flows_l          (segment-sum)
  bottleneck = min_f min_{l ∈ links(f)} share_l    (gather + min)
  → fix flows whose own TCP cap binds below the bottleneck, else
  → fix every flow whose tightest share equals the bottleneck

Where the reference scatter-adds under ``lax.while_loop``, this port
differs in two ways:

* **The segment sums gather.**  ``index_add_`` on CUDA sums in atomic
  order, so two runs could differ in the last bit, and the determinism
  sanitizer demands byte-identical replays.  Each link instead owns a
  row of a (links × max degree) table of the flows that cross it
  (padding points at a sentinel flow whose values are always 0); a
  segment sum is one gather and one ``sum(1)``, whose order is fixed by
  the table, so a problem always gives the same bits on one device.
* **The branches are ``torch.where``.**  Both of ``lax.cond``'s arms are
  computed and one is selected on the device, so a round costs one host
  read: ``active.any()``, which ends the loop.  The body is idempotent
  once ``active`` empties, as the reference's is.

Shapes keep the reference's power-of-two buckets (``pad_problem``), which
the sweeps' batched solver shares.  ``COUNTS`` counts solves, rounds,
host reads and host↔device copies, as the kernels' wrappers count
launches.  ``repro_torch.kernels.ref.maxmin_ref`` is the float64 oracle.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Sequence, Union

import numpy as np
import torch

from ..device import resolve_device


@dataclasses.dataclass
class SolverCounts:
    """What the solver did since the last ``reset``.  ``syncs`` and the
    copies count only solves on the card: on the CPU a read is no
    device sync and ``torch.from_numpy`` copies nothing."""

    solves: int = 0
    rounds: int = 0
    syncs: int = 0            # host reads of a device value
    h2d: int = 0              # host → device copies
    d2h: int = 0              # device → host copies
    host_seconds: float = 0.0  # host clock around whole solves
    solves_by_device: Dict[str, int] = dataclasses.field(
        default_factory=dict)

    def reset(self) -> None:
        self.__init__()


COUNTS = SolverCounts()


def link_table(link_ids: np.ndarray, num_links: int) -> np.ndarray:
    """(num_links, D) int64: row l lists, in increasing order, the flows
    whose row of ``link_ids`` holds l, padded with the sentinel flow
    index ``F`` (= ``link_ids.shape[0]``).  The dummy slot (the last
    link) gets no entries: its capacity is infinite, so its share is
    infinite whatever its count."""
    num_flows, width = link_ids.shape
    flat = link_ids.reshape(-1).astype(np.int64)
    flow_of = np.repeat(np.arange(num_flows, dtype=np.int64), width)
    real = flat < num_links - 1
    flat, flow_of = flat[real], flow_of[real]
    order = np.argsort(flat, kind="stable")
    flat, flow_of = flat[order], flow_of[order]
    counts = np.bincount(flat, minlength=num_links)
    degree = max(int(counts.max(initial=0)), 1)
    starts = np.concatenate(([0], np.cumsum(counts)[:-1]))
    slot = np.arange(flat.size) - starts[flat]
    table = np.full((num_links, degree), num_flows, np.int64)
    table[flat, slot] = flow_of
    return table


def solve_waterfill(link_caps: torch.Tensor, link_ids: torch.Tensor,
                    flow_caps: torch.Tensor, table: torch.Tensor
                    ) -> torch.Tensor:
    """The waterfilling core on the device of its inputs.

    link_caps: (L,) float32 with a trailing dummy-inf slot; link_ids:
    (F + 1, K) int64 rows of link indices, the last row the sentinel
    (all dummy); flow_caps: (F + 1,) float32, the sentinel's 0;
    table: ``link_table`` of the rows → per-flow rates (F + 1,)."""
    on_card = link_caps.device.type != "cpu"
    num_flows, num_links = link_ids.shape[0] - 1, link_caps.shape[0]
    inf = float("inf")        # a Python scalar: no copy to the device

    def seg_sum(per_flow: torch.Tensor) -> torch.Tensor:
        """Each link's sum of a per-flow value, in the table's order."""
        return per_flow[table].sum(1)

    rates = torch.zeros_like(flow_caps)
    active = (link_ids < num_links - 1).any(dim=1)  # padded rows retired
    cap_left = link_caps
    for _ in range(num_flows + num_links + 2):
        COUNTS.rounds += 1
        n = seg_sum(active.to(torch.float32))
        share = torch.where(n > 0, cap_left / n.clamp(min=1.0), inf)
        flow_share = share[link_ids].amin(dim=1)        # tightest link
        best = torch.where(active, flow_share, inf).amin()
        capped = active & (flow_caps < best)
        any_capped = capped.any()
        no_links = torch.isinf(best)
        # lax.cond's arms, selected on the device: capped flows take
        # their own cap; with no capacity-bearing link left, every
        # active flow does (the scalar fallback); else the flows on the
        # bottleneck take its share and its links saturate.
        by_cap = any_capped | no_links
        mask = torch.where(any_capped, capped,
                           torch.where(no_links, active,
                                       active & (flow_share <= best)))
        rate = torch.where(by_cap, flow_caps, best)
        rates = torch.where(mask, rate, rates)
        used = seg_sum(torch.where(mask, rate, 0.0))
        cap_left = (cap_left - used).clamp(min=0.0)
        # float-safety: argmin links are saturated by construction
        cap_left = torch.where(~by_cap & (share <= best), 0.0, cap_left)
        active = active & ~mask
        if on_card:
            COUNTS.syncs += 1
            COUNTS.d2h += 1
        if not bool(active.any()):
            break
    return rates


def _next_pow2(n: int, floor: int = 8) -> int:
    p = floor
    while p < n:
        p *= 2
    return p


def pad_problem(link_caps: Sequence[float],
                flow_links: Sequence[Sequence[int]],
                flow_caps: Sequence[float],
                Fp: int, Lp: int, width: int):
    """Pad one (flows, links) problem into the reference's layout.

    Returns ``(caps, ids, fcaps)`` numpy arrays of shapes (Lp,), (Fp,
    width), (Fp,): real link capacities followed by infinite-capacity
    slots (the last is the dummy every padding id points at), per-flow
    link-index rows, zero-capped padding flows."""
    F, L = len(flow_links), len(link_caps)
    if L + 1 > Lp or F > Fp:
        raise ValueError(f"problem ({F} flows, {L} links) exceeds "
                         f"bucket (Fp={Fp}, Lp={Lp})")
    dummy = Lp - 1
    ids = np.full((Fp, width), dummy, np.int32)
    for fi, ls in enumerate(flow_links):
        if len(ls) > width:
            raise ValueError(f"flow {fi} crosses {len(ls)} links > "
                             f"bucket width {width}")
        ids[fi, :len(ls)] = ls
    caps = np.full(Lp, np.inf, np.float32)
    caps[:L] = link_caps
    fcaps = np.zeros(Fp, np.float32)
    fcaps[:F] = flow_caps
    return caps, ids, fcaps


def device_problem(caps: np.ndarray, ids: np.ndarray, fcaps: np.ndarray,
                   device: torch.device):
    """``solve_waterfill``'s inputs on ``device`` from a padded problem:
    the sentinel row appended and the link table built on the host, then
    two copies, one of the floats and one of the indices."""
    Fp, width = ids.shape
    Lp = caps.shape[0]
    ids_ext = np.concatenate(
        [ids.astype(np.int64), np.full((1, width), Lp - 1, np.int64)])
    table = link_table(ids, Lp)         # its padding: the sentinel, Fp
    floats = np.concatenate([caps, fcaps, np.zeros(1, np.float32)])
    ints = np.concatenate([ids_ext.reshape(-1), table.reshape(-1)])
    floats_t = torch.from_numpy(floats).to(device)
    ints_t = torch.from_numpy(ints).to(device)
    if device.type != "cpu":
        COUNTS.h2d += 2
    n_ids = ids_ext.size
    return (floats_t[:Lp], ints_t[:n_ids].view(Fp + 1, width),
            floats_t[Lp:], ints_t[n_ids:].view(table.shape))


def maxmin_rates_sparse(link_caps: Sequence[float],
                        flow_links: Sequence[Sequence[int]],
                        flow_caps: Sequence[float],
                        device: Union[str, torch.device, None] = None
                        ) -> np.ndarray:
    """Max-min fair rates with per-flow caps, solved on ``device``
    (``None`` means ``cuda``).

    ``link_caps``: (L,) bytes/s; ``flow_links``: per-flow link-index
    lists; ``flow_caps``: (F,) per-flow TCP ceiling.  Shapes are padded
    to power-of-two buckets (padding points at a dummy infinite-capacity
    link slot).  Returns float32 rates (F,) on the host.
    """
    dev = resolve_device(device)
    t0 = time.perf_counter()
    F, L = len(flow_links), len(link_caps)
    width = _next_pow2(max((len(ls) for ls in flow_links), default=1),
                       floor=4)
    Fp, Lp = _next_pow2(F), _next_pow2(L + 1)
    caps, ids, fcaps = pad_problem(link_caps, flow_links, flow_caps,
                                   Fp, Lp, width)
    rates = solve_waterfill(*device_problem(caps, ids, fcaps, dev))
    out = rates[:F].cpu().numpy()
    if dev.type != "cpu":
        COUNTS.d2h += 1
        COUNTS.syncs += 1
    # Flows crossing no capacity-bearing link (loopback transfers) look
    # identical to padding inside ``solve_waterfill`` — all-dummy rows
    # retired at rate 0 — but are real flows bound only by their own TCP
    # cap, which is what the scalar solver assigns.  Restore parity here
    # so same-node ``sim.flow(src, src, ...)`` completes under both
    # solvers.
    for fi, ls in enumerate(flow_links):
        if not ls:
            out[fi] = flow_caps[fi]
    COUNTS.solves += 1
    COUNTS.solves_by_device[dev.type] = \
        COUNTS.solves_by_device.get(dev.type, 0) + 1
    COUNTS.host_seconds += time.perf_counter() - t0
    return out


def maxmin_rates(link_caps: np.ndarray, membership: np.ndarray,
                 flow_caps: np.ndarray,
                 device: Union[str, torch.device, None] = None
                 ) -> np.ndarray:
    """Dense-membership convenience wrapper: ``membership`` is (F, L) 0/1."""
    membership = np.asarray(membership)
    flow_links: List[List[int]] = [list(np.nonzero(row)[0])
                                   for row in membership]
    return maxmin_rates_sparse(np.asarray(link_caps, np.float32), flow_links,
                               np.asarray(flow_caps, np.float32),
                               device=device)
