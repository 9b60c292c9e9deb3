"""Max-min fair-share waterfilling: one CUDA launch a solve on the card,
tensor ops as its plain version.

The port of ``repro.kernels.maxmin``: the fluid-flow simulator re-solves
the max-min bandwidth allocation on every change of its active flow set,
and the sweeps price every cell's storm with the same solve over a batch
(``batched_maxmin``), in float32 like the reference.

Membership is kept *sparse*: each flow carries a fixed-width row of link
indices, and every round is a segment-sum (active flows per link), a
gather (each flow's tightest link share) and a second segment-sum
(retiring capacity):

  share_l   = cap_left_l / active_flows_l          (segment-sum)
  bottleneck = min_f min_{l ∈ links(f)} share_l    (gather + min)
  → fix flows whose own TCP cap binds below the bottleneck, else
  → fix every flow whose tightest share equals the bottleneck

``solve_padded`` solves padded problems through ``ops.maxmin_waterfill``:
on the card, ``csrc/maxmin.cu`` (``WATERFILL``: one block a problem,
every round inside the launch, the per-link flow lists built on the
device); the host packs the problems into one pinned buffer, makes one
copy to the card and one back (rates and round counts).  On the CPU,
``solve_waterfill``, the plain version: torch ops that differ from the
reference's ``lax.while_loop`` in three ways, all shared with the
kernel:

* **The segment sums gather.**  ``index_add_`` on CUDA sums in atomic
  order, and the determinism sanitizer demands byte-identical replays.
  Each link owns a row of a (links × max degree) table of the flows that
  cross it (padding points at a sentinel flow whose values are always
  0), so a segment sum is one gather and one ``sum(1)``.
* **The retired capacity is summed in float64** and rounded once to
  float32: exact in any order for caps within 29 binary orders of
  magnitude of each other, so the kernel's sums (in its own fixed order)
  give the same bits.
* **The branches are ``torch.where``.**  Both of ``lax.cond``'s arms are
  computed and one is selected, so a round costs one check of
  ``active.any()``, which ends the loop.

Shapes keep the reference's power-of-two buckets (``pad_problem``), which
the sweeps' batched solver shares.  ``COUNTS`` counts solves, rounds,
host reads and host↔device copies, and ``WATERFILL.launches`` the
kernel's launches.  ``repro_torch.kernels.ref.maxmin_ref`` is the float64
oracle.
"""
from __future__ import annotations

import ctypes
import dataclasses
import itertools
import time
from typing import Dict, List, Sequence, Union

import numpy as np
import torch

from ..device import resolve_device
from ._build import CudaLibrary


@dataclasses.dataclass
class SolverCounts:
    """What the solver did since the last ``reset``.  ``syncs`` and the
    copies count only solves on the card: on the CPU a read is no
    device sync and ``torch.from_numpy`` copies nothing.  ``solves``
    counts single problems (the simulator's); the sweeps' batched solver
    counts its bucket solves and their problems apart, and adds to the
    rounds, reads, copies and host seconds."""

    solves: int = 0
    rounds: int = 0
    syncs: int = 0            # host reads of a device value
    h2d: int = 0              # host → device copies
    d2h: int = 0              # device → host copies
    host_seconds: float = 0.0  # host clock around whole solves
    batched_calls: int = 0    # maxmin_rates_batch's bucket solves
    batched_problems: int = 0
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
                    flow_caps: torch.Tensor, table: torch.Tensor):
    """The waterfilling core as torch ops (the kernel's plain version), for
    one problem or a batch of independent ones (a leading dimension B on
    every input).

    link_caps: ([B,] L) float32 with a trailing dummy-inf slot; link_ids:
    ([B,] F + 1, K) int64 rows of link indices, the last row the sentinel
    (all dummy); flow_caps: ([B,] F + 1) float32, the sentinel's 0;
    table: ([B,] L, D) ``link_table`` of each problem's rows, padded with
    the sentinel to the batch's largest degree → (per-flow rates ([B,]
    F + 1), rounds ([B,]) int64: the rounds each problem ran with a flow
    still active).  Every reduction is per problem, so one problem's
    bottleneck never retires another's flows; a problem that has
    converged is left as it is while the others finish."""
    single = link_caps.dim() == 1
    if single:
        link_caps, link_ids, flow_caps, table = (
            t.unsqueeze(0) for t in (link_caps, link_ids, flow_caps, table))
    num_flows, num_links = link_ids.shape[1] - 1, link_caps.shape[1]
    flat_ids = link_ids.reshape(link_ids.shape[0], -1)
    flat_table = table.reshape(table.shape[0], -1)
    inf = float("inf")        # a Python scalar: no copy to the device

    def seg_sum(per_flow: torch.Tensor) -> torch.Tensor:
        """Each link's sum of a per-flow value, in the table's order."""
        return per_flow.gather(1, flat_table).view(table.shape).sum(2)

    rates = torch.zeros_like(flow_caps)
    active = (link_ids < num_links - 1).any(dim=2)  # padded rows retired
    rounds = torch.zeros(link_caps.shape[0], dtype=torch.int64,
                         device=link_caps.device)
    cap_left = link_caps
    for _ in range(num_flows + num_links + 2):
        if not bool(active.any()):
            break
        rounds += active.any(dim=1)
        n = seg_sum(active.to(torch.float32))
        share = torch.where(n > 0, cap_left / n.clamp(min=1.0), inf)
        flow_share = share.gather(1, flat_ids).view(
            link_ids.shape).amin(dim=2)                   # tightest link
        best = torch.where(active, flow_share, inf).amin(dim=1,
                                                         keepdim=True)
        capped = active & (flow_caps < best)
        any_capped = capped.any(dim=1, keepdim=True)
        no_links = torch.isinf(best)
        # lax.cond's arms, selected per problem: capped flows take their
        # own cap; with no capacity-bearing link left, every active flow
        # does (the scalar fallback); else the flows on the bottleneck
        # take its share and its links saturate.
        by_cap = any_capped | no_links
        mask = torch.where(any_capped, capped,
                           torch.where(no_links, active,
                                       active & (flow_share <= best)))
        rate = torch.where(by_cap, flow_caps, best)
        rates = torch.where(mask, rate, rates)
        used = seg_sum(torch.where(mask, rate, 0.0).double()).float()
        cap_left = (cap_left - used).clamp(min=0.0)
        # float-safety: argmin links are saturated by construction
        cap_left = torch.where(~by_cap & (share <= best), 0.0, cap_left)
        active = active & ~mask
    return (rates[0], rounds[0]) if single else (rates, rounds)


def plain_waterfill(link_caps: torch.Tensor, link_ids: torch.Tensor,
                    flow_caps: torch.Tensor) -> torch.Tensor:
    """The kernel's contract on the inputs' device by ``solve_waterfill``:
    link_caps (B, Lp) float32, link_ids (B, Fp, width) int32, flow_caps
    (B, Fp) float32 → (B, Fp + 1) float32, each problem's rates and then
    its round count.  The link tables are built on the host."""
    num, Fp, width = link_ids.shape
    Lp = link_caps.shape[1]
    dev = link_caps.device
    ids = link_ids.cpu().numpy()
    tables = [link_table(row, Lp) for row in ids]  # padding: the sentinel
    degree = max(t.shape[1] for t in tables)
    table = np.full((num, Lp, degree), Fp, np.int64)
    for b, t in enumerate(tables):
        table[b, :, :t.shape[1]] = t
    ids_ext = torch.cat([link_ids.long(), torch.full(
        (num, 1, width), Lp - 1, dtype=torch.int64, device=dev)], 1)
    fcaps_ext = torch.cat([flow_caps, torch.zeros(
        num, 1, dtype=torch.float32, device=dev)], 1)
    rates, rounds = solve_waterfill(link_caps, ids_ext, fcaps_ext,
                                    torch.from_numpy(table).to(dev))
    return torch.cat([rates[:, :Fp], rounds[:, None].float()], 1)


_vp, _ci = ctypes.c_void_p, ctypes.c_int
LIB = CudaLibrary("maxmin", {
    "maxmin_waterfill": ([_vp] * 3 + [_ci] * 4 + [_vp] * 3, _ci),
    "maxmin_smem_bytes": ([_ci] * 3, ctypes.c_longlong),
    "maxmin_design": ([_ci] * 3, _ci),
    "maxmin_work_bytes": ([_ci] * 3, ctypes.c_longlong),
    "maxmin_threads": ([_ci], _ci)})


DESIGNS = {0: "smem", 1: "global", 2: "global_flows", 3: "global_links"}


class WaterfillKernel:
    """``csrc/maxmin.cu``'s ``maxmin_waterfill``: the whole solve of each
    problem of a batch in one block of one launch.  ``launches`` is raised
    once per launch that the card accepted; ``launches_by_design`` counts
    them by where the per-link flow lists and the flow state live:
    ``smem`` (both in shared memory, where they fit), ``global`` (the
    lists in a workspace in device memory that the wrapper allocates),
    ``global_flows`` (the flow state there too; the link state alone in
    shared memory) or ``global_links`` (the link state there too; the
    reductions alone in shared memory)."""

    def __init__(self) -> None:
        self.launches = 0
        self.launches_by_design = dict.fromkeys(DESIGNS.values(), 0)

    def design(self, Fp: int, Lp: int, width: int) -> str:
        """The bucket's design."""
        return DESIGNS[LIB.load().maxmin_design(Fp, Lp, width)]

    def smem_bytes(self, Fp: int, Lp: int, width: int) -> int:
        return int(LIB.load().maxmin_smem_bytes(Fp, Lp, width))

    def threads(self, Fp: int) -> int:
        return int(LIB.load().maxmin_threads(Fp))

    def __call__(self, link_caps: torch.Tensor, link_ids: torch.Tensor,
                 flow_caps: torch.Tensor) -> torch.Tensor:
        """link_caps (B, Lp) float32, link_ids (B, Fp, width) int32,
        flow_caps (B, Fp) float32, on one CUDA device → (B, Fp + 1)
        float32: each problem's rates, then its round count.  Raises on
        other inputs and when the card refuses the launch."""
        num, Fp, width = link_ids.shape
        Lp = link_caps.shape[1]
        dev = link_caps.device
        if dev.type != "cuda":
            raise ValueError(f"maxmin kernel: inputs are on {dev}, not a "
                             f"CUDA device")
        for label, t, dtype, shape in (
                ("link_caps", link_caps, torch.float32, (num, Lp)),
                ("link_ids", link_ids, torch.int32, (num, Fp, width)),
                ("flow_caps", flow_caps, torch.float32, (num, Fp))):
            if t.device != dev or t.dtype != dtype or \
                    tuple(t.shape) != shape or not t.is_contiguous():
                raise ValueError(f"maxmin kernel: {label} must be a "
                                 f"contiguous {dtype} {shape} tensor on "
                                 f"{dev}, got {t.dtype} {tuple(t.shape)} "
                                 f"on {t.device}")
        lib = LIB.load()
        design = self.design(Fp, Lp, width)
        out = torch.empty(num, Fp + 1, dtype=torch.float32, device=dev)
        work = None if design == "smem" else torch.empty(
            num * int(lib.maxmin_work_bytes(Fp, Lp, width)),
            dtype=torch.uint8, device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.maxmin_waterfill(
                link_caps.data_ptr(), flow_caps.data_ptr(),
                link_ids.data_ptr(), num, Fp, Lp, width,
                None if work is None else work.data_ptr(), out.data_ptr(),
                stream)
        LIB.check(err, "maxmin")
        self.launches += 1
        self.launches_by_design[design] += 1
        return out


WATERFILL = WaterfillKernel()


def _next_pow2(n: int, floor: int = 8) -> int:
    p = floor
    while p < n:
        p *= 2
    return p


def pad_problem(link_caps: Sequence[float],
                flow_links: Sequence[Sequence[int]],
                flow_caps: Sequence[float],
                Fp: int, Lp: int, width: int, out=None):
    """Pad one (flows, links) problem into the reference's layout.

    Returns ``(caps, ids, fcaps)`` numpy arrays of shapes (Lp,), (Fp,
    width), (Fp,): real link capacities followed by infinite-capacity
    slots (the last is the dummy every padding id points at), per-flow
    link-index rows, zero-capped padding flows.  ``out``, when given, is
    three arrays of those shapes that are filled instead (views of a
    staging buffer)."""
    F, L = len(flow_links), len(link_caps)
    if L + 1 > Lp or F > Fp:
        raise ValueError(f"problem ({F} flows, {L} links) exceeds "
                         f"bucket (Fp={Fp}, Lp={Lp})")
    lens = np.fromiter(map(len, flow_links), np.int64, F)
    if F and lens.max() > width:
        fi = int(np.argmax(lens > width))
        raise ValueError(f"flow {fi} crosses {int(lens[fi])} links > "
                         f"bucket width {width}")
    if out is None:
        out = (np.empty(Lp, np.float32), np.empty((Fp, width), np.int32),
               np.empty(Fp, np.float32))
    caps, ids, fcaps = out
    ids.fill(Lp - 1)
    flat = np.fromiter(itertools.chain.from_iterable(flow_links), np.int32,
                       int(lens.sum()))
    starts = np.cumsum(lens) - lens
    rows = np.repeat(np.arange(F), lens)
    ids[rows, np.arange(flat.size) - starts[rows]] = flat
    caps.fill(np.inf)
    caps[:L] = link_caps
    fcaps.fill(0.0)
    fcaps[:F] = flow_caps
    return caps, ids, fcaps


class Staging:
    """A batch of padded problems ``(num, Fp, Lp, width)`` as numpy views
    (``caps``, ``ids``, ``fcaps``) over one host buffer, pinned when the
    solve runs on the card (PyTorch's host allocator caches pinned blocks,
    and reuses one only once the copy from it is done), so that the whole
    batch goes over in one copy."""

    def __init__(self, num: int, Fp: int, Lp: int, width: int,
                 device: torch.device) -> None:
        self.shape = (num, Fp, Lp, width)
        self.device = device
        self.buffer = torch.empty(num * (Lp + Fp + Fp * width),
                                  dtype=torch.int32,
                                  pin_memory=device.type != "cpu")
        flat = self.buffer.numpy()
        n_caps, n_fcaps = num * Lp, num * Fp
        self.caps = flat[:n_caps].view(np.float32).reshape(num, Lp)
        self.fcaps = flat[n_caps:n_caps + n_fcaps].view(
            np.float32).reshape(num, Fp)
        self.ids = flat[n_caps + n_fcaps:].reshape(num, Fp, width)

    def problem(self, b: int):
        """The three views of problem ``b``, for ``pad_problem(out=...)``."""
        return self.caps[b], self.ids[b], self.fcaps[b]

    def upload(self) -> torch.Tensor:
        """The staging buffer on the device: one copy on the card."""
        return self.buffer.to(self.device, non_blocking=True)

    def views(self, buf: torch.Tensor):
        """``ops.maxmin_waterfill``'s inputs as views of an uploaded buffer:
        caps (num, Lp) and flow caps (num, Fp) float32, ids (num, Fp,
        width) int32."""
        num, Fp, Lp, width = self.shape
        n_caps, n_fcaps = num * Lp, num * Fp
        return (buf[:n_caps].view(torch.float32).view(num, Lp),
                buf[n_caps + n_fcaps:].view(num, Fp, width),
                buf[n_caps:n_caps + n_fcaps].view(torch.float32).view(num,
                                                                      Fp))

    def solve(self) -> np.ndarray:
        """Solve every problem of the batch through ``ops.maxmin_waterfill``
        on the staging device → (num, Fp + 1) float32 on the host: rates,
        then each problem's round count.  On the card: one copy there, one
        launch, one copy back (and one host read)."""
        from . import ops
        Fp = self.shape[1]
        out = ops.maxmin_waterfill(*self.views(self.upload()))
        out = out.cpu().numpy()
        if self.device.type != "cpu":
            COUNTS.h2d += 1
            COUNTS.d2h += 1
            COUNTS.syncs += 1
        COUNTS.rounds += int(out[:, Fp].max(initial=0))
        return out


def fix_loopback(rates: np.ndarray, ids: np.ndarray,
                 flow_caps: Sequence[float], Lp: int) -> None:
    """Flows crossing no capacity-bearing link (loopback transfers) look
    identical to padding inside the solve — all-dummy rows retired at rate
    0 — but are real flows bound only by their own TCP cap, which is what
    the scalar solver assigns.  Restore parity in ``rates`` (F,) from the
    padded rows ``ids`` (F, width), so that same-node ``sim.flow(src, src,
    ...)`` completes under both solvers."""
    loop = (ids == Lp - 1).all(axis=1)
    if loop.any():
        rates[loop] = np.asarray(flow_caps, np.float64)[loop]


def maxmin_rates_sparse(link_caps: Sequence[float],
                        flow_links: Sequence[Sequence[int]],
                        flow_caps: Sequence[float],
                        device: Union[str, torch.device, None] = None
                        ) -> np.ndarray:
    """Max-min fair rates with per-flow caps, solved on ``device``
    (``None`` means ``cuda``): on the card one launch of ``WATERFILL``.

    ``link_caps``: (L,) bytes/s; ``flow_links``: per-flow link-index
    lists; ``flow_caps``: (F,) per-flow TCP ceiling.  Shapes are padded
    to power-of-two buckets (padding points at a dummy infinite-capacity
    link slot).  Returns float32 rates (F,) on the host.
    """
    dev = resolve_device(device)
    t0 = time.perf_counter()
    F, L = len(flow_links), len(link_caps)
    width = _next_pow2(max(map(len, flow_links), default=1), floor=4)
    Fp, Lp = _next_pow2(F), _next_pow2(L + 1)
    staging = Staging(1, Fp, Lp, width, dev)
    pad_problem(link_caps, flow_links, flow_caps, Fp, Lp, width,
                out=staging.problem(0))
    out = staging.solve()[0, :F].copy()
    fix_loopback(out, staging.ids[0, :F], flow_caps, Lp)
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
