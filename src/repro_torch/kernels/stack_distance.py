"""Eviction-aware cache modelling for the sweeps: Mattson stack distances
and exact single-capacity LRU/FIFO replays, batched over many streams.

The port of ``repro.kernels.stack_distance``.  The sweep executor
(:func:`repro_torch.core.api.run_sweep`) resolves every batched cell's
hit/miss pattern without running a cache:

* :func:`stack_distances_batch` — byte-weighted stack distances.  LRU
  with byte-granular ``evict_until`` has the inclusion property, so a
  reference hits at capacity ``C`` iff ``distance + size <= C``: one pass
  prices every capacity of a sweep column.
* :func:`fifo_sim_batch` — exact FIFO replay as a byte frontier over the
  cumulative admitted bytes, with per-reference admit bits.
* :func:`cache_sim_batch` — the exact LRU/FIFO slot machine, for LRU
  cells whose admission basis changes mid-stream.

Cold restarts are stream markers: a reset wipes residency without
counting evictions, as ``CacheServer.clear`` does.

Problems keep the reference's tuples, its power-of-two buckets
(``_FLOOR_N``, ``_FLOOR_K``, batch padded to a power of two with empty
problems) and its ``stats`` telemetry, so a sweep's ``solver`` report
equals the reference's key for key.  Each bucket is one call of a scan
on ``device`` (``None`` means ``cuda``): through ``ops``, a CPU tensor
goes to the plain version in ``ref`` (the reference's scan step as a loop
of torch ops), a CUDA tensor to a hand-written kernel of
``csrc/stack_distance.cu`` (one library, built by ``_build`` at first
use).  The kernels run each problem to its own length; padding changes no
counter.  Byte counts are integers below 2**53 held in float64, so every
result equals the reference's exactly.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..device import resolve_device
from ._build import CudaLibrary
from .maxmin import _next_pow2

# Bucket floors: short streams pad up so a sweep's ragged stream and key
# counts land in few shapes (the reference's, for equal telemetry).
_FLOOR_N = 256
_FLOOR_K = 64

# One stack-distance problem: (prev, sizes) — per-reference index of the
# previous reference to the same key within the same cold-restart segment
# (-1: none → compulsory miss), and per-reference chunk bytes.
DistanceProblem = Tuple[Sequence[int], Sequence[float]]

# One state-machine problem: (keys, admit, reset, key_sizes, capacity,
# fifo) — keys (N,) key ids; admit (N,) miss-path insert allowed; reset
# (N,) cold restart before this reference; key_sizes (K,) bytes per key;
# capacity in bytes; fifo: insertion-order victims.
SimProblem = Tuple[Sequence[int], Sequence[bool], Sequence[bool],
                   Sequence[float], float, bool]

# One FIFO problem: (keys, ref_sizes, admit, reset, n_keys, capacity).
FifoProblem = Tuple[Sequence[int], Sequence[float], Sequence[bool],
                    Sequence[bool], int, float]

_vp, _ci = ctypes.c_void_p, ctypes.c_int
# sd_distances' design, compiled into csrc/stack_distance.cu: a block sorts
# a tile of DIST_TILE positions in shared memory, DIST_ITEMS consecutive
# elements a thread; a block of a level over the row merges DIST_CHUNK
# outputs; a row is padded to a power of two of at least DIST_MIN_WIDTH
# (a warp's elements)
DIST_TILE, DIST_ITEMS, DIST_CHUNK, DIST_MIN_WIDTH = 4096, 8, 2048, 256
LIB = CudaLibrary("stack_distance", {
    "sd_distances": ([_vp, _vp, _vp, _ci, _ci, _vp, _vp, _vp], _ci),
    "sd_distances_work_bytes": ([_ci, _ci], ctypes.c_longlong),
    "sd_cache_sim": ([_vp] * 7 + [_ci] * 4 + [_vp] * 5, _ci),
    "sd_cache_smem_bytes": ([_ci, _ci], ctypes.c_longlong),
    "sd_fifo_replay": ([_vp] * 6 + [_ci] * 5 + [_vp] * 7, _ci),
    "sd_fifo_smem_bytes": ([_ci, _ci], ctypes.c_longlong)},
    defines={"SD_TILE": DIST_TILE, "SD_ITEMS": DIST_ITEMS,
             "MERGE_CHUNK": DIST_CHUNK, "SD_MIN_WIDTH": DIST_MIN_WIDTH})

# The replays' fixed shared memory (csrc/stack_distance.cu) and the shared
# memory a block may have on Hopper: each replay's key state goes beside
# its fixed part where it fits ("smem"), else in device memory ("global").
# sd_fifo_replay: a barrier pair and FIFO_TILE references of 14 B for each
# of FIFO_STAGES stages, a FIFO_HIST-step history of cumB/cumN, 12 B a
# step, and a tile's hits; its key state kcum is 8 B a key.
# sd_cache_sim: 128 B of barriers, a tile's hits, SIM_STAGES stages of
# SIM_TILE references of 6 B and HEAD_STAGES of SIM_TILE keys of 4 B; its
# key state, key_sizes and key_slot, is 12 B a key.
FIFO_RING_BYTES = 16 * 3 + 3 * 1024 * 14 + 4096 * 12 + 1024
SIM_RING_BYTES = 128 + 1024 + 3 * 1024 * 6 + 2 * 1024 * 4
BLOCK_SMEM_BYTES = 232448
DESIGNS = ("global", "smem")


def _check(name: str, device: torch.device, *named) -> None:
    """Raise unless each (label, tensor, dtype, shape) is a contiguous
    tensor of that dtype and shape on ``device``, a CUDA device."""
    if device.type != "cuda":
        raise ValueError(f"{name} kernel: inputs are on {device}, not a "
                         f"CUDA device")
    for label, t, dtype, shape in named:
        if t.device != device:
            raise ValueError(f"{name} kernel: {label} is on {t.device}, "
                             f"not {device}")
        if t.dtype != dtype:
            raise ValueError(f"{name} kernel: {label} is {t.dtype}; needs "
                             f"{dtype}")
        if tuple(t.shape) != tuple(shape) or not t.is_contiguous():
            raise ValueError(f"{name} kernel: {label} must be a contiguous "
                             f"{tuple(shape)} tensor, got "
                             f"{tuple(t.shape)}")


def _pad_to(multiple: int, *tensors: torch.Tensor) -> List[torch.Tensor]:
    """Pad each (B, W) tensor with zeros on the right to the next multiple
    of ``multiple`` columns (the kernels' bulk copies)."""
    width = tensors[0].shape[1]
    extra = -width % multiple
    return [torch.nn.functional.pad(t, (0, extra)) if extra else t
            for t in tensors]


def _lengths(lengths: torch.Tensor, num: int,
             device: torch.device) -> torch.Tensor:
    """Each problem's true length as int32 (B,) on ``device``; the
    kernels clamp a length to the padded width."""
    if tuple(lengths.shape) != (num,):
        raise ValueError(f"lengths must be ({num},), got "
                         f"{tuple(lengths.shape)}")
    return lengths.to(device=device, dtype=torch.int32).contiguous()


class _ScanKernel:
    """A scan of ``csrc/stack_distance.cu``: its launch count, a plain
    integer raised once per call that the card accepted."""

    def __init__(self) -> None:
        self.launches = 0

    def _launch(self, fn: str, what: str, device: torch.device,
                *args) -> None:
        lib = LIB.load()
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = getattr(lib, fn)(*args, stream)
        LIB.check(err, what)
        self.launches += 1


class DistanceKernel(_ScanKernel):
    def __call__(self, prev: torch.Tensor, sizes: torch.Tensor,
                 lengths: torch.Tensor) -> torch.Tensor:
        """prev (B, Np) int64, sizes (B, Np) float64, lengths (B,) each
        problem's true length → the distances (B, Np) float64, ``inf`` on
        compulsory misses and on padding.  A row is padded to a power of
        two of at least ``DIST_MIN_WIDTH`` with references that no length
        reaches; the kernel's workspace is allocated here."""
        num, n = prev.shape
        dev = prev.device
        _check("stack distance", dev, ("prev", prev, torch.int64, (num, n)),
               ("sizes", sizes, torch.float64, (num, n)))
        lens = _lengths(lengths, num, dev)
        width = _next_pow2(max(n, 1), floor=DIST_MIN_WIDTH)
        if width != n:
            prev = torch.nn.functional.pad(prev, (0, width - n), value=-1)
            sizes, = _pad_to(width, sizes)
        work = torch.empty(int(LIB.load().sd_distances_work_bytes(
            num, width)), dtype=torch.uint8, device=dev)
        out = torch.empty(num, width, dtype=torch.float64, device=dev)
        self._launch("sd_distances", "stack distance", dev, prev.data_ptr(),
                     sizes.data_ptr(), lens.data_ptr(), num, width,
                     work.data_ptr(), out.data_ptr())
        return out if width == n else out[:, :n].contiguous()


class _TwoDesigns(_ScanKernel):
    """A replay with two designs by Kp: "smem" when its key state
    (``KEY_BYTES`` a key) fits beside its fixed shared memory
    (``RING_BYTES``) in a block, else "global"; ``launches_by_design``
    counts each."""

    RING_BYTES: int
    KEY_BYTES: int
    SMEM_FN: str

    def __init__(self) -> None:
        super().__init__()
        self.launches_by_design = dict.fromkeys(DESIGNS, 0)

    def design(self, kp: int) -> str:
        return "smem" if self.RING_BYTES + self.KEY_BYTES * kp <= \
            BLOCK_SMEM_BYTES else "global"

    def smem_bytes(self, kp: int) -> int:
        """The dynamic shared memory of a block of the design for Kp."""
        return int(getattr(LIB.load(), self.SMEM_FN)(
            kp, DESIGNS.index(self.design(kp))))


class CacheSimKernel(_TwoDesigns):
    """``sd_cache_sim``: key_sizes and key_slot in shared memory ("smem",
    Kp <= 17,056) or in device memory ("global")."""

    RING_BYTES, KEY_BYTES, SMEM_FN = SIM_RING_BYTES, 12, "sd_cache_smem_bytes"

    def __call__(self, keys: torch.Tensor, admit: torch.Tensor,
                 reset: torch.Tensor, key_sizes: torch.Tensor,
                 capacity: torch.Tensor, fifo: torch.Tensor,
                 lengths: torch.Tensor):
        """The slot machine: keys (B, Np) int32, admit and reset (B, Np)
        bool, key_sizes (B, Kp) float64, capacity (B,) float64, fifo (B,)
        bool → (hits (B, Np) bool, evictions (B,) int32, bytes evicted
        (B,) float64); hits beyond a problem's length are False.  Np is
        padded to a multiple of 16 (the ring's copies) and Kp to an even
        count (the sizes' copy), with references and keys no length or
        key reaches."""
        num, n = keys.shape
        kp = key_sizes.shape[1]
        dev = keys.device
        _check("cache sim", dev, ("keys", keys, torch.int32, (num, n)),
               ("admit", admit, torch.bool, (num, n)),
               ("reset", reset, torch.bool, (num, n)),
               ("key_sizes", key_sizes, torch.float64, (num, kp)),
               ("capacity", capacity, torch.float64, (num,)),
               ("fifo", fifo, torch.bool, (num,)))
        lens = _lengths(lengths, num, dev)
        keys, admit, reset = _pad_to(16, keys, admit, reset)
        key_sizes, = _pad_to(2, key_sizes)
        n16, kp2 = keys.shape[1], key_sizes.shape[1]
        design = self.design(kp2)
        key_slot = torch.empty(num, kp2 if design == "global" else 0,
                               dtype=torch.int32, device=dev)
        hits = torch.zeros(num, n16, dtype=torch.bool, device=dev)
        ev = torch.empty(num, dtype=torch.int32, device=dev)
        evb = torch.empty(num, dtype=torch.float64, device=dev)
        self._launch("sd_cache_sim", "cache sim", dev, keys.data_ptr(),
                     admit.data_ptr(), reset.data_ptr(),
                     key_sizes.data_ptr(), capacity.data_ptr(),
                     fifo.data_ptr(), lens.data_ptr(), num, n16, kp2,
                     DESIGNS.index(design), key_slot.data_ptr(),
                     hits.data_ptr(), ev.data_ptr(), evb.data_ptr())
        self.launches_by_design[design] += 1
        return hits[:, :n], ev, evb


class FifoReplayKernel(_TwoDesigns):
    """``sd_fifo_replay``: kcum in shared memory ("smem", Kp <= 16,384) or
    in device memory ("global")."""

    RING_BYTES, KEY_BYTES, SMEM_FN = FIFO_RING_BYTES, 8, "sd_fifo_smem_bytes"

    def __call__(self, keys: torch.Tensor, sizes: torch.Tensor,
                 admit: torch.Tensor, reset: torch.Tensor,
                 kcum0: torch.Tensor, capacity: torch.Tensor,
                 lengths: torch.Tensor):
        """The byte-frontier FIFO replay: keys (B, Np) int32, sizes (B, Np)
        float64, admit and reset (B, Np) bool, kcum0 (B, Kp) float64 (the
        per-key state's start, zeros), capacity (B,) float64 → (hits,
        evictions int32, bytes evicted float64).  An Np that is not a
        multiple of 16 (the ring's copies) is padded with empty
        references, which no length reaches; the bytes evicted still
        follow the reference over a row of Np."""
        num, n = keys.shape
        kp = kcum0.shape[1]
        dev = keys.device
        _check("fifo replay", dev, ("keys", keys, torch.int32, (num, n)),
               ("sizes", sizes, torch.float64, (num, n)),
               ("admit", admit, torch.bool, (num, n)),
               ("reset", reset, torch.bool, (num, n)),
               ("kcum0", kcum0, torch.float64, (num, kp)),
               ("capacity", capacity, torch.float64, (num,)))
        lens = _lengths(lengths, num, dev)
        keys, sizes, admit, reset = _pad_to(16, keys, sizes, admit, reset)
        n16 = keys.shape[1]
        design = self.design(kp)
        cum_b = torch.empty(num, n16, dtype=torch.float64, device=dev)
        cum_n = torch.empty(num, n16, dtype=torch.int32, device=dev)
        kcum = kcum0.clone()
        hits = torch.zeros(num, n16, dtype=torch.bool, device=dev)
        ev = torch.empty(num, dtype=torch.int32, device=dev)
        evb = torch.empty(num, dtype=torch.float64, device=dev)
        self._launch("sd_fifo_replay", "fifo replay", dev, keys.data_ptr(),
                     sizes.data_ptr(), admit.data_ptr(), reset.data_ptr(),
                     capacity.data_ptr(), lens.data_ptr(), num, n16, n, kp,
                     DESIGNS.index(design), cum_b.data_ptr(),
                     cum_n.data_ptr(), kcum.data_ptr(), hits.data_ptr(),
                     ev.data_ptr(), evb.data_ptr())
        self.launches_by_design[design] += 1
        return hits[:, :n], ev, evb


DISTANCES = DistanceKernel()
CACHE_SIM = CacheSimKernel()
FIFO_REPLAY = FifoReplayKernel()


def _note(stats: Optional[Dict], bucket: Tuple[int, ...], pad: int) -> None:
    if stats is not None:
        stats["solve_calls"] += 1
        stats["buckets"].append(bucket)
        stats["padded_problems"] += pad


def _init_stats(stats: Optional[Dict], n: int) -> None:
    if stats is not None:
        stats.update(solve_calls=0, buckets=[], problems=n,
                     padded_problems=0)


def _to(dev: torch.device, *arrays: np.ndarray) -> List[torch.Tensor]:
    return [torch.from_numpy(a).to(dev) for a in arrays]


def stack_distances_batch(problems: Sequence[DistanceProblem],
                          stats: Optional[Dict] = None,
                          device: Union[str, torch.device, None] = None
                          ) -> List[np.ndarray]:
    """Byte-weighted stack distances for many streams, one scan call per
    power-of-two bucket on ``device``.  Returns one ``(N_i,)`` float64
    array per problem, ``inf`` marking compulsory misses."""
    from . import ops
    dev = resolve_device(device)
    _init_stats(stats, len(problems))
    out: List[Optional[np.ndarray]] = [None] * len(problems)
    by_bucket: Dict[int, List[int]] = {}
    for i, (prev, _) in enumerate(problems):
        by_bucket.setdefault(_next_pow2(max(len(prev), 1), floor=_FLOOR_N),
                             []).append(i)
    for Np, idxs in sorted(by_bucket.items()):
        B = _next_pow2(len(idxs), floor=1)
        prevs = np.full((B, Np), -1, np.int64)
        sizes = np.zeros((B, Np), np.float64)
        lengths = np.zeros(B, np.int32)
        for bi, i in enumerate(idxs):
            p, s = problems[i]
            prevs[bi, :len(p)] = p
            sizes[bi, :len(s)] = s
            lengths[bi] = len(p)
        dists = ops.stack_distances(*_to(dev, prevs, sizes, lengths)
                                    ).cpu().numpy()
        _note(stats, (B, Np), B - len(idxs))
        for bi, i in enumerate(idxs):
            out[i] = dists[bi, :len(problems[i][0])]
    return [r if r is not None else np.zeros(0) for r in out]


def lru_hits(distances: np.ndarray, ref_sizes: np.ndarray,
             capacity: float) -> np.ndarray:
    """Hit mask at one capacity from precomputed stack distances — the
    per-cell half of the one-pass-per-column contract."""
    return distances + ref_sizes <= capacity


def fifo_sim_batch(problems: Sequence[FifoProblem],
                   stats: Optional[Dict] = None,
                   device: Union[str, torch.device, None] = None
                   ) -> List[Tuple[np.ndarray, int, int]]:
    """Replay many FIFO (stream, capacity) problems, one scan call per
    ``(Np, Kp)`` bucket on ``device``; capacity is data, so a capacity ×
    admission column over one stream shares a call.  Returns ``(hits,
    evictions, bytes_evicted)`` per problem."""
    from . import ops
    dev = resolve_device(device)
    _init_stats(stats, len(problems))
    out: List[Optional[Tuple[np.ndarray, int, int]]] = [None] * len(problems)
    by_bucket: Dict[Tuple[int, int], List[int]] = {}
    for i, (keys, _, _, _, n_keys, _) in enumerate(problems):
        bucket = (_next_pow2(max(len(keys), 1), floor=_FLOOR_N),
                  _next_pow2(max(n_keys, 1), floor=_FLOOR_K))
        by_bucket.setdefault(bucket, []).append(i)
    for (Np, Kp), idxs in sorted(by_bucket.items()):
        B = _next_pow2(len(idxs), floor=1)
        keys = np.zeros((B, Np), np.int32)
        sizes = np.zeros((B, Np), np.float64)
        admit = np.zeros((B, Np), bool)
        reset = np.zeros((B, Np), bool)
        kcum0 = np.zeros((B, Kp), np.float64)
        cap = np.full(B, np.inf, np.float64)
        lengths = np.zeros(B, np.int32)
        for bi, i in enumerate(idxs):
            k, s, a, r, _, c = problems[i]
            keys[bi, :len(k)] = k
            sizes[bi, :len(s)] = s
            admit[bi, :len(a)] = a
            reset[bi, :len(r)] = r
            cap[bi] = c
            lengths[bi] = len(k)
        hits, ev, evb = (x.cpu().numpy() for x in ops.fifo_replay(
            *_to(dev, keys, sizes, admit, reset, kcum0, cap, lengths)))
        _note(stats, (B, Np, Kp), B - len(idxs))
        for bi, i in enumerate(idxs):
            n = len(problems[i][0])
            out[i] = (hits[bi, :n], int(ev[bi]), int(round(evb[bi])))
    return [r if r is not None else (np.zeros(0, bool), 0, 0) for r in out]


def cache_sim_batch(problems: Sequence[SimProblem],
                    stats: Optional[Dict] = None,
                    device: Union[str, torch.device, None] = None
                    ) -> List[Tuple[np.ndarray, int, int]]:
    """Replay many (stream, capacity, policy) problems, one scan call per
    ``(Np, Kp)`` bucket on ``device``; capacity and the FIFO flag are
    data.  Returns ``(hits, evictions, bytes_evicted)`` per problem,
    byte-exact against a scalar ``CacheServer`` replay."""
    from . import ops
    dev = resolve_device(device)
    _init_stats(stats, len(problems))
    out: List[Optional[Tuple[np.ndarray, int, int]]] = [None] * len(problems)
    by_bucket: Dict[Tuple[int, int], List[int]] = {}
    for i, (keys, _, _, key_sizes, _, _) in enumerate(problems):
        bucket = (_next_pow2(max(len(keys), 1), floor=_FLOOR_N),
                  _next_pow2(max(len(key_sizes), 1), floor=_FLOOR_K))
        by_bucket.setdefault(bucket, []).append(i)
    for (Np, Kp), idxs in sorted(by_bucket.items()):
        B = _next_pow2(len(idxs), floor=1)
        keys = np.zeros((B, Np), np.int32)
        admit = np.zeros((B, Np), bool)
        reset = np.zeros((B, Np), bool)
        ksz = np.zeros((B, Kp), np.float64)
        cap = np.zeros(B, np.float64)
        fifo = np.zeros(B, bool)
        lengths = np.zeros(B, np.int32)
        for bi, i in enumerate(idxs):
            k, a, r, s, c, f = problems[i]
            keys[bi, :len(k)] = k
            admit[bi, :len(a)] = a
            reset[bi, :len(r)] = r
            ksz[bi, :len(s)] = s
            cap[bi] = c
            fifo[bi] = f
            lengths[bi] = len(k)
        hits, ev, evb = (x.cpu().numpy() for x in ops.cache_sim(
            *_to(dev, keys, admit, reset, ksz, cap, fifo, lengths)))
        _note(stats, (B, Np, Kp), B - len(idxs))
        for bi, i in enumerate(idxs):
            n = len(problems[i][0])
            out[i] = (hits[bi, :n], int(ev[bi]), int(round(evb[bi])))
    return [r if r is not None else (np.zeros(0, bool), 0, 0) for r in out]
