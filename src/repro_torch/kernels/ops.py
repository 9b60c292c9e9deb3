"""Dispatch by the device of the inputs.

A CPU tensor goes to the plain PyTorch version in ``ref``; a CUDA tensor
goes to the hand-written kernel, which raises on anything it cannot
serve.  There is no fallback from one to the other.  The max-min solver
(``maxmin_waterfill``) follows the same rule: the plain version is
``maxmin.plain_waterfill`` (torch ops), the kernel ``maxmin.WATERFILL``;
so do the planner's two loops (``plan_solve``, ``mixture_fit``): the
kernels ``cache_model.PLAN_SOLVE`` and ``cache_model.MIXTURE_FIT``; and
the chunks' FNV-1a digests (``fnv1a64_chunks``): ``fnv1a.KERNEL``, whose
plain version is the reference's host loop.

Under a gradient (``torch.is_grad_enabled()`` and an input that requires
grad) a CUDA tensor goes to the kernel with its hand-written backward
(``flash_attention.FlashAttentionFunction``,
``ssd_scan.SSDIntraFunction``); a CPU tensor to the plain version, whose
gradient is PyTorch's autograd.
"""
from __future__ import annotations

import torch

from . import cache_model as _cm
from . import maxmin as _maxmin
from . import ref
from . import stack_distance as _sd
from .chunk_checksum import chunk_checksum as _checksum_kernel
from .chunk_checksum import chunk_checksums as _checksums_kernel
from .fnv1a import KERNEL as _fnv1a_kernel
from .flash_attention import KERNEL as _flash_kernel
from .flash_attention import FlashAttentionFunction as _FlashFunction
from .ssd_scan import KERNEL as _ssd_kernel
from .ssd_scan import SSDIntraFunction as _SSDFunction


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0) -> torch.Tensor:
    """q: (B, S, H, hd); k/v: (B, S, KV, hd) → (B, S, H, hd)."""
    if q.device.type == "cpu":
        return ref.attention_ref(q, k, v, causal=causal, window=window,
                                 softcap=softcap)
    if _wants_grad(q, k, v):
        return _FlashFunction.apply(q, k, v, causal, window, softcap)
    return _flash_kernel(q, k, v, causal=causal, window=window,
                         softcap=softcap)


def _wants_grad(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def ssd_intra(x: torch.Tensor, dt: torch.Tensor, cum: torch.Tensor,
              b_in: torch.Tensor, c_in: torch.Tensor) -> torch.Tensor:
    """x: (B, NC, Q, H, P); dt, cum: (B, NC, Q, H); b_in, c_in:
    (B, NC, Q, N) → the intra-chunk SSD output (B, NC, Q, H, P)."""
    if x.device.type == "cpu":
        return ref.ssd_intra_ref(x, dt, cum, b_in, c_in)
    if _wants_grad(x, dt, cum, b_in, c_in):
        return _SSDFunction.apply(x, dt, cum, b_in, c_in)
    return _ssd_kernel(x, dt, cum, b_in, c_in)


def chunk_checksum(data: torch.Tensor, block: int = 1024) -> torch.Tensor:
    """The uint32 polynomial checksum of a uint8 or int32 buffer."""
    if data.device.type == "cpu":
        return ref.poly_digest_ref(data, block)[0]
    return _checksum_kernel(data, block)


def chunk_checksums(buffers, block: int = 1024, *,
                    as_bytes: bool = False) -> torch.Tensor:
    """The uint32 checksums (n,) of a list of buffers on one device, each
    uint8 or int32, or any dtype read as its bytes when ``as_bytes``: on
    the card, one launch for the whole list."""
    buffers = list(buffers)
    if buffers[0].device.type == "cpu":
        return torch.stack([ref.poly_digest_ref(
            t.reshape(-1).view(torch.uint8) if as_bytes else t, block)[0]
            for t in buffers])
    return _checksums_kernel(buffers, block, as_bytes=as_bytes)


def fnv1a64_chunks(buf: torch.Tensor, chunk_size: int) -> torch.Tensor:
    """The FNV-1a-64 digest of each ``chunk_size`` piece of one object's
    bytes (a 1-D uint8 tensor; the last piece shorter, an empty object one
    piece), as int64 (n_chunks,) holding the uint64 bits: on the card, one
    launch for the whole object."""
    if buf.device.type == "cpu":
        return ref.fnv1a64_chunks_ref(buf, chunk_size)
    return _fnv1a_kernel(buf, chunk_size)


def maxmin_waterfill(link_caps: torch.Tensor, link_ids: torch.Tensor,
                     flow_caps: torch.Tensor) -> torch.Tensor:
    """The max-min solve of a batch of padded problems: link_caps (B, Lp)
    float32, link_ids (B, Fp, width) int32, flow_caps (B, Fp) float32 →
    (B, Fp + 1) float32, each problem's rates and then its round count."""
    if link_caps.device.type == "cpu":
        return _maxmin.plain_waterfill(link_caps, link_ids, flow_caps)
    return _maxmin.WATERFILL(link_caps, link_ids, flow_caps)


def maxmin_rates(link_caps: torch.Tensor, membership: torch.Tensor,
                 flow_caps: torch.Tensor) -> torch.Tensor:
    """Max-min fair rates (F,) of link_caps (L,), a 0/1 membership (F, L)
    and per-flow caps (F,), solved on the inputs' device (on the card by
    the ``maxmin_waterfill`` kernel); ``ref.maxmin_ref`` is its float64
    oracle.  The counterpart of ``ops.maxmin_rates`` in the reference, for
    tensors: no caller in the system uses it (the simulator calls
    ``maxmin.maxmin_rates_sparse``), and it copies through the host."""
    rates = _maxmin.maxmin_rates(link_caps.cpu().numpy(),
                                 membership.cpu().numpy(),
                                 flow_caps.cpu().numpy(),
                                 device=link_caps.device)
    return torch.from_numpy(rates).to(link_caps.device)


def stack_distances(prev: torch.Tensor, sizes: torch.Tensor,
                    lengths: torch.Tensor) -> torch.Tensor:
    """Byte-weighted stack distances (B, Np) float64 of prev (B, Np) int64
    and sizes (B, Np) float64; ``inf`` on compulsory misses."""
    if prev.device.type == "cpu":
        return ref.stack_distances_ref(prev, sizes)
    return _sd.DISTANCES(prev, sizes, lengths)


def cache_sim(keys: torch.Tensor, admit: torch.Tensor, reset: torch.Tensor,
              key_sizes: torch.Tensor, capacity: torch.Tensor,
              fifo: torch.Tensor, lengths: torch.Tensor):
    """The LRU/FIFO slot machine: (hits (B, Np) bool, evictions (B,)
    int32, bytes evicted (B,) float64)."""
    if keys.device.type == "cpu":
        return ref.cache_sim_ref(keys, admit, reset, key_sizes, capacity,
                                 fifo)
    return _sd.CACHE_SIM(keys, admit, reset, key_sizes, capacity, fifo,
                         lengths)


def fifo_replay(keys: torch.Tensor, sizes: torch.Tensor, admit: torch.Tensor,
                reset: torch.Tensor, kcum0: torch.Tensor,
                capacity: torch.Tensor,
                lengths: torch.Tensor):
    """The byte-frontier FIFO replay: (hits (B, Np) bool, evictions (B,)
    int32, bytes evicted (B,) float64)."""
    if keys.device.type == "cpu":
        return ref.fifo_replay_ref(keys, sizes, admit, reset, kcum0,
                                   capacity)
    return _sd.FIFO_REPLAY(keys, sizes, admit, reset, kcum0, capacity,
                           lengths)


def plan_solve(stacked: torch.Tensor, per_cache: torch.Tensor,
               gidx: torch.Tensor, gsize: torch.Tensor,
               scalars: torch.Tensor, steps: int) -> torch.Tensor:
    """The planner's inverse solve of a batch of P plans: stacked (P, 3,
    N, Bk), per_cache (P, 3, N), gidx (P, N) int64, gsize (P, G) and
    scalars (P, 8) float64 → (P, G + 4) float64 (see
    ``ref.plan_solve_ref``)."""
    if stacked.device.type == "cpu":
        return ref.plan_solve_ref(stacked, per_cache, gidx, gsize, scalars,
                                  steps)
    return _cm.PLAN_SOLVE(stacked, per_cache, gidx, gsize, scalars, steps)


def mixture_fit(params0: torch.Tensor, grid: torch.Tensor,
                target: torch.Tensor, steps: int, lr: float):
    """``steps`` Adam steps fitting log-normal mixtures, params0 (P, 3, K)
    against grid and target (P, M), all float64 → (params (P, 3, K), the
    last step's loss (P,)) (see ``ref.mixture_fit_ref``)."""
    if params0.device.type == "cpu":
        return ref.mixture_fit_ref(params0, grid, target, steps, lr)
    return _cm.MIXTURE_FIT(params0, grid, target, steps, lr)
