"""Mamba-2 SSD intra-chunk term as a hand-written CUDA kernel for Hopper.

Replaces the Pallas TPU kernel ``repro.kernels.ssd_scan`` (``_ssd_kernel``
/ ``ssd_intra``); the source, with its design notes, is
``csrc/ssd_scan.cu``, built and loaded by ``_build`` at first use and
called on PyTorch's current stream.  The plain version is
``ref.ssd_intra_ref``.
"""
from __future__ import annotations

import ctypes

import torch

from ._build import CudaLibrary

# (P, N) → design, as the C entry point routes them: mamba2-780m's
# (64, 128) and jamba-1.5-large's (128, 128) on the tensor cores (the
# latter in two 64-column passes a head), the smoke configs' (16, 16) on
# the CUDA cores.  The chunk length Q is a runtime value, at most
# WGMMA_MAX_Q on both wgmma designs (12 key tiles of scores in shared
# memory).
DESIGNS = {(64, 128): "wgmma", (128, 128): "wgmma_p128", (16, 16): "simt"}
WGMMA_MAX_Q = 768
_DESIGN_CODES = {0: "simt", 1: "wgmma", 2: "wgmma_p128"}
_vp, _ci = ctypes.c_void_p, ctypes.c_int
LIB = CudaLibrary("ssd_scan", {
    "ssd_scan_intra": ([_vp] * 6 + [_ci] * 6 + [_vp], _ci),
    "ssd_scan_design": ([_ci, _ci], _ci),
    "ssd_scan_smem_bytes": ([_ci, _ci, _ci], _ci)})


class SSDIntraKernel:
    """The launch counts of the kernel (plain integers, raised once per
    launch that the card accepted): ``launches`` in all and
    ``launches_by_design`` per design."""

    def __init__(self) -> None:
        self.launches = 0
        self.launches_by_design = dict.fromkeys(sorted(set(DESIGNS.values())),
                                                0)

    def design(self, p: int, n: int) -> str:
        """The design the library routes (P, N) to; it must be the one
        ``DESIGNS`` names."""
        got = _DESIGN_CODES.get(LIB.load().ssd_scan_design(p, n))
        if got != DESIGNS.get((p, n)):
            raise RuntimeError(f"ssd_intra: the library routes ({p}, {n}) to "
                               f"{got}, not {DESIGNS.get((p, n))}")
        return got

    def smem_bytes(self, p: int, n: int, q: int) -> int:
        """Dynamic shared memory one block takes at (P, N) and chunk
        length Q."""
        return LIB.load().ssd_scan_smem_bytes(p, n, q)

    def __call__(self, x: torch.Tensor, dt: torch.Tensor, cum: torch.Tensor,
                 b_in: torch.Tensor, c_in: torch.Tensor) -> torch.Tensor:
        """x: (B, NC, Q, H, P); dt, cum: (B, NC, Q, H); b_in, c_in:
        (B, NC, Q, N), all float32 → (B, NC, Q, H, P) float32.  Raises on
        anything the kernel does not take."""
        _check_inputs(x, dt, cum, b_in, c_in)
        bsz, nc, q, h, p = x.shape
        y = torch.empty_like(x)
        lib = LIB.load()
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = lib.ssd_scan_intra(
                x.data_ptr(), dt.data_ptr(), cum.data_ptr(), b_in.data_ptr(),
                c_in.data_ptr(), y.data_ptr(), bsz, nc, q, h, p,
                b_in.shape[-1], stream)
        LIB.check(err, "ssd_intra")
        self.launches += 1
        self.launches_by_design[DESIGNS[(p, b_in.shape[-1])]] += 1
        return y


def _check_inputs(x, dt, cum, b_in, c_in) -> None:
    """Raises on anything the kernel does not take: ranks, dtypes and
    shapes first, then the (P, N) and Q the designs serve, then the device
    and alignment, so the first two are checked on any device."""
    named = (("x", x, 5), ("dt", dt, 4), ("cum", cum, 4), ("b_in", b_in, 4),
             ("c_in", c_in, 4))
    for name, t, dim in named:
        if t.dtype != torch.float32:
            raise ValueError(f"ssd_intra kernel: {name} is {t.dtype}; "
                             f"needs float32")
        if t.dim() != dim or not t.is_contiguous():
            raise ValueError(f"ssd_intra kernel: {name} must be a "
                             f"contiguous {dim}-D tensor")
    bsz, nc, q, h, p = x.shape
    n = b_in.shape[-1]
    if dt.shape != (bsz, nc, q, h) or cum.shape != dt.shape or \
            b_in.shape != (bsz, nc, q, n) or c_in.shape != b_in.shape:
        raise ValueError(f"ssd_intra kernel: x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, cum {tuple(cum.shape)}, b_in "
                         f"{tuple(b_in.shape)}, c_in {tuple(c_in.shape)}")
    if (p, n) not in DESIGNS:
        raise ValueError(f"ssd_intra kernel: (P, N) = ({p}, {n}) not in "
                         f"{tuple(DESIGNS)}")
    if DESIGNS[(p, n)] != "simt" and q > WGMMA_MAX_Q:
        raise ValueError(f"ssd_intra kernel: Q={q} above the "
                         f"{DESIGNS[(p, n)]} design's {WGMMA_MAX_Q}")
    if min(bsz, nc, q, h) == 0 or bsz * nc > 65535:
        raise ValueError(f"ssd_intra kernel: B={bsz}, NC={nc}, Q={q}, "
                         f"H={h}; needs each >= 1 and B*NC <= 65535")
    for name, t, _ in named:
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"ssd_intra kernel: {name} is on {t.device}, "
                             f"not the CUDA device of x")
        if t.data_ptr() % 16:
            raise ValueError(f"ssd_intra kernel: {name} is not 16-byte "
                             f"aligned")


KERNEL = SSDIntraKernel()
