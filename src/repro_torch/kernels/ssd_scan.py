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

# (P, N) instantiations: mamba2-780m's (64, 128) and its smoke config's
# (16, 16).  The chunk length Q is a runtime value.
SHAPES = ((64, 128), (16, 16))
_vp, _ci = ctypes.c_void_p, ctypes.c_int
LIB = CudaLibrary("ssd_scan", {
    "ssd_scan_intra": ([_vp] * 6 + [_ci] * 6 + [_vp], _ci),
    "ssd_scan_smem_bytes": ([_ci, _ci], _ci)})


class SSDIntraKernel:
    """The launch count of the kernel: a plain integer, raised once per
    launch that the card accepted."""

    def __init__(self) -> None:
        self.launches = 0

    def smem_bytes(self, p: int, n: int) -> int:
        """Dynamic shared memory one block takes at (P, N)."""
        return LIB.load().ssd_scan_smem_bytes(p, n)

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
        return y


def _check_inputs(x, dt, cum, b_in, c_in) -> None:
    named = (("x", x, 5), ("dt", dt, 4), ("cum", cum, 4), ("b_in", b_in, 4),
             ("c_in", c_in, 4))
    for name, t, dim in named:
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"ssd_intra kernel: {name} is on {t.device}, "
                             f"not the CUDA device of x")
        if t.dtype != torch.float32:
            raise ValueError(f"ssd_intra kernel: {name} is {t.dtype}; "
                             f"needs float32")
        if t.dim() != dim or not t.is_contiguous():
            raise ValueError(f"ssd_intra kernel: {name} must be a "
                             f"contiguous {dim}-D tensor")
        if t.data_ptr() % 16:
            raise ValueError(f"ssd_intra kernel: {name} is not 16-byte "
                             f"aligned")
    bsz, nc, q, h, p = x.shape
    n = b_in.shape[-1]
    if dt.shape != (bsz, nc, q, h) or cum.shape != dt.shape or \
            b_in.shape != (bsz, nc, q, n) or c_in.shape != b_in.shape:
        raise ValueError(f"ssd_intra kernel: x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, cum {tuple(cum.shape)}, b_in "
                         f"{tuple(b_in.shape)}, c_in {tuple(c_in.shape)}")
    if (p, n) not in SHAPES:
        raise ValueError(f"ssd_intra kernel: (P, N) = ({p}, {n}) not in "
                         f"{SHAPES}")
    if min(bsz, nc, q, h) == 0 or bsz * nc > 65535:
        raise ValueError(f"ssd_intra kernel: B={bsz}, NC={nc}, Q={q}, "
                         f"H={h}; needs each >= 1 and B*NC <= 65535")


KERNEL = SSDIntraKernel()
