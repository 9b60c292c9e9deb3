"""Mamba-2 SSD intra-chunk term and its gradient as hand-written CUDA
kernels for Hopper.

Replaces the Pallas TPU kernel ``repro.kernels.ssd_scan`` (``_ssd_kernel``
/ ``ssd_intra``); the source, with its design notes, is
``csrc/ssd_scan.cu``, built and loaded by ``_build`` at first use and
called on PyTorch's current stream.  The plain version is
``ref.ssd_intra_ref``.  The reference trains through ``jax.grad`` of its
plain jnp and has no backward kernel; here the gradient is ``BACKWARD``
(three launches, counted once), reached through ``SSDIntraFunction``, and
its plain version ``ref.ssd_intra_bwd_ref``.
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
# (P, N) → the backward's design, as the C entry point routes them: one
# design on the fp32 CUDA cores, a template over (P, N), at every (P, N)
# the forward serves; Q at most WGMMA_MAX_Q at each.
BACKWARD_DESIGNS = {(64, 128): "simt_p64", (128, 128): "simt_p128",
                    (16, 16): "simt"}
_BACKWARD_CODES = {0: "simt", 1: "simt_p64", 2: "simt_p128"}
_vp, _ci = ctypes.c_void_p, ctypes.c_int
LIB = CudaLibrary("ssd_scan", {
    "ssd_scan_intra": ([_vp] * 6 + [_ci] * 6 + [_vp], _ci),
    "ssd_scan_design": ([_ci, _ci], _ci),
    "ssd_scan_smem_bytes": ([_ci, _ci, _ci], _ci),
    "ssd_scan_intra_bwd": ([_vp] * 12 + [_ci] * 6 + [_vp], _ci),
    "ssd_scan_bwd_design": ([_ci, _ci], _ci),
    "ssd_scan_bwd_work_bytes": ([_ci] * 4, ctypes.c_longlong)})


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
        return self._launch(x, dt, cum, b_in, c_in)

    def _launch(self, x, dt, cum, b_in, c_in):
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


class SSDIntraBackward:
    """The backward's launches: ``launches`` counts calls (each is three
    launches: the scores, the heads, the reductions), once per call that
    the card accepted; ``launches_by_design`` per design."""

    def __init__(self) -> None:
        self.launches = 0
        self.launches_by_design = dict.fromkeys(
            sorted(set(BACKWARD_DESIGNS.values())), 0)

    def design(self, p: int, n: int) -> str:
        """The backward design the library routes (P, N) to; it must be the
        one ``BACKWARD_DESIGNS`` names."""
        got = _BACKWARD_CODES.get(LIB.load().ssd_scan_bwd_design(p, n))
        if got != BACKWARD_DESIGNS.get((p, n)):
            raise RuntimeError(f"ssd_intra backward: the library routes "
                               f"({p}, {n}) to {got}, not "
                               f"{BACKWARD_DESIGNS.get((p, n))}")
        return got

    def __call__(self, x: torch.Tensor, dt: torch.Tensor, cum: torch.Tensor,
                 b_in: torch.Tensor, c_in: torch.Tensor, dy: torch.Tensor):
        """The forward's inputs and dy (B, NC, Q, H, P), all float32 →
        (dx, ddt, dcum, db, dc), each of its input's shape.  Raises on
        anything the kernel does not take."""
        _check_inputs(x, dt, cum, b_in, c_in, dy=dy)
        bsz, nc, q, h, p = x.shape
        n = b_in.shape[-1]
        dx, ddt, dcum = (torch.empty_like(t) for t in (x, dt, cum))
        db, dc = torch.empty_like(b_in), torch.empty_like(c_in)
        lib = LIB.load()
        work = torch.empty(lib.ssd_scan_bwd_work_bytes(bsz, nc, q, h),
                           dtype=torch.uint8, device=x.device)
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = lib.ssd_scan_intra_bwd(
                x.data_ptr(), dt.data_ptr(), cum.data_ptr(), b_in.data_ptr(),
                c_in.data_ptr(), dy.data_ptr(), dx.data_ptr(),
                ddt.data_ptr(), dcum.data_ptr(), db.data_ptr(),
                dc.data_ptr(), work.data_ptr(), bsz, nc, q, h, p, n, stream)
        LIB.check(err, "ssd_intra backward")
        self.launches += 1
        self.launches_by_design[BACKWARD_DESIGNS[(p, n)]] += 1
        return dx, ddt, dcum, db, dc


class SSDIntraFunction(torch.autograd.Function):
    """``ssd_intra`` on the card with its gradient: the forward kernel,
    then ``BACKWARD`` on the saved inputs."""

    @staticmethod
    def forward(ctx, x, dt, cum, b_in, c_in):
        ctx.save_for_backward(x, dt, cum, b_in, c_in)
        return KERNEL(x, dt, cum, b_in, c_in)

    @staticmethod
    def backward(ctx, dy):
        return BACKWARD(*ctx.saved_tensors, dy.contiguous())


def _check_inputs(x, dt, cum, b_in, c_in, dy=None) -> None:
    """Raises on anything the kernel (the backward when ``dy`` is given)
    does not take: ranks, dtypes and shapes first, then the (P, N) and Q
    the designs serve, then the device and alignment, so the first two
    are checked on any device."""
    what = "ssd_intra kernel" if dy is None else "ssd_intra backward"
    named = (("x", x, 5), ("dt", dt, 4), ("cum", cum, 4), ("b_in", b_in, 4),
             ("c_in", c_in, 4)) + (() if dy is None else (("dy", dy, 5),))
    for name, t, dim in named:
        if t.dtype != torch.float32:
            raise ValueError(f"{what}: {name} is {t.dtype}; needs float32")
        if t.dim() != dim or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be a contiguous {dim}-D "
                             f"tensor")
    bsz, nc, q, h, p = x.shape
    n = b_in.shape[-1]
    if dt.shape != (bsz, nc, q, h) or cum.shape != dt.shape or \
            b_in.shape != (bsz, nc, q, n) or c_in.shape != b_in.shape or \
            (dy is not None and dy.shape != x.shape):
        raise ValueError(f"{what}: x {tuple(x.shape)}, dt {tuple(dt.shape)}, "
                         f"cum {tuple(cum.shape)}, b_in {tuple(b_in.shape)}, "
                         f"c_in {tuple(c_in.shape)}" +
                         ("" if dy is None else f", dy {tuple(dy.shape)}"))
    designs = DESIGNS if dy is None else BACKWARD_DESIGNS
    if (p, n) not in designs:
        raise ValueError(f"{what}: (P, N) = ({p}, {n}) not in "
                         f"{tuple(designs)}")
    design = designs[(p, n)]
    if (dy is not None or design != "simt") and q > WGMMA_MAX_Q:
        raise ValueError(f"{what}: Q={q} above the {design} design's "
                         f"{WGMMA_MAX_Q}")
    if min(bsz, nc, q, h) == 0 or bsz * nc > 65535:
        raise ValueError(f"{what}: B={bsz}, NC={nc}, Q={q}, H={h}; needs "
                         f"each >= 1 and B*NC <= 65535")
    for name, t, _ in named:
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"{what}: {name} is on {t.device}, not the CUDA "
                             f"device of x")
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} is not 16-byte aligned")


KERNEL = SSDIntraKernel()
BACKWARD = SSDIntraBackward()
