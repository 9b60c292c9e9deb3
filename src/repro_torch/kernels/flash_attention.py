"""Flash attention as a hand-written CUDA kernel for Hopper.

Replaces the Pallas TPU kernel ``repro.kernels.flash_attention``
(``_flash_kernel``); the source, with its design notes, is
``csrc/flash_attention.cu``, built and loaded by ``_build`` at first use
and called on PyTorch's current stream.  The C entry point chooses one of
two designs by (dtype, head_dim): ``wgmma`` (tensor cores, TMA) for bf16
at head_dim 256, 128, 96 and 64, ``simt`` (fp32 on the CUDA cores) for
float32 at 256, 128 and 16 and for bf16 at head_dim 16; it refuses any
other pair.

Training goes through ``FlashAttentionFunction``: its forward is the same
kernel writing each row's log-sum-exp, its backward the hand-written
backward (FlashAttention-2's algorithm in three launches, no atomics):
design ``wgmma`` (tensor cores, TMA) for bf16 at head_dim 256, 128, 96
and 64, ``simt`` for float32 at 16 (``BACKWARD_DESIGNS``).  The reference
has no backward kernel: it differentiates its plain attention.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ._build import CudaLibrary

# (dtype, head_dim) → design, as the C entry point routes them:
# gemma2-2b's bf16 at 256, mixtral-8x22b's (and qwen2-7b's,
# deepseek-coder-33b's, phi3.5-moe's) at 128, phi3-mini-3.8b's at 96 and
# musicgen-medium's at 64 on the tensor cores; float32, and the smoke
# configs' head_dim 16, on the CUDA cores
DESIGNS = {(torch.bfloat16, 256): "wgmma", (torch.bfloat16, 128): "wgmma",
           (torch.bfloat16, 96): "wgmma", (torch.bfloat16, 64): "wgmma",
           (torch.float32, 256): "simt", (torch.float32, 128): "simt",
           (torch.float32, 16): "simt", (torch.bfloat16, 16): "simt"}
# the backward's (dtype, head_dim) → design, as the C entry point's
# ``backward_design_of`` routes them: the training paths of gemma2-2b
# (bf16 at 256), qwen2-7b (128), phi3-mini-3.8b (96) and musicgen-medium
# (64) on the tensor cores, the smoke configs' float32 at 16 on the CUDA
# cores
BACKWARD_DESIGNS = {(torch.bfloat16, 256): "wgmma",
                    (torch.bfloat16, 128): "wgmma",
                    (torch.bfloat16, 96): "wgmma",
                    (torch.bfloat16, 64): "wgmma",
                    (torch.float32, 16): "simt"}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_DESIGN_CODES = {0: "simt", 1: "wgmma"}
_vp, _ci, _cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
LIB = CudaLibrary("flash_attention", {
    "flash_attention_forward": (
        [_ci, _vp, _vp, _vp, _vp, _ci, _ci, _ci, _ci, _ci, _cf, _ci, _ci, _cf,
         _vp, _vp], _ci),
    "flash_attention_design": ([_ci, _ci], _ci),
    "flash_attention_smem_bytes": ([_ci, _ci], _ci),
    "flash_attention_backward": (
        [_ci, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _ci, _ci, _ci,
         _ci, _ci, _cf, _ci, _ci, _cf, _vp], _ci),
    "flash_attention_backward_design": ([_ci, _ci], _ci),
    "flash_attention_backward_smem_bytes": ([_ci, _ci, _ci], _ci)})


class FlashAttentionKernel:
    """The loaded library and its launch counts (plain integers, raised
    once per launch that the card accepted): ``launches`` in all and
    ``launches_by_design`` per design."""

    def __init__(self) -> None:
        self.launches = 0
        self.launches_by_design = dict.fromkeys(sorted(set(DESIGNS.values())),
                                                0)

    def design(self, dtype: torch.dtype, head_dim: int) -> str:
        """The design the library routes (dtype, head_dim) to; it must be
        the one ``DESIGNS`` names."""
        code = LIB.load().flash_attention_design(_DTYPE_CODES[dtype],
                                                 head_dim)
        got = _DESIGN_CODES.get(code)
        if got != DESIGNS.get((dtype, head_dim)):
            raise RuntimeError(f"flash attention: the library routes "
                               f"({dtype}, {head_dim}) to {got}, not "
                               f"{DESIGNS.get((dtype, head_dim))}")
        return got

    def smem_bytes(self, dtype: torch.dtype, head_dim: int) -> int:
        """Dynamic shared memory one block takes for (dtype, head_dim)."""
        return LIB.load().flash_attention_smem_bytes(_DTYPE_CODES[dtype],
                                                     head_dim)

    def __call__(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 causal: bool = True, window: int = 0,
                 softcap: float = 0.0) -> torch.Tensor:
        """q: (B, S, H, hd); k/v: (B, S, KV, hd) → (B, S, H, hd) in q's
        dtype.  Raises on anything the kernel does not take."""
        return self._launch(q, k, v, None, causal, window, softcap)

    def with_lse(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 causal: bool = True, window: int = 0, softcap: float = 0.0
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The same launch, also writing each row's log-sum-exp of its
        scaled (softcapped) scores: (out, lse float32 (B, H, S))."""
        b, s, h, _ = q.shape
        lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
        return self._launch(q, k, v, lse, causal, window, softcap), lse

    def _launch(self, q, k, v, lse, causal, window, softcap):
        _check_inputs(q, k, v, window, softcap)
        b, s, h, hd = q.shape
        out = torch.empty_like(q)
        lib = LIB.load()
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            err = lib.flash_attention_forward(
                _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(),
                v.data_ptr(), out.data_ptr(), b, s, h, k.shape[2], hd,
                1.0 / hd ** 0.5, int(causal), int(window), float(softcap),
                None if lse is None else lse.data_ptr(), stream)
        LIB.check(err, "flash attention")
        self.launches += 1
        self.launches_by_design[DESIGNS[(q.dtype, hd)]] += 1
        return out


class FlashAttentionBackward:
    """The backward's launches: ``launches`` counts calls (each is three
    kernels in one C call: the row pass, then dK/dV, then dQ),
    ``launches_by_design`` per design."""

    def __init__(self) -> None:
        self.launches = 0
        self.launches_by_design = dict.fromkeys(
            sorted(set(BACKWARD_DESIGNS.values())), 0)

    def design(self, dtype: torch.dtype, head_dim: int) -> Optional[str]:
        """The design the library routes (dtype, head_dim) to (None where
        it refuses the pair); it must be the one ``BACKWARD_DESIGNS``
        names."""
        code = LIB.load().flash_attention_backward_design(
            _DTYPE_CODES[dtype], head_dim)
        got = _DESIGN_CODES.get(code)
        if got != BACKWARD_DESIGNS.get((dtype, head_dim)):
            raise RuntimeError(f"flash attention backward: the library "
                               f"routes ({dtype}, {head_dim}) to {got}, not "
                               f"{BACKWARD_DESIGNS.get((dtype, head_dim))}")
        return got

    def smem_bytes(self, dtype: torch.dtype, head_dim: int) -> Tuple[int, int]:
        """Dynamic shared memory of a dK/dV block and of a row-pass or dQ
        block."""
        lib = LIB.load()
        return tuple(lib.flash_attention_backward_smem_bytes(
            _DTYPE_CODES[dtype], head_dim, which) for which in (0, 1))

    def __call__(self, q, k, v, dout, lse, *, causal: bool = True,
                 window: int = 0, softcap: float = 0.0):
        """(dq, dk, dv) in q's dtype from the forward's inputs, its ``lse``
        (float32 (B, H, S)) and the output's gradient ``dout``.  Raises on
        anything the kernel does not take."""
        _check_inputs(q, k, v, window, softcap)
        backward_design_for(q.dtype, q.shape[3])
        b, s, h, hd = q.shape
        if dout.shape != q.shape or dout.dtype != q.dtype or \
                dout.device != q.device or not dout.is_contiguous():
            raise ValueError("flash attention backward: dout must be "
                             "contiguous, of q's shape and dtype")
        if lse.shape != (b, h, s) or lse.dtype != torch.float32 or \
                lse.device != q.device or not lse.is_contiguous():
            raise ValueError("flash attention backward: lse must be "
                             "contiguous float32 (B, H, S) on q's device")
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        # lse' and D, S rounded up to 64 rows a head (the wgmma design's
        # dK/dV kernel copies a tile's 256 bytes of each in one piece)
        lse_rows, dsum = (torch.empty((b, h, -(-s // 64) * 64),
                                      dtype=torch.float32, device=q.device)
                          for _ in range(2))
        lib = LIB.load()
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            err = lib.flash_attention_backward(
                _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(),
                v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
                lse_rows.data_ptr(), dsum.data_ptr(), dq.data_ptr(),
                dk.data_ptr(), dv.data_ptr(), b, s, h, k.shape[2], hd,
                1.0 / hd ** 0.5, int(causal), int(window), float(softcap),
                stream)
        LIB.check(err, "flash attention backward")
        self.launches += 1
        self.launches_by_design[BACKWARD_DESIGNS[(q.dtype, hd)]] += 1
        return dq, dk, dv


class FlashAttentionFunction(torch.autograd.Function):
    """Flash attention with a gradient, on the card: the forward kernel
    writing lse, and the backward kernel.  Inputs and outputs as
    ``KERNEL``'s; the gradients come back in q's dtype."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int, softcap: float):
        backward_design_for(q.dtype, q.shape[3])
        o, lse = KERNEL.with_lse(q, k, v, causal=causal, window=window,
                                 softcap=softcap)
        ctx.save_for_backward(q, k, v, lse)
        ctx.opts = dict(causal=causal, window=window, softcap=softcap)
        return o

    @staticmethod
    def backward(ctx, dout):
        q, k, v, lse = ctx.saved_tensors
        dq, dk, dv = BACKWARD(q, k, v, dout.contiguous(), lse, **ctx.opts)
        return dq, dk, dv, None, None, None


def design_for(dtype: torch.dtype, head_dim: int) -> str:
    """The design ``DESIGNS`` names for (dtype, head_dim); raises for a
    pair that no design serves."""
    design = DESIGNS.get((dtype, head_dim))
    if design is None:
        raise ValueError(f"flash attention kernel: no design for {dtype} at "
                         f"head_dim {head_dim}; it takes "
                         f"{sorted((str(d), n) for d, n in DESIGNS)}")
    return design


def backward_design_for(dtype: torch.dtype, head_dim: int) -> str:
    """The backward design ``BACKWARD_DESIGNS`` names for (dtype,
    head_dim); raises for a pair that no backward design serves."""
    design = BACKWARD_DESIGNS.get((dtype, head_dim))
    if design is None:
        raise ValueError(f"flash attention backward kernel: no design for "
                         f"{dtype} at head_dim {head_dim}; it takes "
                         f"{sorted((str(d), n) for d, n in BACKWARD_DESIGNS)}")
    return design


def _check_inputs(q, k, v, window, softcap) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"flash attention kernel: {name} is on "
                             f"{t.device}, not a CUDA device")
        if t.device != q.device:
            raise ValueError("flash attention kernel: q, k, v on different "
                             "devices")
        if t.dtype != q.dtype or t.dtype not in _DTYPE_CODES:
            raise ValueError(f"flash attention kernel: dtypes {q.dtype}, "
                             f"{k.dtype}, {v.dtype}; needs one of "
                             f"{sorted(map(str, _DTYPE_CODES))} for all")
        if t.dim() != 4 or not t.is_contiguous():
            raise ValueError(f"flash attention kernel: {name} must be a "
                             f"contiguous 4-D tensor")
        if t.data_ptr() % 16:
            raise ValueError(f"flash attention kernel: {name} is not "
                             f"16-byte aligned")
    b, s, h, hd = q.shape
    if k.shape != v.shape or k.shape[:2] != (b, s) or k.shape[3] != hd:
        raise ValueError(f"flash attention kernel: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if s == 0 or b == 0 or k.shape[2] == 0 or h % k.shape[2]:
        raise ValueError(f"flash attention kernel: {h} q-heads over "
                         f"{k.shape[2]} KV heads, S={s}, B={b}")
    design_for(q.dtype, hd)
    if window < 0 or softcap < 0:
        raise ValueError("flash attention kernel: window and softcap must "
                         "be >= 0")


KERNEL = FlashAttentionKernel()
BACKWARD = FlashAttentionBackward()
