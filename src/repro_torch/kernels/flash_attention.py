"""Flash attention as a hand-written CUDA kernel for Hopper.

Replaces the Pallas TPU kernel ``repro.kernels.flash_attention``
(``_flash_kernel``); the source, with its design notes, is
``csrc/flash_attention.cu``, built and loaded by ``_build`` at first use
and called on PyTorch's current stream.
"""
from __future__ import annotations

import ctypes

import torch

from ._build import CudaLibrary

# head_dim instantiations: gemma2-2b's 256 and the smoke config's 16
HEAD_DIMS = (16, 256)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_vp, _ci, _cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
LIB = CudaLibrary("flash_attention", {
    "flash_attention_forward": (
        [_ci, _vp, _vp, _vp, _vp, _ci, _ci, _ci, _ci, _ci, _cf, _ci, _ci, _cf,
         _vp], _ci),
    "flash_attention_smem_bytes": ([_ci], _ci)})


class FlashAttentionKernel:
    """The loaded library and its launch count (a plain integer, raised
    once per launch that the card accepted)."""

    def __init__(self) -> None:
        self.launches = 0

    def smem_bytes(self, head_dim: int) -> int:
        """Dynamic shared memory one block takes at ``head_dim``."""
        return LIB.load().flash_attention_smem_bytes(head_dim)

    def __call__(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 causal: bool = True, window: int = 0,
                 softcap: float = 0.0) -> torch.Tensor:
        """q: (B, S, H, hd); k/v: (B, S, KV, hd) → (B, S, H, hd) in q's
        dtype.  Raises on anything the kernel does not take."""
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
                stream)
        LIB.check(err, "flash attention")
        self.launches += 1
        return out


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
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash attention kernel: head_dim {hd} not in "
                         f"{HEAD_DIMS}")
    if window < 0 or softcap < 0:
        raise ValueError("flash attention kernel: window and softcap must "
                         "be >= 0")


KERNEL = FlashAttentionKernel()
