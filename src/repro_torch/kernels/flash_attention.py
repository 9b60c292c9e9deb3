"""Flash attention as a hand-written CUDA kernel for Hopper.

Replaces the Pallas TPU kernel ``repro.kernels.flash_attention``
(``_flash_kernel``); the source, with its design notes, is
``csrc/flash_attention.cu``.  The kernel is compiled with ``nvcc`` into a
shared library with a plain C interface at first use, into ``_build/``
beside this file, and called through ``ctypes`` on PyTorch's current
stream.  The library's name carries a hash of the source and the flags,
so a changed source or flag set is never served by an old library.
Nothing is compiled or loaded when the module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
from typing import Optional

import torch

SOURCE = pathlib.Path(__file__).resolve().with_name("csrc") / \
    "flash_attention.cu"
BUILD_DIR = pathlib.Path(__file__).resolve().with_name("_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# head_dim instantiations: gemma2-2b's 256 and the smoke config's 16
HEAD_DIMS = (16, 256)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_TAG = hashlib.sha256(SOURCE.read_bytes() + "\0".join(NVCC_FLAGS).encode()
                      ).hexdigest()[:8]
LIBRARY = BUILD_DIR / f"libflash_attention.{_TAG}.so"
PTXAS_REPORT = BUILD_DIR / f"flash_attention.{_TAG}.ptxas.txt"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the flash attention kernel")


def build() -> pathlib.Path:
    """Compile the library unless one built from this source and these
    flags exists.  The compiler's per-kernel report (registers, shared
    memory, spills) is kept in ``PTXAS_REPORT``.  Returns the library's
    path."""
    if LIBRARY.exists() and PTXAS_REPORT.exists():
        return LIBRARY
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = LIBRARY.with_name(f"{LIBRARY.name}.{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                           str(SOURCE)], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {SOURCE.name}:\n{proc.stderr}")
    PTXAS_REPORT.write_text(proc.stderr)
    os.replace(tmp, LIBRARY)   # atomic: no process loads a half-written file
    return LIBRARY


class FlashAttentionKernel:
    """The loaded library and its launch count (a plain integer, raised
    once per launch that the card accepted)."""

    def __init__(self) -> None:
        self.launches = 0
        self._lib: Optional[ctypes.CDLL] = None

    def _library(self) -> ctypes.CDLL:
        if self._lib is None:
            lib = ctypes.CDLL(str(build()))
            vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            lib.flash_attention_forward.argtypes = [
                ci, vp, vp, vp, vp, ci, ci, ci, ci, ci, cf, ci, ci, cf, vp]
            lib.flash_attention_forward.restype = ci
            lib.flash_attention_error_string.argtypes = [ci]
            lib.flash_attention_error_string.restype = ctypes.c_char_p
            lib.flash_attention_smem_bytes.argtypes = [ci]
            lib.flash_attention_smem_bytes.restype = ci
            self._lib = lib
        return self._lib

    def smem_bytes(self, head_dim: int) -> int:
        """Dynamic shared memory one block takes at ``head_dim``."""
        return self._library().flash_attention_smem_bytes(head_dim)

    def __call__(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 causal: bool = True, window: int = 0,
                 softcap: float = 0.0) -> torch.Tensor:
        """q: (B, S, H, hd); k/v: (B, S, KV, hd) → (B, S, H, hd) in q's
        dtype.  Raises on anything the kernel does not take."""
        _check_inputs(q, k, v, window, softcap)
        b, s, h, hd = q.shape
        out = torch.empty_like(q)
        lib = self._library()
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            err = lib.flash_attention_forward(
                _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(),
                v.data_ptr(), out.data_ptr(), b, s, h, k.shape[2], hd,
                1.0 / hd ** 0.5, int(causal), int(window), float(softcap),
                stream)
        if err:
            msg = lib.flash_attention_error_string(err).decode()
            raise RuntimeError(f"flash attention launch failed: {msg} "
                               f"(cudaError {err})")
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
