"""FNV-1a-64 digests of an object's chunks as a hand-written CUDA kernel.

The federation checks every chunk of real bytes against a 64-bit FNV-1a
digest (paper §3.1; ``core/chunk.py``).  The reference computes it with
a host Python loop; the port sends an object's bytes to the card and
digests all its chunks in one launch, one thread a chunk
(``csrc/fnv1a.cu``, built and loaded by ``_build`` at first use and
called on PyTorch's current stream).  The plain version is
``ref.fnv1a64_chunks_ref``, the reference's own loop.

Digests come back as int64 tensors holding the uint64 bits;
``unsigned`` turns them into Python ints.
"""
from __future__ import annotations

import ctypes
from typing import List

import torch

from ._build import CudaLibrary

_vp, _cll = ctypes.c_void_p, ctypes.c_longlong
LIB = CudaLibrary("fnv1a", {
    "fnv1a_chunks_launch": ([_vp, _cll, _cll, _cll, _vp, _vp], ctypes.c_int)})

_MASK64 = (1 << 64) - 1


def num_chunks(n: int, chunk_size: int) -> int:
    """Chunks of an object of ``n`` bytes: an empty object is one chunk."""
    return max(1, -(-n // chunk_size))


def unsigned(digests: torch.Tensor) -> List[int]:
    """The uint64 digests held as int64 bits, as Python ints."""
    return [d & _MASK64 for d in digests.tolist()]


class Fnv1aKernel:
    """The launch count of the kernel: a plain integer, raised once per
    launch that the card accepted."""

    def __init__(self) -> None:
        self.launches = 0

    def __call__(self, buf: torch.Tensor, chunk_size: int) -> torch.Tensor:
        """buf: one object's bytes, a contiguous 1-D uint8 tensor on a
        CUDA device → int64 (n_chunks,) on it: each chunk's FNV-1a-64 bits,
        the last chunk shorter, in one launch."""
        if buf.device.type != "cuda":
            raise ValueError(f"fnv1a kernel: bytes are on {buf.device}, not "
                             f"a CUDA device")
        if buf.dtype != torch.uint8 or buf.dim() != 1 or \
                not buf.is_contiguous():
            raise ValueError(f"fnv1a kernel: needs a contiguous 1-D uint8 "
                             f"tensor, got {buf.dtype} {tuple(buf.shape)}")
        if chunk_size <= 0:
            raise ValueError(f"fnv1a kernel: chunk size {chunk_size}")
        n = buf.numel()
        out = torch.empty(num_chunks(n, chunk_size), dtype=torch.int64,
                          device=buf.device)
        lib = LIB.load()
        with torch.cuda.device(buf.device):
            stream = torch.cuda.current_stream(buf.device).cuda_stream
            err = lib.fnv1a_chunks_launch(buf.data_ptr(), n, chunk_size,
                                          out.numel(), out.data_ptr(),
                                          stream)
        LIB.check(err, "fnv1a")
        self.launches += 1
        return out


KERNEL = Fnv1aKernel()
