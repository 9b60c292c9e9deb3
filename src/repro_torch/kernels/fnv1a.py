"""FNV-1a-64 digests of an object's chunks as a hand-written CUDA kernel.

The federation checks every chunk of real bytes against a 64-bit FNV-1a
digest (paper §3.1; ``core/chunk.py``).  The reference computes it with
a host Python loop; the port sends an object's bytes to the card and
digests all its chunks in one call (``csrc/fnv1a.cu``, built and loaded
by ``_build`` at first use and launched on PyTorch's current stream).
Each chunk is split exactly across the card: its segments of ``SEG``
bytes get their low-byte tables, a walk gives each segment's start byte,
each segment's 64-bit partial follows from it, and the partials compose
as affine maps (design ``split``, four kernels).  An object whose longest
chunk is at most one segment takes design ``short``: a thread a chunk.
The plain version is ``ref.fnv1a64_chunks_ref``, the reference's own
loop.

Digests come back as int64 tensors holding the uint64 bits;
``unsigned`` turns them into Python ints.
"""
from __future__ import annotations

import ctypes
from typing import List

import torch

from ._build import CudaLibrary

# The split's sizes, compiled into csrc/fnv1a.cu: bytes a segment (a
# multiple of 16) and segments a group (a multiple of 32, at most 256),
# one block of the table stage a group.
SEG, GROUP = 2048, 32
DESIGNS = ("short", "split")

_vp, _cll = ctypes.c_void_p, ctypes.c_longlong
LIB = CudaLibrary("fnv1a", {
    "fnv1a_chunks_launch": ([_vp, _cll, _cll, _cll, _vp, _vp, _vp],
                            ctypes.c_int),
    "fnv1a_work_bytes": ([_cll, _cll, _cll], _cll)},
    defines={"FNV_SEG": SEG, "FNV_GROUP": GROUP})

_MASK64 = (1 << 64) - 1


def num_chunks(n: int, chunk_size: int) -> int:
    """Chunks of an object of ``n`` bytes: an empty object is one chunk."""
    return max(1, -(-n // chunk_size))


def design(n: int, chunk_size: int) -> str:
    """``short`` when the object's longest chunk is at most one segment,
    else ``split``."""
    return "short" if min(n, chunk_size) <= SEG else "split"


def unsigned(digests: torch.Tensor) -> List[int]:
    """The uint64 digests held as int64 bits, as Python ints."""
    return [d & _MASK64 for d in digests.tolist()]


class Fnv1aKernel:
    """The launch count of the kernel: a plain integer, raised once per
    call that the card accepted, whatever stages it launches;
    ``launches_by_design`` counts each design."""

    def __init__(self) -> None:
        self.launches = 0
        self.launches_by_design = dict.fromkeys(DESIGNS, 0)

    def __call__(self, buf: torch.Tensor, chunk_size: int) -> torch.Tensor:
        """buf: one object's bytes, a contiguous 1-D uint8 tensor on a
        CUDA device → int64 (n_chunks,) on it: each chunk's FNV-1a-64 bits,
        the last chunk shorter, in one call."""
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
        chunks = num_chunks(n, chunk_size)
        lib = LIB.load()
        out = torch.empty(chunks, dtype=torch.int64, device=buf.device)
        work = torch.empty(int(lib.fnv1a_work_bytes(n, chunk_size, chunks)),
                           dtype=torch.uint8, device=buf.device)
        with torch.cuda.device(buf.device):
            stream = torch.cuda.current_stream(buf.device).cuda_stream
            err = lib.fnv1a_chunks_launch(buf.data_ptr(), n, chunk_size,
                                          chunks, work.data_ptr(),
                                          out.data_ptr(), stream)
        LIB.check(err, "fnv1a")
        self.launches += 1
        self.launches_by_design[design(n, chunk_size)] += 1
        return out


KERNEL = Fnv1aKernel()
