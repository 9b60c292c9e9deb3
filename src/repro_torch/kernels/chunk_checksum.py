"""Blockwise chunk checksums as a hand-written CUDA kernel for Hopper.

Replaces the Pallas TPU kernel ``repro.kernels.chunk_checksum``
(``_checksum_kernel`` / ``block_digests``), whose job is validating the
checksums of cache chunks (dataset shards, checkpoint leaves) on a
worker's ingest path.  The source, with its design notes, is
``csrc/chunk_checksum.cu``, built and loaded by ``_build`` at first use
and called on PyTorch's current stream.  One launch computes the block
digests and their fold.  The plain version is ``ref.poly_digest_ref``.

``block_digests``, ``combine_digests`` and ``chunk_checksum`` have the
reference's signatures and return uint32 tensors.
"""
from __future__ import annotations

import ctypes

import torch

from . import ref
from ._build import CudaLibrary

BLOCKS = (256, 1024)               # block-length instantiations
_DTYPE_CODES = {torch.uint8: 0, torch.int32: 1}
_vp, _ci, _cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
LIB = CudaLibrary("chunk_checksum", {
    "chunk_checksum_digests": ([_ci, _vp, _cll, _ci, _vp, _cll, _vp], _ci)})


class ChecksumKernel:
    """The launch count of the kernel: a plain integer, raised once per
    launch that the card accepted."""

    def __init__(self) -> None:
        self.launches = 0

    def __call__(self, data: torch.Tensor, block: int = 1024):
        """``data``: a contiguous uint8 or int32 tensor on the card, any
        shape, read flat.  Returns (total, digests): uint32 of shape ()
        and (n_blocks,)."""
        if data.device.type != "cuda":
            raise ValueError(f"chunk checksum kernel: data is on "
                             f"{data.device}, not a CUDA device")
        if data.dtype not in _DTYPE_CODES:
            raise ValueError(f"chunk checksum kernel: {data.dtype}; needs "
                             f"uint8 or int32")
        if not data.is_contiguous() or data.data_ptr() % 16:
            raise ValueError("chunk checksum kernel: data must be contiguous "
                             "and 16-byte aligned")
        if block not in BLOCKS:
            raise ValueError(f"chunk checksum kernel: block {block} not in "
                             f"{BLOCKS}")
        n = data.numel()
        n_blocks = -(-n // block)
        out = torch.empty(n_blocks + 1, dtype=torch.int32, device=data.device)
        lib = LIB.load()
        with torch.cuda.device(data.device):
            stream = torch.cuda.current_stream(data.device).cuda_stream
            err = lib.chunk_checksum_digests(
                _DTYPE_CODES[data.dtype], data.data_ptr(), n, block,
                out.data_ptr(), n_blocks, stream)
        LIB.check(err, "chunk checksum")
        self.launches += 1
        out = out.view(torch.uint32)
        return out[n_blocks], out[:n_blocks]


KERNEL = ChecksumKernel()


def block_digests(data: torch.Tensor, block: int = 1024) -> torch.Tensor:
    """Per-block polynomial digests of a uint8/int32 buffer (the kernel)."""
    return KERNEL(data, block)[1]


def combine_digests(digests: torch.Tensor, block: int = 1024
                    ) -> torch.Tensor:
    """Fold per-block digests into one uint32 with the same polynomial
    weights.  Plain exact arithmetic on the digests' device, as the
    reference folds outside its kernel; ``block`` is unused there too."""
    return ref.fold_digests(digests)


def chunk_checksum(data: torch.Tensor, block: int = 1024) -> torch.Tensor:
    """The buffer's checksum: its block digests folded (the kernel)."""
    return KERNEL(data, block)[0]
