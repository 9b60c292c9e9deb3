"""Blockwise chunk checksums as a hand-written CUDA kernel for Hopper.

Replaces the Pallas TPU kernel ``repro.kernels.chunk_checksum``
(``_checksum_kernel`` / ``block_digests``), whose job is validating the
checksums of cache chunks (dataset shards, checkpoint leaves) on a
worker's ingest path.  The source, with its design notes, is
``csrc/chunk_checksum.cu``, built and loaded by ``_build`` at first use
and called on PyTorch's current stream.  One launch computes the block
digests and their fold for a whole list of buffers (``KERNEL.many``); a
single buffer is the list of one.  The plain version is
``ref.poly_digest_ref``.

``block_digests``, ``combine_digests`` and ``chunk_checksum`` have the
reference's signatures and return uint32 tensors; ``chunk_checksums``
takes a list.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from . import ref
from ._build import CudaLibrary

BLOCKS = (256, 1024)               # block-length instantiations
_DTYPE_CODES = {torch.uint8: 0, torch.int32: 1}
UNIT_BYTES = 4096                  # one warp's step: 4 KB of a buffer
_vp, _ci, _cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
LIB = CudaLibrary("chunk_checksum", {
    "chunk_checksum_many": ([_vp, _ci, _cll, _ci, _vp, _vp, _vp], _ci)})


def plan(n, itemsize, block: int):
    """The launch's table, without its pointer column, for buffers of
    ``n`` elements of ``itemsize`` bytes (1 or 4) each.  Returns (rows,
    offsets, total_units): int64 rows of [elements, first digest, first
    unit, dtype code] (0 uint8, 1 int32), the n + 1 digest offsets
    (buffer i's digests are ``offsets[i]:offsets[i + 1]``) and the units
    in all.  A unit is ``UNIT_BYTES`` of consecutive blocks of one
    buffer, counted from its end."""
    n = np.asarray(n, np.int64)
    itemsize = np.asarray(itemsize, np.int64)
    n_blocks = -(-n // block)
    units = -(-n_blocks // (UNIT_BYTES // (block * itemsize)))
    offsets = np.concatenate([[0], np.cumsum(n_blocks)])
    first_unit = np.concatenate([[0], np.cumsum(units)])
    rows = np.stack([n, offsets[:-1], first_unit[:-1],
                     (itemsize == 4).astype(np.int64)], axis=1)
    return rows, offsets, int(first_unit[-1])


class Launch(NamedTuple):
    """A checked list of buffers and its table on their card.  It holds the
    buffers, so their memory stays theirs while it lives."""
    table: torch.Tensor
    n: int
    units: int
    block: int
    offsets: list
    buffers: list


class ChecksumKernel:
    """The launch count of the kernel: a plain integer, raised once per
    launch that the card accepted."""

    def __init__(self) -> None:
        self.launches = 0

    def prepare(self, buffers, block: int = 1024, *,
                as_bytes: bool = False) -> "Launch":
        """Check ``buffers`` and build the launch's table on their card
        (see ``many``); ``run`` launches it, as often as the buffers are to
        be checked."""
        buffers = list(buffers)
        if not buffers:
            raise ValueError("chunk checksum kernel: no buffers")
        if block not in BLOCKS:
            raise ValueError(f"chunk checksum kernel: block {block} not in "
                             f"{BLOCKS}")
        device = buffers[0].device
        ptrs, sizes, itemsizes = [], [], []
        for i, data in enumerate(buffers):
            if data.device.type != "cuda" or data.device != device:
                raise ValueError(f"chunk checksum kernel: buffer {i} is on "
                                 f"{data.device}, not a CUDA device (or not "
                                 f"the first buffer's)")
            if not as_bytes and data.dtype not in _DTYPE_CODES:
                raise ValueError(f"chunk checksum kernel: buffer {i} is "
                                 f"{data.dtype}; needs uint8 or int32")
            ptr = data.data_ptr()
            if ptr % 16 or not data.is_contiguous():
                raise ValueError(f"chunk checksum kernel: buffer {i} must be "
                                 f"contiguous and 16-byte aligned")
            ptrs.append(ptr)
            if as_bytes:
                sizes.append(data.nbytes)
                itemsizes.append(1)
            else:
                sizes.append(data.numel())
                itemsizes.append(data.element_size())
        rows, offsets, units = plan(sizes, itemsizes, block)
        table = torch.from_numpy(np.concatenate(
            [np.asarray(ptrs, np.int64)[:, None], rows], axis=1)
        ).to(device, non_blocking=True)
        return Launch(table, len(buffers), units, block, offsets.tolist(),
                      buffers)

    def run(self, launch: "Launch"):
        """One launch over a prepared list.  Returns (totals, digests,
        offsets), as ``many`` does."""
        n_digests = launch.offsets[-1]
        device = launch.table.device
        out = torch.empty(n_digests + launch.n, dtype=torch.int32,
                          device=device)
        lib = LIB.load()
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = lib.chunk_checksum_many(
                launch.table.data_ptr(), launch.n, launch.units, launch.block,
                out.data_ptr(), out.data_ptr() + 4 * n_digests, stream)
        LIB.check(err, "chunk checksum")
        self.launches += 1
        out = out.view(torch.uint32)
        return out[n_digests:], out[:n_digests], launch.offsets

    def many(self, buffers, block: int = 1024, *, as_bytes: bool = False):
        """Every buffer's block digests and checksum in one launch.
        ``buffers``: contiguous tensors on one card, any shapes, each read
        flat: uint8 or int32, or any dtype read as its bytes when
        ``as_bytes``.  Returns (totals, digests, offsets): uint32 (n,) and
        (sum of n_blocks,), and the n + 1 digest offsets as a list (buffer
        i's digests are ``offsets[i]:offsets[i + 1]``)."""
        return self.run(self.prepare(buffers, block, as_bytes=as_bytes))

    def __call__(self, data: torch.Tensor, block: int = 1024):
        """One buffer (the one-buffer case of ``many``).  Returns (total,
        digests): uint32 of shape () and (n_blocks,)."""
        totals, digests, _ = self.many([data], block)
        return totals[0], digests


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


def chunk_checksums(buffers, block: int = 1024, *,
                    as_bytes: bool = False) -> torch.Tensor:
    """Every buffer's checksum, uint32 (n,), in one launch (the kernel);
    ``as_bytes`` reads buffers of any dtype as their bytes."""
    return KERNEL.many(buffers, block, as_bytes=as_bytes)[0]
