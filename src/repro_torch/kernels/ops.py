"""Dispatch by the device of the inputs.

A CPU tensor goes to the plain PyTorch version in ``ref``; a CUDA tensor
goes to the hand-written kernel, which raises on anything it cannot
serve.  There is no fallback from one to the other.
"""
from __future__ import annotations

import torch

from . import ref
from .chunk_checksum import chunk_checksum as _checksum_kernel
from .chunk_checksum import chunk_checksums as _checksums_kernel
from .flash_attention import KERNEL as _flash_kernel
from .ssd_scan import KERNEL as _ssd_kernel


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0) -> torch.Tensor:
    """q: (B, S, H, hd); k/v: (B, S, KV, hd) → (B, S, H, hd)."""
    if q.device.type == "cpu":
        return ref.attention_ref(q, k, v, causal=causal, window=window,
                                 softcap=softcap)
    return _flash_kernel(q, k, v, causal=causal, window=window,
                         softcap=softcap)


def ssd_intra(x: torch.Tensor, dt: torch.Tensor, cum: torch.Tensor,
              b_in: torch.Tensor, c_in: torch.Tensor) -> torch.Tensor:
    """x: (B, NC, Q, H, P); dt, cum: (B, NC, Q, H); b_in, c_in:
    (B, NC, Q, N) → the intra-chunk SSD output (B, NC, Q, H, P)."""
    if x.device.type == "cpu":
        return ref.ssd_intra_ref(x, dt, cum, b_in, c_in)
    return _ssd_kernel(x, dt, cum, b_in, c_in)


def chunk_checksum(data: torch.Tensor, block: int = 1024) -> torch.Tensor:
    """The uint32 polynomial checksum of a uint8 or int32 buffer."""
    if data.device.type == "cpu":
        return ref.poly_digest_ref(data, block)[0]
    return _checksum_kernel(data, block)


def chunk_checksums(buffers, block: int = 1024, *,
                    as_bytes: bool = False) -> torch.Tensor:
    """The uint32 checksums (n,) of a list of buffers on one device, each
    uint8 or int32, or any dtype read as its bytes when ``as_bytes``: on
    the card, one launch for the whole list."""
    buffers = list(buffers)
    if buffers[0].device.type == "cpu":
        return torch.stack([ref.poly_digest_ref(
            t.reshape(-1).view(torch.uint8) if as_bytes else t, block)[0]
            for t in buffers])
    return _checksums_kernel(buffers, block, as_bytes=as_bytes)
