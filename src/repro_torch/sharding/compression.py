"""Gradient compression for the cross-pod (DCN) all-reduce.

The multi-pod mesh's only WAN-class traffic is the per-step gradient
all-reduce over the ``pod`` axis — the compute-plane twin of the origin
traffic StashCache exists to kill.  Blockwise int8 quantisation with
**error feedback** cuts those bytes 2× vs bf16 / 4× vs fp32: the
quantisation residual is carried to the next step instead of being
dropped, which preserves convergence (EF-SGD family).

The port of ``repro.sharding.compression``, on tensors:
  * :func:`quantize` / :func:`dequantize` — the codec (blockwise absmax
    over a leaf's flattening in blocks of 256; ``torch.round`` rounds half
    to even, as ``jnp.round`` does);
  * :class:`ErrorFeedback` — the residual-carrying compressor over a list
    of gradient leaves, used by the Trainer's ``grad_compression="int8_ef"``
    mode.  The Trainer hands it each pattern position's leaves stacked over
    groups, as the reference's leaves are, so the blocks are the
    reference's.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

BLOCK = 256


def quantize(x: torch.Tensor, block: int = BLOCK) -> Dict[str, torch.Tensor]:
    """{"q": int8 (n_blocks, block), "scale": float32 (n_blocks, 1)}."""
    flat = x.float().reshape(-1)
    flat = torch.nn.functional.pad(flat, (0, (-flat.numel()) % block))
    blocks = flat.reshape(-1, block)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0
    q = torch.round(blocks / scale.clamp_min(1e-12)).to(torch.int8)
    return {"q": q, "scale": scale}


def dequantize(enc: Dict[str, torch.Tensor], shape) -> torch.Tensor:
    flat = (enc["q"].float() * enc["scale"]).reshape(-1)
    n = 1
    for d in shape:
        n *= d
    return flat[:n].reshape(shape)


def wire_bytes(shape, dtype_bytes: int = 4,
               block: int = BLOCK) -> Tuple[int, int]:
    """(uncompressed, compressed) bytes for a tensor of ``shape``."""
    n = 1
    for d in shape:
        n *= d
    blocks = -(-n // block)
    return n * dtype_bytes, n * 1 + blocks * 4


class ErrorFeedback:
    """Residual-carrying int8 compressor over gradient leaves."""

    @staticmethod
    def compress(grads: Sequence[torch.Tensor],
                 residual: Sequence[torch.Tensor]
                 ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        """(the gradients as transmitted, in their dtypes; the new float32
        residuals target − sent), leaf by leaf."""
        sent, new_res = [], []
        for g, r in zip(grads, residual, strict=True):
            target = g.float() + r
            out = dequantize(quantize(target), g.shape)
            sent.append(out.to(g.dtype))
            new_res.append(target - out)
        return sent, new_res
