"""Dispatch by the device of the inputs.

A CPU tensor goes to the plain PyTorch version in ``ref``; a CUDA tensor
goes to the hand-written kernel, which raises on anything it cannot
serve.  There is no fallback from one to the other.
"""
from __future__ import annotations

import torch

from . import ref
from .flash_attention import KERNEL as _flash_kernel


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0) -> torch.Tensor:
    """q: (B, S, H, hd); k/v: (B, S, KV, hd) → (B, S, H, hd)."""
    if q.device.type == "cpu":
        return ref.attention_ref(q, k, v, causal=causal, window=window,
                                 softcap=softcap)
    return _flash_kernel(q, k, v, causal=causal, window=window,
                         softcap=softcap)
