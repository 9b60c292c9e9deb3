"""Shared layers: norms, softcap, SwiGLU, rotary embeddings, embed/head.

Parameters are plain dictionaries of tensors in the reference's layouts
(``w1 (d, f)``, ``embedding (V, d)``), so converted reference weights drop
in unchanged.  Init draws from an explicit ``torch.Generator`` on the
target device.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]


def dense_init(gen: torch.Generator, shape: Tuple[int, ...],
               scale: float = 1.0, dtype=torch.float32) -> torch.Tensor:
    """Truncated-normal (±2σ) init with fan-in scaling.  As in the
    reference, a 3-D weight takes ``shape[-2]`` as its fan-in."""
    fan_in = shape[0] if len(shape) <= 2 else shape[-2]
    std = scale / max(fan_in, 1) ** 0.5
    arr = torch.empty(shape, dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(arr, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return arr.mul_(std).to(dtype)


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + weight.float())).to(dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """Gemma-2 logit soft-capping: cap * tanh(x / cap)."""
    if not cap:
        return x
    return cap * torch.tanh(x / cap)


def swiglu(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor,
           w2: torch.Tensor) -> torch.Tensor:
    """SwiGLU MLP: (silu(x·w1) ⊙ x·w3) · w2."""
    return (F.silu(x @ w1) * (x @ w3)) @ w2


def rope_freqs(head_dim: int, theta: float,
               device: torch.device) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10_000.0) -> torch.Tensor:
    """Half-split rotary embedding.  x: (..., S, H, head_dim);
    positions: broadcastable to (..., S)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)     # (hd/2,)
    angles = positions[..., None].float() * freqs         # (..., S, hd/2)
    angles = angles[..., None, :]                         # (..., S, 1, hd/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int,
             dtype=torch.float32) -> Params:
    return {"w1": dense_init(gen, (d_model, d_ff), dtype=dtype),
            "w3": dense_init(gen, (d_model, d_ff), dtype=dtype),
            "w2": dense_init(gen, (d_ff, d_model), dtype=dtype)}


def mlp_forward(p: Params, x: torch.Tensor) -> torch.Tensor:
    return swiglu(x, p["w1"], p["w3"], p["w2"])


def init_embed(gen: torch.Generator, vocab: int, d_model: int, tie: bool,
               dtype=torch.float32) -> Params:
    p = {"embedding": dense_init(gen, (vocab, d_model), dtype=dtype)}
    if not tie:
        p["head"] = dense_init(gen, (d_model, vocab), dtype=dtype)
    return p


def embed_tokens(p: Params, tokens: torch.Tensor) -> torch.Tensor:
    return p["embedding"][tokens]


def lm_logits(p: Params, x: torch.Tensor, cap: float = 0.0) -> torch.Tensor:
    """Logits in float32, softcapped.  Without a gradient to record the
    cap is applied in place on the fresh float32 tensor: at a 256k
    vocabulary a copy would cost GBs; autograd needs the copies."""
    head = p["head"] if "head" in p else p["embedding"].T
    logits = (x @ head).float()
    if cap and logits.requires_grad:
        return cap * torch.tanh(logits / cap)
    if cap:
        logits.div_(cap).tanh_().mul_(cap)
    return logits
