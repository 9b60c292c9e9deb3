"""Plain PyTorch versions of the port's kernels (the correctness oracles).

The CPU path runs these; on the card they are what each kernel is held
against.
"""
from __future__ import annotations

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0,
                  softcap: float = 0.0) -> torch.Tensor:
    """O(S²) GQA attention. q: (B,S,H,hd); k/v: (B,S,KV,hd)."""
    s, h, hd = q.shape[1], q.shape[2], q.shape[3]
    g = h // k.shape[2]
    k = k.repeat_interleave(g, dim=2)
    v = v.repeat_interleave(g, dim=2)
    scores = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) / hd ** 0.5
    if softcap:
        scores = softcap * torch.tanh(scores / softcap)
    i = torch.arange(s, device=q.device)[:, None]
    j = torch.arange(s, device=q.device)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= j <= i
    if window:
        mask &= j > i - window
    scores = torch.where(mask, scores, torch.tensor(-1e30, device=q.device))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhst,bthd->bshd", probs, v.float())
    return out.to(q.dtype)


def err_over_tolerance(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest |got - want| over its elementwise tolerance; at most 1 passes.

    In bfloat16 the tolerance is one ulp of ``want`` (2^-7 |want|) plus
    1e-3: a kernel that sums in another order than the plain version may
    round the same fp32 value to the neighbouring bf16 value, and no more.
    In float32 it is 1e-4."""
    bf16 = want.dtype == torch.bfloat16
    got, want = got.float(), want.float()
    tol = 2.0 ** -7 * want.abs() + 1e-3 if bf16 else \
        torch.full_like(want, 1e-4)
    return ((got - want).abs() / tol).max().item()
