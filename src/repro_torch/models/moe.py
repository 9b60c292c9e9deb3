"""Top-k Mixture-of-Experts with capacity-based GShard dispatch.

The reference's layer (``repro.models.moe``), on PyTorch.  Each batch row
is one GShard group of S tokens; every expert takes at most
``C = capacity(cfg, S)`` of a group's (token, choice) pairs, and a pair
past that is dropped (its contribution is 0, the residual passes
through).  The routing follows the reference step by step:

* the router is float32 whatever the model's dtype: logits are
  ``x.float() @ router``, then softmax and top-k, the lower expert index
  first on ties (as ``jax.lax.top_k``), gates renormalised by
  ``max(sum, 1e-9)``;
* every token's first choice takes slots before any second choice, and
  each choice's slots are counted after *every* assignment of the
  earlier choices, dropped ones included;
* the combine weights are float32 rounded to the activations' dtype, as
  the reference casts them before its final contraction; the weighted
  sum is taken in float32 and cast once.

Where the reference builds one-hot (B, S, E, C) dispatch and combine
tensors and contracts them, the port computes each kept pair's row of an
(E, B·C, D) buffer with integer cumsums, scatters the tokens there,
runs the three expert products as batched matrix products
(``expert_ffn``; the reference computes them outside any kernel too) and
gathers the rows back.  The values are the same; the one-hot
contractions would cost 2·S·E·C·D operations each.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from .layers import dense_init

Params = Dict[str, torch.Tensor]
# leaves the reference keeps in float32 whatever the model's dtype
FLOAT32_LEAVES = frozenset({"router"})


def init_moe(gen: torch.Generator, cfg: ArchConfig,
             dtype=torch.float32) -> Params:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    return {"router": dense_init(gen, (d, e), dtype=torch.float32),
            "w1": dense_init(gen, (e, d, f), dtype=dtype),
            "w3": dense_init(gen, (e, d, f), dtype=dtype),
            "w2": dense_init(gen, (e, f, d), dtype=dtype)}


def capacity(cfg: ArchConfig, tokens_per_group: int) -> int:
    """Slots per expert and group: ceil(k·S·cf/E), at most S, at least 4."""
    c = math.ceil(cfg.experts_per_token * tokens_per_group
                  * cfg.capacity_factor / cfg.num_experts)
    return max(4, min(c, tokens_per_group))


class Routing(NamedTuple):
    """Where each (token, choice) of x (B, S, D) goes; choices in priority
    order, the most probable expert first."""
    probs: torch.Tensor     # (B, S, E) float32 router softmax
    gates: torch.Tensor     # (B, S, k) float32, renormalised
    expert: torch.Tensor    # (B, S, k) int64
    slot: torch.Tensor      # (B, S, k) int64, position in the expert's slots
    kept: torch.Tensor      # (B, S, k) bool: slot < capacity
    capacity: int


def route(p: Params, x: torch.Tensor, cfg: ArchConfig) -> Routing:
    b, s, _ = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    probs = torch.softmax(x.float() @ p["router"], dim=-1)
    gates, expert = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, expert = gates[..., :k], expert[..., :k]
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    used = torch.zeros((b, 1, e), dtype=torch.long, device=x.device)
    slots = []
    for choice in range(k):
        onehot = F.one_hot(expert[..., choice], e)               # (B, S, E)
        pos = torch.cumsum(onehot, dim=1) - onehot + used
        slots.append(pos.gather(-1, expert[..., choice, None])[..., 0])
        used = used + onehot.sum(dim=1, keepdim=True)
    slot = torch.stack(slots, dim=-1)
    c = capacity(cfg, s)
    return Routing(probs, gates, expert, slot, slot < c, c)


def expert_ffn(p: Params, xe: torch.Tensor) -> torch.Tensor:
    """Every expert's SwiGLU on its slots: xe (E, N, D) → (E, N, D)."""
    h = F.silu(torch.bmm(xe, p["w1"])) * torch.bmm(xe, p["w3"])
    return torch.bmm(h, p["w2"])


def moe_forward(p: Params, x: torch.Tensor, cfg: ArchConfig
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) → (output in x's dtype, float32 load-balancing aux
    loss).  B is the GShard group dimension."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    r = route(p, x, cfg)
    c = r.capacity
    # kept pair → row e·(B·C) + b·C + slot; dropped pairs write to the
    # buffer's last row, which no expert reads
    group = torch.arange(b, device=x.device)[:, None, None]
    rows = (r.expert * b + group) * c + r.slot
    sink = e * b * c
    buf = x.new_zeros((sink + 1, d))
    flat_x = x.reshape(b * s, d)
    for choice in range(k):
        buf.index_copy_(0, torch.where(r.kept[..., choice],
                                       rows[..., choice], sink).reshape(-1),
                        flat_x)
    ye = expert_ffn(p, buf[:sink].view(e, b * c, d)).view(sink, d)
    weights = r.gates.to(x.dtype).float()
    y = torch.zeros((b, s, d), dtype=torch.float32, device=x.device)
    for choice in range(k):
        kept = r.kept[..., choice, None]
        out = ye[torch.where(r.kept[..., choice], rows[..., choice], 0)]
        y = y + torch.where(kept, out.float() * weights[..., choice, None],
                            0.0)
    frac_tokens = F.one_hot(r.expert[..., 0], e).float().mean(dim=(0, 1))
    aux = e * (frac_tokens * r.probs.mean(dim=(0, 1))).sum()
    return y.to(x.dtype), aux
