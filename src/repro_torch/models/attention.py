"""Attention: GQA self-attention and gated cross-attention, full-sequence
(prefill) and decode paths.

* The self-attention full-sequence path goes through
  ``kernels.ops.flash_attention``: on the card the hand-written kernel
  (causal, sliding window, softcap, KV read per group, never repeated),
  on the CPU its plain version.
* Decode keeps the reference's caches: a ring buffer of ``window`` slots
  for sliding-window layers and a dense cache for global layers, both
  unrepeated over KV heads.  Decode is plain PyTorch, as the reference
  computes it outside any kernel.  Unlike the reference, it writes the new
  token's K/V into the cache in place instead of copying the cache.
* Cross-attention (llama-3.2-vision's image layers, ``init_attention(...,
  cross=True)``): q from the text, k and v from the image states, no RoPE
  and no mask, an f32 softmax, the output scaled by ``tanh(gate)``.  It is
  plain PyTorch, as the reference computes it with einsums outside any
  kernel; it keeps no cache.  Given no image states, a cross-attention
  layer runs as the reference runs it then: ungated causal self-attention
  with RoPE (prefill through the flash kernel; decode over the current
  token alone, ``decode_cross_attention``).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..configs.base import ArchConfig
from ..kernels import ops
from .layers import apply_rope, dense_init, softcap

NEG_INF = -2.0 ** 30


def init_attention(gen: torch.Generator, cfg: ArchConfig,
                   dtype=torch.float32, cross: bool = False
                   ) -> Dict[str, torch.Tensor]:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, kv = cfg.resolved_num_heads, cfg.num_kv_heads
    p = {"wq": dense_init(gen, (d, h, hd), dtype=dtype),
         "wk": dense_init(gen, (d, kv, hd), dtype=dtype),
         "wv": dense_init(gen, (d, kv, hd), dtype=dtype),
         "wo": dense_init(gen, (h, hd, d), dtype=dtype)}
    if cfg.padded_heads:
        # zero the pad rows: structurally inactive heads at init
        p["wq"][:, cfg.num_heads:] = 0
        p["wo"][cfg.num_heads:] = 0
    if cfg.qkv_bias:
        dev = gen.device
        p["bq"] = torch.zeros((h, hd), dtype=dtype, device=dev)
        p["bk"] = torch.zeros((kv, hd), dtype=dtype, device=dev)
        p["bv"] = torch.zeros((kv, hd), dtype=dtype, device=dev)
    if cross:
        # the gate of llama-3.2-vision's cross-attention, zero at init
        p["gate"] = torch.zeros((), dtype=dtype, device=gen.device)
    return p


def _heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one matrix product."""
    d, h, k = w.shape
    return (x @ w.reshape(d, h * k)).view(*x.shape[:-1], h, k)


def _out_proj(o: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """einsum("bshk,hkd->bsd") as one matrix product."""
    h, k, d = wo.shape
    return o.reshape(*o.shape[:-2], h * k) @ wo.reshape(h * k, d)


def _project_qkv(p, x, kv_src, cfg: ArchConfig, positions, kv_positions,
                 rope: bool):
    q, k, v = _heads(x, p["wq"]), _heads(kv_src, p["wk"]), \
        _heads(kv_src, p["wv"])
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, kv_positions, cfg.rope_theta)
    return q, k, v


def _self_attention(p, x: torch.Tensor, cfg: ArchConfig,
                    positions: torch.Tensor, window: int):
    """Returns the block output and the layer's (unrepeated) K and V."""
    q, k, v = _project_qkv(p, x, x, cfg, positions, positions, rope=True)
    s = x.shape[1]
    out = ops.flash_attention(
        q, k, v, causal=True, window=window if window and window < s else 0,
        softcap=cfg.attn_logit_softcap)
    return _out_proj(out, p["wo"]), k, v


def _cross_attention(p, x: torch.Tensor, cross_states: torch.Tensor,
                     cfg: ArchConfig) -> torch.Tensor:
    """Every query over every image state: x (B, S, D), cross_states
    (B, T, D) → (B, S, D), scaled by tanh(gate) where the layer has one."""
    q, k, v = _project_qkv(p, x, cross_states.to(x.dtype), cfg, None, None,
                           rope=False)
    g = q.shape[2] // k.shape[2]
    k, v = k.repeat_interleave(g, dim=2), v.repeat_interleave(g, dim=2)
    scores = softcap(torch.einsum("bshd,bthd->bhst", q, k)
                     / cfg.resolved_head_dim ** 0.5, cfg.attn_logit_softcap)
    probs = torch.softmax(scores.float(), dim=-1)
    out = _out_proj(torch.einsum("bhst,bthd->bshd", probs.to(v.dtype), v),
                    p["wo"])
    return torch.tanh(p["gate"]) * out if "gate" in p else out


def attention_forward(p, x: torch.Tensor, cfg: ArchConfig,
                      positions: torch.Tensor, window: int = 0,
                      cross_states: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """Causal (optionally sliding-window) self-attention over the full
    sequence, or cross-attention to ``cross_states`` (B, T, D) when they
    are given.  x: (B, S, D); positions broadcastable to (B, S)."""
    if cross_states is not None:
        return _cross_attention(p, x, cross_states, cfg)
    return _self_attention(p, x, cfg, positions, window)[0]


def prefill_attention(p, x: torch.Tensor, cfg: ArchConfig,
                      positions: torch.Tensor, window: int, max_seq: int,
                      cache_dtype=None):
    """Full-sequence attention that also emits the populated KV cache
    (ring-buffer layout for windowed layers, matching decode_attention)."""
    cache_dtype = cache_dtype or x.dtype
    out, k, v = _self_attention(p, x, cfg, positions, window)
    b, s, kvh, hd = k.shape
    size = min(max_seq, window) if window else max_seq
    take = min(s, size)
    slots = torch.arange(s - take, s, device=x.device) % size
    kc = torch.zeros((b, size, kvh, hd), dtype=cache_dtype, device=x.device)
    vc = torch.zeros((b, size, kvh, hd), dtype=cache_dtype, device=x.device)
    kc[:, slots] = k[:, s - take:].to(cache_dtype)
    vc[:, slots] = v[:, s - take:].to(cache_dtype)
    return out, {"k": kc, "v": vc}


def init_kv_cache(cfg: ArchConfig, batch: int, max_seq: int, window: int,
                  dtype=torch.bfloat16, device=None
                  ) -> Dict[str, torch.Tensor]:
    """Dense cache for global layers; ring buffer (size=window) for SWA."""
    size = min(max_seq, window) if window else max_seq
    shape = (batch, size, cfg.num_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _gqa_scores(q, k, softcap_val: float):
    """q: (B,S,H,hd), k: (B,T,KV,hd) → scores (B, KV, G, S, T)."""
    b, s, h, hd = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, s, kvh, h // kvh, hd)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k) / (hd ** 0.5)
    return softcap(scores, softcap_val)


def _gqa_out(probs, v):
    """probs: (B,KV,G,S,T), v: (B,T,KV,hd) → (B,S,H,hd)."""
    b, kvh, g, s, _ = probs.shape
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(b, s, kvh * g, v.shape[-1])


def decode_attention(p, x: torch.Tensor, cache: Dict[str, torch.Tensor],
                     pos: int, cfg: ArchConfig, window: int = 0
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode: x (B, 1, D) at absolute position ``pos``.  The
    cache is updated in place and returned."""
    positions = torch.full((1, 1), pos, device=x.device)
    q, k_new, v_new = _project_qkv(p, x, x, cfg, positions, positions,
                                   rope=True)
    k, v = cache["k"], cache["v"]
    size = k.shape[1]
    ring = bool(window) and window < 10 ** 9
    slot = pos % size if ring else min(pos, size - 1)
    k[:, slot] = k_new[:, 0].to(k.dtype)
    v[:, slot] = v_new[:, 0].to(v.dtype)
    idx = torch.arange(size, device=x.device)
    if ring:
        # Ring buffer: entry idx holds absolute position
        # pos − ((slot − idx) mod size); valid once actually written.
        valid = (slot - idx) % size <= pos
    else:
        valid = idx <= pos
    scores = _gqa_scores(q, k, cfg.attn_logit_softcap)    # (B,KV,G,1,size)
    scores = torch.where(valid, scores,
                         torch.tensor(NEG_INF, dtype=scores.dtype,
                                      device=x.device))
    probs = torch.softmax(scores.float(), dim=-1)
    out = _gqa_out(probs.to(v.dtype), v)
    return _out_proj(out, p["wo"]), cache


def decode_cross_attention(p, x: torch.Tensor, pos: int, cfg: ArchConfig,
                           cross_states: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """A cross-attention layer's one-token decode, x (B, 1, D): over
    ``cross_states`` when given; else, as the reference's decode runs such
    a layer without them, causal self-attention over the current token
    alone (RoPE at ``pos``, no gate, no cache)."""
    if cross_states is not None:
        return _cross_attention(p, x, cross_states, cfg)
    positions = torch.full((1, 1), pos, device=x.device)
    q, k, v = _project_qkv(p, x, x, cfg, positions, positions, rope=True)
    scores = _gqa_scores(q, k, cfg.attn_logit_softcap)      # (B,KV,G,1,1)
    probs = torch.softmax(scores.float(), dim=-1)
    return _out_proj(_gqa_out(probs.to(v.dtype), v), p["wo"])
