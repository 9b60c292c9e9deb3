"""Config-driven decoder LM, dense family: init, forward, prefill, decode.

Parameters are a plain dictionary: ``embed``, ``final_norm`` and
``blocks``, a list with one entry per layer in execution order.  That
order is the reference's: group-major over ``cfg.pattern()``, so layer
``g * len(pattern) + i`` is pattern position ``i`` of group ``g``.  The
layers run as a Python loop.  Caches are a list in the same order.

Only attention mixers (global and sliding-window) and the dense FFN are
ported; MoE, SSM and cross-attention blocks raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from ..configs.base import (FFN_DENSE, FFN_NONE, MIXER_ATTN,
                            MIXER_ATTN_LOCAL, ArchConfig, BlockSpec_)
from ..device import resolve_device
from . import attention as attn
from .layers import (embed_tokens, init_embed, init_mlp, lm_logits,
                     mlp_forward, rms_norm)

Params = Dict[str, Any]


def torch_dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def layer_specs(cfg: ArchConfig) -> List[BlockSpec_]:
    """The block kind of every layer, in execution order.  Raises for the
    kinds the port does not run yet."""
    specs = cfg.pattern() * cfg.num_groups()
    for spec in specs:
        if spec.mixer not in (MIXER_ATTN, MIXER_ATTN_LOCAL) or \
                spec.ffn not in (FFN_DENSE, FFN_NONE):
            raise NotImplementedError(
                f"{cfg.name}: block ({spec.mixer}, {spec.ffn}) is not ported "
                f"yet; the port runs attention mixers with dense FFNs")
    return specs


def _window_for(cfg: ArchConfig, mixer: str) -> int:
    return cfg.sliding_window if mixer == MIXER_ATTN_LOCAL else 0


def init_lm(cfg: ArchConfig, *, seed: int = 0, device=None) -> Params:
    """Random weights drawn from ``torch.Generator(seed)`` directly on the
    device, in the config's dtype."""
    dev = resolve_device(device)
    dt = torch_dtype(cfg)
    gen = torch.Generator(device=dev).manual_seed(seed)
    blocks = []
    for spec in layer_specs(cfg):
        bp: Params = {
            "norm1": torch.zeros(cfg.d_model, dtype=dt, device=dev),
            "mixer": attn.init_attention(gen, cfg, dtype=dt)}
        if spec.ffn != FFN_NONE:
            bp["norm2"] = torch.zeros(cfg.d_model, dtype=dt, device=dev)
            bp["ffn"] = init_mlp(gen, cfg.d_model, cfg.d_ff, dtype=dt)
        blocks.append(bp)
    return {"embed": init_embed(gen, cfg.vocab_size, cfg.d_model,
                                cfg.tie_embeddings, dtype=dt),
            "final_norm": torch.zeros(cfg.d_model, dtype=dt, device=dev),
            "blocks": blocks}


def _ffn(bp: Params, x: torch.Tensor, cfg: ArchConfig, spec) -> torch.Tensor:
    if spec.ffn == FFN_NONE:
        return x
    return x + mlp_forward(bp["ffn"], rms_norm(x, bp["norm2"], cfg.norm_eps))


def _run(params: Params, tokens: torch.Tensor, cfg: ArchConfig,
         max_seq: Optional[int]):
    """Full-sequence pass; collects the decode cache when ``max_seq`` is
    given."""
    x = embed_tokens(params["embed"], tokens)
    positions = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
    caches = []
    for bp, spec in zip(params["blocks"], layer_specs(cfg)):
        h = rms_norm(x, bp["norm1"], cfg.norm_eps)
        window = _window_for(cfg, spec.mixer)
        if max_seq is None:
            mix = attn.attention_forward(bp["mixer"], h, cfg, positions,
                                         window=window)
        else:
            mix, cache = attn.prefill_attention(bp["mixer"], h, cfg,
                                                positions, window, max_seq)
            caches.append(cache)
        x = _ffn(bp, x + mix, cfg, spec)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = lm_logits(params["embed"], x, cfg.final_logit_softcap)
    return logits, caches


def _no_aux(device) -> torch.Tensor:
    """The dense family has no auxiliary (MoE balance) loss."""
    return torch.zeros((), dtype=torch.float32, device=device)


def forward(params: Params, tokens: torch.Tensor, cfg: ArchConfig
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) → (logits (B, S, V) fp32, aux loss)."""
    logits, _ = _run(params, tokens, cfg, None)
    return logits, _no_aux(tokens.device)


def forward_with_cache(params: Params, tokens: torch.Tensor,
                       cfg: ArchConfig, max_seq: int):
    """Full-sequence forward that also returns the populated decode cache:
    (logits (B, S, V) fp32, cache, aux loss)."""
    logits, caches = _run(params, tokens, cfg, max_seq)
    return logits, caches, _no_aux(tokens.device)


def init_decode_cache(cfg: ArchConfig, batch: int, max_seq: int,
                      dtype=torch.bfloat16, device=None) -> List[Dict]:
    """One ``{"k", "v"}`` cache per layer, in execution order."""
    dev = resolve_device(device)
    return [attn.init_kv_cache(cfg, batch, max_seq,
                               _window_for(cfg, spec.mixer), dtype, dev)
            for spec in layer_specs(cfg)]


def decode_step(params: Params, cache: List[Dict], token: torch.Tensor,
                pos: int, cfg: ArchConfig):
    """token (B,) at absolute position ``pos`` → (logits (B, V) fp32,
    cache).  The cache is updated in place."""
    x = embed_tokens(params["embed"], token[:, None])
    for bp, spec, c in zip(params["blocks"], layer_specs(cfg), cache):
        h = rms_norm(x, bp["norm1"], cfg.norm_eps)
        mix, _ = attn.decode_attention(bp["mixer"], h, c, pos, cfg,
                                       _window_for(cfg, spec.mixer))
        x = _ffn(bp, x + mix, cfg, spec)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return lm_logits(params["embed"], x[:, 0], cfg.final_logit_softcap), \
        cache
