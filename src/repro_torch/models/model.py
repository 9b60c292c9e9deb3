"""Config-driven decoder LM: init, forward, prefill, decode.

Parameters are a plain dictionary: ``embed``, ``final_norm`` and
``blocks``, a list with one entry per layer in execution order.  That
order is the reference's: group-major over ``cfg.pattern()``, so layer
``g * len(pattern) + i`` is pattern position ``i`` of group ``g``.  The
layers run as a Python loop.  Caches are a list in the same order.

Every block kind of the reference runs: attention mixers (global and
sliding-window), Mamba-2 SSM mixers and cross-attention mixers, each
with no FFN, the dense FFN or the MoE FFN, as the pattern gives them
(the SSM family's SSM blocks with none; jamba's hybrid stack of SSM and
attention mixers with dense and MoE FFNs; llama-3.2-vision's
cross-attention layers with dense FFNs).  Each layer dispatches on its
mixer and its FFN as the reference does; the full-sequence passes return
the sum of the MoE layers' aux losses.  ``image_embeds`` (B, T, D) go to
the cross-attention layers; without them those layers run as the
reference runs them then (ungated causal self-attention), which is what
serving gives them.  A cross-attention layer keeps no decode cache: its
entry in the cache list is an empty dictionary.

Training: ``lm_loss`` is the reference's masked cross-entropy plus the
weighted aux loss.  ``forward(remat=True)`` (the reference's default)
runs each layer under ``torch.utils.checkpoint`` when autograd records,
so the backward recomputes a layer's forward instead of keeping its
activations; the reference remats each group with ``jax.checkpoint``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import (FFN_MOE, FFN_NONE, MIXER_ATTN_LOCAL, MIXER_SSM,
                            MIXER_XATTN, ArchConfig, BlockSpec_)
from ..device import resolve_device
from . import attention as attn
from . import moe, ssm
from .layers import (embed_tokens, init_embed, init_mlp, lm_logits,
                     mlp_forward, rms_norm)

Params = Dict[str, Any]


def torch_dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def layer_specs(cfg: ArchConfig) -> List[BlockSpec_]:
    """The block kind of every layer, in execution order: the pattern over
    its groups.  ``num_groups`` raises where the layers are not whole
    groups, as in the reference."""
    return cfg.pattern() * cfg.num_groups()


def _specs(cfg: ArchConfig, params: Params,
           cache: Optional[List[Dict]] = None) -> List[BlockSpec_]:
    """``layer_specs``, checked against the blocks (and the caches): one
    length, so that no loop over them stops early."""
    specs = layer_specs(cfg)
    lengths = {"block kinds": len(specs), "blocks": len(params["blocks"])}
    if cache is not None:
        lengths["caches"] = len(cache)
    if len(set(lengths.values())) != 1:
        raise ValueError(f"{cfg.name}: {lengths} differ; the parameters and "
                         f"caches must be of this config's layers")
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
        if spec.mixer == MIXER_SSM:
            mixer = ssm.init_ssm(gen, cfg, dtype=dt)
        else:
            mixer = attn.init_attention(gen, cfg, dtype=dt,
                                        cross=spec.mixer == MIXER_XATTN)
        bp: Params = {
            "norm1": torch.zeros(cfg.d_model, dtype=dt, device=dev),
            "mixer": mixer}
        if spec.ffn != FFN_NONE:
            bp["norm2"] = torch.zeros(cfg.d_model, dtype=dt, device=dev)
            bp["ffn"] = moe.init_moe(gen, cfg, dtype=dt) \
                if spec.ffn == FFN_MOE else \
                init_mlp(gen, cfg.d_model, cfg.d_ff, dtype=dt)
        blocks.append(bp)
    return {"embed": init_embed(gen, cfg.vocab_size, cfg.d_model,
                                cfg.tie_embeddings, dtype=dt),
            "final_norm": torch.zeros(cfg.d_model, dtype=dt, device=dev),
            "blocks": blocks}


def _ffn(bp: Params, x: torch.Tensor, cfg: ArchConfig, spec
         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The channel mixer with its residual, and its aux loss (None but
    for MoE)."""
    if spec.ffn == FFN_NONE:
        return x, None
    h = rms_norm(x, bp["norm2"], cfg.norm_eps)
    if spec.ffn == FFN_MOE:
        out, aux = moe.moe_forward(bp["ffn"], h, cfg)
        return x + out, aux
    return x + mlp_forward(bp["ffn"], h), None


def _block(bp: Params, x: torch.Tensor, spec, cfg: ArchConfig,
           positions: torch.Tensor, image_embeds: Optional[torch.Tensor]):
    """One layer of the full-sequence pass without a cache: (x, its aux
    loss or None)."""
    h = rms_norm(x, bp["norm1"], cfg.norm_eps)
    if spec.mixer == MIXER_XATTN:
        mix = attn.attention_forward(bp["mixer"], h, cfg, positions,
                                     cross_states=image_embeds)
    elif spec.mixer == MIXER_SSM:
        mix = ssm.ssm_forward(bp["mixer"], h, cfg)
    else:
        mix = attn.attention_forward(bp["mixer"], h, cfg, positions,
                                     window=_window_for(cfg, spec.mixer))
    return _ffn(bp, x + mix, cfg, spec)


def _run(params: Params, tokens: torch.Tensor, cfg: ArchConfig,
         max_seq: Optional[int], image_embeds: Optional[torch.Tensor],
         remat: bool = False):
    """Full-sequence pass: (logits, caches, the sum of the layers' aux
    losses); collects the decode cache when ``max_seq`` is given.  With
    ``remat`` and autograd recording, each layer is checkpointed."""
    x = embed_tokens(params["embed"], tokens)
    positions = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
    caches = []
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    remat = remat and max_seq is None and torch.is_grad_enabled()
    for bp, spec in zip(params["blocks"], _specs(cfg, params), strict=True):
        if max_seq is None:
            args = (bp, x, spec, cfg, positions, image_embeds)
            x, layer_aux = checkpoint(_block, *args, use_reentrant=False,
                                      preserve_rng_state=False) \
                if remat else _block(*args)
            if layer_aux is not None:
                aux = aux + layer_aux
            continue
        h = rms_norm(x, bp["norm1"], cfg.norm_eps)
        window = _window_for(cfg, spec.mixer)
        if spec.mixer == MIXER_XATTN:
            mix = attn.attention_forward(bp["mixer"], h, cfg, positions,
                                         cross_states=image_embeds)
            caches.append({})
        elif spec.mixer == MIXER_SSM:
            mix, cache = ssm.prefill_ssm(bp["mixer"], h, cfg)
            caches.append(cache)
        else:
            mix, cache = attn.prefill_attention(bp["mixer"], h, cfg,
                                                positions, window, max_seq)
            caches.append(cache)
        x, layer_aux = _ffn(bp, x + mix, cfg, spec)
        if layer_aux is not None:
            aux = aux + layer_aux
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = lm_logits(params["embed"], x, cfg.final_logit_softcap)
    return logits, caches, aux


def forward(params: Params, tokens: torch.Tensor, cfg: ArchConfig,
            image_embeds: Optional[torch.Tensor] = None, remat: bool = True
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) → (logits (B, S, V) fp32, aux loss).  ``remat``
    checkpoints each layer when autograd records (and does nothing
    otherwise)."""
    logits, _, aux = _run(params, tokens, cfg, None, image_embeds, remat)
    return logits, aux


def lm_loss(params: Params, tokens: torch.Tensor, labels: torch.Tensor,
            cfg: ArchConfig, image_embeds: Optional[torch.Tensor] = None,
            aux_weight: float = 0.01, remat: bool = True):
    """(ce + aux_weight·aux, (ce, aux)): the mean cross-entropy over the
    positions with ``labels >= 0``.  The gold logit is gathered: the
    reference's one-hot contraction adds exact zeros to it, so the two
    agree exactly."""
    logits, aux = forward(params, tokens, cfg, image_embeds, remat)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1,
                        labels.long().clamp_min(0)[..., None])[..., 0]
    mask = (labels >= 0).float()
    ce = ((logz - gold) * mask).sum() / mask.sum().clamp_min(1.0)
    return ce + aux_weight * aux, (ce, aux)


def forward_with_cache(params: Params, tokens: torch.Tensor,
                       cfg: ArchConfig, max_seq: int,
                       image_embeds: Optional[torch.Tensor] = None):
    """Full-sequence forward that also returns the populated decode cache:
    (logits (B, S, V) fp32, cache, aux loss)."""
    return _run(params, tokens, cfg, max_seq, image_embeds)


def init_decode_cache(cfg: ArchConfig, batch: int, max_seq: int,
                      dtype=torch.bfloat16, device=None) -> List[Dict]:
    """One cache per layer, in execution order: ``{"k", "v"}`` for
    attention, ``{"h", "conv_x", "conv_b", "conv_c"}`` for SSM layers,
    ``{}`` for cross-attention.  As in the reference, an SSM layer's fresh
    cache is float32 whatever ``dtype`` says."""
    dev = resolve_device(device)
    return [ssm.init_ssm_cache(cfg, batch, device=dev)
            if spec.mixer == MIXER_SSM else {}
            if spec.mixer == MIXER_XATTN else
            attn.init_kv_cache(cfg, batch, max_seq,
                               _window_for(cfg, spec.mixer), dtype, dev)
            for spec in layer_specs(cfg)]


def decode_step(params: Params, cache: List[Dict], token: torch.Tensor,
                pos: int, cfg: ArchConfig,
                image_embeds: Optional[torch.Tensor] = None):
    """token (B,) at absolute position ``pos`` → (logits (B, V) fp32,
    cache).  The cache is updated in place.  An MoE layer routes the
    step's B tokens with S = 1 (capacity 4), and its aux loss is dropped,
    as in the reference."""
    x = embed_tokens(params["embed"], token[:, None])
    specs = _specs(cfg, params, cache)
    for bp, spec, c in zip(params["blocks"], specs, cache, strict=True):
        h = rms_norm(x, bp["norm1"], cfg.norm_eps)
        if spec.mixer == MIXER_XATTN:
            mix = attn.decode_cross_attention(bp["mixer"], h, pos, cfg,
                                              image_embeds)
        elif spec.mixer == MIXER_SSM:
            mix, new = ssm.ssm_decode(bp["mixer"], h, c, cfg)
            c.update(new)
        else:
            mix, _ = attn.decode_attention(bp["mixer"], h, c, pos, cfg,
                                           _window_for(cfg, spec.mixer))
        x, _ = _ffn(bp, x + mix, cfg, spec)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return lm_logits(params["embed"], x[:, 0], cfg.final_logit_softcap), \
        cache
