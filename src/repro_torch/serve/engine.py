"""Batched serving engine: prefill → decode in waves of ``batch`` slots.

The reference's engine, on PyTorch:
  * requests are served in waves of ``batch``; each wave is left-padded
    with token 0 to its longest prompt (with no pad mask, as the
    reference does) and padded with empty slots to the full batch;
  * prefill is one :func:`forward_with_cache` pass (on the card through
    the flash attention kernel for attention models and the ssd_intra
    kernel for SSM models, whose state takes the pad tokens in as the
    reference's does); decode advances every slot one token per step
    with :func:`decode_step`;
  * ``EngineStats`` counts as the reference does: one prefill per slot
    of a wave, pad slots included.

The engine takes its weights directly; weight delivery through the
federation's data plane is not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..device import resolve_device
from ..models import decode_step, forward_with_cache


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                  # (prompt_len,)
    max_new_tokens: int = 16
    eos_id: int = -1                     # -1 → never stops early
    output: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


@dataclasses.dataclass
class EngineStats:
    prefills: int = 0
    decode_steps: int = 0
    tokens_out: int = 0


class ServeEngine:
    """Static-batch engine with slot recycling (continuous-batching-lite)."""

    def __init__(self, cfg: ArchConfig, params, batch_size: int = 4,
                 max_seq: int = 256, greedy: bool = True, seed: int = 0,
                 device=None) -> None:
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params
        self.batch = batch_size
        self.max_seq = max_seq
        self.greedy = greedy
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.stats = EngineStats()

    def _prefill_batch(self, prompts: np.ndarray):
        """prompts: (B, P) — one shared prompt length per wave."""
        tokens = torch.as_tensor(prompts, dtype=torch.long,
                                 device=self.device)
        logits, cache, _ = forward_with_cache(self.params, tokens, self.cfg,
                                              max_seq=self.max_seq)
        self.stats.prefills += prompts.shape[0]
        # a copy, so the full (B, P, V) logits are freed at once
        return logits[:, -1, :].clone(), cache

    def _sample(self, logits: torch.Tensor) -> np.ndarray:
        if self.greedy:
            return logits.argmax(dim=-1).cpu().numpy()
        probs = torch.softmax(logits.float(), dim=-1)
        return torch.multinomial(probs, 1, generator=self.generator) \
            .squeeze(-1).cpu().numpy()

    def generate(self, requests: List[Request]) -> List[Request]:
        """Serve a list of requests in waves of ``batch`` slots."""
        queue = list(requests)
        while queue:
            wave = queue[:self.batch]
            queue = queue[len(wave):]
            plen = max(len(r.prompt) for r in wave)
            prompts = np.stack([
                np.pad(r.prompt, (plen - len(r.prompt), 0))
                for r in wave])                      # left-pad to align
            if len(wave) < self.batch:               # pad slots
                prompts = np.pad(prompts,
                                 ((0, self.batch - len(wave)), (0, 0)))
            last_logits, cache = self._prefill_batch(prompts)
            tok = self._sample(last_logits)
            for i, r in enumerate(wave):
                r.output.append(int(tok[i]))
            steps = max(r.max_new_tokens for r in wave) - 1
            pos = plen
            for _ in range(max(steps, 0)):
                logits, cache = decode_step(
                    self.params, cache,
                    torch.as_tensor(tok, dtype=torch.long,
                                    device=self.device), pos, self.cfg)
                self.stats.decode_steps += 1
                tok = self._sample(logits)
                pos += 1
                alive = False
                for i, r in enumerate(wave):
                    if r.done or len(r.output) >= r.max_new_tokens:
                        r.done = True
                        continue
                    t = int(tok[i])
                    r.output.append(t)
                    self.stats.tokens_out += 1
                    if t == r.eos_id:
                        r.done = True
                    else:
                        alive = True
                if not alive:
                    break
            for r in wave:
                r.done = True
        return requests
