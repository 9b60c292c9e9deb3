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
    of a wave, pad slots included;
  * model weights are *distributed to serving hosts through the
    federation's data plane* (:meth:`ServeEngine.from_federation`, weight
    shards via :meth:`ServeEngine.fetch_shard`): a checkpoint in the
    reference's layout, restored through the nearest cache onto the
    engine's device.  Every fetch folds into ``engine.data_stats`` (the
    unified :class:`~repro_torch.core.monitoring.FetchRollup`).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..core.api import DataPlane, FetchRequest, FetchResult
from ..core.monitoring import FetchRollup
from ..device import resolve_device
from ..models import (decode_step, forward_with_cache, init_lm, jax_layout,
                      params_from_jax)


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
                 plane: Optional[DataPlane] = None, site: str = "",
                 worker: int = 0, device=None) -> None:
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params
        self.batch = batch_size
        self.max_seq = max_seq
        self.greedy = greedy
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.stats = EngineStats()
        self.plane = plane
        self.site = site
        self.worker = worker
        self.data_stats = FetchRollup("serve")

    # -- federation weight path ----------------------------------------
    @classmethod
    def from_federation(cls, cfg: ArchConfig, plane: DataPlane, run: str,
                        step: Optional[int] = None, *, site: str = "",
                        worker: int = 0, like=None, device=None,
                        **engine_kw) -> "ServeEngine":
        """Build an engine whose weights arrive through the data plane:
        restore the newest (or given) checkpoint of ``run`` (the
        reference's layout, ``models.jax_layout``) via the federation's
        cache tier onto ``device`` (``None`` means ``cuda``) and account
        the fetches on ``engine.data_stats``.  ``like`` is the parameter
        template in the port's layout; omitted, a fresh
        :func:`~repro_torch.models.init_lm` tree seeded by the engine's
        own ``seed`` is used."""
        from ..train.checkpoint import FederatedCheckpointer
        dev = resolve_device(device)
        ck = FederatedCheckpointer(run, plane, site=site, worker=worker)
        if step is None:
            step = ck.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoint for run {run!r}")
        if like is None:
            # the template tracks the engine's own seed, as the
            # reference's does
            like = init_lm(cfg, seed=engine_kw.get("seed", 0), device=dev)
        tree, _ = ck.restore(step, like=jax_layout(like, cfg), device=dev)
        eng = cls(cfg, params_from_jax(tree, cfg, device=dev), plane=plane,
                  site=site, worker=worker, device=dev, **engine_kw)
        eng.data_stats.merge(ck.stats)
        return eng

    def fetch_shard(self, path: str, method: str = "stash") -> FetchResult:
        """Pull one weight/KV shard object through the data plane (the
        serving-traffic read path — Zipf-popular shard objects under
        ``/models/<name>``)."""
        if self.plane is None:
            raise RuntimeError("engine was built without a data plane")
        res = self.plane.fetch(FetchRequest(
            path=path, site=self.site, worker=self.worker, method=method,
            tenant="serving"))
        self.data_stats.add(res)
        return res

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
