"""Fault-tolerant trainer: federated data, checkpoint/restart, elasticity.

The port of ``repro.train.trainer``.  The loop composes the substrates:
  * batches from :class:`~repro_torch.data.loader.FederatedDataLoader`
    (prefetch + hedged fetches = straggler mitigation on the data plane),
    moved to the trainer's device;
  * a train step: ``lm_loss`` and its gradients by autograd (on the card
    every attention layer goes through the flash kernel and its
    hand-written backward), the int8 error-feedback codec where asked,
    then ``adamw_update`` in place;
  * periodic checkpoint saves through the write-back cache, in the
    reference's layout (``checkpoint_state``), so a checkpoint holds the
    reference's objects;
  * **failure handling** — a ``FailureInjector`` can kill any step; the
    trainer restores the newest checkpoint and replays (the loader's
    deterministic step→slice mapping makes replay exact);
  * **elastic rescale** — ``rescale(world)`` re-ranks the loader so the
    same global batch is re-partitioned across a different worker count.

The state is ``{"params": the port's per-layer parameters, "opt":
init_opt_state's, "ef_residual": float32 residuals in the reference's
layout (int8_ef only)}``; ``trainer.state`` is public, so a converted
reference state (``models.state_from_jax``) can be put there.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import torch

from ..configs.base import ArchConfig
from ..data.loader import FederatedDataLoader
from ..device import resolve_device
from ..models import init_lm, jax_layout, lm_loss, params_from_jax
from ..sharding.compression import ErrorFeedback
from .checkpoint import FederatedCheckpointer
from .optimizer import (AdamWConfig, adamw_update, get, init_opt_state,
                        opt_layout, put, ref_units, stacked, walk)


class FailureInjector:
    """Deterministic chaos monkey: fail at the listed steps, once each."""

    def __init__(self, fail_at: List[int] = ()) -> None:
        self.fail_at = set(fail_at)
        self.failures = 0

    def maybe_fail(self, step: int) -> None:
        if step in self.fail_at:
            self.fail_at.discard(step)
            self.failures += 1
            raise RuntimeError(f"injected node failure at step {step}")


@dataclasses.dataclass
class TrainerReport:
    steps_run: int = 0
    restarts: int = 0
    losses: List[float] = dataclasses.field(default_factory=list)
    final_loss: float = float("nan")
    cache_hit_rate: float = 0.0
    restored_from: List[int] = dataclasses.field(default_factory=list)


class Trainer:
    def __init__(self, cfg: ArchConfig, loader: FederatedDataLoader,
                 opt_cfg: Optional[AdamWConfig] = None,
                 checkpointer: Optional[FederatedCheckpointer] = None,
                 checkpoint_every: int = 50,
                 seed: int = 0,
                 aux_weight: float = 0.01,
                 grad_compression: str = "none",
                 device=None) -> None:
        self.cfg = cfg
        self.loader = loader
        self.opt_cfg = opt_cfg or AdamWConfig(warmup_steps=10,
                                              total_steps=1000)
        self.checkpointer = checkpointer
        self.checkpoint_every = checkpoint_every
        self.aux_weight = aux_weight
        # int8_ef: blockwise-int8 gradients with error feedback — the
        # codec that compresses the cross-pod all-reduce 4x
        self.grad_compression = grad_compression
        self.device = resolve_device(device)
        self.period = len(cfg.pattern())
        params = init_lm(cfg, seed=seed, device=self.device)
        self.state: Dict[str, Any] = {
            "params": params,
            "opt": init_opt_state(params, self.opt_cfg, self.period)}
        if grad_compression == "int8_ef":
            self.state["ef_residual"] = opt_layout(
                params, self.period,
                lambda shape, dev: torch.zeros(shape, device=dev))
        self.step = 0

    # ------------------------------------------------------------------
    def train_step(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """One step on ``batch`` (the loader's int32 arrays), updating
        ``self.state`` in place; returns the step's metrics (tensors)."""
        params = self.state["params"]
        leaves = [t for _, t in walk(params)]
        for t in leaves:
            t.requires_grad_(True)
        tokens = torch.as_tensor(batch["tokens"], device=self.device)
        labels = torch.as_tensor(batch["labels"], device=self.device)
        with torch.enable_grad():
            loss, _ = lm_loss(params, tokens, labels, self.cfg,
                              aux_weight=self.aux_weight)
            flat = torch.autograd.grad(loss, leaves)
        grads = _unflatten(params, iter(flat))
        if self.grad_compression == "int8_ef":
            self._compress(grads)
        _, _, metrics = adamw_update(grads, self.state["opt"], params,
                                     self.opt_cfg)
        metrics["loss"] = loss.detach()
        return metrics

    def _compress(self, grads) -> None:
        """Error feedback over the reference's leaves (each pattern
        position's gradients stacked over groups), in place."""
        residual = self.state["ef_residual"]
        units = ref_units(self.state["params"], self.period)
        sent, new_res = ErrorFeedback.compress(
            [stacked(grads, u) for u in units],
            [get(residual, path) for path, _ in units])
        for (path, leaves), s, r in zip(units, sent, new_res):
            put(residual, path, r)
            for i, lp in enumerate(leaves):
                put(grads, lp, s[i] if path[0] == "blocks" else s)

    # ------------------------------------------------------------------
    def checkpoint_state(self) -> Dict[str, Any]:
        """The state in the reference's layout: what a save writes."""
        with torch.no_grad():
            out = dict(self.state)
            out["params"] = jax_layout(self.state["params"], self.cfg)
            return out

    def save(self) -> None:
        if self.checkpointer is not None:
            self.checkpointer.save(self.step, self.checkpoint_state())

    def restore_latest(self) -> bool:
        if self.checkpointer is None:
            return False
        latest = self.checkpointer.latest_step()
        if latest is None:
            return False
        state, _ = self.checkpointer.restore(
            latest, like=self.checkpoint_state(), device=self.device)
        state["params"] = params_from_jax(state["params"], self.cfg,
                                          self.device)
        self.state = state
        self.step = latest
        return True

    def rescale(self, world: int, rank: int = 0) -> None:
        """Elastic re-partition of the data plane."""
        self.loader.world = world
        self.loader.rank = rank
        self.loader._buffer.clear()

    # ------------------------------------------------------------------
    def run(self, num_steps: int,
            failure: Optional[FailureInjector] = None,
            max_restarts: int = 10) -> TrainerReport:
        report = TrainerReport()
        target = self.step + num_steps
        restarts = 0
        if self.checkpointer is not None and self.step == 0:
            self.save()  # step-0 anchor so the first failure can recover
        while self.step < target:
            try:
                if failure is not None:
                    failure.maybe_fail(self.step)
                batch = self.loader.batch(self.step)
                metrics = self.train_step(batch)
                self.step += 1
                report.steps_run += 1
                loss = float(metrics["loss"])
                report.losses.append(loss)
                if self.checkpointer is not None and \
                        self.step % self.checkpoint_every == 0:
                    self.save()
            except RuntimeError as e:
                if "injected" not in str(e) or restarts >= max_restarts:
                    raise
                restarts += 1
                report.restarts += 1
                restored = self.restore_latest()
                if restored:
                    report.restored_from.append(self.step)
                # else: cold restart from current in-memory state
        report.final_loss = report.losses[-1] if report.losses else \
            float("nan")
        report.cache_hit_rate = self.loader.stats.hit_rate
        return report


def _unflatten(like, leaves):
    """``like``'s structure (dicts and lists) with its leaves taken in
    ``walk`` order from the iterator ``leaves``."""
    if isinstance(like, dict):
        return {k: _unflatten(v, leaves) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, leaves) for v in like)
    return next(leaves)
