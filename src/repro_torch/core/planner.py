"""Predictive capacity planner: invert fitted cache models.

The port of ``repro.core.planner``.  The sweep engine *describes*
configurations it has exactly replayed; this module *prescribes*.  Given
the per-cache differentiable models a ``fit=`` sweep produced
(:mod:`repro_torch.kernels.cache_model`), it answers both directions:

* **forward** (:func:`predict`) — hit rate / origin egress at capacity
  points no sweep cell ever replayed, straight from the smoothed
  Mattson curves;
* **inverse** (:func:`plan_capacity`) — minimize total fleet capacity
  subject to a target fleet hit rate (and optionally an origin-egress
  budget), with one capacity variable per *site* (every cache of a
  site shares the ``SiteSpec.cache_capacity`` knob, including the
  backbone sites of an L1×L2 hierarchy).

The inverse solve is an augmented-Lagrangian gradient descent in
log-capacity — inner Adam rounds, outer dual updates with a
geometrically rising penalty weight — then a monotone *repair*
bisection rescales the solution onto the constraint surface (the
smoothed curves are monotone in capacity, so feasibility-by-scaling is
exact on the model).  The same solve also bisects the minimal *uniform*
capacity meeting the target, which seeds the descent and prices the
``savings_vs_uniform`` headline.  All of it, in float64, is one call of
``ops.plan_solve``: on the card the ``plan_solve`` kernel (one launch,
the host reads its outputs once), on the CPU the plain version
(``ref.plan_solve_ref``, torch ops with autograd).  ``device=None`` means
``cuda`` and raises without a card.

Model-level feasibility is not replay-level feasibility (bucketing and
smoothing error, FIFO columns fitted by spline): recommendations are
**verified** by replaying the recommended point through the exact
batched kernels (:func:`verify_plan` → :func:`~repro_torch.core.api.
run_sweep` with a single cell, on ``base.device``), scaling capacities up
by a bounded backoff until the exact replay meets the target — so a
returned plan's ``verification`` block is ground truth, not model output.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from ..device import resolve_device
from ..kernels import ops
from ..kernels.cache_model import (CacheModel, StackedModels,
                                   predict_hit_rate, predict_miss_bytes,
                                   stack_models)
from ..kernels.ref import PLAN_ROUNDS

Device = Union[str, torch.device, None]


@dataclasses.dataclass(frozen=True)
class PlannerSpec:
    """One inverse-planning problem.

    ``models`` maps cache-server name → fitted :class:`CacheModel`
    (histogram-backed kinds; what ``run_sweep(fit=True)`` returns).
    ``groups`` maps capacity-variable name → the cache names sharing
    that variable; by default every cache is its own variable, and
    :func:`groups_for_federation` builds the per-site grouping that
    matches the ``SiteSpec.cache_capacity`` knob.
    """

    models: Dict[str, CacheModel]
    target_hit_rate: float = 0.95
    target_egress_bytes: Optional[float] = None
    groups: Optional[Dict[str, List[str]]] = None
    min_capacity: float = 64e6
    max_capacity: float = 1e16
    steps: int = 600
    lr: float = 0.05
    penalty: float = 10.0           # initial augmented-Lagrangian weight ρ
    penalty_growth: float = 100.0   # final ρ = penalty * growth
    margin: float = 0.002           # plan for target + margin (smoothing slack)


@dataclasses.dataclass
class PlanReport:
    """What the planner recommends, plus how it got there.

    ``capacities`` are per group (per site under
    :func:`groups_for_federation`); ``per_cache`` expands groups to
    cache-server names.  ``verification`` is ``None`` until
    :func:`verify_plan` has replayed the point through the exact
    kernels."""

    capacities: Dict[str, float]
    per_cache: Dict[str, float]
    predicted_hit_rate: float
    predicted_egress_bytes: float
    total_capacity: float
    uniform_capacity: float
    uniform_total: float
    savings_vs_uniform: float
    target_hit_rate: float
    target_egress_bytes: Optional[float] = None
    wall_seconds: float = 0.0
    telemetry: Dict[str, float] = dataclasses.field(default_factory=dict)
    verification: Optional[Dict] = None

    def summary(self) -> Dict:
        """JSON-safe form — the ``plan.json`` artifact schema."""
        return {
            "capacities": {k: float(v) for k, v in self.capacities.items()},
            "per_cache": {k: float(v) for k, v in self.per_cache.items()},
            "predicted_hit_rate": float(self.predicted_hit_rate),
            "predicted_egress_bytes": float(self.predicted_egress_bytes),
            "total_capacity": float(self.total_capacity),
            "uniform_capacity": float(self.uniform_capacity),
            "uniform_total": float(self.uniform_total),
            "savings_vs_uniform": float(self.savings_vs_uniform),
            "target_hit_rate": float(self.target_hit_rate),
            "target_egress_bytes": (float(self.target_egress_bytes)
                                    if self.target_egress_bytes is not None
                                    else None),
            "wall_seconds": float(self.wall_seconds),
            "telemetry": {k: float(v) for k, v in self.telemetry.items()},
            "verification": dict(self.verification)
            if self.verification is not None else None,
        }


def groups_for_federation(fed, models: Dict[str, CacheModel]
                          ) -> Dict[str, List[str]]:
    """Site-name → cache-names grouping matching the per-site
    ``SiteSpec.cache_capacity`` knob (only caches with a fitted model
    count; a site whose caches saw no traffic gets no variable)."""
    out: Dict[str, List[str]] = {}
    for s in fed.sites:
        names = [n for n in s.cache_names() if n in models]
        if names:
            out[s.name] = names
    return out


def predict(models: Dict[str, CacheModel], capacities,
            device: Device = None) -> Dict:
    """Forward mode: hit rate / egress at an *unswept* capacity point.

    ``capacities`` is a scalar (uniform) or a dict of cache name →
    bytes.  Works for every model kind (interp included), weighting
    per-cache curves by reference counts — so a fleet at heterogeneous
    capacities prices in one call, no replay.  The curves are evaluated
    in float64 on ``device`` (``None`` means ``cuda``)."""
    dev = resolve_device(device)
    names = sorted(models)
    caps = {n: float(capacities[n] if isinstance(capacities, dict)
                     else capacities) for n in names}
    hits = refs = egress = 0.0
    per_cache: Dict[str, float] = {}
    for n in names:
        mdl = models[n]
        cap = torch.tensor(caps[n], dtype=torch.float64, device=dev)
        h = float(predict_hit_rate(mdl, cap))
        per_cache[n] = h
        w = max(mdl.total_refs, 1.0)
        hits += h * w
        refs += w
        egress += mdl.origin_fraction * float(predict_miss_bytes(mdl, cap))
    return {"hit_rate": hits / max(refs, 1.0),
            "origin_egress_bytes": egress,
            "per_cache_hit_rate": per_cache}


def solve_inputs(stacked: StackedModels, gidx: np.ndarray,
                 gsize: np.ndarray, spec: PlannerSpec) -> Dict[str, np.ndarray]:
    """The inverse solve's inputs as ``ops.plan_solve`` takes them, for one
    plan (a leading batch axis of 1), numpy: the stacked model, the
    per-cache totals, each cache's group, each group's size and the
    scalars (target with its margin, budget or NaN, the log-capacity
    bounds, tau, lr, the first penalty and its growth a round)."""
    budget = spec.target_egress_bytes
    scalars = [spec.target_hit_rate + spec.margin,
               math.nan if budget is None else float(budget),
               np.log(spec.min_capacity), np.log(spec.max_capacity),
               stacked.tau, spec.lr, float(spec.penalty),
               spec.penalty_growth ** (1.0 / max(PLAN_ROUNDS - 1, 1))]
    return {"stacked": np.stack([stacked.log_centers, stacked.ref_weights,
                                 stacked.byte_weights])[None],
            "per_cache": np.stack([stacked.total_refs, stacked.total_bytes,
                                   stacked.origin_fraction])[None],
            "gidx": np.asarray(gidx, np.int64)[None],
            "gsize": np.asarray(gsize, np.float64)[None],
            "scalars": np.asarray([scalars], np.float64)}


def _solve(stacked: StackedModels, gidx: np.ndarray, gsize: np.ndarray,
           spec: PlannerSpec, device: torch.device):
    """The inverse solve on ``device``: per-group capacities plus the
    uniform baseline and end-point telemetry, from one ``ops.plan_solve``
    call and one read: bisection → augmented-Lagrangian Adam rounds →
    repair bisection."""
    args = {k: torch.from_numpy(v).to(device)
            for k, v in solve_inputs(stacked, gidx, gsize, spec).items()}
    out = ops.plan_solve(args["stacked"], args["per_cache"], args["gidx"],
                         args["gsize"], args["scalars"], spec.steps)
    out = out[0].cpu().numpy()
    G = len(gsize)
    return out[:G], out[G], out[G + 1], out[G + 2], out[G + 3]


def plan_problem(spec: PlannerSpec, federation=None):
    """The solve's variables: ``(groups, gnames, stacked, gidx, gsize)`` —
    the grouping (``spec.groups``, else per site of ``federation``, else a
    variable a cache), its names in order, the stacked models, each
    cache's group and each group's size."""
    groups = spec.groups
    if groups is None:
        groups = (groups_for_federation(federation, spec.models)
                  if federation is not None
                  else {n: [n] for n in spec.models})
    gnames = sorted(groups)
    stacked = stack_models(spec.models)
    pos = {n: i for i, n in enumerate(stacked.names)}
    gidx = np.zeros(len(stacked.names), np.int64)
    gsize = np.zeros(len(gnames))
    for gi, g in enumerate(gnames):
        for cache in groups[g]:
            gidx[pos[cache]] = gi
        gsize[gi] = len(groups[g])
    return groups, gnames, stacked, gidx, gsize


def plan_capacity(spec: PlannerSpec, federation=None,
                  device: Device = None) -> PlanReport:
    """Inverse planning: minimal total fleet capacity meeting
    ``spec.target_hit_rate`` (and the egress budget, if set).

    ``federation`` (a :class:`~repro_torch.core.federation.FederationSpec`)
    switches the variables to per-site grouping via
    :func:`groups_for_federation` when ``spec.groups`` is unset.  The solve
    runs on ``device`` (``None`` means ``cuda``).  The returned report is
    model-level; chase it with :func:`verify_plan` for exact-replay ground
    truth."""
    t0 = time.perf_counter()
    dev = resolve_device(device)
    groups, gnames, stacked, gidx, gsize = plan_problem(spec, federation)
    caps, uni, pred_hit, pred_egress, gnorm = _solve(stacked, gidx, gsize,
                                                     spec, dev)
    capacities = {g: float(caps[gi]) for gi, g in enumerate(gnames)}
    per_cache = {cache: capacities[g]
                 for g in gnames for cache in groups[g]}
    total = float((gsize * caps).sum())
    uniform_total = float(gsize.sum() * uni)
    return PlanReport(
        capacities=capacities, per_cache=per_cache,
        predicted_hit_rate=float(pred_hit),
        predicted_egress_bytes=float(pred_egress),
        total_capacity=total, uniform_capacity=float(uni),
        uniform_total=uniform_total,
        savings_vs_uniform=1.0 - total / max(uniform_total, 1.0),
        target_hit_rate=spec.target_hit_rate,
        target_egress_bytes=spec.target_egress_bytes,
        wall_seconds=time.perf_counter() - t0,
        telemetry={"hit_grad_norm": float(gnorm),
                   "groups": float(len(gnames)),
                   "caches": float(len(stacked.names)),
                   "steps": float(spec.steps)})


def apply_capacities(fed, capacities: Dict[str, float]):
    """``fed`` with every named site's ``cache_capacity`` replaced —
    the bridge from a plan (per-site bytes) back to a runnable
    :class:`~repro_torch.core.federation.FederationSpec`."""
    sites = [dataclasses.replace(s, cache_capacity=capacities[s.name])
             if s.name in capacities else s for s in fed.sites]
    return dataclasses.replace(fed, sites=sites)


def _exact_point(base, capacities: Dict[str, float]) -> Dict:
    """Replay one capacity point through the exact batched kernels."""
    from .api import SweepSpec, run_sweep
    cspec = dataclasses.replace(
        base, federation=apply_capacities(base.federation, capacities))
    report = run_sweep(SweepSpec(name="verify", base=cspec, axes={}))
    cell = report.cells[0]
    s = cell.summary
    refs = s["cache_hits"] + s["cache_misses"]
    return {"hit_rate": s["cache_hits"] / max(refs, 1),
            "origin_egress_bytes": s["origin_egress_bytes"],
            "executor": cell.executor}


def verify_plan(report: PlanReport, base, max_attempts: int = 6,
                scale: float = 1.25) -> PlanReport:
    """Ground-truth a plan against the exact batched kernels.

    Replays ``base`` (a :class:`~repro_torch.core.api.ScenarioSpec`; its
    federation's site names must match the plan's group names, and its
    ``device`` is where the replay's kernels run) at the recommended
    capacities.  If the exact replay falls short of the target — model
    smoothing error — capacities scale up by ``scale`` and replay again,
    at most ``max_attempts`` times, so the returned plan is *always*
    feasible when any capacity in range is.  Returns the report with
    ``capacities``/``totals`` updated to the verified point and a
    ``verification`` block recording the evidence."""
    caps = dict(report.capacities)
    attempts = 0
    applied = 1.0
    exact: Dict = {}
    while True:
        attempts += 1
        exact = _exact_point(base, caps)
        ok = exact["hit_rate"] >= report.target_hit_rate
        if report.target_egress_bytes is not None:
            ok = ok and (exact["origin_egress_bytes"]
                         <= report.target_egress_bytes)
        if ok or attempts >= max_attempts:
            break
        caps = {k: v * scale for k, v in caps.items()}
        applied *= scale
    per_cache = {c: v * applied for c, v in report.per_cache.items()}
    total = sum(per_cache.values())
    return dataclasses.replace(
        report, capacities=caps, per_cache=per_cache,
        total_capacity=total,
        savings_vs_uniform=1.0 - total / max(report.uniform_total, 1.0),
        verification={
            "achieved_hit_rate": float(exact["hit_rate"]),
            "achieved_egress_bytes": float(exact["origin_egress_bytes"]),
            "target_hit_rate": float(report.target_hit_rate),
            "feasible": bool(exact["hit_rate"] >= report.target_hit_rate),
            "attempts": attempts,
            "scale_applied": applied,
            "executor": exact["executor"],
        })
