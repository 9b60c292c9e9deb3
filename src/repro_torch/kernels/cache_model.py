"""Differentiable cache models: smoothed Mattson hit-rate curves.

The port of ``repro.kernels.cache_model``.  :mod:`.stack_distance`
answers *exact* hit/miss questions: at capacity ``C``, reference ``i``
hits iff ``dist_i + size_i <= C``.  The distances are
capacity-independent, so one pass carries the whole curve ``H(C)`` — but
only as a step function, which autograd cannot use.  This module turns the
same distances into *models*:

* :func:`reuse_histogram` — bucket the per-reference hit thresholds
  ``c_i = dist_i + size_i`` into log-spaced bins (reference counts and
  byte weights per bin, compulsory mass kept separate).  This is the
  per-cache ``reuse_histogram`` surfaced on sweep cells.
* ``kind="hist"`` models — the smoothed Mattson curve
  ``H(C) = Σ_b w_b · σ((ln C − ln d_b) / τ)`` over the histogram
  buckets: monotone non-decreasing in ``C``, bounded in ``[0, 1]``, and
  exact up to bucketing + smoothing error (τ → 0 recovers the step
  curve).  Differentiable in capacity everywhere.
* ``kind="mixture"`` models — a parametric mixture-of-lognormals CDF
  fitted to the empirical curve by Adam (:func:`fit_lognormal_mixture`,
  through ``ops.mixture_fit``: on the card the ``mixture_fit`` kernel, the
  whole loop in one launch): a compact per-workload signature that
  survives without the histogram.
* ``kind="interp"`` models — a monotone piecewise-linear spline in
  log-capacity through *exact* swept points (:func:`fit_interp_model`):
  the fallback for curves the LRU stack model does not express (FIFO
  victim order, admission-filtered residue).

Histograms, the fits' set-up and the stacking stay numpy, as in the
reference.  The evaluators (:func:`predict_hit_rate`,
:func:`predict_miss_bytes`, the ``fleet_*`` totals) are torch ops in
float64 on the capacity tensor's device — a Python float or numpy
capacity means the CPU — and differentiable in capacity by autograd.  The
reference evaluates ``predict_hit_rate`` in its default float32 outside
``enable_x64``; the port always computes in float64.

This module also holds the library of ``csrc/cache_model.cu`` and its two
kernels: ``PLAN_SOLVE`` (the planner's whole inverse solve, a thread block
cluster a plan) and ``MIXTURE_FIT`` (the mixture's Adam loop, a block a
histogram, a batch of histograms in one launch).
``ops.plan_solve`` and ``ops.mixture_fit`` send CUDA tensors to them and
CPU tensors to the plain versions in ``ref``.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from ..device import resolve_device
from ._build import CudaLibrary
from .ref import PLAN_ROUNDS, softmax
from .stack_distance import _check

DEFAULT_BUCKETS = 64
# Smoothing temperature in log-capacity space: ~5% capacity error per
# bucket edge, far below the 2%-absolute-hit-rate acceptance band.
DEFAULT_TAU = 0.05
MIXTURE_POINTS = 129          # the fit's grid over log-threshold space


# ---------------------------------------------------------------------------
# Reuse-distance histograms (numpy, as in the reference)


@dataclasses.dataclass(frozen=True)
class ReuseHistogram:
    """Log-spaced histogram of per-reference hit thresholds.

    A reference with byte-weighted stack distance ``d`` and size ``s``
    hits at any capacity ``C >= d + s``; its *threshold* is ``c = d +
    s``.  Buckets carry reference counts and reference bytes; the
    compulsory mass (``d = inf``: first touch, cold restart) can never
    hit and is kept out of the buckets.
    """

    edges: np.ndarray         # (B+1,) threshold-bucket edges, bytes
    log_centers: np.ndarray   # (B,) mean ln(threshold) of refs in bucket
    ref_weights: np.ndarray   # (B,) references per bucket
    byte_weights: np.ndarray  # (B,) reference bytes per bucket
    compulsory_refs: int
    compulsory_bytes: int
    total_refs: int
    total_bytes: int

    def to_dict(self) -> Dict:
        """JSON-safe form (what sweep cells carry)."""
        return {
            "edges": [float(e) for e in self.edges],
            "log_centers": [float(c) for c in self.log_centers],
            "ref_weights": [float(w) for w in self.ref_weights],
            "byte_weights": [float(w) for w in self.byte_weights],
            "compulsory_refs": int(self.compulsory_refs),
            "compulsory_bytes": int(self.compulsory_bytes),
            "total_refs": int(self.total_refs),
            "total_bytes": int(self.total_bytes),
        }

    @staticmethod
    def from_dict(d: Dict) -> "ReuseHistogram":
        return ReuseHistogram(
            edges=np.asarray(d["edges"], np.float64),
            log_centers=np.asarray(d["log_centers"], np.float64),
            ref_weights=np.asarray(d["ref_weights"], np.float64),
            byte_weights=np.asarray(d["byte_weights"], np.float64),
            compulsory_refs=int(d["compulsory_refs"]),
            compulsory_bytes=int(d["compulsory_bytes"]),
            total_refs=int(d["total_refs"]),
            total_bytes=int(d["total_bytes"]))


def reuse_histogram(distances: np.ndarray, ref_sizes: np.ndarray,
                    n_buckets: int = DEFAULT_BUCKETS) -> ReuseHistogram:
    """Bucket one stream's hit thresholds ``c_i = dist_i + size_i``.

    ``distances`` come straight from
    :func:`repro_torch.kernels.stack_distance.stack_distances_batch`
    (``inf`` marking compulsory misses); ``ref_sizes`` are the matching
    per-reference chunk bytes.  Totals are conserved exactly:
    ``sum(ref_weights) + compulsory_refs == total_refs`` and likewise
    for bytes.
    """
    dist = np.asarray(distances, np.float64)
    sizes = np.asarray(ref_sizes, np.float64)
    c = dist + sizes
    finite = np.isfinite(c)
    total_refs = int(len(c))
    total_bytes = int(round(sizes.sum()))
    comp_refs = int((~finite).sum())
    comp_bytes = int(round(sizes[~finite].sum()))
    cf, sf = c[finite], sizes[finite]
    if not len(cf):
        edges = np.geomspace(1.0, 2.0, n_buckets + 1)
        zeros = np.zeros(n_buckets)
        return ReuseHistogram(
            edges=edges, log_centers=np.log(np.sqrt(edges[:-1] * edges[1:])),
            ref_weights=zeros, byte_weights=zeros.copy(),
            compulsory_refs=comp_refs, compulsory_bytes=comp_bytes,
            total_refs=total_refs, total_bytes=total_bytes)
    lo, hi = float(cf.min()), float(cf.max())
    if hi <= lo:
        hi = lo * (1.0 + 1e-9) + 1.0
    edges = np.geomspace(lo, hi, n_buckets + 1)
    b = np.clip(np.searchsorted(edges, cf, side="right") - 1,
                0, n_buckets - 1)
    refw = np.bincount(b, minlength=n_buckets).astype(np.float64)
    bytew = np.bincount(b, weights=sf, minlength=n_buckets)
    logsum = np.bincount(b, weights=np.log(np.maximum(cf, 1.0)),
                         minlength=n_buckets)
    centers = np.log(np.sqrt(edges[:-1] * edges[1:]))
    occupied = refw > 0
    centers[occupied] = logsum[occupied] / refw[occupied]
    return ReuseHistogram(
        edges=edges, log_centers=centers, ref_weights=refw,
        byte_weights=bytew, compulsory_refs=comp_refs,
        compulsory_bytes=comp_bytes, total_refs=total_refs,
        total_bytes=total_bytes)


# ---------------------------------------------------------------------------
# Models


@dataclasses.dataclass(frozen=True)
class CacheModel:
    """One cache's fitted hit-rate curve, evaluable under autograd.

    Every kind answers :func:`predict_hit_rate` /
    :func:`predict_miss_bytes` with torch ops.  ``hist`` and ``mixture``
    kinds keep the histogram arrays (the mixture uses them for the
    byte/egress curve, where its ref-count fit does not apply);
    ``interp`` kinds carry only their knots.  The arrays are numpy, as in
    the reference; an evaluation moves them to the capacity's device.

    ``origin_fraction`` is the share of this cache's missed bytes that
    pulls from the *origin* rather than a parent tier (1.0 for flat
    caches and merged parent streams) — the per-tier egress weighting
    the planner's egress constraint uses.
    """

    kind: str                   # "hist" | "mixture" | "interp"
    tau: float = DEFAULT_TAU
    log_centers: Optional[np.ndarray] = None   # (B,)
    ref_weights: Optional[np.ndarray] = None   # (B,)
    byte_weights: Optional[np.ndarray] = None  # (B,)
    total_refs: float = 0.0
    total_bytes: float = 0.0
    compulsory_refs: float = 0.0
    compulsory_bytes: float = 0.0
    origin_fraction: float = 1.0
    # mixture-of-lognormals parameters (kind == "mixture")
    mix_logits: Optional[np.ndarray] = None     # (K,)
    mix_mu: Optional[np.ndarray] = None         # (K,)
    mix_log_sigma: Optional[np.ndarray] = None  # (K,)
    # monotone log-capacity spline knots (kind == "interp")
    knots_logc: Optional[np.ndarray] = None     # (M,)
    knots_hit: Optional[np.ndarray] = None      # (M,)
    fit_loss: float = 0.0


def fit_histogram_model(hist: ReuseHistogram, tau: float = DEFAULT_TAU,
                        origin_fraction: float = 1.0) -> CacheModel:
    """The smoothed Mattson curve over ``hist``'s buckets (nonparametric:
    the histogram *is* the fit)."""
    return CacheModel(
        kind="hist", tau=float(tau),
        log_centers=np.asarray(hist.log_centers, np.float64),
        ref_weights=np.asarray(hist.ref_weights, np.float64),
        byte_weights=np.asarray(hist.byte_weights, np.float64),
        total_refs=float(hist.total_refs),
        total_bytes=float(hist.total_bytes),
        compulsory_refs=float(hist.compulsory_refs),
        compulsory_bytes=float(hist.compulsory_bytes),
        origin_fraction=float(origin_fraction))


def _f64(x, device: torch.device) -> torch.Tensor:
    """``x`` as a float64 tensor on ``device`` (a tensor keeps its
    autograd graph)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float64)
    return torch.as_tensor(np.asarray(x, np.float64), device=device)


def _capacity(capacity) -> torch.Tensor:
    """A capacity as float64 on its own device: a tensor's, else the CPU."""
    if isinstance(capacity, torch.Tensor):
        return capacity.to(torch.float64)
    return torch.as_tensor(np.asarray(capacity, np.float64))


def _log_capacity(capacity: torch.Tensor) -> torch.Tensor:
    """``ln max(C, 1)`` (``jnp.maximum``'s gradient: half at a tie)."""
    return torch.log(torch.maximum(capacity, torch.ones_like(capacity)))


def _smoothed_frac(logC: torch.Tensor, centers: torch.Tensor,
                   weights: torch.Tensor, tau: float) -> torch.Tensor:
    """``Σ_b w_b σ((ln C − m_b)/τ)`` — broadcast over leading axes of
    ``logC``; weights need not be normalized."""
    z = (logC[..., None] - centers) / tau
    return (weights * torch.sigmoid(z)).sum(dim=-1)


def _mixture_cdf(logC: torch.Tensor, logits: torch.Tensor, mu: torch.Tensor,
                 log_sigma: torch.Tensor) -> torch.Tensor:
    pis = softmax(logits)
    sigma = torch.exp(log_sigma)
    z = (logC[..., None] - mu) / (sigma * np.sqrt(2.0))
    return (pis * 0.5 * (1.0 + torch.special.erf(z))).sum(dim=-1)


def _interp(x: torch.Tensor, xp: torch.Tensor,
            fp: torch.Tensor) -> torch.Tensor:
    """``jnp.interp(x, xp, fp)``: linear between the knots, the end
    knots' values outside them, and at a repeated knot the right segment
    (``searchsorted`` on the right); a segment of zero width takes its
    left value, as the reference's guard against NaN gradients does."""
    i = torch.clamp(torch.searchsorted(xp, x.detach().contiguous(),
                                       right=True), 1, len(xp) - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    dx0 = torch.abs(dx) <= np.spacing(np.finfo(np.float64).eps)
    f = torch.where(dx0, fp[i - 1],
                    fp[i - 1] + (delta / torch.where(dx0, 1.0, dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def predict_hit_rate(model: CacheModel, capacity) -> torch.Tensor:
    """``H(C)`` for one cache — differentiable in ``capacity`` (scalar
    or array, on its device), monotone non-decreasing, bounded in
    ``[0, 1]``."""
    cap = _capacity(capacity)
    dev = cap.device
    logC = _log_capacity(cap)
    if model.kind == "interp":
        return torch.clamp(_interp(logC, _f64(model.knots_logc, dev),
                                   _f64(model.knots_hit, dev)), 0.0, 1.0)
    denom = max(model.total_refs, 1.0)
    if model.kind == "mixture":
        finite = model.total_refs - model.compulsory_refs
        return finite / denom * _mixture_cdf(
            logC, _f64(model.mix_logits, dev), _f64(model.mix_mu, dev),
            _f64(model.mix_log_sigma, dev))
    return _smoothed_frac(logC, _f64(model.log_centers, dev),
                          _f64(model.ref_weights, dev), model.tau) / denom


def predict_miss_bytes(model: CacheModel, capacity) -> torch.Tensor:
    """Expected bytes this cache pulls from upstream at ``capacity`` —
    the byte-weighted miss curve (compulsory bytes always pull)."""
    cap = _capacity(capacity)
    if model.kind == "interp":
        return model.total_bytes * (1.0 - predict_hit_rate(model, cap))
    dev = cap.device
    hit_bytes = _smoothed_frac(_log_capacity(cap),
                               _f64(model.log_centers, dev),
                               _f64(model.byte_weights, dev), model.tau)
    return model.total_bytes - hit_bytes


# ---------------------------------------------------------------------------
# Parametric fit: mixture of lognormals


def _quantiles(values: np.ndarray, weights: np.ndarray,
               qs: np.ndarray) -> np.ndarray:
    order = np.argsort(values)
    v, w = values[order], weights[order]
    cw = np.cumsum(w)
    if cw[-1] <= 0:
        return np.zeros_like(qs)
    cw = cw / cw[-1]
    return np.interp(qs, cw, v)


def mixture_problem(hist: ReuseHistogram, components: int = 3):
    """The fit's inputs for ``hist`` — ``(params0 (3, K), grid (129,),
    target (129,))``, numpy float64 — or ``None`` when the histogram has no
    finite reuse (the curve is identically zero).  ``params0`` stacks the
    logits, means and log-sigmas, initialised deterministically from
    weighted quantiles of the threshold distribution."""
    w = np.asarray(hist.ref_weights, np.float64)
    m = np.asarray(hist.log_centers, np.float64)
    mass = float(w.sum())
    if mass <= 0 or not np.isfinite(m).all():
        return None
    # empirical CDF of the threshold distribution (normalized to the
    # finite mass — the compulsory scale factor is pinned, not fitted)
    grid = np.linspace(m.min() - 1.0, m.max() + 1.0, MIXTURE_POINTS)
    target = np.array([(w * (m <= g)).sum() for g in grid]) / mass
    qs = (np.arange(components) + 0.5) / components
    mu0 = _quantiles(m, w, qs)
    spread = max(float(m.max() - m.min()), 0.1)
    params0 = np.stack([np.zeros(components), np.asarray(mu0, np.float64),
                        np.full(components,
                                np.log(spread / (2.0 * components)))])
    return params0, grid, target


def mixture_model(hist: ReuseHistogram, params: Optional[np.ndarray],
                  loss: float = 0.0, origin_fraction: float = 1.0,
                  components: int = 3) -> CacheModel:
    """The ``mixture`` model of ``hist`` with fitted ``params`` (3, K), or
    the identically-zero curve of ``components`` zeroed components when
    ``params`` is ``None`` (no finite reuse: :func:`mixture_problem`
    returned ``None``)."""
    m = np.asarray(hist.log_centers, np.float64)
    w = np.asarray(hist.ref_weights, np.float64)
    common = dict(total_refs=float(hist.total_refs),
                  total_bytes=float(hist.total_bytes),
                  compulsory_bytes=float(hist.compulsory_bytes),
                  log_centers=m, ref_weights=w,
                  byte_weights=np.asarray(hist.byte_weights, np.float64),
                  origin_fraction=float(origin_fraction))
    if params is None:
        return CacheModel(kind="mixture", mix_logits=np.zeros(components),
                          mix_mu=np.zeros(components),
                          mix_log_sigma=np.zeros(components),
                          compulsory_refs=float(hist.total_refs), **common)
    logits, mu, log_sigma = (np.asarray(p, np.float64) for p in params)
    return CacheModel(kind="mixture", mix_logits=logits, mix_mu=mu,
                      mix_log_sigma=log_sigma,
                      compulsory_refs=float(hist.compulsory_refs),
                      fit_loss=float(loss), **common)


def fit_lognormal_mixture(hist: ReuseHistogram, components: int = 3,
                          steps: int = 400, lr: float = 0.08,
                          origin_fraction: float = 1.0,
                          stats: Optional[Dict] = None,
                          device: Union[str, torch.device, None] = None
                          ) -> CacheModel:
    """Fit ``H(C) = p · Σ_k π_k Φ((ln C − μ_k)/σ_k)`` to the empirical
    curve: the numpy set-up of :func:`mixture_problem`, then ``steps``
    Adam steps through ``ops.mixture_fit`` on ``device`` (``None`` means
    ``cuda``: the ``mixture_fit`` kernel, the whole loop in one launch).

    ``p`` is the pinned non-compulsory mass; the free parameters are
    the component logits, means and log-sigmas.  ``fit_loss`` is the
    reference's: the loss the last step evaluated before its own update.
    """
    if mixture_problem(hist, components) is None:
        return mixture_model(hist, None, origin_fraction=origin_fraction,
                             components=components)
    model = fit_lognormal_mixtures([hist], components, steps, lr,
                                   [origin_fraction], device)[0]
    if stats is not None:
        stats["fit_steps"] = steps
        stats["fit_loss"] = model.fit_loss
    return model


def fit_lognormal_mixtures(hists: Sequence[ReuseHistogram],
                           components: int = 3, steps: int = 400,
                           lr: float = 0.08,
                           origin_fractions: Optional[Sequence[float]] = None,
                           device: Union[str, torch.device, None] = None
                           ) -> List[CacheModel]:
    """:func:`fit_lognormal_mixture` of every histogram, the fits of those
    with finite reuse in one ``ops.mixture_fit`` call on ``device`` (on the
    card one launch, a block a fit: each model equals its fit alone)."""
    fractions = ([1.0] * len(hists) if origin_fractions is None
                 else list(origin_fractions))
    problems = [mixture_problem(h, components) for h in hists]
    live = [i for i, p in enumerate(problems) if p is not None]
    models = [mixture_model(h, None, origin_fraction=of,
                            components=components)
              for h, of in zip(hists, fractions)]
    if not live:
        return models
    from . import ops
    dev = resolve_device(device)
    params0, grid, target = (
        torch.from_numpy(np.stack([problems[i][j] for i in live])).to(dev)
        for j in range(3))
    params, loss = ops.mixture_fit(params0, grid, target, steps, lr)
    params, loss = params.cpu().numpy(), loss.cpu().numpy()
    for row, i in enumerate(live):
        models[i] = mixture_model(hists[i], params[row], float(loss[row]),
                                  fractions[i])
    return models


def fit_interp_model(capacities: Sequence[float],
                     hit_rates: Sequence[float],
                     total_refs: float = 1.0,
                     total_bytes: float = 0.0,
                     origin_fraction: float = 1.0) -> CacheModel:
    """Monotone piecewise-linear spline in log-capacity through exact
    swept ``(capacity, hit_rate)`` points — the model for curves the
    LRU stack does not express (FIFO columns, filtered residue).
    Monotonicity is enforced by a running max over the sorted knots, so
    the fitted curve keeps the property suite's invariants even when
    measurement noise wiggles the inputs."""
    caps = np.asarray(capacities, np.float64)
    hits = np.asarray(hit_rates, np.float64)
    order = np.argsort(caps)
    knots_logc = np.log(np.maximum(caps[order], 1.0))
    knots_hit = np.maximum.accumulate(np.clip(hits[order], 0.0, 1.0))
    return CacheModel(kind="interp", knots_logc=knots_logc,
                      knots_hit=knots_hit, total_refs=float(total_refs),
                      total_bytes=float(total_bytes),
                      origin_fraction=float(origin_fraction))


# ---------------------------------------------------------------------------
# Fleet-stacked evaluation (the planner's objective terms)


@dataclasses.dataclass(frozen=True)
class StackedModels:
    """A fleet of histogram-backed models padded to one ``(N, B)``
    problem, so fleet hit rate / egress at a capacity vector is one
    expression (and its gradient one backward pass)."""

    names: List[str]
    log_centers: np.ndarray    # (N, B)
    ref_weights: np.ndarray    # (N, B)
    byte_weights: np.ndarray   # (N, B)
    total_refs: np.ndarray     # (N,)
    total_bytes: np.ndarray    # (N,)
    compulsory_bytes: np.ndarray  # (N,)
    origin_fraction: np.ndarray   # (N,)
    tau: float


def stack_models(models: Dict[str, CacheModel],
                 tau: Optional[float] = None) -> StackedModels:
    """Pad per-cache histogram models to a common bucket count.

    Only histogram-backed kinds stack (``hist`` and ``mixture`` — both
    carry bucket arrays); ``interp`` models have no buckets and raise.
    Padding buckets carry zero weight, so they change nothing.
    """
    names = sorted(models)
    for n in names:
        if models[n].log_centers is None:
            raise ValueError(
                f"model {n!r} (kind={models[n].kind!r}) has no histogram "
                "buckets; the stacked planner needs hist/mixture models")
    B = max(len(models[n].log_centers) for n in names)
    N = len(names)
    centers = np.zeros((N, B))
    refw = np.zeros((N, B))
    bytew = np.zeros((N, B))
    tot_r = np.zeros(N)
    tot_b = np.zeros(N)
    comp_b = np.zeros(N)
    of = np.ones(N)
    for i, n in enumerate(names):
        mdl = models[n]
        b = len(mdl.log_centers)
        centers[i, :b] = mdl.log_centers
        refw[i, :b] = mdl.ref_weights
        bytew[i, :b] = mdl.byte_weights
        tot_r[i] = mdl.total_refs
        tot_b[i] = mdl.total_bytes
        comp_b[i] = mdl.compulsory_bytes
        of[i] = mdl.origin_fraction
    return StackedModels(
        names=names, log_centers=centers, ref_weights=refw,
        byte_weights=bytew, total_refs=tot_r, total_bytes=tot_b,
        compulsory_bytes=comp_b, origin_fraction=of,
        tau=float(tau if tau is not None
                  else max(m.tau for m in models.values())))


def fleet_hits(stacked: StackedModels, capacities) -> torch.Tensor:
    """Expected hit *count* per cache at a per-cache capacity vector
    ``(N,)`` — torch ops on its device, differentiable."""
    cap = _capacity(capacities)
    dev = cap.device
    z = (_log_capacity(cap)[:, None] - _f64(stacked.log_centers, dev)) \
        / stacked.tau
    return (_f64(stacked.ref_weights, dev) * torch.sigmoid(z)).sum(dim=1)


def fleet_hit_rate(stacked: StackedModels, capacities) -> torch.Tensor:
    """Chunk-level fleet hit rate ``Σ hits_c / Σ refs_c`` at a
    per-cache capacity vector — the quantity the planner constrains
    (matches ``cache_hits / (cache_hits + cache_misses)`` of an exact
    replay, up to bucketing + smoothing error)."""
    hits = fleet_hits(stacked, capacities)
    total = torch.clamp(_f64(stacked.total_refs, hits.device).sum(),
                        min=1.0)
    return hits.sum() / total


def fleet_origin_egress(stacked: StackedModels, capacities) -> torch.Tensor:
    """Expected origin egress bytes at a per-cache capacity vector:
    each cache's missed bytes (reuse misses + compulsory), weighted by
    the share of its misses that pulls from the origin rather than a
    parent tier."""
    cap = _capacity(capacities)
    dev = cap.device
    z = (_log_capacity(cap)[:, None] - _f64(stacked.log_centers, dev)) \
        / stacked.tau
    hit_bytes = (_f64(stacked.byte_weights, dev)
                 * torch.sigmoid(z)).sum(dim=1)
    miss_bytes = _f64(stacked.total_bytes, dev) - hit_bytes
    return (_f64(stacked.origin_fraction, dev) * miss_bytes).sum()


# ---------------------------------------------------------------------------
# The planner's kernels (csrc/cache_model.cu), built at first use
# ---------------------------------------------------------------------------
# What the kernels serve, compiled into the source with -D: caches a plan
# (its state in shared memory on every CTA of its cluster), grid points a
# fit (a thread each) and components a fit (in registers).
PLAN_MAX_CACHES = 2048
MIXTURE_MAX_POINTS, MIXTURE_MAX_COMPONENTS = 256, 8
_vp, _ci, _cd = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
# (kernel_probe.py builds the same source with -DCM_PROBE=1 from these)
DEFINES = {"PLAN_MAX_CACHES": PLAN_MAX_CACHES,
           "MIX_MAX_POINTS": MIXTURE_MAX_POINTS,
           "MIX_MAX_COMPONENTS": MIXTURE_MAX_COMPONENTS}
FLAGS = ("--fmad=false",)
LIB = CudaLibrary("cache_model", {
    "plan_solve": ([_vp] * 5 + [_ci] * 5 + [_vp] * 2, _ci),
    "plan_solve_cluster": ([_ci] * 2, _ci),
    "plan_solve_threads": ([_ci] * 2, _ci),
    "plan_solve_smem_bytes": ([_ci] * 2, ctypes.c_longlong),
    "mixture_fit": ([_vp] * 3 + [_ci] * 4 + [_cd] + [_vp] * 3, _ci)},
    defines=DEFINES, flags=FLAGS)


class _Kernel:
    """A kernel of ``csrc/cache_model.cu``: ``launches`` is raised once per
    launch that the card accepted."""

    def __init__(self) -> None:
        self.launches = 0

    def _launch(self, fn: str, device: torch.device, *args) -> None:
        lib = LIB.load()
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = getattr(lib, fn)(*args, stream)
        LIB.check(err, fn)
        self.launches += 1


class PlanSolveKernel(_Kernel):
    """``plan_solve``: the planner's whole inverse solve, a thread block
    cluster a plan, in one launch (the stacked model read from device
    memory, each CTA its own caches' rows)."""

    def smem_bytes(self, n: int, g: int) -> int:
        return int(LIB.load().plan_solve_smem_bytes(n, g))

    def cluster(self, n: int, g: int) -> int:
        """CTAs a plan of ``n`` caches and ``g`` groups."""
        return int(LIB.load().plan_solve_cluster(n, g))

    def threads(self, n: int, g: int) -> int:
        """Threads a CTA."""
        return int(LIB.load().plan_solve_threads(n, g))

    def __call__(self, stacked: torch.Tensor, per_cache: torch.Tensor,
                 gidx: torch.Tensor, gsize: torch.Tensor,
                 scalars: torch.Tensor, steps: int) -> torch.Tensor:
        """The inputs and output of ``ref.plan_solve_ref``, on one CUDA
        device.  Raises on other inputs and on sizes the kernel does not
        serve: more than ``PLAN_MAX_CACHES`` caches, or more groups than
        caches.  A cache whose group lies outside [0, G) makes its plan's
        row NaN."""
        P, _, n, bk = stacked.shape
        g = gsize.shape[1] if gsize.dim() == 2 else -1
        dev = stacked.device
        if not (1 <= n <= PLAN_MAX_CACHES and 1 <= g <= n and bk >= 1
                and P >= 1):
            raise ValueError(
                f"plan_solve kernel: serves 1 to {PLAN_MAX_CACHES} caches "
                f"and 1 to N groups; got {P} plans of N={n} caches, "
                f"Bk={bk} buckets, G={g} groups")
        f64 = torch.float64
        _check("plan_solve", dev, ("stacked", stacked, f64, (P, 3, n, bk)),
               ("per_cache", per_cache, f64, (P, 3, n)),
               ("gidx", gidx, torch.int64, (P, n)),
               ("gsize", gsize, f64, (P, g)),
               ("scalars", scalars, f64, (P, 8)))
        out = torch.empty(P, g + 4, dtype=f64, device=dev)
        self._launch("plan_solve", dev, stacked.data_ptr(),
                     per_cache.data_ptr(), gidx.data_ptr(), gsize.data_ptr(),
                     scalars.data_ptr(), P, n, bk, g,
                     max(steps // PLAN_ROUNDS, 1), out.data_ptr())
        return out


class MixtureFitKernel(_Kernel):
    """``mixture_fit``: the mixture's whole Adam loop, a block a
    histogram, in one launch."""

    def __call__(self, params0: torch.Tensor, grid: torch.Tensor,
                 target: torch.Tensor, steps: int, lr: float):
        """The inputs and outputs of ``ref.mixture_fit_ref``, on one CUDA
        device.  Raises on other inputs and on sizes the kernel does not
        serve: more than ``MIXTURE_MAX_POINTS`` grid points or
        ``MIXTURE_MAX_COMPONENTS`` components."""
        P, three, k = params0.shape
        m = grid.shape[-1]
        dev = params0.device
        if not (three == 3 and 1 <= k <= MIXTURE_MAX_COMPONENTS
                and 1 <= m <= MIXTURE_MAX_POINTS and P >= 1 and steps >= 0):
            raise ValueError(
                f"mixture_fit kernel: serves 1 to {MIXTURE_MAX_COMPONENTS} "
                f"components over 1 to {MIXTURE_MAX_POINTS} grid points; "
                f"got {P} fits of params {tuple(params0.shape)}, M={m} "
                f"points, {steps} steps")
        f64 = torch.float64
        _check("mixture_fit", dev, ("params0", params0, f64, (P, 3, k)),
               ("grid", grid, f64, (P, m)),
               ("target", target, f64, (P, m)))
        params = torch.empty_like(params0)
        loss = torch.empty(P, dtype=f64, device=dev)
        self._launch("mixture_fit", dev, params0.data_ptr(), grid.data_ptr(),
                     target.data_ptr(), P, m, k, steps, float(lr),
                     params.data_ptr(), loss.data_ptr())
        return params, loss


PLAN_SOLVE = PlanSolveKernel()
MIXTURE_FIT = MixtureFitKernel()
