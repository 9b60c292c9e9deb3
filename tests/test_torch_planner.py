"""The port's planner (``repro_torch.core.planner``) and ``run_sweep(fit=
...)``, on the CPU.

Part one mirrors the reference's ``tests/test_planner.py`` case for case
(its 19 tests) on the port with ``device="cpu"``: fitted models and
histograms, forward accuracy against exact replays, gradient flow, the
aggregator's surfaces, and the inverse planner with its exact-replay
verification.  Its bounds are the reference's own.

Part two holds the port to the reference on the same inputs:

* a ``fit=True`` sweep's histograms equal the reference's exactly, its
  models' arrays too, and its counters equal the same sweep without
  ``fit`` (the products ride on the cells, not in ``summary``);
* plans (the heterogeneous two-pod scenario of ``bench_plan.py``, a small
  two-tier OSDF fleet with and without an egress budget, an infeasible
  target) agree with the reference's within 1e-9 relative — the budget's
  bounds are ``test_torch_cache_model.BUDGET_TOL``, the spread of the
  reference's own algorithm when the budget binds — and their
  verification blocks are equal;
* ``fit="mixture"`` models agree with the reference's within
  ``test_torch_cache_model.MIX_TOL`` (curve, parameters and loss).

The ``gpu`` tests run the planner's path on the card: a fit sweep, a
plan through the ``plan_solve`` kernel against the CPU's plain version,
and a mixture sweep through ``mixture_fit``.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

import repro_torch.core as T
from repro_torch.kernels import cache_model as cm
from test_torch_cache_model import (BUDGET_TOL, MODEL_RTOL,
                                    assert_mixture_close, assert_plan_close,
                                    plan_errors)

CAP_AXIS = "federation.cache_capacity"
PARITY_KEYS = ("requests", "bytes_moved", "cache_hits", "cache_misses",
               "origin_egress_bytes", "parent_fill_bytes", "evictions",
               "bytes_evicted", "admission_rejects", "tier_hits",
               "tier_misses", "tier_fill_bytes")
CPU = "cpu"


@pytest.fixture(scope="module")
def R():
    pytest.importorskip("jax", reason="the JAX reference is not installed")
    import repro.core as ref_core
    return ref_core


def chunk_hit(summary):
    """Chunk-level hit rate — the fraction the models predict (the
    request-level ``summary['hit_rate']`` mixes multi-chunk files)."""
    refs = summary["cache_hits"] + summary["cache_misses"]
    return summary["cache_hits"] / max(refs, 1)


def device_kw(C):
    return {"device": CPU} if C is T else {}


def base_spec(C=T, n_requests=260, **fed_kw):
    fed_kw.setdefault("num_pods", 2)
    fed_kw.setdefault("hosts_per_pod", 2)
    fed_kw.setdefault("cache_capacity", 2e9)
    return C.ScenarioSpec(
        name="cell", engine="analytic",
        federation=C.FederationSpec.fleet(**fed_kw),
        workload=C.WorkloadSpec(kind="zipf", n_requests=n_requests,
                                working_set=8, duration=600.0, seed=5),
        **device_kw(C))


def hetero_spec(C=T):
    """Two pods with very different locality: pod0 hot and skewed,
    pod1 mostly cold — the planner should starve pod1 (``bench_plan``'s
    ``planner_scenario`` at its full profile, as the reference's test
    sizes it)."""
    fed = C.FederationSpec.fleet(num_pods=2, hosts_per_pod=2,
                                 cache_capacity=2e9)
    wl = (C.generate_workload([fed.sites[0].name], 700, seed=0,
                              working_set=6, zipf_a=1.6)
          + C.generate_workload([fed.sites[1].name], 150, seed=1,
                                working_set=64, zipf_a=1.05))
    wl.sort(key=lambda r: r.time)
    return C.ScenarioSpec(name="hetero", engine="analytic",
                          federation=fed, workload=wl, **device_kw(C))


def osdf_spec(C=T, n_requests=600):
    """A small two-tier OSDF fleet: 2 regions of 2 edges under a backbone
    each (6 caches), whose parent streams take the fit's second round."""
    return C.ScenarioSpec(
        name="osdf", engine="analytic",
        federation=C.FederationSpec.osdf(regions=("us-east", "eu"),
                                         edges_per_region=2),
        workload=C.WorkloadSpec(kind="zipf", n_requests=n_requests,
                                working_set=40, duration=3600.0, seed=3),
        **device_kw(C))


@pytest.fixture(scope="module")
def fit_report():
    grid = list(np.geomspace(4e8, 2e10, 6))
    return T.run_sweep(T.SweepSpec(name="fit", base=base_spec(),
                                   axes={CAP_AXIS: grid}), fit=True)


@pytest.fixture(scope="module")
def hetero_fit():
    base = hetero_spec()
    rep = T.run_sweep(T.SweepSpec(name="hfit", base=base, axes={}), fit=True)
    return base, rep


# ---------------------------------------------------------------------------
# Part one: the reference's tests/test_planner.py on the port
# ---------------------------------------------------------------------------
class TestFitSweep:
    def test_fit_attaches_models_and_histograms(self, fit_report):
        models = fit_report.fitted_models()
        hists = fit_report.reuse_histograms()
        assert models and set(models) == set(hists)
        assert all(m.kind == "hist" for m in models.values())
        assert fit_report.summary()["fitted_cells"] == len(fit_report.cells)
        assert fit_report.summary()["solver"]["fit_streams"] >= len(models)
        json.dumps(hists)

    def test_fit_off_by_default(self):
        rep = T.run_sweep(T.SweepSpec(name="nofit", base=base_spec(n_requests=60),
                                      axes={}))
        assert rep.fitted_models() == {}
        assert rep.reuse_histograms() == {}
        assert rep.summary()["fitted_cells"] == 0

    def test_histogram_conservation(self, fit_report):
        """Bucketed mass + compulsory mass = totals, exactly."""
        for d in fit_report.reuse_histograms().values():
            h = cm.ReuseHistogram.from_dict(d)
            assert h.ref_weights.sum() + h.compulsory_refs == pytest.approx(
                h.total_refs)
            assert h.byte_weights.sum() + h.compulsory_bytes == (
                pytest.approx(h.total_bytes, rel=1e-9))

    def test_histogram_roundtrip(self):
        rng = np.random.default_rng(0)
        dist = rng.exponential(1e9, 500)
        dist[rng.random(500) < 0.2] = np.inf
        sizes = rng.integers(1, 1e8, 500).astype(float)
        h = cm.reuse_histogram(dist, sizes)
        h2 = cm.ReuseHistogram.from_dict(h.to_dict())
        np.testing.assert_allclose(h2.edges, h.edges)
        np.testing.assert_allclose(h2.ref_weights, h.ref_weights)
        assert h2.total_refs == h.total_refs


class TestForwardAccuracy:
    def test_heldout_grid_within_two_percent(self, fit_report):
        models = fit_report.fitted_models()
        errs = [abs(T.predict(models, c.params[CAP_AXIS], device=CPU)
                    ["hit_rate"] - chunk_hit(c.summary))
                for c in fit_report.cells]
        assert max(errs) <= 0.02

    def test_mixture_compact_signature(self, fit_report):
        hists = {k: cm.ReuseHistogram.from_dict(d)
                 for k, d in fit_report.reuse_histograms().items()}
        models = {k: cm.fit_lognormal_mixture(h, device=CPU)
                  for k, h in hists.items()}
        assert all(m.kind == "mixture" for m in models.values())
        errs = [abs(T.predict(models, c.params[CAP_AXIS], device=CPU)
                    ["hit_rate"] - chunk_hit(c.summary))
                for c in fit_report.cells]
        assert max(errs) <= 0.04

    def test_fifo_interp_heldout(self):
        spec = base_spec()
        fed = dataclasses.replace(spec.federation, sites=[
            dataclasses.replace(s, eviction_policy="fifo")
            if s.has_cache else s for s in spec.federation.sites])
        spec = dataclasses.replace(spec, federation=fed)
        grid = list(np.geomspace(4e8, 2e10, 13))
        rep = T.run_sweep(T.SweepSpec(name="fifo", base=spec,
                                      axes={CAP_AXIS: grid}))
        pts = [(c.params[CAP_AXIS], chunk_hit(c.summary)) for c in rep.cells]
        train, held = pts[::2], pts[1::2]
        model = cm.fit_interp_model([p[0] for p in train],
                                    [p[1] for p in train])
        errs = [abs(float(cm.predict_hit_rate(model, cap)) - h)
                for cap, h in held]
        assert max(errs) <= 0.06

    def test_interp_exact_at_knots(self):
        model = cm.fit_interp_model([1e9, 4e9, 1e10], [0.1, 0.4, 0.6])
        for cap, h in ((1e9, 0.1), (4e9, 0.4), (1e10, 0.6)):
            assert float(cm.predict_hit_rate(model, cap)) == pytest.approx(
                h, abs=1e-6)
        assert float(cm.predict_hit_rate(model, 1e6)) == pytest.approx(0.1)
        assert float(cm.predict_hit_rate(model, 1e14)) == pytest.approx(0.6)

    def test_miss_bytes_complements_hits(self, fit_report):
        for m in fit_report.fitted_models().values():
            tiny = float(cm.predict_miss_bytes(m, 1.0))
            huge = float(cm.predict_miss_bytes(m, 1e18))
            assert tiny == pytest.approx(m.total_bytes, rel=1e-3)
            assert huge == pytest.approx(m.compulsory_bytes, rel=1e-3)


class TestGradients:
    def test_grad_flows_through_fleet_hit_rate(self, fit_report):
        stacked = cm.stack_models(fit_report.fitted_models())
        logc = torch.full((len(stacked.names),), np.log(2e9),
                          dtype=torch.float64, requires_grad=True)
        g, = torch.autograd.grad(cm.fleet_hit_rate(stacked, torch.exp(logc)),
                                 logc)
        assert torch.isfinite(g).all()
        assert (g > 0).all()   # more capacity never hurts

    def test_predict_matches_stacked(self, fit_report):
        models = fit_report.fitted_models()
        stacked = cm.stack_models(models)
        caps = {n: 3e9 for n in models}
        fleet = float(cm.fleet_hit_rate(stacked, torch.tensor(
            [caps[n] for n in stacked.names], dtype=torch.float64)))
        assert T.predict(models, caps, device=CPU)["hit_rate"] == \
            pytest.approx(fleet, abs=1e-5)


class TestAggregatorSurfaces:
    def _agg(self):
        agg = T.SweepAggregator()
        for policy in ("lru", "fifo"):
            for i, cap in enumerate((1e9, 2e9, 4e9)):
                agg.add({"federation.eviction_policy": policy,
                         CAP_AXIS: cap},
                        {"hit_rate": 0.2 + 0.1 * i
                         + (0.05 if policy == "lru" else 0.0),
                         "evictions": 10, "bytes_evicted": 100,
                         "admission_rejects": 0})
        return agg

    def test_hit_rate_curve_matches_policy_marginals(self):
        agg = self._agg()
        curves = {c[0]["federation.eviction_policy"]: c[1]
                  for c in agg.hit_rate_curve()}
        marginals = {row[0]: row[2] for row in agg.policy_marginals()}
        assert set(curves) == set(marginals)
        for policy, pts in curves.items():
            assert [p[0] for p in pts] == [1e9, 2e9, 4e9]
            mean = sum(v for _, v in pts) / len(pts)
            assert mean == pytest.approx(marginals[policy])

    def test_hit_rate_curve_no_capacity_axis(self):
        agg = T.SweepAggregator()
        agg.add({"workload.seed": 1}, {"hit_rate": 0.5})
        assert agg.hit_rate_curve() == []

    def test_model_residuals(self):
        agg = self._agg()

        def pred(params):
            if params["federation.eviction_policy"] != "lru":
                return None
            return 0.3

        rows = agg.model_residuals(pred)
        assert len(rows) == 3
        for params, observed, predicted, residual in rows:
            assert predicted == 0.3
            assert residual == pytest.approx(predicted - observed)


class TestInversePlanner:
    def test_plan_feasible_and_beats_uniform(self, hetero_fit):
        base, rep = hetero_fit
        models = rep.fitted_models()
        groups = T.groups_for_federation(base.federation.build(), models)
        plan = T.plan_capacity(T.PlannerSpec(models=models,
                                             target_hit_rate=0.5,
                                             groups=groups), device=CPU)
        assert plan.predicted_hit_rate >= 0.5
        assert set(plan.capacities) == set(groups)
        assert set(plan.per_cache) == set(models)
        ver = T.verify_plan(plan, base)
        assert ver.verification["feasible"]
        assert ver.verification["achieved_hit_rate"] >= 0.5
        assert ver.verification["executor"] == "batched"
        assert ver.savings_vs_uniform > 0.2
        assert ver.total_capacity < ver.uniform_total

    def test_plan_summary_schema(self, hetero_fit):
        base, rep = hetero_fit
        plan = T.plan_capacity(T.PlannerSpec(models=rep.fitted_models(),
                                             target_hit_rate=0.4),
                               federation=base.federation.build(),
                               device=CPU)
        s = T.verify_plan(plan, base).summary()
        for key in ("capacities", "per_cache", "predicted_hit_rate",
                    "total_capacity", "uniform_total",
                    "savings_vs_uniform", "verification", "telemetry"):
            assert key in s
        assert s["verification"]["feasible"] in (True, False)
        json.dumps(s)

    def test_infeasible_target_reported_not_hidden(self, hetero_fit):
        base, rep = hetero_fit
        plan = T.plan_capacity(T.PlannerSpec(models=rep.fitted_models(),
                                             target_hit_rate=0.99),
                               device=CPU)
        ver = T.verify_plan(plan, base, max_attempts=2)
        assert not ver.verification["feasible"]
        assert ver.verification["attempts"] == 2

    def test_apply_capacities_roundtrip(self, hetero_fit):
        base, _ = hetero_fit
        caps = {s.name: 7e9 for s in base.federation.sites}
        fed = T.apply_capacities(base.federation, caps)
        assert all(s.cache_capacity == 7e9 for s in fed.sites
                   if s.name in caps)
        assert base.federation.sites[0].cache_capacity == 2e9

    def test_egress_budget_constrains(self, hetero_fit):
        _, rep = hetero_fit
        models = rep.fitted_models()
        loose = T.plan_capacity(T.PlannerSpec(models=models,
                                              target_hit_rate=0.4),
                                device=CPU)
        tight = T.plan_capacity(T.PlannerSpec(
            models=models, target_hit_rate=0.4,
            target_egress_bytes=loose.predicted_egress_bytes * 0.8),
            device=CPU)
        assert tight.predicted_egress_bytes <= (
            loose.predicted_egress_bytes * 0.8 * 1.02)
        assert tight.total_capacity >= loose.total_capacity * 0.99


# ---------------------------------------------------------------------------
# Part two: the port against the reference on the same inputs
# ---------------------------------------------------------------------------
def plan_vector(plan, gsize_order):
    """A PlanReport as the solve's output row (G + 4,)."""
    return np.array([plan.capacities[g] for g in gsize_order]
                    + [plan.uniform_capacity, plan.predicted_hit_rate,
                       plan.predicted_egress_bytes,
                       plan.telemetry["hit_grad_norm"]])


def assert_reports_close(got, want, budget=False):
    """Plans of groups of one cache each (every case here) within the
    solve's bounds."""
    names = sorted(want.capacities)
    assert sorted(got.capacities) == names
    assert got.per_cache.keys() == want.per_cache.keys()
    assert_plan_close(plan_vector(got, names), plan_vector(want, names),
                      np.ones(len(names)), budget)
    tol = BUDGET_TOL["total"] if budget else MODEL_RTOL
    assert got.savings_vs_uniform == pytest.approx(want.savings_vs_uniform,
                                                   rel=tol, abs=tol)
    assert got.telemetry.keys() == want.telemetry.keys()


def verification_block(plan):
    v = dict(plan.verification)
    v.pop("scale_applied")
    return v


@pytest.fixture(scope="module")
def osdf_pair(R):
    """The small OSDF fleet's fit sweep on both packages."""
    out = {}
    for C in (R, T):
        base = osdf_spec(C)
        out[C] = (base, C.run_sweep(C.SweepSpec(name="osdf", base=base,
                                                axes={}), fit=True))
    return out


@pytest.fixture(scope="module")
def hetero_pair(R, hetero_fit):
    base = hetero_spec(R)
    rep = R.run_sweep(R.SweepSpec(name="hfit", base=base, axes={}), fit=True)
    return {R: (base, rep), T: hetero_fit}


def _models_equal(got, want):
    assert sorted(got) == sorted(want)
    for name in want:
        for f in dataclasses.fields(want[name]):
            a, b = getattr(got[name], f.name), getattr(want[name], f.name)
            if isinstance(b, np.ndarray):
                np.testing.assert_array_equal(a, b)
            else:
                assert a == b, (name, f.name)


@pytest.mark.parametrize("which", ["hetero", "osdf"])
def test_fit_sweep_equals_reference(R, hetero_pair, osdf_pair, which):
    pair = hetero_pair if which == "hetero" else osdf_pair
    (_, want), (_, got) = pair[R], pair[T]
    assert got.reuse_histograms() == want.reuse_histograms()
    _models_equal(got.fitted_models(), want.fitted_models())
    assert got.solver["fit_streams"] == want.solver["fit_streams"]
    for k in PARITY_KEYS:
        assert got.cells[0].summary[k] == want.cells[0].summary[k], k


def test_fit_products_change_no_counter(osdf_pair):
    """The models ride on the cells: a fit sweep's counters equal the same
    sweep's without ``fit``."""
    base, fitted = osdf_pair[T]
    plain = T.run_sweep(T.SweepSpec(name="osdf", base=base, axes={}))
    assert fitted.cells[0].summary == plain.cells[0].summary
    assert fitted.cells[0].pricing == plain.cells[0].pricing
    assert "fit_streams" not in plain.solver
    assert fitted.fitted_models() and plain.fitted_models() == {}


def test_two_tier_fit_covers_both_tiers(osdf_pair):
    """Edge caches fit from their own streams and backbones from the
    merged parent streams of the second round, which miss straight to the
    origin."""
    _, rep = osdf_pair[T]
    models = rep.fitted_models()
    backbones = [n for n in models if "backbone" in n]
    edges = [n for n in models if "edge" in n]
    assert len(backbones) == 2 and len(edges) == 4
    assert all(models[n].origin_fraction == 1.0 for n in backbones)
    assert rep.solver["tier_rounds"] == 2


PLAN_CASES = {"hetero 0.5": ("hetero", 0.5, None, True),
              "hetero 0.4 per cache": ("hetero", 0.4, None, False),
              "osdf 0.4": ("osdf", 0.4, None, True),
              "osdf 0.4 budget": ("osdf", 0.4, "half", True),
              "hetero 0.99 infeasible": ("hetero", 0.99, None, True)}


@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_plan_and_verification_equal_reference(R, hetero_pair, osdf_pair,
                                               case):
    which, target, budget, by_site = PLAN_CASES[case]
    pair = hetero_pair if which == "hetero" else osdf_pair
    reports = {}
    for C in (R, T):
        base, rep = pair[C]
        models = rep.fitted_models()
        groups = (C.groups_for_federation(base.federation.build(), models)
                  if by_site else None)
        spec = C.PlannerSpec(models=models, target_hit_rate=target,
                             groups=groups)
        kw = device_kw(C)
        if budget:
            # halfway between the egress at max_capacity and the plan's
            stacked = cm.stack_models(pair[T][1].fitted_models())
            at_max = float(cm.fleet_origin_egress(stacked, torch.full(
                (len(stacked.names),), spec.max_capacity,
                dtype=torch.float64)))
            free = T.plan_capacity(dataclasses.replace(
                spec, models=pair[T][1].fitted_models()), device=CPU)
            spec = dataclasses.replace(spec, target_egress_bytes=0.5 * (
                at_max + free.predicted_egress_bytes))
        plan = C.plan_capacity(spec, **kw)
        reports[C] = (plan, C.verify_plan(plan, base, max_attempts=2))
    assert_reports_close(reports[T][0], reports[R][0], budget=bool(budget))
    if not budget:
        assert verification_block(reports[T][1]) == \
            verification_block(reports[R][1])
    else:
        assert reports[T][1].verification["feasible"] == \
            reports[R][1].verification["feasible"]
    if "infeasible" in case:
        assert not reports[T][1].verification["feasible"]


def assert_mixture_sweeps_close(R, spec) -> None:
    """``run_sweep(fit="mixture")`` of ``spec(C)`` on both packages: the
    same histograms, and every model within ``MIX_TOL``."""
    reps = {C: C.run_sweep(C.SweepSpec(name="mix", base=spec(C), axes={}),
                           fit="mixture") for C in (R, T)}
    got, want = reps[T].fitted_models(), reps[R].fitted_models()
    assert sorted(got) == sorted(want)
    hists = reps[T].reuse_histograms()
    assert hists == reps[R].reuse_histograms()
    for name in want:
        assert got[name].kind == "mixture"
        assert_mixture_close(mixture_params(got[name]), got[name].fit_loss,
                             mixture_params(want[name]),
                             want[name].fit_loss, mixture_grid(hists[name]))


def test_mixture_fit_sweep_equals_reference(R, osdf_pair):
    assert_mixture_sweeps_close(R, lambda C: osdf_spec(C, n_requests=300))


def test_mixture_fit_sweep_hetero_equals_reference(R):
    """The flat fleet's streams, fitted in one call, against the
    reference's fits one at a time."""
    assert_mixture_sweeps_close(R, hetero_spec)


@pytest.mark.parametrize("which", ["hetero", "osdf"])
def test_mixture_sweep_fits_a_round_in_one_call(monkeypatch, which):
    """``run_sweep(fit="mixture")`` fits each kernel round's streams in one
    ``ops.mixture_fit`` call (the flat fleet one round, the two-tier fleet
    two), and every model equals its stream's histogram fitted alone, bit
    for bit."""
    from repro_torch.kernels import ops
    calls = []
    real = ops.mixture_fit

    def counted(params0, *args):
        calls.append(params0.shape[0])
        return real(params0, *args)
    monkeypatch.setattr(ops, "mixture_fit", counted)
    base = hetero_spec(T) if which == "hetero" else osdf_spec(
        T, n_requests=300)
    rep = T.run_sweep(T.SweepSpec(name="mix", base=base, axes={}),
                      fit="mixture")
    hists = rep.reuse_histograms()
    live = [n for n, h in hists.items() if cm.mixture_problem(
        cm.ReuseHistogram.from_dict(h)) is not None]
    assert len(calls) == (1 if which == "hetero" else 2)
    assert sum(calls) == len(live) == rep.solver["fit_streams"]
    calls.clear()
    for name, model in rep.fitted_models().items():
        alone = cm.fit_lognormal_mixture(
            cm.ReuseHistogram.from_dict(hists[name]),
            origin_fraction=model.origin_fraction, device=CPU)
        np.testing.assert_array_equal(mixture_params(model),
                                      mixture_params(alone))
        assert model.fit_loss == alone.fit_loss
        assert model.origin_fraction == alone.origin_fraction
    assert calls == [1] * len(live)


def mixture_params(model):
    return np.stack([model.mix_logits, model.mix_mu, model.mix_log_sigma])


def mixture_grid(hist_dict):
    problem = cm.mixture_problem(cm.ReuseHistogram.from_dict(hist_dict))
    return np.zeros(1) if problem is None else problem[1]


def test_plan_errors_control():
    """The tolerance check fails on a plan moved by more than it allows."""
    want = np.array([1e9, 2e9, 3e9, 0.5, 1e12, 0.3])
    got = want.copy()
    got[0] *= 1.0 + 2e-9
    assert plan_errors(got, want, np.ones(2))["capacity"] > MODEL_RTOL
    with pytest.raises(AssertionError):
        assert_plan_close(got, want, np.ones(2), False)


def test_planner_entry_points_default_to_the_card(monkeypatch, hetero_fit):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    models = hetero_fit[1].fitted_models()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.plan_capacity(T.PlannerSpec(models=models, target_hit_rate=0.5))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.predict(models, 1e9)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("budget", [False, True])
def test_plan_on_card_equals_cpu(card, budget):
    base = dataclasses.replace(osdf_spec(T), device=card)
    rep = T.run_sweep(T.SweepSpec(name="osdf", base=base, axes={}), fit=True)
    cpu = T.run_sweep(T.SweepSpec(name="osdf", base=osdf_spec(T), axes={}),
                      fit=True)
    assert rep.reuse_histograms() == cpu.reuse_histograms()
    models = rep.fitted_models()
    spec = T.PlannerSpec(models=models, target_hit_rate=0.4, groups=(
        T.groups_for_federation(base.federation.build(), models)))
    if budget:
        free = T.plan_capacity(spec, device=CPU)
        spec = dataclasses.replace(
            spec, target_egress_bytes=free.predicted_egress_bytes * 0.999)
    before = cm.PLAN_SOLVE.launches
    got = T.plan_capacity(spec)
    assert cm.PLAN_SOLVE.launches == before + 1
    want = T.plan_capacity(spec, device=CPU)
    assert_reports_close(got, want, budget=budget)
    ver = T.verify_plan(got, base)
    assert ver.verification["feasible"]


@pytest.mark.gpu
def test_mixture_sweep_on_card_equals_cpu(card):
    base = dataclasses.replace(osdf_spec(T, n_requests=300), device=card)
    before = cm.MIXTURE_FIT.launches
    rep = T.run_sweep(T.SweepSpec(name="mix", base=base, axes={}),
                      fit="mixture")
    got = rep.fitted_models()
    # one launch a kernel round: the edges', then the backbones'
    assert cm.MIXTURE_FIT.launches - before == rep.solver["tier_rounds"] == 2
    cpu = T.run_sweep(T.SweepSpec(name="mix", base=osdf_spec(
        T, n_requests=300), axes={}), fit="mixture")
    want, hists = cpu.fitted_models(), cpu.reuse_histograms()
    for name in want:
        assert_mixture_close(mixture_params(got[name]), got[name].fit_loss,
                             mixture_params(want[name]),
                             want[name].fit_loss, mixture_grid(hists[name]))
