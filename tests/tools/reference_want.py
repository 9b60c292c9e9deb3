#!/usr/bin/env python3
"""The reference's numbers that ``chip_smoke.py``'s phase J holds the port
to, computed with the JAX package on a CPU, and the spreads that set the
planner's tolerances.

    PYTHONPATH=src JAX_PLATFORMS=cpu \
        python3 tests/tools/reference_want.py [--spreads | --fleet250]

from the repo's root.

Prints one JSON object: for J1 (``benchmarks/bench_plan.py``'s
heterogeneous planner scenario at the full profile) and J2 (a two-tier
OSDF fleet of 4 regions x 6 edges, 28 caches, under a day of zipf
traffic) the fit sweep's counters, the plans' capacities, uniform
capacity, savings, predictions and gradient norm (J2: at target 0.5, and
again with an egress budget halfway between the egress at
``max_capacity`` and the first plan's), the verification blocks, and J3:
the mixture fit's loss of each of J2's histograms.  ``chip_smoke.py``
keeps them as constants (it imports nothing of JAX); this script is how
they were made.  It takes about a minute.

``--spreads`` prints how far three versions of the planner's algorithm
(the reference, the port's plain version on the CPU and the kernels'
numpy models of ``tests/test_torch_cache_model.py``) drift apart: the
inverse solve of 8 random plans with and without a binding egress budget,
and 400-step mixture fits of 12 histograms (a two-tier sweep's and random
streams'); and how often three softmax weights sum above 1 in float64.  ``--fleet250`` plans a homogeneous 250-pod fleet on both
packages (the reference quirk of ROADMAP.md; a few minutes).
"""
from __future__ import annotations

import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]   # the repo
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

COUNTERS = ("requests", "bytes_moved", "cache_hits", "cache_misses",
            "origin_egress_bytes", "parent_fill_bytes", "evictions",
            "bytes_evicted")
OSDF_REGIONS = ("us-east", "us-central", "us-west", "eu")
OSDF_EDGES = 6
OSDF_REQUESTS = 8000
TARGET = 0.5


def hetero_spec(core, **extra):
    """``bench_plan.planner_scenario(quick=False)``: pod0 hot and skewed,
    pod1 cold and diffuse."""
    fed = core.FederationSpec.fleet(num_pods=2, hosts_per_pod=2,
                                    cache_capacity=2e9)
    wl = (core.generate_workload([fed.sites[0].name], 700, seed=0,
                                 working_set=6, zipf_a=1.6)
          + core.generate_workload([fed.sites[1].name], 150, seed=1,
                                   working_set=64, zipf_a=1.05))
    wl.sort(key=lambda r: r.time)
    return core.ScenarioSpec(name="plan-hetero", engine="analytic",
                             federation=fed, workload=wl, **extra)


def osdf_spec(core, **extra):
    return core.ScenarioSpec(
        name="plan-osdf", engine="analytic",
        federation=core.FederationSpec.osdf(regions=OSDF_REGIONS,
                                            edges_per_region=OSDF_EDGES),
        workload=core.WorkloadSpec(kind="zipf", n_requests=OSDF_REQUESTS,
                                   working_set=1000, duration=86400.0),
        **extra)


def plan_numbers(plan) -> dict:
    return {"capacities": dict(plan.capacities),
            "uniform_capacity": plan.uniform_capacity,
            "savings_vs_uniform": plan.savings_vs_uniform,
            "predicted_hit_rate": plan.predicted_hit_rate,
            "predicted_egress_bytes": plan.predicted_egress_bytes,
            "hit_grad_norm": plan.telemetry["hit_grad_norm"]}


def verification(plan) -> dict:
    v = plan.verification
    return {k: v[k] for k in ("feasible", "attempts", "achieved_hit_rate",
                              "achieved_egress_bytes", "executor")}


def main() -> None:
    import conftest  # noqa: F401  (the reference's enable_x64 alias)
    import jax.numpy as jnp
    from jax.experimental import enable_x64

    import repro.core as core
    from repro.kernels.cache_model import (ReuseHistogram,
                                           fit_lognormal_mixture,
                                           fleet_origin_egress, stack_models)
    out = {}
    # J1
    base = hetero_spec(core)
    rep = core.run_sweep(core.SweepSpec(name="j1", base=base, axes={}),
                         fit=True)
    models = rep.fitted_models()
    groups = core.groups_for_federation(base.federation.build(), models)
    plan = core.plan_capacity(core.PlannerSpec(
        models=models, target_hit_rate=TARGET, groups=groups))
    out["J1"] = {**plan_numbers(plan),
                 "verification": verification(core.verify_plan(plan, base))}
    # J2
    base = osdf_spec(core)
    rep = core.run_sweep(core.SweepSpec(name="j2", base=base, axes={}),
                         fit=True)
    cell = rep.cells[0]
    models = rep.fitted_models()
    fed = base.federation.build()
    groups = core.groups_for_federation(fed, models)
    spec = core.PlannerSpec(models=models, target_hit_rate=TARGET,
                            groups=groups)
    plan = core.plan_capacity(spec)
    stacked = stack_models(models)
    with enable_x64():
        egress_max = float(fleet_origin_egress(
            stacked, jnp.full(len(stacked.names), spec.max_capacity,
                              jnp.float64)))
    budget = 0.5 * (egress_max + plan.predicted_egress_bytes)
    budgeted = core.plan_capacity(core.PlannerSpec(
        models=models, target_hit_rate=TARGET, groups=groups,
        target_egress_bytes=budget))
    hists = rep.reuse_histograms()
    losses = {}
    for name in sorted(hists):
        fit = fit_lognormal_mixture(ReuseHistogram.from_dict(hists[name]))
        losses[name] = fit.fit_loss
    out["J2"] = {"caches": len(models), "groups": len(groups),
                 "counters": {k: cell.summary[k] for k in COUNTERS},
                 "fit_streams": rep.solver["fit_streams"],
                 "plan": plan_numbers(plan),
                 "egress_at_max_capacity": egress_max, "budget": budget,
                 "budget_plan": plan_numbers(budgeted),
                 "verification": verification(core.verify_plan(plan, base))}
    out["J3"] = {"mixture_loss": losses}
    print(json.dumps(out, indent=1))


def spreads() -> None:
    """The worst differences between the reference (R), the port's plain
    version (P) and the kernels' numpy models (M)."""
    import conftest  # noqa: F401
    sys.path.insert(0, str(ROOT / "tests"))
    import numpy as np
    import torch

    import test_torch_cache_model as t
    import test_torch_planner as tp
    from repro.core import planner as rplanner
    from repro.kernels import cache_model as rcm
    import repro_torch.core as core
    from repro_torch.kernels import cache_model as cm
    from repro_torch.kernels import ref

    keys = ("stacked", "per_cache", "gidx", "gsize", "scalars")
    for budget in (False, True):
        worst = {}
        for seed in range(8):
            inp, spec = t.plan_inputs(seed)
            if budget:
                inp["scalars"][0, 1] = t.egress_budget(inp)
            args = [inp[k] for k in keys]
            plain = ref.plan_solve_ref(*[torch.from_numpy(a) for a in args],
                                       spec.steps)[0].numpy()
            model = t.PlanModel(*(a[0] for a in args)).solve(spec.steps)
            models = {k: t.to_ref(rcm, m) for k, m in spec.models.items()}
            names = sorted(models)
            groups = {f"g{g}": [n for i, n in enumerate(names)
                                if inp["gidx"][0, i] == g]
                      for g in range(inp["gsize"].shape[1])}
            rep = rplanner.plan_capacity(rplanner.PlannerSpec(
                models=models, target_hit_rate=spec.target_hit_rate,
                target_egress_bytes=(float(inp["scalars"][0, 1])
                                     if budget else None), groups=groups))
            rrow = np.array([rep.capacities[g] for g in sorted(groups)] + [
                rep.uniform_capacity, rep.predicted_hit_rate,
                rep.predicted_egress_bytes, rep.telemetry["hit_grad_norm"]])
            gsize = inp["gsize"][0]
            for pair, (a, b) in (("R-P", (rrow, plain)),
                                 ("M-P", (model, plain))):
                for k, v in t.plan_errors(a, b, gsize).items():
                    worst[(pair, k)] = max(worst.get((pair, k), 0.0), v)
        print(json.dumps({"plan": "budget" if budget else "no budget",
                          **{f"{p} {k}": v for (p, k), v in worst.items()}}))
    rep = core.run_sweep(core.SweepSpec(name="mix", base=tp.osdf_spec(
        core, n_requests=300), axes={}), fit=True)
    hists = [cm.ReuseHistogram.from_dict(d)
             for d in rep.reuse_histograms().values()]
    hists += [cm.reuse_histogram(*t.random_stream(s)) for s in range(6)]
    worst = {}
    for h in hists:
        problem = cm.mixture_problem(h)
        if problem is None:
            continue
        p, loss = ref.mixture_fit_ref(*[torch.from_numpy(a[None])
                                        for a in problem], 400, 0.08)
        r = rcm.fit_lognormal_mixture(rcm.ReuseHistogram.from_dict(
            h.to_dict()))
        rp = np.stack([r.mix_logits, r.mix_mu, r.mix_log_sigma])
        mp, ml = t.model_mixture_fit(*problem, 400, 0.08)
        for pair, (a, la, b, lb) in (
                ("R-P", (rp, r.fit_loss, p[0].numpy(), float(loss[0]))),
                ("M-P", (mp, ml, p[0].numpy(), float(loss[0])))):
            g = torch.from_numpy(problem[1])
            err = {"param": float(np.abs(a - b).max()),
                   "cdf": float((cm._mixture_cdf(g, *torch.from_numpy(a))
                                 - cm._mixture_cdf(g, *torch.from_numpy(b))
                                 ).abs().max()),
                   "loss": abs(la / lb - 1.0)}
            for k, v in err.items():
                worst[(pair, k)] = max(worst.get((pair, k), 0.0), v)
    print(json.dumps({"mixture": f"{len(hists)} histograms, 400 steps",
                      **{f"{p} {k}": v for (p, k), v in worst.items()}}))
    # where every erf is 1 a mixture's curve is the sum of its weights
    logits = torch.from_numpy(np.random.default_rng(0).normal(0, 1,
                                                              (200000, 3)))
    shares = {}
    for name, pis in (("division", ref.softmax(logits)),
                      ("torch.softmax", torch.softmax(logits, dim=-1))):
        total = pis[:, 0] + pis[:, 1] + pis[:, 2]
        shares[name] = float((total > 1.0).double().mean())
    print(json.dumps({"softmax weights summing above 1, 200,000 random "
                      "logit triples": shares}))


def fleet250() -> None:
    """The homogeneous 250-pod plan at target 0.3 on both packages."""
    import conftest  # noqa: F401
    import repro.core as rcore
    import repro_torch.core as core
    out = {}
    for name, C, extra in (("reference", rcore, {}),
                           ("port", core, {"device": "cpu"})):
        base = C.ScenarioSpec(
            name="fleet250", engine="analytic",
            federation=C.FederationSpec.fleet(250, 4),
            workload=C.WorkloadSpec(kind="zipf", n_requests=20000), **extra)
        rep = C.run_sweep(C.SweepSpec(name="fleet250", base=base, axes={}),
                          fit=True)
        models = rep.fitted_models()
        plan = C.plan_capacity(C.PlannerSpec(
            models=models, target_hit_rate=0.3,
            groups=C.groups_for_federation(base.federation.build(), models)),
            **extra)
        out[name] = {"savings_vs_uniform": plan.savings_vs_uniform,
                     "total_over_uniform": plan.total_capacity
                     / plan.uniform_total}
    print(json.dumps(out))


if __name__ == "__main__":
    if "--spreads" in sys.argv:
        spreads()
    elif "--fleet250" in sys.argv:
        fleet250()
    else:
        main()
