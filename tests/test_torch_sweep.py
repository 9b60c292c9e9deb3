"""The port's batched sweeps (``repro_torch.core.run_sweep``) against the
JAX reference's, on the CPU.

Each sweep is built twice from the same parameters, once from each
package's classes, and run by both ``run_sweep``s; the port's kernels run
on ``device="cpu"`` (the plain versions of the three scans and the
batched max-min solver as torch ops).  Mirroring ``tests/test_sweep.py``
and ``tests/test_tiers.py``:

* every cell's counters (hits, misses, bytes, egress, evictions, bytes
  evicted, admission rejects, failovers, outages, per-tier tallies) are
  equal to the reference's, and so are the executors and the ``solver``
  telemetry, key for key (the wall seconds aside);
* floats — the summaries' seconds and hit rate, and the ``pricing``
  gauges of the batched solver — agree within 1e-4 relative (the solver
  works in float32 and sums its segments in another order);
* the port's own batched cells equal its serial executor's byte for byte,
  as the reference's do.

Sweeps: an eviction sweep (capacity × policy × admission, with
``admission_rejects``), outage cells whose LRU streams reach the slot
machine (``cache_sim_batch``), routing axes with outages, cells that fall
back to the serial executor (sim engine, proxy method, LFU/TTL, a control
plane), and a two-tier OSDF split-sizing sweep whose parent streams take
the second kernel round.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

import repro_torch.core as T
from repro_torch.kernels import batched_maxmin

PARITY_INTS = ("requests", "completed", "bytes_moved", "cache_hits",
               "cache_misses", "origin_egress_bytes", "parent_fill_bytes",
               "evictions", "bytes_evicted", "admission_rejects",
               "cache_failovers", "origin_fallbacks", "group_failovers",
               "outages", "recoveries")
PARITY_DICTS = ("tier_hits", "tier_misses", "tier_fill_bytes")
PARITY_FLOATS = ("hit_rate", "mean_seconds", "p50_seconds", "p95_seconds")
RTOL = 1e-4
GB = 1000**3


@pytest.fixture(scope="module")
def R():
    pytest.importorskip("jax", reason="the JAX reference is not installed")
    import repro.core as ref_core
    return ref_core


def base_spec(C, n_requests=24, seed=5, **fed_kw):
    fed_kw.setdefault("num_pods", 2)
    fed_kw.setdefault("hosts_per_pod", 2)
    extra = {"device": "cpu"} if C is T else {}
    return C.ScenarioSpec(
        name="cell", engine="analytic",
        federation=C.FederationSpec.fleet(**fed_kw),
        workload=C.WorkloadSpec(kind="zipf", n_requests=n_requests,
                                working_set=8, duration=600.0, seed=seed),
        **extra)


def osdf_spec(C, n_requests=60):
    extra = {"device": "cpu"} if C is T else {}
    return C.ScenarioSpec(
        name="tiered", engine="analytic",
        federation=C.FederationSpec.osdf(edges_per_region=2,
                                         workers_per_edge=2,
                                         l1_capacity=4 * GB,
                                         l2_capacity=24 * GB),
        workload=C.WorkloadSpec(kind="zipf", n_requests=n_requests,
                                working_set=12, duration=600.0, seed=11),
        **extra)


SWEEPS = {
    # the reference's eviction regime: heavy churn at the small
    # capacities, size-aware admission refusing at 0.3
    "evict": (lambda C: base_spec(C, n_requests=40), {
        "federation.cache_capacity": [2e8, 5e8, 1e9, 32e12],
        "federation.eviction_policy": ["lru", "fifo"],
        "federation.admission_max_fraction": [1.0, 0.3]}),
    # cold restarts under eviction; the LRU cells at admission 0.3 have a
    # varying admission basis, so they take the slot machine
    "stormy": (lambda C: base_spec(C, n_requests=60, seed=1), {
        "federation.cache_capacity": [4e8, 1e9],
        "federation.eviction_policy": ["lru", "fifo"],
        "federation.admission_max_fraction": [1.0, 0.3],
        "outage_rate": [0.0, 0.5]}),
    # routing axes: replicas, skew, outages
    "routing": (lambda C: base_spec(C), {
        "federation.cache_replicas": [1, 2],
        "workload.zipf_a": [0.9, 1.4],
        "outage_rate": [0.0, 0.5]}),
    # two tiers: L1 × L2 split sizing, the parents in the second round
    "l1xl2": (lambda C: osdf_spec(C), {
        "federation.tier1.cache_capacity": [2 * GB, 6 * GB],
        "federation.tier2.cache_capacity": [4 * GB, 24 * GB],
        "federation.eviction_policy": ["lru", "fifo"]}),
}


def sweep_of(C, name):
    base, axes = SWEEPS[name]
    return C.SweepSpec(name=name, base=base(C), axes=axes)


@pytest.fixture(scope="module")
def runs(R):
    """name → (reference report, port batched report, port serial
    report), computed once per sweep on first use."""
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = (
                R.run_sweep(sweep_of(R, name)),
                T.run_sweep(sweep_of(T, name)),
                T.run_sweep(sweep_of(T, name), batched=False,
                            price_contention=False))
        return cache[name]
    return get


def assert_cells_match(got, want, floats_rtol=RTOL, executors=True):
    assert len(got.cells) == len(want.cells)
    for cg, cw in zip(got.cells, want.cells):
        assert repr(cg.params) == repr(cw.params) and cg.name == cw.name
        assert cg.executor == cw.executor or not executors
        for k in PARITY_INTS + PARITY_DICTS:
            assert cg.summary[k] == cw.summary[k], (cg.params, k)
        for k in PARITY_FLOATS:
            assert cg.summary[k] == pytest.approx(cw.summary[k],
                                                  rel=floats_rtol), \
                (cg.params, k)


def solver_without_wall(report):
    return {k: v for k, v in report.summary().items()
            if k != "wall_seconds"}


@pytest.mark.parametrize("name", sorted(SWEEPS))
def test_cells_equal_the_reference(runs, name):
    want, got, _ = runs(name)
    assert got.batched_cells == want.batched_cells == len(got.cells)
    assert got.serial_cells == want.serial_cells == 0
    assert_cells_match(got, want)


@pytest.mark.parametrize("name", sorted(SWEEPS))
def test_solver_telemetry_equals_the_reference(runs, name):
    want, got, _ = runs(name)
    assert solver_without_wall(got) == solver_without_wall(want)


@pytest.mark.parametrize("name", sorted(SWEEPS))
def test_pricing_within_tolerance(runs, name):
    want, got, _ = runs(name)
    for cg, cw in zip(got.cells, want.cells):
        assert cg.pricing.keys() == cw.pricing.keys()
        assert cg.pricing["peak_flows"] == cw.pricing["peak_flows"]
        for k, v in cw.pricing.items():
            assert cg.pricing[k] == pytest.approx(v, rel=RTOL), \
                (cg.params, k)


@pytest.mark.parametrize("name", sorted(SWEEPS))
def test_batched_cells_equal_the_ports_serial_run(runs, name):
    _, got, serial = runs(name)
    assert serial.serial_cells == len(serial.cells)
    assert serial.solver == {"solve_calls": 0, "priced_cells": 0}
    assert_cells_match(got, serial, floats_rtol=1e-9, executors=False)


def test_eviction_sweep_evicts_and_rejects(runs):
    _, got, _ = runs("evict")
    tiny = [c for c in got.cells
            if c.params["federation.cache_capacity"] == 2e8
            and c.params["federation.admission_max_fraction"] == 1.0]
    huge = [c for c in got.cells
            if c.params["federation.cache_capacity"] == 32e12
            and c.params["federation.admission_max_fraction"] == 1.0]
    assert all(c.summary["evictions"] > 0 for c in tiny)
    assert all(c.summary["evictions"] == 0 for c in huge)
    assert any(c.summary["admission_rejects"] > 0 for c in got.cells
               if c.params["federation.admission_max_fraction"] < 1.0)
    assert {"stack_calls", "fifo_calls"} <= set(got.solver)


def test_outage_cells_reach_every_scan(runs):
    _, got, _ = runs("stormy")
    for key in ("stack_calls", "fifo_calls", "cache_sim_calls"):
        assert got.solver.get(key, 0) >= 1, key
    stormy = [c for c in got.cells if c.params["outage_rate"] > 0]
    assert sum(c.summary["outages"] for c in stormy) > 0
    assert all(c.summary["evictions"] > 0 for c in stormy
               if c.params["federation.cache_capacity"] == 4e8)


def test_tiered_sweep_takes_two_rounds(runs):
    want, got, _ = runs("l1xl2")
    assert got.solver.get("tier_rounds") == want.solver.get(
        "tier_rounds") == 2
    assert len({c.summary["origin_egress_bytes"] for c in got.cells}) > 1


@pytest.mark.parametrize("axes", [
    {"engine": ["analytic", "sim"]},
    {"method": ["proxy"]},
    {"federation.eviction_policy": ["lru", "fifo", "lfu", "ttl"]},
    {"control": "control-plane"},
], ids=["sim-engine", "proxy", "lfu-ttl", "control-plane"])
def test_serial_fallback_cells_equal_the_reference(R, axes):
    """Cells outside the vectorized regime run serially on both sides with
    equal counters; their batched siblings stay batched."""
    def sweep(C):
        base = base_spec(C, n_requests=8)
        ax = dict(axes)
        if ax.get("control") == "control-plane":
            base = dataclasses.replace(base, workload=dataclasses.replace(
                base.workload, duration=2.0))
            ax["control"] = [None, C.ControlPlaneSpec(max_concurrent=1,
                                                      queue_depth=1)]
        return C.SweepSpec(name="fallback", base=base, axes=ax)
    want = R.run_sweep(sweep(R))
    got = T.run_sweep(sweep(T))
    assert got.serial_cells == want.serial_cells >= 1
    assert got.batched_cells == want.batched_cells
    assert_cells_match(got, want)
    for cg, cw in zip(got.cells, want.cells):
        for k in ("sheds", "queue_waits"):
            assert cg.summary.get(k) == cw.summary.get(k)


def test_sweep_spec_cells_equal_the_reference(R):
    def sweep(C):
        return C.SweepSpec(name="s", base=base_spec(C), axes={
            "federation.cache_replicas": [3], "federation.proxy_ttl": [120.0],
            "streams": [4], "outage_rate": [0.5], "workload.seed": [0, 7]})
    got, want = sweep(T).cells(), sweep(R).cells()
    assert len(sweep(T)) == len(sweep(R)) == 2
    for (pg, sg), (pw, sw) in zip(got, want):
        assert pg == pw and sg.name == sw.name
        assert sg.streams == sw.streams == 4
        assert [(e.time, e.cache, e.action, e.cold) for e in sg.outages] == \
            [(e.time, e.cache, e.action, e.cold) for e in sw.outages]
    for axis in ("workload.nope", "federation.nope", "nope", "name",
                 "outages", "federation.name",
                 "federation.tier3.cache_capacity"):
        with pytest.raises(ValueError):
            T.SweepSpec(name="s", base=osdf_spec(T), axes={axis: [1]}).cells()


def test_report_helpers(runs):
    _, got, _ = runs("routing")
    rows = got.marginal("workload.zipf_a", "hit_rate")
    assert [v for v, _ in rows] == [0.9, 1.4]
    cell = got.cell(**{"workload.zipf_a": 1.4, "outage_rate": 0.5,
                       "federation.cache_replicas": 2})
    assert cell.executor == "batched"
    assert got.fitted_models() == {} and got.reuse_histograms() == {}
    assert got.summary()["fitted_cells"] == 0


def test_device_none_means_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = dataclasses.replace(base_spec(T, n_requests=4), device=None)
    with pytest.raises(RuntimeError, match="CUDA"):
        T.run_sweep(T.SweepSpec(name="card", base=spec))


# ---------------------------------------------------------------------------
# The batched max-min solver against the reference's
# ---------------------------------------------------------------------------
def mixed_problems(seed):
    """Problems that land in several buckets, a few per bucket, with flows
    that cross no link (loopback) and a problem with no flows."""
    rng = np.random.default_rng(seed)
    problems = [([1e9, 2e9], [], [])]
    for _ in range(11):
        F = int(rng.integers(1, 90))
        L = int(rng.integers(2, 50))
        rows = [[] if rng.random() < 0.1 else
                [int(x) for x in rng.choice(L, int(rng.integers(
                    1, min(L, 9) + 1)), replace=False)] for _ in range(F)]
        problems.append((rng.uniform(1e8, 1e10, L).tolist(), rows,
                         rng.uniform(1e7, 5e9, F).tolist()))
    return problems


@pytest.fixture(scope="module")
def jax_batched():
    pytest.importorskip("jax", reason="the JAX reference is not installed")
    from repro.kernels import batched_maxmin as ref_bm
    return types.SimpleNamespace(solve=ref_bm.maxmin_rates_batch)


@pytest.mark.parametrize("seed", range(4))
def test_batched_maxmin_equals_the_reference(jax_batched, seed):
    problems = mixed_problems(seed)
    want_stats, got_stats = {}, {}
    want = jax_batched.solve(problems, stats=want_stats)
    got = batched_maxmin.maxmin_rates_batch(problems, stats=got_stats,
                                            device="cpu")
    assert got_stats == want_stats and want_stats["solve_calls"] >= 3
    for (_, rows, fcaps), g, w in zip(problems, got, want):
        assert g.dtype == np.float64 and g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=0)
        for fi, ls in enumerate(rows):
            if not ls:
                assert g[fi] == fcaps[fi]


def test_batched_problems_do_not_interact():
    """Each problem of a batch gets what it gets alone: one problem's
    bottleneck never retires another's flows."""
    from repro_torch.kernels import maxmin
    problems = [p for p in mixed_problems(5) if p[1]]
    together = batched_maxmin.maxmin_rates_batch(problems, device="cpu")
    for p, got in zip(problems, together):
        alone = maxmin.maxmin_rates_sparse(*p, device="cpu")
        np.testing.assert_allclose(got, alone, rtol=1e-6, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["stormy", "l1xl2"])
def test_sweep_on_card_equals_cpu(name):
    """The same sweep with its kernels on the card and on the CPU: every
    counter equal, pricing within 1e-6 (the same float32 ops)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    base, axes = SWEEPS[name]
    card_spec = T.SweepSpec(name=name, axes=axes, base=dataclasses.replace(
        base(T), device="cuda"))
    got = T.run_sweep(card_spec)
    want = T.run_sweep(sweep_of(T, name))
    assert_cells_match(got, want, floats_rtol=1e-9)
    assert solver_without_wall(got) == solver_without_wall(want)
    for cg, cw in zip(got.cells, want.cells):
        for k, v in cw.pricing.items():
            assert cg.pricing[k] == pytest.approx(v, rel=1e-6)
