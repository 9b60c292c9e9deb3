"""The port's fluid-flow simulator and simulated engine against the
reference's, on the CPU (``device="cpu"``).

* Scalar solver: the scenario family's (``test_torch_fed_family.py``)
  ``canonical_report_bytes`` must equal the reference's byte for byte.
  No field of a report names its package, so the bytes are compared as
  they are.
* Vector solver (the port's torch ops against the reference's jitted
  JAX, both float32): every int, str and bool of the report equal, every
  float (seconds, the accounted times) within 1e-4 relative.
* Without a card, ``FluidFlowSim()`` raises instead of running on the
  CPU.  The ``gpu`` tests run the vector engine on the card: against its
  CPU run, and twice, byte for byte (the sanitizer's double replay).

JAX is imported through the ``ref`` fixture, so that on the machine with
the card, which has no JAX, the ``gpu`` tests run.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro_torch.core as T
from repro_torch.analysis.sanitize import (canonical_report_bytes,
                                          close_reports)
from repro_torch.kernels import maxmin

import test_torch_fed_family as fam

VECTOR_RTOL = 1e-4


@pytest.fixture(scope="module")
def ref():
    pytest.importorskip("jax", reason="the JAX reference is not installed")
    import repro.core
    return repro.core


@pytest.fixture(scope="module")
def ref_bytes(ref):
    from repro.analysis.sanitize import canonical_report_bytes as cb
    return cb


@pytest.mark.parametrize("case", fam.CASES, ids=lambda c: c.id)
def test_scalar_sim_report_equal(ref, ref_bytes, case):
    got = T.run_scenario(fam.spec(T, case, "sim", "scalar", device="cpu"))
    want = ref.run_scenario(fam.spec(ref, case, "sim", "scalar"))
    assert got.reallocations == want.reallocations > 0
    assert canonical_report_bytes(got) == ref_bytes(want)


@pytest.mark.parametrize("case", fam.CASES, ids=lambda c: c.id)
def test_vector_sim_counters_equal_seconds_close(ref, case):
    counts = maxmin.COUNTS
    counts.reset()
    got = T.run_scenario(fam.spec(T, case, "sim", "vector", device="cpu"))
    want = ref.run_scenario(fam.spec(ref, case, "sim", "vector"))
    assert counts.solves == got.reallocations == want.reallocations > 0
    close_reports(dataclasses.asdict(got), dataclasses.asdict(want),
                      VECTOR_RTOL)


def test_vector_and_scalar_agree_on_a_storm():
    """The port's two solvers on one scenario: equal counters, seconds
    within 1e-4 (the chip smoke's check 1, at a small size)."""
    case = fam.Case("fleet", "storm")
    vec = T.run_scenario(fam.spec(T, case, "sim", "vector", device="cpu"))
    sca = T.run_scenario(fam.spec(T, case, "sim", "scalar", device="cpu"))
    close_reports(dataclasses.asdict(vec), dataclasses.asdict(sca),
                      VECTOR_RTOL)


def _topo(n_sites, uplink=1e9):
    topo = T.Topology()
    prof = T.BandwidthProfile(site_uplink=uplink)
    for s in range(n_sites):
        topo.add_site(f"s{s}", prof)
        topo.add_node(f"s{s}/w", T.Coord(f"s{s}", 0, 0), 1e9)
    return topo


def test_same_completion_times_across_solvers():
    """The reference's solver-equivalence test, on the port: 40 random
    flows over 12 sites, completion times within 1e-4."""
    times = {}
    for solver in ("scalar", "vector"):
        sim = T.FluidFlowSim(_topo(12), solver=solver, device="cpu")
        done = []

        def proc(src, dst, nbytes, streams):
            yield sim.flow(src, dst, nbytes, streams=streams)
            done.append(sim.t)

        r = np.random.default_rng(9)
        for _ in range(40):
            a, b = r.choice(12, 2, replace=False)
            sim.spawn(proc(f"s{a}/w", f"s{b}/w", float(r.uniform(1e8, 2e9)),
                           int(r.integers(1, 16))))
        sim.run()
        times[solver] = sorted(done)
    np.testing.assert_allclose(times["vector"], times["scalar"], rtol=1e-4)


@pytest.mark.parametrize("solver", ["scalar", "vector"])
def test_loopback_flow_completes(solver):
    topo = T.Topology()
    topo.add_site("s")
    topo.add_node("s/n", T.Coord("s", 0, 0), 1e9)
    sim = T.FluidFlowSim(topo, solver=solver, device="cpu")
    done = []

    def proc():
        yield sim.flow("s/n", "s/n", 1e8, streams=4)
        done.append(sim.t)

    sim.spawn(proc())
    sim.run()
    assert done and done[0] < 1.0


@pytest.mark.parametrize("solver", ["scalar", "vector", "auto"])
def test_simulator_needs_a_card_unless_told(monkeypatch, solver):
    """``FluidFlowSim()`` means the card, whichever solver; without one it
    raises instead of running on the CPU, and so do the engines above."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        T.FluidFlowSim(_topo(2), solver=solver)
    with pytest.raises(RuntimeError, match="CUDA"):
        T.run_scenario(fam.spec(T, fam.Case("fleet", "storm"), "sim",
                                solver))
    assert T.FluidFlowSim(_topo(2), solver=solver,
                          device="cpu").device.type == "cpu"
    # the analytic engine has no device work and takes none
    T.run_scenario(fam.spec(T, fam.Case("fleet", "storm"), "analytic"))


def test_unknown_solver_rejected():
    with pytest.raises(ValueError):
        T.FluidFlowSim(_topo(2), solver="quantum", device="cpu")


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("case", fam.CASES[::3], ids=lambda c: c.id)
def test_card_vector_sim_matches_cpu(case):
    _card()
    counts = maxmin.COUNTS
    counts.reset()
    got = T.run_scenario(fam.spec(T, case, "sim", "vector", device="cuda"))
    assert counts.solves_by_device.get("cuda", 0) == got.reallocations > 0
    want = T.run_scenario(fam.spec(T, case, "sim", "vector", device="cpu"))
    close_reports(dataclasses.asdict(got), dataclasses.asdict(want),
                      VECTOR_RTOL)


@pytest.mark.gpu
def test_card_double_replay_is_byte_identical():
    _card()
    from repro_torch.analysis.sanitize import run_sanitizer
    rows = run_sanitizer(quick=True, device="cuda")
    assert [r[0] for r in rows].count("double-replay") == 6
    spec = fam.spec(T, fam.Case("fleet", "storm", outage="storm"), "sim",
                    "vector", device="cuda")
    assert canonical_report_bytes(T.run_scenario(spec)) == \
        canonical_report_bytes(T.run_scenario(spec))
