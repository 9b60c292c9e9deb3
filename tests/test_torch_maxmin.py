"""The port's max-min solver (torch ops) against the JAX reference.

On the CPU: 50 seeded random sparse problems (up to 512 flows, each
crossing 1-5 links, some crossing none: loopback rows) go through the
reference's jitted ``solve_waterfill`` and the port's, on the same
padded arrays, and through both packages' ``maxmin_rates_sparse`` and
the float64 oracle ``maxmin_ref``.  Tolerances:

* port vs JAX ``solve_waterfill``, both float32: ``rtol=1e-5`` (the
  segment sums add in another order; ties fall the same way);
* port vs ``maxmin_ref`` (float64): ``rtol=2e-3, atol=1e3``, as the
  reference's own ``tests/test_maxmin.py`` holds its solver.

The ``gpu`` tests hold the solver on the card against its CPU run.  JAX
is imported through the ``jx`` fixture, so that on the machine with the
card, which has no JAX, the ``gpu`` tests run.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch.kernels import maxmin, ops
from repro_torch.kernels.ref import maxmin_ref

N_PROBLEMS = 50
JAX_RTOL = 1e-5
REF_RTOL, REF_ATOL = 2e-3, 1e3
CARD_RTOL = 1e-6


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax", reason="the JAX reference is not installed")
    import jax
    import jax.numpy as jnp

    from repro.kernels import maxmin as jax_maxmin
    return types.SimpleNamespace(
        jnp=jnp, maxmin=jax_maxmin,
        solve=jax.jit(jax_maxmin.solve_waterfill))


def random_problem(seed: int):
    """A sparse problem: link caps, per-flow link rows (width 1-5, about
    one row in eight empty), flow caps; made with numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    n_flows = int(rng.integers(1, 513))
    n_links = int(rng.integers(5, 300))
    caps = rng.uniform(1e8, 1e10, n_links)
    rows = []
    for _ in range(n_flows):
        if rng.random() < 0.125:
            rows.append([])
            continue
        width = int(rng.integers(1, 6))
        rows.append([int(x) for x in rng.choice(n_links, width,
                                                 replace=False)])
    fcaps = rng.uniform(1e7, 5e9, n_flows)
    return caps, rows, fcaps


def dense(rows, n_links):
    mem = np.zeros((len(rows), n_links), bool)
    for f, ls in enumerate(rows):
        mem[f, ls] = True
    return mem


def padded(caps, rows, fcaps):
    width = maxmin._next_pow2(max((len(r) for r in rows), default=1), 4)
    return maxmin.pad_problem(caps, rows, fcaps,
                              maxmin._next_pow2(len(rows)),
                              maxmin._next_pow2(len(caps) + 1), width)


def port_core(caps, ids, fcaps):
    """The port's ``solve_waterfill`` on a padded problem: (Fp,) rates."""
    args = maxmin.device_problem(caps, ids, fcaps, torch.device("cpu"))
    return maxmin.solve_waterfill(*args)[:ids.shape[0]].cpu().numpy()


@pytest.mark.parametrize("seed", range(N_PROBLEMS))
def test_random_problem_matches_jax_and_oracle(jx, seed):
    caps, rows, fcaps = random_problem(seed)
    caps_p, ids, fcaps_p = padded(caps, rows, fcaps)
    want_core = np.asarray(jx.solve(jx.jnp.asarray(caps_p),
                                    jx.jnp.asarray(ids),
                                    jx.jnp.asarray(fcaps_p)))
    np.testing.assert_allclose(port_core(caps_p, ids, fcaps_p), want_core,
                               rtol=JAX_RTOL, atol=0)
    got = maxmin.maxmin_rates_sparse(caps, rows, fcaps, device="cpu")
    np.testing.assert_allclose(
        got, jx.maxmin.maxmin_rates_sparse(caps, rows, fcaps),
        rtol=JAX_RTOL, atol=0)
    oracle = maxmin_ref(caps, dense(rows, len(caps)), fcaps)
    np.testing.assert_allclose(got, oracle, rtol=REF_RTOL, atol=REF_ATOL)
    loopback = [f for f, r in enumerate(rows) if not r]
    assert np.array_equal(got[loopback],
                          np.asarray(fcaps, np.float32)[loopback])


def test_oracle_control_fails_with_one_capacity_halved():
    """The oracle check must catch a wrong answer: the rates of a problem
    with its most-shared link's capacity halved fail the same bound."""
    caps, rows, fcaps = random_problem(1)
    got = maxmin.maxmin_rates_sparse(caps, rows, fcaps, device="cpu")
    busiest = np.bincount([l for r in rows for l in r]).argmax()
    halved = caps.copy()
    halved[busiest] /= 2
    oracle = maxmin_ref(halved, dense(rows, len(caps)), fcaps)
    assert not np.allclose(got, oracle, rtol=REF_RTOL, atol=REF_ATOL)


def test_dense_wrapper_and_ops_match_oracle():
    caps, rows, fcaps = random_problem(2)
    mem = dense(rows, len(caps))
    want = maxmin_ref(caps, mem, fcaps)
    np.testing.assert_allclose(maxmin.maxmin_rates(caps, mem, fcaps,
                                                   device="cpu"),
                               want, rtol=REF_RTOL, atol=REF_ATOL)
    got = ops.maxmin_rates(torch.from_numpy(caps), torch.from_numpy(mem),
                           torch.from_numpy(fcaps))
    assert got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), want, rtol=REF_RTOL,
                               atol=REF_ATOL)


@pytest.mark.parametrize("case", ["bottleneck", "cap_binds", "equal_split",
                                  "loopback"])
def test_small_cases(case):
    """The reference's hand-made cases (``tests/test_maxmin.py``)."""
    if case == "bottleneck":
        rates = maxmin.maxmin_rates(np.array([1e9, 5e8]), np.array([[1, 1]]),
                                    np.array([1e12]), device="cpu")
        assert rates[0] == pytest.approx(5e8, rel=1e-3)
    elif case == "cap_binds":
        rates = maxmin.maxmin_rates(np.array([1e9]), np.array([[1], [1]]),
                                    np.array([1e8, 1e12]), device="cpu")
        assert rates[0] == pytest.approx(1e8, rel=1e-3)
        assert rates[1] == pytest.approx(9e8, rel=1e-3)
    elif case == "equal_split":
        rates = maxmin.maxmin_rates(np.array([1e9]), np.array([[1]] * 4),
                                    np.array([1e12] * 4), device="cpu")
        np.testing.assert_allclose(rates, 2.5e8, rtol=1e-3)
    else:
        rates = maxmin.maxmin_rates_sparse([1e9], [[0], [], [0], []],
                                           [1e12, 3e8, 1e12, 7e8],
                                           device="cpu")
        assert rates[1] == pytest.approx(3e8, rel=1e-4)
        assert rates[3] == pytest.approx(7e8, rel=1e-4)
        assert rates[0] == pytest.approx(5e8, rel=1e-3)
        assert rates[2] == pytest.approx(5e8, rel=1e-3)


def test_link_table_lists_each_links_flows_in_order():
    ids = np.array([[0, 2, 3], [2, 3, 3], [1, 0, 3], [3, 3, 3]], np.int32)
    table = maxmin.link_table(ids, 4)            # 3 is the dummy slot
    assert table.tolist() == [[0, 2], [2, 4], [0, 1], [4, 4]]


def test_pad_problem_keeps_the_reference_layout(jx):
    caps, rows, fcaps = random_problem(3)
    for got, want in zip(padded(caps, rows, fcaps),
                         jx.maxmin.pad_problem(
                             caps, rows, fcaps,
                             maxmin._next_pow2(len(rows)),
                             maxmin._next_pow2(len(caps) + 1),
                             maxmin._next_pow2(max(len(r) for r in rows),
                                               4))):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    with pytest.raises(ValueError):
        maxmin.pad_problem([1e9] * 10, [[0]], [1e9], 8, 8, 4)


def test_counts_and_replay_are_exact():
    """Two solves of one problem give the same bits; the counters see
    both solves and their rounds (no syncs or copies on the CPU)."""
    caps, rows, fcaps = random_problem(4)
    counts = maxmin.COUNTS
    counts.reset()
    a = maxmin.maxmin_rates_sparse(caps, rows, fcaps, device="cpu")
    b = maxmin.maxmin_rates_sparse(caps, rows, fcaps, device="cpu")
    assert a.tobytes() == b.tobytes()
    assert counts.solves == 2 and counts.rounds >= 2
    assert counts.solves_by_device == {"cpu": 2}
    assert counts.syncs == counts.h2d == counts.d2h == 0


def test_solver_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        maxmin.maxmin_rates_sparse([1e9], [[0]], [1e9])


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("seed", range(0, N_PROBLEMS, 5))
def test_card_matches_cpu_and_oracle(seed):
    _card()
    caps, rows, fcaps = random_problem(seed)
    counts = maxmin.COUNTS
    counts.reset()
    got = maxmin.maxmin_rates_sparse(caps, rows, fcaps, device="cuda")
    card = dataclasses.replace(counts, solves_by_device=dict(
        counts.solves_by_device))
    cpu = maxmin.maxmin_rates_sparse(caps, rows, fcaps, device="cpu")
    np.testing.assert_allclose(got, cpu, rtol=CARD_RTOL, atol=0)
    np.testing.assert_allclose(got, maxmin_ref(caps, dense(rows, len(caps)),
                                               fcaps),
                               rtol=REF_RTOL, atol=REF_ATOL)
    assert card.solves_by_device == {"cuda": 1}
    assert card.h2d == 2 and card.d2h == card.syncs == card.rounds + 1
    again = maxmin.maxmin_rates_sparse(caps, rows, fcaps, device="cuda")
    assert got.tobytes() == again.tobytes()
