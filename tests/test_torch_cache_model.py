"""The port's cache models (``repro_torch.kernels.cache_model``) and the
planner's two kernels' plain versions, against the JAX reference on the
CPU, and the kernels' algorithms modelled in numpy.

* Histograms are equal to the reference's ``to_dict()`` exactly, inf
  distances and empty streams included.
* The evaluators and their autograd gradients agree with the reference's
  values and ``jax.grad`` inside ``enable_x64`` within 1e-12 relative (the
  same float64 formulas, summed in another order).  Outside ``enable_x64``
  the reference evaluates in float32, so there the bound is 1e-6.
* The interp evaluator keeps ``jnp.interp``'s edges: the end knots'
  values outside, the right segment at a repeated knot.
* ``model_plan_grad`` and ``model_mixture_grad`` are the kernels'
  analytic gradients, written as the CUDA source writes them; they equal
  autograd's gradient of the same objective within 1e-12 relative (budget
  on and off, and below the ``max(C, 1)`` clamp).  ``model_plan_solve``
  and ``model_mixture_fit`` are the kernels' whole loops, sums folded as
  the kernels fold them (lane-strided sums and an xor tree); they agree
  with the plain versions within 1e-9 relative (capacities) and 1e-9
  absolute (mixture parameters): rounding-level differences that the
  Adam steps carry, not amplify, on these inputs.  Under an egress
  budget that binds, the reference's algorithm itself is sensitive to
  rounding, and the bounds are ``BUDGET_TOL``: what the reference and the
  plain version differ by on the same inputs.
* ``mixture_fit_ref`` agrees with the reference's ``_mixture_fit_loop``
  within 1e-9 at 150 steps, and its loss is the reference's: the loss the
  last step evaluated before its own update.  Over longer fits Adam may
  wander along a flat valley of the loss, so a 400-step fit is held to
  ``MIX_TOL``: its curve, parameters and loss.

The ``gpu`` tests hold each kernel to its plain version on the card, two
launches to the same bits, and sizes the kernels do not serve to an
error; ``plan_solve``'s cluster design at 1 to 2048 caches, G = 1 and
G = N, with and without a budget; a batch of mixture fits to each fit
alone, bit for bit, at 1, 3 and 8 components and on grids of 1 to 33
points.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro_torch.kernels import cache_model as cm
from repro_torch.kernels import ops, ref

EVAL_RTOL = 1e-12       # the same float64 formulas in another order
F32_ATOL = 1e-6         # against the reference's float32 evaluation
GRAD_RTOL = 1e-12       # analytic gradient vs autograd
MODEL_RTOL = 1e-9       # a whole loop, model vs plain version
# Under an egress budget that binds, the reference's solve is sensitive to
# rounding: the dual term's kink sends Adam's normalised steps to either
# side, and the repair lands elsewhere on the constraint surface.  The
# most that three versions of one algorithm (the reference, the plain
# version and the kernel's numpy model) differ over 8 random plans
# (`tools/reference_want.py --spreads`): capacities 6.8e-3 relative, total
# capacity 3.2e-5, hit rate 1.2e-4 absolute, gradient norm 1.0e-2; the
# egress (the binding constraint) and the uniform capacity agree within
# 2e-15.  Without a budget all of them agree within 2.1e-12.
BUDGET_TOL = {"capacity": 1e-2, "total": 1e-4, "hit": 5e-4, "gnorm": 3e-2}
# The mixture's Adam can wander along a flat valley of its loss: over 400
# steps on 12 histograms (a sweep's and random streams) the plain
# version, the kernel's numpy model and the reference differ by at most
# 9.8e-6 in a parameter, 9.3e-8 in the fitted CDF on the grid and 7.3e-8
# relative in the loss (`tools/reference_want.py --spreads`).
MIX_TOL = {"param": 1e-4, "cdf": 1e-6, "loss": 1e-6}
SQRT2, SQRTPI = 1.4142135623730951, 1.7724538509055159


@pytest.fixture(scope="module")
def R():
    pytest.importorskip("jax", reason="the JAX reference is not installed")
    from repro.kernels import cache_model
    return cache_model


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax", reason="the JAX reference is not installed")
    import jax
    import jax.numpy as jnp
    from jax.experimental import enable_x64
    return jax, jnp, enable_x64


def random_stream(seed, n=400, inf_frac=0.2):
    rng = np.random.default_rng(seed)
    dist = rng.exponential(1e9, n)
    dist[rng.random(n) < inf_frac] = np.inf
    sizes = rng.integers(1, 10**8, n).astype(float)
    return dist, sizes


def histogram_cases():
    cases = [random_stream(s) for s in range(3)]
    d, s = random_stream(3, n=50)
    cases.append((np.full(50, np.inf), s))                    # no reuse
    cases.append((np.zeros(0), np.zeros(0)))                  # empty
    cases.append((np.full(20, 5e8), np.full(20, 1e6)))        # one value
    return cases


def plan_errors(got, want, gsize):
    """How far a solve's output (G + 4,) is from another's: each
    capacity, the total, the uniform capacity, the egress and the
    gradient norm relative, the hit rate absolute."""
    G = len(gsize)
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)

    def rel(a, b):
        a, b = np.asarray(a), np.asarray(b)
        return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300)))
    return {"capacity": rel(got[:G], want[:G]),
            "total": rel(gsize @ got[:G], gsize @ want[:G]),
            "uniform": rel(got[G], want[G]),
            "hit": abs(float(got[G + 1] - want[G + 1])),
            "egress": rel(got[G + 2], want[G + 2]),
            "gnorm": rel(got[G + 3], want[G + 3])}


def assert_plan_close(got, want, gsize, budget: bool) -> None:
    err = plan_errors(got, want, np.asarray(gsize, np.float64))
    tol = dict.fromkeys(err, MODEL_RTOL)
    if budget:
        tol.update(BUDGET_TOL)
    assert all(err[k] <= tol[k] for k in err), (err, tol)


def assert_mixture_close(got, got_loss, want, want_loss, grid) -> None:
    """Two fits (params (3, K) each) of one grid within ``MIX_TOL``."""
    got, want = (torch.as_tensor(np.asarray(p, np.float64)) for p in
                 (got, want))
    g = torch.as_tensor(np.asarray(grid, np.float64))
    err = {"param": float((got - want).abs().max()),
           "cdf": float((cm._mixture_cdf(g, *got)
                         - cm._mixture_cdf(g, *want)).abs().max()),
           "loss": abs(got_loss - want_loss) / max(abs(want_loss), 1e-300)}
    assert all(err[k] <= MIX_TOL[k] for k in err), (err, MIX_TOL)


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)),
                                                   1e-300))


def models_for(seed, buckets=64):
    """A hist, a mixture and an interp model from one random stream."""
    dist, sizes = random_stream(seed)
    h = cm.reuse_histogram(dist, sizes, buckets)
    hist = cm.fit_histogram_model(h, origin_fraction=0.7)
    params0, grid, target = cm.mixture_problem(h)
    t = [torch.from_numpy(a[None]) for a in (params0, grid, target)]
    p, loss = ref.mixture_fit_ref(*t, 60, 0.08)
    mix = cm.mixture_model(h, p[0].numpy(), float(loss[0]), 0.7)
    interp = cm.fit_interp_model([1e8, 1e9, 1e9, 4e9, 2e10],
                                 [0.05, 0.2, 0.3, 0.5, 0.6])
    return {"hist": hist, "mixture": mix, "interp": interp}


def to_ref(R, model):
    """The same model as the reference's CacheModel."""
    return R.CacheModel(**{f.name: getattr(model, f.name)
                           for f in dataclasses.fields(model)})


# ---------------------------------------------------------------------------
# Histograms and evaluators against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", range(len(histogram_cases())))
def test_reuse_histogram_equals_reference(R, case):
    dist, sizes = histogram_cases()[case]
    got = cm.reuse_histogram(dist, sizes).to_dict()
    assert got == R.reuse_histogram(dist, sizes).to_dict()
    h = cm.ReuseHistogram.from_dict(got)
    assert h.ref_weights.sum() + h.compulsory_refs == h.total_refs


CAPS = np.geomspace(1.0, 1e15, 31)


@pytest.mark.parametrize("kind", ["hist", "mixture", "interp"])
def test_evaluators_and_gradients_equal_reference_in_x64(R, jx, kind):
    jax, jnp, enable_x64 = jx
    model = models_for(1)[kind]
    rmodel = to_ref(R, model)
    cap = torch.tensor(CAPS, dtype=torch.float64, requires_grad=True)
    for fn in ("predict_hit_rate", "predict_miss_bytes"):
        got = getattr(cm, fn)(model, cap)
        g, = torch.autograd.grad(got.sum(), cap)
        with enable_x64():
            want = np.asarray(getattr(R, fn)(rmodel, jnp.asarray(CAPS)))
            wg = np.asarray(jax.grad(lambda c: getattr(R, fn)(
                rmodel, c).sum())(jnp.asarray(CAPS)))
        assert rel_err(got.detach().numpy(), want) <= EVAL_RTOL, fn
        assert rel_err(g.numpy(), wg) <= EVAL_RTOL, fn


@pytest.mark.parametrize("kind", ["hist", "mixture", "interp"])
def test_hit_rate_outside_x64_is_the_references_float32(R, kind):
    """Outside ``enable_x64`` the reference computes in float32; the port
    computes in float64, so the two differ by float32's rounding."""
    model = models_for(2)[kind]
    got = [float(cm.predict_hit_rate(model, c)) for c in CAPS]
    want = [float(R.predict_hit_rate(to_ref(R, model), c)) for c in CAPS]
    assert np.max(np.abs(np.subtract(got, want))) <= F32_ATOL


def test_fleet_totals_and_gradients_equal_reference(R, jx):
    jax, jnp, enable_x64 = jx
    models = {f"c{i}": models_for(i)["hist"] for i in range(4)}
    stacked = cm.stack_models(models)
    rstacked = R.stack_models({k: to_ref(R, m) for k, m in models.items()})
    caps = np.geomspace(3e8, 3e10, 4)
    for fn in ("fleet_hits", "fleet_hit_rate", "fleet_origin_egress"):
        x = torch.tensor(caps, requires_grad=True)
        got = getattr(cm, fn)(stacked, x)
        g, = torch.autograd.grad(got.sum(), x)
        with enable_x64():
            want = np.asarray(getattr(R, fn)(rstacked, jnp.asarray(caps)))
            wg = np.asarray(jax.grad(lambda c: getattr(R, fn)(
                rstacked, c).sum())(jnp.asarray(caps)))
        assert rel_err(got.detach().numpy(), want) <= EVAL_RTOL, fn
        assert rel_err(g.numpy(), wg) <= EVAL_RTOL, fn


def test_stack_models_equals_reference_and_refuses_interp(R):
    models = {f"c{i}": models_for(i, buckets=16 + 16 * i)["hist"]
              for i in range(3)}
    got = cm.stack_models(models)
    want = R.stack_models({k: to_ref(R, m) for k, m in models.items()})
    for f in ("log_centers", "ref_weights", "byte_weights", "total_refs",
              "total_bytes", "compulsory_bytes", "origin_fraction"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert got.names == want.names and got.tau == want.tau
    with pytest.raises(ValueError, match="no histogram"):
        cm.stack_models({"x": models_for(0)["interp"]})


@pytest.mark.parametrize("x", [-5.0, 0.0, 1.5, 2.0, 2.5, 3.0, 3.5, 9.0])
def test_interp_edges_equal_jnp_interp(jx, x):
    """Outside the knots the end knots' values; at the repeated knot 2.0
    the right segment's value (the last of the repeated knots)."""
    jax, jnp, enable_x64 = jx
    xp = np.array([0.0, 1.0, 2.0, 2.0, 3.0])
    fp = np.array([0.1, 0.2, 0.3, 0.6, 0.9])
    xt = torch.tensor([x], dtype=torch.float64, requires_grad=True)
    got = cm._interp(xt, torch.from_numpy(xp), torch.from_numpy(fp))
    g, = torch.autograd.grad(got.sum(), xt)
    with enable_x64():
        want = float(jnp.interp(x, jnp.asarray(xp), jnp.asarray(fp)))
        wg = float(jax.grad(lambda v: jnp.interp(v, jnp.asarray(xp),
                                                 jnp.asarray(fp)))(x))
    assert float(got.detach()) == want
    assert float(g) == wg
    if x == 2.0:
        assert want == 0.6


def test_interp_single_knot_is_constant(jx):
    jax, jnp, enable_x64 = jx
    got = cm._interp(torch.tensor([-1.0, 0.5, 4.0], dtype=torch.float64),
                     torch.tensor([0.5], dtype=torch.float64),
                     torch.tensor([0.4], dtype=torch.float64))
    with enable_x64():
        want = np.asarray(jnp.interp(jnp.asarray([-1.0, 0.5, 4.0]),
                                     jnp.asarray([0.5]), jnp.asarray([0.4])))
    np.testing.assert_array_equal(got.numpy(), want)


def test_fit_lognormal_mixture_no_reuse_equals_reference(R):
    dist, sizes = histogram_cases()[3]
    h = cm.reuse_histogram(dist, sizes)
    got = cm.fit_lognormal_mixture(h, components=4, device="cpu")
    want = R.fit_lognormal_mixture(R.reuse_histogram(dist, sizes),
                                   components=4)
    assert got.kind == want.kind == "mixture"
    np.testing.assert_array_equal(got.mix_logits, want.mix_logits)
    assert (got.compulsory_refs, got.total_refs, got.fit_loss) == \
        (want.compulsory_refs, want.total_refs, want.fit_loss)


# ---------------------------------------------------------------------------
# The mixture fit: plain version, reference, and the kernel's model
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", range(3))
def test_mixture_fit_ref_equals_reference(R, jx, seed):
    jax, jnp, enable_x64 = jx
    dist, sizes = random_stream(seed)
    h = cm.reuse_histogram(dist, sizes)
    stats = {}
    got = cm.fit_lognormal_mixture(h, steps=150, stats=stats, device="cpu")
    rstats = {}
    want = R.fit_lognormal_mixture(R.reuse_histogram(dist, sizes),
                                   steps=150, stats=rstats)
    for f in ("mix_logits", "mix_mu", "mix_log_sigma"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=0, atol=MODEL_RTOL)
    assert abs(got.fit_loss - want.fit_loss) <= MODEL_RTOL * want.fit_loss
    assert stats["fit_steps"] == rstats["fit_steps"] == 150


def test_fit_loss_is_the_last_steps_pre_update_loss():
    """The returned loss is the loss at the parameters after steps − 1
    updates, not at the returned parameters."""
    dist, sizes = random_stream(4)
    t = [torch.from_numpy(a[None]) for a in
         cm.mixture_problem(cm.reuse_histogram(dist, sizes))]
    p5, loss5 = ref.mixture_fit_ref(*t, 5, 0.08)
    p4, _ = ref.mixture_fit_ref(*t, 4, 0.08)
    assert float(loss5[0]) == float(ref.mixture_loss(p4, *t[1:])[0])
    assert float(loss5[0]) != float(ref.mixture_loss(p5, *t[1:])[0])
    _, loss0 = ref.mixture_fit_ref(*t, 0, 0.08)
    assert float(loss0[0]) == 0.0


def block_sum(v):
    """The mixture kernel's sum over a block's points: one value a lane,
    the xor tree within each warp, the warps' sums in order."""
    v = np.asarray(v, np.float64)
    lanes = np.concatenate([v, np.zeros(-len(v) % 32)]).reshape(-1, 32)
    idx = np.arange(32)
    for m in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[:, idx ^ m]
    s = 0.0
    for w in lanes[:, 0]:
        s += w
    return s


def _erf(z):
    return torch.special.erf(torch.from_numpy(np.asarray(z))).numpy()


def model_mixture_grad(prm, x, y):
    """The mixture kernel's step for one fit, before Adam: (loss, gradient
    over the 3K parameters), as ``csrc/cache_model.cu`` forms them."""
    K, M = len(prm) // 3, len(x)
    logits, mu, logsig = prm[:K], prm[K:2 * K], prm[2 * K:]
    mx = logits[0]
    for j in range(1, K):
        mx = max(mx, logits[j])
    e = np.exp(logits - mx)
    se = 0.0
    for j in range(K):
        se += e[j]
    pi = e / se
    den = np.exp(logsig) * SQRT2
    zz = (x[:, None] - mu) / den
    ez = _erf(zz)
    pred = np.zeros(M)
    for j in range(K):
        pred = pred + (pi[j] * 0.5) * (1.0 + ez[:, j])
    r = pred - y
    ct = (2.0 * r) / M
    loss = block_sum(r * r) / M
    ct_pi = np.array([0.5 * block_sum(ct * (1.0 + ez[:, j]))
                      for j in range(K)])
    ee = ct[:, None] * np.exp(-(zz * zz))
    sg = np.array([block_sum(ee[:, j]) for j in range(K)])
    sz = np.array([block_sum(ee[:, j] * zz[:, j]) for j in range(K)])
    dot = 0.0
    for q in range(K):
        dot += pi[q] * ct_pi[q]
    g = np.concatenate([pi * (ct_pi - dot),
                        -((pi / SQRTPI) * sg) / den,
                        -((pi / SQRTPI) * sz)])
    return loss, g


def model_mixture_fit(params0, grid, target, steps, lr):
    """The mixture kernel's whole loop for one fit (params0 (3, K))."""
    prm = params0.reshape(-1).copy()
    mom, vel = np.zeros_like(prm), np.zeros_like(prm)
    loss = 0.0
    for i in range(steps):
        loss, g = model_mixture_grad(prm, grid, target)
        t = i + 1.0
        mom = 0.9 * mom + 0.1 * g
        vel = 0.999 * vel + 0.001 * g * g
        prm = prm - lr * (mom / (1.0 - 0.9 ** t)) / (
            np.sqrt(vel / (1.0 - 0.999 ** t)) + 1e-8)
    return prm.reshape(params0.shape), loss


@pytest.mark.parametrize("seed", range(3))
def test_mixture_gradient_model_equals_autograd(seed):
    dist, sizes = random_stream(seed)
    params0, grid, target = cm.mixture_problem(
        cm.reuse_histogram(dist, sizes), components=3 + seed)
    rng = np.random.default_rng(seed)
    prm = params0 + rng.normal(0, 0.3, params0.shape)
    x = torch.from_numpy(prm[None]).requires_grad_()
    loss = ref.mixture_loss(x, torch.from_numpy(grid[None]),
                            torch.from_numpy(target[None]))
    want, = torch.autograd.grad(loss.sum(), x)
    mloss, got = model_mixture_grad(prm.reshape(-1), grid, target)
    loss = float(loss.detach()[0])
    assert rel_err(got, want.numpy().reshape(-1)) <= GRAD_RTOL
    assert abs(mloss - loss) <= GRAD_RTOL * loss


@pytest.mark.parametrize("seed", range(2))
def test_mixture_kernel_model_equals_plain(seed):
    dist, sizes = random_stream(seed)
    problem = cm.mixture_problem(cm.reuse_histogram(dist, sizes))
    got, gl = model_mixture_fit(*problem, 120, 0.08)
    want, wl = ref.mixture_fit_ref(*[torch.from_numpy(a[None])
                                     for a in problem], 120, 0.08)
    np.testing.assert_allclose(got, want[0].numpy(), rtol=0, atol=MODEL_RTOL)
    assert abs(gl - float(wl[0])) <= MODEL_RTOL * float(wl[0])


# ---------------------------------------------------------------------------
# The inverse solve: the kernel's gradient and loop in numpy
# ---------------------------------------------------------------------------
def warp_sums(x):
    """The plan kernel's sum over the last axis: lane l adds elements l,
    l + 32, ... in order, then the xor tree over the 32 lanes."""
    x = np.asarray(x, np.float64)
    pad = np.zeros(x.shape[:-1] + (-x.shape[-1] % 32,))
    rows = np.concatenate([x, pad], -1)
    rows = rows.reshape(x.shape[:-1] + (-1, 32))
    lanes = np.zeros(x.shape[:-1] + (32,))
    for r in range(rows.shape[-2]):
        lanes = lanes + rows[..., r, :]
    idx = np.arange(32)
    for m in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[..., idx ^ m]
    return lanes[..., 0]


class PlanModel:
    """``plan_solve``'s algorithm for one plan, as the CUDA source runs
    it: per-cache sums, fleet totals, the groups' member lists in cache
    order and the analytic gradient."""

    def __init__(self, stacked, per_cache, gidx, gsize, scalars):
        self.centers, self.refw, self.bytew = stacked
        self.total_refs, self.tb, self.of = per_cache
        self.gidx, self.gs = np.asarray(gidx), np.asarray(gsize, float)
        (self.target, self.budget, self.lo, self.hi, self.tau, self.lr,
         self.penalty, self.rho_growth) = scalars
        self.has_budget = not math.isnan(self.budget)
        self.bdiv = self.budget if self.budget > 1.0 else 1.0
        self.total = max(warp_sums(self.total_refs), 1.0)
        self.members = [np.nonzero(self.gidx == g)[0]
                        for g in range(len(gsize))]

    def evaluate(self, v):
        """(hr, hb, dr, db) per cache at log-capacities v (N,)."""
        with np.errstate(over="ignore"):
            logc = np.log(np.maximum(np.exp(v), 1.0))
            z = (logc[:, None] - self.centers) / self.tau
            s = 1.0 / (1.0 + np.exp(-z))
        ds = s * (1.0 - s)
        return (warp_sums(self.refw * s), warp_sums(self.bytew * s),
                warp_sums(self.refw * ds), warp_sums(self.bytew * ds))

    def totals(self, hr, hb):
        return (warp_sums(hr) / self.total,
                warp_sums(self.of * (self.tb - hb)))

    def group_ct(self, k, eu, ct_hits, ct_egress, dr, db, budget):
        acc = 0.0
        if eu > 1.0:
            for c in self.members[k]:
                ct = ct_hits * dr[c]
                if budget:
                    ct = ct - ct_egress * (self.of[c] * db[c])
                acc += (ct / self.tau) / eu
        return acc

    def grad(self, u, nu, nu2, rho, inv_scale):
        """∂L/∂u of the augmented Lagrangian at u (G,)."""
        hr, hb, dr, db = self.evaluate(u[self.gidx])
        hit, egress = self.totals(hr, hb)
        aug = max(nu + rho * (self.target - hit), 0.0)
        ct_hits = -(((1.0 / (2.0 * rho)) * (2.0 * aug)) * rho) / self.total
        ct_egress = 0.0
        if self.has_budget:
            aug2 = max(nu2 + rho * ((egress - self.budget) / self.bdiv), 0.0)
            ct_egress = (((1.0 / (2.0 * rho)) * (2.0 * aug2)) * rho) \
                / self.bdiv
        out = np.empty(len(u))
        for k in range(len(u)):
            eu = math.exp(u[k])
            acc = self.group_ct(k, eu, ct_hits, ct_egress, dr, db,
                                self.has_budget)
            out[k] = (inv_scale * self.gs[k]) * eu + acc * eu
        return out

    def feasible(self, v):
        hr, hb, _, _ = self.evaluate(v)
        hit, egress = self.totals(hr, hb)
        return hit >= self.target and (not self.has_budget
                                       or egress <= self.budget)

    def bisect(self, a, b, at):
        for _ in range(ref.PLAN_BISECT_STEPS):
            mid = 0.5 * (a + b)
            good = self.feasible(at(mid))
            a, b = (a, mid) if good else (mid, b)
        return b

    def solve(self, steps):
        G, N = len(self.gs), len(self.gidx)
        u_uni = self.bisect(self.lo, self.hi, lambda m: np.full(N, m))
        u = np.full(G, u_uni)
        s = warp_sums(self.gs * math.exp(u_uni))
        inv_scale = 1.0 / (s if s > 1.0 else 1.0)
        mom, vel = np.zeros(G), np.zeros(G)
        nu, nu2, rho = 0.0, 0.0, self.penalty
        inner = max(steps // ref.PLAN_ROUNDS, 1)
        for r in range(ref.PLAN_ROUNDS):
            for i in range(inner):
                g = self.grad(u, nu, nu2, rho, inv_scale)
                t = r * inner + i + 1.0
                bc1, bc2 = 1.0 - 0.9 ** t, 1.0 - 0.99 ** t
                mom = 0.9 * mom + 0.1 * g
                vel = 0.99 * vel + 0.01 * g * g
                u = np.minimum(np.maximum(
                    u - self.lr * (mom / bc1) / (np.sqrt(vel / bc2) + 1e-8),
                    self.lo), self.hi)
            hr, hb, _, _ = self.evaluate(u[self.gidx])
            hit, egress = self.totals(hr, hb)
            nu = max(nu + rho * (self.target - hit), 0.0)
            if self.has_budget:
                nu2 = max(nu2 + rho * (egress - self.budget) / self.bdiv,
                          0.0)
            rho = rho * self.rho_growth
        shift = self.bisect(-8.0, 8.0, lambda m: u[self.gidx] + m)
        u = np.minimum(np.maximum(u + shift, self.lo), self.hi)
        hr, hb, dr, _ = self.evaluate(u[self.gidx])
        hit, egress = self.totals(hr, hb)
        gk = np.array([self.group_ct(k, math.exp(u[k]), 1.0 / self.total,
                                     0.0, dr, dr, False) * math.exp(u[k])
                       for k in range(G)])
        return np.concatenate([np.exp(u), [math.exp(u_uni), hit, egress,
                                           math.sqrt(warp_sums(gk * gk))]])


def plan_inputs(seed, n_caches=5, groups=3, budget=None, buckets=64,
                min_capacity=64e6):
    """One random plan's inputs for ``ops.plan_solve`` (numpy, batch 1):
    hist models of random streams, caches dealt to groups in turn."""
    from repro_torch.core import planner
    models = {f"c{i:02d}": dataclasses.replace(
        models_for(seed * 31 + i, buckets)["hist"],
        origin_fraction=0.4 + 0.6 * (i % 2)) for i in range(n_caches)}
    stacked = cm.stack_models(models)
    gidx = np.arange(n_caches) % groups
    gsize = np.bincount(gidx, minlength=groups).astype(float)
    spec = planner.PlannerSpec(models=models, target_hit_rate=0.5,
                               target_egress_bytes=budget,
                               min_capacity=min_capacity)
    return planner.solve_inputs(stacked, gidx, gsize, spec), spec


def egress_budget(inp):
    """An egress budget that binds: below the egress of the unbudgeted
    plan's capacities, above the egress at the largest capacity."""
    out = ref.plan_solve_ref(*[torch.from_numpy(inp[k]) for k in (
        "stacked", "per_cache", "gidx", "gsize", "scalars")], 600)[0]
    G = inp["gsize"].shape[1]
    return float(out[G + 2]) * 0.9


GRAD_CASES = {"no budget": dict(),
              "budget": dict(budget=True),
              "below the clamp": dict(min_capacity=0.01)}


@pytest.mark.parametrize("case", list(GRAD_CASES))
def test_plan_gradient_model_equals_autograd(case):
    kw = dict(GRAD_CASES[case])
    inp, _ = plan_inputs(7, min_capacity=kw.get("min_capacity", 64e6))
    if kw.get("budget"):
        inp["scalars"][0, 1] = egress_budget(inp)
    model = PlanModel(*(inp[k][0] for k in ("stacked", "per_cache", "gidx",
                                             "gsize", "scalars")))
    rng = np.random.default_rng(3)
    u = np.log(np.array([2e9, 5e8, 8e9]))
    if case == "below the clamp":
        u[1] = -0.5                  # C = e^-0.5 < 1: no constraint term
    nu, nu2, rho = 0.3, 0.2, 17.0
    stacked, per_cache = (torch.from_numpy(inp[k][0])
                          for k in ("stacked", "per_cache"))
    gidx = torch.from_numpy(inp["gidx"][0])
    gsize = torch.from_numpy(inp["gsize"][0])
    centers, refw, bytew = stacked
    total_refs, tb, of = per_cache
    total = torch.clamp(total_refs.sum(), min=1.0)
    u0 = torch.from_numpy(u).requires_grad_()
    scale = float(rng.uniform(2e9, 4e9))

    def lag(x):
        caps = torch.exp(x)[gidx]
        logc = torch.log(torch.maximum(caps, torch.ones_like(caps)))
        s = torch.sigmoid((logc[:, None] - centers) / model.tau)
        hit = (refw * s).sum(1).sum() / total
        aug = torch.clamp(nu + rho * (model.target - hit), min=0.0)
        val = (gsize * torch.exp(x)).sum() / scale \
            + (aug ** 2 - nu ** 2) / (2.0 * rho)
        if model.has_budget:
            egress = (of * (tb - (bytew * s).sum(1))).sum()
            aug2 = torch.clamp(nu2 + rho * (egress - model.budget)
                               / model.bdiv, min=0.0)
            val = val + (aug2 ** 2 - nu2 ** 2) / (2.0 * rho)
        return val

    want, = torch.autograd.grad(lag(u0), u0)
    got = model.grad(u, nu, nu2, rho, 1.0 / scale)
    assert rel_err(got, want.numpy()) <= GRAD_RTOL
    if case == "below the clamp":
        assert got[1] == pytest.approx(
            float(gsize[1]) * math.exp(u[1]) / scale, rel=GRAD_RTOL)
    if case == "budget":
        # the budget term is live: dropping it changes the gradient
        model.has_budget = False
        assert rel_err(model.grad(u, nu, nu2, rho, 1.0 / scale),
                       want.numpy()) > 1e-6


@pytest.mark.parametrize("case", ["no budget", "budget"])
def test_plan_kernel_model_equals_plain(case):
    inp, spec = plan_inputs(11)
    if case == "budget":
        inp["scalars"][0, 1] = egress_budget(inp)
    args = [inp[k] for k in ("stacked", "per_cache", "gidx", "gsize",
                             "scalars")]
    want = ref.plan_solve_ref(*[torch.from_numpy(a) for a in args],
                              spec.steps)[0].numpy()
    got = PlanModel(*(a[0] for a in args)).solve(spec.steps)
    assert_plan_close(got, want, inp["gsize"][0], case == "budget")


# ---------------------------------------------------------------------------
# The reference's property, in float64
# ---------------------------------------------------------------------------
def _property_histogram(thresholds, sizes, compulsory):
    dist = np.asarray(thresholds, float)
    dist[:compulsory] = np.inf
    return cm.reuse_histogram(dist, np.asarray(sizes, float))


@settings(max_examples=25, deadline=None)
@given(st.lists(st.floats(1e3, 1e13), min_size=4, max_size=120),
       st.integers(0, 3), st.data())
def test_hist_curve_monotone_and_bounded(thresholds, compulsory, data):
    sizes = [data.draw(st.floats(1.0, t)) for t in thresholds]
    model = cm.fit_histogram_model(_property_histogram(
        thresholds, sizes, min(compulsory, len(thresholds))))
    h = np.array([float(cm.predict_hit_rate(model, c))
                  for c in np.geomspace(1.0, 1e15, 40)])
    assert (h >= 0.0).all() and (h <= 1.0).all()
    assert (np.diff(h) >= -1e-9).all()


@settings(max_examples=10, deadline=None)
@given(st.lists(st.floats(1e3, 1e13), min_size=4, max_size=60), st.data())
def test_mixture_curve_monotone_and_bounded(thresholds, data):
    """The reference's strategy and its 1e-9 bound, on the port's float64
    evaluation (the reference's float32 one breaks the bound on a saved
    example).  The bound holds above 1 as well: where every component's
    erf is 1 the curve is the sum of the softmax weights, and in float64
    that sum rounds to 1 + 2^-52 for about 4.5% of logits, the reference's
    arithmetic included (`tools/reference_want.py --spreads`)."""
    sizes = [data.draw(st.floats(1.0, t)) for t in thresholds]
    model = cm.fit_lognormal_mixture(
        _property_histogram(thresholds, sizes, 0), steps=120, device="cpu")
    h = np.array([float(cm.predict_hit_rate(model, c))
                  for c in np.geomspace(1.0, 1e15, 30)])
    assert (h >= 0.0).all() and (h <= 1.0 + 1e-9).all()
    assert (np.diff(h) >= -1e-9).all()


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    dist, sizes = random_stream(0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cm.fit_lognormal_mixture(cm.reuse_histogram(dist, sizes))


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("steps", [0, 1, 120, 400])
def test_mixture_kernel_equals_plain_on_card(card, steps):
    problems = [cm.mixture_problem(cm.reuse_histogram(*random_stream(s)),
                                   components=2 + s % 5) for s in range(6)]
    for problem in problems:
        args = [torch.from_numpy(a[None]).to(card) for a in problem]
        before = cm.MIXTURE_FIT.launches
        got, gl = ops.mixture_fit(*args, steps, 0.08)
        assert cm.MIXTURE_FIT.launches == before + 1
        want, wl = ref.mixture_fit_ref(*args, steps, 0.08)
        assert_mixture_close(got[0].cpu(), float(gl[0]), want[0].cpu(),
                             float(wl[0]), problem[1])
        again, al = ops.mixture_fit(*args, steps, 0.08)
        assert torch.equal(got, again) and torch.equal(gl, al)


@pytest.mark.gpu
def test_mixture_kernel_batch_equals_single_fits(card):
    problems = [cm.mixture_problem(cm.reuse_histogram(*random_stream(s)))
                for s in range(5)]
    batch = [torch.from_numpy(np.stack([p[i] for p in problems])).to(card)
             for i in range(3)]
    got, gl = ops.mixture_fit(*batch, 200, 0.08)
    for b, problem in enumerate(problems):
        one, ol = ops.mixture_fit(*[torch.from_numpy(a[None]).to(card)
                                    for a in problem], 200, 0.08)
        assert torch.equal(got[b], one[0]) and torch.equal(gl[b], ol[0])


@pytest.mark.gpu
@pytest.mark.parametrize("components", [1, 3, 8])
def test_mixture_kernel_batch_equals_single_fits_by_components(card,
                                                               components):
    """A batch of fits in one launch gives each fit's bits alone, for one
    component, the sweeps' three and the most the kernel serves."""
    problems = [cm.mixture_problem(cm.reuse_histogram(*random_stream(s)),
                                   components=components) for s in range(6)]
    batch = [torch.from_numpy(np.stack([p[i] for p in problems])).to(card)
             for i in range(3)]
    before = cm.MIXTURE_FIT.launches
    got, gl = ops.mixture_fit(*batch, 400, 0.08)
    assert cm.MIXTURE_FIT.launches == before + 1
    for b, problem in enumerate(problems):
        one, ol = ops.mixture_fit(*[torch.from_numpy(a[None]).to(card)
                                    for a in problem], 400, 0.08)
        assert torch.equal(got[b], one[0]) and torch.equal(gl[b], ol[0])


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1, 20, 32, 33])
def test_mixture_kernel_short_grids_equal_plain_on_card(card, m):
    """Grids of at most a warp's points (a block of two warps, the second
    with no point) and just over it, against the plain version on the
    card; a batch of fits equal to each fit alone."""
    problems = []
    for s in range(3):
        p = cm.mixture_problem(cm.reuse_histogram(*random_stream(s)))
        at = np.linspace(0, len(p[1]) - 1, m).round().astype(int)
        problems.append((p[0], p[1][at].copy(), p[2][at].copy()))
    batch = [torch.from_numpy(np.stack([p[i] for p in problems])).to(card)
             for i in range(3)]
    got, gl = ops.mixture_fit(*batch, 400, 0.08)
    for b, problem in enumerate(problems):
        args = [torch.from_numpy(a[None]).to(card) for a in problem]
        one, ol = ops.mixture_fit(*args, 400, 0.08)
        assert torch.equal(got[b], one[0]) and torch.equal(gl[b], ol[0])
        want, wl = ref.mixture_fit_ref(*args, 400, 0.08)
        assert_mixture_close(one[0].cpu(), float(ol[0]), want[0].cpu(),
                             float(wl[0]), problem[1])


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["no budget", "budget", "below the clamp"])
def test_plan_kernel_equals_plain_on_card(card, case):
    inp, spec = plan_inputs(11, min_capacity=0.01 if "clamp" in case
                            else 64e6)
    if case == "budget":
        inp["scalars"][0, 1] = egress_budget(inp)
    args = [torch.from_numpy(inp[k]).to(card) for k in (
        "stacked", "per_cache", "gidx", "gsize", "scalars")]
    before = cm.PLAN_SOLVE.launches
    got = ops.plan_solve(*args, spec.steps)
    assert cm.PLAN_SOLVE.launches == before + 1
    want = ref.plan_solve_ref(*args, spec.steps)
    assert_plan_close(got[0].cpu().numpy(), want[0].cpu().numpy(),
                      inp["gsize"][0], case == "budget")
    again = ops.plan_solve(*args, spec.steps)
    assert torch.equal(got, again)


@pytest.mark.gpu
def test_plan_kernel_serves_252_caches_from_device_memory(card):
    inp, spec = plan_inputs(5, n_caches=252, groups=252)
    args = [torch.from_numpy(inp[k]).to(card) for k in (
        "stacked", "per_cache", "gidx", "gsize", "scalars")]
    got = ops.plan_solve(*args, spec.steps)
    want = ref.plan_solve_ref(*args, spec.steps)
    assert_plan_close(got[0].cpu().numpy(), want[0].cpu().numpy(),
                      inp["gsize"][0], False)


@pytest.mark.gpu
def test_kernels_refuse_sizes_they_do_not_serve(card):
    f64 = dict(dtype=torch.float64, device=card)
    n = cm.PLAN_MAX_CACHES + 1
    with pytest.raises(ValueError, match="N=2049"):
        ops.plan_solve(torch.zeros(1, 3, n, 4, **f64),
                       torch.zeros(1, 3, n, **f64),
                       torch.zeros(1, n, dtype=torch.int64, device=card),
                       torch.ones(1, 1, **f64), torch.zeros(1, 8, **f64),
                       600)
    with pytest.raises(ValueError, match="M=300"):
        ops.mixture_fit(torch.zeros(1, 3, 3, **f64), torch.zeros(1, 300, **f64),
                        torch.zeros(1, 300, **f64), 10, 0.08)
    with pytest.raises(ValueError, match="components"):
        ops.mixture_fit(torch.zeros(1, 3, 9, **f64),
                        torch.zeros(1, 129, **f64),
                        torch.zeros(1, 129, **f64), 10, 0.08)


# Plans of 1 to 2048 caches: below, at and above a warp of caches, not a
# multiple of the cluster's CTAs, 16-CTA clusters (252) and the most served.
CLUSTER_CACHES = [1, 31, 32, 33, 252, 2048]
_PLANS = {}


def cluster_plan(n, groups):
    """``plan_inputs`` of ``n`` caches in ``groups`` groups, made once."""
    if (n, groups) not in _PLANS:
        _PLANS[n, groups] = plan_inputs(3, n_caches=n, groups=groups)
    return _PLANS[n, groups]


@pytest.mark.gpu
@pytest.mark.parametrize("budget", [False, True])
@pytest.mark.parametrize("groups", ["1", "N"])
@pytest.mark.parametrize("n", CLUSTER_CACHES)
def test_plan_kernel_clusters_equal_plain_on_card(card, n, groups, budget):
    """The cluster design against the plain version on the card at every
    cluster size it takes, with G = 1 and G = N, with and without a
    binding egress budget; two launches give the same bits."""
    inp, spec = cluster_plan(n, 1 if groups == "1" else n)
    inp = {k: v.copy() for k, v in inp.items()}
    if budget:
        inp["scalars"][0, 1] = egress_budget(inp)
    args = [torch.from_numpy(inp[k]).to(card) for k in (
        "stacked", "per_cache", "gidx", "gsize", "scalars")]
    g = inp["gsize"].shape[1]
    csize = cm.PLAN_SOLVE.cluster(n, g)
    assert csize in (1, 2, 4, 8, 16) and csize <= n
    before = cm.PLAN_SOLVE.launches
    got = ops.plan_solve(*args, spec.steps)
    assert cm.PLAN_SOLVE.launches == before + 1
    want = ref.plan_solve_ref(*args, spec.steps)
    assert_plan_close(got[0].cpu().numpy(), want[0].cpu().numpy(),
                      inp["gsize"][0], budget)
    again = ops.plan_solve(*args, spec.steps)
    assert torch.equal(got, again)
