"""The port's AdamW, its int8 moment codec and the int8 error-feedback
gradient codec against the JAX reference, on the CPU.

Inputs are made with numpy from a seed and handed to both packages.  The
port's moments live in the reference's stacked layout, so after
``state_from_jax`` the two optimizers step the same state: float32 and
bfloat16 moments, and int8 moments whose blocks of 256 are the
reference's (cut over each pattern position's leaves stacked over
groups).  Weight decay follows the reference's stacked rank: a layer's
``norm1`` (d,) is (G, d) there and is decayed; ``final_norm`` is not.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models import params_from_jax, state_from_jax
from repro_torch.sharding import ErrorFeedback, dequantize, quantize, wire_bytes
from repro_torch.train import optimizer as opt
from repro_torch.train.optimizer import AdamWConfig, get, walk

# one AdamW step in float32: the same elementwise formulas; the global
# norm sums its leaves in another order, and XLA may fuse a product into
# an FMA, so parameters and moments agree to a few float32 ulps
F32_TOL = dict(rtol=2e-6, atol=1e-7)


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax", reason="the JAX reference is not installed")
    import jax
    import jax.numpy as jnp

    from repro import models as jmodels
    from repro.configs import get_config as jcfg
    from repro.sharding import compression as jcomp
    from repro.train import optimizer as jopt
    return types.SimpleNamespace(jax=jax, jnp=jnp, models=jmodels,
                                 config=jcfg, comp=jcomp, opt=jopt)


def _np(jx, tree):
    return jx.jax.tree.map(np.asarray, tree)


def _setup(jx, moments, pad=6, seed=0):
    """The reference's smoke params with random norms (not the zero init,
    so that decay shows), random gradients, its fresh optimizer state;
    the port's conversions of all three."""
    cfg = dataclasses.replace(get_config("qwen2-7b", smoke=True),
                              dtype="float32", padded_heads=pad)
    jcfg = dataclasses.replace(jx.config("qwen2-7b", smoke=True),
                               dtype="float32", padded_heads=pad)
    jparams, _ = jx.models.init_lm(jx.jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(seed)
    for block in jparams["blocks"]:
        for name in ("norm1", "norm2"):
            block[name] = jx.jnp.asarray(
                rng.standard_normal(block[name].shape).astype(np.float32))
    jparams["final_norm"] = jx.jnp.asarray(
        rng.standard_normal(jparams["final_norm"].shape).astype(np.float32))
    jgrads = jx.jax.tree.map(lambda p: jx.jnp.asarray(
        0.1 * rng.standard_normal(p.shape).astype(np.float32)), jparams)
    ocfg = dict(lr=1e-2, weight_decay=0.1, moment_dtype=moments,
                warmup_steps=2, total_steps=20)
    jstate = {"params": jparams,
              "opt": jx.opt.init_opt_state(jparams, jx.opt.AdamWConfig(
                  **ocfg))}
    state = state_from_jax(_np(jx, jstate), cfg, device="cpu")
    grads = params_from_jax(_np(jx, jgrads), cfg, device="cpu")
    return cfg, jstate, jgrads, state, grads, ocfg


# ---------------------------------------------------------------------------
def test_schedule_matches_reference(jx):
    for cfg in (AdamWConfig(warmup_steps=5, total_steps=40, lr=3e-3),
                AdamWConfig(warmup_steps=0, total_steps=10),
                AdamWConfig()):
        jcfg = jx.opt.AdamWConfig(**dataclasses.asdict(cfg))
        steps = np.arange(0, cfg.total_steps + 20, dtype=np.int32)
        want = np.asarray(jx.opt.schedule(jcfg, jx.jnp.asarray(steps)))
        got = opt.schedule(cfg, torch.from_numpy(steps))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("shape", [(256,), (1000,), (3, 64), (2, 7, 33)])
def test_q8_codec_matches_reference(jx, shape):
    """Codes and scales equal bit for bit (round half to even on both
    sides), and so the decoded moments."""
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    x[..., 0] = 0.0
    want = jx.opt._q8_encode(jx.jnp.asarray(x))
    got = opt._q8_encode(torch.from_numpy(x))
    assert torch.equal(got["q"], torch.from_numpy(np.asarray(want["q"])))
    assert torch.equal(got["scale"],
                       torch.from_numpy(np.asarray(want["scale"])))
    assert torch.equal(opt._q8_decode(got, shape), torch.from_numpy(
        np.asarray(jx.opt._q8_decode(want, shape))))


def test_quantize_and_wire_bytes_match_reference(jx):
    rng = np.random.default_rng(2)
    x = rng.standard_normal(1000).astype(np.float32)
    x[:10] = [0.5, -0.5, 1.5, 2.5, -2.5, 0, 127, -127, 63.5, 64.5]
    want = jx.comp.quantize(jx.jnp.asarray(x))
    got = quantize(torch.from_numpy(x))
    assert torch.equal(got["q"], torch.from_numpy(np.asarray(want["q"])))
    assert torch.equal(got["scale"],
                       torch.from_numpy(np.asarray(want["scale"])))
    assert torch.equal(dequantize(got, x.shape), torch.from_numpy(
        np.asarray(jx.comp.dequantize(want, x.shape))))
    for shape in ((4096, 4096), (1000,), (3, 5, 7), (256,)):
        assert wire_bytes(shape) == jx.comp.wire_bytes(shape)
        assert wire_bytes(shape, 2) == jx.comp.wire_bytes(shape, 2)


def test_int8_codec_roundtrip_error_bounded():
    """The reference's test: blockwise absmax int8, error ≤ scale/2."""
    x = np.random.default_rng(0).normal(size=(1000,)).astype(np.float32)
    back = dequantize(quantize(torch.from_numpy(x)), x.shape).numpy()
    assert np.max(np.abs(back - x)) <= np.abs(x).max() / 127 * 1.01


def test_error_feedback_matches_reference(jx):
    """20 rounds of ``compress`` on random gradients (float32 and bf16):
    what is sent and the residual equal the reference's bit for bit."""
    rng = np.random.default_rng(3)
    shapes = [(300,), (2, 64, 5)]
    res = [torch.zeros(s) for s in shapes]
    jres = {i: jx.jnp.zeros(s, jx.jnp.float32) for i, s in enumerate(shapes)}
    for _ in range(20):
        g = [rng.standard_normal(s).astype(np.float32) for s in shapes]
        jsent, jres = jx.comp.ErrorFeedback.compress(
            {i: jx.jnp.asarray(a) for i, a in enumerate(g)}, jres)
        sent, res = ErrorFeedback.compress([torch.from_numpy(a) for a in g],
                                           res)
        for i in range(len(shapes)):
            assert torch.equal(sent[i], torch.from_numpy(
                np.asarray(jsent[i])))
            assert torch.equal(res[i], torch.from_numpy(np.asarray(jres[i])))
    g = torch.randn(700).to(torch.bfloat16)
    sent, new = ErrorFeedback.compress([g], [torch.zeros(700)])
    assert sent[0].dtype == torch.bfloat16 and new[0].dtype == torch.float32


def test_error_feedback_carries_residual():
    """The reference's test: tiny gradients quantise to 0 without error
    feedback; with it the sum sent approaches the true sum."""
    g = [torch.full((512,), 1e-6)]
    r = [torch.zeros(512)]
    total = torch.zeros(512)
    for _ in range(200):
        sent, r = ErrorFeedback.compress(g, r)
        total += sent[0]
    true = 200 * 1e-6
    assert abs(total.mean().item() - true) / true < 0.05


@pytest.mark.parametrize("moments", ["float32", "bfloat16", "int8"])
def test_adamw_update_matches_reference(jx, moments):
    """Three steps from the same converted state with the same gradients:
    parameters, moments (int8: codes and scales), step and metrics.
    float32 within ``F32_TOL``; bf16 moments within one bf16 ulp (a value
    a float32 ulp from a rounding midpoint may round the other way);
    int8 codes within one quantum on under 1% of the codes.  A moment
    stored one bf16 ulp or int8 quantum apart changes its element's next
    step, so with those moments up to 8 parameters in all (of ~100,000)
    may differ by more than ``F32_TOL``, and none by more than 2·lr."""
    cfg, jstate, jgrads, state, grads, ocfg = _setup(jx, moments)
    jcfg, pcfg = jx.opt.AdamWConfig(**ocfg), AdamWConfig(**ocfg)
    jp, jo = jstate["params"], jstate["opt"]
    params, ostate = state["params"], state["opt"]
    for step in range(3):
        jp, jo, jm = jx.opt.adamw_update(jgrads, jo, jp, jcfg)
        params, ostate, m = opt.adamw_update(grads, ostate, params, pcfg)
        want = state_from_jax(_np(jx, {"params": jp, "opt": jo}), cfg,
                              device="cpu")
        assert int(ostate["step"]) == int(jo["step"]) == step + 1
        assert m["lr"].item() == float(jm["lr"])
        assert abs(m["grad_norm"].item() / float(jm["grad_norm"]) - 1) < 1e-6
        off = 0
        for path, got in walk(params):
            w = get(want["params"], path)
            diff = (got - w).abs()
            close = diff <= F32_TOL["atol"] + F32_TOL["rtol"] * w.abs()
            assert diff.max().item() <= 2 * ocfg["lr"], path
            off += int((~close).sum())
        assert off == 0 if moments == "float32" else off <= 8, off
        for name in ("mu", "nu"):
            for path, got in walk(ostate[name]):
                w = get(want["opt"][name], path)
                if path[-1] == "q":
                    diff = (got.int() - w.int()).abs()
                    assert diff.max() <= 1 and \
                        (diff > 0).float().mean() < 1e-2, path
                elif moments == "bfloat16":
                    assert got.dtype == torch.bfloat16
                    tol = 2.0 ** -7 * w.float().abs() + 1e-30
                    assert ((got.float() - w.float()).abs() <= tol).all()
                else:
                    np.testing.assert_allclose(got.numpy(), w.numpy(),
                                               rtol=1e-5, atol=1e-12,
                                               err_msg=str(path))


def test_weight_decay_follows_the_stacked_rank(jx):
    """A layer's norms, (G, d) in the reference, are decayed; final_norm
    (d,) is not.  The port's step equals the reference's on both, and a
    step without decay moves the layer norms off the reference's (by
    lr·wd·p ≈ 1e-3) while leaving final_norm where it is: the check sees
    the decay."""
    cfg, jstate, jgrads, state, grads, ocfg = _setup(jx, "float32")
    jp, _, _ = jx.opt.adamw_update(jgrads, jstate["opt"], jstate["params"],
                                   jx.opt.AdamWConfig(**ocfg))
    want = params_from_jax(_np(jx, jp), cfg, device="cpu")
    snapshot = state_from_jax(_np(jx, jstate), cfg, device="cpu")
    params, _, _ = opt.adamw_update(grads, state["opt"], state["params"],
                                    AdamWConfig(**ocfg))
    bare, _, _ = opt.adamw_update(
        grads, snapshot["opt"], snapshot["params"],
        AdamWConfig(**{**ocfg, "weight_decay": 0.0}))
    for layer in range(len(params["blocks"])):
        for name in ("norm1", "norm2"):
            got = params["blocks"][layer][name]
            w = want["blocks"][layer][name]
            np.testing.assert_allclose(got.numpy(), w.numpy(), **F32_TOL)
            assert (bare["blocks"][layer][name] - w).abs().max() > 1e-4
    np.testing.assert_allclose(params["final_norm"].numpy(),
                               want["final_norm"].numpy(), **F32_TOL)
    assert torch.equal(bare["final_norm"], params["final_norm"])


def test_int8_moments_are_cut_over_the_stack(jx):
    """At the smoke width (d 64) a layer's norm does not fill a block of
    256: the reference's int8 moment of ``norm1`` is one block over its 2
    layers' stack.  ``init_opt_state`` and ``state_from_jax`` keep that
    layout (codes and scales bit for bit after a step of the reference),
    and per-layer blocks would have other scales."""
    cfg, jstate, jgrads, state, grads, ocfg = _setup(jx, "int8", pad=0)
    _, jo, _ = jx.opt.adamw_update(jgrads, jstate["opt"], jstate["params"],
                                   jx.opt.AdamWConfig(**ocfg))
    mu = state_from_jax(_np(jx, {"params": jstate["params"], "opt": jo}),
                        cfg, device="cpu")["opt"]["mu"]
    enc = mu["blocks"][0]["norm1"]
    assert tuple(enc["q"].shape) == (1, 256) and enc["scale"].numel() == 1
    assert torch.equal(enc["q"], torch.from_numpy(
        np.asarray(jo["mu"]["blocks"][0]["norm1"]["q"])))
    fresh = opt.init_opt_state(state["params"], AdamWConfig(**ocfg), 1)
    shapes = {p: tuple(t.shape) for p, t in walk(fresh["mu"])}
    want = {tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path):
            tuple(np.shape(v)) for path, v in
            jx.jax.tree_util.tree_flatten_with_path(jo["mu"])[0]}
    assert shapes == want
    m = opt._q8_decode(enc, (2, 64))
    per_layer = [opt._q8_encode(m[g])["scale"] for g in range(2)]
    assert any(not torch.equal(s, enc["scale"]) for s in per_layer)
