"""The port's Mamba-2 SSM against the JAX reference, on the CPU.

Inputs are made with numpy from a seed and handed to both packages; JAX
runs its Pallas ``ssd_intra`` in interpret mode and its plain oracle.
The ``gpu`` tests hold the CUDA kernel against its plain version on a
card.  JAX is imported through the ``jx`` fixture, not at the top of the
file: the machine with the card has no JAX, and there only the ``gpu``
tests run (``python -m pytest -m gpu tests/test_torch_ssm.py``).
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import ops, ref
from repro_torch.kernels.ssd_scan import KERNEL
from repro_torch.models import (decode_step, forward, forward_with_cache,
                                init_decode_cache, init_lm, params_from_jax)
from repro_torch.models import ssm

# float32 throughout; the two sides sum in different orders
TOL = 1e-4


@pytest.fixture(scope="module")
def jx():
    """The JAX reference: jax, its SSD oracle and Pallas kernel, its SSM
    layer and its model."""
    pytest.importorskip("jax", reason="the JAX reference is not installed")
    import jax
    import jax.numpy as jnp

    from repro import models as jax_models
    from repro.configs import get_config as jax_config
    from repro.kernels import ref as jax_ref
    from repro.kernels.ssd_scan import ssd_intra
    from repro.models import ssm as jax_ssm
    return types.SimpleNamespace(jax=jax, jnp=jnp, config=jax_config,
                                 ref=jax_ref, ssd_intra=ssd_intra,
                                 ssm=jax_ssm, models=jax_models)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _softplus(a):
    return np.logaddexp(a, 0.0)


def _intra_inputs(b, nc, q, h, p, n, seed=0, decay=0.1):
    """x, dt, cum, b_in, c_in as the reference's kernel tests make them:
    cum is the inclusive cumsum of −decay·softplus(normal) per chunk."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, nc, q, h, p))
    dt = _softplus(rng.standard_normal((b, nc, q, h)))
    cum = np.cumsum(-decay * _softplus(rng.standard_normal((b, nc, q, h))),
                    axis=2)
    b_in = rng.standard_normal((b, nc, q, n))
    c_in = rng.standard_normal((b, nc, q, n))
    return [a.astype(np.float32) for a in (x, dt, cum, b_in, c_in)]


# ---------------------------------------------------------------------------
# ssd_intra
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("b,nc,q,h,p,n", [      # the reference's own cases
    (1, 2, 32, 2, 16, 8),
    (2, 1, 64, 4, 8, 16),
    (1, 3, 16, 1, 32, 4),
])
def test_ssd_intra_matches_jax(jx, b, nc, q, h, p, n):
    arrays = _intra_inputs(b, nc, q, h, p, n)
    got = ops.ssd_intra(*(torch.from_numpy(a) for a in arrays))
    jarrays = [jx.jnp.asarray(a) for a in arrays]
    _close(got, jx.ref.ssd_intra_ref(*jarrays))
    _close(got, jx.ssd_intra(*jarrays, interpret=True))


def test_ssd_intra_masks_before_the_product(jx):
    """A decay of ~0.7 per row, as the model's init gives, makes
    exp(cum_i − cum_j) overflow to inf for j > i over 128 rows; the masked
    pairs must not turn the output into NaN."""
    arrays = _intra_inputs(1, 1, 128, 2, 16, 8, decay=1.0)
    cum = arrays[2]
    assert cum[0, 0, 0, 0] - cum[0, 0, -1, 0] > \
        np.log(np.finfo(np.float32).max)
    got = ops.ssd_intra(*(torch.from_numpy(a) for a in arrays))
    assert torch.isfinite(got).all()
    _close(got, jx.ref.ssd_intra_ref(*(jx.jnp.asarray(a) for a in arrays)))


def test_cpu_dispatch_is_plain_and_kernel_refuses_cpu():
    tensors = [torch.from_numpy(a) for a in _intra_inputs(1, 2, 8, 8, 16, 16)]
    before = KERNEL.launches
    assert torch.equal(ops.ssd_intra(*tensors), ref.ssd_intra_ref(*tensors))
    with pytest.raises(ValueError, match="not the CUDA device"):
        KERNEL(*tensors)
    assert KERNEL.launches == before


# ---------------------------------------------------------------------------
# the SSD scan, the conv and the layer
# ---------------------------------------------------------------------------
def _scan_inputs(b, l, h, p, n, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, l, h, p))
    dt = _softplus(rng.standard_normal((b, l, h)))
    a = -np.exp(0.3 * rng.standard_normal(h))
    b_in = rng.standard_normal((b, l, n))
    c_in = rng.standard_normal((b, l, n))
    return [v.astype(np.float32) for v in (x, dt, a, b_in, c_in)]


@pytest.mark.parametrize("l,chunk,with_h0", [
    (50, 16, False),     # ragged: the last chunk padded by 14 rows
    (50, 16, True),      # ... continuing from a state h0
    (12, 16, False),     # shorter than one chunk: Q = L
    (64, 16, True),      # whole chunks
])
def test_ssd_chunked_matches_jax(jx, l, chunk, with_h0):
    b, h, p, n = 2, 3, 8, 4
    arrays = _scan_inputs(b, l, h, p, n)
    h0 = np.random.default_rng(2).standard_normal((b, h, n, p)) \
        .astype(np.float32) if with_h0 else None
    jh0 = None if h0 is None else jx.jnp.asarray(h0)
    th0 = None if h0 is None else torch.from_numpy(h0)
    want_y, want_h = jx.ssm.ssd_chunked(*(jx.jnp.asarray(a) for a in arrays),
                                        chunk, jh0)
    got_y, got_h = ssm.ssd_chunked(*(torch.from_numpy(a) for a in arrays),
                                   chunk, th0)
    assert got_y.shape == (b, l, h, p) and got_h.shape == (b, h, n, p)
    _close(got_y, want_y)
    _close(got_h, want_h)


def test_causal_conv_matches_jax(jx):
    rng = np.random.default_rng(3)
    u = rng.standard_normal((2, 9, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    _close(ssm._causal_conv(torch.from_numpy(u), torch.from_numpy(w)),
           jx.ssm._causal_conv(jx.jnp.asarray(u), jx.jnp.asarray(w)), 1e-5)


def _layer(jx):
    """The smoke config's SSM layer in float32, with a_log, dt_bias and
    d_skip drawn away from their init values (0, 0, 1)."""
    jcfg = dataclasses.replace(jx.config("mamba2-780m", smoke=True),
                               dtype="float32")
    cfg = dataclasses.replace(get_config("mamba2-780m", smoke=True),
                              dtype="float32")
    jp, _ = jx.ssm.init_ssm(jx.jax.random.PRNGKey(1), jcfg)
    jp = {k: np.array(v) for k, v in jp.items()}
    rng = np.random.default_rng(4)
    h = cfg.ssm_heads
    jp["a_log"] = np.log(rng.uniform(1, 4, h)).astype(np.float32)
    jp["dt_bias"] = rng.uniform(-1, 0, h).astype(np.float32)
    jp["d_skip"] = rng.uniform(0.5, 1.5, h).astype(np.float32)
    p = {k: torch.from_numpy(v) for k, v in jp.items()}
    return jcfg, cfg, {k: jx.jnp.asarray(v) for k, v in jp.items()}, p


@pytest.mark.parametrize("l", [21, 5, 2])   # ragged; under a chunk; < cw − 1
def test_prefill_then_decode_matches_jax(jx, l):
    jcfg, cfg, jp, p = _layer(jx)
    x = (0.5 * np.random.default_rng(5).standard_normal(
        (2, l, cfg.d_model))).astype(np.float32)
    want, jcache = jx.ssm.prefill_ssm(jp, jx.jnp.asarray(x), jcfg)
    got, cache = ssm.prefill_ssm(p, torch.from_numpy(x), cfg)
    _close(got, want)
    assert sorted(cache) == sorted(jcache)
    for name in cache:
        assert cache[name].shape == jcache[name].shape
        _close(cache[name], jcache[name])
    _close(ssm.ssm_forward(p, torch.from_numpy(x), cfg), want)
    xt = (0.5 * np.random.default_rng(6).standard_normal(
        (2, 1, cfg.d_model))).astype(np.float32)
    want, jcache = jx.ssm.ssm_decode(jp, jx.jnp.asarray(xt), jcache, jcfg)
    got, cache = ssm.ssm_decode(p, torch.from_numpy(xt), cache, cfg)
    _close(got, want)
    for name in cache:
        _close(cache[name], jcache[name])


# ---------------------------------------------------------------------------
# the mamba2 smoke model
# ---------------------------------------------------------------------------
def _model(jx, dtype):
    """Reference weights for the smoke config, with the float32 SSM leaves
    drawn away from their init values (0, 0, 1), which bf16 holds
    exactly."""
    jcfg = dataclasses.replace(jx.config("mamba2-780m", smoke=True),
                               dtype=dtype)
    cfg = dataclasses.replace(get_config("mamba2-780m", smoke=True),
                              dtype=dtype)
    jp, _ = jx.models.init_lm(jx.jax.random.PRNGKey(0), jcfg)
    tree = jx.jax.tree.map(np.array, jp)
    rng = np.random.default_rng(7)
    for block in tree["blocks"]:
        mixer = block["mixer"]
        shape = mixer["a_log"].shape          # (num_groups, H)
        mixer["a_log"] = np.log(rng.uniform(1, 4, shape)).astype(np.float32)
        mixer["dt_bias"] = rng.uniform(-1, 0, shape).astype(np.float32)
        mixer["d_skip"] = rng.uniform(0.5, 1.5, shape).astype(np.float32)
    jp = jx.jax.tree.map(jx.jnp.asarray, tree)
    return jcfg, cfg, jp, params_from_jax(tree, cfg, device="cpu")


def _close_model(got, want, dtype):
    """float32: elementwise within 1e-4 (summation order only).  bfloat16:
    the two frameworks round the bf16 activations at different places, so
    the largest error is held to 5% of the tensor's largest magnitude
    (one bf16 rounding is 0.4%; two layers of them measured 1.4–2.1%)."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    if dtype == "float32":
        _close(got, want)
    else:
        assert np.abs(got - want).max() <= 5e-2 * np.abs(want).max()


def _check_caches(caches, jax_caches, dtype):
    """The port's caches are per layer; the reference's are stacked over
    groups (one pattern position for the SSM family).  Every leaf has the
    reference's dtype: ``h`` float32, the conv history the model's."""
    for layer, c in enumerate(caches):
        for name, leaf in c.items():
            want = jax_caches[0][name][layer]
            assert leaf.dtype == getattr(torch, str(want.dtype))
            _close_model(leaf.float(), want.astype(np.float32), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_prefill_decode_match_jax(jx, dtype):
    jnp = jx.jnp
    jcfg, cfg, jp, p = _model(jx, dtype)
    for bp in p["blocks"]:             # the leaves the reference keeps f32
        for name in ssm.FLOAT32_LEAVES:
            assert bp["mixer"][name].dtype == torch.float32
        assert bp["mixer"]["in_x"].dtype == getattr(torch, dtype)
    tokens = np.random.default_rng(8).integers(0, cfg.vocab_size, (2, 21))

    want, _ = jx.models.forward(jp, jnp.asarray(tokens), jcfg, remat=False)
    got, aux = forward(p, torch.from_numpy(tokens), cfg)
    assert got.dtype == torch.float32 and float(aux) == 0.0
    _close_model(got, want, dtype)

    want, jcache, _ = jx.models.forward_with_cache(jp, jnp.asarray(tokens),
                                                   jcfg, max_seq=64)
    got, cache, _ = forward_with_cache(p, torch.from_numpy(tokens), cfg,
                                       max_seq=64)
    _close_model(got, want, dtype)
    _check_caches(cache, jcache, dtype)

    tok = np.array(jnp.argmax(want[:, -1], axis=-1))
    for step in range(5):
        pos = tokens.shape[1] + step
        want, jcache = jx.models.decode_step(jp, jcache,
                                             jnp.asarray(tok, jnp.int32),
                                             jnp.int32(pos), jcfg)
        got, cache = decode_step(p, cache, torch.from_numpy(tok), pos, cfg)
        _close_model(got, want, dtype)
        tok = np.array(jnp.argmax(want, axis=-1))
    _check_caches(cache, jcache, dtype)


def test_fresh_decode_cache_matches_jax(jx):
    """A fresh SSM cache is float32 whatever dtype is asked for, as the
    reference's is."""
    cfg = get_config("mamba2-780m", smoke=True)
    jcache, _ = jx.models.init_decode_cache(
        jx.config("mamba2-780m", smoke=True), 3, 32)
    cache = init_decode_cache(cfg, 3, 32, device="cpu")
    assert len(cache) == cfg.num_layers
    for layer, c in enumerate(cache):
        for name, leaf in c.items():
            want = np.asarray(jcache[0][name][layer])
            assert leaf.dtype == getattr(torch, str(want.dtype))
            assert tuple(leaf.shape) == want.shape and not leaf.any()


def test_init_lm_layout_matches_converted(jx):
    _, cfg, _, converted = _model(jx, "bfloat16")
    fresh = init_lm(cfg, seed=0, device="cpu")

    def layout(tree):
        if isinstance(tree, dict):
            return {k: layout(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [layout(v) for v in tree]
        return (tuple(tree.shape), tree.dtype)
    assert layout(fresh) == layout(converted)


# ---------------------------------------------------------------------------
@pytest.mark.gpu
@pytest.mark.parametrize("b,nc,q,h,p,n", [
    (1, 4, 256, 48, 64, 128),     # mamba2-780m's widths
    (2, 1, 100, 48, 64, 128),     # a prompt shorter than the chunk
    (1, 2, 256, 6, 64, 128),      # heads not a multiple of the block's 4
    (4, 3, 8, 8, 16, 16),         # the smoke config's widths
])
def test_kernel_matches_plain_on_card(b, nc, q, h, p, n):
    """At the model's decay (~0.7 a row) exp(cum_i − cum_j) overflows
    above the diagonal; the kernel with cum set to 0 (no decay) must fail
    the same check."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x, dt, cum, b_in, c_in = (torch.from_numpy(a).cuda() for a in
                              _intra_inputs(b, nc, q, h, p, n, decay=1.0))
    before = KERNEL.launches
    got = ops.ssd_intra(x, dt, cum, b_in, c_in)
    want = ref.ssd_intra_ref(x, dt, cum, b_in, c_in)
    torch.cuda.synchronize()
    assert KERNEL.launches == before + 1
    assert got.shape == x.shape and bool(torch.isfinite(got).all())
    assert ref.err_over_tolerance(got, want, rtol=1e-4) <= 1.0
    control = KERNEL(x, dt, torch.zeros_like(cum), b_in, c_in)
    assert ref.err_over_tolerance(control, want, rtol=1e-4) > 1.0
