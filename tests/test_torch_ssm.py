"""The port's Mamba-2 SSM against the JAX reference, on the CPU.

Inputs are made with numpy from a seed and handed to both packages; JAX
runs its Pallas ``ssd_intra`` in interpret mode and its plain oracle.
The ``gpu`` tests hold the CUDA kernel against its plain version on a
card.  JAX is imported through the ``jx`` fixture, not at the top of the
file: the machine with the card has no JAX, and there only the ``gpu``
tests run (``python -m pytest -m gpu tests/test_torch_ssm.py``).
"""
import dataclasses
import math
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import ops, ref
from repro_torch.kernels.ssd_scan import DESIGNS, KERNEL
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


def test_designs_agree_with_the_c_router():
    """``DESIGNS`` and the C entry point's ``design_of`` route every (P, N)
    alike: jamba-1.5-large's (128, 128) to ``wgmma_p128``, a design of its
    own, counted under its own name.  Read from the source, as the library
    cannot be built here."""
    import pathlib
    import re

    from repro_torch.kernels import ssd_scan
    src = (pathlib.Path(ssd_scan.__file__).parent / "csrc" /
           "ssd_scan.cu").read_text()
    codes = {name: int(code) for name, code in
             re.findall(r"(\w+) = (-?\d+)", re.search(
                 r"enum Design \{([^}]*)\}", src).group(1))}
    routed = {(int(p), int(n)): codes[d] for p, n, d in re.findall(
        r"if \(P == (\d+) && N == (\d+)\) return (\w+);", src)}
    assert {pn: ssd_scan._DESIGN_CODES[c] for pn, c in routed.items()} == \
        DESIGNS
    assert DESIGNS[(128, 128)] == "wgmma_p128"
    assert set(KERNEL.launches_by_design) == {"simt", "wgmma", "wgmma_p128"}


@pytest.mark.parametrize("p,n,q,match", [
    (128, 64, 256, r"\(P, N\) = \(128, 64\) not in"),
    (64, 128, 769, "Q=769 above the wgmma design's 768"),
    (128, 128, 769, "Q=769 above the wgmma_p128 design's 768"),
    (128, 128, 768, "not the CUDA device"),     # taken; then the device
])
def test_kernel_refuses_widths_and_q_it_has_no_design_for(p, n, q, match):
    tensors = [torch.zeros(s) for s in ((1, 1, q, 2, p), (1, 1, q, 2),
                                        (1, 1, q, 2), (1, 1, q, n),
                                        (1, 1, q, n))]
    before = dict(KERNEL.launches_by_design)
    with pytest.raises(ValueError, match=match):
        KERNEL(*tensors)
    assert KERNEL.launches_by_design == before


def test_cpu_dispatch_is_plain_and_kernel_refuses_cpu():
    tensors = [torch.from_numpy(a) for a in _intra_inputs(1, 2, 8, 8, 16, 16)]
    before = KERNEL.launches
    assert torch.equal(ops.ssd_intra(*tensors), ref.ssd_intra_ref(*tensors))
    with pytest.raises(ValueError, match="not the CUDA device"):
        KERNEL(*tensors)
    assert KERNEL.launches == before


# ---------------------------------------------------------------------------
# the wgmma design's arithmetic, rehearsed on the CPU
# ---------------------------------------------------------------------------
def _tf32(v):
    """cvt.rna.tf32.f32 with the low 13 bits cleared: float32 rounded to
    10 mantissa bits, to nearest, ties away from zero."""
    bits = v.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _split(v):
    hi = _tf32(v)
    return hi, _tf32(v - hi)


def _cut(v, quantum):
    """v cut toward zero to a multiple of ``quantum``."""
    return torch.trunc(v / quantum) * quantum


def _to_f32_toward_zero(v):
    f = v.float()
    return torch.where(f.double().abs() > v.abs(),
                       torch.nextafter(f, torch.zeros_like(f)), f)


def _wgmma(acc, a, b):
    """One wgmma m64nNk8 .tf32 instruction, acc + a·b for a (..., M, 8)
    and b (..., 8, N), as this rehearsal models the tensor cores' fp32 sum
    (not rounded to nearest): the 8 products are exact; each of them and
    the accumulator is cut toward zero to the 24 bits below the largest
    one's leading bit; the cut addends are summed and the sum cut toward
    zero to float32.  ``acc`` None is an instruction with scale-d 0."""
    prods = a.double()[..., :, :, None] * b.double()[..., None, :, :]
    top = prods.abs().amax(-2)
    if acc is not None:
        top = torch.maximum(top, acc.double().abs())
    quantum = torch.exp2(torch.floor(torch.log2(top.clamp(min=1e-30))) - 23)
    total = _cut(prods, quantum[..., None, :]).sum(-2)
    if acc is not None:
        total = total + _cut(acc.double(), quantum)
    return _to_f32_toward_zero(total)


def _wgmma_ssd_arithmetic(x, dt, cum, b_in, c_in, *, parts=3):
    """What the wgmma design computes at its rounding points: operands
    split hi/lo (``parts`` 3: hi·hi + hi·lo + lo·hi; 1: one TF32 product);
    scores per 32-column chunk in two fresh accumulators (hi·hi; the
    cross terms), added into the scores in fp32; M = S·exp(cum_i −
    cum_j)·dt_j in fp32, masked before exp; the per-head product over
    64-key tiles and 8-key k-steps in the kernel's permuted key order,
    three instructions a k-step into one accumulator."""
    bsz, nc, q, h, p = x.shape
    n = b_in.shape[-1]
    ch, cl = _split(c_in)
    bh, bl = (t.transpose(-1, -2) for t in _split(b_in))
    scores = torch.zeros(bsz, nc, q, q)
    for c0 in range(0, n, 32):
        big = small = None
        for k0 in range(c0, c0 + 32, 8):
            ks = slice(k0, k0 + 8)
            big = _wgmma(big, ch[..., ks], bh[..., ks, :])
            if parts == 3:
                small = _wgmma(small, ch[..., ks], bl[..., ks, :])
                small = _wgmma(small, cl[..., ks], bh[..., ks, :])
        scores = scores + big + (small if parts == 3 else 0.0)
    cum_h = cum.permute(0, 1, 3, 2)                        # B NC H Q
    rows = torch.arange(q)[:, None]
    keys = torch.arange(q)[None, :]
    decay = torch.exp(torch.where(keys <= rows,
                                  cum_h[..., :, None] - cum_h[..., None, :],
                                  -math.inf))
    m = scores[:, :, None] * decay * dt.permute(0, 1, 3, 2)[..., None, :]
    mh, ml = _split(m)
    xh, xl = _split(x.permute(0, 1, 3, 2, 4))              # B NC H Q P
    # k-step j takes keys 8j + 2(k % 4) + k // 4 at k = 0..7
    order = torch.tensor([8 * j + 2 * (k % 4) + k // 4
                          for j in range(-(-q // 8)) for k in range(8)])
    order = order[order < q]
    acc = None
    for k0 in range(0, q, 8):
        ks = order[k0:k0 + 8]
        acc = _wgmma(acc, mh[..., ks], xh[..., ks, :])
        if parts == 3:
            acc = _wgmma(acc, mh[..., ks], xl[..., ks, :])
            acc = _wgmma(acc, ml[..., ks], xh[..., ks, :])
    return acc.permute(0, 1, 3, 2, 4).contiguous()


@pytest.mark.parametrize("b,nc,q,h", [(1, 1, 256, 4), (1, 2, 100, 3)])
def test_wgmma_arithmetic_within_tolerance(b, nc, q, h):
    """mamba2-780m's widths at the model's decay (~0.7 a row): the
    kernel's rounding points stay within the card check's 1e-4 +
    1e-4·|want| of the plain version, and the check sees the decay."""
    x, dt, cum, b_in, c_in = (torch.from_numpy(a) for a in
                              _intra_inputs(b, nc, q, h, 64, 128, decay=1.0))
    want = ref.ssd_intra_ref(x, dt, cum, b_in, c_in)
    got = _wgmma_ssd_arithmetic(x, dt, cum, b_in, c_in)
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    assert ref.err_over_tolerance(got, want, rtol=1e-4) <= 1.0
    control = _wgmma_ssd_arithmetic(x, dt, torch.zeros_like(cum), b_in, c_in)
    assert ref.err_over_tolerance(control, want, rtol=1e-4) > 1.0


@pytest.mark.parametrize("b,nc,q,h", [(1, 1, 256, 2), (1, 2, 123, 2)])
def test_wgmma_p128_arithmetic_within_tolerance(b, nc, q, h):
    """jamba-1.5-large's widths (P 128, N 128): the wgmma_p128 design runs
    each head's P in two 64-column passes over the same scores, each pass
    the P 64 design's arithmetic; within the card check's tolerance, and
    the check sees the decay."""
    x, dt, cum, b_in, c_in = (torch.from_numpy(a) for a in
                              _intra_inputs(b, nc, q, h, 128, 128, decay=1.0))
    want = ref.ssd_intra_ref(x, dt, cum, b_in, c_in)

    def passes(cum):
        return torch.cat([_wgmma_ssd_arithmetic(x[..., c0:c0 + 64], dt, cum,
                                                b_in, c_in)
                          for c0 in (0, 64)], dim=-1)
    got = passes(cum)
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    assert ref.err_over_tolerance(got, want, rtol=1e-4) <= 1.0
    assert ref.err_over_tolerance(passes(torch.zeros_like(cum)), want,
                                  rtol=1e-4) > 1.0


def test_single_tf32_misses_the_check():
    """Why the kernel splits every operand in two TF32 parts: one TF32
    product per product fails the same check by orders of magnitude."""
    x, dt, cum, b_in, c_in = (torch.from_numpy(a) for a in
                              _intra_inputs(1, 1, 256, 4, 64, 128, decay=1.0))
    want = ref.ssd_intra_ref(x, dt, cum, b_in, c_in)
    once = _wgmma_ssd_arithmetic(x, dt, cum, b_in, c_in, parts=1)
    assert ref.err_over_tolerance(once, want, rtol=1e-4) > 10.0


def test_tf32_rounding_is_to_nearest_ties_away():
    v = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11, -(1.0 + 2.0 ** -11),
                      1.0 + 2.0 ** -11 + 2.0 ** -20, 3.0])
    want = torch.tensor([1.0 + 2.0 ** -10, 1.0 + 2 * 2.0 ** -10,
                         -(1.0 + 2.0 ** -10), 1.0 + 2.0 ** -10, 3.0])
    assert torch.equal(_tf32(v), want)
    hi, lo = _split(torch.tensor([math.pi]))
    assert abs(float(hi) + float(lo) - math.pi) < 2.0 ** -21 * math.pi


def test_fragment_layouts_agree_under_the_key_permutation():
    """The kernel's index maps for one 32-key step: the fp32 accumulator
    of the scores (thread t of a warpgroup, register e) and the TF32 A
    fragment of the per-head product (register i of k-step j), fed as
    (e0, e2, e1, e3) of group j, give A[row, k] = M[row, key(k)] with the
    key order that X_h^T is staged in; and the staging's 16-byte stores
    hit 8 distinct bank groups in every quarter-warp."""
    def acc_layout(t, e):          # (row, key) of accumulator register e
        w, lane = divmod(t, 32)
        return (16 * w + lane // 4 + 8 * ((e >> 1) & 1),
                8 * (e >> 2) + 2 * (lane % 4) + (e & 1))

    def a_layout(t, i, j):         # (row, k) of A register i, k-step j
        w, lane = divmod(t, 32)
        return 16 * w + lane // 4 + 8 * (i & 1), 8 * j + lane % 4 + 4 * (i >> 1)

    def key_of(k):                 # the product's k -> the step's key
        return 8 * (k // 8) + 2 * (k % 4) + (k % 8) // 4

    seen = set()
    for t in range(128):
        for j in range(4):
            for i, e in enumerate((4 * j, 4 * j + 2, 4 * j + 1, 4 * j + 3)):
                row, key = acc_layout(t, e)
                a_row, k = a_layout(t, i, j)
                assert (row, key) == (a_row, key_of(k))
                seen.add((a_row, k))
    assert seen == {(r, k) for r in range(64) for k in range(32)}
    assert sorted(key_of(k) for k in range(32)) == list(range(32))

    # X_h^T staging: thread (warp, lane) of the warpgroup holds keys
    # 8 g8 + 2 m + par (m < 4) at P quad pq and writes 16-byte chunk
    # c = 2 g8 + par of rows 4 pq + i, swizzled to chunk c ^ (row % 8)
    placed = set()
    for warp in range(4):
        for quarter in range(4):
            for i in range(4):
                banks = set()
                for r8 in range(8):
                    lane = 8 * quarter + r8
                    g8, par = r8 // 2, r8 % 2
                    pq = lane // 8 + 4 * warp
                    p, c = 4 * pq + i, 2 * g8 + par
                    banks.add(c ^ (p % 8))
                    for m in range(4):   # the chunk's 4 keys
                        k = 4 * c + m
                        assert key_of(k) == 8 * g8 + 2 * m + par
                        placed.add((p, k))
                assert len(banks) == 8
    assert placed == {(p, k) for p in range(64) for k in range(32)}


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
    (1, 2, 256, 6, 64, 128),      # heads not a multiple of the head group
    (4, 3, 8, 8, 16, 16),         # the smoke config's widths
    (1, 3, 255, 48, 64, 128),     # a ragged last key tile
    (1, 2, 256, 50, 64, 128),     # 50 heads: a short last head group
    (4, 4, 256, 48, 64, 128),     # engine C's first wave
    (4, 2, 256, 48, 64, 128),     # engine C's second wave
    (1, 32, 256, 48, 64, 128),    # engine D's prompt
    (1, 32, 256, 128, 128, 128),  # jamba-1.5-large's 8,000-token prompt
    (4, 1, 123, 128, 128, 128),   # jamba's engine A wave: a short Q
])
def test_kernel_matches_plain_on_card(b, nc, q, h, p, n):
    """At the model's decay (~0.7 a row) exp(cum_i − cum_j) overflows
    above the diagonal; the kernel with cum set to 0 (no decay) must fail
    the same check.  The launch is counted under the design that (P, N)
    routes to: wgmma at mamba2-780m's widths, wgmma_p128 at
    jamba-1.5-large's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x, dt, cum, b_in, c_in = (torch.from_numpy(a).cuda() for a in
                              _intra_inputs(b, nc, q, h, p, n, decay=1.0))
    design = DESIGNS[(p, n)]
    assert design == {(64, 128): "wgmma", (128, 128): "wgmma_p128",
                      (16, 16): "simt"}[(p, n)]
    assert KERNEL.design(p, n) == design
    before = KERNEL.launches
    by_design = KERNEL.launches_by_design[design]
    got = ops.ssd_intra(x, dt, cum, b_in, c_in)
    want = ref.ssd_intra_ref(x, dt, cum, b_in, c_in)
    torch.cuda.synchronize()
    assert KERNEL.launches == before + 1
    assert KERNEL.launches_by_design[design] == by_design + 1
    assert got.shape == x.shape and bool(torch.isfinite(got).all())
    assert ref.err_over_tolerance(got, want, rtol=1e-4) <= 1.0
    control = KERNEL(x, dt, torch.zeros_like(cum), b_in, c_in)
    assert ref.err_over_tolerance(control, want, rtol=1e-4) > 1.0
