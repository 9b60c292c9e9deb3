"""The port's attention against the JAX reference, on the CPU.

Inputs are made with numpy from a seed and handed to both packages; JAX
runs its Pallas kernel in interpret mode and its plain oracle.  The
``gpu`` test holds the CUDA kernel against its plain version on a card.
JAX is imported through the ``jx`` fixture, not at the top of the file:
the machine with the card has no JAX, and there only the ``gpu`` test
runs (``python -m pytest -m gpu tests/test_torch_attention.py``).
"""
import dataclasses
import math
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import (DESIGNS, KERNEL,
                                                  design_for)
from repro_torch.models import attention as attn

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


@pytest.fixture(scope="module")
def jx():
    """The JAX reference: numpy-facing jax, its attention oracle, its
    Pallas kernel and its attention layer."""
    pytest.importorskip("jax", reason="the JAX reference is not installed")
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jax_config
    from repro.kernels import ref as jax_ref
    from repro.kernels.flash_attention import flash_attention
    from repro.models import attention as jax_attn
    return types.SimpleNamespace(jax=jax, jnp=jnp, config=jax_config,
                                 ref=jax_ref, flash=flash_attention,
                                 attn=jax_attn)


def _qkv(b, s, h, kv, hd, seed=0, q_scale=1.0, k_scale=1.0):
    rng = np.random.default_rng(seed)
    q = q_scale * rng.standard_normal((b, s, h, hd))
    k = k_scale * rng.standard_normal((b, s, kv, hd))
    v = rng.standard_normal((b, s, kv, hd))
    return [a.astype(np.float32) for a in (q, k, v)]


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _check_against_jax(jx, arrays, dtype, tol, **kw):
    jq, jk, jv = (jx.jnp.asarray(a, getattr(jx.jnp, dtype)) for a in arrays)
    q, k, v = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays)
    got = ref.attention_ref(q, k, v, **kw).float().numpy()
    want_ref = jx.ref.attention_ref(jq, jk, jv, **kw)
    want_kernel = jx.flash(jq, jk, jv, q_block=64, kv_block=64,
                           interpret=True, **kw)
    _close(got, want_ref.astype(jx.jnp.float32), tol)
    _close(got, want_kernel.astype(jx.jnp.float32), tol)


@pytest.mark.parametrize("b,s,h,kv,hd", [
    (1, 128, 4, 4, 32),      # MHA
    (2, 128, 4, 2, 32),      # GQA 2:1
    (1, 256, 8, 2, 16),      # GQA 4:1
    (1, 96, 2, 1, 32),       # ragged seq
    (1, 128, 8, 2, 256),     # gemma2's head_dim, GQA 4:1
    (1, 128, 4, 4, 96),      # phi3-mini-3.8b's head_dim, MHA
    (2, 128, 4, 2, 64),      # musicgen-medium's head_dim, GQA 2:1
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_matches_jax(jx, b, s, h, kv, hd, dtype):
    _check_against_jax(jx, _qkv(b, s, h, kv, hd), dtype, TOL[dtype],
                       causal=True)


@pytest.mark.parametrize("window", [32, 64])
def test_sliding_window_matches_jax(jx, window):
    _check_against_jax(jx, _qkv(1, 192, 4, 2, 32), "float32",
                       TOL["float32"], causal=True, window=window)


def test_softcap_matches_jax(jx):
    arrays = _qkv(1, 128, 2, 2, 32, q_scale=5.0, k_scale=5.0)
    _check_against_jax(jx, arrays, "float32", 3e-5, causal=True,
                       softcap=50.0)


def test_cpu_dispatch_is_plain_and_kernel_refuses_cpu():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 64, 4, 2, 32))
    before = KERNEL.launches
    got = ops.flash_attention(q, k, v, causal=True, window=16, softcap=50.0)
    want = ref.attention_ref(q, k, v, causal=True, window=16, softcap=50.0)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="not a CUDA device"):
        KERNEL(q, k, v)
    assert KERNEL.launches == before


def test_err_over_tolerance_admits_one_bf16_ulp_only():
    want = torch.from_numpy(4 * np.random.default_rng(0).standard_normal(
        1000).astype(np.float32)).to(torch.bfloat16)
    bits = want.view(torch.int16)
    one_ulp, two_ulps = ((bits + n).view(torch.bfloat16) for n in (1, 2))
    assert ref.err_over_tolerance(one_ulp, want) <= 1.0
    assert ref.err_over_tolerance(two_ulps, want) > 1.0
    f32 = want.float()
    assert ref.err_over_tolerance(f32 + 9e-5, f32) <= 1.0
    assert ref.err_over_tolerance(f32 + 2e-4, f32) > 1.0


# ---------------------------------------------------------------------------
# the wgmma design's arithmetic, rehearsed on the CPU
# ---------------------------------------------------------------------------
def _wgmma_arithmetic(q, k, v, *, window, softcap, p_parts=2,
                      tanh_rel_err=0.0, causal=True):
    """What the wgmma design computes, with its rounding points: fp32
    scores from bf16 q and k, 64-key tiles with a running max, tanh as
    1 - 2/(2^(2x log2 e) + 1) with scale, softcap and log2 e folded into
    two constants, exp2, P as the sum of ``p_parts`` bf16 parts (hi, then
    the rest), the denominator summed from P in fp32, the output times
    1/l, rounded once to bf16.  ``tanh_rel_err`` perturbs tanh by that
    relative error with random signs, a model of tanh.approx."""
    b, s, h, hd = q.shape
    g = h // k.shape[2]
    qf = q.float().transpose(1, 2)
    kf = k.float().repeat_interleave(g, 2).transpose(1, 2)
    vf = v.float().repeat_interleave(g, 2).transpose(1, 2)
    log2e = math.log2(math.e)
    scale = hd ** -0.5
    pre = 2 * log2e * scale / softcap if softcap else scale * log2e
    post = softcap * log2e
    gen = torch.Generator().manual_seed(0)
    m = torch.full((b, h, s), -math.inf)
    l = torch.zeros(b, h, s)
    acc = torch.zeros(b, h, s, hd)
    rows = torch.arange(s)[:, None]
    for c0 in range(0, s, 64):
        cols = torch.arange(c0, min(c0 + 64, s))[None, :]
        sc = qf @ kf[:, :, c0:c0 + 64].transpose(-1, -2)
        if softcap:
            t = 1 - 2 / (torch.exp2(sc * pre) + 1)
            if tanh_rel_err:
                sign = 2 * torch.randint(0, 2, t.shape, generator=gen) - 1
                t = t * (1 + tanh_rel_err * sign)
            z = post * t
        else:
            z = sc * pre
        valid = cols <= rows if causal else torch.ones_like(cols <= rows)
        if window:
            valid &= cols > rows - window
        z = torch.where(valid, z, -math.inf)
        mx = torch.maximum(m, z.amax(-1))
        mu = torch.where(mx == -math.inf, 0.0, mx)
        corr = torch.exp2(m - mu)
        p = torch.exp2(z - mu[..., None])
        l = l * corr + p.sum(-1)
        parts, rest = [], p
        for _ in range(p_parts):
            parts.append(rest.bfloat16().float())
            rest = rest - parts[-1]
        acc = acc * corr[..., None]
        for part in parts:
            acc = acc + part @ vf[:, :, c0:c0 + 64]
        m = mx
    inv = torch.where(l > 0, 1 / l, 0.0)
    return (acc * inv[..., None]).transpose(1, 2).bfloat16()


# gemma2-2b's widths (16 q-heads over 4 KV heads, hd 256), q at 4x
@pytest.mark.parametrize("b,s,window,zero_heads", [
    (1, 320, 0, False), (1, 577, 0, False), (1, 577, 200, False),
    (1, 450, 100, True), (2, 300, 37, False), (1, 129, 0, True)])
def test_wgmma_arithmetic_within_one_bf16_ulp(b, s, window, zero_heads):
    """The kernel's rounding points keep it within one bf16 ulp of the
    plain version, and the same check sees the softcap."""
    q, k, v = (torch.from_numpy(a).bfloat16()
               for a in _qkv(b, s, 16, 4, 256, q_scale=4.0))
    if zero_heads:                 # gemma2-2b's zero pad heads
        q[:, :, 8:] = 0
    want = ref.attention_ref(q, k, v, causal=True, window=window,
                             softcap=50.0)
    got = _wgmma_arithmetic(q, k, v, window=window, softcap=50.0)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert ref.err_over_tolerance(got, want) <= 1.0
    control = _wgmma_arithmetic(q, k, v, window=window, softcap=0.0)
    assert ref.err_over_tolerance(control, want) > 1.0


# mixtral-8x22b's widths (48 q-heads over 8 KV heads, hd 128, no softcap)
@pytest.mark.parametrize("b,s,window", [
    (1, 577, 0), (1, 577, 200), (2, 300, 37), (1, 129, 0)])
def test_wgmma_arithmetic_hd128_within_one_bf16_ulp(b, s, window):
    """The same rounding points at head_dim 128 stay within one bf16 ulp.
    With no softcap to switch off, the control drops the band instead:
    window 0 on a windowed case, no causal mask on the others."""
    q, k, v = (torch.from_numpy(a).bfloat16()
               for a in _qkv(b, s, 48, 8, 128, q_scale=4.0))
    want = ref.attention_ref(q, k, v, causal=True, window=window)
    got = _wgmma_arithmetic(q, k, v, window=window, softcap=0.0)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert ref.err_over_tolerance(got, want) <= 1.0
    control = _wgmma_arithmetic(q, k, v, window=0, softcap=0.0,
                                causal=bool(window))
    assert ref.err_over_tolerance(control, want) > 1.0


@pytest.mark.parametrize("s,window", [(577, 0), (450, 100)])
def test_single_rounding_of_p_misses_one_ulp_at_hd128(s, window):
    """Why P stays two bf16 parts at head_dim 128: rounded once, it fails
    the one-ulp check at mixtral-8x22b's widths too."""
    q, k, v = (torch.from_numpy(a).bfloat16()
               for a in _qkv(1, s, 48, 8, 128, q_scale=4.0))
    want = ref.attention_ref(q, k, v, causal=True, window=window)
    once = _wgmma_arithmetic(q, k, v, window=window, softcap=0.0, p_parts=1)
    assert ref.err_over_tolerance(once, want) > 1.0


@pytest.mark.parametrize("s,window", [(577, 0), (450, 100)])
def test_single_rounding_of_p_or_approx_tanh_misses_one_ulp(s, window):
    """Why the kernel splits P in two bf16 parts and does not use
    tanh.approx: P rounded once to bf16, or tanh off by tanh.approx's
    2^-11 relative error bound, fails the one-ulp check at these shapes."""
    q, k, v = (torch.from_numpy(a).bfloat16()
               for a in _qkv(1, s, 16, 4, 256, q_scale=4.0))
    want = ref.attention_ref(q, k, v, causal=True, window=window,
                             softcap=50.0)
    once = _wgmma_arithmetic(q, k, v, window=window, softcap=50.0, p_parts=1)
    approx = _wgmma_arithmetic(q, k, v, window=window, softcap=50.0,
                               tanh_rel_err=2.0 ** -11)
    assert ref.err_over_tolerance(once, want) > 1.0
    assert ref.err_over_tolerance(approx, want) > 1.0


# phi3-mini-3.8b's widths (32 q-heads over 32 KV heads, hd 96) and
# musicgen-medium's (24 over 24, hd 64), no softcap, no window: engine A's
# two waves, ragged S (S % 64 != 0, S < 128), musicgen's 1,500 frames
@pytest.mark.parametrize("h,hd,b,s", [
    (32, 96, 4, 228), (32, 96, 4, 123), (32, 96, 1, 100), (32, 96, 1, 577),
    (24, 64, 4, 228), (24, 64, 4, 123), (24, 64, 1, 100), (24, 64, 1, 1500)])
def test_wgmma_arithmetic_hd96_hd64_within_one_bf16_ulp(h, hd, b, s):
    """The same rounding points stay within one bf16 ulp at head_dim 96
    and 64, whose larger 1/sqrt(hd) scale sharpens the softmax; P rounded
    once to bf16 still misses, so the split into two parts stays; the
    control drops the causal mask."""
    q, k, v = (torch.from_numpy(a).bfloat16()
               for a in _qkv(b, s, h, h, hd, q_scale=4.0))
    want = ref.attention_ref(q, k, v, causal=True)
    got = _wgmma_arithmetic(q, k, v, window=0, softcap=0.0)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert ref.err_over_tolerance(got, want) <= 1.0
    once = _wgmma_arithmetic(q, k, v, window=0, softcap=0.0, p_parts=1)
    assert ref.err_over_tolerance(once, want) > 1.0
    control = _wgmma_arithmetic(q, k, v, window=0, softcap=0.0, causal=False)
    assert ref.err_over_tolerance(control, want) > 1.0


@pytest.mark.parametrize("dtype,hd", [
    (torch.bfloat16, 80), (torch.bfloat16, 32), (torch.bfloat16, 192),
    (torch.float32, 96), (torch.float32, 64)])
def test_unserved_head_dims_have_no_design(dtype, hd):
    """bf16 at a head dim no config uses, and float32 at 96 and 64, which
    no path needs, stay refused: the wrapper raises before any launch."""
    assert (dtype, hd) not in DESIGNS
    with pytest.raises(ValueError, match="no design"):
        design_for(dtype, hd)


# ---------------------------------------------------------------------------
# attention layer: full-sequence, prefill with cache, decode
# ---------------------------------------------------------------------------
def _layer(jx, window):
    jcfg = dataclasses.replace(jx.config("gemma2-2b", smoke=True),
                               dtype="float32", sliding_window=window)
    cfg = dataclasses.replace(get_config("gemma2-2b", smoke=True),
                              dtype="float32", sliding_window=window)
    jp, _ = jx.attn.init_attention(jx.jax.random.PRNGKey(1), jcfg)
    p = {n: torch.from_numpy(np.array(a)) for n, a in jp.items()}
    return jcfg, cfg, jp, p


def _x(b, s, d, seed=2):
    """Quarter-scale activations.  The reference's fan-in rule for 3-D
    weights (fan_in = heads) gives q and k a std of ~3.5 at unit input, and
    scores of std ~12; there float32 summation order alone moves outputs
    by ~1e-4 through exp.  At a quarter of that scale the comparison holds
    at 1e-5."""
    return 0.25 * np.random.default_rng(seed).standard_normal((b, s, d)) \
        .astype(np.float32)


# (S, window): window < S (banded), window >= S (causal only), global
@pytest.mark.parametrize("s,window", [(40, 16), (12, 16), (40, 0)])
def test_attention_forward_matches_jax(jx, s, window):
    jcfg, cfg, jp, p = _layer(jx, window or 16)
    x = _x(2, s, cfg.d_model)
    pos = np.arange(s)[None, :]
    want = jx.attn.attention_forward(jp, jx.jnp.asarray(x), jcfg,
                                     jx.jnp.asarray(pos), window=window)
    got = attn.attention_forward(p, torch.from_numpy(x), cfg,
                                 torch.from_numpy(pos), window=window)
    _close(got.numpy(), want, 1e-5)


@pytest.mark.parametrize("s,window,max_seq", [
    (40, 16, 64),   # ring cache already wrapped at prefill
    (10, 16, 64),   # ring cache not yet full
    (40, 0, 64),    # dense global cache
])
def test_prefill_then_decode_matches_jax(jx, s, window, max_seq):
    jnp = jx.jnp
    jcfg, cfg, jp, p = _layer(jx, window or 16)
    x = _x(2, s, cfg.d_model)
    pos = np.arange(s)[None, :]
    jout, jcache = jx.attn.prefill_attention(
        jp, jnp.asarray(x), jcfg, jnp.asarray(pos), window, max_seq)
    out, cache = attn.prefill_attention(
        p, torch.from_numpy(x), cfg, torch.from_numpy(pos), window, max_seq)
    _close(out.numpy(), jout, 1e-5)
    for n in "kv":
        _close(cache[n].numpy(), jcache[n], 1e-5)
    for step in range(20):                 # decode past the ring's size
        xt = _x(2, 1, cfg.d_model, seed=10 + step)
        jout, jcache = jx.attn.decode_attention(
            jp, jnp.asarray(xt), jcache, jnp.int32(s + step), jcfg, window)
        out, cache = attn.decode_attention(
            p, torch.from_numpy(xt), cache, s + step, cfg, window)
        _close(out.numpy(), jout, 1e-5)
    for n in "kv":
        _close(cache[n].numpy(), jcache[n], 1e-5)


def test_cross_attention_not_ported(jx):
    """Cross-attention, which raised here while it was not ported, against
    the reference's branch (q from the text, k and v from the image
    states, no RoPE, an f32 softmax, ``tanh(gate)``): with the gate at
    0.5 within 1e-5, in decode too; at its init of 0 the output is 0."""
    jcfg = dataclasses.replace(jx.config("llama-3.2-vision-90b", smoke=True),
                               dtype="float32")
    cfg = dataclasses.replace(get_config("llama-3.2-vision-90b", smoke=True),
                              dtype="float32")
    jp, _ = jx.attn.init_attention(jx.jax.random.PRNGKey(1), jcfg,
                                   cross=True)
    fresh = attn.init_attention(torch.Generator().manual_seed(0), cfg,
                                cross=True)
    assert fresh.keys() == jp.keys() and float(fresh["gate"]) == 0.0
    x, image = _x(2, 6, cfg.d_model), _x(2, 8, cfg.d_model, seed=3)
    pos = torch.arange(6)[None]
    for gate in (0.5, 0.0):
        jp = {**jp, "gate": jx.jnp.float32(gate)}
        p = {n: torch.from_numpy(np.array(a)) for n, a in jp.items()}
        want = jx.attn.attention_forward(
            jp, jx.jnp.asarray(x), jcfg, jx.jnp.asarray(pos.numpy()),
            cross_states=jx.jnp.asarray(image))
        got = attn.attention_forward(p, torch.from_numpy(x), cfg, pos,
                                     cross_states=torch.from_numpy(image))
        _close(got.numpy(), want, 1e-5)
        step = attn.decode_cross_attention(p, torch.from_numpy(x[:, :1]), 6,
                                           cfg, torch.from_numpy(image))
        _close(step.numpy(), want[:, :1], 1e-5)
        assert bool(got.any()) == (gate != 0.0)


# ---------------------------------------------------------------------------
GEMMA2 = (16, 4, 256, 50.0)      # q-heads, KV heads, head_dim, softcap
MIXTRAL = (48, 8, 128, 0.0)
PHI3_MINI = (32, 32, 96, 0.0)
MUSICGEN = (24, 24, 64, 0.0)


def _check_on_card(b, s, window, dtype, zero_heads=False, widths=GEMMA2):
    """Scores of std 4 (q at 4x) put the top scores on the softcap's curve;
    the kernel with the softcap off must fail the same check (with one key
    the softcap cannot change the output).  Without a softcap the control
    drops the band: window 0 on a windowed case, no causal mask on the
    others.  The launch is counted under the design that (dtype, head_dim)
    routes to."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    h, kv, hd, softcap = widths
    arrays = _qkv(b, s, h, kv, hd, q_scale=4.0)
    tensors = [torch.from_numpy(a).to("cuda", getattr(torch, dtype))
               for a in arrays]
    if zero_heads:                 # gemma2-2b's zero pad heads
        tensors[0][:, :, 8:] = 0
    kw = dict(causal=True, window=window, softcap=softcap)
    design = DESIGNS[(tensors[0].dtype, hd)]
    before = KERNEL.launches
    by_design = KERNEL.launches_by_design[design]
    got = ops.flash_attention(*tensors, **kw)
    want = ref.attention_ref(*tensors, **kw)
    torch.cuda.synchronize()
    assert KERNEL.launches == before + 1
    assert KERNEL.launches_by_design[design] == by_design + 1
    assert got.dtype == tensors[0].dtype and got.shape == tensors[0].shape
    assert ref.err_over_tolerance(got, want) <= 1.0
    if s > 1:
        control = KERNEL(*tensors, causal=True, window=window, softcap=0.0) \
            if softcap else KERNEL(*tensors, causal=bool(window), window=0)
        assert ref.err_over_tolerance(control, want) > 1.0


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,window,dtype", [
    (1, 1024, 0, "bfloat16"), (1, 1024, 0, "float32"), (1, 96, 0, "float32"),
    (1, 512, 64, "bfloat16"), (1, 300, 100, "float32"),
    (4, 228, 0, "bfloat16"), (4, 123, 0, "bfloat16"),    # batched waves
    # tile and ring edges of the wgmma design (64 keys, 128 rows, 2 stages)
    (1, 1, 0, "bfloat16"), (1, 63, 0, "bfloat16"), (1, 64, 0, "bfloat16"),
    (1, 65, 0, "bfloat16"), (1, 127, 0, "bfloat16"),
    (1, 128, 0, "bfloat16"), (1, 129, 0, "bfloat16"),
    # windows off the tile grid, one under a tile; B 4 with GQA
    (1, 700, 100, "bfloat16"), (1, 300, 37, "bfloat16"),
    (4, 333, 150, "bfloat16")])
def test_kernel_matches_plain_on_card(b, s, window, dtype):
    _check_on_card(b, s, window, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,window,dtype", [
    # mixtral-8x22b's engines: two waves of batch 4, one windowed prompt
    (4, 228, 0, "bfloat16"), (4, 123, 0, "bfloat16"),
    (1, 4352, 4096, "bfloat16"),
    (1, 1024, 0, "float32"), (1, 300, 100, "float32"), (1, 96, 0, "float32"),
    # tile and ring edges at hd 128 (64 keys, 128 rows, 4 stages)
    (1, 1, 0, "bfloat16"), (1, 63, 0, "bfloat16"), (1, 65, 0, "bfloat16"),
    (1, 129, 0, "bfloat16"), (1, 256, 0, "bfloat16"),
    (1, 257, 0, "bfloat16"), (1, 320, 0, "bfloat16"),
    (1, 577, 0, "bfloat16"), (2, 1000, 0, "bfloat16"),
    # windows off the tile grid, one under a tile, one over the ring
    (1, 700, 100, "bfloat16"), (1, 300, 37, "bfloat16"),
    (4, 333, 150, "bfloat16"), (1, 900, 300, "bfloat16")])
def test_kernel_hd128_matches_plain_on_card(b, s, window, dtype):
    _check_on_card(b, s, window, dtype, widths=MIXTRAL)


@pytest.mark.gpu
def test_kernel_zero_q_heads_on_card():
    """Half the q-heads all zero, as gemma2-2b's 8 pad heads are."""
    _check_on_card(2, 200, 0, "bfloat16", zero_heads=True)


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,window", [
    # phi3-mini-3.8b's engines: engine A's two waves, one 4,000-token prompt
    (4, 228, 0), (4, 123, 0), (1, 4000, 0),
    # tile and ring edges at hd 96 (64 keys, 128 rows, 5 stages: 320 keys;
    # three 32-column slabs), ragged S under 128
    (1, 1, 0), (1, 63, 0), (1, 64, 0), (1, 65, 0), (1, 100, 0),
    (1, 127, 0), (1, 128, 0), (1, 129, 0), (1, 320, 0), (1, 321, 0),
    (1, 385, 0), (2, 1000, 0),
    # windows, which the kernel takes at every head dim
    (1, 700, 100), (1, 300, 37)])
def test_kernel_hd96_matches_plain_on_card(b, s, window):
    _check_on_card(b, s, window, "bfloat16", widths=PHI3_MINI)


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,window", [
    # musicgen-medium's engines: engine A's two waves, 1,500 frames
    (4, 228, 0), (4, 123, 0), (1, 1500, 0),
    # tile and ring edges at hd 64 (64 keys, 128 rows, 8 stages: 512 keys)
    (1, 1, 0), (1, 63, 0), (1, 64, 0), (1, 65, 0), (1, 100, 0),
    (1, 127, 0), (1, 129, 0), (1, 511, 0), (1, 512, 0), (1, 513, 0),
    (1, 577, 0), (2, 1000, 0),
    (1, 700, 100), (1, 300, 37)])
def test_kernel_hd64_matches_plain_on_card(b, s, window):
    _check_on_card(b, s, window, "bfloat16", widths=MUSICGEN)


@pytest.mark.gpu
def test_library_routes_as_designs_on_card():
    """The C entry point routes every pair as ``DESIGNS`` names it (bf16 at
    96 and 64 to ``wgmma``), and refuses the pairs that ``DESIGNS`` lacks;
    the wrapper raises on them before any launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for (dtype, hd), design in DESIGNS.items():
        assert KERNEL.design(dtype, hd) == design
    assert KERNEL.design(torch.bfloat16, 96) == "wgmma"
    assert KERNEL.design(torch.bfloat16, 64) == "wgmma"
    before = KERNEL.launches
    for dtype, hd in ((torch.bfloat16, 80), (torch.float32, 96),
                      (torch.float32, 64)):
        assert KERNEL.design(dtype, hd) is None
        assert KERNEL.smem_bytes(dtype, hd) == -1
        q = torch.zeros(1, 8, 2, hd, dtype=dtype, device="cuda")
        with pytest.raises(ValueError, match="no design"):
            KERNEL(q, q, q)
    assert KERNEL.launches == before
