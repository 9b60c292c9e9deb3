"""The port's attention against the JAX reference, on the CPU.

Inputs are made with numpy from a seed and handed to both packages; JAX
runs its Pallas kernel in interpret mode and its plain oracle.  The
``gpu`` test holds the CUDA kernel against its plain version on a card.
JAX is imported through the ``jx`` fixture, not at the top of the file:
the machine with the card has no JAX, and there only the ``gpu`` test
runs (``python -m pytest -m gpu tests/test_torch_attention.py``).
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import KERNEL
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


def test_cross_attention_not_ported():
    cfg = get_config("gemma2-2b", smoke=True)
    gen = torch.Generator().manual_seed(0)
    p = attn.init_attention(gen, cfg)
    x = torch.from_numpy(_x(1, 4, cfg.d_model))
    with pytest.raises(NotImplementedError):
        attn.attention_forward(p, x, cfg, torch.arange(4)[None],
                               cross_states=x)


# ---------------------------------------------------------------------------
@pytest.mark.gpu
@pytest.mark.parametrize("b,s,window,dtype", [
    (1, 1024, 0, "bfloat16"), (1, 1024, 0, "float32"), (1, 96, 0, "float32"),
    (1, 512, 64, "bfloat16"), (1, 300, 100, "float32"),
    (4, 228, 0, "bfloat16"), (4, 123, 0, "bfloat16")])   # batched waves
def test_kernel_matches_plain_on_card(b, s, window, dtype):
    """Scores of std 4 (q at 4x) put the top scores on the softcap's curve;
    the kernel with the softcap off must fail the same check."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    arrays = _qkv(b, s, 16, 4, 256, q_scale=4.0)
    tensors = [torch.from_numpy(a).to("cuda", getattr(torch, dtype))
               for a in arrays]
    kw = dict(causal=True, window=window, softcap=50.0)
    before = KERNEL.launches
    got = ops.flash_attention(*tensors, **kw)
    want = ref.attention_ref(*tensors, **kw)
    torch.cuda.synchronize()
    assert KERNEL.launches == before + 1
    assert got.dtype == tensors[0].dtype and got.shape == tensors[0].shape
    assert ref.err_over_tolerance(got, want) <= 1.0
    control = KERNEL(*tensors, causal=True, window=window, softcap=0.0)
    assert ref.err_over_tolerance(control, want) > 1.0
