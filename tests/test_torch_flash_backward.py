"""Flash attention's backward: the plain version against the JAX reference
on the CPU, and the CUDA kernel against the plain version on a card.

The reference has no backward kernel: it trains by ``jax.grad`` through
its plain attention.  So on the CPU ``ref.attention_bwd_ref`` (the
backward kernel's formulas written out in PyTorch) is held to
``jax.grad`` of ``repro.kernels.ref.attention_ref`` and to PyTorch's
autograd through ``ref.attention_ref``, in float32.  The ``gpu`` tests
hold the kernel (``flash_attention.BACKWARD``, reached through
``ops.flash_attention`` under a gradient) to the plain version, each with
a control (dO moved by 1e-2 of its scale) that must fail the same check:
``python -m pytest -m gpu tests/test_torch_flash_backward.py``.  JAX is
imported through the ``jx`` fixture: the machine with the card has none.
"""
import types

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels import flash_attention as fa

# float32 gradients: the plain backward and autograd or jax.grad sum the
# same float32 products in other orders; 2e-5 absolute plus 2e-5 of the
# value covers that at unit-scale inputs
GRAD_TOL = 2e-5
CASES = [  # (causal, window, softcap)
    (True, 0, 0.0), (True, 5, 0.0), (True, 0, 2.0), (True, 7, 3.0),
    (False, 0, 0.0), (False, 4, 0.0)]


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax", reason="the JAX reference is not installed")
    import jax
    import jax.numpy as jnp

    from repro.kernels import ref as jax_ref
    return types.SimpleNamespace(jax=jax, jnp=jnp, ref=jax_ref)


def _arrays(b, s, h, kv, hd, seed=0, q_scale=2.0):
    rng = np.random.default_rng(seed)
    q = q_scale * rng.standard_normal((b, s, h, hd))
    k = rng.standard_normal((b, s, kv, hd))
    v = rng.standard_normal((b, s, kv, hd))
    do = rng.standard_normal((b, s, h, hd))
    return [a.astype(np.float32) for a in (q, k, v, do)]


def _plain_grads(q, k, v, do, **kw):
    _, lse = ref.attention_lse_ref(q, k, v, **kw)
    return ref.attention_bwd_ref(q, k, v, do, lse, kw["causal"],
                                 kw["window"], kw["softcap"])


def _close(got, want, tol=GRAD_TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("causal,window,softcap", CASES)
def test_plain_backward_matches_jax_grad(jx, causal, window, softcap):
    """GQA (8 q-heads over 2 KV heads), a ragged S of 23: the plain
    backward's dq, dk, dv against jax.grad of the reference's attention
    oracle, contracted with the same dO."""
    arrays = _arrays(2, 23, 8, 2, 16)
    kw = dict(causal=causal, window=window, softcap=softcap)

    def loss(q, k, v):
        out = jx.ref.attention_ref(q, k, v, **kw)
        return jx.jnp.sum(out * jx.jnp.asarray(arrays[3]))
    want = jx.jax.grad(loss, argnums=(0, 1, 2))(
        *(jx.jnp.asarray(a) for a in arrays[:3]))
    got = _plain_grads(*(torch.from_numpy(a) for a in arrays), **kw)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("hd,h,kv,window,softcap", [
    (256, 8, 2, 7, 50.0), (256, 4, 2, 0, 3.0), (96, 4, 4, 0, 0.0),
    (96, 4, 4, 6, 0.0), (64, 4, 4, 0, 0.0), (64, 6, 2, 5, 0.0)])
def test_plain_backward_matches_jax_grad_at_model_head_dims(
        jx, hd, h, kv, window, softcap):
    """The head dims the ``wgmma`` design serves: gemma2-2b's 256 with its
    softcap (50, and 3 where it bends the scores) and a window, phi3-mini's
    96 and musicgen's 64 (MHA, and GQA at 64), causal, at a ragged S of
    21: the plain backward against jax.grad of the reference's oracle."""
    arrays = _arrays(1, 21, h, kv, hd, seed=hd + window)
    kw = dict(causal=True, window=window, softcap=softcap)

    def loss(q, k, v):
        out = jx.ref.attention_ref(q, k, v, **kw)
        return jx.jnp.sum(out * jx.jnp.asarray(arrays[3]))
    want = jx.jax.grad(loss, argnums=(0, 1, 2))(
        *(jx.jnp.asarray(a) for a in arrays[:3]))
    got = _plain_grads(*(torch.from_numpy(a) for a in arrays), **kw)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("causal,window,softcap", CASES)
def test_plain_backward_matches_torch_autograd(causal, window, softcap):
    arrays = _arrays(2, 19, 4, 4, 16, seed=1)
    kw = dict(causal=causal, window=window, softcap=softcap)
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in arrays[:3])
    do = torch.from_numpy(arrays[3])
    want = torch.autograd.grad(ref.attention_ref(q, k, v, **kw), (q, k, v),
                               do)
    got = _plain_grads(q.detach(), k.detach(), v.detach(), do, **kw)
    for g, w in zip(got, want):
        _close(g, w)


def test_plain_lse_is_the_rows_logsumexp(jx):
    """lse of the valid scaled, softcapped scores, and the output the
    reference's oracle gives."""
    q, k, v, _ = _arrays(1, 17, 4, 2, 16, seed=2)
    out, lse = ref.attention_lse_ref(*(torch.from_numpy(a)
                                       for a in (q, k, v)),
                                     causal=True, window=6, softcap=3.0)
    want = jx.ref.attention_ref(*(jx.jnp.asarray(a) for a in (q, k, v)),
                                causal=True, window=6, softcap=3.0)
    _close(out, want)
    kr = np.repeat(k, 2, axis=2)
    raw = np.einsum("bshd,bthd->bhst", q.astype(np.float64), kr) / 4.0
    s = 3.0 * np.tanh(raw / 3.0)
    i, j = np.arange(17)[:, None], np.arange(17)[None, :]
    s = np.where((j <= i) & (j > i - 6), s, -np.inf)
    np.testing.assert_allclose(lse.numpy(), np.log(np.exp(s).sum(-1)),
                               rtol=1e-6, atol=1e-6)


def test_saturated_softmax_gradient_is_autograds():
    """Scores of std ~30 (qwen2-7b's random init gives ~300): most rows put
    all their weight on one key, whose true dS is ~0.  The plain backward
    forms D from P and dP and renormalises P, and stays within 2e-5 of
    the largest gradient from autograd; FlashAttention-2's D =
    rowsum(dO ∘ O) over an output rounded to bf16, the control, is 2^-9
    of |dO||O| off in D, and so off by more than 1e-3 of it."""
    q, k, v, do = (torch.from_numpy(a) for a in _arrays(2, 64, 4, 2, 16,
                                                        seed=4,
                                                        q_scale=30.0))
    qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
    want = torch.autograd.grad(ref.attention_ref(qq, kk, vv), (qq, kk, vv),
                               do)
    out, lse = ref.attention_lse_ref(q, k, v)
    got = ref.attention_bwd_ref(q, k, v, do, lse)
    for g, w in zip(got, want):
        assert ((g - w).abs().max() / w.abs().max()).item() <= 2e-5
    kr = k.repeat_interleave(2, dim=2)
    scores = torch.einsum("bshd,bthd->bhst", q, kr) / 4.0
    i = torch.arange(64)
    p = torch.where(i[None, :] <= i[:, None],
                    torch.exp(scores - lse[..., None]), 0.0)
    dp = torch.einsum("bshd,bthd->bhst", do, v.repeat_interleave(2, dim=2))
    dsum = (do * out.bfloat16().float()).sum(-1).transpose(1, 2)
    dq = torch.einsum("bhst,bthd->bshd", p * (dp - dsum[..., None]),
                      kr) / 4.0
    assert ((dq - want[0]).abs().max() / want[0].abs().max()).item() > 1e-3


def test_cpu_gradient_goes_through_plain_autograd():
    """On the CPU ``ops.flash_attention`` under a gradient is the plain
    version's autograd; no kernel count moves."""
    q, k, v, do = (torch.from_numpy(a) for a in _arrays(1, 9, 4, 2, 16))
    q.requires_grad_()
    fwd, bwd = fa.KERNEL.launches, fa.BACKWARD.launches
    out = ops.flash_attention(q, k, v, causal=True)
    (gq,) = torch.autograd.grad(out, (q,), do)
    want = ref.attention_bwd_ref(q.detach(), k, v, do,
                                 ref.attention_lse_ref(q.detach(), k, v)[1])
    _close(gq, want[0])
    assert (fa.KERNEL.launches, fa.BACKWARD.launches) == (fwd, bwd)


@pytest.mark.parametrize("dtype,hd", [
    (torch.bfloat16, 32), (torch.bfloat16, 80), (torch.float32, 64),
    (torch.bfloat16, 16), (torch.float32, 128), (torch.float32, 256),
    (torch.float16, 128)])
def test_backward_refuses_unsupported_pairs(dtype, hd):
    """Only bf16 at 256, 128, 96 and 64 and float32 at 16 have a backward
    design; every other pair raises before any launch, naming the pairs
    it takes."""
    assert (dtype, hd) not in fa.BACKWARD_DESIGNS
    with pytest.raises(ValueError, match="no design") as err:
        fa.backward_design_for(dtype, hd)
    assert "128" in str(err.value) and "16" in str(err.value)


def test_backward_designs_mirror_the_c_router():
    """``BACKWARD_DESIGNS`` is what ``backward_design_of`` in the source
    routes to ``WGMMA`` and ``SIMT``, read from the source, and nothing
    else is routed."""
    src = (fa.LIB.source).read_text()
    body = src.split("Design backward_design_of(int dtype, int HD) {")[1]
    body = body.split("}")[0]
    assert ("if (dtype == 1 && (HD == 64 || HD == 96 || HD == 128 || "
            "HD == 256))\n    return WGMMA;") in body
    assert "if (dtype == 0 && HD == 16) return SIMT;" in body
    assert body.count("return") == 3 and "return NONE;" in body
    assert fa.BACKWARD_DESIGNS == {
        (torch.bfloat16, 256): "wgmma", (torch.bfloat16, 128): "wgmma",
        (torch.bfloat16, 96): "wgmma", (torch.bfloat16, 64): "wgmma",
        (torch.float32, 16): "simt"}


def test_ssd_intra_refuses_a_gradient_on_cuda(monkeypatch):
    """On a CUDA tensor ``ops.ssd_intra`` no longer refuses a gradient: it
    goes to ``SSDIntraFunction`` (the forward kernel, then the backward
    kernel), under ``no_grad`` to the forward kernel alone, and never to
    the plain version.  The CUDA tensors are stood in for (``device.type``
    'cuda'), so the check runs without a card."""
    x = torch.zeros(1, 1, 4, 2, 16, requires_grad=True)

    class OnCard:
        def __init__(self, t):
            self.t = t
            self.device = types.SimpleNamespace(type="cuda")
            self.requires_grad = t.requires_grad
    called = []
    monkeypatch.setattr(ops, "_ssd_kernel",
                        lambda *a: called.append("kernel"))
    monkeypatch.setattr(ops, "_SSDFunction", types.SimpleNamespace(
        apply=lambda *a: called.append("function")))
    monkeypatch.setattr(ref, "ssd_intra_ref",
                        lambda *a: called.append("plain"))
    args = [OnCard(x)] + [OnCard(torch.zeros(1)) for _ in range(4)]
    ops.ssd_intra(*args)
    with torch.no_grad():
        ops.ssd_intra(*args)
    assert called == ["function", "kernel"]


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------
def _on_card(b, s, h, kv, hd, dtype, causal=True, window=0, softcap=0.0,
             seed=0):
    """The forward and backward through ``ops.flash_attention`` and
    autograd against the plain versions on the same inputs: the output
    and lse, then dq, dk, dv within ``ref.err_over_tolerance`` (one bf16
    ulp plus 1e-3 in bf16, 1e-4 in float32); the control (dO + 1e-2 of
    its scale) must fall outside it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    q, k, v, do = (torch.from_numpy(a).to("cuda", dtype)
                   for a in _arrays(b, s, h, kv, hd, seed=seed))
    kw = dict(causal=causal, window=window, softcap=softcap)
    q.requires_grad_()
    k.requires_grad_()
    v.requires_grad_()
    fwd, bwd = fa.KERNEL.launches, fa.BACKWARD.launches
    out = ops.flash_attention(q, k, v, **kw)
    got = torch.autograd.grad(out, (q, k, v), do)
    torch.cuda.synchronize()
    assert (fa.KERNEL.launches, fa.BACKWARD.launches) == (fwd + 1, bwd + 1)
    q, k, v = q.detach(), k.detach(), v.detach()
    o_want, lse_want = ref.attention_lse_ref(q, k, v, **kw)
    o, lse = fa.KERNEL.with_lse(q, k, v, **kw)
    assert ref.err_over_tolerance(o, o_want) <= 1.0
    assert (lse - lse_want).abs().max().item() <= 2e-4
    want = ref.attention_bwd_ref(q, k, v, do, lse, **kw)
    nudged = do + 1e-2 * do.float().std() * torch.randn(
        do.shape, device="cuda", generator=torch.Generator(
            device="cuda").manual_seed(seed)).to(dtype)
    control = fa.BACKWARD(q, k, v, nudged, lse, **kw)
    for g, w, c in zip(got, want, control):
        assert g.dtype == dtype and g.shape == w.shape
        assert ref.err_over_tolerance(g, w) <= 1.0
    assert max(ref.err_over_tolerance(c, w)
               for c, w in zip(control, want)) > 1.0


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,window", [
    (1, 1, 0), (1, 63, 0), (1, 64, 0), (1, 65, 0), (2, 200, 0),
    (1, 300, 100), (1, 129, 37), (4, 512, 0)])
def test_backward_bf16_hd128_on_card(b, s, window):
    """qwen2-7b's widths (32 q-heads over 4 KV heads, hd 128), tile edges
    of 64, windows off the tile grid."""
    _on_card(b, s, 32, 4, 128, torch.bfloat16, window=window)


@pytest.mark.gpu
@pytest.mark.parametrize("hd,h,kv,softcap", [
    (256, 16, 4, 50.0), (256, 16, 4, 0.0), (96, 32, 32, 0.0),
    (64, 24, 24, 0.0)])
@pytest.mark.parametrize("b,s,window", [
    (1, 1, 0), (1, 63, 0), (1, 64, 0), (1, 65, 0), (2, 200, 0),
    (1, 300, 100), (1, 129, 37)])
def test_backward_bf16_model_head_dims_on_card(hd, h, kv, softcap, b, s,
                                               window):
    """The wgmma design at gemma2-2b's widths (16 q-heads over 4, hd 256,
    with and without its softcap of 50), phi3-mini's (32 over 32, hd 96)
    and musicgen's (24 over 24, hd 64): tile edges of 64, windows off the
    tile grid."""
    _on_card(b, s, h, kv, hd, torch.bfloat16, window=window,
             softcap=softcap)


@pytest.mark.gpu
@pytest.mark.parametrize("hd,window", [(128, 0), (64, 9), (256, 40)])
def test_backward_bf16_not_causal_on_card(hd, window):
    """The wgmma design without the causal mask (every key, or a window
    that looks back only)."""
    _on_card(2, 150, 8, 2, hd, torch.bfloat16, causal=False, window=window)


@pytest.mark.gpu
@pytest.mark.parametrize("s,window,softcap,causal", [
    (64, 0, 0.0, True), (100, 0, 0.0, True), (100, 17, 0.0, True),
    (100, 0, 2.0, True), (130, 40, 3.0, True), (70, 0, 0.0, False),
    (70, 9, 0.0, False)])
def test_backward_f32_hd16_on_card(s, window, softcap, causal):
    """The smoke configs' float32 at hd 16 (4 q-heads over 2 KV), with
    windows, a softcap, and no causal mask."""
    _on_card(2, s, 4, 2, 16, torch.float32, causal=causal, window=window,
             softcap=softcap)


@pytest.mark.gpu
def test_backward_is_deterministic_and_routed_on_card():
    """Two backward launches give the same bits (no atomics) at every
    head dim of the wgmma design; the library routes the pairs as
    ``BACKWARD_DESIGNS`` names them and refuses others; an unsupported
    pair under a gradient raises before a launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for (dtype, hd), design in fa.BACKWARD_DESIGNS.items():
        assert fa.BACKWARD.design(dtype, hd) == design
    assert fa.BACKWARD.design(torch.bfloat16, 32) is None
    assert fa.BACKWARD.design(torch.float32, 128) is None
    for hd, softcap in ((128, 0.0), (256, 50.0), (96, 0.0), (64, 0.0)):
        q, k, v, do = (torch.from_numpy(a).to("cuda", torch.bfloat16)
                       for a in _arrays(2, 333, 32, 4, hd))
        kw = dict(window=100 if hd == 256 else 0, softcap=softcap)
        _, lse = fa.KERNEL.with_lse(q, k, v, **kw)
        first = fa.BACKWARD(q, k, v, do, lse, **kw)
        second = fa.BACKWARD(q, k, v, do, lse, **kw)
        for a, b in zip(first, second):
            assert torch.equal(a, b)
    # float32 at 128: the forward serves it, the backward does not
    q = torch.zeros(1, 8, 2, 128, dtype=torch.float32, device="cuda",
                    requires_grad=True)
    before = fa.KERNEL.launches
    with pytest.raises(ValueError, match="no design"):
        ops.flash_attention(q, q.detach(), q.detach())
    assert fa.KERNEL.launches == before
