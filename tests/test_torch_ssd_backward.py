"""ssd_intra's backward: the plain version against the JAX reference on
the CPU, a numpy model of the CUDA kernel's three launches, and the
kernel against the plain version on a card.

The reference has no backward kernel: it trains by ``jax.grad`` through
its plain jnp.  So on the CPU ``ref.ssd_intra_bwd_ref`` (the backward
kernel's formulas written out in PyTorch) is held to ``jax.grad`` of
``repro.kernels.ref.ssd_intra_ref`` and to PyTorch's autograd through
``ref.ssd_intra_ref``, in float32; where the reference's float32 gradient
overflows (a 256-row chunk at the model's decay: exp(cum_i − cum_j) past
float32's range above the diagonal, 0·inf = NaN) the yardstick is the
reference's gradient in float64.  The ``gpu`` tests hold the kernel
(``ssd_scan.BACKWARD``, reached through ``ops.ssd_intra`` under a
gradient) to the plain version in float64 on the card, with two controls
that must fail the same check, and two launches to the same bits:
``python -m pytest -m gpu tests/test_torch_ssd_backward.py``.  JAX is
imported through the ``jx`` fixture: the machine with the card has none.
"""
import pathlib
import re
import types

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd_scan
from repro_torch.models import ssm

# float32 gradients: the plain backward and autograd or jax.grad sum the
# same float32 products in other orders (sums of up to Q·P terms); 1e-4
# absolute plus 1e-4 of the value covers that at unit-scale inputs
GRAD_TOL = 1e-4
# a float32 gradient against a float64 one, over each output's largest
# magnitude: float32 sums of these lengths (up to Q·P and H·Q terms) lie
# within 1e-6 of float64 there, the plain version and the kernel's model
# alike
F64_TOL = 1e-5
# ssd_chunked's whole gradient against the float64 one: cum = cumsum(dt·a)
# reaches ~200 over a 256-row chunk, where float32's ulp is 1.5e-5, and
# each decay exp(cum_i − cum_j) carries that error into every gradient
# (a's most: both float32 routes land 4.3e-5 from float64 there)
CHUNK_F64_TOL = 2e-4
REF_CASES = [(1, 2, 32, 2, 16, 8), (2, 1, 64, 4, 8, 16), (1, 3, 16, 1, 32, 4)]
NAMES = ("dx", "ddt", "dcum", "db", "dc")


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax", reason="the JAX reference is not installed")
    import jax
    import jax.numpy as jnp
    from jax.experimental import enable_x64

    from repro.kernels import ref as jax_ref
    from repro.models import ssm as jax_ssm
    return types.SimpleNamespace(jax=jax, jnp=jnp, ref=jax_ref, ssm=jax_ssm,
                                 enable_x64=enable_x64)


def _softplus(a):
    return np.logaddexp(a, 0.0)


def _inputs(b, nc, q, h, p, n, seed=0, decay=0.1):
    """x, dt, cum, b_in, c_in as the reference's kernel tests make them
    (cum the inclusive cumsum of −decay·softplus(normal) per chunk), and
    dy, all float32."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, nc, q, h, p))
    dt = _softplus(rng.standard_normal((b, nc, q, h)))
    cum = np.cumsum(-decay * _softplus(rng.standard_normal((b, nc, q, h))),
                    axis=2)
    b_in = rng.standard_normal((b, nc, q, n))
    c_in = rng.standard_normal((b, nc, q, n))
    dy = rng.standard_normal((b, nc, q, h, p))
    return [a.astype(np.float32) for a in (x, dt, cum, b_in, c_in, dy)]


def _close(got, want, tol=GRAD_TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _off(got, want) -> float:
    """|got − want|'s largest element over want's largest magnitude."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


# ---------------------------------------------------------------------------
# The plain backward against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("b,nc,q,h,p,n", REF_CASES)
def test_plain_backward_matches_jax_grad(jx, b, nc, q, h, p, n):
    """The reference's own kernel cases (decay 0.1): dx, ddt, dcum, db, dc
    against jax.grad of its oracle, contracted with the same dy."""
    arrays = _inputs(b, nc, q, h, p, n)

    def loss(*args):
        return jx.jnp.sum(jx.ref.ssd_intra_ref(*args)
                          * jx.jnp.asarray(arrays[5]))
    want = jx.jax.jit(jx.jax.grad(loss, argnums=(0, 1, 2, 3, 4)))(
        *(jx.jnp.asarray(a) for a in arrays[:5]))
    got = ref.ssd_intra_bwd_ref(*(torch.from_numpy(a) for a in arrays))
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("b,nc,q,h,p,n", REF_CASES)
def test_plain_backward_matches_autograd(b, nc, q, h, p, n):
    """The same against PyTorch's autograd through the masked
    ``ssd_intra_ref``."""
    arrays = [torch.from_numpy(a) for a in _inputs(b, nc, q, h, p, n)]
    leaves = [a.clone().requires_grad_() for a in arrays[:5]]
    want = torch.autograd.grad(ref.ssd_intra_ref(*leaves), leaves, arrays[5])
    got = ref.ssd_intra_bwd_ref(*arrays)
    for g, w in zip(got, want):
        _close(g, w)


class _KernelRoute(torch.autograd.Function):
    """The card's autograd path on the CPU: the forward's plain version,
    then the backward's (``ref.ssd_intra_bwd_ref``), as
    ``SSDIntraFunction`` runs the two kernels."""

    @staticmethod
    def forward(ctx, x, dt, cum, b_in, c_in):
        ctx.save_for_backward(x, dt, cum, b_in, c_in)
        return ref.ssd_intra_ref(x, dt, cum, b_in, c_in)

    @staticmethod
    def backward(ctx, dy):
        return ref.ssd_intra_bwd_ref(*ctx.saved_tensors, dy.contiguous())


def _chunked_arrays(bsz, l, h, p, n, seed, decay_scale=1.0, with_h0=True):
    """ssd_chunked's inputs: x, dt (softplus of a normal), a (−1 at the
    model's ``a_log = 0`` init, times ``decay_scale``), B, C, h0, and the
    cotangents of y and the final state."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((bsz, l, h, p))
    dt = _softplus(rng.standard_normal((bsz, l, h)))
    a = -decay_scale * np.ones(h)
    b_in = rng.standard_normal((bsz, l, n))
    c_in = rng.standard_normal((bsz, l, n))
    h0 = rng.standard_normal((bsz, h, n, p)) if with_h0 else None
    dy = rng.standard_normal((bsz, l, h, p))
    dh = rng.standard_normal((bsz, h, n, p))
    f32 = [None if v is None else v.astype(np.float32)
           for v in (x, dt, a, b_in, c_in, h0)]
    return f32, dy.astype(np.float32), dh.astype(np.float32)


def _jax_chunked_grads(jx, args, dy, dh, chunk, dtype):
    """jax.grad of Σ y·dy + Σ h_final·dh through the reference's
    ``ssd_chunked`` in ``dtype`` (x, dt, a, B, C and h0 where given)."""
    jnp = jx.jnp
    n_args = 6 if args[5] is not None else 5

    def loss(*xs):
        y, hf = jx.ssm.ssd_chunked(*xs[:5], chunk,
                                   h0=xs[5] if n_args == 6 else None)
        return jnp.sum(y * jnp.asarray(dy, dtype)) + \
            jnp.sum(hf * jnp.asarray(dh, dtype))
    return jx.jax.jit(jx.jax.grad(loss, argnums=tuple(range(n_args))))(
        *(jnp.asarray(a, dtype) for a in args[:n_args]))


def _port_chunked_grads(args, dy, dh, chunk, route):
    """The same through the port's ``ssd_chunked`` on the CPU: ``ops``
    (autograd through the plain version) or the kernel's route
    (``_KernelRoute``)."""
    leaves = [None if a is None else torch.from_numpy(a).requires_grad_()
              for a in args]
    given = [t for t in leaves if t is not None]

    def run():
        y, hf = ssm.ssd_chunked(*leaves[:5], chunk, h0=leaves[5])
        loss = (y * torch.from_numpy(dy)).sum() + \
            (hf * torch.from_numpy(dh)).sum()
        return torch.autograd.grad(loss, given)
    if route == "ops":
        return run()
    saved = ops.ssd_intra
    ops.ssd_intra = _KernelRoute.apply
    try:
        return run()
    finally:
        ops.ssd_intra = saved


def test_overflowing_chunk_is_finite_and_matches_float64(jx):
    """One 256-row chunk at the model's decay (a = −1, dt softplus of a
    normal): above the diagonal cum_i − cum_j passes float32's exp range,
    so the reference's float32 gradient is NaN in dt, a, B and C.  The
    port's gradient, by autograd through the masked plain version and by
    the backward's formulas, is finite and within ``CHUNK_F64_TOL`` of
    each leaf's largest magnitude of the reference's gradient in
    float64."""
    args, dy, dh = _chunked_arrays(1, 256, 2, 8, 8, seed=3, with_h0=False)
    cum = np.cumsum(args[1] * args[2], axis=1)
    assert (cum[0, 0] - cum[0, -1]).max() > np.log(np.finfo(np.float32).max)
    ref32 = _jax_chunked_grads(jx, args, dy, dh, 256, np.float32)
    finite = [bool(np.isfinite(np.asarray(g)).all()) for g in ref32]
    assert finite == [True, False, False, False, False]   # x; dt, a, B, C
    with jx.enable_x64():
        want = [np.asarray(g) for g in
                _jax_chunked_grads(jx, args, dy, dh, 256, np.float64)]
    for route in ("ops", "kernel"):
        got = _port_chunked_grads(args, dy, dh, 256, route)
        for name, g, w in zip(("x", "dt", "a", "B", "C"), got, want):
            assert bool(torch.isfinite(g).all()), (route, name)
            assert _off(g, w) <= CHUNK_F64_TOL, (route, name, _off(g, w))


@pytest.mark.parametrize("route", ["ops", "kernel"])
def test_ssd_chunked_gradient_matches_jax(jx, route):
    """``ssd_chunked``'s whole gradient (x, dt, a, B, C, h0) with L = 45
    over chunks of 16 (a ragged last chunk) and a decay where the
    reference's float32 gradient is finite, against jax.grad of the
    reference's."""
    args, dy, dh = _chunked_arrays(2, 45, 3, 8, 6, seed=4, decay_scale=0.1)
    want = _jax_chunked_grads(jx, args, dy, dh, 16, np.float32)
    got = _port_chunked_grads(args, dy, dh, 16, route)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        _close(g, w)


# ---------------------------------------------------------------------------
# The kernel's algorithm, modelled on the CPU
# ---------------------------------------------------------------------------
def model_ssd_bwd(x, dt, cum, b_in, c_in, dy, bt=64, hg=8):
    """The backward kernel's three launches (``csrc/ssd_scan.cu``,
    namespace ``bwd``) tile by tile over its workspace, in float32 numpy,
    each tile's products in one matmul: (1) the scores of every tile on or
    below the diagonal; (2) a block a (key tile, head group, batch x
    chunk), each head, each query tile from the diagonal down: G, E (its
    exponent masked before exp), M, dX_j, ddt_j's column sums, T's row
    sums to the key tile's slot, G·E·dt_j summed over the group's heads
    into the group's partial dS; dcum_j starts at −dt_j·ddt_j; (3) the
    partials summed in group order, dC of a query tile with dcum's row
    sums, dB of a key tile.  The workspace starts as NaN, so a slot read
    before it is written shows."""
    bsz, nc, q, h, p = x.shape
    n = b_in.shape[-1]
    f = np.float32
    nt, groups, bcn = -(-q // bt), -(-h // hg), bsz * nc
    qp = nt * bt

    def pad(a, width):
        a = a.reshape((bcn, q) + width)
        return np.concatenate([a, np.zeros((bcn, qp - q) + width, f)], 1)
    xs, dys = pad(x, (h, p)), pad(dy, (h, p))
    dts, cums = pad(dt, (h,)), pad(cum, (h,))
    bs, cs = pad(b_in, (n,)), pad(c_in, (n,))
    scores = np.full((bcn, qp, qp), np.nan, f)
    ds = np.full((groups, bcn, qp, qp), np.nan, f)
    rows = np.full((nt, bcn, qp, h), np.nan, f)
    dx = np.zeros((bcn, qp, h, p), f)
    ddt, dcum = np.zeros((bcn, qp, h), f), np.zeros((bcn, qp, h), f)
    db, dc = np.zeros((bcn, qp, n), f), np.zeros((bcn, qp, n), f)

    def tile(t):
        return slice(t * bt, (t + 1) * bt)
    index = np.arange(qp)
    for bc in range(bcn):                                       # launch 1
        for it in range(nt):
            for jt in range(it + 1):
                scores[bc, tile(it), tile(jt)] = \
                    cs[bc, tile(it)] @ bs[bc, tile(jt)].T
    for jt in range(nt):                                        # launch 2
        for bc in range(bcn):
            for g in range(groups):
                for head in range(g * hg, min(h, (g + 1) * hg)):
                    xj, dtj = xs[bc, tile(jt), head], dts[bc, tile(jt), head]
                    acc, col = np.zeros((bt, p), f), np.zeros(bt, f)
                    for it in range(jt, nt):
                        dyi = dys[bc, tile(it), head]
                        gm = dyi @ xj.T
                        r, c = index[tile(it)][:, None], index[tile(jt)]
                        inside = (c[None, :] <= r) & (r < q)
                        e = np.exp(np.where(
                            inside, cums[bc, tile(it), head][:, None]
                            - cums[bc, tile(jt), head][None, :],
                            -np.inf)).astype(f)
                        se = scores[bc, tile(it), tile(jt)] * e
                        se[~inside] = 0
                        m = se * dtj[None, :]
                        col += (gm * se).sum(0)
                        rows[jt, bc, tile(it), head] = (gm * m).sum(1)
                        part = gm * (e * dtj[None, :])
                        if head == g * hg:
                            ds[g, bc, tile(it), tile(jt)] = part
                        else:
                            ds[g, bc, tile(it), tile(jt)] += part
                        acc += m.T @ dyi
                    ddt[bc, tile(jt), head] = col
                    dcum[bc, tile(jt), head] = -dtj * col
                    dx[bc, tile(jt), head] = acc
    for bc in range(bcn):                                       # launch 3
        for t in range(nt):
            acc = np.zeros((bt, n), f)
            for jt in range(t + 1):
                acc += ds[:, bc, tile(t), tile(jt)].sum(0) @ bs[bc, tile(jt)]
                dcum[bc, tile(t)] += rows[jt, bc, tile(t)]
            dc[bc, tile(t)] = acc
            acc = np.zeros((bt, n), f)
            for it in range(t, nt):
                acc += ds[:, bc, tile(it), tile(t)].sum(0).T @ cs[bc, tile(it)]
            db[bc, tile(t)] = acc
    shapes = (x.shape, dt.shape, cum.shape, b_in.shape, c_in.shape)
    return tuple(o[:, :q].reshape(s)
                 for o, s in zip((dx, ddt, dcum, db, dc), shapes))


@pytest.mark.parametrize("b,nc,q,h,p,n", [
    (1, 1, 256, 3, 64, 128),     # mamba2-780m's widths, one chunk
    (1, 2, 100, 11, 16, 16),     # a ragged key tile; 11 heads: a short group
    (2, 1, 8, 8, 16, 16),        # the smoke config's chunk
])
def test_model_of_the_kernel_matches_float64(b, nc, q, h, p, n):
    """The kernel's split (three launches, the workspace's slots, the
    fixed-order sums, dcum_j's column term as −dt_j·ddt_j) within
    ``F64_TOL`` of the float64 plain version at the model's decay, where
    exp overflows above the diagonal; no NaN from the masked pairs or an
    unwritten slot."""
    arrays = _inputs(b, nc, q, h, p, n, decay=1.0)
    got = model_ssd_bwd(*arrays)
    want = ref.ssd_intra_bwd_ref(*(torch.from_numpy(a).double()
                                   for a in arrays))
    for name, g, w in zip(NAMES, got, want):
        assert np.isfinite(g).all(), name
        assert _off(g, w.numpy()) <= F64_TOL, (name, _off(g, w.numpy()))


def test_column_term_is_dt_times_ddt():
    """T's column sums, Σ_i T_ij, equal dt_j·ddt_j (T_ij = G_ij·S_ij·E_ij·
    dt_j): the kernel's dcum_j starts from that product, and chip_smoke's
    control drops the −j term by adding it back."""
    x, dt, cum, b_in, c_in, dy = (torch.from_numpy(a).double() for a in
                                  _inputs(1, 2, 40, 3, 8, 6, decay=1.0))
    _, ddt, dcum, _, _ = ref.ssd_intra_bwd_ref(x, dt, cum, b_in, c_in, dy)
    e = ref._masked_decay(cum)
    s = torch.einsum("bcqn,bckn->bcqk", c_in, b_in)
    g = torch.einsum("bcihp,bcjhp->bcijh", dy, x)
    t = g * s[..., None] * e * dt[:, :, None]
    torch.testing.assert_close(t.sum(2), dt * ddt, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(dcum, t.sum(3) - dt * ddt, rtol=1e-12,
                               atol=1e-12)


# ---------------------------------------------------------------------------
# The wrapper's rules, without a card
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("p,n,q,match", [
    (128, 64, 256, r"\(P, N\) = \(128, 64\) not in"),
    (64, 128, 769, "Q=769 above the simt_p64 design's 768"),
    (128, 128, 769, "Q=769 above the simt_p128 design's 768"),
    (16, 16, 769, "Q=769 above the simt design's 768"),
    (64, 128, 768, "not the CUDA device"),     # taken; then the device
])
def test_backward_refuses_widths_and_q_it_has_no_design_for(p, n, q, match):
    """The (P, N) and Q checks come before the device check, so they hold
    on any device; the smoke widths' forward takes any Q, its backward
    not above 768."""
    tensors = [torch.zeros(s) for s in ((1, 1, q, 2, p), (1, 1, q, 2),
                                        (1, 1, q, 2), (1, 1, q, n),
                                        (1, 1, q, n), (1, 1, q, 2, p))]
    before = dict(ssd_scan.BACKWARD.launches_by_design)
    with pytest.raises(ValueError, match=match):
        ssd_scan.BACKWARD(*tensors)
    assert ssd_scan.BACKWARD.launches_by_design == before


def test_backward_refuses_a_dy_of_another_shape():
    tensors = [torch.zeros(s) for s in ((1, 1, 8, 2, 16), (1, 1, 8, 2),
                                        (1, 1, 8, 2), (1, 1, 8, 16),
                                        (1, 1, 8, 16), (1, 1, 8, 3, 16))]
    with pytest.raises(ValueError, match=r"dy \(1, 1, 8, 3, 16\)"):
        ssd_scan.BACKWARD(*tensors)


def test_backward_designs_mirror_the_c_router():
    """``BACKWARD_DESIGNS`` is what ``backward_design_of`` in the source
    routes: each forward design's (P, N) to a backward design, nothing
    else; read from the source (the library cannot be built here).  Each
    design is counted under its own name."""
    src = (pathlib.Path(ssd_scan.__file__).parent / "csrc" /
           "ssd_scan.cu").read_text()

    def enum(name):
        return {key: int(code) for key, code in re.findall(
            r"(\w+) = (-?\d+)", re.search(rf"enum {name} \{{([^}}]*)\}}",
                                          src).group(1))}
    forward, backward = enum("Design"), enum("BackwardDesign")
    body = src.split("BackwardDesign backward_design_of(int P, int N) {")[1]
    body = body.split("\n}\n")[0]
    assert "switch (design_of(P, N))" in body
    cases = re.findall(r"case (\w+): return (\w+);", body)
    assert "default: return BWD_NONE;" in body and len(cases) == 3
    by_forward = {ssd_scan._DESIGN_CODES[forward[f]]:
                  ssd_scan._BACKWARD_CODES[backward[b]] for f, b in cases}
    assert {pn: by_forward[d] for pn, d in ssd_scan.DESIGNS.items()} == \
        ssd_scan.BACKWARD_DESIGNS
    assert set(ssd_scan.BACKWARD.launches_by_design) == \
        {"simt", "simt_p64", "simt_p128"}


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------
def _nudged(dy: torch.Tensor, seed: int = 7) -> torch.Tensor:
    """dy moved by 1e-2 of its scale: the control's cotangent."""
    gen = torch.Generator(device=dy.device).manual_seed(seed)
    return dy + 1e-2 * dy.std() * torch.randn(dy.shape, generator=gen,
                                              device=dy.device)


@pytest.mark.gpu
@pytest.mark.parametrize("b,nc,q,h,p,n", [
    (4, 4, 256, 48, 64, 128),      # mamba2-780m's training shape
    (1, 3, 255, 50, 64, 128),      # a ragged key tile, a short head group
    (2, 2, 256, 16, 128, 128),     # jamba-1.5-large's widths
    (4, 1, 123, 8, 128, 128),      # a chunk shorter than 128
    (4, 3, 8, 8, 16, 16),          # the smoke config's widths
    (1, 1, 768, 4, 64, 128),       # the longest Q served
])
def test_backward_matches_plain_on_card(b, nc, q, h, p, n):
    """Through ``ops.ssd_intra`` and autograd at the model's decay (exp
    overflows above the diagonal): one forward and one backward launch,
    counted under the (P, N)'s design; every gradient finite and within
    ``F64_TOL`` of each output's largest magnitude of the float64 plain
    version on the same inputs.  Controls that must fail the same check:
    dcum without its −j term, and dy moved by 1e-2 of its scale.  Two
    launches give the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    arrays = [torch.from_numpy(a).cuda()
              for a in _inputs(b, nc, q, h, p, n, decay=1.0)]
    design = ssd_scan.BACKWARD_DESIGNS[(p, n)]
    assert ssd_scan.BACKWARD.design(p, n) == design
    leaves = [a.clone().requires_grad_() for a in arrays[:5]]
    fwd, bwd = ssd_scan.KERNEL.launches, ssd_scan.BACKWARD.launches
    by_design = ssd_scan.BACKWARD.launches_by_design[design]
    got = torch.autograd.grad(ops.ssd_intra(*leaves), leaves, arrays[5])
    torch.cuda.synchronize()
    assert (ssd_scan.KERNEL.launches, ssd_scan.BACKWARD.launches) == \
        (fwd + 1, bwd + 1)
    assert ssd_scan.BACKWARD.launches_by_design[design] == by_design + 1
    want = ref.ssd_intra_bwd_ref(*(a.double() for a in arrays))
    for name, g, w in zip(NAMES, got, want):
        assert g.shape == w.shape and bool(torch.isfinite(g).all()), name
        off = ((g.double() - w).abs().max() / w.abs().max()).item()
        assert off <= F64_TOL, (name, off)
    again = ssd_scan.BACKWARD(*arrays)
    assert all(torch.equal(a, g) for a, g in zip(again, got))
    dropped = got[2] + arrays[1] * got[1]          # dcum without −dt·ddt
    assert ((dropped.double() - want[2]).abs().max()
            / want[2].abs().max()).item() > F64_TOL
    nudged = ssd_scan.BACKWARD(*arrays[:5], _nudged(arrays[5]))
    assert max(((c.double() - w).abs().max() / w.abs().max()).item()
               for c, w in zip(nudged, want)) > F64_TOL
