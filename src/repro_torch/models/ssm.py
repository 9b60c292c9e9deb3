"""Mamba-2 SSD (state-space duality): chunked prefill and O(1) decode.

The reference's block [arXiv:2405.21060], on PyTorch: separate z, x, B,
C and dt projections, a depthwise causal conv without bias, heads H of
dim P (d_inner = H·P), state size N, a scalar decay exp(Δ_t·A_h) per
head and step, and B and C shared by all heads (ngroups 1).

The sequence path is SSD's chunked form.  Within chunks of Q rows the
quadratic term goes through ``kernels.ops.ssd_intra``: on the card the
hand-written kernel, on the CPU its plain version.  The chunk states, the
recurrence between chunks (a Python loop over the NC chunks) and the
inter-chunk output stay plain PyTorch, as the reference keeps them
outside its kernel.  The projections are ``torch.matmul``.

Leaf dtypes follow the reference: ``a_log``, ``dt_bias`` and ``d_skip``
are float32 whatever the model's dtype; the SSD runs in float32; the
decode state ``h`` is float32 and the conv history follows the
activations' dtype.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..kernels import ops
from .layers import dense_init, rms_norm

Params = Dict[str, torch.Tensor]
# leaves the reference keeps in float32 whatever the model's dtype
FLOAT32_LEAVES = frozenset({"a_log", "dt_bias", "d_skip"})


def init_ssm(gen: torch.Generator, cfg: ArchConfig,
             dtype=torch.float32) -> Params:
    d, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    cw = cfg.ssm_conv_width
    dev = gen.device
    conv = dict(scale=cw ** 0.5, dtype=dtype)
    return {
        "in_z": dense_init(gen, (d, di), dtype=dtype),
        "in_x": dense_init(gen, (d, di), dtype=dtype),
        "in_b": dense_init(gen, (d, n), dtype=dtype),
        "in_c": dense_init(gen, (d, n), dtype=dtype),
        "in_dt": dense_init(gen, (d, h), dtype=dtype),
        "conv_x": dense_init(gen, (cw, di), **conv),
        "conv_b": dense_init(gen, (cw, n), **conv),
        "conv_c": dense_init(gen, (cw, n), **conv),
        "a_log": torch.zeros(h, dtype=torch.float32, device=dev),
        "dt_bias": torch.zeros(h, dtype=torch.float32, device=dev),
        "d_skip": torch.ones(h, dtype=torch.float32, device=dev),
        "gate_norm": torch.zeros(di, dtype=dtype, device=dev),
        "out_proj": dense_init(gen, (di, d), dtype=dtype)}


def _causal_conv(u: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over the sequence, then SiLU.  u: (B, L, C);
    w: (cw, C)."""
    cw = w.shape[0]
    pad = F.pad(u, (0, 0, cw - 1, 0))
    out = sum(pad[:, i:i + u.shape[1], :] * w[i] for i in range(cw))
    return F.silu(out)


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                b_in: torch.Tensor, c_in: torch.Tensor, chunk: int,
                h0: Optional[torch.Tensor] = None):
    """Core SSD scan.

    x: (B, L, H, P); dt: (B, L, H); a: (H,) (negative); b_in, c_in:
    (B, L, N); chunk: Q.  L is zero-padded to whole chunks of
    Q = min(chunk, L).  Returns (y (B, L, H, P), h_final (B, H, N, P))."""
    bsz, l, h, p = x.shape
    n = b_in.shape[-1]
    q = min(chunk, l)
    nc = -(-l // q)
    pad = nc * q - l
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b_in = F.pad(b_in, (0, 0, 0, pad))
        c_in = F.pad(c_in, (0, 0, 0, pad))
    xc = x.reshape(bsz, nc, q, h, p)
    dtc = dt.reshape(bsz, nc, q, h)
    bc = b_in.reshape(bsz, nc, q, n)
    cc = c_in.reshape(bsz, nc, q, n)

    cum = torch.cumsum(dtc * a, dim=2)          # inclusive log-decay
    seg_end = cum[:, :, -1:, :]                 # total decay of each chunk

    # Intra-chunk: Y[i] = Σ_{j<=i} C_i·B_j exp(cum_i − cum_j) Δ_j x_j
    y_intra = ops.ssd_intra(xc, dtc, cum, bc, cc)

    # Chunk states: S_c = Σ_j exp(seg_end − cum_j) Δ_j B_j ⊗ x_j
    w = torch.exp(seg_end - cum) * dtc
    s_c = torch.einsum("bcqh,bcqn,bcqhp->bchnp", w, bc, xc)

    # Inter-chunk recurrence, sequential over the NC chunks
    seg = torch.exp(seg_end[:, :, 0, :])        # (B, NC, H)
    state = torch.zeros((bsz, h, n, p), dtype=x.dtype, device=x.device) \
        if h0 is None else h0
    starts = []
    for c in range(nc):
        starts.append(state)
        state = seg[:, c, :, None, None] * state + s_c[:, c]
    h_starts = torch.stack(starts, dim=1)       # (B, NC, H, N, P)

    # Inter-chunk contribution: Y[i] += exp(cum_i) C_i · h_chunk_start
    y_inter = torch.einsum("bcqh,bcqn,bchnp->bcqhp", torch.exp(cum), cc,
                           h_starts)
    y = (y_intra + y_inter).reshape(bsz, nc * q, h, p)
    return y[:, :l], state


def _project(p: Params, x: torch.Tensor):
    """x (B, L, D) → z, x, B, C (pre-conv) and dt (pre-softplus)."""
    return (x @ p["in_z"], x @ p["in_x"], x @ p["in_b"], x @ p["in_c"],
            x @ p["in_dt"])


def ssm_forward(p: Params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    return _ssm_seq(p, x, cfg, want_cache=False)[0]


def prefill_ssm(p: Params, x: torch.Tensor, cfg: ArchConfig):
    """Full-sequence SSM that also returns the decode cache: the final SSD
    state and the causal conv's history, as ``ssm_decode`` reads them."""
    return _ssm_seq(p, x, cfg, want_cache=True)


def _ssm_seq(p: Params, x: torch.Tensor, cfg: ArchConfig, want_cache: bool):
    bsz, l, _ = x.shape
    h, hp, cw = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_conv_width
    z, xr, br, cr, dt = _project(p, x)
    xi = _causal_conv(xr, p["conv_x"]).reshape(bsz, l, h, hp)
    b_in = _causal_conv(br, p["conv_b"])
    c_in = _causal_conv(cr, p["conv_c"])
    dt = F.softplus(dt.float() + p["dt_bias"])
    a = -torch.exp(p["a_log"])
    y, h_final = ssd_chunked(xi.float(), dt, a, b_in.float(), c_in.float(),
                             cfg.ssm_chunk)
    y = y + p["d_skip"][:, None] * xi.float()
    y = y.reshape(bsz, l, cfg.d_inner).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["gate_norm"], cfg.norm_eps)
    out = y @ p["out_proj"]
    if not want_cache:
        return out, None

    def tail(u):
        """The last cw − 1 raw projected rows (zeros before the start)."""
        return F.pad(u[:, -(cw - 1):], (0, 0, max(cw - 1 - l, 0), 0)) \
            .to(x.dtype)
    cache = {"h": h_final.float(), "conv_x": tail(xr), "conv_b": tail(br),
             "conv_c": tail(cr)}
    return out, cache


# ---------------------------------------------------------------------------
# Decode: O(1) state update per token
# ---------------------------------------------------------------------------
def init_ssm_cache(cfg: ArchConfig, batch: int, dtype=torch.float32,
                   device=None) -> Dict[str, torch.Tensor]:
    di, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    cw = cfg.ssm_conv_width
    return {
        "h": torch.zeros((batch, h, n, cfg.ssm_headdim), dtype=torch.float32,
                         device=device),
        "conv_x": torch.zeros((batch, cw - 1, di), dtype=dtype,
                              device=device),
        "conv_b": torch.zeros((batch, cw - 1, n), dtype=dtype, device=device),
        "conv_c": torch.zeros((batch, cw - 1, n), dtype=dtype, device=device)}


def _conv_step(hist: torch.Tensor, new: torch.Tensor, w: torch.Tensor):
    """hist (B, cw−1, C), new (B, C) → (activated output (B, C), new
    history)."""
    seq = torch.cat([hist, new[:, None, :].to(hist.dtype)], dim=1)
    out = F.silu(torch.einsum("bkc,kc->bc", seq.to(w.dtype), w))
    return out, seq[:, 1:]


def ssm_decode(p: Params, x: torch.Tensor, cache: Dict[str, torch.Tensor],
               cfg: ArchConfig) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, 1, D), one token → (out (B, 1, D), the new state)."""
    bsz = x.shape[0]
    h, hp = cfg.ssm_heads, cfg.ssm_headdim
    z, xr, br, cr, dt = (t[:, 0] for t in _project(p, x[:, 0:1]))
    xi, new_cx = _conv_step(cache["conv_x"], xr, p["conv_x"])
    b_in, new_cb = _conv_step(cache["conv_b"], br, p["conv_b"])
    c_in, new_cc = _conv_step(cache["conv_c"], cr, p["conv_c"])
    xi = xi.reshape(bsz, h, hp)
    dt = F.softplus(dt.float() + p["dt_bias"])
    a = -torch.exp(p["a_log"])
    decay = torch.exp(dt * a)                                   # (B, H)
    upd = torch.einsum("bh,bn,bhp->bhnp", dt, b_in.float(), xi.float())
    hnew = decay[:, :, None, None] * cache["h"] + upd
    y = torch.einsum("bn,bhnp->bhp", c_in.float(), hnew)
    y = y + p["d_skip"][:, None] * xi.float()
    y = y.reshape(bsz, cfg.d_inner).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["gate_norm"], cfg.norm_eps)
    out = (y @ p["out_proj"])[:, None, :]
    return out, {"h": hnew, "conv_x": new_cx, "conv_b": new_cb,
                 "conv_c": new_cc}
