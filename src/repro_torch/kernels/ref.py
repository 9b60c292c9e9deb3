"""Plain PyTorch versions of the port's kernels (the correctness oracles).

The CPU path runs these; on the card they are what each kernel is held
against.
"""
from __future__ import annotations

import torch

FNV_PRIME = 0x01000193
_MASK32 = 0xFFFFFFFF


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0,
                  softcap: float = 0.0) -> torch.Tensor:
    """O(S²) GQA attention. q: (B,S,H,hd); k/v: (B,S,KV,hd)."""
    s, h, hd = q.shape[1], q.shape[2], q.shape[3]
    g = h // k.shape[2]
    k = k.repeat_interleave(g, dim=2)
    v = v.repeat_interleave(g, dim=2)
    scores = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) / hd ** 0.5
    if softcap:
        scores = softcap * torch.tanh(scores / softcap)
    i = torch.arange(s, device=q.device)[:, None]
    j = torch.arange(s, device=q.device)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= j <= i
    if window:
        mask &= j > i - window
    scores = torch.where(mask, scores, torch.tensor(-1e30, device=q.device))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhst,bthd->bshd", probs, v.float())
    return out.to(q.dtype)


def ssd_intra_ref(x: torch.Tensor, dt: torch.Tensor, cum: torch.Tensor,
                  b_in: torch.Tensor, c_in: torch.Tensor) -> torch.Tensor:
    """Intra-chunk SSD: Y[i] = Σ_{j≤i} (C_i·B_j) exp(cum_i − cum_j) Δ_j x_j.

    x: (B,NC,Q,H,P); dt/cum: (B,NC,Q,H); b_in/c_in: (B,NC,Q,N).  The mask
    is applied before the product with Δ_j, so the overflowing
    exp(cum_i − cum_j) of j > i never reaches the output."""
    q = x.shape[2]
    scores = torch.einsum("bcqn,bckn->bcqk", c_in.float(), b_in.float())
    decay = torch.exp(cum[:, :, :, None, :] - cum[:, :, None, :, :])
    mask = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    m = torch.where(mask[None, None, :, :, None], scores[..., None] * decay,
                    torch.zeros((), device=x.device))
    m = m * dt[:, :, None, :, :]
    return torch.einsum("bcqkh,bckhp->bcqhp", m, x.float()).to(x.dtype)


def _mulmod32(a: torch.Tensor, b) -> torch.Tensor:
    """a·b mod 2³² for int64 values in [0, 2³²), exactly: b is split in
    16-bit halves so that no partial product exceeds 2⁴⁸."""
    return (a * (b & 0xFFFF) + (((a * (b >> 16)) & 0xFFFF) << 16)) & _MASK32


def _powers(n: int, device) -> torch.Tensor:
    """[P^(n−1), …, P^1, P^0] mod 2³² as int64, by squaring."""
    e = torch.arange(n - 1, -1, -1, dtype=torch.int64, device=device)
    out = torch.ones_like(e)
    base = FNV_PRIME
    for _ in range(max(n - 1, 1).bit_length()):
        out = torch.where(e & 1 == 1, _mulmod32(out, base), out)
        base = base * base & _MASK32
        e = e >> 1
    return out


def _as_uint32(t: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2³²) as uint32 (int32's wrap, then a view)."""
    return t.to(torch.int32).view(torch.uint32)


def poly_digest_ref(data: torch.Tensor, block: int = 1024):
    """Blockwise degree-weighted polynomial hash in uint32 wraparound:
    per block, Σ_i d_i·P^(L−1−i) mod 2³² over the zero-padded buffer;
    blocks folded with the same polynomial.  ``data``: uint8 or int32,
    any shape (int32 is read as uint32, two's complement).  Returns
    (total, digests), uint32 of shape () and (n_blocks,).  Exact int64
    arithmetic, masked after every product and sum."""
    if data.dtype not in (torch.uint8, torch.int32):
        raise TypeError(f"digest of {data.dtype}: needs uint8 or int32")
    flat = data.reshape(-1).to(torch.int64) & _MASK32
    flat = torch.nn.functional.pad(flat, (0, (-flat.numel()) % block))
    blocks = flat.reshape(-1, block)
    digests = _as_uint32(_mulmod32(blocks, _powers(block, data.device)
                                   [None, :]).sum(dim=1) & _MASK32)
    return fold_digests(digests), digests


def fold_digests(digests: torch.Tensor) -> torch.Tensor:
    """Fold uint32 block digests into the buffer's uint32 checksum:
    Σ_k digest_k·P^(n−1−k) mod 2³²."""
    d = digests.reshape(-1).view(torch.int32).to(torch.int64) & _MASK32
    total = _mulmod32(d, _powers(d.numel(), d.device)).sum() & _MASK32
    return _as_uint32(total)


def err_over_tolerance(got: torch.Tensor, want: torch.Tensor,
                       rtol: float = 0.0) -> float:
    """Largest |got - want| over its elementwise tolerance; at most 1 passes.

    In bfloat16 the tolerance is one ulp of ``want`` (2^-7 |want|) plus
    1e-3: a kernel that sums in another order than the plain version may
    round the same fp32 value to the neighbouring bf16 value, and no more.
    In float32 it is 1e-4 + rtol·|want|."""
    bf16 = want.dtype == torch.bfloat16
    got, want = got.float(), want.float()
    tol = 2.0 ** -7 * want.abs() + 1e-3 if bf16 else 1e-4 + rtol * want.abs()
    return ((got - want).abs() / tol).max().item()


def maxmin_ref(link_caps, membership, flow_caps):
    """Scalar max-min waterfilling oracle (per-link greedy fixing).

    The simulator's dict-walking allocator on array inputs, in float64
    numpy: link_caps (L,), membership (F, L) 0/1, flow_caps (F,).
    Ground truth for ``repro_torch.kernels.maxmin.maxmin_rates``.
    """
    import numpy as np

    membership = np.asarray(membership, dtype=bool)
    num_flows, num_links = membership.shape
    cap_left = np.asarray(link_caps, dtype=np.float64).copy()
    flow_caps = np.asarray(flow_caps, dtype=np.float64)
    rates = np.zeros(num_flows)
    unfixed = set(range(num_flows))
    link_flows = [np.nonzero(membership[:, l])[0] for l in range(num_links)]
    while unfixed:
        best_share, best_lid = float("inf"), None
        for lid in range(num_links):
            n = sum(1 for fi in link_flows[lid] if fi in unfixed)
            if n == 0:
                continue
            share = cap_left[lid] / n
            if share < best_share:
                best_share, best_lid = share, lid
        capped = [fi for fi in unfixed if flow_caps[fi] < best_share]
        if capped:
            for fi in capped:
                rates[fi] = flow_caps[fi]
                unfixed.discard(fi)
                for lid in np.nonzero(membership[fi])[0]:
                    cap_left[lid] = max(0.0, cap_left[lid] - rates[fi])
            continue
        if best_lid is None:
            for fi in unfixed:
                rates[fi] = flow_caps[fi]
            break
        fixed_now = [fi for fi in link_flows[best_lid] if fi in unfixed]
        for fi in fixed_now:
            rates[fi] = best_share
            unfixed.discard(fi)
            for lid in np.nonzero(membership[fi])[0]:
                if lid != best_lid:
                    cap_left[lid] = max(0.0, cap_left[lid] - best_share)
        cap_left[best_lid] = 0.0
    return rates
