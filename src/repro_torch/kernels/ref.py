"""Plain PyTorch versions of the port's kernels (the correctness oracles).

The CPU path runs these; on the card they are what each kernel is held
against.
"""
from __future__ import annotations

import math

import torch

FNV_PRIME = 0x01000193
_MASK32 = 0xFFFFFFFF

FNV64_OFFSET = 0xCBF29CE484222325
FNV64_PRIME = 0x100000001B3
_MASK64 = 0xFFFFFFFFFFFFFFFF


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


def _scores(q, k, causal, window, softcap):
    """The attention's scaled (softcapped) float32 scores (B, H, S, S) over
    KV repeated to the q-heads, tanh(raw / cap) (None without a softcap)
    and the valid pairs (S, S)."""
    s, hd = q.shape[1], q.shape[3]
    k = k.repeat_interleave(q.shape[2] // k.shape[2], dim=2)
    raw = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) / hd ** 0.5
    t = torch.tanh(raw / softcap) if softcap else None
    i = torch.arange(s, device=q.device)[:, None]
    j = torch.arange(s, device=q.device)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= j <= i
    if window:
        mask &= j > i - window
    return (softcap * t if softcap else raw), t, mask


def attention_lse_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: int = 0,
                      softcap: float = 0.0):
    """``attention_ref``'s output and each row's log-sum-exp of its valid
    scaled (softcapped) scores, float32 (B, H, S): what the forward
    kernel writes for the backward."""
    scores, _, mask = _scores(q, k, causal, window, softcap)
    lse = torch.logsumexp(scores.masked_fill(~mask, float("-inf")), dim=-1)
    return attention_ref(q, k, v, causal=causal, window=window,
                         softcap=softcap), lse


def attention_bwd_ref(q, k, v, dout, lse, causal: bool = True,
                      window: int = 0, softcap: float = 0.0):
    """The backward kernel's formulas written out: (dq, dk, dv) in q's
    dtype, all in float32 from the forward's ``lse``: P = exp(s − lse) on
    the valid pairs, renormalised over these scores (lse' = lse + log ΣP),
    dP = dO·Vᵀ, D = Σ P ∘ dP, dS = P ∘ (dP − D) (∘ (1 − tanh²(raw / cap))
    with a softcap), dV = Pᵀ·dO, dK = dSᵀ·Q·scale, dQ = dS·K·scale, dK and
    dV summed over each KV head's group of q-heads.  D is formed from P
    and dP, not from the stored output: see the kernel's notes."""
    b, s, h, hd = q.shape
    kv = k.shape[2]
    g = h // kv
    scale = 1.0 / hd ** 0.5
    scores, t, mask = _scores(q, k, causal, window, softcap)
    p = torch.where(mask, torch.exp(scores - lse[..., None]),
                    torch.zeros((), device=q.device))
    total = p.sum(-1, keepdim=True)
    p = torch.where(total > 0, p / torch.where(total > 0, total, 1.0), p)
    dof = dout.float()
    vr = v.float().repeat_interleave(g, dim=2)
    kr = k.float().repeat_interleave(g, dim=2)
    dp = torch.einsum("bshd,bthd->bhst", dof, vr)
    ds = p * (dp - (p * dp).sum(-1, keepdim=True))
    if softcap:
        ds = ds * (1 - t * t)
    dq = torch.einsum("bhst,bthd->bshd", ds, kr) * scale
    dk = torch.einsum("bhst,bshd->bthd", ds, q.float()) * scale
    dv = torch.einsum("bhst,bshd->bthd", p, dof)
    dk = dk.view(b, s, kv, g, hd).sum(3)
    dv = dv.view(b, s, kv, g, hd).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def ssd_intra_ref(x: torch.Tensor, dt: torch.Tensor, cum: torch.Tensor,
                  b_in: torch.Tensor, c_in: torch.Tensor) -> torch.Tensor:
    """Intra-chunk SSD: Y[i] = Σ_{j≤i} (C_i·B_j) exp(cum_i − cum_j) Δ_j x_j.

    x: (B,NC,Q,H,P); dt/cum: (B,NC,Q,H); b_in/c_in: (B,NC,Q,N).  The mask
    is applied to the exponent, before exp is formed: above the diagonal
    exp(cum_i − cum_j) overflows over a long chunk, and although a mask
    after exp keeps that inf out of the output, autograd's 0·inf would put
    NaN into the gradients of dt, cum, B and C (the reference's own
    float32 gradient is NaN there)."""
    scores = torch.einsum("bcqn,bckn->bcqk", c_in.float(), b_in.float())
    m = scores[..., None] * _masked_decay(cum)
    m = m * dt[:, :, None, :, :]
    return torch.einsum("bcqkh,bckhp->bcqhp", m, x.float()).to(x.dtype)


def _masked_decay(cum: torch.Tensor) -> torch.Tensor:
    """E (B, NC, Q, Q, H): exp(cum_i − cum_j) for j ≤ i, 0 above the
    diagonal, its exponent masked to −inf before exp is formed."""
    q = cum.shape[2]
    mask = torch.ones((q, q), dtype=torch.bool, device=cum.device).tril()
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]
    return torch.exp(torch.where(mask[None, None, :, :, None], diff,
                                 torch.full((), -torch.inf, dtype=diff.dtype,
                                            device=cum.device)))


def ssd_intra_bwd_ref(x: torch.Tensor, dt: torch.Tensor, cum: torch.Tensor,
                      b_in: torch.Tensor, c_in: torch.Tensor,
                      dy: torch.Tensor):
    """The backward kernel's formulas written out: dy (B, NC, Q, H, P), the
    gradient of ``ssd_intra_ref``'s output → (dx, ddt, dcum, db, dc), in
    the inputs' dtype (float64 inputs give the float64 yardstick).  With S
    = C·Bᵀ, E the masked decay, M_ijh = S_ij·E_ijh·dt_jh and G_ijh =
    Σ_p dy_ihp·x_jhp: dx_j = Σ_{i≥j} M_ij·dy_i, ddt_j = Σ_i G_ij·S_ij·E_ij,
    dS_ij = Σ_h G_ijh·E_ijh·dt_jh (B and C are shared by the heads), dC =
    dS·B, dB = dSᵀ·C, and with T = G·M, dcum_k = Σ_j T_kj − Σ_i T_ik: the
    decay's two ends."""
    s = torch.einsum("bcqn,bckn->bcqk", c_in, b_in)
    e = _masked_decay(cum)
    g = torch.einsum("bcihp,bcjhp->bcijh", dy, x)
    se = s[..., None] * e
    m = se * dt[:, :, None, :, :]
    dx = torch.einsum("bcijh,bcihp->bcjhp", m, dy)
    ddt = (g * se).sum(2)
    ds = (g * e * dt[:, :, None, :, :]).sum(-1)
    dc = torch.einsum("bcij,bcjn->bcin", ds, b_in)
    db = torch.einsum("bcij,bcin->bcjn", ds, c_in)
    t = g * m
    dcum = t.sum(3) - t.sum(2)
    return dx, ddt, dcum, db, dc


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


def fnv1a64(data: bytes, seed: int = FNV64_OFFSET) -> int:
    """64-bit FNV-1a over ``data`` on the host, the reference's own loop:
    the federation's placement keys, and the plain version of the
    ``fnv1a64_chunks`` kernel."""
    h = seed
    for b in data:
        h = ((h ^ b) * FNV64_PRIME) & _MASK64
    return h


def fnv1a64_chunks_ref(buf: torch.Tensor, chunk_size: int) -> torch.Tensor:
    """FNV-1a-64 of each ``chunk_size`` piece of a uint8 buffer (the last
    shorter; an empty buffer is one chunk) by :func:`fnv1a64` over Python
    ints: no torch op wraps uint64 products.  Returns int64 (n_chunks,)
    holding the uint64 bits."""
    data = buf.reshape(-1).numpy().tobytes()
    digests = [fnv1a64(data[off:off + chunk_size])
               for off in range(0, max(len(data), 1), chunk_size)]
    return torch.tensor([d - (1 << 64) if d >> 63 else d for d in digests],
                        dtype=torch.int64)


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


# ---------------------------------------------------------------------------
# The sweeps' three scans, batched over a leading problem dimension.  Each
# is the reference's ``lax.scan`` step written as a Python loop of torch
# ops over the (B, ...) state, with the same arithmetic: every byte count
# is an integer below 2**53, so the float64 sums are exact in any order and
# the results equal the reference's exactly.  Padded references (key 0,
# admit and reset false, size 0) change no counter.
# ---------------------------------------------------------------------------
def stack_distances_ref(prev: torch.Tensor, sizes: torch.Tensor
                        ) -> torch.Tensor:
    """Byte-weighted Mattson stack distances: prev (B, N) int64, the index
    of the previous reference to the same key (-1: none), sizes (B, N)
    float64 → (B, N) float64, ``inf`` on a compulsory miss.

    Marker j holds sizes[j] while j is the latest reference to its key;
    reference i's distance is the sum of the markers strictly between its
    previous reference and i."""
    num, n = prev.shape
    idx = torch.arange(n, device=prev.device)
    rows = torch.arange(num, device=prev.device)
    markers = torch.zeros_like(sizes)
    out = torch.empty_like(sizes)
    for i in range(n):
        p = prev[:, i]
        d = torch.where(idx > p[:, None], markers, 0.0).sum(1)
        markers[rows, torch.where(p >= 0, p, i)] = 0.0
        markers[:, i] = sizes[:, i]
        out[:, i] = torch.where(p >= 0, d, float("inf"))
    return out


def cache_sim_ref(keys: torch.Tensor, admit: torch.Tensor,
                  reset: torch.Tensor, key_sizes: torch.Tensor,
                  capacity: torch.Tensor, fifo: torch.Tensor):
    """Exact LRU/FIFO replay at one capacity per problem: keys (B, N) int,
    admit and reset (B, N) bool, key_sizes (B, K) float64, capacity (B,)
    float64, fifo (B,) bool → (hits (B, N) bool, evictions (B,) int32,
    bytes evicted (B,) float64).

    Slot t is written only at step t, so slot order is victim order: an
    admitted miss evicts the lowest occupied slots while the bytes freed
    before each are short of ``usage + size - capacity`` (an exclusive
    cumsum over the slots), then occupies slot t; an LRU hit moves its key
    to slot t.  A reset empties every slot without counting evictions."""
    num, n = keys.shape
    dev = keys.device
    rows = torch.arange(num, device=dev)
    slot_bytes = torch.zeros(num, n, dtype=torch.float64, device=dev)
    slot_key = torch.zeros(num, n, dtype=torch.int64, device=dev)
    resident = torch.zeros(key_sizes.shape, dtype=torch.bool, device=dev)
    key_slot = torch.zeros(key_sizes.shape, dtype=torch.int64, device=dev)
    usage = torch.zeros(num, dtype=torch.float64, device=dev)
    ev = torch.zeros(num, dtype=torch.int32, device=dev)
    evb = torch.zeros(num, dtype=torch.float64, device=dev)
    hits = torch.zeros(num, n, dtype=torch.bool, device=dev)
    for t in range(n):
        k, a, r = keys[:, t].long(), admit[:, t], reset[:, t]
        slot_bytes = torch.where(r[:, None], 0.0, slot_bytes)
        resident = resident & ~r[:, None]
        usage = torch.where(r, 0.0, usage)
        s = key_sizes[rows, k]
        hit = resident[rows, k]
        do_insert = ~hit & a
        need = torch.where(do_insert, usage + s - capacity, 0.0)
        excl = slot_bytes.cumsum(1) - slot_bytes
        evict = (slot_bytes > 0) & (excl < need[:, None])
        freed = torch.where(evict, slot_bytes, 0.0).sum(1)
        # stale slot_key duplicates carry zero bytes: the max is exact
        gone = torch.zeros(key_sizes.shape, dtype=torch.int32,
                           device=dev).scatter_reduce(
            1, slot_key, evict.to(torch.int32), "amax")
        resident = resident & (gone == 0)
        slot_bytes = torch.where(evict, 0.0, slot_bytes)
        usage = usage - freed
        touch = do_insert | (hit & ~fifo)
        old = key_slot[rows, k]
        slot_bytes[rows, old] = torch.where(hit & touch, 0.0,
                                            slot_bytes[rows, old])
        slot_bytes[:, t] = torch.where(touch, s, 0.0)
        slot_key[:, t] = k
        key_slot[rows, k] = torch.where(touch, t, old)
        resident[rows, k] = hit | do_insert
        usage = usage + torch.where(do_insert, s, 0.0)
        ev += evict.sum(1, dtype=torch.int32)
        evb += freed
        hits[:, t] = hit
    return hits, ev, evb


def fifo_replay_ref(keys: torch.Tensor, sizes: torch.Tensor,
                    admit: torch.Tensor, reset: torch.Tensor,
                    kcum0: torch.Tensor, capacity: torch.Tensor):
    """Exact FIFO replay as a byte frontier: keys (B, N) int, sizes (B, N)
    float64, admit and reset (B, N) bool, kcum0 (B, K) float64 zeros,
    capacity (B,) float64 → (hits, evictions int32, bytes evicted float64).

    Eviction only ever consumes a prefix of the admit sequence, so the
    cache is a frontier E over the cumulative admitted bytes: a key is
    resident iff its latest admit's cumulative total exceeds E, and an
    insert moves E to the first cumulative total (``searchsorted``, left)
    that brings the resident bytes under the capacity."""
    num, n = keys.shape
    dev = keys.device
    rows = torch.arange(num, device=dev)
    cum_b = torch.full((num, n), float("inf"), dtype=torch.float64,
                       device=dev)
    cum_n = torch.zeros(num, n, dtype=torch.int32, device=dev)
    kcum = kcum0.clone()
    zero_f = torch.zeros(num, dtype=torch.float64, device=dev)
    zero_i = torch.zeros(num, dtype=torch.int32, device=dev)
    total, e, evb = zero_f, zero_f, zero_f
    tot_n, e_n, ev = zero_i, zero_i, zero_i
    hits = torch.zeros(num, n, dtype=torch.bool, device=dev)
    for t in range(n):
        k, s = keys[:, t].long(), sizes[:, t]
        a, r = admit[:, t], reset[:, t]
        e = torch.where(r, total, e)
        e_n = torch.where(r, tot_n, e_n)
        hit = kcum[rows, k] > e
        ins = ~hit & a
        target = total + s - capacity
        do_evict = ins & (target > e)
        j = torch.searchsorted(cum_b, target[:, None]).squeeze(1)
        j = j.clamp(max=n - 1)          # the reference's gather clamps
        new_e = torch.where(do_evict, cum_b[rows, j], e)
        new_n = torch.where(do_evict, cum_n[rows, j], e_n)
        ev = ev + (new_n - e_n)
        evb = evb + (new_e - e)
        e, e_n = new_e, new_n
        total = total + torch.where(ins, s, 0.0)
        tot_n = tot_n + ins.to(torch.int32)
        cum_b[:, t] = total
        cum_n[:, t] = tot_n
        kcum[rows, k] = torch.where(ins, total, kcum[rows, k])
        hits[:, t] = hit
    return hits, ev, evb


# ---------------------------------------------------------------------------
# The planner's two loops: the reference's jitted JAX written as torch ops,
# with autograd where the reference takes ``jax.grad``.  Both in float64.
# ---------------------------------------------------------------------------
PLAN_ROUNDS = 8          # augmented-Lagrangian rounds (planner.py:199)
PLAN_BISECT_STEPS = 64   # each bisection's steps (planner.py:186)


def plan_solve_ref(stacked: torch.Tensor, per_cache: torch.Tensor,
                   gidx: torch.Tensor, gsize: torch.Tensor,
                   scalars: torch.Tensor, steps: int) -> torch.Tensor:
    """The planner's inverse solve (``core/planner.py:162`` ``_solve``)
    for a batch of P plans of N caches, Bk buckets and G groups.

    stacked (P, 3, N, Bk) float64: each cache's log centers, reference
    weights and byte weights; per_cache (P, 3, N) float64: total refs,
    total bytes and origin fraction; gidx (P, N) int64, each cache's group;
    gsize (P, G) float64, caches a group; scalars (P, 8) float64: the
    target (the target hit rate plus the margin), the egress budget (NaN
    for none), lo and hi (ln of the capacity bounds), the smoothing tau,
    Adam's lr, the first penalty rho and its growth a round; ``steps``
    Adam steps in all, ``max(steps // 8, 1)`` a round.

    → (P, G + 4) float64: each group's capacity, the uniform capacity,
    the predicted hit rate and origin egress, and the norm of the hit
    rate's gradient in log-capacity.  The stages, in the reference's
    order: a 64-step bisection for the uniform capacity; 8 rounds of Adam
    (β₂ 0.99) on the augmented Lagrangian, each followed by the dual
    update; a 64-step repair bisection of a shift of every log-capacity;
    the end point's telemetry."""
    return torch.stack([
        _plan_one(stacked[p], per_cache[p], gidx[p], gsize[p],
                  scalars[p].tolist(), steps)
        for p in range(stacked.shape[0])])


def _plan_one(stacked, per_cache, gidx, gsize, scalars, steps):
    target, budget, lo, hi, tau, lr, penalty, rho_growth = scalars
    has_budget = budget == budget            # NaN: no egress budget
    centers, refw, bytew = stacked
    total_refs, total_bytes, origin_fraction = per_cache
    dev = stacked.device
    G = gsize.shape[0]
    total = torch.clamp(total_refs.sum(), min=1.0)
    zero = torch.zeros((), dtype=torch.float64, device=dev)

    def sig(u):
        caps = torch.exp(u)[gidx]
        logc = torch.log(torch.maximum(caps, torch.ones_like(caps)))
        return torch.sigmoid((logc[:, None] - centers) / tau)

    def hit_at(u):
        return (refw * sig(u)).sum(1).sum() / total

    def egress_at(u):
        miss = total_bytes - (bytew * sig(u)).sum(1)
        return (origin_fraction * miss).sum()

    def feasible(u):
        ok = hit_at(u) >= target
        if has_budget:
            ok = ok & (egress_at(u) <= budget)
        return ok

    def bisect(pred, a, b):
        for _ in range(PLAN_BISECT_STEPS):
            mid = 0.5 * (a + b)
            good = pred(mid)
            a, b = torch.where(good, a, mid), torch.where(good, mid, b)
        return b

    u_uni = bisect(lambda v: feasible(v.expand(G)), zero + lo, zero + hi)
    u = u_uni.expand(G).clone()
    scale = torch.clamp((gsize * torch.exp(u)).sum(), min=1.0)
    bdiv = max(budget, 1.0) if has_budget else 1.0

    def lagrangian(u, nu, nu2, rho):
        aug = torch.maximum(nu + rho * (target - hit_at(u)), zero)
        val = (gsize * torch.exp(u)).sum() / scale \
            + (aug ** 2 - nu ** 2) / (2.0 * rho)
        if has_budget:
            c2 = (egress_at(u) - budget) / bdiv
            aug2 = torch.maximum(nu2 + rho * c2, zero)
            val = val + (aug2 ** 2 - nu2 ** 2) / (2.0 * rho)
        return val

    inner = max(steps // PLAN_ROUNDS, 1)
    mom = torch.zeros(G, dtype=torch.float64, device=dev)
    vel = torch.zeros_like(mom)
    nu, nu2, rho = zero, zero, zero + penalty
    for r in range(PLAN_ROUNDS):
        for i in range(inner):
            x = u.detach().requires_grad_()
            g, = torch.autograd.grad(lagrangian(x, nu, nu2, rho), x)
            mom = 0.9 * mom + 0.1 * g
            vel = 0.99 * vel + 0.01 * g * g
            t = r * inner + i + 1.0
            u = u - lr * (mom / (1 - 0.9 ** t)) / (
                torch.sqrt(vel / (1 - 0.99 ** t)) + 1e-8)
            u = torch.clamp(u, lo, hi)
        nu = torch.maximum(nu + rho * (target - hit_at(u)), zero)
        if has_budget:
            nu2 = torch.maximum(
                nu2 + rho * (egress_at(u) - budget) / bdiv, zero)
        rho = rho * rho_growth
    m = bisect(lambda s: feasible(u + s), zero - 8.0, zero + 8.0)
    u = torch.clamp(u + m, lo, hi)
    x = u.detach().requires_grad_()
    grad, = torch.autograd.grad(hit_at(x), x)
    with torch.no_grad():
        return torch.cat([torch.exp(u), torch.stack([
            torch.exp(u_uni), hit_at(u), egress_at(u),
            torch.linalg.vector_norm(grad)])])


def softmax(logits: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax`` over the last axis: exp(x − max) divided by its
    sum.  ``torch.softmax`` multiplies by the sum's reciprocal instead,
    which rounds otherwise: a mixture's weights then sum to 1 + 2^-52 and
    its CDF can exceed 1 where the reference's does not."""
    e = torch.exp(logits - logits.max(dim=-1, keepdim=True).values.detach())
    return e / e.sum(dim=-1, keepdim=True)


def mixture_loss(params: torch.Tensor, grid: torch.Tensor,
                 target: torch.Tensor) -> torch.Tensor:
    """Each fit's loss (P,): the mean over its grid of the squared gap
    between the mixture's CDF and the target; params (P, 3, K) are the
    logits, means and log-sigmas, grid and target (P, M)."""
    logits, mu, log_sigma = params.unbind(1)
    pis = softmax(logits)[:, None, :]
    sigma = torch.exp(log_sigma)[:, None, :]
    z = (grid[..., None] - mu[:, None, :]) / (sigma * math.sqrt(2.0))
    pred = (pis * 0.5 * (1.0 + torch.special.erf(z))).sum(dim=-1)
    return ((pred - target) ** 2).mean(dim=-1)


def mixture_fit_ref(params0: torch.Tensor, grid: torch.Tensor,
                    target: torch.Tensor, steps: int, lr: float):
    """The mixture fit (``kernels/cache_model.py:267``
    ``_mixture_fit_loop``) for a batch of P histograms: ``steps`` Adam
    steps (β₁ 0.9, β₂ 0.999, ε 1e-8) on params0 (P, 3, K) float64 against
    grid and target (P, M) float64 → (params (P, 3, K), loss (P,)).  The
    loss is the reference's: the one the last step evaluated before its
    own update (0 when ``steps`` is 0)."""
    params = params0.clone()
    mom = torch.zeros_like(params)
    vel = torch.zeros_like(params)
    loss = torch.zeros(params.shape[0], dtype=params.dtype,
                       device=params.device)
    for i in range(steps):
        x = params.detach().requires_grad_()
        losses = mixture_loss(x, grid, target)
        g, = torch.autograd.grad(losses.sum(), x)
        mom = 0.9 * mom + 0.1 * g
        vel = 0.999 * vel + 0.001 * g * g
        t = i + 1.0
        params = params - lr * (mom / (1 - 0.9 ** t)) / (
            torch.sqrt(vel / (1 - 0.999 ** t)) + 1e-8)
        loss = losses.detach()
    return params, loss
