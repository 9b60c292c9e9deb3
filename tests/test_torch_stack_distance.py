"""The sweeps' three scans: the port against the JAX reference, and the CUDA
kernels' algorithms against the plain versions.

On the CPU the port's ``stack_distances_batch``, ``fifo_sim_batch`` and
``cache_sim_batch`` run the plain PyTorch versions (``kernels/ref.py``);
they must equal the reference's jitted scans exactly — distances with
their ``inf``, hit masks, eviction counts, bytes evicted and the ``stats``
telemetry — on seeded random streams with resets mid-stream, refused
admits, oversize chunks, lengths that are not powers of two (so padding
shows) and several problems per bucket.  Every byte count is an integer,
so the float64 sums are exact in any order: the tolerance is zero.

The CUDA kernels of ``csrc/stack_distance.cu`` cannot run here, so their
algorithms — distances as a dominance sum carried by a bottom-up merge
sort (tiles, levels over the row, the splits found by sampling), the slot
machine's key_slot state and its scalar walk
from a head pointer, the FIFO frontier's forward search
and its bytes evicted after an oversize insert — are modelled line for
line in numpy and held to the plain versions and the reference's scans,
on random families and on hand-made traps; a control at a capacity one
byte below a size that decides an eviction must fail the same check.  The
``gpu`` tests hold each kernel to its plain version on the card.  JAX
comes in through the ``jx`` fixture, so that on the machine with the
card, which has no JAX, the ``gpu`` tests run.
"""
import types

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels import stack_distance as sd

SEEDS = range(6)


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax", reason="the JAX reference is not installed")
    from repro.kernels import stack_distance as jax_sd
    return types.SimpleNamespace(sd=jax_sd)


def _stream(rng, n, n_keys, max_size, reset_rate=0.01):
    """keys (n,), per-key sizes (n_keys,), reset markers, prev indices."""
    key_sizes = rng.integers(1, max_size + 1, n_keys).astype(np.float64)
    # a skewed key draw, so that keys are re-referenced at short and long
    # distances both
    weights = 1.0 / np.arange(1, n_keys + 1) ** 0.8
    keys = rng.choice(n_keys, n, p=weights / weights.sum()).astype(np.int32)
    reset = (rng.random(n) < reset_rate) & (np.arange(n) > 0)
    prev, last = np.full(n, -1, np.int64), {}
    for i, (k, r) in enumerate(zip(keys, reset)):
        if r:
            last = {}
        prev[i] = last.get(int(k), -1)
        last[int(k)] = i
    return keys, key_sizes, reset, prev


def random_problems(seed):
    """Distance, FIFO and slot-machine problems of one seed: lengths that
    are not powers of two spread over two buckets, several problems a
    bucket, capacities below the largest chunk (oversize refusals) and a
    size-aware policy refusal on some."""
    rng = np.random.default_rng(seed)
    dist, fifo, sim = [], [], []
    for n in (37, 300, 300, 511, 700, 1500):
        n_keys = int(rng.integers(8, 90))
        keys, ksz, reset, prev = _stream(rng, n, n_keys, 40)
        sizes = ksz[keys]
        dist.append((prev, sizes))
        for cap in (float(rng.integers(30, 60)),
                    float(rng.integers(100, 400)), float(ksz.sum() + 1)):
            policy_ok = rng.random(n) < 0.85
            admit = (sizes <= cap) & policy_ok
            fifo.append((keys, sizes, admit, reset, n_keys, cap))
            fifo_flag = bool(rng.random() < 0.5)
            sim.append((keys, admit, reset, ksz, cap, fifo_flag))
    return dist, fifo, sim


def _same_results(got, want):
    assert len(got) == len(want)
    for (h, e, b), (wh, we, wb) in zip(got, want):
        assert np.array_equal(h, wh)
        assert (e, b) == (we, wb)
        assert type(e) is int and type(b) is int


# ---------------------------------------------------------------------------
# The port's batched functions (plain path) against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", SEEDS)
def test_stack_distances_equal_the_reference(jx, seed):
    dist, _, _ = random_problems(seed)
    want_stats, got_stats = {}, {}
    want = jx.sd.stack_distances_batch(dist, stats=want_stats)
    got = sd.stack_distances_batch(dist, stats=got_stats, device="cpu")
    assert got_stats == want_stats
    assert want_stats["solve_calls"] >= 2 and want_stats["padded_problems"]
    for g, w in zip(got, want):
        assert g.dtype == np.float64 and np.isinf(w).any()
        assert np.array_equal(g, w)


@pytest.mark.parametrize("seed", SEEDS)
def test_fifo_replay_equals_the_reference(jx, seed):
    _, fifo, _ = random_problems(seed)
    want_stats, got_stats = {}, {}
    want = jx.sd.fifo_sim_batch(fifo, stats=want_stats)
    got = sd.fifo_sim_batch(fifo, stats=got_stats, device="cpu")
    assert got_stats == want_stats
    _same_results(got, want)
    assert any(e > 0 for _, e, _ in want)


@pytest.mark.parametrize("seed", SEEDS)
def test_cache_sim_equals_the_reference(jx, seed):
    _, _, sim = random_problems(seed)
    want_stats, got_stats = {}, {}
    want = jx.sd.cache_sim_batch(sim, stats=want_stats)
    got = sd.cache_sim_batch(sim, stats=got_stats, device="cpu")
    assert got_stats == want_stats
    _same_results(got, want)
    assert any(e > 0 for _, e, _ in want)


def test_lru_hits_and_empty_batches(jx):
    dist, _, _ = random_problems(0)
    d = sd.stack_distances_batch(dist[:1], device="cpu")[0]
    sizes = dist[0][1]
    for cap in (40.0, 120.0, 1e9):
        assert np.array_equal(sd.lru_hits(d, sizes, cap),
                              jx.sd.lru_hits(d, sizes, cap))
    for fn in ("stack_distances_batch", "fifo_sim_batch", "cache_sim_batch"):
        stats, want_stats = {}, {}
        assert getattr(sd, fn)([], stats=stats, device="cpu") == []
        getattr(jx.sd, fn)([], stats=want_stats)
        assert stats == want_stats


def test_the_reference_examples():
    """The reference's own hand-made cases: compulsory misses are inf, a
    distance counts distinct keys' bytes once."""
    dist = sd.stack_distances_batch([([-1, -1, 0, -1], [3.0] * 4)],
                                    device="cpu")[0]
    assert np.isinf(dist[[0, 1, 3]]).all() and dist[2] == 3.0
    dist = sd.stack_distances_batch(
        [([-1, -1, -1, 1, 0], [5.0, 7.0, 11.0, 7.0, 5.0])], device="cpu")[0]
    assert dist[4] == 7.0 + 11.0 and dist[3] == 11.0


def test_device_none_means_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        sd.stack_distances_batch([([-1], [1.0])])


@pytest.mark.parametrize("fn", ["fifo_sim_batch", "cache_sim_batch"])
def test_replays_device_none_means_cuda(monkeypatch, fn):
    """Without a card, a replay asked for no device (the card) raises
    rather than taking the plain version."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, fifo, sim = random_problems(0)
    with pytest.raises(RuntimeError, match="CUDA"):
        getattr(sd, fn)((fifo if fn == "fifo_sim_batch" else sim)[:1])


def test_cache_sim_kernel_refuses_cpu_tensors():
    """The slot machine's wrapper takes CUDA tensors only, whatever its
    design; nothing is launched or counted."""
    num, n, kp = 1, 256, 64
    before = (sd.CACHE_SIM.launches, dict(sd.CACHE_SIM.launches_by_design))
    with pytest.raises(ValueError, match="CUDA"):
        sd.CACHE_SIM(torch.zeros(num, n, dtype=torch.int32),
                     torch.zeros(num, n, dtype=torch.bool),
                     torch.zeros(num, n, dtype=torch.bool),
                     torch.zeros(num, kp, dtype=torch.float64),
                     torch.zeros(num, dtype=torch.float64),
                     torch.zeros(num, dtype=torch.bool),
                     torch.full((num,), n))
    assert (sd.CACHE_SIM.launches,
            sd.CACHE_SIM.launches_by_design) == before


def test_kernels_refuse_cpu_tensors():
    """A kernel wrapper takes CUDA tensors only; the CPU goes through
    ``ops`` to the plain version, never to a kernel."""
    prev = torch.full((1, 256), -1, dtype=torch.int64)
    before = sd.DISTANCES.launches
    with pytest.raises(ValueError, match="CUDA"):
        sd.DISTANCES(prev, torch.zeros(1, 256, dtype=torch.float64),
                     torch.full((1,), 256))
    assert sd.DISTANCES.launches == before


# ---------------------------------------------------------------------------
# Models of the CUDA kernels' algorithms, line for line, against the plain
# versions
# ---------------------------------------------------------------------------
KEY_NONE, KEY_ZERO = -1, -2    # no query or point (inf); prev >= i (0)
KEY_END = np.iinfo(np.int32).max   # past a run's end: above every key
UINT_MAX = np.iinfo(np.uint32).max


def merge_path(kl, kr, d):
    """How many of the first d outputs of the stable merge of two sorted
    key runs (the left one first on ties) come from the left run."""
    lo, hi = max(0, d - len(kr)), min(d, len(kl))
    while lo < hi:
        mid = (lo + hi) // 2
        if kl[mid] <= kr[d - 1 - mid]:
            lo = mid + 1
        else:
            hi = mid
    return lo


def warp_split(kl, kr, d):
    """``merge_path`` as a warp finds it in device memory: 32 samples a
    round, spaced evenly over the range left, count the true predicates,
    and narrow the range to the gap after the last one."""
    lo, hi = max(0, d - len(kr)), min(d, len(kl))
    while lo < hi:
        s = -(-(hi - lo) // 32)
        c = sum(1 for x in range(lo, hi, s) if kl[x] <= kr[d - 1 - x])
        if c == 0:
            hi = lo
        else:
            lo, hi = lo + (c - 1) * s + 1, min(hi, lo + c * s)
    return lo


def merge_items(left, right, a, b, pl0, pr0, wl, count):
    """A thread's ``count`` outputs of the merge of two segments (key,
    idx, cw, acc arrays), from (a, b): a right element takes off the
    weight of the left run's elements above its key, wl - PWL(a); each
    element's running weight cw becomes its own plus the other run's
    before it.
    pl0 and pr0 are the runs' weights before the segments."""
    kl, il, cl, al = left
    kr, ir, cr, ar = right
    pwl = cl[a - 1] if a > 0 else pl0
    pwr = cr[b - 1] if b > 0 else pr0
    ka = kl[a] if a < len(kl) else KEY_END       # the two heads' keys
    kb = kr[b] if b < len(kr) else KEY_END
    out = []
    for _ in range(count):
        if ka <= kb:
            out.append((ka, il[a], cl[a] + pwr, al[a]))
            pwl = cl[a]
            a += 1
            ka = kl[a] if a < len(kl) else KEY_END
        else:
            out.append((kb, ir[b], cr[b] + pwl, ar[b] - (wl - pwl)))
            pwr = cr[b]
            b += 1
            kb = kr[b] if b < len(kr) else KEY_END
    return out


def model_distances(prev, sizes, length=None, tile=sd.DIST_TILE,
                    items=sd.DIST_ITEMS, chunk=sd.DIST_CHUNK, st=None):
    """``sd_distances``: d_i = (S[i] - S[p+1]) - Q(p, i), S the exclusive
    prefix sum of sizes and Q(p, i) the weight of the points m < i with
    q_m > p, where m is a point iff it is the first reference whose prev
    is q_m (next[q_m] == m), of weight sizes[q_m].  Every reference is one
    element (key prev, or KEY_NONE / KEY_ZERO), sorted by key in a
    bottom-up merge sort over positions that carries acc, its tile's S[i]
    less its Q so far:
    ``items`` consecutive elements a thread (pairwise, then an odd-even
    transposition sort), merge levels inside a tile of ``tile`` positions
    (shared memory; a level whose pairs lie inside a warp's 32 · items
    elements syncs only the warp, the same values), then levels over the
    row whose blocks each take ``chunk`` outputs between splits found by
    ``warp_split``; the last level writes the distances.  ``st`` counts
    the levels of each kind."""
    st = types.SimpleNamespace(tile_levels=0, row_levels=0) \
        if st is None else st
    n0 = len(prev)
    width = sd._next_pow2(max(n0, 1), floor=sd.DIST_MIN_WIDTH)   # wrapper
    p_all = np.full(width, -1, np.int64)
    p_all[:n0] = prev
    s_all = np.zeros(width)
    s_all[:n0] = sizes
    n = min(n0 if length is None else length, width)
    nxt = np.full(width, UINT_MAX, np.int64)          # next_set: atomicMin
    for i in range(n):
        if 0 <= p_all[i] < i:
            nxt[p_all[i]] = min(nxt[p_all[i]], i)
    key = np.full(width, KEY_NONE, np.int64)
    w = np.zeros(width)
    for i in range(n):
        p = p_all[i]
        if p >= 0 and p < i:
            key[i] = p
            w[i] = s_all[p] if nxt[p] == i else 0.0
        elif p >= 0:
            key[i] = KEY_ZERO
    tn = min(tile, width)
    nt = width // tn
    sloc, tsum = np.zeros(width), np.zeros(nt)
    run = [key.copy(), np.arange(width), np.zeros(width), np.zeros(width)]
    for t in range(nt):
        base = t * tn
        sloc[base:base + tn] = np.cumsum(s_all[base:base + tn]) - \
            s_all[base:base + tn]
        tsum[t] = s_all[base:base + tn].sum()
        for e0 in range(base, base + tn, items):       # in registers
            k = list(key[e0:e0 + items])
            ix = list(range(e0, e0 + items))
            ww = list(w[e0:e0 + items])
            acc = [sloc[e0 + j] - sum(ww[j2] for j2 in range(j)
                                      if k[j2] > k[j])
                   for j in range(items)]     # the tile's S[i] less Q
            for ps in range(items):      # odd-even transposition: stable
                for j in range(ps % 2, items - 1, 2):
                    if k[j] > k[j + 1]:
                        for v in (k, ix, ww, acc):
                            v[j], v[j + 1] = v[j + 1], v[j]
            cw = np.cumsum(ww)
            for j in range(items):
                for arr, v in zip(run, (k[j], ix[j], cw[j], acc[j])):
                    arr[e0 + j] = v
        L = items                                      # shared memory
        while L < tn:
            new = [a.copy() for a in run]
            for e0 in range(0, tn, items):
                pb = base + (e0 & ~(2 * L - 1))
                d = base + e0 - pb
                left = [a[pb:pb + L] for a in run]
                right = [a[pb + L:pb + 2 * L] for a in run]
                a = merge_path(left[0], right[0], d)
                out = merge_items(left, right, a, d - a, 0.0, 0.0,
                                  left[2][L - 1], items)
                for j, vals in enumerate(out):
                    for arr, v in zip(new, vals):
                        arr[base + e0 + j] = v
            run = new
            L *= 2
            st.tile_levels += t == 0
    tp = np.concatenate([[0.0], np.cumsum(tsum)[:-1]])
    dist = np.full(width, np.inf)

    def scatter(k, i, acc):
        if k == KEY_NONE:
            dist[i] = np.inf
        elif k == KEY_ZERO:
            dist[i] = 0.0
        else:
            dist[i] = (tp[i // tn] + acc) - (tp[(k + 1) // tn] +
                                             sloc[k + 1])

    L = tn                                             # over the row
    while L < width:
        final = 2 * L == width
        new = [a.copy() for a in run]
        for r0 in range(0, width, chunk):
            pb = r0 & ~(2 * L - 1)
            d0 = r0 - pb
            lrun = [a[pb:pb + L] for a in run]
            rrun = [a[pb + L:pb + 2 * L] for a in run]
            a0 = warp_split(lrun[0], rrun[0], d0)
            a1 = warp_split(lrun[0], rrun[0], d0 + chunk)
            assert (a0, a1) == (merge_path(lrun[0], rrun[0], d0),
                                merge_path(lrun[0], rrun[0], d0 + chunk))
            b0, b1 = d0 - a0, d0 + chunk - a1
            segl = [a[a0:a1] for a in lrun]
            segr = [a[b0:b1] for a in rrun]
            pl0 = lrun[2][a0 - 1] if a0 > 0 else 0.0
            pr0 = rrun[2][b0 - 1] if b0 > 0 else 0.0
            for dt in range(0, chunk, items):
                a = merge_path(segl[0], segr[0], dt)
                out = merge_items(segl, segr, a, dt - a, pl0, pr0,
                                  lrun[2][L - 1], items)
                for j, vals in enumerate(out):
                    if final:
                        scatter(vals[0], vals[1], vals[3])
                    for arr, v in zip(new, vals):
                        arr[r0 + dt + j] = v
        run = new
        L *= 2
        st.row_levels += 1
    if width == tn:
        for e in range(width):
            scatter(run[0][e], run[1][e], run[3][e])
    return dist[:n0]


HEAD_TILE = 1024        # keys a stage of the slot machine's head ring holds


def sim_state():
    return types.SimpleNamespace(walks=0, inspected=0, skipped=0,
                                 victims_max=0, tiles_crossed=0,
                                 head_touches=0)


def model_cache_sim(keys, admit, reset, key_sizes, cap, fifo, st=None):
    """``sd_cache_sim``: one thread's chain with key_slot as the only key
    state (resident iff key_slot >= ep, the last reset's step; -1 once
    evicted) and a head pointer that only moves forward (every slot below
    it is empty; a reset sets it to t).  Slot j is occupied iff
    key_slot[keys[j]] == j and its bytes are > 0.  An insert that needs
    room inspects the slots from the head in order, evicting the occupied
    ones while the bytes freed are short of need, and leaves the head past
    the last one inspected (the kernel reads keys[j] from its head ring:
    the same values).  ``st`` counts walks, slots inspected and those not
    occupied, the most victims of one walk, walks that cross a tile of the
    head ring, and LRU touches of the first occupied slot."""
    st = sim_state() if st is None else st
    n = len(keys)
    kslot = np.full(len(key_sizes), -1, np.int64)
    ep = head = 0
    usage = evb = 0.0
    ev = 0
    hits = np.zeros(n, bool)

    def occupied(j):
        key = int(keys[j])
        return kslot[key] == j and key_sizes[key] > 0.0

    for t in range(n):
        k, a, s = int(keys[t]), bool(admit[t]), key_sizes[int(keys[t])]
        if reset[t]:
            ep, head, usage = t, t, 0.0
        old = int(kslot[k])
        hit = old >= ep
        ins = not hit and a
        need = usage + s - cap
        if ins and need > 0.0:
            st.walks += 1
            freed, victims, j = 0.0, 0, head
            while freed < need and j < t:
                key = int(keys[j])
                st.inspected += 1
                if kslot[key] == j and key_sizes[key] > 0.0:
                    kslot[key] = -1
                    freed += key_sizes[key]
                    ev += 1
                    victims += 1
                else:
                    st.skipped += 1
                j += 1
            st.tiles_crossed += int(j > head and
                                    head // HEAD_TILE != (j - 1) // HEAD_TILE)
            head = j
            usage -= freed
            evb += freed
            st.victims_max = max(st.victims_max, victims)
        if hit and not fifo and occupied(old):
            st.head_touches += int(not any(occupied(j)
                                           for j in range(head, old)))
        if ins or (hit and not fifo):
            kslot[k] = t
        usage += s if ins else 0.0
        hits[t] = hit
    return hits, ev, evb


FIFO_TILE = 1024        # references a ring stage holds


def window_search(cb, cn, t, target, st):
    """``sd_fifo_replay``'s search on the warp: the first j in [0, t] with
    cumB[j] >= target (t when none), from the hint ``st.lo``, restarted at
    0 when ``st.lo_prev`` (cumB[lo - 1]) shows the hint is no lower bound;
    32 entries of cumB/cumN at a time in a window of lane registers, kept
    between searches while they cover the position.  Returns (j, new E,
    new EN)."""
    if st.lo > t or (st.lo > 0 and st.lo_prev >= target):
        st.lo, st.lo_prev = 0, -np.inf
        st.restarts += 1
    lanes = np.arange(32)
    pos, j, at = st.lo, t, 0
    before = st.lo_prev
    while pos < t:
        if pos < st.wb or pos >= st.wb + st.wcount:
            st.wb, st.wcount = pos, min(32, t - pos)
            st.wv = np.full(32, np.inf)
            st.wn = np.zeros(32, np.int64)
            st.wv[:st.wcount] = cb[pos:pos + st.wcount]
            st.wn[:st.wcount] = cn[pos:pos + st.wcount]
            st.loads += 1
        ball = (st.wb + lanes >= pos) & (lanes < st.wcount) & \
            (st.wv >= target)
        if ball.any():
            at = int(np.argmax(ball))
            j = st.wb + at
            break
        before = st.wv[st.wcount - 1]
        pos = st.wb + st.wcount
    new_e = st.wv[at] if j < t else np.inf
    new_n = int(st.wn[at]) if j < t else 0
    if j != st.lo:
        st.lo_prev = before if j == pos else st.wv[at - 1]
        st.lo = j
    return j, new_e, new_n


def search_state():
    return types.SimpleNamespace(lo=0, lo_prev=-np.inf, wb=0, wcount=0,
                                 wv=None, wn=None, restarts=0, loads=0)


def model_fifo_replay(keys, sizes, admit, reset, n_keys, cap, st=None,
                      width=None):
    """``sd_fifo_replay``: the stream in ring tiles of 1,024 references,
    the key state kcum (float64, in shared memory or device memory by Kp:
    the same values) and the frontier moved by ``window_search`` (the
    kernel reads the last 4,096 steps from its shared history, older ones
    from device memory: the same values).  A step that moves no frontier
    adds E - E to the bytes evicted, as the reference does (NaN once E is
    +inf), and so, once, do the reference's padding steps when its row
    (``width``) is longer than the problem."""
    n = len(keys)
    cb = np.zeros(n)
    cn = np.zeros(n, np.int64)
    kcum = np.zeros(max(n_keys, 1))
    total = e = evb = 0.0
    tot_n = e_n = ev = 0
    st = search_state() if st is None else st
    hits = np.zeros(n, bool)
    for t0 in range(0, n, FIFO_TILE):
        for t in range(t0, min(n, t0 + FIFO_TILE)):
            k, s = int(keys[t]), sizes[t]
            if reset[t]:
                e, e_n = total, tot_n
            hit = kcum[k] > e
            ins = not hit and bool(admit[t])
            target = total + s - cap
            if ins and target > e:
                _, new_e, new_n = window_search(cb, cn, t, target, st)
                ev += new_n - e_n
                evb += new_e - e
                e, e_n = new_e, new_n
            else:
                evb += e - e
            if ins:
                total += s
                tot_n += 1
                kcum[k] = total
            cb[t], cn[t] = total, tot_n
            hits[t] = hit
    if width is not None and n < width:
        evb += e - e
    return hits, ev, evb


def _plain_one(fn, *arrays):
    """Run a plain version on one problem (a batch of one) on the CPU."""
    out = fn(*(torch.from_numpy(np.asarray(a)[None]) for a in arrays))
    if isinstance(out, torch.Tensor):
        return out[0].numpy()
    hits, ev, evb = out
    return hits[0].numpy(), int(ev[0]), float(evb[0])


# a small tile: levels over the row from n = 33 on
MODEL_TILE, MODEL_ITEMS, MODEL_CHUNK = 32, 4, 16


def _same_bits(got, want):
    """Bit for bit, inf included."""
    return got.shape == want.shape and \
        np.array_equal(np.asarray(got, np.float64).view(np.int64),
                       np.asarray(want, np.float64).view(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
def test_distance_kernel_model_equals_plain(jx, seed):
    """The kernel's design (at its own tile and at a small one, where the
    levels over the row run), the plain version and the reference's
    ``_dist_batch`` agree bit for bit."""
    dist, _, _ = random_problems(seed)
    want = jx.sd.stack_distances_batch(dist)
    plain = sd.stack_distances_batch(dist, device="cpu")
    for (prev, sizes), w, p in zip(dist, want, plain):
        assert _same_bits(p, w)
        assert _same_bits(model_distances(prev, sizes), w)
        st = types.SimpleNamespace(tile_levels=0, row_levels=0)
        assert _same_bits(model_distances(prev, sizes, tile=MODEL_TILE,
                                          items=MODEL_ITEMS,
                                          chunk=MODEL_CHUNK, st=st), w)
        assert st.row_levels >= 3


def _prevs(keys, reset=None):
    """Each reference's previous reference to its key since the last
    reset (-1: none)."""
    prev, last = np.full(len(keys), -1, np.int64), {}
    for i, k in enumerate(keys):
        if reset is not None and reset[i]:
            last = {}
        prev[i] = last.get(int(k), -1)
        last[int(k)] = i
    return prev


def _split_level(p, i):
    """The merge level at which positions p < i first share a run."""
    return (int(p) ^ int(i)).bit_length() - 1


def _distance_cases(tile):
    """Hand-made distance problems, each at one trap of the design for a
    tile of ``tile`` positions: name → problems (prev, sizes)."""
    rng = np.random.default_rng(11)
    sized = lambda keys: rng.integers(1, 1 << 20, max(keys) + 1)[keys] \
        .astype(np.float64)
    cases = {}
    # prevs that no stream makes: duplicated (a marker dies at the first
    # reference that names it), and one >= i (the plain version gives 0)
    n = 3 * tile + 17
    prev = np.array([rng.integers(-1, i) if i else -1 for i in range(n)])
    prev[5], prev[9] = 9, 9
    cases["duplicated prev"] = [(prev, rng.integers(0, 50, n)
                                 .astype(np.float64))]
    keys, ksz, reset, prev = _stream(rng, 2 * tile + 5, 40, 1000,
                                     reset_rate=0.03)
    assert reset.any()
    cases["a reset mid-stream"] = [(prev, ksz[keys])]
    keys, ksz, _, prev = _stream(rng, tile + 3, 50, 1000, reset_rate=0.0)
    ksz[::3] = 0.0
    cases["zero-byte sizes"] = [(prev, ksz[keys]),
                                (prev, np.zeros(tile + 3))]
    cases["padding"] = []
    for n in (1, 37, 255, 257):
        keys, ksz, _, prev = _stream(rng, n, 20, 100)
        cases["padding"].append((prev, ksz[keys]))
    for label, n in (("length T-1", tile - 1), ("length T", tile),
                     ("length T+1", tile + 1), ("length 3T+17",
                                                3 * tile + 17)):
        keys, ksz, _, prev = _stream(rng, n, max(8, n // 8), 5000)
        cases[label] = [(prev, ksz[keys])]
    n = sd._next_pow2(4 * tile, floor=sd.DIST_MIN_WIDTH)
    keys = (rng.zipf(1.3, n) - 1) % n
    cases["gaps across every level"] = [(_prevs(keys), sized(keys))]
    keys = np.arange(n) % (n // 2)
    keys[rng.integers(0, n, 8)] = 0        # a few shorter gaps among them
    cases["every gap about N/2"] = [(_prevs(keys), sized(keys))]
    return cases


DISTANCE_CASES = list(_distance_cases(MODEL_TILE))


@pytest.mark.parametrize("case", DISTANCE_CASES)
def test_distance_model_cases(jx, case):
    """The design's traps at a small tile: model, plain version and the
    reference's ``_dist_batch`` bit for bit, the problems of a case in
    one bucket."""
    problems = _distance_cases(MODEL_TILE)[case]
    if case == "gaps across every level":
        (prev, _), = problems
        crossed = {_split_level(p, i) for i, p in enumerate(prev) if p >= 0}
        assert crossed == set(range(len(prev).bit_length() - 1))
    want = jx.sd.stack_distances_batch(problems)
    plain = sd.stack_distances_batch(problems, device="cpu")
    for (prev, sizes), w, p in zip(problems, want, plain):
        assert _same_bits(p, w)
        got = model_distances(prev, sizes, tile=MODEL_TILE,
                              items=MODEL_ITEMS, chunk=MODEL_CHUNK)
        assert _same_bits(got, w)


def test_distance_model_at_the_kernel_tile(jx):
    """A row of 3T+17 at the kernel's own tile: two levels over the row."""
    problems = _distance_cases(sd.DIST_TILE)["length 3T+17"]
    (prev, sizes), = problems
    st = types.SimpleNamespace(tile_levels=0, row_levels=0)
    got = model_distances(prev, sizes, st=st)
    assert (st.tile_levels, st.row_levels) == (9, 2)
    want, = jx.sd.stack_distances_batch(problems)
    assert _same_bits(got, want)
    assert _same_bits(_plain_one(ref.stack_distances_ref, prev, sizes),
                      want)


@pytest.mark.parametrize("seed", SEEDS)
def test_cache_sim_kernel_model_equals_plain(seed):
    _, _, sim = random_problems(seed)
    for keys, admit, reset, ksz, cap, fifo in sim:
        want = _plain_one(ref.cache_sim_ref, keys, admit, reset, ksz,
                          np.float64(cap), fifo)
        got = model_cache_sim(keys, admit, reset, ksz, cap, fifo)
        assert np.array_equal(got[0], want[0])
        assert (got[1], got[2]) == want[1:]


@pytest.mark.parametrize("seed", SEEDS)
def test_fifo_kernel_model_equals_plain(seed):
    _, fifo, _ = random_problems(seed)
    for keys, sizes, admit, reset, n_keys, cap in fifo:
        want = _plain_one(ref.fifo_replay_ref, keys, sizes, admit, reset,
                          np.zeros(n_keys), np.float64(cap))
        got = model_fifo_replay(keys, sizes, admit, reset, n_keys, cap)
        assert np.array_equal(got[0], want[0])
        assert (got[1], got[2]) == want[1:]


def test_one_byte_control_fails_the_check():
    """The check of equal counters must see one byte: at a capacity C that
    decides an eviction, the kernel's model equals the plain version, and
    the same problem at C - 1 (the control) gives other counters."""
    _, fifo, _ = random_problems(1)
    keys, sizes, admit, reset, n_keys, cap = next(
        p for p in fifo if model_fifo_replay(*p)[1] > 0)

    def model(c):
        return model_fifo_replay(keys, sizes, admit & (sizes <= c), reset,
                                 n_keys, float(c))
    c = next(c for c in range(int(cap), 1, -1)
             if model(c)[1:] != model(c - 1)[1:])
    exact = _plain_one(ref.fifo_replay_ref, keys, sizes,
                       admit & (sizes <= c), reset, np.zeros(n_keys),
                       np.float64(c))
    assert model(c)[1:] == exact[1:]
    assert model(c - 1)[1:] != exact[1:]


def test_window_search_restarts_and_equals_searchsorted():
    """The warp's search from any hint, valid or not, is numpy's
    ``searchsorted`` (left side) over the steps taken, whether it reuses
    its window or reads a new one; a hint that is no lower bound restarts
    it at 0, and a hint that is one never does."""
    rng = np.random.default_rng(11)
    steps = rng.integers(0, 4, 400).astype(np.float64)
    steps[rng.random(400) < 0.3] = 0.0             # ties: zero-byte steps
    cb = np.cumsum(steps)
    cn = np.arange(1, 401)
    restarted = 0
    for _ in range(300):
        t = int(rng.integers(1, 400))
        target = float(rng.integers(0, int(cb[t - 1]) + 3))
        st = search_state()
        st.lo = int(rng.integers(0, t + 1))
        st.lo_prev = cb[st.lo - 1] if st.lo else -np.inf
        valid = st.lo == 0 or st.lo_prev < target
        j, new_e, new_n = window_search(cb, cn, t, target, st)
        want = int(np.searchsorted(cb[:t], target, side="left"))
        assert j == want
        assert (new_e, new_n) == ((cb[j], cn[j]) if j < t else (np.inf, 0))
        assert st.restarts == (0 if valid else 1)
        restarted += st.restarts
    assert restarted > 50
    # one state through a stream of rising targets: the window is reused
    st, searches = search_state(), 0
    for t in range(10, 400, 3):
        target = cb[t - 1] - 150.0      # the frontier ~100 steps back
        if target > cb[max(st.lo - 1, 0)]:
            j, _, _ = window_search(cb, cn, t, target, st)
            assert j == int(np.searchsorted(cb[:t], target, side="left"))
            searches += 1
    assert st.restarts == 0 and 0 < st.loads < searches / 2


def test_fifo_model_zero_byte_keys_and_resets():
    """Zero-byte keys (never resident once admitted at the frontier's
    total, ties in cumB) and frequent resets, against the plain version;
    the valid stream never restarts the search, and the window is read
    far fewer times than the search runs."""
    rng = np.random.default_rng(5)
    for reset_rate in (0.0, 0.02, 0.2):
        keys, ksz, reset, _ = _stream(rng, 3000, 300, 40,
                                      reset_rate=reset_rate)
        ksz[rng.random(300) < 0.2] = 0.0
        sizes = ksz[keys]
        for cap in (40.0, 60.0, 500.0):
            admit = (rng.random(3000) < 0.9) & (sizes <= cap)
            st = search_state()
            got = model_fifo_replay(keys, sizes, admit, reset, 300, cap, st)
            want = _plain_one(ref.fifo_replay_ref, keys, sizes, admit, reset,
                              np.zeros(300), np.float64(cap))
            assert np.array_equal(got[0], want[0])
            assert (got[1], got[2]) == want[1:]
            assert st.restarts == 0
            if cap == 60.0:
                assert got[1] > 100 and st.loads < got[1]


@pytest.mark.parametrize("n_keys", [16384, 16385])
def test_fifo_design_boundary(n_keys):
    """Kp 16,384 keeps the key state beside the ring in shared memory, Kp
    32,768 in device memory; the model (the same values in either place)
    equals the plain version on a stream over keys at the top of the
    range."""
    kp = sd._next_pow2(n_keys, floor=sd._FLOOR_K)
    design = sd.FIFO_REPLAY.design(kp)
    assert design == ("smem" if kp <= 16384 else "global")
    assert (sd.FIFO_RING_BYTES + 8 * kp <= sd.BLOCK_SMEM_BYTES) == \
        (design == "smem")
    rng = np.random.default_rng(n_keys)
    keys = (n_keys - 1 - rng.integers(0, 200, 2500)).astype(np.int32)
    ksz = rng.integers(0, 50, n_keys).astype(np.float64)
    sizes = ksz[keys]
    reset = rng.random(2500) < 0.005
    admit = (rng.random(2500) < 0.9) & (sizes <= 900.0)
    got = model_fifo_replay(keys, sizes, admit, reset, n_keys, 900.0)
    want = _plain_one(ref.fifo_replay_ref, keys, sizes, admit, reset,
                      np.zeros(kp), np.float64(900.0))
    assert np.array_equal(got[0], want[0])
    assert (got[1], got[2]) == want[1:] and got[1] > 0


def _bits(x):
    """A float64's bits: NaN equals NaN, +inf is not NaN."""
    return np.float64(x).view(np.int64)


def _sim_cases():
    """Hand-made slot-machine problems, each at one trap of the kernel's
    design: name → (problems (keys, admit, reset, key_sizes, capacity,
    fifo), what the model's counters must show)."""
    rng = np.random.default_rng(7)

    def both(keys, ksz, cap, reset=None, admit=None):
        keys = np.asarray(keys, np.int32)
        ksz = np.asarray(ksz, np.float64)
        reset = np.zeros(len(keys), bool) if reset is None else reset
        admit = np.ones(len(keys), bool) if admit is None else admit
        return [(keys, admit, reset, ksz, float(cap), f)
                for f in (False, True)]

    # zero-byte keys among sized ones, evicting: resident, never victims
    keys, ksz, _, _ = _stream(rng, 900, 40, 30, reset_rate=0.0)
    ksz[::3] = 0.0
    zero = both(keys, ksz, 60.0, admit=rng.random(900) < 0.9)
    # an insert that evicts, then a reset on the very next step
    keys = [0, 1, 2, 3, 4, 5, 1, 2, 0, 6, 7, 8, 9, 1, 0, 5]
    reset = np.zeros(len(keys), bool)
    reset[6] = True
    after = both(keys, [10.0] * 10, 50.0, reset=reset)
    keys, ksz, reset, _ = _stream(rng, 900, 30, 20, reset_rate=0.1)
    after += both(keys, ksz, 45.0, reset=reset)
    # LRU hits on the oldest resident key, the slot at the head
    head = both([0, 1, 2, 0, 1, 2, 3, 1, 2, 0, 4, 2, 5], [10.0] * 6, 30.0)
    # walks of many victims, with holes left by LRU touches and zero-byte
    # keys on the way
    keys = list(range(40)) + [5, 7, 40] + list(range(41, 150)) + [150, 151]
    ksz = np.ones(152)
    ksz[[40, 150]] = 35.0, 100.0
    ksz[[9, 60, 61]] = 0.0
    long = both(keys, ksz, 40.0) + both(keys, ksz, 120.0)
    # walks across the head ring's tiles of 1,024 slots: one insert that
    # frees slots 0..1049, and after a reset that moves the head into the
    # second tile, evictions that walk on into the third
    keys = np.arange(2600) % 1400
    ksz = np.ones(1400)
    ksz[1100] = 1050.0
    reset = np.zeros(2600, bool)
    reset[1500] = True
    tiles = both(keys[:1400], ksz, 1100.0) + both(keys, ksz, 200.0,
                                                    reset=reset)
    # an admitted insert larger than the capacity: it frees every slot
    # and is inserted; the next insert evicts it
    over = both([0, 1, 2, 0, 3, 4, 2], [4.0, 4.0, 20.0, 4.0, 4.0], 10.0)
    # FIFO and LRU over one stream at one capacity, in one batch
    keys, ksz, reset, _ = _stream(rng, 700, 50, 40)
    mixed = both(keys, ksz, 150.0, reset=reset,
                 admit=rng.random(700) < 0.85)
    return {"zero_byte_keys": (zero, lambda st: st.walks > 20
                               and st.skipped > 0),
            "reset_after_eviction": (after, lambda st: st.walks > 0),
            "lru_touch_at_head": (head, lambda st: st.head_touches >= 4
                                  and st.skipped > 0),
            "long_walks": (long, lambda st: st.victims_max > 64
                           and st.skipped > 0),
            "walk_crosses_head_tiles": (tiles, lambda st:
                                        st.tiles_crossed >= 4
                                        and st.victims_max >= 1050),
            "oversize_admit": (over, lambda st: st.victims_max == 2),
            "fifo_and_lru_in_one_batch": (mixed, lambda st: st.walks > 20)}


def _reference_sim(jx, problems):
    """The reference's ``_sim_batch`` on problems in one batch, padded as
    its batch function pads them: (hits, evictions, bytes evicted)."""
    Np = sd._next_pow2(max(len(p[0]) for p in problems), floor=sd._FLOOR_N)
    Kp = sd._next_pow2(max(len(p[3]) for p in problems), floor=sd._FLOOR_K)
    num = len(problems)
    keys = np.zeros((num, Np), np.int32)
    admit = np.zeros((num, Np), bool)
    reset = np.zeros((num, Np), bool)
    ksz = np.zeros((num, Kp))
    for b, (k, a, r, s, _, _) in enumerate(problems):
        keys[b, :len(k)], admit[b, :len(a)], reset[b, :len(r)] = k, a, r
        ksz[b, :len(s)] = s
    cap = np.array([p[4] for p in problems])
    fifo = np.array([p[5] for p in problems])
    with jx.sd.enable_x64():
        hits, ev, evb = (np.asarray(x) for x in jx.sd._sim_batch(
            keys, admit, reset, ksz, cap, fifo))
    return [(hits[b, :len(p[0])], int(ev[b]), float(evb[b]))
            for b, p in enumerate(problems)]


def _plain_sim(problems):
    """``ref.cache_sim_ref`` on problems of one length in one batch."""
    keys, admit, reset = (torch.from_numpy(np.stack([p[i] for p in
                                                     problems]))
                          for i in range(3))
    kp = max(len(p[3]) for p in problems)
    ksz = torch.from_numpy(np.stack([np.pad(p[3], (0, kp - len(p[3])))
                                     for p in problems]))
    hits, ev, evb = ref.cache_sim_ref(
        keys, admit, reset, ksz, torch.tensor([p[4] for p in problems],
                                              dtype=torch.float64),
        torch.tensor([p[5] for p in problems]))
    return [(hits[b].numpy(), int(ev[b]), float(evb[b]))
            for b in range(len(problems))]


def _assert_same(got, want):
    assert np.array_equal(got[0], want[0])
    assert got[1] == want[1] and _bits(got[2]) == _bits(want[2])


@pytest.mark.parametrize("case", list(_sim_cases()))
def test_cache_sim_model_cases(jx, case):
    """Each trap of the slot machine's design: the kernel's model equals
    the plain version and the reference's ``_sim_batch`` bit for bit, and
    its counters show that the case reached the trap."""
    problems, shows = _sim_cases()[case]
    want = _reference_sim(jx, problems)
    plain = _plain_sim(problems) if case == "fifo_and_lru_in_one_batch" \
        else [_plain_sim([p])[0] for p in problems]
    st = sim_state()
    for p, w, pl in zip(problems, want, plain):
        got = model_cache_sim(*p, st=st)
        _assert_same(got, w)
        _assert_same(pl, w)
    assert shows(st)
    if case == "fifo_and_lru_in_one_batch":
        assert want[0][1:] != want[1][1:]


@pytest.mark.parametrize("seed", SEEDS)
def test_cache_sim_model_equals_the_reference(jx, seed):
    """The kernel's model against the reference's ``_sim_batch`` on the
    random families (every problem of a seed in one batch); its walks
    inspect each slot at most once."""
    _, _, sim = random_problems(seed)
    st = sim_state()
    for p, want in zip(sim, _reference_sim(jx, sim)):
        _assert_same(model_cache_sim(*p, st=st), want)
    assert st.walks > 50 and st.skipped > 0
    # the head only moves forward: no slot is inspected twice
    assert st.inspected <= sum(len(p[0]) for p in sim)


@pytest.mark.parametrize("n_keys", [16384, 16385])
def test_cache_sim_design_boundary(n_keys):
    """Kp 16,384 keeps key_sizes and key_slot beside the rings in shared
    memory (12 B a key, up to Kp 17,056), Kp 32,768 in device memory; the
    model equals the plain version on a stream over keys at the top of
    the range."""
    kp = sd._next_pow2(n_keys, floor=sd._FLOOR_K)
    design = sd.CACHE_SIM.design(kp)
    assert design == ("smem" if kp <= 16384 else "global")
    assert [sd.CACHE_SIM.design(k) for k in (17056, 17058)] == \
        ["smem", "global"]
    assert (sd.SIM_RING_BYTES + 12 * kp <= sd.BLOCK_SMEM_BYTES) == \
        (design == "smem")
    rng = np.random.default_rng(n_keys)
    keys = (n_keys - 1 - rng.integers(0, 200, 2500)).astype(np.int32)
    ksz = rng.integers(0, 50, n_keys).astype(np.float64)
    reset = rng.random(2500) < 0.005
    admit = (rng.random(2500) < 0.9) & (ksz[keys] <= 900.0)
    for fifo in (False, True):
        got = model_cache_sim(keys, admit, reset, ksz, 900.0, fifo)
        want = _plain_one(ref.cache_sim_ref, keys, admit, reset,
                          np.pad(ksz, (0, kp - n_keys)), np.float64(900.0),
                          fifo)
        _assert_same(got, want)
        assert got[1] > 0


# keys, sizes, admit, reset, capacity: the third reference (20 B) is larger
# than the capacity and admitted, which moves the frontier to +inf
OVERSIZE = ([0, 1, 2, 0, 3], [4.0, 4.0, 20.0, 4.0, 4.0], 10.0)


def _oversize(reset_at=None, last=False):
    keys, sizes, cap = OVERSIZE
    keys, sizes = np.array(keys, np.int32), np.array(sizes)
    if last:                               # the oversize insert comes last
        keys, sizes = keys[:3], sizes[:3]
    reset = np.zeros(len(keys), bool)
    if reset_at is not None:
        reset[reset_at] = True
    return keys, sizes, np.ones(len(keys), bool), reset, 4, cap


# name: (problem, the reference's row width, its bytes evicted)
OVERSIZE_CASES = {"no_later_reset": (_oversize(), 5, np.nan),
                  "reset_on_the_next_step": (_oversize(3), 5, np.inf),
                  "reset_on_the_next_step_padded": (_oversize(3), 256,
                                                    np.inf),
                  "oversize_last": (_oversize(last=True), 3, np.inf),
                  "oversize_last_padded": (_oversize(last=True), 256,
                                           np.nan)}


@pytest.mark.parametrize("case", list(OVERSIZE_CASES))
def test_fifo_oversize_admit_bytes(jx, case):
    """An admitted insert larger than the capacity moves the frontier to
    +inf: the reference's ``_fifo_batch``, the plain version and the
    kernel's model give NaN bytes evicted (``inf - inf`` on a later step
    without a reset, the reference's padding steps included) or +inf (a
    reset on the very next step, or no step after), and the same counts:
    0 evictions, since cumN is 0 where cumB is +inf."""
    (keys, sizes, admit, reset, n_keys, cap), width, want_evb = \
        OVERSIZE_CASES[case]
    pad = width - len(keys)
    rows = [np.pad(x, (0, pad)) for x in (keys, sizes, admit, reset)]
    with jx.sd.enable_x64():
        hits, ev, evb = (np.asarray(x)[0] for x in jx.sd._fifo_batch(
            *(r[None] for r in rows), np.zeros((1, n_keys)),
            np.array([cap])))
    want = (hits[:len(keys)], int(ev), float(evb))
    assert np.array_equal(want[2], want_evb, equal_nan=True) and \
        want[1] == 0
    plain = _plain_one(ref.fifo_replay_ref, *rows, np.zeros(n_keys),
                       np.float64(cap))
    _assert_same((plain[0][:len(keys)],) + plain[1:], want)
    with np.errstate(invalid="ignore"):
        got = model_fifo_replay(keys, sizes, admit, reset, n_keys, cap,
                                width=width)
    _assert_same(got, want)


@pytest.mark.parametrize("case,error", [("no_later_reset", ValueError),
                                        ("reset_on_the_next_step",
                                         OverflowError)])
def test_fifo_sim_batch_raises_on_oversize(jx, case, error):
    """Both packages' ``fifo_sim_batch`` round the bytes evicted to an
    int, as the reference does: NaN raises ValueError, +inf
    OverflowError."""
    problem = OVERSIZE_CASES[case][0]
    with pytest.raises(error):
        jx.sd.fifo_sim_batch([problem])
    with pytest.raises(error):
        sd.fifo_sim_batch([problem], device="cpu")


# ---------------------------------------------------------------------------
# On the card: each kernel against its plain version
# ---------------------------------------------------------------------------
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _distances_on_card(card, problems, width):
    """The kernel on a bucket of ``problems`` in rows of ``width``, one
    launch, against the plain version on the card: torch.equal."""
    prev = np.full((len(problems), width), -1, np.int64)
    sizes = np.zeros((len(problems), width))
    lengths = np.zeros(len(problems), np.int32)
    for b, (p, s) in enumerate(problems):
        prev[b, :len(p)], sizes[b, :len(s)], lengths[b] = p, s, len(p)
    args = [torch.from_numpy(a).to(card) for a in (prev, sizes)]
    before = sd.DISTANCES.launches
    got = ops.stack_distances(*args, torch.from_numpy(lengths).to(card))
    assert sd.DISTANCES.launches == before + 1
    assert torch.equal(got, ref.stack_distances_ref(*args))


@pytest.mark.gpu
@pytest.mark.parametrize("n", [2048, 32768, 3 * sd.DIST_TILE + 17])
@pytest.mark.parametrize("seed", SEEDS)
def test_distance_kernel_on_card(card, seed, n):
    """Rows of n (below the tile, with levels over the row, and not a
    power of two), problems of lengths up to n."""
    rng = np.random.default_rng(seed)
    problems = []
    for length in (n, n - 1, n // 2 + 17, 300, 37):
        keys, ksz, _, prev = _stream(rng, length,
                                     int(rng.integers(8, length // 2)), 40)
        problems.append((prev, ksz[keys]))
    _distances_on_card(card, problems, n)


@pytest.mark.gpu
@pytest.mark.parametrize("case", DISTANCE_CASES)
def test_distance_cases_on_card(card, case):
    """The design's traps at the kernel's tile, in one bucket each."""
    problems = _distance_cases(sd.DIST_TILE)[case]
    _distances_on_card(card, problems, max(len(p) for p, _ in problems))


@pytest.mark.gpu
@pytest.mark.parametrize("seed", SEEDS)
def test_cache_sim_kernel_on_card(card, seed):
    _, _, sim = random_problems(seed)
    n, kp, num = 2048, 128, len(sim)
    keys = np.zeros((num, n), np.int32)
    admit = np.zeros((num, n), bool)
    reset = np.zeros((num, n), bool)
    ksz = np.zeros((num, kp))
    cap = np.zeros(num)
    fifo = np.zeros(num, bool)
    lengths = np.zeros(num, np.int32)
    for b, (k, a, r, s, c, f) in enumerate(sim):
        keys[b, :len(k)], admit[b, :len(a)], reset[b, :len(r)] = k, a, r
        ksz[b, :len(s)], cap[b], fifo[b], lengths[b] = s, c, f, len(k)
    args = [torch.from_numpy(x).to(card)
            for x in (keys, admit, reset, ksz, cap, fifo)]
    before = sd.CACHE_SIM.launches
    hits, ev, evb = ops.cache_sim(*args, torch.from_numpy(lengths).to(card))
    assert sd.CACHE_SIM.launches == before + 1
    w_hits, w_ev, w_evb = ref.cache_sim_ref(*args)
    assert torch.equal(ev, w_ev) and torch.equal(evb, w_evb)
    for b, length in enumerate(lengths):
        assert torch.equal(hits[b, :length], w_hits[b, :length])


@pytest.mark.gpu
@pytest.mark.parametrize("seed", SEEDS)
def test_fifo_kernel_on_card(card, seed):
    _, fifo, _ = random_problems(seed)
    n, kp, num = 2048, 128, len(fifo)
    keys = np.zeros((num, n), np.int32)
    sizes = np.zeros((num, n))
    admit = np.zeros((num, n), bool)
    reset = np.zeros((num, n), bool)
    cap = np.full(num, np.inf)
    lengths = np.zeros(num, np.int32)
    for b, (k, s, a, r, _, c) in enumerate(fifo):
        keys[b, :len(k)], sizes[b, :len(s)] = k, s
        admit[b, :len(a)], reset[b, :len(r)] = a, r
        cap[b], lengths[b] = c, len(k)
    args = [torch.from_numpy(x).to(card)
            for x in (keys, sizes, admit, reset, np.zeros((num, kp)), cap)]
    before = sd.FIFO_REPLAY.launches
    hits, ev, evb = ops.fifo_replay(*args, torch.from_numpy(lengths).to(card))
    assert sd.FIFO_REPLAY.launches == before + 1
    w_hits, w_ev, w_evb = ref.fifo_replay_ref(*args)
    assert torch.equal(ev, w_ev) and torch.equal(evb, w_evb)
    for b, length in enumerate(lengths):
        assert torch.equal(hits[b, :length], w_hits[b, :length])


@pytest.mark.gpu
def test_batch_functions_on_card_equal_cpu(card):
    dist, fifo, sim = random_problems(3)
    assert all(np.array_equal(a, b) for a, b in zip(
        sd.stack_distances_batch(dist, device=card),
        sd.stack_distances_batch(dist, device="cpu")))
    _same_results(sd.fifo_sim_batch(fifo, device=card),
                  sd.fifo_sim_batch(fifo, device="cpu"))
    _same_results(sd.cache_sim_batch(sim, device=card),
                  sd.cache_sim_batch(sim, device="cpu"))


@pytest.mark.gpu
@pytest.mark.parametrize("n_keys", [300, 16384, 16385])
def test_fifo_designs_on_card(card, n_keys):
    """Both designs against the plain version on the card: zero-byte keys,
    resets, a length that is no multiple of 16 (the ring's copies pad it),
    and Kp on each side of the boundary; the launch counted by design."""
    rng = np.random.default_rng(n_keys)
    kp = sd._next_pow2(n_keys, floor=sd._FLOOR_K)
    num, n = 4, 3001
    keys = (n_keys - 1 - rng.integers(0, 250, (num, n))).astype(np.int32)
    ksz = rng.integers(0, 40, n_keys).astype(np.float64)
    ksz[rng.random(n_keys) < 0.2] = 0.0
    sizes = ksz[keys]
    reset = rng.random((num, n)) < 0.01
    cap = np.array([40.0, 200.0, 1000.0, 1e9])
    admit = (rng.random((num, n)) < 0.9) & (sizes <= cap[:, None])
    args = [torch.from_numpy(x).to(card) for x in
            (keys, sizes, admit, reset, np.zeros((num, kp)), cap)]
    design = sd.FIFO_REPLAY.design(kp)
    before = dict(sd.FIFO_REPLAY.launches_by_design)
    hits, ev, evb = ops.fifo_replay(*args, torch.full((num,), n).to(card))
    assert sd.FIFO_REPLAY.launches_by_design[design] == before[design] + 1
    w_hits, w_ev, w_evb = ref.fifo_replay_ref(*args)
    assert torch.equal(hits, w_hits)
    assert torch.equal(ev, w_ev) and torch.equal(evb, w_evb)
    assert int(ev[0]) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("n_keys", [301, 16384, 16385])
def test_cache_sim_designs_on_card(card, n_keys):
    """Both designs of the slot machine against the plain version on the
    card, LRU and FIFO: zero-byte keys, resets, a length that is no
    multiple of 16 and an odd Kp (the wrapper pads both), Kp on each
    side of the boundary; the launch counted by design."""
    rng = np.random.default_rng(n_keys)
    num, n = 4, 3001
    keys = (n_keys - 1 - rng.integers(0, 250, (num, n))).astype(np.int32)
    ksz = rng.integers(0, 40, (num, n_keys)).astype(np.float64)
    ksz[rng.random((num, n_keys)) < 0.2] = 0.0
    reset = rng.random((num, n)) < 0.01
    cap = np.array([40.0, 200.0, 1000.0, 1e9])
    admit = (rng.random((num, n)) < 0.9) & \
        (np.take_along_axis(ksz, keys, 1) <= cap[:, None])
    fifo = np.array([False, True, False, True])
    args = [torch.from_numpy(x).to(card)
            for x in (keys, admit, reset, ksz, cap, fifo)]
    design = sd.CACHE_SIM.design(n_keys + n_keys % 2)
    before = dict(sd.CACHE_SIM.launches_by_design)
    hits, ev, evb = ops.cache_sim(*args, torch.full((num,), n).to(card))
    assert sd.CACHE_SIM.launches_by_design[design] == before[design] + 1
    w_hits, w_ev, w_evb = ref.cache_sim_ref(*args)
    assert torch.equal(hits, w_hits)
    assert torch.equal(ev, w_ev) and torch.equal(evb, w_evb)
    assert int(ev[0]) > 0 and int(ev[1]) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(_sim_cases()))
def test_cache_sim_cases_on_card(card, case):
    """The hand-made traps of the slot machine, in one batch a case, on
    the card against the plain version on the card."""
    problems, _ = _sim_cases()[case]
    num = len(problems)
    n = max(len(p[0]) for p in problems)
    kp = max(len(p[3]) for p in problems)
    keys = np.zeros((num, n), np.int32)
    admit = np.zeros((num, n), bool)
    reset = np.zeros((num, n), bool)
    ksz = np.zeros((num, kp))
    lengths = np.zeros(num, np.int32)
    for b, (k, a, r, s, _, _) in enumerate(problems):
        keys[b, :len(k)], admit[b, :len(a)], reset[b, :len(r)] = k, a, r
        ksz[b, :len(s)], lengths[b] = s, len(k)
    args = [torch.from_numpy(x).to(card) for x in
            (keys, admit, reset, ksz, np.array([p[4] for p in problems]),
             np.array([p[5] for p in problems]))]
    hits, ev, evb = ops.cache_sim(*args, torch.from_numpy(lengths).to(card))
    w_hits, w_ev, w_evb = ref.cache_sim_ref(*args)
    assert torch.equal(ev, w_ev) and torch.equal(evb, w_evb)
    for b, length in enumerate(lengths):
        assert torch.equal(hits[b, :length], w_hits[b, :length])


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(OVERSIZE_CASES))
def test_fifo_oversize_on_card(card, case):
    """The FIFO replay after an admitted oversize insert, on the card:
    the same NaN or +inf bytes evicted as the plain version (compared by
    bits: ``torch.equal`` takes NaN for unequal) and the same counts,
    with the reference's row ``width`` as the kernel's Np."""
    (keys, sizes, admit, reset, n_keys, cap), width, want_evb = \
        OVERSIZE_CASES[case]
    pad = width - len(keys)
    args = [torch.from_numpy(np.pad(x, (0, pad))[None]).to(card)
            for x in (keys, sizes, admit, reset)]
    args += [torch.zeros(1, n_keys, dtype=torch.float64, device=card),
             torch.tensor([cap], dtype=torch.float64, device=card)]
    hits, ev, evb = ops.fifo_replay(*args, torch.tensor([len(keys)],
                                                        device=card))
    w_hits, w_ev, w_evb = ref.fifo_replay_ref(*args)
    assert torch.equal(hits[0, :len(keys)], w_hits[0, :len(keys)])
    assert torch.equal(ev, w_ev)
    assert torch.equal(evb.view(torch.int64), w_evb.view(torch.int64))
    assert np.array_equal(float(evb[0]), want_evb, equal_nan=True)
