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
algorithms — distances from ``next`` pointers with a warp's lanes and a
shuffle reduction, the slot machine's head pointer and key epochs, the
FIFO frontier's forward search — are modelled line for line in numpy and
held to the plain versions; a control at a capacity one byte below a size
that decides an eviction must fail the same check.  The ``gpu`` tests hold
each kernel to its plain version on the card.  JAX comes in through the
``jx`` fixture, so that on the machine with the card, which has no JAX,
the ``gpu`` tests run.
"""
import types

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels import stack_distance as sd

SEEDS = range(6)
INT_MAX = np.iinfo(np.int32).max


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
def model_distances(prev, sizes):
    """``sd_distances``: next pointers (atomicMin), then per reference a
    warp's 32 lane sums over (p, i) and a shuffle-down reduction."""
    n = len(prev)
    nxt = np.full(n, INT_MAX, np.int64)
    for i, p in enumerate(prev):
        if 0 <= p < i:
            nxt[p] = min(nxt[p], i)
    out = np.full(n, np.inf)
    lane_ids = np.arange(32)
    for i, p in enumerate(prev):
        if p < 0:
            continue
        acc = np.zeros(32)
        for j in range(p + 1, i):
            if nxt[j] >= i:
                acc[(j - p - 1) % 32] += sizes[j]
        for off in (16, 8, 4, 2, 1):
            src = lane_ids + off
            acc = acc + np.where(src < 32, acc[np.minimum(src, 31)], acc)
        out[i] = acc[0]
    return out


def model_cache_sim(keys, admit, reset, key_sizes, cap, fifo):
    """``sd_cache_sim``: one problem's chain with a head pointer over the
    slots and an epoch per key."""
    n = len(keys)
    sb = np.zeros(n)
    sk = np.zeros(n, np.int64)
    kslot = np.zeros(len(key_sizes), np.int64)
    epoch_of = np.zeros(len(key_sizes), np.int64)
    epoch, head, usage, evb, ev = 1, 0, 0.0, 0.0, 0
    hits = np.zeros(n, bool)
    for t in range(n):
        k = int(keys[t])
        if reset[t]:
            epoch += 1
            head = t
            usage = 0.0
        s = key_sizes[k]
        hit = epoch_of[k] == epoch
        do_insert = not hit and bool(admit[t])
        if do_insert:
            need = usage + s - cap
            freed = 0.0
            j = head
            while j < t:
                if sb[j] > 0.0:
                    if not freed < need:
                        break
                    freed += sb[j]
                    sb[j] = 0.0
                    epoch_of[sk[j]] = 0
                    ev += 1
                j += 1
            head = j
            usage -= freed
            evb += freed
        touch = do_insert or (hit and not fifo)
        if hit and touch:
            sb[kslot[k]] = 0.0
        sb[t] = s if touch else 0.0
        sk[t] = k
        if touch:
            kslot[k] = t
        epoch_of[k] = epoch if (hit or do_insert) else 0
        if do_insert:
            usage += s
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


def model_fifo_replay(keys, sizes, admit, reset, n_keys, cap, st=None):
    """``sd_fifo_replay``: the stream in ring tiles of 1,024 references,
    the key state kcum (float64, in shared memory or device memory by Kp:
    the same values) and the frontier moved by ``window_search`` (the
    kernel reads the last 4,096 steps from its shared history, older ones
    from device memory: the same values)."""
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
            if ins:
                total += s
                tot_n += 1
                kcum[k] = total
            cb[t], cn[t] = total, tot_n
            hits[t] = hit
    return hits, ev, evb


def _plain_one(fn, *arrays):
    """Run a plain version on one problem (a batch of one) on the CPU."""
    out = fn(*(torch.from_numpy(np.asarray(a)[None]) for a in arrays))
    if isinstance(out, torch.Tensor):
        return out[0].numpy()
    hits, ev, evb = out
    return hits[0].numpy(), int(ev[0]), float(evb[0])


@pytest.mark.parametrize("seed", SEEDS)
def test_distance_kernel_model_equals_plain(seed):
    dist, _, _ = random_problems(seed)
    for prev, sizes in dist[:4]:
        want = _plain_one(ref.stack_distances_ref, prev, sizes)
        assert np.array_equal(model_distances(prev, sizes), want)


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


# ---------------------------------------------------------------------------
# On the card: each kernel against its plain version
# ---------------------------------------------------------------------------
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("seed", SEEDS)
def test_distance_kernel_on_card(card, seed):
    dist, _, _ = random_problems(seed)
    n = 2048
    prev = np.full((len(dist), n), -1, np.int64)
    sizes = np.zeros((len(dist), n))
    lengths = np.zeros(len(dist), np.int32)
    for b, (p, s) in enumerate(dist):
        prev[b, :len(p)], sizes[b, :len(s)], lengths[b] = p, s, len(p)
    args = [torch.from_numpy(a).to(card) for a in (prev, sizes)]
    before = sd.DISTANCES.launches
    got = ops.stack_distances(*args, torch.from_numpy(lengths).to(card))
    assert sd.DISTANCES.launches == before + 1
    want = ref.stack_distances_ref(*args)
    assert torch.equal(got, want)


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
