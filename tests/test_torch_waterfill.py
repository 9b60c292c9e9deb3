"""The max-min solve as the ``maxmin_waterfill`` kernel takes it.

The kernel (``csrc/maxmin.cu``) cannot run here, so its algorithm is
modelled in numpy step for step: the per-link flow lists built by a
counting sort (per-warp counts over tiles of 32 entries, a link-major
scan, ranks inside a tile), the integer active counts, the tightest share
as a min, ``best`` and the three branches, the retired capacity in
float64 (``best × count`` in the bottleneck branch; in the capped branch
a short list's sum in list order, a long list's lane-strided sums folded
by an xor tree) rounded once, every float32 step
rounded as the kernel's ``_rn`` intrinsics round it.  The model is held to
the plain version (``ops.maxmin_waterfill`` on CPU tensors) within 1e-6
relative with equal round counts, and its rates after the host's loopback
fix-up to ``maxmin_ref`` within the reference's rtol 2e-3 / atol 1e3, over
the random family of ``test_torch_maxmin.py`` and named edge cases.

The ``gpu`` tests hold the kernel to the plain version on the card, two
launches to the same bits, a bucket whose lists do not fit a block's
shared memory (the design that keeps them in device memory) likewise,
buckets whose flow state does not fit either (Fp 32768 and 131072: the
design that keeps it in device memory too) to the plain version's bits,
and buckets whose link state alone does not fit (Lp 16384 and 32768: the
design that keeps that in device memory too) likewise.  On the CPU, the
plain version at those link counts is held to the reference's
``maxmin_rates_batch``.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.kernels import batched_maxmin, maxmin, ops
from repro_torch.kernels.ref import maxmin_ref
from test_torch_maxmin import (JAX_RTOL, N_PROBLEMS, dense, padded,
                              random_problem)

MODEL_RTOL = 1e-6
REF_RTOL, REF_ATOL = 2e-3, 1e3
BUILD_COUNTERS = 8192
SHORT_LIST = 32         # a list this long or shorter: one thread's sum
F32_INF = np.float32(np.inf)


def build_lists(ids, Lp):
    """The kernel's counting sort: (offsets (Lp + 1,), list of flows)."""
    Fp, width = ids.shape
    threads = min(1024, max(64, Fp))
    nw = threads // 32
    bw = min(nw, max(1, BUILD_COUNTERS // Lp))
    flat = ids.reshape(-1)
    dummy = Lp - 1
    chunk = -(-Fp // bw)
    ranges = [(min(w * chunk, Fp) * width, min((w + 1) * chunk, Fp) * width)
              for w in range(bw)]

    def tiles(e0, e1):
        for base in range(e0, e1, 32):
            lanes = np.arange(base, min(base + 32, e1))
            links = flat[lanes]
            real = links < dummy
            yield lanes[real], links[real]

    cnt = np.zeros((bw, Lp), np.int64)
    for w, (e0, e1) in enumerate(ranges):
        for _, links in tiles(e0, e1):
            for link in np.unique(links):      # each group's leader adds
                cnt[w, link] += int((links == link).sum())
    off = np.zeros(Lp + 1, np.int64)
    off[1:] = np.cumsum(cnt.sum(0))
    cursor = off[:-1] + np.cumsum(cnt, 0) - cnt   # link-major, warp-minor
    lst = np.full(int(off[-1]), -1, np.int64)
    for w, (e0, e1) in enumerate(ranges):
        for lanes, links in tiles(e0, e1):
            for link in np.unique(links):
                group = lanes[links == link]       # lane order: the rank
                lst[cursor[w, link] + np.arange(group.size)] = group // width
                cursor[w, link] += group.size
    assert (lst >= 0).all()
    return off, lst


def xor_fold(lane_sums):
    """The kernel's ``__shfl_xor_sync`` tree over 32 lanes; lane 0's sum."""
    acc = lane_sums.copy()
    for d in (16, 8, 4, 2, 1):
        acc = acc + acc[np.arange(32) ^ d]
    return acc[0]


def model_waterfill(caps, ids, fcaps):
    """One padded problem through the kernel's algorithm → (rates (Fp,)
    float32, rounds)."""
    Fp, width = ids.shape
    Lp = len(caps)
    off, lst = build_lists(ids, Lp)
    cap_left = caps.astype(np.float32).copy()
    fcap = fcaps.astype(np.float32)
    active = (ids < Lp - 1).any(1)
    rates = np.zeros(Fp, np.float32)
    share = np.empty(Lp, np.float32)
    rounds = 0
    while active.any() and rounds < Fp + Lp + 2:
        fs = np.full(Fp, F32_INF)
        for link in range(Lp):
            flows = lst[off[link]:off[link + 1]]
            n = int(active[flows].sum())
            share[link] = cap_left[link] / np.float32(n) if n else F32_INF
            on = flows[active[flows]]
            fs[on] = np.minimum(fs[on], abs(share[link]))
        best = fs.min()
        capped = active & (fcap < best)
        any_capped = bool(capped.any())
        no_links = bool(np.isinf(best))
        by_cap = any_capped or no_links
        if any_capped:
            mask = capped
        elif no_links:
            mask = active.copy()
        else:
            mask = active & (fs <= best)
        rates[mask] = fcap[mask] if by_cap else best
        active = active & ~mask
        for link in range(Lp):
            flows = lst[off[link]:off[link + 1]]
            if by_cap and len(flows) <= SHORT_LIST:   # its thread, in order
                used = 0.0
                for f in flows[mask[flows]]:
                    used += np.float64(fcap[f])
            elif by_cap:                               # its warp
                lane_sums = np.zeros(32)
                for i, f in enumerate(flows):
                    if mask[f]:
                        lane_sums[i % 32] += np.float64(fcap[f])
                used = xor_fold(lane_sums)
            else:
                used = np.float64(best) * int(mask[flows].sum())
            c = max(np.float32(cap_left[link] - np.float32(used)),
                    np.float32(0.0))
            if not by_cap and share[link] <= best:
                c = np.float32(0.0)
            cap_left[link] = c
        rounds += 1
    return rates, rounds


def plain(caps, ids, fcaps):
    """``ops.maxmin_waterfill`` on CPU tensors (the plain version) for one
    padded problem → (rates, rounds)."""
    out = ops.maxmin_waterfill(torch.from_numpy(caps[None]),
                               torch.from_numpy(ids[None]),
                               torch.from_numpy(fcaps[None]))[0].numpy()
    return out[:-1], int(out[-1])


def check_problem(caps, rows, fcaps):
    """Model against plain (1e-6, equal rounds) and, after the loopback
    fix-up, against the float64 oracle; returns the model's rounds."""
    caps_p, ids, fcaps_p = padded(caps, rows, fcaps)
    got, rounds = model_waterfill(caps_p, ids, fcaps_p)
    want, want_rounds = plain(caps_p, ids, fcaps_p)
    np.testing.assert_allclose(got, want, rtol=MODEL_RTOL, atol=0)
    assert rounds == want_rounds
    rates = got[:len(rows)].copy()
    for f, r in enumerate(rows):
        if not r:
            rates[f] = fcaps[f]
    np.testing.assert_allclose(rates, maxmin_ref(caps, dense(rows, len(caps)),
                                                 fcaps),
                               rtol=REF_RTOL, atol=REF_ATOL)
    return rounds


@pytest.mark.parametrize("seed", range(N_PROBLEMS))
def test_model_equals_plain_and_oracle(seed):
    check_problem(*random_problem(seed))


def test_lists_are_stable_in_flow_order():
    """Every link's list holds its flows in increasing order, duplicates
    included, whatever the warp ranges and tiles (Fp 2048: 64 flows a
    warp, 4 rows of width 8 a tile)."""
    rng = np.random.default_rng(7)
    Lp = 16
    ids = np.full((2048, 8), Lp - 1, np.int32)
    for f in range(2000):
        w = int(rng.integers(0, 9))
        ids[f, :w] = rng.integers(0, Lp - 1, w)
    off, lst = build_lists(ids, Lp)
    for link in range(Lp - 1):
        want = [f for f in range(2048) for x in ids[f] if x == link]
        assert lst[off[link]:off[link + 1]].tolist() == want
    assert off[-1] == off[Lp - 1]              # the dummy lists nothing


def test_exact_ties_between_links():
    """Two links with exactly equal shares saturate in the same round."""
    caps = [6e8, 6e8, 9e8]
    rows = [[0], [0], [1], [1], [2]]
    fcaps = [1e12] * 5
    assert check_problem(caps, rows, fcaps) == 2


def test_capped_and_uncapped_flows_in_one_round():
    caps = [1e9, 4e8]
    rows = [[0], [0], [0, 1], [1]]
    fcaps = [1e8, 1e8, 1e12, 1e12]
    check_problem(caps, rows, fcaps)
    rates, _ = model_waterfill(*padded(caps, rows, fcaps))
    assert rates[0] == rates[1] == np.float32(1e8)


def test_loopback_flows():
    caps = [1e9]
    rows = [[0], [], [0], []]
    fcaps = [1e12, 3e8, 1e12, 7e8]
    check_problem(caps, rows, fcaps)
    rates, _ = model_waterfill(*padded(caps, rows, fcaps))
    assert rates[1] == rates[3] == 0.0          # the host fixes them up


def test_zero_capacity_links():
    caps = [0.0, 1e9, 0.0]
    rows = [[0], [1], [1, 2], [1]]
    fcaps = [1e9] * 4
    check_problem(caps, rows, fcaps)
    rates, _ = model_waterfill(*padded(caps, rows, fcaps))
    assert rates[0] == rates[2] == 0.0 and rates[1] == np.float32(5e8)


def test_round_limit_is_never_reached():
    """Each round fixes at least one flow: flows alone on links of distinct
    capacities take one round each, the most a problem can take, well
    inside Fp + Lp + 2."""
    F = 64
    caps = [1e8 * (i + 1) for i in range(F)]
    rows = [[i] for i in range(F)]
    assert check_problem(caps, rows, [1e12] * F) == F


def test_all_padding_beside_a_long_problem_in_a_batch():
    """A batch of the plain version: an all-padding problem takes 0 rounds
    and rate 0 beside one of 64 rounds, each equal to the model alone."""
    F = 64
    long_p = padded([1e8 * (i + 1) for i in range(F)], [[i] for i in range(F)],
                    [1e12] * F)
    Fp, width = long_p[1].shape
    Lp = len(long_p[0])
    empty = (np.full(Lp, np.inf, np.float32),
             np.full((Fp, width), Lp - 1, np.int32), np.zeros(Fp, np.float32))
    out = ops.maxmin_waterfill(*(torch.from_numpy(np.stack([a, b]))
                                 for a, b in zip(empty, long_p))).numpy()
    assert out[0].tolist() == [0.0] * (Fp + 1)
    rates, rounds = model_waterfill(*long_p)
    np.testing.assert_allclose(out[1, :Fp], rates, rtol=MODEL_RTOL, atol=0)
    assert out[1, Fp] == rounds == F
    assert model_waterfill(*empty)[1] == 0


def test_plain_counts_one_solve_per_call_on_the_cpu():
    caps, rows, fcaps = random_problem(5)
    counts = maxmin.COUNTS
    counts.reset()
    maxmin.maxmin_rates_sparse(caps, rows, fcaps, device="cpu")
    _, rounds = model_waterfill(*padded(caps, rows, fcaps))
    assert counts.rounds == rounds and counts.solves == 1
    assert counts.syncs == counts.h2d == counts.d2h == 0


def test_kernel_refuses_cpu_tensors():
    caps, ids, fcaps = padded(*random_problem(6))
    before = maxmin.WATERFILL.launches
    with pytest.raises(ValueError, match="CUDA"):
        maxmin.WATERFILL(*(torch.from_numpy(a[None])
                           for a in (caps, ids, fcaps)))
    assert maxmin.WATERFILL.launches == before


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _edge_cases():
    return [([6e8, 6e8, 9e8], [[0], [0], [1], [1], [2]], [1e12] * 5),
            ([1e9, 4e8], [[0], [0], [0, 1], [1]], [1e8, 1e8, 1e12, 1e12]),
            ([1e9], [[0], [], [0], []], [1e12, 3e8, 1e12, 7e8]),
            ([0.0, 1e9, 0.0], [[0], [1], [1, 2], [1]], [1e9] * 4),
            ([1e8 * (i + 1) for i in range(64)], [[i] for i in range(64)],
             [1e12] * 64)]


@pytest.mark.gpu
@pytest.mark.parametrize("case", range(N_PROBLEMS + 5))
def test_kernel_equals_plain_on_card(card, case):
    problem = random_problem(case) if case < N_PROBLEMS else \
        _edge_cases()[case - N_PROBLEMS]
    arrays = padded(*problem)
    args = [torch.from_numpy(a[None]).to(card) for a in arrays]
    before = maxmin.WATERFILL.launches
    got = ops.maxmin_waterfill(*args).cpu().numpy()[0]
    assert maxmin.WATERFILL.launches == before + 1
    want, rounds = plain(*arrays)
    np.testing.assert_allclose(got[:-1], want, rtol=MODEL_RTOL, atol=0)
    assert got[-1] == rounds
    again = ops.maxmin_waterfill(*args).cpu().numpy()[0]
    assert got.tobytes() == again.tobytes()


@pytest.mark.gpu
def test_batched_kernel_equals_plain_on_card(card):
    problems = [random_problem(s) for s in range(12)] + \
        [([1e9], [[] for _ in range(300)], [1e8] * 300)]
    stats = {}
    counts = maxmin.COUNTS
    counts.reset()
    before = maxmin.WATERFILL.launches
    got = batched_maxmin.maxmin_rates_batch(problems, stats=stats,
                                            device=card)
    assert maxmin.WATERFILL.launches - before == stats["solve_calls"] == \
        counts.batched_calls == counts.h2d == counts.d2h == counts.syncs
    want = batched_maxmin.maxmin_rates_batch(problems, device="cpu")
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=MODEL_RTOL, atol=0)


@pytest.mark.gpu
def test_solve_on_card_is_one_launch_and_one_read(card):
    caps, rows, fcaps = random_problem(8)
    counts = maxmin.COUNTS
    counts.reset()
    before = maxmin.WATERFILL.launches
    maxmin.maxmin_rates_sparse(caps, rows, fcaps, device=card)
    run = dataclasses.replace(counts)
    assert maxmin.WATERFILL.launches == before + 1
    assert (run.h2d, run.d2h, run.syncs) == (1, 1, 1)
    assert run.rounds == model_waterfill(*padded(caps, rows, fcaps))[1]


# buckets whose link state alone exceeds a block's shared memory:
# (flows, links, most links a flow) padded to (Fp 64, Lp 16384, width 4)
# and (Fp 1024, Lp 32768, width 8)
LINK_BUCKETS = {"Fp 64 Lp 16384": (60, 9000, 4),
                "Fp 1024 Lp 32768": (1000, 20000, 8)}


def wide_problem(bucket: str, seed: int = 0):
    """Seeded uniform-random flows over thousands of links: each flow
    crosses 1 to its bucket's width of them."""
    n_flows, n_links, most = LINK_BUCKETS[bucket]
    rng = np.random.default_rng(seed)
    caps = rng.uniform(1e8, 1e10, n_links)
    rows = [[int(x) for x in rng.choice(
        n_links, int(rng.integers(1, most + 1)), replace=False)]
        for _ in range(n_flows)]
    return caps, rows, rng.uniform(1e6, 1e9, n_flows)


@pytest.fixture(scope="module")
def ref_batched():
    pytest.importorskip("jax", reason="the JAX reference is not installed")
    from repro.kernels import batched_maxmin as ref
    return ref


@pytest.mark.parametrize("bucket", list(LINK_BUCKETS))
def test_plain_at_many_links_matches_reference(ref_batched, bucket):
    """The plain version at Lp 16384 and 32768 against the reference's
    batched solver, to ``test_torch_maxmin.py``'s port-vs-JAX tolerance."""
    problems = [wide_problem(bucket, seed) for seed in range(2)]
    stats = {}
    got = batched_maxmin.maxmin_rates_batch(problems, stats=stats,
                                            device="cpu")
    want = ref_batched.maxmin_rates_batch(problems)
    Fp, Lp, width = (int(x) for x in stats["buckets"][0][1:])
    assert (f"Fp {Fp} Lp {Lp}", width) == (bucket, LINK_BUCKETS[bucket][2])
    for g, w in zip(got, want, strict=True):
        np.testing.assert_allclose(g, w, rtol=JAX_RTOL, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("bucket", list(LINK_BUCKETS))
def test_link_state_in_device_memory_equals_plain_on_card(card, bucket):
    """A bucket whose link state alone exceeds a block's shared memory runs
    on the design global_links, its rates and round count equal to the
    plain version's on the card bit for bit; two launches agree."""
    arrays = padded(*wide_problem(bucket))
    Lp = arrays[0].shape[0]
    Fp, width = arrays[1].shape
    assert f"Fp {Fp} Lp {Lp}" == bucket
    assert maxmin.WATERFILL.design(Fp, Lp, width) == "global_links"
    args = [torch.from_numpy(a[None]).to(card) for a in arrays]
    before = dict(maxmin.WATERFILL.launches_by_design)
    got = ops.maxmin_waterfill(*args)
    again = ops.maxmin_waterfill(*args)
    assert maxmin.WATERFILL.launches_by_design["global_links"] == \
        before["global_links"] + 2
    want = maxmin.plain_waterfill(*args)
    assert got.cpu().numpy().tobytes() == want.cpu().numpy().tobytes()
    assert torch.equal(got, again)
    assert int(got[0, -1]) > 1


def large_problem(seed: int, n_flows: int = 14000, n_links: int = 200):
    """A problem of a two-tier sweep's pricing size: 1-8 links a flow."""
    rng = np.random.default_rng(seed)
    caps = rng.uniform(1e8, 1e10, n_links)
    rows = [[int(x) for x in rng.choice(n_links, int(rng.integers(1, 9)),
                                        replace=False)]
            for _ in range(n_flows)]
    return caps, rows, rng.uniform(1e6, 1e9, n_flows)


@pytest.mark.gpu
@pytest.mark.parametrize("seed", range(2))
def test_lists_in_device_memory_equal_plain_on_card(card, seed):
    """A bucket whose lists do not fit shared memory (Fp 16384, Lp 256,
    width 8) runs on the design global, equal to the plain version."""
    arrays = padded(*large_problem(seed))
    assert arrays[1].shape == (16384, 8) and arrays[0].shape == (256,)
    assert maxmin.WATERFILL.design(16384, 256, 8) == "global"
    args = [torch.from_numpy(a[None]).to(card) for a in arrays]
    before = dict(maxmin.WATERFILL.launches_by_design)
    got = ops.maxmin_waterfill(*args).cpu().numpy()[0]
    assert maxmin.WATERFILL.launches_by_design["global"] == \
        before["global"] + 1
    want, rounds = plain(*arrays)
    np.testing.assert_allclose(got[:-1], want, rtol=MODEL_RTOL, atol=0)
    assert got[-1] == rounds
    again = ops.maxmin_waterfill(*args).cpu().numpy()[0]
    assert got.tobytes() == again.tobytes()


# flows of a bucket whose flow state exceeds shared memory: Fp 32768, and
# Fp 131072 (4-byte list entries above 65,536 flows)
LARGE_FLOWS = {"Fp 32768": 20000, "Fp 131072": 70000}


@pytest.mark.gpu
@pytest.mark.parametrize("bucket", list(LARGE_FLOWS))
def test_flow_state_in_device_memory_equals_plain_on_card(card, bucket):
    """A bucket whose flow state alone exceeds a block's shared memory
    runs on the design global_flows, its rates and round count equal to
    the plain version's on the card bit for bit; two launches agree; the
    control (the most-shared saturated link halved) changes the rates and
    still equals the plain version."""
    caps, rows, fcaps = large_problem(0, n_flows=LARGE_FLOWS[bucket])
    arrays = padded(caps, rows, fcaps)
    Fp, width = arrays[1].shape
    assert f"Fp {Fp}" == bucket
    assert maxmin.WATERFILL.design(Fp, arrays[0].shape[0], width) == \
        "global_flows"
    args = [torch.from_numpy(a[None]).to(card) for a in arrays]
    before = dict(maxmin.WATERFILL.launches_by_design)
    got = ops.maxmin_waterfill(*args)
    assert maxmin.WATERFILL.launches_by_design["global_flows"] == \
        before["global_flows"] + 1
    want = maxmin.plain_waterfill(*args)
    assert torch.equal(got, want)
    assert got.cpu().numpy().tobytes() == want.cpu().numpy().tobytes()
    again = ops.maxmin_waterfill(*args)
    assert maxmin.WATERFILL.launches_by_design["global_flows"] == \
        before["global_flows"] + 2
    assert torch.equal(got, again)
    rates = want.cpu().numpy()[0]
    load = np.zeros(len(caps))
    share = np.zeros(len(caps), np.int64)
    for f, row in enumerate(rows):
        load[row] += rates[f]
        share[row] += 1
    saturated = np.flatnonzero(load >= 0.999 * caps)
    assert saturated.size
    ctl_caps = args[0].clone()
    ctl_caps[0, saturated[np.argmax(share[saturated])]] /= 2
    ctl = ops.maxmin_waterfill(ctl_caps, args[1], args[2])
    assert not torch.equal(ctl, got)
    assert torch.equal(ctl, maxmin.plain_waterfill(ctl_caps, *args[1:]))
