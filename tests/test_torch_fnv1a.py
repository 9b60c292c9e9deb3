"""The chunks' FNV-1a-64 digests: the plain version and the
``fnv1a64_chunks`` kernel.

On the CPU, ``ops.fnv1a64_chunks`` (the plain version, the reference's
loop over Python ints) against the reference's ``fnv1a64`` chunk by
chunk, bit for bit, and the federation's device rule for real bytes.
The kernel cannot run here, so its split is modelled step for step
(``model_fnv1a_chunks``): each segment's low-byte table with two start
values a 32-bit register, a group's prefix tables, the walk over the
group tables, each segment's partial from its start byte as an affine
map, the maps composed as the kernel's shuffle trees compose them.  The
model is held to the reference's ``fnv1a64`` bit for bit at segments of
16 and 64 bytes (lengths 0, 1, L - 1, L, L + 1, many segments and a
tail, multi-chunk objects with a short last chunk).

The ``gpu`` tests hold the kernel to the port's host ``fnv1a64`` bit for
bit at lengths 0, 1, 7, 24 MiB ± 1, the kernel's own segment length
L - 1, L and L + 1, on multi-chunk objects (aligned and not) and on a
chunk of many segments, with flipped-byte controls (mid-object, and at a
segment's first and last byte) and each call counted on its design, and
run a checkpoint's store and restore through a federation that digests
on the card, with a corrupted cached chunk that must be caught and
refetched.

JAX is imported through the ``ref`` fixture, so that on the machine with
the card, which has no JAX, the ``gpu`` tests run.
"""
import numpy as np
import pytest
import torch

import repro_torch.core as TC
from repro_torch.core.chunk import DEFAULT_CHUNK_SIZE, fnv1a64
from repro_torch.kernels import fnv1a, ops

MiB = 2 ** 20
OFFSET_BASIS = 0xCBF29CE484222325
PRIME = 0x100000001B3
MASK64 = (1 << 64) - 1
SEG = fnv1a.SEG


@pytest.fixture(scope="module")
def ref():
    pytest.importorskip("jax", reason="the JAX reference is not installed")
    import repro.core
    return repro.core


def _bytes(n: int, seed: int = 0) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, n, np.uint8) \
        .tobytes()


def _tensor(data: bytes, device="cpu") -> torch.Tensor:
    return torch.tensor(np.frombuffer(data, np.uint8).copy(),
                        dtype=torch.uint8, device=device)


def _host(data: bytes, chunk: int):
    return [fnv1a64(data[off:off + chunk])
            for off in range(0, max(len(data), 1), chunk)]


@pytest.mark.parametrize("n,chunk", [(0, 64), (1, 64), (7, 3), (4096, 1000),
                                     (100_003, 4096), (100_003, 200_000)])
def test_plain_equals_reference(ref, n, chunk):
    data = _bytes(n, n)
    got = fnv1a.unsigned(ops.fnv1a64_chunks(_tensor(data), chunk))
    assert got == [ref.fnv1a64(data[off:off + chunk])
                   for off in range(0, max(n, 1), chunk)]
    assert len(got) == fnv1a.num_chunks(n, chunk)
    if n == 0:
        assert got == [OFFSET_BASIS]


def test_real_bytes_need_a_device_and_synthetic_do_not(monkeypatch):
    """``None`` means ``cuda``, resolved when real bytes are digested; a
    synthetic object and a host key never ask for one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TC.chunk_object("/d/f", b"abc")
    with pytest.raises(RuntimeError, match="CUDA"):
        TC.Payload.from_bytes(b"abc")
    meta, payloads = TC.synthetic_object("/s", 10 ** 9)
    assert len(payloads) == meta.num_chunks and payloads[0].verify()
    TC.build_fleet_federation(num_pods=1, hosts_per_pod=2).origins[0] \
        .put_object("/s", 5 * DEFAULT_CHUNK_SIZE)
    assert TC.HashRing(["a", "b"]).owner("/k") in ("a", "b")


def test_verify_catches_a_flipped_byte_on_the_cpu():
    good = TC.Payload.from_bytes(_bytes(5000), device="cpu")
    assert good.digest == fnv1a64(good.data)
    assert good.verify("cpu") and not good.corrupted().verify("cpu")
    empty = TC.Payload.from_bytes(b"", device="cpu")
    assert empty.digest == OFFSET_BASIS and empty.verify("cpu")


def test_unsigned_reads_the_bits():
    t = torch.tensor([-1, 0, 1, -(1 << 63)], dtype=torch.int64)
    assert fnv1a.unsigned(t) == [(1 << 64) - 1, 0, 1, 1 << 63]


# ---------------------------------------------------------------------------
# The kernel's split, modelled (csrc/fnv1a.cu)
# ---------------------------------------------------------------------------
WARP, COMBINE_THREADS = 32, 256


def _chain(data: bytes, h: int) -> int:
    for b in data:
        h = ((h ^ b) * PRIME) & MASK64
    return h


def model_table(seg: bytes) -> np.ndarray:
    """Stage 1 for one segment: the end low byte from each of the 256
    start values, two a 32-bit register (bytes at bits 0 and 16): a
    byte's step is (r ^ (b | b << 16)) & 0x00FF00FF, then × 0xB3."""
    v = np.arange(128, dtype=np.uint32)
    r = v | (v + 128) << 16
    for b in seg:
        r = ((r ^ np.uint32(b | b << 16)) & np.uint32(0x00FF00FF)) \
            * np.uint32(0xB3)
    table = np.empty(256, np.int64)
    table[:128], table[128:] = r & 0xFF, (r >> 16) & 0xFF
    return table


def _compose(later, earlier):
    return ((later[0] * earlier[0]) & MASK64,
            (later[0] * earlier[1] + later[1]) & MASK64)


def model_block_compose(maps):
    """Thread i's map first: a shuffle tree a warp (lane i takes lane
    i + d's at level d), then the warps' maps in order."""
    maps = list(maps)
    warps = []
    for w0 in range(0, len(maps), WARP):
        m = maps[w0:w0 + WARP]
        d = 1
        while d < WARP:
            m = [_compose(m[i + d], m[i]) if i % (2 * d) == 0 and
                 i + d < WARP else m[i] for i in range(WARP)]
            d *= 2
        warps.append(m[0])
    out = warps[0]
    for m in warps[1:]:
        out = _compose(m, out)
    return out


def model_fnv1a_chunks(data: bytes, chunk: int, seg: int,
                       group: int = fnv1a.GROUP):
    """The digests as the kernel takes them, at segments of ``seg``
    bytes and groups of ``group`` segments: (design, digests)."""
    n = len(data)
    chunks = fnv1a.num_chunks(n, chunk)
    if min(n, chunk) <= seg:                   # design "short"
        return "short", [_chain(data[c * chunk:(c + 1) * chunk],
                                OFFSET_BASIS) for c in range(chunks)]
    out = []
    for c in range(chunks):
        cdata = data[c * chunk:(c + 1) * chunk]
        segs = -(-len(cdata) // seg)
        pieces = [cdata[s * seg:(s + 1) * seg] for s in range(segs)]
        groups = -(-segs // group)
        prefix, group_tab = [], []             # stage 1
        for g in range(groups):
            low = np.arange(256)
            for s in range(g * group, min((g + 1) * group, segs)):
                prefix.append(low)
                low = model_table(pieces[s])[low]
            group_tab.append(low)
        low, gstart = OFFSET_BASIS & 0xFF, []  # stage 2
        for g in range(groups):
            gstart.append(low)
            low = int(group_tab[g][low])
        maps = []                              # stage 3
        for g in range(groups):
            lanes = []
            for s in range(g * group, (g + 1) * group):
                if s >= segs:
                    lanes.append((1, 0))
                    continue
                start = int(prefix[s][gstart[g]])
                a = pow(PRIME, len(pieces[s]), 1 << 64)
                lanes.append((a, (_chain(pieces[s], start) - start * a)
                              & MASK64))
            maps.append(model_block_compose(lanes))
        per = -(-groups // COMBINE_THREADS)    # stage 4
        runs = []
        for t in range(COMBINE_THREADS):
            m = (1, 0)
            for g in range(t * per, min((t + 1) * per, groups)):
                m = _compose(maps[g], m)
            runs.append(m)
        a, b = model_block_compose(runs)
        out.append((a * OFFSET_BASIS + b) & MASK64)
    return "split", out


def _model_cases(seg):
    many = 70 * seg + 5
    return {"empty": (0, 10 * seg), "1 B": (1, 10 * seg),
            "L - 1": (seg - 1, 10 * seg), "L": (seg, 10 * seg),
            "L + 1": (seg + 1, 10 * seg),
            "70 segments and a tail": (many, 2 * many),
            "3 chunks of 5 L + 3, a last chunk of 7 B": (3 * (5 * seg + 3)
                                                         + 7, 5 * seg + 3),
            "2 chunks of 70 segments + 9, a last of L + 2": (
                2 * (70 * seg + 9) + seg + 2, 70 * seg + 9),
            "4 chunks of L + 1": (4 * (seg + 1), seg + 1),
            "5 chunks of L, the last L - 3": (5 * seg - 3, seg)}


@pytest.mark.parametrize("seg", [16, 64])
@pytest.mark.parametrize("case", list(_model_cases(16)))
def test_model_split_equals_reference(ref, seg, case):
    n, chunk = _model_cases(seg)[case]
    data = _bytes(n, n + seg)
    design, got = model_fnv1a_chunks(data, chunk, seg)
    assert got == [ref.fnv1a64(data[off:off + chunk])
                   for off in range(0, max(n, 1), chunk)]
    assert design == ("short" if min(n, chunk) <= seg else "split")


def test_model_split_at_small_groups(ref):
    """Groups of 32 segments of 16 bytes over 1,000 segments: 32 groups,
    the last one short, each group's prefix tables and the walk."""
    data = _bytes(16_000 - 3, 7)
    design, got = model_fnv1a_chunks(data, 16_000, 16)
    assert design == "split" and got == [ref.fnv1a64(data)]


def test_design_follows_the_longest_chunk():
    assert fnv1a.design(0, DEFAULT_CHUNK_SIZE) == "short"
    assert fnv1a.design(SEG, DEFAULT_CHUNK_SIZE) == "short"
    assert fnv1a.design(SEG + 1, DEFAULT_CHUNK_SIZE) == "split"
    assert fnv1a.design(10 * SEG, SEG) == "short"
    assert fnv1a.design(10 * SEG, SEG + 1) == "split"


def test_two_values_a_register_follow_the_byte_chain():
    """The packed low-byte step (two start values a register) against
    the low-byte chain l' = ((l ^ b) · 0xB3) mod 256 for every start
    value, byte by byte over 5,000 bytes, and that chain against the low
    byte of the 64-bit FNV-1a from the same start."""
    data = np.frombuffer(_bytes(5000, 3), np.uint8)
    v = np.arange(128, dtype=np.uint32)
    packed = v | (v + 128) << 16
    low = np.arange(256, dtype=np.int64)
    full = [int(x) for x in range(256)]
    for i, b in enumerate(data):
        packed = ((packed ^ np.uint32(int(b) | int(b) << 16))
                  & np.uint32(0x00FF00FF)) * np.uint32(0xB3)
        low = ((low ^ int(b)) * 0xB3) & 0xFF
        assert np.array_equal(packed & 0xFF, low[:128])
        assert np.array_equal((packed >> 16) & 0xFF, low[128:])
        if i < 300:
            full = [((h ^ int(b)) * PRIME) & MASK64 for h in full]
            assert [h & 0xFF for h in full] == low.tolist()


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


# (object bytes, chunk size, offset of the object in its buffer)
KERNEL_CASES = {
    "empty": (0, DEFAULT_CHUNK_SIZE, 0),
    "1 B": (1, DEFAULT_CHUNK_SIZE, 0),
    "7 B unaligned": (7, DEFAULT_CHUNK_SIZE, 3),
    "24 MiB - 1": (DEFAULT_CHUNK_SIZE - 1, DEFAULT_CHUNK_SIZE, 0),
    "24 MiB + 1": (DEFAULT_CHUNK_SIZE + 1, DEFAULT_CHUNK_SIZE, 0),
    "3.5 chunks of 1 MiB": (3 * MiB + MiB // 2, MiB, 0),
    "2 chunks of 1 MiB + 5, unaligned": (2 * MiB + 5, MiB, 9),
    "40 chunks of 4 KiB + 13": (40 * 4096 + 13, 4096, 1),
    "L - 1 B": (SEG - 1, DEFAULT_CHUNK_SIZE, 0),
    "L B": (SEG, DEFAULT_CHUNK_SIZE, 0),
    "L + 1 B": (SEG + 1, DEFAULT_CHUNK_SIZE, 0),
    "5 chunks of L - 1, unaligned": (5 * (SEG - 1), SEG - 1, 1),
    "4 chunks of L, the last L - 3": (4 * SEG - 3, SEG, 0),
    "3 chunks of L + 1 and 5 B": (3 * (SEG + 1) + 5, SEG + 1, 0),
    "1,000 segments + 7, unaligned": (1000 * SEG + 7, DEFAULT_CHUNK_SIZE, 5),
    "2 chunks of 70 segments + 3 and L + 2, unaligned": (
        2 * (70 * SEG + 3) + SEG + 2, 70 * SEG + 3, 11),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(KERNEL_CASES))
def test_kernel_equals_host_fnv1a(card, case):
    n, chunk, offset = KERNEL_CASES[case]
    data = _bytes(n, n)
    buf = _tensor(b"\0" * offset + data, card)[offset:]
    before = fnv1a.KERNEL.launches
    by_design = dict(fnv1a.KERNEL.launches_by_design)
    got = ops.fnv1a64_chunks(buf, chunk)
    assert fnv1a.KERNEL.launches == before + 1
    design = fnv1a.design(n, chunk)
    by_design[design] += 1
    assert fnv1a.KERNEL.launches_by_design == by_design
    assert got.device.type == "cuda" and got.dtype == torch.int64
    want = _host(data, chunk)
    assert fnv1a.unsigned(got) == want
    if n > 1:                               # control: one byte flipped
        flip = n // 2
        bad = buf.clone()
        bad[flip] ^= 0x01
        changed = [i for i, (a, b) in enumerate(zip(
            fnv1a.unsigned(ops.fnv1a64_chunks(bad, chunk)), want)) if a != b]
        assert changed == [flip // chunk]


# (object bytes, chunk size, offset): objects of the split design
EDGE_CASES = {
    "3 chunks of 70 segments + 3, unaligned": (3 * (70 * SEG + 3), 70 * SEG + 3,
                                               7),
    "24 MiB + L + 1": (DEFAULT_CHUNK_SIZE + SEG + 1, DEFAULT_CHUNK_SIZE, 0),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(EDGE_CASES))
def test_kernel_flips_at_segment_edges(card, case):
    """A byte flipped at a segment's first or last byte, in the first
    segment of a group, in the middle of a chunk and in its last
    segment, changes its own chunk's digest alone; the kept digest fails
    ``Payload.verify`` on the card."""
    n, chunk, offset = EDGE_CASES[case]
    data = _bytes(n, n)
    buf = _tensor(b"\0" * offset + data, card)[offset:]
    want = _host(data, chunk)
    assert fnv1a.unsigned(ops.fnv1a64_chunks(buf, chunk)) == want
    assert fnv1a.design(n, chunk) == "split"
    flips = set()
    for c in range(len(want)):
        begin = c * chunk
        end = min(begin + chunk, n)
        last_seg = begin + (end - begin - 1) // SEG * SEG
        for edge in (begin, begin + SEG - 1, begin + SEG,
                     begin + fnv1a.GROUP * SEG, begin + 37 * SEG - 1,
                     last_seg, end - 1):
            if begin <= edge < end:
                flips.add((c, edge))
    for c, flip in sorted(flips):
        bad = buf.clone()
        bad[flip] ^= 0x80
        got = fnv1a.unsigned(ops.fnv1a64_chunks(bad, chunk))
        assert [i for i, (a, b) in enumerate(zip(got, want)) if a != b] \
            == [c], flip
    begin = chunk if len(want) > 1 else 0
    bad = buf.clone()
    bad[begin + SEG] ^= 0x01
    end = min(begin + chunk, n)
    kept = TC.Payload(size=end - begin, data=bad[begin:end].cpu().numpy()
                      .tobytes(), digest=want[begin // chunk])
    assert not kept.verify("cuda")


def _flip_one_cached_chunk(plane, path: str) -> None:
    cache = plane.fed.caches["pod0/cache"]
    key = (path, 0)
    cache._lru[key] = cache._lru[key].corrupted()


@pytest.mark.gpu
def test_checkpoint_round_trip_digests_on_the_card(card):
    """A state of a 30 MB float32 leaf (two chunks) and a bf16 leaf saved
    and restored through a federation that digests on the card: restored
    bit-exact, one digest launch an object on store and on drain and one
    a chunk on restore; a corrupted cached chunk is counted and
    refetched."""
    from repro_torch.train import FederatedCheckpointer
    gen = torch.Generator(device=card).manual_seed(0)
    state = {"big": torch.randn(7_500_000, generator=gen, device=card),
             "small": torch.randn(3, 5, generator=gen, device=card)
             .to(torch.bfloat16)}
    plane = TC.AnalyticPlane(TC.build_fleet_federation(num_pods=1,
                                                       hosts_per_pod=4))
    before = fnv1a.KERNEL.launches
    FederatedCheckpointer("rt", plane, site="pod0", worker=0).save(0, state)
    objects = 3                             # two leaves and the manifest
    assert fnv1a.KERNEL.launches - before == 2 * objects
    before = fnv1a.KERNEL.launches
    tree, res = FederatedCheckpointer("rt", plane, site="pod0",
                                      worker=1).restore(0)
    assert fnv1a.KERNEL.launches - before == res.chunks == 4
    for name, t in state.items():
        assert tree[name].device.type == "cuda"
        assert tree[name].dtype == t.dtype and torch.equal(tree[name], t)
    assert plane.client("pod0", 1).stats.checksum_failures == 0
    path = "/ckpt/rt/step_00000000/big.npy"
    _flip_one_cached_chunk(plane, path)
    tree, res = FederatedCheckpointer("rt", plane, site="pod0",
                                      worker=2).restore(0)
    assert plane.client("pod0", 2).stats.checksum_failures == 1
    assert res.cache_misses == 1 and torch.equal(tree["big"], state["big"])
