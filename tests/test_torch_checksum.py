"""The port's chunk checksum against the JAX reference, on the CPU.

Every digest must equal the reference's bit for bit.  Inputs are made
with numpy from a seed; JAX runs its Pallas kernel in interpret mode and
its plain oracle.  The ``gpu`` test holds the CUDA kernel against its
plain version on a card.  JAX is imported through the ``jx`` fixture, so
that on the machine with the card, which has no JAX, the ``gpu`` test
runs (``python -m pytest -m gpu tests/test_torch_checksum.py``).
"""
import types

import numpy as np
import pytest
import torch

from repro_torch.kernels import chunk_checksum as cc
from repro_torch.kernels import ops, ref

CASES = [(1024, 256), (5000, 256), (256, 256), (70000, 1024)]  # (n, block)


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax", reason="the JAX reference is not installed")
    import jax.numpy as jnp

    from repro.kernels import chunk_checksum as jax_cc
    from repro.kernels import ref as jax_ref
    return types.SimpleNamespace(jnp=jnp, cc=jax_cc, ref=jax_ref)


def _data(n, dtype, seed=0):
    """uint8 bytes, or int32 over the full range (negative values too)."""
    rng = np.random.default_rng(seed)
    if dtype == "uint8":
        return rng.integers(0, 256, n, dtype=np.uint8)
    return rng.integers(-2 ** 31, 2 ** 31, n, dtype=np.int64) \
        .astype(np.int32)


def _u32(x):
    return np.asarray(x).astype(np.uint32)


@pytest.mark.parametrize("n,block", CASES)
@pytest.mark.parametrize("dtype", ["bytes_as_int32", "uint8", "int32"])
def test_checksum_and_digests_equal_jax(jx, n, block, dtype):
    """``bytes_as_int32`` is the reference's own test data: values 0..255
    in an int32 buffer."""
    if dtype == "bytes_as_int32":
        data = _data(n, "uint8").astype(np.int32)
    else:
        data = _data(n, dtype)
    jdata = jx.jnp.asarray(data.astype(np.int32) if dtype == "uint8"
                           else data)
    total, digests = ref.poly_digest_ref(torch.from_numpy(data), block)
    assert total.dtype == digests.dtype == torch.uint32
    want_total, want_digests = jx.ref.poly_digest_ref(jdata, block)
    assert np.array_equal(digests.numpy(), _u32(want_digests))
    assert np.array_equal(digests.numpy(), _u32(
        jx.cc.block_digests(jdata, block, interpret=True)))
    assert int(total) == int(_u32(want_total))
    assert int(total) == int(_u32(jx.cc.chunk_checksum(jdata, block,
                                                       interpret=True)))
    assert int(ops.chunk_checksum(torch.from_numpy(data), block)) == \
        int(total)
    assert int(cc.combine_digests(digests, block)) == int(total)


def test_negative_int32_read_as_uint32(jx):
    """−1 is 0xFFFFFFFF, as the reference's astype(uint32) reads it."""
    data = np.array([-1, -2 ** 31, 5, -7], np.int32)
    total, digests = ref.poly_digest_ref(torch.from_numpy(data), 256)
    want_total, want_digests = jx.ref.poly_digest_ref(jx.jnp.asarray(data),
                                                      256)
    assert int(total) == int(_u32(want_total))
    assert np.array_equal(digests.numpy(), _u32(want_digests))
    flat = ref.poly_digest_ref(torch.tensor([-1], dtype=torch.int32), 1)[0]
    assert int(flat) == 0xFFFFFFFF


def test_powers_are_exact_mod_2_32():
    got = ref._powers(300, "cpu").tolist()
    assert got == [pow(ref.FNV_PRIME, e, 2 ** 32) for e in range(299, -1, -1)]


def test_detects_single_bitflip():
    data = _data(4096, "uint8")
    flipped = data.copy()
    flipped[1234] ^= 0x01
    d1 = ops.chunk_checksum(torch.from_numpy(data), 256)
    d2 = ops.chunk_checksum(torch.from_numpy(flipped), 256)
    assert int(d1) != int(d2)


def test_block_digests_localise_corruption():
    data = _data(2048, "uint8")
    flipped = data.copy()
    flipped[700] ^= 0xFF
    _, want = ref.poly_digest_ref(torch.from_numpy(data), 256)
    _, got = ref.poly_digest_ref(torch.from_numpy(flipped), 256)
    assert list(np.nonzero(got.numpy() != want.numpy())[0]) == [700 // 256]


def test_param_checksums_equal_jax_digests_of_the_leaf_bytes(jx):
    """Every leaf of the mamba2 smoke model (bf16, with float32 SSM
    leaves), read as its bytes, against the reference's checksum of the
    same bytes."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_lm, param_checksums
    params = init_lm(get_config("mamba2-780m", smoke=True), device="cpu")
    sums = param_checksums(params)
    leaf = params["blocks"][1]["mixer"]["a_log"]
    assert leaf.dtype == torch.float32 and "blocks.1.mixer.a_log" in sums
    assert len(sums) == 2 + 2 * 14
    for path, total in sums.items():
        node = params
        for key in path.split("."):
            node = node[int(key)] if isinstance(node, list) else node[key]
        data = node.reshape(-1).view(torch.uint8).numpy().astype(np.int32)
        want, _ = jx.ref.poly_digest_ref(jx.jnp.asarray(data), 1024)
        assert int(total) == int(_u32(want)), path


# ---------------------------------------------------------------------------
# the list launch's walk, modelled on the CPU
# ---------------------------------------------------------------------------
P32 = 2 ** 32


def _walk(buffers, block, n_warps):
    """What the list kernel computes, unit by unit: warp w takes units
    w, w + G, … of all buffers (G = ``n_warps``); entering a buffer it
    finds it by binary search over the first units and forms the fold
    weight P^(U j) with pow_mod, then steps it by P^(U G) inside the
    buffer; unit j covers blocks n_blocks−1−U·j−r (r < U, those that
    exist), each weighted P^(U j)·P^r; each warp adds one partial sum per
    buffer it touched.  A block's digest is summed per lane vector by
    Horner's rule, as the kernel does.  Returns (totals, digests,
    offsets) as Python ints."""
    rows, offsets, total_units = cc.plan([t.size for t in buffers],
                                         [t.itemsize for t in buffers], block)
    rows, offsets = rows.tolist(), offsets.tolist()
    firsts = [row[2] for row in rows]
    totals, digests = [0] * len(buffers), [None] * offsets[-1]
    for w in range(n_warps):
        b, unit_end, partial, fold = -1, 0, 0, 0
        for u in range(w, total_units, n_warps):
            if u < unit_end:
                fold = fold * step % P32
            else:
                if b >= 0:
                    totals[b] = (totals[b] + partial) % P32
                partial = 0
                lo, hi = b + 1, len(buffers) - 1
                while lo < hi:
                    mid = (lo + hi + 1) // 2
                    lo, hi = (mid, hi) if firsts[mid] <= u else (lo, mid - 1)
                b = lo
                n, first_block, first_unit, _ = rows[b]
                unit_end = firsts[b + 1] if b + 1 < len(buffers) \
                    else total_units
                per_unit = cc.UNIT_BYTES // (block * buffers[b].itemsize)
                step = pow(ref.FNV_PRIME, per_unit * n_warps, P32)
                fold = pow(ref.FNV_PRIME, per_unit * (u - first_unit), P32)
            j = u - first_unit
            n_blocks = -(-n // block)
            data = np.zeros(n_blocks * block, np.uint64)
            data[:n] = buffers[b].astype(np.int64) & 0xFFFFFFFF
            vec = min(block // 32, 16 // buffers[b].itemsize)
            f = fold
            for r in range(per_unit):
                k = n_blocks - 1 - per_unit * j - r
                if k < 0:
                    break
                d = 0
                for start in range(k * block, (k + 1) * block, vec):
                    h = 0                # Horner over the lane's vector
                    for v in data[start:start + vec]:
                        h = (h * ref.FNV_PRIME + int(v)) % P32
                    pos = start - k * block
                    d += h * pow(ref.FNV_PRIME, block - vec - pos, P32)
                d %= P32
                digests[first_block + k] = d
                partial = (partial + d * f) % P32
                f = f * ref.FNV_PRIME % P32
        if b >= 0:
            totals[b] = (totals[b] + partial) % P32
    return totals, digests, offsets


@pytest.mark.parametrize("n_warps", [1, 3, 7, 64])
def test_list_walk_equals_plain_per_buffer(n_warps):
    """Ragged, empty and one-element buffers of both dtypes, block 256:
    every digest and total of the walk equals ``poly_digest_ref`` of its
    buffer, however many warps share the units."""
    sizes = [("uint8", 0), ("uint8", 1), ("int32", 1), ("uint8", 1023),
             ("uint8", 4096 * 3 + 77), ("int32", 0), ("int32", 257),
             ("uint8", 256), ("int32", 1500), ("uint8", 0)]
    buffers = [_data(n, dt, seed=i) for i, (dt, n) in enumerate(sizes)]
    totals, digests, offsets = _walk(buffers, 256, n_warps)
    assert None not in digests
    for i, data in enumerate(buffers):
        want_total, want_digests = ref.poly_digest_ref(
            torch.from_numpy(data), 256)
        assert totals[i] == int(want_total)
        assert digests[offsets[i]:offsets[i + 1]] == \
            [int(d) for d in want_digests]


def test_list_api_equals_jax_per_buffer(jx):
    """The list entry point (one launch on the card, the plain version per
    buffer on the CPU) against the reference's ``block_digests`` and
    ``combine_digests`` of each buffer."""
    sizes = [("uint8", 0), ("uint8", 1), ("int32", 3), ("uint8", 1025),
             ("int32", 700), ("uint8", 5000)]
    buffers = [_data(n, dt, seed=i) for i, (dt, n) in enumerate(sizes)]
    totals = ops.chunk_checksums([torch.from_numpy(a) for a in buffers], 256)
    assert totals.dtype == torch.uint32 and totals.shape == (len(sizes),)
    for i, data in enumerate(buffers):
        jdata = jx.jnp.asarray(data.astype(np.int32))
        want = jx.cc.combine_digests(
            jx.cc.block_digests(jdata, 256, interpret=True), 256) \
            if data.size else 0
        assert int(totals[i]) == int(_u32(want)), i


def test_plan_cuts_units_from_each_buffers_end():
    rows, offsets, units = cc.plan([0, 1, 4096 * 2 + 1, 1025], [1, 1, 1, 4],
                                   1024)
    # blocks: 0, 1, 9 (uint8, 4 a unit), 2 (int32, 1 a unit)
    assert offsets.tolist() == [0, 0, 1, 10, 12]
    assert rows[:, 2].tolist() == [0, 0, 1, 4]
    assert units == 6 and rows[:, 3].tolist() == [0, 0, 0, 1]


def test_kernel_refuses_cpu_and_other_dtypes():
    before = cc.KERNEL.launches
    with pytest.raises(ValueError, match="not a CUDA device"):
        cc.block_digests(torch.zeros(16, dtype=torch.uint8))
    with pytest.raises(TypeError, match="uint8 or int32"):
        ref.poly_digest_ref(torch.zeros(16, dtype=torch.float32))
    assert cc.KERNEL.launches == before


# ---------------------------------------------------------------------------
@pytest.mark.gpu
@pytest.mark.parametrize("n,block", CASES + [(3 * 2 ** 20 + 77, 1024)])
@pytest.mark.parametrize("dtype", ["uint8", "int32"])
def test_kernel_matches_plain_on_card(n, block, dtype):
    """Exact: block digests and total equal the plain version's; a flipped
    byte changes the total and exactly one block digest."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    data = torch.from_numpy(_data(n, dtype)).cuda()
    before = cc.KERNEL.launches
    total, digests = cc.KERNEL(data, block)
    want_total, want_digests = ref.poly_digest_ref(data, block)
    torch.cuda.synchronize()
    assert cc.KERNEL.launches == before + 1
    assert torch.equal(digests.view(torch.int32),
                       want_digests.view(torch.int32))
    assert int(total) == int(want_total)
    offset = n // 3
    flipped = data.clone()
    flipped.view(torch.uint8)[offset] ^= 0x10
    flipped_total, flipped_digests = cc.KERNEL(flipped, block)
    assert int(flipped_total) != int(total)
    differ = (flipped_digests.view(torch.int32) !=
              digests.view(torch.int32)).nonzero().flatten().tolist()
    assert differ == [offset // (block * data.element_size())]


@pytest.mark.gpu
def test_list_launch_matches_plain_on_card():
    """Mixed sizes and dtypes in one launch: every digest and total equals
    the plain version's; float buffers read ``as_bytes`` equal their uint8
    views; a flipped byte changes exactly one buffer's total and one
    digest."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    sizes = [("uint8", 0), ("uint8", 1), ("uint8", 1023), ("uint8", 1025),
             ("uint8", 3 * 2 ** 20 + 77), ("int32", 0), ("int32", 1),
             ("int32", 255), ("int32", 257), ("int32", (3 * 2 ** 20 + 76) // 4)]
    for block in cc.BLOCKS:
        buffers = [torch.from_numpy(_data(n, dt, seed=i)).cuda()
                   for i, (dt, n) in enumerate(sizes)]
        before = cc.KERNEL.launches
        totals, digests, offsets = cc.KERNEL.many(buffers, block)
        torch.cuda.synchronize()
        assert cc.KERNEL.launches == before + 1
        assert len(offsets) == len(buffers) + 1
        for i, data in enumerate(buffers):
            want_total, want_digests = ref.poly_digest_ref(data, block)
            assert int(totals[i]) == int(want_total), i
            assert torch.equal(digests[offsets[i]:offsets[i + 1]]
                               .view(torch.int32),
                               want_digests.view(torch.int32)), i
        floats = [torch.randn(n, device="cuda").to(dtype)
                  for n, dtype in ((0, torch.float32), (7, torch.bfloat16),
                                   (70001, torch.float32))]
        as_bytes = cc.KERNEL.many(floats, block, as_bytes=True)[0]
        viewed = cc.KERNEL.many([t.view(torch.uint8) for t in floats],
                                block)[0]
        assert torch.equal(as_bytes.view(torch.int32),
                           viewed.view(torch.int32))
        target = 4
        offset = buffers[target].numel() // 3
        flipped = list(buffers)
        flipped[target] = buffers[target].clone()
        flipped[target][offset] ^= 0x10
        f_totals, f_digests, _ = cc.KERNEL.many(flipped, block)
        assert (f_totals.view(torch.int32) != totals.view(torch.int32)) \
            .nonzero().flatten().tolist() == [target]
        assert (f_digests.view(torch.int32) != digests.view(torch.int32)) \
            .nonzero().flatten().tolist() == \
            [offsets[target] + offset // block]
