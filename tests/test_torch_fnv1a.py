"""The chunks' FNV-1a-64 digests: the plain version and the
``fnv1a64_chunks`` kernel.

On the CPU, ``ops.fnv1a64_chunks`` (the plain version, the reference's
loop over Python ints) against the reference's ``fnv1a64`` chunk by
chunk, bit for bit, and the federation's device rule for real bytes.
The ``gpu`` tests hold the kernel to the port's host ``fnv1a64`` bit for
bit at lengths 0, 1, 7, 24 MiB ± 1 and on multi-chunk objects (aligned
and not), with a flipped-byte control, and run a checkpoint's store and
restore through a federation that digests on the card, with a corrupted
cached chunk that must be caught and refetched.

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
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(KERNEL_CASES))
def test_kernel_equals_host_fnv1a(card, case):
    n, chunk, offset = KERNEL_CASES[case]
    data = _bytes(n, n)
    buf = _tensor(b"\0" * offset + data, card)[offset:]
    before = fnv1a.KERNEL.launches
    got = ops.fnv1a64_chunks(buf, chunk)
    assert fnv1a.KERNEL.launches == before + 1
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
