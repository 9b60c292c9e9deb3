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
