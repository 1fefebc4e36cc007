"""The port's host Morton codec and MurmurHash3 (csrc/host_morton.cpp,
bound in utils/host_build) and its bit-loop codecs (ops/morton.
encode_naive / decode_naive) against the JAX package's: the C++ codec
equals the JAX package's np_encode and the port's encode bit for bit on
2^16 random 21-bit coordinates and its decode inverts it; the bit loops
equal the JAX bit loops (their (hi, lo) pairs through np_unpack_pair); the
C++ murmur equals both packages' np_murmur3_x86_32 at every tail length;
and scripts/microbench.py returns its four codecs' rows on the CPU."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from massivevoxelraytracing_tpu.ops import hashing as jhashing
from massivevoxelraytracing_tpu.ops import morton as jmorton
from massivevoxelraytracing_torch.ops import hashing, morton
from massivevoxelraytracing_torch.scripts import microbench

# The tensors here are small: one intra-op thread keeps the test runner's
# parallel workers from oversubscribing the cores.
torch.set_num_threads(1)

N = 1 << 16


@pytest.fixture(scope="module")
def coords():
    rng = np.random.default_rng(12)
    xyz = [rng.integers(0, 1 << 21, N, dtype=np.uint32) for _ in range(3)]
    for a in xyz:  # the extremes of a coordinate
        a[:2] = (0, (1 << 21) - 1)
    return xyz


def test_host_codec_equals_both_packages(coords):
    got = morton.host_encode(*coords)
    assert got.dtype == np.int64
    want = jmorton.np_encode(*coords)
    np.testing.assert_array_equal(got.view(np.uint64), want)
    port = morton.encode(*(torch.from_numpy(a.astype(np.int64)) for a in coords))
    np.testing.assert_array_equal(got, port.numpy())
    np.testing.assert_array_equal(got, morton.np_encode(*coords))


def test_host_decode_inverts_encode(coords):
    back = morton.host_decode(morton.host_encode(*coords))
    for b, a in zip(back, coords):
        np.testing.assert_array_equal(b, a.astype(np.int64))
    for b, a in zip(back, jmorton.np_decode(jmorton.np_encode(*coords))):
        np.testing.assert_array_equal(b, a.astype(np.int64))


def test_host_codec_checks_its_inputs():
    with pytest.raises(ValueError):
        morton.host_encode(np.zeros(3), np.zeros(3), np.zeros(2))
    with pytest.raises(ValueError):
        morton.host_decode(np.zeros((2, 2), np.int64))


def test_bit_loops_equal_jax(coords):
    jx, jy, jz = (jnp.asarray(a) for a in coords)
    hi, lo = jax.jit(jmorton.encode_naive)(jx, jy, jz)
    want = jmorton.np_unpack_pair(np.asarray(hi), np.asarray(lo))
    t = [torch.from_numpy(a.astype(np.int64)) for a in coords]
    got = morton.encode_naive(*t)
    np.testing.assert_array_equal(got.numpy().view(np.uint64), want)
    back_j = jax.jit(jmorton.decode_naive)(hi, lo)
    back = morton.decode_naive(got)
    for b, bj, a in zip(back, back_j, coords):
        np.testing.assert_array_equal(b.numpy(), np.asarray(bj).astype(np.int64))
        np.testing.assert_array_equal(b.numpy(), a.astype(np.int64))


@pytest.mark.parametrize("length", range(9))
def test_host_murmur_equals_both_packages(length):
    rng = np.random.default_rng(length)
    data = bytes(rng.integers(0, 256, length, dtype=np.uint8))
    for seed in (0, 0x9747B28C, 0xFFFFFFFF):
        want = jhashing.np_murmur3_x86_32(data, seed)
        assert hashing.host_murmur3_32(data, seed) == want
        assert hashing.np_murmur3_x86_32(data, seed) == want


def test_microbench_rows_on_the_cpu():
    rows = microbench.run(n=4096, device="cpu")
    assert [r["where"] for r in rows] == ["cpu", "cpu", "host", "host"]
    assert len({r["name"] for r in rows}) == 4
    for r in rows:
        assert r["n"] == 4096 and r["s_per_100m"] > 0
        assert r["s_per_100m"] == pytest.approx(r["s_per_call"] / 4096 * 1e8)
