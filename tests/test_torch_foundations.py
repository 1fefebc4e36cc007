"""PyTorch port foundations held against the JAX package: u32 bit helpers,
popcount, int64 Morton codes and the size buckets. Inputs come from a
numpy seed; JAX and torch exchange numpy arrays."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from massivevoxelraytracing_tpu.ops import bits as jbits
from massivevoxelraytracing_tpu.ops import morton as jmorton
from massivevoxelraytracing_tpu.ops import octree as joctree
from massivevoxelraytracing_torch.ops import bits, morton, octree

# The tensors here are small: one intra-op thread keeps the test runner's
# parallel workers from oversubscribing the cores.
torch.set_num_threads(1)

RNG = np.random.default_rng(5)
EXTREMES = np.array([0, 1, 2, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE, 0xFFFFFFFF,
                     0x55555555, 0xAAAAAAAA, 0x01010101], np.uint32)


def u32_words(n):
    w = RNG.integers(0, 1 << 32, size=n, dtype=np.uint64).astype(np.uint32)
    return np.concatenate([EXTREMES, w])


def as_i32_tensor(a_u32):
    return torch.from_numpy(np.ascontiguousarray(a_u32).view(np.int32))


def test_popcount32_matches_jax_and_numpy():
    w = u32_words(4096)
    got = bits.popcount32(as_i32_tensor(w)).numpy()
    ref = np.asarray(jbits.popcount32(jnp.asarray(w)))
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(
        got, np.unpackbits(w.view(np.uint8)).reshape(-1, 32).sum(1))


def test_u32_bit_pattern_round_trip():
    w = u32_words(1024)
    t = as_i32_tensor(w)
    widened = bits.u32(t)
    assert widened.dtype == torch.int64
    np.testing.assert_array_equal(widened.numpy(), w.astype(np.int64))
    back = bits.to_i32_bits(widened + (7 << 32))  # high bits are dropped
    np.testing.assert_array_equal(back.numpy().view(np.uint32), w)


def coords_21bit(n):
    top = (1 << 21) - 1
    c = RNG.integers(0, 1 << 21, size=(n, 3)).astype(np.uint32)
    ext = np.array([[0, 0, 0], [top, top, top], [top, 0, 0], [0, top, 0],
                    [0, 0, top], [1 << 20, 1 << 11, 1 << 10],
                    [(1 << 11) - 1, 1 << 11, top]], np.uint32)
    return np.concatenate([ext, c])


def test_morton_encode_matches_jax_bit_for_bit():
    c = coords_21bit(4096)
    code = morton.encode(*(torch.from_numpy(c[:, a].astype(np.int64))
                           for a in range(3)))
    hi, lo = jmorton.encode(*(jnp.asarray(c[:, a]) for a in range(3)))
    p_hi, p_lo = morton.to_pair(code)
    np.testing.assert_array_equal(p_hi.numpy(), np.asarray(hi).astype(np.int64))
    np.testing.assert_array_equal(p_lo.numpy(), np.asarray(lo).astype(np.int64))
    np.testing.assert_array_equal(
        code.numpy().astype(np.uint64), jmorton.np_encode(c[:, 0], c[:, 1], c[:, 2]))
    assert int(code.max()) == (1 << 63) - 1  # the all-ones extreme


def test_morton_decode_and_pair_round_trip():
    c = coords_21bit(4096)
    code = torch.from_numpy(
        jmorton.np_encode(c[:, 0], c[:, 1], c[:, 2]).astype(np.int64))
    for a, got in enumerate(morton.decode(code)):
        np.testing.assert_array_equal(got.numpy(), c[:, a].astype(np.int64))
    hi, lo = jmorton.np_pack_pair(code.numpy().astype(np.uint64))
    back = morton.from_pair(torch.from_numpy(hi.view(np.int32)),
                            torch.from_numpy(lo.view(np.int32)))
    np.testing.assert_array_equal(back.numpy(), code.numpy())


@pytest.mark.parametrize("floor", [1, 8, 1024])
def test_bucket_matches_jax(floor):
    for n in list(range(0, 70)) + [1000, 1024, 1025, 13_645_209]:
        assert octree.next_pow2(n) == joctree.next_pow2(n)
        assert octree.bucket(n, floor) == joctree.bucket(n, floor)
