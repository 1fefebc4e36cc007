"""Streamed HakoTree build of the PyTorch port (ops/hako_stream.py) and its
terrain generator (utils/shellgen.py), at 256^3, cube 64, kmax 8 (as
tests/test_hako_stream.py runs the JAX package's):

  * the generator's chunks are sorted, unique, globally ascending and
    counted by its column pass;
  * the streamed build equals the port's monolithic build_hako bit for
    bit, parking rows on the host or on the device;
  * the port's streamed build of the JAX generator's chunks equals the JAX
    package's build_hako_stream bit for bit;
  * the port's generator against the JAX generator: the column tops
    (f32 sin / cos, then floor) differ only in a tie band -- at most 8 of
    the 65,536 columns (1 measured), the voxel sets by at most 0.01% (1
    voxel of 228,794 measured);
  * chunk order, brick alignment and the int32 rank range are checked and
    raise."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from massivevoxelraytracing_tpu.ops import hako_stream as jhako_stream
from massivevoxelraytracing_tpu.utils import shellgen as jshellgen
from massivevoxelraytracing_torch.ops import hako, hako_stream, morton
from massivevoxelraytracing_torch.utils import shellgen
from test_torch_hako_build import assert_trees_equal

torch.set_num_threads(1)

RES, CUBE = 256, 64
COLUMN_BAND = 8      # column tops that may differ from the JAX generator's
VOXEL_BAND = 1e-4    # share of the voxel set that may differ


def wrap(codes):
    """Bare code tensors as the builder's (codes,) chunks."""
    return ((c,) for c in codes)


@pytest.fixture(scope="module")
def terrain():
    return shellgen.Terrain(RES, CUBE, kmax=8, device="cpu")


@pytest.fixture(scope="module")
def chunks(terrain):
    return [c[0] for c in terrain.chunks()]


@pytest.fixture(scope="module")
def jax_chunks():
    t = jshellgen.Terrain(RES, CUBE, kmax=8)
    return t, [(np.asarray(hi[: int(n)]), np.asarray(lo[: int(n)]))
               for hi, lo, n in t.chunks()]


def test_generator_sorted_unique_and_counted(terrain, chunks):
    for c in chunks:
        assert c.dtype == torch.int64 and c.shape[0] > 0
        assert bool((c[1:] > c[:-1]).all()), "chunk not strictly sorted"
    m = torch.cat(chunks)
    assert bool((m[1:] > m[:-1]).all()), "chunks overlap or are out of order"
    assert m.shape[0] == terrain.total_voxels()
    # the column fill reaches every (x, y)
    x, y, _ = morton.decode(m)
    assert torch.unique(x * RES + y).shape[0] == RES * RES


@pytest.mark.parametrize("park", ["host", "device"])
def test_stream_build_equals_monolithic(chunks, park):
    got = hako_stream.build_hako_stream(wrap(chunks), RES, park=park)
    want = hako.build_hako(torch.cat(chunks), RES, device="cpu")
    assert_trees_equal(got, want)
    assert got.n_voxels == sum(c.shape[0] for c in chunks)


def test_fat_stream_equals_monolithic(chunks, monkeypatch):
    # the supernode layout (the 16384^3 shell's) on the same stream
    monkeypatch.setattr(hako, "USE_SNODES_ABOVE", 128)
    got = hako_stream.build_hako_stream(wrap(chunks), RES)
    want = hako.build_hako(torch.cat(chunks), RES, device="cpu")
    assert got.snodes is not None
    assert_trees_equal(got, want)


def test_port_stream_of_jax_chunks_equals_jax_stream(jax_chunks):
    jt, parts = jax_chunks
    want = jhako_stream.build_hako_stream(jt.chunks(), RES)
    got = hako_stream.build_hako_stream(
        ((morton.from_pair(torch.from_numpy(hi.copy()), torch.from_numpy(lo.copy())),)
         for hi, lo in parts), RES)
    nb = got.n_bricks
    assert (nb, got.n_voxels, got.n_per_level, got.T, got.res) == (
        want.n_bricks, want.n_voxels, want.n_per_level, want.T, want.res)
    assert (got.root_mask_lo, got.root_mask_hi) == (want.root_mask_lo,
                                                     want.root_mask_hi)
    np.testing.assert_array_equal(np.asarray(want.bricks)[:nb],
                                  got.bricks.numpy().view(np.uint32))
    for a, b, n in zip(want.levels, got.levels, got.n_per_level):
        np.testing.assert_array_equal(hako._decode_level(np.asarray(a), n),
                                      b.numpy().view(np.uint32))


def test_generator_tie_band_against_jax(terrain, chunks, jax_chunks):
    jt, parts = jax_chunks
    runs = jax.jit(lambda x, y: jt._runs(x, y))
    off = 0
    for cx in range(RES // CUBE):
        for cy in range(RES // CUBE):
            ar = jnp.arange(CUBE, dtype=jnp.int32)
            jz = np.asarray(runs((cx * CUBE + ar)[:, None].astype(jnp.float32),
                                 (cy * CUBE + ar)[None, :].astype(jnp.float32))[1])
            pz = terrain._runs(*terrain._columns(cx, cy))[1].numpy()
            off += int((jz != pz).sum())
    assert off <= COLUMN_BAND, f"{off} column tops differ"
    want = np.concatenate([(hi.astype(np.int64) << 32) | lo for hi, lo in parts])
    got = torch.cat(chunks).numpy()
    n_diff = len(np.setxor1d(want, got))
    assert n_diff <= VOXEL_BAND * len(want), f"{n_diff} voxels differ"
    assert abs(jt.total_voxels() - terrain.total_voxels()) <= n_diff


def test_color_stream_is_the_global_sort():
    t = shellgen.Terrain(RES, CUBE, kmax=8, color=True, device="cpu")
    parts = list(t.chunks())
    m = torch.cat([p[0] for p in parts])
    c = torch.cat([p[1] for p in parts])
    assert c.dtype == torch.int32 and c.shape == m.shape
    tree = hako_stream.build_hako_stream(iter(parts), RES)
    assert torch.equal(tree.color, c)
    assert torch.unique(c).shape[0] > 3  # terrain bands, not a constant
    # the uncolored terrain gives the same voxels
    assert torch.equal(m, torch.cat([p[0] for p in shellgen.Terrain(
        RES, CUBE, kmax=8, device="cpu").chunks()]))


def test_misaligned_or_reordered_chunks_raise(chunks):
    whole = torch.cat(chunks[:2])
    cut = int(chunks[0].shape[0]) - 1   # splits the last brick of chunk 0
    for park in ("host", "device"):
        with pytest.raises(ValueError, match="overlap or reorder"):
            hako_stream.build_hako_stream(wrap([whole[:cut], whole[cut:]]), RES,
                                          park=park)
        with pytest.raises(ValueError, match="overlap or reorder"):
            hako_stream.build_hako_stream(wrap([chunks[1], chunks[0]]), RES,
                                          park=park)


def test_rank_overflow_raises(chunks, monkeypatch):
    monkeypatch.setattr(hako_stream, "MAX_VOXELS", int(chunks[0].shape[0]) + 10)
    with pytest.raises(OverflowError):
        hako_stream.build_hako_stream(wrap(chunks[:2]), RES)
