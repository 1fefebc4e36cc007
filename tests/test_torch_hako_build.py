"""HakoTree build of the PyTorch port, exact against the JAX package's
build_hako: brick rows, supernode rows, per-level masks and bases, root
masks, plain and fat layouts; `from_numpy` on a JAX tree (every TPU
level-table form) equals the port's own build; voxels_from_tree round
trips. Also the helpers the traversal tests share."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from massivevoxelraytracing_tpu.ops import hako as jhako
from massivevoxelraytracing_tpu.ops import morton as jmorton
from massivevoxelraytracing_tpu.ops import octree as joctree
from massivevoxelraytracing_torch.ops import hako

# The tensors here are small: one intra-op thread keeps the test runner's
# parallel workers from oversubscribing the cores.
torch.set_num_threads(1)

RNG = np.random.default_rng(17)


def random_voxels(grid_res, n, rng=RNG):
    c = rng.integers(0, grid_res, size=(n, 3)).astype(np.uint32)
    return np.unique(jmorton.np_encode(c[:, 0], c[:, 1], c[:, 2]))


def jax_tree(m_u64, grid_res):
    """The JAX package's build (Morton pairs padded as its tests pad)."""
    n = len(m_u64)
    pad = joctree.bucket(n)
    hi, lo = jmorton.np_pack_pair(m_u64)
    hi = np.concatenate([hi, np.full(pad - n, 0xFFFFFFFF, np.uint32)])
    lo = np.concatenate([lo, np.full(pad - n, 0xFFFFFFFF, np.uint32)])
    return jhako.build_hako(
        jnp.asarray(hi), jnp.asarray(lo), n, grid_res,
        lower=np.zeros(3, np.float32), dps=1.0 / grid_res,
    )


def port_tree(m_u64, grid_res):
    return hako.build_hako(
        torch.from_numpy(m_u64.astype(np.int64)), grid_res, device="cpu",
        lower=np.zeros(3, np.float32), dps=1.0 / grid_res,
    )


def jax_tree_dict(tree) -> dict:
    """A JAX HakoTree's fields as numpy arrays and python numbers."""
    d = {}
    for f in dataclasses.fields(tree):
        v = getattr(tree, f.name)
        if f.name == "levels":
            v = tuple(np.asarray(t) for t in v)
        elif hasattr(v, "shape"):
            v = np.asarray(v)
        d[f.name] = v
    return d


def u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def assert_trees_equal(a, b):
    """Two port HakoTrees, every field."""
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if f.name == "levels":
            assert len(va) == len(vb)
            for x, y in zip(va, vb):
                np.testing.assert_array_equal(x.numpy(), y.numpy())
        elif isinstance(va, torch.Tensor) or isinstance(vb, torch.Tensor):
            np.testing.assert_array_equal(va.numpy(), vb.numpy(), err_msg=f.name)
        elif f.name != "build_stats":
            assert va == vb, (f.name, va, vb)


def assert_matches_jax(jt, pt):
    assert (pt.T, pt.res, pt.grid_res, pt.n_bricks, pt.n_snodes) == (
        jt.T, jt.res, jt.grid_res, jt.n_bricks, jt.n_snodes)
    assert (pt.root_mask_lo, pt.root_mask_hi) == (jt.root_mask_lo, jt.root_mask_hi)
    assert pt.n_per_level == jt.n_per_level and pt.n_nodes == jt.n_nodes
    np.testing.assert_array_equal(u32(pt.bricks), np.asarray(jt.bricks)[: jt.n_bricks])
    np.testing.assert_array_equal(np.asarray(jt.bricks)[jt.n_bricks:], 0)
    if jt.snodes is None:
        assert pt.snodes is None
    else:
        np.testing.assert_array_equal(
            u32(pt.snodes), np.asarray(jt.snodes)[: jt.n_snodes])
    for tab_j, tab_p, n in zip(jt.levels, pt.levels, jt.n_per_level):
        np.testing.assert_array_equal(
            u32(tab_p), hako._decode_level(np.asarray(tab_j), n))
    np.testing.assert_array_equal(pt.lower.numpy(), np.asarray(jt.lower))
    np.testing.assert_array_equal(pt.upper.numpy(), np.asarray(jt.upper))


# grid, voxels, USE_SNODES_ABOVE in both packages
CASES = {
    "64": (64, 64 * 16, None),
    "256": (256, 256 * 16, None),
    "fat512": (512, 8000, 128),          # fat, T = 1: the 1024^3 shape
    "plain1024": (1024, 24000, 1024),    # T = 3: byte-split + smem levels
}


@pytest.fixture(scope="module", params=list(CASES))
def built(request):
    grid_res, n, snodes_above = CASES[request.param]
    m = random_voxels(grid_res, n, np.random.default_rng(grid_res))
    mp = pytest.MonkeyPatch()
    if snodes_above is not None:
        mp.setattr(jhako, "USE_SNODES_ABOVE", snodes_above)
        mp.setattr(hako, "USE_SNODES_ABOVE", snodes_above)
    try:
        yield m, jax_tree(m, grid_res), port_tree(m, grid_res)
    finally:
        mp.undo()


def test_build_matches_jax(built):
    m, jt, pt = built
    assert pt.n_voxels == jt.n_voxels == len(m)
    assert_matches_jax(jt, pt)


def test_from_numpy_equals_port_build(built):
    _m, jt, pt = built
    d = jax_tree_dict(jt)
    # attributes ride along (trees without them render black albedo)
    color = RNG.integers(0, 1 << 32, size=joctree.bucket(len(_m)),
                         dtype=np.uint64).astype(np.uint32)
    d["color"] = color
    d["emission"] = color[::-1].copy()
    d["has_emission"] = True
    got = hako.from_numpy(d, device="cpu")
    want = dataclasses.replace(
        pt,
        color=torch.from_numpy(color[: pt.n_voxels].view(np.int32)),
        emission=torch.from_numpy(color[::-1][: pt.n_voxels].copy().view(np.int32)),
        has_emission=True,
    )
    assert_trees_equal(got, want)


def test_voxels_from_tree_round_trip(built):
    m, _jt, pt = built
    np.testing.assert_array_equal(hako.voxels_from_tree(pt), m)


@pytest.mark.parametrize("n", [1, 37, 64, 200, 2048, 3000])
def test_decode_every_level_table_form(n):
    ml = RNG.integers(0, 1 << 32, size=n, dtype=np.uint64).astype(np.uint32)
    mh = RNG.integers(0, 1 << 32, size=n, dtype=np.uint64).astype(np.uint32)
    base = RNG.integers(0, 1 << 24, size=n).astype(np.uint32)
    want = np.stack([ml, mh, base], 1)
    forms = [jhako._byte_split_table, jhako._flat_table]
    if n <= jhako.SMEM_TABLE_MAX:
        forms.append(jhako._smem_table)
    if n <= jhako.TAA_TABLE_MAX:
        forms.append(jhako._taa_table)
    for make in forms:
        np.testing.assert_array_equal(
            hako._decode_level(make(ml, mh, base), n), want, err_msg=make.__name__)


@pytest.mark.parametrize("grid_res", [16, 64, 256, 512, 1024, 2048, 4096])
def test_layout_helpers_match_jax(grid_res):
    assert hako.use_snodes_for(grid_res) == jhako.use_snodes_for(grid_res)
    assert hako.top_levels_for(grid_res) == jhako.top_levels_for(grid_res)
    assert hako.pad_res(grid_res) == jhako.pad_res(grid_res)
