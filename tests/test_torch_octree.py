"""SVO/DAG build of the PyTorch port (ops/octree.py), exact against the
JAX package's build_octree: the node arrays (children with embedded masks,
psum, mask, meta) are equal, DAG on and off, because the DAG's node order
is canonical (the same sort keys in the same priority); the node counts
equal the host oracle's (cpu_oracle.build_octree), whose port equals the
JAX oracle; `from_numpy` of a JAX tree equals the port's own build."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from massivevoxelraytracing_tpu.models import cpu_oracle as jcpu_oracle
from massivevoxelraytracing_tpu.ops import morton as jmorton
from massivevoxelraytracing_tpu.ops import octree as joctree
from massivevoxelraytracing_torch.models import cpu_oracle
from massivevoxelraytracing_torch.ops import octree

# The tensors here are small: one intra-op thread keeps the test runner's
# parallel workers from oversubscribing the cores.
torch.set_num_threads(1)

RNG = np.random.default_rng(42)


def random_voxels(grid_res, n, rng=RNG):
    c = rng.integers(0, grid_res, size=(n, 3)).astype(np.uint32)
    return np.unique(jmorton.np_encode(c[:, 0], c[:, 1], c[:, 2]))


def padded_pairs(m_u64):
    """The JAX package's input: Morton pairs padded as its tests pad."""
    n = len(m_u64)
    pad = joctree.bucket(n)
    hi, lo = jmorton.np_pack_pair(m_u64)
    hi = np.concatenate([hi, np.full(pad - n, 0xFFFFFFFF, np.uint32)])
    lo = np.concatenate([lo, np.full(pad - n, 0xFFFFFFFF, np.uint32)])
    return jnp.asarray(hi), jnp.asarray(lo)


def jax_octree(m_u64, grid_res, dag=True, dps=None):
    kw = {}
    if dps is not None:
        lower = np.zeros(3, np.float32)
        kw = dict(lower=lower, upper=lower + np.float32(dps) * grid_res)
    return joctree.build_octree(*padded_pairs(m_u64), len(m_u64), grid_res,
                                dag=dag, **kw)


def port_octree(m_u64, grid_res, dag=True, dps=None):
    kw = {}
    if dps is not None:
        lower = np.zeros(3, np.float32)
        kw = dict(lower=lower, upper=lower + np.float32(dps) * grid_res)
    return octree.build_octree(torch.from_numpy(m_u64.astype(np.int64)),
                               grid_res, dag=dag, **kw)


def jax_octree_dict(tree) -> dict:
    """A JAX VoxelOctree's fields as numpy arrays and python numbers."""
    d = {}
    for f in dataclasses.fields(tree):
        v = getattr(tree, f.name)
        d[f.name] = np.asarray(v) if hasattr(v, "shape") else v
    return d


def assert_nodes_equal(jt, pt):
    """A JAX tree's node arrays (padded) == a port tree's, bit for bit."""
    n = pt.n_nodes
    assert n == jt.n_nodes
    for name in ("children", "psum", "mask", "meta"):
        np.testing.assert_array_equal(
            np.asarray(getattr(jt, name))[:n],
            getattr(pt, name).numpy().view(np.uint32), err_msg=name)


@pytest.mark.parametrize("dag", [True, False])
@pytest.mark.parametrize("grid_res,n", [(2, 3), (8, 40), (32, 600), (128, 4000),
                                        (256, 20000)])
def test_build_equals_jax(grid_res, n, dag):
    m = random_voxels(grid_res, n)
    assert_nodes_equal(jax_octree(m, grid_res, dag), port_octree(m, grid_res, dag))


def test_level_task_counts_equal_jax():
    grid_res = 64
    m = random_voxels(grid_res, 2000)
    hi, lo = padded_pairs(m)
    valid = jnp.arange(hi.shape[0]) < len(m)
    want = np.asarray(joctree.level_task_counts(hi, lo, valid, n_levels=6))
    got = octree.level_task_counts(torch.from_numpy(m.astype(np.int64)), 6)
    assert got == want.tolist()


def test_plane_dedups_like_jax_and_the_oracle():
    # a full plane at constant y: many identical subtrees
    grid_res = 64
    x, z = np.meshgrid(np.arange(grid_res), np.arange(grid_res), indexing="ij")
    m = np.unique(jmorton.np_encode(x.ravel(), np.full(x.size, 5), z.ravel()))
    dag = port_octree(m, grid_res, dag=True)
    naive = port_octree(m, grid_res, dag=False)
    assert dag.n_nodes * 4 < naive.n_nodes, (dag.n_nodes, naive.n_nodes)
    assert_nodes_equal(jax_octree(m, grid_res, dag=True), dag)
    assert_nodes_equal(jax_octree(m, grid_res, dag=False), naive)
    ora = cpu_oracle.build_octree(m.astype(np.int64), grid_res, dag=True)
    assert dag.n_nodes == ora.n_nodes


@pytest.mark.parametrize("dag", [True, False])
@pytest.mark.parametrize("grid_res", [8, 32])
def test_oracle_counts_and_port_oracle(grid_res, dag):
    m = random_voxels(grid_res, grid_res * 6)
    ora = cpu_oracle.embed_masks(
        cpu_oracle.build_octree(m.astype(np.int64), grid_res, dag=dag))
    jora = jcpu_oracle.embed_masks(jcpu_oracle.build_octree(m, grid_res, dag=dag))
    for name in ("children", "psum", "mask"):
        np.testing.assert_array_equal(getattr(ora, name), getattr(jora, name))
    tree = port_octree(m, grid_res, dag=dag)
    assert tree.n_nodes == ora.n_nodes
    # the same multiset of node masks and psum rows, and the same root
    np.testing.assert_array_equal(np.sort(tree.mask.numpy()), np.sort(ora.mask))
    np.testing.assert_array_equal(tree.psum[-1].numpy().view(np.uint32),
                                  ora.psum[-1])


def test_from_numpy_equals_port_build():
    grid_res = 64
    dps = 1.0 / grid_res
    m = random_voxels(grid_res, 3000)
    jt = jax_octree(m, grid_res, dps=dps)
    d = jax_octree_dict(jt)
    d["color"] = np.arange(len(m), dtype=np.uint32) * np.uint32(2654435761)
    d["n_voxels"] = len(m)
    got = octree.from_numpy(d, device="cpu")
    want = port_octree(m, grid_res, dps=dps)
    for name in ("children", "psum", "mask", "meta", "lower", "upper"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert (got.n_nodes, got.grid_res, got.root) == (want.n_nodes, 64, want.root)
    np.testing.assert_array_equal(got.color.numpy().view(np.uint32), d["color"])
    assert got.memory_bytes() == want.memory_bytes() == 68 * want.n_nodes


def test_psums_count_the_voxels():
    grid_res = 16
    m = random_voxels(grid_res, 300)
    tree = port_octree(m, grid_res)
    p = tree.psum[tree.root].numpy()
    assert np.all(np.diff(p) >= 0) and p.max() < len(m)
    assert tree.n_voxels == len(m)
