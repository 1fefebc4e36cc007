"""The port's HakoTree cache (utils/treecache.py): a cache file that the
JAX package's save_hako wrote loads into the tree ops/hako.from_numpy
makes of that JAX tree, field by field (plain and fat layouts, with color
and emission); the port's own layout round trips bit for bit; the two
packages' cache names never collide; lattice_tree builds once and then
loads."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from massivevoxelraytracing_tpu.ops import hako as jhako
from massivevoxelraytracing_tpu.utils import treecache as jtreecache
from massivevoxelraytracing_torch.ops import hako
from massivevoxelraytracing_torch.utils import meshgen, treecache

from test_torch_hako_build import (assert_trees_equal, jax_tree, jax_tree_dict,
                                   port_tree, random_voxels)

# The tensors here are small: one intra-op thread keeps the test runner's
# parallel workers from oversubscribing the cores.
torch.set_num_threads(1)

# grid, voxels, USE_SNODES_ABOVE in both packages
CASES = {"plain64": (64, 1024, None), "fat512": (512, 4000, 128)}


@pytest.fixture(params=list(CASES))
def layout(request, monkeypatch):
    grid_res, n, snodes_above = CASES[request.param]
    if snodes_above is not None:
        monkeypatch.setattr(jhako, "USE_SNODES_ABOVE", snodes_above)
        monkeypatch.setattr(hako, "USE_SNODES_ABOVE", snodes_above)
    rng = np.random.default_rng(grid_res)
    return grid_res, random_voxels(grid_res, n, rng), rng


def with_attributes(jt, rng):
    n_pad = 2 * jt.n_voxels  # the JAX tables are padded past the count
    color = rng.integers(0, 1 << 32, n_pad, dtype=np.uint64).astype(np.uint32)
    emission = rng.integers(0, 1 << 32, n_pad, dtype=np.uint64).astype(np.uint32)
    return dataclasses.replace(jt, color=jnp.asarray(color),
                               emission=jnp.asarray(emission), has_emission=True)


def test_loads_a_cache_the_jax_package_wrote(layout, tmp_path):
    grid_res, m, rng = layout
    jt = with_attributes(jax_tree(m, grid_res), rng)
    assert (jt.snodes is not None) == (grid_res == 512)
    path = str(tmp_path / "jax_tree.npz")
    jtreecache.save_hako(jt, path)
    got = treecache.load_hako(path, device="cpu")
    want = hako.from_numpy(jax_tree_dict(jt), device="cpu")
    assert got.color is not None and got.emission is not None
    assert got.n_voxels == len(m)
    assert_trees_equal(got, want)


def test_loads_a_jax_cache_without_voxel_count(layout, tmp_path):
    """Early JAX caches carry no n_voxels: the count comes from the rows."""
    grid_res, m, rng = layout
    jt = with_attributes(jax_tree(m, grid_res), rng)
    path = str(tmp_path / "old.npz")
    jtreecache.save_hako(jt, path)
    with np.load(path) as z:
        old = {k: z[k] for k in z.files if k != "n_voxels"}
    np.savez(path, **old)
    got = treecache.load_hako(path, device="cpu")
    assert got.n_voxels == len(m)
    assert_trees_equal(got, hako.from_numpy(jax_tree_dict(jt), device="cpu"))


@pytest.mark.parametrize("attrs", [True, False])
def test_port_layout_round_trip(layout, tmp_path, attrs):
    grid_res, m, rng = layout
    pt = port_tree(m, grid_res)
    if attrs:
        pt = dataclasses.replace(
            pt, color=torch.from_numpy(rng.integers(-2**31, 2**31, len(m), dtype=np.int64)
                                       .astype(np.int32)),
            emission=torch.from_numpy(rng.integers(-2**31, 2**31, len(m), dtype=np.int64)
                                      .astype(np.int32)),
            has_emission=True)
    path = str(tmp_path / "sub" / "tree.npz")
    treecache.save_hako(pt, path)
    assert os.listdir(tmp_path / "sub") == ["tree.npz"]  # no temporary left
    back = treecache.load_hako(path, device="cpu")
    assert_trees_equal(back, pt)
    assert (back.color is None) == (not attrs)


def test_cache_names_never_collide(monkeypatch):
    monkeypatch.delenv("MVRT_SNODES_ABOVE", raising=False)
    for res in (256, 1024, 2048):
        mine = os.path.basename(treecache.cache_path(res))
        theirs = os.path.basename(jtreecache.cache_path(res))
        assert mine != theirs and str(res) in mine
    assert treecache.cache_path(1024).endswith("_1024_fat.npz")
    assert treecache.cache_path(256).endswith("_256_plain.npz")
    assert treecache.cache_path(256, "/x").startswith("/x/")
    assert os.path.dirname(treecache.cache_path(64)) == treecache.DEFAULT_DIR


def test_lattice_tree_builds_once_then_loads(monkeypatch, tmp_path):
    small = meshgen.sphere_lattice(2, 2)
    monkeypatch.setattr(meshgen, "sphere_lattice", lambda *a, **k: small)
    built = treecache.lattice_tree(32, device="cpu", cache_dir=str(tmp_path))
    assert os.path.exists(treecache.cache_path(32, str(tmp_path)))
    assert built.color is not None and built.n_voxels > 0

    def no_build(*a, **k):
        raise AssertionError("the cached tree must be loaded, not rebuilt")

    monkeypatch.setattr(meshgen, "sphere_lattice", no_build)
    loaded = treecache.lattice_tree(32, device="cpu", cache_dir=str(tmp_path))
    assert_trees_equal(loaded, dataclasses.replace(built, build_stats=None))
