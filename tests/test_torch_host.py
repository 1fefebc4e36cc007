"""The port's own host code against its plain versions and the JAX
package: the triangle split to the voxelizer's cap (host C++ built without
multiply-add contraction), the procedural meshes, and the PMJ table.

The split equals its plain numpy version array for array: the same
worklist order, every f32 op rounded. Against the JAX package's split
(whose native build contracts multiply-adds on hosts with FMA, so its
longest-edge choice at ties can depend on the host) the port's parts
cover the same voxels (up to the voxelizer's cell-boundary ties, should a
host's build bisect another edge at a tie).
"""

import numpy as np
import pytest
import torch

from massivevoxelraytracing_tpu.ops import sampling as jsampling
from massivevoxelraytracing_tpu.utils import meshgen as jmeshgen
from massivevoxelraytracing_tpu.utils import meshprep as jmeshprep
from massivevoxelraytracing_torch.ops import sampling, voxelize
from massivevoxelraytracing_torch.utils import host_build, meshgen, meshprep

# The tensors here are small: one intra-op thread keeps the test runner's
# parallel workers from oversubscribing the cores.
torch.set_num_threads(1)


def split_cases():
    """(name, tri, col, emi, origin, dps, grid_res, cap)"""
    rng = np.random.default_rng(3)
    lat, lat_col = meshgen.sphere_lattice(2, 2)
    soup = jmeshgen.random_soup(200, seed=11, scale=0.9)
    big = np.array([[[-0.9, -0.9, 0.0], [0.9, -0.85, 0.05],
                     [0.0, 0.9, -0.1]]], np.float32)
    m1 = np.array([-1.0, -1.0, -1.0], np.float32)
    return [
        ("lattice64", lat, lat_col, np.zeros_like(lat), np.zeros(3, np.float32),
         1.0 / 64, 64, 4),
        ("soup128", soup, rng.uniform(0, 1, soup.shape).astype(np.float32),
         rng.uniform(0, 1, soup.shape).astype(np.float32), m1, np.float32(2 / 128),
         128, 4),
        ("big64", big, np.ones_like(big), np.zeros_like(big), m1,
         np.float32(2 / 64), 64, 8),
    ]


CASES = {c[0]: c[1:] for c in split_cases()}


@pytest.mark.parametrize("name", list(CASES))
def test_split_equals_plain_version(name):
    args = CASES[name]
    got = meshprep.split_to_cap(*args)
    want = meshprep.split_to_cap_plain(*args)
    assert len(got[0]) > len(args[0])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    ext = meshprep.bbox_extent_in_voxels(got[0], args[3], args[4], args[5])
    assert ext.max() <= args[6]


def voxel_set(tri, origin, dps, grid_res, cap):
    cands = voxelize.voxelize_dense(
        torch.from_numpy(tri), torch.ones(tri.shape), torch.zeros(tri.shape),
        torch.from_numpy(np.asarray(origin, np.float32)),
        torch.tensor(dps, dtype=torch.float32), grid_res=grid_res, cap=cap)
    return np.unique(cands["code"][cands["valid"]].numpy())


@pytest.mark.parametrize("name", list(CASES))
def test_split_covers_the_jax_packages_voxels(name):
    tri, col, emi, origin, dps, grid_res, cap = CASES[name]
    got = meshprep.split_to_cap(tri, col, emi, origin, dps, grid_res, cap)
    want = jmeshprep.split_to_cap(tri, col, emi, origin, dps, grid_res, cap)
    vg = voxel_set(got[0], origin, dps, grid_res, cap)
    vw = voxel_set(want[0], origin, dps, grid_res, cap)
    assert len(vg) > 0
    # the same triangles give the same voxels; where a host's contracted
    # JAX build bisects another edge at a tie, the parts still cover the
    # same surface and differ only at the voxelizer's cell-boundary ties
    assert len(np.setxor1d(vg, vw)) <= max(2, len(vw) // 200)


def test_host_build_keeps_floats_as_written():
    cmd = host_build.gxx_command("out.so", host_build.sources())
    assert "-ffp-contract=off" in cmd
    assert not any(a.startswith("-march") or a == "-ffast-math" for a in cmd)
    assert [s.rsplit("/", 1)[-1] for s in host_build.sources()] == [
        "host_pmj.cpp", "host_split.cpp"]


@pytest.mark.parametrize("make", [
    lambda m: m.icosphere(2),
    lambda m: m.icosphere(3, radius=0.8, center=(0.1, 0.2, 0.3)),
    lambda m: m.bumpy_sphere(3, radius=0.9),
    lambda m: m.sphere_lattice(2, 2),
    lambda m: m.sphere_lattice(3, 3, seed=5),
    lambda m: m.quad_plane(y=0.5, half=0.4, center=(0.5, 0.0, 0.5)),
    lambda m: m.mesh_bounds(m.icosphere(2, radius=0.3)),
    lambda m: m.fit_grid(m.icosphere(3, radius=0.8), 32),
])
def test_meshgen_equals_reference(make):
    got, want = make(meshgen), make(jmeshgen)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        assert np.asarray(g).dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("shape", [(4, 256), (128, 4096)])
def test_pmj_table_equals_jax(shape):
    got = sampling.make_pmj_table(*shape)
    assert got.shape == shape + (2,) and got.dtype == np.float32
    np.testing.assert_array_equal(got, jsampling.make_pmj_table(*shape))


def test_pmj_table_equals_plain_version():
    np.testing.assert_array_equal(sampling.make_pmj_table(4, 256),
                                  sampling.make_pmj_table_plain(4, 256))
    seq = sampling.make_pmj_table(1, 4096)[0]
    for g in (4, 8, 16, 64):  # first g^2 points stratify a g x g grid
        cells = (seq[:g * g, 0] * g).astype(int) * g + (seq[:g * g, 1] * g).astype(int)
        assert len(np.unique(cells)) == g * g
