"""The port's voxelizer (ops/voxelize.py) and scene build front half
against the JAX package, on meshgen.icosphere / bumpy_sphere at 64^3.

Exactness. XLA:CPU contracts multiply-add chains inside a jitted program
into FMAs (the cross products of triangle_contexts and
closest_barycentric, the edge functions), which moves a band of exact
cell-boundary ties. The port rounds every op, like the reference's
expressions read. So:
  * candidates (valid, Morton code, packed attributes) are exact against
    the reference evaluated op by op (jax.disable_jit: no fusion, no FMA);
  * against the jitted reference the unique voxel set stays inside the
    tie band that test_parallel_build allows between differently
    compiled voxelizers (1.5% of voxels);
  * sort + unique is integer code and is exact on the same candidates.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from massivevoxelraytracing_tpu.ops import voxelize as jvox
from massivevoxelraytracing_tpu.utils import meshgen, meshprep
from massivevoxelraytracing_torch.models import scene
from massivevoxelraytracing_torch.ops import morton, voxelize

# The tensors here are small: one intra-op thread keeps the test runner's
# parallel workers from oversubscribing the cores.
torch.set_num_threads(1)

GRID = 64
MESHES = {
    "icosphere": lambda: meshgen.icosphere(3, radius=0.9),
    "bumpy": lambda: meshgen.bumpy_sphere(3, radius=0.9),
}


def mesh_inputs(name):
    tri = MESHES[name]()
    origin, dps = meshgen.fit_grid(tri, GRID)
    col = meshgen.vertex_colors_from_position(tri, *meshgen.mesh_bounds(tri))
    emi = np.zeros_like(col)
    emi[: len(emi) // 5] = 0.5  # duplicate means on both channels
    return tri, col, emi, np.asarray(origin, np.float32), float(dps)


@pytest.fixture(scope="module", params=list(MESHES))
def cands(request):
    tri, col, emi, origin, dps = mesh_inputs(request.param)
    t, c, e = meshprep.split_to_cap(tri, col, emi, origin, dps, GRID, 4)
    jargs = (jnp.asarray(t), jnp.asarray(c), jnp.asarray(e),
             jnp.asarray(origin), dps)
    with jax.disable_jit():
        op_by_op = {k: np.asarray(v) for k, v in
                    jvox.voxelize_dense(*jargs, grid_res=GRID).items()}
    jitted = jvox.voxelize_dense(*jargs, grid_res=GRID)
    port = voxelize.voxelize_dense(
        torch.from_numpy(t), torch.from_numpy(c), torch.from_numpy(e),
        torch.from_numpy(origin), torch.tensor(dps, dtype=torch.float32),
        grid_res=GRID)
    return op_by_op, jitted, port


def test_candidates_exact_op_by_op(cands):
    ref, _jitted, port = cands
    valid = port["valid"].numpy()
    np.testing.assert_array_equal(valid, ref["valid"])
    assert valid.any() and (~valid).any()
    hi, lo = morton.to_pair(port["code"])
    np.testing.assert_array_equal(hi.numpy()[valid], ref["m_hi"][valid])
    np.testing.assert_array_equal(lo.numpy()[valid], ref["m_lo"][valid])
    for key in ("color", "emission"):
        np.testing.assert_array_equal(
            port[key].numpy().view(np.uint32)[valid], ref[key][valid])
    assert int(voxelize.count_voxels(port)) == int(ref["valid"].sum())


def unique_codes(u, n):
    return morton.from_pair(
        torch.from_numpy(np.array(u["m_hi"])[:n].view(np.int32)),
        torch.from_numpy(np.array(u["m_lo"])[:n].view(np.int32))).numpy()


def test_unique_set_within_tie_band_of_jitted(cands):
    _ref, jitted, port = cands
    uj = jvox.sort_and_unique(jitted)
    nj = int(uj["n_unique"])
    up = voxelize.sort_and_unique(port)
    assert abs(up["n_unique"] - nj) <= max(2, nj // 66), (up["n_unique"], nj)
    diff = np.setxor1d(unique_codes(uj, nj), up["code"].numpy())
    assert len(diff) <= max(2, nj // 66), len(diff)


def jax_cands_from_port(port):
    hi, lo = morton.to_pair(port["code"])
    return dict(
        valid=jnp.asarray(port["valid"].numpy()),
        m_hi=jnp.asarray(hi.numpy().astype(np.uint32)),
        m_lo=jnp.asarray(lo.numpy().astype(np.uint32)),
        color=jnp.asarray(port["color"].numpy().view(np.uint32)),
        emission=jnp.asarray(port["emission"].numpy().view(np.uint32)),
    )


def assert_unique_equal(up, uj):
    n = int(uj["n_unique"])
    assert up["n_unique"] == n
    np.testing.assert_array_equal(up["code"].numpy(), unique_codes(uj, n))
    for key in ("color", "emission"):
        np.testing.assert_array_equal(
            up[key].numpy().view(np.uint32), np.asarray(uj[key])[:n])
    assert up["has_emission"] == bool(uj["has_emission"])


def test_sort_and_unique_exact(cands):
    _ref, _jitted, port = cands
    assert_unique_equal(voxelize.sort_and_unique(port),
                        jvox.sort_and_unique(jax_cands_from_port(port)))


def test_grouped_unique_exact(cands):
    """sort_and_unique_sums per group + merge_unique_sums against the
    reference's same two stages, and against the single pass."""
    _ref, _jitted, port = cands
    n = port["code"].shape[0]
    cut = n // 3
    parts_p, parts_j = [], []
    jc = jax_cands_from_port(port)
    for sl in (slice(0, cut), slice(cut, n)):
        parts_p.append(voxelize.sort_and_unique_sums(
            port["code"][sl], port["color"][sl], port["emission"][sl],
            port["valid"][sl])[0])
        out, _n = jvox.sort_and_unique_sums(
            jc["m_hi"][sl], jc["m_lo"][sl], jc["color"][sl],
            jc["emission"][sl], jc["valid"][sl])
        parts_j.append(out)
    merged = voxelize.merge_unique_sums(
        torch.cat([p[0] for p in parts_p]),
        [torch.cat([p[1][i] for p in parts_p]) for i in range(6)],
        torch.cat([p[2] for p in parts_p]))
    cat = [jnp.concatenate([p[i] for p in parts_j]) for i in range(9)]
    assert_unique_equal(merged, jvox.merge_unique_sums(
        cat[0], cat[1], cat[2:8], cat[8]))
    single = voxelize.sort_and_unique(port)
    for key in ("code", "color", "emission"):
        np.testing.assert_array_equal(merged[key].numpy(), single[key].numpy())


def test_packing_matches_jax():
    rng = np.random.default_rng(4)
    rgb = rng.uniform(-0.2, 1.2, (3, 4096)).astype(np.float32)
    rgb[:, :3] = np.nan
    got = voxelize.pack_rgb8(*(torch.from_numpy(c) for c in rgb))
    want = np.asarray(jvox.pack_rgb8(*(jnp.asarray(c) for c in rgb)))
    np.testing.assert_array_equal(got.numpy().view(np.uint32)[3:], want[3:])
    np.testing.assert_array_equal(
        voxelize.rgb8_to_f32(got).numpy(),
        np.asarray(jvox.rgb8_to_f32(jnp.asarray(got.numpy().view(np.uint32)))))


def test_hierarchical_build_equals_single_pass(monkeypatch):
    """Forcing the GROUP_DUMPED path (per-group sums, then one merge)
    builds the same tree as the single sort + unique."""
    tri, col, emi, origin, dps = mesh_inputs("bumpy")
    kw = dict(origin=origin, dps=dps, grid_res=GRID, device="cpu",
              chunk_tris=1024)
    single = scene.build_scene(tri, col, emi, **kw)
    monkeypatch.setattr(scene, "GROUP_DUMPED", 5000)
    grouped = scene.build_scene(tri, col, emi, **kw)
    assert single.build_stats["n_dumped"] > 3 * 5000
    assert grouped.build_stats["n_unique"] == single.build_stats["n_unique"]
    for key in ("bricks", "color", "emission"):
        np.testing.assert_array_equal(
            getattr(grouped, key).numpy(), getattr(single, key).numpy())
    assert grouped.has_emission and single.has_emission
