"""The port's voxrt app on the CPU against the JAX app (tiny torus at
32^3, 48x32, voxel colors, the JAX app on its HakoTree with its
megakernel in interpret mode): voxrt.png decodes equal, u8 exact. The
app's --oracle and --wire run; and the pieces they use equal the JAX
package's on the same inputs: the oracle copy (the numpy voxelization
with attributes; the batched brute-force intersector against the JAX
package's per-ray one, axis-parallel rays included), the wireframe
overlay and camera.shoot."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from massivevoxelraytracing_tpu.models import cpu_oracle as jcpu_oracle
from massivevoxelraytracing_tpu.ops import camera as jcamera
from massivevoxelraytracing_tpu.utils import meshgen as jmeshgen
from massivevoxelraytracing_tpu.utils import wireframe as jwireframe
from massivevoxelraytracing_torch.apps import voxrt
from massivevoxelraytracing_torch.models import cpu_oracle
from massivevoxelraytracing_torch.ops import camera
from massivevoxelraytracing_torch.utils import png, wireframe

# The tensors here are small: one intra-op thread keeps the test runner's
# parallel workers from oversubscribing the cores.
torch.set_num_threads(1)

ARGV = ["--scene", "torus", "--res", "32", "--width", "48", "--height", "32",
        "--mode", "color"]


def test_voxrt_png_equals_jax(tmp_path):
    from massivevoxelraytracing_tpu.apps import voxrt as jvoxrt

    jout, out = str(tmp_path / "jax"), str(tmp_path / "port")
    jvoxrt.main(ARGV + ["--accel", "hako", "--out", jout])
    stats = voxrt.main(ARGV + ["--device", "cpu", "--out", out])
    got = png.read(os.path.join(out, "voxrt.png"))
    want = png.read(os.path.join(jout, "voxrt.png"))
    assert got.shape == (32, 48, 3) and got.max() > got.min()
    np.testing.assert_array_equal(got, want)
    assert stats["n_voxels"] > 0


def test_voxrt_oracle_and_wire(tmp_path, capsys):
    out = str(tmp_path / "o")
    stats = voxrt.main(["--scene", "soup", "--res", "32", "--width", "48",
                        "--height", "32", "--device", "cpu", "--oracle", "--wire",
                        "--out", out])
    assert stats["oracle_checked"] == 48 * 32
    assert stats["oracle_agree"] >= 48 * 32 * 49 // 50
    assert "oracle A/B:" in capsys.readouterr().out
    plain = png.read(os.path.join(out, "voxrt.png"))
    wired = png.read(os.path.join(out, "voxrt_wire.png"))
    assert (wired != plain).any()


def small_mesh():
    tri = jmeshgen.random_soup(24, seed=3, scale=0.7)
    rng = np.random.default_rng(3)
    return (tri, rng.random(tri.shape).astype(np.float32),
            rng.random(tri.shape).astype(np.float32))


@pytest.mark.parametrize("six", [True, False])
def test_oracle_voxelize_equals_jax(six):
    tri, col, emi = small_mesh()
    origin, dps = jmeshgen.fit_grid(tri, 16)
    m, c, e = cpu_oracle.voxelize_mesh(tri, origin, dps, 16, six, col, emi)
    jm, jc, je = jcpu_oracle.voxelize_mesh(tri, origin, dps, 16, six, col, emi)
    assert m.dtype == np.int64 and len(m) > 0
    np.testing.assert_array_equal(m.astype(np.uint64), jm)
    np.testing.assert_array_equal(c, jc)
    np.testing.assert_array_equal(e, je)
    m2, c2, e2 = cpu_oracle.voxelize_mesh(tri, origin, dps, 16, six, col, emi,
                                          attributes=False)
    np.testing.assert_array_equal(m2, m)
    assert c2 is None and e2 is None
    for i in range(0, len(tri), 5):  # the closed form against the loops
        ctx = cpu_oracle.TriContext(*tri[i], six, origin, dps, 16)
        jctx = jcpu_oracle.TriContext(*tri[i], six, origin, dps, 16)
        np.testing.assert_array_equal(ctx.test_grid(), jctx.test_grid())
        grid = {tuple(v) for v in ctx.test_grid().tolist()}
        assert grid == {tuple(v) for v in jctx.voxels_looped().tolist()}


def rays(n, origin, extent, rng):
    ro = (origin + rng.uniform(-0.5, 1.5, (n, 3)) * extent).astype(np.float32)
    rd = rng.normal(size=(n, 3)).astype(np.float32)
    rd[::7, 0] = 0.0   # axis-parallel rays take the rd == 0 slab branch
    rd[::11, 1] = 0.0
    return ro, rd


def test_batched_brute_force_equals_jax():
    tri, col, emi = small_mesh()
    origin, dps = jmeshgen.fit_grid(tri, 16)
    m, _, _ = cpu_oracle.voxelize_mesh(tri, origin, dps, 16, True,
                                       attributes=False)
    rng = np.random.default_rng(9)
    ro, rd = rays(160, origin, 16 * dps, rng)
    t_all, v_all = cpu_oracle.brute_force_rays(
        m, origin, dps, torch.from_numpy(ro), torch.from_numpy(rd), chunk_elems=4096)
    n_hit = 0
    for i in range(len(ro)):
        t, _n_major, v = jcpu_oracle.intersect_brute_force(
            m.astype(np.uint64), origin, dps, ro[i], rd[i])
        assert float(t_all[i]) == t
        if np.isfinite(t):
            n_hit += 1
            assert int(v_all[i]) == v
    assert 0 < n_hit < len(ro)


def frame_cams():
    kw = dict(eye=(1.4, 0.9, 2.2), target=(0.0, 0.1, 0.0), fovy_deg=40.0)
    return camera.Camera.look_at(**kw), jcamera.Camera.look_at(**kw)


def test_shoot_equals_jax():
    cam, jcam = frame_cams()
    rng = np.random.default_rng(5)
    px = rng.integers(0, 64, 500).astype(np.int32)
    py = rng.integers(0, 40, 500).astype(np.int32)
    got = camera.shoot(cam, torch.from_numpy(px), torch.from_numpy(py), 0.5, 0.25,
                       64, 40)
    want = jcamera.shoot(jcam, jnp.asarray(px), jnp.asarray(py), 0.5, 0.25, 64, 40)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_wireframe_equals_jax():
    tri, _, _ = small_mesh()
    origin, dps = jmeshgen.fit_grid(tri, 16)
    m, _, _ = cpu_oracle.voxelize_mesh(tri, origin, dps, 16, True,
                                       attributes=False)
    cam, jcam = frame_cams()
    rng = np.random.default_rng(2)
    img = rng.integers(0, 256, (40, 64, 3), dtype=np.uint8)
    depth = rng.uniform(0.5, 4.0, (40, 64)).astype(np.float32)
    for max_voxels in (4096, 7):
        a, b = img.copy(), img.copy()
        wireframe.draw_voxels_wire(a, depth, cam, m, origin, dps,
                                   max_voxels=max_voxels)
        jwireframe.draw_voxels_wire(b, depth, jcam, m.astype(np.uint64), origin,
                                    dps, max_voxels=max_voxels)
        assert (a != img).any()
        np.testing.assert_array_equal(a, b)
