"""The slice as a whole: the port's build_scene + render_frame against the
JAX package's on a small lattice (meshgen.sphere_lattice(2, 2) at 64^3,
96x64 pixels, the bench camera's framing).

The reference tree is built op by op (jax.disable_jit): its jitted
voxelizer contracts multiply-adds into FMAs and so moves a band of
cell-boundary ties (test_torch_voxelize), which the jitted build is held
to separately. The frame is rendered by the reference as it runs, jitted,
with its megakernel in interpret mode: u8 images must be equal. Depth
gets a wider bound than test_torch_hako_mega's, because the jitted
reference also contracts the ray generation `u * right + v * up + front`
(_gen_rays_band) into FMAs: its ray directions differ from the port's by
up to 2 ulps of their largest component, while the port's equal the
reference's evaluated op by op. Measured: 16 ulps of max(|t|, 1); bound
32. On CPU the traversal runs the plain version: no kernel launch is
counted.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from massivevoxelraytracing_tpu.models import raycast as jraycast
from massivevoxelraytracing_tpu.models import scene as jscene
from massivevoxelraytracing_tpu.ops import camera as jcamera
from massivevoxelraytracing_tpu.ops import hako as jhako
from massivevoxelraytracing_tpu.utils import meshgen
from massivevoxelraytracing_torch.models import raycast, scene
from massivevoxelraytracing_torch.ops import camera, hako, hako_mega

from test_torch_hako_build import assert_matches_jax

# The tensors here are small: one intra-op thread keeps the test runner's
# parallel workers from oversubscribing the cores.
torch.set_num_threads(1)

GRID = 64
W, H = 96, 64
T_FRAME_ULPS = 32


def build_kw():
    return dict(origin=np.zeros(3, np.float32), dps=1.0 / GRID,
                grid_res=GRID, chunk_tris=65536)


@pytest.fixture(scope="module")
def trees():
    tri, cols = meshgen.sphere_lattice(2, 2)
    with jax.disable_jit():
        op_by_op = jscene.build_scene(tri, cols, accel="hako", **build_kw())
    port = scene.build_scene(tri, cols, device="cpu", **build_kw())
    return tri, cols, op_by_op, port


def bench_cameras():
    center = np.zeros(3, np.float32) + 0.5
    kw = dict(eye=center + np.array([0.9, 0.4, 1.4]) * 0.9, target=center,
              fovy_deg=40.0)
    return jcamera.Camera.look_at(**kw), camera.Camera.look_at(**kw)


def test_build_scene_matches_jax_op_by_op(trees):
    _tri, _cols, jt, pt = trees
    assert_matches_jax(jt, pt)
    n = pt.n_voxels
    assert n == jt.n_voxels == jt.build_stats["n_unique"]
    for key in ("color", "emission"):
        np.testing.assert_array_equal(
            getattr(pt, key).numpy().view(np.uint32),
            np.asarray(getattr(jt, key))[:n])
    assert pt.has_emission == jt.has_emission
    assert pt.build_stats.keys() == jt.build_stats.keys()
    # (accel_bytes differs: the reference pads its rows to pow2 buckets)
    for key in ("n_triangles", "n_dumped", "n_unique", "grid_res", "n_nodes"):
        assert pt.build_stats[key] == jt.build_stats[key], key


def test_build_scene_within_tie_band_of_jitted(trees):
    tri, cols, _jt, pt = trees
    jj = jscene.build_scene(tri, cols, accel="hako", **build_kw())
    nj = jj.build_stats["n_unique"]
    assert abs(pt.n_voxels - nj) <= max(2, nj // 66), (pt.n_voxels, nj)
    assert abs(pt.n_nodes - jj.n_nodes) <= max(2, jj.n_nodes // 50)
    diff = np.setxor1d(hako.voxels_from_tree(pt), jhako.voxels_from_tree(jj))
    assert len(diff) <= max(2, nj // 66), len(diff)


@pytest.mark.parametrize("show_color", [False, True])
def test_render_frame_matches_jax(trees, show_color):
    _tri, _cols, jt, pt = trees
    jcam, cam = bench_cameras()
    img_j, depth_j = (np.asarray(x) for x in
                      jraycast.render_frame(jt, jcam, W, H, show_color=show_color))
    hako_mega.reset_counters()
    img, depth = raycast.render_frame(pt, cam, W, H, show_color=show_color,
                                      device="cpu")
    assert hako_mega.LAUNCHES == 0  # CPU tensors: the plain version
    assert hako_mega.unresolved_lanes() == 0
    assert img.dtype == torch.uint8 and tuple(img.shape) == (H, W, 3)
    np.testing.assert_array_equal(img.numpy(), img_j)
    hit = depth_j < 1e37
    np.testing.assert_array_equal(depth.numpy() < 1e37, hit)
    assert 0.2 < hit.mean() < 0.9
    t, t_ref = depth.numpy()[hit], depth_j[hit]
    scale = np.spacing(np.maximum(np.abs(t_ref), 1.0).astype(np.float32))
    assert np.all(np.abs(t - t_ref) <= T_FRAME_ULPS * scale)


def test_camera_matches_jax():
    jcam, cam = bench_cameras()
    for key in ("o", "front", "up", "right"):
        np.testing.assert_array_equal(getattr(cam, key), getattr(jcam, key))
    assert (cam.tan_half_fovy, cam.focus) == (jcam.tan_half_fovy, jcam.focus)
    for got, want in zip(camera.np_frame_rays(cam, W, H),
                         jcamera.np_frame_rays(jcam, W, H)):
        np.testing.assert_array_equal(got, want)


def test_gen_rays_exact_op_by_op():
    """The port's tile-major ray generation equals the reference's
    evaluated op by op; the jitted reference (FMA-contracted) stays within
    2 ulps of each ray's largest component."""
    jcam, cam = bench_cameras()
    jargs = (*(jnp.asarray(v) for v in (jcam.o, jcam.right, jcam.up, jcam.front)),
             jnp.float32(jcam.tan_half_fovy))
    with jax.disable_jit():
        ro_e, rd_e = (np.asarray(x) for x in
                      jraycast._gen_rays_tiled(*jargs, width=W, height=H))
    _ro_j, rd_j = (np.asarray(x) for x in
                   jraycast._gen_rays_tiled(*jargs, width=W, height=H))
    f32 = torch.float32
    ro, rd = raycast._gen_rays_tiled(
        *(torch.as_tensor(v, dtype=f32) for v in (cam.o, cam.right, cam.up, cam.front)),
        torch.tensor(cam.tan_half_fovy, dtype=f32), width=W, height=H)
    np.testing.assert_array_equal(ro.numpy(), ro_e)
    np.testing.assert_array_equal(rd.numpy(), rd_e)
    scale = np.spacing(np.abs(rd_e).max(1, keepdims=True))
    assert np.all(np.abs(rd_j - rd_e) <= 2 * scale)


def test_render_rays_equals_frame_pixels(trees):
    """render_rays on the frame's own rays, in row-major pixel order,
    gives the frame's pixels."""
    _tri, _cols, _jt, pt = trees
    _jcam, cam = bench_cameras()
    f32 = torch.float32
    ro, rd = raycast._gen_rays_tiled(
        *(torch.as_tensor(v, dtype=f32) for v in (cam.o, cam.right, cam.up, cam.front)),
        torch.tensor(cam.tan_half_fovy, dtype=f32), width=W, height=H)
    # lane of each row-major pixel in the padded 128x128-tile stream
    px, py = np.arange(W * H) % W, np.arange(W * H) // W
    tile = raycast.TILE
    lane = ((py // tile) * -(-W // tile) + px // tile) * tile * tile \
        + (py % tile) * tile + px % tile
    np.testing.assert_array_equal(np.argsort(lane, kind="stable"),
                                  raycast.tile_order(W, H))
    img_r, t_r = raycast.render_rays(pt, ro[lane], rd[lane])
    img, depth = raycast.render_frame(pt, cam, W, H, device="cpu")
    np.testing.assert_array_equal(img_r.numpy(), img.numpy().reshape(-1, 3))
    np.testing.assert_array_equal(t_r.numpy(), depth.numpy().reshape(-1))
