"""The analytic path-tracer oracles of tests/test_pathtracer.py, re-run on
the port (models/pathtracer.py) with HakoTrees built by the port, on the
CPU (the traversal's plain version), at that file's tolerances: the white
furnace, a dark environment, emissive voxels, progressive accumulation,
the half-sky floor (a/2), the emissive ceiling (a * Le_eff) and the
opaque ceiling that any-hit shadow rays must see.

The last three read only the 16x16 center of the reference's 64x48
frame. Here they render just that region, as a 32x32 frame whose field of
view has a third of the reference's tangent (the same rays' span), with
as many samples in it as the reference takes (16x16 pixels x its spp). The
plain traversal's cost on the CPU is per round, not per lane, so this cuts
the packets traced from 3 per step to 1. The two ceiling scenes also stop
after 2 bounces: their ceiling is black, so the throughput of every path
is 0 after depth 1 and deeper bounces add exactly 0.
"""

import numpy as np
import torch

from massivevoxelraytracing_torch.models import pathtracer, scene
from massivevoxelraytracing_torch.ops import camera as camera_ops
from massivevoxelraytracing_torch.utils import meshgen

# The tensors here are small: one intra-op thread keeps the test runner's
# parallel workers from oversubscribing the cores.
torch.set_num_threads(1)

W, H = 64, 48


def make_pt(tree, env_img=None, env_scale=1.0, width=W, height=H, **kw):
    pt = pathtracer.PathTracer(width=width, height=height, packet=1024,
                               device="cpu", **kw)
    pt.pmj_table = torch.from_numpy(
        np.random.default_rng(0).random((128, 4096, 2), np.float32)
    )  # a random table is fine here (the PMJ table is tested on its own)
    pt.setup()
    if env_img is not None:
        pt.load_hdri(env_img, scale=env_scale)
    pt.update_scene(tree)
    return pt


def sphere_scene(grid_res=32, emissive=False, albedo=1.0):
    tri = meshgen.icosphere(3, radius=0.8)
    origin, dps = meshgen.fit_grid(tri, grid_res)
    tree = scene.build_scene(
        tri, np.full_like(tri, albedo), np.full_like(tri, 0.4 if emissive else 0.0),
        origin=origin, dps=dps, grid_res=grid_res, device="cpu")
    return tree, origin, dps


def look_cam(origin, dps, grid_res, dist=2.2):
    extent = float(dps) * grid_res
    center = np.asarray(origin) + extent / 2
    return camera_ops.Camera.look_at(
        eye=center + np.array([0.0, 0.3, 1.0]) * extent * dist,
        target=center, fovy_deg=35.0)


def quad(y, lo=0.08, hi=0.92):
    return np.asarray([[[lo, y, lo], [hi, y, lo], [hi, y, hi]],
                       [[lo, y, lo], [hi, y, hi], [lo, y, hi]]], np.float32)


def center_region(tree, env, eye, target, fovy_deg, n_spp, **kw):
    """Mean radiance over the reference frame's 16x16 center pixels at
    n_spp: a 32x32 frame spanning the same rays (module docstring) at
    n_spp / 4, in one step."""
    half = np.degrees(np.arctan(np.tan(np.radians(fovy_deg / 2)) / 3))
    cam = camera_ops.Camera.look_at(eye=np.asarray(eye), target=np.asarray(target),
                                    fovy_deg=2 * half)
    pt = make_pt(tree, env, width=32, height=32, **kw)
    pt.step(cam, n_spp=n_spp // 4)
    acc = pt.accum.numpy()
    return acc[:, :3].sum() / acc[:, 3].sum() / 3.0


def test_white_furnace():
    """An albedo-1 sphere in a uniform unit sky: every pixel converges to
    1 (bounce truncation and noise allowed), no fireflies."""
    tree, origin, dps = sphere_scene(grid_res=32, albedo=1.0)
    pt = make_pt(tree, np.ones((16, 32, 3), np.float32))
    pt.step(look_cam(origin, dps, 32), n_spp=8)
    acc = pt.accum.numpy()
    val = acc[:, :3] / acc[:, 3:4]
    assert abs(val.mean() - 1.0) < 0.08, val.mean()
    assert np.isfinite(val).all() and val.max() < 4.0


def test_dark_env_black_image():
    tree, origin, dps = sphere_scene(grid_res=16)
    pt = make_pt(tree, None)  # no HDRI: a black environment
    pt.step(look_cam(origin, dps, 16), n_spp=2)
    assert np.allclose(pt.accum.numpy()[:, :3], 0.0)


def test_emissive_voxels_light_the_scene():
    tree, origin, dps = sphere_scene(grid_res=16, emissive=True, albedo=0.7)
    assert tree.has_emission
    pt = make_pt(tree, None)
    pt.step(look_cam(origin, dps, 16), n_spp=4)
    acc = pt.accum.numpy()
    val = acc[:, :3] / acc[:, 3:4]
    # primary hits see raw (unscaled) emission 0.4, some indirect on top
    img = val.reshape(H, W, 3)
    assert img[H // 2 - 4: H // 2 + 4, W // 2 - 4: W // 2 + 4].mean() > 0.3
    assert np.isfinite(val).all()


def test_progressive_accumulation_and_resolve():
    tree, origin, dps = sphere_scene(grid_res=16)
    pt = make_pt(tree, np.ones((8, 16, 3), np.float32) * 0.5)
    cam = look_cam(origin, dps, 16)
    pt.step(cam, n_spp=2)
    assert pt.steps == 1 and np.all(pt.accum.numpy()[:, 3] == 2)
    pt.step(cam, n_spp=2)
    assert np.all(pt.accum.numpy()[:, 3] == 4) and pt.spp_done == 4
    img = pt.resolve()
    assert img.shape == (H, W, 3) and img.dtype == np.uint8
    # background pixels = gamma(0.5)
    assert abs(int(img[0, 0, 0]) - int(255 * 0.5 ** (1 / 2.2) + 0.5)) <= 2
    pt.clear_frame_buffer()
    assert pt.steps == 0 and np.all(pt.accum.numpy() == 0)


def test_half_sky_floor_analytic_half_albedo():
    """A lambertian floor (albedo 1, normal +y) under an azimuthal half
    sky receives exactly a/2 at every bounce depth (tests/test_pathtracer.py
    derives it): pins the importance-sampling tables, pdf and NEE."""
    grid_res = 32
    q = quad(0.5)
    tree = scene.build_scene(q, np.ones_like(q), np.zeros_like(q),
                             origin=np.zeros(3, np.float32), dps=1.0 / grid_res,
                             grid_res=grid_res, device="cpu")
    env = np.zeros((16, 32, 3), np.float32)
    env[:, :16] = 1.0
    # the reference: 4 steps of 16 spp
    val = center_region(tree, env, (0.5, 0.92, 0.5), (0.5, 0.5, 0.499), 25.0, 64)
    assert abs(val - 0.5) < 0.02, f"half-sky floor radiance {val} != 0.5"


def two_planes(emissive: bool):
    grid_res = 32
    tri = np.concatenate([quad(16.2 / 32), quad(18.2 / 32)])
    col = np.zeros_like(tri)
    col[:2] = 1.0  # floor: albedo 1; ceiling black
    emi = np.zeros_like(tri)
    if emissive:
        emi[2:] = 0.4
    return scene.build_scene(tri, col, emi, origin=np.zeros(3, np.float32),
                             dps=1.0 / grid_res, grid_res=grid_res, device="cpu")


CEILING_VIEW = ((0.5, 17.6 / 32, 0.5), (0.5, 0.5, 0.4999), 20.0)


def test_emissive_ceiling_analytic_radiance():
    """A black ceiling emitting Le over an albedo-1 floor, black sky: the
    floor reads a * Le_eff (Le_eff = emission_scale * quantized 0.4), which
    pins the 1/(1+n) averaging of the depth-0 implicit and BSDF rays."""
    tree = two_planes(emissive=True)
    assert tree.has_emission
    # the reference: 6 steps of 16 spp
    val = center_region(tree, np.zeros((8, 16, 3), np.float32), *CEILING_VIEW,
                        96, max_bounces=2)
    le_eff = 7.5 * (102 / 255.0)
    assert abs(val / le_eff - 1.0) < 0.05, (val, le_eff)


def test_opaque_ceiling_blocks_sky_anyhit_shadows():
    """An opaque ceiling one voxel row above an albedo-1 floor under a
    unit sky: every NEE shadow ray (any-hit) is blocked, so the floor
    reads ~0; a shadow traversal that missed occluders would leak the
    sky."""
    tree = two_planes(emissive=False)
    # the reference: 2 steps of 16 spp
    val = center_region(tree, np.ones((8, 16, 3), np.float32), *CEILING_VIEW,
                        32, max_bounces=2)
    assert val < 0.02, f"occluded floor leaked {val} of the sky"
