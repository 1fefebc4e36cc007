"""The port's sharded frame and path-trace step (parallel/render.py) and its
meshes (parallel/mesh.py) on the CPU, on tests/test_parallel.py's scenes
(icosphere(2) at 16^3 / 64^3, the procedural sky, a 16x512 PMJ table).

  * make_sharded_render over 8 bands equals the port's render_frame bit
    for bit (every lane is traced and shaded by the same ops); against
    the JAX package's make_sharded_render on the same brick tree
    (`bricktree.from_numpy`), the JAX test's own bar: pixel agreement
    above 0.999, depth within 1e-5 on common hits.
  * make_sharded_pt_step over make_mesh(8) (dp 2 x sp 4) against one
    pt_sample over the same (pixel, sample) lanes, rtol / atol 2e-5 (the
    JAX test's bar: the psum adds in another order than one device's sum),
    on the octree and the HakoTree; with 4 samples an entry, against
    PathTracer.step's 16-spp accumulator (the step draws the same lane for
    the same pixel and sample index: its tile order and packets are
    permutations). test_torch_parallel_jax.py holds the octree case
    against the JAX package's make_sharded_pt_step.
  * make_mesh's (dp, sp) equal the JAX package's for 1, 2, 4 and 8
    devices; a CUDA mesh raises without a card.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from massivevoxelraytracing_tpu.models import accel as jaccel
from massivevoxelraytracing_tpu.models import scene as jscene
from massivevoxelraytracing_tpu.ops import camera as jcamera
from massivevoxelraytracing_tpu.ops import sampling as jsampling
from massivevoxelraytracing_tpu.parallel import mesh as jmesh
from massivevoxelraytracing_tpu.parallel import render as jrender
from massivevoxelraytracing_tpu.utils import hdr, meshgen
from massivevoxelraytracing_torch.models import accel, pathtracer, raycast, scene
from massivevoxelraytracing_torch.ops import bricktree, camera, hdri
from massivevoxelraytracing_torch.parallel import mesh as mesh_lib
from massivevoxelraytracing_torch.parallel import render as prender

# The tensors here are small: one intra-op thread keeps the test runner's
# parallel workers from oversubscribing the cores.
torch.set_num_threads(1)

F32 = np.float32


def scene_of(grid_res):
    tri = meshgen.icosphere(2, radius=0.85)
    origin, dps = meshgen.fit_grid(tri, grid_res)
    col = meshgen.vertex_colors_from_position(tri, *meshgen.mesh_bounds(tri))
    extent = float(dps) * grid_res
    center = np.asarray(origin) + extent / 2
    eye = center + np.array([0.8, 0.5, 1.5]) * extent
    return tri, col, dict(origin=origin, dps=dps, grid_res=grid_res), eye, center


def cam_tensors(cam):
    return [torch.from_numpy(np.asarray(v, F32)) for v in (cam.o, cam.right,
                                                           cam.up, cam.front)]


def render_sharded(tree, cam, width, height, n_bands=8):
    kind, depth, meta, root = accel.accel_args(tree)
    m = mesh_lib.make_mesh(n_bands, device="cpu")
    render = prender.make_sharded_render(m, width=width, height=height,
                                         kind=kind, depth=depth, show_color=True)
    return render(meta, root, tree.lower, tree.upper, raycast._color_table(tree),
                  *cam_tensors(cam), torch.tensor(F32(cam.tan_half_fovy)))


@pytest.mark.parametrize("accel_name", ["hako", "brick"])
def test_sharded_render_equals_render_frame(accel_name):
    tri, col, kw, eye, center = scene_of(64)
    tree = scene.build_scene(tri, col, accel=accel_name, device="cpu", **kw)
    cam = camera.Camera.look_at(eye=eye, target=center)
    img1, t1 = raycast.render_frame(tree, cam, 96, 64, show_color=True,
                                    device="cpu")
    img2, t2 = render_sharded(tree, cam, 96, 64)
    assert torch.equal(img1, img2) and torch.equal(t1, t2)
    assert 0 < int((t2 < 1e37).sum()) < 96 * 64


def test_band_rays_equal_whole_frame_rays():
    """_gen_rays_band at py0 > 0 gives exactly _gen_rays_tiled's rays for
    those rows (live lanes), at a frame of 3 tile rows."""
    cam = camera.Camera.look_at(eye=(0.5, 0.6, 2.0), target=(0.5, 0.5, 0.5))
    args = (*cam_tensors(cam), torch.tensor(F32(cam.tan_half_fovy)))
    w, h = 200, 300
    ro, rd = raycast._gen_rays_tiled(*args, width=w, height=h)
    ntx = -(-w // raycast.TILE)
    per_band = ntx * raycast.TILE * raycast.TILE
    for band in range(3):
        rob, rdb = raycast._gen_rays_band(*args, band * raycast.TILE, width=w,
                                          height=h, band_tile_rows=1)
        sl = slice(band * per_band, (band + 1) * per_band)
        assert torch.equal(rob, ro[sl]) and torch.equal(rdb, rd[sl])


def test_sharded_render_against_jax_on_brick():
    tri, col, kw, eye, center = scene_of(64)
    jt = jscene.build_scene(tri, col, accel="brick", **kw)
    d = {k: (np.asarray(v) if hasattr(v, "shape") else v)
         for k, v in vars(jt).items()}
    pt = bricktree.from_numpy(d, device="cpu")
    kind, depth, meta, root = jaccel.accel_args(jt)
    jm = jax.sharding.Mesh(np.array(jax.devices()[:8]), ("d",))
    jcam = jcamera.Camera.look_at(eye=eye, target=center)
    jfn = jrender.make_sharded_render(jm, width=96, height=64, kind=kind,
                                      depth=depth, show_color=True)
    img1, t1 = (np.asarray(x) for x in jfn(
        meta, root, jt.lower, jt.upper, jt.color, jnp.asarray(jcam.o),
        jnp.asarray(jcam.right), jnp.asarray(jcam.up), jnp.asarray(jcam.front),
        jnp.float32(jcam.tan_half_fovy)))
    img2, t2 = (x.numpy() for x in render_sharded(
        pt, camera.Camera.look_at(eye=eye, target=center), 96, 64))
    assert img2.shape == img1.shape and t2.shape == t1.shape
    assert (img1 == img2).all(axis=-1).mean() > 0.999
    hit1, hit2 = t1 < 1e37, t2 < 1e37
    assert (hit1 == hit2).mean() > 0.999
    both = hit1 & hit2
    np.testing.assert_allclose(t2[both], t1[both], rtol=1e-5, atol=1e-5)


def pt_head(tree, cam, env, pmj):
    kind, depth, meta, root = accel.accel_args(tree)

    def f(v):
        return torch.tensor(F32(v))

    return kind, depth, (
        meta, root, tree.lower, tree.upper, tree.color, tree.emission,
        torch.from_numpy(pmj), env, *cam_tensors(cam), f(cam.tan_half_fovy),
        f(cam.lens_r), f(cam.focus))


def sharded_step(tree, cam, env, pmj, width, height, spd=1, n_devices=8):
    m = mesh_lib.make_mesh(n_devices, device="cpu")
    kind, depth, head = pt_head(tree, cam, env, pmj)
    n = width * height
    step = prender.make_sharded_pt_step(
        m, stack_depth=depth, spp_per_device=spd, width=width, height=height,
        n_pixels=n, has_emission=tree.has_emission, hdri_enabled=True,
        accel_kind=kind)
    return step(*head, torch.zeros((n, 4)), 0).numpy(), m.devices.shape


@pytest.mark.parametrize("accel_name,grid_res", [("octree", 16), ("hako", 64)])
def test_sharded_pt_step_equals_single_pt_sample(accel_name, grid_res):
    tri, col, kw, eye, center = scene_of(grid_res)
    tree = scene.build_scene(tri, col, accel=accel_name, device="cpu", **kw)
    cam = camera.Camera.look_at(eye=eye, target=center)
    env = hdri.load(hdr.procedural_sky(32, 16), scale=1.0, device="cpu")
    pmj = jsampling.make_pmj_table(16, 512)
    width, height = 16, 16
    out, (dp, sp) = sharded_step(tree, cam, env, pmj, width, height)
    assert (dp, sp) == (2, 4)
    n = width * height
    kind, depth, head = pt_head(tree, cam, env, pmj)
    f = lambda v: torch.tensor(F32(v))  # noqa: E731
    single = pathtracer.pt_sample(
        *head, 0, 0, f(1.0 / width), f(1.0 / height), f(width / height),
        f(7.5), width=width, pix_packet=n, n_spp=sp, accel_kind=kind,
        stack_depth=depth, has_emission=tree.has_emission, hdri_enabled=True,
        extra_implicit=True).reshape(sp, n, 3).sum(0).numpy()
    assert np.all(out[:, 3] == sp)
    assert np.isfinite(out).all() and out[:, :3].mean() > 0.01
    np.testing.assert_allclose(out[:, :3], single, rtol=2e-5, atol=2e-5)


def test_sharded_step_equals_path_tracer_step():
    """16 spp as 4 an entry over dp 2 x sp 4 against PathTracer.step's
    16-spp accumulator from zero (the card's phase-8 comparison)."""
    tri, col, kw, eye, center = scene_of(16)
    tree = scene.build_scene(tri, col, accel="octree", device="cpu", **kw)
    cam = camera.Camera.look_at(eye=eye, target=center)
    sky = hdr.procedural_sky(32, 16)
    pmj = jsampling.make_pmj_table(16, 512)
    width, height = 24, 16
    pt = pathtracer.PathTracer(width=width, height=height, device="cpu")
    pt.pmj_table = torch.from_numpy(pmj)
    pt.setup()
    pt.load_hdri(sky, scale=1.0)
    pt.update_scene(tree)
    pt.step(cam)
    out, _ = sharded_step(tree, cam, pt.env, pmj, width, height, spd=4)
    want = pt.accum.numpy()
    np.testing.assert_array_equal(out[:, 3], want[:, 3])
    assert np.all(out[:, 3] == 16)
    np.testing.assert_allclose(out[:, :3], want[:, :3], rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_make_mesh_matches_jax(n):
    m = mesh_lib.make_mesh(n, device="cpu")
    jm = jmesh.make_mesh(n)
    assert m.axis_names == jm.axis_names == ("dp", "sp")
    assert m.devices.shape == jm.devices.shape
    assert all(d == torch.device("cpu") for d in m.flat())


def test_cuda_mesh_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="card"):
        mesh_lib.make_mesh(8)
    with pytest.raises(RuntimeError, match="card"):
        mesh_lib.make_build_mesh(2, device="cuda:0")
    with pytest.raises(ValueError):
        mesh_lib.make_mesh(6, sp=4, device="cpu")


def test_collectives_are_ordered():
    """psum adds in ascending shard order; all_gather concatenates in
    shard order on the first shard's device."""
    parts = [torch.tensor([1e8], dtype=torch.float32),
             torch.tensor([-1e8], dtype=torch.float32),
             torch.tensor([1.0], dtype=torch.float32)]
    assert float(mesh_lib.psum(parts)) == 1.0       # (1e8 - 1e8) + 1
    assert float(mesh_lib.psum(parts[::-1])) == 0.0  # (1 - 1e8) + 1e8
    got = mesh_lib.all_gather([torch.arange(2), torch.arange(2, 5)])
    assert got.tolist() == [0, 1, 2, 3, 4]
