"""The port's path tracer (models/pathtracer.py) against the JAX package's
pt_sample on a HakoTree (tests/test_parallel.py's configuration: hako at
64^3, a procedural sky, a 16x512 PMJ table), and the helpers the other
path-tracer test files share.

Tolerance. With jax.disable_jit() the reference runs op by op, so XLA
contracts no multiply-add (tests/test_torch_hako_mega.py) and every float
op rounds as the port's: per-lane radiance after one bounce is then equal
bit for bit. The 8-bounce comparison is in test_torch_pathtracer_deep.py,
the port's own invariants in test_torch_pathtracer_lanes.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from massivevoxelraytracing_tpu.models import accel as jaccel
from massivevoxelraytracing_tpu.models import scene as jscene
from massivevoxelraytracing_tpu.models.pathtracer import pt_sample as jpt_sample
from massivevoxelraytracing_tpu.ops import camera as jcamera
from massivevoxelraytracing_tpu.ops import hdri as jhdri
from massivevoxelraytracing_tpu.ops import sampling as jsampling
from massivevoxelraytracing_tpu.utils import hdr, meshgen as jmeshgen
from massivevoxelraytracing_torch.models import accel, pathtracer
from massivevoxelraytracing_torch.ops import camera, hako, hdri

from test_torch_hako_build import jax_tree_dict

# The tensors here are small: one intra-op thread keeps the test runner's
# parallel workers from oversubscribing the cores.
torch.set_num_threads(1)

F32 = np.float32


def parallel_scene(grid_res=64):
    """tests/test_parallel.py's scene: (triangles, colors, origin, dps,
    camera eye, target, sky pixels)."""
    tri = jmeshgen.icosphere(2, radius=0.85)
    origin, dps = jmeshgen.fit_grid(tri, grid_res)
    col = jmeshgen.vertex_colors_from_position(tri, *jmeshgen.mesh_bounds(tri))
    extent = float(dps) * grid_res
    center = np.asarray(origin) + extent / 2
    eye = center + np.array([0.8, 0.5, 1.5]) * extent
    return tri, col, origin, dps, eye, center, hdr.procedural_sky(32, 16)


def port_pt_sample(tree, env, pmj, cam, width, height, n_spp, traversal="mega",
                   **kw):
    """The port's pt_sample over the whole (width x height) frame in one
    packet, on the CPU."""
    kind, depth, meta, root = accel.accel_args(tree, traversal)
    f = lambda v: torch.tensor(F32(v))  # noqa: E731
    return pathtracer.pt_sample(
        meta, root, tree.lower, tree.upper, tree.color, tree.emission,
        torch.from_numpy(pmj), env,
        *[torch.from_numpy(np.asarray(v, F32)) for v in (cam.o, cam.right, cam.up,
                                                         cam.front)],
        f(cam.tan_half_fovy), f(cam.lens_r), f(cam.focus), 0, 0, f(1.0 / width),
        f(1.0 / height), f(width / height), f(7.5), width=width,
        pix_packet=width * height, n_spp=n_spp, accel_kind=kind,
        stack_depth=depth, has_emission=tree.has_emission, hdri_enabled=True,
        extra_implicit=True, **kw).numpy()


def jax_pt_sample(tree, env, pmj, cam, width, height, n_spp, **kw):
    kind, depth, meta, root = jaccel.accel_args(tree)
    return np.asarray(jpt_sample(
        meta, root, tree.lower, tree.upper, tree.color, tree.emission,
        jnp.asarray(pmj), env, jnp.asarray(cam.o), jnp.asarray(cam.right),
        jnp.asarray(cam.up), jnp.asarray(cam.front), jnp.float32(cam.tan_half_fovy),
        jnp.float32(cam.lens_r), jnp.float32(cam.focus), jnp.uint32(0),
        jnp.uint32(0), jnp.float32(1.0 / width), jnp.float32(1.0 / height),
        jnp.float32(width / height), jnp.float32(7.5), width=width,
        pix_packet=width * height, n_spp=n_spp, accel_kind=kind,
        stack_depth=depth, has_emission=tree.has_emission, hdri_enabled=True,
        extra_implicit=True, **kw))


def test_one_bounce_radiance_equals_jax_bit_for_bit():
    """Per-lane radiance of 16x16 pixels x 4 spp after one bounce: the
    thin-lens primary, the primary sky lookup, NEE through the importance
    tables, the BSDF ray and the PMJ / hash streams."""
    tri, col, origin, dps, eye, center, sky = parallel_scene()
    jtree = jscene.build_scene(tri, col, origin=origin, dps=dps, grid_res=64,
                               accel="hako")
    ptree = hako.from_numpy(jax_tree_dict(jtree), device="cpu")
    pmj = jsampling.make_pmj_table(16, 512)
    jcam = jcamera.Camera.look_at(eye=eye, target=center)
    with jax.disable_jit():
        want = jax_pt_sample(jtree, jhdri.load(sky, scale=1.0), pmj, jcam, 16, 16,
                             4, max_bounces=1)
    cam = camera.Camera.look_at(eye=eye, target=center)
    got = port_pt_sample(ptree, hdri.load(sky, scale=1.0, device="cpu"), pmj, cam,
                         16, 16, 4, max_bounces=1)
    assert got.shape == (16 * 16 * 4, 3) and np.isfinite(got).all()
    assert (got > 0).mean() > 0.5
    np.testing.assert_array_equal(got, want)
