"""The port's sharded path-trace step (parallel/render.py) against the JAX
package's make_sharded_pt_step on the same octree (tests/test_parallel.py's
scene at 16^3, `octree.from_numpy`), both over 8 devices (dp 2 x sp 4),
1 spp an entry, 16x16 pixels. The JAX step runs jitted, as its own test
runs it (compiling it takes most of this file's time), so XLA contracts
multiply-adds (a quarter of the lanes differ by ulps,
test_torch_pathtracer_deep) and a lane whose bounce grazes a voxel edge
may take another path: the bar is statistical, the mean within 0.5%
relative and 98% of the pixels within rtol 1e-4; sample counts exact.
(Measured: every pixel within 1.4e-6 relative.)
"""

import numpy as np
import jax.numpy as jnp
import torch

from massivevoxelraytracing_tpu.models import accel as jaccel
from massivevoxelraytracing_tpu.models import scene as jscene
from massivevoxelraytracing_tpu.ops import camera as jcamera
from massivevoxelraytracing_tpu.ops import hdri as jhdri
from massivevoxelraytracing_tpu.ops import sampling as jsampling
from massivevoxelraytracing_tpu.parallel import mesh as jmesh
from massivevoxelraytracing_tpu.parallel import render as jrender
from massivevoxelraytracing_tpu.utils import hdr
from massivevoxelraytracing_torch.ops import camera, hdri, octree

from test_torch_octree import jax_octree_dict
from test_torch_parallel import scene_of, sharded_step

# The tensors here are small: one intra-op thread keeps the test runner's
# parallel workers from oversubscribing the cores.
torch.set_num_threads(1)


def test_sharded_pt_step_against_jax_on_octree():
    tri, col, kw, eye, center = scene_of(16)
    jt = jscene.build_scene(tri, col, accel="octree", **kw)
    pt = octree.from_numpy(jax_octree_dict(jt), device="cpu")
    sky = hdr.procedural_sky(32, 16)
    pmj = jsampling.make_pmj_table(16, 512)
    width, height = 16, 16
    n = width * height
    jm = jmesh.make_mesh(8)
    kind, depth, meta, root = jaccel.accel_args(jt)
    jcam = jcamera.Camera.look_at(eye=eye, target=center)
    jstep = jrender.make_sharded_pt_step(
        jm, stack_depth=depth, spp_per_device=1, width=width, height=height,
        n_pixels=n, has_emission=jt.has_emission, hdri_enabled=True,
        accel_kind=kind)
    want = np.asarray(jstep(
        meta, root, jt.lower, jt.upper, jt.color, jt.emission, jnp.asarray(pmj),
        jhdri.load(sky, scale=1.0), jnp.asarray(jcam.o), jnp.asarray(jcam.right),
        jnp.asarray(jcam.up), jnp.asarray(jcam.front),
        jnp.float32(jcam.tan_half_fovy), jnp.float32(jcam.lens_r),
        jnp.float32(jcam.focus), jnp.zeros((n, 4), jnp.float32), jnp.uint32(0)))
    got, _ = sharded_step(pt, camera.Camera.look_at(eye=eye, target=center),
                          hdri.load(sky, scale=1.0, device="cpu"), pmj, width,
                          height)
    np.testing.assert_array_equal(got[:, 3], want[:, 3])
    assert abs(got[:, :3].mean() / want[:, :3].mean() - 1) < 5e-3
    close = np.isclose(got[:, :3], want[:, :3], rtol=1e-4, atol=0).all(axis=1)
    assert close.mean() >= 0.98, close.mean()
