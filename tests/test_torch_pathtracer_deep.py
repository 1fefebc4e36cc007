"""The port's path tracer at its full depth (8 bounces) against the JAX
package's pt_sample.

The reference's 8-bounce run goes through the JAX package's octree of the
same scene, not its HakoTree: on one CPU its interpret-mode HakoTree
kernels take about 12 s per bounce (over 100 s for 8), while its octree
traversal (plain jnp) takes about 30 s for all 8. The port traverses the
HakoTree that the JAX package builds of the same voxels, so every lane
sees the same scene; the octree computes hit distances by other float
operations (and XLA contracts multiply-adds), so radiance differs by ulps
and a lane whose bounce ray grazes a voxel edge can take another path
from there on. The bound is therefore statistical: the image mean within
0.5% relative, and at least 98% of the lanes within rtol 1e-4 (measured:
every lane within rtol 1e-4, 773 of 1024 bit-equal, the means equal).
test_torch_pathtracer.py holds the HakoTree route bit for bit after one
bounce.
"""

import numpy as np
import torch

from massivevoxelraytracing_tpu.models import scene as jscene
from massivevoxelraytracing_tpu.ops import camera as jcamera
from massivevoxelraytracing_tpu.ops import hdri as jhdri
from massivevoxelraytracing_tpu.ops import sampling as jsampling
from massivevoxelraytracing_torch.models import pathtracer
from massivevoxelraytracing_torch.ops import camera, hako, hdri

from test_torch_hako_build import jax_tree_dict

from test_torch_pathtracer import jax_pt_sample, parallel_scene, port_pt_sample

# The tensors here are small: one intra-op thread keeps the test runner's
# parallel workers from oversubscribing the cores.
torch.set_num_threads(1)


def test_eight_bounce_image_matches_jax_statistically():
    tri, col, origin, dps, eye, center, sky = parallel_scene()
    jtree = jscene.build_scene(tri, col, origin=origin, dps=dps, grid_res=64,
                               accel="octree")
    # the port traverses the JAX package's HakoTree of the same voxels
    jhako_tree = jscene.build_scene(tri, col, origin=origin, dps=dps,
                                    grid_res=64, accel="hako")
    ptree = hako.from_numpy(jax_tree_dict(jhako_tree), device="cpu")
    assert ptree.n_voxels == int(jtree.n_voxels)
    pmj = jsampling.make_pmj_table(16, 512)
    want = jax_pt_sample(jtree, jhdri.load(sky, scale=1.0), pmj,
                         jcamera.Camera.look_at(eye=eye, target=center), 16, 16, 4,
                         max_bounces=pathtracer.MAX_BOUNCES)
    got = port_pt_sample(ptree, hdri.load(sky, scale=1.0, device="cpu"), pmj,
                         camera.Camera.look_at(eye=eye, target=center), 16, 16, 4)
    assert np.isfinite(got).all() and (got > 0).mean() > 0.5
    assert abs(got.mean() / want.mean() - 1.0) < 5e-3
    close = np.all(np.abs(got - want) <= 1e-4 * np.abs(want) + 1e-7, axis=1)
    assert close.mean() >= 0.98, close.mean()

