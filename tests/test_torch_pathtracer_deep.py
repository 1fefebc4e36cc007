"""The port's path tracer at its full depth (8 bounces) against the JAX
package's pt_sample, 16x16 pixels x 4 spp.

The reference's 8-bounce run goes through the JAX package's octree of the
same scene, not its HakoTree: on one CPU its interpret-mode HakoTree
kernels take about 12 s per bounce (over 100 s for 8), while its octree
traversal (plain jnp) takes about 22 s for all 8, evaluated op by op under
`jax.disable_jit()` (no multiply-add contracted; jitted, XLA contracts
them and a quarter of the lanes differ by ulps). That one JAX run (a
module-scoped fixture) serves two tests:

  * the port's pt_sample through the same JAX octree (`octree.from_numpy`)
    holds it lane by lane: every lane bit-equal;
  * the port's pt_sample through the JAX package's HakoTree of the same
    voxels, the only 8-bounce check of the HakoTree route: the octree
    computes hit distances by other float operations, so radiance differs
    by ulps and a lane whose bounce ray grazes a voxel edge can take
    another path from there on. That bound is statistical: the image mean
    within 0.5% relative, and at least 98% of the lanes within rtol 1e-4.

test_torch_pathtracer.py holds the HakoTree route bit for bit after one
bounce.
"""

import jax
import numpy as np
import pytest
import torch

from massivevoxelraytracing_tpu.models import scene as jscene
from massivevoxelraytracing_tpu.ops import camera as jcamera
from massivevoxelraytracing_tpu.ops import hdri as jhdri
from massivevoxelraytracing_tpu.ops import sampling as jsampling
from massivevoxelraytracing_torch.models import pathtracer
from massivevoxelraytracing_torch.ops import camera, hako, hdri, octree

from test_torch_hako_build import jax_tree_dict
from test_torch_octree import jax_octree_dict

from test_torch_pathtracer import jax_pt_sample, parallel_scene, port_pt_sample

# The tensors here are small: one intra-op thread keeps the test runner's
# parallel workers from oversubscribing the cores.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def octree_run():
    """The scene, the JAX octree of it, and the JAX pt_sample through that
    octree at 8 bounces, op by op: (scene, jtree, pmj, radiance [1024, 3])."""
    sc = parallel_scene()
    tri, col, origin, dps, eye, center, sky = sc
    jtree = jscene.build_scene(tri, col, origin=origin, dps=dps, grid_res=64,
                               accel="octree")
    pmj = jsampling.make_pmj_table(16, 512)
    with jax.disable_jit():
        want = jax_pt_sample(jtree, jhdri.load(sky, scale=1.0), pmj,
                             jcamera.Camera.look_at(eye=eye, target=center), 16,
                             16, 4, max_bounces=pathtracer.MAX_BOUNCES)
    return sc, jtree, pmj, want


def test_eight_bounce_octree_matches_jax_lane_by_lane(octree_run):
    (_tri, _col, _origin, _dps, eye, center, sky), jtree, pmj, want = octree_run
    ptree = octree.from_numpy(jax_octree_dict(jtree), device="cpu")
    got = port_pt_sample(ptree, hdri.load(sky, scale=1.0, device="cpu"), pmj,
                         camera.Camera.look_at(eye=eye, target=center), 16, 16, 4)
    assert got.shape == (16 * 16 * 4, 3) and (got > 0).mean() > 0.5
    np.testing.assert_array_equal(got, want)


def test_eight_bounce_image_matches_jax_statistically(octree_run):
    (tri, col, origin, dps, eye, center, sky), jtree, pmj, want = octree_run
    # the port traverses the JAX package's HakoTree of the same voxels
    jhako_tree = jscene.build_scene(tri, col, origin=origin, dps=dps,
                                    grid_res=64, accel="hako")
    ptree = hako.from_numpy(jax_tree_dict(jhako_tree), device="cpu")
    assert ptree.n_voxels == int(jtree.n_voxels)
    got = port_pt_sample(ptree, hdri.load(sky, scale=1.0, device="cpu"), pmj,
                         camera.Camera.look_at(eye=eye, target=center), 16, 16, 4)
    assert np.isfinite(got).all() and (got > 0).mean() > 0.5
    assert abs(got.mean() / want.mean() - 1.0) < 5e-3
    close = np.all(np.abs(got - want) <= 1e-4 * np.abs(want) + 1e-7, axis=1)
    assert close.mean() >= 0.98, close.mean()
