"""The port's path tracer at 2 bounces against the JAX package's pt_sample
traced through the JAX package's HakoTree (the "hako" accel), not its
octree: tests/test_torch_pathtracer.py's scene at 64^3, 8x8 pixels x 2 spp.

Tolerance: bit for bit. With jax.disable_jit() the reference runs op by
op, so XLA contracts no multiply-add (tests/test_torch_hako_mega.py) and
every float op rounds as the port's; the second bounce then sees the same
rays, the same hits and the same sample streams, and per-lane radiance is
equal. The reference's HakoTree kernels run op by op on the CPU, so the
cost is per op, not per lane: the file took 55 s alone on one core (1 spp
took as long).
test_torch_pathtracer_deep.py goes to 8 bounces through the JAX octree.
"""

import jax
import numpy as np
import torch

from massivevoxelraytracing_tpu.models import scene as jscene
from massivevoxelraytracing_tpu.ops import camera as jcamera
from massivevoxelraytracing_tpu.ops import hdri as jhdri
from massivevoxelraytracing_tpu.ops import sampling as jsampling
from massivevoxelraytracing_torch.ops import camera, hako, hdri

from test_torch_hako_build import jax_tree_dict

from test_torch_pathtracer import jax_pt_sample, parallel_scene, port_pt_sample

# The tensors here are small: one intra-op thread keeps the test runner's
# parallel workers from oversubscribing the cores.
torch.set_num_threads(1)


def test_two_bounce_radiance_equals_jax_hako_bit_for_bit():
    tri, col, origin, dps, eye, center, sky = parallel_scene()
    jtree = jscene.build_scene(tri, col, origin=origin, dps=dps, grid_res=64,
                               accel="hako")
    ptree = hako.from_numpy(jax_tree_dict(jtree), device="cpu")
    pmj = jsampling.make_pmj_table(16, 512)
    with jax.disable_jit():
        want = jax_pt_sample(jtree, jhdri.load(sky, scale=1.0), pmj,
                             jcamera.Camera.look_at(eye=eye, target=center), 8, 8,
                             2, max_bounces=2)
    got = port_pt_sample(ptree, hdri.load(sky, scale=1.0, device="cpu"), pmj,
                         camera.Camera.look_at(eye=eye, target=center), 8, 8, 2,
                         max_bounces=2)
    assert got.shape == (8 * 8 * 2, 3) and np.isfinite(got).all()
    assert (got > 0).mean() > 0.5
    np.testing.assert_array_equal(got, want)
