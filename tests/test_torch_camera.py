"""ops/camera.shoot_thin_lens, the thin lens's pixel rays, against the JAX
package's on 256 rays: bit for bit against the reference evaluated op by
op (jax.disable_jit: no fusion, no multiply-add contraction), with the
pixel offsets as arrays and as Python floats, and the lens at zero radius
(every ray leaves the eye)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from massivevoxelraytracing_tpu.ops import camera as jcamera
from massivevoxelraytracing_torch.ops import camera

# The tensors here are small: one intra-op thread keeps the test runner's
# parallel workers from oversubscribing the cores.
torch.set_num_threads(1)

W, H = 37, 23
N = 256


def cameras(lens_r: float):
    kw = dict(eye=(0.9, 0.7, 2.1), target=(0.5, 0.45, 0.5), fovy_deg=40.0,
              lens_r=lens_r, focus=1.7)
    return jcamera.Camera.look_at(**kw), camera.Camera.look_at(**kw)


@pytest.mark.parametrize("lens_r, offsets", [(0.03, "arrays"), (0.03, "floats"),
                                             (0.0, "arrays")])
def test_thin_lens_equals_jax_op_by_op(lens_r, offsets):
    rng = np.random.default_rng(5)
    px = rng.integers(0, W, N).astype(np.int32)
    py = rng.integers(0, H, N).astype(np.int32)
    u0, u1 = (rng.random(N).astype(np.float32) for _ in range(2))
    if offsets == "arrays":
        ox, oy = (rng.random(N).astype(np.float32) for _ in range(2))
        joff = (jnp.asarray(ox), jnp.asarray(oy))
        off = (torch.from_numpy(ox), torch.from_numpy(oy))
    else:
        joff = off = (0.5, 0.25)
    jcam, cam = cameras(lens_r)
    with jax.disable_jit():
        jro, jrd = jcamera.shoot_thin_lens(jcam, jnp.asarray(px), jnp.asarray(py), *joff,
                                           W, H, jnp.asarray(u0), jnp.asarray(u1))
    ro, rd = camera.shoot_thin_lens(cam, torch.from_numpy(px), torch.from_numpy(py), *off,
                                    W, H, torch.from_numpy(u0), torch.from_numpy(u1))
    assert ro.dtype == rd.dtype == torch.float32
    assert tuple(ro.shape) == tuple(rd.shape) == (N, 3)
    np.testing.assert_array_equal(ro.numpy(), np.asarray(jro))
    np.testing.assert_array_equal(rd.numpy(), np.asarray(jrd))
    if lens_r == 0.0:
        np.testing.assert_array_equal(ro.numpy(), np.broadcast_to(cam.o, (N, 3)))
