"""The committed golden images (tests/golden/*.npz, rendered by the JAX
package through its brick tree on the CPU) hold the port too: the port's
brick route renders the same scenes, cameras, sky and packet as
tests/test_golden.py and must pass that file's tolerance (fewer than 0.2%
of the pixels off by more than 2/255)."""

import os

import numpy as np
import pytest
import torch

from massivevoxelraytracing_torch.models import raycast, scene
from massivevoxelraytracing_torch.models.pathtracer import PathTracer
from massivevoxelraytracing_torch.ops import camera as camera_ops
from massivevoxelraytracing_torch.utils import meshgen

# The tensors here are small: one intra-op thread keeps the test runner's
# parallel workers from oversubscribing the cores.
torch.set_num_threads(1)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")


def _scene_and_cam(grid_res=64, accel="brick"):
    tri = meshgen.icosphere(3, radius=0.85)
    origin, dps = meshgen.fit_grid(tri, grid_res)
    lo, hi = meshgen.mesh_bounds(tri)
    col = meshgen.vertex_colors_from_position(tri, lo, hi)
    tree = scene.build_scene(
        tri, col, np.zeros_like(tri),
        origin=origin, dps=dps, grid_res=grid_res, accel=accel, device="cpu",
    )
    center = np.asarray(origin) + 0.5 * float(dps) * grid_res
    extent = float(dps) * grid_res
    cam = camera_ops.Camera.look_at(
        eye=center + np.array([0.8, 0.5, 1.5]) * extent * 0.9,
        target=center, fovy_deg=40.0,
    )
    return tree, cam


def _render_primary(mode):
    tree, cam = _scene_and_cam()
    img, _ = raycast.render_frame(tree, cam, 128, 96,
                                  show_color=(mode == "color"), device="cpu")
    return img.numpy()


def _render_pt():
    tree, cam = _scene_and_cam(grid_res=32)
    pt = PathTracer(width=96, height=64, packet=1 << 15, device="cpu")
    pt.setup()
    h, w = 16, 32
    ang = np.linspace(0, np.pi, h)[:, None]
    sky = np.stack(
        [np.broadcast_to(0.6 + 0.4 * np.cos(ang), (h, w))] * 3, -1
    ).astype(np.float32)
    pt.load_hdri(sky)
    pt.update_scene(tree)
    pt.step(cam, n_spp=4)
    return pt.resolve().reshape(64, 96, 3)


def _check(name, img):
    ref = np.load(os.path.join(GOLDEN_DIR, name + ".npz"))["img"]
    assert img.shape == ref.shape, f"{name}: shape {img.shape} vs {ref.shape}"
    diff = np.abs(img.astype(np.int32) - ref.astype(np.int32))
    frac_off = (diff.max(axis=-1) > 2).mean()
    assert frac_off < 0.002, (
        f"{name}: {frac_off * 100:.2f}% of pixels moved by >2/255 "
        f"(max diff {diff.max()})"
    )
    return frac_off


@pytest.mark.parametrize("mode", ["normal", "color"])
def test_golden_primary(mode):
    _check("primary_" + mode, _render_primary(mode))


def test_golden_pt():
    _check("pt_4spp", _render_pt())
