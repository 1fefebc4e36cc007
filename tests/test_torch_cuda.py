"""The hand-written CUDA kernel on the card (marked `cuda`; skipped where
torch.cuda.is_available() is false): the hako_mega kernel against its
plain PyTorch version on the same device tensors, plain and fat layouts,
primary and shadow rays, bit for bit; and the whole slice on the card
(build_scene + render_frame through the kernel) against the same slice
on the CPU (plain version). Run on a card with

    python -m pytest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from massivevoxelraytracing_tpu.utils import meshgen
from massivevoxelraytracing_torch.models import raycast, scene
from massivevoxelraytracing_torch.ops import camera, hako, hako_mega, morton

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def random_tree(grid_res, n, rng, device):
    c = torch.as_tensor(rng.integers(0, grid_res, size=(n, 3)), device=device)
    codes = morton.encode(c[:, 0], c[:, 1], c[:, 2]).unique()
    return hako.build_hako(codes, grid_res, device=device, dps=1.0 / grid_res)


@pytest.mark.parametrize("shadow", [False, True])
@pytest.mark.parametrize("grid_res,n_vox,snodes_above", [
    (64, 1536, None), (256, 6144, None), (512, 8000, 128)])
def test_kernel_matches_plain_bit_for_bit(cuda, monkeypatch, grid_res, n_vox,
                                          snodes_above, shadow):
    if snodes_above is not None:
        monkeypatch.setattr(hako, "USE_SNODES_ABOVE", snodes_above)
    rng = np.random.default_rng(grid_res)
    tree = random_tree(grid_res, n_vox, rng, cuda)
    assert (tree.snodes is not None) == (snodes_above is not None)
    n = 4096
    ro = torch.as_tensor(rng.uniform(-1.0, 2.0, (n, 3)), dtype=torch.float32,
                         device=cuda)
    rd = torch.as_tensor(rng.normal(size=(n, 3)), dtype=torch.float32,
                         device=cuda)
    (bricks, snodes, tabs, root), T = hako_mega.hako_mega_args(tree)
    args = (bricks, snodes, tabs, root, tree.lower, tree.upper, ro, rd)
    hako_mega.reset_counters()
    got = hako_mega.intersect_rays_hako_mega(*args, T=T, shadow=shadow)
    want = hako_mega.intersect_rays_hako_mega_plain(*args, T=T, shadow=shadow)
    torch.cuda.synchronize()
    assert hako_mega.LAUNCHES == 1
    assert hako_mega.unresolved_lanes() == 0 and int(want[3]) == 0
    for a, b in zip(got, want[:3]):
        np.testing.assert_array_equal(a.cpu().numpy(), b.cpu().numpy())
    assert bool((got[0] < 1e37).any())


def test_slice_on_card_equals_slice_on_cpu(cuda, monkeypatch):
    """build_scene + render_frame on the card (kernel; the device given as
    the string "cuda") and on the CPU (plain version) give the same tree,
    image and depth, bit for bit; so does the grouped unique on the card."""
    tri, cols = meshgen.sphere_lattice(2, 2)
    kw = dict(origin=np.zeros(3, np.float32), dps=1.0 / 128, grid_res=128)
    on_card = scene.build_scene(tri, cols, device="cuda", **kw)
    on_cpu = scene.build_scene(tri, cols, device="cpu", **kw)
    monkeypatch.setattr(scene, "GROUP_DUMPED", 20000)
    grouped = scene.build_scene(tri, cols, device="cuda", chunk_tris=4096, **kw)
    assert grouped.build_stats["n_dumped"] > 2 * 20000
    for key in ("bricks", "color", "emission"):
        np.testing.assert_array_equal(getattr(on_card, key).cpu().numpy(),
                                      getattr(on_cpu, key).numpy())
        np.testing.assert_array_equal(getattr(grouped, key).cpu().numpy(),
                                      getattr(on_cpu, key).numpy())
    center = np.full(3, 0.5, np.float32)
    cam = camera.Camera.look_at(eye=center + np.array([0.9, 0.4, 1.4]) * 0.9,
                                target=center, fovy_deg=40.0)
    hako_mega.reset_counters()
    img, depth = raycast.render_frame(on_card, cam, 160, 96, device="cuda")
    assert hako_mega.LAUNCHES == 1
    img_c, depth_c = raycast.render_frame(on_cpu, cam, 160, 96, device="cpu")
    np.testing.assert_array_equal(img.cpu().numpy(), img_c.numpy())
    np.testing.assert_array_equal(depth.cpu().numpy(), depth_c.numpy())


def test_wrapper_checks_inputs(cuda):
    rows = torch.zeros((1, 164), dtype=torch.int64, device=cuda)
    rays = torch.zeros((4, 3), dtype=torch.float32, device=cuda)
    with pytest.raises(ValueError):
        hako_mega.intersect_rays_hako_mega(
            rows, None, (), (1, 0), torch.zeros(3, device=cuda),
            torch.ones(3, device=cuda), rays, rays, T=1)
