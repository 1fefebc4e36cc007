"""The hand-written CUDA kernels on the card (marked `cuda`; skipped where
torch.cuda.is_available() is false): the hako_mega kernel, and the round
driver's hako_probe / hako_dda / hako_merge round by round, against their
plain PyTorch versions on the same device tensors, plain and fat layouts,
primary and shadow rays, bit for bit; the whole slice on the card
(build_scene + render_frame through the kernel) against the same slice on
the CPU (plain version); a path-tracer step through both routes. Imports
nothing of JAX. Run on a card with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from massivevoxelraytracing_torch.models import pathtracer, raycast, scene
from massivevoxelraytracing_torch.ops import camera, hako, hako_mega, morton
from massivevoxelraytracing_torch.ops import hako_kernels as hk
from massivevoxelraytracing_torch.utils import meshgen

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


CASES = [(64, 1536, None), (256, 6144, None), (512, 8000, 128)]


def case_args(cuda, monkeypatch, grid_res, n_vox, snodes_above):
    """A random tree on the card and 4096 random rays: ((bricks, snodes,
    tabs, root, lower, upper, ro, rd), T)."""
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
    return (bricks, snodes, tabs, root, tree.lower, tree.upper, ro, rd), T


@pytest.mark.parametrize("shadow", [False, True])
@pytest.mark.parametrize("grid_res,n_vox,snodes_above", CASES)
def test_kernel_matches_plain_bit_for_bit(cuda, monkeypatch, grid_res, n_vox,
                                          snodes_above, shadow):
    args, T = case_args(cuda, monkeypatch, grid_res, n_vox, snodes_above)
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


def assert_equal(got, want, what):
    for i, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g, w), f"{what}: output {i} differs"


@pytest.mark.parametrize("shadow", [False, True])
@pytest.mark.parametrize("grid_res,n_vox,snodes_above", CASES)
def test_round_kernels_match_plain_bit_for_bit(cuda, monkeypatch, grid_res,
                                               n_vox, snodes_above, shadow):
    """Each round: hako_probe, hako_dda (snode and leaf stages) and
    hako_merge through their wrappers against their plain versions on the
    same inputs, then the loop goes on with the kernels' outputs; the
    result equals the plain driver's and the megakernel's."""
    args, T = case_args(cuda, monkeypatch, grid_res, n_vox, snodes_above)

    def probe(*a, **k):
        got = hk.hako_probe(*a, **k)
        assert_equal(got, hk.hako_probe_plain(*a, **k), "hako_probe")
        return got

    def dda(*a, **k):
        got = hk.hako_dda(*a, **k)
        assert_equal(got, hk.hako_dda_plain(*a, **k), "hako_dda")
        return got

    def merge(state, *a):
        want = tuple(x.clone() for x in state)
        hk.hako_merge(state, *a)
        hk.hako_merge_plain(want, *a)
        assert_equal(state, want, "hako_merge")

    hk.reset_counters()
    rounds = hk.default_max_rounds(args[1], T, hk.PROBES, hk.DDA_ITERS)
    got = hk.drive((probe, dda, merge), *args, T=T, shadow=shadow,
                   max_probes=hk.PROBES, max_dda=hk.DDA_ITERS, max_rounds=rounds)
    n_rounds = got[4]
    assert int(got[3]) == 0 and n_rounds > 1
    n_stages = 2 if args[1] is not None else 1
    assert hk.LAUNCHES == {"hako_probe": n_rounds, "hako_dda": n_stages * n_rounds,
                           "hako_merge": n_rounds}
    assert_equal(got[:3], hk.intersect_rays_hako_plain(*args, T=T, shadow=shadow)[:3],
                 "round driver vs plain")
    assert_equal(got[:3], hako_mega.intersect_rays_hako_mega(*args, T=T, shadow=shadow),
                 "round driver vs megakernel")


def test_round_wrappers_check_inputs(cuda):
    n = 4
    rays = torch.zeros((n, 3), device=cuda)
    idx64 = torch.zeros(n, dtype=torch.int64, device=cuda)
    tq = torch.zeros(n, device=cuda)
    bounds = torch.zeros(6, device=cuda)
    with pytest.raises(ValueError):  # int64 lane index
        hk.hako_probe(None, (), 1, (1, 0), bounds, rays, rays, idx64, tq,
                      max_probes=4)
    idx = idx64.int()
    with pytest.raises(ValueError):  # rows on the CPU
        hk.hako_dda(torch.zeros((1, 164), dtype=torch.int32), bounds, rays, rays,
                    idx, torch.zeros(n, dtype=torch.bool, device=cuda), idx,
                    torch.zeros((3, n), device=cuda), tq, dt_factor=0.25,
                    leaf=True, shadow=False, max_iters=4)
    with pytest.raises(ValueError):  # bt1 transposed
        b = torch.zeros(n, dtype=torch.bool, device=cuda)
        state = (b.clone(), tq.clone(), tq.clone(), idx.clone(), idx.clone())
        hk.hako_merge(state, idx, b, torch.zeros((n, 3), device=cuda), tq, b, b,
                      tq, idx, idx, b, tq)


def test_pt_step_rounds_equals_mega_on_card(cuda):
    """A path-tracer step on the card through the round driver equals the
    megakernel route's bit for bit, and both launch their kernels."""
    tri = meshgen.icosphere(2, radius=0.85)
    origin, dps = meshgen.fit_grid(tri, 64)
    tree = scene.build_scene(tri, np.full_like(tri, 0.8), origin=origin, dps=dps,
                             grid_res=64, device="cuda")
    extent = float(dps) * 64
    center = np.asarray(origin) + extent / 2
    cam = camera.Camera.look_at(eye=center + np.array([0.8, 0.5, 1.5]) * extent,
                                target=center)
    sky = np.ones((16, 32, 3), np.float32)
    accum = {}
    for traversal in ("mega", "rounds"):
        pt = pathtracer.PathTracer(width=48, height=32, traversal=traversal)
        pt.pmj_table = torch.from_numpy(
            np.random.default_rng(0).random((128, 4096, 2), np.float32))
        pt.setup()
        pt.load_hdri(sky, scale=1.0)
        pt.update_scene(tree)
        hako_mega.reset_counters()
        hk.reset_counters()
        pt.step(cam, n_spp=4)
        torch.cuda.synchronize()
        if traversal == "mega":
            assert hako_mega.LAUNCHES > 0 and hk.ROUNDS == 0
        else:
            assert hako_mega.LAUNCHES == 0 and min(hk.LAUNCHES.values()) > 0
        assert pt.accum.device.type == "cuda"
        accum[traversal] = pt.accum
    assert bool(torch.isfinite(accum["mega"]).all())
    assert float(accum["mega"][:, :3].mean()) > 0
    assert torch.equal(accum["rounds"], accum["mega"])
