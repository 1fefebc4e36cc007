"""The hand-written CUDA kernels on the card (marked `cuda`; skipped where
torch.cuda.is_available() is false): the hako_mega kernel, and the round
driver's hako_probe / hako_dda / hako_merge and its fused row stage
hako_dda_merge round by round, against their plain PyTorch versions on the
same device tensors, plain and fat layouts, primary and shadow rays, bit
for bit (and the route, one hako_rounds launch a call, against hako_mega;
hako_rounds against the two-launch and plain drivers with their rounds,
at the default caps, capped and cut, with no host sync under
set_sync_debug_mode("error"), and a grid the card refuses raising); the whole slice on the card
(build_scene + render_frame through the kernel) against the same slice on
the CPU (plain version); a path-tracer step through both routes; the kernel
at small ray counts and on permuted rays, and its counting variant; the
rtcamp app for two tiny frames on the card against the same run on the
CPU (u8 images exact); the brick tree, the octree (DAG on and off), their
walks, the streamed build, the terrain generator and the voxmesh /
voxtriangle apps on the card against the same on the CPU; the issue-cost
probes (construct_probe, node_gather_probe, table_select_probe,
calib_probe, the scan64 walk probe) against their plain versions on the
card, bit for bit, at two block sizes and a ragged lane count (the
row-word fetch at 32, 256 and 1,024 threads, 0 to 64 repeats, on a rows
view at a 16-byte offset, and at every block size its shared-memory query
allows; the L2 read probe over a full grid and one block); kernel A's
shell, preamble and stage probes (both shell layouts, all five stages,
child indices past an smem- and a taa-form level; the streaming stage
kernel also == the parent commit's at 1 to past 3 waves of lanes, under
every mirror mask, with +-0 / inf / NaN directions and ranks clipped at
cells 64-127) and kernel B through
its row cache (leaf and supernode rows, primary and shadow, no cache, a
cache small enough that lanes overflow it, caches that hold every
distinct row, a last block partial and without go-lanes, the largest
cache its shared-memory query fits and one row more, refused, and a
cache the card refuses); the gather
probes (take_along_probe in each form on the reference's tiles, and the
shared form's refusal of a table over a block's shared memory;
smem_alloc_probe up to the opt-in limit and one row past it; ohg_probe in
each mode at 32, 128 and 1024 rows); the multi-device layer with every mesh
entry on the card (the sharded build at 2 and 8 shards == build_scene, the
sharded frame == render_frame with one launch a band, the sharded PT step
within rtol 2e-5 of pt_sample, bigscene's shards == the whole tree); the Morton codecs on the card
against the host C++ codec and the thin lens's rays against the CPU's;
the path tracer's sample chain (ops/pt_chain.py): each of its five
kernels against its plain stage bit for bit on random lanes (every
template case) and on the stage calls a PT step makes, a PT step through
the kernels against the same step through the plain stages (2 and 8
bounces, with and without emission and sky; PCG32), the sats HDRI
backend's counted plain stage (and the bounce sample through it on a sky
whose column prefixes step down and on skies either side of the limit of
its staged rows), a build failure that raises, and the nvcc
command of pt_chain.cu; the frame's kernels (models/raycast.py,
csrc/frame.cu: frame_raygen on whole frames and bands past row 0 at widths
1 to 1920, multiples of 128 or not, 1 to 9 tile rows, and its refusal of
a band past 32-bit lane arithmetic; frame_shade for normals and colours,
un-tiled and flat, on lanes with ±0 and NaN directions) and the walk
kernels (csrc/walks.cu: brick_walk, octree_walk with DAG on and off,
shadow on and off, max_iters cuts of 1, 7 and 100, on mirrored,
axis-parallel, inside, parked, NaN and inf rays, and on stacks shallower
than the walk needs; the brick walk's crossed-cell selection also on a
full grid, a solid cube and a sparse tree, rays in cell planes, along
axes and diagonals, from inside or on a voxel, with ±0, NaN and inf)
against their plain versions bit for bit; the octree walk's candidate
masks, look-ahead and fold also on a solid cube and a sparse tree, DAG on
and off, shadow on and off, max_iters cuts of 1, 2, 3, 7, 100 and 100000,
rays from the octant-plane lattice along axes and diagonals, from inside
or on a voxel or far away, with ±0, NaN and inf, and stacks of 1, 2 and
3; a stack
deeper than 16 refused before any launch, render_frame / render_rays
against stages="plain" (HakoTree, brick tree, octree with DAG on and
off), and a PT step through the walk kernels against the plain walks.
Imports nothing of JAX. Run on a card with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from massivevoxelraytracing_torch.models import pathtracer, raycast, scene
from massivevoxelraytracing_torch.ops import camera, hako, hako_mega, morton
from massivevoxelraytracing_torch.ops import hako_kernels as hk
from massivevoxelraytracing_torch.scripts import dyngather_probe2 as dg
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
    got = hk.drive((probe, hk.unfused_stage(dda, merge)), *args, T=T, shadow=shadow,
                   max_probes=hk.PROBES, max_dda=hk.DDA_ITERS, max_rounds=rounds)
    n_rounds = got[4]
    assert int(got[3]) == 0 and n_rounds > 1
    n_stages = 2 if args[1] is not None else 1
    assert hk.LAUNCHES == {"hako_rounds": 0, "hako_probe": n_rounds, "hako_dda_merge": 0,
                           "hako_dda": n_stages * n_rounds, "hako_merge": n_rounds,
                           "hako_dda_cached": 0}
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


@pytest.mark.parametrize("shadow", [False, True])
@pytest.mark.parametrize("grid_res,n_vox,snodes_above", CASES)
def test_dda_merge_matches_plain_bit_for_bit(cuda, monkeypatch, grid_res, n_vox,
                                             snodes_above, shadow):
    """The fused row stage through its wrapper against its plain version on
    the same state and kernel A outputs, every round, with kernel B capped
    at 2 sub-brick visits so that lanes resume (and, on the fat tree, miss
    their supernode); the driver goes on with the kernel's state and ends
    equal to the plain driver and the megakernel."""
    args, T = case_args(cuda, monkeypatch, grid_res, n_vox, snodes_above)
    resumed = []

    def stage(state, *a, **k):
        want = tuple(x.clone() for x in state)
        hk.hako_dda_merge(state, *a, **k)
        hk.hako_dda_merge_plain(want, *a, **k)
        assert_equal(state, want, "hako_dda_merge")
        # the lanes the first row stage (supernode rows of a fat tree) left capped
        rows, leaf = (a[0], True) if a[1] is None else (a[1], False)
        first = hk.hako_dda_plain(rows, *a[2:10], dt_factor=0.25 ** T, leaf=leaf,
                                  shadow=k["shadow"], max_iters=k["max_iters"])
        resumed.append(int(first[6].sum()))

    hk.reset_counters()
    got = hk.drive((hk.hako_probe, stage), *args, T=T, shadow=shadow, max_probes=hk.PROBES,
                   max_dda=2, max_rounds=hk.default_max_rounds(args[1], T, hk.PROBES, 2))
    n_rounds = got[4]
    assert int(got[3]) == 0 and n_rounds > 1 and sum(resumed) > 0
    assert hk.LAUNCHES == {"hako_rounds": 0, "hako_probe": n_rounds,
                           "hako_dda_merge": n_rounds, "hako_dda": 0, "hako_merge": 0,
                           "hako_dda_cached": 0}
    assert_equal(got[:3], hk.intersect_rays_hako_plain(*args, T=T, shadow=shadow)[:3],
                 "fused rounds vs plain")
    assert_equal(got[:3], hako_mega.intersect_rays_hako_mega(*args, T=T, shadow=shadow),
                 "fused rounds vs megakernel")


@pytest.mark.parametrize("shadow", [False, True])
@pytest.mark.parametrize("grid_res,n_vox,snodes_above", CASES)
def test_rounds_route_equals_megakernel(cuda, monkeypatch, grid_res, n_vox,
                                        snodes_above, shadow):
    """intersect_rays_hako on the card: one hako_rounds launch a call, none
    of the two-launch or unfused drivers' kernels, equal to hako_mega."""
    args, T = case_args(cuda, monkeypatch, grid_res, n_vox, snodes_above)
    hk.reset_counters()
    got = hk.intersect_rays_hako(*args, T=T, shadow=shadow)
    torch.cuda.synchronize()
    assert hk.rounds_run() > 1 and hk.unresolved_lanes() == 0
    assert hk.LAUNCHES == {"hako_rounds": 1, "hako_probe": 0, "hako_dda_merge": 0,
                           "hako_dda": 0, "hako_merge": 0, "hako_dda_cached": 0}
    assert_equal(got, hako_mega.intersect_rays_hako_mega(*args, T=T, shadow=shadow),
                 "rounds route vs megakernel")


ROUND_CAPS = [(hk.PROBES, hk.DDA_ITERS, None), (1, 1, None), (1, 2, 3)]


@pytest.mark.parametrize("caps", ROUND_CAPS, ids=["default", "capped", "cut"])
@pytest.mark.parametrize("shadow", [False, True])
@pytest.mark.parametrize("grid_res,n_vox,snodes_above", CASES)
def test_rounds_kernel_equals_two_launch_and_plain(cuda, monkeypatch, grid_res, n_vox,
                                                   snodes_above, shadow, caps):
    """hako_rounds (the round loop in one cooperative launch) against the
    two-launch driver (hako_probe, hako_dda_merge a round) and the plain
    driver on the same card tensors: t, nmajor, vrank bit for bit, the
    same rounds and unresolved lanes; with the default caps, with one
    probe and one sub-brick visit a round (every resume path), and cut
    at 3 rounds (lanes left unresolved)."""
    args, T = case_args(cuda, monkeypatch, grid_res, n_vox, snodes_above)
    max_probes, max_dda, max_rounds = caps
    if max_rounds is None:
        max_rounds = hk.default_max_rounds(args[1], T, max_probes, max_dda)
    kw = dict(T=T, shadow=shadow, max_probes=max_probes, max_dda=max_dda,
              max_rounds=max_rounds)
    hk.reset_counters()
    got = hk.hako_rounds(*args, **kw)
    assert hk.LAUNCHES["hako_rounds"] == 1
    two = hk.drive((hk.hako_probe, hk.hako_dda_merge), *args, **kw)
    want = hk.intersect_rays_hako_plain(*args, **kw)
    torch.cuda.synchronize()
    assert_equal(got[:3], want[:3], "hako_rounds vs plain")
    assert_equal(two[:3], want[:3], "two-launch vs plain")
    assert got[3].tolist() == [want[4], int(want[3])] == [two[4], int(two[3])]
    if caps[2] is None:
        assert want[4] > 1 and int(want[3]) == 0
    else:
        assert want[4] == 3 and int(want[3]) > 0


def test_rounds_kernel_makes_no_host_sync(cuda, monkeypatch):
    """Once the kernel is built, intersect_rays_hako on CUDA tensors runs
    under torch.cuda.set_sync_debug_mode("error"): no nonzero, no .item(),
    no copy to the host; one launch a call."""
    args, T = case_args(cuda, monkeypatch, 512, 8000, 128)
    want = hk.intersect_rays_hako(*args, T=T)  # builds the library
    torch.cuda.synchronize()
    hk.reset_counters()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = hk.intersect_rays_hako(*args, T=T)
        shadow = hk.intersect_rays_hako(*args, T=T, shadow=True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert hk.LAUNCHES["hako_rounds"] == 2 and hk.LAUNCHES["hako_probe"] == 0
    assert_equal(got, want, "a call under the sync check")
    assert bool((shadow[0] < 1e37).any())
    assert hk.unresolved_lanes() == 0 and hk.rounds_run() > 2


def test_rounds_kernel_failed_launch_raises(cuda, monkeypatch):
    """A grid the card cannot hold co-resident is refused by the
    cooperative launch, and the wrapper raises: no fallback, no count."""
    args, T = case_args(cuda, monkeypatch, 64, 1536, None)
    per_sm, sms = hk.rounds_grid(cuda, False, False)
    assert per_sm >= 1 and sms >= 1
    hk.reset_counters()
    with pytest.raises(RuntimeError, match="hako_rounds kernel launch failed"):
        hk.hako_rounds(*args, T=T, _blocks=per_sm * sms + 1)
    assert set(hk.LAUNCHES.values()) == {0}
    got = hk.hako_rounds(*args, T=T, _blocks=per_sm * sms)  # the largest grid it takes
    assert_equal(got[:3], hk.intersect_rays_hako_plain(*args, T=T)[:3],
                 "hako_rounds on the full co-resident grid")


def test_dda_merge_checks_inputs(cuda):
    n = 4
    rays = torch.zeros((n, 3), device=cuda)
    idx = torch.zeros(n, dtype=torch.int32, device=cuda)
    f = torch.zeros(n, device=cuda)
    b = torch.zeros(n, dtype=torch.bool, device=cuda)
    bt1 = torch.zeros((3, n), device=cuda)
    rows = torch.zeros((1, 164), dtype=torch.int32, device=cuda)
    bounds = torch.zeros(6, device=cuda)

    def state():
        return (b.clone(), f.clone(), f.clone(), idx.clone(), idx.clone())

    kw = dict(T=1, shadow=False, max_iters=4)
    ok = (rows, None, bounds, rays, rays, idx, b, idx, bt1, f, f, b)
    hk.reset_counters()
    hk.hako_dda_merge(state(), *ok, **kw)
    torch.cuda.synchronize()
    assert hk.LAUNCHES["hako_dda_merge"] == 1
    for i, bad in ((0, rows.long()),                    # int64 brick rows
                   (1, torch.zeros((1, 160), dtype=torch.int32, device=cuda)),  # snodes
                   (5, idx.long()),                     # int64 lane index
                   (7, idx.float()),                    # float child ids
                   (8, torch.zeros((n, 3), device=cuda)),  # bt1 transposed
                   (11, f)):                            # float exh
        with pytest.raises(ValueError):
            hk.hako_dda_merge(state(), *ok[:i], bad, *ok[i + 1:], **kw)
    with pytest.raises(ValueError):  # the state on the CPU
        hk.hako_dda_merge(tuple(x.cpu() for x in state()), *ok, **kw)
    for r in (n - 1, n + 1):  # a state one lane shorter or longer than the rays
        with pytest.raises(ValueError, match=f"state: {r} lanes for {n} rays"):
            hk.hako_dda_merge(tuple(torch.cat([x, x])[:r] for x in state()), *ok, **kw)
    torch.cuda.synchronize()
    assert hk.LAUNCHES["hako_dda_merge"] == 1


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
            assert hako_mega.LAUNCHES > 0 and hk.rounds_run() == 0
        else:
            assert hako_mega.LAUNCHES == 0 and min(hk.LAUNCHES[k] for k in hk.ROUTE_KERNELS) > 0
        assert pt.accum.device.type == "cuda"
        accum[traversal] = pt.accum
    assert bool(torch.isfinite(accum["mega"]).all())
    assert float(accum["mega"][:, :3].mean()) > 0
    assert torch.equal(accum["rounds"], accum["mega"])


@pytest.mark.parametrize("n", [0, 1, 31, 33, 1000])
def test_kernel_at_small_counts(cuda, monkeypatch, n):
    """Ray counts around a warp and inside one block, and none: equal to
    the plain version, one launch for n > 0."""
    args, T = case_args(cuda, monkeypatch, 512, 8000, 128)
    args = (*args[:6], args[6][:n].contiguous(), args[7][:n].contiguous())
    hako_mega.reset_counters()
    got = hako_mega.intersect_rays_hako_mega(*args, T=T)
    want = hako_mega.intersect_rays_hako_mega_plain(*args, T=T)
    torch.cuda.synchronize()
    assert int(want[3]) == 0
    assert_equal(got, want[:3], "kernel vs plain")
    assert got[0].shape == (n,)
    assert hako_mega.LAUNCHES == (1 if n else 0)
    assert hako_mega.unresolved_lanes() == 0


def test_permuted_rays_give_permuted_outputs(cuda, monkeypatch):
    """Results are per ray, whichever warp takes a ray."""
    args, T = case_args(cuda, monkeypatch, 256, 6144, None)
    got = hako_mega.intersect_rays_hako_mega(*args, T=T)
    perm = torch.from_numpy(np.random.default_rng(5).permutation(
        args[6].shape[0])).to(cuda)
    shuffled = (*args[:6], args[6][perm].contiguous(), args[7][perm].contiguous())
    assert_equal(hako_mega.intersect_rays_hako_mega(*shuffled, T=T),
                 tuple(x[perm] for x in got), "permuted rays")


@pytest.mark.parametrize("shadow", [False, True])
@pytest.mark.parametrize("grid_res,n_vox,snodes_above", CASES)
def test_counting_variant_equals_kernel(cuda, monkeypatch, grid_res, n_vox,
                                        snodes_above, shadow):
    args, T = case_args(cuda, monkeypatch, grid_res, n_vox, snodes_above)
    got = hako_mega.intersect_rays_hako_mega(*args, T=T, shadow=shadow)
    counted = hako_mega.intersect_rays_hako_mega_counted(*args, T=T, shadow=shadow)
    assert_equal(counted[:3], got, "counting variant")
    counts, warps = counted[3], counted[4]
    rounds = counts[hako_mega.RAY_COUNTS.index("rounds")]
    assert bool((rounds >= 1).any()) and int(counts.min()) >= 0
    busy = warps[warps[:, 1] > 0]
    assert int(busy[:, 1].sum()) > 0
    assert bool((busy[:, 0] <= 32 * busy[:, 1]).all())
    # the lanes' lives end where their rays resolve, inside the warp's life
    assert bool((busy[:, 4] <= 32 * (busy[:, 3] - busy[:, 2])).all())


def test_rtcamp_on_card_equals_cpu_run(cuda, tmp_path):
    """Two tiny rtcamp frames (16^3 and 32^3) on the card: the same grids,
    voxels and PNGs, byte for byte, as the run on the CPU's plain
    versions; the card run launches the megakernel."""
    from massivevoxelraytracing_torch.apps import rtcamp

    argv = ["--scene", "torus", "--frames", "2", "--width", "24", "--height",
            "16", "--steps", "1", "--from-res", "16", "--to-res", "32"]
    hako_mega.reset_counters()
    on_card = rtcamp.main(argv + ["--device", "cuda", "--out", str(tmp_path / "gpu")])
    assert hako_mega.LAUNCHES > 0
    launches = hako_mega.LAUNCHES
    on_cpu = rtcamp.main(argv + ["--device", "cpu", "--out", str(tmp_path / "cpu")])
    assert hako_mega.LAUNCHES == launches  # the CPU run launches no kernel
    assert [r["grid_res"] for r in on_card] == [r["grid_res"] for r in on_cpu] == [16, 32]
    for a, b in zip(on_card, on_cpu):
        assert a["build_stats"]["n_unique"] == b["build_stats"]["n_unique"]
        name = f"{a['frame']:03d}.png"
        with open(tmp_path / "gpu" / name, "rb") as fa, \
                open(tmp_path / "cpu" / name, "rb") as fb:
            assert fa.read() == fb.read(), name


# ---------------------------------------------------------------------------
# the brick tree, the octree and the streamed build (tensor code on the
# card; the same ops as on the CPU, so the same bits)
# ---------------------------------------------------------------------------

def structure_case(grid_res, n_vox, n_rays=4096):
    rng = np.random.default_rng(grid_res + n_vox)
    c = torch.as_tensor(rng.integers(0, grid_res, size=(n_vox, 3)))
    codes = morton.encode(c[:, 0], c[:, 1], c[:, 2]).unique()
    ro = rng.uniform(-1.0, 2.0, (n_rays, 3)).astype(np.float32)
    x, y, z = (v.numpy() for v in morton.decode(codes[rng.integers(0, codes.shape[0], n_rays)]))
    rd = ((np.stack([x, y, z], -1) + 0.5) / grid_res - ro).astype(np.float32)
    return codes, ro, rd


def build_structure(kind, codes, grid_res, device, dag=True):
    from massivevoxelraytracing_torch.ops import bricktree, octree

    lower = np.zeros(3, np.float32)
    if kind == "brick":
        return bricktree.build_bricktree(codes.to(device), grid_res,
                                         lower=lower, dps=1.0 / grid_res)
    return octree.build_octree(codes.to(device), grid_res, dag=dag, lower=lower,
                               upper=lower + np.float32(1.0 / grid_res) * grid_res)


@pytest.mark.parametrize("kind,dag", [("brick", True), ("octree", True),
                                      ("octree", False)])
def test_structures_on_card_equal_cpu(cuda, kind, dag):
    """Builds and walks (brick; octree v1 and v2, primary and shadow) on the
    card == on the CPU, bit for bit."""
    from massivevoxelraytracing_torch.ops import bricktree, traverse, traverse2

    codes, ro, rd = structure_case(256, 20000)
    on_card = build_structure(kind, codes, 256, cuda, dag)
    on_cpu = build_structure(kind, codes, 256, "cpu", dag)
    fields = ("meta",) if kind == "brick" else ("children", "psum", "mask", "meta")
    for name in fields + ("upper",):
        np.testing.assert_array_equal(getattr(on_card, name).cpu().numpy(),
                                      getattr(on_cpu, name).numpy(), err_msg=name)
    walks = ([bricktree.intersect_bricktree] if kind == "brick"
             else [traverse.intersect_octree, traverse2.intersect_octree2])
    for walk in walks:
        for shadow in (False, True):
            got = [x.cpu() for x in walk(on_card, ro, rd, shadow=shadow)]
            want = walk(on_cpu, ro, rd, shadow=shadow)
            assert int((want[0] < 1e37).sum()) > 1000
            assert_equal(got, want, f"{walk.__name__} shadow={shadow}")


@pytest.mark.parametrize("accel", ["brick", "octree"])
def test_structure_frames_on_card_equal_cpu(cuda, accel):
    tri, cols = meshgen.sphere_lattice(2, 2)
    kw = dict(origin=np.zeros(3, np.float32), dps=1.0 / 128, grid_res=128,
              accel=accel)
    on_card = scene.build_scene(tri, cols, device="cuda", **kw)
    on_cpu = scene.build_scene(tri, cols, device="cpu", **kw)
    assert on_card.n_nodes == on_cpu.n_nodes
    center = np.full(3, 0.5, np.float32)
    cam = camera.Camera.look_at(eye=center + np.array([0.9, 0.4, 1.4]) * 0.9,
                                target=center, fovy_deg=40.0)
    img, depth = raycast.render_frame(on_card, cam, 160, 96, device="cuda")
    img_c, depth_c = raycast.render_frame(on_cpu, cam, 160, 96, device="cpu")
    np.testing.assert_array_equal(img.cpu().numpy(), img_c.numpy())
    np.testing.assert_array_equal(depth.cpu().numpy(), depth_c.numpy())


@pytest.mark.parametrize("park", ["host", "device"])
def test_stream_build_on_card_equals_cpu(cuda, park):
    """The streamed build of the same chunks on the card == on the CPU; the
    terrain generator on the card stays in its tie band of the CPU's (f32
    sin / cos, then floor)."""
    from massivevoxelraytracing_torch.ops import hako_stream
    from massivevoxelraytracing_torch.utils import shellgen

    cpu_chunks = [c[0] for c in shellgen.Terrain(256, 64, device="cpu").chunks()]
    card_chunks = [c[0] for c in shellgen.Terrain(256, 64, device=cuda).chunks()]
    a, b = torch.cat(cpu_chunks).numpy(), torch.cat(card_chunks).cpu().numpy()
    assert len(np.setxor1d(a, b)) <= 1e-4 * len(a)
    got = hako_stream.build_hako_stream(((c.to(cuda),) for c in cpu_chunks), 256,
                                        park=park)
    want = hako_stream.build_hako_stream(((c,) for c in cpu_chunks), 256)
    assert got.bricks.device.type == "cuda"
    assert torch.equal(got.bricks.cpu(), want.bricks)
    for x, y in zip(got.levels, want.levels):
        assert torch.equal(x.cpu(), y)
    assert (got.root_mask_lo, got.root_mask_hi) == (want.root_mask_lo, want.root_mask_hi)


def test_mesh_apps_on_card_equal_cpu(cuda, tmp_path):
    from massivevoxelraytracing_torch.apps import voxmesh, voxtriangle

    for dev in ("cuda", "cpu"):
        voxmesh.main(["--scene", "sphere", "--res", "32", "--device", dev,
                      "--out", str(tmp_path / f"{dev}.ply")])
        voxtriangle.main(["--res", "32", "--device", dev,
                          "--out", str(tmp_path / dev)])
    for a, b in (("cuda.ply", "cpu.ply"),
                 ("cuda/coverage.png", "cpu/coverage.png")):
        assert (tmp_path / a).read_bytes() == (tmp_path / b).read_bytes(), a



PROBE_LANES = 1000  # not a multiple of 32: the last warp is partial
PROBE_K = 24


@pytest.mark.parametrize("threads", [32, 256])
@pytest.mark.parametrize("kind", ["minmax", "cmpsel", "int", "vshift", "barrel",
                                  "i2f", "bitat", "pc64"])
def test_construct_probe_matches_plain(cuda, kind, threads):
    from massivevoxelraytracing_torch.ops import probes
    from massivevoxelraytracing_torch.scripts import construct_micro

    xs = construct_micro.inputs(kind, PROBE_LANES, cuda, np.random.default_rng(5))
    probes.reset_counters()
    got = probes.construct_probe(kind, xs, k=PROBE_K, threads=threads)
    assert probes.LAUNCHES["construct_probe"] == 1
    assert torch.equal(got, probes.construct_plain(kind, xs, PROBE_K))


@pytest.mark.parametrize("space", ["global", "shared", "constant"])
@pytest.mark.parametrize("n_nodes,rows", [(128, None), (1024, 8), (4096, 32)])
def test_node_gather_probe_matches_plain(cuda, space, n_nodes, rows):
    from massivevoxelraytracing_torch.ops import probes
    from massivevoxelraytracing_torch.scripts import hako_kernel_micro as km

    rng = np.random.default_rng(n_nodes)
    table = probes.node_table_from_segments(km.segment_table(n_nodes, rows, rng), cuda)
    idx0 = torch.as_tensor(rng.integers(0, n_nodes - 31, PROBE_LANES)
                           .astype(np.int32), device=cuda)
    got = probes.node_gather_probe(table, idx0, k=PROBE_K, space=space)
    for a, b in zip(got, probes.node_gather_plain(table, idx0, PROBE_K)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("form", ["constant", "shared", "shuffle"])
def test_table_select_probe_matches_plain(cuda, form):
    from massivevoxelraytracing_torch.ops import probes

    rng = np.random.default_rng(9)
    tab = torch.as_tensor(rng.integers(0, 1 << 32, (64, 3), dtype=np.uint64)
                          .astype(np.uint32).view(np.int32), device=cuda)
    idx0 = torch.as_tensor(rng.integers(0, 64, PROBE_LANES).astype(np.int32),
                           device=cuda)
    for threads in (32, 256):
        got = probes.table_select_probe(tab, idx0, k=PROBE_K, form=form,
                                        threads=threads)
        assert torch.equal(got, probes.table_select_plain(tab, idx0, PROBE_K))


def offset_view(x, words: int):
    """x (contiguous) copied into a larger buffer `words` int32 words in:
    a contiguous view that is not 16-byte aligned where words % 4."""
    flat = torch.zeros(x.numel() + words, dtype=x.dtype, device=x.device)
    flat[words:] = x.reshape(-1)
    return flat[words:].view(x.shape)


@pytest.mark.parametrize("n_nodes", [1 << j for j in range(13)])
def test_shared_node_gather_every_table_size(cuda, n_nodes):
    """The shared node fetch at every table size its launcher takes (each
    layout it picks: 32 word copies up to 128 nodes, 4 record copies up
    to 1,024, the packed table beyond), bit-equal to its plain version at
    32 and 256 threads, on a lane count with a partial last warp, at k
    and 2k, on a 16-byte-aligned table (the bulk copy where its bytes are
    whole 16-byte units: 4 nodes and up) and on a view 4 bytes in (every
    thread copies words); one launch a call."""
    from massivevoxelraytracing_torch.ops import probes

    rng = np.random.default_rng(n_nodes + 1)
    table = torch.as_tensor(rng.integers(0, 1 << 32, (n_nodes, 3), dtype=np.uint64)
                            .astype(np.uint32).view(np.int32), device=cuda)
    idx0 = torch.as_tensor(rng.integers(0, 1 << 20, PROBE_LANES).astype(np.int32),
                           device=cuda)
    probes.reset_counters()
    calls = 0
    for tab in (table, offset_view(table, 1)):
        assert (tab.data_ptr() % 16 == 0) == (tab is table)
        for threads in (32, 256):
            for k in (PROBE_K, 2 * PROBE_K):
                got = probes.node_gather_probe(tab, idx0, k=k, space="shared", threads=threads)
                for a, b in zip(got, probes.node_gather_plain(table, idx0, k)):
                    assert torch.equal(a, b), (threads, k, tab is table)
                calls += 1
    assert probes.LAUNCHES["node_gather_probe"] == calls


def test_shared_select_on_every_staging_path(cuda):
    """The shared select bit-equal to its plain version at 32 and 256
    threads, a partial last warp, k and 2k, on an aligned table (the bulk
    copy) and on a view 4 bytes in (words copied by every thread)."""
    from massivevoxelraytracing_torch.ops import probes

    rng = np.random.default_rng(12)
    tab = torch.as_tensor(rng.integers(0, 1 << 32, (64, 3), dtype=np.uint64)
                          .astype(np.uint32).view(np.int32), device=cuda)
    idx0 = torch.as_tensor(rng.integers(0, 64, PROBE_LANES).astype(np.int32), device=cuda)
    for t in (tab, offset_view(tab, 1)):
        for threads in (32, 256):
            for k in (PROBE_K, 2 * PROBE_K):
                got = probes.table_select_probe(t, idx0, k=k, form="shared", threads=threads)
                assert torch.equal(got, probes.table_select_plain(tab, idx0, k)), (threads, k)


def test_shared_forms_smem_queries_are_the_launch(cuda):
    """The launchers' layouts, as their C query answers them, are the ones
    ops/probes.py mirrors for the wavefront model (gather_layout,
    SELECT_LAYOUT) at every table size; the dynamic shared memory a block
    launches with is the staged table, the packed table where the layout
    has copies (the bulk copy's destination) and the mbarrier, each
    rounded up to 16 bytes, and fits a block's opt-in limit; the largest
    table of each layout launches at 1,024 threads, bit-equal to its
    plain version."""
    import ctypes

    from massivevoxelraytracing_torch.ops import probes
    from massivevoxelraytracing_torch.utils import cuda_build

    def want(n, rec, copies):
        up16 = -(-4 * n * rec * copies // 16) * 16
        return up16 + (0 if copies == 1 else -(-12 * n // 16) * 16) + 16

    lib = cuda_build.load()
    limit = probes.smem_optin_bytes(cuda)
    for j in range(13):
        n = 1 << j
        out = (ctypes.c_int * 2)()
        lib.node_gather_probe_plan(n, out)
        assert tuple(out) == probes.gather_layout(n), n
        assert lib.node_gather_probe_smem_bytes(n) == want(n, *out) <= limit, n
    assert lib.table_select_probe_smem_bytes() == want(64, *probes.SELECT_LAYOUT)
    rng = np.random.default_rng(13)
    for n in (128, 1024, 4096):
        table = torch.as_tensor(rng.integers(0, 1 << 31, (n, 3)).astype(np.int32), device=cuda)
        idx0 = torch.as_tensor(rng.integers(0, n, 2048).astype(np.int32), device=cuda)
        got = probes.node_gather_probe(table, idx0, k=8, space="shared", threads=1024)
        for a, b in zip(got, probes.node_gather_plain(table, idx0, 8)):
            assert torch.equal(a, b), n


def test_shared_node_gather_refuses_tables_past_its_limit(cuda):
    """A table over MAX_NODES nodes or not a power of two is refused
    before any launch: by the wrapper (ValueError) and by the C launcher
    (cudaErrorInvalidValue)."""
    from massivevoxelraytracing_torch.ops import probes
    from massivevoxelraytracing_torch.utils import cuda_build

    idx0 = torch.zeros(64, dtype=torch.int32, device=cuda)
    acc = torch.empty_like(idx0)
    probes.reset_counters()
    for n in (probes.MAX_NODES * 2, 96):
        table = torch.zeros((n, 3), dtype=torch.int32, device=cuda)
        with pytest.raises(ValueError, match="power of two"):
            probes.node_gather_probe(table, idx0, k=8, space="shared")
        assert cuda_build.load().node_gather_probe_launch(
            probes.SPACES.index("shared"), table.data_ptr(), n, idx0.data_ptr(), 64, 8,
            acc.data_ptr(), acc.data_ptr(), 32, None) == 1
    assert probes.LAUNCHES["node_gather_probe"] == 0


@pytest.mark.parametrize("kind", ["chain", "par8"])
def test_calib_probe_matches_plain(cuda, kind):
    from massivevoxelraytracing_torch.ops import probes

    rng = np.random.default_rng(10)
    a, b = (torch.as_tensor(rng.uniform(0.5, 2.0, PROBE_LANES).astype(np.float32),
                            device=cuda) for _ in range(2))
    assert torch.equal(probes.calib_probe(kind, a, b), probes.calib_plain(kind, a, b))


@pytest.mark.parametrize("impl", ["walk", "scan"])
def test_walk_probe_matches_plain(cuda, impl):
    from massivevoxelraytracing_torch.ops import probes
    from massivevoxelraytracing_torch.scripts import hako_kernel_micro as km

    rng = np.random.default_rng(11)
    t1, dc = km.ray_planes(PROBE_LANES, cuda, rng)
    lo, hi = (torch.as_tensor(rng.integers(0, 1 << 32, PROBE_LANES, dtype=np.uint64)
                              .astype(np.uint32).view(np.int32), device=cuda)
              for _ in range(2))
    got = probes.walk_probe(lo, hi, t1, dc, iters=PROBE_K, impl=impl, threads=32)
    assert torch.equal(got, probes.walk_probe_plain(lo, hi, t1, dc, iters=PROBE_K,
                                                    impl=impl))


MIRRORS = [x | y | z for x in (0, 0b001001) for y in (0, 0b010010) for z in (0, 0b100100)]


def walk_inputs(n, rng, device, tie: bool):
    """(lo, hi, vm6, t1, dc) of n walks: the mirrored planes of rays through
    the unit box (ray_preamble), with random masks and each of the 8 mirror
    masks in turn; with `tie`, rays whose planes tie across axes (origins
    on the cell lattice, directions of equal or halved components)."""
    from massivevoxelraytracing_torch.ops import hako_kernels as hk

    if tie:
        ro = rng.integers(-2, 7, (n, 3)) * 0.25 - 0.5
        rd = rng.choice([-1.0, -0.5, 0.5, 1.0], (n, 3))
    else:
        ro = rng.uniform(-1.0, 2.0, (n, 3))
        rd = rng.normal(size=(n, 3))
    ro = torch.as_tensor(ro, dtype=torch.float32)
    rd = torch.as_tensor(rd, dtype=torch.float32)
    _t0, t1, dt, _vm6, _ok = hk._ray_preamble(torch.zeros(3), torch.ones(3), ro, rd)
    vm6 = torch.as_tensor([MIRRORS[i % 8] for i in range(n)], dtype=torch.int32)
    lo, hi = (torch.as_tensor(rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
                              .view(np.int32)) for _ in range(2))
    return [x.contiguous().to(device) for x in (lo, hi, vm6, t1, dt * 0.25)]


@pytest.mark.parametrize("tie", [False, True])
@pytest.mark.parametrize("tq", ["zero", "positive", "negative"])
def test_hopper_walk_equals_walk64(cuda, tie, tq):
    """The Hopper walk returns walk64's (en, ex, c) (hako_device.cuh, through
    the test kernel) on random masks, all 8 mirror masks, t_q at 0, inside
    the node or before it, and rays whose planes tie; the sweep's cell is
    the plain _scan64_impl's on the same walks."""
    from massivevoxelraytracing_torch.ops import probes

    rng = np.random.default_rng(20 + tie)
    n = 20000
    lo, hi, vm6, t1, dc = walk_inputs(n, rng, cuda, tie)
    t_q = {"zero": torch.zeros(n), "negative": torch.full((n,), -1.0),
           "positive": torch.as_tensor(rng.uniform(0.0, 1.5, n), dtype=torch.float32)}[tq]
    t_q = t_q.to(cuda)
    probes.reset_counters()
    want = probes.walk_form(lo, hi, vm6, t1, dc, t_q, form="walk64")
    got = probes.walk_form(lo, hi, vm6, t1, dc, t_q, form="hopper")
    assert int((want[2] < 64).sum()) > n // 50  # the walks hit
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    scan = probes.walk_form(lo, hi, vm6, t1, dc, t_q, form="scan")[2]
    plain = probes.walk_form(*(x.cpu() for x in (lo, hi, vm6, t1, dc, t_q)), form="scan")[2]
    assert torch.equal(scan.cpu(), plain) and torch.equal(scan, want[2])
    torch.cuda.synchronize()
    assert probes.LAUNCHES["walk_form"] == 3


@pytest.mark.parametrize("masks", ["zero", "ones", "random"])
def test_bit_forms_equal_for_every_cell(cuda, masks):
    """bit_at and pc64_below in their Hopper forms == hako_device.cuh's for
    all 64 cells of every mask, and == the plain versions."""
    from massivevoxelraytracing_torch.ops import probes

    rng = np.random.default_rng(22)
    n = 512
    if masks == "random":
        lo, hi = (torch.as_tensor(rng.integers(0, 1 << 32, n, dtype=np.uint64)
                                  .astype(np.uint32).view(np.int32), device=cuda)
                  for _ in range(2))
    else:
        lo = hi = torch.full((n,), 0 if masks == "zero" else -1, dtype=torch.int32, device=cuda)
    got = probes.bit_forms(lo, hi)
    assert torch.equal(got[0], got[1]) and torch.equal(got[2], got[3])
    assert torch.equal(got.cpu(), probes.bit_forms(lo.cpu(), hi.cpu()))


@pytest.mark.parametrize("pair", list(range(37)))
def test_pipe_probe_matches_plain(cuda, pair):
    from massivevoxelraytracing_torch.ops import probes

    a, b = probes.PIPE_PAIRS[pair]
    x0 = probes.pipe_inputs(a, b, PROBE_LANES, np.random.default_rng(23 + pair), cuda)
    probes.reset_counters()
    for k in (8, PROBE_K):
        assert torch.equal(probes.pipe_probe(a, b, x0, k=k, threads=256),
                           probes.pipe_probe_plain(a, b, x0, k)), k
    probes.empty_launch(3, 64, cuda)
    torch.cuda.synchronize()
    assert probes.LAUNCHES["pipe_probe"] == 3


@pytest.mark.parametrize("hopper", [False, True])
def test_walk_count_matches_its_plain_slots(cuda, hopper):
    """The counting variant: each lane's slots == the plain count, the
    passes' active lanes sum to them, the warps ran at least each repeat's
    slowest lane's slots, and its checksum is the walk probe's."""
    from massivevoxelraytracing_torch.ops import probes
    from massivevoxelraytracing_torch.scripts import hako_kernel_micro as km

    rng = np.random.default_rng(24)
    t1, dc = km.ray_planes(PROBE_LANES, cuda, rng)
    lo, hi = km._u32(rng, PROBE_LANES, cuda), km._u32(rng, PROBE_LANES, cuda)
    got = probes.walk_count(lo, hi, t1, dc, iters=PROBE_K, hopper=hopper, threads=64)
    want = probes.walk_count(lo.cpu(), hi.cpu(), t1.cpu(), dc.cpu(), iters=PROBE_K,
                             hopper=hopper)
    assert torch.equal(got["slots"].cpu(), want["slots"])
    assert got["lane_slots"] == want["lane_slots"] and got["passes"] >= want["passes"]
    assert torch.equal(got["out"].cpu(), want["out"])


@pytest.mark.parametrize("threads", [32, 256, 1024])
def test_fetch_probe_matches_plain(cuda, threads):
    """The row-word fetch bit-equal to its plain version at 0, 1, 7 and 64
    repeats, on a lane count that is not a multiple of the block (the
    last block's last warp partial), on a rows view at a 16-byte-aligned
    offset into its storage; one launch a call."""
    from massivevoxelraytracing_torch.ops import probes

    rng = np.random.default_rng(14)
    n_rows = 300
    flat = torch.as_tensor(rng.integers(0, 1 << 32, n_rows * probes.ROW_WORDS + 4,
                                        dtype=np.uint64).astype(np.uint32).view(np.int32),
                           device=cuda)
    rows = flat[4:].view(n_rows, probes.ROW_WORDS)
    assert rows.data_ptr() - flat.data_ptr() == 16 and rows.data_ptr() % 16 == 0
    n = 3 * threads + 45
    row_of = torch.as_tensor(rng.integers(0, n_rows, n).astype(np.int32), device=cuda)
    probes.reset_counters()
    for iters in (0, 1, 7, 64):
        got = probes.fetch_probe(rows, row_of, iters=iters, threads=threads)
        assert torch.equal(got, probes.fetch_probe_plain(rows, row_of, iters=iters)), iters
    torch.cuda.synchronize()
    assert probes.LAUNCHES["fetch_probe"] == 4


@pytest.mark.parametrize("mib, passes", [(1, 0), (1, 3), (8, 2)])
def test_l2_read_probe_matches_plain(cuda, mib, passes):
    """The L2 read probe's sums bit-equal to its plain version over a grid
    that fills the card and over one block with a tail of vectors (1 MiB
    plus 5 vectors); one launch a call."""
    from massivevoxelraytracing_torch.ops import probes

    rng = np.random.default_rng(15)
    n = (mib << 20) // 4 + 20
    buf = torch.as_tensor(rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
                          .view(np.int32), device=cuda)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    probes.reset_counters()
    for blocks, threads in ((sms * 8, 256), (1, 96)):
        got = probes.l2_read_probe(buf, passes=passes, blocks=blocks, threads=threads)
        assert torch.equal(got, probes.l2_read_plain(buf, passes=passes,
                                                     lanes=blocks * threads))
    torch.cuda.synchronize()
    assert probes.LAUNCHES["l2_read_probe"] == 2


def test_fetch_probe_smem_query_is_the_launch(cuda):
    """fetch_probe_smem_bytes is the shared memory the launches take: at
    every block size it fits the opt-in limit and the fetch launches."""
    from massivevoxelraytracing_torch.ops import probes
    from massivevoxelraytracing_torch.utils import cuda_build

    lib = cuda_build.load()
    limit = probes.smem_optin_bytes(cuda)
    rows = torch.zeros((8, probes.ROW_WORDS), dtype=torch.int32, device=cuda)
    for threads in range(32, 1025, 32):
        assert lib.fetch_probe_smem_bytes(threads) <= limit, threads
        row_of = torch.zeros(threads, dtype=torch.int32, device=cuda)
        assert int(probes.fetch_probe(rows, row_of, iters=1, threads=threads).abs().sum()) == 0


# floats of each array one block-step of the shell kernel covers (128
# threads x 8 float4 loads: one float4 of each of 8 arrays, or 8 of one)
SHELL_TILE = {"8 arrays": 512, "1 array": 4096}


@pytest.mark.parametrize("n", ["1", "3", "4", "5", "100", "tile-1", "tile+1", "524288"])
@pytest.mark.parametrize("layout", ["8 arrays", "1 array"])
def test_shell_copy_probe_matches_plain(cuda, layout, n):
    """Both layouts bit-equal to the plain version, into new outputs and
    into given ones, one launch a call: at counts that leave 1-3 floats
    past the last float4, an array shorter than one block (100 floats),
    one float short of and past a block-step's tile, and the shell micro's
    524,288 lanes ([256, 8, 2048] as one array); the 16-byte alignment
    refusal of an input and of an output, before launch."""
    from massivevoxelraytracing_torch.ops import probes

    tile = SHELL_TILE[layout]
    n = {"tile-1": tile - 1, "tile+1": tile + 1}.get(n) or int(n)
    rng = np.random.default_rng(n)
    eight = [torch.as_tensor(rng.uniform(0.5, 2.0, n).astype(np.float32), device=cuda)
             for _ in range(8)]
    if layout == "8 arrays":
        xs = eight
    elif n == 524288:
        xs = [torch.stack([x.reshape(-1, 2048) for x in eight], 1).contiguous()]
    else:
        xs = eight[:1]
    want = probes.shell_copy_plain(*xs)
    probes.reset_counters()
    got = probes.shell_copy_probe(*xs)
    torch.cuda.synchronize()
    assert probes.LAUNCHES["shell_copy_probe"] == 1
    outs = [torch.full_like(x, -1.0) for x in xs]
    assert all(a is b for a, b in zip(probes.shell_copy_probe(*xs, out=outs), outs))
    torch.cuda.synchronize()
    assert probes.LAUNCHES["shell_copy_probe"] == 2
    for a, b, c in zip(got, outs, want):
        assert torch.equal(a, c) and torch.equal(b, c)
    shifted = [torch.cat([x.reshape(-1)] * 2)[1:x.numel() + 1] for x in xs]
    with pytest.raises(ValueError, match="aligned"):
        probes.shell_copy_probe(*shifted)
    with pytest.raises(ValueError, match="aligned"):
        probes.shell_copy_probe(*(x.reshape(-1) for x in xs), out=shifted)
    assert probes.LAUNCHES["shell_copy_probe"] == 2


def probe_rays(rng, n, cuda):
    """Origins around the unit box, directions of every sign, resume keys
    of either sign: 7 f32 [n]."""
    return ([torch.as_tensor(rng.uniform(-0.5, 1.5, n).astype(np.float32), device=cuda)
             for _ in range(3)]
            + [torch.as_tensor(rng.normal(size=n).astype(np.float32), device=cuda)
               for _ in range(3)]
            + [torch.as_tensor(rng.uniform(-0.2, 0.6, n).astype(np.float32), device=cuda)])


def test_preamble_probe_matches_plain(cuda):
    from massivevoxelraytracing_torch.ops import probes

    rays = probe_rays(np.random.default_rng(12), PROBE_LANES, cuda)[:6]
    unit = torch.tensor([0, 0, 0, 1, 1, 1], dtype=torch.float32, device=cuda)
    for a, b in zip(probes.preamble_probe(rays, unit), probes.preamble_plain(rays, unit)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("stage", range(5))
def test_probe_stage_probe_matches_plain(cuda, stage):
    """Dense root masks over an smem-form level of 40 nodes and a taa-form
    level of 300: ranks and child indices run past both."""
    from massivevoxelraytracing_torch.ops import probes

    rng = np.random.default_rng(13)

    def words(n):
        return rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)

    tabs = [torch.as_tensor(np.stack([words(n), words(n), rng.integers(lo, hi, n)
                                      .astype(np.uint32)], 1).view(np.int32), device=cuda)
            for n, lo, hi in ((40, 250, 420), (300, 0, 1 << 20))]
    assert probes.level_forms(tabs) == [("smem", 64), ("taa", 3)]
    root = tuple(int(words(1)[0] | words(1)[0] | words(1)[0]) for _ in range(2))
    rays = probe_rays(rng, 4096 + 17, cuda)
    bounds = torch.tensor([0, 0, 0, 1, 1, 1], dtype=torch.float32, device=cuda)
    for T in ((2, 3) if stage == 4 else (3,)):
        got = probes.probe_stage_probe(stage, rays, bounds, root, tabs, T=T)
        want = probes.probe_stage_plain(stage, rays, bounds, root, tabs, T=T)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    child = got[0].cpu().numpy()
    if stage == 4:
        assert (child >= 300).any() and (got[1] == 64).any() and (got[1] < 64).any()


@pytest.fixture(scope="module")
def earlier_stage():
    """The parent design's stage entry point (commit aca9a3e's source,
    csrc/earlier/, built once for the module)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from massivevoxelraytracing_torch.scripts import issue_ab

    entries, _funcs, _log = issue_ab.build_earlier(issue_ab.EARLIER)
    return entries["probe_stage_probe_launch"]


def equal_or_both_nan(a, b):
    """Equal values, NaN where the other is NaN (a NaN ray's exit planes)."""
    nan = torch.isnan(a) if a.dtype.is_floating_point else torch.zeros_like(a, dtype=bool)
    return torch.equal(nan, torch.isnan(b) if b.dtype.is_floating_point else nan) and \
        torch.equal(a[~nan], b[~nan])


def stage_by_both(stage, rays, bounds, root, tabs, T, earlier):
    """(the kernel's outputs, the parent kernel's, the plain version's)."""
    from massivevoxelraytracing_torch.ops import probes
    from massivevoxelraytracing_torch.scripts.gather_ab import earlier_entries

    got = probes.probe_stage_probe(stage, rays, bounds, root, tabs, T=T)
    with earlier_entries({"probe_stage_probe_launch": earlier}):
        old = probes.probe_stage_probe(stage, rays, bounds, root, tabs, T=T)
    return got, old, probes.probe_stage_plain(stage, rays, bounds, root, tabs, T=T)


@pytest.mark.parametrize("n", [1, 31, 129, 4096 + 17, "waves"])
@pytest.mark.parametrize("stage", range(5))
def test_probe_stage_probe_equals_plain_and_parent(cuda, earlier_stage, stage, n):
    """The streaming stage kernel (one wave of blocks, a grid-stride loop)
    == its plain version and the parent's kernel bit for bit on the card
    tests' dense masks, at lane counts below a warp, past a block, and past
    3 of its waves (each thread then runs 3-4 lanes)."""
    from massivevoxelraytracing_torch.ops import probes
    from massivevoxelraytracing_torch.scripts import stage_ab

    if n == "waves":
        n = 3 * probes.stage_blocks(stage, 1 << 30, cuda) * stage_ab.THREADS + 17
    rays, bounds, root, tabs = stage_ab.hit_inputs(cuda, n, seed=30 + stage)
    probes.reset_counters()
    got, old, want = stage_by_both(stage, rays, bounds, root, tabs, stage_ab.HIT_T,
                                   earlier_stage)
    for g, o, w in zip(got, old, want):
        assert torch.equal(g, w) and torch.equal(o, w)
    assert probes.LAUNCHES["probe_stage_probe"] == 2


def edge_rays(rng, n, cuda):
    """Rays of all 8 mirror masks in turn (the signs of N(0, 1) directions
    set by the lane), some direction components +-0, +-inf or NaN, origins
    around and on the unit box's faces, t_q of either sign."""
    d = np.abs(rng.normal(size=(3, n))).astype(np.float32)
    d *= np.where(np.arange(n)[None, :] >> np.arange(3)[:, None] & 1, -1.0, 1.0)
    for v, share in ((0.0, 0.03), (-0.0, 0.03), (np.inf, 0.01), (-np.inf, 0.01),
                     (np.nan, 0.01)):
        d[rng.random((3, n)) < share] = v
    o = rng.choice([-0.5, 0.0, 0.25, 1.0, 1.5], (3, n)).astype(np.float32)
    o = np.where(rng.random((3, n)) < 0.7, rng.uniform(-0.5, 1.5, (3, n)), o).astype(np.float32)
    tq = rng.uniform(-0.6, 0.6, n).astype(np.float32)
    return [torch.as_tensor(x.copy(), device=cuda) for x in (*o, *d, tq)]


@pytest.mark.parametrize("stage", range(5))
def test_probe_stage_probe_mirrors_clips_and_past_levels(cuda, earlier_stage, stage):
    """All 8 mirror masks, t_q of either sign, +-0 / inf / NaN direction
    components: the kernel == plain == the parent's kernel; the walks that
    find no cell rank cells 64-127 (c ^ vm6, clipped to cell 63's count)
    under every mirror mask, and the child indices run past both levels
    (40 nodes in the smem form, 300 in the taa form)."""
    from massivevoxelraytracing_torch.ops import hako_kernels as hkk
    from massivevoxelraytracing_torch.scripts import stage_ab

    n = 20000
    rng = np.random.default_rng(40 + stage)
    _rays, bounds, root, tabs = stage_ab.hit_inputs(cuda, 1, seed=40 + stage)
    rays = edge_rays(rng, n, cuda)
    got, old, want = stage_by_both(stage, rays, bounds, root, tabs, stage_ab.HIT_T,
                                   earlier_stage)
    for g, o, w in zip(got, old, want):
        assert equal_or_both_nan(g, w) and equal_or_both_nan(o, w)
    ro, rd = torch.stack(rays[:3], 1).cpu(), torch.stack(rays[3:6], 1).cpu()
    vm6 = hkk._ray_preamble(torch.zeros(3), torch.ones(3), ro, rd)[3]
    assert len(set(vm6.tolist())) == 8
    cell = got[1] if stage == 4 else None
    if stage == 4:
        missed = (cell == 64).cpu()
        assert len(set((64 ^ vm6[missed]).tolist())) == 8 and (cell < 64).any()
    if stage >= 2:
        child = got[0]
        assert (child >= 300).any() and (child < 300).any()


def first_round_stages(cuda, monkeypatch, shadow):
    """Kernel B's two stages on a fat tree's first round (supernode rows,
    then brick rows after the handoff): [(args, keywords)]."""
    args, T = case_args(cuda, monkeypatch, 512, 8000, 128)
    bricks, snodes, tabs, root, lower, upper, ro, rd = args
    levels, level_off = hk.level_pack(tabs)
    bounds = torch.cat([lower, upper]).to(torch.float32)
    n = ro.shape[0]
    idx = torch.arange(n, dtype=torch.int32, device=cuda)
    tq = torch.zeros(n, dtype=torch.float32, device=cuda)
    emit, child, bt1, tqe, tqn, _exh = hk.hako_probe(
        levels, level_off, T, root, bounds, ro, rd, idx, tq, max_probes=hk.PROBES)
    kw = dict(shadow=shadow, max_iters=hk.DDA_ITERS)
    s = ((snodes, bounds, ro, rd, idx, emit, child, bt1, tqe),
         dict(dt_factor=0.25 ** T, leaf=False, **kw))
    emit2, child2, bt1_2, tqe2, _tqn = hk.supernode_handoff(
        emit, bt1, tqn, hk.hako_dda_plain(*s[0], **s[1]))
    b = ((bricks, bounds, ro, rd, idx, emit2, child2, bt1_2, tqe2),
         dict(dt_factor=0.25 ** (T + 2), leaf=True, **kw))
    return [s, b]


def partial_tail(a, tail: int = 50):
    """A kernel B stage's lanes cut so that its last 128-lane block holds
    `tail` lanes, none of them a go-lane."""
    rows, bounds, ro, rd, idx, go, child, bt1, tqe = a
    m = (idx.shape[0] // hk.CACHE_BLOCK - 1) * hk.CACHE_BLOCK + tail
    go = go[:m].clone()
    go[m - tail:] = False
    return (rows, bounds, ro, rd, idx[:m], go, child[:m], bt1[:, :m].contiguous(), tqe[:m])


@pytest.mark.parametrize("shadow", [False, True])
@pytest.mark.parametrize("cache", [0, 2, 64, 128])
def test_hako_dda_cached_matches_plain(cuda, monkeypatch, cache, shadow):
    """Supernode and brick rows of a fat tree's first round, and the brick
    rows cut to a last block that is partial and has no go-lanes: the 8
    outputs equal hako_dda_plain's and the stats block_rows_plain's, with
    no row staged (cache 0), lanes past the cache (2), and every distinct
    row of a block staged (64 here, and 128, a block's lanes)."""
    stages = first_round_stages(cuda, monkeypatch, shadow)
    stages.append((partial_tail(stages[1][0]), stages[1][1]))
    hk.reset_counters()
    overflow = 0
    for a, k in stages:
        got, stats = hk.hako_dda_cached(*a, cache=cache, **k)
        for x, y in zip(got, hk.hako_dda_plain(*a, **k)):
            assert torch.equal(x, y)
        assert torch.equal(stats, hk.block_rows_plain(a[5], a[6], cache))
        assert (int(stats[:, 2].sum()) > 0) == (cache > 0)
        overflow += int((stats[:, 0] - stats[:, 2]).sum())
    assert hk.LAUNCHES["hako_dda_cached"] == 3
    assert int(stats[-1, 0]) == 0 and stats.shape[0] == -(-a[4].shape[0] // hk.CACHE_BLOCK)
    assert (overflow > 0) == (cache in (0, 2))


def test_hako_dda_cached_refuses_too_much_shared_memory(cuda, monkeypatch):
    """400 rows of 656 B exceed a block's 227 KB: the launch is refused and
    the wrapper raises (no plain version behind it)."""
    (a, k), _ = first_round_stages(cuda, monkeypatch, False)
    hk.reset_counters()
    with pytest.raises(RuntimeError, match="hako_dda_cached kernel launch failed"):
        hk.hako_dda_cached(*a, cache=400, **k)
    assert hk.LAUNCHES["hako_dda_cached"] == 0


def test_hako_dda_cached_smem_query_is_the_launch(cuda, monkeypatch):
    """hako_dda_cached_smem_bytes is the shared memory a launch asks for:
    the largest cache whose query fits the card's opt-in limit launches
    and is bit-equal to the plain version, one row more is refused."""
    from massivevoxelraytracing_torch.ops import probes
    from massivevoxelraytracing_torch.utils import cuda_build

    lib = cuda_build.load()
    limit = probes.smem_optin_bytes(cuda)
    cache = max(c for c in range(0, 400) if lib.hako_dda_cached_smem_bytes(c) <= limit)
    (a, k), _ = first_round_stages(cuda, monkeypatch, False)
    got, stats = hk.hako_dda_cached(*a, cache=cache, **k)
    for x, y in zip(got, hk.hako_dda_plain(*a, **k)):
        assert torch.equal(x, y)
    assert torch.equal(stats, hk.block_rows_plain(a[5], a[6], cache))
    with pytest.raises(RuntimeError, match="hako_dda_cached kernel launch failed"):
        hk.hako_dda_cached(*a, cache=cache + 1, **k)


# the gather probes (scripts/dyngather_probe2.py, scripts/gather_probe3.py)
# (body, axis, mod, (t shape, bound), (idx shape, bound)): the script's four
# bodies, then two of a0small's tables (no modulus)
TAA_CASES = [body[1:] for body in dg.BODIES] + [
    ("a0_8", 0, 0, ((8, 128), 99), ((16, 128), 8)),
    ("a0_128", 0, 0, ((128, 128), 99), ((16, 128), 128))]


@pytest.mark.parametrize("body,axis,mod,ts,xs,form", [
    (*case, form) for case in TAA_CASES for form in ("shared", "shfl", "global")
    if form != "shfl" or case[1] == 1])
def test_take_along_probe_matches_plain(cuda, body, axis, mod, ts, xs, form):
    """Every form that applies (the shuffle form along rows only) on 3
    tiles of each reference body, tiles 1 and 2 with indices past the
    modulus (the kernel reduces them)."""
    from massivevoxelraytracing_torch.ops import probes

    t, idx = (torch.from_numpy(a).to(cuda) for a in dg.draws((ts, xs), 3))
    if mod:
        idx = idx + mod * torch.arange(3, device=cuda, dtype=torch.int32)[:, None, None]
    probes.reset_counters()
    got = probes.take_along_probe(t, idx, axis=axis, mod=mod, form=form, c_out=128)
    torch.cuda.synchronize()
    assert probes.LAUNCHES["take_along_probe"] == 1
    assert torch.equal(got, probes.take_along_plain(t, idx, axis=axis, mod=mod, c_out=128))


def test_take_along_shared_refuses_a_table_over_the_limit(cuda):
    """a0small's 1024-row table is 512 KB, over a block's opt-in shared
    memory: the shared form refuses it before launch; the L1 form runs."""
    from massivevoxelraytracing_torch.ops import probes

    rng = np.random.default_rng(21)
    t = torch.as_tensor(rng.integers(0, 99, (1, 1024, 128)).astype(np.int32), device=cuda)
    idx = torch.as_tensor(rng.integers(0, 1024, (1, 16, 128)).astype(np.int32), device=cuda)
    probes.reset_counters()
    with pytest.raises(ValueError, match="524288 bytes"):
        probes.take_along_probe(t, idx, axis=0, mod=0, form="shared")
    assert probes.LAUNCHES["take_along_probe"] == 0
    got = probes.take_along_probe(t, idx, axis=0, mod=0, form="global")
    assert torch.equal(got, probes.take_along_plain(t, idx, axis=0, mod=0))


def test_smem_alloc_probe_capacity(cuda):
    """Every size up to the opt-in limit launches and gives 4x; one row
    more is refused with the CUDA error, and the next launch still runs."""
    from massivevoxelraytracing_torch.ops import probes

    limit = probes.smem_optin_bytes(cuda)
    props = torch.cuda.get_device_properties(cuda)
    if hasattr(props, "shared_memory_per_block_optin"):
        assert limit == props.shared_memory_per_block_optin
    rows = limit // 512
    x = torch.as_tensor(np.random.default_rng(22).uniform(0.5, 2.0, (1, 128))
                        .astype(np.float32), device=cuda)
    probes.reset_counters()
    for n in (1, 2, 96, 97, rows):
        assert torch.equal(probes.smem_alloc_probe(x, n), 4 * x)
    with pytest.raises(RuntimeError, match="refused: CUDA error"):
        probes.smem_alloc_probe(x, rows + 1)
    assert torch.equal(probes.smem_alloc_probe(x, 32), probes.smem_alloc_plain(x, 32))
    torch.cuda.synchronize()
    assert probes.LAUNCHES["smem_alloc_probe"] == 6


@pytest.mark.parametrize("mode", ["shared", "global", "mma"])
@pytest.mark.parametrize("n_rows", [32, 128, 1024])
def test_ohg_probe_matches_plain(cuda, mode, n_rows):
    """k = 1 (the mma form), 8 and 32 hops on the reference's draws and on
    1000 lanes (a partial warp and 16-lane group); the mma form against
    the plain one-hot arithmetic, the others against the plain chase."""
    from massivevoxelraytracing_torch.ops import probes
    from massivevoxelraytracing_torch.scripts import gather_probe3 as g3

    tbln, idxn = g3.ohg_inputs(n_rows)
    table = torch.from_numpy(tbln).to(cuda)
    rng = np.random.default_rng(n_rows)
    lanes = [torch.from_numpy(idxn).to(cuda),
             torch.as_tensor(rng.integers(0, n_rows * 128, 1000).astype(np.int32),
                             device=cuda)]
    plain_mode = "mma" if mode == "mma" else "gather"
    if mode == "shared" and n_rows == 1024:
        with pytest.raises(ValueError, match="524288 bytes"):
            probes.ohg_probe(table, lanes[0], k=8, mode=mode)
        return
    for idx in lanes:
        for k in ((1, 8, 32) if mode == "mma" else (8, 32)):
            got = probes.ohg_probe(table, idx, k=k, mode=mode)
            assert torch.equal(got, probes.ohg_plain(table, idx, k, plain_mode))
    assert np.array_equal(got.cpu().numpy(), probes.ohg_plain(
        table.cpu(), lanes[1].cpu(), 32, "gather").numpy())


@pytest.mark.parametrize("batch", [1, 3, 17, 33, 1056])
@pytest.mark.parametrize("R,C,mod", [(128, 128, 128), (16, 128, 16), (128, 128, 0),
                                     (8, 128, 0), (32, 128, 8), (64, 12, 64), (40, 72, 32),
                                     (16, 12, 0), (16, 72, 16), (448, 128, 256)])
def test_take_along_axis0_slices_match_plain(cuda, batch, R, C, mod):
    """The shared axis-0 take-along at batch 1, 3, 17, 33 and 1,056, whose
    slices of a 128-column tile are 8, 8, 16, 32 and 32 columns (or whole
    tiles where the indices reach every sector: the 8- and 16-row tiles
    of the 1,056-tile batch, 4 KB tiles at any batch), mod 0 and powers of two, tiles whose columns are
    no multiple of the slice (12 and 72) and a 448-row tile (224 KB whole,
    within a block's opt-in limit); the sliced kernel also on the tiles
    the wrapper takes whole, through its entry point."""
    from massivevoxelraytracing_torch.ops import probes
    from massivevoxelraytracing_torch.scripts import gather_ab

    if R * C * 4 > probes.smem_optin_bytes(cuda):
        pytest.skip("the tile exceeds this card's opt-in shared memory")
    rng = np.random.default_rng(R * 1000 + C + batch)
    t = torch.as_tensor(rng.integers(0, 1 << 30, (batch, R, C)).astype(np.int32), device=cuda)
    hi = (4 * mod) if mod else R  # indices past the modulus: the kernel reduces them
    idx = torch.as_tensor(rng.integers(0, hi, (batch, 16, C)).astype(np.int32), device=cuda)
    want = probes.take_along_plain(t, idx, axis=0, mod=mod)
    probes.reset_counters()
    assert torch.equal(probes.take_along_probe(t, idx, axis=0, mod=mod, form="shared"), want)
    torch.cuda.synchronize()
    assert probes.LAUNCHES["take_along_probe"] == 1
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    if probes.taa0_whole(R, C, 16, mod, batch, sms):
        sl = probes.taa0_slice(C, batch, sms)
        assert torch.equal(gather_ab.sliced_call(t, idx, mod, sl)(t, idx, None), want)


@pytest.mark.parametrize("n", [1, 15, 17, 2048])
@pytest.mark.parametrize("n_rows", [32, 128, 1024, 2048, 4096])
def test_ohg_mma_clusters_match_plain(cuda, n_rows, n):
    """The tensor-core chase at 1, 15, 17 and 2,048 lanes (a partial
    16-lane group, one lane past it, the reference's lanes), 1 and 9 hops,
    on tables whose byte planes its default cluster splits over 1 (32,
    128 rows), 2, 4 and 8 blocks (1,024-4,096 rows: combined through
    distributed shared memory), bit-equal to the plain one-hot
    arithmetic."""
    from massivevoxelraytracing_torch.ops import probes
    from massivevoxelraytracing_torch.scripts import gather_probe3 as g3

    tbln, _ = g3.ohg_inputs(n_rows)
    table = torch.from_numpy(tbln).to(cuda)
    idx = torch.as_tensor(np.random.default_rng(n).integers(0, n_rows * 128, n)
                          .astype(np.int32), device=cuda)
    assert probes.ohg_cluster(n_rows) == {32: 1, 128: 1, 1024: 2, 2048: 4, 4096: 8}[n_rows]
    for k in (1, 9):
        got = probes.ohg_probe(table, idx, k=k, mode="mma")
        assert torch.equal(got, probes.ohg_plain(table, idx, k, "mma")), k


def test_ohg_mma_refuses_a_table_over_its_clusters_shared_memory(cuda):
    """An 8,192-row table's byte planes are 384 KB a block over the
    largest cluster, 8 blocks: refused before launch; 4,096 rows run."""
    from massivevoxelraytracing_torch.ops import probes

    table = torch.zeros(8192, 128, dtype=torch.int32, device=cuda)
    idx = torch.zeros(16, dtype=torch.int32, device=cuda)
    probes.reset_counters()
    with pytest.raises(ValueError, match="over 8 blocks are 401408 bytes"):
        probes.ohg_probe(table, idx, k=1, mode="mma")
    assert probes.LAUNCHES["ohg_probe"] == 0
    assert torch.equal(probes.ohg_probe(table[:4096], idx, k=1, mode="mma"), idx)


# ---------------------------------------------------------------------------
# the multi-device layer on the card (every mesh entry on the one card)
# ---------------------------------------------------------------------------

def ico_scene(grid_res):
    tri = meshgen.icosphere(2, radius=0.85)
    origin, dps = meshgen.fit_grid(tri, grid_res)
    col = meshgen.vertex_colors_from_position(tri, *meshgen.mesh_bounds(tri))
    emi = np.zeros_like(col)
    emi[: len(emi) // 5] = 0.5
    extent = float(dps) * grid_res
    center = np.asarray(origin) + extent / 2
    cam = camera.Camera.look_at(eye=center + np.array([0.8, 0.5, 1.5]) * extent,
                                target=center)
    return tri, col, emi, dict(origin=origin, dps=dps, grid_res=grid_res), cam


@pytest.mark.parametrize("accel", ["octree", "brick", "hako"])
def test_sharded_build_on_card_equals_build_scene(cuda, accel):
    """2 and 8 shards on the card == build_scene on the card == the CPU's."""
    from massivevoxelraytracing_torch.entry import trees_equal
    from massivevoxelraytracing_torch.parallel import build as pbuild

    tri, col, emi, kw, _cam = ico_scene(32)
    kw.update(accel=accel, chunk_tris=128)
    single = scene.build_scene(tri, col, emi, device=cuda, **kw)
    for n in (2, 8):
        sharded = pbuild.build_scene_sharded(tri, col, emi, n_devices=n,
                                             device=cuda, **kw)
        assert sharded.device == cuda and sharded.build_stats["n_devices"] == n
        assert trees_equal(single, sharded)
    cpu = pbuild.build_scene_sharded(tri, col, emi, n_devices=8, device="cpu", **kw)
    for name in ("n_nodes", "n_voxels"):
        assert getattr(cpu, name) == getattr(single, name)
    assert cpu.build_stats["n_unique"] == single.build_stats["n_unique"]


def test_sharded_frame_on_card_equals_render_frame(cuda):
    """8 bands, one hako_mega launch a band, image and depth bit-equal."""
    from massivevoxelraytracing_torch.models import accel
    from massivevoxelraytracing_torch.parallel import mesh as pmesh
    from massivevoxelraytracing_torch.parallel import render as prender

    tri, col, _emi, kw, cam = ico_scene(64)
    tree = scene.build_scene(tri, col, device=cuda, accel="hako", **kw)
    img1, t1 = raycast.render_frame(tree, cam, 200, 300, device=cuda)
    kind, depth, meta, root = accel.accel_args(tree)
    render = prender.make_sharded_render(pmesh.make_mesh(8, device=cuda),
                                         width=200, height=300, kind=kind,
                                         depth=depth)
    hako_mega.reset_counters()
    img2, t2 = render(meta, root, tree.lower, tree.upper,
                      raycast._color_table(tree),
                      *(torch.as_tensor(np.asarray(v, np.float32), device=cuda)
                        for v in (cam.o, cam.right, cam.up, cam.front)),
                      torch.tensor(np.float32(cam.tan_half_fovy), device=cuda))
    torch.cuda.synchronize()
    assert hako_mega.LAUNCHES == 8
    assert torch.equal(img1, img2) and torch.equal(t1, t2)


def test_sharded_pt_step_on_card(cuda):
    """dp 2 x sp 4 at 2 spp an entry == one pt_sample over the same lanes
    on the card within rtol / atol 2e-5; its count column exact."""
    from massivevoxelraytracing_torch.models import accel
    from massivevoxelraytracing_torch.ops import hdri, sampling
    from massivevoxelraytracing_torch.parallel import mesh as pmesh
    from massivevoxelraytracing_torch.parallel import render as prender
    from massivevoxelraytracing_torch.utils import hdr

    tri, col, _emi, kw, cam = ico_scene(64)
    tree = scene.build_scene(tri, col, device=cuda, accel="hako", **kw)
    env = hdri.load(hdr.procedural_sky(32, 16), scale=1.0, device=cuda)
    pmj = torch.from_numpy(sampling.make_pmj_table(16, 512)).to(cuda)
    kind, depth, meta, root = accel.accel_args(tree)
    width, height, spd = 32, 16, 2
    n = width * height

    def f(v):
        return torch.tensor(np.float32(v), device=cuda)

    head = (meta, root, tree.lower, tree.upper, tree.color, tree.emission, pmj,
            env, *(torch.as_tensor(np.asarray(v, np.float32), device=cuda)
                   for v in (cam.o, cam.right, cam.up, cam.front)),
            f(cam.tan_half_fovy), f(cam.lens_r), f(cam.focus))
    m = pmesh.make_mesh(8, device=cuda)
    step = prender.make_sharded_pt_step(
        m, stack_depth=depth, spp_per_device=spd, width=width, height=height,
        n_pixels=n, has_emission=tree.has_emission, hdri_enabled=True,
        accel_kind=kind)
    hako_mega.reset_counters()
    out = step(*head, torch.zeros((n, 4), device=cuda), 0)
    torch.cuda.synchronize()
    assert hako_mega.LAUNCHES == 8 * 17  # 8 calls: primary + 2 a bounce
    single = pathtracer.pt_sample(
        *head, 0, 0, f(1.0 / width), f(1.0 / height), f(width / height), f(7.5),
        width=width, pix_packet=n, n_spp=4 * spd, accel_kind=kind,
        stack_depth=depth, has_emission=tree.has_emission, hdri_enabled=True,
        extra_implicit=True).reshape(4 * spd, n, 3).sum(0)
    assert bool((out[:, 3] == 4 * spd).all())
    assert torch.allclose(out[:, :3], single, rtol=2e-5, atol=2e-5)


def test_bigscene_on_card_equals_whole_tree(cuda):
    """4 brick-range shards through the round kernels on the card == the
    whole tree (primary, shadow, shading), and == the same on the CPU."""
    from massivevoxelraytracing_torch.parallel import bigscene

    tri, col, _emi, kw, _cam = ico_scene(64)
    tree = scene.build_scene(tri, col, device=cuda, accel="hako", **kw)
    rng = np.random.default_rng(11)
    n = 4096
    extent = float(kw["dps"]) * 64
    center = np.asarray(kw["origin"]) + extent / 2
    ro = np.tile((center + np.array([0.8, 0.5, 1.5]) * extent).astype(np.float32),
                 (n, 1))
    rd = (np.asarray(kw["origin"]) + extent * rng.uniform(0.1, 0.9, (n, 3))
          - ro).astype(np.float32)
    shards = bigscene.shard_hako_tree(tree, 4)
    want = hk.intersect_hako(tree, ro, rd)
    hk.reset_counters()
    got = bigscene.intersect_sharded(shards, ro, rd)
    torch.cuda.synchronize()
    assert min(hk.LAUNCHES[k] for k in hk.ROUTE_KERNELS) >= 4
    for a, b in zip(got[:3], want):
        assert torch.equal(a, b)
    assert len(torch.unique(got[3][want[0] < 1e37])) > 1
    shadow = bigscene.intersect_sharded(shards, ro, rd, shadow=True)[0]
    assert torch.equal(shadow < 1e37,
                       hk.intersect_hako(tree, ro, rd, shadow=True)[0] < 1e37)
    img, t = bigscene.render_rays_sharded(shards, ro, rd, show_color=True)
    img1, t1 = raycast.render_rays(tree, ro, rd, show_color=True)
    assert torch.equal(img, img1) and torch.equal(t, t1)
    cpu = bigscene.intersect_sharded(
        bigscene.shard_hako_tree(tree, 4, devices=["cpu"]), ro, rd)
    for a, b in zip(cpu, got):
        assert torch.equal(a, b.cpu())


def test_morton_codecs_on_card_equal_the_host_codec(cuda):
    """The torch codec and the bit loop on the card (microbench's device
    codecs) equal the host C++ codec bit for bit, and decode inverts."""
    rng = np.random.default_rng(9)
    xyz = [rng.integers(0, 1 << 21, 1 << 16, dtype=np.uint32) for _ in range(3)]
    want = morton.host_encode(*xyz)
    t = [torch.from_numpy(a.astype(np.int64)).to(cuda) for a in xyz]
    for codec in (morton.encode, morton.encode_naive):
        np.testing.assert_array_equal(codec(*t).cpu().numpy(), want)
    code = torch.from_numpy(want).to(cuda)
    for back in (morton.decode(code), morton.decode_naive(code)):
        for b, a in zip(back, xyz):
            np.testing.assert_array_equal(b.cpu().numpy(), a.astype(np.int64))


def test_thin_lens_on_card_equals_cpu(cuda):
    cam = camera.Camera.look_at(eye=(0.9, 0.7, 2.1), target=(0.5, 0.45, 0.5),
                                fovy_deg=40.0, lens_r=0.03, focus=1.7)
    rng = np.random.default_rng(4)
    args = [torch.from_numpy(rng.integers(0, 37, 256)), torch.from_numpy(rng.integers(0, 23, 256)),
            *(torch.from_numpy(rng.random(256).astype(np.float32)) for _ in range(2))]
    lens = [torch.from_numpy(rng.random(256).astype(np.float32)) for _ in range(2)]
    want = camera.shoot_thin_lens(cam, *args, 37, 23, *lens)
    got = camera.shoot_thin_lens(cam, *(a.to(cuda) for a in args), 37, 23,
                                 *(u.to(cuda) for u in lens))
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


# ---------------------------------------------------------------------------
# the path tracer's sample chain (ops/pt_chain.py, csrc/pt_chain.cu)
# ---------------------------------------------------------------------------

MAX_F32 = float(np.finfo(np.float32).max)
CHAIN_STAGES = ("lane_init", "primary_shade", "bounce_sample", "bounce_shade",
                "compact_gather")


def chain_case(rng, R: int, n_vox: int = 300) -> dict:
    """Random per-lane chain state as numpy arrays (shared with the CPU
    tests): a quarter of the lanes missed (t = MAX_F32), voxel indices a
    few past both ends of the tables (clip), u32 streams with 0 and
    2^32 - 1 among them, full-range PCG32 states, axis-aligned hit normals
    and unit NEE directions, tiny pdfs among the positive ones."""
    def unit(n):
        v = rng.normal(size=(n, 3))
        v[: n // 16] = np.eye(3)[rng.integers(0, 3, n // 16)] * rng.choice([-1, 1], (n // 16, 1))
        return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)

    def tvals():
        t = rng.uniform(0.0, 3.0, R).astype(np.float32)
        t[rng.random(R) < 0.25] = MAX_F32
        return t

    def u32s():
        v = rng.integers(0, 1 << 32, R, dtype=np.int64)
        v[:2] = (0, (1 << 32) - 1)
        return v

    t = tvals()
    miss = t >= np.float32(1e37)
    nmaj = np.where(miss, -1, rng.integers(0, 3, R)).astype(np.int32)
    hit_n = np.zeros((R, 3), np.float32)
    axis = rng.integers(0, 3, R)
    hit_n[np.arange(R), axis] = rng.choice([-1.0, 1.0], R)
    hit_n[miss] = 0.0
    return dict(
        ro=rng.uniform(-1.0, 2.0, (R, 3)).astype(np.float32), rd=unit(R), t=t,
        miss=miss, nmaj=nmaj,
        vidx=rng.integers(-3, n_vox + 3, R).astype(np.int32),
        stream=u32s(), spp=u32s(),
        pcg_state=rng.integers(-(1 << 63), (1 << 63) - 1, R, dtype=np.int64),
        pcg_inc=rng.integers(-(1 << 63), (1 << 63) - 1, R, dtype=np.int64) | 1,
        color=rng.integers(-(1 << 31), (1 << 31) - 1, n_vox, dtype=np.int64).astype(np.int32),
        emission=rng.integers(-(1 << 31), (1 << 31) - 1, n_vox,
                              dtype=np.int64).astype(np.int32),
        T=rng.uniform(0.0, 1.0, (R, 3)).astype(np.float32),
        L=rng.uniform(0.0, 4.0, (R, 3)).astype(np.float32),
        refl=rng.uniform(0.0, 1.0, (R, 3)).astype(np.float32), hit_n=hit_n,
        dir_s=unit(R), emissive=rng.uniform(0.0, 8.0, (R, 3)).astype(np.float32),
        pdf=np.where(rng.random(R) < 0.05, 1e-30,
                     rng.uniform(1e-3, 4.0, R)).astype(np.float32),
        t_s=tvals(), t_e=tvals(),
        v_e=rng.integers(-3, n_vox + 3, R).astype(np.int32),
        t_b=tvals(), nm_b=rng.integers(-1, 3, R).astype(np.int32),
        vi_b=rng.integers(-3, n_vox + 3, R).astype(np.int32),
        perm=rng.permutation(R).astype(np.int64), orig=rng.permutation(R).astype(np.int64),
        pmj=rng.random((16, 512, 2), dtype=np.float32),
    )


def chain_cam(device):
    """The thin-lens camera tensors of pt_sample (cam_o ... aspect)."""
    cam = camera.Camera.look_at(eye=(0.9, 0.7, 2.1), target=(0.5, 0.45, 0.5),
                                fovy_deg=40.0, lens_r=0.03, focus=1.7)
    vecs = [torch.as_tensor(np.asarray(v, np.float32), device=device)
            for v in (cam.o, cam.right, cam.up, cam.front)]
    return (*vecs, *(torch.tensor(np.float32(v), device=device) for v in (
        cam.tan_half_fovy, cam.lens_r, cam.focus, 1.0 / 37, 1.0 / 23, 37 / 23)))


def chain_env(device, use_alias=True):
    from massivevoxelraytracing_torch.ops import hdri
    from massivevoxelraytracing_torch.utils import hdr

    return hdri.load(hdr.procedural_sky(32, 16), scale=1.0, use_alias=use_alias,
                     device=device)


def bits_equal(got, want, what: str) -> None:
    """Nested outputs equal bit for bit (floats compared as their bits)."""
    if want is None or got is None:
        assert got is None and want is None, what
        return
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            bits_equal(g, w, f"{what}[{i}]")
        return
    assert same_layout(got, want), what
    if want.dtype == torch.float32:
        got, want = got.view(torch.int32), want.view(torch.int32)
    assert torch.equal(got, want), f"{what}: {int((got != want).sum())} values differ"


def same_layout(a, b) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and a.device == b.device


@pytest.mark.parametrize("pmj,spp_major,perm", [
    (True, True, True), (True, False, True), (True, True, False), (False, True, True),
    (False, False, False)])
def test_lane_init_kernel_matches_plain(cuda, pmj, spp_major, perm):
    """pt_lane_init_kernel == lane_init_plain bit for bit: both lane
    layouts, pix_perm with padding sentinels past the frame (and clipped
    positions), PMJ and PCG32, pix_start / spp_base wrapping past 2^32."""
    from massivevoxelraytracing_torch.ops import pt_chain

    c = chain_case(np.random.default_rng(30), 8)
    pix_packet, n_spp, width = 1024, 4, 37
    pix_perm = None
    if perm:
        p = np.random.default_rng(31).permutation(pix_packet - 64)
        pix_perm = torch.as_tensor(np.concatenate([p, np.full(32, 5000)]),
                                   dtype=torch.int64, device=cuda)  # shorter: clips
    args = (torch.as_tensor(c["pmj"], device=cuda), pix_perm, chain_cam(cuda),
            (1 << 32) - 700, (1 << 32) - 2)
    kw = dict(width=width, pix_packet=pix_packet, n_spp=n_spp, spp_major=spp_major,
              use_pmj=pmj)
    pt_chain.reset_counters()
    got = pt_chain.lane_init(*args, **kw)
    torch.cuda.synchronize()
    assert pt_chain.LAUNCHES["pt_lane_init"] == 1
    bits_equal(got, pt_chain.lane_init_plain(*args, **kw), "lane_init")


def chain_tensors(c, device):
    out = {}
    for k, v in c.items():
        out[k] = torch.as_tensor(v, device=device)
    return out


@pytest.mark.parametrize("hdri_on", [True, False])
def test_primary_shade_kernel_matches_plain(cuda, hdri_on):
    from massivevoxelraytracing_torch.ops import pt_chain

    x = chain_tensors(chain_case(np.random.default_rng(32), 5000), cuda)
    args = (chain_env(cuda), x["emission"], x["rd"], x["t"], x["vidx"])
    pt_chain.reset_counters()
    got = pt_chain.primary_shade(*args, hdri=hdri_on)
    torch.cuda.synchronize()
    assert pt_chain.LAUNCHES["pt_primary_shade"] == 1
    bits_equal(got, pt_chain.primary_shade_plain(*args, hdri=hdri_on), "primary_shade")


@pytest.mark.parametrize("hdri_on,use_alias", [(True, True), (True, False), (False, True)])
@pytest.mark.parametrize("extra", [True, False])
@pytest.mark.parametrize("pmj", [True, False])
def test_bounce_sample_kernel_matches_plain(cuda, hdri_on, use_alias, extra, pmj):
    """Every (HDRI, EXTRA, PMJ) case of pt_bounce_sample_kernel, the HDRI
    through the alias tables or the prefix tables (sats)."""
    from massivevoxelraytracing_torch.ops import pt_chain

    x = chain_tensors(chain_case(np.random.default_rng(33), 5000), cuda)
    pcg = None if pmj else (x["pcg_state"], x["pcg_inc"])
    args = (chain_env(cuda, use_alias), x["color"], x["pmj"], x["vidx"], x["nmaj"], x["ro"],
            x["rd"], x["t"], x["miss"], x["stream"], x["spp"], pcg)
    kw = dict(dim=5, hdri=hdri_on, extra=extra)
    pt_chain.reset_counters()
    got = pt_chain.bounce_sample(*args, **kw)
    torch.cuda.synchronize()
    assert pt_chain.LAUNCHES["pt_bounce_sample"] == 1
    bits_equal(got, pt_chain.bounce_sample_plain(*args, **kw), "bounce_sample")


def edge_skies() -> dict:
    """Skies whose prefix tables tie: black rows and columns, one lit
    texel, all black, and a wide one with a steep distribution."""
    rng = np.random.default_rng(38)
    holes = rng.random((16, 32, 3)).astype(np.float32)
    holes[3:6] = 0.0
    holes[:, 7:11] = 0.0
    one = np.zeros((16, 32, 3), np.float32)
    one[9, 30] = 5.0
    return {"holes": holes, "one_texel": one, "black": np.zeros((8, 8, 3), np.float32),
            "wide": rng.random((5, 300, 3)).astype(np.float32) ** 8}


def step_down_sky() -> np.ndarray:
    """A sky whose prefix tables' columns step down: every third column is
    black over rows 10-49 while its neighbours are lit, so the floors of
    _build_sat_u32 make the masked column prefix fall by one at some rows
    (sats_step_downs counts them; the bench sky has none)."""
    img = (np.random.default_rng(7).random((64, 96, 3)) ** 2).astype(np.float32)
    img[10:50, ::3] = 0.0
    return img


def sats_step_downs(sats: np.ndarray) -> int:
    """Rows y at which a column's masked prefix, (sat[y, X] - sat[y, X -
    1]) & 0xFFFFFFFF, is below the row before's, over all tables and
    columns of an int64 [7, h, w] prefix table."""
    prev = np.concatenate([np.zeros_like(sats[:, :, :1]), sats[:, :, :-1]], 2)
    col = (sats - prev) & 0xFFFFFFFF
    return int((col[:, 1:] < col[:, :-1]).sum())


def sats_case(cuda, img, seed: int, n: int = 5000):
    """The bounce sample's arguments with the sats backend on `img`."""
    from massivevoxelraytracing_torch.ops import hdri

    x = chain_tensors(chain_case(np.random.default_rng(seed), n), cuda)
    env = hdri.load(img, scale=1.0, use_alias=False, device=cuda)
    return (env, x["color"], x["pmj"], x["vidx"], x["nmaj"], x["ro"], x["rd"], x["t"],
            x["miss"], x["stream"], x["spp"], None)


@pytest.mark.parametrize("extra", [True, False])
def test_bounce_sample_sats_kernel_matches_plain_on_step_down_sky(cuda, extra):
    """The kernel replays the plain stage's bisections where a column's
    masked prefix steps down (there the bisection's index is not the
    smallest i with f(i) > b), its last rows staged in shared memory."""
    from massivevoxelraytracing_torch.ops import pt_chain

    args = sats_case(cuda, step_down_sky(), 39, 20000)
    assert sats_step_downs(args[0].sats.cpu().numpy()) > 100
    pt_chain.reset_counters()
    got = pt_chain.bounce_sample(*args, dim=2, hdri=True, extra=extra)
    torch.cuda.synchronize()
    assert pt_chain.LAUNCHES["pt_bounce_sample"] == 1
    bits_equal(got, pt_chain.bounce_sample_plain(*args, dim=2, hdri=True, extra=extra),
               "sats bounce_sample, step-down sky")


@pytest.mark.parametrize("w,h", [(2341, 3), (2400, 2), (2340, 2), (2339, 5), (600, 40),
                                 (293, 9), (292, 9), (100, 1), (50, 2), (3, 129)])
def test_bounce_sample_sats_kernel_global_and_staged_paths(cuda, w, h):
    """Skies on both sides of the staging limit (7 w u32 last-row entries
    over 64 KiB: w > 2340) and of the Y levels staged with them (7 2^levels
    w u32 within 64 KiB: 3 levels up to w = 292, 2 up to 585, 1 up to
    1170, none past; no more than the Y search's steps): the global-memory
    search and the staged one == the plain stage, with lanes spread over
    every table."""
    from massivevoxelraytracing_torch.ops import pt_chain

    img = (np.random.default_rng(w + h).random((h, w, 3)) ** 3).astype(np.float32)
    img[:, w // 3: w // 2] = 0.0
    args = sats_case(cuda, img, 40)
    pt_chain.reset_counters()
    got = pt_chain.bounce_sample(*args, dim=4, hdri=True, extra=True)
    torch.cuda.synchronize()
    assert pt_chain.LAUNCHES["pt_bounce_sample"] == 1
    bits_equal(got, pt_chain.bounce_sample_plain(*args, dim=4, hdri=True, extra=True),
               f"sats bounce_sample, {w}x{h} sky")


@pytest.mark.parametrize("sky", ["holes", "one_texel", "black", "wide"])
def test_bounce_sample_sats_kernel_matches_plain_on_edge_skies(cuda, sky):
    """The sats backend's binary searches in the kernel == the plain
    stage's where prefix values tie (texels of zero weight)."""
    from massivevoxelraytracing_torch.ops import hdri, pt_chain

    x = chain_tensors(chain_case(np.random.default_rng(34), 5000), cuda)
    env = hdri.load(edge_skies()[sky], scale=1.0, use_alias=False, device=cuda)
    args = (env, x["color"], x["pmj"], x["vidx"], x["nmaj"], x["ro"], x["rd"], x["t"],
            x["miss"], x["stream"], x["spp"], None)
    pt_chain.reset_counters()
    got = pt_chain.bounce_sample(*args, dim=2, hdri=True, extra=False)
    torch.cuda.synchronize()
    assert pt_chain.LAUNCHES["pt_bounce_sample"] == 1
    bits_equal(got, pt_chain.bounce_sample_plain(*args, dim=2, hdri=True, extra=False),
               f"sats bounce_sample, {sky} sky")


@pytest.mark.parametrize("hdri_on", [True, False])
@pytest.mark.parametrize("extra", [True, False])
@pytest.mark.parametrize("key", [True, False])
def test_bounce_shade_kernel_matches_plain(cuda, hdri_on, extra, key):
    from massivevoxelraytracing_torch.ops import pt_chain

    x = chain_tensors(chain_case(np.random.default_rng(35), 5000), cuda)
    nee = (x["hit_n"], x["dir_s"], x["emissive"], x["pdf"]) if hdri_on else (None,) * 4
    args = (x["emission"], torch.tensor(np.float32(7.5), device=cuda), x["T"], x["L"],
            x["refl"], *nee, x["miss"], x["nmaj"], x["vidx"], x["rd"],
            x["t_s"] if hdri_on else None, x["t_e"] if extra else None,
            x["v_e"] if extra else None, x["t_b"], x["nm_b"], x["vi_b"])
    kw = dict(inv_extra=2.0 if extra else 1.0, w_depth0=0.5 if extra else 1.0, key=key)
    pt_chain.reset_counters()
    got = pt_chain.bounce_shade(*args, **kw)
    torch.cuda.synchronize()
    assert pt_chain.LAUNCHES["pt_bounce_shade"] == 1
    bits_equal(got, pt_chain.bounce_shade_plain(*args, **kw), "bounce_shade")


def test_compact_gather_kernel_matches_plain(cuda):
    from massivevoxelraytracing_torch.ops import pt_chain

    x = chain_tensors(chain_case(np.random.default_rng(36), 5000), cuda)
    args = [x[k] for k in ("perm", "vidx", "stream", "spp", "orig", "nmaj", "t", "ro",
                           "rd", "T", "L")]
    pt_chain.reset_counters()
    got = pt_chain.compact_gather(*args)
    torch.cuda.synchronize()
    assert pt_chain.LAUNCHES["pt_compact_gather"] == 1
    bits_equal(got, pt_chain.compact_gather_plain(*args), "compact_gather")


def chain_tracer(device, tree, *, bounces, sky, use_pmj=True):
    pt = pathtracer.PathTracer(width=32, height=32, max_bounces=bounces,
                               use_pmj=use_pmj, device=device)
    pt.pmj_table = torch.from_numpy(
        np.random.default_rng(0).random((128, 4096, 2), np.float32))
    pt.setup()
    if sky:
        pt.load_hdri(np.random.default_rng(1).random((16, 32, 3)).astype(np.float32),
                     scale=1.0)
    pt.update_scene(tree)
    return pt


def chain_scene(device, emission: bool):
    tri, col, emi, kw, cam = ico_scene(64)
    return scene.build_scene(tri, col, emi if emission else None, device=device,
                             **kw), cam


def record_chain(monkeypatch):
    """Record every stage call (name, args, kwargs, outputs) of pt_sample."""
    from massivevoxelraytracing_torch.ops import pt_chain

    calls = []
    for name in CHAIN_STAGES:
        def rec(*a, _real=getattr(pt_chain, name), _name=name, **k):
            out = _real(*a, **k)
            calls.append((_name, a, k, out))
            return out
        monkeypatch.setattr(pt_chain, name, rec)
    return calls


def test_chain_kernels_match_plain_on_recorded_inputs(cuda, monkeypatch):
    """Each kernel == its plain stage on the inputs a PT step gives it (a
    16-spp step of a 32x32 frame: 16,384 lanes, so the compaction runs;
    emission on, so the depth-0 implicit ray runs)."""
    from massivevoxelraytracing_torch.ops import pt_chain

    tree, cam = chain_scene(cuda, emission=True)
    assert tree.has_emission
    pt = chain_tracer(cuda, tree, bounces=3, sky=True)
    calls = record_chain(monkeypatch)
    pt.step(cam)
    torch.cuda.synchronize()
    names = [c[0] for c in calls]
    assert names.count("compact_gather") == 2 and names.count("bounce_sample") == 3
    for name, a, k, out in calls:
        bits_equal(out, getattr(pt_chain, name + "_plain")(*a, **k), f"recorded {name}")


@pytest.mark.parametrize("bounces", [2, 8])
@pytest.mark.parametrize("emission,sky", [(True, True), (False, True), (True, False)])
def test_pt_step_kernels_equal_plain_chain(cuda, bounces, emission, sky):
    """A step through the chain's kernels == the same step through its
    plain stages on the card, bit for bit; each kernel of the path ran."""
    from massivevoxelraytracing_torch.ops import pt_chain

    tree, cam = chain_scene(cuda, emission)
    accum = {}
    for chain in (None, "plain"):
        pt = chain_tracer(cuda, tree, bounces=bounces, sky=sky)
        pt_chain.reset_counters()
        pt.step(cam, chain=chain)
        pt.step(cam, chain=chain)
        torch.cuda.synchronize()
        ran = {k for k, v in pt_chain.LAUNCHES.items() if v}
        assert ran == (set(pt_chain.KERNELS) if chain is None else set()), ran
        accum[chain] = pt.accum
    assert bool(torch.isfinite(accum[None]).all()) and float(accum[None][:, :3].sum()) > 0
    bits_equal(accum[None], accum["plain"], "accumulator")


def test_pt_step_kernels_equal_plain_chain_pcg(cuda):
    """use_pmj=False: the PCG32 stream in the kernels (no compaction)."""
    from massivevoxelraytracing_torch.ops import pt_chain

    tree, cam = chain_scene(cuda, emission=True)
    accum = {}
    for chain in (None, "plain"):
        pt = chain_tracer(cuda, tree, bounces=3, sky=True, use_pmj=False)
        pt_chain.reset_counters()
        pt.step(cam, chain=chain)
        torch.cuda.synchronize()
        assert pt_chain.LAUNCHES["pt_compact_gather"] == 0
        assert (pt_chain.LAUNCHES["pt_bounce_sample"] == 3) == (chain is None)
        accum[chain] = pt.accum
    bits_equal(accum[None], accum["plain"], "PCG32 accumulator")


def test_pt_step_kernels_equal_plain_chain_sats(cuda):
    """The sats HDRI backend: a step through the kernels == through the
    plain stages, and every kernel of the path ran."""
    from massivevoxelraytracing_torch.ops import pt_chain

    tree, cam = chain_scene(cuda, emission=True)
    accum = {}
    for chain in (None, "plain"):
        pt = chain_tracer(cuda, tree, bounces=3, sky=True)
        pt.env = dataclasses.replace(pt.env, use_alias=False)
        pt_chain.reset_counters()
        pt.step(cam, chain=chain)
        torch.cuda.synchronize()
        ran = {k for k, v in pt_chain.LAUNCHES.items() if v}
        assert ran == (set(pt_chain.KERNELS) if chain is None else set()), ran
        accum[chain] = pt.accum
    bits_equal(accum[None], accum["plain"], "sats accumulator")


def test_chain_kernel_build_failure_raises(cuda, monkeypatch, tmp_path):
    """A pt_chain.cu that does not compile: the build raises, and so does
    the wrapper (no fallback to the plain stage)."""
    from massivevoxelraytracing_torch.ops import pt_chain
    from massivevoxelraytracing_torch.utils import cuda_build

    src = tmp_path / "csrc"
    src.mkdir()
    (src / "pt_chain.cu").write_text(open(os.path.join(cuda_build.CSRC, "pt_chain.cu")).read()
                                     + "\nthis does not compile;\n")
    monkeypatch.setattr(cuda_build, "CSRC", str(src))
    pt_chain.reset_counters()
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(cuda_build, "LIB_PATH", str(tmp_path / "build" / "lib.so"))
    monkeypatch.setattr(cuda_build, "_lib", None)
    x = chain_tensors(chain_case(np.random.default_rng(37), 64), cuda)
    with pytest.raises(RuntimeError, match="pt_chain.cu"):
        pt_chain.compact_gather(*[x[k] for k in (
            "perm", "vidx", "stream", "spp", "orig", "nmaj", "t", "ro", "rd", "T", "L")])
    assert pt_chain.LAUNCHES["pt_compact_gather"] == 0


def test_chain_nvcc_command_keeps_ieee_floats(cuda):
    """The library on the card was built from pt_chain.cu with
    -fmad=false for sm_90a and no fast-math flag, and exports the chain's
    launchers."""
    from massivevoxelraytracing_torch.utils import cuda_build

    lib = cuda_build.load()
    srcs = cuda_build.sources()
    assert any(s.endswith("pt_chain.cu") for s in srcs)
    compile_cmds, _link = cuda_build.nvcc_commands("nvcc", cuda_build.LIB_PATH, srcs)
    cmd = next(c for c in compile_cmds if c[-1].endswith("pt_chain.cu"))
    assert "-fmad=false" in cmd and "arch=compute_90a,code=sm_90a" in cmd
    for flag in ("use_fast_math", "-ftz=true", "-prec-div=false", "-prec-sqrt=false"):
        assert flag not in " ".join(cmd)
    for name in CHAIN_STAGES:
        assert getattr(lib, f"pt_{name}_launch") is not None


# ---------------------------------------------------------------------------
# the scene build's kernels (ops/voxelize.py, csrc/vox_build.cu)
# ---------------------------------------------------------------------------

VOX_MESHES = {"icosphere": lambda: meshgen.icosphere(3, radius=0.9),
              "bumpy": lambda: meshgen.bumpy_sphere(3, radius=0.9)}


def vox_inputs(tri, grid, device, cap=4, emission=True):
    """test_torch_voxelize's inputs of a mesh: split to cap, on `device`."""
    from massivevoxelraytracing_torch.utils import meshprep

    origin, dps = meshgen.fit_grid(tri, grid)
    col = meshgen.vertex_colors_from_position(tri, *meshgen.mesh_bounds(tri))
    emi = np.zeros_like(col)
    if emission:
        emi[: len(emi) // 5] = 0.5
    arrays = meshprep.split_to_cap(tri, col, emi, origin, dps, grid, cap)
    return ([torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in arrays],
            torch.as_tensor(np.asarray(origin, np.float32), device=device),
            torch.tensor(dps, dtype=torch.float32, device=device))


def vox_stages_equal(tris, origin, dps, grid, six, cap=4, chunk=None):
    """Each build kernel against its plain stage on the same card tensors,
    bit for bit: count, emit into buffers prefilled with a sentinel, and
    the unique reduce in its three modes (the merge on two groups' sums).
    The plain stages run `chunk` triangles at a time (all when None).
    Returns (the kernels' launches, dumped, unique)."""
    from massivevoxelraytracing_torch.ops import voxelize as vox

    t, c, e = tris
    kw = dict(grid_res=grid, six_separating=six, cap=cap)
    T = t.shape[0]
    runs = [(a, min(a + (chunk or T), T)) for a in range(0, T, chunk or max(T, 1))]
    vox.reset_counters()
    counts = vox.count(t, origin, dps, **kw)
    torch.cuda.synchronize()
    assert vox.LAUNCHES["vox_count"] == 1
    want = torch.cat([vox.count_plain(t[a:b], origin, dps, **kw) for a, b in runs])
    assert torch.equal(counts, want)
    end = torch.cumsum(counts, 0, dtype=torch.int64)
    n = int(end[-1])
    dumps = []
    for kernel in (True, False):
        out = (torch.full((n,), -1, dtype=torch.int64, device=t.device),
               torch.full((n,), 7, dtype=torch.int32, device=t.device),
               torch.full((n,), 7, dtype=torch.int32, device=t.device))
        if kernel:
            vox.emit(t, c, e, end - counts, origin, dps, out, **kw)
            torch.cuda.synchronize()
        for a, b in runs if not kernel else ():
            vox.emit_plain(t[a:b], c[a:b], e[a:b], (end - counts)[a:b], origin, dps, out, **kw)
        dumps.append(out)
    assert vox.LAUNCHES["vox_emit"] == 1
    for x, y in zip(*dumps):
        assert torch.equal(x, y)
    code, color, emission = dumps[0]
    assert bool((code >= 0).all())
    s_key, perm = torch.sort(code, stable=True)
    for mode in ("means", "sums"):
        got = vox.unique_reduce(s_key, perm, (color, emission), mode=mode)
        plain = vox.unique_reduce_plain(s_key, perm, (color, emission), mode=mode)
        assert got[1] == plain[1], mode
        for x, y in zip(torch.utils._pytree.tree_leaves(got[0]),
                        torch.utils._pytree.tree_leaves(plain[0])):
            assert torch.equal(x, y), mode
    n_unique = got[1]
    parts = [vox.sort_and_unique_sums(code[sl], color[sl], emission[sl])[0]
             for sl in (slice(0, n // 3), slice(n // 3, n))]
    m_key, m_perm = torch.sort(torch.cat([p[0] for p in parts]), stable=True)
    attrs = (*[torch.cat([p[1][i] for p in parts]) for i in range(6)],
             torch.cat([p[2] for p in parts]))
    got, nu = vox.unique_reduce(m_key, m_perm, attrs, mode="merge")
    plain, nu_plain = vox.unique_reduce_plain(m_key, m_perm, attrs, mode="merge")
    assert nu == nu_plain == n_unique
    for x, y in zip(got, plain):
        assert torch.equal(x, y), "merge"
    # means, sums, two groups, merge: the run heads' count and the reduce each
    assert vox.LAUNCHES["vox_unique_reduce"] == vox.LAUNCHES["vox_run_heads"] == 5
    return dict(vox.LAUNCHES), n, n_unique


@pytest.mark.parametrize("six", [False, True])
@pytest.mark.parametrize("name", list(VOX_MESHES))
def test_vox_kernels_match_plain_on_meshes(cuda, name, six):
    tris, origin, dps = vox_inputs(VOX_MESHES[name](), 64, cuda)
    launches, n, n_unique = vox_stages_equal(tris, origin, dps, 64, six)
    assert n > n_unique > 1000


@pytest.mark.parametrize("six", [False, True])
def test_vox_kernels_match_plain_on_edge_cases(cuda, six):
    """Triangles reaching past the grid (one far enough that the bbox's
    float-to-int casts saturate), padding (zero) triangles, a degenerate
    one, colours that quantize through NaN and inf, and triangles whose
    vertices sit on cell corners (the closest point's 0 / 0)."""
    (t, c, e), origin, dps = vox_inputs(VOX_MESHES["bumpy"](), 64, cuda)
    t, c, e = (torch.cat([x, torch.zeros((6, 3, 3), device=cuda)]) for x in (t, c, e))
    t[0] += 1.5
    t[1] -= 3.0
    t[2] = t[2] * 1e12  # casts saturate
    t[3, 2] = t[3, 0]
    c[4, 0, 0] = float("nan")
    c[5] = float("inf")
    e[6, 1, 2] = float("nan")
    corner = torch.tensor([[0.25, 0.25, 0.25], [0.5, 0.25, 0.25], [0.25, 0.5, 0.25]],
                          device=cuda)
    t[-1] = origin + corner * 64 * dps
    t[-2] = origin + corner[[0, 2, 1]] * 64 * dps
    vox_stages_equal((t.contiguous(), c.contiguous(), e.contiguous()), origin, dps, 64, six)


def test_vox_kernels_match_plain_at_cap_of_the_grid(cuda):
    """voxtriangle's one triangle with cap = the grid (32^3 candidates)."""
    one = torch.tensor([[[-0.5, -0.4, 0.1], [0.58, -0.22, 0.3], [0.0, 0.61, -0.2]]],
                       device=cuda)
    for six in (False, True):
        vox_stages_equal((one, torch.ones_like(one), torch.zeros_like(one)),
                         torch.full((3,), -1.0, device=cuda),
                         torch.tensor(2.0 / 32, device=cuda), 32, six, cap=32)


def test_vox_kernels_match_plain_on_the_lattice_group(cuda):
    """The 1024^3 bench lattice (one group: 33.5M dumped voxels), the plain
    stages a chunk of 262,144 triangles at a time."""
    from massivevoxelraytracing_torch.utils import meshprep

    tri, cols = meshgen.sphere_lattice(6, 4)
    origin = np.zeros(3, np.float32)
    arrays = meshprep.split_to_cap(tri, cols, np.zeros_like(tri), origin, 1.0 / 1024, 1024, 4)
    tris = [torch.from_numpy(a).to(cuda) for a in arrays]
    _, n, n_unique = vox_stages_equal(tris, torch.from_numpy(origin).to(cuda),
                                      torch.tensor(1.0 / 1024, device=cuda), 1024, True,
                                      chunk=262144)
    assert (n, n_unique) == (33_545_375, 13_645_228)


BIG = [[-0.8, -0.7, 0.1], [0.8, -0.25, 0.35], [0.05, 0.85, -0.3]]  # ~25 cells across at 32^3
# tests/test_torch_vox_build.WIDE: one plane whose normal's largest axis is
# z or x, in fractions of the grid; 44 cells deep along it at 64^3, so at
# cap 64 each column is two runs of Z cells with the slab's cells in both
WIDE = ([[0.25, 0.25, 0.923], [0.85, 0.4, 0.255], [0.35, 0.9, 0.331]],
        [[0.923, 0.25, 0.25], [0.255, 0.85, 0.4], [0.331, 0.35, 0.9]])


def vox_mix(device, T, cap, big_at=(), grid=32, wide_at=()):
    """The first T split triangles of the bumpy sphere at grid^3 (cap 4),
    with BIG at the indices `big_at` (at cap 32, ~600 columns each) and
    WIDE[0], WIDE[1] at those of `wide_at`."""
    (t, c, e), origin, dps = vox_inputs(VOX_MESHES["bumpy"](), grid, device)
    t, c, e = (x[:T].clone() for x in (t, c, e))
    for i in big_at:
        t[i] = torch.tensor(BIG, device=device)
    for i, w in zip(wide_at, WIDE):
        t[i] = origin + torch.tensor(w, device=device) * grid * dps
    return (t, c, e), origin, dps


@pytest.mark.parametrize("six", [False, True])
def test_vox_kernels_match_plain_with_several_passes_a_tile(cuda, six):
    """cap 32: two triangles of ~600 columns (BIG) among 298 small ones, so
    one warp's queue takes units of lanes whose walks differ in length by
    hundreds of units, and emits their cells in many rounds of 32; 300
    triangles (the last block partial)."""
    tris, origin, dps = vox_mix(cuda, 300, 32, big_at=(5, 90))
    _, n, _ = vox_stages_equal(tris, origin, dps, 32, six, cap=32, chunk=64)
    assert n > 1000


@pytest.mark.parametrize("six", [False, True])
def test_vox_kernels_match_plain_in_several_z_runs(cuda, six):
    """cap 64 at 64^3: WIDE's columns are two runs of Z cells each (the
    kernels' units past the first run, the emit's positions carried across
    a column's runs), among 98 small triangles; then the emit with gapped
    offsets into buffers cut into WIDE[1]'s run."""
    from massivevoxelraytracing_torch.ops import voxelize as vox

    tris, origin, dps = vox_mix(cuda, 100, 4, grid=64, wide_at=(20, 99))
    kw = dict(grid_res=64, six_separating=six, cap=64)
    ctx, cells = vox.column_cells(tris[0].cpu(), origin.cpu(), dps.cpu(), **kw)
    past = cells["valid"] & (cells["Z"] - ctx["lo_w"][cells["tri"]] >= vox.Z_CELLS)
    assert set(cells["tri"][past].tolist()) == {20, 99}
    vox_stages_equal(tris, origin, dps, 64, six, cap=64, chunk=25)
    vox_emit_gapped_equal(tris, origin, dps, kw, cut=5, seed=64)


@pytest.mark.parametrize("six", [False, True])
@pytest.mark.parametrize("T", [1, 31, 33, 200])
def test_vox_kernels_match_plain_at_odd_triangle_counts(cuda, T, six):
    """T of one, below and above a warp, and not a multiple of a block."""
    tris, origin, dps = vox_mix(cuda, T, 4, big_at=(T // 2,) if T > 1 else ())
    vox_stages_equal(tris, origin, dps, 32, six)


def vox_emit_gapped_equal(tris, origin, dps, kw, cut, seed):
    """Offsets with gaps (0-2 entries after each triangle's run) into
    sentinel-filled buffers, the last `cut` entries cut off (n_out short of
    the last triangle's run): the kernel's buffers == the plain stage's
    (into full-length buffers) up to n_out, the gaps left at the sentinel."""
    from massivevoxelraytracing_torch.ops import voxelize as vox

    t, c, e = tris
    counts = vox.count(t, origin, dps, **kw).long()
    gaps = torch.as_tensor(np.random.default_rng(seed).integers(0, 3, len(counts)),
                           device=t.device)
    end = torch.cumsum(counts + gaps, 0)
    start = end - counts - gaps
    n = int(end[-1])

    def bufs(m):
        return (torch.full((m,), -1, dtype=torch.int64, device=t.device),
                torch.full((m,), 7, dtype=torch.int32, device=t.device),
                torch.full((m,), 7, dtype=torch.int32, device=t.device))

    n_out = n - int(gaps[-1]) - cut
    got = vox.emit(t, c, e, start, origin, dps, bufs(n_out), **kw)
    torch.cuda.synchronize()
    want = vox.emit_plain(t, c, e, start, origin, dps, bufs(n), **kw)
    for x, y in zip(got, want):
        assert torch.equal(x, y[:n_out])
    assert int((got[0] == -1).sum()) == int(gaps[:-1].sum())


@pytest.mark.parametrize("cut", [0, 5])
def test_vox_emit_gapped_offsets_and_truncated_n_out(cuda, cut):
    """vox_emit_gapped_equal at cap 32, BIG last."""
    tris, origin, dps = vox_mix(cuda, 200, 32, big_at=(7, 199))
    vox_emit_gapped_equal(tris, origin, dps, dict(grid_res=32, six_separating=True, cap=32),
                          cut, seed=7)


def test_voxtriangle_on_card_equals_cpu_in_two_z_runs(cuda, tmp_path):
    """voxtriangle at --res 128 (cap 128): its triangle is 33 cells deep
    along its normal's largest axis, so its columns are two runs of Z
    cells; the card's PNG == the CPU's, byte for byte."""
    from massivevoxelraytracing_torch.apps import voxtriangle
    from massivevoxelraytracing_torch.ops import voxelize as vox

    one = torch.tensor([[[-0.62, -0.3, -0.11], [0.58, -0.22, 0.3], [0.0, 0.61, -0.2]]])
    for six in (False, True):
        ctx, cells = vox.column_cells(one, torch.full((3,), -1.0), torch.tensor(2.0 / 128),
                                      grid_res=128, six_separating=six, cap=128)
        assert bool((cells["valid"] & (cells["Z"] - ctx["lo_w"][0] >= vox.Z_CELLS)).any())
    got = {dev: voxtriangle.main(["--res", "128", "--device", dev,
                                  "--out", str(tmp_path / dev)]) for dev in ("cuda", "cpu")}
    assert got["cuda"]["counts"] == got["cpu"]["counts"]
    assert ((tmp_path / "cuda/coverage.png").read_bytes()
            == (tmp_path / "cpu/coverage.png").read_bytes())


# sorted streams for the unique reduce: run lengths (then invalid entries),
# at the edges of tiles of 1,024 and 2,048 entries
UNIQUE_STREAMS = {
    "empty": ([], 0),
    "one": ([1], 0),
    "one_invalid": ([], 1),
    "all_invalid": ([], 5000),
    "each_own_run": ([1] * 4103, 0),
    "one_key": ([3 * 2048 + 100], 0),
    "random_runs_invalid_tail": ("random", 700),
    "head_last_of_a_tile": ([2047, 1, 5, 2041, 1, 1], 0),
    "head_last_of_a_merge_tile": ([1023, 1, 1022, 2, 3], 0),
    "run_longer_than_a_tile": ([10, 2048 + 900, 7, 1], 3),
    "run_over_three_tiles": ([10, 4 * 2048 + 333, 2, 1], 0),
    "run_to_the_end": ([5, 2 * 2048 + 256 * 3], 0),
    "run_to_a_chunk_edge": ([2043, 5 + 256, 7], 0),
    "long_runs": ("long", 37),
}


def unique_stream(name, device, seed):
    """(s_key, perm, (color, emission), merge attrs) of a sorted stream:
    increasing random keys repeated by the run lengths, then INVALID_KEY;
    perm a permutation; random packed words and int64 sums."""
    from massivevoxelraytracing_torch.ops import voxelize as vox

    rng = np.random.default_rng(seed)
    runs, n_invalid = UNIQUE_STREAMS[name]
    if runs == "random":
        runs = list(rng.integers(1, 6, 2500))
    elif runs == "long":
        runs = list(rng.integers(1, 3000, 40))
    keys = np.cumsum(rng.integers(1, 1 << 20, len(runs))).astype(np.int64)
    s_key = np.concatenate([np.repeat(keys, runs).astype(np.int64),
                            np.full(n_invalid, vox.INVALID_KEY, np.int64)])
    n = len(s_key)

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    colors = (t(rng.integers(-2**31, 2**31, n).astype(np.int32)),
              t(rng.integers(-2**31, 2**31, n).astype(np.int32)))
    merge = tuple(t(rng.integers(0, 1 << 40, n).astype(np.int64)) for _ in range(6))
    merge += (t(rng.integers(0, 6, n).astype(np.int64)),)
    return t(s_key), t(rng.permutation(n).astype(np.int64)), colors, merge


@pytest.mark.parametrize("mode", ["means", "sums", "merge"])
@pytest.mark.parametrize("name", list(UNIQUE_STREAMS))
def test_vox_unique_reduce_matches_plain_on_adversarial_streams(cuda, name, mode):
    """The run heads' count and the unique reduce against their plain
    stages bit for bit on sorted streams at and past the tiles' edges
    (runs longer than a tile and than three, a head on a tile's last
    entry, a run to the stream's end or to the edge of the block's chunk
    past a tile, all-invalid and empty streams: no reduce launch); one
    launch of each a call (none of the run heads' count for n = 0)."""
    from massivevoxelraytracing_torch.ops import voxelize as vox
    from massivevoxelraytracing_torch.utils import cuda_build

    assert cuda_build.load().vox_unique_tile() == vox.UNIQUE_TILE
    s_key, perm, colors, merge = unique_stream(name, cuda, seed=len(name))
    attrs = merge if mode == "merge" else colors
    vox.reset_counters()
    heads = vox.run_heads(s_key)
    got, nu = vox.unique_reduce(s_key, perm, attrs, mode=mode)
    torch.cuda.synchronize()
    assert torch.equal(heads, vox.run_heads_plain(s_key))
    want, nu_plain = vox.unique_reduce_plain(s_key, perm, attrs, mode=mode)
    assert nu == nu_plain
    got, want = (torch.utils._pytree.tree_leaves(x) for x in (got, want))
    assert len(got) == len(want)
    for x, y in zip(got, want):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)
    n = len(s_key)
    assert vox.LAUNCHES["vox_run_heads"] == 2 * (n > 0)
    assert vox.LAUNCHES["vox_unique_reduce"] == (nu > 0)


def test_build_scene_vox_kernels_equal_plain_stages(cuda, monkeypatch):
    """build_scene through the kernels and through the plain stages on the
    card: the same tree, single pass and grouped; the kernel route launches
    one count, one emit a group and one run-head count and one reduce a
    group (plus the merge's), the plain route none."""
    from massivevoxelraytracing_torch.entry import trees_equal
    from massivevoxelraytracing_torch.ops import voxelize as vox

    tri, cols = meshgen.sphere_lattice(2, 2)
    kw = dict(origin=np.zeros(3, np.float32), dps=1.0 / 128, grid_res=128, device=cuda,
              chunk_tris=4096)
    trees = {}
    for label, group, stages in (("kernels", None, None), ("plain", None, "plain"),
                                 ("kernels_grouped", 20000, None),
                                 ("plain_grouped", 20000, "plain")):
        if group:
            monkeypatch.setattr(scene, "GROUP_DUMPED", group)
        vox.reset_counters()
        trees[label] = scene.build_scene(tri, cols, stages=stages, **kw)
        n = vox.LAUNCHES
        if stages:
            assert n == dict.fromkeys(vox.KERNELS, 0)
        elif group:
            assert n["vox_count"] == 1 and n["vox_emit"] >= 2
            assert n["vox_unique_reduce"] == n["vox_emit"] + 1  # the groups' and the merge
            assert n["vox_run_heads"] == n["vox_unique_reduce"]
        else:
            assert n == dict.fromkeys(vox.KERNELS, 1)
    assert trees["kernels_grouped"].build_stats["n_dumped"] > 2 * 20000
    for label in ("plain", "kernels_grouped", "plain_grouped"):
        assert trees_equal(trees["kernels"], trees[label]), label


# ---------------------------------------------------------------------------
# the frame's kernels (csrc/frame.cu) and the walk kernels (csrc/walks.cu)
# against their plain versions on the card, bit for bit
# ---------------------------------------------------------------------------

def assert_bits(got, want, what):
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and g.shape == w.shape, f"{what}: output {i}"
        if g.dtype == torch.float32:
            g, w = g.contiguous().view(torch.int32), w.contiguous().view(torch.int32)
        assert torch.equal(g, w), f"{what}: output {i} differs"


def frame_cam():
    center = np.full(3, 0.5, np.float32)
    return camera.Camera.look_at(eye=center + np.array([0.9, 0.4, 1.4], np.float32) * 0.9,
                                 target=center, fovy_deg=40.0)


@pytest.mark.parametrize("width,height,py0,rows", [
    (1920, 1080, 0, 9), (200, 130, 0, 2), (200, 330, 128, 2), (333, 77, 0, 1),
    # widths 1, 127, 128, 129; band_tile_rows 1-9; py0 > 0; partial last tiles
    (1, 1, 0, 1), (127, 300, 0, 3), (128, 128, 0, 1), (129, 1000, 0, 8),
    (1920, 1080, 0, 4), (1920, 1080, 512, 5), (129, 700, 384, 6), (127, 900, 0, 7),
    (1, 2000, 640, 9), (128, 257, 128, 2), (1920, 1079, 896, 2)])
def test_frame_raygen_kernel_matches_plain(cuda, width, height, py0, rows):
    cam = raycast.camera_of(frame_cam())
    raycast.reset_counters()
    got = raycast.gen_rays(cam, py0, width=width, height=height, band_tile_rows=rows,
                           device=cuda)
    assert raycast.LAUNCHES["frame_raygen"] == 1
    want = raycast._gen_rays_band(
        *(torch.from_numpy(v).to(cuda) for v in cam[:4]),
        torch.tensor(cam[4], dtype=torch.float32, device=cuda), py0, width=width,
        height=height, band_tile_rows=rows)
    assert_bits(got, want, f"raygen {width}x{height} py0={py0}")


def test_frame_raygen_refuses_a_band_past_32_bits(cuda):
    """3 n_pad past an int32: refused before anything is allocated or
    launched."""
    cam = raycast.camera_of(frame_cam())
    raycast.reset_counters()
    with pytest.raises(ValueError, match="32-bit"):
        raycast.gen_rays(cam, 0, width=65536, height=65536, band_tile_rows=90, device=cuda)
    assert raycast.LAUNCHES["frame_raygen"] == 0


def card_lanes(n, seed, device):
    rng = np.random.default_rng(seed)
    t = np.where(rng.random(n) < 0.6, rng.uniform(0.01, 3.0, n),
                 np.float32(3.402823466e38)).astype(np.float32)
    rd = rng.normal(size=(n, 3)).astype(np.float32)
    rd[::7, 0] = 0.0
    rd[::11, 1] = -0.0
    rd[::13, 2] = np.nan
    arrays = (rng.integers(-2 ** 31, 2 ** 31, 300).astype(np.int32), rd, t,
              rng.integers(-1, 3, n).astype(np.int32),
              rng.integers(-20, 320, n).astype(np.int32))
    return [torch.from_numpy(a).to(device) for a in arrays]


@pytest.mark.parametrize("show_color", [False, True])
@pytest.mark.parametrize("width,rows,rows_out", [(1920, 9, 1080), (200, 2, 130),
                                                 (333, 1, 128), (None, 1, None)])
def test_frame_shade_kernel_matches_plain(cuda, show_color, width, rows, rows_out):
    n = (-(-width // 128) if width else 2) * 128 * rows * 128
    args = card_lanes(n, rows + show_color, cuda)
    raycast.reset_counters()
    if width:
        got = raycast.shade(*args, show_color=show_color, width=width,
                            band_tile_rows=rows, rows_out=rows_out)
        want = raycast._shade_untile_band(*args, width=width, band_tile_rows=rows,
                                          rows_out=rows_out, show_color=show_color)
    else:
        got = raycast.shade(*args, show_color=show_color)
        want = raycast._shade_flat(*args, show_color=show_color)
    assert raycast.LAUNCHES["frame_shade"] == 1
    assert_bits(got, want, f"shade {width} color={show_color}")


@pytest.mark.parametrize("accel,dag", [("hako", True), ("brick", True), ("octree", True),
                                       ("octree", False)])
def test_render_frame_kernels_equal_plain_route(cuda, accel, dag):
    """render_frame through the frame's kernels (and the walk kernels)
    against stages="plain" (the eager stages and walks) on the card, at a
    width that is not a multiple of 128; render_rays likewise."""
    from massivevoxelraytracing_torch.ops import traverse

    tri, cols = meshgen.sphere_lattice(2, 2)
    tree = scene.build_scene(tri, cols, origin=np.zeros(3, np.float32), dps=1.0 / 128,
                             grid_res=128, accel=accel, dag=dag, device=cuda)
    cam = frame_cam()
    for show_color in (False, True):
        raycast.reset_counters()
        traverse.reset_counters()
        got = raycast.render_frame(tree, cam, 333, 190, show_color, device=cuda)
        assert raycast.LAUNCHES == dict.fromkeys(raycast.KERNELS, 1)
        walks = dict(traverse.LAUNCHES)
        want = raycast.render_frame(tree, cam, 333, 190, show_color, device=cuda,
                                    stages="plain")
        assert raycast.LAUNCHES == dict.fromkeys(raycast.KERNELS, 1)
        assert traverse.LAUNCHES == walks
        if accel != "hako":
            assert walks[f"{'brick' if accel == 'brick' else 'octree'}_walk"] == 1
        assert int((want[1] < 1e37).sum()) > 5000
        assert_bits(got, want, f"{accel} dag={dag} color={show_color}")
    ro, rd = raycast.gen_rays(raycast.camera_of(cam), 0, width=333, height=190,
                              band_tile_rows=2, device=cuda)
    from massivevoxelraytracing_torch.models import accel as accel_lib

    kind, depth, meta, root = accel_lib.accel_args(tree)
    traced = accel_lib.intersect_with(kind, depth, meta, root, tree.lower, tree.upper,
                                      ro, rd, stages="plain")
    assert_bits(raycast.render_rays(tree, ro, rd, True),
                raycast._shade_flat(raycast._color_table(tree), rd, *traced, show_color=True),
                "render_rays")


def walk_rays(codes, grid_res, n, seed, device):
    """Rays aimed at voxels, then mirrored and axis-parallel ones with ±0
    components, rays from inside the box, parked, NaN and inf rays."""
    rng = np.random.default_rng(seed)
    ro = rng.uniform(-1.0, 2.0, (n, 3)).astype(np.float32)
    x, y, z = (v.numpy() for v in morton.decode(
        codes.cpu()[rng.integers(0, codes.shape[0], n)]))
    rd = ((np.stack([x, y, z], -1) + 0.5) / grid_res - ro).astype(np.float32)
    m = n // 8
    rd[:m, 0] = 0.0
    rd[m:2 * m, 1] = -0.0
    rd[2 * m:3 * m, :2] = -0.0
    rd[3 * m:3 * m + 64, :2] = 0.0
    ro[4 * m:5 * m] = rng.uniform(0.0, 1.0, (m, 3)).astype(np.float32)
    ro[5 * m:5 * m + 8] = 1e9
    rd[5 * m + 8] = np.nan
    ro[5 * m + 9, 1] = np.nan
    ro[5 * m + 10] = np.inf
    rd[5 * m + 11] = 0.0
    return torch.from_numpy(ro).to(device), torch.from_numpy(rd).to(device)


def walk_pair(kind):
    from massivevoxelraytracing_torch.ops import bricktree, traverse2

    if kind == "brick":
        return bricktree.intersect_rays_brick, bricktree.intersect_rays_brick_plain, "n_levels"
    return traverse2.intersect_rays2, traverse2.intersect_rays2_plain, "stack_depth"


@pytest.mark.parametrize("max_iters", [1, 7, 100, 100_000])
@pytest.mark.parametrize("shadow", [False, True])
@pytest.mark.parametrize("kind,dag", [("brick", True), ("octree", True), ("octree", False)])
def test_walk_kernels_match_plain(cuda, kind, dag, shadow, max_iters):
    from massivevoxelraytracing_torch.models import accel
    from massivevoxelraytracing_torch.ops import traverse

    codes, _ro, _rd = structure_case(256, 20000)
    tree = build_structure(kind, codes, 256, cuda, dag)
    ro, rd = walk_rays(codes, 256, 8192, 256 + max_iters, cuda)
    _kind, depth, meta, root = accel.accel_args(tree)
    kernel, plain, key = walk_pair(kind)
    traverse.reset_counters()
    got = kernel(meta, root, tree.lower, tree.upper, ro, rd, shadow=shadow,
                 max_iters=max_iters, **{key: depth})
    assert sum(traverse.LAUNCHES.values()) == 1
    want = plain(meta, root, tree.lower, tree.upper, ro, rd, shadow=shadow,
                 max_iters=max_iters, **{key: depth})
    assert_bits(got, want, f"{kind} dag={dag} shadow={shadow} max_iters={max_iters}")
    if max_iters == 100_000:
        assert int((want[0] < 1e37).sum()) > 2000


@pytest.mark.parametrize("kind", ["brick", "octree"])
def test_walk_kernels_match_plain_on_a_shallow_stack(cuda, kind):
    """A stack shallower than the walk needs: pushes past it write nothing
    and pops there read 0, in both versions."""
    from massivevoxelraytracing_torch.models import accel

    codes, _ro, _rd = structure_case(256, 20000)
    tree = build_structure(kind, codes, 256, cuda)
    ro, rd = walk_rays(codes, 256, 4096, 9, cuda)
    _kind, _depth, meta, root = accel.accel_args(tree)
    kernel, plain, key = walk_pair(kind)
    for depth in (1, 2, 3):
        assert_bits(kernel(meta, root, tree.lower, tree.upper, ro, rd, **{key: depth}),
                    plain(meta, root, tree.lower, tree.upper, ro, rd, **{key: depth}),
                    f"{kind} stack {depth}")


def test_walk_kernels_refuse_a_deep_stack_before_launch(cuda):
    from massivevoxelraytracing_torch.models import accel
    from massivevoxelraytracing_torch.ops import traverse

    codes, ro, rd = structure_case(64, 2000, 64)
    ro, rd = torch.from_numpy(ro).to(cuda), torch.from_numpy(rd).to(cuda)
    traverse.reset_counters()
    for kind in ("brick", "octree"):
        tree = build_structure(kind, codes, 64, cuda)
        _kind, _depth, meta, root = accel.accel_args(tree)
        kernel, _plain, key = walk_pair(kind)
        with pytest.raises(ValueError, match="stack depth"):
            kernel(meta, root, tree.lower, tree.upper, ro, rd, **{key: 17})
    assert traverse.LAUNCHES == dict.fromkeys(traverse.WALK_KERNELS, 0)


def full_grid_codes(grid_res, lo=(0, 0, 0), size=None):
    g = torch.arange(grid_res if size is None else size)
    x, y, z = torch.meshgrid(g, g, g, indexing="ij")
    return morton.encode(x.reshape(-1) + lo[0], y.reshape(-1) + lo[1],
                         z.reshape(-1) + lo[2]).unique()


CELL_DIRS = np.array([[1, 0, 0], [0, -1, 0], [0, 0, 1], [1, 1, 0], [-1, 0, 1], [0, 1, -1],
                      [1, 1, 1], [-1, 1, -1], [-1, -1, -1]], np.float32)


def cell_rays(codes, grid_res, n, seed, device):
    """Rays for the brick walk's cell selection: aimed at voxels; origins
    on the cell-plane lattice with directions along the axes, the face
    diagonals and (1, 1, 1) (both signs); origins inside a voxel and on
    its face; ±0 components; NaN, inf and parked rays."""
    rng = np.random.default_rng(seed)
    ro = rng.uniform(-1.0, 2.0, (n, 3)).astype(np.float32)
    x, y, z = (v.numpy() for v in morton.decode(codes.cpu()[rng.integers(0, codes.shape[0], n)]))
    vox = np.stack([x, y, z], -1).astype(np.float32)
    rd = ((vox + 0.5) / grid_res - ro).astype(np.float32)
    m = n // 8
    ro[:2 * m] = (rng.integers(0, grid_res + 1, (2 * m, 3)) / grid_res).astype(np.float32)
    ro[m:2 * m] = ro[m:2 * m] * np.float32(0.5) + np.float32(0.25)
    rd[:2 * m] = CELL_DIRS[rng.integers(0, len(CELL_DIRS), 2 * m)]
    ro[2 * m:3 * m] = ((vox[2 * m:3 * m] + 0.375) / grid_res).astype(np.float32)
    face = vox[3 * m:4 * m] + 0.5
    face[np.arange(m), rng.integers(0, 3, m)] -= 0.5
    ro[3 * m:4 * m] = (face / grid_res).astype(np.float32)
    rd[4 * m:5 * m, 0] = -0.0
    rd[5 * m:5 * m + m // 2, 1:] = 0.0
    rd[5 * m + m // 2:6 * m, :2] = -0.0
    k = 6 * m
    ro[k:k + 8] = 1e9
    rd[k + 8:k + 12] = np.nan
    ro[k + 12, 1] = np.nan
    ro[k + 13] = np.inf
    rd[k + 14] = np.inf
    rd[k + 15, 2] = -np.inf
    rd[k + 16] = 0.0
    return torch.from_numpy(ro).to(device), torch.from_numpy(rd).to(device)


@pytest.mark.parametrize("max_iters", [1, 7, 100, 100_000])
@pytest.mark.parametrize("shadow", [False, True])
@pytest.mark.parametrize("case", ["full grid", "solid cube", "sparse"])
def test_brick_walk_kernel_cells_match_plain(cuda, case, shadow, max_iters):
    """brick_walk_kernel's crossed-cell selection against the plain walk,
    bit for bit: a full grid (every node full), a solid cube inside an
    empty box and a sparse tree, on rays that lie in cell planes, run
    along axes and diagonals, start inside or on a voxel, or hold ±0, NaN
    and inf; max_iters cuts the same lanes."""
    from massivevoxelraytracing_torch.ops import bricktree, traverse

    grid = 64 if case == "full grid" else 256
    if case == "full grid":
        codes = full_grid_codes(grid)
    elif case == "solid cube":
        codes = full_grid_codes(grid, lo=(37, 64, 100), size=48)
    else:
        codes = structure_case(grid, 20000)[0]
    tree = build_structure("brick", codes, grid, cuda)
    ro, rd = cell_rays(codes, grid, 8192, grid + max_iters, cuda)
    args = (tree.meta, tree.root, tree.lower, tree.upper, ro, rd)
    traverse.reset_counters()
    got = bricktree.intersect_rays_brick(*args, n_levels=tree.n_levels, shadow=shadow,
                                         max_iters=max_iters)
    assert traverse.LAUNCHES["brick_walk"] == 1
    want = bricktree.intersect_rays_brick_plain(*args, n_levels=tree.n_levels, shadow=shadow,
                                                max_iters=max_iters)
    assert_bits(got, want, f"{case} shadow={shadow} max_iters={max_iters}")
    if max_iters == 100_000:
        assert int((want[0] < 1e37).sum()) > 1000


@pytest.mark.parametrize("case", ["full grid", "sparse"])
def test_brick_walk_kernel_cells_match_plain_on_a_shallow_stack(cuda, case):
    """The carried candidates on the stack: pushes past a shallow stack
    write nothing and pops there read 0, as in the plain walk."""
    from massivevoxelraytracing_torch.ops import bricktree

    grid = 64 if case == "full grid" else 256
    codes = full_grid_codes(grid) if case == "full grid" else structure_case(grid, 20000)[0]
    tree = build_structure("brick", codes, grid, cuda)
    ro, rd = cell_rays(codes, grid, 4096, 17, cuda)
    args = (tree.meta, tree.root, tree.lower, tree.upper, ro, rd)
    for depth in (1, 2, 3):
        assert_bits(bricktree.intersect_rays_brick(*args, n_levels=depth),
                    bricktree.intersect_rays_brick_plain(*args, n_levels=depth),
                    f"{case} stack {depth}")


def octree_case(case, dag, device):
    """A solid cube inside an empty 256^3 box (dense: most children have
    candidates) or a sparse tree, DAG on or off."""
    if case == "solid cube":
        codes = full_grid_codes(256, lo=(37, 64, 100), size=48)
    else:
        codes = structure_case(256, 20000)[0]
    return codes, build_structure("octree", codes, 256, device, dag)


def octree_rays(codes, n, seed, device):
    """cell_rays, with the last eighth aimed from far away (10^3 to 10^6
    boxes), where deep planes round together."""
    ro, rd = (x.cpu().numpy() for x in cell_rays(codes, 256, n, seed, device))
    rng = np.random.default_rng(seed + 1)
    m = n // 8
    u = rng.normal(size=(m, 3))
    far = (0.5 + u / np.linalg.norm(u, axis=1, keepdims=True)
           * 10.0 ** rng.uniform(3, 6, (m, 1))).astype(np.float32)
    ro[n - m:] = far
    rd[n - m:] = (rd[n - m:] + ro[n - m:] - far).astype(np.float32)  # the same targets
    return torch.from_numpy(ro).to(device), torch.from_numpy(rd).to(device)


@pytest.mark.parametrize("max_iters", [1, 2, 3, 7, 100, 100_000])
@pytest.mark.parametrize("shadow", [False, True])
@pytest.mark.parametrize("dag", [True, False])
@pytest.mark.parametrize("case", ["solid cube", "sparse"])
def test_octree_walk_kernel_fold_matches_plain(cuda, case, dag, shadow, max_iters):
    """octree_walk_kernel's candidate masks, look-ahead and fold against
    the plain v2 walk, bit for bit: on rays from the octant-plane lattice
    along the axes, the face diagonals and (1, 1, 1), from inside a leaf
    voxel and on its face, from far away, with ±0, NaN, inf and parked
    rays; max_iters
    cuts the same lanes, also where a cut falls inside a folded trip."""
    from massivevoxelraytracing_torch.models import accel
    from massivevoxelraytracing_torch.ops import traverse, traverse2

    codes, tree = octree_case(case, dag, cuda)
    ro, rd = octree_rays(codes, 8192, 1000 + max_iters, cuda)
    _kind, depth, meta, root = accel.accel_args(tree)
    args = (meta, root, tree.lower, tree.upper, ro, rd)
    kw = dict(stack_depth=depth, shadow=shadow, max_iters=max_iters)
    traverse.reset_counters()
    got = traverse2.intersect_rays2(*args, **kw)
    assert traverse.LAUNCHES["octree_walk"] == 1
    want = traverse2.intersect_rays2_plain(*args, **kw)
    assert_bits(got, want, f"{case} dag={dag} shadow={shadow} max_iters={max_iters}")
    if max_iters == 100_000:
        assert int((want[0] < 1e37).sum()) > 1000


@pytest.mark.parametrize("dag", [True, False])
@pytest.mark.parametrize("case", ["solid cube", "sparse"])
def test_octree_walk_kernel_fold_matches_plain_on_a_shallow_stack(cuda, case, dag):
    """Stacks of 1, 2 and 3: a rejected child's push and pop cancel only
    inside the stack; past it the kernel takes the plain walk's sequence
    (a push that writes nothing, a pop that reads 0)."""
    from massivevoxelraytracing_torch.ops import traverse, traverse2

    codes, tree = octree_case(case, dag, cuda)
    ro, rd = octree_rays(codes, 4096, 19, cuda)
    meta, root = traverse2.tree_meta(tree), traverse.root_entry_of(tree)
    for depth in (1, 2, 3):
        for shadow in (False, True):
            kw = dict(stack_depth=depth, shadow=shadow)
            assert_bits(traverse2.intersect_rays2(meta, root, tree.lower, tree.upper, ro, rd,
                                                  **kw),
                        traverse2.intersect_rays2_plain(meta, root, tree.lower, tree.upper, ro,
                                                        rd, **kw),
                        f"{case} dag={dag} stack {depth} shadow={shadow}")


@pytest.mark.parametrize("accel_kind", ["brick", "octree"])
def test_pt_step_walk_kernels_equal_plain_walks(cuda, monkeypatch, accel_kind):
    """A PT step through the walk kernels (primary, BSDF and NEE shadow
    rays) against the same step through the plain walks: accumulators
    bit for bit."""
    from massivevoxelraytracing_torch.models import accel
    from massivevoxelraytracing_torch.ops import traverse
    from massivevoxelraytracing_torch.utils import hdr

    tri, cols = meshgen.sphere_lattice(2, 2)
    tree = scene.build_scene(tri, cols, origin=np.zeros(3, np.float32), dps=1.0 / 128,
                             grid_res=128, accel=accel_kind, device=cuda)
    accums = []
    for route in (None, "plain"):
        if route == "plain":
            real = accel.intersect_with
            monkeypatch.setattr(accel, "intersect_with",
                                lambda *a, **k: real(*a, **{**k, "stages": "plain"}))
        traverse.reset_counters()
        pt = pathtracer.PathTracer(width=96, height=64, device=cuda)
        pt.setup()
        env = hdr.procedural_sky(64, 32)
        pt.load_hdri(env, env)
        pt.update_scene(tree)
        pt.step(frame_cam())
        launched = sum(traverse.LAUNCHES.values())
        assert (launched > 8) if route is None else launched == 0
        accums.append(pt.accum)
    assert_bits(accums[:1], accums[1:], f"PT step through {accel_kind}")
    assert float(accums[0][:, :3].mean()) > 0
