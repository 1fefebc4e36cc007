"""The port's path tracer (models/pathtracer.py) against itself on the
CPU: compaction on/off, the lane layouts on a ragged frame, the two
traversal routes, the PCG fallback, checkpoints, and where its state
lives.

Compaction and the layouts are pure lane permutations (one stable sort
and its inverse; the order of pixels and samples in the lanes), and both
traversal routes share every per-lane function, so each is exact.
"""

import numpy as np
import pytest
import torch

from massivevoxelraytracing_tpu.ops import sampling as jsampling
from massivevoxelraytracing_torch.models import pathtracer, scene
from massivevoxelraytracing_torch.ops import camera

from test_torch_pathtracer import parallel_scene

# The tensors here are small: one intra-op thread keeps the test runner's
# parallel workers from oversubscribing the cores.
torch.set_num_threads(1)

F32 = np.float32


def small_tree():
    tri, col, origin, dps, eye, center, sky = parallel_scene(grid_res=32)
    tree = scene.build_scene(tri, col, np.where(col > 0.8, 0.4, 0.0).astype(F32),
                             origin=origin, dps=dps, grid_res=32, device="cpu")
    assert tree.has_emission
    return tree, camera.Camera.look_at(eye=eye, target=center), sky


@pytest.fixture(scope="module")
def small():
    return small_tree()


def run_pt(tree, cam, sky, width, height, n_spp=2, steps=1, **kw):
    pt = pathtracer.PathTracer(width=width, height=height, packet=1024,
                               device="cpu", **kw)
    pt.pmj_table = torch.from_numpy(jsampling.make_pmj_table(128, 512))
    pt.setup()
    pt.load_hdri(sky, scale=1.0)
    pt.update_scene(tree)
    for _ in range(steps):
        pt.step(cam, n_spp=n_spp)
    return pt


def test_compaction_is_bit_identical(small, monkeypatch):
    """The inter-bounce compaction is a pure lane permutation (one stable
    sort and its inverse): radiance equal bit for bit with it off."""
    tree, cam, sky = small
    monkeypatch.setattr(pathtracer, "COMPACT_MIN_LANES", 1)
    on = run_pt(tree, cam, sky, 32, 24, n_spp=4).accum.numpy()
    off = run_pt(tree, cam, sky, 32, 24, n_spp=4, compact=False).accum.numpy()
    assert (on[:, :3] > 0).mean() > 0.5
    np.testing.assert_array_equal(on, off)




@pytest.fixture(scope="module")
def ragged_default(small):
    tree, cam, sky = small
    return run_pt(tree, cam, sky, 37, 29, max_bounces=3).accum.numpy()


@pytest.mark.parametrize("tile_packets,spp_major",
                         [(False, False), (False, True), (True, False)])
def test_lane_layouts_are_bit_identical(small, ragged_default, tile_packets,
                                        spp_major):
    """tile_packets and spp_major on and off, on a ragged 37x29 frame
    (1073 pixels: two packets of 1024, tiles cut at the frame's edges),
    against the default layout (both on)."""
    tree, cam, sky = small
    got = run_pt(tree, cam, sky, 37, 29, max_bounces=3, tile_packets=tile_packets,
                 spp_major=spp_major).accum.numpy()
    assert (got[:, :3] > 0).mean() > 0.5
    np.testing.assert_array_equal(got, ragged_default)


def test_rounds_traversal_equals_mega(small):
    """A step through the round driver equals the megakernel route's, bit
    for bit (the same per-lane functions in another order)."""
    tree, cam, sky = small
    mega = run_pt(tree, cam, sky, 32, 24, max_bounces=3).accum.numpy()
    rounds = run_pt(tree, cam, sky, 32, 24, max_bounces=3,
                    traversal="rounds").accum.numpy()
    np.testing.assert_array_equal(rounds, mega)


def test_pcg_fallback_is_deterministic_and_finite(small):
    """use_pmj=False draws the sample dimensions from per-(pixel, spp)
    PCG32 streams: finite, lit, repeatable, and not the PMJ image."""
    tree, cam, sky = small
    a = run_pt(tree, cam, sky, 32, 24, max_bounces=2, use_pmj=False).accum.numpy()
    b = run_pt(tree, cam, sky, 32, 24, max_bounces=2, use_pmj=False).accum.numpy()
    pmj = run_pt(tree, cam, sky, 32, 24, max_bounces=2).accum.numpy()
    np.testing.assert_array_equal(a, b)
    assert np.isfinite(a).all() and (a[:, :3] > 0).mean() > 0.5
    assert not np.array_equal(a, pmj)
    assert abs(a[:, :3].mean() / pmj[:, :3].mean() - 1) < 0.1


def test_checkpoint_round_trip(small, tmp_path):
    tree, cam, sky = small
    pt = run_pt(tree, cam, sky, 32, 24, max_bounces=1, steps=2)
    path = str(tmp_path / "ckpt")  # np.savez appends .npz
    pt.save_checkpoint(path, frame=7)
    fresh = pathtracer.PathTracer(width=32, height=24, device="cpu")
    assert fresh.load_checkpoint(path) == 7
    assert (fresh.steps, fresh.spp_done) == (2, 4)
    np.testing.assert_array_equal(fresh.accum.numpy(), pt.accum.numpy())
    np.testing.assert_array_equal(fresh.accum.numpy()[:, 3], 4.0)
    with pytest.raises(ValueError):
        pathtracer.PathTracer(width=24, height=32, device="cpu").load_checkpoint(path)
    # the next step continues the sample sequence
    pt.step(cam, n_spp=2)
    fresh.pmj_table, fresh.env = pt.pmj_table, pt.env
    fresh.max_bounces = pt.max_bounces
    fresh.update_scene(tree)
    fresh.accum = torch.from_numpy(np.load(path + ".npz")["accum"])
    fresh.step(cam, n_spp=2)
    np.testing.assert_array_equal(fresh.accum.numpy(), pt.accum.numpy())


def test_state_lives_on_the_trees_device(small):
    tree, cam, sky = small
    pt = pathtracer.PathTracer(width=8, height=8)
    assert pt.device == "cuda"  # the card unless the caller asks for the CPU
    pt.pmj_table = torch.zeros((128, 4096, 2))
    pt.update_scene(tree)
    assert pt.device == torch.device("cpu")
    assert pt.pmj_table.device == torch.device("cpu")
    with pytest.raises(RuntimeError):
        pathtracer.PathTracer(width=8, height=8, device="cpu").step(cam)
