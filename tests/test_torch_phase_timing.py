"""scripts/hako_phase_timing.py on the CPU (plain versions) at 32^3 and
64x64 pixels: its rays equal the JAX package's script's numpy formula on
the JAX package's tile order; each phase's outputs equal those of the
round driver's first round (run with its plain kernels) on the same
lanes; its full frame equals intersect_rays_hako_plain; and without a
card it refuses to run unless given --device cpu."""

import numpy as np
import pytest
import torch

from massivevoxelraytracing_tpu.models import raycast as jraycast
from massivevoxelraytracing_tpu.ops import camera as jcamera
from massivevoxelraytracing_tpu.utils import meshgen as jmeshgen
from massivevoxelraytracing_torch.ops import hako
from massivevoxelraytracing_torch.ops import hako_kernels as hk
from massivevoxelraytracing_torch.ops import hako_mega
from massivevoxelraytracing_torch.scripts import hako_phase_timing as pt

# The tensors here are small: one intra-op thread keeps the test runner's
# parallel workers from oversubscribing the cores.
torch.set_num_threads(1)

ARGV = ["--device", "cpu", "--res", "32", "--width", "64", "--height", "64"]


def test_rays_equal_the_reference_scripts_formula():
    """scripts/hako_phase_timing.py:50-70 with the JAX package's camera and
    tile order (its packet: the renderer's for 64 x 64 = 4,096 rays)."""
    grid_res, width, height = 32, 64, 48
    tri = jmeshgen.bumpy_sphere(5, radius=0.9)
    origin, dps = jmeshgen.fit_grid(tri, grid_res)
    lo = np.asarray(origin)
    extent = float(dps) * grid_res
    center = lo + extent / 2
    cam = jcamera.Camera.look_at(eye=center + np.array([0.9, 0.4, 1.4]) * extent * 0.9,
                                 target=center, fovy_deg=40.0)
    order_pad, _ = jraycast._cached_order(width, height, 8192)
    idx = np.asarray(order_pad)
    live = idx >= 0
    safe = np.maximum(idx, 0)
    px = (safe % width).astype(np.float32)
    py = (safe // width).astype(np.float32)
    th = cam.tan_half_fovy
    u = (-th + 2.0 * th * (px + 0.5) / width) * (width / height)
    v = th - 2.0 * th * (py + 0.5) / height
    rd = (u[:, None] * np.asarray(cam.right) + v[:, None] * np.asarray(cam.up)
          + np.asarray(cam.front)).astype(np.float32)
    ro = np.where(live[:, None], np.asarray(cam.o)[None, :], 1e9).astype(np.float32)
    _tree, pcam = pt.bumpy_scene(grid_res, "cpu")
    got = pt.frame_rays(pcam, width, height)
    np.testing.assert_array_equal(got[0], ro)
    np.testing.assert_array_equal(got[1], rd)
    assert pt.packet_for(1920 * 1088) == jraycast.MAX_RAY_PACKET


class FirstRound:
    """The plain round kernels, recording the first round's outputs."""

    def __init__(self):
        self.out = {}

    def probe(self, *a, **k):
        got = hk.hako_probe_plain(*a, **k)
        self.out.setdefault("hako_probe", got)
        return got

    def dda(self, *a, **k):
        got = hk.hako_dda_plain(*a, **k)
        self.out.setdefault("hako_dda leaf" if k["leaf"] else "hako_dda supernodes", got)
        return got

    def merge(self, state, *a):
        hk.hako_merge_plain(state, *a)
        self.out.setdefault("hako_merge", tuple(x.clone() for x in state))


@pytest.mark.parametrize("snodes_above", [None, 16])
def test_phases_and_frame_equal_the_plain_driver(monkeypatch, snodes_above):
    if snodes_above is not None:
        monkeypatch.setattr(hako, "USE_SNODES_ABOVE", snodes_above)
    # the script counts its rounds as differences: a caller's count runs on
    hk.reset_counters()
    hk._acc(torch.device("cpu"))[0] += 1000
    got = pt.main(ARGV)
    assert hk.rounds_run() == 1000 + got["frame"]["rounds"]
    # on the CPU the wrappers run the plain versions and launch nothing
    assert set(got["launches"].values()) == {0}
    assert all(set(r["launches"].values()) == {0} for r in got["phases"].values())
    assert got["fat"] == (snodes_above is not None)
    assert got["phases"].keys() == {"hako_probe", "hako_dda leaf", "hako_merge",
                                    "hako_dda_merge"} | (
        {"hako_dda supernodes"} if got["fat"] else set())
    # the fused row stage leaves the state the unfused stage's merge leaves
    for a, b in zip(got["outputs"]["hako_dda_merge"], got["outputs"]["hako_merge"]):
        assert torch.equal(a, b)
    tree, cam = pt.bumpy_scene(32, "cpu")
    ro, rd = (torch.from_numpy(x) for x in pt.frame_rays(cam, 64, 64))
    (bricks, snodes, tabs, root), T = hako_mega.hako_mega_args(tree)
    args = (bricks, snodes, tabs, root, tree.lower, tree.upper, ro, rd)
    rec = FirstRound()
    t, nmaj, vrank, unresolved, rounds = hk.drive(
        (rec.probe, hk.unfused_stage(rec.dda, rec.merge)), *args, T=T, shadow=False,
        max_probes=hk.PROBES, max_dda=hk.DDA_ITERS,
        max_rounds=hk.default_max_rounds(snodes, T, hk.PROBES, hk.DDA_ITERS))
    n = got["lanes"]
    assert n == 2048 and got["rays"] == 8192 and int(unresolved) == 0
    for name, outs in rec.out.items():
        for a, b in zip(got["outputs"][name], outs):
            # every lane is active in the first round: its lanes [0, n)
            # are the phase's lanes; the merge's state covers every ray
            want = b if name == "hako_merge" else b[..., :n]
            if name == "hako_merge":
                a, want = a[:n], want[:n]
            assert torch.equal(a, want), name
    for a, b in zip(got["outputs"]["frame"], (t, nmaj, vrank)):
        assert torch.equal(a, b)
    assert got["frame"]["rounds"] == rounds
    want = hk.intersect_rays_hako_plain(*args, T=T)
    for a, b in zip(got["outputs"]["frame"], want[:3]):
        assert torch.equal(a, b)
    assert bool((want[0] < 1e37).any())


def test_refuses_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt.main(ARGV[2:])
