"""The PT step scripts at a small size on the CPU: scripts/pt_phase_attrib.py
on a coloured 32^3 bumpy sphere at 32x32 (16 spp: 16,384 lanes, so the
inter-bounce compaction is on at COMPACT_MIN_LANES) with cells b0, b2,
b2_nosky and b2_nocompact, each cell's accumulator equal to a PathTracer
driven directly with the same settings, compaction on equal to compaction
off bit for bit, no sky (and no emission) giving mean 0 and b0 differing
from b2; scripts/pt_step_timing.py at 32x16 equal to a PathTracer driven
directly on the same scene; and the attribution's arithmetic. The
PathTracer itself is held against the JAX package in
test_torch_pathtracer*.py."""

import numpy as np
import pytest
import torch

from massivevoxelraytracing_torch.models import pathtracer, scene
from massivevoxelraytracing_torch.ops import camera
from massivevoxelraytracing_torch.scripts import common, pt_phase_attrib, pt_step_timing
from massivevoxelraytracing_torch.utils import meshgen

# The tensors here are small: one intra-op thread keeps the test runner's
# parallel workers from oversubscribing the cores.
torch.set_num_threads(1)

RES = 32
CELLS = ("b0", "b2", "b2_nosky", "b2_nocompact")


@pytest.fixture(scope="module")
def tree():
    tri = meshgen.bumpy_sphere(3, radius=0.9)
    origin, dps = meshgen.fit_grid(tri, RES)
    cols = meshgen.vertex_colors_from_position(tri, *meshgen.mesh_bounds(tri))
    t = scene.build_scene(tri, cols, origin=origin, dps=dps, grid_res=RES, device="cpu")
    assert t.color is not None and not t.has_emission
    return t


@pytest.fixture(scope="module")
def attrib(tree):
    return pt_phase_attrib.run(width=32, height=32, steps=1, tree=tree, cells=CELLS,
                               device="cpu")


def script_camera(lower, extent):
    center = np.asarray(lower, np.float32) + extent / 2
    return camera.Camera.look_at(eye=center + np.array([0.9, 0.4, 1.4]) * extent * 0.9,
                                 target=center, fovy_deg=40.0)


def direct(tree, cam, width, height, steps, max_bounces=pathtracer.MAX_BOUNCES,
           sky=True, compact=None):
    pt = pathtracer.PathTracer(width=width, height=height, max_bounces=max_bounces,
                               device="cpu")
    pt.compact = compact
    pt.setup()
    if sky:
        pt.load_hdri(common.sky_img())
    pt.update_scene(tree)
    for _ in range(steps):
        pt.step(cam)
    return pt.accum


def test_compaction_is_on_at_this_size():
    assert 32 * 32 * pathtracer.N_BATCH_SPP >= pathtracer.COMPACT_MIN_LANES


@pytest.mark.parametrize("name", CELLS)
def test_cell_equals_a_tracer_driven_directly(attrib, tree, name):
    rec = attrib["cells"][name]
    bounces, sky, compact = pt_phase_attrib.parse_cell(name)
    assert (rec["bounces"], rec["sky"], rec["compact"]) == (bounces, sky, compact)
    cam = script_camera(tree.lower.numpy(), float(tree.dps) * RES)
    want = direct(tree, cam, 32, 32, 2, bounces, sky, compact)
    assert torch.equal(rec["accum"], want)
    assert rec["mean"] == float(want[:, :3].mean())
    assert rec["launches_a_step"] == 0  # CPU tensors: the plain version


def test_compaction_changes_no_bit(attrib):
    cells = attrib["cells"]
    assert cells["b2_nocompact"]["compact"] is False and cells["b2"]["compact"] is None
    assert torch.equal(cells["b2_nocompact"]["accum"], cells["b2"]["accum"])


def test_no_sky_no_light(attrib):
    rec = attrib["cells"]["b2_nosky"]
    assert rec["mean"] == 0.0
    assert not bool(rec["accum"][:, :3].any())
    assert bool((rec["accum"][:, 3] == 2 * pathtracer.N_BATCH_SPP).all())


def test_bounces_add_light(attrib):
    cells = attrib["cells"]
    assert 0 < cells["b0"]["mean"] < cells["b2"]["mean"]
    assert attrib["attribution"] == {}  # no device times on the CPU


def test_attribution_arithmetic():
    s = dict(b0=1.0, b1=1.5, b2=1.75, b4=2.75, b8=4.75, b8_nosky=4.0, b8_nocompact=5.0)
    got = pt_phase_attrib.attribution(s)
    assert list(got.values()) == [1.0, 0.5, 0.25, 0.5, 0.5, 0.75, 0.25]
    assert list(pt_phase_attrib.attribution(dict(b0=1.0, b2=2.0))) == ["primary (b0)"]


@pytest.mark.parametrize("name", ["b", "x2", "b2_sky", "b2_nosky_nocompact", "b-1"])
def test_cell_names_are_checked(name):
    with pytest.raises(ValueError):
        pt_phase_attrib.parse_cell(name)


def test_step_timing_equals_a_tracer_driven_directly():
    rec = pt_step_timing.run(res=RES, width=32, height=16, iters=1, device="cpu")
    tri = meshgen.bumpy_sphere(5, radius=0.9)
    origin, dps = meshgen.fit_grid(tri, RES)
    tree = scene.build_scene(tri, origin=origin, dps=dps, grid_res=RES, device="cpu")
    want = direct(tree, script_camera(origin, float(dps) * RES), 32, 16, 2)
    assert torch.equal(rec["accum"], want)
    assert rec["mean"] == float(want[:, :3].mean()) and np.isfinite(rec["mean"])
    assert (rec["scene"], rec["accel"], rec["launches_a_step"]) == ("bumpy", "hako", 0)


def test_step_profile_is_held_to_the_steps_counts(monkeypatch, capsys):
    """common.profile_or_none with the PT step's live counts (the sample
    chain's kernels and hako_mega): a trace that drops one counted launch
    in every try is "not measured"; one that drops it once is taken again
    and kept. The step runs once a try."""
    from massivevoxelraytracing_torch.ops import hako_mega, pt_chain

    steps = []

    def step():  # one step: a hako_mega and a bounce-sample launch
        steps.append(1)
        hako_mega.LAUNCHES += 1
        pt_chain.LAUNCHES["pt_bounce_sample"] += 1

    def fake(drops):
        def profile(fn, pad_s=0.0, names=()):
            before = {k: counts[k] for k in names}
            fn()
            named = {k: (0.1, counts[k] - before[k]) for k in names}
            if next(drops):
                named["pt_bounce_sample"] = (0.1, named["pt_bounce_sample"][1] - 1)
            return dict(named=named, busy_ms=1.0)
        return profile

    monkeypatch.setattr(hako_mega, "LAUNCHES", 0)
    monkeypatch.setattr(pt_chain, "LAUNCHES", dict.fromkeys(pt_chain.KERNELS, 0))
    counts = common.step_counts()
    assert dict(counts) == {**dict.fromkeys(pt_chain.KERNELS, 0), "hako_mega": 0}
    monkeypatch.setattr(common, "profile_call", fake(iter([True] * 8)))
    assert common.profile_or_none(step, counts, "[t] step") is None
    assert "[t] step: not measured" in capsys.readouterr().out
    assert len(steps) == len(common.PROFILE_PADS_S) and counts["hako_mega"] == len(steps)
    monkeypatch.setattr(common, "profile_call", fake(iter([True, False])))
    got = common.profile_or_none(step, counts, "[t] step")
    assert got["tries"] == 2 and got["busy_ms"] == 1.0
    assert got["named"]["hako_mega"] == (0.1, 1)
