"""The port's rtcamp app on the CPU (torus, 4 frames at 24x16 from 16^3 to
32^3, one 16-spp step a frame): every frame's grid resolution, origin,
dps and camera equal the JAX app's under the same argv (the JAX app run
with its build_scene and PathTracer replaced by cheap recorders, so only
its frame arithmetic runs); every PNG equals a PathTracer driven directly
on the same tree and camera; and a PNG writer that fails makes main()
raise instead of hanging on its queue."""

import os
import threading
import types

import numpy as np
import pytest
import torch

from massivevoxelraytracing_torch.apps import rtcamp
from massivevoxelraytracing_torch.models import scene
from massivevoxelraytracing_torch.models.pathtracer import PathTracer
from massivevoxelraytracing_torch.utils import png

# The tensors here are small: one intra-op thread keeps the test runner's
# parallel workers from oversubscribing the cores.
torch.set_num_threads(1)

ARGV = ["--scene", "torus", "--frames", "4", "--frame-range", "0", "4",
        "--width", "24", "--height", "16", "--steps", "1",
        "--from-res", "16", "--to-res", "32"]
CAM_FIELDS = ("o", "front", "up", "right", "tan_half_fovy", "lens_r", "focus")


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    """(out dir, per-frame records, the trees built, the app's tracer)."""
    out = str(tmp_path_factory.mktemp("rtcamp"))
    trees, tracers = [], []
    real_build, real_hdri = scene.build_scene, PathTracer.load_hdri

    def build(*a, **k):
        trees.append(real_build(*a, **k))
        return trees[-1]

    def load_hdri(self, *a, **k):
        tracers.append(self)
        return real_hdri(self, *a, **k)

    mp = pytest.MonkeyPatch()
    mp.setattr(scene, "build_scene", build)
    mp.setattr(PathTracer, "load_hdri", load_hdri)
    try:
        records = rtcamp.main(ARGV + ["--device", "cpu", "--out", out])
    finally:
        mp.undo()
    return out, records, trees, tracers[0]


def jax_run(tmp_path):
    """The JAX app's per-frame (grid_res, origin, dps, camera), with the
    build and the tracer replaced by recorders."""
    from massivevoxelraytracing_tpu.apps import rtcamp as jrtcamp

    frames = []

    def build(tri, col, emi, *, origin, dps, grid_res, **kw):
        frames.append(dict(origin=np.asarray(origin), dps=dps, grid_res=grid_res))
        return types.SimpleNamespace(build_stats=None)

    class Tracer:
        def __init__(self, width, height, **kw):
            self.shape = (height, width, 3)

        def step(self, cam):
            frames[-1]["cam"] = cam

        def resolve(self):
            return np.zeros(self.shape, np.uint8)

        setup = load_hdri = update_scene = clear_frame_buffer = \
            lambda self, *a, **k: None

    mp = pytest.MonkeyPatch()
    mp.setattr(jrtcamp.scene, "build_scene", build)
    mp.setattr(jrtcamp, "PathTracer", Tracer)
    try:
        jrtcamp.main(ARGV + ["--accel", "hako", "--out", str(tmp_path)])
    finally:
        mp.undo()
    return frames


def test_frames_grid_and_camera_equal_jax(port_run, tmp_path):
    _out, records, trees, _pt = port_run
    want = jax_run(tmp_path)
    assert [r["frame"] for r in records] == [0, 1, 2, 3]
    assert [r["grid_res"] for r in records] == [16, 32, 32, 32]
    assert len(want) == len(records) == len(trees)
    for rec, w, tree in zip(records, want, trees):
        assert rec["grid_res"] == w["grid_res"] == tree.grid_res
        assert rec["dps"] == w["dps"] and tree.dps == float(rec["dps"])
        assert rec["origin"].dtype == w["origin"].dtype
        np.testing.assert_array_equal(rec["origin"], w["origin"])
        np.testing.assert_array_equal(tree.lower.numpy(), w["origin"])
        for f in CAM_FIELDS:
            np.testing.assert_array_equal(getattr(rec["cam"], f), getattr(w["cam"], f))


def test_each_png_equals_the_tracer_driven_directly(port_run):
    out, records, trees, app_pt = port_run
    pt = PathTracer(width=24, height=16, device="cpu")
    pt.setup()
    pt.env = app_pt.env  # the same procedural sky, built once
    for rec, tree in zip(records, trees):
        pt.update_scene(tree)
        pt.clear_frame_buffer()
        pt.step(rec["cam"])
        img = png.read(os.path.join(out, f"{rec['frame']:03d}.png"))
        assert img.shape == (16, 24, 3) and img.max() > img.min()
        np.testing.assert_array_equal(img, pt.resolve())


def test_a_failing_writer_raises_instead_of_hanging(monkeypatch, tmp_path):
    def broken(path, img, compress_level=1):
        raise OSError("disk full")

    monkeypatch.setattr(rtcamp.png, "write", broken)
    result = {}

    def run():  # more frames than the queue holds
        try:
            rtcamp.main(["--scene", "soup", "--frames", "10", "--width", "8",
                         "--height", "8", "--steps", "0", "--from-res", "8",
                         "--to-res", "8", "--hdri", "none", "--device", "cpu",
                         "--out", str(tmp_path)])
        except BaseException as e:
            result["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout=120)
    assert not t.is_alive(), "rtcamp.main hung on a failed PNG writer"
    err = result.get("error")
    assert isinstance(err, RuntimeError), err
    assert isinstance(err.__cause__, OSError)
