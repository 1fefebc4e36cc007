"""The port's app layer against the JAX package: EngineConfig JSON both
ways, the frame partition, every named scene (load_scene and the animated
frames, the lattice on a small stand-in mesh in both packages), scenes
from .obj / .ply / .npz / .abc files; and voxpt on the CPU: a checkpoint
then a resume equals an uninterrupted run, bit for bit, and
render_first.png holds exactly 16 spp."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from massivevoxelraytracing_tpu import config as jconfig
from massivevoxelraytracing_tpu.apps import launch_frames as jlaunch
from massivevoxelraytracing_tpu.apps import scenes as jscenes
from massivevoxelraytracing_tpu.utils import abcio as jabcio
from massivevoxelraytracing_tpu.utils import meshgen as jmeshgen
from massivevoxelraytracing_torch import config
from massivevoxelraytracing_torch.apps import launch_frames, scenes, voxpt
from massivevoxelraytracing_torch.utils import png

# The tensors here are small: one intra-op thread keeps the test runner's
# parallel workers from oversubscribing the cores.
torch.set_num_threads(1)


def test_engine_config_json_both_ways():
    assert config.EngineConfig().to_json() == jconfig.EngineConfig().to_json()
    assert dataclasses.asdict(config.DEFAULT) == dataclasses.asdict(jconfig.DEFAULT)
    cfg = config.EngineConfig(six_separating=False, max_bounces=4, lens_r=0.1,
                              ray_packet=1 << 21, hdri_scale=2.5)
    back = jconfig.EngineConfig.from_json(cfg.to_json())
    assert dataclasses.asdict(back) == dataclasses.asdict(cfg)
    jcfg = jconfig.EngineConfig(dag=False, n_batch_spp=8, emission_scale=3.0)
    assert dataclasses.asdict(config.EngineConfig.from_json(jcfg.to_json())) == \
        dataclasses.asdict(jcfg)
    assert json.loads(cfg.to_json())["ray_packet"] == 1 << 21


@pytest.mark.parametrize("frames,workers", [(240, 2), (24, 5), (7, 3), (3, 8), (24, 1)])
def test_partition_equals_jax(frames, workers):
    got = launch_frames.partition(frames, workers)
    assert got == jlaunch.partition(frames, workers)
    assert [f for a, b in got for f in range(a, b)] == list(range(frames))


def assert_scene_equal(got, want):
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["torus", "sphere", "bumpy", "soup"])
def test_load_scene_equals_jax(name):
    assert_scene_equal(scenes.load_scene(name), jscenes.load_scene(name))


@pytest.fixture
def small_lattice(monkeypatch):
    base = jmeshgen.sphere_lattice(2, 1)
    for mod in (scenes, jscenes):
        monkeypatch.setattr(mod, "_lattice_base", lambda: base)


@pytest.mark.parametrize("name", ["torus", "bumpy", "lattice", "sphere", "soup"])
def test_animated_scene_equals_jax(name, small_lattice):
    for frame, total in ((0, 24), (5, 24), (3, 4), (23, 24)):
        assert_scene_equal(scenes.animated_scene(name, frame, total),
                           jscenes.animated_scene(name, frame, total))


def test_unknown_scene_exits():
    with pytest.raises(SystemExit):
        scenes.load_scene("teapot")


def test_file_scenes_equal_jax(tmp_path):
    from test_torch_host_io import write_obj, write_ply

    obj, ply = str(tmp_path / "m.obj"), str(tmp_path / "m.ply")
    write_obj(obj)
    write_ply(ply, binary=True, colors=True)
    for path in (obj, ply):
        assert_scene_equal(scenes.load_scene(path), jscenes.load_scene(path))
    npz = str(tmp_path / "anim.npz")
    t0 = jmeshgen.icosphere(1)
    np.savez(npz, tri_0000=t0, tri_0001=t0 * 0.5, col_0001=np.full_like(t0, 0.2))
    abc = str(tmp_path / "shot.abc")
    jabcio.write_fixture_abc(abc, [t0, t0 * 1.5], [np.ones((t0.size // 3, 3), np.float32)] * 2)
    for path in (npz, abc):
        assert_scene_equal(scenes.load_scene(path), jscenes.load_scene(path))
        for frame in (0, 1):
            assert_scene_equal(scenes.animated_scene(path, frame, 2),
                               jscenes.animated_scene(path, frame, 2))


VOXPT = ["--scene", "sphere", "--res", "16", "--width", "24", "--height", "16",
         "--snapshot-every", "0", "--device", "cpu"]


def test_voxpt_resume_equals_uninterrupted(tmp_path):
    full = str(tmp_path / "full")
    part = str(tmp_path / "part")
    ck = str(tmp_path / "ck.npz")
    pt_full = voxpt.main(VOXPT + ["--steps", "2", "--out", full])
    assert pt_full.spp_done == 32
    # render_first.png is the image at exactly 16 spp
    first = png.read(os.path.join(full, "render_first.png"))
    voxpt.main(VOXPT + ["--steps", "1", "--out", part, "--checkpoint", ck])
    np.testing.assert_array_equal(png.read(os.path.join(part, "render_final.png")),
                                  first)
    with np.load(ck) as z:
        assert int(z["steps"]) == 1 and int(z["spp_done"]) == 16
    trace = str(tmp_path / "trace")
    pt_res = voxpt.main(VOXPT + ["--steps", "2", "--out", part, "--resume", ck,
                                 "--profile", trace])
    assert pt_res.spp_done == 32 and pt_res.steps == 2
    assert torch.equal(pt_res.accum, pt_full.accum)
    with open(os.path.join(full, "render_final.png"), "rb") as a, \
            open(os.path.join(part, "render_final.png"), "rb") as b:
        assert a.read() == b.read()
    assert os.path.getsize(os.path.join(trace, "trace.json")) > 0


def test_apps_refuse_unported_accel(tmp_path):
    # every structure of the reference is ported and traces the same image;
    # a structure the reference does not have is refused
    with pytest.raises(SystemExit):
        voxpt.main(VOXPT + ["--accel", "bvh", "--out", str(tmp_path)])
    runs = {accel: voxpt.main(VOXPT + ["--accel", accel, "--steps", "1",
                                       "--out", str(tmp_path / accel)])
            for accel in ("hako", "octree", "brick")}
    for accel in ("octree", "brick"):
        assert torch.equal(runs[accel].accum, runs["hako"].accum), accel


def test_launch_frames_fans_out_the_ports_rtcamp(monkeypatch):
    started = []

    class Proc:
        def __init__(self, cmd):
            started.append(cmd)

        def wait(self):
            return 0

    monkeypatch.setattr(launch_frames.subprocess, "Popen", Proc)
    with pytest.raises(SystemExit) as done:
        launch_frames.main(["--frames", "7", "--workers", "3", "--",
                            "--scene", "soup", "--device", "cpu"])
    assert done.value.code == 0
    assert [c[2] for c in started] == ["massivevoxelraytracing_torch.apps.rtcamp"] * 3
    assert [c[4:6] for c in started] == [["0", "3"], ["3", "5"], ["5", "7"]]
    assert all(c[-4:] == ["--scene", "soup", "--device", "cpu"] for c in started)
