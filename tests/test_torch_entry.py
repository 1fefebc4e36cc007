"""The port's entry points (massivevoxelraytracing_torch/entry.py) and the
apps' --build-devices flag, on the CPU.

  * entry()'s function against the JAX package's `__graft_entry__.entry()`
    on the same tree (the JAX tree through `hako.from_numpy`) and the same
    rays: the example rays bit-equal; hit mask, nmajor and voxel rank
    equal, t within 8 ulps of max(|t|, 1) (the interpret-mode megakernel
    contracts its cell plane into an FMA: test_torch_hako_mega).
  * dryrun_multichip(8, device="cpu") prints JAX's three ok lines.
  * rtcamp with --build-devices 2 writes the PNG of the single build, byte
    for byte; voxpt with --build-devices 2 accumulates the same radiance.
"""

import numpy as np
import pytest
import torch

import __graft_entry__ as jentry
from massivevoxelraytracing_tpu.models import scene as jscene
from massivevoxelraytracing_tpu.utils import meshgen
from massivevoxelraytracing_torch import entry
from massivevoxelraytracing_torch.apps import rtcamp, voxpt
from massivevoxelraytracing_torch.models import accel
from massivevoxelraytracing_torch.ops import hako

from test_torch_hako_build import jax_tree_dict
from test_torch_hako_mega import assert_matches_reference

# The tensors here are small: one intra-op thread keeps the test runner's
# parallel workers from oversubscribing the cores.
torch.set_num_threads(1)


def test_entry_matches_jax_entry():
    jfn, jargs = jentry.entry()
    want = tuple(np.asarray(x) for x in jfn(*jargs))
    fn, args = entry.entry(device="cpu")
    assert fn.args == ("hako_mega", 1)
    ro, rd = args[4], args[5]
    assert ro.shape == (4096, 3)
    np.testing.assert_array_equal(ro.numpy(), np.asarray(jargs[4]))
    np.testing.assert_array_equal(rd.numpy(), np.asarray(jargs[5]))
    # the JAX entry's tree, built as entry() builds it
    tri = meshgen.icosphere(2, radius=0.9)
    origin, dps = meshgen.fit_grid(tri, 64)
    col = meshgen.vertex_colors_from_position(tri, *meshgen.mesh_bounds(tri))
    jt = jscene.build_scene(tri, col, origin=origin, dps=dps, grid_res=64,
                            accel="hako")
    pt = hako.from_numpy(jax_tree_dict(jt), device="cpu")
    _kind, _depth, meta, root = accel.accel_args(pt)
    t, nm, vr = fn(meta, root, pt.lower, pt.upper, ro, rd)
    assert_matches_reference((t.numpy(), nm.numpy(), vr.numpy().view(np.uint32)),
                             want)
    # and the port's own example arguments trace
    t2, _nm2, _vr2 = fn(*args)
    assert t2.shape == (4096,) and 0 < int((t2 < 1e37).sum()) < 4096


def test_entry_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="card"):
        entry.entry()
    with pytest.raises(RuntimeError, match="card"):
        entry.dryrun_multichip(2)


def test_dryrun_multichip_on_cpu(capsys):
    entry.dryrun_multichip(8, device="cpu")
    out = capsys.readouterr().out
    assert "[dryrun] mesh: {'dp': 2, 'sp': 4}" in out
    ok = [ln for ln in out.splitlines() if ln.startswith("[dryrun] ok:")]
    assert len(ok) == 3
    assert "sharded build over 8 devices" in ok[0] and "every field equal" in ok[0]
    assert "full PT step, 512 rays over dp=2, sp=4" in ok[1] and "spp 4" in ok[1]
    assert "sharded hako PT step" in ok[2]


RTCAMP = ["--scene", "soup", "--frames", "2", "--frame-range", "1", "2",
          "--width", "24", "--height", "16", "--steps", "1", "--from-res", "16",
          "--to-res", "32", "--device", "cpu"]


def test_rtcamp_build_devices_same_png(tmp_path):
    one = rtcamp.main(RTCAMP + ["--out", str(tmp_path / "one")])
    two = rtcamp.main(RTCAMP + ["--build-devices", "2", "--out", str(tmp_path / "two")])
    assert two[0]["build_stats"]["n_devices"] == 2
    assert "n_devices" not in one[0]["build_stats"]
    assert two[0]["build_stats"]["n_unique"] == one[0]["build_stats"]["n_unique"]
    a = (tmp_path / "one" / "001.png").read_bytes()
    assert a == (tmp_path / "two" / "001.png").read_bytes()


def test_voxpt_build_devices_same_accumulator(tmp_path):
    argv = ["--scene", "torus", "--res", "32", "--width", "24", "--height", "16",
            "--steps", "1", "--device", "cpu", "--ray-packet", "4096"]
    one = voxpt.main(argv + ["--out", str(tmp_path / "one")])
    two = voxpt.main(argv + ["--build-devices", "2", "--out", str(tmp_path / "two")])
    assert two.tree.build_stats["n_devices"] == 2
    assert torch.equal(one.accum, two.accum)
