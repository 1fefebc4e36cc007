"""The apps this slice adds or completes, on the CPU (`--device cpu`):

  * voxmesh writes the JAX app's PLY byte for byte against the JAX app run
    op by op (jax.disable_jit); against the jitted JAX app (whose XLA:CPU
    program contracts the voxelizer's barycentrics into FMAs) the voxel
    geometry is equal and the vertex colors differ by at most 2 per channel
    on at most 1.5% of the vertices, the voxelizer's tie band of
    tests/test_torch_voxelize.py (1.3% of the vertices, by at most 2,
    measured);
  * voxtriangle writes the JAX app's PNG byte for byte;
  * voxrt through the brick tree and the octree (DAG on and off) renders
    the HakoTree's image up to ties;
  * apps.scale_shell builds and renders the 256^3 terrain shell."""

import numpy as np
import jax
import pytest
import torch

from massivevoxelraytracing_tpu.apps import voxmesh as jvoxmesh
from massivevoxelraytracing_tpu.apps import voxtriangle as jvoxtriangle
from massivevoxelraytracing_torch.apps import scale_shell, voxmesh, voxrt, voxtriangle
from massivevoxelraytracing_torch.utils import png

torch.set_num_threads(1)

VOXMESH = ["--scene", "sphere", "--res", "32"]
PLY_VERTEX = np.dtype([("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                       ("r", "u1"), ("g", "u1"), ("b", "u1")])


def read_ply(path):
    data = open(path, "rb").read()
    head = data.index(b"end_header\n") + len(b"end_header\n")
    header = data[:head].decode()
    nv = int(header.split("element vertex ")[1].split()[0])
    verts = np.frombuffer(data[head:head + nv * PLY_VERTEX.itemsize], PLY_VERTEX)
    return header, verts, data[head + nv * PLY_VERTEX.itemsize:]


@pytest.fixture(scope="module")
def port_ply(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("voxmesh") / "port.ply")
    st = voxmesh.main(VOXMESH + ["--device", "cpu", "--out", path])
    assert st["n_voxels"] > 1000
    return path


def test_voxmesh_equals_jax_op_by_op(port_ply, tmp_path):
    path = str(tmp_path / "jax.ply")
    with jax.disable_jit():
        jvoxmesh.main(VOXMESH + ["--out", path])
    with open(path, "rb") as a, open(port_ply, "rb") as b:
        assert a.read() == b.read()


def test_voxmesh_within_the_tie_band_of_jitted_jax(port_ply, tmp_path):
    path = str(tmp_path / "jax.ply")
    jvoxmesh.main(VOXMESH + ["--out", path])
    hj, vj, fj = read_ply(path)
    hp, vp, fp = read_ply(port_ply)
    assert hj == hp and fj == fp
    for axis in "xyz":
        np.testing.assert_array_equal(vj[axis], vp[axis])
    d = np.stack([np.abs(vj[c].astype(int) - vp[c]) for c in "rgb"], -1)
    assert d.max() <= 2
    assert d.max(-1).sum() <= 0.015 * len(vj), d.max(-1).sum()


def test_voxtriangle_equals_jax(tmp_path):
    argv = ["--res", "32"]
    jvoxtriangle.main(argv + ["--out", str(tmp_path / "jax")])
    st = voxtriangle.main(argv + ["--device", "cpu", "--out", str(tmp_path / "port")])
    assert st["counts"] == {"conservative": 270, "six": 151}
    with open(tmp_path / "jax" / "coverage.png", "rb") as a, \
            open(st["path"], "rb") as b:
        assert a.read() == b.read()
    img = png.read(st["path"])
    assert img.shape == (256, 256, 3) and img.min() != img.max()


VOXRT = ["--scene", "torus", "--res", "64", "--width", "64", "--height", "48",
         "--device", "cpu"]


@pytest.fixture(scope="module")
def hako_frame(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("voxrt_hako"))
    st = voxrt.main(VOXRT + ["--accel", "hako", "--out", out])
    return st, png.read(st["path"])


@pytest.mark.parametrize("accel,dag", [("brick", 1), ("octree", 1), ("octree", 0)])
def test_voxrt_structures_equal_hako_up_to_ties(hako_frame, tmp_path, accel, dag):
    want, img_want = hako_frame
    st = voxrt.main(VOXRT + ["--accel", accel, "--dag", str(dag),
                             "--out", str(tmp_path)])
    img = png.read(st["path"])
    assert st["n_voxels"] == want["n_voxels"]
    dw, dg = want["depth"], st["depth"]
    hit = dw < 1e37
    np.testing.assert_array_equal(hit, dg < 1e37)
    assert 0.2 < hit.mean() < 0.9
    # a pixel may differ only where two voxel faces tie at the same depth
    np.testing.assert_allclose(dg[hit], dw[hit], rtol=1e-5, atol=1e-7)
    assert (img != img_want).any(-1).sum() <= hit.sum() // 100


def test_scale_shell_on_the_cpu(tmp_path):
    out = str(tmp_path / "shell.png")
    st = scale_shell.main(["--res", "256", "--width", "96", "--height", "64",
                           "--device", "cpu", "--out", out])
    assert st["park"] == "host"
    assert st["n_voxels"] == st["analytic"] == st["tree"].n_voxels > 200_000
    assert st["tree"].T == 2 and st["hit"] > 0.5
    img = png.read(out)
    assert img.shape == (64, 96, 3) and img.min() != img.max()
