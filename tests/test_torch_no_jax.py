"""The PyTorch port stands without JAX: it imports none (a subprocess with
`jax` and the JAX package blocked builds a tiny scene, renders a frame,
runs a path-tracer step, renders one rtcamp frame, builds and renders the
brick tree and the octree, builds over 2 shards and renders over 2 bands,
streams a terrain shell, imports the measurement scripts of the last
slice, runs the Morton codecs' microbenchmark and shoots thin-lens rays),
no module of it
names jax or imports anything of the JAX package, the nvcc commands keep
IEEE float semantics for sm_90a, the host library links no zlib, and
chip_smoke.py refuses to run without a card or without the repository."""

import glob
import os
import re
import shutil
import subprocess
import sys

import pytest
import torch

from massivevoxelraytracing_torch.utils import cuda_build, host_build

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "massivevoxelraytracing_torch")
# Subprocesses run tiny tensors on one OpenMP thread, so the test runner's
# parallel workers do not oversubscribe the cores.
ONE_THREAD = dict(os.environ, OMP_NUM_THREADS="1")

NO_JAX_RUN = r"""
import sys
# any `import jax` or `import massivevoxelraytracing_tpu...` now raises
sys.modules["jax"] = None
sys.modules["massivevoxelraytracing_tpu"] = None
import numpy as np
import torch
from massivevoxelraytracing_torch.models import pathtracer, raycast, scene
from massivevoxelraytracing_torch.ops import camera, hako_mega
from massivevoxelraytracing_torch.utils import cuda_build, meshgen

tri = meshgen.icosphere(2, radius=0.3, center=(0.5, 0.5, 0.5))
tree = scene.build_scene(tri, origin=np.zeros(3, np.float32), dps=1 / 32,
                         grid_res=32, device="cpu")
cam = camera.Camera.look_at(eye=(0.5, 0.6, 2.0), target=(0.5, 0.5, 0.5))
img, depth = raycast.render_frame(tree, cam, 16, 12, device="cpu")
assert tuple(img.shape) == (12, 16, 3)
assert 0 < int((depth < 1e37).sum()) < 16 * 12
pt = pathtracer.PathTracer(width=16, height=12, packet=1024, max_bounces=2,
                           device="cpu")
pt.pmj_table = torch.from_numpy(
    np.random.default_rng(0).random((128, 4096, 2), np.float32))
pt.setup()
pt.load_hdri(np.ones((8, 16, 3), np.float32))
pt.update_scene(tree)
pt.step(cam, n_spp=2)
assert bool(torch.isfinite(pt.accum).all()) and float(pt.accum[:, :3].sum()) > 0
assert hako_mega.LAUNCHES == 0
from massivevoxelraytracing_torch.ops import pt_chain
assert not any(pt_chain.LAUNCHES.values())  # the CPU runs the plain stages
# the rtcamp app, one tiny frame
import os, tempfile
from massivevoxelraytracing_torch.apps import rtcamp
with tempfile.TemporaryDirectory() as out:
    rec = rtcamp.main(["--scene", "soup", "--frames", "1", "--width", "16",
                       "--height", "12", "--steps", "1", "--from-res", "16",
                       "--to-res", "16", "--device", "cpu", "--out", out])
    assert [r["grid_res"] for r in rec] == [16]
    assert os.path.getsize(os.path.join(out, "000.png")) > 0
# the other structures, the streamed build and the apps of slice 5
from massivevoxelraytracing_torch.apps import scale_shell, voxmesh, voxtriangle
from massivevoxelraytracing_torch.ops import bricktree, hako_stream, octree
from massivevoxelraytracing_torch.ops import traverse, traverse2
from massivevoxelraytracing_torch.utils import shellgen
for accel in ("brick", "octree"):
    t2 = scene.build_scene(tri, origin=np.zeros(3, np.float32), dps=1 / 32,
                           grid_res=32, device="cpu", accel=accel)
    img2, depth2 = raycast.render_frame(t2, cam, 16, 12, device="cpu")
    assert torch.equal(depth2 < 1e37, depth < 1e37), accel
assert isinstance(t2, octree.VoxelOctree) and t2.n_nodes > 0
# the multi-device layer: a 2-shard build and a 2-band frame on the CPU
from massivevoxelraytracing_torch.models import accel
from massivevoxelraytracing_torch.parallel import build as pbuild
from massivevoxelraytracing_torch.parallel import mesh, render as prender
t3 = pbuild.build_scene_sharded(tri, origin=np.zeros(3, np.float32), dps=1 / 32,
                                grid_res=32, n_devices=2, device="cpu", accel="hako")
assert torch.equal(t3.bricks, tree.bricks) and t3.build_stats["n_devices"] == 2
kind, levels, meta, root = accel.accel_args(tree)
band = prender.make_sharded_render(mesh.make_mesh(2, device="cpu"), width=16,
                                   height=12, kind=kind, depth=levels)
img3, depth3 = band(meta, root, tree.lower, tree.upper, raycast._color_table(tree),
                    *(torch.tensor(np.asarray(v, np.float32)) for v in
                      (cam.o, cam.right, cam.up, cam.front, cam.tan_half_fovy)))
assert torch.equal(img3, img) and torch.equal(depth3, depth)
terrain = shellgen.Terrain(64, 16, device="cpu")
shell = hako_stream.build_hako_stream(terrain.chunks(), 64)
assert shell.n_voxels == terrain.total_voxels() > 0
# the last modules: the measurement scripts, the host Morton codec, the thin lens
from massivevoxelraytracing_torch.ops import morton
from massivevoxelraytracing_torch.scripts import (
    microbench, pt_phase_attrib, pt_step_timing, rebuild_timing, scale_demo)
assert len(microbench.run(n=64, device="cpu")) == 4
assert pt_phase_attrib.parse_cell("b8_nocompact") == (8, True, False)
assert scale_demo.sphere_lattice(1, 0, 0.44)[0].shape == (20, 3, 3)
px = torch.arange(4)
ro, rd = camera.shoot_thin_lens(cam, px, px, 0.5, 0.5, 16, 12, torch.rand(4), torch.rand(4))
assert tuple(rd.shape) == (4, 3) and bool(torch.isfinite(ro).all())
loaded = [m for m, v in sys.modules.items() if v is not None and m.split(".")[0]
          in ("jax", "jaxlib", "massivevoxelraytracing_tpu")]
assert not loaded, loaded
print("no-jax ok")
"""


def _python_files():
    for dirpath, _dirs, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_port_builds_and_renders_with_jax_blocked():
    env = dict(ONE_THREAD, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", NO_JAX_RUN], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "no-jax ok" in out.stdout


def test_no_module_imports_jax():
    jax_import = re.compile(r"^\s*(import\s+jax|from\s+jax[\s.])", re.M)
    tpu_import = re.compile(
        r"^\s*(?:from|import)\s+(massivevoxelraytracing_tpu[\w.]*)", re.M)
    shared = set()  # the port keeps its own copy of any host code it needs
    for path in [*_python_files(), os.path.join(ROOT, "chip_smoke.py")]:
        with open(path) as f:
            src = f.read()
        assert not jax_import.search(src), path
        for name in tpu_import.findall(src):
            assert name in shared, (path, name)
    # the kernel sources include only system headers and their own
    for path in glob.glob(os.path.join(PKG, "csrc", "*.cu*")):
        with open(path) as f:
            includes = re.findall(r'^\s*#\s*include\s*[<"]([^>"]+)[>"]', f.read(), re.M)
        assert includes and all("massivevoxelraytracing_tpu" not in h and "/" not in h
                                for h in includes), (path, includes)


def test_nvcc_command_keeps_ieee_floats():
    srcs = cuda_build.sources()
    assert [os.path.basename(s) for s in srcs] == [
        "hako_mega.cu", "hako_probes.cu", "hako_rounds.cu", "pt_chain.cu",
        "vox_build.cu"]
    compile_cmds, link_cmd = cuda_build.nvcc_commands(
        "nvcc", cuda_build.LIB_PATH, srcs)
    assert [c[-1] for c in compile_cmds] == srcs  # one nvcc per source
    for cmd in compile_cmds:
        line = " ".join(cmd)
        assert "-fmad=false" in cmd
        assert "arch=compute_90a,code=sm_90a" in cmd
        for flag in ("use_fast_math", "-ftz=true", "-prec-div=false",
                     "-prec-sqrt=false"):
            assert flag not in line
    assert "arch=compute_90a,code=sm_90a" in link_cmd
    assert cuda_build.LIB_PATH.endswith(
        os.path.join("build", "torch_kernels", "libhako_torch.so"))


def test_host_command_keeps_ieee_floats():
    """The host split is built without contraction and without
    -march=native, so it gives the same triangles on every host; the
    library links no zlib (a host without its headers still builds it)."""
    srcs = host_build.sources()
    assert [os.path.basename(s) for s in srcs] == [
        "host_io.cpp", "host_morton.cpp", "host_pmj.cpp", "host_split.cpp"]
    cmd = host_build.gxx_command(host_build.LIB_PATH, srcs)
    assert not any(a.startswith("-l") for a in cmd)
    for src in srcs:
        with open(src) as f:
            assert "zlib" not in f.read()
    assert "-ffp-contract=off" in cmd
    assert not any(a.startswith("-march") or "fast-math" in a or a == "-Ofast"
                   for a in cmd)


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py would run for real")


def _smoke(cwd):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=300,
                          env=dict(ONE_THREAD, PYTHONPATH=""))


def test_chip_smoke_fails_without_a_card(no_card):
    out = _smoke(ROOT)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_fails_outside_the_repository(no_card, tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    out = _smoke(tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
