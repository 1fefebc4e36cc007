"""The PyTorch port stands without JAX: it imports none (a subprocess with
`jax` and the JAX package blocked builds a tiny scene, renders a frame and
runs a path-tracer step), no module of it names jax or imports anything of
the JAX package, the nvcc commands keep IEEE float semantics for sm_90a,
and chip_smoke.py refuses to run without a card or without the
repository."""

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


def test_nvcc_command_keeps_ieee_floats():
    srcs = cuda_build.sources()
    assert [os.path.basename(s) for s in srcs] == ["hako_mega.cu", "hako_rounds.cu"]
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
    -march=native, so it gives the same triangles on every host."""
    srcs = host_build.sources()
    assert [os.path.basename(s) for s in srcs] == ["host_pmj.cpp", "host_split.cpp"]
    cmd = host_build.gxx_command(host_build.LIB_PATH, srcs)
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
