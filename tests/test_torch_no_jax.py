"""The PyTorch port stands without JAX: it imports none (a subprocess with
`jax` blocked builds and renders a tiny scene), no module of it names
jax, its only imports from the JAX package are the shared host utilities,
the nvcc command keeps IEEE float semantics for sm_90a, and chip_smoke.py
refuses to run without a card or without the repository."""

import os
import re
import shutil
import subprocess
import sys

import pytest
import torch

from massivevoxelraytracing_torch.utils import cuda_build

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "massivevoxelraytracing_torch")
# Subprocesses run tiny tensors on one OpenMP thread, so the test runner's
# parallel workers do not oversubscribe the cores.
ONE_THREAD = dict(os.environ, OMP_NUM_THREADS="1")

NO_JAX_RUN = r"""
import sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
import numpy as np
from massivevoxelraytracing_torch.models import raycast, scene
from massivevoxelraytracing_torch.ops import camera, hako_mega
from massivevoxelraytracing_torch.utils import cuda_build
from massivevoxelraytracing_tpu.utils import meshgen

tri = meshgen.icosphere(2, radius=0.3, center=(0.5, 0.5, 0.5))
tree = scene.build_scene(tri, origin=np.zeros(3, np.float32), dps=1 / 32,
                         grid_res=32, device="cpu")
cam = camera.Camera.look_at(eye=(0.5, 0.6, 2.0), target=(0.5, 0.5, 0.5))
img, depth = raycast.render_frame(tree, cam, 16, 12, device="cpu")
assert tuple(img.shape) == (12, 16, 3)
assert 0 < int((depth < 1e37).sum()) < 16 * 12
assert hako_mega.LAUNCHES == 0
loaded = [m for m, v in sys.modules.items()
          if v is not None and (m.split(".")[0] in ("jax", "jaxlib"))]
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
    shared = {"massivevoxelraytracing_tpu.utils"}
    for path in _python_files():
        with open(path) as f:
            src = f.read()
        assert not jax_import.search(src), path
        for name in tpu_import.findall(src):
            assert name in shared, (path, name)


def test_nvcc_command_keeps_ieee_floats():
    srcs = cuda_build.sources()
    assert [os.path.basename(s) for s in srcs] == ["hako_mega.cu"]
    cmd = cuda_build.nvcc_command("nvcc", cuda_build.LIB_PATH, srcs)
    line = " ".join(cmd)
    assert "-fmad=false" in cmd
    assert "arch=compute_90a,code=sm_90a" in cmd
    for flag in ("use_fast_math", "-ftz=true", "-prec-div=false",
                 "-prec-sqrt=false"):
        assert flag not in line
    assert cuda_build.LIB_PATH.endswith(
        os.path.join("build", "torch_kernels", "libhako_torch.so"))


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
