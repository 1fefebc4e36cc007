"""Build the port's CUDA kernels with nvcc and bind them with ctypes.

The sources are `massivevoxelraytracing_torch/csrc/*.cu` (plus the `.cuh`
headers they include). They are compiled at first use into
`build/torch_kernels/libhako_torch.so` at the repository root, with a
plain C interface (no PyTorch headers, so a build takes seconds), and
rebuilt whenever the hash of the sources and the command changes.

Flags: `-fmad=false` keeps every float expression as written (the
traversal decides ties by exact float equality of cell planes, which an
FMA contraction would drift by an ulp); `--use_fast_math` is never used,
and `-ftz` / `-prec-div` stay at their IEEE defaults.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")
LIB_PATH = os.path.join(BUILD_DIR, "libhako_torch.so")
MAX_LEVELS = 8  # top-tree level tables the kernel takes (T <= 9)

_lib = None
last_build_seconds = None  # wall seconds of this process's nvcc run, if any
last_build_log = ""        # its ptxas report (registers, spills per kernel)


def sources() -> list:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def nvcc_command(nvcc: str, out: str, srcs: list) -> list:
    return [
        nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
        "-O3", "-fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
        "-o", out, *srcs,
    ]


def _digest(cmd: list) -> str:
    h = hashlib.sha256(" ".join(cmd[1:]).encode())
    files = sources() + sorted(glob.glob(os.path.join(CSRC, "*.cuh")))
    for path in files:
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + f.read())
    return h.hexdigest()


def _bind(lib):
    p = ctypes.c_void_p
    i = ctypes.c_int
    lib.hako_mega_launch.argtypes = [
        p, p, p, p, i,                                 # rows, levels, offs, T
        ctypes.c_uint, ctypes.c_uint, p,               # root mask, bounds
        p, p, i,                                       # ro, rd, n
        p, p, p, p,                                    # t, nmaj, vrank, unres
        i, i, i, i,                                    # shadow, caps, rounds
        ctypes.c_float, ctypes.c_float,                # dt factors
        p,                                             # stream
    ]
    lib.hako_mega_launch.restype = ctypes.c_int
    return lib


def load():
    """The loaded kernel library; builds it first if the sources changed.
    Raises if nvcc is missing or the build fails."""
    global _lib, last_build_seconds, last_build_log
    if _lib is not None:
        return _lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = nvcc_path()
    tmp = f"{LIB_PATH}.tmp.{os.getpid()}"
    digest = _digest(nvcc_command(nvcc, LIB_PATH, sources()))
    stamp = LIB_PATH + ".sha256"
    fresh = os.path.exists(LIB_PATH) and os.path.exists(stamp)
    if fresh:
        with open(stamp) as f:
            fresh = f.read().strip() == digest
    if not fresh:
        t0 = time.time()
        proc = subprocess.run(
            nvcc_command(nvcc, tmp, sources()), capture_output=True, text=True
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
        os.replace(tmp, LIB_PATH)
        with open(stamp, "w") as f:
            f.write(digest)
        last_build_seconds = time.time() - t0
        last_build_log = proc.stderr
    _lib = _bind(ctypes.CDLL(LIB_PATH))
    return _lib
