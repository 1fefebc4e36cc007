"""Build the port's host library with g++ and bind it with ctypes.

The sources are `massivevoxelraytracing_torch/csrc/*.cpp` (the triangle
split to the voxelizer's cap, the PMJ table generator, the HDR / OBJ
decoders of host_io.cpp, and the Morton codec and MurmurHash3 of
host_morton.cpp). The library links nothing but the C++ runtime
(no zlib: PNG compression is the standard library's). They are
compiled at first use into `build/torch_kernels/libhako_host.so` at the
repository root and rebuilt whenever the hash of the sources and the
command changes (`cuda_build`'s stamp). A failed build raises: there is no
fallback on the main path.

Flags: no `-march=native` and `-ffp-contract=off`, so no multiply-add is
contracted and the split gives the same triangles on every host.
"""

from __future__ import annotations

import ctypes
import glob
import os
import time

from . import cuda_build

LIB_PATH = os.path.join(cuda_build.BUILD_DIR, "libhako_host.so")

_lib = None
last_build_seconds = None  # wall seconds of this process's g++ run, if any


def sources() -> list:
    return sorted(glob.glob(os.path.join(cuda_build.CSRC, "*.cpp")))


def gxx_command(out: str, srcs: list) -> list:
    return ["g++", "-O3", "-std=c++17", "-fPIC", "-ffp-contract=off",
            "-shared", "-o", out, *srcs]


def _bind(lib):
    p = ctypes.c_void_p
    i64 = ctypes.c_int64
    lib.hako_split_to_cap.argtypes = [p, p, p, i64, p, ctypes.c_float, i64,
                                      i64, p, p, p, i64]
    lib.hako_split_to_cap.restype = i64
    lib.hako_pmj02_table.argtypes = [ctypes.c_int32, ctypes.c_int32,
                                     ctypes.c_uint64, ctypes.c_uint64, p]
    lib.hako_pmj02_table.restype = None
    lib.hako_hdr_decode.argtypes = [p, i64, ctypes.c_int32, ctypes.c_int32, p]
    lib.hako_hdr_decode.restype = ctypes.c_int32
    lib.hako_obj_parse.argtypes = [p, i64, p, i64]
    lib.hako_obj_parse.restype = i64
    lib.hako_morton_encode.argtypes = [p, p, p, i64, p]
    lib.hako_morton_encode.restype = None
    lib.hako_morton_decode.argtypes = [p, i64, p, p, p]
    lib.hako_morton_decode.restype = None
    lib.hako_murmur3_32.argtypes = [p, i64, ctypes.c_uint32]
    lib.hako_murmur3_32.restype = ctypes.c_uint32
    return lib


def load():
    """The loaded host library; builds it first if the sources changed."""
    global _lib, last_build_seconds
    if _lib is not None:
        return _lib
    os.makedirs(cuda_build.BUILD_DIR, exist_ok=True)
    srcs = sources()
    want = cuda_build.digest([gxx_command(LIB_PATH, srcs)], srcs)
    if not cuda_build.is_fresh(LIB_PATH, want):
        t0 = time.time()
        tmp = f"{LIB_PATH}.tmp.{os.getpid()}"
        cuda_build._run_parallel([gxx_command(tmp, srcs)])
        cuda_build.install(tmp, LIB_PATH, want)
        last_build_seconds = time.time() - t0
    _lib = _bind(ctypes.CDLL(LIB_PATH))
    return _lib
