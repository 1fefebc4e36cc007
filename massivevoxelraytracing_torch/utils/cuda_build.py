"""Build the port's CUDA kernels with nvcc and bind them with ctypes.

The sources are `massivevoxelraytracing_torch/csrc/*.cu` (plus the `.cuh`
headers they include). They are compiled at first use into
`build/torch_kernels/libhako_torch.so` at the repository root, with a
plain C interface (no PyTorch headers, so a build takes seconds): one nvcc
per source, all started together, then one link. The library is rebuilt
whenever the hash of the sources and the commands changes.

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
MAX_LEVELS = 8  # top-tree level tables the kernels take (T <= 9)

_lib = None
last_build_seconds = None  # wall seconds of this process's nvcc run, if any
last_build_log = ""        # the library's ptxas report (registers, spills per kernel)


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


def nvcc_commands(nvcc: str, out: str, srcs: list, tag: str = "", includes=()):
    """(one compile command per source, the link command) for the library
    `out`; object files sit next to it, suffixed with `tag`; `includes`
    are searched for the sources' headers."""
    objs = [os.path.join(os.path.dirname(out),
                         os.path.basename(s)[:-3] + tag + ".o") for s in srcs]
    compile_cmds = [
        [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
         "-O3", "-fmad=false", "-Xptxas", "-v", "-Xcompiler", "-fPIC",
         *(a for d in includes for a in ("-I", d)), "-c", "-o", obj, src]
        for src, obj in zip(srcs, objs)
    ]
    link_cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
                "-o", out, *objs]
    return compile_cmds, link_cmd


def digest(cmds: list, files: list) -> str:
    """Hash of the build commands' flags and the files' contents."""
    h = hashlib.sha256()
    for cmd in cmds:
        h.update(" ".join(a for a in cmd[1:] if not a.startswith(BUILD_DIR))
                 .encode())
    for path in files:
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + f.read())
    return h.hexdigest()


def is_fresh(lib_path: str, want: str) -> bool:
    stamp = lib_path + ".sha256"
    if not (os.path.exists(lib_path) and os.path.exists(stamp)):
        return False
    with open(stamp) as f:
        return f.read().strip() == want


def install(tmp: str, lib_path: str, want: str) -> None:
    """Move a finished build into place and stamp it (atomic rename, so
    concurrent builders never load a half-written library)."""
    os.replace(tmp, lib_path)
    with open(lib_path + ".sha256", "w") as f:
        f.write(want)


def _run_parallel(cmds: list) -> str:
    """Run the commands concurrently; raise on the first failure. Returns
    their stderr, concatenated."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for c in cmds]
    outs = [p.communicate() for p in procs]
    for cmd, p, (_out, err) in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(
                f"{os.path.basename(cmd[0])} failed ({p.returncode}) on "
                f"{cmd[-1]}:\n{err[-4000:]}")
    return "".join(err for _out, err in outs)


def _bind(lib):
    p = ctypes.c_void_p
    i = ctypes.c_int
    f = ctypes.c_float
    u = ctypes.c_uint
    lib.hako_mega_launch.argtypes = [
        p, p, p, p, i,                                 # rows, levels, offs, T
        u, u, p,                                       # root mask, bounds
        p, p, i,                                       # ro, rd, n
        p, p, p, p,                                    # t, nmaj, vrank, unres
        i, i, i, i,                                    # shadow, caps, rounds
        f, f,                                          # dt factors
        p, p,                                          # counts, warp stats
        p,                                             # stream
    ]
    lib.hako_probe_launch.argtypes = [
        p, p, i, u, u, p,                              # levels, offs, T, root, bounds
        p, p, p, p, i,                                 # ro, rd, idx, tq, n
        p, p, p, p, p, p,                              # emit, child, bt1, tqe, tqn, exh
        i, p,                                          # max_probes, stream
    ]
    lib.hako_dda_launch.argtypes = [
        p, p, p, p, p, i,                              # rows, bounds, ro, rd, idx, n
        p, p, p, p,                                    # go, child, bt1, tqe
        p, p, p, p, p, p, p, p,                        # 8 outputs
        f, i, i, i, p,                                 # dt_factor, leaf, shadow, iters, stream
    ]
    lib.hako_dda_cached_launch.argtypes = (
        lib.hako_dda_launch.argtypes[:-1] + [i, p, p])  # cache, stats, stream
    lib.hako_merge_launch.argtypes = [
        p, i,                                          # idx, n
        p, p, p, p, p, p, p, p, p, p,                  # emit, bt1, tqn, exh, hit, t, nmaj, vr, more, tqr
        p, p, p, p, p,                                 # state: resolved, tq, t, nmaj, vrank
        p,                                             # stream
    ]
    lib.hako_dda_merge_launch.argtypes = [
        p, p, p, p, p, p, i,                           # bricks, snodes, bounds, ro, rd, idx, n
        p, p, p, p, p, p,                              # emit, child, bt1, tqe, tqn, exh
        f, f, i, i,                                    # dt factors, shadow, max_iters
        p, p, p, p, p,                                 # state: resolved, tq, t, nmaj, vrank
        p,                                             # stream
    ]
    lib.hako_rounds_launch.argtypes = [
        p, p, p, p, i,                                 # bricks, snodes, levels, offs, T
        u, u, p, p,                                    # root mask, lower, upper
        p, p, i,                                       # ro, rd, n
        p, p, p,                                       # lists, counts, tq
        p, p, p, p, p,                                 # t, nmaj, vrank, info, acc
        i, i, i, i,                                    # shadow, caps, rounds
        f, f, i,                                       # dt factors, blocks
        p,                                             # stream
    ]
    lib.hako_rounds_grid.argtypes = [i, i, p]            # fat, shadow, out[2]
    lib.row_chase_launch.argtypes = [
        p, p, p, i, i,                                 # rows, start, end, chains, hops
        i, i, i, i, p,                                 # mode, chains/thread, blocks, threads, stream
    ]
    lib.walk_probe_launch.argtypes = [p, p, p, p, i, i, i, i, p, p]
    lib.fetch_probe_launch.argtypes = [p, p, i, i, i, p, p]
    lib.fetch_probe_smem_bytes.argtypes = [i]
    lib.fetch_probe_smem_bytes.restype = ctypes.c_size_t
    lib.hako_dda_cached_smem_bytes.argtypes = [i]
    lib.hako_dda_cached_smem_bytes.restype = ctypes.c_size_t
    lib.l2_read_probe_launch.argtypes = [p, ctypes.c_longlong, i, i, i, p, p]
    lib.construct_probe_launch.argtypes = [
        i, p, p, p, p, p,                              # kind, fa, fb, ia, ua, ub
        i, i, p, i, p,                                 # n, k, out, threads, stream
    ]
    lib.node_gather_probe_launch.argtypes = [
        i, p, i, p, i, i,                              # space, table, nodes, idx0, n, k
        p, p, i, p,                                    # acc, fold, threads, stream
    ]
    lib.table_select_probe_launch.argtypes = [i, p, p, i, i, p, i, p]
    lib.calib_probe_launch.argtypes = [i, p, p, i, i, p, i, p]
    lib.shell_copy_probe_launch.argtypes = [i, p, p, i, p]  # aos, in[8], out[8], n
    lib.preamble_probe_launch.argtypes = [p, p, i, p, p]    # ray[6], bounds, n, out[8]
    lib.probe_stage_probe_launch.argtypes = [
        i, p, p, u, u,                                 # stage, ray[7], bounds, root
        p, p, p, p, p, i,                              # levels, off, n, form, rows, count
        i, i, i, p, p, p,                              # T, clip, n, out_i[3], out_f[5], stream
    ]
    lib.take_along_probe_launch.argtypes = [
        i, i, p, p, p,                                 # axis, form, t, idx, out
        i, i, i, i, i, i, i,                           # B, R, C, r, Ci, c_out, mod
        i, p,                                          # slice, stream
    ]
    lib.smem_alloc_probe_launch.argtypes = [p, p, i, p]  # x, out, rows, stream
    lib.ohg_probe_launch.argtypes = [
        i, p, i, p, i, i, p,                           # mode, table, rows, idx0, n, k, out
        i, i, p,                                       # threads, cluster, stream
    ]
    q = ctypes.c_longlong
    lib.pt_lane_init_launch.argtypes = [
        i, p, q, p, q,                                 # pmj, table, points, perm, n_perm
        u, u, q, q, q, i,                              # pix_start, spp_base, width, packet, spp, major
        p, q, p, p, p, p, p, p, p,                     # cam[10], n, stream, spp, pcg x2, ro, rd, stream
    ]
    lib.pt_primary_shade_launch.argtypes = [
        i, p, p, p, p, q,                              # hdri, t, vidx, rd, emission, n
        p, i, i, f, q,                                 # img, w, h, scale, n
        p, p, p, p,                                    # T, L, miss, stream
    ]
    lib.pt_bounce_sample_launch.argtypes = [
        i, i, i, p, q, p, p, p, p, p, p,               # flags, color, n, vidx, nmaj, ro, rd, t, miss
        p, p, p, p, p, q, u,                           # stream, spp, pcg x2, table, points, dim
        p, p, p, p, p, i, i, i, i,                     # alias x3, sats, pixels, w, h, steps w / h
        f, f, f, q,                                    # scale, dtheta, dphi, n
        p, p, p, p, p, p, p, p, p, p,                  # 9 outputs, stream
    ]
    lib.pt_bounce_shade_launch.argtypes = [
        i, i, p, q, p,                                 # hdri, extra, emission, n, escale
        p, p, p, p, p, p, p,                           # T, L, refl, hit_n, dir_s, emissive, pdf
        p, p, p, p, p, p, p, p, p, p,                  # miss, nmaj, vidx, rd, t_s, t_e, v_e, t_b, nm_b, vi_b
        f, f, q, p, p, p, p, p, p, p,                  # inv_extra, w_depth0, n, 6 outputs, stream
    ]
    lib.pt_compact_gather_launch.argtypes = [p, q] + [p] * 22  # perm, n, 10 in, 11 out, stream
    lib.vox_count_launch.argtypes = [
        i, p, q, p, p,                                 # six, tri, n, origin, dps
        i, i, p, p,                                    # grid_res, cap, count, stream
    ]
    lib.vox_emit_launch.argtypes = [
        i, p, p, p, p, q,                              # six, tri, col, emi, offsets, n
        p, p, i, i, q,                                 # origin, dps, grid_res, cap, n_out
        p, p, p, p,                                    # code, color, emission, stream
    ]
    lib.vox_run_heads_launch.argtypes = [p, q, p, p]     # s_key, n, heads, stream
    lib.vox_unique_reduce_launch.argtypes = [
        i, p, p, p, q,                                 # mode, s_key, perm, ends, n
        p, p, p, p,                                    # in[7], code, out[7], stream
    ]
    lib.vox_unique_tile.argtypes = []
    lib.frame_raygen_launch.argtypes = [
        p, q, q, q, q,                                 # cam[16] (host), py0, w, h, tile rows
        p, p, p,                                       # ro, rd, stream
    ]
    lib.frame_shade_launch.argtypes = [
        i, i, p, p, p, p, p,                           # color, untile, t, nmaj, vidx, rd, table
        q, q, q, p, p, p,                              # n_color, n_out, width, img, depth, stream
    ]
    walk = [p, q, p, p, p, q,                          # meta, nodes, bounds, ro, rd, n
            u, i, q, f, f, f,                          # root, depth, max_iters, constants
            p, p, p, p]                                # t, nmaj, vidx, stream
    lib.brick_walk_launch.argtypes = walk
    lib.octree_walk_launch.argtypes = [i] + walk       # shadow
    lib.smem_optin_bytes.argtypes = [i]
    lib.ohg_mma_max_clusters.argtypes = [i, i]            # rows, cluster
    lib.cuda_error_string.argtypes = [i]
    lib.cuda_error_string.restype = ctypes.c_char_p
    for fn in (lib.hako_mega_launch, lib.hako_probe_launch,
               lib.hako_dda_launch, lib.hako_merge_launch,
               lib.hako_dda_merge_launch, lib.hako_rounds_launch,
               lib.hako_rounds_grid, lib.row_chase_launch, lib.walk_probe_launch,
               lib.fetch_probe_launch, lib.l2_read_probe_launch, lib.construct_probe_launch,
               lib.node_gather_probe_launch, lib.table_select_probe_launch,
               lib.calib_probe_launch, lib.hako_dda_cached_launch,
               lib.shell_copy_probe_launch, lib.preamble_probe_launch,
               lib.probe_stage_probe_launch, lib.take_along_probe_launch,
               lib.smem_alloc_probe_launch, lib.ohg_probe_launch,
               lib.pt_lane_init_launch, lib.pt_primary_shade_launch,
               lib.pt_bounce_sample_launch, lib.pt_bounce_shade_launch,
               lib.pt_compact_gather_launch, lib.vox_count_launch,
               lib.vox_emit_launch, lib.vox_run_heads_launch,
               lib.vox_unique_reduce_launch, lib.vox_unique_tile,
               lib.frame_raygen_launch, lib.frame_shade_launch,
               lib.brick_walk_launch, lib.octree_walk_launch,
               lib.smem_optin_bytes, lib.ohg_mma_max_clusters):
        fn.restype = ctypes.c_int
    return lib


def build_renamed(src: str, out_dir: str, entry_points, suffix: str = "_old",
                  includes=(), extra: str = ""):
    """An earlier version of one kernel source, built with the library's
    nvcc flags into a library of its own under out_dir, its C entry points
    (each name followed by "(") renamed with `suffix` so that it loads
    beside the current library; `includes` are searched for its headers
    (the current csrc/ for hako_device.cuh); `extra` is appended to the
    source before the renaming. Returns (the ctypes library, the source
    text as built, wall seconds, the ptxas report); raises if nvcc fails."""
    os.makedirs(out_dir, exist_ok=True)
    with open(src) as f:
        text = f.read() + extra
    for name in entry_points:
        text = text.replace(name + "(", name + suffix + "(")
    stem = os.path.splitext(os.path.basename(src))[0]
    renamed = os.path.join(out_dir, f"{stem}_renamed.cu")
    with open(renamed, "w") as f:
        f.write(text)
    lib_path = os.path.join(out_dir, f"lib{stem}_renamed.so")
    compile_cmds, link = nvcc_commands(nvcc_path(), lib_path, [renamed], includes=includes)
    t0 = time.perf_counter()
    log = ""
    for cmd in (*compile_cmds, link):
        done = subprocess.run(cmd, capture_output=True, text=True)
        if done.returncode != 0:
            raise RuntimeError(f"nvcc failed on {cmd[-1]}:\n{done.stderr[-4000:]}")
        log += done.stderr
    return ctypes.CDLL(lib_path), text, time.perf_counter() - t0, log


def load():
    """The loaded kernel library; builds it first if the sources changed.
    Raises if nvcc is missing or the build fails."""
    global _lib, last_build_seconds, last_build_log
    if _lib is not None:
        return _lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = nvcc_path()
    srcs = sources()
    compile_cmds, link_cmd = nvcc_commands(nvcc, LIB_PATH, srcs)
    want = digest(compile_cmds + [link_cmd],
                  srcs + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))))
    if not is_fresh(LIB_PATH, want):
        t0 = time.time()
        tag = f".tmp{os.getpid()}"
        tmp = LIB_PATH + tag
        compile_cmds, link_cmd = nvcc_commands(nvcc, tmp, srcs, tag)
        log = _run_parallel(compile_cmds)
        _run_parallel([link_cmd])
        for cmd in compile_cmds:
            os.remove(cmd[cmd.index("-o") + 1])
        install(tmp, LIB_PATH, want)
        last_build_seconds = time.time() - t0
        last_build_log = log
        with open(LIB_PATH + ".ptxas", "w") as f:
            f.write(log)
    elif os.path.exists(LIB_PATH + ".ptxas"):
        with open(LIB_PATH + ".ptxas") as f:
            last_build_log = f.read()
    _lib = _bind(ctypes.CDLL(LIB_PATH))
    return _lib
