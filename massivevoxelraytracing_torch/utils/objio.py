"""Mesh I/O: OBJ and ASCII / binary PLY read, voxel PLY write, baked .npz
animation frames (the port's copy of the JAX package's utils/objio.py).

`load_obj` parses with the port's host C++ (csrc/host_io.cpp); its plain
version is `load_obj_plain`. A failed build raises: there is no fallback
to the Python parser. Voxel Morton codes are the port's int64 codes.
"""

from __future__ import annotations

import ctypes
import os
import struct

import numpy as np

from ..ops import morton as morton_ops

F = np.float32


def load(path: str):
    """Load a mesh file -> (tri f32[T,3,3], colors f32[T,3,3] | None)."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".obj":
        return load_obj(path)
    if ext == ".ply":
        return load_ply(path)
    raise ValueError(f"unsupported mesh format: {path}")


def load_obj(path: str):
    """OBJ -> (tri f32[T,3,3], None) with the host C++ parser."""
    from . import host_build

    lib = host_build.load()
    with open(path, "rb") as f:
        buf = np.frombuffer(f.read(), np.uint8)
    ptr = buf.ctypes.data_as(ctypes.c_void_p)
    n = lib.hako_obj_parse(ptr, len(buf), None, 0)
    out = np.empty((n, 3, 3), F)
    n2 = lib.hako_obj_parse(ptr, len(buf), out.ctypes.data_as(ctypes.c_void_p), n)
    if n2 != n:
        raise ValueError(f"{path}: OBJ parse gave {n2} triangles, then {n}")
    return out, None


def load_obj_plain(path: str):
    """The plain Python version of `load_obj`."""
    verts = []
    faces = []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                p = line.split()
                verts.append((float(p[1]), float(p[2]), float(p[3])))
            elif line.startswith("f "):
                idx = [int(tok.split("/")[0]) for tok in line.split()[1:]]
                idx = [i - 1 if i > 0 else len(verts) + i for i in idx]
                for k in range(1, len(idx) - 1):  # fan triangulation
                    faces.append((idx[0], idx[k], idx[k + 1]))
    v = np.asarray(verts, F).reshape(-1, 3)
    f_arr = np.asarray(faces, np.int64).reshape(-1, 3)
    return v[f_arr], None


def load_ply(path: str):
    """ASCII or binary_little_endian PLY with x/y/z (+ optional u8 rgb)."""
    with open(path, "rb") as f:
        data = f.read()
    header_end = data.find(b"end_header\n") + len(b"end_header\n")
    header = data[:header_end].decode("ascii", "replace").splitlines()
    fmt = None
    elements = []  # (name, count, [(type, prop)...])
    for line in header:
        tok = line.split()
        if not tok:
            continue
        if tok[0] == "format":
            fmt = tok[1]
        elif tok[0] == "element":
            elements.append([tok[1], int(tok[2]), []])
        elif tok[0] == "property":
            if tok[1] == "list":
                elements[-1][2].append(("list", tok[2], tok[3], tok[4]))
            else:
                elements[-1][2].append((tok[1], tok[2]))

    type_map = {
        "float": ("f", 4), "float32": ("f", 4), "double": ("d", 8),
        "uchar": ("B", 1), "uint8": ("B", 1), "char": ("b", 1),
        "short": ("h", 2), "ushort": ("H", 2),
        "int": ("i", 4), "int32": ("i", 4), "uint": ("I", 4), "uint32": ("I", 4),
    }
    body = data[header_end:]
    verts = None
    vcols = None
    faces = []
    if fmt == "ascii":
        lines = body.decode().split("\n")
        li = 0
        for name, count, props in elements:
            rows = []
            for _ in range(count):
                rows.append(lines[li].split())
                li += 1
            if name == "vertex":
                keys = [p[1] for p in props if p[0] != "list"]
                arr = np.asarray([[float(x) for x in r[: len(keys)]] for r in rows])
                verts, vcols = _extract_vertex(arr, keys)
            elif name == "face":
                for r in rows:
                    n = int(r[0])
                    idx = [int(x) for x in r[1 : 1 + n]]
                    for k in range(1, n - 1):
                        faces.append((idx[0], idx[k], idx[k + 1]))
    elif fmt == "binary_little_endian":
        off = 0
        for name, count, props in elements:
            if name == "vertex":
                fmt_str = "<" + "".join(type_map[p[0]][0] for p in props)
                size = struct.calcsize(fmt_str)
                arr = np.array(
                    [
                        struct.unpack_from(fmt_str, body, off + i * size)
                        for i in range(count)
                    ]
                )
                off += count * size
                keys = [p[1] for p in props]
                verts, vcols = _extract_vertex(arr, keys)
            elif name == "face":
                lp = props[0]
                cnt_fmt, cnt_sz = type_map[lp[1]]
                idx_fmt, idx_sz = type_map[lp[2]]
                for _ in range(count):
                    (n,) = struct.unpack_from("<" + cnt_fmt, body, off)
                    off += cnt_sz
                    idx = struct.unpack_from("<" + idx_fmt * n, body, off)
                    off += idx_sz * n
                    for k in range(1, n - 1):
                        faces.append((idx[0], idx[k], idx[k + 1]))
    else:
        raise ValueError(f"unsupported PLY format {fmt}")

    f_arr = np.asarray(faces, np.int64)
    tri = verts[f_arr].astype(F)
    col = vcols[f_arr].astype(F) if vcols is not None else None
    return tri, col


def _extract_vertex(arr, keys):
    xi, yi, zi = keys.index("x"), keys.index("y"), keys.index("z")
    verts = arr[:, [xi, yi, zi]].astype(F)
    cols = None
    if "red" in keys:
        ri, gi, bi = keys.index("red"), keys.index("green"), keys.index("blue")
        cols = arr[:, [ri, gi, bi]].astype(F) / 255.0
    return verts, cols


def save_voxels_ply(path: str, xyz: np.ndarray, dps: float, origin,
                    colors: np.ndarray | None = None,
                    cull_hidden: bool = True, mortons_sorted=None):
    """Write voxels as quads-as-triangles PLY (VoxelMeshWriter semantics,
    voxelMeshWriter.hpp:5-73), optionally culling faces whose +-1 neighbor
    exists (the bSearch hidden-face cull, voxMesh.cpp:143-148).
    mortons_sorted: the voxels' sorted int64 Morton codes, if at hand."""
    xyz = np.asarray(xyz, np.int64)
    origin = np.asarray(origin, F)
    n = len(xyz)
    if mortons_sorted is None:
        mortons_sorted = np.sort(
            morton_ops.np_encode(xyz[:, 0], xyz[:, 1], xyz[:, 2]))

    # 6 faces, each 2 triangles; cull shared faces via sorted-morton lookup
    face_dirs = np.array(
        [[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]]
    )
    # vertices of a unit cube face for each dir
    face_corners = {
        (1, 0, 0): [(1, 0, 0), (1, 1, 0), (1, 1, 1), (1, 0, 1)],
        (-1, 0, 0): [(0, 0, 1), (0, 1, 1), (0, 1, 0), (0, 0, 0)],
        (0, 1, 0): [(0, 1, 0), (0, 1, 1), (1, 1, 1), (1, 1, 0)],
        (0, -1, 0): [(0, 0, 0), (1, 0, 0), (1, 0, 1), (0, 0, 1)],
        (0, 0, 1): [(0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1)],
        (0, 0, -1): [(0, 1, 0), (1, 1, 0), (1, 0, 0), (0, 0, 0)],
    }
    vs = []
    fs = []
    cs = []
    for i in range(n):
        p = xyz[i]
        for d in face_dirs:
            if cull_hidden:
                q = p + d
                if np.all(q >= 0):
                    mq = int(morton_ops.np_encode(q[0], q[1], q[2]))
                    j = np.searchsorted(mortons_sorted, mq)
                    if j < n and mortons_sorted[j] == mq:
                        continue
            base = len(vs)
            for c in face_corners[tuple(d)]:
                vs.append(origin + (p + np.asarray(c)) * F(dps))
                if colors is not None:
                    cs.append(colors[i])
            fs.append((base, base + 1, base + 2))
            fs.append((base, base + 2, base + 3))

    with open(path, "wb") as f:
        has_col = colors is not None
        hdr = ["ply", "format binary_little_endian 1.0",
               f"element vertex {len(vs)}",
               "property float x", "property float y", "property float z"]
        if has_col:
            hdr += ["property uchar red", "property uchar green",
                    "property uchar blue"]
        hdr += [f"element face {len(fs)}",
                "property list uchar int vertex_indices", "end_header"]
        f.write(("\n".join(hdr) + "\n").encode())
        for i, v in enumerate(vs):
            f.write(struct.pack("<fff", *v))
            if has_col:
                c = (np.asarray(cs[i]) * 255 + 0.5).astype(np.uint8)
                f.write(struct.pack("<BBB", *c))
        for face in fs:
            f.write(struct.pack("<Biii", 3, *face))


def load_npz_frame(path: str, frame: int):
    """Baked animation: arrays tri_{i}, col_{i}, emi_{i} per frame."""
    z = np.load(path)
    tri = z[f"tri_{frame:04d}"].astype(F)
    ck, ek = f"col_{frame:04d}", f"emi_{frame:04d}"
    col = z[ck].astype(F) if ck in z.files else np.ones_like(tri)
    emi = z[ek].astype(F) if ek in z.files else np.zeros_like(tri)
    return tri, col, emi
