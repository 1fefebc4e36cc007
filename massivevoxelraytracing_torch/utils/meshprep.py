"""Host-side triangle preparation for the dense candidate-grid voxelizer
(the port's copy of the JAX package's utils/meshprep.py).

The voxelizer evaluates a static cap^3 candidate grid per triangle
(ops/voxelize.py), so triangles whose voxel-space bbox exceeds the cap are
bisected at their longest edge until they fit. Coverage is preserved: the
Schwarz-Seidel predicate is an exact triangle/box overlap test, so the
union of the parts' coverage equals the whole's; voxels duplicated along a
cut merge in the sort + unique pass.

`split_to_cap` runs the port's host C++ (csrc/host_split.cpp, built by
utils/host_build.py without multiply-add contraction, so every host gives
the same triangles); `split_to_cap_plain` is its plain numpy version with
the same worklist order and every float op rounded to f32.
"""

from __future__ import annotations

import numpy as np

F = np.float32


def bbox_extent_in_voxels(verts: np.ndarray, origin, dps, grid_res: int):
    """Max per-axis voxel-index extent (inclusive count) of each triangle's
    clipped bbox. verts: [T, 3, 3]."""
    origin = np.asarray(origin, F)
    lo = verts.min(axis=1)
    hi = verts.max(axis=1)
    l = np.floor((lo - origin) / F(dps)).astype(np.int64)
    u = np.floor((hi - origin) / F(dps)).astype(np.int64)
    l = np.maximum(l, 0)
    u = np.minimum(u, grid_res - 1)
    ext = np.maximum(u - l + 1, 0)
    return ext.max(axis=1)


def _as_rows(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, F).reshape(-1, 9))


def split_to_cap(verts, colors, emissions, origin, dps, grid_res: int,
                 cap: int):
    """Bisect triangles at their longest edge until every bbox fits cap^3.

    verts/colors/emissions: f32[T, 3, 3]. Returns the enlarged arrays, each
    input triangle's parts in depth-first order (first half first).
    Vertex attributes at a new midpoint are linearly interpolated."""
    from . import host_build

    lib = host_build.load()
    v, c, e = _as_rows(verts), _as_rows(colors), _as_rows(emissions)
    org = np.ascontiguousarray(origin, F)
    args = (v.ctypes.data, c.ctypes.data, e.ctypes.data, len(v),
            org.ctypes.data, float(F(dps)), int(grid_res), int(cap))
    total = lib.hako_split_to_cap(*args, None, None, None, 0)
    out = [np.empty((total, 9), F) for _ in range(3)]
    n = lib.hako_split_to_cap(*args, *(o.ctypes.data for o in out), total)
    if n != total:
        raise RuntimeError(f"split_to_cap: {n} triangles on the fill pass, "
                           f"{total} on the count pass")
    return tuple(o.reshape(-1, 3, 3) for o in out)


def split_to_cap_plain(verts, colors, emissions, origin, dps, grid_res: int,
                       cap: int):
    """Plain numpy version of split_to_cap: the same worklist, one f32
    scalar op at a time (numpy rounds each, so nothing is contracted)."""
    v, c, e = _as_rows(verts), _as_rows(colors), _as_rows(emissions)
    origin = np.asarray(origin, F)
    dps = F(dps)
    half = F(0.5)
    out_v, out_c, out_e = [], [], []
    for i in range(len(v)):
        stack = [(v[i], c[i], e[i])]
        while stack:
            tv, tc, te = stack.pop()
            tri = tv.reshape(1, 3, 3)
            if bbox_extent_in_voxels(tri, origin, dps, grid_res)[0] <= cap:
                out_v.append(tv)
                out_c.append(tc)
                out_e.append(te)
                continue
            el = []
            for k in range(3):
                a, b = 3 * k, 3 * ((k + 1) % 3)
                dx, dy, dz = (tv[b + j] - tv[a + j] for j in range(3))
                el.append(np.sqrt(dx * dx + dy * dy + dz * dz))
            w = 0
            if el[1] > el[w]:
                w = 1
            if el[2] > el[w]:
                w = 2
            a, b, o = 3 * w, 3 * ((w + 1) % 3), 3 * ((w + 2) % 3)
            parts = []
            for x in (tv, tc, te):
                mid = (x[a:a + 3] + x[b:b + 3]) * half
                parts.append((np.concatenate([x[a:a + 3], mid, x[o:o + 3]]),
                              np.concatenate([mid, x[b:b + 3], x[o:o + 3]])))
            stack.append(tuple(p[1] for p in parts))
            stack.append(tuple(p[0] for p in parts))
    if not out_v:
        return tuple(np.zeros((0, 3, 3), F) for _ in range(3))
    return tuple(np.stack(x).reshape(-1, 3, 3) for x in (out_v, out_c, out_e))


def pad_triangles(verts, colors, emissions, multiple: int):
    """Pad the triangle count to a multiple (degenerate zero triangles at
    the end voxelize to nothing)."""
    n = len(verts)
    m = (-n) % multiple
    if m == 0:
        return verts, colors, emissions
    z = np.zeros((m, 3, 3), F)
    return (
        np.concatenate([verts, z]),
        np.concatenate([colors, z]),
        np.concatenate([emissions, z]),
    )
