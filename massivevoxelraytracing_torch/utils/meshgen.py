"""Procedural test meshes (the port's copy of the part of the JAX package's
utils/meshgen.py that the port uses): the bench's sphere lattice, the
icosphere of the tests, a quad and grid fitting. Host numpy; the arrays
equal the reference's bit for bit."""

from __future__ import annotations

import numpy as np

F = np.float32


def icosphere(subdiv: int = 2, radius: float = 1.0, center=(0, 0, 0)):
    """Subdivided icosahedron; returns triangle soup f32[T, 3, 3]."""
    t = (1.0 + 5.0 ** 0.5) / 2.0
    verts = np.array(
        [
            [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
            [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
            [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
        ],
        np.float64,
    )
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ]
    )
    for _ in range(subdiv):
        new_faces = []
        mid_cache = {}
        verts = list(verts)

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in mid_cache:
                m = (np.asarray(verts[a]) + np.asarray(verts[b])) / 2.0
                m /= np.linalg.norm(m)
                mid_cache[key] = len(verts)
                verts.append(m)
            return mid_cache[key]

        for f in faces:
            a, b, c = int(f[0]), int(f[1]), int(f[2])
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        faces = np.array(new_faces)
        verts = np.array(verts)
    tri = verts[faces] * radius + np.asarray(center, np.float64)
    return tri.astype(F)


def bumpy_sphere(subdiv: int = 4, radius: float = 1.0, bump: float = 0.18,
                 freq: float = 6.0, center=(0, 0, 0)):
    """Icosphere displaced by a trig field (surface detail so voxel counts
    resemble a scanned model)."""
    tri = icosphere(subdiv, 1.0, (0, 0, 0)).astype(np.float64)
    p = tri.reshape(-1, 3)
    d = 1.0 + bump * (
        np.sin(freq * p[:, 0]) * np.sin(freq * 1.31 * p[:, 1])
        + np.cos(freq * 0.77 * p[:, 2]) * np.cos(freq * 1.13 * p[:, 0])
    ) * 0.5
    p = p * d[:, None] * radius + np.asarray(center, np.float64)
    return p.reshape(-1, 3, 3).astype(F)


def sphere_lattice(nsp: int = 6, subdiv: int = 4, radius_frac: float = 0.44,
                   bump: float = 0.15, freq: float = 5.0, seed: int = 11):
    """nsp^3 jittered bumpy spheres filling the unit cube: the bench scene.
    Returns (tri f32[T,3,3], colors f32[T,3,3]); use origin=0, dps=1/res."""
    base = bumpy_sphere(subdiv, radius=1.0, bump=bump, freq=freq)
    tris = []
    cols = []
    step = 1.0 / nsp
    r = radius_frac * step
    rng = np.random.default_rng(seed)
    for i in range(nsp):
        for j in range(nsp):
            for k in range(nsp):
                c = (np.array([i, j, k], F) + 0.5) * step
                c += rng.uniform(-0.08, 0.08, 3).astype(F) * step
                tris.append(base * r + c)
                col = 0.25 + 0.75 * rng.uniform(0, 1, 3).astype(F)
                cols.append(np.broadcast_to(col, base.shape).copy())
    return np.concatenate(tris), np.concatenate(cols)


def quad_plane(y: float = 0.0, half: float = 1.0, center=(0, 0, 0)):
    c = np.asarray(center, np.float64)
    v = np.array(
        [
            [-half, y, -half], [half, y, -half], [half, y, half],
            [-half, y, -half], [half, y, half], [-half, y, half],
        ]
    ) + c
    return v.reshape(2, 3, 3).astype(F)


def mesh_bounds(tri):
    return tri.reshape(-1, 3).min(axis=0), tri.reshape(-1, 3).max(axis=0)


def fit_grid(tri, grid_res: int, margin: float = 0.01):
    """Compute (origin, dps) so the mesh fits a grid_res^3 cube grid."""
    lo, hi = mesh_bounds(tri)
    extent = float((hi - lo).max()) * (1.0 + margin * 2)
    dps = extent / grid_res
    center = (lo + hi) * 0.5
    origin = center - extent * 0.5
    return origin.astype(F), F(dps)
