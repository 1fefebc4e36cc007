"""Scene sources for the apps (the port's copy of the JAX package's
apps/scenes.py): procedural generators, OBJ / PLY files, baked .npz
triangle-soup sequences (utils/objio.load_npz_frame) and Alembic archives
(utils/abcio). Host numpy; for the same arguments the arrays equal the
JAX package's bit for bit."""

from __future__ import annotations

import numpy as np

from ..utils import meshgen, objio


def load_scene(name: str):
    """Returns (verts f32[T,3,3], colors f32[T,3,3], emissions f32[T,3,3])."""
    if name.endswith(".obj") or name.endswith(".ply"):
        tri, col = objio.load(name)
        emi = np.zeros_like(tri)
        if col is None:
            lo, hi = meshgen.mesh_bounds(tri)
            col = meshgen.vertex_colors_from_position(tri, lo, hi)
        return tri, col, emi
    if name.endswith(".npz"):
        return objio.load_npz_frame(name, 0)
    if name.endswith(".abc"):
        from ..utils.abcio import AbcArchive

        ar = AbcArchive(name)
        try:
            return ar.read_flat(0)
        finally:
            ar.close()

    if name == "torus":
        tri = meshgen.torus_knot(n_seg=384, n_ring=28)
    elif name == "sphere":
        tri = meshgen.icosphere(4, radius=0.9)
    elif name == "bumpy":
        tri = meshgen.bumpy_sphere(5, radius=0.9)
    elif name == "soup":
        tri = meshgen.random_soup(200, seed=1, scale=0.8)
    else:
        raise SystemExit(f"unknown scene '{name}'")
    lo, hi = meshgen.mesh_bounds(tri)
    col = meshgen.vertex_colors_from_position(tri, lo, hi)
    emi = np.zeros_like(tri)
    return tri, col, emi


_ABC_CACHE: dict = {}
_LATTICE_CACHE: list = []


def _lattice_base():
    """Rest-pose contest-scale mesh (generated once per process: its 1.1M
    triangles take seconds of host trigonometry)."""
    if not _LATTICE_CACHE:
        _LATTICE_CACHE.append(meshgen.sphere_lattice(6, 4))
    return _LATTICE_CACHE[0]


def animated_scene(name: str, frame: int, total_frames: int):
    """Per-frame scene read: an Alembic archive (the reference's production
    input, RTCamp.cpp:95-109) or a procedural deforming mesh.

    Returns (verts, colors, emissions)."""
    if name.endswith(".abc"):
        from ..utils.abcio import AbcArchive

        if name not in _ABC_CACHE:
            _ABC_CACHE[name] = AbcArchive(name)
        return _ABC_CACHE[name].read_flat(frame)
    if name.endswith(".npz"):
        return objio.load_npz_frame(name, frame)
    t = frame / max(total_frames, 1)
    if name == "torus":
        tri = meshgen.torus_knot(
            p=2, q=3, n_seg=384, n_ring=28, tube=0.18 + 0.1 * np.sin(2 * np.pi * t)
        )
        ang = 2 * np.pi * t
        rot = np.array(
            [
                [np.cos(ang), 0, np.sin(ang)],
                [0, 1, 0],
                [-np.sin(ang), 0, np.cos(ang)],
            ],
            np.float32,
        )
        tri = tri @ rot.T
    elif name == "bumpy":
        tri = meshgen.bumpy_sphere(5, radius=0.9, bump=0.1 + 0.15 * t, freq=4 + 6 * t)
    elif name == "lattice":
        # reference-shaped contest scene: 1.1M triangles (the rtcamp9.abc
        # scene is 1.2M, seminar_ushio.pdf slide 67) at dragon-class voxel
        # density (54.4M unique @2048^3), rigidly tumbling per frame so
        # every frame is a full re-voxelize + rebuild like RTCamp.cpp:146.
        tri, col = _lattice_base()
        ang = 2 * np.pi * t
        c, s = np.cos(ang), np.sin(ang)
        rot_y = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
        a2 = 0.35 * np.sin(2 * np.pi * t)
        c2, s2 = np.cos(a2), np.sin(a2)
        rot_x = np.array([[1, 0, 0], [0, c2, -s2], [0, s2, c2]], np.float32)
        ctr = np.float32(0.5)
        tri = ((tri - ctr) @ (rot_x @ rot_y).T + ctr).astype(np.float32)
        return tri, col, np.zeros_like(tri)
    else:
        tri, _, _ = load_scene(name)
    lo, hi = meshgen.mesh_bounds(tri)
    col = meshgen.vertex_colors_from_position(tri, lo, hi)
    emi = np.zeros_like(tri)
    return tri.astype(np.float32), col, emi
