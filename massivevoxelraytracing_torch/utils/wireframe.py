"""Voxel wireframe overlay (the port's copy of the JAX package's
utils/wireframe.py, the drawVoxelsWire equivalent of voxUtil.hpp:79-127):
draw the 12 edges of each voxel AABB over a rendered frame. The edges are
projected with the same pinhole camera and rasterized into the image
(host numpy, depth-tested against the rendered depth buffer so hidden
edges stay hidden). Voxels are the port's int64 Morton codes."""

from __future__ import annotations

import numpy as np

from ..ops import morton as morton_ops

# voxel corner offsets (unit cube), edge index pairs -- the reference's
# i0..i7 / 12-edge topology
_CORNERS = np.array(
    [
        [0, 0, 0], [1, 0, 0], [1, 0, 1], [0, 0, 1],
        [0, 1, 0], [1, 1, 0], [1, 1, 1], [0, 1, 1],
    ],
    np.float32,
)
_EDGES = np.array(
    [
        [0, 1], [1, 2], [2, 3], [3, 0],
        [4, 5], [5, 6], [6, 7], [7, 4],
        [0, 4], [1, 5], [2, 6], [3, 7],
    ],
    np.int32,
)


def _project(cam, pts, width, height):
    """World points -> (x_px, y_px, view_depth)."""
    rel = pts - cam.o[None, :]
    z = rel @ cam.front
    x = rel @ cam.right
    y = rel @ cam.up
    zs = np.maximum(z, 1e-6)
    th = cam.tan_half_fovy
    aspect = width / height
    u = x / (zs * th * aspect)  # [-1, 1]
    v = y / (zs * th)
    px = (u + 1.0) * 0.5 * width
    py = (1.0 - (v + 1.0) * 0.5) * height
    return px, py, z


def draw_voxels_wire(
    img: np.ndarray, depth: np.ndarray, cam, morton, origin, dps,
    color=(255, 220, 40), max_voxels: int = 4096, n_sub: int = 12,
):
    """Overlay voxel wireframes in place on img (u8 [H, W, 3]); depth
    (f32 [H, W], primary-hit distances) hides occluded edge samples.
    Draws at most max_voxels voxels (evenly strided like a debug view)."""
    h, w = depth.shape
    m = np.asarray(morton, np.int64)
    if len(m) > max_voxels:
        m = m[:: len(m) // max_voxels + 1]
    if len(m) == 0:
        return img
    x, y, z = morton_ops.np_decode(m)
    base = np.asarray(origin, np.float32) + np.stack(
        [x, y, z], -1
    ).astype(np.float32) * np.float32(dps)

    # all edge endpoints, subdivided for depth-tested visibility
    p0 = base[:, None, :] + _CORNERS[_EDGES[:, 0]][None, :, :] * dps
    p1 = base[:, None, :] + _CORNERS[_EDGES[:, 1]][None, :, :] * dps
    ts = np.linspace(0.0, 1.0, n_sub, dtype=np.float32)
    pts = (
        p0[:, :, None, :] * (1.0 - ts)[None, None, :, None]
        + p1[:, :, None, :] * ts[None, None, :, None]
    ).reshape(-1, 3)

    px, py, pz = _project(cam, pts, w, h)
    xi = np.round(px).astype(np.int64)
    yi = np.round(py).astype(np.int64)
    ok = (pz > 1e-6) & (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
    xi, yi, pz = xi[ok], yi[ok], pz[ok]
    # depth test with a small bias: edges sit exactly on hit faces
    vis = pz <= depth[yi, xi] * 1.002 + 1e-4
    img[yi[vis], xi[vis]] = np.asarray(color, np.uint8)
    return img
