"""Primary-ray renderer (the reference's models/raycast.py): one ray per
pixel, face-normal or voxel-color shading.

A frame is generated on the device directly in 128x128-tile-major order
(rays of one tile are neighbours, so they take similar paths through the
tree), traced in one call of the acceleration structure, shaded, and
un-tiled by a reshape. Rays of the padding past the frame's edge start
parked at 1e9, outside the root box, and miss at once.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import camera as camera_ops
from ..ops.traverse import hit_normal
from ..ops.voxelize import _f32, rgb8_to_f32
from . import accel as accel_lib

TILE = 128  # pixel tile edge
F32 = torch.float32


def _shade_flat(color_table, rd, t, nmaj, vidx, *, show_color: bool):
    hit = t < 1e37
    if show_color:
        idx = torch.clamp(vidx.to(torch.int64), 0, color_table.shape[0] - 1)
        col = rgb8_to_f32(color_table[idx])
    else:
        col = (hit_normal(nmaj, rd) + 1.0) * 0.5
    rgb = torch.where(hit[:, None], col, 0.0)
    img = torch.clamp(rgb * 255.0 + 0.5, 0, 255).to(torch.uint8)
    return img, t


def render_rays(tree, ro, rd, show_color: bool = False,
                traversal: str = "mega"):
    """Render arbitrary rays (f32 [N, 3], numpy or tensors) on the tree's
    device. Returns (u8 [N, 3], f32 [N])."""
    dev = tree.device
    ro = torch.as_tensor(ro, dtype=F32, device=dev).contiguous()
    rd = torch.as_tensor(rd, dtype=F32, device=dev).contiguous()
    kind, depth, meta, root = accel_lib.accel_args(tree, traversal)
    t, nmaj, vidx = accel_lib.intersect_with(
        kind, depth, meta, root, tree.lower, tree.upper, ro, rd)
    return _shade_flat(_color_table(tree), rd, t, nmaj, vidx,
                       show_color=show_color)


def tile_order(width: int, height: int, tile_w: int = 128, tile_h: int = 128):
    """Pixel permutation putting rectangular tiles contiguous."""
    idx = np.arange(width * height)
    px = idx % width
    py = idx // width
    key = (
        (py // tile_h) * ((width + tile_w - 1) // tile_w) + (px // tile_w)
    ) * (tile_w * tile_h) + (py % tile_h) * tile_w + (px % tile_w)
    return np.argsort(key, kind="stable")


def _gen_rays_tiled(cam_o, cam_right, cam_up, cam_front, tan_half_fovy, *,
                    width: int, height: int):
    """Whole-frame ray generation in 128x128-tile-major order."""
    return _gen_rays_band(
        cam_o, cam_right, cam_up, cam_front, tan_half_fovy, 0,
        width=width, height=height, band_tile_rows=-(-height // TILE),
    )


def _gen_rays_band(cam_o, cam_right, cam_up, cam_front, tan_half_fovy, py0,
                   *, width: int, height: int, band_tile_rows: int):
    """Tile-major rays for a band of tile rows starting at pixel row py0.
    cam_*: f32 [3] tensors and tan_half_fovy a 0-d f32 tensor, all on the
    target device. Float expressions in the reference's order; every
    divisor is a device tensor (on CUDA a CPU-scalar divisor becomes a
    reciprocal multiply)."""
    dev = cam_o.device
    ntx = -(-width // TILE)
    n_pad = ntx * TILE * band_tile_rows * TILE
    lane = torch.arange(n_pad, dtype=torch.int64, device=dev)
    ti = lane // (TILE * TILE)
    k = lane % (TILE * TILE)
    px = (ti % ntx) * TILE + (k % TILE)
    py = (ti // ntx) * TILE + (k // TILE) + py0
    live = (px < width) & (py < height)
    pxf = px.to(F32)
    pyf = py.to(F32)
    th = tan_half_fovy
    w = _f32(width, dev)
    h = _f32(height, dev)
    u = (-th + 2.0 * th * (pxf + 0.5) / w) * _f32(width / height, dev)
    v = th - 2.0 * th * (pyf + 0.5) / h
    rd = u[:, None] * cam_right + v[:, None] * cam_up + cam_front
    ro = torch.where(live[:, None], cam_o[None, :], 1e9)
    return ro.contiguous(), rd.contiguous()


def _shade_untile(color_table, rd, t, nmaj, vidx, *, width: int, height: int,
                  show_color: bool):
    ntx = -(-width // TILE)
    nty = -(-height // TILE)
    img, t = _shade_flat(color_table, rd, t, nmaj, vidx, show_color=show_color)

    def untile(x):
        c = tuple(x.shape[1:])
        y = x.reshape((nty, ntx, TILE, TILE) + c)
        y = y.permute((0, 2, 1, 3) + tuple(4 + i for i in range(len(c))))
        return y.reshape((nty * TILE, ntx * TILE) + c)[:height, :width]

    return untile(img), untile(t)


def _color_table(tree):
    if tree.color is not None:
        return tree.color
    return torch.zeros(1, dtype=torch.int32, device=tree.device)


def render_frame(tree, cam: camera_ops.Camera, width: int, height: int,
                 show_color: bool = False, *, device, traversal: str = "mega"):
    """Render one frame on `device`, where the tree must live, through the
    megakernel or the round driver (`traversal`, models/accel.py). Returns
    device tensors (u8 [H, W, 3] image, f32 [H, W] depth)."""
    device = torch.empty(0, device=device).device  # "cuda" -> "cuda:<current>"
    if tree.device != device:
        raise ValueError(f"tree lives on {tree.device}, not {device}")
    kind, depth, meta, root = accel_lib.accel_args(tree, traversal)
    ro, rd = _gen_rays_tiled(
        torch.as_tensor(cam.o, dtype=F32, device=device),
        torch.as_tensor(cam.right, dtype=F32, device=device),
        torch.as_tensor(cam.up, dtype=F32, device=device),
        torch.as_tensor(cam.front, dtype=F32, device=device),
        _f32(cam.tan_half_fovy, device),
        width=width, height=height,
    )
    t, nmaj, vidx = accel_lib.intersect_with(
        kind, depth, meta, root, tree.lower, tree.upper, ro, rd)
    return _shade_untile(_color_table(tree), rd, t, nmaj, vidx,
                         width=width, height=height, show_color=show_color)
