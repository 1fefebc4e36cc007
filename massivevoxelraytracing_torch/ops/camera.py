"""Pinhole camera (the reference's ops/camera.py: Camera.look_at,
np_frame_rays on the host, `shoot`, pixel rays on tensors, and
`shoot_thin_lens`, the thin lens's pixel rays). The path tracer's primary
ray is models/pathtracer.pt_sample's own."""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


@dataclasses.dataclass
class Camera:
    o: np.ndarray  # eye position f32[3]
    front: np.ndarray
    up: np.ndarray
    right: np.ndarray
    tan_half_fovy: float
    lens_r: float = 0.0
    focus: float = 1.0

    @staticmethod
    def look_at(eye, target, up=(0.0, 1.0, 0.0), fovy_deg: float = 45.0,
                lens_r: float = 0.0, focus: float | None = None) -> "Camera":
        eye = np.asarray(eye, np.float32)
        target = np.asarray(target, np.float32)
        front = target - eye
        dist = float(np.linalg.norm(front))
        front = front / dist
        upv = np.asarray(up, np.float32)
        right = np.cross(front, upv)
        right /= np.linalg.norm(right)
        up2 = np.cross(right, front)
        return Camera(
            o=eye,
            front=front.astype(np.float32),
            up=up2.astype(np.float32),
            right=right.astype(np.float32),
            tan_half_fovy=math.tan(math.radians(fovy_deg) * 0.5),
            lens_r=lens_r,
            focus=dist if focus is None else focus,
        )


def np_frame_rays(cam: Camera, width: int, height: int, off_x=0.5, off_y=0.5):
    """Host-side primary rays for a full frame (row-major pixel order)."""
    idx = np.arange(width * height)
    px = idx % width
    py = idx // width
    xf = (px + off_x) / width
    yf = (py + off_y) / height
    th = cam.tan_half_fovy
    u = (-th + 2.0 * th * xf) * (width / height)
    v = th - 2.0 * th * yf
    rd = (
        u[:, None] * cam.right[None, :]
        + v[:, None] * cam.up[None, :]
        + cam.front[None, :]
    ).astype(np.float32)
    ro = np.broadcast_to(cam.o, rd.shape).astype(np.float32)
    return ro, rd


def shoot(cam: Camera, px, py, off_x: float, off_y: float, width: int,
          height: int):
    """Pixel rays (CameraPinhole::shoot): px / py integer tensors [R], off
    in [0, 1). Returns (ro, rd) f32 [R, 3] on px's device, with the
    reference's float32 operations in its order; every divisor is a
    device tensor (on CUDA a Python-scalar divisor becomes a reciprocal
    multiply)."""
    dev = px.device
    f32 = torch.float32

    def c(x):
        return torch.tensor(x, dtype=f32, device=dev)

    xf = (px.to(f32) + c(off_x)) / c(float(width))
    yf = (py.to(f32) + c(off_y)) / c(float(height))
    th = c(np.float32(cam.tan_half_fovy))
    u = (-th + (2.0 * th) * xf) * c(np.float32(width / height))
    v = th - (2.0 * th) * yf
    right, up, front = (torch.as_tensor(np.asarray(a, np.float32), device=dev)
                        for a in (cam.right, cam.up, cam.front))
    rd = u[:, None] * right + v[:, None] * up + front
    ro = torch.as_tensor(np.asarray(cam.o, np.float32), device=dev).expand(
        rd.shape).contiguous()
    return ro, rd


def shoot_thin_lens(cam: Camera, px, py, off_x, off_y, width: int, height: int,
                    u0, u1):
    """Thin-lens rays (CameraPinhole::shootThinLens): a square lens in
    [-lens_r, lens_r]^2, the focal plane at `focus`. px / py integer
    tensors [R]; off_x / off_y floats or f32 tensors (broadcasting to [R]);
    u0 / u1 f32 tensors [R] in [0, 1) on the lens. Returns (ro, rd) f32
    [R, 3] on px's device, with the reference's float32 operations in its
    order and every divisor a device tensor."""
    dev = px.device
    f32 = torch.float32

    def c(x):
        return x if isinstance(x, torch.Tensor) else torch.tensor(x, dtype=f32, device=dev)

    xf = (px.to(f32) + c(off_x)) / c(float(width))
    yf = (py.to(f32) + c(off_y)) / c(float(height))
    th = c(np.float32(cam.tan_half_fovy))
    focus = c(np.float32(cam.focus))
    lens_r = c(np.float32(cam.lens_r))
    fx = focus * (-th + (2.0 * th) * xf) * c(np.float32(width / height))
    fy = focus * (th - (2.0 * th) * yf)
    lx = -lens_r + (2.0 * lens_r) * u0
    ly = -lens_r + (2.0 * lens_r) * u1
    dx = fx - lx
    dy = fy - ly
    right, up, front, o = (torch.as_tensor(np.asarray(a, np.float32), device=dev)
                           for a in (cam.right, cam.up, cam.front, cam.o))
    rd = dx[:, None] * right + dy[:, None] * up + focus * front
    ro = o + lx[:, None] * right + ly[:, None] * up
    return ro, rd
