"""Radiance .hdr (RGBE) I/O and a procedural sky for asset-free runs (the
port's copy of the JAX package's utils/hdr.py).

`read_hdr` decodes the scanlines (new-style RLE or flat) with the port's
host C++ (csrc/host_io.cpp); `decode_plain` is its plain numpy version.
A failed build raises: there is no fallback to the Python loop.
"""

from __future__ import annotations

import ctypes

import numpy as np

F = np.float32


def _header(data: bytes):
    """(width, height, offset of the first scanline byte)."""
    p = 0
    while True:
        e = data.index(b"\n", p)
        if e == p:  # an empty line ends the header
            break
        p = e + 1
    res_end = data.index(b"\n", e + 1)
    toks = data[e + 1: res_end].decode().split()
    if len(toks) != 4 or toks[0] != "-Y" or toks[2] != "+X":
        raise ValueError(f"unsupported .hdr layout {' '.join(toks)!r}")
    return int(toks[3]), int(toks[1]), res_end + 1


def decode(pix: bytes, w: int, h: int) -> np.ndarray:
    """RGBE scanlines -> f32 [h, w, 3] with the host C++ decoder."""
    from . import host_build

    buf = np.frombuffer(pix, np.uint8)
    out = np.empty((h, w, 3), F)
    rc = host_build.load().hako_hdr_decode(
        buf.ctypes.data_as(ctypes.c_void_p), len(buf), w, h,
        out.ctypes.data_as(ctypes.c_void_p))
    if rc != 0:
        raise ValueError(f"malformed RGBE scanlines (decoder code {rc})")
    return out


def decode_plain(pix: bytes, w: int, h: int) -> np.ndarray:
    """The plain numpy version of `decode`."""
    pix = np.frombuffer(pix, np.uint8)
    out = np.zeros((h, w, 4), np.uint8)
    p = 0
    for y in range(h):
        if (len(pix) - p >= 4 and pix[p] == 2 and pix[p + 1] == 2
                and (int(pix[p + 2]) << 8 | int(pix[p + 3])) == w):
            p += 4
            for c in range(4):
                x = 0
                while x < w:
                    cnt = int(pix[p])
                    p += 1
                    if cnt > 128:  # run
                        out[y, x: x + cnt - 128, c] = pix[p]
                        p += 1
                        x += cnt - 128
                    else:  # literal
                        out[y, x: x + cnt, c] = pix[p: p + cnt]
                        p += cnt
                        x += cnt
        else:  # flat scanline
            out[y] = pix[p: p + 4 * w].reshape(w, 4)
            p += 4 * w
    e = out[..., 3].astype(np.int32)
    scale = np.where(e > 0, np.ldexp(F(1.0), e - 136), F(0.0)).astype(F)
    rgb = (out[..., :3].astype(F) + F(0.5)) * scale[..., None]
    return np.where((e > 0)[..., None], rgb, F(0.0)).astype(F)


def read_hdr(path: str) -> np.ndarray:
    """Radiance RGBE file (-Y h +X w) -> f32 [H, W, 3]."""
    with open(path, "rb") as f:
        data = f.read()
    w, h, off = _header(data)
    return decode(data[off:], w, h)


def write_hdr(path: str, img: np.ndarray) -> None:
    """f32 [H, W, 3] -> flat (non-RLE) Radiance file."""
    img = np.asarray(img, F)
    h, w = img.shape[:2]
    m = img.max(axis=2)
    e = np.zeros((h, w), np.int32)
    nz = m > 1e-32
    e[nz] = np.frexp(m[nz])[1]
    scale = np.where(nz, np.ldexp(1.0, -e) * 256.0, 0.0)
    rgbe = np.zeros((h, w, 4), np.uint8)
    rgbe[..., :3] = np.clip(img * scale[..., None], 0, 255).astype(np.uint8)
    rgbe[..., 3] = np.where(nz, e + 128, 0).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        f.write(rgbe.tobytes())


def procedural_sky(width: int = 512, height: int = 256,
                   sun_dir=(0.5, 0.6, 0.3), sun_intensity: float = 200.0,
                   sun_radius: float = 0.02, ground=0.25) -> np.ndarray:
    """Gradient sky + a bright sun disc (a sharp peak for the importance
    sampler to find). f32 [height, width, 3]."""
    sun = np.asarray(sun_dir, np.float64)
    sun /= np.linalg.norm(sun)
    y = (np.arange(height) + 0.5) / height
    x = (np.arange(width) + 0.5) / width
    theta = y * np.pi
    phi = x * 2 * np.pi - np.pi
    st = np.sin(theta)[:, None]
    dirs = np.stack(
        [np.cos(phi)[None, :] * st, np.cos(theta)[:, None] * np.ones((1, width)),
         np.sin(phi)[None, :] * st],
        axis=-1,
    )
    up = dirs[..., 1]
    sky = np.stack(
        [0.35 + 0.25 * up, 0.5 + 0.3 * up, 0.8 + 0.2 * up], axis=-1
    ).clip(0)
    grd = np.array([ground, ground * 0.9, ground * 0.7])
    img = np.where(up[..., None] > 0, sky, grd[None, None])
    cosang = (dirs * sun[None, None]).sum(-1)
    disc = cosang > np.cos(sun_radius)
    img = img + disc[..., None] * sun_intensity
    return img.astype(np.float32)
