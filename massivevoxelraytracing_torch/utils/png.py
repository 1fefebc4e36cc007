"""Minimal PNG codec (RGB8 / RGBA8) on the host (the port's copy of the
JAX package's utils/png.py).

`encode` compresses with the standard library's zlib at the given level
(1 by default: fast; 0 stores), which is the stream the JAX package's
native encoder writes with the same zlib (compress2 at that level), so the
bytes are the same. No C library links zlib here: the host library stays
buildable on a machine without zlib headers.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (
        struct.pack(">I", len(data))
        + tag
        + data
        + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
    )


def encode(img: np.ndarray, compress_level: int = 1) -> bytes:
    """img: u8[H, W, 3|4] -> PNG bytes (filter 0 on every scanline)."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] not in (3, 4):
        raise ValueError(f"expected u8 [H, W, 3|4], got {img.dtype} {img.shape}")
    h, w, c = img.shape
    color_type = 2 if c == 3 else 6
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, -1)], axis=1)
    idat = zlib.compress(raw.tobytes(), compress_level)
    return (
        b"\x89PNG\r\n\x1a\n"
        + _chunk(b"IHDR", ihdr)
        + _chunk(b"IDAT", idat)
        + _chunk(b"IEND", b"")
    )


def write(path: str, img: np.ndarray, compress_level: int = 1) -> None:
    data = encode(img, compress_level)
    with open(path, "wb") as f:
        f.write(data)


def read(path: str) -> np.ndarray:
    """PNG -> u8 [H, W, 3|4] (8-bit RGB / RGBA, no interlace, filter 0: the
    files `write` makes)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG file")
    pos = 8
    idat = b""
    w = h = c = None
    while pos < len(data):
        (ln,) = struct.unpack(">I", data[pos: pos + 4])
        tag = data[pos + 4: pos + 8]
        payload = data[pos + 8: pos + 8 + ln]
        pos += 12 + ln
        if tag == b"IHDR":
            w, h, depth, color_type, _, _, interlace = struct.unpack(
                ">IIBBBBB", payload)
            if depth != 8 or interlace != 0 or color_type not in (2, 6):
                raise ValueError(f"{path}: unsupported PNG layout")
            c = {2: 3, 6: 4}[color_type]
        elif tag == b"IDAT":
            idat += payload
        elif tag == b"IEND":
            break
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + w * c)
    if not np.all(raw[:, 0] == 0):
        raise ValueError(f"{path}: only filter 0 is supported")
    return raw[:, 1:].reshape(h, w, c).copy()
