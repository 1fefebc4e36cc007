"""Morton (Z-order) codes for 3 x 21-bit coordinates as one int64.

The reference (ops/morton.py) carries the 63-bit code as a (hi, lo) pair
of u32 limbs only because JAX runs with x64 off. Here the code is a
single int64 tensor with the same bit layout: coordinate bit i of x, y, z
lands at bit 3i, 3i+1, 3i+2. Every code is below 2^63, so the signed
shifts below never see a sign bit. `to_pair` / `from_pair` convert to and
from the reference's limbs; `np_encode` / `np_decode` take and give host
numpy arrays. `encode_naive` / `decode_naive` are the reference's bit-loop
codecs (its test oracle), `host_encode` / `host_decode` the host library's
C++ codec (csrc/host_morton.cpp).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

MAX_COORD_BITS = 21
_C21 = (1 << MAX_COORD_BITS) - 1


def _part1by2(x: torch.Tensor) -> torch.Tensor:
    """Spread the low 21 bits of x to stride-3 positions 0, 3, ..., 60."""
    x = x.to(torch.int64) & _C21
    x = (x | (x << 32)) & 0x1F00000000FFFF
    x = (x | (x << 16)) & 0x1F0000FF0000FF
    x = (x | (x << 8)) & 0x100F00F00F00F00F
    x = (x | (x << 4)) & 0x10C30C30C30C30C3
    x = (x | (x << 2)) & 0x1249249249249249
    return x


def _compact1by2(x: torch.Tensor) -> torch.Tensor:
    """Inverse of _part1by2."""
    x = x & 0x1249249249249249
    x = (x ^ (x >> 2)) & 0x10C30C30C30C30C3
    x = (x ^ (x >> 4)) & 0x100F00F00F00F00F
    x = (x ^ (x >> 8)) & 0x1F0000FF0000FF
    x = (x ^ (x >> 16)) & 0x1F00000000FFFF
    x = (x ^ (x >> 32)) & _C21
    return x


def encode(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Interleave three 21-bit coordinates into an int64 Morton code
    (bit-for-bit the reference's morton.encode, as one word)."""
    return _part1by2(x) | (_part1by2(y) << 1) | (_part1by2(z) << 2)


def decode(code: torch.Tensor):
    """int64 Morton code -> (x, y, z) int64 coordinates."""
    return _compact1by2(code), _compact1by2(code >> 1), _compact1by2(code >> 2)


def to_pair(code: torch.Tensor):
    """int64 code -> the reference's (hi, lo) limbs, as int64 tensors
    holding u32 values."""
    return code >> 32, code & 0xFFFFFFFF


def from_pair(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """(hi, lo) limbs (any integer dtype, u32 values) -> int64 code."""
    return ((hi.to(torch.int64) & 0xFFFFFFFF) << 32) | (lo.to(torch.int64) & 0xFFFFFFFF)


def np_encode(x, y, z) -> np.ndarray:
    """`encode` on host numpy arrays or scalars: int64 Morton codes."""
    return encode(*(torch.as_tensor(np.asarray(a).astype(np.int64))
                    for a in (x, y, z))).numpy()


def np_decode(code):
    """`decode` on host numpy arrays: int64 (x, y, z)."""
    c = torch.as_tensor(np.asarray(code).astype(np.int64))
    return tuple(v.numpy() for v in decode(c))


def encode_naive(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Bit-loop codec (the reference's encode_naive, morton.hpp:5-16): bit i
    of x, y, z to bits 3i, 3i+1, 3i+2 of an int64 code, one bit at a time."""
    code = torch.zeros_like(x, dtype=torch.int64)
    for i in range(MAX_COORD_BITS):
        for off, v in ((0, x), (1, y), (2, z)):
            code = code | (((v.to(torch.int64) >> i) & 1) << (3 * i + off))
    return code


def decode_naive(code: torch.Tensor):
    """Inverse of encode_naive, one bit at a time: int64 (x, y, z)."""
    out = [torch.zeros_like(code) for _ in range(3)]
    for i in range(MAX_COORD_BITS):
        for off in range(3):
            out[off] = out[off] | (((code >> (3 * i + off)) & 1) << i)
    return tuple(out)


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def host_encode(x, y, z) -> np.ndarray:
    """The host library's C++ codec (magic bits) on numpy arrays of 21-bit
    coordinates: int64 Morton codes, bit for bit `np_encode`'s."""
    from ..utils import host_build

    x, y, z = (np.ascontiguousarray(a, np.uint32) for a in (x, y, z))
    if not x.shape == y.shape == z.shape or x.ndim != 1:
        raise ValueError(f"x, y, z must be 1-D of one length: {x.shape} {y.shape} {z.shape}")
    out = np.empty(x.shape[0], np.uint64)
    host_build.load().hako_morton_encode(_ptr(x), _ptr(y), _ptr(z), x.shape[0], _ptr(out))
    return out.view(np.int64)


def host_decode(code) -> tuple:
    """Inverse of host_encode on the host: int64 (x, y, z)."""
    from ..utils import host_build

    m = np.ascontiguousarray(code, np.int64).view(np.uint64)
    if m.ndim != 1:
        raise ValueError(f"codes must be 1-D, not {m.shape}")
    xyz = [np.empty(m.shape[0], np.uint32) for _ in range(3)]
    host_build.load().hako_morton_decode(_ptr(m), m.shape[0], *map(_ptr, xyz))
    return tuple(a.astype(np.int64) for a in xyz)
