"""Bit helpers for u32 words held in signed integer tensors.

Torch has only partial uint32 support and `>>` on a signed tensor is an
arithmetic shift, so a u32 word is carried as an int32 bit pattern and
widened to int64 (masked to 32 bits) wherever the arithmetic needs
headroom or a logical shift. Counterpart of the reference's ops/bits.py
(the helpers the HakoTree traversal and the path tracer use).
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF


def u32(x):
    """Any integer tensor holding u32 bit patterns -> int64 in [0, 2^32);
    a python int -> its low 32 bits."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & MASK32
    return int(x) & MASK32


def to_i32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 holding a u32 value (or any value: its low 32 bits count)
    -> int32 with the same bit pattern. Wraps explicitly, so the cast
    never depends on out-of-range conversion behaviour."""
    v = x & MASK32
    return (v - ((v >> 31) << 32)).to(torch.int32)


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Population count of u32 bit patterns (SWAR, the reference's
    hako_kernels._pc32, done in int64). Returns int64."""
    v = u32(x)
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & MASK32) >> 24


# ---------------------------------------------------------------------------
# Owen scrambling and u32 -> float (the reference's ops/bits.py:38-77), on
# u32 values held in int64 tensors; every multiply is masked to 32 bits
# (its low 32 bits survive an int64 wrap)
# ---------------------------------------------------------------------------

def reverse_bits(v: torch.Tensor) -> torch.Tensor:
    """Bit-reverse a u32 (classic swap ladder). Returns int64."""
    v = u32(v)
    v = ((v >> 1) & 0x55555555) | ((v & 0x55555555) << 1)
    v = ((v >> 2) & 0x33333333) | ((v & 0x33333333) << 2)
    v = ((v >> 4) & 0x0F0F0F0F) | ((v & 0x0F0F0F0F) << 4)
    v = ((v >> 8) & 0x00FF00FF) | ((v & 0x00FF00FF) << 8)
    return (v >> 16) | ((v << 16) & MASK32)


def laine_karras_permutation(x, seed):
    x = (u32(x) + seed) & MASK32
    x = x ^ ((x * 0x6C50B47C) & MASK32)
    x = x ^ ((x * 0xB82F1E52) & MASK32)
    x = x ^ ((x * 0xC7AFE638) & MASK32)
    return x ^ ((x * 0x8D22F6E6) & MASK32)


def nested_uniform_scramble(x, seed):
    """Owen scrambling of an index: reverse o laine_karras o reverse."""
    return reverse_bits(laine_karras_permutation(reverse_bits(x), seed))


def _as_f32(bits: torch.Tensor) -> torch.Tensor:
    """int64 holding a u32 bit pattern -> the f32 with those bits."""
    return to_i32_bits(bits).view(torch.float32)


def uniformf(x: torch.Tensor) -> torch.Tensor:
    """u32 -> float in [0, 1) via mantissa stuffing."""
    return _as_f32((u32(x) >> 9) | 0x3F800000) - 1.0


def scramble_f32(x: torch.Tensor, seed) -> torch.Tensor:
    """Owen-scramble the mantissa of a float in [0, 1)."""
    bits = u32((x.to(torch.float32) + 1.0).view(torch.int32))  # [1, 2)
    scrambled = 0x3F800000 | (
        nested_uniform_scramble(bits & 0x7FFFFF, seed) & 0x7FFFFF)
    return _as_f32(scrambled) - 1.0
