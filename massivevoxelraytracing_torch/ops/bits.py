"""Bit helpers for u32 words held in signed integer tensors.

Torch has only partial uint32 support and `>>` on a signed tensor is an
arithmetic shift, so a u32 word is carried as an int32 bit pattern and
widened to int64 (masked to 32 bits) wherever the arithmetic needs
headroom or a logical shift. Counterpart of the reference's ops/bits.py
(only the helpers the HakoTree path uses).
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF


def u32(x: torch.Tensor) -> torch.Tensor:
    """Any integer tensor holding u32 bit patterns -> int64 in [0, 2^32)."""
    return x.to(torch.int64) & MASK32


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
