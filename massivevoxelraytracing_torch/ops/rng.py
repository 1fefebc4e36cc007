"""PCG32 (XSH-RR) and the LCG shuffler (the port of the reference's
ops/rng.py).

The reference carries the 64-bit PCG state as (hi, lo) u32 limbs because
JAX runs with x64 off. Here a u64 is one int64 tensor holding its bits:
multiply and add wrap mod 2^64 as in unsigned arithmetic, and since torch's
`>>` on int64 is arithmetic, the logical shifts PCG needs are masked
(`_lsr`). `NpPCG32` is the host generator, the exact oracle.
"""

from __future__ import annotations

import numpy as np
import torch

from .bits import MASK32

MULT = 6364136223846793005  # < 2^63: a plain int64 constant
_U64 = (1 << 64) - 1


def _lsr(x: torch.Tensor, n: int) -> torch.Tensor:
    """Logical right shift of the u64 bits held in int64 x, 0 < n < 64."""
    return (x >> n) & ((1 << (64 - n)) - 1)


def _u64(v) -> torch.Tensor:
    """A u32/u64 value, a (hi, lo) pair of u32 tensors or ints, or an
    integer tensor -> int64 tensor holding the u64 bits."""
    if isinstance(v, tuple):
        hi, lo = (_u64(x) & MASK32 for x in v)
        return (hi << 32) | lo
    if isinstance(v, torch.Tensor):
        return v.to(torch.int64)
    v = int(v) & _U64
    return torch.tensor(v - (1 << 64) if v >> 63 else v, dtype=torch.int64)


def pcg32_init(seed, stream):
    """PCG32::setup: state = 0, inc = stream * 2 + 1, step, state += seed,
    step. seed/stream: u32 tensors (or ints, or (hi, lo) pairs). Returns
    (state, inc) int64 tensors."""
    seed, stream = _u64(seed), _u64(stream)
    inc = (stream << 1) | 1
    state, _ = pcg32_next(torch.zeros_like(inc), inc)
    state, _ = pcg32_next(state + seed, inc)
    return state, inc


def pcg32_next(state, inc):
    """One PCG32 step: returns (new_state, u32 output as int64)."""
    old = state
    new_state = old * MULT + inc  # wraps mod 2^64
    xorshifted = _lsr(_lsr(old, 18) ^ old, 27) & MASK32
    rot = _lsr(old, 59)
    out = (xorshifted >> rot) | ((xorshifted << ((-rot) & 31)) & MASK32)
    return new_state, out


def lcg_shuffle(i, a, c, n):
    """(a * i + c) mod n: bandwidth-optimal random permutation when
    gcd(a, n) == 1. i: u32 int64 tensor; a, c, n: u32 ints. The 64-bit
    product is split at bit 16 of i so every term stays below 2^63."""
    i = i.to(torch.int64) & MASK32
    r = ((a * (i >> 16)) % n) * 65536 + a * (i & 0xFFFF) + c
    return r % n


def lcg_try_init(r0: int, r1: int, n: int):
    """Host-side: returns (a, c, n) or None if gcd(a, n) != 1."""
    a = int(r0) & MASK32
    c = int(r1) & MASK32
    n = int(n) & MASK32
    return (a, c, n) if np.gcd(a, n) == 1 else None


class NpPCG32:
    """Host PCG32 on python ints: the exact oracle and the PMJ table's
    generator in its plain version."""

    def __init__(self, seed: int, stream: int):
        self.state = 0
        self.inc = ((stream << 1) | 1) & _U64
        self.next_u32()
        self.state = (self.state + seed) & _U64
        self.next_u32()

    def next_u32(self) -> int:
        old = self.state
        self.state = (old * MULT + self.inc) & _U64
        xorshifted = (((old >> 18) ^ old) >> 27) & MASK32
        rot = old >> 59
        return ((xorshifted >> rot) | (xorshifted << ((-rot) & 31))) & MASK32

    def uniformf(self) -> float:
        bits = ((self.next_u32() >> 9) | 0x3F800000) & MASK32
        return float(np.frombuffer(np.uint32(bits).tobytes(), np.float32)[0]) - 1.0
