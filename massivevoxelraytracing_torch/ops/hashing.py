"""Streaming 32-bit MurmurHash3 on u32 values held in int64 tensors (the
port of the reference's ops/hashing.py).

`murmur_*` is the incremental form (word at a time, length counted in
words * 4 bytes) the path tracer derives its sample streams with;
`np_murmur3_x86_32` is the canonical byte-stream MurmurHash3_x86_32 on the
host, the oracle the incremental form agrees with on 4-byte-aligned input;
`host_murmur3_32` the same function in the host library's C++
(csrc/host_morton.cpp).

A value is an int64 tensor in [0, 2^32) or a python int (a constant word,
which broadcasts and stays on no device). A 32 x 32 product can pass 2^63
and wrap, but its low 32 bits survive, so every multiply and left shift is
masked with 0xFFFFFFFF.
"""

from __future__ import annotations

import ctypes

import numpy as np

from .bits import MASK32, u32


def fmix32(h):
    h = u32(h)
    h = h ^ (h >> 16)
    h = (h * 0x85EBCA6B) & MASK32
    h = h ^ (h >> 13)
    h = (h * 0xC2B2AE35) & MASK32
    return h ^ (h >> 16)


def rotl32(x, r: int):
    x = u32(x)
    return ((x << r) & MASK32) | (x >> (32 - r))


def murmur_init(seed):
    """Returns hash state (h1, n_words)."""
    return u32(seed), 0


def murmur_combine(state, k1):
    h1, n = state
    k1 = (u32(k1) * 0xCC9E2D51) & MASK32
    k1 = rotl32(k1, 15)
    k1 = (k1 * 0x1B873593) & MASK32
    h1 = rotl32(h1 ^ k1, 13)
    h1 = (h1 * 5 + 0xE6546B64) & MASK32
    return h1, n + 1


def murmur_get(state):
    h1, n = state
    return fmix32(h1 ^ ((n * 4) & MASK32))


def hash_combine(*ks):
    """hashCombine(a, b[, c[, d]]): seed with the first word, mix the rest."""
    state = murmur_init(ks[0])
    for k in ks[1:]:
        state = murmur_combine(state, k)
    return murmur_get(state)


def np_murmur3_x86_32(data: bytes, seed: int = 0) -> int:
    """Canonical byte-stream MurmurHash3 (public domain algorithm by Austin
    Appleby), on the host."""
    c1 = 0xCC9E2D51
    c2 = 0x1B873593
    h1 = seed & MASK32
    nblocks = len(data) // 4
    for i in range(nblocks):
        k1 = int.from_bytes(data[4 * i: 4 * i + 4], "little")
        k1 = (k1 * c1) & MASK32
        k1 = ((k1 << 15) | (k1 >> 17)) & MASK32
        k1 = (k1 * c2) & MASK32
        h1 ^= k1
        h1 = ((h1 << 13) | (h1 >> 19)) & MASK32
        h1 = (h1 * 5 + 0xE6546B64) & MASK32
    tail = data[nblocks * 4:]
    k1 = 0
    if len(tail) >= 3:
        k1 ^= tail[2] << 16
    if len(tail) >= 2:
        k1 ^= tail[1] << 8
    if len(tail) >= 1:
        k1 ^= tail[0]
        k1 = (k1 * c1) & MASK32
        k1 = ((k1 << 15) | (k1 >> 17)) & MASK32
        k1 = (k1 * c2) & MASK32
        h1 ^= k1
    h1 ^= len(data)
    h1 ^= h1 >> 16
    h1 = (h1 * 0x85EBCA6B) & MASK32
    h1 ^= h1 >> 13
    h1 = (h1 * 0xC2B2AE35) & MASK32
    h1 ^= h1 >> 16
    return h1


def host_murmur3_32(data: bytes, seed: int = 0) -> int:
    """np_murmur3_x86_32 through the host library's C++."""
    from ..utils import host_build

    buf = np.frombuffer(data, np.uint8) if data else np.zeros(1, np.uint8)
    return int(host_build.load().hako_murmur3_32(
        buf.ctypes.data_as(ctypes.c_void_p), len(data), seed & MASK32))
