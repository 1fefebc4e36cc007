"""PMJ(0,2) sampling, Owen shuffling / scrambling and Lambertian sampling
(the port of the reference's ops/sampling.py).

The table (128 sequences x 4096 2-D points) is generated on the host by
the port's C++ (csrc/host_pmj.cpp, utils/host_build.py); `np_pmj02_samples`
is its plain version. `pmj_sample2d` and the samplers run on the device.

Transcendentals (sqrt aside) are evaluated in float64 and rounded to
float32 (`_f64`): torch's float32 kernels on the CPU round some of them
differently in their vector body and their scalar tail, so a lane's value
would depend on where the lane sits in the tensor. Rounded from float64,
a lane's value is a function of its inputs alone, on every device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .bits import nested_uniform_scramble, scramble_f32
from .hashing import hash_combine
from .rng import NpPCG32

LENGTH = 4096
N_SEQUENCE = 128
F32 = torch.float32

# pmj02 xor strata tables (Helmer stochastic generation, public algorithm)
_PMJ02_XORS = (
    (0x0, 0x0, 0x2, 0x6, 0x6, 0xE, 0x36, 0x4E, 0x16, 0x2E, 0x276, 0x6CE,
     0x716, 0xC2E, 0x3076, 0x40CE, 0x116, 0x22E, 0x20676, 0x60ECE, 0x61716,
     0xE2C2E, 0x367076, 0x4EC0CE, 0x170116, 0x2C022E, 0x2700676, 0x6C00ECE,
     0x7001716, 0xC002C2E, 0x30007076, 0x4000C0CE),
    (0x0, 0x1, 0x3, 0x3, 0x7, 0x1B, 0x27, 0xB, 0x17, 0x13B, 0x367, 0x38B,
     0x617, 0x183B, 0x2067, 0x8B, 0x117, 0x1033B, 0x30767, 0x30B8B, 0x71617,
     0x1B383B, 0x276067, 0xB808B, 0x160117, 0x138033B, 0x3600767, 0x3800B8B,
     0x6001617, 0x1800383B, 0x20006067, 0x808B),
)


def _f64(fn, x: torch.Tensor) -> torch.Tensor:
    """fn evaluated in float64, rounded to float32 (module docstring)."""
    return fn(x.to(torch.float64)).to(F32)


def np_pmj02_samples(num_samples: int, uniform) -> np.ndarray:
    """One pmj02 sequence on the host (float32 [n, 2]); `uniform` returns
    floats in [0, 1). Plain version of the C++ generator."""
    s = np.zeros((num_samples, 2), np.float64)
    s[0, 0] = uniform()
    s[0, 1] = uniform()
    log_n = 0
    while (1 << log_n) < num_samples:
        prev_len = 1 << log_n
        n_strata = prev_len * 2
        i_strata = 1.0 / n_strata
        for i in range(prev_len):
            if prev_len + i >= num_samples:
                break
            prev_x_idx = i ^ _PMJ02_XORS[0][log_n]
            x_stratum = int(s[prev_x_idx, 0] * n_strata) ^ 1
            prev_y_idx = i ^ _PMJ02_XORS[1][log_n]
            y_stratum = int(s[prev_y_idx, 1] * n_strata) ^ 1
            s[prev_len + i, 0] = (uniform() + x_stratum) * i_strata
            s[prev_len + i, 1] = (uniform() + y_stratum) * i_strata
        log_n += 1
    return s.astype(np.float32)


def make_pmj_table_plain(n_sequence: int = N_SEQUENCE, length: int = LENGTH,
                         seed: int = 0, stream: int = 2525) -> np.ndarray:
    rng = NpPCG32(seed, stream)
    out = np.zeros((n_sequence, length, 2), np.float32)
    for i in range(n_sequence):
        out[i] = np_pmj02_samples(length, rng.uniformf)
    return out


def make_pmj_table(n_sequence: int = N_SEQUENCE, length: int = LENGTH,
                   seed: int = 0, stream: int = 2525) -> np.ndarray:
    """All sequences: f32 [n_sequence, length, 2] (PMJSampler::setup), from
    the host library."""
    from ..utils import host_build

    out = np.empty((n_sequence, length, 2), np.float32)
    host_build.load().hako_pmj02_table(n_sequence, length, seed, stream,
                                       out.ctypes.data)
    return out


def pmj_sample2d(table, sample_idx, dimension, stream):
    """Owen-shuffled, Owen-scrambled 2-D sample (PMJSampler::sample2d).
    sample_idx / stream: u32 int64 tensors; dimension: u32 int or tensor;
    table: f32 [n_sequence, length, 2] (indices past a smaller table clamp
    to its last point, as the reference's take(mode="clip") does)."""
    dimension = torch.as_tensor(dimension, dtype=torch.int64,
                                device=stream.device)
    sample_idx = nested_uniform_scramble(
        sample_idx, hash_combine(stream, dimension, 31082745)) & (LENGTH - 1)
    dim = nested_uniform_scramble(
        dimension, hash_combine(stream, 54761983)) & (N_SEQUENCE - 1)
    flat = table.reshape(-1, 2)
    lin = torch.clamp(dim * LENGTH + sample_idx, 0, flat.shape[0] - 1)
    pt = flat[lin]
    x = scramble_f32(pt[..., 0], hash_combine(stream, dim, 83927105))
    y = scramble_f32(pt[..., 1], hash_combine(stream, dim, 12654890))
    return x, y


def orthonormal_basis(z: torch.Tensor):
    """Branchless ONB (Duff et al.). z: f32[..., 3] -> (x, y) axes."""
    z0, z1, z2 = z[..., 0], z[..., 1], z[..., 2]
    sign = torch.where(z2 >= 0.0, 1.0, -1.0).to(z.dtype)
    a = torch.full_like(z2, -1.0) / (sign + z2)
    b = z0 * z1 * a
    x = torch.stack([1.0 + sign * z0 * z0 * a, sign * b, -sign * z0], dim=-1)
    y = torch.stack([b, sign + z1 * z1 * a, -z1], dim=-1)
    return x, y


def sample_lambertian(a, b, ng):
    """Cosine-hemisphere direction around ng (sampleLambertian). a/b
    uniform [0, 1), ng f32[..., 3]."""
    r = torch.sqrt(a)
    theta = b * (2.0 * math.pi)
    x = r * _f64(torch.cos, theta)
    y = r * _f64(torch.sin, theta)
    z = torch.sqrt(torch.clamp(1.0 - a, min=0.0))
    xa, ya = orthonormal_basis(ng)
    return xa * x[..., None] + ya * y[..., None] + ng * z[..., None]


def luminance(rgb):
    """Rec.709 luma."""
    return 0.2126 * rgb[..., 0] + 0.7152 * rgb[..., 1] + 0.0722 * rgb[..., 2]
