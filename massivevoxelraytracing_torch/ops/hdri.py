"""HDR environment map: equirect radiance + importance-sampling tables (the
port of the reference's ops/hdri.py).

`load` builds the tables on the host in numpy exactly as the reference
does (one unweighted + six axis-cosine-weighted importance tables, each as
a u32 2-D prefix table and as Walker alias tables) and moves them to the
device. Sampling runs on the device: nearest-texel lookup, and importance
sampling through the alias tables (the default) or the reference's binary
search over the prefix tables.

u32 prefix values are held in int64 tensors; their differences are taken
in int64 and masked to 32 bits, which equals the reference's wrapping u32
arithmetic. Every divisor is a tensor on the operands' device (on CUDA,
torch turns a division by a python scalar into a reciprocal multiply).
Transcendentals and square roots go through float64 (sampling._f64).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .bits import MASK32
from .sampling import _f64

F32 = torch.float32
I64 = torch.int64

AXES = np.array(
    [
        [1.0, 0.0, 0.0], [-1.0, 0.0, 0.0],
        [0.0, 1.0, 0.0], [0.0, -1.0, 0.0],
        [0.0, 0.0, 1.0], [0.0, 0.0, -1.0],
    ],
    np.float32,
)


@dataclasses.dataclass
class HDRI:
    """Device-side environment state: tensors plus the dims and scale.

    Two sampling backends over identical texel distributions: `sats`
    (u32 2-D prefix tables + binary search, the original scheme) and the
    Walker alias tables (`alias_*`, the default)."""

    pixels: torch.Tensor          # f32 [H, W, 3] secondary (sampling) image
    pixels_primary: torch.Tensor  # f32 [Hp, Wp, 3] camera-visible image
    sats: torch.Tensor            # int64 [7, H, W] u32 prefix tables
    alias_prob: torch.Tensor      # f32 [7, H*W] acceptance probability
    alias_idx: torch.Tensor       # int64 [7, H*W] alias target
    alias_pdf: torch.Tensor       # f32 [7, H*W] texel selection probability
    width: int
    height: int
    width_primary: int
    height_primary: int
    scale: float = 1.75
    use_alias: bool = True

    @property
    def enabled(self) -> bool:
        return self.scale > 0.0

    @property
    def device(self) -> torch.device:
        return self.pixels.device

    def to(self, device) -> "HDRI":
        moved = {f.name: getattr(self, f.name).to(device)
                 for f in dataclasses.fields(self)
                 if isinstance(getattr(self, f.name), torch.Tensor)}
        return dataclasses.replace(self, **moved)


def _build_alias(weights: np.ndarray):
    """Walker alias method (O(n) construction). weights: f64 [N].
    Returns (prob f32, alias i32, pdf f32)."""
    n = len(weights)
    total = weights.sum()
    if total <= 0:
        weights = np.ones_like(weights)
        total = float(n)
    p = weights / total
    # the loop runs on python floats (the same f64 arithmetic as numpy
    # scalars, without their per-element overhead)
    scaled = (p * n).tolist()
    prob = [1.0] * n
    alias = list(range(n))
    small = [i for i in range(n) if scaled[i] < 1.0]
    large = [i for i in range(n) if scaled[i] >= 1.0]
    while small and large:
        s = small.pop()
        l = large.pop()
        prob[s] = scaled[s]
        alias[s] = l
        scaled[l] = scaled[l] - (1.0 - scaled[s])
        (small if scaled[l] < 1.0 else large).append(l)
    return (np.asarray(prob, np.float64).astype(np.float32),
            np.asarray(alias, np.int32), p.astype(np.float32))


def _solid_angle_weights(width: int, height: int) -> np.ndarray:
    y = np.arange(height, dtype=np.float64)
    d_theta = np.pi / height
    d_phi = 2.0 * np.pi / width
    theta = y * d_theta
    # dH = cos(theta) - cos(theta+dTheta) = 2 sin(dT/2) sin(dT/2 + theta)
    dh = 2.0 * np.sin(d_theta * 0.5) * np.sin(d_theta * 0.5 + theta)
    return (dh * d_phi)[:, None]  # [H, 1]


def _texel_dirs(width: int, height: int) -> np.ndarray:
    """Center direction of each texel."""
    y = np.arange(height, dtype=np.float64)
    x = np.arange(width, dtype=np.float64)
    d_theta = np.pi / height
    d_phi = 2.0 * np.pi / width
    theta = y * d_theta
    s_y = 0.5 * (np.cos(theta) + np.cos(theta + d_theta))
    phi = d_phi * (x + 0.5) + np.pi
    s_x = np.cos(phi)
    s_z = np.sin(phi)
    sin_theta = np.sqrt(np.maximum(1.0 - s_y**2, 0.0))
    dirs = np.zeros((height, width, 3))
    dirs[..., 0] = s_x[None, :] * sin_theta[:, None]
    dirs[..., 1] = s_y[:, None]
    dirs[..., 2] = s_z[None, :] * sin_theta[:, None]
    return dirs


def _build_sat_u32(importance: np.ndarray) -> np.ndarray:
    """Row-then-column inclusive 2-D prefix, normalized to u32."""
    sat = np.cumsum(np.cumsum(importance, axis=1), axis=0)
    total = sat[-1, -1]
    if total <= 0:
        total = 1.0
    return (sat / total * float(0xFFFFFFFF)).astype(np.uint32)


def load(pixels: np.ndarray, pixels_primary: np.ndarray | None = None,
         scale: float = 1.75, use_alias: bool = True, *,
         device="cuda") -> HDRI:
    """Build the 7 sampling tables from an f32 [H, W, 3] radiance image on
    the host, then move everything to `device`."""
    pixels = np.asarray(pixels, np.float32)
    h, w = pixels.shape[:2]
    lum = (
        0.2126 * pixels[..., 0]
        + 0.7152 * pixels[..., 1]
        + 0.0722 * pixels[..., 2]
    ).astype(np.float64)
    sr = _solid_angle_weights(w, h)
    dirs = _texel_dirs(w, h)
    importances = [lum * sr]
    for axis in AXES:
        cosw = np.maximum((dirs * axis[None, None]).sum(-1), 0.0)
        importances.append(lum * sr * cosw)
    sats = [_build_sat_u32(imp) for imp in importances]
    probs, aliases, pdfs = zip(
        *[_build_alias(imp.reshape(-1)) for imp in importances]
    )
    if pixels_primary is None:
        pixels_primary = pixels
    pixels_primary = np.asarray(pixels_primary, np.float32)

    def dev(a, dtype=None):
        t = torch.from_numpy(np.ascontiguousarray(a))
        return t.to(device=device, dtype=dtype or t.dtype)

    return HDRI(
        pixels=dev(pixels[..., :3]),
        pixels_primary=dev(pixels_primary[..., :3]),
        sats=dev(np.stack(sats).astype(np.int64)),
        alias_prob=dev(np.stack(probs)),
        alias_idx=dev(np.stack(aliases), I64),
        alias_pdf=dev(np.stack(pdfs)),
        width=w,
        height=h,
        width_primary=pixels_primary.shape[1],
        height_primary=pixels_primary.shape[0],
        scale=scale,
        use_alias=use_alias,
    )


def _c(x, like: torch.Tensor) -> torch.Tensor:
    """An f32 constant on like's device (a divisor or factor)."""
    return torch.tensor(x, dtype=F32, device=like.device)


def get_spherical(n: torch.Tensor):
    """Direction -> equirect uv, forward +x, up +y."""
    n0, n1, n2 = n[..., 0], n[..., 1], n[..., 2]
    pi = _c(math.pi, n)
    phi = _f64(lambda a: torch.atan2(a[0], a[1]),
               torch.stack([n2, n0])) + pi
    theta = _f64(lambda a: torch.atan2(a[0], a[1]),
                 torch.stack([_f64(torch.sqrt, n0 * n0 + n2 * n2), n1]))
    return phi / _c(2.0 * math.pi, n), theta / pi


def nearest_texel(env: HDRI, direction: torch.Tensor, primary: bool):
    """(y, x): the texel of the primary or the sampling image nearest to
    each direction."""
    w = env.width_primary if primary else env.width
    h = env.height_primary if primary else env.height
    u, v = get_spherical(direction)
    x = torch.clamp(u * w, 0.0, w - 1.0).to(I64)
    y = torch.clamp(v * h, 0.0, h - 1.0).to(I64)
    return y, x


def sample_nearest(env: HDRI, direction: torch.Tensor, primary: bool):
    """Nearest-texel radiance lookup (HDRI::sampleNearest)."""
    img = env.pixels_primary if primary else env.pixels
    y, x = nearest_texel(env, direction, primary)
    return img[y, x] * _c(env.scale, direction)


def search_steps(n: int) -> int:
    """The bisection steps of _upper_bound over n entries."""
    return max(int(np.ceil(np.log2(max(n, 2)))) + 1, 1)


def _upper_bound(f, n: int, b: torch.Tensor) -> torch.Tensor:
    """Vectorized upper_bound_f: smallest i with f(i) > b, in a fixed
    number of bisection steps."""
    i = torch.zeros_like(b, dtype=I64)
    j = torch.full_like(i, n)
    for _ in range(search_steps(n)):
        cont = i < j
        m = (i + j) // 2
        le = f(m) <= b
        i, j = torch.where(cont & le, m + 1, i), torch.where(cont & ~le, m, j)
    return i


def select_table(env: HDRI, n: torch.Tensor, axis_aligned: bool):
    """Table index per shading normal (importanceSample's if-chain with
    k = 0.8). Returns int64 [...] in [0, 6]."""
    if not axis_aligned:
        return torch.zeros(n.shape[:-1], dtype=I64, device=n.device)
    k = 0.8
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    idx = torch.zeros(nx.shape, dtype=I64, device=n.device)
    # reversed chain so the first true condition wins
    idx = torch.where(nz < -k, 6, idx)
    idx = torch.where(k < nz, 5, idx)
    idx = torch.where(ny < -k, 4, idx)
    idx = torch.where(k < ny, 3, idx)
    idx = torch.where(nx < -k, 2, idx)
    return torch.where(k < nx, 1, idx)


def _take(flat: torch.Tensor, lin: torch.Tensor) -> torch.Tensor:
    """The reference's take(mode="clip"): indices clamp into range."""
    return flat[torch.clamp(lin, 0, flat.shape[0] - 1)]


def alias_texel(env: HDRI, table, u0, u1):
    """The alias tables' pick: (lin, texel), the entry of the alias arrays
    read (table, then u0's texel) and the texel chosen (it, or its alias
    by u1)."""
    nt = env.width * env.height
    j = torch.clamp((u0 * nt).to(I64), 0, nt - 1)
    lin = table * nt + j
    pa = _take(env.alias_prob.reshape(-1), lin)
    ja = _take(env.alias_idx.reshape(-1), lin)
    return lin, torch.where(u1 < pa, j, ja)


def importance_sample(env: HDRI, n, u0, u1, u2, u3, axis_aligned: bool = True):
    """Returns (direction f32[R, 3], L f32[R, 3], sr_pdf f32[R])
    (HDRI::importanceSample): pick a texel, then jitter inside it."""
    w, h = env.width, env.height
    table = select_table(env, n, axis_aligned)

    if env.use_alias:
        lin, texel = alias_texel(env, table, u0, u1)
        p_sel = _take(env.alias_pdf.reshape(-1), table * (w * h) + texel)
        return _finish_sample(env, texel % w, texel // w, p_sel, u2, u3)

    sats = env.sats.reshape(-1)

    def gather(y, x):
        return _take(sats, table * (w * h) + y * w + x)

    inv_max = _c(1.0 / float(0xFFFFFFFF), u0)

    def ps_h(x):
        # prefix-sum-exclusive along columns: sat[H-1, x-1], 0 for x <= 0
        v = gather(torch.full_like(x, h - 1), torch.clamp(x - 1, min=0))
        return torch.where(x <= 0, 0, v)

    X = _upper_bound(lambda m: ps_h(m).to(F32) * inv_max, w, u0) - 1
    X = torch.clamp(X, 0, w - 1)
    vol = (ps_h(X + 1) - ps_h(X)) & MASK32
    vol_f = torch.clamp(vol.to(F32), min=1.0)

    def ps_v(y):
        # within column X: sat[y-1, X] - sat[y-1, X-1], 0 for y <= 0
        ym = torch.clamp(y - 1, min=0)
        s1 = gather(ym, X)
        s0 = torch.where(X <= 0, 0, gather(ym, torch.clamp(X - 1, min=0)))
        return torch.where(y <= 0, 0, (s1 - s0) & MASK32)

    Y = _upper_bound(lambda m: ps_v(m).to(F32) / vol_f, h, u1) - 1
    Y = torch.clamp(Y, 0, h - 1)

    # 2x2 SAT corner difference = texel count (getCount)
    ym, xm = torch.clamp(Y - 1, min=0), torch.clamp(X - 1, min=0)
    a = torch.where((X <= 0) | (Y <= 0), 0, gather(ym, xm))
    b_ = torch.where(Y <= 0, 0, gather(ym, X))
    c_ = torch.where(X <= 0, 0, gather(Y, xm))
    d_ = gather(Y, X)
    p_sel = ((d_ - b_) + (a - c_) & MASK32).to(F32) * inv_max
    return _finish_sample(env, X, Y, p_sel, u2, u3)


def _finish_sample(env: HDRI, X, Y, p_sel, u2, u3):
    """Texel -> jittered direction, radiance, solid-angle pdf."""
    w, h = env.width, env.height
    d_theta = _c(np.float32(np.pi / h), u2)
    d_phi = _c(np.float32(2.0 * np.pi / w), u2)
    pi = _c(math.pi, u2)
    theta = Y.to(F32) * d_theta
    dh = 2.0 * _f64(torch.sin, d_theta * 0.5) * _f64(torch.sin, d_theta * 0.5 + theta)
    sr = dh * d_phi

    s_y = _f64(torch.cos, theta) * (1.0 - u2) + _f64(torch.cos, theta + d_theta) * u2
    phi = d_phi * (X.to(F32) + u3) + pi
    s_x = _f64(torch.cos, phi)
    s_z = _f64(torch.sin, phi)
    sin_theta = _f64(torch.sqrt, torch.clamp(1.0 - s_y * s_y, min=0.0))
    direction = torch.stack([s_x * sin_theta, s_y, s_z * sin_theta], dim=-1)
    sr_pdf = torch.clamp(p_sel, min=1e-20) / sr

    L = _take(env.pixels.reshape(-1, 3), Y * w + X) * _c(env.scale, u2)
    return direction, L, sr_pdf
