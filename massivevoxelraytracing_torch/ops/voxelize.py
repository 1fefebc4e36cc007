"""Triangle voxelization (Schwarz-Seidel conservative / 6-separating) in
tensor code: the port of the reference's ops/voxelize.py.

Same pipeline and the same float expressions, in the same operation
order: every coverage test is a closed-form predicate over a static
cap^3 candidate grid per triangle (`voxelize_dense`), then one sort by
Morton code and a dedup with integer-mean attributes (`sort_and_unique`).
The two-key limb sort of the reference becomes one int64 `torch.sort`,
and `segment_sum` becomes `scatter_add_`. Attribute means are sums of
integers, so the order of duplicates does not matter.

Float exactness: torch runs each elementwise op on its own and rounds it,
so no multiply-add is ever contracted. On CUDA, dividing by a CPU scalar
multiplies by its reciprocal instead; every divisor here is therefore a
tensor on the operands' device.
"""

from __future__ import annotations

import torch

from . import morton
from .bits import MASK32, to_i32_bits

F32 = torch.float32
# sort key of an invalid candidate: sinks past every real code (codes of
# grids up to 2^20 per axis stay below 2^60)
INVALID_KEY = (1 << 63) - 1


def _f32(x, device) -> torch.Tensor:
    return torch.tensor(x, dtype=F32, device=device)


# ---------------------------------------------------------------------------
# attribute packing
# ---------------------------------------------------------------------------

def pack_rgb8(r, g, b) -> torch.Tensor:
    """float [0,1] rgb -> packed u32 (r | g<<8 | b<<16 | 0xFF<<24) as an
    int32 bit pattern, quantized like the reference's (uint8)(v*255+0.5).
    NaN quantizes to 0, as XLA's float->int conversion does."""
    def q(v):
        x = torch.clamp(v * 255.0 + 0.5, 0.0, 255.0)
        return torch.nan_to_num(x, nan=0.0).to(torch.int64)

    return to_i32_bits(q(r) | (q(g) << 8) | (q(b) << 16) | 0xFF000000)


def unpack_rgb8(p: torch.Tensor):
    p = p.to(torch.int64) & MASK32
    return p & 0xFF, (p >> 8) & 0xFF, (p >> 16) & 0xFF


def rgb8_to_f32(p: torch.Tensor) -> torch.Tensor:
    """Packed u32 -> f32[..., 3] in [0, 1]."""
    r, g, b = unpack_rgb8(p)
    s = _f32(1.0 / 255.0, p.device)
    return torch.stack([r.to(F32) * s, g.to(F32) * s, b.to(F32) * s], dim=-1)


# ---------------------------------------------------------------------------
# per-triangle context (vectorized VTContext)
# ---------------------------------------------------------------------------

def _proj(p, axis: int):
    """(p[a], p[(a+1)%3] | remainder p[(a+2)%3]) for a static axis."""
    return p[..., axis], p[..., (axis + 1) % 3], p[..., (axis + 2) % 3]


def _cross(a, b):
    """jnp.cross's component formulas, in its operation order."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack(
        [a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1
    )


def _dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def triangle_contexts(v, six_separating: bool, origin, dps, grid_res: int):
    """v: f32[T, 3, 3] triangle vertices; origin f32[3] and dps (0-d f32)
    tensors on v's device. Returns a dict of per-triangle tensors."""
    zero = torch.zeros((), dtype=F32, device=v.device)
    v0, v1, v2 = v[:, 0], v[:, 1], v[:, 2]
    e01 = v1 - v0
    e12 = v2 - v1
    n = _cross(e01, e12)

    ax, ay, az = n[:, 0].abs(), n[:, 1].abs(), n[:, 2].abs()
    major = torch.where(
        ax < ay,
        torch.where(ay < az, 0, 2),
        torch.where(ax < az, 0, 1),
    ).to(torch.int32)

    bb_lo = torch.minimum(torch.minimum(v0, v1), v2)
    bb_hi = torch.maximum(torch.maximum(v0, v1), v2)
    lower = torch.floor((bb_lo - origin) / dps).to(torch.int32)
    upper = torch.floor((bb_hi - origin) / dps).to(torch.int32)
    lower = torch.clamp(lower, min=0)
    upper = torch.clamp(upper, max=grid_res - 1)

    # edge functions for every axis (static unroll over the 3 projections)
    edges = [[None] * 3 for _ in range(3)]  # [axis][edge] = (nex, ney, d)
    for axis in range(3):
        pu0, pv0, _ = _proj(v0, axis)
        pu1, pv1, _ = _proj(v1, axis)
        pu2, pv2, _ = _proj(v2, axis)
        rem = _proj(n, axis)[2]
        n_sign = torch.where(0.0 < rem, 1.0, -1.0).to(F32)
        us = (pu0, pu1, pu2)
        vs = (pv0, pv1, pv2)
        for edge in range(3):
            au, av = us[edge], vs[edge]
            bu, bv = us[(edge + 1) % 3], vs[(edge + 1) % 3]
            nex = -(bv - av) * n_sign
            ney = (bu - au) * n_sign
            if not six_separating:
                d = (
                    torch.maximum(nex * dps, zero)
                    + torch.maximum(ney * dps, zero)
                    - (nex * au + ney * av)
                )
            else:
                d = (
                    nex * (dps * 0.5 - au)
                    + ney * (dps * 0.5 - av)
                    + 0.5 * dps * torch.maximum(nex.abs(), ney.abs())
                )
            edges[axis][edge] = (nex, ney, d)

    def sel3(a0, a1, a2):
        return torch.where(major == 0, a0, torch.where(major == 1, a1, a2))

    o = origin
    ones = torch.ones_like(n[:, 0])
    o_u = sel3(o[0], o[1], o[2]) * ones
    o_v = sel3(o[1], o[2], o[0]) * ones
    o_w = sel3(o[2], o[0], o[1]) * ones
    lo_u = sel3(lower[:, 0], lower[:, 1], lower[:, 2])
    lo_v = sel3(lower[:, 1], lower[:, 2], lower[:, 0])
    lo_w = sel3(lower[:, 2], lower[:, 0], lower[:, 1])
    up_u = sel3(upper[:, 0], upper[:, 1], upper[:, 2])
    up_v = sel3(upper[:, 1], upper[:, 2], upper[:, 0])
    up_w = sel3(upper[:, 2], upper[:, 0], upper[:, 1])

    n_u = sel3(n[:, 0], n[:, 1], n[:, 2])
    n_v = sel3(n[:, 1], n[:, 2], n[:, 0])
    n_w = sel3(n[:, 2], n[:, 0], n[:, 1])
    v0_u = sel3(v0[:, 0], v0[:, 1], v0[:, 2])
    v0_v = sel3(v0[:, 1], v0[:, 2], v0[:, 0])
    v0_w = sel3(v0[:, 2], v0[:, 0], v0[:, 1])
    kx = -n_u / n_w
    ky = -n_v / n_w
    K = -kx * v0_u - ky * v0_v + v0_w
    c_max = K + dps * (torch.maximum(kx, zero) + torch.maximum(ky, zero))
    c_min = K + dps * (torch.minimum(kx, zero) + torch.minimum(ky, zero))
    c_six = K + 0.5 * dps * (kx + ky)

    degenerate = (n[:, 0] == 0.0) & (n[:, 1] == 0.0) & (n[:, 2] == 0.0)
    empty = degenerate | torch.any(upper < lower, dim=-1)

    # major-axis edge consts, selected per triangle
    edges_major = []
    for edge in range(3):
        nex = sel3(edges[0][edge][0], edges[1][edge][0], edges[2][edge][0])
        ney = sel3(edges[0][edge][1], edges[1][edge][1], edges[2][edge][1])
        dd = sel3(edges[0][edge][2], edges[1][edge][2], edges[2][edge][2])
        edges_major.append((nex, ney, dd))

    return dict(
        major=major,
        lo_u=lo_u, lo_v=lo_v, lo_w=lo_w,
        up_u=up_u, up_v=up_v, up_w=up_w,
        o_u=o_u, o_v=o_v, o_w=o_w,
        kx=kx, ky=ky, c_max=c_max, c_min=c_min, c_six=c_six,
        edges=edges, edges_major=edges_major,
        empty=empty, dps=dps,
        v0=v0, v1=v1, v2=v2,
    )


def coverage_mask(ctx, X, Y, Z, six_separating: bool):
    """Coverage predicate at projected integer coords X/Y/Z (int32 [T, C]):
    X along the major axis, Y the next, Z the remainder. Returns (ok
    bool[T, C], (r0, r1, r2) f32[T, C] real-space corner coords)."""
    dps = ctx["dps"]

    def e(a):
        return a[:, None]

    xc = e(ctx["o_u"]) + X.to(F32) * dps
    yc = e(ctx["o_v"]) + Y.to(F32) * dps
    zc = e(ctx["o_w"]) + Z.to(F32) * dps

    ok = (
        (e(ctx["lo_u"]) <= X) & (X <= e(ctx["up_u"]))
        & (e(ctx["lo_v"]) <= Y) & (Y <= e(ctx["up_v"]))
        & (e(ctx["lo_w"]) <= Z) & (Z <= e(ctx["up_w"]))
        & ~e(ctx["empty"])
    )

    # major-axis edge functions (yRangeInclusive)
    for nex, ney, d in ctx["edges_major"]:
        ok &= e(nex) * xc + e(ney) * yc + e(d) >= 0.0

    # z slab (zRangeInclusive)
    var = e(ctx["kx"]) * xc + e(ctx["ky"]) * yc
    if six_separating:
        indexf = (var + e(ctx["c_six"]) - e(ctx["o_w"])) / dps
        zf = torch.floor(indexf)
        zmax = zf.to(torch.int32)
        zmin = torch.where(indexf == zf, zmax - 1, zmax)
    else:
        zmin = torch.floor(
            (var + e(ctx["c_min"]) - e(ctx["o_w"])) / dps).to(torch.int32)
        zmax = torch.floor(
            (var + e(ctx["c_max"]) - e(ctx["o_w"])) / dps).to(torch.int32)
    zmin = torch.maximum(zmin, e(ctx["lo_w"]))
    zmax = torch.minimum(zmax, e(ctx["up_w"]))
    ok &= (zmin <= Z) & (Z <= zmax)

    # real-space corner point of the candidate cell
    major = ctx["major"][:, None]
    r0 = torch.where(major == 0, xc, torch.where(major == 1, zc, yc))
    r1 = torch.where(major == 0, yc, torch.where(major == 1, xc, zc))
    r2 = torch.where(major == 0, zc, torch.where(major == 1, yc, xc))

    # intersect(p): the two non-major axes' edge tests, skipped when the
    # bbox is flat along the remainder axis
    flat = e(ctx["lo_w"] == ctx["up_w"])
    rr = (r0, r1, r2)
    for axis in range(3):
        pu = rr[axis]
        pv = rr[(axis + 1) % 3]
        ax_ok = torch.ones_like(ok)
        for edge in range(3):
            nex, ney, d = ctx["edges"][axis][edge]
            ax_ok &= e(nex) * pu + e(ney) * pv + e(d) >= 0.0
        ok &= ax_ok | flat | (major == axis)

    return ok, rr


def closest_barycentric(v0, v1, v2, p):
    """Clamped barycentric coords of the closest point on the triangle,
    over leading dims (the reference's branch ladder as nested selects)."""
    d0 = v0 - p
    d1 = v1 - p
    d2 = v2 - p
    e0 = v2 - v0
    e1 = v0 - v1
    e2 = v1 - v2
    ng = _cross(e2, e0)
    U = _dot(_cross(d2, d0), ng)
    V = _dot(_cross(d0, d1), ng)
    W = _dot(_cross(d1, d2), ng)
    u_neg = U < 0.0
    v_neg = ~u_neg & (V < 0.0)
    w_neg = ~u_neg & ~v_neg & (W < 0.0)
    V = torch.where(u_neg, _dot(-d0, e0),
                    torch.where(v_neg, V, torch.where(w_neg, _dot(d1, e2), V)))
    W = torch.where(u_neg, _dot(d2, e0), torch.where(v_neg, _dot(-d1, e1), W))
    U = torch.where(v_neg, _dot(d0, e1), torch.where(w_neg, _dot(-d2, e2), U))
    bc = torch.clamp(torch.stack([U, V, W], dim=-1), min=0.0)
    tot = bc[..., 0:1] + bc[..., 1:2] + bc[..., 2:3]
    return bc / tot


def voxelize_dense(tri_verts, tri_colors, tri_emissions, origin, dps, *,
                   grid_res: int, six_separating: bool = True, cap: int = 4,
                   valid_only: bool = False):
    """Candidate voxels of T triangles whose voxel bbox fits cap^3.

    tri_verts/colors/emissions: f32[T, 3, 3] tensors on one device;
    origin f32[3] and dps (0-d f32) tensors on that device. Returns a dict
    of flattened [T * cap^3] tensors: valid bool, code int64 Morton,
    color/emission packed u32 as int32 bit patterns; with valid_only (the
    count pass) the coverage mask alone."""
    ctx = triangle_contexts(tri_verts, six_separating, origin, dps, grid_res)
    C = cap * cap * cap
    dev = tri_verts.device

    off = torch.arange(cap, dtype=torch.int32, device=dev)
    OX, OY, OZ = torch.meshgrid(off, off, off, indexing="ij")
    X = ctx["lo_u"][:, None] + OX.reshape(1, C)
    Y = ctx["lo_v"][:, None] + OY.reshape(1, C)
    Z = ctx["lo_w"][:, None] + OZ.reshape(1, C)

    ok, (r0, r1, r2) = coverage_mask(ctx, X, Y, Z, six_separating)
    if valid_only:
        return dict(valid=ok.reshape(-1))

    # integer grid coords (unproject)
    major = ctx["major"][:, None]
    i0 = torch.where(major == 0, X, torch.where(major == 1, Z, Y))
    i1 = torch.where(major == 0, Y, torch.where(major == 1, X, Z))
    i2 = torch.where(major == 0, Z, torch.where(major == 1, Y, X))
    code = morton.encode(i0, i1, i2)

    # attributes at the closest barycentric point of the cell corner
    p = torch.stack([r0, r1, r2], dim=-1)  # [T, C, 3]
    bc = closest_barycentric(
        ctx["v0"][:, None, :], ctx["v1"][:, None, :], ctx["v2"][:, None, :], p
    )
    c0, c1, c2 = tri_colors[:, 0], tri_colors[:, 1], tri_colors[:, 2]
    e0, e1, e2 = tri_emissions[:, 0], tri_emissions[:, 1], tri_emissions[:, 2]
    # the reference's rotation: color = bc.x*c1 + bc.y*c2 + bc.z*c0
    col = (bc[..., 0:1] * c1[:, None, :] + bc[..., 1:2] * c2[:, None, :]
           + bc[..., 2:3] * c0[:, None, :])
    emi = (bc[..., 0:1] * e1[:, None, :] + bc[..., 1:2] * e2[:, None, :]
           + bc[..., 2:3] * e0[:, None, :])

    return dict(
        valid=ok.reshape(-1),
        code=code.reshape(-1),
        color=pack_rgb8(col[..., 0], col[..., 1], col[..., 2]).reshape(-1),
        emission=pack_rgb8(emi[..., 0], emi[..., 1], emi[..., 2]).reshape(-1),
    )


def count_voxels(cands) -> torch.Tensor:
    """Total dumped voxels (the voxCount pass), as a 0-d int64 tensor."""
    return cands["valid"].sum()


# ---------------------------------------------------------------------------
# sort + unique
# ---------------------------------------------------------------------------

def _sorted_segments(key):
    """Stable sort of int64 keys (INVALID_KEY = no voxel). Returns
    (s_key, perm, boundary, seg, n_unique): seg is each sorted entry's
    unique-voxel index, n_unique (the dump segment) for invalid entries."""
    s_key, perm = torch.sort(key, stable=True)
    s_valid = s_key != INVALID_KEY
    ne = torch.ones_like(s_valid)
    ne[1:] = s_key[1:] != s_key[:-1]
    boundary = s_valid & ne
    n_unique = int(boundary.sum())
    seg = torch.cumsum(boundary, 0) - 1
    seg = torch.where(s_valid, seg, n_unique)
    return s_key, perm, boundary, seg, n_unique


def _segment_sum(x, seg, n_unique):
    out = torch.zeros(n_unique + 1, dtype=torch.int64, device=x.device)
    return out.scatter_add_(0, seg, x.to(torch.int64))[:n_unique]


def _pack_means(sums, cnt):
    means = [s // cnt for s in sums]
    return to_i32_bits(means[0] | (means[1] << 8) | (means[2] << 16) | 0xFF000000)


def _has_emission(emission):
    return bool(((emission.to(torch.int64) & 0x00FFFFFF) != 0).any())


def sort_and_unique(cands):
    """Sort candidates by Morton code and deduplicate with integer-mean
    attributes. cands: dict of valid bool, code int64, color/emission
    int32 [N]. Returns dict of code/color/emission tensors of length
    n_unique, n_unique and has_emission."""
    key = torch.where(cands["valid"], cands["code"], INVALID_KEY)
    s_key, perm, boundary, seg, n_unique = _sorted_segments(key)
    counts = _segment_sum(torch.ones_like(seg), seg, n_unique)
    cnt = torch.clamp(counts, min=1)

    def mean_channels(packed):
        chs = unpack_rgb8(packed[perm])
        return _pack_means([_segment_sum(ch, seg, n_unique) for ch in chs], cnt)

    emission = mean_channels(cands["emission"])
    return dict(
        code=s_key[boundary],
        color=mean_channels(cands["color"]),
        emission=emission,
        n_unique=n_unique,
        has_emission=_has_emission(emission),
    )


def sort_and_unique_sums(code, color, emission, valid):
    """Group stage of the hierarchical unique: sort one group's candidates
    and reduce duplicates to per-voxel channel sums and counts, so groups
    merge later with exact true-duplicate means. Returns ((code, sums6,
    count) of length n_unique, n_unique)."""
    key = torch.where(valid, code, INVALID_KEY)
    s_key, perm, boundary, seg, n_unique = _sorted_segments(key)
    sums = []
    for packed in (color, emission):
        sums += [_segment_sum(ch, seg, n_unique) for ch in unpack_rgb8(packed[perm])]
    count = _segment_sum(torch.ones_like(seg), seg, n_unique)
    return (s_key[boundary], sums, count), n_unique


def merge_unique_sums(code, sums6, count):
    """Merge stage: concatenated per-group (code, sums, count) rows ->
    unique voxels with true-duplicate-mean attributes (same dict as
    sort_and_unique)."""
    s_key, perm, boundary, seg, n_unique = _sorted_segments(code)
    tot = [_segment_sum(s[perm], seg, n_unique) for s in sums6]
    cnt = torch.clamp(_segment_sum(count[perm], seg, n_unique), min=1)
    emission = _pack_means(tot[3:6], cnt)
    return dict(
        code=s_key[boundary],
        color=_pack_means(tot[0:3], cnt),
        emission=emission,
        n_unique=n_unique,
        has_emission=_has_emission(emission),
    )
