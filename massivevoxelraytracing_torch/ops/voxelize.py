"""Triangle voxelization (Schwarz-Seidel conservative / 6-separating) in
tensor code: the port of the reference's ops/voxelize.py.

Same pipeline and the same float expressions, in the same operation
order: every coverage test is a closed-form predicate over a static
cap^3 candidate grid per triangle (`voxelize_dense`), then one sort by
Morton code and a dedup with integer-mean attributes (`sort_and_unique`).
The two-key limb sort of the reference becomes one int64 `torch.sort`,
and `segment_sum` becomes `scatter_add_`. Attribute means are sums of
integers, so the order of duplicates does not matter.

The scene build runs three stages, each a plain PyTorch function and a
hand-written CUDA kernel (csrc/vox_build.cu: one thread a triangle
walking its units, a column and a run of Z cells, in candidate order;
the emit's warps queue those units and emit one cell a lane; the unique
reduce one thread a sorted entry):

  count          the valid candidates of each triangle (the voxCount
                 pass: voxelize_dense's coverage mask summed a triangle)
  emit           each triangle's valid candidates, in increasing candidate
                 index, written at its offset into the dump buffers: the
                 Morton code, the packed colour and emission at the
                 closest point of the cell corner (the voxelize pass)
  unique_reduce  after the stable sort of the codes and the segment ids:
                 each unique voxel's channel sums and count, and its code
                 and packed means ("means"), sums ("sums") or the merge of
                 groups' sums ("merge")

`*_plain` are the code of voxelize_dense and sort_and_unique moved as it
was; `count_columns` / `emit_columns` the count and emit kernels'
enumeration as tensor code (for the tests). The wrappers (`count`, `emit`, `unique_reduce`) run the plain stage
for CPU tensors and launch the kernel for CUDA tensors (or raise; there is
no fallback). `voxelize_dense` stays the candidate-level reference.

Float exactness: torch runs each elementwise op on its own and rounds it,
so no multiply-add is ever contracted. On CUDA, dividing by a CPU scalar
multiplies by its reciprocal instead; every divisor here is therefore a
tensor on the operands' device. The kernels are built with -fmad=false
and IEEE division, keep every expression's order and propagate NaN
through min / max / clamp as torch does, so on the card each equals its
plain stage bit for bit. (Float-to-int casts saturate on the card, NaN to
0; on the CPU they do not, so a kernel is held against its plain stage on
the card.)

Counters: LAUNCHES[name] counts each kernel's launches.
"""

from __future__ import annotations

import ctypes
import sys
import types

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


def _key(code, valid):
    return code if valid is None else torch.where(valid, code, INVALID_KEY)


def sort_and_unique(cands, stages: str | None = None):
    """Sort candidates by Morton code and deduplicate with integer-mean
    attributes. cands: dict of code int64, color/emission int32 [N] and
    optionally valid bool [N] (all valid without it). Returns dict of
    code/color/emission tensors of length n_unique, n_unique and
    has_emission. stages: None, the wrappers; "plain", the plain stages
    (`_stages`)."""
    s_key, perm, boundary, seg, n_unique = _sorted_segments(
        _key(cands["code"], cands.get("valid")))
    code, color, emission = _stages(stages).unique_reduce(
        s_key, perm, boundary, seg, n_unique, (cands["color"], cands["emission"]),
        mode="means")
    return dict(code=code, color=color, emission=emission, n_unique=n_unique,
                has_emission=_has_emission(emission))


def sort_and_unique_sums(code, color, emission, valid=None, stages: str | None = None):
    """Group stage of the hierarchical unique: sort one group's candidates
    (all valid when `valid` is None) and reduce duplicates to per-voxel
    channel sums and counts, so groups merge later with exact
    true-duplicate means. Returns ((code, sums6, count) of length
    n_unique, n_unique)."""
    s_key, perm, boundary, seg, n_unique = _sorted_segments(_key(code, valid))
    out = _stages(stages).unique_reduce(s_key, perm, boundary, seg, n_unique,
                                        (color, emission), mode="sums")
    return out, n_unique


def merge_unique_sums(code, sums6, count, stages: str | None = None):
    """Merge stage: concatenated per-group (code, sums, count) rows ->
    unique voxels with true-duplicate-mean attributes (same dict as
    sort_and_unique)."""
    s_key, perm, boundary, seg, n_unique = _sorted_segments(code)
    code, color, emission = _stages(stages).unique_reduce(
        s_key, perm, boundary, seg, n_unique, (*sums6, count), mode="merge")
    return dict(code=code, color=color, emission=emission, n_unique=n_unique,
                has_emission=_has_emission(emission))


# ---------------------------------------------------------------------------
# the build's stages: the plain versions
# ---------------------------------------------------------------------------

KERNELS = ("vox_count", "vox_emit", "vox_unique_reduce")
LAUNCHES = dict.fromkeys(KERNELS, 0)
MODES = ("means", "sums", "merge")
I32 = torch.int32
I64 = torch.int64


def reset_counters() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def count_plain(tri, origin, dps, *, grid_res: int, six_separating: bool = True,
                cap: int = 4):
    """Valid candidates of each triangle (voxelize_dense's coverage mask
    summed a triangle): int32 [T]."""
    valid = voxelize_dense(tri, None, None, origin, dps, grid_res=grid_res,
                           six_separating=six_separating, cap=cap,
                           valid_only=True)["valid"]
    return valid.reshape(tri.shape[0], cap ** 3).sum(1, dtype=I32)


def emit_plain(tri, col, emi, offsets, origin, dps, out, *, grid_res: int,
               six_separating: bool = True, cap: int = 4):
    """Write each triangle's valid candidates in increasing candidate index
    at out[offsets[t]], out[offsets[t] + 1], ...: out = (code int64, color
    int32, emission int32) dump buffers, offsets int64 [T]. Returns out."""
    cands = voxelize_dense(tri, col, emi, origin, dps, grid_res=grid_res,
                           six_separating=six_separating, cap=cap)
    valid = cands["valid"].reshape(tri.shape[0], cap ** 3)
    pos = (offsets[:, None] + torch.cumsum(valid, 1) - 1)[valid]
    for buf, key in zip(out, ("code", "color", "emission")):
        buf[pos] = cands[key][valid.reshape(-1)]
    return out


# The count and emit kernels' enumeration as tensor code (for the tests and
# for counting the cells the kernels test): a triangle's units are its
# columns (ox, oy) and runs of Z_CELLS Z cells of its bbox, in candidate
# order; a unit runs the major-axis edge tests and the z slab once and tests
# only the Z cells inside the slab.
Z_CELLS = 32  # csrc/vox_build.cu kZCells


def _axis_edges(ctx, j: int):
    """(nex, ney, d) of the three edges of axis major + j, per triangle."""
    major, E = ctx["major"], ctx["edges"]
    return [tuple(torch.where(major == 0, E[j % 3][edge][f],
                              torch.where(major == 1, E[(j + 1) % 3][edge][f],
                                          E[(j + 2) % 3][edge][f])) for f in range(3))
            for edge in range(3)]


def column_cells(tri, origin, dps, *, grid_res: int, six_separating: bool = True,
                 cap: int = 4):
    """The cells the count and emit kernels test, in their order: each
    triangle's units (ox, oy, zb) from the exclusive scan of its unit count
    ext_u * ext_v * ceil(ext_w / Z_CELLS), each unit's slab-clipped z range
    [max(zmin, lo_w, zbase), min(zmax, lo_w + ext_w - 1, zbase + Z_CELLS -
    1)] where its column passes the major-axis edge tests, and each cell of
    it. Returns (ctx, dict of [C] tensors: tri, X, Y, Z (projected int
    coordinates), xc, yc, zc, valid; and units, the units' count)."""
    ctx = triangle_contexts(tri, six_separating, origin, dps, grid_res)
    dev = tri.device
    T = tri.shape[0]

    def ext(u):
        return torch.clamp(ctx[f"up_{u}"].to(I64) - ctx[f"lo_{u}"] + 1, 0, cap)

    ext_u, ext_v, ext_w = ext("u"), ext("v"), ext("w")
    nz = (ext_w + Z_CELLS - 1) // Z_CELLS
    units = torch.where(ctx["empty"], 0, ext_u * ext_v * nz)
    t = torch.repeat_interleave(torch.arange(T, device=dev), units)
    first = torch.cumsum(units, 0) - units
    l = torch.arange(len(t), device=dev) - first[t]
    col = l // nz[t]
    zb = l - col * nz[t]
    ox = col // ext_v[t]
    oy = col - ox * ext_v[t]
    X = (ctx["lo_u"][t] + ox).to(I32)
    Y = (ctx["lo_v"][t] + oy).to(I32)
    xc = ctx["o_u"][t] + X.to(F32) * dps
    yc = ctx["o_v"][t] + Y.to(F32) * dps
    ok = torch.ones_like(xc, dtype=torch.bool)
    for nex, ney, d in _axis_edges(ctx, 0):
        ok &= nex[t] * xc + ney[t] * yc + d[t] >= 0.0
    var = ctx["kx"][t] * xc + ctx["ky"][t] * yc
    o_w, lo_w = ctx["o_w"][t], ctx["lo_w"][t]
    if six_separating:
        indexf = (var + ctx["c_six"][t] - o_w) / dps
        zf = torch.floor(indexf)
        zmax = zf.to(I32)
        zmin = torch.where(indexf == zf, zmax - 1, zmax)
    else:
        zmin = torch.floor((var + ctx["c_min"][t] - o_w) / dps).to(I32)
        zmax = torch.floor((var + ctx["c_max"][t] - o_w) / dps).to(I32)
    zmin = torch.maximum(zmin, lo_w)
    zmax = torch.minimum(zmax, ctx["up_w"][t])
    zbase = lo_w + zb * Z_CELLS
    zlo = torch.maximum(zmin, zbase)
    zhi = torch.minimum(torch.minimum(zmax, lo_w + ext_w[t] - 1), zbase + Z_CELLS - 1)
    length = torch.where(ok, torch.clamp(zhi - zlo + 1, min=0), 0)

    u = torch.repeat_interleave(torch.arange(len(t), device=dev), length)
    k = torch.arange(len(u), device=dev) - (torch.cumsum(length, 0) - length)[u]
    tc = t[u]
    Z = (zlo[u] + k).to(I32)
    zc = ctx["o_w"][tc] + Z.to(F32) * dps
    valid = (ctx["lo_w"] == ctx["up_w"])[tc]
    inside = torch.ones_like(valid)
    for j, (pu, pv) in ((1, (yc[u], zc)), (2, (zc, xc[u]))):
        for nex, ney, d in _axis_edges(ctx, j):
            inside &= nex[tc] * pu + ney[tc] * pv + d[tc] >= 0.0
    return ctx, dict(tri=tc, X=X[u], Y=Y[u], Z=Z, xc=xc[u], yc=yc[u], zc=zc,
                     valid=valid | inside, units=len(t))


def count_columns(tri, origin, dps, *, grid_res: int, six_separating: bool = True,
                  cap: int = 4):
    """count_plain's output through the kernels' enumeration (column_cells)."""
    _, cells = column_cells(tri, origin, dps, grid_res=grid_res,
                            six_separating=six_separating, cap=cap)
    return torch.bincount(cells["tri"][cells["valid"]], minlength=tri.shape[0]).to(I32)


def emit_columns(tri, col, emi, offsets, origin, dps, out, *, grid_res: int,
                 six_separating: bool = True, cap: int = 4):
    """emit_plain through the kernels' enumeration: each valid cell at
    offsets[t] + its rank among its triangle's valid cells (the kernel's
    within-triangle scan), written only where 0 <= pos < the buffers'
    length (as the kernel writes; emit_plain needs every position in
    range). Returns out."""
    ctx, cells = column_cells(tri, origin, dps, grid_res=grid_res,
                              six_separating=six_separating, cap=cap)
    valid = cells["valid"]
    c = {k: v[valid] for k, v in cells.items() if k not in ("valid", "units")}
    t = c["tri"]
    counts = torch.bincount(t, minlength=tri.shape[0])
    rank = torch.arange(len(t), device=tri.device) - (torch.cumsum(counts, 0) - counts)[t]
    pos = offsets[t] + rank
    keep = (pos >= 0) & (pos < out[0].shape[0])
    c = {k: v[keep] for k, v in c.items()}
    t, pos = c["tri"], pos[keep]
    m = ctx["major"][t]
    X, Y, Z, xc, yc, zc = (c[k] for k in ("X", "Y", "Z", "xc", "yc", "zc"))
    i0 = torch.where(m == 0, X, torch.where(m == 1, Z, Y))
    i1 = torch.where(m == 0, Y, torch.where(m == 1, X, Z))
    i2 = torch.where(m == 0, Z, torch.where(m == 1, Y, X))
    r0 = torch.where(m == 0, xc, torch.where(m == 1, zc, yc))
    r1 = torch.where(m == 0, yc, torch.where(m == 1, xc, zc))
    r2 = torch.where(m == 0, zc, torch.where(m == 1, yc, xc))
    bc = closest_barycentric(ctx["v0"][t], ctx["v1"][t], ctx["v2"][t],
                             torch.stack([r0, r1, r2], dim=-1))
    attrs = []
    for a in (col, emi):
        a0, a1, a2 = a[t, 0], a[t, 1], a[t, 2]
        ch = bc[:, 0:1] * a1 + bc[:, 1:2] * a2 + bc[:, 2:3] * a0
        attrs.append(pack_rgb8(ch[:, 0], ch[:, 1], ch[:, 2]))
    out[0][pos] = morton.encode(i0, i1, i2)
    out[1][pos] = attrs[0]
    out[2][pos] = attrs[1]
    return out


def unique_reduce_plain(s_key, perm, boundary, seg, n_unique: int, attrs, *, mode: str):
    """The segment sums of a sorted stream (_sorted_segments' outputs).
    mode "means": attrs (color, emission) int32 [N] -> (code, color,
    emission) of the unique voxels, the packed integer means; "sums": the
    same attrs -> (code, sums6, count), the six 8-bit channels' sums and
    the count, int64; "merge": attrs (*sums6, count) int64 [N] -> (code,
    color, emission), sum of sums / sum of counts."""
    code = s_key[boundary]
    if mode == "merge":
        *sums6, count = attrs
        tot = [_segment_sum(s[perm], seg, n_unique) for s in sums6]
        cnt = torch.clamp(_segment_sum(count[perm], seg, n_unique), min=1)
        return code, _pack_means(tot[0:3], cnt), _pack_means(tot[3:6], cnt)
    sums = []
    for packed in attrs:
        sums += [_segment_sum(ch, seg, n_unique) for ch in unpack_rgb8(packed[perm])]
    count = _segment_sum(torch.ones_like(seg), seg, n_unique)
    if mode == "sums":
        return code, tuple(sums), count
    cnt = torch.clamp(count, min=1)
    return code, _pack_means(sums[0:3], cnt), _pack_means(sums[3:6], cnt)


# ---------------------------------------------------------------------------
# the wrappers: the plain stage for CPU tensors, the kernel for CUDA ones
# ---------------------------------------------------------------------------

def _device_of(x: torch.Tensor) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no voxelize kernel for device {x.device}")
    return x.device.type


def _check(name, x, dtype, shape, device):
    if (x.device != device or x.dtype != dtype or tuple(x.shape) != tuple(shape)
            or not x.is_contiguous()):
        raise ValueError(f"{name}: need contiguous {dtype} {list(shape)} on {device}, "
                         f"got {x.dtype} {list(x.shape)} on {x.device}")


def _check_grid(grid_res: int, cap: int) -> None:
    if not (1 <= grid_res <= 1 << morton.MAX_COORD_BITS and cap >= 1):
        raise ValueError(f"grid_res {grid_res} must be in [1, 2^21] and cap {cap} >= 1")


def _check_frame(tri, origin, dps, grid_res: int, cap: int):
    """Checks what count and emit share; returns (device, T)."""
    dev = tri.device
    T = tri.shape[0] if tri.dim() == 3 else -1
    _check("tri", tri, F32, (T, 3, 3), dev)
    _check("origin", origin, F32, (3,), dev)
    _check("dps", dps, F32, (), dev)
    _check_grid(grid_res, cap)
    return dev, T


def _launched(name: str, rc: int, n: int) -> None:
    """Raise on a refused launch; count it (the kernels launch nothing for
    n = 0)."""
    if rc != 0:
        from ..utils import cuda_build

        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc} "
                           f"({cuda_build.load().cuda_error_string(rc).decode()})")
    LAUNCHES[name] += n > 0


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def count(tri, origin, dps, *, grid_res: int, six_separating: bool = True, cap: int = 4):
    """count_plain's output; CUDA tensors launch vox_count_kernel<SIX>."""
    kw = dict(grid_res=grid_res, six_separating=six_separating, cap=cap)
    device = _device_of(tri)
    dev, T = _check_frame(tri, origin, dps, grid_res, cap)
    if device == "cpu":
        return count_plain(tri, origin, dps, **kw)
    from ..utils import cuda_build

    out = torch.empty(T, dtype=I32, device=dev)
    lib = cuda_build.load()
    with torch.cuda.device(dev):
        rc = lib.vox_count_launch(int(six_separating), tri.data_ptr(), T, origin.data_ptr(),
                                  dps.data_ptr(), grid_res, cap, out.data_ptr(), _stream(dev))
    _launched("vox_count", rc, T)
    return out


def emit(tri, col, emi, offsets, origin, dps, out, *, grid_res: int,
         six_separating: bool = True, cap: int = 4):
    """emit_plain into `out`; CUDA tensors launch vox_emit_kernel<SIX>
    (which writes nothing past the buffers' end)."""
    kw = dict(grid_res=grid_res, six_separating=six_separating, cap=cap)
    device = _device_of(tri)
    dev, T = _check_frame(tri, origin, dps, grid_res, cap)
    _check("col", col, F32, (T, 3, 3), dev)
    _check("emi", emi, F32, (T, 3, 3), dev)
    _check("offsets", offsets, I64, (T,), dev)
    N = out[0].shape[0]
    for name, x, dtype in zip(("code", "color", "emission"), out, (I64, I32, I32)):
        _check(name, x, dtype, (N,), dev)
    if device == "cpu":
        return emit_plain(tri, col, emi, offsets, origin, dps, out, **kw)
    from ..utils import cuda_build

    lib = cuda_build.load()
    with torch.cuda.device(dev):
        rc = lib.vox_emit_launch(int(six_separating), tri.data_ptr(), col.data_ptr(),
                                 emi.data_ptr(), offsets.data_ptr(), T, origin.data_ptr(),
                                 dps.data_ptr(), grid_res, cap, N, out[0].data_ptr(),
                                 out[1].data_ptr(), out[2].data_ptr(), _stream(dev))
    _launched("vox_emit", rc, T)
    return out


def unique_reduce(s_key, perm, boundary, seg, n_unique: int, attrs, *, mode: str):
    """unique_reduce_plain's outputs; CUDA tensors launch
    vox_unique_reduce_kernel<MODE>."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, not {mode!r}")
    device = _device_of(s_key)
    dev = s_key.device
    N = s_key.shape[0]
    _check("s_key", s_key, I64, (N,), dev)
    _check("perm", perm, I64, (N,), dev)
    _check("boundary", boundary, torch.bool, (N,), dev)
    _check("seg", seg, I64, (N,), dev)
    dtypes = (I64,) * 7 if mode == "merge" else (I32, I32)
    if len(attrs) != len(dtypes):
        raise ValueError(f"mode {mode!r} takes {len(dtypes)} attribute arrays, not {len(attrs)}")
    for i, (x, dtype) in enumerate(zip(attrs, dtypes)):
        _check(f"attrs[{i}]", x, dtype, (N,), dev)
    if device == "cpu":
        return unique_reduce_plain(s_key, perm, boundary, seg, n_unique, attrs, mode=mode)
    from ..utils import cuda_build

    code = torch.empty(n_unique, dtype=I64, device=dev)
    if mode == "sums":
        sums = torch.empty((7, n_unique), dtype=I64, device=dev)
        outs = list(sums)
    else:
        outs = [torch.empty(n_unique, dtype=I32, device=dev) for _ in range(2)]
    in_ptrs = (ctypes.c_void_p * 7)(*[x.data_ptr() for x in attrs])
    out_ptrs = (ctypes.c_void_p * 7)(*[x.data_ptr() for x in outs])
    lib = cuda_build.load()
    with torch.cuda.device(dev):
        rc = lib.vox_unique_reduce_launch(
            MODES.index(mode), s_key.data_ptr(), perm.data_ptr(), boundary.data_ptr(),
            seg.data_ptr(), N, ctypes.addressof(in_ptrs), code.data_ptr(),
            ctypes.addressof(out_ptrs), _stream(dev))
    _launched("vox_unique_reduce", rc, N)
    if mode == "sums":
        return code, tuple(outs[:6]), outs[6]
    return code, outs[0], outs[1]


def dump_candidates(tri, col, emi, origin, dps, *, grid_res: int,
                    six_separating: bool = True, cap: int = 4):
    """All triangles' valid candidates in one group through the wrappers:
    count, the int64 exclusive prefix, one host readback of the total, one
    emit into new dump buffers. Returns sort_and_unique's cands dict (code,
    color, emission; every entry valid)."""
    kw = dict(grid_res=grid_res, six_separating=six_separating, cap=cap)
    counts = count(tri, origin, dps, **kw)
    end = torch.cumsum(counts, 0, dtype=I64)
    n = int(end[-1]) if len(end) else 0
    out = (torch.empty(n, dtype=I64, device=tri.device),
           torch.empty(n, dtype=I32, device=tri.device),
           torch.empty(n, dtype=I32, device=tri.device))
    emit(tri, col, emi, end - counts, origin, dps, out, **kw)
    return dict(code=out[0], color=out[1], emission=out[2])


PLAIN = types.SimpleNamespace(count=count_plain, emit=emit_plain,
                              unique_reduce=unique_reduce_plain)


def _stages(stages: str | None):
    """The build's stages: None, the wrappers (the kernels on the card, the
    plain stages on the CPU); "plain", the plain stages on any device (for
    holding the kernels against them)."""
    if stages is None:
        return sys.modules[__name__]
    if stages == "plain":
        return PLAIN
    raise ValueError(f"stages must be None or 'plain', not {stages!r}")
