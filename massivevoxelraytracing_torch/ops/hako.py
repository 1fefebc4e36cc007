"""HakoTree: fat-leaf sparse voxel tree -- the port of the reference's
ops/hako.py build.

Brick row layout (u32 x 164, held as int32 bit patterns):
  cols   0..127  voxel occupancy words; bit b of word w = voxel with
                 12-bit in-brick Morton index 32*w + b
  cols 128..129  coarse mask (lo, hi): bit s = sub-brick s (words 2s,
                 2s+1, a 4^3 voxel block) is non-empty
  col  130       base: rank of the brick's first voxel in the global
                 Morton-sorted unique-voxel array (attribute index)
  col  131       brick Morton code (low 32 bits)
  cols 132..163  per-sub-brick exclusive voxel-count prefix, packed u16x2:
                 col 132+t = prefix[2t] | prefix[2t+1] << 16

Above the bricks sits a 4^3-branching top tree of T levels. A node is
(mask_lo, mask_hi) over its 64 children plus base, the index of its first
child in the child level; child index = base + popcount(mask below cell).
Levels 1..T-1 are plain int32 [n, 3] tensors of (mask_lo, mask_hi, base);
the root (level T) is two python ints. Grids above USE_SNODES_ABOVE get
"supernode" rows between the top tree and the bricks: the same 164-word
layout over 16^3 bricks (base = rank of the first brick).

The reference's node-table forms (smem, taa, flat, byte-split) are TPU
layouts and are not built here; `from_numpy` decodes them when it takes
a tree built by the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .bits import MASK32, popcount32, to_i32_bits

BRICK_WORDS = 164
N_TAB_SEG = 11  # byte-split table segments: 4 + 4 + 3 bytes

# Grids above this get the supernode level (the reference's default).
USE_SNODES_ABOVE = 512


def use_snodes_for(grid_res: int) -> bool:
    return grid_res > USE_SNODES_ABOVE


def top_levels_for(grid_res: int) -> int:
    """T such that the top tree's leaf cell covers one fat row: without
    snodes 16 * 4^T >= grid_res, with snodes 256 * 4^T >= grid_res."""
    leaf = 256 if use_snodes_for(grid_res) else 16
    t = 1
    while leaf * (4 ** t) < grid_res:
        t += 1
    return t


def pad_res(grid_res: int) -> int:
    leaf = 256 if use_snodes_for(grid_res) else 16
    return leaf * 4 ** top_levels_for(grid_res)


@dataclasses.dataclass
class HakoTree:
    bricks: torch.Tensor       # int32 [n_bricks, 164]
    n_bricks: int
    levels: tuple              # int32 [n_l, 3] tables for levels 1..T-1
    n_per_level: tuple         # node counts for levels 1..T-1
    root_mask_lo: int          # root node (level T): u64 mask as 2 ints
    root_mask_hi: int
    T: int                     # top (4^3) levels above the fat rows
    res: int                   # padded: (256 if snodes else 16) * 4^T
    grid_res: int              # caller resolution
    lower: torch.Tensor        # f32 [3]
    upper: torch.Tensor        # f32 [3] = lower + dps * res
    dps: float
    snodes: torch.Tensor | None = None  # int32 [n_snodes, 164]
    n_snodes: int = 0
    color: torch.Tensor | None = None     # int32 [n_voxels] packed rgb8
    emission: torch.Tensor | None = None  # int32 [n_voxels] packed rgb8
    n_voxels: int = 0
    has_emission: bool = False
    build_stats: dict | None = None

    def memory_bytes(self) -> int:
        b = self.bricks.shape[0] * BRICK_WORDS * 4
        if self.snodes is not None:
            b += self.snodes.shape[0] * BRICK_WORDS * 4
        for lv in self.levels:
            b += lv.numel() * 4
        return b

    @property
    def n_nodes(self) -> int:
        return self.n_bricks + self.n_snodes + sum(self.n_per_level)

    @property
    def device(self) -> torch.device:
        return self.bricks.device


def _boundaries(key):
    """True where a sorted key differs from its predecessor (and at 0)."""
    ne = torch.ones(key.shape[0], dtype=torch.bool, device=key.device)
    ne[1:] = key[1:] != key[:-1]
    return ne


def _level_counts(bm, n_levels: int) -> list:
    """Distinct counts of bm >> 6l for l = 0..n_levels (l=0: brick count);
    bm sorted int64. One host readback."""
    counts = [_boundaries(bm >> (6 * l)).sum() for l in range(n_levels + 1)]
    return torch.stack(counts).tolist()


def _group_starts(boundary):
    """Index of each group's first entry (the reference's segment_min)."""
    return torch.nonzero(boundary).reshape(-1)


def _build_bricks(codes):
    """Sorted unique Morton codes (int64) -> (brick rows int32 [nb, 164],
    brick Mortons int64 [nb])."""
    bm = codes >> 12
    boundary = _boundaries(bm)
    gid = torch.cumsum(boundary, 0) - 1
    gstart = _group_starts(boundary)
    nb = gstart.shape[0]

    # voxel occupancy words: the bits are distinct, so the int64 sum is an OR
    m12 = codes & 4095
    flat = torch.zeros(nb * 128, dtype=torch.int64, device=codes.device)
    flat.scatter_add_(0, gid * 128 + (m12 >> 5), torch.ones_like(m12) << (m12 & 31))
    words = flat.reshape(nb, 128)

    # coarse mask: sub-brick s <-> words 2s, 2s+1
    w_even = words[:, 0::2]
    w_odd = words[:, 1::2]
    occ = ((w_even | w_odd) != 0).to(torch.int64)
    pw = torch.ones(32, dtype=torch.int64, device=codes.device) << torch.arange(
        32, device=codes.device)
    coarse_lo = (occ[:, :32] * pw).sum(1)
    coarse_hi = (occ[:, 32:] * pw).sum(1)

    g_bm = bm[gstart]

    # per-sub-brick exclusive prefix of voxel counts, packed u16 pairs
    pc = popcount32(w_even) + popcount32(w_odd)
    prefix = torch.cumsum(pc, 1) - pc
    packed = prefix[:, 0::2] | (prefix[:, 1::2] << 16)

    rows = torch.cat(
        [words, coarse_lo[:, None], coarse_hi[:, None], gstart[:, None],
         g_bm[:, None] & MASK32, packed],
        dim=1,
    )
    return to_i32_bits(rows), g_bm


def _build_top_level(t_m):
    """Group sorted child Mortons (int64) into 4^3 parents. Returns
    (int32 [n_groups, 3] table of (mask_lo, mask_hi, base), parent
    Mortons int64 [n_groups])."""
    p = t_m >> 6
    cell = t_m & 63
    boundary = _boundaries(p)
    gid = torch.cumsum(boundary, 0) - 1
    gstart = _group_starts(boundary)
    n_groups = gstart.shape[0]

    one = torch.ones_like(cell)
    zero = torch.zeros_like(cell)
    bit_lo = torch.where(cell < 32, one << torch.clamp(cell, max=31), zero)
    bit_hi = torch.where(cell >= 32, one << torch.clamp(cell - 32, min=0), zero)
    mask_lo = torch.zeros(n_groups, dtype=torch.int64, device=t_m.device)
    mask_hi = torch.zeros_like(mask_lo)
    mask_lo.scatter_add_(0, gid, bit_lo)
    mask_hi.scatter_add_(0, gid, bit_hi)
    table = to_i32_bits(torch.stack([mask_lo, mask_hi, gstart], dim=1))
    return table, p[gstart]


def _assemble_above(g_bm, nb: int, grid_res: int):
    """Everything above the brick rows, from the sorted brick Mortons:
    (snode_rows, n_snodes, levels, n_per_level, root_lo, root_hi, T, res)."""
    T = top_levels_for(grid_res)
    snody = use_snodes_for(grid_res)
    res4h = (256 if snody else 16) * 4 ** T

    n_above = T + (2 if snody else 0)
    counts = _level_counts(g_bm, n_above)
    assert counts[0] == nb
    assert counts[n_above] == 1, f"root must be single, got {counts[n_above]}"

    snode_rows = None
    n_snodes = 0
    t_m = g_bm
    if snody:
        # supernode rows: the brick builder over the brick Mortons, so a
        # supernode is a 4096-bit occupancy over its 16^3 bricks
        snode_rows, t_m = _build_bricks(g_bm)
        n_snodes = int(counts[2])

    levels = []
    n_per_level = []
    for l in range(1, T + 1):
        table, t_m = _build_top_level(t_m)
        if l < T:
            levels.append(table)
            n_per_level.append(table.shape[0])
    root_lo, root_hi, root_base = (
        int(x) & MASK32 for x in table[0].tolist()
    )
    assert root_base == 0
    return (snode_rows, n_snodes, tuple(levels), tuple(n_per_level),
            root_lo, root_hi, T, res4h)


def build_hako(codes: torch.Tensor, grid_res: int, *, device, lower=None,
               dps: float = 1.0, color=None, emission=None,
               has_emission: bool = False) -> HakoTree:
    """Build from the sorted unique Morton codes (int64 [n_voxels]) on
    `device`. color/emission: int32 [n_voxels] packed rgb8, or None."""
    codes = codes.to(device=device, dtype=torch.int64)
    rows, g_bm = _build_bricks(codes)
    nb = rows.shape[0]
    assert nb < (1 << 24), f"brick count {nb} exceeds capacity"

    (snode_rows, n_snodes, levels, n_per_level, root_lo, root_hi,
     T, res4h) = _assemble_above(g_bm, nb, grid_res)

    if lower is None:
        lower = np.zeros(3, np.float32)
    lower = torch.tensor(np.asarray(lower, np.float32), device=device)
    dps_t = torch.tensor(dps, dtype=torch.float32, device=device)
    return HakoTree(
        bricks=rows,
        n_bricks=nb,
        levels=levels,
        n_per_level=n_per_level,
        root_mask_lo=root_lo,
        root_mask_hi=root_hi,
        T=T,
        res=res4h,
        grid_res=grid_res,
        lower=lower,
        upper=lower + dps_t * res4h,
        dps=float(dps),
        snodes=snode_rows,
        n_snodes=n_snodes,
        color=None if color is None else color.to(device),
        emission=None if emission is None else emission.to(device),
        n_voxels=int(codes.shape[0]),
        has_emission=bool(has_emission),
    )


def voxels_from_tree(tree: HakoTree) -> np.ndarray:
    """Host: the sorted voxel Morton codes (uint64) read back from the
    brick rows -- the build round-trip oracle."""
    rows = tree.bricks[: tree.n_bricks].cpu().numpy().view(np.uint32)
    words = np.ascontiguousarray(rows[:, :128])
    bits = np.unpackbits(words.view(np.uint8), bitorder="little")
    b, idx = np.nonzero(bits.reshape(tree.n_bricks, 128 * 32))
    bm = rows[b, 131].astype(np.uint64)
    return np.sort((bm << np.uint64(12)) | idx.astype(np.uint64))


# ---------------------------------------------------------------------------
# a tree built by the JAX package, as numpy arrays
# ---------------------------------------------------------------------------

def _decode_level(tab: np.ndarray, n: int) -> np.ndarray:
    """One level table of the JAX package, in whichever TPU form it was
    stored (smem (1, 192), taa (48, 128), flat [n_pad, 16], byte-split
    [rows, 1408]), -> u32 [n, 3] of (mask_lo, mask_hi, base)."""
    idx = np.arange(n)
    if tab.shape == (1, 192):
        cols = [tab[0, 64 * k + idx] for k in range(3)]
    elif tab.shape == (48, 128):
        cols = [tab[16 * k + (idx >> 7), idx & 127] for k in range(3)]
    else:
        if tab.shape[1] == 16:
            segs = [tab[idx, k] for k in range(N_TAB_SEG)]
        elif tab.shape[1] == N_TAB_SEG * 128:
            segs = [tab[idx >> 7, 128 * k + (idx & 127)] for k in range(N_TAB_SEG)]
        else:
            raise ValueError(f"unknown level table shape {tab.shape}")
        b = [s.astype(np.uint32) for s in segs]
        cols = [
            b[0] | (b[1] << 8) | (b[2] << 16) | (b[3] << 24),
            b[4] | (b[5] << 8) | (b[6] << 16) | (b[7] << 24),
            b[8] | (b[9] << 8) | (b[10] << 16),
        ]
    return np.stack([np.asarray(c, np.uint32) for c in cols], axis=1)


def _rows_i32(a: np.ndarray, n: int, device) -> torch.Tensor:
    return torch.from_numpy(
        np.ascontiguousarray(np.asarray(a)[:n]).astype(np.uint32).view(np.int32)
    ).to(device)


def from_numpy(d: dict, device="cuda") -> HakoTree:
    """HakoTree from the fields of a tree built by the JAX package, as
    numpy arrays and python numbers (the dataclass fields of the
    reference's HakoTree). Rows are copied as they are, cut to their
    valid count; level tables are decoded from their TPU form; color and
    emission are carried (a tree without them renders black albedo)."""
    n_b = int(d["n_bricks"])
    n_s = int(d.get("n_snodes", 0))
    n_v = int(d.get("n_voxels", 0))
    levels = tuple(
        _rows_i32(_decode_level(np.asarray(tab), int(n)), int(n), device)
        for tab, n in zip(d["levels"], d["n_per_level"])
    )
    snodes = d.get("snodes")

    def attr(key):
        a = d.get(key)
        return None if a is None else _rows_i32(a, n_v, device)

    return HakoTree(
        bricks=_rows_i32(d["bricks"], n_b, device),
        n_bricks=n_b,
        levels=levels,
        n_per_level=tuple(int(n) for n in d["n_per_level"]),
        root_mask_lo=int(d["root_mask_lo"]),
        root_mask_hi=int(d["root_mask_hi"]),
        T=int(d["T"]),
        res=int(d["res"]),
        grid_res=int(d["grid_res"]),
        lower=torch.tensor(np.asarray(d["lower"], np.float32), device=device),
        upper=torch.tensor(np.asarray(d["upper"], np.float32), device=device),
        dps=float(d["dps"]),
        snodes=None if snodes is None else _rows_i32(snodes, n_s, device),
        n_snodes=n_s,
        color=attr("color"),
        emission=attr("emission"),
        n_voxels=n_v,
        has_emission=bool(d.get("has_emission", False)),
    )
