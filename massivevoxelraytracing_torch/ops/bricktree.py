"""BrickTree64: a 4^3-branching sparse voxel tree (the port of the
reference's ops/bricktree.py).

  node record (u32 x 4, int32 bit patterns; one row read a visit):
    [mask_lo, mask_hi, base, 0]   64-bit cell occupancy over the 4^3 grid
  interior: child index = base + popcount64(mask & below(cell))   (the
            children of a node are contiguous: nodes are built in Morton
            order)
  leaf:     voxel rank  = base + popcount64(mask & below(cell))   (base =
            rank of the brick's first voxel in the sorted unique array)

so the attribute index falls out of popcounts with no per-level state.
The tree is built from the same sorted Morton stream as the octree (shift
6 a level instead of 3). Grids that are not a power of 4 are padded up:
the root covers a larger empty box, and `upper` moves with it.

The walk is the octree v2 walk over 64 cells a node (traverse2). Its
plain version (`intersect_rays_brick_plain`) steps the tensor body on the
live lanes only (traverse.run_walk); the wrapper `intersect_rays_brick`
runs it for CPU tensors and launches the hand-written brick_walk_kernel
(csrc/walks.cu, one thread a ray to completion) for CUDA tensors, bit for
bit the same. The reference's `block` sub-blocking is a TPU workaround and
is not ported.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .bits import MASK32, popcount32, to_i32_bits
from .hako import _boundaries, _build_top_level
from .traverse import (
    F32,
    I64,
    NEG_INF,
    launch_walk,
    run_walk,
    stack_push,
    stack_read,
    walk_device,
    walk_state,
)
from .traverse2 import _select_child


@dataclasses.dataclass
class BrickTree:
    meta: torch.Tensor   # int32 [N, 4]: mask_lo, mask_hi, base, pad
    n_nodes: int
    root: int
    n_levels: int        # brick levels (each covers 4x per axis)
    grid_res: int        # padded to a power of 4
    lower: torch.Tensor  # f32 [3]
    upper: torch.Tensor  # f32 [3] = lower + dps * grid_res (padded)
    color: torch.Tensor | None = None
    emission: torch.Tensor | None = None
    n_voxels: int = 0
    has_emission: bool = False
    build_stats: dict | None = None

    @property
    def device(self) -> torch.device:
        return self.meta.device

    def memory_bytes(self) -> int:
        return self.n_nodes * 16


def pad_res_pow4(grid_res: int) -> int:
    levels = (int(grid_res).bit_length() - 1 + 1) // 2  # ceil(log2 / 2)
    return 4 ** max(levels, 1)


def _level_counts64(codes, n_levels: int) -> list:
    """Distinct counts of codes >> 6(l+1), l < n_levels; one readback."""
    counts = [_boundaries(codes >> (6 * (l + 1))).sum() for l in range(n_levels)]
    return torch.stack(counts).tolist()


def _build_level64(t_m, child_start: int):
    """Group tasks (sorted Mortons of the level below) by 64-cell parents.
    child_start: global index of the first task's node in the level below
    (0 for the voxel level, where `base` is a voxel rank). Returns (int64
    [n_groups, 3] of mask_lo, mask_hi, base; parent Mortons)."""
    table, parents = _build_top_level(t_m)
    table = table.to(I64) & MASK32
    table[:, 2] += child_start
    return table, parents


def _assemble64(levels) -> torch.Tensor:
    """Levels bottom-up into one int32 [N, 4] meta (pad column 0)."""
    meta = torch.cat(levels)
    return to_i32_bits(torch.cat([meta, torch.zeros_like(meta[:, :1])], dim=1))


def build_bricktree(codes: torch.Tensor, grid_res: int, *, device=None,
                    lower=None, dps: float = 1.0, color=None, emission=None,
                    has_emission: bool = False) -> BrickTree:
    """Build from the sorted unique Morton codes (int64 [n_voxels]) on
    `device` (default: the codes' device)."""
    device = codes.device if device is None else torch.device(device)
    codes = codes.to(device=device, dtype=torch.int64)
    res4 = pad_res_pow4(grid_res)
    n_levels = (int(res4).bit_length() - 1) // 2
    assert n_levels >= 1

    counts = _level_counts64(codes, n_levels)
    assert counts[-1] == 1, f"root must be single, got {counts[-1]}"
    # level l's bases index level l-1's nodes (voxel ranks for l = 0);
    # the global meta goes bottom-up, level 0 first
    offsets = np.concatenate([[0], np.cumsum(counts)]).tolist()
    total = int(offsets[-1])

    levels = []
    t_m = codes
    for l in range(n_levels):
        table, t_m = _build_level64(t_m, 0 if l == 0 else int(offsets[l - 1]))
        levels.append(table)
    meta = _assemble64(levels)

    lower = torch.as_tensor(np.zeros(3, np.float32) if lower is None else lower,
                            dtype=F32).to(device)
    upper = lower + torch.tensor(dps, dtype=F32, device=device) * res4
    return BrickTree(
        meta=meta, n_nodes=total, root=total - 1, n_levels=n_levels,
        grid_res=res4, lower=lower, upper=upper,
        color=None if color is None else color.to(device),
        emission=None if emission is None else emission.to(device),
        n_voxels=int(codes.shape[0]), has_emission=bool(has_emission),
    )


def from_numpy(d: dict, device="cuda") -> BrickTree:
    """BrickTree from the fields of a tree built by the JAX package, as
    numpy arrays and python numbers (meta padded past n_nodes, root,
    n_levels, lower / upper, color / emission)."""
    n = int(d["n_nodes"])
    n_v = int(d.get("n_voxels", 0))

    def i32(a, k):
        return torch.from_numpy(np.ascontiguousarray(np.asarray(a)[:k])
                                .astype(np.uint32).view(np.int32)).to(device)

    def attr(key):
        a = d.get(key)
        return None if a is None else i32(a, n_v)

    return BrickTree(
        meta=i32(d["meta"], n), n_nodes=n, root=int(d["root"]),
        n_levels=int(d["n_levels"]), grid_res=int(d["grid_res"]),
        lower=torch.tensor(np.asarray(d["lower"], np.float32), device=device),
        upper=torch.tensor(np.asarray(d["upper"], np.float32), device=device),
        color=attr("color"), emission=attr("emission"), n_voxels=n_v,
        has_emission=bool(d.get("has_emission", False)),
    )


# ---------------------------------------------------------------------------
# traversal
# ---------------------------------------------------------------------------

def _popcount64_below(mask_lo, mask_hi, cell):
    """popcount of the mask bits strictly below `cell` (int [R] in
    [0, 64)); masks int64 holding u32 values."""
    c = cell.to(I64)
    one = torch.ones_like(c)
    below_lo = torch.where(c >= 32, MASK32, (one << torch.clamp(c, 0, 31)) - 1)
    below_hi = torch.where(c >= 32, (one << torch.clamp(c - 32, 0, 31)) - 1, 0)
    return popcount32(mask_lo & below_lo) + popcount32(mask_hi & below_hi)


# cell c of a node at (x, y, z) in [0, 4)^3: the two Morton levels of the
# cell index; the walk lays the 64 cells out x-major (64 = 4 x 4 x 4) and
# carries each column's cell index
_POS_CELL = [((x & 1) | ((y & 1) << 1) | ((z & 1) << 2)
              | ((x >> 1) << 3) | ((y >> 1) << 4) | ((z >> 1) << 5))
             for x in range(4) for y in range(4) for z in range(4)]
# a mirrored axis complements its 2-bit cell coordinate: XOR 0b11 spread
# over both Morton levels of the cell index
_MIRROR64 = (0b001001, 0b010010, 0b100100)


def _cell_coords(c):
    return ((c & 1) | (((c >> 3) & 1) << 1),
            ((c >> 1) & 1) | (((c >> 4) & 1) << 1),
            ((c >> 2) & 1) | (((c >> 5) & 1) << 1))


def _cell_planes(t1x, t1y, t1z, dtx, dty, dtz, scale, quarters):
    """A visit's 15 cell planes, tb[k] = t1 - dt*(scale - (scale/4)*k) for
    k = 0..4 (f32 [n, 5] an axis, in the walk's mirrored frame), and
    scale / 4. quarters: f32 [0, 1, 2, 3, 4]."""
    qs = scale * 0.25
    steps = scale[:, None] - qs[:, None] * quarters[None, :]
    return (t1x[:, None] - dtx[:, None] * steps, t1y[:, None] - dty[:, None] * steps,
            t1z[:, None] - dtz[:, None] * steps, qs)


def _cell_entry_exit(tbx, tby, tbz):
    """Every cell's entry and exit (f32 [n, 64], x-major 4 x 4 x 4): the max
    / min of its planes over the axes, NaN if any is NaN."""
    n = tbx.shape[0]
    en = torch.maximum(tbx[:, :4, None, None], torch.maximum(
        tby[:, None, :4, None], tbz[:, None, None, :4])).reshape(n, 64)
    ex = torch.minimum(tbx[:, 1:, None, None], torch.minimum(
        tby[:, None, 1:, None], tbz[:, None, None, 1:])).reshape(n, 64)
    return en, ex


def crossed_cells_plain(tbx, tby, tbz, vmask):
    """brick_walk_kernel's mask of the cells a visit may accept, as tensor
    code (the tests hold it against the body's own en < ex & ex > 0; no
    route runs it). tb*: a visit's planes (f32 [n, 5] an axis, as
    _cell_planes gives them); vmask: int [n], the walk's mirror. Returns
    int64 [n], a bit pattern over the node's own cells: bit b is set iff
    walk cell c = b ^ vmask has en < ex and ex > 0.

    The kernel's construction, comparison for comparison. Along each axis
    the node's cell r enters at E[r] and leaves at X[r], the planes of walk
    coordinate r, or 3 - r where the axis is mirrored. A cell whose own
    interval is empty or behind the origin (not E[r] < X[r] and X[r] > 0)
    gets X[r] = NaN, so every comparison against it fails. Cell (x, y, z)
    is accepted iff each pair of its axes' intervals overlaps (E_a < X_b
    and E_b < X_a): with the diagonal terms above, these are the nine
    comparisons en_a < ex_b that max(E) < min(X) means when nothing is NaN,
    and a NaN plane fails one of them as it makes en or ex NaN. A
    comparison does not round, so the mask is the accepted set exactly."""
    n = tbx.shape[0]
    dev = tbx.device
    planes = torch.stack([tbx, tby, tbz], 1)
    mir = torch.stack([(vmask & m) != 0 for m in _MIRROR64], 1)[:, :, None]
    r = torch.arange(4, device=dev)
    enter = torch.where(mir, planes[:, :, 3 - r], planes[:, :, r])
    leave = torch.where(mir, planes[:, :, 4 - r], planes[:, :, r + 1])
    leave = torch.where((enter < leave) & (leave > 0.0), leave, float("nan"))

    def overlap(a, b):  # [n, 4, 4]: cell i on axis a, cell j on axis b
        return ((enter[:, a, :, None] < leave[:, b, None, :])
                & (enter[:, b, None, :] < leave[:, a, :, None]))

    xy, xz, yz = overlap(0, 1), overlap(0, 2), overlap(1, 2)
    crossed = (xy[:, :, :, None] & xz[:, :, None, :] & yz[:, None, :, :]).reshape(n, 64)
    bits = torch.ones(64, dtype=I64, device=dev) << torch.tensor(_POS_CELL, device=dev)
    return torch.where(crossed, bits[None, :], 0).sum(1)


def _brick_body(meta):
    last = meta.shape[0] - 1
    dev = meta.device
    cells = torch.tensor(_POS_CELL, device=dev)[None, :]
    quarters = torch.arange(5, dtype=F32, device=dev)

    def body(st):
        active = st["active"]
        node = st["node"]
        t1x, t1y, t1z = st["t1x"], st["t1y"], st["t1z"]
        scale = st["scale"]
        vm64 = st["vmask"]

        # the node's meta row (the one read)
        row = meta[torch.clamp(torch.where(active, node, 0), 0, last)].to(I64) & MASK32
        mask_lo, mask_hi, base = row[:, 0], row[:, 1], row[:, 2]

        # cell boundaries, and every cell's entry and exit
        tbx, tby, tbz, qs = _cell_planes(t1x, t1y, t1z, st["dtx"], st["dty"],
                                         st["dtz"], scale, quarters)
        en, ex = _cell_entry_exit(tbx, tby, tbz)
        mask64 = mask_lo | (mask_hi << 32)
        occ = ((mask64[:, None] >> (cells ^ vm64[:, None])) & 1) == 1
        best_t, best_c, n_valid = _select_child(
            en, ex, occ, st["rk_t"], st["rk_c"], cells, 64, strict=True)
        any_other = n_valid > 1

        found = active & (best_c < 64)
        pop = active & ~found

        real_best = (best_c ^ vm64) & 63
        target = (base + _popcount64_below(mask_lo, mask_hi, real_best)) & MASK32
        is_leaf = st["depth"] == 0

        hit = found & is_leaf & (best_t > 0.0)
        t_out = torch.where(hit, best_t, st["t"])
        # the best cell's per-axis entries, for the face normal
        cbx, cby, cbz = (torch.clamp(k, max=3)[:, None]
                         for k in _cell_coords(best_c))
        en_xa = tbx.gather(1, cbx)[:, 0]
        en_ya = tby.gather(1, cby)[:, 0]
        nmaj_new = torch.where(best_t == en_xa, 1, torch.where(best_t == en_ya, 2, 0))
        nmajor = torch.where(hit, nmaj_new, st["nmajor"])
        vidx = torch.where(hit, target, st["vidx"])
        active = active & ~hit

        skip_leaf = found & is_leaf & ~hit
        descend = found & ~is_leaf & active
        push = descend & any_other

        stack_push(st, push, [("s_node", node), ("s_depth", st["depth"]),
                              ("s_t1x", t1x), ("s_t1y", t1y), ("s_t1z", t1z),
                              ("s_scale", scale), ("s_rkt", best_t),
                              ("s_rkc", best_c)])
        sp = st["sp"] + push.to(I64)

        # descend: the best cell's exits become the child's t1
        node = torch.where(descend, target, node)
        depth = torch.where(descend, st["depth"] - 1, st["depth"])
        t1x = torch.where(descend, tbx.gather(1, cbx + 1)[:, 0], t1x)
        t1y = torch.where(descend, tby.gather(1, cby + 1)[:, 0], t1y)
        t1z = torch.where(descend, tbz.gather(1, cbz + 1)[:, 0], t1z)
        scale = torch.where(descend, qs, scale)
        rk_t = torch.where(descend, NEG_INF,
                           torch.where(skip_leaf, best_t, st["rk_t"]))
        rk_c = torch.where(descend, -1, torch.where(skip_leaf, best_c, st["rk_c"]))

        # pop
        exhausted = pop & (sp == 0)
        active = active & ~exhausted
        do_pop = pop & (sp > 0) & active
        sp = sp - do_pop.to(I64)
        st.update(
            node=stack_read(st["s_node"], sp, node, do_pop),
            depth=stack_read(st["s_depth"], sp, depth, do_pop),
            t1x=stack_read(st["s_t1x"], sp, t1x, do_pop),
            t1y=stack_read(st["s_t1y"], sp, t1y, do_pop),
            t1z=stack_read(st["s_t1z"], sp, t1z, do_pop),
            scale=stack_read(st["s_scale"], sp, scale, do_pop),
            rk_t=stack_read(st["s_rkt"], sp, rk_t, do_pop),
            rk_c=stack_read(st["s_rkc"], sp, rk_c, do_pop),
            sp=sp, active=active, t=t_out, nmajor=nmajor, vidx=vidx)
        return st

    return body


def intersect_rays_brick(meta, root: int, lower, upper, ro, rd, *,
                         n_levels: int, shadow: bool = False,
                         max_iters: int = 100_000):
    """The brick walk. meta: int32 [N, 4]; ro/rd f32 [R, 3] on the tree's
    device. Returns (t f32 [R], MAX_FLOAT for a miss; n_major int32 [R];
    v_index int32 [R], the voxel rank). `shadow` changes nothing here:
    the rank comes from popcounts, not an accumulated prefix. CPU tensors
    run the plain walk; CUDA tensors launch brick_walk_kernel. Raises
    ValueError for another device, a wrong dtype or shape, or n_levels
    outside [1, 16], before any launch."""
    kw = dict(n_levels=n_levels, shadow=shadow, max_iters=max_iters)
    if walk_device("brick_walk", meta, 4, lower, upper, ro, rd, n_levels) == "cpu":
        return intersect_rays_brick_plain(meta, root, lower, upper, ro, rd, **kw)
    return launch_walk("brick_walk", meta, root, lower, upper, ro, rd,
                       depth=n_levels, shadow=shadow, max_iters=max_iters)


def intersect_rays_brick_plain(meta, root: int, lower, upper, ro, rd, *,
                               n_levels: int, shadow: bool = False,
                               max_iters: int = 100_000, on_step=None):
    """The brick walk as tensor code on any device (intersect_rays_brick's
    plain version). on_step: as traverse.run_walk's."""
    st = walk_state(ro, rd, lower, upper, n_levels, _MIRROR64,
                    ("s_node", "s_depth", "s_rkc"),
                    ("s_t1x", "s_t1y", "s_t1z", "s_scale", "s_rkt"))
    st.update(node=torch.full_like(st["sp"], int(root)),
              depth=torch.full_like(st["sp"], n_levels - 1),
              rk_t=torch.full_like(st["t"], NEG_INF),
              rk_c=torch.full_like(st["sp"], -1))
    return run_walk(st, _brick_body(meta), ro.shape[0], max_iters, on_step)


def intersect_bricktree(tree: BrickTree, ro, rd, shadow: bool = False,
                        max_iters: int = 100_000):
    """The brick walk over a BrickTree (ro / rd: anything torch takes)."""
    dev = tree.device
    return intersect_rays_brick(
        tree.meta, tree.root, tree.lower, tree.upper,
        torch.as_tensor(ro, dtype=F32, device=dev).reshape(-1, 3),
        torch.as_tensor(rd, dtype=F32, device=dev).reshape(-1, 3),
        n_levels=tree.n_levels, shadow=shadow, max_iters=max_iters)
