"""Bottom-up sparse-voxel-octree / DAG build from sorted Morton codes (the
port of the reference's ops/octree.py; IntersectorOctreeGPU.hpp:40-241 and
voxKernel.cu:245-435 of the original renderer).

Every step is a sorted / segmented tensor op:
  * group-by-parent  = neighbour-diff boundary mask + cumsum segment ids
  * node assembly    = scatter into [n_groups, 8] slot arrays
  * DAG dedup        = lexicographic sort of the (mask, children[0..7])
                       keys, run-boundary unique and an index remap. Node
                       order is canonical: the same keys in the same
                       priority as the reference's lax.sort(num_keys=9), so
                       the node arrays equal the reference's
  * level sizing     = one boundary pre-count, read back once

Node layout (u32 words held as int32 bit patterns, like the HakoTree rows):
  children [N, 8]   0xFFFFFFFF = empty slot or leaf voxel; bits 24..31
                    carry the child's own mask (embedded masks)
  psum     [N, 8]   exclusive prefix sum of per-child voxel counts (the
                    attribute index of a hit is the sum along its path)
  mask     [N]      8-bit occupancy
  meta     [N, 16]  children ++ psum (one row read per visit, traverse2)
The root is the last node; level l's nodes occupy [offset_l, offset_l +
n_l). Morton codes are int64 (the reference's (hi, lo) u32 limbs exist
only because JAX runs with x64 off).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .bits import to_i32_bits
from .hako import _boundaries, _group_starts

INVALID = 0xFFFFFFFF
_IDX24 = 0xFFFFFF  # an empty slot's 24-bit key in the DAG sort


def next_pow2(n: int) -> int:
    n = max(int(n), 1)
    return 1 << (n - 1).bit_length()


def bucket(n: int, floor: int = 8) -> int:
    """Padded size for a dynamic count: the next power of two, at least
    `floor`."""
    return max(next_pow2(n), floor)


@dataclasses.dataclass
class VoxelOctree:
    """Traversal-ready SVO/DAG + per-voxel attributes."""

    children: torch.Tensor  # int32 [N, 8], embedded masks
    psum: torch.Tensor      # int32 [N, 8]
    mask: torch.Tensor      # int32 [N]
    n_nodes: int
    grid_res: int
    lower: torch.Tensor     # f32 [3]
    upper: torch.Tensor     # f32 [3]
    color: torch.Tensor | None = None     # int32 [n_voxels] packed rgb8
    emission: torch.Tensor | None = None  # int32 [n_voxels] packed rgb8
    n_voxels: int = 0
    has_emission: bool = False
    meta: torch.Tensor | None = None      # int32 [N, 16]
    build_stats: dict | None = None

    @property
    def root(self) -> int:
        return self.n_nodes - 1

    @property
    def device(self) -> torch.device:
        return self.children.device

    def memory_bytes(self) -> int:
        # parity metric with IntersectorOctree::getMemoryConsumption
        # (68 B a node: mask + 8 children + 8 psums)
        return self.n_nodes * 68


def level_task_counts(codes: torch.Tensor, n_levels: int) -> list:
    """Distinct-parent counts per level in one pass (octreeTaskInit,
    voxKernel.cu:245-267): counts[l] = groups at level l = tasks fed to
    level l + 1. codes: sorted unique int64. One host readback."""
    counts = [_boundaries(codes >> (3 * (l + 1))).sum() for l in range(n_levels)]
    return torch.stack(counts).tolist()


def _dag_keys(mask, children):
    """(mask, children[0..7]) packed into four int64 keys with the same
    lexicographic order: an empty slot (INVALID) becomes 0xFFFFFF, above
    every level-local index (< 0xFFFFFF)."""
    c = torch.where(children == INVALID, _IDX24, children)
    return [(mask << 48) | (c[:, 0] << 24) | c[:, 1],
            (c[:, 2] << 24) | c[:, 3],
            (c[:, 4] << 24) | c[:, 5],
            (c[:, 6] << 24) | c[:, 7]]


def build_level(t_m, t_child, t_nvox, *, dag: bool) -> dict:
    """One bottom-up level (bottomUpOctreeBuild, voxKernel.cu:269-424).

    Tasks: sorted Mortons t_m, child pointers t_child (INVALID for a voxel)
    and voxel counts t_nvox, int64 [n]. Returns the level's nodes
    (node_children / node_psum int64 [n_unique, 8], node_mask [n_unique],
    level-local child indices) and the next level's tasks (t_m, t_child,
    t_nvox, one per group)."""
    dev = t_m.device
    p = t_m >> 3
    slot = t_m & 7
    boundary = _boundaries(p)
    gid = torch.cumsum(boundary, 0) - 1
    gstart = _group_starts(boundary)
    n_groups = gstart.shape[0]

    flat = gid * 8 + slot
    children = torch.full((n_groups * 8,), INVALID, dtype=torch.int64, device=dev)
    children[flat] = t_child
    children = children.reshape(n_groups, 8)
    nvox = torch.zeros(n_groups * 8, dtype=torch.int64, device=dev)
    nvox[flat] = t_nvox
    nvox = nvox.reshape(n_groups, 8)
    mask = torch.zeros(n_groups, dtype=torch.int64, device=dev)
    mask.scatter_add_(0, gid, torch.ones_like(slot) << slot)

    psum = torch.cumsum(nvox, 1) - nvox  # exclusive scan per node
    total = nvox.sum(1)
    g_m = p[gstart]

    if dag:
        # canonical dedup: sort groups by (mask, children[0..7]), equal keys
        # collapse to the first of their run (replaces the lock-free hash
        # table, voxKernel.cu:335-405); a stable least-significant-first
        # radix of the four packed keys
        keys = _dag_keys(mask, children)
        perm = torch.arange(n_groups, dtype=torch.int64, device=dev)
        for k in reversed(keys):
            perm = perm[torch.sort(k[perm], stable=True).indices]
        s_keys = [k[perm] for k in keys]
        uniq = torch.ones(n_groups, dtype=torch.bool, device=dev)
        diff = torch.zeros(max(n_groups - 1, 0), dtype=torch.bool, device=dev)
        for k in s_keys:
            diff = diff | (k[1:] != k[:-1])
        uniq[1:] = diff
        uid = torch.cumsum(uniq, 0) - 1
        rep_row = perm[_group_starts(uniq)]
        node_children = children[rep_row]
        node_psum = psum[rep_row]
        node_mask = mask[rep_row]
        task_child = torch.empty_like(uid)
        task_child[perm] = uid
    else:
        node_children, node_psum, node_mask = children, psum, mask
        task_child = torch.arange(n_groups, dtype=torch.int64, device=dev)
    return dict(node_children=node_children, node_psum=node_psum,
                node_mask=node_mask, n_unique=int(node_mask.shape[0]),
                t_m=g_m, t_child=task_child, t_nvox=total, n_groups=n_groups)


def _init_tasks(codes):
    """Level-0 tasks: every voxel is a leaf (INVALID child) of count 1."""
    return (torch.full_like(codes, INVALID), torch.ones_like(codes))


def _assemble(level_nodes, offsets):
    """Concatenate the levels bottom-up, remap child indices to global by
    adding the previous level's offset, and embed each child's mask into
    pointer bits 24..31 (the compact copy + embedMasks steps,
    IntersectorOctreeGPU.hpp:219-241). Returns int32 (children, psum,
    mask, meta)."""
    chs = []
    for l, (ch, _, _) in enumerate(level_nodes):
        if l > 0:
            ch = torch.where(ch == INVALID, ch, ch + offsets[l - 1])
        chs.append(ch)
    children = torch.cat(chs)
    psum = torch.cat([ps for _, ps, _ in level_nodes])
    mask = torch.cat([mk for _, _, mk in level_nodes])
    empty = children == INVALID
    child_mask = mask[torch.where(empty, 0, children)]
    children = torch.where(empty, children, children | (child_mask << 24))
    children, psum, mask = (to_i32_bits(x) for x in (children, psum, mask))
    return children, psum, mask, torch.cat([children, psum], dim=1)


def build_octree(codes: torch.Tensor, grid_res: int, *, device=None,
                 dag: bool = True, lower=None, upper=None, color=None,
                 emission=None, has_emission: bool = False) -> VoxelOctree:
    """Build from the sorted unique Morton codes (int64 [n_voxels]) on
    `device` (default: the codes' device). lower / upper: the root box
    (default the unit cube); color / emission int32 [n_voxels] or None."""
    assert grid_res >= 2 and (grid_res & (grid_res - 1)) == 0
    device = codes.device if device is None else torch.device(device)
    codes = codes.to(device=device, dtype=torch.int64)
    n_levels = int(grid_res).bit_length() - 1

    counts = level_task_counts(codes, n_levels)  # readback
    assert counts[-1] == 1, f"top level must collapse to one group, got {counts[-1]}"

    t_m = codes
    t_child, t_nvox = _init_tasks(codes)
    level_nodes = []
    n_uniques = []
    for _ in range(n_levels):
        out = build_level(t_m, t_child, t_nvox, dag=dag)
        level_nodes.append((out["node_children"], out["node_psum"], out["node_mask"]))
        n_uniques.append(out["n_unique"])
        t_m, t_child, t_nvox = out["t_m"], out["t_child"], out["t_nvox"]

    offsets = np.concatenate([[0], np.cumsum(n_uniques)]).tolist()
    total = int(offsets[-1])
    assert total < _IDX24, "node count exceeds embedded-mask capacity"
    children, psum, mask, meta = _assemble(level_nodes, offsets)

    lower = torch.as_tensor(np.zeros(3, np.float32) if lower is None else lower,
                            dtype=torch.float32).to(device)
    upper = torch.as_tensor(np.ones(3, np.float32) if upper is None else upper,
                            dtype=torch.float32).to(device)
    return VoxelOctree(
        children=children, psum=psum, mask=mask, n_nodes=total,
        grid_res=grid_res, lower=lower, upper=upper,
        color=None if color is None else color.to(device),
        emission=None if emission is None else emission.to(device),
        n_voxels=int(codes.shape[0]), has_emission=bool(has_emission),
        meta=meta,
    )


def _i32(a, n: int, device) -> torch.Tensor:
    return torch.from_numpy(
        np.ascontiguousarray(np.asarray(a)[:n]).astype(np.uint32).view(np.int32)
    ).to(device)


def from_numpy(d: dict, device="cuda") -> VoxelOctree:
    """VoxelOctree from the fields of a tree built by the JAX package, as
    numpy arrays and python numbers (children / psum / mask padded past
    n_nodes, lower / upper, color / emission). Arrays are cut to their
    valid counts; meta is children ++ psum."""
    n = int(d["n_nodes"])
    n_v = int(d.get("n_voxels", 0))
    children = _i32(d["children"], n, device)
    psum = _i32(d["psum"], n, device)

    def attr(key):
        a = d.get(key)
        return None if a is None else _i32(a, n_v, device)

    return VoxelOctree(
        children=children, psum=psum, mask=_i32(d["mask"], n, device),
        n_nodes=n, grid_res=int(d["grid_res"]),
        lower=torch.tensor(np.asarray(d["lower"], np.float32), device=device),
        upper=torch.tensor(np.asarray(d["upper"], np.float32), device=device),
        color=attr("color"), emission=attr("emission"), n_voxels=n_v,
        has_emission=bool(d.get("has_emission", False)),
        meta=torch.cat([children, psum], dim=1),
    )
