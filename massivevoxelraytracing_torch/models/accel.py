"""Acceleration-structure dispatch (the reference's models/accel.py).

Three structures share the same voxel stream:
  * HakoTree    -- fat 16^3 brick rows under a 4^3-branching top tree,
                   traced by one of two routes that give identical
                   results: "mega" (the default) through the megakernel
                   (ops/hako_mega.py, one CUDA thread per ray to
                   completion), or "rounds" through the legacy round driver
                   (ops/hako_kernels.intersect_rays_hako: kernel A and the
                   row stage, kernel B and the merge in one launch, with a
                   host loop over rounds). The reference
                   picks between them with the MVRT_MEGA environment
                   variable; here the caller says which (`traversal`);
  * BrickTree   -- 4^3-branching, rank-based, 16 B a node ("brick");
  * VoxelOctree -- the reference-parity SVO/DAG, traced by the v2 walk
                   ("octree").
The brick and octree walks are hand-written CUDA kernels on the card
(csrc/walks.cu, through ops/bricktree.intersect_rays_brick and
ops/traverse2.intersect_rays2) and tensor code on the CPU; `traversal`
means nothing to them, and `stages="plain"` runs their tensor walks on
any device.
"""

from __future__ import annotations

from ..ops import bricktree, hako_kernels, hako_mega, traverse2
from ..ops.bricktree import BrickTree
from ..ops.hako import HakoTree
from ..ops.octree import VoxelOctree
from ..ops.traverse import root_entry_of

_KINDS = {"mega": "hako_mega", "rounds": "hako"}


def accel_args(tree, traversal: str = "mega"):
    """(kind, depth, meta, root) for intersect_with. For a HakoTree,
    depth is T and meta the (bricks, snodes, root-down level tables,
    root mask) tuple; root is unused. For a BrickTree, depth is its brick
    levels, meta its rows and root the root's index; for a VoxelOctree,
    depth is the stack depth, meta children ++ psum and root the root
    entry (index | mask << 24). traversal: "mega" or "rounds" (a
    HakoTree's route)."""
    if traversal not in _KINDS:
        raise ValueError(f"traversal must be 'mega' or 'rounds', not {traversal!r}")
    if isinstance(tree, HakoTree):
        meta, T = hako_mega.hako_mega_args(tree)
        return _KINDS[traversal], T, meta, None
    if isinstance(tree, BrickTree):
        return "brick", tree.n_levels, tree.meta, tree.root
    if isinstance(tree, VoxelOctree):
        depth = max(int(tree.grid_res).bit_length() - 1, 1)
        return "octree", depth, traverse2.tree_meta(tree), root_entry_of(tree)
    raise TypeError(f"not an acceleration structure: {type(tree).__name__}")


def intersect_with(kind: str, depth, meta, root, lower, upper, ro, rd, *,
                   shadow: bool = False, stages: str | None = None):
    """(t, nmajor, vrank) of rays ro/rd (f32 [R, 3] on the tree's device).
    stages="plain": the brick / octree walk's tensor version on any device
    (a HakoTree's routes are unchanged)."""
    if stages not in (None, "plain"):
        raise ValueError(f"stages must be None or 'plain', not {stages!r}")
    plain = stages == "plain"
    if kind == "brick":
        fn = bricktree.intersect_rays_brick_plain if plain else bricktree.intersect_rays_brick
        return fn(meta, root, lower, upper, ro, rd, n_levels=depth, shadow=shadow)
    if kind == "octree":
        fn = traverse2.intersect_rays2_plain if plain else traverse2.intersect_rays2
        return fn(meta, root, lower, upper, ro, rd, stack_depth=depth, shadow=shadow)
    if kind == "hako_mega":
        fn = hako_mega.intersect_rays_hako_mega
    elif kind == "hako":
        fn = hako_kernels.intersect_rays_hako
    else:
        raise ValueError(f"unknown acceleration structure {kind!r}")
    bricks, snodes, tabs, root_mask = meta
    return fn(bricks, snodes, tabs, root_mask, lower, upper, ro, rd, T=depth,
              shadow=shadow)
