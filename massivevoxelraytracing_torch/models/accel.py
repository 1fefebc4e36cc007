"""Acceleration-structure dispatch (the reference's models/accel.py).

Only the HakoTree through the megakernel ("hako_mega") is ported. The
legacy round driver ("hako", ROADMAP Queue 1 #9) and the octree / brick
tree (Queue 1 #11) raise NotImplementedError.
"""

from __future__ import annotations

from ..ops import hako_mega
from ..ops.hako import HakoTree

_NOT_PORTED = {
    "hako": "the legacy round driver (ROADMAP Queue 1 #9)",
    "brick": "the BrickTree (ROADMAP Queue 1 #11)",
    "octree": "the SVO/DAG octree (ROADMAP Queue 1 #11)",
}


def accel_args(tree):
    """(kind, depth, meta, root) for intersect_with. For a HakoTree,
    depth is T and meta the (bricks, snodes, root-down level tables,
    root mask) tuple; root is unused."""
    if isinstance(tree, HakoTree):
        meta, T = hako_mega.hako_mega_args(tree)
        return "hako_mega", T, meta, None
    raise NotImplementedError(
        f"{type(tree).__name__}: only the HakoTree is ported "
        "(ROADMAP Queue 1 #11 for the others)")


def intersect_with(kind: str, depth, meta, root, lower, upper, ro, rd, *,
                   shadow: bool = False):
    """(t, nmajor, vrank) of rays ro/rd (f32 [R, 3] on the tree's device)."""
    if kind == "hako_mega":
        bricks, snodes, tabs, root_mask = meta
        return hako_mega.intersect_rays_hako_mega(
            bricks, snodes, tabs, root_mask, lower, upper, ro, rd,
            T=depth, shadow=shadow,
        )
    if kind in _NOT_PORTED:
        raise NotImplementedError(f"{kind}: {_NOT_PORTED[kind]} is not ported yet")
    raise ValueError(f"unknown acceleration structure {kind!r}")

