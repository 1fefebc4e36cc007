"""Acceleration-structure dispatch (the reference's models/accel.py).

A HakoTree is traced by one of two routes that give identical results:
"mega" (the default) through the megakernel (ops/hako_mega.py, one CUDA
thread per ray to completion), or "rounds" through the legacy round
driver (ops/hako_kernels.intersect_rays_hako: kernels A, B and the merge
with a host loop over rounds). The reference picks between them with the
MVRT_MEGA environment variable; here the caller says which. The octree
and the brick tree (ROADMAP Queue 1 #11) raise NotImplementedError.
"""

from __future__ import annotations

from ..ops import hako_kernels, hako_mega
from ..ops.hako import HakoTree

_KINDS = {"mega": "hako_mega", "rounds": "hako"}


def accel_args(tree, traversal: str = "mega"):
    """(kind, depth, meta, root) for intersect_with. For a HakoTree,
    depth is T and meta the (bricks, snodes, root-down level tables,
    root mask) tuple; root is unused. traversal: "mega" or "rounds"."""
    if traversal not in _KINDS:
        raise ValueError(f"traversal must be 'mega' or 'rounds', not {traversal!r}")
    if isinstance(tree, HakoTree):
        meta, T = hako_mega.hako_mega_args(tree)
        return _KINDS[traversal], T, meta, None
    raise NotImplementedError(
        f"{type(tree).__name__}: only the HakoTree is ported "
        "(ROADMAP Queue 1 #11 for the others)")


def intersect_with(kind: str, depth, meta, root, lower, upper, ro, rd, *,
                   shadow: bool = False):
    """(t, nmajor, vrank) of rays ro/rd (f32 [R, 3] on the tree's device)."""
    if kind == "hako_mega":
        fn = hako_mega.intersect_rays_hako_mega
    elif kind == "hako":
        fn = hako_kernels.intersect_rays_hako
    elif kind in ("brick", "octree"):
        raise NotImplementedError(f"{kind}: not ported yet (ROADMAP Queue 1 #11)")
    else:
        raise ValueError(f"unknown acceleration structure {kind!r}")
    bricks, snodes, tabs, root_mask = meta
    return fn(bricks, snodes, tabs, root_mask, lower, upper, ro, rd, T=depth,
              shadow=shadow)
