"""Streamed HakoTree build (the port of the reference's ops/hako_stream.py):
reference-scale grids (16384^3, hundreds of millions of voxels) without
ever holding the whole voxel Morton stream on the device.

build_hako needs the whole sorted unique Morton array resident (8 B a
voxel) plus its scatter temporaries. This builder consumes an iterator of
sorted Morton chunks whose boundaries fall on 16^3 brick boundaries (any
Morton-aligned cube partition of side >= 16 guarantees that, e.g.
utils/shellgen.py), so:

  * every chunk's bricks are disjoint from every other chunk's: the
    per-chunk `_build_bricks` outputs concatenate with no merge step;
  * the device peak per chunk is O(chunk); finished brick rows park on the
    host (park="host", 656 B a brick) or stay on the device (park="device")
    as parts concatenated once at the end;
  * the levels above the bricks need only the brick Mortons and ride the
    same `_assemble_above` as build_hako, so the streamed and the
    monolithic builds are bit-identical.
"""

from __future__ import annotations

import numpy as np
import torch

from .hako import HakoTree, _assemble_above, _build_bricks

MAX_VOXELS = (1 << 31) - 1  # voxel ranks travel as int32


def _rebase(rows: torch.Tensor, off: int) -> torch.Tensor:
    """base (col 130) is the voxel rank inside the chunk; make it global.
    Ranks stay below 2^31 (checked by the caller), so the int32 add
    cannot wrap."""
    rows[:, 130] += off
    return rows


def build_hako_stream(chunks, grid_res: int, *, lower=None, dps: float = 1.0,
                      has_emission: bool = False, park: str = "host") -> HakoTree:
    """chunks: iterator of tuples (codes,), (codes, color) or (codes, color,
    emission): int64 Morton codes and packed rgb8 int32 attributes in the
    chunk's order, on one device (the tree's). Each chunk is sorted, the
    chunks are globally ascending and unique, and split only at 16^3 brick
    boundaries. Since the chunks are in order, the global attribute arrays
    (indexed by voxel rank) are their concatenation. Either all chunks
    carry attributes or none do.

    park: "host" copies each chunk's finished rows to host memory (the
    lowest device peak) and checks the chunk order chunk by chunk;
    "device" keeps them on the device and checks the order with one
    readback at the end."""
    assert park in ("host", "device")
    on_host = park == "host"
    rows_parts: list = []
    gbm_parts: list = []
    col_parts: list = []
    emi_parts: list = []
    edges: list = []  # device mode: (first, last) brick Morton of each chunk
    vox_off = 0
    last_bm = -1
    device = None
    for chunk in chunks:
        codes, col, emi = (tuple(chunk) + (None, None))[:3]
        n_c = int(codes.shape[0])
        if n_c == 0:
            continue
        device = codes.device
        if vox_off + n_c > MAX_VOXELS:
            raise OverflowError(
                f"{vox_off + n_c} voxels: ranks past 2^31 - 1 do not fit int32")
        for parts, a in ((col_parts, col), (emi_parts, emi)):
            if a is not None:
                parts.append(a[:n_c].cpu() if on_host else a[:n_c])
            if len(parts) not in (0, len(rows_parts) + 1):
                raise ValueError("all chunks must carry attributes, or none")
        rows, g_bm = _build_bricks(codes.to(torch.int64))
        rows = _rebase(rows, vox_off)
        if on_host:
            gbm_host = g_bm.cpu()
            # brick-aligned chunks in global order = disjoint ascending
            # brick runs; a generator fault shows here, not in traversal
            if int(gbm_host[0]) <= last_bm:
                raise ValueError(f"chunks overlap or reorder bricks: brick "
                                 f"{int(gbm_host[0])} after {last_bm}")
            last_bm = int(gbm_host[-1])
            rows_parts.append(rows.cpu())
            gbm_parts.append(gbm_host)
        else:
            rows_parts.append(rows)
            gbm_parts.append(g_bm)
            edges.append(torch.stack([g_bm[0], g_bm[-1]]))
        vox_off += n_c

    if not rows_parts:
        raise ValueError("empty voxel stream")
    if edges:
        ed = torch.stack(edges).cpu()  # one readback for every chunk
        if not bool((ed[1:, 0] > ed[:-1, 1]).all()):
            raise ValueError("chunks overlap or reorder bricks")
    rows_all = torch.cat(rows_parts).to(device)
    del rows_parts
    gbm_all = torch.cat(gbm_parts).to(device)
    del gbm_parts
    nb = rows_all.shape[0]
    assert nb < (1 << 24), f"brick count {nb} exceeds capacity"

    (snode_rows, n_snodes, levels, n_per_level, root_lo, root_hi,
     T, res4h) = _assemble_above(gbm_all, nb, grid_res)

    def cat_attr(parts):
        return torch.cat(parts).to(device) if parts else None

    if lower is None:
        lower = np.zeros(3, np.float32)
    lower = torch.tensor(np.asarray(lower, np.float32), device=device)
    dps_t = torch.tensor(dps, dtype=torch.float32, device=device)
    return HakoTree(
        bricks=rows_all, n_bricks=nb, levels=levels, n_per_level=n_per_level,
        root_mask_lo=root_lo, root_mask_hi=root_hi, T=T, res=res4h,
        grid_res=grid_res, lower=lower, upper=lower + dps_t * res4h,
        dps=float(dps), snodes=snode_rows, n_snodes=n_snodes,
        color=cat_attr(col_parts), emission=cat_attr(emi_parts),
        n_voxels=vox_off, has_emission=bool(has_emission),
        build_stats=dict(n_unique=vox_off, n_dumped=vox_off, grid_res=grid_res),
    )
