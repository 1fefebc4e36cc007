"""Scene-memory sharding: a HakoTree split into brick-range sub-trees, one
a device (the port of the JAX package's parallel/bigscene.py).

The brick table is cut into D contiguous Morton ranges ("shards"); each
shard is a complete HakoTree over the full grid above its bricks only.
Every shard traces the frame's rays against its own bricks (the round
driver: kernel A and the row stage a round); the nearest hit is the
per-lane min over shards, ties going to the lowest shard (voxel surfaces are
independent, so min-t composes exactly), and shadow rays compose the same
way (any hit on any shard). Attributes stay with their shard: each shard
shades its own candidate hits and the D candidate colors meet in the
final per-lane select, made on the first shard's device.

Sharding a built tree is exact: shards reuse the tree's brick rows as
they are (the same 164-word rows, the same in-brick DDA bits); only the
voxel-base column is rebased to the shard, and the small upper levels are
rebuilt over the shard's bricks (ops/hako._assemble_above, the build's
own level code). A shard's voxel base is its first brick's base, so a
shard-local voxel index plus the base is the whole tree's index.
"""

from __future__ import annotations

import torch

from ..models.raycast import shade
from ..ops import hako as hako_ops
from ..ops.bits import MASK32, to_i32_bits
from ..ops.hako import HakoTree
from ..ops.hako_kernels import MAX_FLOAT, intersect_hako

BASE_COL = 130   # brick row: rank of the brick's first voxel
MORTON_COL = 131  # brick row: brick Morton code (low 32 bits)


def shard_hako_tree(tree: HakoTree, n_shards: int, devices=None) -> list:
    """Split a built HakoTree into n_shards contiguous brick-range
    sub-trees. Shard d lives on devices[d % len(devices)], or on the
    tree's device. Each shard carries `voxel_base`, the whole tree's index
    of its first voxel."""
    nb = tree.n_bricks
    if not 1 <= n_shards <= nb:
        raise ValueError(f"cannot split {nb} bricks into {n_shards} shards")
    rows = tree.bricks[:nb]
    bounds = [round(d * nb / n_shards) for d in range(n_shards + 1)]
    # the base column in int64: a u32 rank above 2^31 reads negative as int32
    base = rows[:, BASE_COL].to(torch.int64) & MASK32
    gbm = rows[:, MORTON_COL].to(torch.int64) & MASK32

    shards = []
    for d in range(n_shards):
        s, e = bounds[d], bounds[d + 1]
        dev = tree.device if devices is None else torch.device(
            devices[d % len(devices)])
        base_s = int(base[s])
        base_e = int(base[e]) if e < nb else tree.n_voxels
        rows_d = rows[s:e].clone()
        rows_d[:, BASE_COL] = to_i32_bits(base[s:e] - base_s)
        (snode_rows, n_snodes, levels, n_per_level, root_lo, root_hi, T,
         res4h) = hako_ops._assemble_above(gbm[s:e], e - s, tree.grid_res)

        def attr(a):
            return None if a is None else a[base_s:base_e].to(dev)

        shard = HakoTree(
            bricks=rows_d.to(dev),
            n_bricks=e - s,
            levels=tuple(lv.to(dev) for lv in levels),
            n_per_level=n_per_level,
            root_mask_lo=root_lo,
            root_mask_hi=root_hi,
            T=T,
            res=res4h,
            grid_res=tree.grid_res,
            lower=tree.lower.to(dev),
            upper=tree.upper.to(dev),
            dps=tree.dps,
            snodes=None if snode_rows is None else snode_rows.to(dev),
            n_snodes=n_snodes,
            color=attr(tree.color),
            emission=attr(tree.emission),
            n_voxels=base_e - base_s,
            has_emission=tree.has_emission,
        )
        shard.voxel_base = base_s
        shards.append(shard)
    return shards


def _select(ts: list, *others):
    """Per-lane min over the shards' t (ties -> the lowest shard), on the
    first shard's device: (t, win, then each of `others` (lists of
    per-shard tensors) at the winning shard)."""
    dev = ts[0].device
    t = torch.stack([x.to(dev) for x in ts])
    win = torch.argmin(t, dim=0)  # the first minimum: the lowest shard
    pick = win[None]
    out = [t.gather(0, pick)[0], win]
    for xs in others:
        x = torch.stack([v.to(dev) for v in xs])
        idx = pick.reshape(pick.shape + (1,) * (x.dim() - 2)).expand(
            (1,) + tuple(x.shape[1:]))
        out.append(x.gather(0, idx)[0])
    return out


def intersect_sharded(shards: list, ro, rd, shadow: bool = False):
    """Trace every shard (its launches queue on its own device), then
    compose: per-lane min over t, ties to the lowest shard. Returns (t,
    nmaj, vidx, win) on the first shard's device, vidx global (the shard's
    voxel index + its base; 0 on a miss) exactly as the whole tree's."""
    outs = [intersect_hako(sh, ro, rd, shadow=shadow) for sh in shards]
    t, win, nmaj, vidx = _select([o[0] for o in outs], [o[1] for o in outs],
                                 [o[2] for o in outs])
    base = torch.tensor([sh.voxel_base for sh in shards], dtype=torch.int64,
                        device=t.device)
    vidx = torch.where(t < MAX_FLOAT, vidx.to(torch.int64) + base[win], 0)
    return t, nmaj, to_i32_bits(vidx), win


def render_rays_sharded(shards: list, ro, rd, show_color: bool = False):
    """Primary-ray shading over sharded scene memory: each shard shades
    its own candidate hits with its own attribute slice; the candidates
    meet in the per-lane min-t select. Returns (u8 [N, 3], f32 [N]) on the
    first shard's device."""
    imgs, ts = [], []
    for sh in shards:
        rd_d = torch.as_tensor(rd, dtype=torch.float32, device=sh.device).contiguous()
        t, nmaj, vidx = intersect_hako(sh, ro, rd_d)
        color = sh.color if sh.color is not None else torch.zeros(
            1, dtype=torch.int32, device=sh.device)
        img, t = shade(color, rd_d, t, nmaj, vidx, show_color=show_color)
        imgs.append(img)
        ts.append(t)
    t, _win, img = _select(ts, imgs)
    return img, t
