"""Scene build: triangle soup -> voxels -> HakoTree (the reference's
models/scene.py, `accel="hako"` only).

The reference's two-pass structure:
  pass 1 (voxCount): per-chunk dumped-voxel counts, one host readback
  pass 2 (voxelize): each chunk's valid candidates, in order, written at
    running offsets into one dump buffer (`_chunk_emit`)
  then one sort + unique with true duplicate-mean attributes, or, above
  GROUP_DUMPED dumped voxels, a per-group sort to channel sums and one
  merge of the much smaller unique streams (the same attributes bit for
  bit: sum of sums / sum of counts).
Host readbacks: chunk counts, unique count, level counts of the tree.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..ops import hako as hako_ops
from ..ops import voxelize as vox_ops
from ..ops.octree import bucket
from ..utils import meshprep

GROUP_DUMPED = 40 << 20  # above this, unique runs hierarchically (by groups)


def _chunk_emit(bufs, cands, off: int):
    """Write one chunk's valid candidates (code, color, emission), in
    order, into the dump buffers at a running offset."""
    idx = torch.nonzero(cands["valid"]).reshape(-1)
    for buf, key in zip(bufs, ("code", "color", "emission")):
        buf[off:off + idx.shape[0]] = cands[key][idx]


def _dump_buffers(n: int, device):
    return (
        torch.empty(n, dtype=torch.int64, device=device),
        torch.empty(n, dtype=torch.int32, device=device),
        torch.empty(n, dtype=torch.int32, device=device),
    )


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build_scene(tri_verts, tri_colors=None, tri_emissions=None, *, origin,
                dps, grid_res: int, device, six_separating: bool = True,
                cap: int = 4, chunk_tris: int = 65536, accel: str = "hako"):
    """Voxelize + build on `device`. tri_*: f32 [T, 3, 3] host arrays."""
    if accel != "hako":
        raise NotImplementedError(
            f"accel={accel!r}: only 'hako' is ported (ROADMAP Queue 1 #11)")
    device = torch.device(device)
    tri_verts = np.asarray(tri_verts, np.float32).reshape(-1, 3, 3)
    if tri_colors is None:
        tri_colors = np.ones_like(tri_verts)
    if tri_emissions is None:
        tri_emissions = np.zeros_like(tri_verts)

    # per-phase wall times, stamped at the pipeline's host sync points
    t_0 = time.time()
    tri, col, emi = meshprep.split_to_cap(
        tri_verts, tri_colors, tri_emissions, origin, dps, grid_res, cap
    )
    t_split = time.time()
    n_tri = len(tri)
    chunk = min(chunk_tris, bucket(n_tri, floor=1024))
    tri, col, emi = meshprep.pad_triangles(tri, col, emi, chunk)
    n_chunks = len(tri) // chunk
    origin_t = torch.as_tensor(np.asarray(origin, np.float32), device=device)
    dps_t = torch.tensor(dps, dtype=torch.float32, device=device)

    def vox_chunk(k):
        sl = slice(k * chunk, (k + 1) * chunk)
        return vox_ops.voxelize_dense(
            *(torch.from_numpy(np.ascontiguousarray(a[sl])).to(device)
              for a in (tri, col, emi)),
            origin_t, dps_t, grid_res=grid_res,
            six_separating=six_separating, cap=cap,
        )

    # pass 1: counts (voxCount)
    counts = torch.stack(
        [vox_ops.count_voxels(vox_chunk(k)) for k in range(n_chunks)]
    ).cpu().numpy()  # readback 1
    t_count = time.time()
    total_dumped = int(counts.sum())
    if total_dumped == 0:
        raise ValueError("voxelization produced no voxels")
    offsets = np.concatenate([[0], np.cumsum(counts)])

    # pass 2: emit the chunks, then sort + unique (hierarchically by
    # groups of chunks above GROUP_DUMPED)
    if total_dumped <= GROUP_DUMPED:
        groups = [(0, n_chunks)]
    else:
        groups = []
        k0 = 0
        acc = 0
        for k in range(n_chunks):
            acc += int(counts[k])
            if acc >= GROUP_DUMPED or k == n_chunks - 1:
                groups.append((k0, k + 1))
                k0 = k + 1
                acc = 0

    parts = []
    for ka, kb in groups:
        off0 = int(offsets[ka])
        bufs = _dump_buffers(int(offsets[kb]) - off0, device)
        for k in range(ka, kb):
            _chunk_emit(bufs, vox_chunk(k), int(offsets[k]) - off0)
        if len(groups) == 1:
            valid = torch.ones_like(bufs[0], dtype=torch.bool)
            uniq = vox_ops.sort_and_unique(dict(
                valid=valid, code=bufs[0], color=bufs[1], emission=bufs[2]))
        else:
            parts.append(vox_ops.sort_and_unique_sums(
                *bufs, torch.ones_like(bufs[0], dtype=torch.bool))[0])
    if parts:
        uniq = vox_ops.merge_unique_sums(
            torch.cat([p[0] for p in parts]),
            [torch.cat([p[1][i] for p in parts]) for i in range(6)],
            torch.cat([p[2] for p in parts]),
        )
    n_unique = uniq["n_unique"]  # readback 2 (inside the unique)
    t_unique = time.time()
    stats = dict(
        n_triangles=int(n_tri),
        n_dumped=total_dumped,
        n_unique=n_unique,
        grid_res=grid_res,
    )
    tree = hako_ops.build_hako(
        uniq["code"], grid_res, device=device, lower=np.asarray(origin, np.float32),
        dps=float(dps), color=uniq["color"], emission=uniq["emission"],
        has_emission=uniq["has_emission"],
    )
    _sync(device)
    t_accel = time.time()
    stats["n_nodes"] = tree.n_nodes
    stats["accel_bytes"] = tree.memory_bytes()
    stats["t_split_s"] = t_split - t_0
    stats["t_count_s"] = t_count - t_split
    stats["t_unique_s"] = t_unique - t_count
    stats["t_accel_s"] = t_accel - t_unique
    stats["t_total_s"] = t_accel - t_0
    tree.build_stats = stats
    return tree
