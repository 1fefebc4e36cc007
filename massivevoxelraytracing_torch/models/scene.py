"""Scene build: triangle soup -> voxels -> traversal structure (the
reference's models/scene.py): a HakoTree ("hako"), a BrickTree ("brick")
or an SVO/DAG ("octree", `dag` on or off).

The reference's two-pass structure, in ops/voxelize's three stages (on the
card, one kernel each):
  upload: the split triangle arrays, one host-to-device copy each a build
    (through pinned memory)
  pass 1 (voxCount): each triangle's valid candidates (`count`, one launch
    over all triangles), their int64 exclusive prefix on the device, and
    the per-chunk counts read back once (readback 1)
  pass 2 (voxelize): each group's triangles' valid candidates, in order,
    written at their offsets into the group's dump buffers (`emit`, one
    launch a group)
  then one sort + unique with true duplicate-mean attributes
  (`unique_reduce` after the stable sort), or, above GROUP_DUMPED dumped
  voxels, a per-group sort to channel sums and one merge of the much
  smaller unique streams (the same attributes bit for bit: sum of sums /
  sum of counts). Groups are runs of `chunk_tris`-triangle chunks.
With stages="plain" the plain stages run instead, chunk by chunk, each
chunk copied to the device in each pass (the route before the kernels),
for holding the kernels against them.
Host readbacks: chunk counts, unique count, level counts of the tree.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..ops import bricktree as brick_ops
from ..ops import hako as hako_ops
from ..ops import octree as octree_ops
from ..ops import voxelize as vox_ops
from ..ops.octree import bucket
from ..utils import meshprep

GROUP_DUMPED = 40 << 20  # above this, unique runs hierarchically (by groups)


def upload(arrays, device) -> tuple:
    """Host float32 arrays -> tensors on `device`, one copy each. To the
    card through pinned memory: the pin is a host copy into the caching
    host allocator's blocks, the copy runs on the current stream without
    a sync. Once the allocator holds the blocks (every rebuild after the
    first) that took half the time of a copy from pageable memory
    (chip_smoke.py phase 3c)."""
    device = torch.device(device)
    host = (torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)
    if device.type != "cuda":
        return tuple(x.to(device) for x in host)
    return tuple(x.pin_memory().to(device, non_blocking=True) for x in host)


def _dump_buffers(n: int, device):
    return (
        torch.empty(n, dtype=torch.int64, device=device),
        torch.empty(n, dtype=torch.int32, device=device),
        torch.empty(n, dtype=torch.int32, device=device),
    )


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build_accel_from_unique(uniq, *, origin, dps, grid_res: int, accel: str,
                            device, dag: bool = True):
    """Unique-voxel stream (sort_and_unique's dict) -> traversal structure
    on `device` (the tail of the build, IntersectorOctreeGPU.hpp:163-239):
    accel "hako", "brick" or "octree"."""
    attrs = dict(color=uniq["color"], emission=uniq["emission"],
                 has_emission=uniq["has_emission"])
    lower = np.asarray(origin, np.float32)
    if accel == "hako":
        return hako_ops.build_hako(uniq["code"], grid_res, device=device,
                                   lower=lower, dps=float(dps), **attrs)
    if accel == "brick":
        return brick_ops.build_bricktree(uniq["code"], grid_res, device=device,
                                         lower=lower, dps=float(dps), **attrs)
    lower_t = torch.as_tensor(lower, device=device)
    upper = lower_t + torch.tensor(dps, dtype=torch.float32, device=device) * grid_res
    return octree_ops.build_octree(uniq["code"], grid_res, device=device,
                                   dag=dag, lower=lower_t, upper=upper, **attrs)


def chunk_offsets(end, chunk: int):
    """The dumped voxels before each chunk of `chunk` triangles and the
    total (n_chunks + 1 ints, one readback); end: the counts' int64
    inclusive prefix."""
    n_tri = len(end)
    ends = torch.clamp(torch.arange(1, -(-n_tri // chunk) + 1, device=end.device) * chunk,
                       max=n_tri) - 1
    return np.concatenate([[0], end[ends].cpu().numpy()])


def dump_groups(offsets) -> list:
    """The emit groups, as chunk ranges [ka, kb): all chunks in one group up
    to GROUP_DUMPED dumped voxels, else consecutive chunks until a group
    reaches it. offsets: the dumped voxels before each chunk and the total
    (n_chunks + 1 ints)."""
    n_chunks = len(offsets) - 1
    if offsets[-1] <= GROUP_DUMPED:
        return [(0, n_chunks)]
    groups = []
    k0 = 0
    for k in range(n_chunks):
        if offsets[k + 1] - offsets[k0] >= GROUP_DUMPED or k == n_chunks - 1:
            groups.append((k0, k + 1))
            k0 = k + 1
    return groups


def build_scene(tri_verts, tri_colors=None, tri_emissions=None, *, origin,
                dps, grid_res: int, device, six_separating: bool = True,
                cap: int = 4, chunk_tris: int = 65536, accel: str = "hako",
                dag: bool = True, stages: str | None = None):
    """Voxelize + build on `device`. tri_*: f32 [T, 3, 3] host arrays;
    accel: "hako", "brick" or "octree" (`dag`: the octree's dedup);
    stages: None, the build's kernels (the plain stages on the CPU);
    "plain", the plain stages chunk by chunk on any device."""
    if accel not in ("hako", "brick", "octree"):
        raise ValueError(f"accel must be 'hako', 'brick' or 'octree', not {accel!r}")
    S = vox_ops._stages(stages)
    device = torch.device(device)
    tri_verts = np.asarray(tri_verts, np.float32).reshape(-1, 3, 3)
    if tri_colors is None:
        tri_colors = np.ones_like(tri_verts)
    if tri_emissions is None:
        tri_emissions = np.zeros_like(tri_verts)

    # per-phase wall times, stamped at the pipeline's host sync points
    t_0 = time.time()
    arrays = meshprep.split_to_cap(
        tri_verts, tri_colors, tri_emissions, origin, dps, grid_res, cap
    )
    t_split = time.time()
    n_tri = len(arrays[0])
    chunk = min(chunk_tris, bucket(n_tri, floor=1024))
    origin_t = torch.as_tensor(np.asarray(origin, np.float32), device=device)
    dps_t = torch.tensor(dps, dtype=torch.float32, device=device)
    kw = dict(grid_res=grid_res, six_separating=six_separating, cap=cap)

    # the plain stages copy triangles [a, b) to the device each pass, a
    # chunk at a time; the kernels take all of them, copied once
    on_device = None if stages == "plain" else upload(arrays, device)

    def tris(a, b, n=3):
        if on_device is None:
            return upload((x[a:b] for x in arrays[:n]), device)
        return tuple(x[a:b] for x in on_device[:n])

    def runs(a, b):
        if on_device is None:
            return [(k, min(k + chunk, b)) for k in range(a, b, chunk)]
        return [(a, b)]

    # pass 1: counts (voxCount), their prefix, the chunk ends' prefixes
    counts = torch.cat([S.count(*tris(a, b, 1), origin_t, dps_t, **kw)
                        for a, b in runs(0, n_tri)])
    end = torch.cumsum(counts, 0, dtype=torch.int64)
    offsets = chunk_offsets(end, chunk)  # readback 1
    t_count = time.time()
    total_dumped = int(offsets[-1])
    if total_dumped == 0:
        raise ValueError("voxelization produced no voxels")
    start = end - counts

    # pass 2: emit the groups, then sort + unique (hierarchically by
    # groups of chunks above GROUP_DUMPED)
    groups = dump_groups(offsets)
    parts = []
    for ka, kb in groups:
        off0 = int(offsets[ka])
        bufs = _dump_buffers(int(offsets[kb]) - off0, device)
        for a, b in runs(ka * chunk, min(kb * chunk, n_tri)):
            S.emit(*tris(a, b), start[a:b] - off0, origin_t, dps_t, bufs, **kw)
        if len(groups) == 1:
            uniq = vox_ops.sort_and_unique(
                dict(code=bufs[0], color=bufs[1], emission=bufs[2]), stages)
        else:
            parts.append(vox_ops.sort_and_unique_sums(*bufs, stages=stages)[0])
        del bufs
    on_device = counts = end = start = None  # free before the merge and the tree
    if parts:
        rows = (torch.cat([p[0] for p in parts]),
                [torch.cat([p[1][i] for p in parts]) for i in range(6)],
                torch.cat([p[2] for p in parts]))
        parts = None
        uniq = vox_ops.merge_unique_sums(*rows, stages)
        rows = None
    n_unique = uniq["n_unique"]  # readback 2 (inside the unique)
    t_unique = time.time()
    stats = dict(
        n_triangles=int(n_tri),
        n_dumped=total_dumped,
        n_unique=n_unique,
        grid_res=grid_res,
    )
    tree = build_accel_from_unique(uniq, origin=origin, dps=dps,
                                   grid_res=grid_res, accel=accel,
                                   device=device, dag=dag)
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
