"""Sharded scene build: the triangle chunks partitioned over a device mesh
(the port of the JAX package's parallel/build.py).

Every mesh entry owns a contiguous run of triangle chunks and, on its own
device, runs the build's three stages (ops/voxelize: `count` -> the int64
exclusive prefix -> `emit` into dump buffers of exactly its dumped
voxels) and the group stage of the hierarchical unique
(`sort_and_unique_sums`: per voxel channel sums and a count). Its
triangles and dump buffers are freed as soon as its sums exist, so on one
card the peak is near one shard's, not all of them. The small per-shard
unique streams are all-gathered to the first entry's device and merged
(`merge_unique_sums`: sum of sums / sum of counts, the same integer
division as `sort_and_unique`).

The result is bit for bit the tree of models.scene.build_scene, at any
number of shards: voxelization is per triangle, every offset is an exact
integer count, and the merge's sums of integers commute exactly. (The
JAX package's sharded build drifts from its single build by a band of
float ties, because XLA fuses the coverage predicate differently in the
two programs; the port evaluates the same ops in both.)

Host readbacks: each shard's dumped voxels and unique count, the merged
unique count, the tree's level counts.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..models import scene as scene_mod
from ..ops import voxelize as vox_ops
from ..ops.octree import bucket
from ..utils import meshprep
from .mesh import Mesh, all_gather, make_build_mesh


def _shard_unique(arrays, device, origin, dps, kw):
    """One shard's triangles (host arrays) -> ((code, sums6, count),
    n_unique, n_dumped, seconds to its count's readback) on `device`: one
    copy of each array, one count launch, one readback of its dumped
    voxels, one emit, the group unique."""
    t0 = time.time()
    tri, col, emi = scene_mod.upload(arrays, device)
    counts = vox_ops.count(tri, origin, dps, **kw)
    end = torch.cumsum(counts, 0, dtype=torch.int64)
    n = int(end[-1]) if len(end) else 0
    count_s = time.time() - t0
    bufs = scene_mod._dump_buffers(n, device)
    vox_ops.emit(tri, col, emi, end - counts, origin, dps, bufs, **kw)
    del tri, col, emi, counts, end
    out, n_u = vox_ops.sort_and_unique_sums(*bufs)
    return out, n_u, n, count_s


def build_scene_sharded(tri_verts, tri_colors=None, tri_emissions=None, *,
                        origin, dps, grid_res: int, mesh: Mesh | None = None,
                        n_devices: int | None = None, device="cuda",
                        six_separating: bool = True, cap: int = 4,
                        dag: bool = True, chunk_tris: int = 65536,
                        accel: str = "octree"):
    """Voxelize + build over a device mesh (default: make_build_mesh of
    n_devices entries of `device`). Same contract, and bit for bit the
    same tree, as models.scene.build_scene; the tree lives on the mesh's
    first device. build_stats has n_devices and the phase split."""
    if accel not in ("hako", "brick", "octree"):
        raise ValueError(f"accel must be 'hako', 'brick' or 'octree', not {accel!r}")
    if mesh is None:
        mesh = make_build_mesh(n_devices, device)
    devs = mesh.flat()
    dp = len(devs)
    tri_verts = np.asarray(tri_verts, np.float32).reshape(-1, 3, 3)
    if tri_colors is None:
        tri_colors = np.ones_like(tri_verts)
    if tri_emissions is None:
        tri_emissions = np.zeros_like(tri_verts)

    t_0 = time.time()
    arrays = meshprep.split_to_cap(
        tri_verts, tri_colors, tri_emissions, origin, dps, grid_res, cap
    )
    t_split = time.time()
    n_tri = len(arrays[0])
    chunk = min(chunk_tris, bucket(n_tri, floor=1024))
    # every shard owns the same number of chunks L (the last ones may be
    # short or empty)
    per = -(-n_tri // (chunk * dp)) * chunk
    kw = dict(grid_res=grid_res, six_separating=six_separating, cap=cap)

    # count, emit and group unique, shard by shard on the shard's device
    streams = []
    for d, dev in enumerate(devs):
        consts = (torch.as_tensor(np.asarray(origin, np.float32), device=dev),
                  torch.tensor(dps, dtype=torch.float32, device=dev))
        sl = slice(d * per, min((d + 1) * per, n_tri))
        streams.append(_shard_unique([a[sl] for a in arrays], dev, *consts, kw))
    count_s = sum(s[3] for s in streams)  # the shards' count passes
    total_dumped = sum(s[2] for s in streams)
    if total_dumped == 0:
        raise ValueError("voxelization produced no voxels")

    # the build's only cross-device traffic: all-gather the unique streams
    # to the first device, then one merge there
    uniq = vox_ops.merge_unique_sums(
        all_gather([s[0][0] for s in streams]),
        [all_gather([s[0][1][i] for s in streams]) for i in range(6)],
        all_gather([s[0][2] for s in streams]),
    )
    del streams
    n_unique = uniq["n_unique"]
    t_unique = time.time()

    stats = dict(
        n_triangles=int(n_tri),
        n_dumped=int(total_dumped),
        n_unique=n_unique,
        grid_res=grid_res,
        n_devices=dp,
    )
    tree = scene_mod.build_accel_from_unique(
        uniq, origin=origin, dps=dps, grid_res=grid_res, accel=accel,
        device=devs[0], dag=dag)
    scene_mod._sync(devs[0])
    t_accel = time.time()
    stats["n_nodes"] = tree.n_nodes
    stats["accel_bytes"] = tree.memory_bytes()
    stats["t_split_s"] = t_split - t_0
    stats["t_count_s"] = count_s
    stats["t_unique_s"] = t_unique - t_split - count_s
    stats["t_accel_s"] = t_accel - t_unique
    stats["t_total_s"] = t_accel - t_0
    tree.build_stats = stats
    return tree
