"""Sharded scene build: the triangle chunks partitioned over a device mesh
(the port of the JAX package's parallel/build.py).

Every mesh entry owns a contiguous run of triangle chunks and, on its own
device, runs the two-pass voxelize (count -> emit at running offsets) and
the group stage of the hierarchical unique (`sort_and_unique_sums`: per
voxel channel sums and a count). Its dump buffers are freed as soon as
its sums exist, so on one card the peak is near one shard's buffers, not
all of them. The small per-shard unique streams are all-gathered to the
first entry's device and merged (`merge_unique_sums`: sum of sums / sum
of counts, the same integer division as `sort_and_unique`).

The result is bit for bit the tree of models.scene.build_scene, at any
number of shards: voxelization is per triangle, every offset is an exact
integer count, and the merge's sums of integers commute exactly. (The
JAX package's sharded build drifts from its single build by a band of
float ties, because XLA fuses the coverage predicate differently in the
two programs; the port evaluates the same ops in both.)

Host readbacks: each shard's chunk counts, each shard's unique count and
end offset, the merged unique count, the tree's level counts.
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

MAX_ATTEMPTS = 4  # buffer doublings before the build gives up


def _shard_unique(vox_chunk, chunks, buf: int, device):
    """Emit one shard's chunks into one buffer of `buf` entries at a
    running offset carried from the emit pass's own valid counts (the
    count pass only sizes the buffer), then reduce them to per-voxel sums.
    Returns ((code, sums6, count), n_unique, off_end), or None when the
    buffer is too small."""
    bufs = scene_mod._dump_buffers(buf, device)
    off = 0
    for k in chunks:
        cands = vox_chunk(k)
        n_valid = int(vox_ops.count_voxels(cands))
        if off + n_valid > buf:
            return None
        scene_mod._chunk_emit(bufs, cands, off)
        off += n_valid
    valid = torch.zeros(buf, dtype=torch.bool, device=device)
    valid[:off] = True
    out, n_u = vox_ops.sort_and_unique_sums(*bufs, valid)
    return out, n_u, off


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
    tri, col, emi = meshprep.split_to_cap(
        tri_verts, tri_colors, tri_emissions, origin, dps, grid_res, cap
    )
    t_split = time.time()
    n_tri = len(tri)
    chunk = min(chunk_tris, bucket(n_tri, floor=1024))
    # every shard owns the same number of chunks L = n_chunks / dp
    tri, col, emi = meshprep.pad_triangles(tri, col, emi, chunk * dp)
    n_chunks = len(tri) // chunk
    L = n_chunks // dp
    consts = {}

    def vox_chunk(k, valid_only=False):
        dev = devs[k // L]
        if dev not in consts:
            consts[dev] = (
                torch.as_tensor(np.asarray(origin, np.float32), device=dev),
                torch.tensor(dps, dtype=torch.float32, device=dev))
        sl = slice(k * chunk, (k + 1) * chunk)
        return vox_ops.voxelize_dense(
            *(torch.from_numpy(np.ascontiguousarray(a[sl])).to(dev)
              for a in (tri, col, emi)),
            *consts[dev], grid_res=grid_res, six_separating=six_separating,
            cap=cap, valid_only=valid_only,
        )

    # pass 1 (voxCount): every shard's chunk counts; one readback a shard
    counts = np.concatenate([
        torch.stack([vox_ops.count_voxels(vox_chunk(k, valid_only=True))
                     for k in range(d * L, (d + 1) * L)]).cpu().numpy()
        for d in range(dp)])
    t_count = time.time()
    if int(counts.sum()) == 0:
        raise ValueError("voxelization produced no voxels")

    # pass 2 (emit + group unique), shard by shard; buffers sized by the
    # worst shard (one pow2 bucket for all), doubled and rerun if a shard
    # ever overflows it (exact integer offsets: it should never trip)
    dev_tot = counts.reshape(dp, L).sum(axis=1)
    buf = bucket(int(dev_tot.max()))
    for _attempt in range(MAX_ATTEMPTS):
        streams = []
        for d in range(dp):
            got = _shard_unique(vox_chunk, range(d * L, (d + 1) * L), buf,
                                devs[d])
            if got is None:
                break
            streams.append(got)
        if len(streams) == dp:
            break
        buf *= 2
    else:
        raise RuntimeError("sharded build buffer sizing diverged")
    total_dumped = sum(s[2] for s in streams)

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
    stats["t_count_s"] = t_count - t_split
    stats["t_unique_s"] = t_unique - t_count
    stats["t_accel_s"] = t_accel - t_unique
    stats["t_total_s"] = t_accel - t_0
    tree.build_stats = stats
    return tree
