"""Entry points of the port (the counterparts of the repository's
`__graft_entry__.py`).

entry(device)               -> (fn, example_args): one primary-ray
                               traversal of 4,096 rays through a 64^3
                               HakoTree (the megakernel on the card).
dryrun_multichip(n, device) -> the multi-device layer end to end on an
                               n-entry mesh: a sharded build, held bit
                               for bit against build_scene, then one
                               sharded path-trace step over the octree
                               and one over the HakoTree.

Both run on the card unless the caller passes device="cpu"; without a
card they raise. Run: python -m massivevoxelraytracing_torch.entry [n]
[--device cpu].
"""

from __future__ import annotations

import argparse
import dataclasses
from functools import partial

import numpy as np
import torch

F32 = torch.float32


def _icosphere_scene():
    from .utils import meshgen

    tri = meshgen.icosphere(2, radius=0.9)
    col = meshgen.vertex_colors_from_position(tri, *meshgen.mesh_bounds(tri))
    return tri, col


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the card is not available (pass device='cpu')")
    return dev


def entry(device="cuda"):
    """(partial(intersect_with, kind, depth), (meta, root, lower, upper,
    ro, rd)): 4,096 rays from one eye to seeded targets in a 64^3
    icosphere HakoTree."""
    from .models import accel as accel_lib
    from .models import scene
    from .utils import meshgen

    dev = _device(device)
    grid_res = 64
    tri, col = _icosphere_scene()
    origin, dps = meshgen.fit_grid(tri, grid_res)
    tree = scene.build_scene(tri, col, origin=origin, dps=dps,
                             grid_res=grid_res, accel="hako", device=dev)
    extent = float(dps) * grid_res
    center = np.asarray(origin) + extent / 2

    n_rays = 4096
    rng = np.random.default_rng(0)
    ro = (center + np.array([0.8, 0.5, 1.5]) * extent).astype(np.float32)
    ro = np.tile(ro, (n_rays, 1))
    target = np.asarray(origin) + extent * rng.uniform(0.2, 0.8, (n_rays, 3))
    rd = (target - ro).astype(np.float32)

    kind, depth, meta, root = accel_lib.accel_args(tree)
    fn = partial(accel_lib.intersect_with, kind, depth)
    example_args = (meta, root, tree.lower, tree.upper,
                    torch.from_numpy(ro).to(dev), torch.from_numpy(rd).to(dev))
    return fn, example_args


def trees_equal(a, b) -> bool:
    """Every field of two trees of one structure (not build_stats), bit
    for bit."""
    if type(a) is not type(b):
        return False
    for f in dataclasses.fields(a):
        if f.name == "build_stats":
            continue
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if isinstance(va, tuple):
            if len(va) != len(vb) or not all(
                    torch.equal(x, y) for x, y in zip(va, vb)):
                return False
        elif isinstance(va, torch.Tensor) or isinstance(vb, torch.Tensor):
            if va is None or vb is None or not torch.equal(va, vb):
                return False
        elif va != vb:
            return False
    return True


def _sharded_step(m, tree, cam, env, pmj, width: int, height: int):
    """One sharded PT step (1 spp an entry) from a zero accumulator."""
    from .models import accel as accel_lib
    from .parallel import render as prender

    dev = tree.device
    kind, depth, meta, root = accel_lib.accel_args(tree)
    n = width * height
    step = prender.make_sharded_pt_step(
        m, stack_depth=depth, spp_per_device=1, width=width, height=height,
        n_pixels=n, has_emission=tree.has_emission, hdri_enabled=True,
        accel_kind=kind)

    def vec(v):
        return torch.as_tensor(np.asarray(v, np.float32), device=dev)

    def scalar(v):
        return torch.tensor(np.float32(v), device=dev)

    zero = torch.zeros(1, dtype=torch.int32, device=dev)
    return step(
        meta, root, tree.lower, tree.upper,
        tree.color if tree.color is not None else zero,
        tree.emission if tree.emission is not None else zero,
        pmj, env, vec(cam.o), vec(cam.right), vec(cam.up), vec(cam.front),
        scalar(cam.tan_half_fovy), scalar(cam.lens_r), scalar(cam.focus),
        torch.zeros((n, 4), dtype=F32, device=dev), 0)


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """The multi-device layer on an n-entry mesh of `device`: prints the
    mesh and three `[dryrun] ok:` lines (sharded build == build_scene,
    sharded PT step over the octree, and over the HakoTree); raises on a
    failed check."""
    from .models import scene
    from .ops import camera as camera_ops
    from .ops import hdri as hdri_ops
    from .ops import sampling
    from .parallel import build as pbuild
    from .parallel import mesh as mesh_lib
    from .utils import hdr, meshgen

    dev = _device(device)
    m = mesh_lib.make_mesh(n_devices, device=dev)
    print(f"[dryrun] mesh: {m.shape}", flush=True)

    grid_res = 32
    tri, col = _icosphere_scene()
    origin, dps = meshgen.fit_grid(tri, grid_res)
    kw = dict(origin=origin, dps=dps, grid_res=grid_res)
    tree = scene.build_scene(tri, col, device=dev, accel="octree", **kw)
    tree_sh = pbuild.build_scene_sharded(tri, col, n_devices=n_devices,
                                         device=dev, chunk_tris=128, **kw)
    if not trees_equal(tree, tree_sh):
        raise AssertionError("the sharded build differs from build_scene")
    n1, n2 = tree.build_stats["n_unique"], tree_sh.build_stats["n_unique"]
    print(f"[dryrun] ok: sharded build over {n_devices} devices, {n2} voxels "
          f"(single-device {n1}, every field equal), {tree_sh.n_nodes} nodes",
          flush=True)

    extent = float(dps) * grid_res
    center = np.asarray(origin) + extent / 2
    cam = camera_ops.Camera.look_at(
        eye=center + np.array([0.8, 0.5, 1.5]) * extent, target=center)
    dp, sp = m.devices.shape
    width, height = 32, 8 * dp  # rows divide over dp
    env = hdri_ops.load(hdr.procedural_sky(64, 32), scale=1.75, device=dev)
    pmj = torch.from_numpy(sampling.make_pmj_table()).to(dev)

    out = _sharded_step(m, tree, cam, env, pmj, width, height)
    arr = out.cpu().numpy()
    if arr.shape != (width * height, 4) or not np.all(arr[:, 3] == sp):
        raise AssertionError(f"spp accumulation mismatch: {arr.shape}")
    if not np.isfinite(arr).all() or arr[:, :3].mean() <= 0.01:
        raise AssertionError("octree sharded step: non-finite or black frame")
    print(f"[dryrun] ok: full PT step, {width * height} rays over dp={dp}, "
          f"sp={sp}; mean radiance {arr[:, :3].mean():.4f}, spp {arr[0, 3]:.0f}",
          flush=True)

    tree_h = scene.build_scene(tri, col, device=dev, accel="hako", **kw)
    arr_h = _sharded_step(m, tree_h, cam, env, pmj, width, height).cpu().numpy()
    if not np.isfinite(arr_h).all() or arr_h[:, :3].mean() <= 0.01:
        raise AssertionError("hako sharded step: non-finite or black frame")
    print(f"[dryrun] ok: sharded hako PT step, mean radiance "
          f"{arr_h[:, :3].mean():.4f}", flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="dryrun_multichip on n entries")
    ap.add_argument("n", type=int, nargs="?", default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dryrun_multichip(args.n, args.device)


if __name__ == "__main__":
    main()
