"""Voxelize a mesh and export the voxels as a PLY (the port of the JAX
package's apps/voxmesh.py; the voxMesh app, voxMesh.cpp:221-410), with
hidden-face culling through a sorted-Morton neighbour lookup
(voxMesh.cpp:143-148).

Usage:
  python -m massivevoxelraytracing_torch.apps.voxmesh --scene sphere \
      --res 64 --out out/voxels.ply
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..ops import morton
from ..ops import voxelize as vox_ops
from ..utils import meshgen, meshprep, objio
from .scenes import load_scene


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", default="sphere")
    ap.add_argument("--res", type=int, default=64)
    ap.add_argument("--six-separating", type=int, default=1)
    ap.add_argument("--no-cull", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the voxelization (default cuda; "
                    "cpu runs the plain tensor versions)")
    ap.add_argument("--out", default="out/voxels.ply")
    args = ap.parse_args(argv)
    device = torch.device(args.device)

    tri, col, emi = load_scene(args.scene)
    origin, dps = meshgen.fit_grid(tri, args.res)

    cap = 4
    tri, col, emi = meshprep.split_to_cap(
        tri, col, emi, origin, dps, args.res, cap
    )
    tri, col, emi = meshprep.pad_triangles(tri, col, emi, 1024)
    cands = vox_ops.voxelize_dense(
        *(torch.from_numpy(np.ascontiguousarray(a)).to(device)
          for a in (tri, col, emi)),
        torch.as_tensor(np.asarray(origin, np.float32), device=device),
        torch.tensor(dps, dtype=torch.float32, device=device),
        grid_res=args.res, six_separating=bool(args.six_separating), cap=cap,
    )
    uniq = vox_ops.sort_and_unique(cands)
    n = int(uniq["n_unique"])
    m64 = uniq["code"].cpu().numpy()
    x, y, z = morton.np_decode(m64)
    xyz = np.stack([x, y, z], -1)
    colors = uniq["color"].cpu().numpy().view(np.uint32)
    rgb = (
        np.stack([colors & 0xFF, (colors >> 8) & 0xFF, (colors >> 16) & 0xFF], -1)
        / 255.0
    )

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    objio.save_voxels_ply(
        args.out, xyz, float(dps), origin, colors=rgb,
        cull_hidden=not args.no_cull, mortons_sorted=m64,
    )
    print(f"[voxmesh] res({args.res}) voxels({n}) -> {args.out}")
    return dict(n_voxels=n, path=args.out)


if __name__ == "__main__":
    main()
