"""Single-triangle voxelization demo (the port of the JAX package's
apps/voxtriangle.py) -- the visual unit test of the rasterizer math
(voxTriangle.cpp:9-110). Writes an orthographic top-down map of the cells
the conservative and the 6-separating tests cover for one triangle, as a
PNG, and holds each voxel set against the host oracle
(models/cpu_oracle.py).

Usage:
  python -m massivevoxelraytracing_torch.apps.voxtriangle --res 32 --out out/tri
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..models import cpu_oracle
from ..ops import morton
from ..ops import voxelize as vox_ops
from ..utils import png


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--res", type=int, default=32)
    ap.add_argument("--v0", nargs=3, type=float, default=[-0.62, -0.3, -0.11])
    ap.add_argument("--v1", nargs=3, type=float, default=[0.58, -0.22, 0.3])
    ap.add_argument("--v2", nargs=3, type=float, default=[0.0, 0.61, -0.2])
    ap.add_argument("--device", default="cuda",
                    help="torch device of the voxelization (default cuda; "
                    "cpu runs the plain tensor versions)")
    ap.add_argument("--out", default="out/tri")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    os.makedirs(args.out, exist_ok=True)

    origin = np.array([-1.0, -1.0, -1.0], np.float32)
    dps = np.float32(2.0 / args.res)
    tri = np.array([[args.v0, args.v1, args.v2]], np.float32)

    def on_device(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    grids = {}
    counts = {}
    for six in (False, True):
        cands = vox_ops.dump_candidates(
            on_device(tri), on_device(np.ones_like(tri)),
            on_device(np.zeros_like(tri)), on_device(origin),
            torch.tensor(dps, dtype=torch.float32, device=device),
            grid_res=args.res, six_separating=six, cap=args.res,
        )
        out = vox_ops.sort_and_unique(cands)
        n = int(out["n_unique"])
        x, y, z = morton.np_decode(out["code"].cpu().numpy())
        g = np.zeros((args.res,) * 3, bool)
        g[x, y, z] = True
        mode = "six" if six else "conservative"
        grids[mode] = g
        counts[mode] = n

        # the oracle cross-check: the visual app doubles as a unit test
        ctx = cpu_oracle.TriContext(
            tri[0, 0], tri[0, 1], tri[0, 2], six, origin, dps, args.res
        )
        ora = ctx.test_grid()
        assert len(ora) == n, (len(ora), n)
        label = "6-separating" if six else "conservative"
        print(f"[voxtriangle] {label}: {n} voxels (oracle agrees)")

    # composite: conservative = red channel, six-separating = green,
    # projected along z with brightness by depth coverage
    comp = np.zeros((args.res, args.res, 3), np.float32)
    comp[..., 0] = grids["conservative"].sum(2) / max(
        grids["conservative"].sum(2).max(), 1
    )
    comp[..., 1] = grids["six"].sum(2) / max(grids["six"].sum(2).max(), 1)
    img = (comp.transpose(1, 0, 2)[::-1] * 255 + 0.5).astype(np.uint8)
    scale = max(256 // args.res, 1)
    img = np.kron(img, np.ones((scale, scale, 1), np.uint8))
    path = os.path.join(args.out, "coverage.png")
    png.write(path, img)
    print(f"[voxtriangle] -> {path} "
          "(red: conservative, green: 6-separating, yellow: both)")
    return dict(counts=counts, path=path)


if __name__ == "__main__":
    main()
