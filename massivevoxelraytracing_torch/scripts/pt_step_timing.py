"""PT 16-spp step timing, after the JAX package's scripts/pt_step_timing.py
(its single-combo mode):

    python -m massivevoxelraytracing_torch.scripts.pt_step_timing
    python -m massivevoxelraytracing_torch.scripts.pt_step_timing --scene lattice --res 1024
    python -m massivevoxelraytracing_torch.scripts.pt_step_timing --device cpu --res 32 --width 32 --height 16 --iters 1

The scene is the bumpy sphere (meshgen.bumpy_sphere(5, radius 0.9), fit
to --res) built with --accel (hako, brick or octree), or with --scene
lattice the bench lattice's HakoTree (utils/treecache.lattice_tree). The
reference scripts' camera (fovy 40) and procedural sky (so NEE shadow
rays are real work), one warm step from a cleared frame buffer, then
--iters timed steps on the host clock, synced; it prints s/step, the
accumulator's mean to 9 digits and hako_mega's launches a step. The
brick tree and the octree walk in eager tensor code: a step takes tens of
seconds on the card. The reference's knobs (CAPD, PACKD, UNIQ, TWOB, P,
D, VACP, VACR) and its multi-combo mode choose TPU forms that change no
result and are not ported. Without a card and without --device cpu the
script raises.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..models import pathtracer
from ..models import scene as scene_lib
from ..ops import hako_mega
from ..utils import meshgen, treecache
from . import common


def scene_box(scene_kind: str, res: int) -> tuple:
    """(origin, dps) of the script's scene at res^3."""
    if scene_kind == "lattice":
        return np.zeros(3, np.float32), 1.0 / res
    if scene_kind != "bumpy":
        raise ValueError(f"scene must be 'bumpy' or 'lattice', not {scene_kind!r}")
    return meshgen.fit_grid(meshgen.bumpy_sphere(5, radius=0.9), res)


def build(scene_kind: str, res: int, accel: str, device):
    """The script's tree."""
    if scene_kind == "lattice":
        if accel != "hako":
            raise ValueError("the cached lattice is a HakoTree: --accel hako")
        return treecache.lattice_tree(res, device=device)
    origin, dps = scene_box(scene_kind, res)
    return scene_lib.build_scene(meshgen.bumpy_sphere(5, radius=0.9), origin=origin,
                                 dps=dps, grid_res=res, accel=accel, device=device)


def measure(pt, cam, iters: int) -> dict:
    """One warm step from a cleared buffer, then `iters` timed steps."""
    dev = pt.tree.device

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    pt.clear_frame_buffer()
    t0 = time.perf_counter()
    pt.step(cam)
    sync()
    first = time.perf_counter() - t0
    launches0 = hako_mega.LAUNCHES
    t0 = time.perf_counter()
    for _ in range(iters):
        pt.step(cam)
    sync()
    dt = (time.perf_counter() - t0) / iters
    return dict(s_per_step=dt, first_s=first,
                launches_a_step=(hako_mega.LAUNCHES - launches0) / iters,
                mean=float(pt.accum[:, :3].mean()))


def run(accel: str = "hako", res: int = 256, scene: str = "bumpy",
        width: int = 640, height: int = 360, iters: int = 3, tree=None,
        device="cuda", card: str = "") -> dict:
    """The step's numbers on the scene (or on `tree`, the scene's tree
    built before). Returns them with the accumulator."""
    dev = torch.device(device)
    if tree is None:
        tree = build(scene, res, accel, dev)
    origin, dps = scene_box(scene, res)
    cam = common.script_camera(origin, float(dps) * res)
    pt = pathtracer.PathTracer(width=width, height=height, device=dev)
    pt.setup()
    pt.load_hdri(common.sky_img())
    pt.update_scene(tree)
    rec = measure(pt, cam, iters)
    scene_tok = f" scene={scene}" if scene != "bumpy" else ""
    what = (f"{rec['s_per_step']:.3f} s/step (first {rec['first_s']:.1f} s)"
            if dev.type == "cuda" else "plain versions")
    print(f"[pt] accel={accel} res={res}{scene_tok} {width}x{height} "
          f"{pt.n_batch_spp}spp: {what} mean={rec['mean']:.9e}, "
          f"{rec['launches_a_step']:g} hako_mega launches a step [{card}]", flush=True)
    rec.update(accel=accel, res=res, scene=scene, width=width, height=height,
               iters=iters, accum=pt.accum)
    return rec


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    common.add_device_arg(ap)
    ap.add_argument("--accel", default="hako", choices=("hako", "brick", "octree"))
    ap.add_argument("--res", type=int, default=256, help="grid resolution")
    ap.add_argument("--scene", default="bumpy", choices=("bumpy", "lattice"))
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=360)
    ap.add_argument("--iters", type=int, default=3, help="timed steps")
    args = ap.parse_args(argv)
    dev = common.resolve_device(args.device)
    card = common.card(dev)
    print(card, flush=True)
    return run(args.accel, args.res, args.scene, args.width, args.height, args.iters,
               device=dev, card=card)


if __name__ == "__main__":
    main()
