"""Whether torch.profiler's trace of a short session keeps its device
events as the process ages, and with which idle pad around the profiled
call (scripts/common.profile_call's pad_s; common.profile_counted tries
the pads of common.PROFILE_PADS_S in turn until a trace is whole):

    python -m massivevoxelraytracing_torch.scripts.profile_window [--ages 0 30 90]

At each age (seconds since the first checkpoint; the card is kept busy
with hako_mega calls in between, 50 ms of host sleep after every 20),
one hako_rounds call and one hako_mega call on a 640x360 frame of the
bumpy sphere at 256^3 (models/scene.build_scene) are profiled with each
pad of --pads, twice. Each line gives the hako_rounds and hako_mega
kernels the trace holds against the one launch of each, and the device
events it holds; then common.profile_counted's tries. Needs a card.
"""

from __future__ import annotations

import argparse
import time

import torch

from ..ops import hako_kernels as hk
from ..ops import hako_mega
from . import common
from .hako_phase_timing import bumpy_scene, frame_rays

GRID = 256
WIDTH, HEIGHT = 640, 360


PADS_S = (0.0, 0.02, 0.05, 0.2)


def run(ages, device="cuda", pads=PADS_S) -> list:
    """The checkpoints' records: (age s, pad s, hako_rounds kernels
    recorded, hako_mega kernels recorded, device events recorded)."""
    dev = common.resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("profile_window measures the card's trace: it needs a card")
    card = common.card(dev)
    tree, cam = bumpy_scene(GRID, dev)
    ro, rd = (torch.from_numpy(x).to(dev) for x in frame_rays(cam, WIDTH, HEIGHT))
    (bricks, snodes, tabs, root), T = hako_mega.hako_mega_args(tree)
    args = (bricks, snodes, tabs, root, tree.lower, tree.upper, ro, rd)

    def call():
        hk.hako_rounds(*args, T=T)
        hako_mega.intersect_rays_hako_mega(*args, T=T)

    def busy(seconds):
        t = time.time()
        while time.time() - t < seconds:
            for _ in range(20):
                hako_mega.intersect_rays_hako_mega(*args, T=T)
            torch.cuda.synchronize()
            time.sleep(0.05)

    call()
    torch.cuda.synchronize()
    out = []
    t0 = time.time()
    for age in ages:
        busy(age - (time.time() - t0))
        for pad in [*pads, *pads]:
            r = common.profile_call(call, pad_s=pad)
            mega = sum(calls for name, _ms, calls in r["top"] if "hako_mega" in name)
            rec = (time.time() - t0, pad, r["rounds"]["hako_rounds"][1], mega, r["kernels"])
            out.append(rec)
            print(f"[profile window] age {rec[0]:.1f} s, pad {pad * 1e3:.0f} ms: the trace "
                  f"holds hako_rounds {rec[2]} of 1, hako_mega {rec[3]} of 1, {rec[4]} device "
                  f"events [{card}]", flush=True)
        r = common.profile_counted(call, hk.LAUNCHES)
        print(f"[profile window] age {time.time() - t0:.1f} s, profile_counted: a trace "
              f"holding the hako_rounds launch after {r['tries']} tries (pad {r['pad_s']} s) "
              f"[{card}]", flush=True)
    return out


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    common.add_device_arg(ap)
    ap.add_argument("--ages", type=float, nargs="+", default=[0.0, 30.0, 90.0],
                    help="seconds since the first checkpoint at which to profile")
    ap.add_argument("--pads", type=float, nargs="+", default=list(PADS_S),
                    help="idle seconds before and after the profiled call")
    a = ap.parse_args(argv)
    return run(a.ages, a.device, tuple(a.pads))


if __name__ == "__main__":
    main()
