"""What each vector construct costs on the card: K dependent repeats a
lane of each of the eight constructs of the JAX package's
scripts/construct_micro.py (fp min / max + add, compare + select + add,
int add / and / xor / constant shift, a per-lane variable shift, the
5-step barrel shift, int -> float, _bit_at, _pc64_below), each through
ops/probes.construct_probe (csrc/hako_probes.cu construct_probe<C>).

    python -m massivevoxelraytracing_torch.scripts.construct_micro
    python -m massivevoxelraytracing_torch.scripts.construct_micro --device cpu

Every case is held bit for bit against its plain version at each launch
shape (one warp an SM, full occupancy, the JAX script's 64 x 2048 lanes)
and at each repeat count that shape is timed at (k and 2k; the script's
shape k alone), then timed with CUDA events. A line a case and shape: the time, ns per
dependent repeat, G repeats/s over the card, the loop's SASS instructions
a repeat and its dependent chain (cuobjdump), and the issue, bytes and
latency floors (the latency of a dependent instruction from
hako_kernel_micro's calibration). --device cpu runs the plain versions
at 256 lanes and prints no time.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..ops import probes
from . import common
from .hako_kernel_micro import calibrate

K = 256  # in-kernel repeats (the JAX script's)


def inputs(kind: str, lanes: int, device, rng) -> list:
    """The construct's inputs: f32 in [0.5, 2), i32 in [0, 2^30), u32 bit
    patterns (as the JAX script draws them)."""
    out = []
    for c in probes.CONSTRUCTS[kind]:
        if c == "f":
            x = rng.uniform(0.5, 2.0, lanes).astype(np.float32)
        elif c == "i":
            x = rng.integers(0, 1 << 30, lanes).astype(np.int32)
        else:
            x = rng.integers(0, 1 << 32, lanes, dtype=np.uint64).astype(
                np.uint32).view(np.int32)
        out.append(torch.from_numpy(x).to(device))
    return out


def run(meter, k: int = K, seed: int = 0) -> list:
    rng = np.random.default_rng(seed)
    for kind in probes.CONSTRUCTS:
        for shape in common.shapes(meter.device, k):
            xs = inputs(kind, shape["lanes"], meter.device, rng)
            meter.case(
                f"construct {kind}", "construct_probe_kernel",
                (list(probes.CONSTRUCTS).index(kind),), shape,
                lambda kk, xs=xs, t=shape["threads"]: probes.construct_probe(
                    kind, xs, k=kk, threads=t),
                lambda kk, xs=xs: probes.construct_plain(kind, xs, kk),
                n_bytes=4 * shape["lanes"] * (len(xs) + 1), repeats=probes.UNROLL)
    return meter.records


def main(argv=None, meter=None) -> list:
    """The calibration and every case; with `meter`, that meter's device
    and calibration (calibrated once, whichever script runs first)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    common.add_device_arg(ap)
    args = ap.parse_args(argv)
    meter = meter or common.Meter(common.resolve_device(args.device))
    print(meter.card, flush=True)
    if not meter.calibrated:
        calibrate(meter)
    return run(meter)


if __name__ == "__main__":
    main()
