"""Dynamic 2D gathers within a tile on the card, after the JAX package's
scripts/dyngather_probe2.py (which asked which take_along_axis forms
Mosaic lowers along lanes and sublanes):

    python -m massivevoxelraytracing_torch.scripts.dyngather_probe2
    python -m massivevoxelraytracing_torch.scripts.dyngather_probe2 --device cpu

Its four bodies, on int32 tiles drawn as it draws them (argument i from
default_rng(i).integers(0, hi, shape); tables below 2^30):
  * k_taa1  (:41) out = take_along_axis(t, idx % 128, axis=1), t [16, 128];
  * k_taa1w (:52) the same on t [16, 256] with idx % 256, first 128 columns;
  * k_taa0  (:59) take_along_axis(t, idx % 16, axis=0), t [16, 128];
  * k_taa0t (:70) take_along_axis(t, idx % 128, axis=0), t [128, 128],
    idx [16, 128] (the output takes the index's shape).
Each runs through ops/probes.take_along_probe in every form that applies
(shared memory; warp shuffles, along rows only; L1), on one tile (the
reference's call: the launch's fixed cost sets its time) and on a batch of
TILES_AN_SM tiles for every SM (the batch's tiles are the same draws with
a leading batch axis, so tile 0 is the reference's). Every case is held
bit for bit against its plain version, then timed with CUDA events
(scripts/common.gather_case), every launch reading its inputs from HBM:
one tile as the median of 10 single launches queued behind a spin kernel,
each after the L2 is flushed; the batch as the least of 3 trains of 10
launches that take copies of the tiles in turn, 4 L2s of other copies
between two uses of one. Beside it torch.gather on the same tiles (the indices reduced first,
untimed), the copy shell (shell_copy_probe) on one f32 array whose read
and write move the case's bytes, and the bytes bound at 3.35 TB/s: the
32-byte sectors of the tile that this run's indices reach, the indices
read and the output, each once. --device cpu runs the plain versions on
one tile and prints no time; without a card and without that flag the
script raises.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..ops import probes
from . import common

S = 16
C_OUT = 128
TILES_AN_SM = 8
# name, the reference's body, axis, modulus, (t shape, bound), (idx shape, bound)
BODIES = (
    ("taa axis=1 [16,128]", "k_taa1", 1, 128, ((S, 128), 1 << 30), ((S, 128), 128)),
    ("taa axis=1 [16,256]", "k_taa1w", 1, 256, ((S, 256), 1 << 30), ((S, 256), 256)),
    ("taa axis=0 [16,128]", "k_taa0", 0, S, ((S, 128), 1 << 30), ((S, 128), S)),
    ("taa axis=0 [128,128] idx[16]", "k_taa0t", 0, 128, ((128, 128), 1 << 30),
     ((S, 128), 128)),
)


def draws(shapes, batch: int = 1) -> list:
    """The reference's arguments, int32 [batch, *shape]: argument i from
    default_rng(i).integers(0, hi, (batch, *shape))."""
    return [np.random.default_rng(i).integers(0, hi, (batch,) + tuple(sh)).astype(np.int32)
            for i, (sh, hi) in enumerate(shapes)]


def forms(axis: int) -> tuple:
    return probes.TAA_FORMS if axis == 1 else tuple(f for f in probes.TAA_FORMS
                                                     if f != "shfl")


def run(device, card: str = "") -> dict:
    """The four bodies in every form that applies, on one tile and (on the
    card) on a batch of TILES_AN_SM tiles an SM. Returns the case records."""
    cuda = device.type == "cuda"
    batches = (1,)
    if cuda:
        common.warm_up(device)
        batches = (1, TILES_AN_SM * torch.cuda.get_device_properties(device)
                   .multi_processor_count)
    cases = []
    for name, body, axis, mod, ts, xs in BODIES:
        for batch in batches:
            t, idx = (torch.from_numpy(a).to(device) for a in draws((ts, xs), batch))
            for form in forms(axis):
                rec = common.gather_case(name, t, idx, axis=axis, mod=mod, form=form,
                                         c_out=C_OUT, card=card)
                rec["body"] = body
                cases.append(rec)
            del t, idx
    return dict(batches=list(batches), cases=cases)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    common.add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = common.resolve_device(args.device)
    card = common.card(dev)
    print(card, flush=True)
    return run(dev, card=card)


if __name__ == "__main__":
    main()
