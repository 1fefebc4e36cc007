"""voxpt's default ray packet: the PathTracer's 2^21 lanes a call
(models/pathtracer.RAY_PACKET), not EngineConfig.ray_packet's 65,536.

A step's lanes are independent and every pixel's samples are summed
inside one call, so the accumulator must not depend on how many calls a
step takes. Held here on the CPU, at a frame of 2,048 pixels: a packet of
4,096 lanes (1,024 pixels a call, two calls a step) against voxpt's
default (one call), two steps each, bit for bit. The card holds the same
for a 640x360 step at 65,536 and 2^21 (chip_smoke.py phase 6).
"""

import numpy as np
import torch

from massivevoxelraytracing_torch.apps import voxpt
from massivevoxelraytracing_torch.models import pathtracer

# The tensors here are small: one intra-op thread keeps the test runner's
# parallel workers from oversubscribing the cores.
torch.set_num_threads(1)


def run(tmp_path, label, extra):
    return voxpt.main(["--scene", "torus", "--res", "16", "--width", "64", "--height", "32",
                       "--steps", "2", "--snapshot-every", "0", "--device", "cpu",
                       "--out", str(tmp_path / label)] + extra)


def test_voxpt_accumulator_is_the_same_at_any_packet(tmp_path, monkeypatch):
    calls = []
    real = pathtracer.pt_sample

    def counting(*a, **k):
        calls.append(k["pix_packet"])
        return real(*a, **k)

    monkeypatch.setattr(pathtracer, "pt_sample", counting)
    small = run(tmp_path, "small", ["--ray-packet", "4096"])
    n_small = len(calls)
    default = run(tmp_path, "default", [])
    assert default.packet == pathtracer.RAY_PACKET
    assert (n_small, len(calls) - n_small) == (4, 2)  # two calls a step, then one
    assert small.spp_done == default.spp_done == 32
    np.testing.assert_array_equal(small.accum.numpy().view(np.int32),
                                  default.accum.numpy().view(np.int32))
    assert float(default.accum[:, :3].mean()) > 0
