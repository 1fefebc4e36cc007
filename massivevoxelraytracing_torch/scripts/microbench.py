"""Morton-encode microbenchmark, after the JAX package's
scripts/microbench.py (the reference prints seconds per 100M encodes for
its codecs, unittest.cpp:133-182):

    python -m massivevoxelraytracing_torch.scripts.microbench
    python -m massivevoxelraytracing_torch.scripts.microbench --device cpu --n 4096

Four codecs on the same n random 21-bit coordinates (default_rng(0), as
the reference script draws them), first held bit for bit against each
other, then each timed on the host clock over `reps` calls after a warm
call, every timed region ending in a synchronize on the card:
  * ops/morton.encode, magic bits in int64 tensor ops, on --device;
  * ops/morton.encode_naive, the bit loop, on --device;
  * ops/morton.host_encode, the host library's C++ (csrc/host_morton.cpp);
  * ops/morton.np_encode, magic bits in tensor ops on the host.
Each is printed in seconds per 100M encodes; the host codecs' times are
the host's on any device. The reference's XLA-compiled device codecs have
no kernel of their own in the port: on the card they are the eager torch
ops above. Without a card and without --device cpu the script raises.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..ops import morton
from . import common

N = 1 << 22
PER = 1e8  # encodes the times are normalized to


def draw(n: int) -> tuple:
    """(x, y, z) uint32 numpy coordinates below 2^21."""
    rng = np.random.default_rng(0)
    return tuple(rng.integers(0, 1 << morton.MAX_COORD_BITS, n, dtype=np.uint32)
                 for _ in range(3))


def _s_per_call(fn, reps: int, sync) -> float:
    fn()  # warm
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sync()
    return (time.perf_counter() - t0) / reps


def run(n: int = N, device="cuda", card: str = "") -> list:
    """The four codecs on n coordinates. Returns one record each: name,
    where it ran, seconds a call and per 100M encodes."""
    dev = torch.device(device)
    xyz = draw(n)
    xyz_t = tuple(torch.from_numpy(a.astype(np.int64)).to(dev) for a in xyz)
    cases = (
        ("torch magic bits (encode)", str(dev), lambda: morton.encode(*xyz_t), 5),
        ("torch naive (encode_naive)", str(dev), lambda: morton.encode_naive(*xyz_t), 5),
        ("host C++ magic bits (host_encode)", "host", lambda: morton.host_encode(*xyz), 5),
        ("host np_encode", "host", lambda: morton.np_encode(*xyz), 1),
    )
    want = morton.host_encode(*xyz)
    for name, _where, fn, _reps in cases:
        got = fn()
        got = got.cpu().numpy() if isinstance(got, torch.Tensor) else got
        if not np.array_equal(got, want):
            raise AssertionError(f"{name}: {int((got != want).sum())} codes differ from "
                                 "the host C++ codec's")
    back = morton.host_decode(want)
    if not all(np.array_equal(b, a) for b, a in zip(back, xyz)):
        raise AssertionError("host_decode does not invert host_encode")

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    records = []
    for name, where, fn, reps in cases:
        s = _s_per_call(fn, reps, sync)
        rec = dict(name=name, where=where, n=n, reps=reps, s_per_call=s,
                   s_per_100m=s / n * PER)
        records.append(rec)
        print(f"[microbench] {name:36s} on {where:6s}: {rec['s_per_100m']:9.4f} s / 100M "
              f"encodes ({n} codes, == the others) [{card}]", flush=True)
    return records


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    common.add_device_arg(ap)
    ap.add_argument("--n", type=int, default=N, help="coordinates encoded a call")
    args = ap.parse_args(argv)
    dev = common.resolve_device(args.device)
    card = common.card(dev)
    print(card, flush=True)
    return run(args.n, dev, card=card)


if __name__ == "__main__":
    main()
