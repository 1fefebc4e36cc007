"""Frame-range fan-out (the port of the JAX package's
apps/launch_frames.py, the usecase2_submission/run.py equivalent).

The reference splits a shot across two machines by launching
`RTCamp --frame-range A B` over SSH (run.py:14-27, no communication).
Frames are independent, so this launcher partitions [0, frames) and
launches one process of the port's rtcamp per worker. Workers are local
subprocesses by default; pass --ssh host1 host2 ... to fan out over SSH
like the reference (requires passwordless ssh and this repository at the
same path remotely).

Usage:
  python -m massivevoxelraytracing_torch.apps.launch_frames --frames 24 \
      --workers 2 -- --scene torus --width 480 --height 300 --steps 1
"""

from __future__ import annotations

import argparse
import os
import shlex
import subprocess
import sys


def partition(n_frames: int, n_workers: int):
    """Contiguous frame ranges, same arithmetic as run.py's split."""
    base = n_frames // n_workers
    rem = n_frames % n_workers
    ranges = []
    start = 0
    for w in range(n_workers):
        cnt = base + (1 if w < rem else 0)
        ranges.append((start, start + cnt))
        start += cnt
    return ranges


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, required=True)
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--ssh", nargs="*", default=None,
                    help="remote hosts (one worker per host)")
    ap.add_argument("rest", nargs=argparse.REMAINDER,
                    help="arguments passed through to rtcamp (after --)")
    args = ap.parse_args(argv)
    rest = [a for a in args.rest if a != "--"]

    hosts = args.ssh
    n_workers = len(hosts) if hosts else args.workers
    ranges = partition(args.frames, n_workers)

    procs = []
    for w, (a, b) in enumerate(ranges):
        if a == b:
            continue
        cmd = [
            sys.executable, "-m", "massivevoxelraytracing_torch.apps.rtcamp",
            "--frame-range", str(a), str(b), "--frames", str(args.frames),
        ] + rest
        if hosts:
            remote = f"cd {shlex.quote(os.getcwd())} && " + " ".join(
                shlex.quote(c) for c in cmd
            )
            cmd = ["ssh", hosts[w], remote]
        print(f"[launch] worker {w}: frames [{a}, {b}) -> {' '.join(cmd[:6])}...")
        procs.append(subprocess.Popen(cmd))

    rc = 0
    for p in procs:
        rc |= p.wait()
    sys.exit(rc)


if __name__ == "__main__":
    main()
