"""Multi-process frame-parallel rendering (the port of the JAX package's
apps/dcn_frames.py).

N OS processes join one torch.distributed group (gloo, over TCP on this
host); each renders its contiguous frame range (apps/launch_frames.py's
partition) on its own device, and the job's statistics ride a real
cross-process collective: an all_reduce of a small CPU tensor holding
each frame's depth checksum in its own slot and the frame counts. A slot
has one contributor, so the reduced checksums are exact, and the job's
checksum (their sum in frame order) equals one process rendering the
same frames. Each process renders on --device (default the card: rank r
on card r % device_count; `--device cpu` for the CPU); a worker that
fails fails the job.

Run (one host, 2 processes):
  python -m massivevoxelraytracing_torch.apps.dcn_frames --procs 2 --frames 4
"""

from __future__ import annotations

import argparse
import datetime
import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import torch

TIMEOUT_S = 900.0  # the job's limit, and each collective's
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def worker_device(device: str, rank: int) -> torch.device:
    """The device of a worker: `device` as given, or for a bare "cuda"
    card rank % device_count. Raises without a card."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda needs a card (pass --device cpu)")
        if dev.index is None:
            dev = torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def render_frames(args, begin: int, end: int, device) -> list:
    """Render frames [begin, end) of the animated scene, each built as a
    brick tree on `device`; write their PNGs when args.out is set. Returns
    each frame's depth checksum (the sum of its hit depths, in float64)."""
    from ..models import raycast, scene
    from ..ops import camera as camera_ops
    from ..utils import meshgen, png
    from .scenes import animated_scene

    sums = []
    for frame in range(begin, end):
        tri, col, emi = animated_scene(args.scene, frame, args.frames)
        origin, dps = meshgen.fit_grid(tri, args.res)
        tree = scene.build_scene(
            tri, col, emi, origin=origin, dps=dps, grid_res=args.res,
            accel="brick", device=device,
        )
        center = np.asarray(origin) + 0.5 * float(dps) * args.res
        cam = camera_ops.Camera.look_at(
            eye=center + np.array([0.8, 0.5, 1.5]) * float(dps) * args.res,
            target=center, fovy_deg=40.0,
        )
        img, depth = raycast.render_frame(tree, cam, args.width, args.height,
                                          device=device)
        sums.append(float(torch.where(depth < 1e37, depth, 0.0).double().sum()))
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            png.write(os.path.join(args.out, f"{frame:03d}.png"),
                      img.cpu().numpy())
    return sums


def checksum(per_frame) -> float:
    """The job's depth checksum: the frames' checksums summed in frame order."""
    return float(sum(float(x) for x in per_frame))  # left to right


def worker(args) -> dict:
    import torch.distributed as dist

    from .launch_frames import partition

    pid = args.process_id
    device = worker_device(args.device, pid)
    dist.init_process_group(
        "gloo", init_method=f"tcp://{args.coordinator}",
        world_size=args.procs, rank=pid,
        timeout=datetime.timedelta(seconds=TIMEOUT_S),
    )
    try:
        # connect every process now, while all are within seconds of each
        # other, not after the first (slow) build and render
        dist.barrier()
        begin, end = partition(args.frames, args.procs)[pid]
        sums = render_frames(args, begin, end, device)
        slots = torch.zeros(args.frames + 1, dtype=torch.float64)
        slots[begin:end] = torch.tensor(sums, dtype=torch.float64)
        slots[-1] = len(sums)
        dist.all_reduce(slots)  # one contributor a frame slot: exact
        result = dict(frames=int(slots[-1]), checksum=checksum(slots[:-1].tolist()))
    finally:
        dist.destroy_process_group()
    if pid == 0:
        print(f"[dcn] {args.procs} processes x 1 device ({device.type}): "
              f"{result['frames']} frames, depth-checksum "
              f"{result['checksum']:.4f} (exact {result['checksum'].hex()})",
              flush=True)
    return result


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def parse_line(line: str) -> dict:
    """frames and checksum of a `[dcn]` line."""
    frames = int(line.split(": ", 1)[1].split(" frames")[0])
    return dict(frames=frames,
                checksum=float.fromhex(line.rsplit("(exact ", 1)[1].rstrip(")")))


def main(argv=None) -> dict:
    """Spawn the workers (or, with --process-id, be one). Returns
    {frames, checksum} of the job; raises SystemExit if a worker fails."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--scene", default="bumpy")
    ap.add_argument("--res", type=int, default=64)
    ap.add_argument("--width", type=int, default=160)
    ap.add_argument("--height", type=int, default=100)
    ap.add_argument("--device", default="cuda",
                    help="each worker's device (default cuda; cpu runs the "
                    "plain tensor versions)")
    ap.add_argument("--coordinator", default=None,
                    help="host:port of the process group (default localhost "
                    "and a free port)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--process-id", type=int, default=None,
                    help="internal: set for spawned workers")
    args = ap.parse_args(argv)

    if args.process_id is not None:
        return worker(args)

    # build the host (and CUDA) libraries once, here, so the workers find
    # them built instead of each running the compilers
    from ..utils import host_build

    host_build.load()
    if torch.device(args.device).type == "cuda":
        worker_device(args.device, 0)
        from ..utils import cuda_build

        cuda_build.load()
    coordinator = args.coordinator or f"localhost:{free_port()}"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [_ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    procs = []
    try:
        for pid in range(args.procs):
            cmd = [sys.executable, "-m",
                   "massivevoxelraytracing_torch.apps.dcn_frames",
                   "--process-id", str(pid), "--coordinator", coordinator]
            for k in ("procs", "frames", "res", "width", "height"):
                cmd += [f"--{k}", str(getattr(args, k))]
            cmd += ["--scene", args.scene, "--device", args.device]
            if args.out:
                cmd += ["--out", args.out]
            procs.append(subprocess.Popen(
                cmd, env=env, text=True,
                stdout=subprocess.PIPE if pid == 0 else None))
        out0 = []
        reader = threading.Thread(target=lambda: out0.append(procs[0].stdout.read()),
                                  daemon=True)
        reader.start()
        deadline = time.time() + TIMEOUT_S
        while any(p.poll() is None for p in procs):
            rcs = [p.poll() for p in procs]
            if any(rc not in (None, 0) for rc in rcs):
                raise SystemExit(f"dcn_frames: worker exit codes {rcs}")
            if time.time() > deadline:
                raise SystemExit(f"dcn_frames: workers still running after "
                                 f"{TIMEOUT_S} s")
            time.sleep(0.05)
        rcs = [p.returncode for p in procs]
        if any(rcs):
            raise SystemExit(f"dcn_frames: worker exit codes {rcs}")
        reader.join()
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    lines = [ln for ln in out0[0].splitlines() if ln.startswith("[dcn]")]
    if len(lines) != 1:
        raise SystemExit(f"dcn_frames: rank 0 printed no [dcn] line:\n{out0[0]}")
    print(lines[0], flush=True)
    return parse_line(lines[0])


if __name__ == "__main__":
    main()
