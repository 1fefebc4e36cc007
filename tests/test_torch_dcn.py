"""The port's multi-process frame renderer (apps/dcn_frames.py) on the
CPU: two OS processes join a gloo process group, render disjoint frame
ranges of `bumpy` at 32^3 / 96x64 (brick trees), and all-reduce their
statistics. The job's depth checksum must equal one process rendering the
same 4 frames (exactly: each frame's checksum rides its own slot of the
all_reduce), every frame is written once, and a failing worker fails the
job. Subprocesses run on one OpenMP thread, under a time limit."""

import argparse
import os
import subprocess
import sys

import torch

from massivevoxelraytracing_torch.apps import dcn_frames

# The tensors here are small: one intra-op thread keeps the test runner's
# parallel workers from oversubscribing the cores.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = ["--procs", "2", "--frames", "4", "--res", "32", "--width", "96",
        "--height", "64", "--device", "cpu"]
ENV = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT)


def run(extra):
    return subprocess.run(
        [sys.executable, "-m", "massivevoxelraytracing_torch.apps.dcn_frames",
         *ARGS, *extra], cwd=ROOT, env=ENV, capture_output=True, text=True,
        timeout=180)


def test_two_processes_equal_one(tmp_path):
    out = run(["--out", str(tmp_path / "frames")])
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("[dcn]")]
    assert len(lines) == 1 and "2 processes" in lines[0] and "4 frames" in lines[0]
    got = dcn_frames.parse_line(lines[0])
    one = argparse.Namespace(scene="bumpy", frames=4, res=32, width=96,
                             height=64, out=None)
    sums = dcn_frames.render_frames(one, 0, 4, torch.device("cpu"))
    assert got == dict(frames=4, checksum=dcn_frames.checksum(sums))
    assert got["checksum"] > 0
    assert sorted(os.listdir(tmp_path / "frames")) == [f"{i:03d}.png" for i in range(4)]


def test_a_failing_worker_fails_the_job():
    out = run(["--scene", "no_such_scene"])
    assert out.returncode != 0
    assert "[dcn]" not in out.stdout
    assert "worker exit codes" in out.stderr
