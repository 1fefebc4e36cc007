"""Per-phase timers and the profiler wrapper of the apps (the port's
counterpart of the JAX package's utils/runtime.py).

The JAX module's `setup()` (the persistent XLA compilation cache and the
backend selection) has no counterpart: the port compiles no graphs, its
kernels are built once per source hash (utils/cuda_build.py,
utils/host_build.py), and the device is the apps' `--device` flag.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


def synchronize(on) -> None:
    """Wait for the device work queued on `on`'s device (a tensor, a tree
    or anything with a `.device`, or a device); no-op on the CPU."""
    dev = on if isinstance(on, torch.device) else getattr(on, "device", None)
    if dev is not None and torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


@contextlib.contextmanager
def profile(trace_dir: str | None):
    """torch.profiler over the block (CPU ops, and CUDA kernels when a card
    is present); writes a Chrome trace `trace.json` into trace_dir. No-op
    when trace_dir is empty."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    os.makedirs(trace_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with torch_profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))


class Stopwatch:
    """Per-phase wall timers (the reference's stats line: '[frame N] res()
    total() / update / render'). `lap` synchronizes the device of its
    argument first, so queued device work is counted in its phase."""

    def __init__(self):
        self.t0 = time.time()
        self.marks: dict[str, float] = {}

    def lap(self, name: str, block_on=None) -> float:
        if block_on is not None:
            synchronize(block_on)
        now = time.time()
        dt = now - self.t0
        self.marks[name] = self.marks.get(name, 0.0) + dt
        self.t0 = now
        return dt
