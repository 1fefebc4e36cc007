"""The frame's ray generation (frame_raygen_kernel) and the bounce sample
(pt_bounce_sample_kernel, through the prefix-table (sats) and the alias
HDRI backends) against an earlier design of each, in turns on one card:

    python -m massivevoxelraytracing_torch.scripts.render_ab \
        [--old-frame csrc/earlier/frame_877ff8b.cu] \
        [--old-chain csrc/earlier/pt_chain_877ff8b.cu]

The earlier designs default to the sources of commit 877ff8b, kept
verbatim under `csrc/earlier/` (`git show 877ff8b:massivevoxelraytracing_
torch/csrc/frame.cu` gives the same file), so that a checkout without git
history times them too. Each is built with the library's nvcc flags into a
library of its own (utils/cuda_build.build_renamed: its C entry points
suffixed `_old`; the two builds run together) and called through the same
wrapper as the current kernel (models/raycast.gen_rays, ops/pt_chain.
bounce_sample, with cuda_build.load answering the earlier entry point), so
both pay the same host work a call.

Inputs: the 1920x1080 frame's one band (9 tile rows, 2,211,840 lanes) from
the bench camera, and the bounce-1 call of the first packet of a 16-spp
1080p PT step on the bench lattice (chip_smoke.py phase 4 hands in the
call it recorded; run alone, the script builds the lattice at 1024^3 and
records it), through the sats backend and through the alias backend. On
each, the current and the earlier kernel are held bit for bit against the
plain stage, then timed by CUDA events (common.timed, REPS calls a turn)
in the turns old, new, new, old, beside their bound (common.raygen_bound,
common.chain_bound), and the current kernel on the same call without an
HDRI (the rest of the sample, both backends' yardstick). Prints each
kernel's ptxas registers. Needs a card.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import ctypes
import dataclasses
import os

import numpy as np
import torch

from ..models import pathtracer, raycast, scene
from ..ops import pt_chain
from ..utils import cuda_build, meshgen
from . import common
from .walk_ab import ptxas_lines

REPS = 20
TURNS = ("old", "new", "new", "old")
FRAME = (1920, 1080)
GRID = 1024
EARLIER_DIR = os.path.join(cuda_build.CSRC, "earlier")
EARLIER = {"frame_raygen": os.path.join(EARLIER_DIR, "frame_877ff8b.cu"),
           "pt_bounce_sample": os.path.join(EARLIER_DIR, "pt_chain_877ff8b.cu")}
ENTRIES = {"frame_raygen": ("frame_raygen_launch", "frame_shade_launch"),
           "pt_bounce_sample": ("pt_lane_init_launch", "pt_primary_shade_launch",
                                "pt_bounce_sample_launch", "pt_bounce_shade_launch",
                                "pt_compact_gather_launch")}

_built = {}  # (kernel, source) -> (the earlier <kernel>_launch, its ptxas lines)


def build_earlier(srcs=None) -> dict:
    """{(kernel, source): (its earlier <kernel>_launch, ptxas lines)} for
    srcs, [(kernel, an earlier frame.cu / pt_chain.cu)] (EARLIER's by
    default; each file's stem names its library), built together once a
    process."""
    srcs = list(EARLIER.items()) if srcs is None else list(srcs)
    todo = [ks for ks in srcs if ks not in _built]
    out_dir = os.path.join(os.path.dirname(cuda_build.BUILD_DIR), "render_ab")
    current = cuda_build.load()

    def build(kernel, src):
        lib, _text, seconds, log = cuda_build.build_renamed(src, out_dir, ENTRIES[kernel])
        fn = getattr(lib, f"{kernel}_launch_old")
        fn.argtypes = getattr(current, f"{kernel}_launch").argtypes
        fn.restype = ctypes.c_int
        print(f"[render_ab] built the earlier {kernel} from "
              f"{os.path.relpath(src, cuda_build.CSRC)} in {seconds:.1f} s", flush=True)
        return fn, ptxas_lines(log, f"{kernel}_kernel")

    with concurrent.futures.ThreadPoolExecutor(max(len(todo), 1)) as pool:
        futures = {ks: pool.submit(build, *ks) for ks in todo}
        for ks, f in futures.items():
            _built[ks] = f.result()
    return {ks: _built[ks] for ks in srcs}


def parent(kernel: str):
    """The parent commit's <kernel>_launch (EARLIER), built on first use."""
    return build_earlier([(kernel, EARLIER[kernel])])[(kernel, EARLIER[kernel])][0]


@contextlib.contextmanager
def earlier_entry(kernel: str, fn):
    """The wrappers launch `fn` as <kernel>_launch while inside."""
    lib = cuda_build.load()
    real_load = cuda_build.load
    name = f"{kernel}_launch"

    class Swapped:
        def __getattr__(self, attr):
            return fn if attr == name else getattr(lib, attr)

    cuda_build.load = Swapped
    try:
        yield
    finally:
        cuda_build.load = real_load


@contextlib.contextmanager
def counts_kept():
    """raycast's and pt_chain's launch counts restored on leaving: the
    comparisons are not the main path's launches."""
    saved = dict(raycast.LAUNCHES), dict(pt_chain.LAUNCHES)
    try:
        yield
    finally:
        raycast.LAUNCHES.update(saved[0])
        pt_chain.LAUNCHES.update(saved[1])


def same_bits(got, want) -> bool:
    got, want = common.flat_tensors(got), common.flat_tensors(want)
    return len(got) == len(want) and all(
        g.dtype == w.dtype and g.shape == w.shape
        and torch.equal(g.view(torch.int32) if g.dtype == torch.float32 else g,
                        w.view(torch.int32) if w.dtype == torch.float32 else w)
        for g, w in zip(got, want))


def in_turns(kernel: str, call, old_fn, what: str, want) -> dict:
    """{"old": [ms, ms], "new": [ms, ms]}: call() through the earlier and
    the current kernel in TURNS, each == want first."""
    with counts_kept():
        def old():
            with earlier_entry(kernel, old_fn):
                return call()

        fns = {"old": old, "new": call}
        for k, fn in fns.items():
            if not same_bits(fn(), want):
                raise AssertionError(f"{what}: the {k} {kernel} differs from its plain stage")
        ms = {"old": [], "new": []}
        for turn in TURNS:
            ms[turn].append(common.timed(fns[turn], REPS)[1])
    return ms


def report(kernel: str, what: str, ms: dict, bound: tuple, old_name: str, card: str) -> dict:
    old, new = ms["old"], ms["new"]
    faster = ("current" if max(new) < min(old) else
              old_name if max(old) < min(new) else "neither")
    print(f"[render_ab] {kernel} on {what} (== plain stage, both designs): turns {old_name} "
          f"{old[0]:.4f}, current {new[0]:.4f}, current {new[1]:.4f}, {old_name} {old[1]:.4f} "
          f"ms; bound {bound[0]:.4f} ms ({bound[1]}); share {old_name} "
          f"{bound[0] / min(old):.1%}, current {bound[0] / min(new):.1%}; faster in every "
          f"turn: {faster} [{card}]", flush=True)
    return dict(old_ms=old, ms=new, bound_ms=bound[0], bound_by=bound[1],
                share=bound[0] / min(new), old_share=bound[0] / min(old), faster=faster)


def raygen_ab(old_fn, camv: tuple, width: int, height: int, device, card: str = "",
              old_name: str = "parent") -> dict:
    """frame_raygen on the frame's one band (py0 0, every tile row)."""
    rows = -(-height // raycast.TILE)
    cam_dev = (*(torch.from_numpy(v).to(device) for v in camv[:4]),
               torch.tensor(camv[4], dtype=torch.float32, device=device))
    want = raycast._gen_rays_band(*cam_dev, 0, width=width, height=height, band_tile_rows=rows)

    def call():
        return raycast.gen_rays(camv, 0, width=width, height=height, band_tile_rows=rows,
                                device=device)

    what = f"the {width}x{height} band ({want[0].shape[0]} lanes)"
    ms = in_turns("frame_raygen", call, old_fn, what, want)
    return report("frame_raygen", what, ms, common.raygen_bound(want[0].shape[0]), old_name,
                  card)


def bounce_ab(old_fn, args: tuple, kw: dict, backend: str, card: str = "",
              old_name: str = "parent") -> dict:
    """pt_bounce_sample on one recorded call (args, kw), its HDRI through
    `backend` ("sats" or "alias")."""
    args = (dataclasses.replace(args[0], use_alias=backend == "alias"), *args[1:])
    want = pt_chain.bounce_sample_plain(*args, **kw)

    def call():
        return pt_chain.bounce_sample(*args, **kw)

    lanes = common.flat_tensors(want)[0].shape[0]
    what = f"the bounce-1 call through {backend} ({lanes} lanes)"
    ms = in_turns("pt_bounce_sample", call, old_fn, what, want)
    return report(f"pt_bounce_sample ({backend})", what, ms,
                  common.chain_bound("bounce_sample", args, kw, want), old_name, card)


def first_packet_bounce_call(device) -> tuple:
    """(args, kwargs) of the bounce-1 bounce_sample call of the first packet
    of a 16-spp 1080p PT step on the bench lattice at 1024^3 with the
    bench sky."""
    tri, cols = meshgen.sphere_lattice(6, 4)
    tree = scene.build_scene(tri, cols, origin=np.zeros(3, np.float32), dps=1.0 / GRID,
                             grid_res=GRID, chunk_tris=262144, device=device)
    pt = pathtracer.PathTracer(width=FRAME[0], height=FRAME[1], device=device)
    pt.setup()
    pt.load_hdri(common.sky_img())
    pt.update_scene(tree)
    calls, packets, real = [], [0], {k: getattr(pt_chain, k) for k in ("lane_init",
                                                                       "bounce_sample")}

    def lane_init(*a, **k):
        packets[0] += 1
        return real["lane_init"](*a, **k)

    def bounce_sample(*a, **k):
        if packets[0] == 1:
            calls.append((a, k))
        return real["bounce_sample"](*a, **k)

    pt_chain.lane_init, pt_chain.bounce_sample = lane_init, bounce_sample
    try:
        pt.step(common.script_camera(np.zeros(3, np.float32), 1.0))
    finally:
        pt_chain.lane_init, pt_chain.bounce_sample = real["lane_init"], real["bounce_sample"]
    return calls[1]


def run(old_frames=(EARLIER["frame_raygen"],), old_chains=(EARLIER["pt_bounce_sample"],),
        device="cuda", card: str = "", camv: tuple | None = None,
        bounce_call: tuple | None = None) -> dict:
    dev = torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("render_ab times CUDA kernels: it needs a card")
    srcs = [("frame_raygen", f) for f in old_frames] + [("pt_bounce_sample", c)
                                                        for c in old_chains]
    olds = build_earlier(srcs)
    for kernel in ("frame_raygen", "pt_bounce_sample"):
        for ln in ptxas_lines(cuda_build.last_build_log, f"{kernel}_kernel") or [
                "(built before this process: see chip_smoke.py phase 1)"]:
            print(f"[render_ab] ptxas current {kernel}: {' '.join(ln.split())}", flush=True)
    for (kernel, src), (_fn, lines) in olds.items():
        for ln in lines:
            print(f"[render_ab] ptxas {stem(src)} {kernel}: {' '.join(ln.split())}", flush=True)
    if camv is None:
        camv = raycast.camera_of(common.script_camera(np.zeros(3, np.float32), 1.0))
    if bounce_call is None:
        bounce_call = first_packet_bounce_call(dev)
    common.warm_up(dev)
    out = {}
    for (kernel, src), (fn, _lines) in olds.items():
        if kernel == "frame_raygen":
            out[f"frame_raygen {stem(src)}"] = raygen_ab(fn, camv, *FRAME, dev, card, stem(src))
            continue
        for backend in ("sats", "alias"):
            out[f"pt_bounce_sample_{backend} {stem(src)}"] = bounce_ab(
                fn, *bounce_call, backend, card, stem(src))
    # the yardstick of both backends: the same call without an HDRI, the
    # rest of the sample alone (the current kernel)
    args, kw = bounce_call
    with counts_kept():
        out["pt_bounce_sample_no_hdri_ms"] = [common.timed(
            lambda: pt_chain.bounce_sample(*args, **dict(kw, hdri=False)), REPS)[1]
            for _ in range(2)]
    print(f"[render_ab] pt_bounce_sample without an HDRI on the same call (the rest of the "
          f"sample): {' / '.join(f'{v:.4f}' for v in out['pt_bounce_sample_no_hdri_ms'])} ms "
          f"[{card}]", flush=True)
    return out


def stem(path: str) -> str:
    return os.path.splitext(os.path.basename(path))[0]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old-frame", action="append",
                    help="an earlier frame.cu (repeatable; default: commit 877ff8b's)")
    ap.add_argument("--old-chain", action="append",
                    help="an earlier pt_chain.cu (repeatable; default: commit 877ff8b's)")
    args = ap.parse_args(argv)
    return run(args.old_frame or [EARLIER["frame_raygen"]],
               args.old_chain or [EARLIER["pt_bounce_sample"]],
               card=common.card(torch.device("cuda")))


if __name__ == "__main__":
    main()
