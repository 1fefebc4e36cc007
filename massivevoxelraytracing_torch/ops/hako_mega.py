"""HakoMega: the whole HakoTree traversal as one kernel -- the port of the
reference's ops/hako_mega.py (`_make_megakernel`, a persistent Pallas
megakernel on the TPU).

Two halves:

  * `intersect_rays_hako_mega_plain`, the plain PyTorch version: a lane's
    rounds (root probe -> supernode-row DDA if the tree is fat -> brick-row
    DDA -> merge, hako_mega.py:332-403 of the reference) as masked
    lockstep tensor code, with every lane served every round;
  * `intersect_rays_hako_mega`, the wrapper: the plain version for CPU
    tensors, the hand-written CUDA kernel (csrc/hako_mega.cu, one thread
    per ray running to completion) for CUDA tensors, and an error for
    anything else. There is no fallback from the kernel to the plain
    version.

The reference's TPU knobs (U, S_BLK, cont) and its dedup DMA fetch do not
exist here: the reference's tests show results do not depend on them.
Results do not depend on max_probes / max_dda either (more rounds, the
same traversal).

Counters: `LAUNCHES` counts kernel launches of the wrapper; unresolved
lanes (a lane still unresolved after max_rounds is a bug, not a miss) are
accumulated on the device per call, read with `unresolved_lanes()`.
"""

from __future__ import annotations

import ctypes

import torch

from .hako import HakoTree
from .hako_kernels import (
    MAX_FLOAT,
    _dda_rows,
    _min3,
    _probe_from_root,
    _ray_preamble,
)

MEGA_PROBES = 4      # probe descents per round
MEGA_DDA = 24        # DDA iterations (sub-bricks) per row stage per round

LAUNCHES = 0
_UNRESOLVED: dict = {}  # device -> int32 [1] accumulator


def reset_counters() -> None:
    global LAUNCHES
    LAUNCHES = 0
    for acc in _UNRESOLVED.values():
        acc.zero_()


def unresolved_lanes() -> int:
    """Lanes left unresolved at max_rounds since the last reset."""
    return sum(int(acc.item()) for acc in _UNRESOLVED.values())


def _unresolved_acc(device) -> torch.Tensor:
    device = torch.device(device)
    if device not in _UNRESOLVED:
        _UNRESOLVED[device] = torch.zeros(1, dtype=torch.int32, device=device)
    return _UNRESOLVED[device]


def default_max_rounds(res4h: int, max_probes: int = MEGA_PROBES,
                       max_dda: int = MEGA_DDA) -> int:
    """Safety bound only (each lane stops when it resolves): worst-case
    fat-row visits along a ray (~3 * res/16) plus slack, times the extra
    rounds that probe / DDA caps below the defaults can cost. The
    reference's U-overflow factor is gone: every lane is served every
    round."""
    v = 3 * max(res4h // 16, 4) + 64
    return v * -(-MEGA_PROBES // max_probes) * -(-MEGA_DDA // max_dda)


def _rounds_for(snodes, T: int, max_probes: int, max_dda: int) -> int:
    """default_max_rounds for a tree's layout (fat rows span 256 cells)."""
    res4h = (256 if snodes is not None else 16) * 4 ** T
    return default_max_rounds(res4h, max_probes, max_dda)


def intersect_rays_hako_mega_plain(bricks, snodes, tabs, root_mask, lower,
                                   upper, ro, rd, *, T: int,
                                   shadow: bool = False,
                                   max_probes: int = MEGA_PROBES,
                                   max_dda: int = MEGA_DDA,
                                   max_rounds: int | None = None):
    """Plain version of the megakernel on any device.

    bricks/snodes: int32 [N, 164] row tables (snodes None for a plain
    tree); tabs: root-down level tables int32 [n_l, 3]; root_mask:
    (mask_lo, mask_hi) python ints; lower/upper f32 [3]; ro/rd f32 [R, 3].
    Returns (t f32 [R] (MAX_FLOAT = miss), nmajor int32 [R] (-1 = miss),
    vrank int32 [R], unresolved int32 [1])."""
    fat = snodes is not None
    if max_rounds is None:
        max_rounds = _rounds_for(snodes, T, max_probes, max_dda)
    _t0, t1, dt, vm6, enter_ok = _ray_preamble(lower, upper, ro, rd)
    rt_ml, rt_mh = root_mask

    resolved = ~enter_ok  # no-enter lanes are misses
    t_q = torch.zeros_like(t1[0])
    t_out = torch.full_like(t_q, MAX_FLOAT)
    nm_out = torch.full_like(vm6, -1, dtype=torch.int32)
    vi_out = torch.zeros_like(vm6)
    no = torch.zeros_like(resolved)
    rnd = 0
    while rnd < max_rounds and not bool(resolved.all()):
        act = ~resolved
        need, tqn, emit, child, bt1, tqe, exh = _probe_from_root(
            tabs, T, t1, dt, vm6, rt_ml, rt_mh, act, no, t_q,
            max_probes=max_probes,
        )
        if fat:
            # stage 1: the supernode row walk emits the next brick + planes
            go_s = emit
            (emit2, bp1, bp2i, brick, bp3, btq, more_s,
             tqr_s) = _dda_rows(snodes, child, dt, vm6, bt1, tqe, go_s,
                                dt_factor=0.25 ** T, shadow=shadow,
                                leaf=False, max_iters=max_dda)
            tqn = torch.where(
                go_s & ~emit2, torch.where(more_s, tqr_s, _min3(bt1)), tqn)
            emit = emit2
            bt1 = torch.stack([bp1, bp2i.view(torch.float32), bp3])
            tqe = btq
            child = brick

        go = emit
        hit, t_hit, nmaj, vr, _p3, _tqp, more, tqr = _dda_rows(
            bricks, child, dt, vm6, bt1, tqe, go,
            dt_factor=0.25 ** (T + 2 if fat else T), shadow=shadow,
            leaf=True, max_iters=max_dda,
        )
        # merge (the reference's expressions with every lane served)
        tqn = torch.where(go, torch.where(more, tqr, _min3(bt1)), tqn)
        newhit = act & hit
        resolved = resolved | (act & (newhit | exh))
        t_q = torch.where(act, tqn, t_q)
        t_out = torch.where(newhit, t_hit, t_out)
        nm_out = torch.where(newhit, nmaj, nm_out)
        vi_out = torch.where(newhit, vr, vi_out)
        rnd += 1
    unresolved = (~resolved).sum().to(torch.int32).reshape(1)
    return t_out, nm_out, vi_out.to(torch.int32), unresolved


def _check_rows(name, rows, device):
    if (rows.device != device or rows.dtype != torch.int32 or rows.dim() != 2
            or rows.shape[1] != 164 or not rows.is_contiguous()):
        raise ValueError(f"{name}: need contiguous int32 [N, 164] on {device}")


def _launch(bricks, snodes, tabs, root_mask, lower, upper, ro, rd, *, T,
            shadow, max_probes, max_dda, max_rounds, unresolved):
    """Validate, allocate the outputs and launch the CUDA kernel on the
    current stream (counted in LAUNCHES). The kernel adds its unresolved
    lanes to `unresolved`."""
    global LAUNCHES
    from ..utils import cuda_build

    device = ro.device
    _check_rows("bricks", bricks, device)
    fat = snodes is not None
    if fat:
        _check_rows("snodes", snodes, device)
    if len(tabs) != T - 1 or len(tabs) > cuda_build.MAX_LEVELS:
        raise ValueError(f"need T-1 = {T - 1} level tables, got {len(tabs)}")
    for tab in tabs:
        if tab.device != device or tab.dtype != torch.int32 or tab.shape[1:] != (3,):
            raise ValueError(f"level tables: need int32 [n, 3] on {device}")
    n = ro.shape[0]
    for name, x in (("ro", ro), ("rd", rd)):
        if (x.device != device or x.dtype != torch.float32
                or x.shape != (n, 3) or not x.is_contiguous()):
            raise ValueError(f"{name}: need contiguous f32 [{n}, 3] on {device}")
    bounds = torch.cat([lower, upper]).to(device=device, dtype=torch.float32)

    t = torch.empty(n, dtype=torch.float32, device=device)
    nmaj = torch.empty(n, dtype=torch.int32, device=device)
    vrank = torch.empty(n, dtype=torch.int32, device=device)
    if n == 0:
        return t, nmaj, vrank
    levels = torch.cat(tabs) if tabs else None
    offs = [0]
    for tab in tabs:
        offs.append(offs[-1] + tab.shape[0])
    off_arr = (ctypes.c_int * cuda_build.MAX_LEVELS)(*offs[: len(tabs)])
    lib = cuda_build.load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.hako_mega_launch(
            bricks.data_ptr(), snodes.data_ptr() if fat else None,
            levels.data_ptr() if levels is not None else None,
            ctypes.addressof(off_arr), T,
            root_mask[0], root_mask[1], bounds.data_ptr(),
            ro.data_ptr(), rd.data_ptr(), n,
            t.data_ptr(), nmaj.data_ptr(), vrank.data_ptr(),
            unresolved.data_ptr(), int(shadow), max_probes, max_dda,
            max_rounds, float(0.25 ** T), float(0.25 ** (T + 2 if fat else T)),
            stream,
        )
    if rc != 0:
        raise RuntimeError(f"hako_mega kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return t, nmaj, vrank


def intersect_rays_hako_mega(bricks, snodes, tabs, root_mask, lower, upper,
                             ro, rd, *, T: int, shadow: bool = False,
                             max_probes: int | None = None,
                             max_dda: int | None = None,
                             max_rounds: int | None = None):
    """Full-frame traversal (arguments as in the plain version). Returns
    (t, nmajor, vrank). CPU tensors run the plain version; CUDA tensors
    launch the kernel or raise."""
    max_probes = MEGA_PROBES if max_probes is None else int(max_probes)
    max_dda = MEGA_DDA if max_dda is None else int(max_dda)
    if max_rounds is None:
        max_rounds = _rounds_for(snodes, T, max_probes, max_dda)
    if ro.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no hako_mega kernel for device {ro.device}")
    acc = _unresolved_acc(ro.device)
    kw = dict(T=T, shadow=shadow, max_probes=max_probes, max_dda=max_dda,
              max_rounds=int(max_rounds))
    if ro.device.type == "cpu":
        t, nmaj, vrank, unresolved = intersect_rays_hako_mega_plain(
            bricks, snodes, tabs, root_mask, lower, upper, ro, rd, **kw)
        acc += unresolved
        return t, nmaj, vrank
    return _launch(bricks, snodes, tabs, root_mask, lower, upper, ro, rd,
                   unresolved=acc, **kw)


def hako_mega_args(tree: HakoTree):
    """(meta, T) for the accel dispatch: meta = (bricks, snodes, root-down
    level tables, (root_mask_lo, root_mask_hi))."""
    meta = (tree.bricks, tree.snodes, tuple(reversed(tree.levels)),
            (tree.root_mask_lo, tree.root_mask_hi))
    return meta, tree.T


def intersect_hako_mega(tree: HakoTree, ro, rd, shadow: bool = False, **kw):
    (bricks, snodes, tabs, root_mask), T = hako_mega_args(tree)
    dev = tree.device
    return intersect_rays_hako_mega(
        bricks, snodes, tabs, root_mask, tree.lower, tree.upper,
        torch.as_tensor(ro, dtype=torch.float32, device=dev).contiguous(),
        torch.as_tensor(rd, dtype=torch.float32, device=dev).contiguous(),
        T=T, shadow=shadow, **kw,
    )
