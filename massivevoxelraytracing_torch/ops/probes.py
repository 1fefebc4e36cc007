"""Hopper microbenchmarks of two questions the megakernel's design asks
(csrc/hako_probes.cu; ports of the reference's Pallas probes
scripts/gather_probe3.py, scripts/dma_gather_probe3.py and
scripts/hako_kernel_micro.py):

  * `row_chase`: chains of dependent brick-row gathers, each row's index
    read from the row before, three ways (CHASE_MODES): 4 B a thread
    (word 0), 16 B a thread (the xor of words 0-3) and a whole 656-byte
    row a warp (the xor of all 164 words), 1, 2 or 4 chains a thread (or
    warp) in flight. Output: each chain's final row.
  * `walk_probe` / `fetch_probe`: walk64 alone on register-resident masks,
    and the row-word fetch alone, each looped `iters` times a lane.
    Output: a checksum a lane.

Each has a plain PyTorch version computing the same output. The wrappers
run the plain version for CPU tensors and launch the kernel for CUDA
tensors (counted in LAUNCHES), and raise for anything else.
"""

from __future__ import annotations

import numpy as np
import torch

from .bits import MASK32
from .hako_kernels import _walk64_impl

ROW_WORDS = 164
CHASE_MODES = ("4B", "16B", "warp_row")
LAUNCHES = {"row_chase": 0, "walk_probe": 0, "fetch_probe": 0}


def reset_counters() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def make_chase_table(n_rows: int, rng) -> np.ndarray:
    """int32 [n_rows, 164] rows of random words in which all three chase
    modes follow one cycle through every row: word 0 holds the next row,
    words 1-3 xor to 0 and words 4-163 xor to 0."""
    rows = rng.integers(0, 1 << 32, (n_rows, ROW_WORDS), dtype=np.uint64)
    rows = rows.astype(np.uint32)
    order = rng.permutation(n_rows)
    nxt = np.empty(n_rows, np.uint32)
    nxt[order] = np.roll(order, -1)
    rows[:, 0] = nxt
    rows[:, 3] = rows[:, 1] ^ rows[:, 2]
    rows[:, 163] = np.bitwise_xor.reduce(rows[:, 4:163], axis=1)
    return rows.view(np.int32)


def _xor_columns(x):
    """xor over the last axis of an int tensor (a folding tree)."""
    while x.shape[-1] > 1:
        if x.shape[-1] % 2:
            x = torch.cat([x, torch.zeros_like(x[..., :1])], -1)
        half = x.shape[-1] // 2
        x = x[..., :half] ^ x[..., half:]
    return x[..., 0]


def row_chase_plain(rows, start, *, hops: int, mode: str):
    """Final row of each chain: `hops` times, idx <- the mode's function
    of rows[idx] (word 0; the xor of words 0-3; the xor of the row)."""
    width = {"4B": 1, "16B": 4, "warp_row": ROW_WORDS}[mode]
    idx = start.long()
    for _ in range(hops):
        idx = _xor_columns(rows[idx, :width]).long()
    return idx.to(torch.int32)


def chase_chains(mode: str, chains: int, blocks: int, threads: int) -> int:
    """The number of chains a row_chase launch runs: `chains` per thread,
    or per warp for the whole-row mode."""
    if mode not in CHASE_MODES or chains not in (1, 2, 4) or threads % 32:
        raise ValueError(f"no chase launch for mode {mode!r}, {chains} chains, "
                         f"{threads} threads")
    owners = blocks * threads // (32 if mode == "warp_row" else 1)
    return owners * chains


def _device_of(x, name):
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no {name} kernel for device {x.device}")
    return x.device.type


def _check(name, x, device, dtype, shape):
    if (x.device != device or x.dtype != dtype or tuple(x.shape) != tuple(shape)
            or not x.is_contiguous()):
        raise ValueError(f"{name}: need contiguous {dtype} {list(shape)} on "
                         f"{device}, got {x.dtype} {list(x.shape)} on {x.device}")


def _launched(name, rc):
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    LAUNCHES[name] += 1


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def row_chase(rows, start, *, hops: int, mode: str, chains: int, blocks: int,
              threads: int):
    """Final row of each chain (as row_chase_plain); start holds
    chase_chains(mode, chains, blocks, threads) row indices."""
    n = chase_chains(mode, chains, blocks, threads)
    if _device_of(start, "row_chase") == "cpu":
        _check("start", start, start.device, torch.int32, (n,))
        return row_chase_plain(rows, start, hops=hops, mode=mode)
    from ..utils import cuda_build

    dev = start.device
    _check("rows", rows, dev, torch.int32, (rows.shape[0], ROW_WORDS))
    _check("start", start, dev, torch.int32, (n,))
    if rows.data_ptr() % 16:
        raise ValueError("rows: need a 16-byte aligned table")
    end = torch.empty(n, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = cuda_build.load().row_chase_launch(
            rows.data_ptr(), start.data_ptr(), end.data_ptr(), n, int(hops),
            CHASE_MODES.index(mode), int(chains), int(blocks), int(threads),
            _stream(dev))
    _launched("row_chase", rc)
    return end


def walk_probe_plain(lo, hi, t1, dc, *, iters: int):
    """Sum over `iters` of walk64's cell (64 = none) on masks (lo, hi)
    stepped by an LCG; t1 / dc f32 [3, N] held fixed, vm6 = 0, t_q = 0."""
    lo = lo.long() & MASK32
    hi = hi.long() & MASK32
    zero = torch.zeros_like(lo)
    tq = torch.zeros_like(t1[0])
    acc = torch.zeros_like(lo)
    for _ in range(iters):
        acc = acc + _walk64_impl(lo, hi, zero, t1, dc, tq)[2]
        lo = (lo * 1664525 + 1013904223) & MASK32
        hi = (hi * 22695477 + 1) & MASK32
    return acc.to(torch.int32)


def walk_probe(lo, hi, t1, dc, *, iters: int):
    """As walk_probe_plain; lo / hi int32 [N] (u32 bit patterns)."""
    if _device_of(lo, "walk_probe") == "cpu":
        return walk_probe_plain(lo, hi, t1, dc, iters=iters)
    from ..utils import cuda_build

    dev = lo.device
    n = lo.shape[0]
    _check("lo", lo, dev, torch.int32, (n,))
    _check("hi", hi, dev, torch.int32, (n,))
    _check("t1", t1, dev, torch.float32, (3, n))
    _check("dc", dc, dev, torch.float32, (3, n))
    out = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return out
    with torch.cuda.device(dev):
        rc = cuda_build.load().walk_probe_launch(
            lo.data_ptr(), hi.data_ptr(), t1.data_ptr(), dc.data_ptr(), n,
            int(iters), out.data_ptr(), _stream(dev))
    _launched("walk_probe", rc)
    return out


def fetch_probe_plain(rows, row_of, *, iters: int):
    """xor over `iters` of words (2s, 2s+1) of each lane's row, s starting
    at lane & 63 and then taken from the words read and the step."""
    r = row_of.long()
    s = torch.arange(r.shape[0], device=r.device) & 63
    acc = torch.zeros_like(r)
    for k in range(iters):
        w = rows[r, 2 * s].long() ^ rows[r, 2 * s + 1].long()
        acc = acc ^ w
        s = (w ^ k) & 63
    return acc.to(torch.int32)


def fetch_probe(rows, row_of, *, iters: int):
    """As fetch_probe_plain; rows int32 [N, 164], row_of int32 [lanes]."""
    if _device_of(row_of, "fetch_probe") == "cpu":
        return fetch_probe_plain(rows, row_of, iters=iters)
    from ..utils import cuda_build

    dev = row_of.device
    n = row_of.shape[0]
    _check("rows", rows, dev, torch.int32, (rows.shape[0], ROW_WORDS))
    _check("row_of", row_of, dev, torch.int32, (n,))
    if rows.data_ptr() % 16:
        raise ValueError("rows: need a 16-byte aligned table")
    out = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return out
    with torch.cuda.device(dev):
        rc = cuda_build.load().fetch_probe_launch(
            rows.data_ptr(), row_of.data_ptr(), n, int(iters), out.data_ptr(),
            _stream(dev))
    _launched("fetch_probe", rc)
    return out
