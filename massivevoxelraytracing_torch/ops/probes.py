"""Hopper microbenchmarks of the questions the megakernel's design asks
(csrc/hako_probes.cu; ports of the reference's Pallas probes
scripts/gather_probe3.py, scripts/dma_gather_probe3.py,
scripts/construct_micro.py and scripts/hako_kernel_micro.py):

  * `row_chase`: chains of dependent brick-row gathers, each row's index
    read from the row before, three ways (CHASE_MODES): 4 B a thread
    (word 0), 16 B a thread (the xor of words 0-3) and a whole 656-byte
    row a warp (the xor of all 164 words), 1, 2 or 4 chains a thread (or
    warp) in flight. Output: each chain's final row.
  * `walk_probe` / `fetch_probe`: walk64 (or the 64-cell scan64 sweep)
    alone on register-resident masks, and the row-word fetch alone, each
    looped `iters` times a lane. Output: a checksum a lane.
  * `construct_probe`: k dependent repeats of one vector construct a lane
    (CONSTRUCTS: construct_micro.py's eight kernels).
  * `node_gather_probe`: k dependent node fetches from an int32 [n, 3]
    node table (mask_lo, mask_hi, base) in global, shared or constant
    memory (SPACES; hako_kernel_micro.py k_gflat / k_gsplit).
  * `table_select_probe`: k dependent selects from 64 entries of 3 words
    in constant memory, shared memory or registers with warp shuffles
    (FORMS; hako_kernel_micro.py k_fold).
  * `calib_probe`: k dependent multiply-adds against 8 independent
    chains of k (CALIBS; hako_kernel_micro.py calibrate, k = 1024 / 128).
  * `shell_copy_probe`: kernel A's I/O alone, o = i + 1 over 8 separate
    float arrays or one consolidated array (hako_shell_micro.py :64,
    :78); `preamble_probe`: the I/O plus the ray preamble on the unit box
    (:102); `probe_stage_probe`: kernel A's probe body by stage, or
    unrolled over the tree's levels (PROBE_STAGES; :200, :287).
  * `take_along_probe`: take_along_axis within a tile on a batch of
    tiles, from shared memory, warp shuffles or L1 (TAA_FORMS;
    dyngather_probe2.py :19, gather_probe3.py :70); `smem_alloc_probe`:
    the largest dynamic shared memory a block launches with
    (gather_probe3.py :101); `ohg_probe`: the dependent chase
    idx = (idx + flat[idx]) & (n - 1), each hop a load from shared or
    global memory or a one-hot product on the tensor cores (OHG_MODES;
    gather_probe3.py :147).

Each has a plain PyTorch version computing the same output (u32 kept as
int64 & MASK32, every float op rounded on its own). The wrappers run the
plain version for CPU tensors and launch the kernel for CUDA tensors
(counted in LAUNCHES), and raise for anything else. `threads` is the
block size of a launch (a multiple of 32): 32 with one block an SM
measures a dependent repeat's latency, 256 the card's rate.
"""

from __future__ import annotations

import numpy as np
import torch

from . import hako_kernels as hk
from .bits import MASK32, to_i32_bits, u32
from .hako_kernels import _bit_at, _pc64_below, _scan64_impl, _walk64_impl

ROW_WORDS = 164
CHASE_MODES = ("4B", "16B", "warp_row")
WALK_IMPLS = ("walk", "scan")
# construct -> its inputs: f f32, i i32, u u32 bit patterns (as int32)
CONSTRUCTS = {"minmax": "ff", "cmpsel": "ff", "int": "i", "vshift": "iu",
              "barrel": "iu", "i2f": "i", "bitat": "iuu", "pc64": "iuu"}
FLOAT_CONSTRUCTS = ("minmax", "cmpsel", "i2f")
SPACES = ("global", "shared", "constant")
MAX_NODES = 4096  # the constant-memory node table: 4096 x 12 B = 48 KB
FORMS = ("constant", "shared", "shuffle")
CALIBS = ("chain", "par8")
CALIB_MUL = 1.0000001  # 1 + 2^-23 as f32
UNROLL = 8  # repeats a pass of the kernels' outer loop: k is a multiple
N_TAB_SEG = 11  # byte segments of a reference node: 4 + 4 + 3
SHELL_ARRAYS = 8  # kernel A's lane arrays each way
# probe_stage_probe's stages: staged()'s four kernels, then k_body
PROBE_STAGES = ("preamble+walk", "+coords/planes/rank", "+node fetch",
                "+second walk", "unrolled body")
STAGE_CLIP = 55  # the stages' clip of the rank before the fetch (the reference's literal)
# the reference's node-table forms by a level's node count (its ops/hako.py
# SMEM_TABLE_MAX / TAA_TABLE_MAX; flat tables are off there)
NODE_FORMS = ("smem", "taa", "split")
SMEM_TABLE_MAX = 64
TAA_TABLE_MAX = 2048
TAA_FORMS = ("shared", "shfl", "global")
OHG_MODES = ("shared", "global", "mma")
OHG_COLS = 128        # the one-hot gather's table row
OHG_PLANES = 3        # its byte planes: table values below 2^24
OHG_THREADS = 128     # the shared and global modes' block: 128 lanes
OHG_CHUNK = 32        # the mma mode's table rows an mma takes (its K)
OHG_TILES = OHG_COLS // 8  # its 8-column n-tiles: a warp each
OHG_CLUSTERS = (1, 2, 4, 8)  # its cluster sizes; a cluster chases 16 x size lanes
OHG_SLICE_BYTES = 192 * 1024  # the byte planes a block of it holds at most
TAA_THREADS = 256     # the whole-tile take-along's block (kTaaThreads)
TAA_SECTOR = 8        # int32 columns of a 32-byte sector
TAA_SLICE = 32        # the sliced shared axis-0 take-along's widest slice
SMEM_ROW_FLOATS = 128  # a row of the shared-memory allocation probe
LAUNCHES = {"row_chase": 0, "walk_probe": 0, "fetch_probe": 0, "l2_read_probe": 0,
            "construct_probe": 0, "node_gather_probe": 0,
            "table_select_probe": 0, "calib_probe": 0,
            "shell_copy_probe": 0, "preamble_probe": 0, "probe_stage_probe": 0,
            "take_along_probe": 0, "smem_alloc_probe": 0, "ohg_probe": 0}
# the 2D gather probes' kernels (dyngather_probe2.py, gather_probe3.py)
GATHER_KERNELS = ("take_along_probe", "smem_alloc_probe", "ohg_probe")


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


def _check_threads(threads):
    if threads <= 0 or threads > 1024 or threads % 32:
        raise ValueError(f"threads must be a multiple of 32 up to 1024, not {threads}")


def _check_repeats(k):
    if k <= 0 or k % UNROLL:
        raise ValueError(f"k must be a positive multiple of {UNROLL}, not {k}")


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


def walk_probe_plain(lo, hi, t1, dc, *, iters: int, impl: str = "walk"):
    """Sum over `iters` of walk64's cell (64 = none; impl "scan": the
    64-cell sweep's) on masks (lo, hi) stepped by an LCG; t1 / dc f32
    [3, N] held fixed, vm6 = 0, t_q = 0."""
    walk = {"walk": _walk64_impl, "scan": _scan64_impl}[impl]
    lo = lo.long() & MASK32
    hi = hi.long() & MASK32
    zero = torch.zeros_like(lo)
    tq = torch.zeros_like(t1[0])
    acc = torch.zeros_like(lo)
    for _ in range(iters):
        acc = acc + walk(lo, hi, zero, t1, dc, tq)[2]
        lo = (lo * 1664525 + 1013904223) & MASK32
        hi = (hi * 22695477 + 1) & MASK32
    return acc.to(torch.int32)


def walk_probe(lo, hi, t1, dc, *, iters: int, impl: str = "walk",
               threads: int = 256):
    """As walk_probe_plain; lo / hi int32 [N] (u32 bit patterns)."""
    if impl not in WALK_IMPLS:
        raise ValueError(f"no walk probe {impl!r}")
    if _device_of(lo, "walk_probe") == "cpu":
        return walk_probe_plain(lo, hi, t1, dc, iters=iters, impl=impl)
    from ..utils import cuda_build

    dev = lo.device
    n = lo.shape[0]
    _check("lo", lo, dev, torch.int32, (n,))
    _check("hi", hi, dev, torch.int32, (n,))
    _check("t1", t1, dev, torch.float32, (3, n))
    _check("dc", dc, dev, torch.float32, (3, n))
    _check_threads(threads)
    out = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return out
    with torch.cuda.device(dev):
        rc = cuda_build.load().walk_probe_launch(
            lo.data_ptr(), hi.data_ptr(), t1.data_ptr(), dc.data_ptr(), n,
            int(iters), WALK_IMPLS.index(impl), int(threads), out.data_ptr(),
            _stream(dev))
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


def fetch_probe(rows, row_of, *, iters: int, threads: int = 256):
    """As fetch_probe_plain; rows int32 [N, 164], row_of int32 [lanes]."""
    if _device_of(row_of, "fetch_probe") == "cpu":
        return fetch_probe_plain(rows, row_of, iters=iters)
    from ..utils import cuda_build

    dev = row_of.device
    n = row_of.shape[0]
    _check("rows", rows, dev, torch.int32, (rows.shape[0], ROW_WORDS))
    _check("row_of", row_of, dev, torch.int32, (n,))
    _check_threads(threads)
    if rows.data_ptr() % 16:
        raise ValueError("rows: need a 16-byte aligned table")
    out = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return out
    with torch.cuda.device(dev):
        rc = cuda_build.load().fetch_probe_launch(
            rows.data_ptr(), row_of.data_ptr(), n, int(iters), int(threads),
            out.data_ptr(), _stream(dev))
    _launched("fetch_probe", rc)
    return out


def l2_read_plain(buf, *, passes: int, lanes: int):
    """Each of `lanes` threads' sum, mod 2^32, over the passes and the
    16-byte vectors g, g + lanes, ... of buf (int32 [4 x vectors]) of the
    xor of the vector's four words."""
    v = buf.view(-1, 4)
    x = (v[:, 0] ^ v[:, 1] ^ v[:, 2] ^ v[:, 3]).long() & 0xFFFFFFFF
    x = torch.nn.functional.pad(x, (0, -x.shape[0] % lanes))
    acc = (x.view(-1, lanes).sum(0) * passes) & 0xFFFFFFFF
    return torch.where(acc >= 2 ** 31, acc - 2 ** 32, acc).to(torch.int32)


def l2_read_probe(buf, *, passes: int, blocks: int, threads: int = 256):
    """As l2_read_plain over blocks x threads lanes; buf int32 [4 x vectors],
    16-byte aligned. Reads buf `passes` times, each byte once a pass."""
    lanes = blocks * threads
    if buf.dim() != 1 or buf.shape[0] == 0 or buf.shape[0] % 4:
        raise ValueError(f"buf: need int32 [4 x vectors], got {list(buf.shape)}")
    if passes < 0 or blocks <= 0:
        raise ValueError(f"need passes >= 0 and blocks > 0, not {passes}, {blocks}")
    _check_threads(threads)
    if _device_of(buf, "l2_read_probe") == "cpu":
        return l2_read_plain(buf, passes=passes, lanes=lanes)
    from ..utils import cuda_build

    dev = buf.device
    _check("buf", buf, dev, torch.int32, buf.shape)
    if buf.data_ptr() % 16:
        raise ValueError("buf: need a 16-byte aligned buffer")
    out = torch.empty(lanes, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = cuda_build.load().l2_read_probe_launch(
            buf.data_ptr(), buf.shape[0] // 4, int(passes), int(blocks), int(threads),
            out.data_ptr(), _stream(dev))
    _launched("l2_read_probe", rc)
    return out


def construct_plain(kind: str, inputs, k: int):
    """k dependent repeats of construct_micro.py's construct `kind` on
    `inputs` (one [N] tensor per letter of CONSTRUCTS[kind]). Returns f32
    [N] (FLOAT_CONSTRUCTS) or int32 [N]."""
    if kind in ("minmax", "cmpsel"):
        x, y = inputs
        for _ in range(k):
            if kind == "minmax":
                x = torch.minimum(torch.maximum(x, y), y + x)
            else:
                x = torch.where(x < y, x + y, y)
        return x
    x = inputs[0].long()
    if kind == "i2f":
        acc = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        for _ in range(k):
            acc = acc + (x & 255).to(torch.float32)
            x = x ^ acc.long()  # acc < 2^24 and integral: the cast is exact
        return acc
    m = [u32(v) for v in inputs[1:]]
    for _ in range(k):
        if kind == "int":
            x = ((x + 7) & 0x7FFFFFF) ^ (x >> 3)
        elif kind == "vshift":
            x = x + ((m[0] >> (x & 31)) & 1)
        elif kind == "barrel":
            sh = x & 31
            v = m[0]
            for b in (1, 2, 4, 8, 16):
                v = torch.where((sh & b) != 0, v >> b, v)
            x = x + (v & 1)
        elif kind == "bitat":
            x = x + _bit_at(m[0], m[1], x & 63).long()
        else:
            x = x + _pc64_below(m[0], m[1], x & 63)
    return to_i32_bits(x)


def construct_probe(kind: str, inputs, *, k: int, threads: int = 256):
    """As construct_plain; k a multiple of UNROLL."""
    if kind not in CONSTRUCTS:
        raise ValueError(f"no construct {kind!r}")
    letters = CONSTRUCTS[kind]
    if len(inputs) != len(letters):
        raise ValueError(f"{kind} takes {len(letters)} inputs, not {len(inputs)}")
    _check_repeats(k)
    if _device_of(inputs[0], "construct_probe") == "cpu":
        return construct_plain(kind, inputs, k)
    from ..utils import cuda_build

    dev = inputs[0].device
    n = inputs[0].shape[0]
    for j, (x, c) in enumerate(zip(inputs, letters)):
        _check(f"input {j}", x, dev, torch.float32 if c == "f" else torch.int32, (n,))
    _check_threads(threads)
    slots = {"f": [], "i": [], "u": []}
    for x, c in zip(inputs, letters):
        slots[c].append(x.data_ptr())
    fa, fb = (slots["f"] + [None, None])[:2]
    ua, ub = (slots["u"] + [None, None])[:2]
    ia = (slots["i"] + [None])[0]
    out = torch.empty(n, dtype=torch.float32 if kind in FLOAT_CONSTRUCTS
                      else torch.int32, device=dev)
    if n == 0:
        return out
    with torch.cuda.device(dev):
        rc = cuda_build.load().construct_probe_launch(
            list(CONSTRUCTS).index(kind), fa, fb, ia, ua, ub, n, int(k),
            out.data_ptr(), int(threads), _stream(dev))
    _launched("construct_probe", rc)
    return out


def node_table_from_segments(tab, device):
    """The reference's byte-segment node tables -> the port's int32
    [n, 3] (mask_lo, mask_hi, base) table. tab (numpy) is either the flat
    f32 [n, 16] of hako_kernels._gather_node_flat (segment k in column k)
    or the split f32 [rows, 11 * 128] of _gather_node (node r * 128 + j's
    segment k at [r, k * 128 + j]); a segment is a byte value, truncated
    to an integer as the reference's gathers do (astype(int32))."""
    tab = np.asarray(tab, np.float32)
    if tab.ndim == 2 and tab.shape[1] == 16:
        seg = tab[:, :N_TAB_SEG]
    elif tab.ndim == 2 and tab.shape[1] == N_TAB_SEG * 128:
        seg = tab.reshape(-1, N_TAB_SEG, 128).transpose(0, 2, 1).reshape(-1, N_TAB_SEG)
    else:
        raise ValueError(f"not a flat [n, 16] or split [rows, {N_TAB_SEG * 128}] "
                         f"table: {tab.shape}")
    b = seg.astype(np.int32).astype(np.uint32)
    lo = b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16) | (b[:, 3] << 24)
    hi = b[:, 4] | (b[:, 5] << 8) | (b[:, 6] << 16) | (b[:, 7] << 24)
    base = b[:, 8] | (b[:, 9] << 8) | (b[:, 10] << 16)
    nodes = np.stack([lo, hi, base], 1).view(np.int32)
    return torch.from_numpy(np.ascontiguousarray(nodes)).to(device)


def node_gather_plain(table, idx0, k: int):
    """k dependent node fetches a lane: idx = (idx0 + acc) & (n - 1),
    acc = (acc + base[idx]) & 31, fold ^= mask_lo[idx] ^ mask_hi[idx].
    table int32 [n, 3], n a power of two. Returns (acc, fold) int32 [N]."""
    n = table.shape[0]
    words = u32(table)
    start = idx0.long()
    acc = torch.zeros_like(start)
    fold = torch.zeros_like(start)
    for _ in range(k):
        node = words[(start + acc) & (n - 1)]
        acc = (acc + node[:, 2]) & 31
        fold = fold ^ node[:, 0] ^ node[:, 1]
    return acc.to(torch.int32), to_i32_bits(fold)


def node_gather_probe(table, idx0, *, k: int, space: str, threads: int = 256):
    """As node_gather_plain, with the table in `space` (SPACES); n a power
    of two up to MAX_NODES, k a multiple of UNROLL."""
    n = table.shape[0]
    if space not in SPACES:
        raise ValueError(f"no node table space {space!r}")
    if n <= 0 or n > MAX_NODES or n & (n - 1):
        raise ValueError(f"node table of {n} nodes: need a power of two up to "
                         f"{MAX_NODES}")
    _check_repeats(k)
    if _device_of(idx0, "node_gather_probe") == "cpu":
        return node_gather_plain(table, idx0, k)
    from ..utils import cuda_build

    dev = idx0.device
    m = idx0.shape[0]
    _check("table", table, dev, torch.int32, (n, 3))
    _check("idx0", idx0, dev, torch.int32, (m,))
    _check_threads(threads)
    acc = torch.empty(m, dtype=torch.int32, device=dev)
    fold = torch.empty_like(acc)
    if m == 0:
        return acc, fold
    with torch.cuda.device(dev):
        rc = cuda_build.load().node_gather_probe_launch(
            SPACES.index(space), table.data_ptr(), n, idx0.data_ptr(), m,
            int(k), acc.data_ptr(), fold.data_ptr(), int(threads), _stream(dev))
    _launched("node_gather_probe", rc)
    return acc, fold


def table_select_plain(tab, idx0, k: int):
    """k dependent selects a lane from tab int32 [64, 3]: sel = (idx0 +
    acc) & 63, acc = (acc + (w0 ^ w1 ^ w2)) & 31 of row sel. Returns acc
    int32 [N]."""
    words = u32(tab)
    start = idx0.long()
    acc = torch.zeros_like(start)
    for _ in range(k):
        row = words[(start + acc) & 63]
        acc = (acc + (row[:, 0] ^ row[:, 1] ^ row[:, 2])) & 31
    return acc.to(torch.int32)


def table_select_probe(tab, idx0, *, k: int, form: str, threads: int = 256):
    """As table_select_plain, with the table in `form` (FORMS); k a
    multiple of UNROLL."""
    if form not in FORMS:
        raise ValueError(f"no table form {form!r}")
    _check_repeats(k)
    if _device_of(idx0, "table_select_probe") == "cpu":
        return table_select_plain(tab, idx0, k)
    from ..utils import cuda_build

    dev = idx0.device
    m = idx0.shape[0]
    _check("tab", tab, dev, torch.int32, (64, 3))
    _check("idx0", idx0, dev, torch.int32, (m,))
    _check_threads(threads)
    out = torch.empty(m, dtype=torch.int32, device=dev)
    if m == 0:
        return out
    with torch.cuda.device(dev):
        rc = cuda_build.load().table_select_probe_launch(
            FORMS.index(form), tab.data_ptr(), idx0.data_ptr(), m, int(k),
            out.data_ptr(), int(threads), _stream(dev))
    _launched("table_select_probe", rc)
    return out


CALIB_REPEATS = {"chain": 1024, "par8": 128}  # the reference's


def calib_plain(kind: str, a, b, k: int | None = None):
    """calibrate()'s kernels, every multiply and add rounded on its own:
    "chain" k dependent a = a * CALIB_MUL + b; "par8" 8 chains of k from
    a + j with b = a, summed in order. k defaults to CALIB_REPEATS[kind].
    f32 [N]."""
    k = CALIB_REPEATS[kind] if k is None else k
    c = torch.tensor(CALIB_MUL, dtype=torch.float32, device=a.device)
    if kind == "chain":
        x = a
        for _ in range(k):
            x = x * c + b
        return x
    xs = [a + torch.tensor(float(j), dtype=torch.float32, device=a.device)
          for j in range(8)]
    for _ in range(k):
        xs = [x * c + a for x in xs]
    r = xs[0]
    for x in xs[1:]:
        r = r + x
    return r


def calib_probe(kind: str, a, b, *, k: int | None = None, threads: int = 256):
    """As calib_plain; a / b f32 [N], k a multiple of UNROLL."""
    if kind not in CALIBS:
        raise ValueError(f"no calibration kernel {kind!r}")
    k = CALIB_REPEATS[kind] if k is None else k
    _check_repeats(k)
    if _device_of(a, "calib_probe") == "cpu":
        return calib_plain(kind, a, b, k)
    from ..utils import cuda_build

    dev = a.device
    n = a.shape[0]
    _check("a", a, dev, torch.float32, (n,))
    _check("b", b, dev, torch.float32, (n,))
    _check_threads(threads)
    out = torch.empty(n, dtype=torch.float32, device=dev)
    if n == 0:
        return out
    with torch.cuda.device(dev):
        rc = cuda_build.load().calib_probe_launch(
            CALIBS.index(kind), a.data_ptr(), b.data_ptr(), n, int(k),
            out.data_ptr(), int(threads), _stream(dev))
    _launched("calib_probe", rc)
    return out


# ---------------------------------------------------------------------------
# kernel A's fixed cost (hako_shell_micro.py): its I/O shell, the ray
# preamble, and its probe body by stage
# ---------------------------------------------------------------------------


def _ptrs(xs, count):
    """A host array of `count` device pointers (None past len(xs))."""
    import ctypes

    return (ctypes.c_void_p * count)(*[x.data_ptr() for x in xs],
                                       *([None] * (count - len(xs))))


def shell_copy_plain(*xs):
    """o = i + 1 of each f32 array."""
    return tuple(x + 1.0 for x in xs)


def shell_copy_probe(*xs, out=None):
    """As shell_copy_plain: 8 f32 [n] arrays (kernel A's 8 separate
    streams each way), or one f32 array (the consolidated [G, 8, L]
    block), into new arrays or into `out` (as many arrays of the same
    shape). Every address must be 16-byte aligned."""
    if len(xs) not in (1, SHELL_ARRAYS):
        raise ValueError(f"the shell takes 1 or {SHELL_ARRAYS} arrays, not {len(xs)}")
    if out is not None and len(out) != len(xs):
        raise ValueError(f"{len(xs)} arrays in, {len(out)} out")
    if _device_of(xs[0], "shell_copy_probe") == "cpu":
        got = shell_copy_plain(*xs)
        if out is None:
            return got
        for o, g in zip(out, got):
            o.copy_(g)
        return tuple(out)
    from ..utils import cuda_build

    dev = xs[0].device
    shape = tuple(xs[0].shape)
    outs = tuple(torch.empty_like(x) for x in xs) if out is None else tuple(out)
    for j, (x, o) in enumerate(zip(xs, outs)):
        _check(f"array {j}", x, dev, torch.float32, shape)
        _check(f"out {j}", o, dev, torch.float32, shape)
        if x.data_ptr() % 16 or o.data_ptr() % 16:
            raise ValueError(f"array {j}: need 16-byte aligned addresses")
    n = xs[0].numel()
    if n == 0:
        return outs
    if n >= 2**31:
        raise ValueError(f"the shell takes fewer than 2**31 floats an array, not {n}")
    with torch.cuda.device(dev):
        rc = cuda_build.load().shell_copy_probe_launch(
            int(len(xs) == 1), _ptrs(xs, SHELL_ARRAYS), _ptrs(outs, SHELL_ARRAYS), n,
            _stream(dev))
    _launched("shell_copy_probe", rc)
    return outs


def _stack_rays(rays):
    return torch.stack(rays[:3], 1), torch.stack(rays[3:6], 1)


def preamble_plain(rays, bounds):
    """The ray preamble of the SoA rays (ox, oy, oz, dx, dy, dz) in the box
    bounds (lower[3], upper[3]): 8 f32 arrays, t0 + t1 an axis, dt an
    axis, vm6 and enter_ok as floats."""
    ro, rd = _stack_rays(rays)
    t0, t1, dt, vm6, ok = hk._ray_preamble(bounds[:3], bounds[3:], ro, rd)
    tt = t0 + t1
    return (tt[0], tt[1], tt[2], dt[0], dt[1], dt[2], vm6.to(torch.float32),
            ok.to(torch.float32))


def _check_lane_arrays(rays, count, dev):
    if len(rays) != count:
        raise ValueError(f"need {count} lane arrays, not {len(rays)}")
    n = rays[0].shape[0]
    for j, x in enumerate(rays):
        _check(f"lane array {j}", x, dev, torch.float32, (n,))
    return n


def preamble_probe(rays, bounds):
    """As preamble_plain; rays 6 f32 [n], bounds f32 [6]."""
    if _device_of(rays[0], "preamble_probe") == "cpu":
        return preamble_plain(rays, bounds)
    from ..utils import cuda_build

    dev = rays[0].device
    n = _check_lane_arrays(rays, 6, dev)
    _check("bounds", bounds, dev, torch.float32, (6,))
    outs = tuple(torch.empty(n, dtype=torch.float32, device=dev) for _ in range(8))
    if n == 0:
        return outs
    with torch.cuda.device(dev):
        rc = cuda_build.load().preamble_probe_launch(
            _ptrs(rays, 6), bounds.data_ptr(), n, _ptrs(outs, 8), _stream(dev))
    _launched("preamble_probe", rc)
    return outs


def level_forms(tabs) -> list:
    """The reference's node-table form of each level table (int32 [n_l,
    3]) by its node count: (form, rows) with rows the taa table's used
    rows of 128 nodes (hako_kernels.hako_args' level_rows)."""
    out = []
    for tab in tabs:
        n = tab.shape[0]
        if n <= SMEM_TABLE_MAX:
            out.append(("smem", 64))
        elif n <= TAA_TABLE_MAX:
            out.append(("taa", max(-(-n // 128), 1)))
        else:
            out.append(("split", -(-n // 128)))
    return out


def _level_node(tab, form, child):
    """The node the reference's gather of `form` gives for each child
    index: smem clips it to [0, 63], taa its row to [0, rows - 1]; every
    form reads zeros past the level's nodes. Returns (mask_lo, mask_hi,
    base) int64."""
    kind, rows = form
    if kind == "smem":
        i = torch.clamp(child, 0, 63)
    elif kind == "taa":
        i = torch.clamp(child >> 7, 0, rows - 1) * 128 + (child & 127)
    else:
        i = child
    ok = (i >= 0) & (i < tab.shape[0])
    node = torch.where(ok[:, None], tab[torch.where(ok, i, 0)].long(), 0)
    return node[:, 0], node[:, 1], node[:, 2]


def probe_stage_plain(stage: int, rays, bounds, root_mask, tabs, *, T: int,
                      clip: int = STAGE_CLIP):
    """Kernel A's probe body by stage on the lanes' rays (ox, oy, oz, dx,
    dy, dz, tq; f32 [n]) in the box bounds, from the root masks
    root_mask (lo, hi) through the root-down level tables `tabs` (int32
    [n_l, 3]). Stages 0-3 (PROBE_STAGES): the root walk; + its cell's
    coords, exit planes and rank; + the level-0 node at the rank clipped
    to [0, clip]; + that node's walk. Returns (child int32, en, ex).
    Stage 4: the body unrolled over T levels; returns (child, cell, en,
    ex, exit planes x, y, z, rank) as hako_shell_micro.py's k_body
    writes them."""
    ro, rd = _stack_rays(rays)
    tq = rays[6]
    _t0, t1, dt, vm6, _ok = hk._ray_preamble(bounds[:3], bounds[3:], ro, rd)
    forms = level_forms(tabs)
    ml = torch.full_like(vm6, root_mask[0])
    mh = torch.full_like(vm6, root_mask[1])
    cur = t1
    dc = dt * 0.25

    def exit_planes(cur, dc, c):
        return hk._plane(cur, dc, torch.clamp(hk._coords(c) + 1, max=4))

    if stage == 4:
        base = torch.zeros_like(vm6)
        for depth in range(T):
            en, ex, c = _walk64_impl(ml, mh, vm6, cur, dc, tq)
            nt1 = exit_planes(cur, dc, c)
            rank = _pc64_below(ml, mh, c ^ vm6)
            child = base + rank
            if depth < T - 1:
                ml, mh, base = _level_node(tabs[depth], forms[depth], child)
                cur = nt1
                dc = dc * 0.25
        i32 = torch.int32
        return (child.to(i32), c.to(i32), en, ex, nt1[0], nt1[1], nt1[2],
                rank.to(i32))
    en, ex, c = _walk64_impl(ml, mh, vm6, cur, dc, tq)
    child = c
    if stage >= 1:
        nt1 = exit_planes(cur, dc, c)
        rank = _pc64_below(ml, mh, c ^ vm6)
        child = rank
    if stage >= 2:
        ml2, mh2, b2 = _level_node(tabs[0], forms[0], torch.clamp(child, 0, clip))
        child = b2 + rank
    if stage >= 3:
        child = child + _walk64_impl(ml2, mh2, vm6, nt1, dc * 0.25, tq)[2]
    return child.to(torch.int32), en, ex


def probe_stage_probe(stage: int, rays, bounds, root_mask, tabs, *, T: int,
                      clip: int = STAGE_CLIP):
    """As probe_stage_plain; rays 7 f32 [n], bounds f32 [6], tabs int32
    [n_l, 3] root-down (at most cuda_build.MAX_LEVELS)."""
    if stage not in range(len(PROBE_STAGES)):
        raise ValueError(f"no probe stage {stage}")
    if stage >= 2 and not tabs or stage == 4 and not 1 <= T <= len(tabs) + 1:
        raise ValueError(f"stage {stage} with T = {T} needs more than {len(tabs)} "
                         "level tables")
    if _device_of(rays[0], "probe_stage_probe") == "cpu":
        return probe_stage_plain(stage, rays, bounds, root_mask, tabs, T=T, clip=clip)
    import ctypes

    from ..utils import cuda_build

    if len(tabs) > cuda_build.MAX_LEVELS:
        raise ValueError(f"at most {cuda_build.MAX_LEVELS} level tables, not {len(tabs)}")

    dev = rays[0].device
    n = _check_lane_arrays(rays, 7, dev)
    _check("bounds", bounds, dev, torch.float32, (6,))
    for d, tab in enumerate(tabs):
        _check(f"level {d}", tab, dev, torch.int32, (tab.shape[0], 3))
    levels, level_off = hk.level_pack(list(tabs))
    forms = level_forms(tabs)

    def ints(vals):
        return (ctypes.c_int * cuda_build.MAX_LEVELS)(*vals)

    full = stage == 4
    out_i = [torch.empty(n, dtype=torch.int32, device=dev) for _ in range(3 if full else 1)]
    out_f = [torch.empty(n, dtype=torch.float32, device=dev) for _ in range(5 if full else 2)]
    if n:
        offs, counts = ints(level_off), ints([t.shape[0] for t in tabs])
        kinds, rows = ints([NODE_FORMS.index(f) for f, _ in forms]), ints([r for _, r in forms])
        with torch.cuda.device(dev):
            rc = cuda_build.load().probe_stage_probe_launch(
                stage, _ptrs(rays, 7), bounds.data_ptr(), root_mask[0] & MASK32,
                root_mask[1] & MASK32, None if levels is None else levels.data_ptr(),
                ctypes.addressof(offs), ctypes.addressof(counts),
                ctypes.addressof(kinds), ctypes.addressof(rows), len(tabs), T,
                clip, n, _ptrs(out_i, 3), _ptrs(out_f, 5), _stream(dev))
        _launched("probe_stage_probe", rc)
    if full:
        child, cell, rank = out_i
        return (child, cell, *out_f, rank)
    return (out_i[0], *out_f)


# ---------------------------------------------------------------------------
# 2D gathers within a tile, shared-memory capacity, the one-hot gather
# (dyngather_probe2.py, gather_probe3.py)
# ---------------------------------------------------------------------------


def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def smem_optin_bytes(device) -> int:
    """The shared memory a block of `device` can opt in to
    (cudaDevAttrMaxSharedMemoryPerBlockOptin)."""
    from ..utils import cuda_build

    index = torch.device(device).index
    v = cuda_build.load().smem_optin_bytes(torch.cuda.current_device() if index is None
                                           else index)
    if v < 0:
        raise RuntimeError(f"no shared memory limit for device {device}")
    return v


def _is_pow2(v: int) -> bool:
    return v > 0 and v & (v - 1) == 0


def take_along_plain(t, idx, *, axis: int, mod: int, c_out: int | None = None):
    """take_along_axis on each tile of a batch: out[b, i, j] =
    t[b, i, idx[b, i, j] % mod] (axis 1) or t[b, idx[b, i, j] % mod, j]
    (axis 0), for j < c_out (default: idx's columns); mod 0 takes idx as
    it is. t int [B, R, C], idx int [B, r, Ci]."""
    c_out = idx.shape[2] if c_out is None else c_out
    x = idx[:, :, :c_out].long()
    if mod:
        x = torch.remainder(x, mod)
    b = torch.arange(x.shape[0], device=x.device)[:, None, None]
    if axis == 1:
        return t[b, torch.arange(x.shape[1], device=x.device)[None, :, None], x]
    return t[b, x, torch.arange(c_out, device=x.device)[None, None, :]]


def taa0_whole(R: int, C: int, r: int, mod: int, B: int, sms: int) -> bool:
    """Whether the shared axis-0 take-along stages whole R x C tiles, a
    block a tile (take_along_probe_kernel<0, SHARED>): where the r indices
    a column, spread over the tile's R rows (mod 0 or mod >= R), are
    expected to reach nearly every sector (2 r >= R: 1 - exp(-8 r / R) >=
    98% of them for uniform indices), so that marking would stage no
    less, and either the B tiles fill the card's `sms` SMs or a block
    stages a tile with one 16-byte load a thread (R x C x 4 <= TAA_THREADS
    x 16), so that slices would spread no latency over SMs (PERF.md §6:
    k_taa0's batch and a0small's 8-row tile are faster whole, its 32-row
    tile in slices). Elsewhere a block takes a slice of a tile's columns
    (taa0_slice) and stages only the sectors its indices reach
    (taa0_sectors)."""
    reach_all = 2 * r >= R and not 0 < mod < R
    return reach_all and (B >= sms or R * C * 4 <= TAA_THREADS * 16)


def taa0_slice(C: int, B: int, sms: int) -> int:
    """The columns a block of the sliced shared axis-0 take-along takes:
    TAA_SLICE, halved while the B tiles' blocks are fewer than the `sms`
    SMs (one tile's loads spread over more SMs), down to one sector of
    TAA_SECTOR columns; cut to the tile's columns, rounded up to a sector,
    where it is wider."""
    width = -(-C // TAA_SECTOR) * TAA_SECTOR
    s = min(TAA_SLICE, width)
    while s > TAA_SECTOR and B * -(-C // s) < sms:
        s = max(s // 2 // TAA_SECTOR * TAA_SECTOR, TAA_SECTOR)
    return s


def taa0_sectors(t, idx, *, mod: int):
    """The 32-byte sectors (a row's 8 columns) that the shared axis-0
    take-along stages: sectors[b, m, q] is set where an index of column
    8q..8q+7 of tile b, reduced by mod, is row m (an index outside the
    tile is read through L1 and marks none). Every slice is a multiple of
    8 columns, so a sector belongs to one block. bool [B, R, ceil(C / 8)]."""
    B, R, C = t.shape
    x = idx[:, :, :C].long()
    if mod:
        x = torch.remainder(x, mod)
    ok = (x >= 0) & (x < R)
    sec = torch.arange(C, device=x.device) // TAA_SECTOR
    flat = ((torch.arange(B, device=x.device)[:, None, None] * R + x) * -(-C // TAA_SECTOR)
            + sec[None, None, :])
    out = torch.zeros(B * R * -(-C // TAA_SECTOR), dtype=torch.bool, device=x.device)
    out[flat[ok]] = True
    return out.reshape(B, R, -(-C // TAA_SECTOR))


def take_along_probe(t, idx, *, axis: int, mod: int, form: str, c_out: int | None = None):
    """As take_along_plain; t int32 [B, R, C], idx int32 [B, r, Ci], mod 0
    or a power of two no larger than the gathered axis (C along rows, R
    along columns). A block a tile, but for the shared form along columns,
    where a block takes a slice of a tile's columns (taa0_slice) and
    stages the sectors its indices reach (taa0_sectors), unless the
    indices reach nearly every sector of a batch that fills the card
    (taa0_whole). With mod 0 the kernel takes idx as it is
    and does not check it: an index outside the tile reads past it, where
    the plain version raises an IndexError. form "shared" needs the R x C
    x 4 bytes of the tile in a block's shared memory and raises a
    ValueError naming them where they exceed what a block can have."""
    if form not in TAA_FORMS:
        raise ValueError(f"no take-along form {form!r}")
    if axis not in (0, 1) or form == "shfl" and axis != 1:
        raise ValueError(f"no {form} take-along on axis {axis}")
    if t.dim() != 3 or idx.dim() != 3 or t.shape[0] != idx.shape[0]:
        raise ValueError(f"take_along_probe: need [B, R, C] and [B, r, Ci], got "
                         f"{list(t.shape)} and {list(idx.shape)}")
    span = t.shape[2 if axis == 1 else 1]
    if mod and not _is_pow2(mod) or mod > span:
        raise ValueError(f"the modulus must be 0 or a power of two no larger than the "
                         f"gathered axis ({span}), not {mod}")
    c_out = idx.shape[2] if c_out is None else c_out
    if _device_of(idx, "take_along_probe") == "cpu":
        return take_along_plain(t, idx, axis=axis, mod=mod, c_out=c_out)
    from ..utils import cuda_build

    dev = idx.device
    B, R, C = t.shape
    r, Ci = idx.shape[1:]
    _check("t", t, dev, torch.int32, (B, R, C))
    _check("idx", idx, dev, torch.int32, (B, r, Ci))
    fits = (r <= R and c_out <= Ci) if axis == 1 else c_out == C <= Ci
    if not fits or C % 4 or Ci % 4 or c_out % 4 or t.data_ptr() % 16 or idx.data_ptr() % 16:
        raise ValueError(f"take_along_probe: no axis-{axis} gather of {c_out} columns "
                         f"from {list(t.shape)} by {list(idx.shape)} (columns a multiple "
                         "of 4, 16-byte aligned)")
    if form == "shfl" and (C not in (128, 256) or c_out % 32):
        raise ValueError(f"take_along_probe: the shuffle form takes rows of 128 or 256, "
                         f"not {C} (c_out {c_out}, mod {mod})")
    if form == "shared":
        need, limit = R * C * 4, smem_optin_bytes(dev)
        if need > limit:
            raise ValueError(f"take_along_probe: a {R} x {C} int32 tile is {need} bytes "
                             f"of shared memory, over the {limit} bytes a block can have")
    slice_cols = 0  # whole tiles
    if axis == 0 and form == "shared":
        sms = _sm_count(dev)
        if not taa0_whole(R, C, r, mod, B, sms):
            slice_cols = taa0_slice(C, B, sms)
    out = torch.empty(B, r, c_out, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = cuda_build.load().take_along_probe_launch(
            axis, TAA_FORMS.index(form), t.data_ptr(), idx.data_ptr(), out.data_ptr(),
            B, R, C, r, Ci, c_out, int(mod), slice_cols, _stream(dev))
    _launched("take_along_probe", rc)
    return out


def smem_alloc_plain(x, n_rows: int):
    """What the allocation probe returns: row 0 + row n_rows - 1 of its
    scratch after 2x went into both, 4x."""
    return x * 2.0 + x * 2.0


def smem_alloc_probe(x, n_rows: int):
    """As smem_alloc_plain, from n_rows x 128 f32 of dynamic shared memory
    a block; x f32 [1, 128]. Raises RuntimeError with the CUDA error where
    the card refuses the allocation."""
    if n_rows <= 0:
        raise ValueError(f"need a row or more, not {n_rows}")
    if _device_of(x, "smem_alloc_probe") == "cpu":
        return smem_alloc_plain(x, n_rows)
    from ..utils import cuda_build

    dev = x.device
    _check("x", x, dev, torch.float32, (1, SMEM_ROW_FLOATS))
    out = torch.empty_like(x)
    lib = cuda_build.load()
    with torch.cuda.device(dev):
        rc = lib.smem_alloc_probe_launch(x.data_ptr(), out.data_ptr(), int(n_rows),
                                         _stream(dev))
    if rc != 0:
        raise RuntimeError(f"smem_alloc_probe: {n_rows} rows ({n_rows * SMEM_ROW_FLOATS * 4} "
                           f"bytes) refused: CUDA error {rc} "
                           f"({lib.cuda_error_string(rc).decode()})")
    _launched("smem_alloc_probe", rc)
    return out


def ohg_plain(table, idx, k: int, mode: str = "gather"):
    """k hops of idx = (idx + flat[idx]) & (n - 1) on the flat int32
    [n_rows, 128] table (n = n_rows x 128, a power of two; values in [0,
    n)). mode "gather" indexes the table; "mma" repeats the one-hot
    kernel's arithmetic: each hop the one-hot rows of the indices times
    the table's three byte planes (a float64 product, exact: one
    non-zero term below 2^8 a sum), p0 + (p1 << 8) + (p2 << 16), then the
    index's column."""
    n_rows = table.shape[0]
    wrap = n_rows * OHG_COLS - 1
    x = idx.reshape(-1).long()
    if mode == "gather":
        flat = table.reshape(-1).long()
        for _ in range(k):
            x = (x + flat[x]) & wrap
    elif mode == "mma":
        words = table.long()
        planes = [((words >> (8 * p)) & 255).double() for p in range(OHG_PLANES)]
        rows = torch.arange(n_rows, device=x.device)
        for _ in range(k):
            one_hot = ((x >> 7)[:, None] == rows[None, :]).double()
            full = sum((one_hot @ plane).long() << (8 * p) for p, plane in enumerate(planes))
            x = (x + full.gather(1, (x & 127)[:, None])[:, 0]) & wrap
    else:
        raise ValueError(f"no plain chase mode {mode!r}")
    return x.to(torch.int32).reshape(idx.shape)


def ohg_cluster(n_rows: int) -> int:
    """The mma mode's cluster for a table of n_rows: the fewest blocks (of
    OHG_CLUSTERS, at most one a 32-row chunk) whose shares of its byte
    planes (n_rows x 384 bytes) are at most OHG_SLICE_BYTES each."""
    need = -(-n_rows * OHG_COLS * OHG_PLANES // OHG_SLICE_BYTES)
    cl = next((c for c in OHG_CLUSTERS if c >= need), OHG_CLUSTERS[-1])
    return min(cl, max(n_rows // OHG_CHUNK, 1))


def ohg_smem_bytes(n_rows: int, cluster: int) -> int:
    """The shared memory a block of the mma mode takes: its share of the
    B fragments (n_rows x 384 / cluster bytes) and its two hops' slots (a
    block and lane of the cluster's 16 x cluster lanes)."""
    return n_rows * OHG_COLS * OHG_PLANES // cluster + 2 * cluster * 16 * cluster * 4


def ohg_mma_check(n_rows: int, limit: int) -> int:
    """The mma mode's cluster for a table of n_rows (ohg_cluster) where a
    block's share of it (ohg_smem_bytes) fits the `limit` bytes of shared
    memory a block can have, else a ValueError naming the bytes. The mode
    holds the table in its cluster's shared memory and reads none of it
    from global memory in its hops: a cluster is at most OHG_CLUSTERS[-1]
    blocks, so on an H100 (232,448 bytes) a table of 4,096 rows is the
    largest it takes."""
    cluster = ohg_cluster(n_rows)
    need = ohg_smem_bytes(n_rows, cluster)
    if need > limit:
        raise ValueError(f"ohg_probe: the byte planes of a {n_rows}-row table over "
                         f"{cluster} blocks are {need} bytes of shared memory a block, "
                         f"over the {limit} bytes a block can have")
    return cluster


def ohg_max_clusters(n_rows: int, cluster: int, device) -> int:
    """The clusters of `cluster` blocks of the mma mode on a table of
    n_rows that `device` runs at once (cudaOccupancyMaxActiveClusters)."""
    from ..utils import cuda_build

    with torch.cuda.device(device):
        v = cuda_build.load().ohg_mma_max_clusters(int(n_rows), int(cluster))
    if v < 0:
        raise RuntimeError(f"no occupancy for clusters of {cluster} on {n_rows} rows: CUDA "
                           f"error {-v}")
    return v


def ohg_fragments(table, cluster: int = 1):
    """The mma mode's shared-memory image of each block of a cluster: the
    table's three byte planes in the order mma.sync m16n8k32 reads its B
    fragments. int32 [cluster, chunks, 16 n-tiles, 3 planes, 32 threads, 2
    registers]: block r holds the 32-row chunks r x chunks..; thread (g,
    t) = (lane // 4, lane % 4) of n-tile nt holds in register 0 the plane's
    bytes of rows 32 c + 4t + j (byte j) at column 8 nt + g, in register 1
    those of rows 32 c + 16 + 4t + j."""
    n_rows = table.shape[0]
    chunks = n_rows // OHG_CHUNK
    w = u32(table).reshape(chunks, 2, 4, 4, OHG_TILES, 8)  # [c, half, t, j, nt, g]
    planes = torch.stack([(w >> (8 * p)) & 255 for p in range(OHG_PLANES)])
    planes = planes.permute(1, 5, 0, 6, 3, 2, 4)  # [c, nt, p, g, t, half, j]
    regs = (planes << (8 * torch.arange(4, device=w.device))).sum(-1)
    return to_i32_bits(regs).reshape(cluster, chunks // cluster, OHG_TILES, OHG_PLANES,
                                     32, 2)


def ohg_probe(table, idx, *, k: int, mode: str):
    """As ohg_plain (the "mma" mode's for mode "mma"); table int32
    [n_rows, 128] with n_rows a power of two (at least 32 for "mma"), idx
    int32 of any shape; k a multiple of UNROLL ("mma": any k >= 1).
    "shared" needs the table in a block's shared memory, and "mma" its
    share of the byte planes in each block of its cluster (ohg_mma_check:
    4,096 rows at most on an H100): each raises a ValueError naming the
    bytes where they exceed what a block can have."""
    if mode not in OHG_MODES:
        raise ValueError(f"no one-hot gather mode {mode!r}")
    n_rows = table.shape[0]
    if not _is_pow2(n_rows) or mode == "mma" and n_rows < OHG_CHUNK:
        raise ValueError(f"a table of {n_rows} rows: need a power of two"
                         + (", 32 or more" if mode == "mma" else ""))
    if k <= 0 or mode != "mma" and k % UNROLL:
        raise ValueError(f"k must be a positive multiple of {UNROLL}"
                         f"{' (any k >= 1 for mma)' if mode != 'mma' else ''}, not {k}")
    plain_mode = "mma" if mode == "mma" else "gather"
    if _device_of(idx, "ohg_probe") == "cpu":
        return ohg_plain(table, idx, k, plain_mode)
    from ..utils import cuda_build

    dev = idx.device
    _check("table", table, dev, torch.int32, (n_rows, OHG_COLS))
    _check("idx", idx, dev, torch.int32, tuple(idx.shape))
    if mode == "shared":
        need, limit = table.numel() * 4, smem_optin_bytes(dev)
        if need > limit:
            raise ValueError(f"ohg_probe: a {n_rows}-row table is {need} bytes of shared "
                             f"memory, over the {limit} bytes a block can have")
        if table.data_ptr() % 16:
            raise ValueError("table: need a 16-byte aligned table")
    cluster = ohg_mma_check(n_rows, smem_optin_bytes(dev)) if mode == "mma" else 0
    out = torch.empty_like(idx)
    if idx.numel() == 0:
        return out
    with torch.cuda.device(dev):
        rc = cuda_build.load().ohg_probe_launch(
            OHG_MODES.index(mode), table.data_ptr(), n_rows, idx.data_ptr(), idx.numel(),
            int(k), out.data_ptr(), OHG_THREADS, cluster, _stream(dev))
    _launched("ohg_probe", rc)
    return out
