"""What the probe and measurement scripts share: the device they run on,
the card's name, its launch shapes, CUDA-event timing, one probe case
measured against its plain version with its instruction counts and floors,
the card's L2 read rate, a host model of shared memory's bank wavefronts
for the staged tables' probes, and for the scene scripts the reference
scripts' camera and sky, a frame's rays, hako_mega's bound on them, the
sample chain's and the scene build's bounds and a profiled call's device
time."""

from __future__ import annotations

import collections.abc
import inspect
import itertools
import math
import subprocess
import time

import numpy as np
import torch

from ..ops import probes, pt_chain
from ..ops import voxelize as vox_ops

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
F32_OPS_PER_S = 67e12      # H100 SXM float32 outside the tensor cores
INT8_OPS_PER_S = 1979e12   # H100 SXM int8 on the tensor cores, dense
SCHEDULERS = 4             # warp instructions an SM issues a cycle
# repeats a lane, at least, at the one-warp-an-SM and full-occupancy
# shapes: enough for the k-to-2k difference to stand well above the
# events' noise, few enough that checking every timed launch against its
# plain version (a few eager ops a repeat) stays short
LATENCY_REPEATS = 1024
RATE_REPEATS = 256
SCRIPT_LANES = 64 * 2048   # the JAX scripts' grid of 64 blocks of 2048 lanes
CPU_LANES = 256            # the plain versions' size on the CPU


def add_device_arg(ap) -> None:
    ap.add_argument("--device", default="cuda",
                    help="cuda (default): the kernels on the card; cpu: the "
                    "plain versions at a small size (no device times)")


def resolve_device(name: str) -> torch.device:
    """The device to run on; raises for a card that is not there."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: run on the card, or pass --device cpu "
                           "for the plain versions")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no probe kernels for device {dev}")
    return dev


def _smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader,nounits" if "clocks" in query
                          else "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def card(device) -> str:
    """The card's name and power limit as nvidia-smi gives them; on the
    CPU, a note that no number is a device time."""
    if device.type != "cuda":
        return "CPU: plain versions, no device time"
    return _smi("name,power.limit")


def sm_clock_hz() -> float:
    """The card's maximum SM clock (nvidia-smi clocks.max.sm)."""
    return float(_smi("clocks.max.sm")) * 1e6


def shapes(device, k: int, latency_k: int = LATENCY_REPEATS,
           rate_k: int = RATE_REPEATS) -> list:
    """The launch shapes of a probe whose script repeats k times a lane:
    one warp an SM (a dependent repeat's latency, at least latency_k
    repeats), full occupancy (the card's rate, at least rate_k) and the
    JAX script's own 131,072 lanes at its k."""
    if device.type != "cuda":
        return [dict(shape="cpu", lanes=CPU_LANES, threads=32, k=k)]
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return [dict(shape="one warp an SM", lanes=sms * 32, threads=32,
                 k=max(k, latency_k)),
            dict(shape="full occupancy", lanes=sms * 2048, threads=256,
                 k=max(k, rate_k)),
            dict(shape="script", lanes=SCRIPT_LANES, threads=256, k=k)]


ROW_BYTES = 164 * 4


def ops_ms(n_ops: float) -> float:
    """The least ms of n_ops float32 operations at the card's rate."""
    return n_ops / F32_OPS_PER_S * 1e3


def bound(n_bytes: float, n_ops: float) -> tuple:
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the float32 rate."""
    b_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    o_ms = ops_ms(n_ops)
    return (b_ms, "bytes") if b_ms >= o_ms else (o_ms, "operations")


L2_PROBE_MIB = (8, 16, 32)  # the L2-resident buffers of the L2 read probe
L2_PROBE_READ_MIB = 256     # what one launch of it reads, in passes over a buffer
L2_PROBE_BLOCKS_PER_SM = 8  # of 256 threads: a full SM


def l2_read_rates(device, rng) -> dict:
    """{MiB: bytes/s} that l2_read_probe reads an L2-resident buffer of each
    size at (a grid of L2_PROBE_BLOCKS_PER_SM blocks of 256 an SM, the
    buffer read L2_PROBE_READ_MIB / MiB times a launch, warm: the least of
    3 trains), its sums == their plain version first."""
    blocks = torch.cuda.get_device_properties(device).multi_processor_count * (
        L2_PROBE_BLOCKS_PER_SM)
    rates = {}
    for mib in L2_PROBE_MIB:
        buf = torch.from_numpy(rng.integers(0, 1 << 32, (mib << 20) // 4, dtype=np.uint64)
                               .astype(np.uint32).view(np.int32)).to(device)
        passes = L2_PROBE_READ_MIB // mib

        def read(b=buf, p=passes):
            return probes.l2_read_probe(b, passes=p, blocks=blocks)

        if not torch.equal(read(), probes.l2_read_plain(buf, passes=passes,
                                                         lanes=blocks * 256)):
            raise AssertionError(f"l2_read_probe {mib} MiB differs from the plain version")
        rates[mib] = passes * (mib << 20) / (best_ms([read])[0] * 1e-3)
    return rates


# Shared memory: 32 banks of 4 bytes; an SM serves one wavefront of them,
# 128 B, a clock.
SMEM_BANKS = 32
SMEM_WAVE_REPEATS = 16  # the repeats a lane whose loads the cases' counts model


def smem_wavefronts(word_addresses, width: int = 4) -> np.ndarray:
    """The shared-memory wavefronts of warp-wide loads. word_addresses
    int [..., 32]: each lane's word address (its first word for a 16-byte
    load; negative: a lane that loads nothing). A 4-byte load takes as many
    wavefronts as the most distinct words any bank is asked for (a word
    asked for by several lanes is broadcast once); a 16-byte load is served
    a quarter-warp (8 lanes, 4 words each) at a time, each phase counted
    so, and the phases summed. int [...]."""
    a = np.asarray(word_addresses, dtype=np.int64)
    lead = a.shape[:-1]
    if width == 16:
        words = a.reshape(*lead, 4, 8)[..., None] + np.arange(4)
        words = np.where(a.reshape(*lead, 4, 8)[..., None] < 0, -1, words)
        return smem_wavefronts(words.reshape(*lead, 4, 32)).sum(-1)
    if width != 4:
        raise ValueError(f"no {width}-byte shared loads")
    a = np.sort(a.reshape(-1, 32), axis=1)
    new = np.ones(a.shape, bool)
    new[:, 1:] = a[:, 1:] != a[:, :-1]
    bank = np.where(new & (a >= 0), a % SMEM_BANKS, SMEM_BANKS)
    rows = np.arange(a.shape[0])[:, None] * (SMEM_BANKS + 1)
    per_bank = np.bincount((rows + bank).ravel(), minlength=a.shape[0] * (SMEM_BANKS + 1))
    return per_bank.reshape(-1, SMEM_BANKS + 1)[:, :SMEM_BANKS].max(1).reshape(lead)


def staged_loads(entries, rec: int, copies: int) -> list:
    """A fetch's shared loads of entries int [..., 32] (a warp's lanes in
    order) from a table staged in layout (rec, copies), as
    csrc/hako_probes.cu's StagedReader issues them: [(word addresses,
    width)], three 4-byte loads (rec 3) or one 16-byte load (rec 4)."""
    e = np.asarray(entries, dtype=np.int64)
    lane = np.arange(32)
    if rec == 4:
        return [(4 * (e * copies + (lane & 7) % copies), 16)]
    return [((3 * e + j) * copies + lane % copies, 4) for j in range(3)]


def staged_wavefronts(entries, rec: int, copies: int) -> float:
    """The mean wavefronts a warp-repeat of fetching entries int [repeats,
    lanes] (lanes a multiple of 32) in layout (rec, copies)."""
    e = np.asarray(entries).reshape(len(entries), -1, 32)
    return float(sum(smem_wavefronts(a, w) for a, w in staged_loads(e, rec, copies)).mean())


def fetch_entries(table, idx0, k: int, *, select: bool) -> np.ndarray:
    """The entries int [k, lanes] the shared node fetch (select=False) or
    the shared select (True) reads in its first k repeats, from the plain
    versions' recurrences on the case's own table and start indices; the
    lanes padded to whole warps as the kernels run them (a lane past the
    end starts at entry 0)."""
    words = table.cpu().numpy().view(np.uint32).astype(np.int64)
    n = words.shape[0]
    start = np.zeros(-(-idx0.numel() // 32) * 32, np.int64)
    start[:idx0.numel()] = idx0.cpu().numpy()
    acc = np.zeros_like(start)
    out = np.empty((k, start.size), np.int64)
    for r in range(k):
        out[r] = e = (start + acc) & (n - 1)
        w = words[e]
        acc = (acc + ((w[:, 0] ^ w[:, 1] ^ w[:, 2]) if select else w[:, 2])) & 31
    return out


def case_wavefronts(table, idx0, k: int, *, select: bool, layouts) -> list:
    """The mean wavefronts a warp-repeat of a shared-form case's own
    fetches (its first SMEM_WAVE_REPEATS repeats of k, every lane) in each
    layout (rec, copies) of `layouts`."""
    e = fetch_entries(table, idx0, min(k, SMEM_WAVE_REPEATS), select=select)
    return [staged_wavefronts(e, rec, copies) for rec, copies in layouts]


def wavefront_ms(lanes: int, k: int, waves: float, sms: int, clock: float) -> float:
    """The least ms of lanes x k repeats at `waves` wavefronts a
    warp-repeat, one wavefront a clock an SM (3 words a lane: at least 3)."""
    return -(-lanes // 32) * k * waves / (sms * clock) * 1e3


# The round kernels' bounds on their inputs: each byte read or written
# once, counted by the lanes that take each branch; operations a lower
# bound on one yardstick, hako_mega.traversal_traffic's: the ray preamble's
# ~30 float ops a lane that runs it, ~100 a row walked.
PREAMBLE_OPS = 30
ROW_WALK_OPS = 100


def walk_ops(preambles: int, row_walks: int) -> int:
    """Float operations of `preambles` ray preambles and `row_walks` row
    DDAs (one lane on one row)."""
    return PREAMBLE_OPS * preambles + ROW_WALK_OPS * row_walks


def probe_bound(n: int, table_words: int) -> tuple:
    """hako_probe on n lanes. Every lane: in idx 4, ro / rd 24, tq 4; out
    emit 1, child 4, bt1 12, tqe / tqn 8, exh 1; the level tables once."""
    return bound(n * (32 + 26) + 4 * table_words, walk_ops(n, 0))


def dda_bound(n: int, n_go: int, rows: int) -> tuple:
    """hako_dda (or hako_dda_cached) on n lanes, n_go of them going, over
    `rows` distinct rows. Every lane: in go 1, tqe 4; out hit 1, t / nmaj
    / vr / p3 / tqp / tqr 24, more 1; go lanes: in idx 4, ro / rd 24,
    child 4, bt1 12, and their rows; a preamble and a row walk each."""
    return bound(n * (5 + 26) + n_go * 44 + rows * ROW_BYTES, walk_ops(n_go, n_go))


def dda_counts(go, child) -> tuple:
    """(go lanes, distinct rows among them) of a kernel B launch."""
    return int(go.sum()), int(torch.unique(child[go]).numel())


def merge_bound(n: int, n_act: int, n_more: int, n_plane: int, n_hit: int) -> tuple:
    """hako_merge on n lanes. Every lane: in idx 4, resolved 1; active
    lanes: in tqn 4, emit / hit / exh 3, out resolved 1, tq 4; emitting
    lanes: in more 1, then tqr 4 (more) or bt1 12; hit lanes: in t / nmaj
    / vr 12, out t / nmaj / vrank 12."""
    return bound(n * 5 + n_act * 12 + n_more * 5 + n_plane * 13 + n_hit * 24, 3 * n_act)


def merge_counts(state, idx, emit, hit, more) -> tuple:
    """(lanes, active, emitting with more, emitting without, hits) of a
    hako_merge launch on the round state `state`."""
    act = ~state[0][idx.long()]
    return (int(idx.shape[0]), int(act.sum()), int((act & emit & more).sum()),
            int((act & emit & ~more).sum()), int((act & hit).sum()))


def dda_merge_bound(n: int, n_act: int, n_emit: int, row_walks: int, rows: int,
                    n_hit: int) -> tuple:
    """hako_dda_merge on n lanes: n_act of them unresolved, n_emit of
    those emitting a row from kernel A, `row_walks` row DDAs in all (the
    supernode and the brick stage's go-lanes), over `rows` distinct rows
    of both tables, n_hit hitting. Every lane: in idx 4, resolved 1;
    active lanes: in emit / exh 2, tqn 4, out resolved 1, tq 4; emitting
    lanes: in ro / rd 24, child 4, bt1 12, tqe 4, and one preamble; hit
    lanes: out t / nmaj / vrank 12; each distinct row once."""
    return bound(n * 5 + n_act * 11 + n_emit * 44 + n_hit * 12 + rows * ROW_BYTES,
                 walk_ops(n_emit, row_walks))


def dda_merge_counts(state, idx, emit, stages, hit) -> tuple:
    """(lanes, active, emitting, row walks, distinct rows, hits) of a
    hako_dda_merge launch on the round state `state`: `stages` are the
    unfused stage's kernel B inputs (go, child) on the same lanes, one
    pair a table (supernode rows, brick rows), `hit` its leaf hits."""
    act = ~state[0][idx.long()]
    walks = sum(int((act & go).sum()) for go, _c in stages)
    rows = sum(int(torch.unique(c[act & go]).numel()) for go, c in stages)
    return (int(idx.shape[0]), int(act.sum()), int((act & emit).sum()), walks, rows,
            int((act & hit).sum()))


def rounds_counts(bricks, snodes, tabs, root_mask, lower, upper, ro, rd, *, T: int,
                  shadow: bool = False, max_probes: int | None = None,
                  max_dda: int | None = None) -> dict:
    """What each round of a round-driver call serves and reads: its lanes,
    the lanes it leaves unresolved, the row DDAs it runs (the supernode and
    the brick stage's go-lanes) and the distinct rows of each table its
    lanes read, from the two-launch driver with the unfused stage
    recording kernel B's rows (the kernels on CUDA tensors, the plain
    versions on CPU ones). Returns {"rounds": [(lanes, left, row walks,
    distinct rows), ...], "unresolved", "table_words"}."""
    from ..ops import hako_kernels as hk

    cuda = ro.device.type == "cuda"
    max_probes = hk.PROBES if max_probes is None else max_probes
    max_dda = hk.DDA_ITERS if max_dda is None else max_dda
    dda_stage = hk.hako_dda if cuda else hk.hako_dda_plain
    per_round = []

    def probe(*a, **k):
        per_round.append([int(a[7].shape[0]), 0, 0, 0])
        return (hk.hako_probe if cuda else hk.hako_probe_plain)(*a, **k)

    def dda(rows, *a, **k):
        go, child = a[4], a[5]
        per_round[-1][2] += int(go.sum())
        per_round[-1][3] += int(torch.unique(child[go]).numel())
        return dda_stage(rows, *a, **k)

    stage = hk.unfused_stage(dda, hk.hako_merge if cuda else hk.hako_merge_plain)
    out = hk.drive((probe, stage), bricks, snodes, tabs, root_mask, lower, upper, ro, rd,
                   T=T, shadow=shadow, max_probes=max_probes, max_dda=max_dda,
                   max_rounds=hk.default_max_rounds(snodes, T, max_probes, max_dda))
    unresolved = int(out[3].item())
    for r, rec in enumerate(per_round):
        rec[1] = per_round[r + 1][0] if r + 1 < len(per_round) else unresolved
    return dict(rounds=[tuple(x) for x in per_round], unresolved=unresolved,
                table_words=sum(int(t.numel()) for t in tabs))


def rounds_bound(counts: dict) -> tuple:
    """hako_rounds on one call, its rounds as the round kernels' bounds
    count them, summed over the rounds, without kernel A's outputs (they
    stay in registers): a round's lanes read their ray (ro / rd 24) and,
    after round 0, their list entry and resume key (8); the lanes it
    leaves write their resume key and next list entry (8); the lanes it
    resolves write t / nmaj / vrank once (12), as do the lanes left at
    max_rounds; each round reads the distinct rows its lanes walk and the
    level tables once. Operations: a preamble a lane a round, a row walk
    a row DDA (rounds_counts)."""
    n_bytes = ops_pre = ops_walk = 0
    for r, (lanes, left, walks, rows) in enumerate(counts["rounds"]):
        n_bytes += (lanes * (24 + (8 if r else 0)) + left * 8 + (lanes - left) * 12
                    + rows * ROW_BYTES + 4 * counts["table_words"])
        ops_pre += lanes
        ops_walk += walks
    n_bytes += 12 * counts["unresolved"]
    return bound(n_bytes, walk_ops(ops_pre, ops_walk))


HOST_CYCLES_A_CALL = 400_000  # ~0.2 ms of the card's clock: a wrapper call's host time


def queue_ahead(calls: int) -> None:
    """Park the stream on a spin kernel long enough for the host to queue
    `calls` launches behind it, so that the events time the card and not
    the host's launch overhead (a wrapper call costs tens of microseconds
    of Python, longer than a short probe launch)."""
    torch.cuda._sleep(HOST_CYCLES_A_CALL * calls)


def timed(fn, reps: int = 20, warm: bool = True):
    """(the last call's result, ms a call) with CUDA events around `reps`
    calls queued behind a spin kernel, after one warm call unless `warm`
    is false."""
    if warm:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    queue_ahead(reps)
    start.record()
    for _ in range(reps):
        out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop) / reps


def best_ms(fns, trials: int = 3, reps: int = 10) -> list:
    """The least of `trials` timed ms of each fn, taken in turns."""
    best = [float("inf")] * len(fns)
    for _ in range(trials):
        for j, fn in enumerate(fns):
            best[j] = min(best[j], timed(fn, reps)[1])
    return best


def warm_up(device, seconds: float = 0.3) -> None:
    """Keep the card busy for about `seconds` so its clocks leave idle
    before anything is timed (8 independent multiply-add chains a lane,
    the calibration kernel, over the whole card); and load the spin kernel
    of queue_ahead, whose first launch would otherwise stall the first
    timing behind it."""
    lanes = torch.cuda.get_device_properties(device).multi_processor_count * 2048
    a = torch.ones(lanes, dtype=torch.float32, device=device)
    t0 = time.time()
    while time.time() - t0 < seconds:
        probes.calib_probe("par8", a, a, k=8192)
        torch.cuda.synchronize()
    queue_ahead(1)
    torch.cuda.synchronize()


def event_ms_each(fn, setup, reps: int = 10, calls: int = 1) -> float:
    """ms a call of fn(setup()) with CUDA events around fn alone, queued
    behind a spin kernel long enough for `calls` wrapper calls (setup,
    e.g. a copy of a state that fn updates in place, untimed)."""
    fn(setup())
    total = 0.0
    for _ in range(reps):
        arg = setup()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        queue_ahead(calls)
        start.record()
        fn(arg)
        stop.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(stop)
    return total / reps


def event_ms_median(fn, setup, reps: int = 10) -> float:
    """The median ms of `reps` single calls of fn(setup()), each timed by
    CUDA events around fn alone behind a spin kernel (setup untimed, e.g.
    an L2 flush): a call that the host stalls past the spin does not set
    it, as it sets a mean."""
    fn(setup())
    ms = []
    for _ in range(reps):
        arg = setup()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        queue_ahead(1)
        start.record()
        fn(arg)
        stop.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(stop))
    return float(np.median(ms))


def _outputs(x):
    return x if isinstance(x, tuple) else (x,)


class Meter:
    """Measures probe cases on one device: each case's kernel against its
    plain version, bit for bit, at every repeat count that is then timed;
    then on the card its time at k and 2k repeats (the least of 3 turns
    of 10 launches each), its loop's SASS instructions a repeat, and its
    floors: the issue floor (warp instructions over SMS x SCHEDULERS a
    cycle at the maximum clock), the bytes floor and, once `dep_ns` is
    set, the latency floor (the dependent chain a repeat at dep_ns a
    dependent instruction).

    What a repeat costs comes from the difference of the two times, over
    k, whatever the launch's fixed costs: at one warp an SM the ns of a
    dependent repeat, at full occupancy the card's G repeats/s. At the
    JAX scripts' shape the launch is short, so it is timed at k alone and
    its numbers are those of the whole launch: ns a block-repeat (a block
    of 2048 lanes, as the scripts count) and G repeats/s."""

    def __init__(self, device):
        self.device = device
        self.card = card(device)
        self.dep_ns = None
        self.pipe = None  # pipe_rates' answer, once calibrated on the card
        self.calibrated = False
        self.records = []
        if device.type == "cuda":
            from ..utils import cuda_build, sass

            cuda_build.load()
            self.funcs = sass.functions(sass.dump(cuda_build.LIB_PATH))
            self.sms = torch.cuda.get_device_properties(device).multi_processor_count
            self.clock = sm_clock_hz()
            warm_up(device)

    def counts(self, kernel: str, *targs, repeats: int) -> dict:
        from ..utils import sass

        return sass.loop_counts(self.funcs, kernel, *targs, repeats=repeats)

    def pipe_floor(self, kernel: str, targs: tuple, repeats: int) -> dict:
        """sass.pipe_floor of the kernel's repeat loop at the rates and
        pipes this meter measured (pipe_rates)."""
        from ..utils import sass

        body = sass.loop_body(self.funcs[sass.kernel_name(self.funcs, kernel, *targs)])
        return sass.pipe_floor(body, self.pipe["rates"], self.pipe["pipes"], repeats)

    def case(self, name: str, kernel: str, targs: tuple, shape: dict, run, plain,
             n_bytes: int, repeats: int) -> dict:
        """run(k) launches the kernel, plain(k) its plain version on the
        same inputs. repeats: the repeats one pass of the kernel's loop
        holds."""
        lanes, threads, k = shape["lanes"], shape["threads"], shape["k"]
        cuda = self.device.type == "cuda"
        two_k = cuda and shape["shape"] != "script"
        ks = (k, 2 * k) if two_k else (k,)
        err = 0.0
        for kk in ks:
            for g, w in zip(_outputs(run(kk)), _outputs(plain(kk))):
                if g.dtype.is_floating_point:
                    err = max(err, float((g - w).abs().max()))
                if not torch.equal(g, w):
                    raise AssertionError(f"{name} ({shape['shape']}, k={kk}): the "
                                         "kernel differs from its plain version")
        rec = dict(name=name, kernel=kernel, shape=shape["shape"], lanes=lanes,
                   threads=threads, k=k, checked_k=list(ks), max_abs_err=err)
        if not cuda:
            print(f"{name:36s} {lanes} lanes x {k}: == plain version "
                  f"[{self.card}]", flush=True)
            self.records.append(rec)
            return rec
        ms, *ms2 = best_ms([lambda kk=kk: run(kk) for kk in ks])
        c = self.counts(kernel, *targs, repeats=repeats)
        warp_instr = lanes / 32 * k * c["per_repeat"]
        issue_ms = warp_instr / (self.sms * SCHEDULERS * self.clock) * 1e3
        bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        rec.update(ms=ms, sass_per_repeat=c["per_repeat"],
                   chain_per_repeat=c["chain_per_repeat"], sass_body=c["body"],
                   issue_floor_ms=issue_ms, bytes_floor_ms=bytes_ms,
                   bound_ms=max(issue_ms, bytes_ms),
                   bound_by="operations" if issue_ms >= bytes_ms else "bytes")
        pipe = ""
        if self.pipe is not None:
            pf = self.pipe_floor(kernel, targs, repeats)
            rec.update(pipe_clocks_per_repeat=pf["clocks"], busiest_pipe=pf["pipe"],
                       pipe_floor_ms=lanes / 32 * k * pf["clocks"] / (self.sms * self.clock)
                       * 1e3, unclassified_per_repeat=pf["unclassified"])
            rec["pipe_share"] = rec["pipe_floor_ms"] / ms
            pipe = (f", pipe ({pf['pipe']}) {rec['pipe_floor_ms']:.4f} ms "
                    f"({rec['pipe_share']:.1%} of the launch; issue {issue_ms / ms:.1%})")
        if self.dep_ns is not None:
            rec["latency_floor_ms"] = k * c["chain_per_repeat"] * self.dep_ns * 1e-6
        if shape["shape"] == "script":
            rec["plain_ms"] = timed(lambda: plain(k), reps=1)[1]
            rec["ns_per_block_repeat"] = ms * 1e6 / (k * lanes / 2048)
            rec["g_repeats_per_s"] = lanes * k / (ms * 1e-3) / 1e9
            blocks = -(-lanes // threads)
            rec["empty_launch_ms"] = best_ms(
                [lambda: probes.empty_launch(blocks, threads, self.device)])[0]
            what = (f"{rec['ns_per_block_repeat']:9.3f} ns a block-repeat, "
                    f"{rec['g_repeats_per_s']:9.2f} G repeats/s (whole launch; an empty "
                    f"launch of the grid {rec['empty_launch_ms']:.4f} ms)")
        else:
            rec["ms_2k"] = ms2[0]
            slope = ms2[0] - ms
            rec["ns_per_repeat"] = slope * 1e6 / k
            rec["g_repeats_per_s"] = lanes * k / (slope * 1e-3) / 1e9
            rec["slope_issue_share"] = issue_ms / slope
            if "pipe_floor_ms" in rec:
                rec["slope_pipe_share"] = rec["pipe_floor_ms"] / slope
            what = (f"{rec['ns_per_repeat']:9.3f} ns a dependent repeat "
                    f"({rec['ns_per_repeat'] * self.clock * 1e-9:.1f} cycles)"
                    if shape["shape"] == "one warp an SM" else
                    f"{rec['g_repeats_per_s']:9.2f} G repeats/s (slope share: issue "
                    f"{rec['slope_issue_share']:.1%}"
                    + (f", pipe {rec['slope_pipe_share']:.1%}" if "slope_pipe_share" in rec
                       else "") + ")")
        print(f"{name:26s} {shape['shape']:14s} {lanes:6d} x {k:4d}: == plain at "
              f"{' and '.join(map(str, ks))}; "
              f"{ms:9.4f} ms, {what}; SASS {c['per_repeat']:.2f} a repeat (chain "
              f"{c['chain_per_repeat']:.2f}); floors: issue {issue_ms:.4f} ms{pipe}, bytes "
              f"{bytes_ms:.4f} ms"
              + (f", latency {rec['latency_floor_ms']:.4f} ms"
                 if "latency_floor_ms" in rec else "")
              + f" [{self.card}]", flush=True)
        self.records.append(rec)
        return rec


# ---------------------------------------------------------------------------
# The SM's pipes (pipe_probe)
# ---------------------------------------------------------------------------

PIPE_REPEATS = 256  # pipe_probe's repeats at full occupancy (and 2k)
CPU_PIPE_REPEATS = 16
# a pair shares one pipe where it takes at least this share of its two
# classes' clocks added (else its classes issue side by side, if not
# perfectly: the floor keeps the side-by-side clocks, a lower bound)
ONE_PIPE_SHARE = 0.95
PURE = 0.9  # a class alone whose pass is at least this share of it


def pipe_rates(device, funcs=None, sms: int = 0, clock: float = 0.0, card: str = "",
               seed: int = 0, k: int = PIPE_REPEATS) -> dict:
    """pipe_probe's pairs (probes.PIPE_PAIRS), each == its plain version at
    k and 2k first (on the CPU at CPU_LANES lanes and CPU_PIPE_REPEATS, with
    no time). On the card at full occupancy (SMs x 2048 lanes, 256 threads):
    the least of 3 trains of 10 launches at k and 2k; the slope gives the
    SM-clocks a warp-pass takes at the maximum clock; a class alone gives its
    rate, its instructions a pass (from the pass's SASS) over those clocks
    (less the clocks of the pass's other classes of the same pipe at their
    rates: those of the passes that are at least PURE their own class, and
    for the others, whose passes hold each other's classes, three rounds of
    the same): the warp
    instructions an SM issues a clock; a pair is measured against
    the two classes' clocks added (one pipe) and against the larger of them
    and the issue floor (side by side), and shares one pipe where it takes
    at least ONE_PIPE_SHARE of the clocks added. Each pair's record also
    has its issue and bytes floors at k and its plain version's ms. Returns
    {"rates": {class: rate}, "pairs": {"A+B": record}, "pipes": sass.PIPES,
    "disagree": the pairs whose call differs from sass.PIPES} ({} rates on
    the CPU)."""
    from ..utils import sass

    rng = np.random.default_rng(seed)
    t_start = time.perf_counter()
    cuda = device.type == "cuda"
    lanes = sms * 2048 if cuda else CPU_LANES
    k = k if cuda else CPU_PIPE_REPEATS
    out = dict(rates={}, pairs={}, pipes=dict(sass.PIPES), disagree=[])
    timed_pairs = []
    for a, b in probes.PIPE_PAIRS:
        x0 = probes.pipe_inputs(a, b, lanes, rng, device)
        for kk in ((k, 2 * k) if cuda else (k,)):
            if not torch.equal(probes.pipe_probe(a, b, x0, k=kk),
                               probes.pipe_probe_plain(a, b, x0, kk)):
                raise AssertionError(f"pipe_probe {a}+{b} (k={kk}) differs from its plain "
                                     "version")
        if not cuda:
            continue
        ms = best_ms([lambda kk=kk: probes.pipe_probe(a, b, x0, k=kk) for kk in (k, 2 * k)])
        names = (sass.kernel_name(funcs, "pipe_probe_kernel", probes.PIPE_CLASSES.index(a),
                                  probes.PIPE_CLASSES.index(b)))
        body = sass.loop_body(funcs[names])
        counts = sass.class_counts(body)
        passes = k // probes.PIPE_UNROLL
        clocks = (ms[1] - ms[0]) * 1e-3 * clock * sms / (lanes / 32 * passes)
        issue_ms = lanes / 32 * passes * len(body) / (sms * SCHEDULERS * clock) * 1e3
        rec = dict(ms_k=ms[0], ms_2k=ms[1], clocks_per_pass=clocks, counts=counts,
                   body=len(body), k=k, lanes=lanes, issue_floor_ms=issue_ms,
                   bytes_floor_ms=17 * 4 * lanes / HBM_BYTES_PER_S * 1e3,
                   plain_ms=timed(lambda: probes.pipe_probe_plain(a, b, x0, k), reps=1)[1])
        out["pairs"][f"{a}+{b}"] = rec
        timed_pairs.append((a, b, rec))
    # a class alone: its rate over its pass's clocks; where the compiler put
    # other classes of the same pipe into the pass (the compares' predicate
    # moves), their clocks at their own rates come off first
    singles = [(a, rec) for a, b, rec in timed_pairs if a == b]
    pure = [(a, rec) for a, rec in singles if rec["counts"].get(a, 0) >= PURE * rec["body"]]
    impure = [x for x in singles if x not in pure]
    for a, rec in pure:
        rec["others_clocks"] = 0.0
        out["rates"][a] = rec["counts"].get(a, 0) / rec["clocks_per_pass"]
    for _ in range(3):  # the impure classes' rates depend on each other's
        for a, rec in impure:
            rec["others_clocks"] = sum(
                n / out["rates"][o] for o, n in rec["counts"].items()
                if o != a and o in out["rates"] and sass.PIPES.get(o) == sass.PIPES.get(a))
            out["rates"][a] = rec["counts"].get(a, 0) / (rec["clocks_per_pass"]
                                                         - rec["others_clocks"])
    for a, rec in singles:
        others = rec["others_clocks"]
        print(f"[pipe] {a:9s} alone: {rec['counts'].get(a, 0)} a pass of {rec['body']}, "
              f"{rec['clocks_per_pass']:.2f} SM-clocks a warp-pass (the pass's other "
              f"classes of its pipe {others:.2f}): {out['rates'][a]:.3f} warp instructions "
              f"an SM a clock [{card}]", flush=True)
    for a, b, rec in timed_pairs:
        if a == b:
            continue
        na, nb = rec["counts"].get(a, 0), rec["counts"].get(b, 0)
        one = na / out["rates"][a] + nb / out["rates"][b]
        side = max(na / out["rates"][a], nb / out["rates"][b], rec["body"] / SCHEDULERS)
        rec.update(one_pipe_clocks=one, side_by_side_clocks=side,
                   call="one pipe" if rec["clocks_per_pass"] >= ONE_PIPE_SHARE * one
                   else "side by side")
        table = "one pipe" if sass.PIPES[a] == sass.PIPES[b] else "side by side"
        if rec["call"] != table:
            out["disagree"].append(f"{a}+{b}")
        print(f"[pipe] {a}+{b}: {na} + {nb} a pass, {rec['clocks_per_pass']:.2f} SM-clocks a "
              f"warp-pass; one pipe {one:.2f}, side by side {side:.2f}: {rec['call']} "
              f"(sass.PIPES: {table}) [{card}]", flush=True)
    if cuda:
        print(f"[pipe] {len(timed_pairs)} pairs in {time.perf_counter() - t_start:.1f} s "
              f"[{card}]", flush=True)
    return out


def stage_loop_times(stage: int, slots: list, T: int, warps: int) -> tuple:
    """(the times a warp runs each loop of the probe body by stage's lane
    body, the times it enters each loop's guard), in address order, a
    warp-lane's mean on a launch's lanes: each walk loop its slots as the
    warps run them and its guard (the walk's start) where a lane of the
    warp meets the walk's node (probes.stage_slots; stage 4's one walk loop
    all T walks'), stage 4's level loop T times, entered once, before it."""
    runs = [s["warp_slots"] / warps for s in slots]
    ins = [s["warps_in"] / warps for s in slots]
    if stage == 4:
        return [float(T), sum(runs)], [1.0, sum(ins)]
    return runs, ins


def lane_floor(funcs: dict, kernel: str, targs: tuple, *, grid_stride: bool, times=(),
               entries=(), lanes: int, pipe: dict, sms: int, clock: float) -> dict:
    """A lane kernel's SASS a warp-lane (utils/sass.lane_split: its lane
    body's instructions once, each loop's as many times as `times` gives
    it, each loop's guard as `entries` gives it) and the pipe floor of
    `lanes` lanes at the measured rates (sass.pipe_floor): {"instructions",
    "pipe_floor_ms", "issue_floor_ms", "busiest_pipe", "by_pipe", "loops",
    "loop_sizes", "guard_sizes", "straight"}; "pipe_floor_ms" None where
    the lane body's loops are not as many as `times` (the compiler unrolled
    or split one)."""
    from ..utils import sass

    body, inner, guards = sass.lane_split(funcs[sass.kernel_name(funcs, kernel, *targs)],
                                          grid_stride)
    rec = dict(loops=len(inner), loop_sizes=[len(b) for b in inner],
               guard_sizes=[len(g) for g in guards], straight=len(body))
    if len(inner) != len(times):
        rec.update(instructions=None, pipe_floor_ms=None, issue_floor_ms=None,
                   busiest_pipe=None, by_pipe=None)
        return rec
    pf = sass.pipe_floor(body, pipe["rates"], pipe["pipes"],
                         loops=tuple(zip(inner, times)) + tuple(zip(guards, entries)))
    rec.update(instructions=pf["instructions"], busiest_pipe=pf["pipe"], by_pipe=pf["by_pipe"],
               pipe_floor_ms=lanes / 32 * pf["clocks"] / (sms * clock) * 1e3,
               issue_floor_ms=lanes / 32 * pf["issue_clocks"] / (sms * clock) * 1e3)
    return rec


# ---------------------------------------------------------------------------
# The 2D gather probes' cases (dyngather_probe2.py, gather_probe3.py)
# ---------------------------------------------------------------------------

# the kernels the two gather scripts launch in their cases (the copy shell
# as the yardstick beside each take-along gather)
GATHER_CASE_KERNELS = probes.GATHER_KERNELS + ("shell_copy_probe",)
SECTOR_BYTES = 32  # what one access moves between HBM, L2 and L1
COLD_L2S = 4       # L2s of other data that pass between two reads of one input


def gather_case_launches() -> int:
    return sum(probes.LAUNCHES[k] for k in GATHER_CASE_KERNELS)


def l2_bytes(device) -> int:
    """The card's L2 cache (50 MiB, an H100 SXM's, where torch does not say)."""
    return getattr(torch.cuda.get_device_properties(device), "L2_cache_size", 50 << 20)


def cold_copies(tensors: tuple, device) -> list:
    """`tensors` and copies of them, enough that, taken in turn, COLD_L2S
    of the card's L2 of other copies pass between two uses of one: each
    use reads its inputs from HBM."""
    n_bytes = sum(t.numel() * t.element_size() for t in tensors)
    n = 2 + math.ceil(COLD_L2S * l2_bytes(device) / n_bytes)
    return [tuple(tensors)] + [tuple(t.clone() for t in tensors) for _ in range(n - 1)]


def in_turn(fn, sets: list):
    """A function of no arguments that calls fn on the next of `sets`,
    round and round."""
    it = itertools.cycle(sets)
    return lambda: fn(*next(it))


def l2_flush(device):
    """A function that evicts the L2: it reads and writes COLD_L2S L2s."""
    buf = torch.zeros(COLD_L2S * l2_bytes(device) // 4, dtype=torch.float32, device=device)
    return lambda: buf.add_(1.0)


def smem_refusal(call, need: int, device):
    """(call(), None); or (None, the ValueError) where call raises one and
    `need` bytes of shared memory exceed what a block of `device` can opt
    in to: the refusal is then the probe's answer. Any other error
    propagates."""
    try:
        return call(), None
    except ValueError as e:
        if device.type != "cuda" or need <= probes.smem_optin_bytes(device):
            raise
        return None, e


def take_along_bytes(t, idx, *, axis: int, mod: int, c_out: int) -> int:
    """The bytes a take-along gather must move on this run's indices: each
    32-byte sector of t that an index reaches, idx[:, :, :c_out] and the
    output, each once. (A staged tile moves all of t: that is the form's
    cost, not the function's.)"""
    B, R, C = t.shape
    r = idx.shape[1]
    x = idx[:, :, :c_out].long()
    if mod:
        x = torch.remainder(x, mod)
    at = torch.arange(B, device=x.device)[:, None, None] * (R * C)
    if axis == 1:
        at = at + torch.arange(r, device=x.device)[None, :, None] * C + x
    else:
        at = at + x * C + torch.arange(c_out, device=x.device)[None, None, :]
    sectors = torch.unique(at // (SECTOR_BYTES // 4)).numel()
    return SECTOR_BYTES * sectors + 2 * 4 * B * r * c_out


def gather_case(name: str, t, idx, *, axis: int, mod: int, form: str, c_out: int,
                card: str = "", refusable: bool = False) -> dict:
    """One take-along case on t / idx (already on the device): the kernel
    against its plain version, then (on the card) its time, torch.gather's,
    the copy shell's on the same bytes, and the bytes bound at the HBM rate;
    its launches of all GATHER_CASE_KERNELS and of take_along_probe alone.
    Every timed launch reads its inputs from HBM: one tile after the L2 is
    flushed (the median of 10 launches), a batch from copies taken in turn
    (cold_copies). A shared-memory
    refusal is the case's answer only where `refusable` and the tile exceeds
    the block's opt-in limit; any other error propagates."""
    dev = idx.device
    cuda = dev.type == "cuda"
    B = t.shape[0]
    n_bytes = take_along_bytes(t, idx, axis=axis, mod=mod, c_out=c_out)
    rec = dict(name=name, form=form, batch=B, bytes=n_bytes)
    before = gather_case_launches()
    before_taa = probes.LAUNCHES["take_along_probe"]

    def run(tt, xx):
        return probes.take_along_probe(tt, xx, axis=axis, mod=mod, form=form, c_out=c_out)

    need = t.shape[1] * t.shape[2] * 4
    got, refused = (smem_refusal(lambda: run(t, idx), need, dev) if refusable
                    else (run(t, idx), None))
    if refused is not None:
        rec.update(refused=True, launches=gather_case_launches() - before,
                   take_along_launches=probes.LAUNCHES["take_along_probe"] - before_taa,
                   smem_bytes=need, optin_bytes=probes.smem_optin_bytes(dev))
        print(f"{name:30s} {form:6s} B={B:5d}: refused, the {need}-byte tile is over the "
              f"{rec['optin_bytes']} bytes a block can have [{card}]", flush=True)
        return rec
    want = probes.take_along_plain(t, idx, axis=axis, mod=mod, c_out=c_out)
    if not torch.equal(got, want):
        raise AssertionError(f"{name} ({form}, B={B}): the kernel differs from its plain "
                             "version")
    rec["refused"] = False
    if cuda:
        x = idx[:, :, :c_out].long()
        red = torch.remainder(x, mod) if mod else x
        gathered = torch.empty_like(got)

        def library(tt, rr):
            return torch.gather(tt, 2 if axis == 1 else 1, rr, out=gathered)

        if not torch.equal(library(t, red), want):
            raise AssertionError(f"{name}: torch.gather differs from the plain version")
        copy = torch.zeros(max(n_bytes // 8, 4), dtype=torch.float32, device=dev)
        cases = ((run, (t, idx)), (library, (t, red)), (probes.shell_copy_probe, (copy,)))
        if B == 1:
            flush = l2_flush(dev)
            ms, lib_ms, shell_ms = (event_ms_median(lambda _, f=f, a=a: f(*a), flush)
                                    for f, a in cases)
        else:
            ms, lib_ms, shell_ms = best_ms([in_turn(f, cold_copies(a, dev))
                                            for f, a in cases])
        plain_ms = timed(lambda: probes.take_along_plain(
            t, idx, axis=axis, mod=mod, c_out=c_out), reps=1, warm=False)[1]
        b_ms, b_by = bound(n_bytes, 0)
        rec.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, shell_ms=shell_ms,
                   bound_ms=b_ms, bound_by=b_by)
        print(f"{name:30s} {form:6s} B={B:5d}: == plain; {ms * 1e3:9.3f} us a launch, "
              f"bound {b_ms * 1e3:.3f} us ({n_bytes} B), torch.gather {lib_ms * 1e3:.3f} "
              f"us, copy shell on the same bytes {shell_ms * 1e3:.3f} us, plain "
              f"{plain_ms:.3f} ms [{card}]", flush=True)
    else:
        print(f"{name:30s} {form:6s} B={B:5d}: == plain version [{card}]", flush=True)
    rec["launches"] = gather_case_launches() - before
    rec["take_along_launches"] = probes.LAUNCHES["take_along_probe"] - before_taa
    return rec


# ---------------------------------------------------------------------------
# The scene scripts (scale_demo, rebuild_timing, pt_step_timing,
# pt_phase_attrib): camera, sky, frame rays, bound, profile
# ---------------------------------------------------------------------------

def script_camera(lower, extent: float, fovy_deg: float = 40.0):
    """The reference scripts' camera: from lower + extent / 2 + (0.9, 0.4,
    1.4) * extent * 0.9 toward the box's center."""
    from ..ops import camera as camera_ops

    center = np.asarray(lower, np.float32) + extent / 2
    return camera_ops.Camera.look_at(
        eye=center + np.array([0.9, 0.4, 1.4]) * extent * 0.9,
        target=center, fovy_deg=fovy_deg)


def sky_img() -> np.ndarray:
    """The reference scripts' procedural sky (64 x 128, f32 RGB), so that
    NEE shadow rays are real work."""
    h, w = 64, 128
    ang = np.linspace(0, np.pi, h)[:, None]
    return np.stack([
        np.broadcast_to(0.6 + 0.4 * np.cos(ang), (h, w)),
        np.broadcast_to(0.7 + 0.3 * np.cos(ang), (h, w)),
        np.broadcast_to(0.9 + 0.1 * np.cos(ang), (h, w)),
    ], -1).astype(np.float32)


def camera_rays(cam, width: int, height: int, device) -> tuple:
    """(ro, rd): the tile-major rays render_frame traces for this camera
    (raycast.gen_rays: the ray kernel on the card)."""
    from ..models import raycast

    return raycast.gen_rays(raycast.camera_of(cam), 0, width=width, height=height,
                            band_tile_rows=-(-height // raycast.TILE), device=device)


def frame_bound(tree, ro, rd) -> dict:
    """hako_mega's least time on these rays of a HakoTree: the rows its
    traversal reads (hako_mega.rows_touched) and the bytes and float ops
    they need (traversal_traffic), over the card's rates."""
    from ..ops import hako_mega

    (bricks, snodes, tabs, root), T = hako_mega.hako_mega_args(tree)
    args = (bricks, snodes, tabs, root, tree.lower, tree.upper, ro, rd)
    distinct, visits = hako_mega.rows_touched(*args, T=T)
    n_bytes, n_ops = hako_mega.traversal_traffic(
        ro.shape[0], distinct, visits, sum(t.shape[0] for t in tabs))
    b_ms, b_by = bound(n_bytes, n_ops)
    return dict(rays=int(ro.shape[0]), distinct_rows=distinct, row_visits=visits,
                bytes=n_bytes, ops=n_ops, bound_ms=b_ms, bound_by=b_by)


# The frame's stages (models/raycast.py, csrc/frame.cu): float32
# operations a lane, counted from the plain stages' code: ray generation
# ~5 for u, ~4 for v and 12 for rd; the shade ~10 (the normal or the
# colour's three scales, the pixel's multiply-add and clamp).
RAYGEN_OPS = 21
SHADE_OPS = 10


def raygen_bound(n_lanes: int) -> tuple:
    """frame_raygen on n_lanes lanes: it reads nothing (the camera comes by
    value) and writes ro and rd, 24 B a lane."""
    return bound(24 * n_lanes, RAYGEN_OPS * n_lanes)


def shade_bound(t, nmaj, vidx, show_color: bool, color_table, lanes=None) -> tuple:
    """frame_shade on the lanes it shades (all, or the bool mask `lanes`,
    the output pixels' lanes): every pixel reads t (4 B) and writes its
    RGB8 and depth (7 B); a hit pixel reads nmajor and rd (16 B), or vidx
    (4 B) and its colour, each distinct table entry once (4 B)."""
    if lanes is None:
        lanes = torch.ones_like(t, dtype=torch.bool)
    n = int(lanes.sum())
    hit = lanes & (t < 1e37)
    n_hit = int(hit.sum())
    if show_color:
        extra = 4 * n_hit + _touched(color_table, vidx[hit])
    else:
        extra = 16 * n_hit
    return bound(11 * n + extra, SHADE_OPS * n)


# The walks' float32 operations a visit (an active lane's iteration),
# counted from the plain bodies as a lower bound: the brick walk's 15
# cell planes (4 each), the v2 walk's 6 planes (2 each) and its 8
# octants' entry / exit max / min (4 each).
WALK_VISIT_OPS = {"brick": 60, "octree": 44}
# the bytes of a node's row a visit must read: the brick walk's 16 B row;
# the v2 walk's children[c] and psum[c], two words in two 32 B sectors of
# the 64 B row (children[c] alone for a shadow ray)
WALK_ROW_BYTES = {"brick": 16, "octree": 64, "octree_shadow": 32}


def walk_rows(kind: str, depth, meta, root, lower, upper, ro, rd, shadow: bool = False) -> dict:
    """What the brick or v2 walk of these rays reads, off the plain walk:
    `entered` (rays entering the box), `rows` (distinct rows) and `visits`
    (row visits: every active lane stands on one node an iteration and
    reads its row; a v2 lane that finds no child pops without reading it,
    so this counts at most one row more a lane and visit). For the brick
    walk also `bits`, the set bits of the visited nodes' masks (the cells
    a selection over the whole mask tests a visit), and `cells`, the occupied cells of
    bricktree.crossed_cells_plain's mask (the most the current selection
    tests a visit; a visit that returns to a node tests fewer). For the v2
    walk also traverse2.fold_counts' decisions (descends, hits, misses,
    stays, pops, empty first visits, return visits; the occupied and the
    crossed-and-occupied octants over all visits) and `trips`, the
    octree_walk_kernel's loop trips over the rays that enter."""
    from ..ops import bricktree, traverse2
    from ..ops.bits import MASK32, popcount32

    n_rows = meta.shape[0]
    seen = torch.zeros(n_rows, dtype=torch.bool, device=meta.device)
    out = dict(entered=0, rows=0, visits=0)
    if kind == "brick":
        out.update(bits=0, cells=0)
        quarters = torch.arange(5, dtype=torch.float32, device=meta.device)

    def on_step(st):
        if out["entered"] == 0:
            out["entered"] = int(st["lane"].shape[0])  # the lanes that entered
        act = st["active"]
        node = st["node"][act]
        if kind == "octree":
            node = node & 0xFFFFFF
        row = torch.clamp(node, 0, n_rows - 1)
        seen[row] = True
        out["visits"] += int(node.shape[0])
        if kind == "brick":
            mask = (meta[row, 0].to(torch.int64) & MASK32) | (meta[row, 1].to(torch.int64) << 32)
            planes = bricktree._cell_planes(*(st[k][act] for k in (
                "t1x", "t1y", "t1z", "dtx", "dty", "dtz", "scale")), quarters)[:3]
            both = mask & bricktree.crossed_cells_plain(*planes, st["vmask"][act])
            for m, key in ((mask, "bits"), (both, "cells")):
                out[key] += int((popcount32(m & MASK32) + popcount32((m >> 32) & MASK32)).sum())

    if kind == "brick":
        bricktree.intersect_rays_brick_plain(meta, root, lower, upper, ro, rd,
                                             n_levels=depth, shadow=shadow, on_step=on_step)
    else:
        fold = traverse2.fold_counts(meta, root, lower, upper, ro, rd, stack_depth=depth,
                                     shadow=shadow, on_step=on_step)
        entered = fold["end_it"] >= 0  # a ray that does not enter takes one trip to end
        out.update({k: fold[k] for k in traverse2.FOLD_EVENTS},
                   trips=int(fold["trips"][entered].sum()))
    out["rows"] = int(seen.sum())
    return out


def visit_note(rows: dict) -> str:
    """What a visit of the brick or v2 walk tests, off walk_rows."""
    visits = max(rows["visits"], 1)
    if "bits" in rows:
        return (f"a visit {rows['bits'] / visits:.2f} set bits (a scan of the whole mask) vs "
                f"{rows['cells'] / visits:.2f} crossed and occupied cells (at most, the "
                f"current one)")
    rays = max(rows["entered"], 1)
    return (f"a visit {rows['occupied'] / visits:.2f} occupied octants (a scan of each) vs "
            f"{rows['crossed'] / visits:.2f} crossed and occupied; a ray {visits / rays:.2f} "
            f"plain iterations vs {rows['trips'] / rays:.2f} loop trips (the current one); "
            f"{rows['descends']} descends, {rows['empty_first']} into a child with nothing, "
            f"{rows['hits']} hits, {rows['stays']} stays behind the origin, {rows['pops']} "
            f"pops, {rows['return_visits']} return visits")


def walk_bound(kind: str, n_rays: int, rows: int, visits: int, shadow: bool = False) -> tuple:
    """The brick or v2 walk on n_rays rays: each reads its ro / rd (24 B)
    and writes t, nmajor and vidx (12 B); each distinct row it reaches is
    read once (WALK_ROW_BYTES); WALK_VISIT_OPS float ops a visit."""
    key = "octree_shadow" if kind == "octree" and shadow else kind
    return bound(36 * n_rays + WALK_ROW_BYTES[key] * rows, WALK_VISIT_OPS[kind] * visits)


def profile_call(fn, pad_s: float = 0.0, names: tuple = ()) -> dict:
    """fn() under torch.profiler on the card, the session held open `pad_s`
    of idle host time before the call and after it: wall ms (host clock,
    synced, the call alone), device busy ms (the sum of the device events),
    its idle share, the hako_mega kernels' ms, the device kernels launched,
    the top 8 by time as (name, ms, calls), and each sample-chain,
    scene-build, frame, walk and round kernel's (ms, calls), and those of
    `names` under "named".
    Reads the profiler's raw trace events: prof.events() would first build
    the host ops' call tree, about a minute of host time for a PT step's
    ~10^6 ops."""
    from torch.profiler import ProfilerActivity, profile

    from ..models import raycast
    from ..ops import traverse

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(pad_s)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        time.sleep(pad_s)
    busy_us = 0.0
    kernels = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            us = e.duration_ns() / 1e3
            busy_us += us
            ms, calls = kernels.get(e.name(), (0.0, 0))
            kernels[e.name()] = (ms + us / 1e3, calls + 1)
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:8]
    busy_ms = busy_us / 1e3
    def by_kernel(names):  # (ms, calls) of each named kernel, over its templates
        out = {}
        for k in names:
            hits = [v for name, v in kernels.items() if f"{k}_kernel" in name]
            out[k] = (sum(ms for ms, _ in hits), sum(calls for _, calls in hits))
        return out

    return dict(wall_ms=wall_ms, busy_ms=busy_ms, idle_share=1 - busy_ms / wall_ms,
                mega_ms=sum(ms for name, (ms, _) in kernels.items() if "hako_mega" in name),
                kernels=sum(calls for _ms, calls in kernels.values()),
                top=[(name[:70], ms, calls) for name, (ms, calls) in top],
                chain=by_kernel(pt_chain.KERNELS), vox=by_kernel(vox_ops.KERNELS),
                frame=by_kernel(raycast.KERNELS), walks=by_kernel(traverse.WALK_KERNELS),
                rounds=by_kernel(("hako_rounds", "hako_probe", "hako_dda_merge")),
                named=by_kernel(names))


# torch.profiler on the card drops a short session's device events, some
# or all, once the process has run for half a minute or so; which idle
# pads around the call keep them changes with the process and its age,
# and late in a long process none may (scripts/profile_window.py).
# profile_counted takes the profile again with the next pad until the
# trace holds what the wrappers counted.
PROFILE_PADS_S = (0.02, 0.2, 0.0, 0.05, 0.1, 0.5, 0.01, 0.3)


def profile_counted(fn, launches: dict, tries: int = len(PROFILE_PADS_S)) -> dict:
    """profile_call(fn), taken again with the next of PROFILE_PADS_S until
    the trace holds each kernel counted in `launches` (a wrapper module's
    counts, such as hako_kernels.LAUNCHES; the kernel named `<key>_kernel`)
    as often as that run of fn launched it. Adds "tries" and "pad_s".
    Raises if `tries` profiles all missed a launch. fn must be safe to run
    again."""
    for i in range(tries):
        before = dict(launches)
        pad = PROFILE_PADS_S[i % len(PROFILE_PADS_S)]
        r = profile_call(fn, pad_s=pad, names=tuple(launches))
        launched = {k: launches[k] - before[k] for k in launches}
        missed = {k: n - r["named"][k][1] for k, n in launched.items() if n != r["named"][k][1]}
        if not missed:
            return dict(r, tries=i + 1, pad_s=pad)
    raise AssertionError(f"{tries} profiles missed launches the wrappers counted: {missed} "
                         f"(last try's pad {pad} s)")


class LiveCounts(collections.abc.Mapping):
    """Launch counts read live for profile_counted: the wrapper modules'
    LAUNCHES dicts given, and hako_mega's count (an int the module
    rebinds at each launch)."""

    def __init__(self, *counts: dict):
        self.counts = counts

    def __getitem__(self, name):
        from ..ops import hako_mega

        if name == "hako_mega":
            return hako_mega.LAUNCHES
        for c in self.counts:
            if name in c:
                return c[name]
        raise KeyError(name)

    def __iter__(self):
        return iter((*(k for c in self.counts for k in c), "hako_mega"))

    def __len__(self):
        return len(tuple(iter(self)))


def step_counts() -> LiveCounts:
    """The PT step's launch counts: the sample chain's kernels and
    hako_mega."""
    return LiveCounts(pt_chain.LAUNCHES)


def profile_or_none(fn, launches, what: str, card: str = ""):
    """profile_counted(fn, launches), or None where every try missed a
    launch the wrappers counted: then `what` is printed as not measured."""
    try:
        return profile_counted(fn, launches)
    except AssertionError as e:
        print(f"{what}: not measured ({e}) [{card}]", flush=True)
        return None


# The sample chain's stages (ops/pt_chain.py): float32-equivalent operations
# a lane, counted from the plain stages' code as a lower-bound yardstick
# (integer hashing priced at the float32 rate, a float64 sin / cos / atan2
# as 20): lane setup ~2 PMJ draws (~110 integer ops each) and the thin
# lens; the primary shade an atan2 pair on a miss; the bounce sample 4
# draws, 8 trig calls and two cosine frames; the shade and the gather a
# few dozen.
CHAIN_OPS = {"pt_lane_init": 300, "pt_primary_shade": 80, "pt_bounce_sample": 800,
             "pt_bounce_shade": 60, "pt_compact_gather": 0}


def _rows(x, lanes=None) -> int:
    """Bytes of x's per-lane rows ([R] or [R, k]) on the lanes of the bool
    mask `lanes` (all when None); 0 for None."""
    if x is None:
        return 0
    row = x.element_size() * (x.numel() // max(x.shape[0], 1))
    return row * (x.shape[0] if lanes is None else int(lanes.sum()))


def _touched(table, idx, row_bytes: int | None = None) -> int:
    """Bytes of the distinct rows of `table` that the indices read,
    clamped into it as the stages' clip takes do."""
    n = table.shape[0]
    row = row_bytes if row_bytes is not None else table.element_size() * (table.numel() // n)
    return int(torch.unique(torch.clamp(idx.long(), 0, n - 1)).numel()) * row


def _pmj_touched(pmj_table, stream, spp, dims) -> int:
    """Bytes of the distinct PMJ points (8 bytes each) that the draws of
    dimensions `dims` read."""
    from ..ops import sampling

    lin = torch.cat([sampling.pmj_index(pmj_table, spp, d, stream)[0] for d in dims])
    return int(torch.unique(lin).numel()) * 8


def _sats_touched(env, n, u0, u1) -> int:
    """Bytes of the distinct prefix-table entries (int64) and texels that
    the sats backend's importance_sample reads for these lanes: every
    clipped take of its two binary searches, the texel's 2x2 corners and
    its pixel, recorded while it runs."""
    from ..ops import hdri as hdri_ops

    read = {}
    real = hdri_ops._take

    def take(flat, lin):
        read.setdefault(flat.data_ptr(), (flat, []))[1].append(lin.reshape(-1))
        return real(flat, lin)

    hdri_ops._take = take
    try:
        hdri_ops.importance_sample(env, n, u0, u1, torch.zeros_like(u0), torch.zeros_like(u0))
    finally:
        hdri_ops._take = real
    return sum(_touched(flat, torch.cat(idx)) for flat, idx in read.values())


def chain_bytes(name: str, args: tuple, kwargs: dict, out) -> int:
    """The bytes one call of a sample-chain stage's kernel must move on its
    inputs (`args` / `kwargs`, bound to the plain stage's parameter names)
    and outputs: each per-lane value on the lanes that need it, as the
    kernel reads it (what a lane's outcome does not use is not read), each
    table entry the lanes touch once, each output written once, a tensor
    passed through (bounce_shade's t, a PCG32 increment) not at all. The
    HDRI's tables are those of its backend: the alias tables (the main
    path's), or the prefix tables' entries that the binary searches read
    (_sats_touched)."""
    from ..ops import hdri as hdri_ops

    a = inspect.signature(getattr(pt_chain, name + "_plain")).bind(*args, **kwargs).arguments
    if name == "lane_init":
        stream, spp, pcg, ro, rd = out
        pix = (a["pix_start"] + torch.arange(a["pix_packet"], device=ro.device)) & 0xFFFFFFFF
        b = sum(nbytes(x) for x in a["cam"]) + _rows(stream) + _rows(spp) + _rows(ro) + _rows(rd)
        if a["pix_perm"] is not None:
            b += _touched(a["pix_perm"], pix)
        if pcg is None:
            b += _pmj_touched(a["pmj_table"], stream, spp, (0, 1))
        else:
            b += _rows(pcg[0]) + _rows(pcg[1])
        return b
    if name == "primary_shade":
        T, L, miss = out
        hit = ~miss
        b = _rows(a["t"]) + _rows(a["vidx"], hit) + _touched(a["emission_table"], a["vidx"][hit], 4)
        if a["hdri"]:
            y, x = hdri_ops.nearest_texel(a["env"], a["rd"][miss], primary=True)
            b += _rows(a["rd"], miss) + _touched(a["env"].pixels_primary.reshape(-1, 3),
                                                 y * a["env"].width_primary + x)
        return b + _rows(T) + _rows(L) + _rows(miss)
    if name == "bounce_sample":
        refl, hit_n, hit_p, rd_out, dir_e, dir_s, emissive, pdf, pcg_out = out
        alive, pcg, env = ~a["miss"], a["pcg"], a["env"]
        b = (_rows(a["miss"]) + _rows(a["vidx"]) + _touched(a["color_table"], a["vidx"], 4)
             + _rows(a["nmaj"]) + _rows(a["rd"]) + _rows(a["ro"], alive) + _rows(a["t"], alive))
        dims = list(range(a["dim"], a["dim"] + 2 * a["hdri"] + a["extra"] + 1))
        if pcg is None:
            b += _rows(a["stream"]) + _rows(a["spp"])
            b += _pmj_touched(a["pmj_table"], a["stream"], a["spp"], dims)
        else:
            b += _rows(pcg[0]) + _rows(pcg[1]) + _rows(pcg_out[0])
        if a["hdri"]:
            (u0, u1), _ = pt_chain.sample2d(a["pmj_table"], a["stream"], a["spp"], pcg,
                                            a["dim"])
            if env.use_alias:
                table = hdri_ops.select_table(env, hit_n, True)
                lin, texel = hdri_ops.alias_texel(env, table, u0, u1)
                nt = env.width * env.height
                b += (_touched(env.alias_prob.reshape(-1), lin)
                      + _touched(env.alias_idx.reshape(-1), lin)
                      + _touched(env.alias_pdf.reshape(-1), table * nt + texel)
                      + _touched(env.pixels.reshape(-1, 3), texel))
            else:
                b += _sats_touched(env, hit_n, u0, u1)
        return b + sum(_rows(x) for x in (refl, hit_n, hit_p, rd_out, dir_e, dir_s,
                                          emissive, pdf))
    if name == "bounce_shade":
        T, L, _t, nmaj, vidx, miss_o, key = out
        alive = ~a["miss"]
        new_hit = ~miss_o
        b = (_rows(a["miss"]) + _rows(a["T"]) + _rows(a["L"]) + _rows(a["refl"], alive)
             + _rows(a["t_b"], alive) + _rows(a["nm_b"], new_hit) + _rows(a["vi_b"], new_hit)
             + _rows(a["nmaj"], miss_o) + _rows(a["vidx"], miss_o)
             + nbytes(a["emission_scale"]))
        picked = [a["vi_b"][new_hit]]
        if a["dir_s"] is not None:
            vis = alive & (a["t_s"] >= 1e37)
            b += _rows(a["t_s"], alive) + sum(_rows(a[k], vis) for k in (
                "hit_n", "dir_s", "emissive", "pdf"))
        if a["t_e"] is not None:
            pick = alive & (a["t_e"] < 1e37)
            b += _rows(a["t_e"], alive) + _rows(a["v_e"], pick)
            picked.append(a["v_e"][pick])
        b += _touched(a["emission_table"], torch.cat(picked), 4)
        if key is not None:
            b += _rows(a["rd"], new_hit) + _rows(key)
        return b + _rows(T) + _rows(L) + _rows(nmaj) + _rows(vidx) + _rows(miss_o)
    if name == "compact_gather":
        return sum(_rows(x) for x in (*a.values(), *out))
    raise ValueError(f"no stage {name!r}")


def nbytes(x) -> int:
    return x.numel() * x.element_size()


def chain_bound(name: str, args: tuple, kwargs: dict, out) -> tuple:
    """(bound_ms, bound_by) of one call of a sample-chain stage's kernel:
    chain_bytes over the memory rate against CHAIN_OPS a lane."""
    n = flat_tensors(out)[0].shape[0]
    return bound(chain_bytes(name, args, kwargs, out), CHAIN_OPS["pt_" + name] * n)


def flat_tensors(xs) -> list:
    """The tensors of a nested tuple / list, in order (None skipped)."""
    out = []
    for x in xs:
        if isinstance(x, (tuple, list)):
            out += flat_tensors(x)
        elif isinstance(x, torch.Tensor):
            out.append(x)
    return out


# The scene build's stages (ops/voxelize.py): float32 operations counted
# from the plain stages' code as a lower-bound yardstick. A triangle's
# context ~190 (edges, normal, the voxel bbox, nine edge functions, the z
# slab's constants); a cell of its voxel bbox tested ~40 (its corner, its
# column's three major-axis edge functions and z range, the other two
# axes' six edge functions); a dumped voxel ~110 (the closest point's
# three cross products and dots, two colours mixed and packed); a sorted
# entry of the unique reduce ~8 (three channels unpacked and added a word),
# of the run heads' count ~2 (a compare with the key before it, a sum).
# The count and emit kernels walk units and the slab-clipped cells
# (vox_tested_cells), not the bbox: a unit ~22 (its column's corner 4,
# three major-axis edge functions 12, its z range 6), a tested cell ~26
# (its z corner 2, the other two axes' six edge functions 24).
VOX_CTX_OPS = 190
VOX_CELL_OPS = 40
VOX_UNIT_OPS = 22
VOX_TESTED_OPS = 26
VOX_EMIT_OPS = 110
VOX_ENTRY_OPS = 8
VOX_HEAD_OPS = 2


def vox_cells(tri, origin, dps, grid_res: int, cap: int) -> int:
    """The cells of the triangles' voxel bboxes, each axis clamped to the
    grid and to cap (the candidates the count and emit kernels test)."""
    lo = torch.clamp(torch.floor((tri.amin(1) - origin) / dps).to(torch.int32), min=0)
    hi = torch.clamp(torch.floor((tri.amax(1) - origin) / dps).to(torch.int32),
                     max=grid_res - 1)
    ext = torch.clamp(hi.to(torch.int64) - lo + 1, min=0, max=cap)
    return int(ext.prod(1).sum())


def vox_tested_cells(tri, origin, dps, grid_res: int, cap: int, six: bool = True,
                     chunk: int = 1 << 18) -> dict:
    """What the count and emit kernels test on these triangles
    (ops/voxelize.column_cells, a chunk of triangles at a time): their
    units (a column's run of up to 32 Z cells), the slab-clipped cells they
    test, and the valid cells among them."""
    units = cells = valid = 0
    for a in range(0, tri.shape[0], chunk):
        _, c = vox_ops.column_cells(tri[a:a + chunk], origin, dps, grid_res=grid_res,
                                    six_separating=six, cap=cap)
        units += c["units"]
        cells += len(c["tri"])
        valid += int(c["valid"].sum())
    return dict(units=units, cells=cells, valid=valid)


def vox_bound(stage: str, *, n_tri: int = 0, n_cells: int = 0, n_dumped: int = 0,
              n_sorted: int = 0, n_unique: int = 0, mode: str = "means",
              walk: dict | None = None, segments: bool = False) -> tuple:
    """(bound_ms, bound_by) of one call of a scene-build kernel on its
    call's data (n_cells: vox_cells of its triangles; with `walk`, the
    vox_tested_cells of its triangles, the count's and emit's cell work is
    that of their units and slab-clipped cells instead: the kernels' own
    bound, where the bbox cells are the yardstick that compares designs
    with a bbox cell loop). Bytes it must move:
    count, a triangle's 36 B in and its 4 B count out; emit, a triangle's
    vertices, colours and emissions (108 B) and its 8 B offset in, 16 B out
    a dumped voxel; the run heads' count, a sorted entry's key in and a
    tile's count out (int64); the unique reduce, the bound of the whole
    unique stage after the sort: a sorted entry's key, perm and attribute
    words (two int32, or the merge's seven int64) in, a unique voxel's
    outputs (the code and two packed means, or the code, six sums and the
    count) out. With `segments`, the unique reduce's bound also counts a
    sorted entry's boundary flag (1 B) and a unique voxel's segment id
    (8 B), the inputs of the earlier design that walked a run a thread:
    the yardstick that compares designs. Operations: the VOX_*_OPS counts."""
    cell_ops = (VOX_CELL_OPS * n_cells if walk is None else
                VOX_UNIT_OPS * walk["units"] + VOX_TESTED_OPS * walk["cells"])
    if stage == "vox_count":
        n_bytes = n_tri * (36 + 4)
        ops = VOX_CTX_OPS * n_tri + cell_ops
    elif stage == "vox_emit":
        n_bytes = n_tri * (108 + 8) + n_dumped * 16
        ops = VOX_CTX_OPS * n_tri + cell_ops + VOX_EMIT_OPS * n_dumped
    elif stage == "vox_run_heads":
        n_bytes = n_sorted * 8 + -(-n_sorted // vox_ops.UNIQUE_TILE) * 8
        ops = VOX_HEAD_OPS * n_sorted
    elif stage == "vox_unique_reduce":
        attrs = 7 * 8 if mode == "merge" else 2 * 4
        outs = 8 + (7 * 8 if mode == "sums" else 2 * 4)
        n_bytes = n_sorted * (8 + 8 + attrs) + n_unique * outs
        if segments:
            n_bytes += n_sorted * 1 + n_unique * 8
        ops = VOX_ENTRY_OPS * n_sorted
    else:
        raise ValueError(f"no scene-build kernel {stage!r}")
    return bound(n_bytes, ops)
