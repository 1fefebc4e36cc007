"""Plain PyTorch versions of the HakoTree traversal's shared device
functions (the reference's ops/hako_kernels.py), as masked lockstep tensor
code over lanes.

The reference inlines these into its Pallas megakernel; here they are the
megakernel's plain version (ops/hako_mega.py) and the arithmetic the CUDA
kernel (csrc/hako_device.cuh) reproduces line for line. Every float
expression keeps the reference's operation order, and each torch op rounds
on its own, so no multiply-add is contracted: every cell plane is
`t1 - dc * (4 - k)` (`_plane`), and exact float equality between planes
decides the face axis, walk ties and resume keys.

Layout: per-axis quantities are stacked as [3, N] tensors (x, y, z rows);
lane integers are int64; u32 masks arrive as int32 bit patterns and are
widened (sign-extended) to int64 -- single-bit tests are unaffected and
popcounts mask to 32 bits first. The reference's TPU node-fetch forms and
`_fold_select` become direct tensor indexing.
"""

from __future__ import annotations

import ctypes

import torch

from .bits import MASK32, popcount32

MAX_FLOAT = 3.402823466e38  # rounds to FLT_MAX in f32
F32 = torch.float32
_PAT = (0b001001, 0b010010, 0b100100)  # per-axis XOR mirror bits


def _bit_at(mask_lo, mask_hi, cell):
    lo = (mask_lo >> torch.clamp(cell, 0, 31)) & 1
    hi = (mask_hi >> torch.clamp(cell - 32, 0, 31)) & 1
    return torch.where(cell < 32, lo, hi) == 1


def _pc64_below(mask_lo, mask_hi, cell):
    """popcount of the mask bits below `cell` (the child's rank)."""
    one = torch.ones_like(cell)
    below_lo = torch.where(
        cell >= 32, MASK32, (one << torch.clamp(cell, 0, 31)) - 1
    )
    below_hi = torch.where(
        cell >= 32, (one << torch.clamp(cell - 32, 0, 31)) - 1, 0
    )
    return popcount32(mask_lo & below_lo) + popcount32(mask_hi & below_hi)


def _coords(c):
    """6-bit Morton-layout cell index -> stacked [3, N] 2-bit coords."""
    return torch.stack([
        (c & 1) | (((c >> 3) & 1) << 1),
        ((c >> 1) & 1) | (((c >> 4) & 1) << 1),
        ((c >> 2) & 1) | (((c >> 5) & 1) << 1),
    ])


def _cell_of(cx, cy, cz):
    """Inverse of _coords."""
    return (
        (cx & 1) | ((cy & 1) << 1) | ((cz & 1) << 2)
        | ((cx >> 1) << 3) | ((cy >> 1) << 4) | ((cz >> 1) << 5)
    )


def _plane(t1, dc, k):
    """Cell-boundary plane t1 - dc * (4 - k); k an int tensor or int."""
    if isinstance(k, int):
        return t1 - dc * float(4 - k)
    return t1 - dc * (4 - k).to(F32)


def _min3(v):
    return torch.minimum(v[0], torch.minimum(v[1], v[2]))


def _max3(v):
    return torch.maximum(v[0], torch.maximum(v[1], v[2]))


def _walk64_impl(mask_lo, mask_hi, vm6, t1, dc, t_q):
    """First occupied cell (in order) of a 4^3 node along the mirrored ray
    whose exit lies strictly past max(t_q, 0). t1/dc: [3, N] node exit
    planes and per-cell dt. Returns (entry, exit, cell; 64 = none) via a
    10-slot monotone lattice walk (x wins ties, then y)."""
    tq0 = torch.clamp(t_q, min=0.0)
    node_en = _max3(_plane(t1, dc, 0))
    node_ex = _min3(t1)
    t_start = torch.maximum(node_en, tq0)
    c = sum((_plane(t1, dc, k) <= t_start).to(torch.int64) for k in (1, 2, 3))
    # true entry of the start cell (can precede a resume key)
    en = _max3(_plane(t1, dc, c))
    n = _plane(t1, dc, torch.clamp(c + 1, max=4))

    alive = t_start < node_ex
    found = torch.zeros_like(alive)
    best_en = torch.full_like(node_ex, MAX_FLOAT)
    best_ex = torch.full_like(node_ex, MAX_FLOAT)
    best_c = torch.full_like(vm6, 64)
    for slot in range(10):
        if slot and not bool(alive.any()):
            break  # no lane walks on: the later slots change nothing
        ex = _min3(n)
        cell = _cell_of(c[0], c[1], c[2])
        occ = _bit_at(mask_lo, mask_hi, cell ^ vm6)
        valid = alive & occ & (en < ex) & (ex > tq0)
        take = valid & ~found
        best_en = torch.where(take, en, best_en)
        best_ex = torch.where(take, ex, best_ex)
        best_c = torch.where(take, cell, best_c)
        found = found | valid
        if slot == 9:
            break
        # step the axis whose plane is crossed first (ties: x, then y)
        sx = (n[0] <= n[1]) & (n[0] <= n[2])
        sy = ~sx & (n[1] <= n[2])
        step = torch.stack([sx, sy, ~sx & ~sy])
        c = c + step.to(torch.int64)
        en = ex
        n = torch.where(step & (c < 4), _plane(t1, dc, torch.clamp(c + 1, max=4)), n)
        alive = alive & ~found & (c < 4).all(0)
    return best_en, best_ex, best_c


def _scan64_impl(mask_lo, mask_hi, vm6, t1, dc, t_q):
    """The 64-cell in-order sweep with _walk64_impl's contract (the
    reference keeps it as the walk's cross-check)."""
    tq0 = torch.clamp(t_q, min=0.0)
    tb = [_plane(t1, dc, k) for k in range(5)]  # 5 x [3, N]
    best_en = torch.full_like(tq0, MAX_FLOAT)
    best_ex = torch.full_like(tq0, MAX_FLOAT)
    best_c = torch.full_like(vm6, 64)
    for c in range(64):
        cx, cy, cz = (int(v) for v in _coords(torch.tensor(c)))
        en = torch.maximum(tb[cx][0], torch.maximum(tb[cy][1], tb[cz][2]))
        ex = torch.minimum(
            tb[cx + 1][0], torch.minimum(tb[cy + 1][1], tb[cz + 1][2])
        )
        occ = _bit_at(mask_lo, mask_hi, vm6 ^ c)
        valid = occ & (en < ex) & (ex > tq0)
        better = valid & (en < best_en)
        best_en = torch.where(better, en, best_en)
        best_ex = torch.where(better, ex, best_ex)
        best_c = torch.where(better, c, best_c)
    return best_en, best_ex, best_c


def _ray_preamble(lower, upper, ro, rd):
    """Mirrored parametrization: per-axis (t0, t1, dt) as [3, N], the XOR
    mirror mask vm6 [N] and enter_ok [N]. lower/upper f32 [3]; ro/rd
    f32 [N, 3]."""
    rom0 = ro.T
    rda = rd.T
    lo = lower[:, None]
    up = upper[:, None]
    inv = torch.ones_like(rda) / rda
    neg = inv < 0.0
    rom = torch.where(neg, lo + up - rom0, rom0)
    bound = torch.full_like(rom, 0.25 * MAX_FLOAT) / torch.clamp(
        torch.maximum((lo - rom).abs(), (up - rom).abs()), min=1.0
    )
    inva = torch.minimum(inv.abs(), bound)
    t0 = (lo - rom) * inva
    t1 = (up - rom) * inva
    dt = t1 - t0
    pat = torch.tensor(_PAT, dtype=torch.int64, device=ro.device)[:, None]
    vm6 = torch.where(neg, pat, 0).sum(0)
    enter_ok = _min3(t1) >= _max3(t0)
    return t0, t1, dt, vm6, enter_ok


def _probe_from_root(tabs, T, t1, dt, vm6, rt_ml, rt_mh, need0, exhausted0,
                     t_q0, *, max_probes: int):
    """Restart descents from the root through the top tree, emitting each
    active lane's next fat row (or exhaustion), up to max_probes descents.
    tabs: root-down level tables, int32 [n_l, 3] (mask_lo, mask_hi, base).

    Returns (need, tq_new, emit, child, bt1 [3, N], tqe, exhausted)."""
    need = need0
    t_q = t_q0
    emit = torch.zeros_like(need0)
    exh = exhausted0
    brick = torch.zeros_like(vm6)
    bt1 = torch.zeros_like(t1)
    tqe = t_q0
    p = 0
    while p < max_probes and bool(need.any()):
        ok = need
        mask_lo = torch.full_like(vm6, rt_ml)
        mask_hi = torch.full_like(vm6, rt_mh)
        base = torch.zeros_like(vm6)
        cur = t1
        dc = dt * 0.25
        tq_new = t_q
        for depth in range(T):
            _en, _ex, c = _walk64_impl(mask_lo, mask_hi, vm6, cur, dc, t_q)
            found = ok & (c < 64)
            dead = ok & ~found
            tq_new = torch.where(dead, _min3(cur), tq_new)
            if depth == 0:
                exh = exh | dead
            ok = found
            nt1 = _plane(cur, dc, torch.clamp(_coords(c) + 1, max=4))
            child = base + _pc64_below(mask_lo, mask_hi, c ^ vm6)
            if depth == T - 1:
                emit = emit | ok
                brick = torch.where(ok, child, brick)
                bt1 = torch.where(ok, nt1, bt1)
                tqe = torch.where(ok, t_q, tqe)
                tq_new = torch.where(ok, _min3(nt1), tq_new)
            else:
                node = tabs[depth][torch.where(ok, child, 0)].to(torch.int64)
                mask_lo, mask_hi, base = node[:, 0], node[:, 1], node[:, 2]
                cur = nt1
                dc = dc * 0.25
        need = need & ~emit & ~exh
        t_q = tq_new
        p += 1
    return need, t_q, emit, brick, bt1, tqe, exh


def _dda_rows(rows, child, dt, vm6, bt1, tqe0, go, *, dt_factor: float,
              shadow: bool, leaf: bool, max_iters: int):
    """Hierarchical DDA inside each go-lane's 16^3 row `rows[child]`: the
    coarse 4^3 sub-bricks (columns 128-129), then the fine 4^3 cells
    (words 2s, 2s+1). A leaf row reports the first voxel ahead of the
    origin (t, face axis, rank); a supernode row (leaf=False) emits the
    first child brick past the resume key, with its exit planes (the y
    plane bit-cast into nmaj). Stops after max_iters sub-bricks with a
    resume key. Each iteration serves only the lanes still walking,
    gathered densely (lanes are independent: the same bits as serving
    every lane).

    Returns (hit, t_hit, nmaj int32, vr, p3, tqp, more, tqr)."""
    dtb = dt * dt_factor
    dcs = dtb * 0.25     # coarse (4^3-of-cells) dt
    dcv = dtb * 0.0625   # fine cell dt

    ch_all = torch.where(go, child, 0)
    coarse_lo = rows[ch_all, 128].to(torch.int64)
    coarse_hi = rows[ch_all, 129].to(torch.int64)
    base = rows[ch_all, 130].to(torch.int64)

    active = go.clone()
    sub_tq = tqe0.clone()
    hit = torch.zeros_like(go)
    t_hit = torch.full_like(tqe0, MAX_FLOAT)
    nmaj = torch.full_like(vm6, -1, dtype=torch.int32)
    vr = torch.zeros_like(vm6)
    p3 = torch.zeros_like(tqe0)
    tqp = torch.zeros_like(tqe0)
    a = torch.nonzero(go).reshape(-1)  # the lanes still walking
    i = 0
    while i < max_iters and a.numel() > 0:
        ch, m6, tq = ch_all[a], vm6[a], sub_tq[a]
        b1, ds, dv = bt1[:, a], dcs[:, a], dcv[:, a]

        def word(idx):
            return rows[ch, idx].to(torch.int64)

        _en_s, ex_s, cs = _walk64_impl(coarse_lo[a], coarse_hi[a], m6, b1, ds, tq)
        found_s = cs < 64
        s_real = torch.where(found_s, cs ^ m6, 0)
        w_lo = word(2 * s_real)
        w_hi = word(2 * s_real + 1)
        st1 = _plane(b1, ds, torch.clamp(_coords(cs) + 1, max=4))

        en_v, ex_v, cv = _walk64_impl(w_lo, w_hi, m6, st1, dv, tq)
        found_v = found_s & (cv < 64)
        # leaf: a voxel behind the origin is skipped (entry strictly
        # ahead); supernode: any child row past the resume key is next
        is_hit = found_v & (en_v > 0.0) if leaf else found_v
        vc = _coords(cv)

        if not (leaf and shadow):
            pk = word(132 + (s_real >> 1)) & MASK32
            pref = torch.where((s_real & 1) == 1, pk >> 16, pk & 0xFFFF)
            vrank = base[a] + pref + _pc64_below(w_lo, w_hi, cv ^ m6)
            vr[a] = torch.where(is_hit, vrank, vr[a])
        hit[a] = is_hit
        if leaf:
            en_xa = _plane(st1[0], dv[0], vc[0])
            en_ya = _plane(st1[1], dv[1], vc[1])
            nm = torch.where(en_v == en_xa, 1, torch.where(en_v == en_ya, 2, 0))
            t_hit[a] = torch.where(is_hit, en_v, t_hit[a])
            nmaj[a] = torch.where(is_hit, nm.to(torch.int32), nmaj[a])
        else:
            # child-row cell EXIT planes become the next stage's bt1
            cp = _plane(st1, dv, torch.clamp(vc + 1, max=4))
            t_hit[a] = torch.where(is_hit, cp[0], t_hit[a])
            nmaj[a] = torch.where(is_hit, cp[1].view(torch.int32), nmaj[a])
            p3[a] = torch.where(is_hit, cp[2], p3[a])
            tqp[a] = torch.where(is_hit, tq, tqp[a])

        skipped = found_v & ~is_hit          # origin-inside voxel
        no_vox = found_s & ~found_v          # coarse cell had nothing left
        sub_tq[a] = torch.where(
            skipped, ex_v,
            torch.where(no_vox, torch.maximum(tq, ex_s), tq),
        )
        still = found_s & ~is_hit
        active[a] = still
        a = a[still]
        i += 1
    return hit, t_hit, nmaj, vr, p3, tqp, active, sub_tq


# ---------------------------------------------------------------------------
# the legacy round driver (the reference's intersect_rays_hako): kernel A
# (hako_probe), then the row stage (hako_dda_merge: kernel B on the
# supernode and brick rows and the merge in one launch) on the lanes still
# unresolved, round after round. On the card the whole loop is one
# cooperative launch (hako_rounds); `drive` with (hako_probe,
# hako_dda_merge) is the two-launch driver it replaced, kept for the
# round-by-round checks; kernel B (hako_dda) and the merge (hako_merge)
# apart make the unfused stage the phase-timing scripts time
# ---------------------------------------------------------------------------
#
# Each kernel has a plain version (`*_plain`, the per-lane algorithm above
# as tensor code on the round's lanes) and a wrapper that takes the plain
# version for CPU tensors, launches the CUDA kernel of
# csrc/hako_rounds.cu for CUDA tensors, and raises for anything else.
#
# Round state (per ray, [R]): resolved bool, tq f32 (resume key), t f32
# (MAX_FLOAT = miss), nmaj int32 (-1 = miss), vrank int32. A round's lanes
# are an int32 index list `idx` [n]; its per-lane arrays are [n] (bt1
# [3, n]): emit / exh / hit / more bool, child / nmaj / vr int32, the rest
# f32.

PROBES = 4      # kernel A: root descents per round
DDA_ITERS = 24  # kernel B: sub-brick visits per row stage per round

ROUTE_KERNELS = ("hako_rounds",)  # what intersect_rays_hako launches on the card
TWO_LAUNCH = ("hako_probe", "hako_dda_merge")  # what a round of drive() runs
# ... the unfused stage's kernels, and kernel B through a block-local row
# cache, measured beside hako_dda (scripts/r3_phase_split.py): not on the
# route
LAUNCHES = {**dict.fromkeys(ROUTE_KERNELS + TWO_LAUNCH, 0), "hako_dda": 0,
            "hako_merge": 0, "hako_dda_cached": 0}
CACHE_BLOCK = 128  # lanes a block of hako_dda_cached dedups its rows over
_ACC: dict = {}  # device -> int32 [2]: rounds run, lanes left unresolved


def reset_counters() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    for acc in _ACC.values():
        acc.zero_()


def _acc(device) -> torch.Tensor:
    """The device's accumulators of intersect_rays_hako (int32 [2])."""
    if device not in _ACC:
        _ACC[device] = torch.zeros(2, dtype=torch.int32, device=device)
    return _ACC[device]


def rounds_run() -> int:
    """Rounds run by intersect_rays_hako since the last reset (summed over
    its calls; a read of each device's accumulator)."""
    return sum(int(acc[0].item()) for acc in _ACC.values())


def unresolved_lanes() -> int:
    """Lanes left unresolved at max_rounds since the last reset."""
    return sum(int(acc[1].item()) for acc in _ACC.values())


def level_pack(tabs):
    """Root-down level tables -> (one int32 [sum n_l, 3] table or None,
    offsets of each level in it); a single table is its own pack."""
    offs = []
    n = 0
    for tab in tabs:
        offs.append(n)
        n += tab.shape[0]
    if len(tabs) == 1:
        return tabs[0], (0,)
    return (torch.cat(tabs) if tabs else None), tuple(offs)


def _unpack_levels(levels, level_off):
    ends = level_off[1:] + ((levels.shape[0],) if level_off else ())
    return [levels[a:b] for a, b in zip(level_off, ends)]


def hako_probe_plain(levels, level_off, T, root_mask, bounds, ro, rd, idx,
                     tq, *, max_probes):
    """Kernel A: each lane's preamble, then up to max_probes descents from
    the root emitting its next fat row. Returns (emit, child, bt1, tqe,
    tqn, exh)."""
    i = idx.long()
    _t0, t1, dt, vm6, enter_ok = _ray_preamble(bounds[:3], bounds[3:],
                                               ro[i], rd[i])
    _need, tqn, emit, child, bt1, tqe, exh = _probe_from_root(
        _unpack_levels(levels, level_off) if level_off else [], T, t1, dt,
        vm6, root_mask[0], root_mask[1], enter_ok, ~enter_ok, tq[i],
        max_probes=max_probes)
    child = torch.where(emit, child, 0).to(torch.int32)
    return emit, child, bt1, tqe, tqn, exh


def hako_dda_plain(rows, bounds, ro, rd, idx, go, child, bt1, tqe, *,
                   dt_factor, leaf, shadow, max_iters):
    """Kernel B: the row DDA of each go-lane's row rows[child]. Returns
    (hit, t, nmaj, vr, p3, tqp, more, tqr); a supernode row's outputs are
    (emit, exit plane x, exit plane y bit-cast, child brick, exit plane z,
    resume key passed on, more, resume key)."""
    i = idx.long()
    _t0, _t1, dt, vm6, _ok = _ray_preamble(bounds[:3], bounds[3:], ro[i], rd[i])
    hit, t, nmaj, vr, p3, tqp, more, tqr = _dda_rows(
        rows, child.long(), dt, vm6, bt1, tqe, go, dt_factor=dt_factor,
        shadow=shadow, leaf=leaf, max_iters=max_iters)
    return hit, t, nmaj, vr.to(torch.int32), p3, tqp, more, tqr


def hako_merge_plain(state, idx, emit, bt1, tqn, exh, hit, t_hit, nmaj, vr,
                     more, tqr):
    """The round's where-merges, written into state (resolved, tq, t,
    nmaj, vrank) at the lanes idx, in place."""
    resolved, tq, t_out, nm_out, vi_out = state
    i = idx.long()
    act = ~resolved[i]
    go = emit & act
    tqn = torch.where(go, torch.where(more, tqr, _min3(bt1)), tqn)
    newhit = act & hit
    resolved[i] = resolved[i] | (act & (newhit | exh))
    tq[i] = torch.where(act, tqn, tq[i])
    t_out[i] = torch.where(newhit, t_hit, t_out[i])
    nm_out[i] = torch.where(newhit, nmaj, nm_out[i])
    vi_out[i] = torch.where(newhit, vr, vi_out[i])


def _check(name, x, device, dtype, shape):
    if (x.device != device or x.dtype != dtype or tuple(x.shape) != shape
            or not x.is_contiguous()):
        raise ValueError(f"{name}: need contiguous {dtype} {list(shape)} on "
                         f"{device}, got {x.dtype} {list(x.shape)} on {x.device}")


def _check_rays(bounds, ro, rd, idx, device):
    _check("bounds", bounds, device, torch.float32, (6,))
    _check("ro", ro, device, torch.float32, (ro.shape[0], 3))
    _check("rd", rd, device, torch.float32, (ro.shape[0], 3))
    _check("idx", idx, device, torch.int32, (idx.shape[0],))


def _device_of(ro, name):
    """'cpu' -> the plain version, 'cuda' -> the kernel; raise otherwise."""
    if ro.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no {name} kernel for device {ro.device}")
    return ro.device.type


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def _launched(name, rc):
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    LAUNCHES[name] += 1


def hako_probe(levels, level_off, T, root_mask, bounds, ro, rd, idx, tq, *,
               max_probes):
    """Kernel A (arguments and results as in hako_probe_plain)."""
    if _device_of(ro, "hako_probe") == "cpu":
        return hako_probe_plain(levels, level_off, T, root_mask, bounds, ro,
                                rd, idx, tq, max_probes=max_probes)
    from ..utils import cuda_build

    dev = ro.device
    _check_rays(bounds, ro, rd, idx, dev)
    _check("tq", tq, dev, torch.float32, (ro.shape[0],))
    if len(level_off) != T - 1 or T - 1 > cuda_build.MAX_LEVELS:
        raise ValueError(f"need T-1 = {T - 1} level tables, got {len(level_off)}")
    if levels is not None:
        _check("levels", levels, dev, torch.int32, (levels.shape[0], 3))
    n = idx.shape[0]
    emit = torch.empty(n, dtype=torch.bool, device=dev)
    exh = torch.empty_like(emit)
    child = torch.empty(n, dtype=torch.int32, device=dev)
    bt1 = torch.empty((3, n), dtype=torch.float32, device=dev)
    tqe = torch.empty(n, dtype=torch.float32, device=dev)
    tqn = torch.empty_like(tqe)
    offs = (ctypes.c_int * cuda_build.MAX_LEVELS)(*level_off)
    with torch.cuda.device(dev):
        rc = cuda_build.load().hako_probe_launch(
            None if levels is None else levels.data_ptr(),
            ctypes.addressof(offs), T, root_mask[0], root_mask[1],
            bounds.data_ptr(), ro.data_ptr(), rd.data_ptr(), idx.data_ptr(),
            tq.data_ptr(), n, emit.data_ptr(), child.data_ptr(),
            bt1.data_ptr(), tqe.data_ptr(), tqn.data_ptr(), exh.data_ptr(),
            max_probes, _stream(dev))
    _launched("hako_probe", rc)
    return emit, child, bt1, tqe, tqn, exh


def hako_dda(rows, bounds, ro, rd, idx, go, child, bt1, tqe, *, dt_factor,
             leaf, shadow, max_iters):
    """Kernel B (arguments and results as in hako_dda_plain)."""
    if _device_of(ro, "hako_dda") == "cpu":
        return hako_dda_plain(rows, bounds, ro, rd, idx, go, child, bt1, tqe,
                              dt_factor=dt_factor, leaf=leaf, shadow=shadow,
                              max_iters=max_iters)
    from ..utils import cuda_build

    dev = ro.device
    n = idx.shape[0]
    _check_rays(bounds, ro, rd, idx, dev)
    _check("rows", rows, dev, torch.int32, (rows.shape[0], 164))
    _check("go", go, dev, torch.bool, (n,))
    _check("child", child, dev, torch.int32, (n,))
    _check("bt1", bt1, dev, torch.float32, (3, n))
    _check("tqe", tqe, dev, torch.float32, (n,))
    f = dict(dtype=torch.float32, device=dev)
    i = dict(dtype=torch.int32, device=dev)
    b = dict(dtype=torch.bool, device=dev)
    out = (torch.empty(n, **b), torch.empty(n, **f), torch.empty(n, **i),
           torch.empty(n, **i), torch.empty(n, **f), torch.empty(n, **f),
           torch.empty(n, **b), torch.empty(n, **f))
    with torch.cuda.device(dev):
        rc = cuda_build.load().hako_dda_launch(
            rows.data_ptr(), bounds.data_ptr(), ro.data_ptr(), rd.data_ptr(),
            idx.data_ptr(), n, go.data_ptr(), child.data_ptr(),
            bt1.data_ptr(), tqe.data_ptr(), *(o.data_ptr() for o in out),
            float(dt_factor), int(leaf), int(shadow), int(max_iters),
            _stream(dev))
    _launched("hako_dda", rc)
    return out


def block_rows_plain(go, child, cache: int, block: int = CACHE_BLOCK):
    """What hako_dda_cached's blocks find: for each block of `block` lanes,
    its go-lanes, its distinct rows among them and the go-lanes whose row
    is among the block's `cache` smallest row ids (those it stages).
    Returns int32 [blocks, 3]."""
    n = go.shape[0]
    nb = -(-n // block)
    big = torch.iinfo(torch.int64).max
    ids = torch.full((nb * block,), big, dtype=torch.int64, device=go.device)
    ids[:n] = torch.where(go, child.long(), big)
    s, _ = torch.sort(ids.reshape(nb, block), dim=1)
    real = s != big
    first = torch.ones_like(real)
    first[:, 1:] = s[:, 1:] != s[:, :-1]
    bnd = real & first
    rank = torch.cumsum(bnd.to(torch.int64), 1) - 1
    return torch.stack([real.sum(1), bnd.sum(1), (real & (rank < cache)).sum(1)],
                       1).to(torch.int32)


def hako_dda_cached(rows, bounds, ro, rd, idx, go, child, bt1, tqe, *,
                    dt_factor, leaf, shadow, max_iters, cache):
    """Kernel B through a block-local row cache of `cache` rows: the
    outputs of hako_dda, and the blocks' row counts. Its plain version is
    hako_dda_plain with block_rows_plain. Raises where the card refuses
    the cache's shared memory."""
    if _device_of(ro, "hako_dda_cached") == "cpu":
        return (hako_dda_plain(rows, bounds, ro, rd, idx, go, child, bt1, tqe,
                               dt_factor=dt_factor, leaf=leaf, shadow=shadow,
                               max_iters=max_iters),
                block_rows_plain(go, child, cache))
    from ..utils import cuda_build

    dev = ro.device
    n = idx.shape[0]
    _check_rays(bounds, ro, rd, idx, dev)
    _check("rows", rows, dev, torch.int32, (rows.shape[0], 164))
    _check("go", go, dev, torch.bool, (n,))
    _check("child", child, dev, torch.int32, (n,))
    _check("bt1", bt1, dev, torch.float32, (3, n))
    _check("tqe", tqe, dev, torch.float32, (n,))
    if rows.data_ptr() % 16:
        raise ValueError("rows: need a 16-byte aligned table")
    if cache < 0:
        raise ValueError(f"cache must be 0 or more rows, not {cache}")
    f = dict(dtype=torch.float32, device=dev)
    i = dict(dtype=torch.int32, device=dev)
    b = dict(dtype=torch.bool, device=dev)
    out = (torch.empty(n, **b), torch.empty(n, **f), torch.empty(n, **i),
           torch.empty(n, **i), torch.empty(n, **f), torch.empty(n, **f),
           torch.empty(n, **b), torch.empty(n, **f))
    stats = torch.empty((-(-n // CACHE_BLOCK), 3), **i)
    with torch.cuda.device(dev):
        rc = cuda_build.load().hako_dda_cached_launch(
            rows.data_ptr(), bounds.data_ptr(), ro.data_ptr(), rd.data_ptr(),
            idx.data_ptr(), n, go.data_ptr(), child.data_ptr(),
            bt1.data_ptr(), tqe.data_ptr(), *(o.data_ptr() for o in out),
            float(dt_factor), int(leaf), int(shadow), int(max_iters),
            int(cache), stats.data_ptr(), _stream(dev))
    _launched("hako_dda_cached", rc)
    return out, stats


def hako_merge(state, idx, emit, bt1, tqn, exh, hit, t_hit, nmaj, vr, more,
               tqr):
    """The merge (arguments as in hako_merge_plain), in place."""
    resolved = state[0]
    if _device_of(resolved, "hako_merge") == "cpu":
        return hako_merge_plain(state, idx, emit, bt1, tqn, exh, hit, t_hit,
                                nmaj, vr, more, tqr)
    from ..utils import cuda_build

    dev = resolved.device
    r, n = resolved.shape[0], idx.shape[0]
    _check("idx", idx, dev, torch.int32, (n,))
    for name, x, dtype in (("resolved", resolved, torch.bool),
                           ("tq", state[1], torch.float32),
                           ("t", state[2], torch.float32),
                           ("nmaj", state[3], torch.int32),
                           ("vrank", state[4], torch.int32)):
        _check(name, x, dev, dtype, (r,))
    _check("bt1", bt1, dev, torch.float32, (3, n))
    for name, x, dtype in (("emit", emit, torch.bool), ("tqn", tqn, torch.float32),
                           ("exh", exh, torch.bool), ("hit", hit, torch.bool),
                           ("t_hit", t_hit, torch.float32),
                           ("nmaj", nmaj, torch.int32), ("vr", vr, torch.int32),
                           ("more", more, torch.bool), ("tqr", tqr, torch.float32)):
        _check(name, x, dev, dtype, (n,))
    with torch.cuda.device(dev):
        rc = cuda_build.load().hako_merge_launch(
            idx.data_ptr(), n, emit.data_ptr(), bt1.data_ptr(), tqn.data_ptr(),
            exh.data_ptr(), hit.data_ptr(), t_hit.data_ptr(), nmaj.data_ptr(),
            vr.data_ptr(), more.data_ptr(), tqr.data_ptr(),
            *(x.data_ptr() for x in state), _stream(dev))
    _launched("hako_merge", rc)


def unfused_stage(dda, merge):
    """The round's row stage from a kernel B and a merge (the wrappers, the
    plain versions, or checked pairs side by side), with hako_dda_merge's
    arguments: on a fat tree B on the supernode rows and the hand-off,
    then B on the brick rows, then the merge into `state`."""
    def stage(state, bricks, snodes, bounds, ro, rd, idx, emit, child, bt1,
              tqe, tqn, exh, *, T, shadow, max_iters):
        rays = (bounds, ro, rd)
        fat = snodes is not None
        if fat:
            # stage 1: the supernode row walk emits the next brick + planes
            emit, child, bt1, tqe, tqn = supernode_handoff(
                emit, bt1, tqn, dda(snodes, *rays, idx, emit, child, bt1, tqe,
                                    dt_factor=0.25 ** T, leaf=False,
                                    shadow=shadow, max_iters=max_iters))
        hit, t_hit, nmaj, vr, _p3, _tqp, more, tqr = dda(
            bricks, *rays, idx, emit, child, bt1, tqe,
            dt_factor=0.25 ** (T + 2 if fat else T), leaf=True, shadow=shadow,
            max_iters=max_iters)
        merge(state, idx, emit, bt1, tqn, exh, hit, t_hit, nmaj, vr, more, tqr)
    return stage


def hako_dda_merge_plain(state, bricks, snodes, bounds, ro, rd, idx, emit,
                         child, bt1, tqe, tqn, exh, *, T, shadow, max_iters):
    """The round's row stage on kernel A's outputs (emit, child, bt1, tqe,
    tqn, exh) for the lanes idx, written into state (resolved, tq, t,
    nmaj, vrank) in place: hako_dda_plain on the supernode rows of a fat
    tree (snodes not None), supernode_handoff, hako_dda_plain on the brick
    rows, hako_merge_plain."""
    unfused_stage(hako_dda_plain, hako_merge_plain)(
        state, bricks, snodes, bounds, ro, rd, idx, emit, child, bt1, tqe,
        tqn, exh, T=T, shadow=shadow, max_iters=max_iters)


def hako_dda_merge(state, bricks, snodes, bounds, ro, rd, idx, emit, child,
                   bt1, tqe, tqn, exh, *, T, shadow, max_iters):
    """The row stage in one launch (arguments as in hako_dda_merge_plain),
    in place. Refuses, on every device, a state whose length is not the
    rays' (the kernel writes state[*][idx[j]] for lanes of ro)."""
    resolved = state[0]
    if resolved.shape[0] != ro.shape[0]:
        raise ValueError(f"state: {resolved.shape[0]} lanes for {ro.shape[0]} rays")
    if _device_of(ro, "hako_dda_merge") == "cpu":
        return hako_dda_merge_plain(state, bricks, snodes, bounds, ro, rd, idx,
                                    emit, child, bt1, tqe, tqn, exh, T=T,
                                    shadow=shadow, max_iters=max_iters)
    from ..utils import cuda_build

    dev = ro.device
    r, n = resolved.shape[0], idx.shape[0]
    _check_rays(bounds, ro, rd, idx, dev)
    _check("bricks", bricks, dev, torch.int32, (bricks.shape[0], 164))
    if snodes is not None:
        _check("snodes", snodes, dev, torch.int32, (snodes.shape[0], 164))
    for name, x, dtype in (("resolved", resolved, torch.bool),
                           ("tq", state[1], torch.float32),
                           ("t", state[2], torch.float32),
                           ("nmaj", state[3], torch.int32),
                           ("vrank", state[4], torch.int32)):
        _check(name, x, dev, dtype, (r,))
    _check("bt1", bt1, dev, torch.float32, (3, n))
    for name, x, dtype in (("emit", emit, torch.bool), ("child", child, torch.int32),
                           ("tqe", tqe, torch.float32), ("tqn", tqn, torch.float32),
                           ("exh", exh, torch.bool)):
        _check(name, x, dev, dtype, (n,))
    fat = snodes is not None
    with torch.cuda.device(dev):
        rc = cuda_build.load().hako_dda_merge_launch(
            bricks.data_ptr(), snodes.data_ptr() if fat else None,
            bounds.data_ptr(), ro.data_ptr(), rd.data_ptr(), idx.data_ptr(), n,
            emit.data_ptr(), child.data_ptr(), bt1.data_ptr(), tqe.data_ptr(),
            tqn.data_ptr(), exh.data_ptr(), float(0.25 ** T),
            float(0.25 ** (T + 2 if fat else T)), int(shadow), int(max_iters),
            *(x.data_ptr() for x in state), _stream(dev))
    _launched("hako_dda_merge", rc)


def default_max_rounds(snodes, T: int, max_probes: int, max_dda: int) -> int:
    """Safety bound only (the loop ends when no lane is left): every
    active lane is served every round, so a lane needs as many rounds as
    it does in the megakernel, whose bound this is."""
    from .hako_mega import _rounds_for

    return _rounds_for(snodes, T, max_probes, max_dda)


def round_lanes(state):
    """The two-launch round's one host sync: the lanes still unresolved
    (int32)."""
    return torch.nonzero(~state[0]).reshape(-1).to(torch.int32)


def supernode_handoff(emit, bt1, tqn, sn):
    """The supernode stage's outputs `sn` -> the leaf stage's (emit,
    child, bt1, tqe) and the lanes' resume keys tqn: lanes whose supernode
    held nothing past tq resume at its exit (or at the DDA's resume key
    when capped)."""
    emit2, bp1, bp2i, brick, bp3, btq, more_s, tqr_s = sn
    tqn = torch.where(emit & ~emit2, torch.where(more_s, tqr_s, _min3(bt1)), tqn)
    return emit2, brick, torch.stack([bp1, bp2i.view(torch.float32), bp3]), btq, tqn


def drive(kernels, bricks, snodes, tabs, root_mask, lower, upper, ro, rd, *,
          T, shadow, max_probes, max_dda, max_rounds):
    """The host loop of rounds with the given (probe, stage): the kernel
    wrappers (hako_probe, hako_dda_merge: the two-launch driver, one host
    sync a round), their plain versions, an unfused_stage, or
    (chip_smoke.py) checked kernels side by side. Returns (t, nmaj,
    vrank, unresolved int32 [1], rounds)."""
    probe, stage = kernels
    dev = ro.device
    n = ro.shape[0]
    levels, level_off = level_pack(tabs)
    bounds = torch.cat([lower, upper]).to(device=dev, dtype=torch.float32)
    state = (torch.zeros(n, dtype=torch.bool, device=dev),
             torch.zeros(n, dtype=torch.float32, device=dev),
             torch.full((n,), MAX_FLOAT, dtype=torch.float32, device=dev),
             torch.full((n,), -1, dtype=torch.int32, device=dev),
             torch.zeros(n, dtype=torch.int32, device=dev))
    rays = (bounds, ro, rd)
    rounds = 0
    while rounds < max_rounds:
        idx = round_lanes(state)
        if idx.shape[0] == 0:
            break
        a_out = probe(levels, level_off, T, root_mask, *rays, idx, state[1],
                      max_probes=max_probes)
        stage(state, bricks, snodes, *rays, idx, *a_out, T=T, shadow=shadow,
              max_iters=max_dda)
        rounds += 1
    unresolved = (~state[0]).sum().to(torch.int32).reshape(1)
    return state[2], state[3], state[4], unresolved, rounds


def intersect_rays_hako_plain(bricks, snodes, tabs, root_mask, lower, upper,
                              ro, rd, *, T: int, shadow: bool = False,
                              max_probes: int = PROBES,
                              max_dda: int = DDA_ITERS,
                              max_rounds: int | None = None):
    """Plain version of the round driver on any device (arguments and
    results as in hako_mega.intersect_rays_hako_mega_plain, plus the
    number of rounds run)."""
    if max_rounds is None:
        max_rounds = default_max_rounds(snodes, T, max_probes, max_dda)
    return drive((hako_probe_plain,
                  unfused_stage(hako_dda_plain, hako_merge_plain)), bricks,
                 snodes, tabs, root_mask, lower, upper, ro, rd, T=T,
                 shadow=shadow, max_probes=max_probes, max_dda=max_dda,
                 max_rounds=max_rounds)


ROUND_THREADS = 128  # kThreads of csrc/hako_rounds.cu: the lanes of a block
_GRIDS: dict = {}  # (device, fat, shadow) -> (blocks an SM, SMs)


def rounds_grid(device, fat: bool, shadow: bool) -> tuple:
    """(blocks an SM, SMs) of hako_rounds_kernel<fat, shadow>'s co-resident
    grid on `device` by the occupancy calculator, asked of the card once a
    device and instantiation; raises without one."""
    from ..utils import cuda_build

    key = (torch.device(device), bool(fat), bool(shadow))
    if key not in _GRIDS:
        out = (ctypes.c_int * 2)()
        lib = cuda_build.load()
        with torch.cuda.device(key[0]):
            rc = lib.hako_rounds_grid(int(fat), int(shadow), out)
        if rc != 0:
            raise RuntimeError(f"hako_rounds grid query failed: CUDA error {rc} "
                               f"({lib.cuda_error_string(rc).decode()})")
        _GRIDS[key] = (out[0], out[1])
    return _GRIDS[key]


def hako_rounds(bricks, snodes, tabs, root_mask, lower, upper, ro, rd, *, T: int,
                shadow: bool = False, max_probes: int = PROBES,
                max_dda: int = DDA_ITERS, max_rounds: int | None = None,
                acc=None, _blocks: int = 0):
    """The round loop on the card in one cooperative launch of
    hako_rounds_kernel (CUDA tensors only): each round serves its list of
    lanes with kernel A and the row stage, the survivors appended to the
    next list on the device, until none is left or max_rounds. Returns (t,
    nmaj, vrank, info): info int32 [2] on the device holds the rounds run
    and the lanes left unresolved, as intersect_rays_hako_plain returns
    them; `acc` (int32 [2]), when given, has info added on the device.
    Makes no host sync. The grid is the co-resident one (rounds_grid), and
    no more blocks than the lanes need; `_blocks`, a hook for tests and
    measurements, launches that many blocks instead. Raises where the
    launch fails (a grid the card cannot hold co-resident among the
    causes); there is no fallback."""
    from ..utils import cuda_build

    if _device_of(ro, "hako_rounds") != "cuda":
        raise ValueError(f"hako_rounds runs on CUDA tensors, not {ro.device}")
    if max_rounds is None:
        max_rounds = default_max_rounds(snodes, T, max_probes, max_dda)
    dev = ro.device
    n = ro.shape[0]
    _check("ro", ro, dev, torch.float32, (n, 3))
    _check("rd", rd, dev, torch.float32, (n, 3))
    _check("bricks", bricks, dev, torch.int32, (bricks.shape[0], 164))
    fat = snodes is not None
    if fat:
        _check("snodes", snodes, dev, torch.int32, (snodes.shape[0], 164))
    if len(tabs) != T - 1 or T - 1 > cuda_build.MAX_LEVELS:
        raise ValueError(f"need T-1 = {T - 1} level tables, got {len(tabs)}")
    levels, level_off = level_pack(tabs)
    if levels is not None:
        _check("levels", levels, dev, torch.int32, (levels.shape[0], 3))
    if acc is not None:
        _check("acc", acc, dev, torch.int32, (2,))
    if n >= 2 ** 30:
        raise ValueError(f"{n} rays: the lane lists index int32 [2, n]")
    lower = lower.to(device=dev, dtype=torch.float32).contiguous()
    upper = upper.to(device=dev, dtype=torch.float32).contiguous()
    _check("lower", lower, dev, torch.float32, (3,))
    _check("upper", upper, dev, torch.float32, (3,))
    t = torch.empty(n, dtype=torch.float32, device=dev)
    nmaj = torch.empty(n, dtype=torch.int32, device=dev)
    vrank = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return t, nmaj, vrank, torch.zeros(2, dtype=torch.int32, device=dev)
    info = torch.empty(2, dtype=torch.int32, device=dev)
    lists = torch.empty((2, n), dtype=torch.int32, device=dev)
    counts = torch.empty(3, dtype=torch.int32, device=dev)
    tq = torch.empty(n, dtype=torch.float32, device=dev)
    if _blocks:
        blocks = _blocks
    else:
        per_sm, sms = rounds_grid(dev, fat, shadow)
        blocks = min(per_sm * sms, -(-n // ROUND_THREADS))
    offs = (ctypes.c_int * cuda_build.MAX_LEVELS)(*level_off)
    lib = cuda_build.load()
    with torch.cuda.device(dev):
        rc = lib.hako_rounds_launch(
            bricks.data_ptr(), snodes.data_ptr() if fat else None,
            None if levels is None else levels.data_ptr(), ctypes.addressof(offs), T,
            root_mask[0], root_mask[1], lower.data_ptr(), upper.data_ptr(),
            ro.data_ptr(), rd.data_ptr(), n, lists.data_ptr(), counts.data_ptr(),
            tq.data_ptr(), t.data_ptr(), nmaj.data_ptr(), vrank.data_ptr(),
            info.data_ptr(), None if acc is None else acc.data_ptr(), int(shadow),
            int(max_probes), int(max_dda), int(max_rounds), float(0.25 ** T),
            float(0.25 ** (T + 2 if fat else T)), int(blocks), _stream(dev))
    if rc != 0:
        raise RuntimeError(f"hako_rounds kernel launch failed: CUDA error {rc} "
                           f"({lib.cuda_error_string(rc).decode()})")
    LAUNCHES["hako_rounds"] += 1
    return t, nmaj, vrank, info


def intersect_rays_hako(bricks, snodes, tabs, root_mask, lower, upper, ro,
                        rd, *, T: int, shadow: bool = False,
                        max_probes: int = PROBES, max_dda: int = DDA_ITERS,
                        max_rounds: int | None = None):
    """Full-frame traversal through the round driver. Returns (t, nmajor,
    vrank). CPU tensors run the plain version; CUDA tensors launch
    hako_rounds once (no host sync) or raise. The rounds run and the lanes
    left unresolved go to the device's accumulators (rounds_run(),
    unresolved_lanes())."""
    if max_rounds is None:
        max_rounds = default_max_rounds(snodes, T, max_probes, max_dda)
    dev = torch.device(ro.device)
    kw = dict(T=T, shadow=shadow, max_probes=max_probes, max_dda=max_dda,
              max_rounds=max_rounds)
    if _device_of(ro, "round driver") == "cuda":
        return hako_rounds(bricks, snodes, tabs, root_mask, lower, upper, ro, rd,
                           acc=_acc(dev), **kw)[:3]
    t, nmaj, vrank, unresolved, rounds = intersect_rays_hako_plain(
        bricks, snodes, tabs, root_mask, lower, upper, ro, rd, **kw)
    acc = _acc(dev)
    acc[0] += rounds
    acc[1] += unresolved[0]
    return t, nmaj, vrank


def hako_args(tree):
    """(meta, T) for the accel dispatch: the megakernel's (bricks, snodes,
    root-down level tables, root mask)."""
    from .hako_mega import hako_mega_args

    return hako_mega_args(tree)


def intersect_hako(tree, ro, rd, shadow: bool = False, **kw):
    (bricks, snodes, tabs, root_mask), T = hako_args(tree)
    dev = tree.device
    return intersect_rays_hako(
        bricks, snodes, tabs, root_mask, tree.lower, tree.upper,
        torch.as_tensor(ro, dtype=torch.float32, device=dev).contiguous(),
        torch.as_tensor(rd, dtype=torch.float32, device=dev).contiguous(),
        T=T, shadow=shadow, **kw,
    )
