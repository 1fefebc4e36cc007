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
    resume key.

    Returns (hit, t_hit, nmaj int32, vr, p3, tqp, more, tqr)."""
    dtb = dt * dt_factor
    dcs = dtb * 0.25     # coarse (4^3-of-cells) dt
    dcv = dtb * 0.0625   # fine cell dt

    row = rows[torch.where(go, child, 0)].to(torch.int64)
    coarse_lo = row[:, 128]
    coarse_hi = row[:, 129]
    base = row[:, 130]

    def word(idx):
        return row.gather(1, idx[:, None])[:, 0]

    active = go
    sub_tq = tqe0
    hit = torch.zeros_like(go)
    t_hit = torch.full_like(tqe0, MAX_FLOAT)
    nmaj = torch.full_like(vm6, -1, dtype=torch.int32)
    vr = torch.zeros_like(vm6)
    p3 = torch.zeros_like(tqe0)
    tqp = torch.zeros_like(tqe0)
    i = 0
    while i < max_iters and bool(active.any()):
        _en_s, ex_s, cs = _walk64_impl(coarse_lo, coarse_hi, vm6, bt1, dcs, sub_tq)
        found_s = active & (cs < 64)
        s_real = torch.where(found_s, cs ^ vm6, 0)
        w_lo = word(2 * s_real)
        w_hi = word(2 * s_real + 1)
        st1 = _plane(bt1, dcs, torch.clamp(_coords(cs) + 1, max=4))

        en_v, ex_v, cv = _walk64_impl(w_lo, w_hi, vm6, st1, dcv, sub_tq)
        found_v = found_s & (cv < 64)
        # leaf: a voxel behind the origin is skipped (entry strictly
        # ahead); supernode: any child row past the resume key is next
        is_hit = found_v & (en_v > 0.0) if leaf else found_v
        vc = _coords(cv)

        if not (leaf and shadow):
            pk = word(132 + (s_real >> 1)) & MASK32
            pref = torch.where((s_real & 1) == 1, pk >> 16, pk & 0xFFFF)
            vrank = base + pref + _pc64_below(w_lo, w_hi, cv ^ vm6)
            vr = torch.where(is_hit, vrank, vr)
        hit = hit | is_hit
        if leaf:
            en_xa = _plane(st1[0], dcv[0], vc[0])
            en_ya = _plane(st1[1], dcv[1], vc[1])
            nm = torch.where(en_v == en_xa, 1, torch.where(en_v == en_ya, 2, 0))
            t_hit = torch.where(is_hit, en_v, t_hit)
            nmaj = torch.where(is_hit, nm.to(torch.int32), nmaj)
        else:
            # child-row cell EXIT planes become the next stage's bt1
            cp = _plane(st1, dcv, torch.clamp(vc + 1, max=4))
            t_hit = torch.where(is_hit, cp[0], t_hit)
            nmaj = torch.where(is_hit, cp[1].view(torch.int32), nmaj)
            p3 = torch.where(is_hit, cp[2], p3)
            tqp = torch.where(is_hit, sub_tq, tqp)

        skipped = found_v & ~is_hit          # origin-inside voxel
        no_vox = found_s & ~found_v          # coarse cell had nothing left
        sub_tq = torch.where(
            skipped, ex_v,
            torch.where(no_vox, torch.maximum(sub_tq, ex_s), sub_tq),
        )
        active = found_s & ~is_hit
        i += 1
    return hit, t_hit, nmaj, vr, p3, tqp, active, sub_tq
