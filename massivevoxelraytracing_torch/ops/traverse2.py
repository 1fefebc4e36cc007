"""Traversal v2: one iteration per node visit (the port of the reference's
ops/traverse2.py).

v1 (traverse.py) advances a lane by at most one child slot an iteration.
v2 walks the same tree in the same order with the same results, around a
per-node child selection: all 8 children's entry / exit times at once
(static selects of t0 / tM / t1), masked by occupancy, behind-ness and the
resume key (entry time, octant), and the lexicographic minimum (entry,
octant) taken. Each iteration then descends, records a leaf hit, or pops.
No push when no other sibling is valid (the reference's hasNext,
voxCommon.hpp:368), so the stack stays shallow. One row read a visit:
meta = children ++ psum.

The reference's `block` / lax.map sub-blocking keeps a while-loop carry
resident in TPU VMEM and changes no result; it is not ported. The plain
walk (`intersect_rays2_plain`) steps the live lanes only
(traverse.run_walk); the wrapper `intersect_rays2` runs it for CPU tensors
and launches the hand-written octree_walk_kernel<SHADOW> (csrc/walks.cu,
one thread a ray to completion) for CUDA tensors, bit for bit the same.

That kernel takes a visit's candidates from a list of the octants the ray
crosses and that are occupied, in the ray's order, looks into a child
before it descends, and folds the plain walk's empty child visits and its
pops into its own loop trips. The pieces as tensor code, for the tests
and the measurement scripts (nothing on the card route uses them):
`crossed_octants_plain` (the listed set), `child_octants_plain` (the
look-ahead) and `fold_counts` (the plain walk counted as the kernel runs
it: each lane's terminating iteration and loop trips, and the walk's
decisions).
"""

from __future__ import annotations

import torch

from .bits import MASK32, popcount32
from .traverse import (
    INVALID,
    MAX_FLOAT,
    NEG_INF,
    F32,
    I64,
    _min3,
    _max3,
    launch_walk,
    root_entry_of,
    run_walk,
    stack_push,
    stack_read,
    walk_device,
    walk_state,
)

# child c's per-axis half: bit a of c
_BITS = [[(c >> a) & 1 for c in range(8)] for a in range(3)]


def _select_child(en, ex, occ, rk_t, rk_c, c, n_cells: int, strict: bool):
    """The walks' child selection over [n, k] candidates, column j being
    cell c[0, j] of n_cells: valid = occupied, non-empty, in front, after
    the resume key; the best is the lexicographic minimum (entry, cell).
    Returns (best_t, best_c, n_valid); best_c == n_cells when none is
    valid. `strict` is the brick walk's `en < best_t` (a valid entry of
    MAX_FLOAT is never taken); otherwise ties at MAX_FLOAT go to the
    lowest cell, as the octree walk's (en, c) < (best_t, best_c) does."""
    after = (en > rk_t[:, None]) | ((en == rk_t[:, None]) & (c > rk_c[:, None]))
    valid = occ & (en < ex) & (ex > 0.0) & after
    best_t = torch.where(valid, en, MAX_FLOAT).amin(1)
    pick = valid & (en == best_t[:, None])
    if strict:
        pick = pick & (en < MAX_FLOAT)
    best_c = torch.where(pick, c, n_cells).amin(1)
    return best_t, best_c, valid.sum(1)


def _v2_body(meta, shadow: bool):
    last = meta.shape[0] - 1
    sel = [torch.tensor(b, device=meta.device) for b in _BITS]
    octant = torch.arange(8, device=meta.device)

    def body(st):
        active = st["active"]
        node = st["node"]
        t1x, t1y, t1z = st["t1x"], st["t1y"], st["t1z"]
        scale = st["scale"]
        dtx, dty, dtz = st["dtx"], st["dty"], st["dtz"]

        hs = 0.5 * scale
        tmx = t1x - dtx * hs
        tmy = t1y - dty * hs
        tmz = t1z - dtz * hs
        tx0 = t1x - dtx * scale
        ty0 = t1y - dty * scale
        tz0 = t1z - dtz * scale

        # --- 8-wide child selection
        exs = [torch.stack(p, 1) for p in ((tmx, t1x), (tmy, t1y), (tmz, t1z))]
        ens = [torch.stack(p, 1) for p in ((tx0, tmx), (ty0, tmy), (tz0, tmz))]
        ex = _min3(exs[0][:, sel[0]], exs[1][:, sel[1]], exs[2][:, sel[2]])
        en = _max3(ens[0][:, sel[0]], ens[1][:, sel[1]], ens[2][:, sel[2]])
        real = octant[None, :] ^ st["vmask"][:, None]
        occ = (((node >> 24)[:, None] >> real) & 1) == 1
        best_t, best_c, n_valid = _select_child(
            en, ex, occ, st["rk_t"], st["rk_c"], octant[None, :], 8, strict=False)
        any_other = n_valid > 1  # a sibling remains after taking the best

        found = active & (best_c < 8)
        pop = active & ~found

        # one row read: the node record children[8] ++ psum[8]
        real_best = (best_c ^ st["vmask"]) & 7
        nrow = torch.clamp(torch.where(found, node & 0xFFFFFF, 0), 0, last)
        row = meta[nrow]
        child_ptr = row.gather(1, real_best[:, None])[:, 0].to(I64) & MASK32
        child_psum = row.gather(1, 8 + real_best[:, None])[:, 0].to(I64) & MASK32
        is_leaf_child = child_ptr == INVALID

        # --- leaf: the in-order first hit with a positive entry wins
        hit = found & is_leaf_child & (best_t > 0.0)
        t_out = torch.where(hit, best_t, st["t"])
        bx = (best_c & 1) != 0
        by = (best_c & 2) != 0
        bz = (best_c & 4) != 0
        ex_x = torch.where(bx, t1x, tmx)
        ex_y = torch.where(by, t1y, tmy)
        ex_z = torch.where(bz, t1z, tmz)
        en_xa = torch.where(bx, tmx, tx0)
        en_ya = torch.where(by, tmy, ty0)
        nmaj_new = torch.where(best_t == en_xa, 1, torch.where(best_t == en_ya, 2, 0))
        nmajor = torch.where(hit, nmaj_new, st["nmajor"])
        skipped = st["skipped"]
        skipped_here = skipped if shadow else (skipped + child_psum) & MASK32
        vidx = torch.where(hit, skipped_here, st["vidx"])
        active = active & ~hit

        # a leaf behind the origin: stay on this node, resume past it
        skip_leaf = found & is_leaf_child & ~hit
        descend = found & ~is_leaf_child & active
        push = descend & any_other

        # --- push the current node with the taken child as resume key
        stack_push(st, push, [("s_node", node), ("s_t1x", t1x), ("s_t1y", t1y),
                              ("s_t1z", t1z), ("s_scale", scale),
                              ("s_rkt", best_t), ("s_rkc", best_c),
                              ("s_skip", skipped)])
        sp = st["sp"] + push.to(I64)

        node = torch.where(descend, child_ptr, node)
        t1x = torch.where(descend, ex_x, t1x)
        t1y = torch.where(descend, ex_y, t1y)
        t1z = torch.where(descend, ex_z, t1z)
        scale = torch.where(descend, hs, scale)
        rk_t = torch.where(descend, NEG_INF,
                           torch.where(skip_leaf, best_t, st["rk_t"]))
        rk_c = torch.where(descend, -1, torch.where(skip_leaf, best_c, st["rk_c"]))
        if not shadow:  # only a real descend accumulates the prefix sum
            skipped = torch.where(descend, skipped_here, skipped)

        # --- pop
        exhausted = pop & (sp == 0)
        active = active & ~exhausted
        do_pop = pop & (sp > 0) & active
        sp = sp - do_pop.to(I64)
        st.update(
            node=stack_read(st["s_node"], sp, node, do_pop),
            t1x=stack_read(st["s_t1x"], sp, t1x, do_pop),
            t1y=stack_read(st["s_t1y"], sp, t1y, do_pop),
            t1z=stack_read(st["s_t1z"], sp, t1z, do_pop),
            scale=stack_read(st["s_scale"], sp, scale, do_pop),
            rk_t=stack_read(st["s_rkt"], sp, rk_t, do_pop),
            rk_c=stack_read(st["s_rkc"], sp, rk_c, do_pop),
            skipped=stack_read(st["s_skip"], sp, skipped, do_pop),
            sp=sp, active=active, t=t_out, nmajor=nmajor, vidx=vidx)
        return st

    return body


def _mirror8(m, vm):
    """Bit c of the result is bit c ^ vm of the 8-bit octant mask m."""
    for bit, keep, shift in ((1, 0x55, 1), (2, 0x33, 2), (4, 0x0F, 4)):
        m = torch.where((vm & bit) != 0, ((m & keep) << shift) | ((m >> shift) & keep), m)
    return m


# the octants (walk order) whose halves on axes (a, b) are (h, k): base << (h << sa | k << sb)
_PAIRS = ((0, 1, 0x11, 0, 1), (0, 2, 0x05, 0, 2), (1, 2, 0x03, 1, 2))


def crossed_octants_plain(t1x, t1y, t1z, dtx, dty, dtz, scale, vm):
    """The octants octree_walk_kernel lists as a visit's candidates, as a
    mask: int64 [n], bit b set iff the body accepts the node's own octant b
    (the walk's octant b ^ vm) before its resume key, en < ex and ex > 0,
    for any planes. Per axis the halves' planes are the body's (t0 = t1 -
    dt * scale, tm = t1 - dt * (0.5 * scale)); a half empty or behind the
    origin gets a NaN exit; an octant passes iff each pair of its axes'
    halves overlaps (en_a < ex_b and en_b < ex_a): the nine comparisons
    en_a < ex_b that max(en) < min(ex) means, and ex_a > 0 on each axis.
    The kernel (csrc/walks.cu crossed_octants) builds the same set, in the
    ray's order, from the pieces of the ray's interval in the node, which
    needs finite planes: every visit of a ray that enters has them. AND it
    with the occupancy (node >> 24) for the visit's candidates."""
    hs = 0.5 * scale
    en, ex = [], []
    for t1, dt in ((t1x, dtx), (t1y, dty), (t1z, dtz)):
        tm = t1 - dt * hs
        t0 = t1 - dt * scale
        en.append((t0, tm))
        ex.append((torch.where((t0 < tm) & (tm > 0.0), tm, float("nan")),
                   torch.where((tm < t1) & (t1 > 0.0), t1, float("nan"))))
    walk = torch.full(t1x.shape, 0xFF, dtype=I64, device=t1x.device)
    for a, b, base, sa, sb in _PAIRS:
        w = torch.zeros_like(walk)
        for h in range(2):
            for k in range(2):
                ok = (en[a][h] < ex[b][k]) & (en[b][k] < ex[a][h])
                w = w | torch.where(ok, base << (h << sa | k << sb), 0)
        walk = walk & w
    return _mirror8(walk, vm)


def child_octants_plain(t1x, t1y, t1z, dtx, dty, dtz, scale, vm, best_c, child):
    """The kernel's look-ahead: the candidates the first visit of the
    child under the walk's octant best_c would build (its planes from the
    parent's by the body's selects, scale / 2), ANDed with the child
    word's occupancy (bits 24-31 of index | mask << 24). int64 [n]; 0
    means the plain walk would descend there, find nothing and pop."""
    hs = 0.5 * scale
    t1 = [torch.where(((best_c >> a) & 1) != 0, t, t - d * hs)
          for a, t, d in ((0, t1x, dtx), (1, t1y, dty), (2, t1z, dtz))]
    return crossed_octants_plain(*t1, dtx, dty, dtz, hs, vm) & ((child >> 24) & 0xFF)


FOLD_DECISIONS = ("descends", "hits", "misses", "stays", "pops", "empty_first",
                  "return_visits")
FOLD_EVENTS = FOLD_DECISIONS + ("occupied", "crossed")


def fold_counts(meta, root_entry: int, lower, upper, ro, rd, *, stack_depth: int,
                shadow: bool = False, max_iters: int = 100_000, on_step=None) -> dict:
    """The plain v2 walk, counted as octree_walk_kernel runs it. Per ray:
    `end_it`, the plain iteration at which it ends (its hit or its miss
    with an empty stack; max_iters if still walking then; -1 if it does
    not enter), `hit`, and `trips`, the kernel's loop trips (one takes a
    candidate and ends in a descend, a rejected child, a hit or a leaf
    behind the origin; a pop joins the trip that takes the popped node's
    candidate; a rejected child whose push and pop cancel in the stack
    takes no other trip; a walk's end is a trip of its own, as is a ray
    that does not enter). Summed over the rays (FOLD_EVENTS): the plain
    walk's decisions (FOLD_DECISIONS: descends, hits, misses, stays behind
    the origin, pops, empty first visits, a descend's child with nothing,
    what the look-ahead rejects, and return visits after a pop within the
    stack), and the occupied and the crossed-and-occupied octants
    (crossed_octants_plain) of every visit. on_step as in run_walk."""
    new, pop_in, fold = 0, 1, 2  # how the next iteration joins the kernel's trips
    st = v2_state(root_entry, lower, upper, ro, rd, stack_depth)
    n, dev = ro.shape[0], ro.device
    entered = st["active"].clone()
    it = torch.zeros(n, dtype=I64, device=dev)
    end_it = torch.where(entered, int(max_iters), -1)
    hit_ray = torch.zeros(n, dtype=torch.bool, device=dev)
    trips = torch.zeros(n, dtype=I64, device=dev)
    pend = torch.full((n,), new, dtype=I64, device=dev)
    after_desc = torch.zeros(n, dtype=torch.bool, device=dev)
    after_pop = torch.zeros(n, dtype=torch.bool, device=dev)
    out = dict.fromkeys(FOLD_EVENTS, 0)
    v2 = _v2_body(meta, shadow)

    def body(st):
        lane, act = st["lane"], st["active"]
        pre_sp, pre_scale = st["sp"], st["scale"]
        occ = (st["node"] >> 24) & 0xFF
        cross = crossed_octants_plain(*(st[k] for k in ("t1x", "t1y", "t1z", "dtx", "dty",
                                                        "dtz", "scale", "vmask"))) & occ
        st = v2(st)
        on, sp = st["active"], st["sp"]
        hit = act & ~on & (st["nmajor"] >= 0)
        miss = act & ~on & (st["nmajor"] < 0)
        pop = act & on & (sp < pre_sp)
        desc = act & on & (sp >= pre_sp) & (st["scale"] != pre_scale)
        stay = act & on & ~pop & ~desc
        empty = pop | miss
        p = pend[lane]
        trips[lane] += (act & ((p == new) | ((p == fold) & ~empty))).to(I64)
        absorbed = act & (p == fold) & empty  # the child's empty visit: its push pops
        nxt = torch.where(desc & (sp > pre_sp) & (pre_sp < stack_depth), fold, new)
        nxt = torch.where(pop & ~absorbed & (sp < stack_depth), pop_in, nxt)
        pend[lane] = torch.where(act, nxt, p)
        for key, m in (("descends", desc), ("hits", hit), ("misses", miss), ("stays", stay),
                       ("pops", pop), ("empty_first", empty & after_desc[lane]),
                       ("return_visits", act & after_pop[lane])):
            out[key] += int(m.sum())
        out["occupied"] += int(popcount32(torch.where(act, occ, 0)).sum())
        out["crossed"] += int(popcount32(torch.where(act, cross, 0)).sum())
        after_desc[lane] = desc
        after_pop[lane] = pop & (sp < stack_depth)
        end_it[lane] = torch.where(hit | miss, it[lane], end_it[lane])
        hit_ray[lane] |= hit
        it[lane] += act.to(I64)
        return st

    run_walk(st, body, n, max_iters, on_step)
    # a lane still walking at max_iters takes one more trip to end, unless a
    # pop within the stack brought it there (that trip ends at the cut)
    trips += (~entered | ((end_it == int(max_iters)) & (pend != pop_in))).to(I64)
    return dict(end_it=end_it, hit=hit_ray, trips=trips, **out)


def intersect_rays2(meta, root_entry: int, lower, upper, ro, rd, *,
                    stack_depth: int, shadow: bool = False,
                    max_iters: int = 100_000):
    """The v2 walk. meta: int32 [N, 16] (children ++ psum, u32 patterns);
    root_entry: rootIndex | mask[root] << 24; ro/rd f32 [R, 3] on the
    tree's device. Returns (t f32 [R], n_major int32 [R], v_index int32
    [R]) as traverse.intersect_rays. CPU tensors run the plain walk; CUDA
    tensors launch octree_walk_kernel<shadow>. Raises ValueError for
    another device, a wrong dtype or shape, or stack_depth outside [1, 16],
    before any launch."""
    kw = dict(stack_depth=stack_depth, shadow=shadow, max_iters=max_iters)
    if walk_device("octree_walk", meta, 16, lower, upper, ro, rd, stack_depth) == "cpu":
        return intersect_rays2_plain(meta, root_entry, lower, upper, ro, rd, **kw)
    return launch_walk("octree_walk", meta, root_entry, lower, upper, ro, rd,
                       depth=stack_depth, shadow=shadow, max_iters=max_iters)


def intersect_rays2_plain(meta, root_entry: int, lower, upper, ro, rd, *,
                          stack_depth: int, shadow: bool = False,
                          max_iters: int = 100_000, on_step=None):
    """The v2 walk as tensor code on any device (intersect_rays2's plain
    version)."""
    st = v2_state(root_entry, lower, upper, ro, rd, stack_depth)
    return run_walk(st, _v2_body(meta, shadow), ro.shape[0], max_iters, on_step)


def v2_state(root_entry: int, lower, upper, ro, rd, stack_depth: int) -> dict:
    """The v2 walk's initial state (traverse.walk_state at the root, with
    the first visit's resume key and no prefix sum)."""
    st = walk_state(ro, rd, lower, upper, stack_depth, (1, 2, 4),
                    ("s_node", "s_rkc", "s_skip"),
                    ("s_t1x", "s_t1y", "s_t1z", "s_scale", "s_rkt"))
    st.update(node=torch.full_like(st["sp"], int(root_entry) & MASK32),
              rk_t=torch.full_like(st["t"], NEG_INF),
              rk_c=torch.full_like(st["sp"], -1),
              skipped=torch.zeros_like(st["sp"]))
    return st


def tree_meta(tree) -> torch.Tensor:
    if tree.meta is not None:
        return tree.meta
    return torch.cat([tree.children, tree.psum], dim=1)


def intersect_octree2(tree, ro, rd, shadow: bool = False,
                      max_iters: int = 100_000):
    """The v2 walk over a VoxelOctree (ro / rd: anything torch takes)."""
    depth = max(int(tree.grid_res).bit_length() - 1, 1)
    dev = tree.device
    return intersect_rays2(
        tree_meta(tree), root_entry_of(tree), tree.lower, tree.upper,
        torch.as_tensor(ro, dtype=F32, device=dev).reshape(-1, 3),
        torch.as_tensor(rd, dtype=F32, device=dev).reshape(-1, 3),
        stack_depth=depth, shadow=shadow, max_iters=max_iters)
