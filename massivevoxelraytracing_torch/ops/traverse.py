"""Parametric octree traversal over ray packets (the port of the
reference's ops/traverse.py: octreeTraverse_EfficientParametric,
voxCommon.hpp:231-423, SMALL_STACK variant), and the helpers every
acceleration structure's walk shares.

The walk is a single-step state machine: every iteration, each active lane
either
  ENTER+ADVANCE: recompute t0 = t1 - dt*scale, lazily derive the first
    child mask from the t midplanes, find the next child boundary, and
    DESCEND into an occupied, non-behind child (pushing the resumable
    parent when siblings remain), ADVANCE the child mask one step, or POP
    the stack / retire;
  or, on a leaf (node == 0xFFFFFFFF), record a hit when the entry plane is
    in front (the walk is in ray order, so the first leaf hit wins) and
    retire, or pop.
Negative directions are mirrored by the vMask XOR; 1/rd is clamped so that
|t| <= MAX_FLOAT/4 (the reference's clamp, tightened so that dt stays
finite). The psum accumulation along the path gives the attribute index
(skipped for shadow rays).

The reference's lax.while_loop steps every lane until none is active. Here
`run_walk` steps the live lanes only: every SYNC_EVERY iterations it
writes the retired lanes' results and keeps the rest (one host sync), so
the time follows the live lanes. Lanes are independent, so the bits are
the same; `max_iters` still bounds each lane's iterations, and a lane
still walking then keeps its miss.

That tensor walk is the plain version of the brick and v2 walks. On the
card they are hand-written CUDA kernels (csrc/walks.cu: brick_walk_kernel,
octree_walk_kernel<SHADOW>, one thread a ray to completion), launched by
`launch_walk` for the wrappers bricktree.intersect_rays_brick and
traverse2.intersect_rays2; their CPU tensors run the plain walks. The v1
walk here stays tensor code (no app path runs it: models/accel sends every
octree through v2).

Counters: LAUNCHES[name] counts each walk kernel's launches.
"""

from __future__ import annotations

import numpy as np
import torch

from .bits import MASK32, to_i32_bits

MAX_FLOAT = 3.402823466e38  # rounds to FLT_MAX in f32
NEG_INF = -3.402823466e38
INVALID = 0xFFFFFFFF
F32 = torch.float32
I64 = torch.int64
SYNC_EVERY = 4  # walk iterations between host syncs (lane compaction)
MAX_WALK_DEPTH = 16  # the walk kernels' per-thread stack (16384^3 needs 14)
WALK_KERNELS = ("brick_walk", "octree_walk")
LAUNCHES = dict.fromkeys(WALK_KERNELS, 0)


def reset_counters() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _max3(a, b, c):
    return torch.maximum(a, torch.maximum(b, c))


def _min3(a, b, c):
    return torch.minimum(a, torch.minimum(b, c))


def stack_push(st: dict, push, names_values) -> None:
    """Write (name, value) pairs into column sp of the [n, D] stacks of
    the pushing lanes (a column beyond D writes nothing)."""
    d_iota = torch.arange(st[names_values[0][0]].shape[1], device=push.device)
    wcol = (d_iota[None, :] == st["sp"][:, None]) & push[:, None]
    for name, v in names_values:
        st[name] = torch.where(wcol, v[:, None].to(st[name].dtype), st[name])


def stack_read(stack, sp, cur, do_pop):
    """Column sp of a stack where do_pop, else cur (the reference's masked
    sum over the columns; a column beyond D reads 0)."""
    d_iota = torch.arange(stack.shape[1], device=sp.device)
    v = torch.where(d_iota[None, :] == sp[:, None], stack,
                    torch.zeros_like(stack)).sum(1)
    return torch.where(do_pop, v.to(cur.dtype), cur)


def run_walk(state: dict, body, n: int, max_iters: int, on_step=None):
    """Step `body` (state dict -> state dict, every tensor [lanes, ...])
    on the live lanes until none is active or max_iters iterations ran,
    dropping the retired lanes every SYNC_EVERY iterations. state holds
    `lane` (the ray index), `active`, and the outputs `t`, `nmajor`,
    `vidx`. on_step (optional) sees the state before each iteration (the
    measurement scripts count the rows the walk reads). Returns (t f32
    [n], nmajor int32 [n], vidx int32 [n], the ray's attribute rank as a
    u32 bit pattern)."""
    dev = state["t"].device
    t = torch.full((n,), MAX_FLOAT, dtype=F32, device=dev)
    nmajor = torch.full((n,), -1, dtype=torch.int32, device=dev)
    vidx = torch.zeros(n, dtype=torch.int32, device=dev)

    def select(st, keep):
        idx = torch.nonzero(keep).reshape(-1)
        return {k: v[idx] for k, v in st.items()}

    def flush(st):
        lane = st["lane"]
        t[lane] = st["t"]
        nmajor[lane] = st["nmajor"].to(torch.int32)
        vidx[lane] = to_i32_bits(st["vidx"])

    st = select(state, state["active"])
    it = 0
    while it < max_iters and st["lane"].shape[0] > 0:
        for _ in range(min(SYNC_EVERY, max_iters - it)):
            if on_step is not None:
                on_step(st)
            st = body(st)
        it += SYNC_EVERY
        flush(select(st, ~st["active"]))
        st = select(st, st["active"])
    return t, nmajor, vidx


def _v1_body(children_flat, psum_flat, shadow: bool):
    last = children_flat.shape[0] - 1

    def body(st):
        active = st["active"]
        node = st["node"]
        t1x, t1y, t1z = st["t1x"], st["t1y"], st["t1z"]
        scale = st["scale"]
        cm = st["cm"]

        tx0 = t1x - st["dtx"] * scale
        ty0 = t1y - st["dty"] * scale
        tz0 = t1z - st["dtz"] * scale
        s_lmax = _max3(tx0, ty0, tz0)

        isleaf = node == INVALID

        # --- leaf: hit or pop (voxCommon.hpp:322-335)
        hit = active & isleaf & (0.0 < s_lmax)
        t = torch.where(hit, s_lmax, st["t"])
        nmajor = torch.where(
            hit, torch.where(s_lmax == tx0, 1, torch.where(s_lmax == ty0, 2, 0)),
            st["nmajor"])
        vidx = torch.where(hit, st["skipped"], st["vidx"])
        active = active & ~hit
        pop_leaf = active & isleaf  # S_lmax <= 0: behind the ray

        # --- interior node
        txm = 0.5 * (tx0 + t1x)
        tym = 0.5 * (ty0 + t1y)
        tzm = 0.5 * (tz0 + t1z)
        cm0 = torch.where(
            cm == INVALID,
            (txm < s_lmax).to(I64) | ((tym < s_lmax).to(I64) << 1)
            | ((tzm < s_lmax).to(I64) << 2),
            cm)
        x1 = torch.where((cm0 & 1) != 0, t1x, txm)
        y1 = torch.where((cm0 & 2) != 0, t1y, tym)
        z1 = torch.where((cm0 & 4) != 0, t1z, tzm)
        s_umin = _min3(x1, y1, z1)
        mv = torch.where(s_umin == x1, 1, torch.where(s_umin == y1, 2, 4))
        has_next = (cm0 & mv) == 0
        child_idx = cm0 ^ st["vmask"]

        lin = (node & 0xFFFFFF) * 8 + child_idx
        lin = torch.clamp(torch.where(isleaf | ~active, 0, lin), 0, last)
        child_ptr = children_flat[lin]
        occupied = (((node >> 24) >> child_idx) & 1) == 1
        is_behind = s_umin < 0.0

        work = active & ~isleaf
        descend = work & occupied & ~is_behind
        push = descend & has_next
        advance = work & ~descend & has_next
        pop_adv = work & ~descend & ~has_next
        pop = pop_leaf | pop_adv

        # --- push the parent (childMask already advanced past mv)
        cm_stored = cm0 | mv
        stack_push(st, push, [("s_node", node), ("s_t1x", t1x), ("s_t1y", t1y),
                              ("s_t1z", t1z), ("s_scale", scale),
                              ("s_cm", cm_stored), ("s_skip", st["skipped"])])
        sp = st["sp"] + push.to(I64)

        # --- descend / advance
        node = torch.where(descend, child_ptr, node)
        t1x = torch.where(descend, x1, t1x)
        t1y = torch.where(descend, y1, t1y)
        t1z = torch.where(descend, z1, t1z)
        scale = torch.where(descend, scale * 0.5, scale)
        cm = torch.where(descend, INVALID, torch.where(advance, cm_stored, cm))
        skipped = st["skipped"]
        if not shadow:
            skipped = torch.where(descend, (skipped + psum_flat[lin]) & MASK32,
                                  skipped)

        # --- pop
        exhausted = pop & (sp == 0)
        active = active & ~exhausted
        do_pop = pop & (sp > 0)
        sp = sp - do_pop.to(I64)
        st.update(
            node=stack_read(st["s_node"], sp, node, do_pop),
            t1x=stack_read(st["s_t1x"], sp, t1x, do_pop),
            t1y=stack_read(st["s_t1y"], sp, t1y, do_pop),
            t1z=stack_read(st["s_t1z"], sp, t1z, do_pop),
            scale=stack_read(st["s_scale"], sp, scale, do_pop),
            cm=stack_read(st["s_cm"], sp, cm, do_pop),
            skipped=stack_read(st["s_skip"], sp, skipped, do_pop),
            sp=sp, active=active, t=t, nmajor=nmajor, vidx=vidx)
        return st

    return body


def walk_state(ro, rd, lower, upper, D: int, mirror_bits, ints, floats):
    """The walks' common initial state: per-lane constants (dtx, dty, dtz,
    the mirror mask from the per-axis `mirror_bits`), t1, the outputs, sp,
    `active` = enter_ok, and zeroed [n, D] stacks (`ints` int64, `floats`
    f32 channel names). The mirrored parametrization: every divisor is a
    tensor (on CUDA a python-scalar divisor becomes a reciprocal
    multiply)."""
    n = ro.shape[0]
    dev = ro.device
    inv = torch.ones_like(rd) / rd
    neg = inv < 0.0
    lo = lower[None, :]
    up = upper[None, :]
    ro_m = torch.where(neg, lo + up - ro, ro)
    bound = torch.full_like(ro_m, 0.25 * MAX_FLOAT) / torch.clamp(
        torch.maximum((lo - ro_m).abs(), (up - ro_m).abs()), min=1.0)
    inv_a = torch.minimum(inv.abs(), bound)
    t0 = (lo - ro_m) * inv_a
    t1 = (up - ro_m) * inv_a
    enter_ok = _min3(t1[:, 0], t1[:, 1], t1[:, 2]) >= _max3(t0[:, 0], t0[:, 1], t0[:, 2])
    dt = t1 - t0
    vm = sum(neg[:, a].to(I64) * mirror_bits[a] for a in range(3))
    st = dict(
        lane=torch.arange(n, dtype=I64, device=dev),
        dtx=dt[:, 0], dty=dt[:, 1], dtz=dt[:, 2], vmask=vm,
        t1x=t1[:, 0], t1y=t1[:, 1], t1z=t1[:, 2],
        scale=torch.ones(n, dtype=F32, device=dev),
        sp=torch.zeros(n, dtype=I64, device=dev),
        active=enter_ok,
        t=torch.full((n,), MAX_FLOAT, dtype=F32, device=dev),
        nmajor=torch.full((n,), -1, dtype=I64, device=dev),
        vidx=torch.zeros(n, dtype=I64, device=dev),
    )
    for name in ints:
        st[name] = torch.zeros((n, D), dtype=I64, device=dev)
    for name in floats:
        st[name] = torch.zeros((n, D), dtype=F32, device=dev)
    return st


def intersect_rays(children_flat, psum_flat, root_entry: int, lower, upper,
                   ro, rd, *, stack_depth: int, shadow: bool = False,
                   max_iters: int = 100_000):
    """The v1 walk. children_flat / psum_flat: int32 [N*8] u32 patterns;
    root_entry: rootIndex | mask[root] << 24; ro/rd f32 [R, 3] on the
    tree's device. Returns (t f32 [R], MAX_FLOAT for a miss; n_major int32
    [R] in {1: x, 2: y, 0: z}; v_index int32 [R], the flat attribute
    rank)."""
    st = walk_state(ro, rd, lower, upper, stack_depth, (1, 2, 4),
                    ("s_node", "s_cm", "s_skip"), ("s_t1x", "s_t1y", "s_t1z", "s_scale"))
    st.update(node=torch.full_like(st["sp"], int(root_entry) & MASK32),
              cm=torch.full_like(st["sp"], INVALID),
              skipped=torch.zeros_like(st["sp"]))
    body = _v1_body(children_flat.to(I64) & MASK32, psum_flat.to(I64) & MASK32,
                    shadow)
    return run_walk(st, body, ro.shape[0], max_iters)


def root_entry_of(tree) -> int:
    """rootIndex | mask[root] << 24 (the embedded-mask bootstrap,
    voxCommon.hpp:305-307)."""
    root = tree.root
    return (root | ((int(tree.mask[root]) & 0xFF) << 24)) & MASK32


def intersect_octree(tree, ro, rd, shadow: bool = False,
                     max_iters: int = 100_000):
    """The v1 walk over a VoxelOctree (ro / rd: anything torch takes)."""
    depth = int(tree.grid_res).bit_length() - 1
    dev = tree.device
    return intersect_rays(
        tree.children.reshape(-1), tree.psum.reshape(-1), root_entry_of(tree),
        tree.lower, tree.upper,
        torch.as_tensor(ro, dtype=F32, device=dev).reshape(-1, 3),
        torch.as_tensor(rd, dtype=F32, device=dev).reshape(-1, 3),
        stack_depth=max(depth, 1), shadow=shadow, max_iters=max_iters)


def hit_normal(n_major: torch.Tensor, rd: torch.Tensor) -> torch.Tensor:
    """Face normal from the major axis + ray sign (getHitN). n_major:
    int [R] (1: x, 2: y, 0: z), rd: f32 [R, 3] -> f32 [R, 3]."""
    s = torch.where(0.0 < rd, -1.0, 1.0).to(rd.dtype)
    zero = torch.zeros_like(s[:, 0])
    nx = torch.where(n_major == 1, s[:, 0], zero)
    ny = torch.where(n_major == 2, s[:, 1], zero)
    nz = torch.where(n_major == 0, s[:, 2], zero)
    return torch.stack([nx, ny, nz], dim=-1)


# ---------------------------------------------------------------------------
# the walk kernels' launch (csrc/walks.cu)
# ---------------------------------------------------------------------------

def walk_device(name: str, meta, cols: int, lower, upper, ro, rd, depth: int) -> str:
    """Check a walk's arguments before any launch: meta int32 [N >= 1,
    cols], lower / upper f32 [3], ro / rd f32 [R, 3], all on one device,
    the cpu or a CUDA device, and 1 <= depth <= MAX_WALK_DEPTH. Returns the
    device type; raises ValueError otherwise."""
    dev = ro.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no {name} kernel for device {dev}")
    R = ro.shape[0] if ro.dim() == 2 else -1
    for what, x, dtype, shape in (("meta", meta, torch.int32, None),
                                  ("lower", lower, F32, (3,)),
                                  ("upper", upper, F32, (3,)),
                                  ("ro", ro, F32, (R, 3)), ("rd", rd, F32, (R, 3))):
        ok_shape = (x.dim() == 2 and x.shape[1] == cols and x.shape[0] >= 1
                    if shape is None else tuple(x.shape) == shape)
        if x.device != dev or x.dtype != dtype or not ok_shape:
            want = f"[N >= 1, {cols}]" if shape is None else list(shape)
            raise ValueError(f"{name}: {what} must be {dtype} {want} on {dev}, got "
                             f"{x.dtype} {list(x.shape)} on {x.device}")
    if not 1 <= int(depth) <= MAX_WALK_DEPTH:
        raise ValueError(f"{name}: stack depth {depth} outside [1, {MAX_WALK_DEPTH}]")
    return dev.type


def walk_launch_args(meta, root: int, lower, upper, ro, rd, *, depth: int, max_iters: int):
    """The walk kernels' launch arguments but the stream (and the octree's
    shadow flag), and new outputs (t f32 [R], nmajor int32 [R], vidx int32
    [R]); the tensors the pointers reach are kept alive in the tuple."""
    n = ro.shape[0]
    meta = meta.contiguous()
    ro, rd = ro.contiguous(), rd.contiguous()
    bounds = torch.cat([lower, upper]).contiguous()
    out = (torch.empty(n, dtype=F32, device=ro.device),
           torch.empty(n, dtype=torch.int32, device=ro.device),
           torch.empty(n, dtype=torch.int32, device=ro.device))
    consts = (float(np.float32(0.25 * MAX_FLOAT)), float(np.float32(MAX_FLOAT)),
              float(np.float32(NEG_INF)))
    head = (meta.data_ptr(), meta.shape[0], bounds.data_ptr(), ro.data_ptr(),
            rd.data_ptr(), n, int(root) & MASK32, int(depth), max(int(max_iters), 0),
            *consts, *(x.data_ptr() for x in out))
    return head, out, (meta, ro, rd, bounds)


def launch_walk(name: str, meta, root: int, lower, upper, ro, rd, *, depth: int,
                shadow: bool, max_iters: int):
    """Launch brick_walk_kernel or octree_walk_kernel<shadow> on CUDA
    tensors checked by walk_device. Returns (t f32 [R], nmajor int32 [R],
    vidx int32 [R]) as run_walk does; raises if the launch is refused."""
    from ..utils import cuda_build

    dev = ro.device
    n = ro.shape[0]
    head, (t, nmaj, vidx), _keep = walk_launch_args(meta, root, lower, upper, ro, rd,
                                                    depth=depth, max_iters=max_iters)
    lib = cuda_build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if name == "brick_walk":
            rc = lib.brick_walk_launch(*head, stream)
        else:
            rc = lib.octree_walk_launch(int(bool(shadow)), *head, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc} "
                           f"({lib.cuda_error_string(rc).decode()})")
    LAUNCHES[name] += n > 0
    return t, nmaj, vidx
