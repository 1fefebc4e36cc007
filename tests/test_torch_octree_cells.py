"""The octree / DAG walk's candidate octants, look-ahead and fold on the CPU.

octree_walk_kernel (csrc/walks.cu) takes a visit's child among the octants
of `crossed_octants(...) & occupancy` only, looks into a child before it
descends (and does not descend where the child's own mask is empty), and
counts the plain walk's iterations as it folds them into its loop trips.
Their constructions as tensor code (ops/traverse2.py) are held here
against the plain walk's own body:

  * the mask ANDed with the occupancy equals the octants the body accepts
    (en < ex & ex > 0 & occupied) on every active lane at every step of
    the plain walk, over a sparse tree, a solid cube and a full grid, DAG
    on and off, on rays that mirror, have ±0 and axis-parallel directions,
    start on the octant-plane lattice (along the axes, the face diagonals
    and (1, 1, 1)), inside a voxel or on its face, are parked or hold NaN
    / inf;
  * on plane sets made by hand: exact ties within and across axes, ±0,
    ±inf, NaN in one plane and in one axis, dt = 0, scale 2^-15;
  * at every descend, the look-ahead's "empty" equals the plain walk's
    next step popping (or missing) from the child's first visit;
  * fold_counts' terminating iteration decides every max_iters cut.

Then the kernel source itself, compiled for the host with g++ (a stub
cuda_runtime.h, the launch a loop over blocks and threads, a counter at
the loop's head), is held bit for bit against the plain walk with
max_iters cuts of 1, 2, 3, 7 and stacks of 1, 2 and 3, shadow on and off,
and its loop trips against fold_counts'. And walk_rows' octree counts,
and walk_ab's octree choice.
"""

import ctypes
import os

import numpy as np
import pytest
import torch

from massivevoxelraytracing_torch.ops import morton, octree, traverse, traverse2
from massivevoxelraytracing_torch.ops.bits import MASK32
from massivevoxelraytracing_torch.utils import cuda_build

import cuda_host_stub

torch.set_num_threads(1)

GRID = 64
OCTANT = torch.arange(8)
ONE = torch.ones(8, dtype=torch.int64)


def entry_exit(st):
    """(en, ex, occupied) of the 8 octants (walk order) of each lane's
    visit: _v2_body's own lines."""
    t1x, t1y, t1z, scale = st["t1x"], st["t1y"], st["t1z"], st["scale"]
    dtx, dty, dtz = st["dtx"], st["dty"], st["dtz"]
    hs = 0.5 * scale
    tm = [t1x - dtx * hs, t1y - dty * hs, t1z - dtz * hs]
    t0 = [t1x - dtx * scale, t1y - dty * scale, t1z - dtz * scale]
    t1 = [t1x, t1y, t1z]
    sel = [torch.tensor(b) for b in traverse2._BITS]
    exs = [torch.stack(p, 1) for p in zip(tm, t1)]
    ens = [torch.stack(p, 1) for p in zip(t0, tm)]
    ex = traverse._min3(exs[0][:, sel[0]], exs[1][:, sel[1]], exs[2][:, sel[2]])
    en = traverse._max3(ens[0][:, sel[0]], ens[1][:, sel[1]], ens[2][:, sel[2]])
    real = OCTANT[None, :] ^ st["vmask"][:, None]
    return en, ex, (((st["node"] >> 24)[:, None] >> real) & 1) == 1


def accepted(st):
    """The octants the plain body accepts on a first visit (en < ex & ex
    > 0 & occupied), as a mask over the node's own bits."""
    en, ex, occ = entry_exit(st)
    real = OCTANT[None, :] ^ st["vmask"][:, None]
    return torch.where(occ & (en < ex) & (ex > 0.0), ONE[None, :] << real, 0).sum(1)


def mask_of(st):
    keys = ("t1x", "t1y", "t1z", "dtx", "dty", "dtz", "scale", "vmask")
    return traverse2.crossed_octants_plain(*(st[k] for k in keys)) & ((st["node"] >> 24) & 0xFF)


def grid_codes(lo, size):
    g = torch.arange(size)
    x, y, z = torch.meshgrid(g, g, g, indexing="ij")
    return morton.encode(x.reshape(-1) + lo[0], y.reshape(-1) + lo[1],
                         z.reshape(-1) + lo[2]).unique()


def trees():
    rng = np.random.default_rng(19)
    c = torch.as_tensor(rng.integers(0, GRID, size=(2500, 3)))
    return {"sparse": morton.encode(c[:, 0], c[:, 1], c[:, 2]).unique(),
            "solid": grid_codes((20, 24, 16), 16),
            "full": grid_codes((0, 0, 0), GRID)}


def build(name, dag):
    lower = np.zeros(3, np.float32)
    return octree.build_octree(trees()[name], GRID, dag=dag, lower=lower,
                               upper=lower + np.float32(1.0))


def walk_args(tree):
    return (traverse2.tree_meta(tree), traverse.root_entry_of(tree), tree.lower, tree.upper)


DIRS = np.array([[1, 0, 0], [0, 1, 0], [0, 0, -1], [1, 1, 0], [0, -1, 1], [-1, 0, -1],
                 [1, 1, 1], [-1, 1, -1], [-1, -1, -1]], np.float32)


def rays(codes, n, seed):
    """Rays aimed at voxels, then: ±0 and axis-parallel directions, from
    inside the box, from the octant-plane lattice along the axes, the face
    diagonals and (1, 1, 1), from inside a voxel and on its face, parked
    at 1e9, NaN and inf, and from far away."""
    rng = np.random.default_rng(seed)
    ro = rng.uniform(-1.0, 2.0, (n, 3)).astype(np.float32)
    x, y, z = (v.numpy() for v in morton.decode(codes[rng.integers(0, codes.shape[0], n)]))
    vox = np.stack([x, y, z], -1).astype(np.float32)
    rd = ((vox + 0.5) / GRID - ro).astype(np.float32)
    m = n // 8
    rd[:m, 0] = 0.0
    rd[m:2 * m, 1] = -0.0
    rd[2 * m:3 * m, :2] = -0.0
    ro[3 * m:4 * m] = rng.uniform(0.0, 1.0, (m, 3)).astype(np.float32)
    ro[4 * m:5 * m] = (rng.integers(0, GRID + 1, (m, 3)) / GRID).astype(np.float32)
    rd[4 * m:6 * m] = DIRS[rng.integers(0, len(DIRS), 2 * m)]
    ro[5 * m:5 * m + m // 2] = ((vox[5 * m:5 * m + m // 2] + 0.25) / GRID).astype(np.float32)
    face = vox[5 * m + m // 2:6 * m] + 0.5
    face[:, 0] -= 0.5
    ro[5 * m + m // 2:6 * m] = (face / GRID).astype(np.float32)
    k = 6 * m
    ro[k:k + 8] = 1e9
    rd[k + 8] = np.nan
    ro[k + 9, 1] = np.nan
    ro[k + 10] = np.inf
    rd[k + 11] = 0.0
    rd[k + 12, 2] = np.inf
    rd[k + 13, 0] = -np.inf
    # far origins (10^3 to 10^6 boxes away): deep planes round together, so
    # a half's interval is empty in front of the origin
    far = slice(7 * m, 8 * m)
    u = rng.normal(size=(m, 3))
    ro[far] = (0.5 + u / np.linalg.norm(u, axis=1, keepdims=True)
               * 10.0 ** rng.uniform(3, 6, (m, 1))).astype(np.float32)
    rd[far] = ((vox[far] + 0.5) / GRID - ro[far]).astype(np.float32)
    return torch.from_numpy(ro), torch.from_numpy(rd)


CASES = [("sparse", True), ("sparse", False), ("solid", True), ("full", True)]


@pytest.mark.parametrize("name,dag", CASES)
def test_mask_equals_accepted_octants_at_every_walk_step(name, dag):
    tree = build(name, dag)
    ro, rd = rays(trees()[name], 768, 5)
    seen = [0, 0]

    def on_step(st):
        a = st["active"]
        live = {k: v[a] for k, v in st.items() if v.dim() == 1}
        got, want = mask_of(live), accepted(live)
        first = live["rk_c"] < 0  # a first visit: the resume key takes every octant
        assert not bool((want & ~got).any()), f"{name}: the mask misses accepted octants"
        assert torch.equal(got[first], want[first]), f"{name}: the mask holds refused octants"
        seen[0] += int(a.sum())
        seen[1] += int((want != 0).sum())

    t, _nmaj, _vidx = traverse2.intersect_rays2_plain(
        *walk_args(tree), ro, rd, stack_depth=6, on_step=on_step)
    assert seen[0] > 1000 and seen[1] > 0.5 * seen[0]
    assert int((t < 1e37).sum()) > 200


SPECIAL = [-np.inf, -3.0, -1.0, -0.0, 0.0, 1.0, 2.0, 3.0, np.inf]


def planes_state(t1, dt, scale, node_mask, vmask):
    n = t1.shape[0]
    return dict(t1x=t1[:, 0], t1y=t1[:, 1], t1z=t1[:, 2], dtx=dt[:, 0], dty=dt[:, 1],
                dtz=dt[:, 2], scale=torch.full((n,), scale, dtype=torch.float32),
                node=node_mask << 24, vmask=vmask)


@pytest.mark.parametrize("case", ["ties", "signed zeros and inf", "nan plane", "nan axis",
                                  "dt zero", "scale 2^-15"])
def test_mask_equals_accepted_octants_on_hand_made_planes(case):
    """t1 and dt picked so that the planes tie within and across axes, hold
    ±0 and ±inf, NaN in one plane (t1 or dt of one axis) or a whole axis,
    have dt = 0 on an axis, or sit at the deepest scale a 16-deep stack
    reaches."""
    st = hand_made_planes(case)
    got, want = mask_of(st), accepted(st)
    assert torch.equal(got, want), case
    if not case.startswith("nan"):
        assert int((want != 0).sum()) > st["node"].shape[0] // 20, case


def hand_made_planes(case):
    rng = np.random.default_rng(len(case))
    n = 4096
    scale = 2.0 ** -15 if case == "scale 2^-15" else 1.0
    pick = SPECIAL if case == "signed zeros and inf" else [-2, -1, -0.5, 0, 0.5, 1, 2, 3]
    dt = rng.choice(np.asarray([0, 0.5, 1, 2, 4], np.float32), size=(n, 3))
    # most lanes' boxes share a corner plane, so that many octants are crossed
    t1 = (rng.choice(np.asarray(pick, np.float32), size=(n, 1))
          + dt * rng.choice(np.asarray([0.5, 1, 1.5], np.float32), size=(n, 3)))
    t1[: n // 4] = rng.choice(np.asarray(pick, np.float32), size=(n // 4, 3))
    t1 = (t1 * np.float32(scale)).astype(np.float32)
    if case == "signed zeros and inf":
        dt[rng.random((n, 3)) < 0.2] = np.inf
    lane, axis = np.arange(n), rng.integers(0, 3, n)
    if case == "nan plane":
        (t1 if rng.integers(2) else dt)[lane, axis] = np.nan
        t1[: n // 2, 0] = np.nan
        dt[n // 2:, 1] = np.nan
    elif case == "nan axis":
        t1[lane, axis] = np.nan
        dt[lane, axis] = np.nan
    elif case == "dt zero":
        dt[rng.random((n, 3)) < 0.1] = 0.0  # an axis with dt = 0 has no half interval
    st = planes_state(torch.from_numpy(t1.astype(np.float32)),
                      torch.from_numpy(dt.astype(np.float32)), scale,
                      torch.from_numpy(rng.integers(0, 256, n)), torch.from_numpy(
                          rng.integers(0, 8, n)))
    return st


def host_list(lib, st):
    """The kernel's own crossed_octants (compiled for the host) on each
    lane's planes and occupancy: (the listed octants as a mask over the
    node's own bits, [n, 4] the listed octants in list order, -1 where not
    listed)."""
    n = st["node"].shape[0]
    t1 = torch.stack([st["t1x"], st["t1y"], st["t1z"]], 1).contiguous()
    dt = torch.stack([st["dtx"], st["dty"], st["dtz"]], 1).contiguous()
    scale, vm = st["scale"].contiguous(), st["vmask"].contiguous()
    occ = ((st["node"] >> 24) & 0xFF).contiguous()
    out = torch.empty(n, dtype=torch.int64)
    lib.host_crossed_octants(t1.data_ptr(), dt.data_ptr(), scale.data_ptr(), vm.data_ptr(),
                             occ.data_ptr(), out.data_ptr(), n)
    k = torch.arange(4)
    listed = ((out[:, None] >> (12 + k)) & 1) == 1
    octs = torch.where(listed, (out[:, None] >> (3 * k)) & 7, -1)
    return torch.where(listed, ONE[None, :4] << octs.clamp(min=0), 0).sum(1), octs


def assert_list(lib, st, what):
    """The kernel's list holds exactly the accepted occupied octants, in
    the order of their entries."""
    mask, octs = host_list(lib, st)
    assert torch.equal(mask, mask_of(st)), f"{what}: the list != the plain mask"
    en, _ex, _occ = entry_exit(st)
    walk = torch.where(octs >= 0, octs ^ st["vmask"][:, None], 0)
    t = torch.where(octs >= 0, en.gather(1, walk), float("inf"))
    listed = octs >= 0
    for j in range(1, 4):  # listed entries after an earlier one enter strictly later
        earlier = torch.where(listed[:, :j], t[:, :j], -float("inf")).amax(1)
        assert bool((~listed[:, j] | (t[:, j] > earlier)).all()), f"{what}: list out of order"
    return int((mask != 0).sum())


@pytest.mark.parametrize("case", ["ties", "dt zero", "scale 2^-15"])
def test_kernel_list_on_host_equals_plain_mask_on_hand_made_planes(host_walks, case):
    """The kernel's own crossed_octants (compiled for the host) on the
    hand-made planes a walk can make (finite t1, dt >= 0): the octants it
    lists are crossed_octants_plain's, in the order of their entries."""
    assert assert_list(host_walks, hand_made_planes(case), case) > 200


@pytest.mark.parametrize("name,dag", [("sparse", True), ("solid", False), ("full", True)])
def test_kernel_list_on_host_equals_plain_mask_at_every_walk_step(host_walks, name, dag):
    tree = build(name, dag)
    ro, rd = rays(trees()[name], 768, 13)
    seen = [0]

    def on_step(st):
        first = st["active"] & (st["rk_c"] < 0)  # a visit that builds its list
        seen[0] += assert_list(host_walks, {k: v[first] for k, v in st.items() if v.dim() == 1},
                               f"{name} walk step")

    traverse2.intersect_rays2_plain(*walk_args(tree), ro, rd, stack_depth=6, on_step=on_step)
    assert seen[0] > 1000


@pytest.mark.parametrize("name,dag", CASES)
def test_look_ahead_empty_equals_the_next_step_popping(name, dag):
    """At every descend of the plain walk, the look-ahead from the parent's
    state, the octant taken and the child word is empty exactly where the
    child's first visit finds nothing (the walk pops or ends there)."""
    tree = build(name, dag)
    meta, root, lower, upper = walk_args(tree)
    ro, rd = rays(trees()[name], 1024, 7)
    st = traverse2.v2_state(root, lower, upper, ro, rd, 6)
    body = traverse2._v2_body(meta, False)
    counts = [0, 0]
    pending = None  # (lanes that descended, the look-ahead's verdict)
    for _ in range(200):
        act = st["active"]
        if not bool(act.any()):
            break
        if pending is not None:  # the child's first visit: does it find an octant?
            lanes, empty = pending
            finds = mask_of({k: v[lanes] for k, v in st.items() if v.dim() == 1}) != 0
            assert torch.equal(~finds, empty), f"{name}: look-ahead != the child's visit"
            counts[0] += int(lanes.shape[0])
            counts[1] += int(empty.sum())
        pre = {k: v for k, v in st.items() if v.dim() == 1}
        st = body(dict(st))
        desc = act & st["active"] & (st["sp"] >= pre["sp"]) & (st["scale"] != pre["scale"])
        lanes = torch.nonzero(desc).reshape(-1)
        # the octant taken: the body's own selection on the parent's visit
        parent = {k: v[lanes] for k, v in pre.items()}
        en, ex, occ = entry_exit(parent)
        best_c = traverse2._select_child(en, ex, occ, parent["rk_t"], parent["rk_c"],
                                         OCTANT[None, :], 8, strict=False)[1]
        # the child word, as the body reads it from the parent's row
        real = (best_c ^ pre["vmask"][lanes]) & 7
        child = meta[pre["node"][lanes] & 0xFFFFFF, real].to(torch.int64) & MASK32
        assert torch.equal(child, st["node"][lanes])
        la = traverse2.child_octants_plain(*(pre[k][lanes] for k in (
            "t1x", "t1y", "t1z", "dtx", "dty", "dtz", "scale", "vmask")), best_c, child)
        pending = (lanes, la == 0)
    assert counts[0] > 1000 and counts[1] < counts[0], counts
    assert counts[1] > 0 or name == "full", counts  # a full grid has no empty child


@pytest.mark.parametrize("name,dag", [("sparse", True), ("solid", False)])
def test_end_iteration_decides_every_cut(name, dag):
    """fold_counts' terminating iteration: a walk cut at max_iters keeps
    exactly the hits whose end_it is below it, and its own counts agree."""
    tree = build(name, dag)
    ro, rd = rays(trees()[name], 768, 11)
    args = (*walk_args(tree), ro, rd)
    full = traverse2.fold_counts(*args, stack_depth=6)
    t_full, nmaj_full, _ = traverse2.intersect_rays2_plain(*args, stack_depth=6)
    assert torch.equal(full["hit"], t_full < 1e37)
    for m in (1, 2, 3, 7, 12):
        t, nmaj, _ = traverse2.intersect_rays2_plain(*args, stack_depth=6, max_iters=m)
        keep = full["hit"] & (full["end_it"] < m)
        assert torch.equal(t < 1e37, keep), f"max_iters {m}"
        assert torch.equal(nmaj[keep], nmaj_full[keep])
        cut = traverse2.fold_counts(*args, stack_depth=6, max_iters=m)
        ended = full["end_it"] < m
        assert torch.equal(cut["end_it"][ended], full["end_it"][ended])
        assert bool((cut["end_it"][~ended & (full["end_it"] >= 0)] == m).all())
    assert full["hits"] == int(full["hit"].sum()) and full["empty_first"] > 0
    assert full["descends"] + full["hits"] + full["stays"] + full["pops"] + full["misses"] == \
        int((full["end_it"] + 1).clamp(min=0).sum())


# ---------------------------------------------------------------------------
# the kernel source on the host
# ---------------------------------------------------------------------------

TRIPS = r"""
static long long* g_trips = nullptr;
inline void host_trip(long long i) { if (g_trips) ++g_trips[i]; }
extern "C" void set_trips(long long* p) { g_trips = p; }
"""


HOST_MASK = r"""
extern "C" void host_crossed_octants(const float* t1, const float* dt, const float* scale,
                                     const long long* vm, const long long* occ, long long* out,
                                     long long n) {
  for (long long i = 0; i < n; ++i)
    out[i] = crossed_octants(t1[3 * i], t1[3 * i + 1], t1[3 * i + 2], dt[3 * i],
                             dt[3 * i + 1], dt[3 * i + 2], scale[i],
                             static_cast<uint32_t>(vm[i]), static_cast<uint32_t>(occ[i]));
}
"""


@pytest.fixture(scope="module")
def host_walks(tmp_path_factory):
    """csrc/walks.cu compiled for the host, each launch a loop over its
    blocks and threads, the octree walk's loop head counting its trips."""
    d = tmp_path_factory.mktemp("octree_walk_host")
    with open(os.path.join(cuda_build.CSRC, "walks.cu")) as f:
        src = f.read()
    src, n = cuda_host_stub.rewrite_launches(src)
    assert n == 1 and "<<<" not in src
    head = "long long it = 0;\n    for (;;) {\n"
    assert src.count(head) == 1
    src = src.replace(head, head + "      host_trip(i);\n")
    src += HOST_MASK
    lib = cuda_host_stub.build(d, "octree_walk_host", src, extra=TRIPS)
    p, q, u, i, f = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_uint, ctypes.c_int,
                     ctypes.c_float)
    lib.octree_walk_launch.argtypes = [i, p, q, p, p, p, q, u, i, q, f, f, f, p, p, p, p]
    lib.octree_walk_launch.restype = ctypes.c_int
    lib.set_trips.argtypes = [p]
    lib.host_crossed_octants.argtypes = [p, p, p, p, p, p, q]
    return lib


def host_octree_walk(lib, tree, ro, rd, depth, shadow, max_iters):
    meta, root, lower, upper = walk_args(tree)
    head, out, _keep = traverse.walk_launch_args(meta, root, lower, upper, ro, rd,
                                                 depth=depth, max_iters=max_iters)
    trips = torch.zeros(ro.shape[0], dtype=torch.int64)
    lib.set_trips(trips.data_ptr())
    try:
        assert lib.octree_walk_launch(int(shadow), *head, None) == 0
    finally:
        lib.set_trips(None)
    return out, trips


def assert_bits(got, want, what):
    for g, w, name in zip(got, want, ("t", "nmajor", "vidx")):
        if g.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        assert torch.equal(g, w), f"{what}: {name} differs"


@pytest.mark.parametrize("name,dag", CASES)
@pytest.mark.parametrize("shadow", [False, True])
def test_kernel_source_on_host_equals_plain_walk(host_walks, name, dag, shadow):
    tree = build(name, dag)
    ro, rd = rays(trees()[name], 1024, 9)
    for depth, max_iters in ((6, 1), (6, 2), (6, 3), (6, 7), (6, 100_000), (1, 100_000),
                             (2, 100_000), (3, 7), (3, 100_000)):
        what = f"{name} dag={dag} shadow={shadow} stack {depth} max_iters {max_iters}"
        kw = dict(stack_depth=depth, shadow=shadow, max_iters=max_iters)
        want = traverse2.intersect_rays2_plain(*walk_args(tree), ro, rd, **kw)
        got, trips = host_octree_walk(host_walks, tree, ro, rd, depth, shadow, max_iters)
        assert_bits(got, want, what)
        counted = traverse2.fold_counts(*walk_args(tree), ro, rd, **kw)
        assert torch.equal(trips, counted["trips"]), f"{what}: trips differ"
        if depth == 6 and max_iters == 100_000:
            assert int((want[0] < 1e37).sum()) > 300
            visits = sum(counted[k] for k in ("descends", "hits", "misses", "stays", "pops"))
            outside = int((counted["end_it"] < 0).sum())  # one trip, no iteration
            assert int(trips.sum()) - outside < visits - counted["empty_first"] // 2


# ---------------------------------------------------------------------------
# the measurement helpers
# ---------------------------------------------------------------------------

def test_walk_rows_counts_the_fold():
    from massivevoxelraytracing_torch.scripts import common

    tree = build("sparse", True)
    ro, rd = rays(trees()["sparse"], 256, 3)
    got = common.walk_rows("octree", 6, *walk_args(tree), ro, rd)
    assert set(got) == {"entered", "rows", "visits", "trips", *traverse2.FOLD_EVENTS}
    assert got["visits"] == (got["descends"] + got["hits"] + got["misses"] + got["stays"]
                             + got["pops"])
    assert 0 < got["crossed"] < got["occupied"] <= 8 * got["visits"]
    assert 0 < got["trips"] < got["visits"]
    assert "loop trips" in common.visit_note(got)


def test_walk_ab_takes_the_octree_walk_and_needs_a_card():
    from massivevoxelraytracing_torch.scripts import walk_ab

    log = ("ptxas info    : Compiling entry function '_ZN18octree_walk_kernelILb0EEEv8WalkArgs' "
           "for 'sm_90a'\nptxas info    : Function properties for octree_walk_kernelILb0E\n"
           "    384 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
           "ptxas info    : Used 44 registers, used 0 barriers\n"
           "ptxas info    : Compiling entry function '_ZN18octree_walk_kernelILb1EEEv8WalkArgs' "
           "for 'sm_90a'\nptxas info    : Used 39 registers\n"
           "ptxas info    : Compiling entry function '_Z17brick_walk_kernel8WalkArgs' for "
           "'sm_90a'\nptxas info    : Used 62 registers\n")
    lines = walk_ab.ptxas_lines(log, "octree_walk_kernel")
    assert len(lines) == 4 and "44 registers" in lines[2] and "39 registers" in lines[3]
    with pytest.raises(RuntimeError, match="needs a card"):
        walk_ab.run([], device="cpu", kernel="octree_walk")
