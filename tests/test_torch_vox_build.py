"""The scene build's three stages (ops/voxelize.py: count, emit,
unique_reduce) against the JAX package, on test_torch_voxelize's 64^3
icosphere and bumpy sphere, and build_scene / the wrappers on the CPU.

  * count_plain: the JAX package's voxelize_dense, run op by op
    (jax.disable_jit: no fusion, no FMA contraction), its valid mask
    summed a triangle, for both values of six_separating;
  * emit_plain: the same reference's valid candidates, taken in candidate
    order (the Morton code from its (hi, lo) limbs), entry for entry in
    the dump buffers;
  * unique_reduce_plain in its three modes, through sort_and_unique,
    sort_and_unique_sums and merge_unique_sums, against the JAX package's
    same three functions on the same candidates: exact (integer code);
    and called as the stage (after torch.sort) on hand-made streams (an
    invalid tail, one key, every entry its own run, a run longer than a
    tile, the empty stream) against the same functions (sort_and_unique
    and sort_and_unique_sums with a valid mask), exactly, with
    run_heads_plain's tile counts; UNIQUE_TILE is the kernels' tile;
  * build_scene on the CPU gives the same tree at chunk_tris 1,024 and
    65,536, through the wrappers and through the plain stages;
  * the wrappers refuse a wrong dtype, shape or device before any launch
    (no counter moves);
  * count_columns / emit_columns, the kernels' enumeration as tensor code
    (each triangle's units, a column and a run of up to 32 Z cells, from
    the scan of its unit count; the slab-clipped z range; the rank within
    the triangle to the position), bit-equal to count_plain / emit_plain
    (and through them to the JAX voxelizer op by op) for both values of
    six_separating, on the edge cases the card tests use, at cap 1, 2, 4
    and 32 (a triangle of more than 256 units), at cap 64 (columns of two
    runs of Z cells; both values of six_separating, gapped offsets and a
    cut), and with gapped offsets and an n_out that cuts the last
    triangle's run; the enumeration's Z_CELLS is the kernels' kZCells.

The kernels themselves run on the card only (tests/test_torch_cuda.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from massivevoxelraytracing_tpu.ops import voxelize as jvox
from massivevoxelraytracing_torch.models import scene
from massivevoxelraytracing_torch.ops import morton
from massivevoxelraytracing_torch.ops import voxelize as vox
from massivevoxelraytracing_torch.utils import meshprep

from test_torch_voxelize import GRID, MESHES, jax_cands_from_port, mesh_inputs, unique_codes

# The tensors here are small: one intra-op thread keeps the test runner's
# parallel workers from oversubscribing the cores.
torch.set_num_threads(1)

CAP = 4
CASES = [(name, six) for name in MESHES for six in (False, True)]


@pytest.fixture(scope="module", params=CASES, ids=[f"{n}-{'six' if s else 'cons'}"
                                                    for n, s in CASES])
def case(request):
    """The split triangles of one mesh, the JAX op-by-op candidates, and
    the port's count and emit through the plain stages."""
    name, six = request.param
    tri, col, emi, origin, dps = mesh_inputs(name)
    t, c, e = meshprep.split_to_cap(tri, col, emi, origin, dps, GRID, CAP)
    with jax.disable_jit():
        ref = {k: np.asarray(v) for k, v in jvox.voxelize_dense(
            jnp.asarray(t), jnp.asarray(c), jnp.asarray(e), jnp.asarray(origin), dps,
            grid_res=GRID, six_separating=six, cap=CAP).items()}
    tt, ct, et = (torch.from_numpy(np.ascontiguousarray(a)) for a in (t, c, e))
    origin_t = torch.from_numpy(origin)
    dps_t = torch.tensor(dps, dtype=torch.float32)
    kw = dict(grid_res=GRID, six_separating=six, cap=CAP)
    counts = vox.count_plain(tt, origin_t, dps_t, **kw)
    end = torch.cumsum(counts, 0, dtype=torch.int64)
    n = int(end[-1])
    out = (torch.full((n,), -1, dtype=torch.int64), torch.zeros(n, dtype=torch.int32),
           torch.zeros(n, dtype=torch.int32))
    vox.emit_plain(tt, ct, et, end - counts, origin_t, dps_t, out, **kw)
    return dict(ref=ref, counts=counts, dump=out, n_tri=len(t), name=name, six=six)


def test_count_plain_equals_jax_op_by_op(case):
    ref, counts = case["ref"], case["counts"]
    assert counts.dtype == torch.int32 and counts.shape == (case["n_tri"],)
    want = ref["valid"].reshape(case["n_tri"], CAP ** 3).sum(1)
    np.testing.assert_array_equal(counts.numpy(), want)
    assert (want > 0).mean() > 0.9 and want.max() <= CAP ** 3


def test_emit_plain_equals_jax_op_by_op(case):
    """Valid candidates in increasing (triangle, candidate) order: the
    order of the reference's flattened mask."""
    ref = case["ref"]
    valid = ref["valid"]
    code, color, emission = (x.numpy() for x in case["dump"])
    assert len(code) == int(valid.sum())
    want = morton.from_pair(torch.from_numpy(ref["m_hi"][valid].astype(np.int64)),
                            torch.from_numpy(ref["m_lo"][valid].astype(np.int64))).numpy()
    np.testing.assert_array_equal(code, want)
    np.testing.assert_array_equal(color.view(np.uint32), ref["color"][valid])
    np.testing.assert_array_equal(emission.view(np.uint32), ref["emission"][valid])


def _jax_cands(dump):
    code, color, emission = dump
    return jax_cands_from_port(dict(valid=torch.ones_like(code, dtype=torch.bool),
                                    code=code, color=color, emission=emission))


def _assert_unique(got, want):
    n = int(want["n_unique"])
    assert got["n_unique"] == n
    np.testing.assert_array_equal(got["code"].numpy(), unique_codes(want, n))
    for key in ("color", "emission"):
        np.testing.assert_array_equal(got[key].numpy().view(np.uint32),
                                      np.asarray(want[key])[:n])
    assert got["has_emission"] == bool(want["has_emission"])


@pytest.mark.parametrize("mode", vox.MODES)
def test_unique_reduce_plain_equals_jax(case, mode):
    """"means": sort_and_unique; "sums": sort_and_unique_sums on two
    groups; "merge": merge_unique_sums of those groups' sums. Each against
    the JAX package's function of the same name, exact."""
    dump = case["dump"]
    jc = _jax_cands(dump)
    if mode == "means":
        _assert_unique(vox.sort_and_unique(dict(code=dump[0], color=dump[1],
                                                emission=dump[2]), stages="plain"),
                       jvox.sort_and_unique(jc))
        return
    n = len(dump[0])
    cuts = (slice(0, n // 3), slice(n // 3, n))
    parts, jparts = [], []
    for sl in cuts:
        parts.append(vox.sort_and_unique_sums(*(x[sl] for x in dump), stages="plain"))
        jparts.append(jvox.sort_and_unique_sums(jc["m_hi"][sl], jc["m_lo"][sl],
                                                jc["color"][sl], jc["emission"][sl],
                                                jc["valid"][sl]))
    if mode == "sums":
        for ((code, sums6, count), nu), (jout, jn) in zip(parts, jparts):
            assert nu == int(jn)
            np.testing.assert_array_equal(
                code.numpy(), unique_codes(dict(m_hi=jout[0], m_lo=jout[1]), nu))
            for got, want in zip((*sums6, count), jout[2:]):
                np.testing.assert_array_equal(got.numpy(), np.asarray(want)[:nu])
        return
    merged = vox.merge_unique_sums(
        torch.cat([p[0][0] for p in parts]),
        [torch.cat([p[0][1][i] for p in parts]) for i in range(6)],
        torch.cat([p[0][2] for p in parts]), stages="plain")
    cat = [jnp.concatenate([p[0][i] for p in jparts]) for i in range(9)]
    _assert_unique(merged, jvox.merge_unique_sums(cat[0], cat[1], cat[2:8], cat[8]))


# hand-made streams of the unique stage: (valid codes as (key, run length)
# pairs, invalid entries); shuffled before the sort
STREAMS = {
    "invalid_tail": ([(5, 3), (9, 1), (12, 4), (40, 2), (41, 1), (77, 6)], 9),
    "one_key": ([(123456789, 30)], 0),
    "each_own_run": ([(3 * k + 1, 1) for k in range(25)], 0),
    "run_past_a_tile": ([(2, 2), (1 << 40, 2500), ((1 << 40) + 1, 1), (7, 3)], 2),
    "empty": ([], 0),
}


def _stream(name, seed):
    """(code int64, valid bool, color int32, emission int32, sums6 + count
    int64 for the merge) of a hand-made stream, shuffled."""
    runs, n_invalid = STREAMS[name]
    rng = np.random.default_rng(seed)
    code = np.concatenate([np.full(n, k, np.int64) for k, n in runs]
                          + [rng.integers(0, 1 << 50, n_invalid)]).astype(np.int64)
    valid = np.arange(len(code)) < len(code) - n_invalid
    order = rng.permutation(len(code))
    code, valid = code[order], valid[order]
    n = len(code)
    color = rng.integers(-2**31, 2**31, n).astype(np.int32)
    emission = rng.integers(-2**31, 2**31, n).astype(np.int32)
    sums = [np.where(valid, rng.integers(0, 1 << 16, n), 0).astype(np.int64) for _ in range(6)]
    count = np.where(valid, rng.integers(1, 9, n), 0).astype(np.int64)
    return code, valid, color, emission, sums + [count]


def _limbs(code, valid):
    """The JAX package's (m_hi, m_lo) uint32 limbs, invalid entries all ones."""
    hi, lo = morton.to_pair(torch.from_numpy(code))
    hi = np.where(valid, hi.numpy().astype(np.uint32), np.uint32(0xFFFFFFFF))
    lo = np.where(valid, lo.numpy().astype(np.uint32), np.uint32(0xFFFFFFFF))
    return jnp.asarray(hi), jnp.asarray(lo)


@pytest.mark.parametrize("mode", vox.MODES)
@pytest.mark.parametrize("name", list(STREAMS))
def test_unique_stage_plain_on_hand_made_streams(name, mode):
    """unique_reduce_plain after torch.sort (the stage as the wrappers call
    it) against the JAX package: "means" against sort_and_unique with the
    valid mask, "sums" against sort_and_unique_sums with it, "merge" (the
    invalid entries' codes INVALID_KEY, as a group's padding) against
    merge_unique_sums, exactly; run_heads_plain's tiles add up to n_unique."""
    code, valid, color, emission, merge_in = _stream(name, seed=len(name))
    t_valid = torch.from_numpy(valid)
    key = vox._key(torch.from_numpy(code), t_valid)
    s_key, perm = torch.sort(key, stable=True)
    hi, lo = _limbs(code, valid)
    jcol, jemi = jnp.asarray(color.view(np.uint32)), jnp.asarray(emission.view(np.uint32))
    if mode == "merge":
        attrs = tuple(torch.from_numpy(x) for x in merge_in)
        (u_code, u_col, u_emi), nu = vox.unique_reduce_plain(s_key, perm, attrs, mode=mode)
        want = jvox.merge_unique_sums(hi, lo, [jnp.asarray(x.astype(np.uint32))
                                               for x in merge_in[:6]],
                                      jnp.asarray(merge_in[6].astype(np.uint32)))
        _assert_unique(dict(code=u_code, color=u_col, emission=u_emi, n_unique=nu,
                            has_emission=vox._has_emission(u_emi)), want)
    elif mode == "means":
        (u_code, u_col, u_emi), nu = vox.unique_reduce_plain(
            s_key, perm, (torch.from_numpy(color), torch.from_numpy(emission)), mode=mode)
        want = jvox.sort_and_unique(dict(m_hi=hi, m_lo=lo, color=jcol, emission=jemi,
                                         valid=jnp.asarray(valid)))
        _assert_unique(dict(code=u_code, color=u_col, emission=u_emi, n_unique=nu,
                            has_emission=vox._has_emission(u_emi)), want)
    else:
        (u_code, sums6, count), nu = vox.unique_reduce_plain(
            s_key, perm, (torch.from_numpy(color), torch.from_numpy(emission)), mode=mode)
        jout, jn = jvox.sort_and_unique_sums(hi, lo, jcol, jemi, jnp.asarray(valid))
        assert nu == int(jn)
        np.testing.assert_array_equal(u_code.numpy(),
                                      unique_codes(dict(m_hi=jout[0], m_lo=jout[1]), nu))
        for got, w in zip((*sums6, count), jout[2:]):
            np.testing.assert_array_equal(got.numpy(), np.asarray(w)[:nu])
    n_runs = len(STREAMS[name][0])
    assert nu == n_runs
    heads = vox.run_heads_plain(s_key)
    tile = vox.UNIQUE_TILE
    assert heads.dtype == torch.int64 and len(heads) == -(-len(code) // tile)
    assert int(heads.sum()) == nu
    firsts = torch.unique_consecutive(s_key[s_key != vox.INVALID_KEY], return_counts=True)[1]
    first_at = torch.cumsum(firsts, 0) - firsts
    assert torch.equal(heads, torch.bincount(first_at // tile, minlength=len(heads)))


def test_unique_tile_matches_the_kernels():
    """UNIQUE_TILE is the kernels' tile: kThreads * kUniqueItems."""
    import re
    from pathlib import Path

    src = (Path(vox.__file__).parent.parent / "csrc" / "vox_build.cu").read_text()
    threads = int(re.search(r"constexpr int kThreads = (\d+);", src).group(1))
    items = int(re.search(r"constexpr int kUniqueItems = (\d+);", src).group(1))
    assert vox.UNIQUE_TILE == threads * items


@pytest.mark.parametrize("stages", [None, "plain"])
def test_build_scene_same_tree_at_both_chunk_sizes(stages, monkeypatch):
    """build_scene on the CPU, through the wrappers (stages None) and the
    plain stages chunk by chunk: the same tree at chunk_tris 1,024 and
    65,536, and the same again through the grouped unique."""
    tri, col, emi, origin, dps = mesh_inputs("bumpy")
    kw = dict(origin=origin, dps=dps, grid_res=GRID, device="cpu", stages=stages)
    trees = [scene.build_scene(tri, col, emi, chunk_tris=c, **kw) for c in (1024, 65536)]
    monkeypatch.setattr(scene, "GROUP_DUMPED", 5000)
    trees.append(scene.build_scene(tri, col, emi, chunk_tris=1024, **kw))
    assert trees[2].build_stats["n_dumped"] > 3 * 5000
    for t in trees[1:]:
        for k in ("n_triangles", "n_dumped", "n_unique", "n_nodes"):
            assert t.build_stats[k] == trees[0].build_stats[k], k
        for key in ("bricks", "color", "emission"):
            assert torch.equal(getattr(t, key), getattr(trees[0], key)), key
    assert trees[0].has_emission


def _small_inputs():
    rng = np.random.default_rng(3)
    tri = torch.from_numpy(rng.uniform(0.1, 0.9, (16, 3, 3)).astype(np.float32))
    col = torch.from_numpy(rng.uniform(0.0, 1.0, (16, 3, 3)).astype(np.float32))
    return tri, col, torch.zeros_like(col), torch.zeros(3), torch.tensor(1.0 / 16)


def test_wrappers_refuse_bad_inputs_and_count_nothing():
    tri, col, emi, origin, dps = _small_inputs()
    kw = dict(grid_res=16, six_separating=True, cap=CAP)
    vox.reset_counters()
    with pytest.raises(ValueError, match="tri"):
        vox.count(tri.double(), origin, dps, **kw)
    with pytest.raises(ValueError, match="dps"):
        vox.count(tri, origin, torch.tensor([1.0 / 16]), **kw)
    with pytest.raises(ValueError, match="no voxelize kernel"):
        vox.count(tri.to("meta"), origin, dps, **kw)
    with pytest.raises(ValueError, match="origin"):
        vox.count(tri, origin.to("meta"), dps, **kw)
    with pytest.raises(ValueError, match="grid_res"):
        vox.count(tri, origin, dps, grid_res=1 << 22, cap=CAP)
    counts = vox.count(tri, origin, dps, **kw)  # the plain stage on the CPU
    end = torch.cumsum(counts, 0, dtype=torch.int64)
    n = int(end[-1])
    out = (torch.empty(n, dtype=torch.int64), torch.empty(n, dtype=torch.int32),
           torch.empty(n, dtype=torch.int32))
    with pytest.raises(ValueError, match="offsets"):
        vox.emit(tri, col, emi, (end - counts).int(), origin, dps, out, **kw)
    with pytest.raises(ValueError, match="color"):
        vox.emit(tri, col, emi, end - counts, origin, dps, (out[0], out[1].long(), out[2]), **kw)
    with pytest.raises(ValueError, match="col"):
        vox.emit(tri, col[:3], emi, end - counts, origin, dps, out, **kw)
    vox.emit(tri, col, emi, end - counts, origin, dps, out, **kw)
    s_key, perm = torch.sort(out[0], stable=True)
    with pytest.raises(ValueError, match="mode"):
        vox.unique_reduce(s_key, perm, out[1:], mode="mean")
    with pytest.raises(ValueError, match="takes 7"):
        vox.unique_reduce(s_key, perm, out[1:], mode="merge")
    with pytest.raises(ValueError, match="attrs"):
        vox.unique_reduce(s_key, perm, (out[1], out[2].long()), mode="means")
    with pytest.raises(ValueError, match="perm"):
        vox.unique_reduce(s_key, perm.int(), out[1:], mode="means")
    with pytest.raises(ValueError, match="s_key"):
        vox.run_heads(s_key[None])
    with pytest.raises(ValueError, match="ends"):
        vox.reduce_tiles(s_key, perm, out[1:], torch.zeros(2, dtype=torch.int64), 1,
                         mode="means")
    with pytest.raises(ValueError, match="stages"):
        vox.sort_and_unique(dict(code=out[0], color=out[1], emission=out[2]), stages="cuda")
    got, nu = vox.unique_reduce(s_key, perm, out[1:], mode="means")
    assert len(got[0]) == nu > 0
    ends = torch.cumsum(vox.run_heads(s_key), 0)
    assert int(ends[-1]) == nu
    for x, y in zip(vox.reduce_tiles(s_key, perm, out[1:], ends, nu, mode="means"), got):
        assert torch.equal(x, y)
    assert vox.LAUNCHES == dict.fromkeys(vox.KERNELS, 0)


def test_dump_candidates_equals_the_stages():
    """The apps' one-group path (count, prefix, emit) equals voxelize_dense's
    valid candidates in order."""
    tri, col, emi, origin, dps = _small_inputs()
    kw = dict(grid_res=16, six_separating=False, cap=CAP)
    got = vox.dump_candidates(tri, col, emi, origin, dps, **kw)
    dense = vox.voxelize_dense(tri, col, emi, origin, dps, **kw)
    for key in ("code", "color", "emission"):
        assert torch.equal(got[key], dense[key][dense["valid"]]), key


# ---------------------------------------------------------------------------
# the kernels' enumeration (count_columns / emit_columns) against the plain
# stages
# ---------------------------------------------------------------------------

def _buffers(n):
    return (torch.full((n,), -1, dtype=torch.int64), torch.full((n,), 7, dtype=torch.int32),
            torch.full((n,), 7, dtype=torch.int32))


def columns_equal_plain(t, c, e, origin, dps, *, gaps=None, cut=0, **kw):
    """count_columns == count_plain; emit_columns into buffers cut `cut`
    entries short == emit_plain into full-length ones, up to the cut, with
    `gaps` free entries after each triangle's run. Returns (counts, n)."""
    counts = vox.count_plain(t, origin, dps, **kw)
    assert torch.equal(vox.count_columns(t, origin, dps, **kw), counts)
    step = counts.long() + (0 if gaps is None else gaps)
    end = torch.cumsum(step, 0)
    n = int(end[-1]) if len(end) else 0
    want = vox.emit_plain(t, c, e, end - step, origin, dps, _buffers(n), **kw)
    got = vox.emit_columns(t, c, e, end - step, origin, dps, _buffers(n - cut), **kw)
    for x, y in zip(got, want):
        assert torch.equal(x, y[:n - cut])
    return counts, n


def test_columns_equal_plain_and_jax(case):
    """The module's meshes, both values of six_separating: the enumeration's
    counts == the JAX reference's valid mask summed a triangle, its dump ==
    the plain stage's (held against the JAX candidates above)."""
    ref = case["ref"]
    name, six = case["name"], case["six"]
    tri, col, emi, origin, dps = mesh_inputs(name)
    t, c, e = (torch.from_numpy(np.ascontiguousarray(a)) for a in
               meshprep.split_to_cap(tri, col, emi, origin, dps, GRID, CAP))
    kw = dict(grid_res=GRID, six_separating=six, cap=CAP)
    origin_t, dps_t = torch.from_numpy(origin), torch.tensor(dps, dtype=torch.float32)
    counts = vox.count_columns(t, origin_t, dps_t, **kw)
    np.testing.assert_array_equal(counts.numpy(),
                                  ref["valid"].reshape(case["n_tri"], CAP ** 3).sum(1))
    got = vox.emit_columns(t, c, e, torch.cumsum(counts, 0, dtype=torch.int64) - counts,
                           origin_t, dps_t, _buffers(int(counts.sum())), **kw)
    for x, y in zip(got, case["dump"]):
        assert torch.equal(x, y)


def _edge_inputs():
    """test_torch_cuda's edge cases on the bumpy sphere at 64^3: triangles
    past the grid (one far enough that the bbox's casts saturate on the
    card), padding, a degenerate one, NaN / inf colours, triangles on cell
    corners."""
    tri, col, emi, origin, dps = mesh_inputs("bumpy")
    t, c, e = (torch.from_numpy(np.ascontiguousarray(a)) for a in
               meshprep.split_to_cap(tri, col, emi, origin, dps, GRID, CAP))
    t, c, e = (torch.cat([x, torch.zeros((6, 3, 3))]) for x in (t, c, e))
    origin_t, dps_t = torch.from_numpy(origin), torch.tensor(dps, dtype=torch.float32)
    t[0] += 1.5
    t[1] -= 3.0
    t[2] = t[2] * 1e12
    t[3, 2] = t[3, 0]
    c[4, 0, 0] = float("nan")
    c[5] = float("inf")
    e[6, 1, 2] = float("nan")
    corner = torch.tensor([[0.25, 0.25, 0.25], [0.5, 0.25, 0.25], [0.25, 0.5, 0.25]])
    t[-1] = origin_t + corner * GRID * dps_t
    t[-2] = origin_t + corner[[0, 2, 1]] * GRID * dps_t
    return t.contiguous(), c.contiguous(), e.contiguous(), origin_t, dps_t


@pytest.mark.parametrize("six", [False, True])
def test_columns_equal_plain_on_edge_cases(six):
    t, c, e, origin, dps = _edge_inputs()
    counts, n = columns_equal_plain(t, c, e, origin, dps, grid_res=GRID, six_separating=six,
                                    cap=CAP)
    assert n > 10000 and int(counts[3]) == 0 and int(counts[2]) == 0


BIG = [[-0.8, -0.7, 0.1], [0.8, -0.25, 0.35], [0.05, 0.85, -0.3]]  # ~25 cells across at 32^3
# Two triangles of one plane whose normal's largest axis is z (WIDE[0]) or
# x (WIDE[1]), in fractions of the grid: 44 cells deep along that axis at
# 64^3, so at cap 64 each column is two runs of Z cells and the slab's
# cells lie in both.
WIDE = ([[0.25, 0.25, 0.923], [0.85, 0.4, 0.255], [0.35, 0.9, 0.331]],
        [[0.923, 0.25, 0.25], [0.255, 0.85, 0.4], [0.331, 0.35, 0.9]])


def _mix(T, big_at=(), grid=32, wide_at=()):
    """The first T split triangles of the bumpy sphere at grid^3 (cap 4),
    BIG at the indices `big_at`, WIDE[0] and WIDE[1] at those of `wide_at`."""
    from massivevoxelraytracing_torch.utils import meshgen

    tri, col, emi, _, _ = mesh_inputs("bumpy")
    origin, dps = meshgen.fit_grid(tri, grid)
    origin = np.asarray(origin, np.float32)
    t, c, e = (torch.from_numpy(np.ascontiguousarray(a[:T])) for a in
               meshprep.split_to_cap(tri, col, emi, origin, dps, grid, CAP))
    for i in big_at:
        t[i] = torch.tensor(BIG)
    origin_t, dps_t = torch.from_numpy(origin), torch.tensor(dps, dtype=torch.float32)
    for i, w in zip(wide_at, WIDE):
        t[i] = origin_t + torch.tensor(w) * grid * dps_t
    return t, c, e, origin_t, dps_t


def _cells_past_a_run(t, origin, dps, **kw):
    """Each triangle's valid cells at or past Z_CELLS of its bbox's w start
    (in a unit's second or later run of Z cells)."""
    ctx, cells = vox.column_cells(t, origin, dps, **kw)
    tri = cells["tri"]
    past = cells["valid"] & (cells["Z"] - ctx["lo_w"][tri] >= vox.Z_CELLS)
    return torch.bincount(tri[past], minlength=t.shape[0])


@pytest.mark.parametrize("cap", [1, 2, 4, 32, 64])
def test_columns_equal_plain_at_each_cap(cap):
    """cap 1 and 2 cut the cap-4 triangles' bboxes; at cap 32 one triangle
    has ~600 units (more than a warp's or a block's pass); at cap 64 (a
    64^3 grid) WIDE's columns are two runs of Z cells each."""
    if cap == 64:
        t, c, e, origin, dps = _mix(10, grid=64, wide_at=(5, 8))
    else:
        t, c, e, origin, dps = _mix(40 if cap == 32 else 400, big_at=(5,) if cap == 32 else ())
    grid = 64 if cap == 64 else 32
    counts, n = columns_equal_plain(t, c, e, origin, dps, grid_res=grid, six_separating=True,
                                    cap=cap)
    assert n > 0
    if cap == 32:
        assert int(counts[5]) > 256
    if cap == 64:
        past = _cells_past_a_run(t, origin, dps, grid_res=64, six_separating=True, cap=64)
        assert int(past[5]) > 0 and int(past[8]) > 0


@pytest.mark.parametrize("six", [False, True])
def test_columns_in_several_z_runs_gapped_and_cut(six):
    """cap 64 at 64^3, WIDE (both major axes) among small triangles: the
    units' Z runs, the positions carried across a column's runs, with
    0-2 free entries after each triangle's run and buffers cut 3 entries
    into the last one (WIDE[1])."""
    T = 12
    t, c, e, origin, dps = _mix(T, grid=64, wide_at=(4, T - 1))
    kw = dict(grid_res=64, six_separating=six, cap=64)
    gaps = torch.from_numpy(np.random.default_rng(64).integers(0, 3, T))
    gaps[-1] = 0
    counts, _ = columns_equal_plain(t, c, e, origin, dps, gaps=gaps, cut=3, **kw)
    past = _cells_past_a_run(t, origin, dps, **kw)
    assert int(past[4]) > 0 and int(past[-1]) > 3


def test_z_cells_match_the_kernels():
    """The enumeration's run of Z cells is the kernels' kZCells."""
    import pathlib
    import re

    src = pathlib.Path(vox.__file__).parent.parent / "csrc" / "vox_build.cu"
    got = re.search(r"constexpr int kZCells = (\d+);", src.read_text())
    assert got and int(got.group(1)) == vox.Z_CELLS


@pytest.mark.parametrize("T", [1, 33, 130])
def test_columns_gapped_offsets_and_cut_last_run(T):
    """Offsets with 0-2 free entries after each run, and buffers cut 3
    entries into the last triangle's run (BIG, at cap 32)."""
    t, c, e, origin, dps = _mix(T, big_at=(T - 1,))
    gaps = torch.from_numpy(np.random.default_rng(T).integers(0, 3, T))
    gaps[-1] = 0
    counts, _ = columns_equal_plain(t, c, e, origin, dps, gaps=gaps, cut=3, grid_res=32,
                                    six_separating=False, cap=32)
    assert int(counts[-1]) > 3
