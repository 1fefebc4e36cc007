"""scripts/hako_shell_micro.py's probes on the CPU (plain versions) against
the JAX package's kernel bodies of that script, re-stated here (the
script sets up a TPU runtime when imported) and evaluated op by op under
jax.disable_jit() on the same [16, 128] lanes: the copy shell in both
layouts, the shell + _ray_preamble, the probe body by stage (staged()'s
four kernels) and unrolled (k_body). Integers equal, f32 bit-equal.
Inputs: the script's own (its tree, built by both packages from the same
draws, and its first block of lanes, where most walks find no cell), and
a synthetic tree of two levels (an smem-form level of 40 nodes and a
taa-form level of 300) with random root masks, rays in every direction
and child indices that run past both levels. Then the script itself at
--device cpu, and its refusal without a card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from massivevoxelraytracing_tpu.ops import hako as jhako
from massivevoxelraytracing_tpu.ops import hako_kernels as jk
from massivevoxelraytracing_tpu.ops import morton as jmorton
from massivevoxelraytracing_tpu.ops import octree as joctree
from massivevoxelraytracing_torch.ops import hako_kernels as hk
from massivevoxelraytracing_torch.ops import probes
from massivevoxelraytracing_torch.scripts import hako_shell_micro as sm

# The tensors here are small: one intra-op thread keeps the test runner's
# parallel workers from oversubscribing the cores.
torch.set_num_threads(1)

SHAPE = (16, 128)  # one of the reference's blocks


def script_case():
    """The reference script's draws: eight [16, 128] lane blocks (the
    first block of each array), the JAX tree and the port's tree."""
    rng = np.random.default_rng(0)
    eight = [rng.uniform(0.5, 2.0, (sm.LANES,)).astype(np.float32) for _ in range(8)]
    c = rng.integers(0, 256, size=(60000, 3)).astype(np.uint32)
    m = np.unique(jmorton.np_encode(c[:, 0], c[:, 1], c[:, 2]))
    pad = joctree.bucket(len(m))
    hi, lo = jmorton.np_pack_pair(m)
    hi = np.concatenate([hi, np.full(pad - len(m), 0xFFFFFFFF, np.uint32)])
    lo = np.concatenate([lo, np.full(pad - len(m), 0xFFFFFFFF, np.uint32)])
    jtree = jhako.build_hako(jnp.asarray(hi), jnp.asarray(lo), len(m), 256,
                             lower=np.zeros(3, np.float32), dps=1.0 / 256)
    port_eight, ptree = sm.script_inputs("cpu", SHAPE[0] * SHAPE[1])
    for a, b in zip(port_eight, eight):
        np.testing.assert_array_equal(a.numpy(), b[: a.shape[0]])
    return [x[: SHAPE[0] * SHAPE[1]].reshape(SHAPE) for x in eight], jtree, ptree


@pytest.fixture(scope="module")
def script():
    return script_case()


def test_the_script_tree_is_the_references(script):
    _eight, jtree, ptree = script
    meta, (T, level_rows) = jk.hako_args(jtree)
    assert T == ptree.T == 2 and level_rows == (("smem", 64),)
    assert probes.level_forms(ptree.levels) == [("smem", 64)]
    n = jtree.n_per_level[0]
    assert n == ptree.n_per_level[0] == 64  # the reference's stage 2 clips to 55
    tab = np.asarray(jtree.levels[0])
    nodes = np.stack([tab[0, :n], tab[0, 64:64 + n], tab[0, 128:128 + n]], 1)
    np.testing.assert_array_equal(ptree.levels[0].numpy().view(np.uint32), nodes)
    assert (ptree.root_mask_lo, ptree.root_mask_hi) == (jtree.root_mask_lo,
                                                        jtree.root_mask_hi)
    nb = ptree.n_bricks
    np.testing.assert_array_equal(ptree.bricks.numpy().view(np.uint32),
                                  np.asarray(jtree.bricks)[:nb])


def lanes_t(x):
    return torch.from_numpy(np.ascontiguousarray(x).reshape(-1))


def assert_bits(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w).reshape(-1)
        g = g.numpy().reshape(-1)
        assert g.dtype.itemsize == w.dtype.itemsize
        np.testing.assert_array_equal(g.view(np.int32), w.view(np.int32))


def test_shells_match(script):
    eight = script[0]
    with jax.disable_jit():
        want8 = [jnp.asarray(x) + 1.0 for x in eight]
        one = jnp.stack([jnp.asarray(x).reshape(1, 16, 128) for x in eight], 1)
        want1 = one + 1.0
    assert_bits(probes.shell_copy_plain(*[lanes_t(x) for x in eight]), want8)
    got = probes.shell_copy_plain(torch.from_numpy(np.array(one).reshape(1, 8, 2048)))
    assert_bits(got, [want1])


@pytest.mark.parametrize("arrays", [1, 8])
def test_shell_writes_into_given_outputs(arrays):
    """shell_copy_probe(..., out=) on the CPU: the plain version's values
    in the given arrays, which it returns; a count of outputs other than
    the inputs' is refused."""
    rng = np.random.default_rng(arrays)
    xs = [torch.from_numpy(rng.uniform(0.5, 2.0, 1000).astype(np.float32))
          for _ in range(arrays)]
    outs = [torch.full_like(x, -1.0) for x in xs]
    got = probes.shell_copy_probe(*xs, out=outs)
    assert len(got) == arrays and all(a is b for a, b in zip(got, outs))
    for a, b in zip(outs, probes.shell_copy_plain(*xs)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="arrays in"):
        probes.shell_copy_probe(*xs, out=outs + outs)


def jax_preamble(ro, rd):
    """hako_shell_micro.py k_pre's eight outputs."""
    t0, t1, dt, vm6, ok = jk._ray_preamble([0.0, 0.0, 0.0], [1.0, 1.0, 1.0], ro, rd)
    return ([t0[a] + t1[a] for a in range(3)] + dt
            + [vm6.astype(jnp.float32), ok.astype(jnp.float32)])


def test_preamble_matches(script):
    eight = script[0]
    with jax.disable_jit():
        want = jax_preamble([jnp.asarray(x) for x in eight[:3]],
                            [jnp.asarray(x) for x in eight[3:6]])
    unit = torch.tensor([0, 0, 0, 1, 1, 1], dtype=torch.float32)
    assert_bits(probes.preamble_plain([lanes_t(x) for x in eight[:6]], unit), want)


def jax_stage(stage, tabs, level_rows, sf, rt, ins, clip=probes.STAGE_CLIP):
    """hako_shell_micro.py staged()'s kernel of `stage` (arrays for refs;
    rt: the two root mask words as u32)."""
    ro, rd, tq = ins[0:3], ins[3:6], ins[6]
    lov = [sf[a] for a in range(3)]
    upv = [sf[3 + a] for a in range(3)]
    t0, t1, dt, vm6, okp = jk._ray_preamble(lov, upv, ro, rd)
    rt_ml = jnp.full_like(vm6, rt[0]).astype(jnp.uint32)
    rt_mh = jnp.full_like(vm6, rt[1]).astype(jnp.uint32)
    cur = [t1[0], t1[1], t1[2]]
    dc = [dt[0] * 0.25, dt[1] * 0.25, dt[2] * 0.25]
    en, ex, c = jk._walk64(rt_ml, rt_mh, vm6, cur[0], cur[1], cur[2],
                           dc[0], dc[1], dc[2], tq)
    child = c
    rank = c
    if stage >= 1:
        cx, cy, cz = jk._coords(c)
        k4 = jnp.full_like(c, 4)
        nt1x = jk._plane(cur[0], dc[0], jnp.minimum(cx + 1, k4))
        nt1y = jk._plane(cur[1], dc[1], jnp.minimum(cy + 1, k4))
        nt1z = jk._plane(cur[2], dc[2], jnp.minimum(cz + 1, k4))
        rank = jk._pc64_below(rt_ml, rt_mh, c ^ vm6)
        child = rank
    if stage >= 2:
        ml2, mh2, b2 = jk._gather_node_any(tabs[0], level_rows[0],
                                           jnp.clip(child, 0, clip))
        child = b2 + rank
    if stage >= 3:
        _en2, _ex2, c2 = jk._walk64(ml2, mh2, vm6, nt1x, nt1y, nt1z,
                                    dc[0] * 0.25, dc[1] * 0.25, dc[2] * 0.25, tq)
        child = child + c2
    return [child, en, ex]


def jax_body(T, tabs, level_rows, sf, rt, ins):
    """hako_shell_micro.py k_body's eight outputs."""
    ro, rd, tq = ins[0:3], ins[3:6], ins[6]
    lov = [sf[a] for a in range(3)]
    upv = [sf[3 + a] for a in range(3)]
    t0, t1, dt, vm6, ok = jk._ray_preamble(lov, upv, ro, rd)
    mask_lo = jnp.full_like(vm6, rt[0]).astype(jnp.uint32)
    mask_hi = jnp.full_like(vm6, rt[1]).astype(jnp.uint32)
    cur = [t1[0], t1[1], t1[2]]
    dc = [dt[0] * 0.25, dt[1] * 0.25, dt[2] * 0.25]
    base = jnp.zeros_like(vm6)
    for depth in range(T):
        en, ex, c = jk._walk64(mask_lo, mask_hi, vm6, cur[0], cur[1], cur[2],
                               dc[0], dc[1], dc[2], tq)
        cx, cy, cz = jk._coords(c)
        k4 = jnp.full_like(c, 4)
        nt1x = jk._plane(cur[0], dc[0], jnp.minimum(cx + 1, k4))
        nt1y = jk._plane(cur[1], dc[1], jnp.minimum(cy + 1, k4))
        nt1z = jk._plane(cur[2], dc[2], jnp.minimum(cz + 1, k4))
        rank = jk._pc64_below(mask_lo, mask_hi, c ^ vm6)
        child = base + rank
        if depth < T - 1:
            mask_lo, mask_hi, base = jk._gather_node_any(tabs[depth], level_rows[depth],
                                                         child)
            cur = [nt1x, nt1y, nt1z]
            dc = [d * 0.25 for d in dc]
    return [child, c, en, ex, nt1x, nt1y, nt1z, rank]


def synthetic_case():
    """Two levels, smem (40 nodes) then taa (300 nodes), random root
    masks; lanes [16, 128] with origins around the unit box, directions
    of every sign and resume keys of either sign."""
    rng = np.random.default_rng(3)

    def words(n):
        return rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)

    n0, n1 = 40, 300
    l0 = (words(n0), words(n0), rng.integers(250, 420, n0).astype(np.uint32))
    l1 = (words(n1), words(n1), rng.integers(0, 1 << 20, n1).astype(np.uint32))
    jtabs = [jnp.asarray(jhako._smem_table(*l0)), jnp.asarray(jhako._taa_table(*l1))]
    level_rows = (("smem", 64), ("taa", 3))
    ptabs = [torch.from_numpy(np.stack(lv, 1).view(np.int32)) for lv in (l0, l1)]
    assert probes.level_forms(ptabs) == list(level_rows)
    # dense root masks (~56 of 64 cells): ranks run past level 0's 40 nodes
    rt = tuple(int(words(1)[0] | words(1)[0] | words(1)[0]) for _ in range(2))
    ins = ([rng.uniform(-0.5, 1.5, SHAPE).astype(np.float32) for _ in range(3)]
           + [rng.normal(size=SHAPE).astype(np.float32) for _ in range(3)]
           + [rng.uniform(-0.2, 0.6, SHAPE).astype(np.float32)])
    return jtabs, level_rows, ptabs, rt, ins


def script_stage_case(script):
    eight, jtree, ptree = script
    meta, (_T, level_rows) = jk.hako_args(jtree)
    rt = (jtree.root_mask_lo & 0xFFFF, jtree.root_mask_hi & 0xFFFF)
    return list(meta[2]), level_rows, list(reversed(ptree.levels)), rt, eight


def run_both(case, stage, T, tq_zero):
    jtabs, level_rows, ptabs, rt, ins = case
    ins = list(ins[:6]) + [np.zeros(SHAPE, np.float32) if tq_zero else ins[6]]
    sf = np.array([0, 0, 0, 1, 1, 1], np.float32)
    with jax.disable_jit():
        jins = [jnp.asarray(x) for x in ins]
        jsf = jnp.asarray(sf)
        rtj = (jnp.uint32(rt[0]), jnp.uint32(rt[1]))
        want = (jax_body(T, jtabs, level_rows, jsf, rtj, jins) if stage == 4
                else jax_stage(stage, jtabs, level_rows, jsf, rtj, jins))
        want = [np.asarray(w) for w in want]
    got = probes.probe_stage_plain(stage, [lanes_t(x) for x in ins], torch.from_numpy(sf),
                                   rt, ptabs, T=T)
    assert_bits(got, want)
    return got, want


@pytest.mark.parametrize("stage", range(5))
def test_script_stages_match(script, stage):
    """The script's tree and lanes (T = 2; tq = 0 for the stages, array 6
    for the body, as the script passes them)."""
    got, want = run_both(script_stage_case(script), stage, 2, tq_zero=stage < 4)
    if stage == 0:
        c = got[0].numpy()
        # the reference's 16-bit root mask words hold no cell of the upper
        # half of the box, where these origins lie: no root walk finds one
        assert (c == 64).all()


@pytest.mark.parametrize("stage", range(5))
def test_synthetic_stages_match(stage):
    """Child indices past both levels: the smem level's clip to 63 and its
    zeros past 40 nodes, the taa level's row clip and its zeros past 300."""
    case = synthetic_case()
    got, want = run_both(case, stage, 3, tq_zero=False)
    if stage == 4:
        child, cell, rank = (g.numpy() for g in (got[0], got[1], got[7]))
        assert (cell == 64).any() and (cell < 64).any()
    if stage >= 2:
        ptabs, rt, ins = case[2], case[3], case[4]
        # the lanes' level-0 ranks run past its 40 nodes
        _t0, t1, dt, vm6, _ok = hk._ray_preamble(
            torch.zeros(3), torch.ones(3), *(torch.stack([lanes_t(x) for x in ins[a:a + 3]], 1)
                                             for a in (0, 3)))
        c = hk._walk64_impl(torch.full_like(vm6, rt[0]), torch.full_like(vm6, rt[1]),
                                vm6, t1, dt * 0.25, lanes_t(ins[6]))[2]
        rank = hk._pc64_below(torch.full_like(vm6, rt[0]), torch.full_like(vm6, rt[1]),
                                  c ^ vm6)
        assert (rank >= 40).any() and (rank < 40).any()


def test_synthetic_body_runs_past_the_taa_level():
    """The body's level-1 child indices reach past the 300 nodes, into the
    clipped rows (384 and beyond) and the zeros (300-383)."""
    jtabs, level_rows, ptabs, rt, ins = synthetic_case()
    got = probes.probe_stage_plain(
        4, [lanes_t(x) for x in ins], torch.tensor([0, 0, 0, 1, 1, 1.0]), rt, ptabs[:1],
        T=2)
    child = got[0].numpy()
    assert (child >= 384).any() and ((child >= 300) & (child < 384)).any()
    assert (child < 300).any()


def test_script_runs_on_the_cpu():
    got = sm.main(["--device", "cpu", "--staged"])
    assert got["lanes"] == 2048 and got["T"] == 2 and got["level_nodes"] == [64]
    assert [r["site"] for r in got["cases"]] == [":64", ":78", ":102", ":134", ":134",
                                                ":200"] + [":287"] * 4
    assert all(r["launches"] == 0 for r in got["cases"])  # plain versions
    assert 0.02 < got["ahead_share"] < 0.06 < 0.5 < got["meets_box_share"] < 0.7


def test_refuses_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sm.main([])
