"""The Hopper microbenchmarks' plain versions (ops/probes.py) against numpy
and the JAX package, and the pure-Python helpers of the megakernel's
launch and bound (ops/hako_mega.py): the counting variant's counter
order, the byte and operation counts behind a traversal's bound, the rows
a traversal reads. The kernels themselves run on the card (tests/test_torch_cuda.py,
chip_smoke.py). All exact: integer outputs, or the walk evaluated op by op.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from massivevoxelraytracing_tpu.ops import hako_kernels as jk
from massivevoxelraytracing_torch.ops import hako, hako_mega, morton, probes

# The tensors here are small: one intra-op thread keeps the test runner's
# parallel workers from oversubscribing the cores.
torch.set_num_threads(1)


def test_chase_table_is_one_cycle_in_every_mode():
    rows = probes.make_chase_table(1000, np.random.default_rng(0)).view(np.uint32)
    seen, r = set(), 0
    for _ in range(1000):
        seen.add(r)
        r = int(rows[r, 0])
    assert r == 0 and len(seen) == 1000
    np.testing.assert_array_equal(np.bitwise_xor.reduce(rows[:, :4], axis=1), rows[:, 0])
    np.testing.assert_array_equal(np.bitwise_xor.reduce(rows, axis=1), rows[:, 0])


def numpy_chase(rows, start, hops, width):
    idx = start.astype(np.int64)
    u = rows.view(np.uint32)
    for _ in range(hops):
        idx = np.bitwise_xor.reduce(u[idx, :width], axis=1).astype(np.int64)
    return idx


@pytest.mark.parametrize("mode,width", [("4B", 1), ("16B", 4), ("warp_row", 164)])
def test_row_chase_plain_matches_numpy(mode, width):
    """The final row of each chain, on a table whose words are random
    (not a chase table), so each mode follows its own chains."""
    rng = np.random.default_rng(1)
    n_rows = 256  # 8-bit words: every xor of them indexes the table
    rows = rng.integers(0, n_rows, (n_rows, 164)).astype(np.int32)
    start = rng.integers(0, n_rows, probes.chase_chains(mode, 2, 1, 64)).astype(np.int32)
    want = numpy_chase(rows, start, 9, width)
    got = probes.row_chase(torch.from_numpy(rows), torch.from_numpy(start), hops=9,
                           mode=mode, chains=2, blocks=1, threads=64)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("mode,chains,blocks,threads,want", [
    ("4B", 1, 132, 32, 4224), ("16B", 4, 1056, 256, 1081344),
    ("warp_row", 1, 132, 32, 132), ("warp_row", 4, 1056, 256, 33792)])
def test_chase_launch_shapes(mode, chains, blocks, threads, want):
    assert probes.chase_chains(mode, chains, blocks, threads) == want


def test_chase_launch_shape_refuses():
    for args in (("8B", 1, 1, 32), ("4B", 3, 1, 32), ("4B", 1, 1, 48)):
        with pytest.raises(ValueError):
            probes.chase_chains(*args)
    with pytest.raises(ValueError):  # start holds the wrong number of chains
        probes.row_chase(torch.zeros((4, 164), dtype=torch.int32),
                         torch.zeros(7, dtype=torch.int32), hops=1, mode="4B",
                         chains=1, blocks=1, threads=32)


def test_walk_probe_plain_matches_jax_op_by_op():
    """The checksum of walk64 cells over 4 LCG steps of the masks equals the
    reference's walk (op by op: no contracted planes) on the same steps."""
    rng = np.random.default_rng(3)
    n, iters = 500, 4
    t1 = rng.uniform(0.5, 3.0, (3, n)).astype(np.float32)
    dc = rng.uniform(0.01, 0.3, (3, n)).astype(np.float32)
    lo = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    hi = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    got = probes.walk_probe(torch.from_numpy(lo.view(np.int32)),
                            torch.from_numpy(hi.view(np.int32)),
                            torch.from_numpy(t1), torch.from_numpy(dc), iters=iters)
    want = np.zeros(n, np.int64)
    zero = jnp.zeros(n, jnp.int32)
    with jax.disable_jit():
        for _ in range(iters):
            cell = jk._walk64_impl(jnp.asarray(lo), jnp.asarray(hi), zero,
                                   *[jnp.asarray(t1[a]) for a in range(3)],
                                   *[jnp.asarray(dc[a]) for a in range(3)],
                                   jnp.zeros(n, jnp.float32))[2]
            want += np.asarray(cell)
            lo = lo * np.uint32(1664525) + np.uint32(1013904223)
            hi = hi * np.uint32(22695477) + np.uint32(1)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want > 0).all() and (want < 64 * iters).any()


def test_fetch_probe_plain_matches_numpy():
    rng = np.random.default_rng(4)
    rows = rng.integers(-2**31, 2**31, (50, 164), dtype=np.int64).astype(np.int32)
    row_of = rng.integers(0, 50, 300).astype(np.int32)
    u = rows.view(np.uint32)
    want = np.zeros(300, np.uint32)
    for i in range(300):
        s = i & 63
        for k in range(7):
            w = u[row_of[i], 2 * s] ^ u[row_of[i], 2 * s + 1]
            want[i] ^= w
            s = int(w ^ k) & 63
    got = probes.fetch_probe(torch.from_numpy(rows), torch.from_numpy(row_of), iters=7)
    np.testing.assert_array_equal(got.numpy(), want.view(np.int32))


def test_ray_counts_follow_the_kernels_row_order():
    """RAY_COUNTS names the rows of the counting variant's per-ray output
    in the order the kernel writes them (csrc/hako_mega.cu)."""
    src = os.path.join(os.path.dirname(probes.__file__), "..", "csrc", "hako_mega.cu")
    with open(src) as f:
        text = f.read()
    written = re.search(r"const int v\[8\] = \{([^}]*)\}", text).group(1)
    assert tuple(re.findall(r"c\.(\w+)", written)) == hako_mega.RAY_COUNTS


def test_traversal_traffic_counts():
    # 10 rays x 36 B, 3 rows x 656 B, 2 level nodes x 12 B; 30 ops a ray,
    # 100 a row visit
    assert hako_mega.traversal_traffic(10, 3, 7, 2) == (360 + 1968 + 24, 300 + 700)
    assert hako_mega.traversal_traffic(0, 0, 0, 0) == (0, 0)


@pytest.mark.parametrize("snodes_above", [None, 8])
def test_rows_touched_one_voxel(monkeypatch, snodes_above):
    """One voxel at 64^3: a ray aimed at it reads one brick row (and one
    supernode row in the fat layout), each at least once; a ray past the
    box reads none."""
    if snodes_above is not None:
        monkeypatch.setattr(hako, "USE_SNODES_ABOVE", snodes_above)
    codes = morton.encode(torch.tensor([5]), torch.tensor([40]), torch.tensor([17]))
    tree = hako.build_hako(codes, 64, device="cpu", dps=1.0 / 64)
    assert (tree.snodes is not None) == (snodes_above is not None)
    (bricks, snodes, tabs, root), T = hako_mega.hako_mega_args(tree)
    center = (np.array([5, 40, 17]) + 0.5) / 64
    ro = torch.tensor([[-0.5, 0.3, 0.2], [50.0, 50.0, 50.0]], dtype=torch.float32)
    rd = torch.tensor(np.stack([center - ro[0].numpy(), [1.0, 0.0, 0.0]]),
                      dtype=torch.float32)
    t, _nm, _vr, _u = hako_mega.intersect_rays_hako_mega_plain(
        bricks, snodes, tabs, root, tree.lower, tree.upper, ro, rd, T=T)
    assert t[0] < 1e37 and t[1] > 1e37
    got = hako_mega.rows_touched(bricks, snodes, tabs, root, tree.lower, tree.upper,
                                 ro, rd, T=T)
    stages = 2 if snodes is not None else 1
    assert got[0] == stages and got[1] >= stages
    assert hako_mega.rows_touched(bricks, snodes, tabs, root, tree.lower,
                                  tree.upper, ro[1:], rd[1:], T=T) == (0, 0)


def test_counting_variant_needs_the_card():
    rows = torch.zeros((1, 164), dtype=torch.int32)
    rays = torch.zeros((2, 3))
    with pytest.raises(ValueError):
        hako_mega.intersect_rays_hako_mega_counted(
            rows, None, (), (1, 0), torch.zeros(3), torch.ones(3), rays, rays, T=1)
