"""The brick and v2 walk wrappers (ops/bricktree.intersect_rays_brick,
ops/traverse2.intersect_rays2) on the CPU:

  * CPU tensors take the plain walk (the tensor code that
    tests/test_torch_bricktree.py and test_torch_traverse.py hold against
    the JAX package): equal to intersect_rays_brick_plain /
    intersect_rays2_plain on rays that mirror, run along an axis, start
    inside the box, are parked or hold a NaN, for DAG on and off, shadow
    on and off, and a max_iters cut; no kernel is built and no counter
    moves;
  * the wrappers raise ValueError for a wrong dtype or shape, a stack
    deeper than 16 (or empty), and a device that is neither the CPU nor a
    CUDA device, before any launch;
  * models/accel.intersect_with takes stages=None or "plain" only.

The kernels themselves run on the card only (tests/test_torch_cuda.py).
"""

import numpy as np
import pytest
import torch

from massivevoxelraytracing_torch.models import accel
from massivevoxelraytracing_torch.ops import bricktree, morton, octree, traverse, traverse2
from massivevoxelraytracing_torch.utils import cuda_build

# The tensors here are small: one intra-op thread keeps the test runner's
# parallel workers from oversubscribing the cores.
torch.set_num_threads(1)

GRID = 64
STRUCTURES = [("brick", True), ("octree", True), ("octree", False)]


@pytest.fixture(autouse=True)
def no_launch(monkeypatch):
    traverse.reset_counters()

    def refuse():
        raise AssertionError("the CPU route loaded the kernel library")

    monkeypatch.setattr(cuda_build, "load", refuse)
    yield
    assert traverse.LAUNCHES == dict.fromkeys(traverse.WALK_KERNELS, 0)


def structure(kind, dag, rng):
    c = torch.as_tensor(rng.integers(0, GRID, size=(1500, 3)))
    codes = morton.encode(c[:, 0], c[:, 1], c[:, 2]).unique()
    lower = np.zeros(3, np.float32)
    if kind == "brick":
        tree = bricktree.build_bricktree(codes, GRID, lower=lower, dps=1.0 / GRID)
    else:
        tree = octree.build_octree(codes, GRID, dag=dag, lower=lower,
                                   upper=lower + np.float32(1.0 / GRID) * GRID)
    return tree, codes


def edge_rays(codes, rng, n=512):
    """Rays aimed at voxels, then: mirrored, with ±0 and axis-parallel
    directions, from inside the box, parked at 1e9, NaN and inf."""
    ro = rng.uniform(-1.0, 2.0, (n, 3)).astype(np.float32)
    x, y, z = (v.numpy() for v in morton.decode(codes[rng.integers(0, codes.shape[0], n)]))
    rd = ((np.stack([x, y, z], -1) + 0.5) / GRID - ro).astype(np.float32)
    m = n // 8
    rd[:m, 0] = 0.0
    rd[m:2 * m, 1] = -0.0
    rd[2 * m:3 * m, :2] = -0.0
    ro[3 * m:4 * m] = rng.uniform(0.0, 1.0, (m, 3)).astype(np.float32)
    ro[4 * m:4 * m + 4] = 1e9
    rd[4 * m + 4] = np.nan
    ro[4 * m + 5, 1] = np.nan
    ro[4 * m + 6] = np.inf
    rd[4 * m + 7] = 0.0
    return torch.from_numpy(ro), torch.from_numpy(rd)


def assert_bits(got, want, what):
    for g, w, name in zip(got, want, ("t", "nmajor", "vidx")):
        assert g.dtype == w.dtype and g.shape == w.shape, (what, name)
        if g.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        assert torch.equal(g, w), (what, name)


@pytest.mark.parametrize("kind,dag", STRUCTURES)
@pytest.mark.parametrize("shadow", [False, True])
def test_wrapper_takes_the_plain_walk_on_cpu(kind, dag, shadow):
    rng = np.random.default_rng(11 + dag)
    tree, codes = structure(kind, dag, rng)
    ro, rd = edge_rays(codes, rng)
    kind_, depth, meta, root = accel.accel_args(tree)
    for max_iters in (9, 100_000):
        got = accel.intersect_with(kind_, depth, meta, root, tree.lower, tree.upper,
                                   ro, rd, shadow=shadow)
        if max_iters != 100_000:
            fn = (bricktree.intersect_rays_brick if kind == "brick"
                  else traverse2.intersect_rays2)
            kw = dict(n_levels=depth) if kind == "brick" else dict(stack_depth=depth)
            got = fn(meta, root, tree.lower, tree.upper, ro, rd, shadow=shadow,
                     max_iters=max_iters, **kw)
            plain_fn = (bricktree.intersect_rays_brick_plain if kind == "brick"
                        else traverse2.intersect_rays2_plain)
            want = plain_fn(meta, root, tree.lower, tree.upper, ro, rd, shadow=shadow,
                            max_iters=max_iters, **kw)
        else:
            want = accel.intersect_with(kind_, depth, meta, root, tree.lower, tree.upper,
                                        ro, rd, shadow=shadow, stages="plain")
        assert_bits(got, want, f"max_iters={max_iters}")
        hits = want[0] < 1e37
        assert not bool(hits[4 * 64:4 * 64 + 7].any())  # parked, NaN, inf: misses
    assert 50 < int(hits.sum()) < ro.shape[0]


def walk_call(kind):
    """(wrapper, good positional args, depth keyword) on a tiny tree."""
    rng = np.random.default_rng(3)
    tree, codes = structure(kind, True, rng)
    ro, rd = edge_rays(codes, rng, 64)
    _kind, depth, meta, root = accel.accel_args(tree)
    if kind == "brick":
        return bricktree.intersect_rays_brick, [meta, root, tree.lower, tree.upper, ro, rd], \
            "n_levels", depth
    return traverse2.intersect_rays2, [meta, root, tree.lower, tree.upper, ro, rd], \
        "stack_depth", depth


BAD = {
    "meta int64": (0, lambda x: x.long(), "meta"),
    "meta columns": (0, lambda x: x[:, :3].contiguous(), "meta"),
    "meta empty": (0, lambda x: x[:0], "meta"),
    "lower shape": (2, lambda x: x[:2], "lower"),
    "upper float64": (3, lambda x: x.double(), "upper"),
    "ro float64": (4, lambda x: x.double(), "ro"),
    "ro columns": (4, lambda x: torch.cat([x, x[:, :1]], 1), "ro"),
    "rd rows": (5, lambda x: x[:-1], "rd"),
}


@pytest.mark.parametrize("kind", ["brick", "octree"])
@pytest.mark.parametrize("case", sorted(BAD))
def test_wrapper_refuses_a_wrong_dtype_or_shape(kind, case):
    fn, args, key, depth = walk_call(kind)
    pos, change, what = BAD[case]
    args[pos] = change(args[pos])
    with pytest.raises(ValueError, match=what):
        fn(*args, **{key: depth})


@pytest.mark.parametrize("kind", ["brick", "octree"])
@pytest.mark.parametrize("depth", [0, 17, 40])
def test_wrapper_refuses_a_stack_outside_1_16(kind, depth):
    fn, args, key, _depth = walk_call(kind)
    with pytest.raises(ValueError, match="stack depth"):
        fn(*args, **{key: depth})


@pytest.mark.parametrize("kind", ["brick", "octree"])
def test_wrapper_refuses_another_device(kind):
    fn, args, key, depth = walk_call(kind)
    args = [a.to("meta") if isinstance(a, torch.Tensor) else a for a in args]
    with pytest.raises(ValueError, match="no .*_walk kernel for device meta"):
        fn(*args, **{key: depth})


def test_intersect_with_takes_none_or_plain():
    rng = np.random.default_rng(3)
    tree, codes = structure("brick", True, rng)
    ro, rd = edge_rays(codes, rng, 16)
    kind, depth, meta, root = accel.accel_args(tree)
    with pytest.raises(ValueError, match="stages"):
        accel.intersect_with(kind, depth, meta, root, tree.lower, tree.upper, ro, rd,
                             stages="kernels")
