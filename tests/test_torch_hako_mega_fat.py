"""The port's megakernel plain version on a fat tree (supernode rows,
T = 1: the layout a 1024^3 scene takes), forced at 512^3 by setting
USE_SNODES_ABOVE to 128 in both packages, against the JAX package's
interpret-mode megakernel. The t bound is test_torch_hako_mega's (XLA:CPU
contracts the reference's cell planes into FMAs); discrete outputs are
exact. Its own file: the fat interpret-mode reference alone takes about
20 s on one CPU."""

import numpy as np
import pytest

from massivevoxelraytracing_tpu.ops import hako as jhako
from massivevoxelraytracing_tpu.ops import hako_mega as jmega
from massivevoxelraytracing_torch.ops import hako

from test_torch_hako_build import jax_tree, port_tree, random_voxels
from test_torch_hako_mega import assert_matches_reference, mixed_rays, plain


@pytest.fixture(scope="module")
def fat_case():
    mp = pytest.MonkeyPatch()
    mp.setattr(jhako, "USE_SNODES_ABOVE", 128)
    mp.setattr(hako, "USE_SNODES_ABOVE", 128)
    try:
        rng = np.random.default_rng(512)
        m = random_voxels(512, 8000, rng)
        ro, rd = mixed_rays(m, 512, 1024, rng)
        jt = jax_tree(m, 512)
        pt = port_tree(m, 512)
    finally:
        mp.undo()
    ref = tuple(np.asarray(x) for x in jmega.intersect_hako_mega(jt, ro, rd))
    return pt, ro, rd, ref


def test_fat_tree_layout(fat_case):
    pt = fat_case[0]
    assert pt.snodes is not None and pt.T == 1 and not pt.levels
    assert pt.n_snodes > 1


def test_fat_plain_matches_jax(fat_case):
    pt, ro, rd, ref = fat_case
    assert_matches_reference(plain(pt, ro, rd), ref)


def test_fat_caps_and_shadow(fat_case):
    """Capped rounds through the supernode chain change nothing; shadow
    rays see the primary hit mask with rank 0."""
    pt, ro, rd, _ref = fat_case
    base = plain(pt, ro, rd)
    for a, b in zip(base, plain(pt, ro, rd, max_probes=1, max_dda=1)):
        np.testing.assert_array_equal(a, b)
    ts, nms, vrs = plain(pt, ro, rd, shadow=True)
    np.testing.assert_array_equal(ts < 1e37, base[0] < 1e37)
    np.testing.assert_array_equal(nms, base[1])
    np.testing.assert_array_equal(vrs, 0)
