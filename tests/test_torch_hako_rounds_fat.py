"""The port's legacy round driver (plain version) on a fat tree
(supernode rows, T = 1: the layout a 1024^3 scene takes), forced at 512^3
by setting USE_SNODES_ABOVE to 128 in both packages, against the JAX
package's interpret-mode intersect_hako, primary and shadow rays; and
against the port's plain megakernel bit for bit, with capped resumes
through the supernode stage. The t bound is test_torch_hako_mega's
(XLA:CPU contracts the reference's cell planes into FMAs); discrete
outputs are exact. Its own file: the fat interpret-mode reference is the
slowest."""

import numpy as np
import pytest

from massivevoxelraytracing_tpu.ops import hako as jhako
from massivevoxelraytracing_tpu.ops import hako_kernels as jk
from massivevoxelraytracing_torch.ops import hako

from test_torch_hako_build import jax_tree, port_tree, random_voxels
from test_torch_hako_mega import assert_matches_reference, mixed_rays, plain
from test_torch_hako_rounds import rounds_plain


@pytest.fixture(scope="module")
def fat_case():
    mp = pytest.MonkeyPatch()
    mp.setattr(jhako, "USE_SNODES_ABOVE", 128)
    mp.setattr(hako, "USE_SNODES_ABOVE", 128)
    try:
        rng = np.random.default_rng(513)
        m = random_voxels(512, 8000, rng)
        ro, rd = mixed_rays(m, 512, 512, rng)
        jt = jax_tree(m, 512)
        pt = port_tree(m, 512)
    finally:
        mp.undo()
    ref = tuple(np.asarray(x) for x in jk.intersect_hako(jt, ro, rd))
    return jt, pt, ro, rd, ref


def test_fat_rounds_plain_matches_jax(fat_case):
    _jt, pt, ro, rd, ref = fat_case
    assert pt.snodes is not None and pt.T == 1
    got, rounds = rounds_plain(pt, ro, rd)
    assert rounds > 1
    assert_matches_reference(got, ref)


def test_fat_rounds_plain_shadow_matches_jax(fat_case):
    """Any-hit through the supernode stage: the reference's shadow hit
    mask and nmajor, rank 0."""
    jt, pt, ro, rd, _ref = fat_case
    tj, nmj, _vrj = (np.asarray(x) for x in jk.intersect_hako(jt, ro, rd, shadow=True))
    (tp, nmp, vrp), _ = rounds_plain(pt, ro, rd, shadow=True)
    assert (tj < 1e37).any()
    np.testing.assert_array_equal(tp < 1e37, tj < 1e37)
    np.testing.assert_array_equal(nmp, nmj)
    np.testing.assert_array_equal(vrp, 0)


@pytest.mark.parametrize("shadow", [False, True])
def test_fat_rounds_equal_megakernel_and_capped(fat_case, shadow):
    """The supernode stage's resumes (one probe, one sub-brick visit per
    call) change nothing, and both equal the megakernel bit for bit."""
    _jt, pt, ro, rd, _ref = fat_case
    base, r_base = rounds_plain(pt, ro, rd, shadow=shadow)
    capped, r_capped = rounds_plain(pt, ro, rd, shadow=shadow, max_probes=1,
                                    max_dda=1)
    assert r_capped > r_base
    for a, b, c in zip(base, capped, plain(pt, ro, rd, shadow=shadow)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    if shadow:
        np.testing.assert_array_equal(base[2], 0)
