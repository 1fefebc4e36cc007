"""The port's disagreement classifier (utils/tiecheck.py) on constructed
rays: a tie is accepted only where the voxels' slabs prove it (an edge or
corner entry of the same voxel; two voxels each entered at the shared t),
and refused otherwise, whatever t the two walkers report."""

import numpy as np
import pytest
import torch

from massivevoxelraytracing_torch.ops import morton
from massivevoxelraytracing_torch.utils import tiecheck

# The tensors here are small: one intra-op thread keeps the test runner's
# parallel workers from oversubscribing the cores.
torch.set_num_threads(1)

F = np.float32
DPS = 1.0 / 8
LOWER = (0.0, 0.0, 0.0)
# voxels (x, y, z) of an 8^3 grid, as sorted int64 Morton codes
VOXELS = [(2, 3, 4), (1, 3, 4), (2, 2, 4), (6, 6, 6), (1, 2, 4)]
CODES = np.sort(np.array([int(morton.np_encode(*v)) for v in VOXELS], np.int64))
# a ray through the edge x = 0.25, y = 0.375 of voxel (2, 3, 4) at t = 1
EDGE_RO = np.array([-0.75, -0.625, 0.05], F)
EDGE_RD = np.array([1.0, 1.0, 0.5], F)
# a ray entering voxel (2, 3, 4) through its x face only, at t = 1
FACE_RO = np.array([-0.75, 0.3, 0.4], F)
FACE_RD = np.array([1.0, 0.125, 0.15], F)


def rank(v):
    return int(np.searchsorted(CODES, morton.np_encode(*v)))


def classify(t1, m1, vox1, t2, m2, vox2, ro, rd):
    """classify_structures on one ray whose two answers differ."""
    a = [np.array([x], dt) for x, dt in ((t1, F), (m1, np.int32), (rank(vox1), np.int32))]
    b = [np.array([x], dt) for x, dt in ((t2, F), (m2, np.int32), (rank(vox2), np.int32))]
    return tiecheck.classify_structures(*a, *b, CODES, LOWER, DPS, 1.0, ro[None],
                                        rd[None])


def test_assert_face_tie_accepts_an_edge_entry():
    tiecheck.assert_face_tie(0, CODES[rank((2, 3, 4))], LOWER, DPS, EDGE_RO, EDGE_RD)


def test_assert_face_tie_refuses_a_face_entry():
    with pytest.raises(AssertionError, match="without an axis tie"):
        tiecheck.assert_face_tie(0, CODES[rank((2, 3, 4))], LOWER, DPS, FACE_RO,
                                 FACE_RD)


def test_same_voxel_other_face_is_a_tie_only_at_an_edge():
    # nmajor 1 is the x axis, 2 the y axis
    assert classify(1.0, 1, (2, 3, 4), 1.0, 2, (2, 3, 4), EDGE_RO, EDGE_RD) == dict(
        tie=1, graze=0, drift=0)
    with pytest.raises(AssertionError, match="unclassified"):
        classify(1.0, 1, (2, 3, 4), 1.0, 2, (2, 3, 4), FACE_RO, FACE_RD)


def test_two_voxels_entered_at_the_same_t_are_a_tie():
    # along the edge the ray touches (1, 3, 4) and enters (2, 3, 4), both at t = 1
    assert classify(1.0, 2, (1, 3, 4), 1.0, 1, (2, 3, 4), EDGE_RO, EDGE_RD) == dict(
        tie=1, graze=0, drift=0)


def test_an_edge_voxel_missed_by_an_ulp_is_a_tie_and_by_more_is_not():
    """The edge ray moved an ulp in y crosses the y plane just after the x
    plane: it enters (2, 3, 4) from (2, 2, 4) and misses (1, 3, 4), whose
    slab is empty by that ulp; a walker whose rounding crossed y first
    reports (1, 3, 4) at the same t. Moved 1e-3 instead, the miss is real."""
    for dy, tie in ((np.spacing(F(1.0)), True), (F(1e-3), False)):
        ro = EDGE_RO - np.array([0.0, dy, 0.0], F)
        if tie:
            assert classify(1.0, 2, (1, 3, 4), 1.0, 1, (2, 3, 4), ro, EDGE_RD) == dict(
                tie=1, graze=0, drift=0)
        else:
            with pytest.raises(AssertionError, match="unclassified"):
                classify(1.0, 2, (1, 3, 4), 1.0, 1, (2, 3, 4), ro, EDGE_RD)


@pytest.mark.parametrize("other", [(6, 6, 6), (1, 2, 4)])
def test_a_voxel_whose_slab_does_not_hold_t_is_no_tie(other):
    """The same t, but the other voxel is off the ray (6, 6, 6) or left by
    the ray at t = 1 after entering it earlier (1, 2, 4): refused."""
    with pytest.raises(AssertionError, match="unclassified"):
        classify(1.0, 1, (2, 3, 4), 1.0, 1, other, EDGE_RO, EDGE_RD)
