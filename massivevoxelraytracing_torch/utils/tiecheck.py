"""Disagreement classifier for traversal A/B checks (the port's copy of the
JAX package's tests/tiecheck.py, on the port's int64 Morton codes).

The reference's culture is pixel-exact A/B (voxRT.cpp:316-323). Two exact
in-order walkers can still disagree in two zero-measure cases:

  * t-tie: the ray passes through a shared voxel edge / corner, two voxels
    tie at the same entry distance, and either (voxel, face) answer is
    valid;
  * grazing touch: a ray along a voxel face or edge has a degenerate
    [entry, exit] interval that the inclusive slab test reports and the
    strict `en < ex` parametric walk excludes (the reference traversal's
    strict comparisons, voxCommon.hpp:326-334); two walkers that round
    their cell planes differently may also split on it.

Between two different structures over the same voxels (`classify_structures`)
a third case appears on rays nearly parallel to an axis:

  * plane drift: the same voxel and face, and t within a few ulps of that
    axis' t extent over the root box (extent / |rd_a|): the structures
    compute the entry plane by different chains of f32 operations.

Every disagreement must prove it is one of these, or the check fails. A
tie proves itself from the voxels' slabs: the same voxel reached through
another face is entered on two axes at once (an edge or corner entry,
`assert_face_tie`); two different voxels are each met by the ray and
entered at their own t, within the tie tolerance.
"""

from __future__ import annotations

import numpy as np

from ..ops import morton as morton_ops

F = np.float32


def _box(m_voxel, lower, dps):
    """(lo, hi) corners of one voxel's AABB (f32 [3] each)."""
    x, y, z = morton_ops.np_decode(np.asarray([m_voxel], np.int64))
    lo = np.asarray(lower, F) + np.stack([x, y, z], -1).astype(F)[0] * F(dps)
    return lo, lo + F(dps)


def _slab(m_voxel, lower, dps, ro, rd):
    """(entry, exit) of one voxel's AABB along the ray (inclusive slab)."""
    lo, hi = _box(m_voxel, lower, dps)
    en, ex = -np.inf, np.inf
    for a in range(3):
        if rd[a] == 0.0:
            if not (lo[a] <= ro[a] <= hi[a]):
                return np.inf, -np.inf
            continue
        t0 = (lo[a] - ro[a]) / rd[a]
        t1 = (hi[a] - ro[a]) / rd[a]
        en = max(en, min(t0, t1))
        ex = min(ex, max(t0, t1))
    return en, ex


def assert_tie_or_equal(i, t1, v1, m1, t2, v2, m2, rtol=1e-5, atol=1e-7):
    """Between two exact walkers: a disagreement must be a t-tie."""
    hit1 = t1 < 1e37
    hit2 = t2 < 1e37
    assert hit1 == hit2, f"ray {i}: hit-mask mismatch ({t1} vs {t2})"
    if not hit1:
        return
    assert np.isclose(t1, t2, rtol=rtol, atol=atol), (
        f"ray {i}: t differs beyond tie tolerance: {t1} vs {t2}")
    # equal t, different (voxel, face): a legitimate corner / edge tie


def classify_vs_each_other(t1, m1, v1, t2, m2, v2, rtol=1e-5, atol=1e-7):
    """Vectorized outer check + per-ray classification of the residue.
    Returns the number of classified ties."""
    hit1 = t1 < 1e37
    hit2 = t2 < 1e37
    agree = (hit1 == hit2) & (
        ~hit1 | (np.isclose(t1, t2, rtol=rtol, atol=atol)
                 & (v1 == v2) & (m1 == m2)))
    for i in np.nonzero(~agree)[0]:
        assert_tie_or_equal(i, t1[i], v1[i], m1[i], t2[i], v2[i], m2[i],
                            rtol=rtol, atol=atol)
    return int((~agree).sum())


def _axis_entries(m_voxel, lower, dps, ro, rd):
    """Sorted per-axis slab entry times of one voxel (axes with rd = 0
    left out)."""
    lo, hi = _box(m_voxel, lower, dps)
    tmins = []
    for a in range(3):
        if rd[a] == 0.0:
            continue
        t0 = (lo[a] - ro[a]) / rd[a]
        t1 = (hi[a] - ro[a]) / rd[a]
        tmins.append(min(t0, t1))
    return sorted(tmins)


def _is_face_tie(m_voxel, lower, dps, ro, rd, rtol=1e-5):
    tmins = _axis_entries(m_voxel, lower, dps, ro, rd)
    return len(tmins) >= 2 and bool(
        np.isclose(tmins[-1], tmins[-2], rtol=rtol, atol=1e-7))


def assert_face_tie(i, m_voxel, lower, dps, ro, rd, rtol=1e-5):
    """A differing face axis at the same hit voxel and t is only legitimate
    when the voxel is entered on two or more axes at once (an edge or
    corner entry): checked from the per-axis slab entry times."""
    assert _is_face_tie(m_voxel, lower, dps, ro, rd, rtol), (
        f"ray {i}: face-axis mismatch without an axis tie "
        f"(tmins={_axis_entries(m_voxel, lower, dps, ro, rd)})")


def _entered_at(m_voxel, t, lower, dps, ro, rd, rtol, atol):
    """The ray meets the voxel (its inclusive slab is not empty) and enters
    it at t, both within the tie tolerance: at an edge the two voxels'
    crossings are an ulp apart, and the f32 slab of the voxel that the
    other walker's rounding skipped can come out empty by that ulp."""
    en, ex = _slab(m_voxel, lower, dps, ro, rd)
    return (ex >= en - (atol + rtol * abs(en))
            and bool(np.isclose(en, t, rtol=rtol, atol=atol)))


def classify_vs_oracle(i, m_sorted, lower, dps, ro, rd, t_dev, v_dev, t_ora,
                       v_ora, rtol=2e-5, atol=1e-6, graze_eps=1e-4):
    """A walker vs the inclusive brute-force slab oracle: a disagreement must
    be a t-tie or a grazing touch of the oracle's voxel. Returns a short tag
    of the classified case."""
    dev_hit = t_dev < 1e37
    ora_hit = np.isfinite(t_ora)
    if dev_hit == ora_hit and dev_hit:
        if np.isclose(t_dev, t_ora, rtol=rtol, atol=atol):
            return "tie"  # the same t, another voxel / face at an edge
    if ora_hit:
        en, ex = _slab(m_sorted[int(v_ora)], lower, dps, ro, rd)
        scale = max(1.0, abs(en))
        if ex - en <= graze_eps * scale:
            # the oracle counted a zero-measure touch; the walker's answer
            # (a miss or a later real hit) must not be earlier than it
            if not dev_hit or t_dev >= en - rtol * scale:
                return "graze"
    raise AssertionError(
        f"ray {i}: unclassified disagreement: dev(t={t_dev}, v={v_dev}) "
        f"vs oracle(t={t_ora}, v={v_ora})")


_AXIS_OF_NMAJOR = {1: 0, 2: 1, 0: 2}


def _classify_pair(i, t1, m1, v1, t2, m2, v2, codes, lower, dps, extent, ro,
                   rd, rtol, atol, drift_ulps, graze_eps):
    hit1, hit2 = t1 < 1e37, t2 < 1e37
    if hit1 and hit2 and np.isclose(t1, t2, rtol=rtol, atol=atol):
        c1, c2 = codes[int(v1)], codes[int(v2)]
        if v1 == v2:
            # the same voxel through another face: an edge / corner entry
            if _is_face_tie(c1, lower, dps, ro, rd, rtol):
                return "tie"
        elif (_entered_at(c1, t1, lower, dps, ro, rd, rtol, atol)
              and _entered_at(c2, t2, lower, dps, ro, rd, rtol, atol)):
            return "tie"  # two voxels both entered at that t
    if hit1 and hit2 and v1 == v2 and m1 == m2:
        a = _AXIS_OF_NMAJOR[int(m1)]
        plane_scale = F(extent / max(abs(float(rd[a])), 1e-30))
        if abs(float(t1) - float(t2)) <= drift_ulps * float(np.spacing(plane_scale)):
            return "drift"
    # the earlier hit (or the only one) must be a zero-measure touch that
    # the other walker stepped past
    if hit1 and (not hit2 or t1 <= t2):
        v_first, t_other, other_hit = v1, t2, hit2
    else:
        v_first, t_other, other_hit = v2, t1, hit1
    en, ex = _slab(codes[int(v_first)], lower, dps, ro, rd)
    scale = max(1.0, abs(en))
    if ex - en <= graze_eps * scale and (
            not other_hit or t_other >= en - rtol * scale):
        return "graze"
    raise AssertionError(
        f"ray {i}: unclassified disagreement: (t={t1}, v={v1}, n={m1}) vs "
        f"(t={t2}, v={v2}, n={m2})")


def classify_structures(t1, m1, v1, t2, m2, v2, codes, lower, dps, extent,
                        ro, rd, rtol=1e-5, atol=1e-7, drift_ulps=4,
                        graze_eps=1e-4) -> dict:
    """Two structures' walks over the same voxels (vidx = rank into the
    sorted int64 `codes`) on many rays (numpy): every disagreement must be
    a proven tie (an axis tie at the same voxel, or two voxels each entered
    at its t), a graze or plane drift. extent: the root box's side. Returns
    the counts of each."""
    hit1 = t1 < 1e37
    hit2 = t2 < 1e37
    agree = (hit1 == hit2) & (
        ~hit1 | (np.isclose(t1, t2, rtol=rtol, atol=atol)
                 & (v1 == v2) & (m1 == m2)))
    counts = dict(tie=0, graze=0, drift=0)
    for i in np.nonzero(~agree)[0]:
        counts[_classify_pair(i, t1[i], m1[i], v1[i], t2[i], m2[i], v2[i],
                              codes, lower, dps, extent, ro[i], rd[i], rtol,
                              atol, drift_ulps, graze_eps)] += 1
    return counts
