"""Host-side fidelity oracles (the port's copy of the JAX package's
models/cpu_oracle.py).

  - `TriContext` / `voxelize_mesh`: Schwarz-Seidel conservative and
    6-separating triangle voxelization (closed-form predicate, float32
    numpy), independent of the tensor voxelizer;
  - `brute_force_rays`: the slab test over every voxel AABB (the Embree
    user-geometry stand-in, the reference's `intersect_brute_force`) for
    many rays at once in tensor ops on any device, with the reference's
    float32 operations in its order: the ground truth of voxrt's
    `--oracle`; `intersect_brute_force`, the same test for one ray in
    numpy;
  - `OracleOctree` / `build_octree` / `embed_masks`: the SVO/DAG built
    voxel by voxel with a hash of (mask, children) for the dedup
    (IntersectorOctree.hpp semantics), the oracle of ops/octree.py.

Voxels are the port's int64 Morton codes. The range-loop formulation that
cross-checks the closed form stays in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import morton as morton_ops

F = np.float32


def _major_axis(n):
    x, y, z = abs(n[0]), abs(n[1]), abs(n[2])
    if x < y:
        return 0 if y < z else 2
    return 0 if x < z else 1


_PROJ = {0: (0, 1, 2), 1: (1, 2, 0), 2: (2, 0, 1)}  # axis -> (u, v, w) indices
# the projected (u, v, w) columns back in (x, y, z) order, per major axis
_UNPROJECT_COLS = {0: [0, 1, 2], 1: [2, 0, 1], 2: [1, 2, 0]}


def _project(p, axis):
    u, v, _ = _PROJ[axis]
    return np.array([p[u], p[v]], F)


def _remainder(p, axis):
    return F(p[_PROJ[axis][2]])


class TriContext:
    """Per-triangle voxelization constants (VTContext semantics)."""

    def __init__(self, v0, v1, v2, six_separating, origin, dps, grid_res):
        v0 = np.asarray(v0, F)
        v1 = np.asarray(v1, F)
        v2 = np.asarray(v2, F)
        origin = np.asarray(origin, F)
        dps = F(dps)
        e01 = v1 - v0
        e12 = v2 - v1
        n = np.cross(e01, e12).astype(F)
        self.n = n
        self.major = _major_axis(n)
        self.six = bool(six_separating)
        self.dps = dps
        self.grid_res = int(grid_res)

        bbox_lower = np.minimum(np.minimum(v0, v1), v2)
        bbox_upper = np.maximum(np.maximum(v0, v1), v2)
        lower = np.floor((bbox_lower - origin) / dps).astype(np.int64)
        upper = np.floor((bbox_upper - origin) / dps).astype(np.int64)
        lower = np.maximum(lower, 0)
        upper = np.minimum(upper, grid_res - 1)
        self.lower_xyz = lower
        self.upper_xyz = upper

        m = self.major
        self.lower_xy = _project(lower, m).astype(np.int64)
        self.upper_xy = _project(upper, m).astype(np.int64)
        self.lower_z = int(_remainder(lower, m))
        self.upper_z = int(_remainder(upper, m))

        # per-axis edge functions
        self.nes = np.zeros((3, 3, 2), F)
        self.d_consts = np.zeros((3, 3), F)
        for axis in range(3):
            vs = [_project(v, axis) for v in (v0, v1, v2)]
            rem = _remainder(n, axis)
            n_sign = F(1.0) if F(0.0) < rem else F(-1.0)
            for edge in range(3):
                a = vs[edge]
                b = vs[(edge + 1) % 3]
                e = b - a
                ne = np.array([-e[1], e[0]], F) * n_sign
                self.nes[axis, edge] = ne
                if not six_separating:
                    d = (
                        max(ne[0] * dps, F(0.0))
                        + max(ne[1] * dps, F(0.0))
                        - (ne[0] * a[0] + ne[1] * a[1])
                    )
                else:
                    d = (
                        ne[0] * (dps * F(0.5) - a[0])
                        + ne[1] * (dps * F(0.5) - a[1])
                        + F(0.5) * dps * max(abs(ne[0]), abs(ne[1]))
                    )
                self.d_consts[axis, edge] = F(d)

        self.origin_xy = _project(origin, m)
        self.origin_z = _remainder(origin, m)
        v0_xy = _project(v0, m)
        v0_z = _remainder(v0, m)
        n_xy = _project(n, m)
        n_z = _remainder(n, m)
        self.kx = F(-n_xy[0] / n_z)
        self.ky = F(-n_xy[1] / n_z)
        K = F(-self.kx * v0_xy[0] - self.ky * v0_xy[1] + v0_z)
        self.constant_max = F(K + dps * (max(self.kx, F(0)) + max(self.ky, F(0))))
        self.constant_min = F(K + dps * (min(self.kx, F(0)) + min(self.ky, F(0))))
        self.constant_six = F(K + F(0.5) * dps * (self.kx + self.ky))

    # -- closed-form predicate over a grid of projected integer coords -------

    def test_grid(self):
        """Evaluate the coverage predicate over the whole clipped bbox.

        Returns integer xyz coords (in grid space) of covered voxels, in the
        projected-loop order (x-major, then y, then z) like the reference
        emission loops.
        """
        if np.any(self.upper_xyz < self.lower_xyz):
            return np.zeros((0, 3), np.int64)
        xs = np.arange(self.lower_xy[0], self.upper_xy[0] + 1)
        ys = np.arange(self.lower_xy[1], self.upper_xy[1] + 1)
        zs = np.arange(self.lower_z, self.upper_z + 1)
        X, Y, Z = np.meshgrid(xs, ys, zs, indexing="ij")
        ok = self.test_points(X, Y, Z)
        sel = np.stack([X[ok], Y[ok], Z[ok]], axis=-1).astype(np.int64)
        return sel[:, _UNPROJECT_COLS[self.major]]

    def test_points(self, X, Y, Z):
        """Closed-form predicate at projected integer coords (vectorized)."""
        dps = self.dps
        xc = self.origin_xy[0] + X.astype(F) * dps
        yc = self.origin_xy[1] + Y.astype(F) * dps
        zc = self.origin_z + Z.astype(F) * dps

        # major-axis edge functions (equivalent to yRangeInclusive bounds)
        ok = np.ones(X.shape, bool)
        m = self.major
        for edge in range(3):
            ne = self.nes[m, edge]
            d = self.d_consts[m, edge]
            ok &= ne[0] * xc + ne[1] * yc + d >= F(0.0)

        # z slab (zRangeInclusive)
        var = self.kx * xc + self.ky * yc
        if self.six:
            tsix = var + self.constant_six
            indexf = (tsix - self.origin_z) / dps
            zf = np.floor(indexf)
            zmax = zf.astype(np.int64)
            zmin = np.where(indexf == zf, zmax - 1, zmax)
        else:
            zmin = np.floor((var + self.constant_min - self.origin_z) / dps).astype(
                np.int64
            )
            zmax = np.floor((var + self.constant_max - self.origin_z) / dps).astype(
                np.int64
            )
        zmin = np.maximum(zmin, self.lower_z)
        zmax = np.minimum(zmax, self.upper_z)
        ok &= (zmin <= Z) & (Z <= zmax)

        # intersect(p): other two axes' edge tests, skipped for flat bbox
        if self.lower_z != self.upper_z:
            for axis in range(3):
                if axis == self.major:
                    continue
                # project the continuous corner point onto `axis`
                P = np.zeros(X.shape + (3,), F)
                if self.major == 0:
                    P[..., 0], P[..., 1], P[..., 2] = xc, yc, zc
                elif self.major == 1:
                    P[..., 1], P[..., 2], P[..., 0] = xc, yc, zc
                else:
                    P[..., 2], P[..., 0], P[..., 1] = xc, yc, zc
                u, v, _ = _PROJ[axis]
                pu, pv = P[..., u], P[..., v]
                for edge in range(3):
                    ne = self.nes[axis, edge]
                    d = self.d_consts[axis, edge]
                    ok &= ne[0] * pu + ne[1] * pv + d >= F(0.0)
        return ok

def closest_barycentric(v0, v1, v2, p):
    """Clamped barycentric coords of the closest point (vectorMath.hpp:249)."""
    v0 = np.asarray(v0, F)
    v1 = np.asarray(v1, F)
    v2 = np.asarray(v2, F)
    p = np.asarray(p, F)
    d0, d1, d2 = v0 - p, v1 - p, v2 - p
    e0, e1, e2 = v2 - v0, v0 - v1, v1 - v2
    ng = np.cross(e2, e0)
    U = np.dot(np.cross(d2, d0), ng)
    V = np.dot(np.cross(d0, d1), ng)
    W = np.dot(np.cross(d1, d2), ng)
    if U < 0.0:
        V = np.dot(-d0, e0)
        W = np.dot(d2, e0)
    elif V < 0.0:
        W = np.dot(-d1, e1)
        U = np.dot(d0, e1)
    elif W < 0.0:
        U = np.dot(-d2, e2)
        V = np.dot(d1, e2)
    bc = np.maximum(np.array([U, V, W], F), F(0.0))
    return bc / bc.sum()


def voxelize_mesh(
    vertices, origin, dps, grid_res, six_separating=True, colors=None,
    emissions=None, attributes: bool = True,
):
    """Voxelize a triangle soup; returns sorted-unique (morton int64, color
    u8[?,4], emission u8[?,4]) with duplicate attributes integer-averaged
    (semantics of voxelize + unique kernels, voxKernel.cu:91-243).
    attributes=False skips the per-voxel colors: (morton, None, None)."""
    vertices = np.asarray(vertices, F).reshape(-1, 3, 3)
    ntri = len(vertices)
    if colors is None:
        colors = np.ones((ntri, 3, 3), F)
    if emissions is None:
        emissions = np.zeros((ntri, 3, 3), F)
    colors = np.asarray(colors, F).reshape(-1, 3, 3)
    emissions = np.asarray(emissions, F).reshape(-1, 3, 3)
    origin = np.asarray(origin, F)

    mortons = []
    cols = []
    emis = []
    for i in range(ntri):
        v0, v1, v2 = vertices[i]
        ctx = TriContext(v0, v1, v2, six_separating, origin, dps, grid_res)
        xyz = ctx.test_grid()
        if len(xyz) == 0:
            continue
        m = morton_ops.np_encode(xyz[:, 0], xyz[:, 1], xyz[:, 2])
        mortons.append(m)
        if not attributes:
            continue
        for x, y, z in xyz:
            p = origin + np.array([x, y, z], F) * F(dps)
            bc = closest_barycentric(v0, v1, v2, p)
            c = bc[0] * colors[i, 1] + bc[1] * colors[i, 2] + bc[2] * colors[i, 0]
            e = (
                bc[0] * emissions[i, 1]
                + bc[1] * emissions[i, 2]
                + bc[2] * emissions[i, 0]
            )
            cols.append((c * F(255.0) + F(0.5)).astype(np.uint8))
            emis.append((e * F(255.0) + F(0.5)).astype(np.uint8))
    if not attributes:
        m = np.concatenate(mortons) if mortons else np.zeros(0, np.int64)
        return np.unique(m), None, None
    if not mortons:
        return (
            np.zeros(0, np.int64),
            np.zeros((0, 4), np.uint8),
            np.zeros((0, 4), np.uint8),
        )
    m = np.concatenate(mortons)
    c = np.stack(cols)
    e = np.stack(emis)

    order = np.argsort(m, kind="stable")
    m, c, e = m[order], c[order], e[order]
    # unique with integer-mean attributes
    um, first, counts = np.unique(m, return_index=True, return_counts=True)
    oc = np.zeros((len(um), 4), np.uint8)
    oe = np.zeros((len(um), 4), np.uint8)
    for k in range(len(um)):
        s, n = first[k], counts[k]
        oc[k, :3] = c[s : s + n, :3].astype(np.int64).sum(0) // n
        oe[k, :3] = e[s : s + n, :3].astype(np.int64).sum(0) // n
        oc[k, 3] = 255
        oe[k, 3] = 255
    return um, oc, oe



def brute_force_rays(morton_sorted, lower, dps, ro, rd, chunk_elems=1 << 24):
    """Slab-test every voxel AABB (the reference's intersect_brute_force,
    for many rays): ro / rd f32 [N, 3] tensors on any device. Returns
    (t f32 [N], v_index int64 [N]): t = entry distance (must be > 0),
    v_index = Morton rank of the hit voxel; t = inf and v_index = 0 on a
    miss. Among equal entry distances the lowest rank wins, as the
    reference's np.argmin picks the first."""
    dev = ro.device
    f32 = torch.float32
    x, y, z = morton_ops.np_decode(morton_sorted)
    lo = (np.asarray(lower, F)
          + np.stack([x, y, z], -1).astype(F) * F(dps))
    hi = lo + F(dps)
    lo_t = torch.from_numpy(lo).to(dev)
    hi_t = torch.from_numpy(hi).to(dev)
    n_vox = lo_t.shape[0]
    rank = torch.arange(n_vox, dtype=torch.int64, device=dev)
    t_out = torch.full((ro.shape[0],), float("inf"), dtype=f32, device=dev)
    v_out = torch.zeros(ro.shape[0], dtype=torch.int64, device=dev)
    step = max(1, chunk_elems // max(3 * n_vox, 1))
    inf = torch.tensor(float("inf"), dtype=f32, device=dev)
    for a in range(0, ro.shape[0], step):
        o = ro[a:a + step].to(f32)[:, None, :]
        d = rd[a:a + step].to(f32)[:, None, :]
        inv = torch.ones((), dtype=f32, device=dev) / d
        t0 = (lo_t[None] - o) * inv
        t1 = (hi_t[None] - o) * inv
        tmin = torch.minimum(t0, t1)
        tmax = torch.maximum(t0, t1)
        # rd == 0 on an axis: the ray is parallel; inside the slab iff
        # lo <= ro <= hi
        flat = d == 0.0
        inside = (lo_t[None] <= o) & (o <= hi_t[None])
        tmin = torch.where(flat, torch.where(inside, -inf, inf), tmin)
        tmax = torch.where(flat, torch.where(inside, inf, -inf), tmax)
        t_enter = tmin.amax(dim=2)
        t_exit = tmax.amin(dim=2)
        hit = (t_enter <= t_exit) & (t_enter > 0.0)
        t_hit = torch.where(hit, t_enter, inf)
        best_t = t_hit.amin(dim=1)
        first = torch.where(hit & (t_hit == best_t[:, None]), rank[None],
                            n_vox).amin(dim=1)
        t_out[a:a + step] = best_t
        v_out[a:a + step] = torch.where(first < n_vox, first, 0)
    return t_out, v_out


# ---------------------------------------------------------------------------
# Octree builders (IntersectorOctree.hpp semantics)
# ---------------------------------------------------------------------------

class OracleOctree:
    """children / psum / mask arrays; children == 0xFFFFFFFF marks a leaf
    voxel."""

    def __init__(self, children, psum, mask, grid_res):
        self.children = children  # uint32 [N, 8]
        self.psum = psum  # uint32 [N, 8]
        self.mask = mask  # uint32 [N]
        self.grid_res = grid_res

    @property
    def n_nodes(self):
        return len(self.mask)


def build_octree(morton_sorted, grid_res, dag=True):
    """Bottom-up build, one voxel at a time; returns an OracleOctree (root
    = last node)."""
    tasks = [(int(m), 0xFFFFFFFF, 1) for m in morton_sorted]  # (morton, child, nvox)
    children_rows = []
    psum_rows = []
    masks = []
    existing = {}
    wide = int(grid_res)
    while wide > 1:
        # group by parent Morton
        next_tasks = []
        i = 0
        n = len(tasks)
        while i < n:
            pm = tasks[i][0] >> 3
            j = i
            ch = [0xFFFFFFFF] * 8
            ps = [0] * 8
            mask = 0
            while j < n and (tasks[j][0] >> 3) == pm:
                slot = tasks[j][0] & 7
                mask |= 1 << slot
                ch[slot] = tasks[j][1]
                ps[slot] = tasks[j][2]
                j += 1
            total = 0
            for k in range(8):
                c = ps[k]
                ps[k] = total
                total += c
            key = (mask, tuple(ch))
            if dag and key in existing:
                idx = existing[key]
            else:
                idx = len(masks)
                children_rows.append(ch)
                psum_rows.append(ps)
                masks.append(mask)
                if dag:
                    existing[key] = idx
            next_tasks.append((pm, idx, total))
            i = j
        tasks = next_tasks
        wide //= 2
    return OracleOctree(
        np.array(children_rows, np.uint32).reshape(-1, 8),
        np.array(psum_rows, np.uint32).reshape(-1, 8),
        np.array(masks, np.uint32),
        grid_res,
    )


def embed_masks(tree: OracleOctree):
    """Pack each child's mask into bits 24..31 of the parent's pointer
    (voxCommon.hpp:183-195)."""
    ch = tree.children.copy()
    for i in range(tree.n_nodes):
        for j in range(8):
            c = ch[i, j]
            if c == 0xFFFFFFFF:
                continue
            ch[i, j] = c | (np.uint32(tree.mask[c & 0xFFFFFF]) << np.uint32(24))
    return OracleOctree(ch, tree.psum, tree.mask, tree.grid_res)


def intersect_brute_force(morton_sorted, lower, dps, ro, rd):
    """Slab-test every voxel AABB for one ray (numpy); returns (t, n_major,
    v_index) with the reference conventions: t = entry distance (must be
    > 0), n_major in {1: x, 2: y, 0: z}, v_index = Morton rank of the hit
    voxel. A miss gives t = inf."""
    x, y, z = morton_ops.np_decode(morton_sorted)
    lo = np.asarray(lower, F) + np.stack([x, y, z], -1).astype(F) * F(dps)
    hi = lo + F(dps)
    ro = np.asarray(ro, F)
    rd = np.asarray(rd, F)
    with np.errstate(divide="ignore", invalid="ignore"):
        inv = F(1.0) / rd
        t0 = (lo - ro) * inv
        t1 = (hi - ro) * inv
    tmin = np.minimum(t0, t1)
    tmax = np.maximum(t0, t1)
    # rd == 0 on an axis: the ray is parallel; inside the slab iff
    # lo <= ro <= hi
    for a in range(3):
        if rd[a] == 0.0:
            inside = (lo[:, a] <= ro[a]) & (ro[a] <= hi[:, a])
            tmin[:, a] = np.where(inside, -np.inf, np.inf)
            tmax[:, a] = np.where(inside, np.inf, -np.inf)
    t_enter = tmin.max(axis=1)
    t_exit = tmax.min(axis=1)
    hit = (t_enter <= t_exit) & (t_enter > 0.0)
    if not hit.any():
        return np.inf, -1, 0
    idx = np.where(hit)[0]
    best = idx[np.argmin(t_enter[idx])]
    axis = int(np.argmax(tmin[best]))  # the axis achieving the entry
    n_major = {0: 1, 1: 2, 2: 0}[axis]
    return float(t_enter[best]), n_major, int(best)
