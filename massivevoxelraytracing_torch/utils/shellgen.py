"""Procedural terrain voxels in Morton-cube order, for reference-scale
builds (the port of the reference's utils/shellgen.py; the 16384^3 axis of
renderer_introduction.pdf p.8).

Emits the voxelization of a smooth analytic heightfield h(x, y), each
column filled down to its lowest 4-neighbour top so the surface is
watertight from any direction, as a stream of sorted unique int64 Morton
chunks on the terrain's device. Chunks are Morton-aligned cubes of side
`cube` visited in Morton order of their cube coordinates: a cube's Morton
code is the high bits of its voxels' codes, so the concatenated stream is
globally sorted and brick-aligned, as ops/hako_stream.py needs. The voxel
count is known from the column pass alone (`total_voxels`), before any
chunk is made.

The height is f32 sin / cos then floor, as the reference computes it; the
sin / cos of XLA, of torch on the CPU and of CUDA may differ by an ulp, and
floor turns that into a voxel at the rare integer ties.
"""

from __future__ import annotations

import math

import torch

from ..ops import morton
from ..ops.voxelize import pack_rgb8

F32 = torch.float32
I32 = torch.int32


def _compact3(m: int) -> int:
    """Every 3rd bit of m (bit 0, 3, 6, ...) -> packed int."""
    out = 0
    b = 0
    while m:
        out |= (m & 1) << b
        m >>= 3
        b += 1
    return out


class Terrain:
    """Two-octave sine terrain on a grid_res^3 grid.

    h/R = base + a1 sin(2pi f1 x/R + p) sin(2pi f1 y/R + p')
               + a2 sin(2pi f2 x/R + q) cos(2pi f2 y/R + q')

    The mean column run is about 1 + E[max 4-neighbour drop]: 2-3 voxels
    with the default knobs, so the total is about (2..3) * grid_res^2.
    kmax caps the fill run (steeper columns are cut; the defaults stay
    under it)."""

    def __init__(self, grid_res: int, cube: int | None = None, *,
                 a1: float = 0.07, f1: float = 8.0,
                 a2: float = 0.015, f2: float = 27.0,
                 base: float = 0.5, kmax: int = 8, color: bool = False,
                 device="cuda"):
        if cube is None:
            cube = max(16, min(1024, grid_res // 4))
        assert grid_res % cube == 0 and cube % 16 == 0
        self.R = grid_res
        self.Q = cube
        self.nc = grid_res // cube
        self.kmax = kmax
        self.color = color
        self.params = (a1, f1, a2, f2, base)
        self.device = torch.device(device)
        self._tile_cache: dict[tuple[int, int], tuple[int, int, int]] = {}

    def _f32(self, v) -> torch.Tensor:
        return torch.tensor(v, dtype=F32, device=self.device)

    def _height(self, x, y):
        """h * R for f32 coordinate tensors; every divisor a tensor (on
        CUDA a python-scalar divisor becomes a reciprocal multiply)."""
        a1, f1, a2, f2, base = self.params
        R = self._f32(float(self.R))
        u = x / R
        v = y / R
        two_pi = 2.0 * math.pi
        h = (
            base
            + a1 * torch.sin(two_pi * f1 * u + 0.7) * torch.sin(two_pi * f1 * v + 1.3)
            + a2 * torch.sin(two_pi * f2 * u + 2.1) * torch.cos(two_pi * f2 * v + 0.4)
        )
        return h * float(self.R)

    def _runs(self, x, y):
        """Per-column fill run [zbot, ztop] (int32); x / y f32
        broadcastable."""
        top = self.R - 1
        ztop = torch.clamp(torch.floor(self._height(x, y)).to(I32), 0, top)
        zn = ztop
        for dx, dy in ((1, 0), (-1, 0), (0, 1), (0, -1)):
            n = torch.floor(self._height(x + dx, y + dy)).to(I32)
            zn = torch.minimum(zn, torch.clamp(n, 0, top))
        zbot = torch.maximum(zn, ztop - (self.kmax - 1))
        return zbot, ztop

    def _columns(self, cx: int, cy: int):
        Q = self.Q
        ar = torch.arange(Q, dtype=I32, device=self.device)
        x = (cx * Q + ar)[:, None].to(F32)
        y = (cy * Q + ar)[None, :].to(F32)
        return x, y

    def tile_info(self, cx: int, cy: int) -> tuple[int, int, int]:
        """(voxel count, zmin, zmax) of tile column (cx, cy); cached."""
        key = (cx, cy)
        if key not in self._tile_cache:
            zbot, ztop = self._runs(*self._columns(cx, cy))
            info = torch.stack([(ztop - zbot + 1).sum(), zbot.min().to(torch.int64),
                                ztop.max().to(torch.int64)])
            self._tile_cache[key] = tuple(int(v) for v in info.tolist())
        return self._tile_cache[key]

    def total_voxels(self) -> int:
        return sum(
            self.tile_info(cx, cy)[0]
            for cx in range(self.nc) for cy in range(self.nc)
        )

    def _cube_chunk(self, cx: int, cy: int, cz: int):
        Q, kmax = self.Q, self.kmax
        x, y = self._columns(cx, cy)
        zbot, ztop = self._runs(x, y)
        lo = torch.maximum(zbot, torch.full_like(zbot, cz * Q))
        hi = torch.minimum(ztop, torch.full_like(ztop, cz * Q + (Q - 1)))
        z = lo[:, :, None] + torch.arange(kmax, dtype=I32, device=self.device)
        valid = z <= hi[:, :, None]
        xi = x.to(I32)[:, :, None].expand(z.shape)
        yi = y.to(I32)[:, :, None].expand(z.shape)
        codes = morton.encode(xi[valid], yi[valid], z[valid])
        codes, order = torch.sort(codes)
        if not self.color:
            return (codes,)
        # altitude / steepness banded colormap, packed rgb8 riding the sort
        a1, f1, a2, f2, base = self.params
        amp = max(a1 + a2, 1e-6) * self.R
        rel = torch.clamp(
            (z[valid].to(F32) - (base * self.R - amp)) / self._f32(2.0 * amp),
            0.0, 1.0)
        steep = ((ztop - zbot)[:, :, None] >= 4).expand(z.shape)[valid]
        grass = self._f32([0.23, 0.43, 0.16])
        rock = self._f32([0.43, 0.39, 0.36])
        snow = self._f32([0.92, 0.93, 0.96])
        w_rock = torch.clamp((rel - 0.55) / self._f32(0.2), 0.0, 1.0)[:, None]
        w_snow = torch.clamp((rel - 0.88) / self._f32(0.06), 0.0, 1.0)[:, None]
        rgb = grass + (rock - grass) * w_rock
        rgb = torch.where(steep[:, None], rock, rgb)
        rgb = rgb + (snow - rgb) * w_snow
        col = pack_rgb8(rgb[:, 0], rgb[:, 1], rgb[:, 2])
        return codes, col[order]

    def chunks(self):
        """Yield (codes,) or (codes, color) per cube that the terrain
        reaches, in cube Morton order."""
        Q = self.Q
        for mc in range(self.nc ** 3):
            cx = _compact3(mc)
            cy = _compact3(mc >> 1)
            cz = _compact3(mc >> 2)
            _, zmin, zmax = self.tile_info(cx, cy)
            if cz * Q > zmax or (cz + 1) * Q <= zmin:
                continue
            yield self._cube_chunk(cx, cy, cz)
