"""Progressive diffuse path tracer (the port of the reference's
models/pathtracer.py: `pt_sample` and the PathTracer facade).

Light transport per sample, as in the reference:
  thin-lens primary ray -> miss: primary-HDRI lookup; hit: raw voxel
  emission. Then up to 8 diffuse bounces; per bounce:
    NEE: one shadow ray (any-hit traversal) toward an HDRI importance
      sample from the axis-aligned cosine-weighted table of the hit
      normal; contribution T * (R/pi) * cos * E / pdf on visibility.
    extra implicit ray: at depth 0 only, when the scene has emissive
      voxels, one more cosine-sampled ray picks up emission, averaged
      1/(1+n) with the BSDF ray's depth-0 pickup.
    BSDF ray: cosine hemisphere; emission picked up on hit (T *= R first).
  PMJ(0,2) sample dimensions are drawn in a fixed order per (pixel, spp)
  stream, or PCG32 when use_pmj is off.

Every traversal goes through models/accel.py, so a step runs through the
megakernel or through the round driver (`traversal`); both routes give
identical bits. The sample runs eagerly on the tree's device with
per-lane state in [R] / [R, 3] tensors. Every float expression keeps the
reference's operation order and every divisor is a device tensor; lanes
are independent, so the inter-bounce compaction and the lane layouts are
pure permutations and change no bit of the result.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..ops import camera as camera_ops
from ..ops import hdri as hdri_ops
from ..ops import rng as rng_ops
from ..ops import sampling
from ..ops.bits import MASK32, uniformf
from ..ops.hashing import hash_combine
from ..ops.traverse import hit_normal
from ..ops.voxelize import rgb8_to_f32
from . import accel as accel_lib

MAX_BOUNCES = 8
N_BATCH_SPP = 16       # samples per pixel per step
RAY_PACKET = 1 << 21   # max (pixel x spp) lanes per pt_sample call
COMPACT_MIN_LANES = 1 << 14  # inter-bounce compaction from this many lanes
F32 = torch.float32
I64 = torch.int64


def _ckpt_path(path: str) -> str:
    """np.savez silently appends .npz; normalize so save/load agree."""
    return path if path.endswith(".npz") else path + ".npz"


def _take(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The reference's take(mode="clip"): indices clamp into range."""
    return table[torch.clamp(idx.to(I64), 0, table.shape[0] - 1)]


def pt_sample(meta, root_entry, lower, upper, color_table, emission_table,
              pmj_table, env: hdri_ops.HDRI, cam_o, cam_right, cam_up,
              cam_front, tan_half_fovy, lens_r, focus, pix_start: int,
              spp_base: int, inv_w, inv_h, aspect, emission_scale,
              pix_perm=None, *, width: int, pix_packet: int, n_spp: int,
              accel_kind: str, stack_depth: int, has_emission: bool,
              hdri_enabled: bool, extra_implicit: bool,
              max_bounces: int = MAX_BOUNCES, use_pmj: bool = True,
              use_compact: bool = True, spp_major: bool = False):
    """Path-traced samples for (pixel, spp) lanes generated on the device
    from two scalars (pix_start, spp_base). Default layout: lane r =
    s * pix_packet + p covers pixel pix_start + p at sample spp_base + s;
    spp_major: r = p * n_spp + s. pix_perm (optional, int64 [n_pad]) maps
    a packet-linear position to the pixel index (PathTracer._pixel_perm);
    entries past the frame render harmlessly and are dropped by the
    caller. cam_* / tan_half_fovy / lens_r / focus / inv_w / inv_h /
    aspect / emission_scale: f32 tensors on the tree's device. Returns
    f32 [R, 3] with R = pix_packet * n_spp."""
    dev = cam_o.device
    R = pix_packet * n_spp
    lane = torch.arange(R, dtype=I64, device=dev)
    if spp_major:
        pix_off, spp_off = lane // n_spp, lane % n_spp
    else:
        pix_off, spp_off = lane % pix_packet, lane // pix_packet
    pix_idx = (pix_start + pix_off) & MASK32
    if pix_perm is not None:
        pix_idx = _take(pix_perm, pix_idx)
    px = pix_idx % width
    py = pix_idx // width  # rows past the frame render harmlessly
    stream = hash_combine(0, pix_idx)
    spp = (spp_base + spp_off) & MASK32
    pi = torch.tensor(math.pi, dtype=F32, device=dev)

    dim_counter = [0]
    if use_pmj:
        def s2d():
            d = dim_counter[0]
            dim_counter[0] += 1
            return sampling.pmj_sample2d(pmj_table, spp, d, stream)
    else:
        # a per-(pixel, spp) PCG32 stream
        pcg_state = [rng_ops.pcg32_init(hash_combine(stream, spp), stream)]

        def s2d():
            state, inc = pcg_state[0]
            state, a = rng_ops.pcg32_next(state, inc)
            state, b = rng_ops.pcg32_next(state, inc)
            pcg_state[0] = (state, inc)
            return uniformf(a), uniformf(b)

    def intersect(ro, rd, shadow):
        return accel_lib.intersect_with(
            accel_kind, stack_depth, meta, root_entry, lower, upper,
            ro.contiguous(), rd.contiguous(), shadow=shadow)

    # --- thin-lens primary
    cu0, cu1 = s2d()
    lu0, lu1 = s2d()
    xf = (px.to(F32) + cu0) * inv_w
    yf = (py.to(F32) + cu1) * inv_h
    fx = focus * (-tan_half_fovy + 2.0 * tan_half_fovy * xf) * aspect
    fy = focus * (tan_half_fovy - 2.0 * tan_half_fovy * yf)
    lx = -lens_r + 2.0 * lens_r * lu0
    ly = -lens_r + 2.0 * lens_r * lu1
    rd = ((fx - lx)[:, None] * cam_right + (fy - ly)[:, None] * cam_up
          + focus * cam_front)
    ro = cam_o + lx[:, None] * cam_right + ly[:, None] * cam_up

    T = torch.ones((R, 3), dtype=F32, device=dev)
    L = torch.zeros((R, 3), dtype=F32, device=dev)

    t, nmaj, vidx = intersect(ro, rd, False)
    miss = t >= 1e37

    # --- primary emissions
    if hdri_enabled:
        env_col = hdri_ops.sample_nearest(env, rd, primary=True)
        L = torch.where(miss[:, None], env_col, L)
    le = rgb8_to_f32(_take(emission_table, vidx))
    L = torch.where(miss[:, None], L, le)  # Le raw, unscaled on primary hit

    n_extra = 1 if (extra_implicit and has_emission) else 0
    inv_extra = torch.tensor(float(1 + n_extra), dtype=F32, device=dev)

    # inter-bounce compaction: from bounce 1 on, one stable sort puts dead
    # lanes last and groups live lanes by direction octant, then by hit
    # voxel rank (monotone in Morton order); every per-lane quantity rides
    # the permutation and one inverse at the end restores lane order
    compact = use_compact and use_pmj and R >= COMPACT_MIN_LANES
    orig = torch.arange(R, dtype=I64, device=dev)

    for depth in range(max_bounces):
        alive = ~miss
        if compact and depth >= 1:
            octant = ((rd[:, 0] < 0).to(I64) + 2 * (rd[:, 1] < 0).to(I64)
                      + 4 * (rd[:, 2] < 0).to(I64))
            key = torch.where(alive, octant, 8)
            key = (key << 32) | (vidx.to(I64) & MASK32)
            perm = torch.sort(key, stable=True).indices
            vidx, stream, spp, orig, nmaj, t = (
                x[perm] for x in (vidx, stream, spp, orig, nmaj, t))
            ro, rd, T, L = (x[perm] for x in (ro, rd, T, L))
            miss = t >= 1e37
            alive = ~miss
        refl = rgb8_to_f32(_take(color_table, vidx))
        hit_n = hit_normal(nmaj, rd)
        # dead lanes park far outside the root box: their NEE / implicit /
        # BSDF traversals all retire at once
        hit_p = torch.where(
            alive[:, None],
            ro + rd * torch.where(miss, 0.0, t)[:, None], 1e9)

        # the bounce's sample dims, in the reference's fixed order
        dir_s = emissive = pdf = None
        if hdri_enabled:
            u01 = s2d()
            u23 = s2d()
            dir_s, emissive, pdf = hdri_ops.importance_sample(
                env, hit_n, u01[0], u01[1], u23[0], u23[1], axis_aligned=True)
        dir_e = None
        if n_extra and depth == 0:
            eu = s2d()
            dir_e = sampling.sample_lambertian(eu[0], eu[1], hit_n)
        bu = s2d()
        dir_b = sampling.sample_lambertian(bu[0], bu[1], hit_n)
        ro = torch.where(alive[:, None], hit_p, 1e9)
        rd = torch.where(alive[:, None], dir_b, rd)

        # the depth-0 implicit ray and the BSDF ray: one closest-hit batch
        if dir_e is not None:
            t_all, nm_all, vi_all = intersect(
                torch.cat([hit_p, ro]), torch.cat([dir_e, rd]), False)
        else:
            t_all, nm_all, vi_all = intersect(ro, rd, False)
        k = 0
        if dir_s is not None:
            # NEE to the environment, any-hit
            t_s, _, _ = intersect(hit_p, dir_s, True)
            vis = alive & (t_s >= 1e37)
            cosw = torch.clamp(hit_n[:, 0] * dir_s[:, 0]
                               + hit_n[:, 1] * dir_s[:, 1]
                               + hit_n[:, 2] * dir_s[:, 2], min=0.0)
            contrib = T * (refl / pi) * (cosw / pdf)[:, None] * emissive
            L = torch.where(vis[:, None], L + contrib, L)

        T = torch.where(alive[:, None], T * refl, T)

        if dir_e is not None:
            # one extra implicit emission ray
            t_e, v_e = t_all[:R], vi_all[:R]
            k = 1
            le_e = rgb8_to_f32(_take(emission_table, v_e)) * emission_scale
            pick = alive & (t_e < 1e37)
            L = torch.where(pick[:, None], L + T * le_e / inv_extra, L)

        # BSDF ray; only alive lanes advance their hit state
        t = t_all[k * R:]
        nmaj_n = nm_all[k * R:]
        vidx_n = vi_all[k * R:]
        new_hit = alive & (t < 1e37)
        le_b = rgb8_to_f32(_take(emission_table, vidx_n)) * emission_scale
        w_depth0 = 1.0 / float(1 + n_extra) if depth == 0 else 1.0
        L = torch.where(new_hit[:, None], L + T * le_b * w_depth0, L)

        nmaj = torch.where(new_hit, nmaj_n, nmaj)
        vidx = torch.where(new_hit, vidx_n, vidx)
        miss = ~new_hit  # dead lanes stay dead

    if compact and max_bounces >= 2:
        out = torch.empty_like(L)
        out[orig] = L  # the inverse permutation: back to lane order
        L = out
    return L


def _spp_sum(li: torch.Tensor, n_spp: int, pix_packet: int, spp_major: bool):
    """Per-pixel sum over the spp batch, in s order for either layout."""
    li = (li.reshape(pix_packet, n_spp, 3).transpose(0, 1) if spp_major
          else li.reshape(n_spp, pix_packet, 3))
    acc = li[0]
    for s in range(1, n_spp):
        acc = acc + li[s]
    return acc


@dataclasses.dataclass
class PathTracer:
    """Engine facade: owns the scene tree, HDRI, PMJ table and the
    progressive accumulation buffer, on the tree's device (`device` until
    a scene is set; the card unless the caller asks for the CPU).
    `traversal` picks the route of every ray: "mega" or "rounds"."""

    width: int
    height: int
    tree: object | None = None
    env: hdri_ops.HDRI | None = None
    pmj_table: torch.Tensor | None = None
    accum: torch.Tensor | None = None  # f32 [W*H, 4]
    steps: int = 0
    spp_done: int = 0  # cumulative samples accumulated (PMJ sample base)
    emission_scale: float = 7.5
    packet: int = RAY_PACKET
    max_bounces: int = MAX_BOUNCES
    n_batch_spp: int = N_BATCH_SPP
    use_pmj: bool = True
    compact: bool | None = None  # None = auto (on from COMPACT_MIN_LANES)
    tile_packets: bool = True  # 32x32-tile pixel order inside packets
    spp_major: bool = True  # lane block = consecutive pixels x spp batch
    traversal: str = "mega"
    device: object = "cuda"
    _perm_cache: tuple | None = None

    def setup(self):
        if self.pmj_table is None:
            self.pmj_table = torch.from_numpy(sampling.make_pmj_table())
        self.pmj_table = self.pmj_table.to(self.device)
        self.clear_frame_buffer()

    def load_hdri(self, pixels, pixels_primary=None, scale: float = 1.75):
        self.env = hdri_ops.load(pixels, pixels_primary, scale=scale,
                                 device=self.device)

    def update_scene(self, tree):
        """Set the scene; the tracer's state moves to the tree's device."""
        self.tree = tree
        if torch.device(self.device) != tree.device:
            self.device = tree.device
            self.pmj_table = (None if self.pmj_table is None
                              else self.pmj_table.to(self.device))
            self.accum = None if self.accum is None else self.accum.to(self.device)
            self.env = None if self.env is None else self.env.to(self.device)
            self._perm_cache = None

    def clear_frame_buffer(self):
        self.accum = torch.zeros((self.width * self.height, 4), dtype=F32,
                                 device=self.device)
        self.steps = 0
        self.spp_done = 0

    def _pixel_perm(self, pix_packet: int):
        """(perm, inv, n_pad): perm[j] = pixel rendered at packet-linear
        position j, in 32x32 screen-tile raster order; inv[pixel] = j.
        Padding positions carry the out-of-frame sentinel n_pad. n_pad is
        the packet-rounded tile cover of the frame."""
        key = (self.width, self.height, pix_packet, self.tile_packets)
        if self._perm_cache is not None and self._perm_cache[0] == key:
            return self._perm_cache[1:]
        n = self.width * self.height
        if not self.tile_packets:
            n_pad = -(-n // pix_packet) * pix_packet
            out = (None, None, n_pad)
        else:
            ts = 32
            wt = -(-self.width // ts)
            ht = -(-self.height // ts)
            n_tiles = wt * ht * ts * ts
            n_pad = -(-max(n, n_tiles) // pix_packet) * pix_packet
            idx = np.arange(n_tiles, dtype=np.int64)
            t, within = idx // (ts * ts), idx % (ts * ts)
            x = (t % wt) * ts + within % ts
            y = (t // wt) * ts + within // ts
            pix = y * self.width + x
            oob = (x >= self.width) | (y >= self.height)
            perm_np = np.full(n_pad, n_pad, np.int64)
            perm_np[:n_tiles] = np.where(oob, n_pad, pix)
            pos = np.nonzero(perm_np < n)[0]
            inv_np = np.zeros(n, np.int64)
            inv_np[perm_np[pos]] = pos
            out = (torch.from_numpy(perm_np).to(self.device),
                   torch.from_numpy(inv_np).to(self.device), n_pad)
        self._perm_cache = (key,) + out
        return out

    def step(self, cam: camera_ops.Camera, n_spp: int | None = None):
        """One progressive step: +n_spp samples per pixel."""
        if n_spp is None:
            n_spp = self.n_batch_spp
        if self.tree is None or self.pmj_table is None:
            raise RuntimeError("call setup() and update_scene() before step()")
        tree = self.tree
        dev = tree.device
        env = self.env
        if env is None:
            # disabled env: zero-radiance 1x1
            env = hdri_ops.load(np.zeros((1, 1, 3), np.float32), scale=0.0,
                                device=dev)
        kind, depth, meta, root = accel_lib.accel_args(tree, self.traversal)

        n = self.width * self.height
        # pixel sub-packet: pow2 buckets of the frame, with pixels * n_spp
        # * 2 capped at the packet (the implicit + BSDF batch is up to
        # twice the lane width)
        np2 = 1 << max(n - 1, 1).bit_length()
        pix_packet = max(min(self.packet // (max(n_spp, 1) * 2), np2), 1024)
        perm, inv_perm, n_pad = self._pixel_perm(pix_packet)

        def f32(x):
            return torch.tensor(x, dtype=F32, device=dev)

        cam_t = [torch.as_tensor(np.asarray(v, np.float32), device=dev)
                 for v in (cam.o, cam.right, cam.up, cam.front)]
        scalars = [f32(np.float32(v)) for v in (
            cam.tan_half_fovy, cam.lens_r, cam.focus)]
        frame = [f32(np.float32(v)) for v in (
            1.0 / self.width, 1.0 / self.height, self.width / self.height,
            self.emission_scale)]
        color = tree.color if tree.color is not None else torch.zeros(
            1, dtype=torch.int32, device=dev)
        emission = tree.emission if tree.emission is not None else torch.zeros(
            1, dtype=torch.int32, device=dev)
        parts = []
        for k in range(n_pad // pix_packet):
            li = pt_sample(
                meta, root, tree.lower, tree.upper, color, emission,
                self.pmj_table, env, *cam_t, *scalars, k * pix_packet,
                self.spp_done, *frame, perm,
                width=self.width, pix_packet=pix_packet, n_spp=n_spp,
                accel_kind=kind, stack_depth=depth,
                has_emission=tree.has_emission,
                hdri_enabled=self.env is not None and env.scale > 0,
                extra_implicit=True, max_bounces=self.max_bounces,
                use_pmj=self.use_pmj,
                use_compact=True if self.compact is None else bool(self.compact),
                spp_major=self.spp_major,
            )
            parts.append(_spp_sum(li, n_spp, pix_packet, self.spp_major))
        radiance = torch.cat(parts)
        if inv_perm is not None:
            radiance = radiance[inv_perm]  # tile order -> pixel order
        radiance = radiance[:n]
        self.accum = self.accum + torch.cat(
            [radiance, torch.full((n, 1), float(n_spp), dtype=F32, device=dev)],
            dim=1)
        self.steps += 1
        self.spp_done += n_spp

    def save_checkpoint(self, path: str, frame: int = 0):
        """Serialize progressive state (accum buffer, spp steps, frame)."""
        np.savez(
            _ckpt_path(path),
            accum=self.accum.cpu().numpy(),
            steps=np.int64(self.steps),
            spp_done=np.int64(self.spp_done),
            frame=np.int64(frame),
            width=np.int64(self.width),
            height=np.int64(self.height),
        )

    def load_checkpoint(self, path: str) -> int:
        """Restore progressive state; returns the stored frame index."""
        z = np.load(_ckpt_path(path))
        if int(z["width"]) != self.width or int(z["height"]) != self.height:
            raise ValueError("checkpoint resolution mismatch")
        self.accum = torch.from_numpy(z["accum"]).to(self.device)
        self.steps = int(z["steps"])
        self.spp_done = (int(z["spp_done"]) if "spp_done" in z
                         else self.steps * N_BATCH_SPP)
        return int(z["frame"])

    def resolve(self) -> np.ndarray:
        """accum -> u8 image with 1/2.2 gamma (on the host)."""
        acc = self.accum.cpu().numpy()
        w = np.maximum(acc[:, 3:4], 1e-8)
        rgb = np.clip(acc[:, :3] / w, 0.0, None) ** (1.0 / 2.2)
        img = np.clip(255.0 * rgb + 0.5, 0, 255).astype(np.uint8)
        return img.reshape(self.height, self.width, 3)
