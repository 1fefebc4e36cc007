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
identical bits. Between the traversals the per-lane sample chain runs in
the stages of ops/pt_chain.py (lane setup, primary shade, bounce sample,
bounce shade, compaction gather) on per-lane state in [R] / [R, 3]
tensors: one CUDA kernel a stage on the card, their plain versions on the
CPU (or with chain="plain"), equal bit for bit. Every float expression
keeps the reference's operation order; lanes are independent, so the
inter-bounce compaction and the lane layouts are pure permutations and
change no bit of the result.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops import camera as camera_ops
from ..ops import hdri as hdri_ops
from ..ops import pt_chain
from ..ops import sampling
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


def pt_sample(meta, root_entry, lower, upper, color_table, emission_table,
              pmj_table, env: hdri_ops.HDRI, cam_o, cam_right, cam_up,
              cam_front, tan_half_fovy, lens_r, focus, pix_start: int,
              spp_base: int, inv_w, inv_h, aspect, emission_scale,
              pix_perm=None, *, width: int, pix_packet: int, n_spp: int,
              accel_kind: str, stack_depth: int, has_emission: bool,
              hdri_enabled: bool, extra_implicit: bool,
              max_bounces: int = MAX_BOUNCES, use_pmj: bool = True,
              use_compact: bool = True, spp_major: bool = False,
              chain: str | None = None):
    """Path-traced samples for (pixel, spp) lanes generated on the device
    from two scalars (pix_start, spp_base). Default layout: lane r =
    s * pix_packet + p covers pixel pix_start + p at sample spp_base + s;
    spp_major: r = p * n_spp + s. pix_perm (optional, int64 [n_pad]) maps
    a packet-linear position to the pixel index (PathTracer._pixel_perm);
    entries past the frame render harmlessly and are dropped by the
    caller. cam_* / tan_half_fovy / lens_r / focus / inv_w / inv_h /
    aspect / emission_scale: f32 tensors on the tree's device. The sample
    chain runs in ops/pt_chain's stages: their kernels on the card, their
    plain versions on the CPU or with chain="plain". Returns f32 [R, 3]
    with R = pix_packet * n_spp."""
    S = pt_chain.stages(chain)
    dev = cam_o.device
    R = pix_packet * n_spp

    def intersect(ro, rd, shadow):
        return accel_lib.intersect_with(
            accel_kind, stack_depth, meta, root_entry, lower, upper,
            ro.contiguous(), rd.contiguous(), shadow=shadow)

    # --- thin-lens primary (PMJ dims 0-1)
    cam = (cam_o, cam_right, cam_up, cam_front, tan_half_fovy, lens_r, focus,
           inv_w, inv_h, aspect)
    stream, spp, pcg, ro, rd = S.lane_init(
        pmj_table, pix_perm, cam, pix_start, spp_base, width=width,
        pix_packet=pix_packet, n_spp=n_spp, spp_major=spp_major, use_pmj=use_pmj)
    t, nmaj, vidx = intersect(ro, rd, False)
    # --- primary emissions
    T, L, miss = S.primary_shade(env, emission_table, rd, t, vidx, hdri=hdri_enabled)

    n_extra = 1 if (extra_implicit and has_emission) else 0

    # inter-bounce compaction: from bounce 1 on, one stable sort puts dead
    # lanes last and groups live lanes by direction octant, then by hit
    # voxel rank (monotone in Morton order); every per-lane quantity rides
    # the permutation and one inverse at the end restores lane order
    compact = use_compact and use_pmj and R >= COMPACT_MIN_LANES
    orig = torch.arange(R, dtype=I64, device=dev) if compact else None
    dim = 2
    key = None
    for depth in range(max_bounces):
        if key is not None:
            perm = torch.sort(key, stable=True).indices
            (vidx, stream, spp, orig, nmaj, t, ro, rd, T, L,
             miss) = S.compact_gather(perm, vidx, stream, spp, orig, nmaj, t,
                                      ro, rd, T, L)
        extra = bool(n_extra) and depth == 0
        (refl, hit_n, hit_p, rd, dir_e, dir_s, emissive, pdf,
         pcg) = S.bounce_sample(env, color_table, pmj_table, vidx, nmaj, ro, rd,
                                t, miss, stream, spp, pcg, dim=dim,
                                hdri=hdri_enabled, extra=extra)
        dim += 2 * hdri_enabled + extra + 1
        ro = hit_p

        # the depth-0 implicit ray and the BSDF ray: one closest-hit batch
        if dir_e is not None:
            t_all, nm_all, vi_all = intersect(
                torch.cat([hit_p, ro]), torch.cat([dir_e, rd]), False)
        else:
            t_all, nm_all, vi_all = intersect(ro, rd, False)
        # NEE to the environment, any-hit
        t_s = intersect(hit_p, dir_s, True)[0] if dir_s is not None else None
        k = R if dir_e is not None else 0
        (T, L, t, nmaj, vidx, miss, key) = S.bounce_shade(
            emission_table, emission_scale, T, L, refl, hit_n, dir_s, emissive,
            pdf, miss, nmaj, vidx, rd, t_s,
            t_all[:R] if dir_e is not None else None,
            vi_all[:R] if dir_e is not None else None,
            t_all[k:], nm_all[k:], vi_all[k:], inv_extra=float(1 + n_extra),
            w_depth0=1.0 / float(1 + n_extra) if depth == 0 else 1.0,
            key=compact and depth + 1 < max_bounces)

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

    def step(self, cam: camera_ops.Camera, n_spp: int | None = None, *,
             chain: str | None = None):
        """One progressive step: +n_spp samples per pixel. chain="plain"
        runs the sample chain's plain stages on the card too (pt_sample)."""
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
                spp_major=self.spp_major, chain=chain,
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
