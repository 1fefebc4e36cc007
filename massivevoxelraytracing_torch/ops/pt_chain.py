"""The path tracer's per-lane sample chain (models/pathtracer.pt_sample)
in five stages, each a plain PyTorch function and a hand-written CUDA
kernel (csrc/pt_chain.cu, one thread per lane).

The reference's `pt_sample` is one jitted program: XLA fuses its sample
chain -- the Owen-scrambled PMJ02 draws (ops/sampling.pmj_sample2d over
ops/hashing and ops/bits), the HDRI alias-table importance sample
(ops/hdri.importance_sample), the cosine directions
(sampling.sample_lambertian) and the throughput / radiance updates -- into
a few fusions a bounce. Run as eager tensor code it is ~1,700 device
kernels a bounce; here it is one kernel a stage:

  lane_init       pixel / spp offsets of both lane layouts, the pix_perm
                  take, the PMJ stream (or the PCG32 state), PMJ dims 0-1
                  and the thin-lens primary ray
  primary_shade   after the primary traversal: the miss mask, the primary
                  HDRI lookup on a miss, the raw voxel emission on a hit
  bounce_sample   albedo, hit normal, hit point (dead lanes parked at
                  1e9), the bounce's PMJ dims in the reference's order
                  (NEE 2, the depth-0 implicit ray 1, BSDF 1), the HDRI
                  importance sample, the cosine directions
  bounce_shade    after the BSDF (+ implicit) and NEE traversals:
                  visibility, the NEE contribution, T *= albedo, the
                  emission pickups, the hit-state advance, and the next
                  bounce's compaction key
  compact_gather  every per-lane tensor gathered by the compaction's
                  permutation (the stable sort itself stays torch.sort)

`*_plain` are pt_sample's code moved as it was, with every float
expression in its order and every divisor a device tensor. The wrappers
(`lane_init`, ...) run the plain stage for CPU tensors and launch the
kernel for CUDA tensors (or raise; there is no fallback). The kernels are
built with -fmad=false and IEEE division and square root, hash in
uint32_t and evaluate the transcendentals in double rounded to float, as
the plain stages do (sampling._f64), so on the card each kernel equals its
plain stage bit for bit.

The bounce sample's kernel has both HDRI backends: the alias tables (the
default) and `sats` (use_alias=False), the binary searches over the u32
prefix tables in hdri.importance_sample's fixed number of steps.

Counters: LAUNCHES[name] counts each kernel's launches.
"""

from __future__ import annotations

import ctypes
import math
import sys
import types

import numpy as np
import torch

from . import hdri as hdri_ops
from . import rng as rng_ops
from . import sampling
from .bits import MASK32, uniformf
from .hashing import hash_combine
from .traverse import hit_normal
from .voxelize import rgb8_to_f32

F32 = torch.float32
I32 = torch.int32
I64 = torch.int64

KERNELS = ("pt_lane_init", "pt_primary_shade", "pt_bounce_sample",
           "pt_bounce_shade", "pt_compact_gather")
LAUNCHES = dict.fromkeys(KERNELS, 0)


def reset_counters() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _take(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The reference's take(mode="clip"): indices clamp into range."""
    return table[torch.clamp(idx.to(I64), 0, table.shape[0] - 1)]


def sample2d(pmj_table, stream, spp, pcg, dim: int):
    """((u0, u1), pcg): sample dimension `dim` of each lane's stream, the
    PMJ02 point (pcg None) or the next two PCG32 draws."""
    if pcg is None:
        return sampling.pmj_sample2d(pmj_table, spp, dim, stream), None
    state, inc = pcg
    state, a = rng_ops.pcg32_next(state, inc)
    state, b = rng_ops.pcg32_next(state, inc)
    return (uniformf(a), uniformf(b)), (state, inc)


# ---------------------------------------------------------------------------
# the plain stages
# ---------------------------------------------------------------------------

def lane_init_plain(pmj_table, pix_perm, cam, pix_start: int, spp_base: int, *,
                    width: int, pix_packet: int, n_spp: int, spp_major: bool,
                    use_pmj: bool):
    """The lanes of one packet and their thin-lens primary rays. cam: the
    f32 tensors (cam_o, cam_right, cam_up, cam_front, tan_half_fovy,
    lens_r, focus, inv_w, inv_h, aspect). Returns (stream, spp, pcg, ro,
    rd): u32 values in int64 [R], pcg (state, inc) int64 [R] each or None
    (PMJ), f32 [R, 3]."""
    cam_o, cam_right, cam_up, cam_front, tan_half_fovy, lens_r, focus, \
        inv_w, inv_h, aspect = cam
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
    # a per-(pixel, spp) PCG32 stream when the PMJ table is off
    pcg = None if use_pmj else rng_ops.pcg32_init(hash_combine(stream, spp), stream)

    (cu0, cu1), pcg = sample2d(pmj_table, stream, spp, pcg, 0)
    (lu0, lu1), pcg = sample2d(pmj_table, stream, spp, pcg, 1)
    xf = (px.to(F32) + cu0) * inv_w
    yf = (py.to(F32) + cu1) * inv_h
    fx = focus * (-tan_half_fovy + 2.0 * tan_half_fovy * xf) * aspect
    fy = focus * (tan_half_fovy - 2.0 * tan_half_fovy * yf)
    lx = -lens_r + 2.0 * lens_r * lu0
    ly = -lens_r + 2.0 * lens_r * lu1
    rd = ((fx - lx)[:, None] * cam_right + (fy - ly)[:, None] * cam_up
          + focus * cam_front)
    ro = cam_o + lx[:, None] * cam_right + ly[:, None] * cam_up
    return stream, spp, pcg, ro, rd


def primary_shade_plain(env, emission_table, rd, t, vidx, *, hdri: bool):
    """After the primary traversal: (T ones, L, miss). A miss sees the
    primary HDRI (when `hdri`), a hit its voxel's raw emission."""
    R = t.shape[0]
    T = torch.ones((R, 3), dtype=F32, device=t.device)
    L = torch.zeros((R, 3), dtype=F32, device=t.device)
    miss = t >= 1e37
    if hdri:
        env_col = hdri_ops.sample_nearest(env, rd, primary=True)
        L = torch.where(miss[:, None], env_col, L)
    le = rgb8_to_f32(_take(emission_table, vidx))
    L = torch.where(miss[:, None], L, le)  # Le raw, unscaled on primary hit
    return T, L, miss


def bounce_sample_plain(env, color_table, pmj_table, vidx, nmaj, ro, rd, t, miss,
                        stream, spp, pcg, *, dim: int, hdri: bool, extra: bool):
    """One bounce's samples, drawing sample dimensions from `dim` on.
    Returns (refl, hit_n, hit_p, rd, dir_e, dir_s, emissive, pdf, pcg):
    hit_p is also the BSDF ray's origin (the reference's
    where(alive, hit_p, 1e9) is hit_p itself: a dead lane's hit_p is 1e9
    already); rd the BSDF direction on live lanes, the old one on dead
    lanes; dir_e (the depth-0 implicit ray, `extra`) and dir_s / emissive /
    pdf (the NEE sample, `hdri`) None when off."""
    alive = ~miss
    refl = rgb8_to_f32(_take(color_table, vidx))
    hit_n = hit_normal(nmaj, rd)
    # dead lanes park far outside the root box: their NEE / implicit /
    # BSDF traversals all retire at once
    hit_p = torch.where(
        alive[:, None], ro + rd * torch.where(miss, 0.0, t)[:, None], 1e9)

    # the bounce's sample dims, in the reference's fixed order
    dir_s = emissive = pdf = None
    if hdri:
        u01, pcg = sample2d(pmj_table, stream, spp, pcg, dim)
        u23, pcg = sample2d(pmj_table, stream, spp, pcg, dim + 1)
        dim += 2
        dir_s, emissive, pdf = hdri_ops.importance_sample(
            env, hit_n, u01[0], u01[1], u23[0], u23[1], axis_aligned=True)
    dir_e = None
    if extra:
        eu, pcg = sample2d(pmj_table, stream, spp, pcg, dim)
        dim += 1
        dir_e = sampling.sample_lambertian(eu[0], eu[1], hit_n)
    bu, pcg = sample2d(pmj_table, stream, spp, pcg, dim)
    dir_b = sampling.sample_lambertian(bu[0], bu[1], hit_n)
    rd = torch.where(alive[:, None], dir_b, rd)
    return refl, hit_n, hit_p, rd, dir_e, dir_s, emissive, pdf, pcg


def bounce_shade_plain(emission_table, emission_scale, T, L, refl, hit_n, dir_s,
                       emissive, pdf, miss, nmaj, vidx, rd, t_s, t_e, v_e, t_b,
                       nm_b, vi_b, *, inv_extra: float, w_depth0: float,
                       key: bool):
    """After the bounce's traversals: t_s the NEE (any-hit) t (None
    without the HDRI), t_e / v_e the implicit ray's (None off depth 0),
    t_b / nm_b / vi_b the BSDF ray's. inv_extra: 1 + the implicit rays;
    w_depth0: the BSDF pickup's weight. Returns (T, L, t, nmaj, vidx,
    miss, key): t is t_b; key (with `key`) the next bounce's compaction
    key: the direction octant of live lanes, 8 for dead ones, in the high
    word, the hit voxel in the low word."""
    dev = T.device
    pi = torch.tensor(math.pi, dtype=F32, device=dev)
    alive = ~miss
    if dir_s is not None:
        # NEE to the environment, any-hit
        vis = alive & (t_s >= 1e37)
        cosw = torch.clamp(hit_n[:, 0] * dir_s[:, 0]
                           + hit_n[:, 1] * dir_s[:, 1]
                           + hit_n[:, 2] * dir_s[:, 2], min=0.0)
        contrib = T * (refl / pi) * (cosw / pdf)[:, None] * emissive
        L = torch.where(vis[:, None], L + contrib, L)

    T = torch.where(alive[:, None], T * refl, T)

    if t_e is not None:
        # one extra implicit emission ray
        le_e = rgb8_to_f32(_take(emission_table, v_e)) * emission_scale
        pick = alive & (t_e < 1e37)
        L = torch.where(pick[:, None],
                        L + T * le_e / torch.tensor(inv_extra, dtype=F32, device=dev), L)

    # BSDF ray; only alive lanes advance their hit state
    new_hit = alive & (t_b < 1e37)
    le_b = rgb8_to_f32(_take(emission_table, vi_b)) * emission_scale
    L = torch.where(new_hit[:, None], L + T * le_b * w_depth0, L)

    nmaj = torch.where(new_hit, nm_b, nmaj)
    vidx = torch.where(new_hit, vi_b, vidx)
    miss = ~new_hit  # dead lanes stay dead
    k = None
    if key:
        octant = ((rd[:, 0] < 0).to(I64) + 2 * (rd[:, 1] < 0).to(I64)
                  + 4 * (rd[:, 2] < 0).to(I64))
        k = torch.where(new_hit, octant, 8)
        k = (k << 32) | (vidx.to(I64) & MASK32)
    return T, L, t_b, nmaj, vidx, miss, k


def compact_gather_plain(perm, vidx, stream, spp, orig, nmaj, t, ro, rd, T, L):
    """Every per-lane tensor gathered by `perm`; then the miss mask of the
    gathered t. Returns (vidx, stream, spp, orig, nmaj, t, ro, rd, T, L,
    miss)."""
    vidx, stream, spp, orig, nmaj, t = (
        x[perm] for x in (vidx, stream, spp, orig, nmaj, t))
    ro, rd, T, L = (x[perm] for x in (ro, rd, T, L))
    return vidx, stream, spp, orig, nmaj, t, ro, rd, T, L, t >= 1e37


# ---------------------------------------------------------------------------
# the wrappers: the plain stage for CPU tensors, the kernel for CUDA ones
# ---------------------------------------------------------------------------

def _device_of(x: torch.Tensor) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no pt_chain kernel for device {x.device}")
    return x.device.type


def _ptr(x) -> int | None:
    return None if x is None else x.data_ptr()


def _check(name, x, dtype, shape, device):
    if (x.device != device or x.dtype != dtype or tuple(x.shape) != tuple(shape)
            or not x.is_contiguous()):
        raise ValueError(f"{name}: need contiguous {dtype} {list(shape)} on {device}, "
                         f"got {x.dtype} {list(x.shape)} on {x.device}")


def _check_table(name, x, dtype, device):
    if x.device != device or x.dtype != dtype or not x.is_contiguous() or x.numel() < 1:
        raise ValueError(f"{name}: need a contiguous non-empty {dtype} table on {device}")


def _launched(name: str, rc: int, n: int) -> None:
    """Raise on a refused launch; count it (the kernels launch nothing for
    0 lanes)."""
    if rc != 0:
        from ..utils import cuda_build

        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc} "
                           f"({cuda_build.load().cuda_error_string(rc).decode()})")
    LAUNCHES[name] += n > 0


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _empty(shape, dtype, device, on: bool = True):
    return torch.empty(shape, dtype=dtype, device=device) if on else None


def lane_init(pmj_table, pix_perm, cam, pix_start: int, spp_base: int, *,
              width: int, pix_packet: int, n_spp: int, spp_major: bool,
              use_pmj: bool):
    """lane_init_plain's outputs; CUDA tensors launch pt_lane_init_kernel."""
    kw = dict(width=width, pix_packet=pix_packet, n_spp=n_spp,
              spp_major=spp_major, use_pmj=use_pmj)
    if _device_of(cam[0]) == "cpu":
        return lane_init_plain(pmj_table, pix_perm, cam, pix_start, spp_base, **kw)
    from ..utils import cuda_build

    dev = cam[0].device
    for i, x in enumerate(cam):
        _check(f"cam[{i}]", x, F32, (3,) if i < 4 else (), dev)
    _check_table("pmj_table", pmj_table, F32, dev)
    if pix_perm is not None:
        _check_table("pix_perm", pix_perm, I64, dev)
    R = pix_packet * n_spp
    stream, spp = (torch.empty(R, dtype=I64, device=dev) for _ in range(2))
    pcg = None if use_pmj else (torch.empty(R, dtype=I64, device=dev),
                                torch.empty(R, dtype=I64, device=dev))
    ro, rd = (torch.empty((R, 3), dtype=F32, device=dev) for _ in range(2))
    cam_ptrs = (ctypes.c_void_p * 10)(*[x.data_ptr() for x in cam])
    lib = cuda_build.load()
    with torch.cuda.device(dev):
        rc = lib.pt_lane_init_launch(
            int(use_pmj), pmj_table.data_ptr(), pmj_table.numel() // 2,
            _ptr(pix_perm), 0 if pix_perm is None else pix_perm.numel(),
            pix_start & MASK32, spp_base & MASK32, width, pix_packet, n_spp,
            int(spp_major), ctypes.addressof(cam_ptrs), R, stream.data_ptr(), spp.data_ptr(),
            None if pcg is None else pcg[0].data_ptr(),
            None if pcg is None else pcg[1].data_ptr(),
            ro.data_ptr(), rd.data_ptr(), _stream(dev))
    _launched("pt_lane_init", rc, R)
    return stream, spp, pcg, ro, rd


def primary_shade(env, emission_table, rd, t, vidx, *, hdri: bool):
    """primary_shade_plain's outputs; CUDA tensors launch
    pt_primary_shade_kernel."""
    if _device_of(t) == "cpu":
        return primary_shade_plain(env, emission_table, rd, t, vidx, hdri=hdri)
    from ..utils import cuda_build

    dev = t.device
    R = t.shape[0]
    _check("t", t, F32, (R,), dev)
    _check("vidx", vidx, I32, (R,), dev)
    _check("rd", rd, F32, (R, 3), dev)
    _check_table("emission_table", emission_table, I32, dev)
    img = env.pixels_primary
    _check_table("env.pixels_primary", img, F32, dev)
    T, L = (torch.empty((R, 3), dtype=F32, device=dev) for _ in range(2))
    miss = torch.empty(R, dtype=torch.bool, device=dev)
    lib = cuda_build.load()
    with torch.cuda.device(dev):
        rc = lib.pt_primary_shade_launch(
            int(hdri), t.data_ptr(), vidx.data_ptr(), rd.data_ptr(),
            emission_table.data_ptr(), emission_table.numel(), img.data_ptr(),
            env.width_primary, env.height_primary, float(env.scale), R,
            T.data_ptr(), L.data_ptr(), miss.data_ptr(), _stream(dev))
    _launched("pt_primary_shade", rc, R)
    return T, L, miss


def bounce_sample(env, color_table, pmj_table, vidx, nmaj, ro, rd, t, miss,
                  stream, spp, pcg, *, dim: int, hdri: bool, extra: bool):
    """bounce_sample_plain's outputs; CUDA tensors launch
    pt_bounce_sample_kernel<HDRI, EXTRA, PMJ> (HDRI: none, the alias
    tables or the prefix tables)."""
    if _device_of(t) == "cpu":
        return bounce_sample_plain(env, color_table, pmj_table, vidx, nmaj, ro, rd, t,
                                   miss, stream, spp, pcg, dim=dim, hdri=hdri, extra=extra)
    from ..utils import cuda_build

    dev = t.device
    R = t.shape[0]
    for name, x, dtype, shape in (
            ("vidx", vidx, I32, (R,)), ("nmaj", nmaj, I32, (R,)),
            ("ro", ro, F32, (R, 3)), ("rd", rd, F32, (R, 3)), ("t", t, F32, (R,)),
            ("miss", miss, torch.bool, (R,)), ("stream", stream, I64, (R,)),
            ("spp", spp, I64, (R,))):
        _check(name, x, dtype, shape, dev)
    if pcg is not None:
        _check("pcg state", pcg[0], I64, (R,), dev)
        _check("pcg inc", pcg[1], I64, (R,), dev)
    _check_table("color_table", color_table, I32, dev)
    _check_table("pmj_table", pmj_table, F32, dev)
    w, h = env.width, env.height
    sats = hdri and not env.use_alias
    if sats:
        _check("env.sats", env.sats, I64, (7, h, w), dev)
    elif hdri:
        for name, x, dtype in (("alias_prob", env.alias_prob, F32),
                               ("alias_idx", env.alias_idx, I64),
                               ("alias_pdf", env.alias_pdf, F32)):
            _check(f"env.{name}", x, dtype, (7, w * h), dev)
    if hdri:
        _check("env.pixels", env.pixels, F32, (h, w, 3), dev)
    v3 = (R, 3)
    refl, hit_n, hit_p, rd_out = (torch.empty(v3, dtype=F32, device=dev) for _ in range(4))
    dir_e = _empty(v3, F32, dev, extra)
    dir_s, emissive = (_empty(v3, F32, dev, hdri) for _ in range(2))
    pdf = _empty(R, F32, dev, hdri)
    pcg_out = None if pcg is None else (torch.empty(R, dtype=I64, device=dev), pcg[1])
    lib = cuda_build.load()
    with torch.cuda.device(dev):
        rc = lib.pt_bounce_sample_launch(
            (2 if sats else 1) if hdri else 0, int(extra), int(pcg is None),
            color_table.data_ptr(), color_table.numel(), vidx.data_ptr(),
            nmaj.data_ptr(), ro.data_ptr(), rd.data_ptr(), t.data_ptr(),
            miss.data_ptr(), stream.data_ptr(), spp.data_ptr(),
            None if pcg is None else pcg[0].data_ptr(),
            None if pcg is None else pcg[1].data_ptr(),
            pmj_table.data_ptr(), pmj_table.numel() // 2, dim,
            _ptr(env.alias_prob) if hdri and not sats else None,
            _ptr(env.alias_idx) if hdri and not sats else None,
            _ptr(env.alias_pdf) if hdri and not sats else None,
            _ptr(env.sats) if sats else None,
            _ptr(env.pixels) if hdri else None, w, h, hdri_ops.search_steps(w),
            hdri_ops.search_steps(h), float(env.scale), float(np.float32(np.pi / h)),
            float(np.float32(2.0 * np.pi / w)), R,
            refl.data_ptr(), hit_n.data_ptr(), hit_p.data_ptr(), rd_out.data_ptr(),
            _ptr(dir_e), _ptr(dir_s), _ptr(emissive), _ptr(pdf),
            None if pcg_out is None else pcg_out[0].data_ptr(), _stream(dev))
    _launched("pt_bounce_sample", rc, R)
    return refl, hit_n, hit_p, rd_out, dir_e, dir_s, emissive, pdf, pcg_out


def bounce_shade(emission_table, emission_scale, T, L, refl, hit_n, dir_s,
                 emissive, pdf, miss, nmaj, vidx, rd, t_s, t_e, v_e, t_b, nm_b,
                 vi_b, *, inv_extra: float, w_depth0: float, key: bool):
    """bounce_shade_plain's outputs; CUDA tensors launch
    pt_bounce_shade_kernel<HDRI, EXTRA>."""
    args = (emission_table, emission_scale, T, L, refl, hit_n, dir_s, emissive,
            pdf, miss, nmaj, vidx, rd, t_s, t_e, v_e, t_b, nm_b, vi_b)
    kw = dict(inv_extra=inv_extra, w_depth0=w_depth0, key=key)
    if _device_of(t_b) == "cpu":
        return bounce_shade_plain(*args, **kw)
    from ..utils import cuda_build

    dev = t_b.device
    R = t_b.shape[0]
    hdri, extra = dir_s is not None, t_e is not None
    checks = [("T", T, F32, (R, 3)), ("L", L, F32, (R, 3)), ("refl", refl, F32, (R, 3)),
              ("miss", miss, torch.bool, (R,)), ("nmaj", nmaj, I32, (R,)),
              ("vidx", vidx, I32, (R,)), ("rd", rd, F32, (R, 3)),
              ("t_b", t_b, F32, (R,)), ("nm_b", nm_b, I32, (R,)),
              ("vi_b", vi_b, I32, (R,)), ("emission_scale", emission_scale, F32, ())]
    if hdri:
        checks += [("hit_n", hit_n, F32, (R, 3)), ("dir_s", dir_s, F32, (R, 3)),
                   ("emissive", emissive, F32, (R, 3)), ("pdf", pdf, F32, (R,)),
                   ("t_s", t_s, F32, (R,))]
    if extra:
        checks += [("t_e", t_e, F32, (R,)), ("v_e", v_e, I32, (R,))]
    for name, x, dtype, shape in checks:
        _check(name, x, dtype, shape, dev)
    _check_table("emission_table", emission_table, I32, dev)
    T_o, L_o = (torch.empty((R, 3), dtype=F32, device=dev) for _ in range(2))
    nmaj_o, vidx_o = (torch.empty(R, dtype=I32, device=dev) for _ in range(2))
    miss_o = torch.empty(R, dtype=torch.bool, device=dev)
    key_o = _empty(R, I64, dev, key)
    lib = cuda_build.load()
    with torch.cuda.device(dev):
        rc = lib.pt_bounce_shade_launch(
            int(hdri), int(extra), emission_table.data_ptr(), emission_table.numel(),
            emission_scale.data_ptr(), T.data_ptr(), L.data_ptr(), refl.data_ptr(),
            _ptr(hit_n) if hdri else None, _ptr(dir_s), _ptr(emissive), _ptr(pdf),
            miss.data_ptr(), nmaj.data_ptr(), vidx.data_ptr(), rd.data_ptr(),
            _ptr(t_s) if hdri else None, _ptr(t_e), _ptr(v_e), t_b.data_ptr(),
            nm_b.data_ptr(), vi_b.data_ptr(), float(inv_extra), float(w_depth0), R,
            T_o.data_ptr(), L_o.data_ptr(), nmaj_o.data_ptr(), vidx_o.data_ptr(),
            miss_o.data_ptr(), _ptr(key_o), _stream(dev))
    _launched("pt_bounce_shade", rc, R)
    return T_o, L_o, t_b, nmaj_o, vidx_o, miss_o, key_o


def compact_gather(perm, vidx, stream, spp, orig, nmaj, t, ro, rd, T, L):
    """compact_gather_plain's outputs; CUDA tensors launch
    pt_compact_gather_kernel (all the gathers in one launch)."""
    lanes = (vidx, stream, spp, orig, nmaj, t, ro, rd, T, L)
    if _device_of(t) == "cpu":
        return compact_gather_plain(perm, *lanes)
    from ..utils import cuda_build

    dev = t.device
    R = t.shape[0]
    names = ("vidx", "stream", "spp", "orig", "nmaj", "t", "ro", "rd", "T", "L")
    dtypes = (I32, I64, I64, I64, I32, F32, F32, F32, F32, F32)
    _check("perm", perm, I64, (R,), dev)
    for name, x, dtype in zip(names, lanes, dtypes):
        _check(name, x, dtype, (R,) if dtype != F32 or name == "t" else (R, 3), dev)
    outs = [torch.empty_like(x) for x in lanes]
    miss = torch.empty(R, dtype=torch.bool, device=dev)
    lib = cuda_build.load()
    with torch.cuda.device(dev):
        rc = lib.pt_compact_gather_launch(
            perm.data_ptr(), R, *[x.data_ptr() for x in lanes],
            *[x.data_ptr() for x in outs], miss.data_ptr(), _stream(dev))
    _launched("pt_compact_gather", rc, R)
    return (*outs, miss)


PLAIN = types.SimpleNamespace(
    lane_init=lane_init_plain, primary_shade=primary_shade_plain,
    bounce_sample=bounce_sample_plain, bounce_shade=bounce_shade_plain,
    compact_gather=compact_gather_plain)


def stages(chain: str | None):
    """The stages pt_sample runs: None, the wrappers (the kernels on the
    card, the plain stages on the CPU); "plain", the plain stages on any
    device (for holding the kernels against them)."""
    if chain is None:
        return sys.modules[__name__]
    if chain == "plain":
        return PLAIN
    raise ValueError(f"chain must be None or 'plain', not {chain!r}")
