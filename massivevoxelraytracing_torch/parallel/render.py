"""Sharded primary frame and progressive path-trace step over a mesh (the
port of the JAX package's parallel/render.py).

The scene tables are replicated: each shard reads them on its own device
(a copy is made only where a shard's device differs from the tables').
The frame shards its 128-pixel tile-row bands over the flattened mesh;
the PT step shards pixels over 'dp' and samples over 'sp', reduced with
the mesh's ordered psum. Both return plain functions on tensors: each
call runs every shard's body (on one card, one after another) and the
collectives, and returns tensors on the mesh's first device.
"""

from __future__ import annotations

import torch

from ..models import accel as accel_lib
from ..models import raycast
from ..models.pathtracer import pt_sample
from .mesh import Mesh, all_gather, psum

F32 = torch.float32


def _on(dev, *xs):
    """xs on dev: tensors and anything else with a `.to` (an HDRI) moved,
    tuples entered, the rest (ints, None) as it is."""
    return [tuple(_on(dev, *x)) if isinstance(x, tuple)
            else x.to(dev) if hasattr(x, "to") else x for x in xs]


def make_sharded_render(mesh: Mesh, *, width: int, height: int, kind: str,
                        depth, show_color: bool = False):
    """Primary-ray frame over every entry of the mesh: band b of
    ceil(tile rows / entries) tile rows goes to entry b; it generates its
    rays from pixel row b * band_rows (raycast.gen_rays), traces them
    (intersect_with) and shades and un-tiles them (raycast.shade): the
    frame's kernels on a CUDA entry, their plain stages on a CPU one. The
    bands are concatenated and cut to `height` (rows of the last band past
    the frame start parked, miss, and are dropped). Every lane equals
    render_frame's bit for bit."""
    devs = mesh.flat()
    nty = -(-height // raycast.TILE)
    band_nty = -(-nty // len(devs))
    band_rows = band_nty * raycast.TILE

    def render(meta, root, lower, upper, color_table, cam_o, cam_right,
               cam_up, cam_front, tan_half_fovy):
        imgs, ts = [], []
        cam = raycast.host_camera(cam_o, cam_right, cam_up, cam_front,
                                  tan_half_fovy)
        for b, dev in enumerate(devs):
            meta_d, root_d, lower_d, upper_d, color_d = _on(
                dev, meta, root, lower, upper, color_table)
            ro, rd = raycast.gen_rays(
                cam, b * band_rows, width=width, height=height,
                band_tile_rows=band_nty, device=dev)
            t, nmaj, vidx = accel_lib.intersect_with(
                kind, depth, meta_d, root_d, lower_d, upper_d, ro, rd)
            img, t = raycast.shade(
                color_d, rd, t, nmaj, vidx, show_color=show_color,
                width=width, band_tile_rows=band_nty, rows_out=band_rows)
            imgs.append(img)
            ts.append(t)
        return all_gather(imgs)[:height], all_gather(ts)[:height]

    return render


def make_sharded_pt_step(mesh: Mesh, *, stack_depth: int,
                         spp_per_device: int = 2, width: int, height: int,
                         n_pixels: int, has_emission: bool,
                         hdri_enabled: bool, emission_scale: float = 7.5,
                         accel_kind: str = "octree"):
    """One progressive path-trace step over a ('dp', 'sp') mesh: entry
    (i, j) renders pixels [i * P, (i + 1) * P), P = n_pixels / dp, at
    samples spp_base + j * spp_per_device + s (s < spp_per_device) through
    pt_sample; its samples are summed in s order, the sp row's sums are
    psum'd in ascending j, and the row adds them and the sample count to
    its slice of the accumulator. Returns step(meta, root_entry, lower,
    upper, color_table, emission_table, pmj_table, env, cam_o, cam_right,
    cam_up, cam_front, tan_half_fovy, lens_r, focus, accum, spp_base) ->
    the new accumulator, f32 [n_pixels, 4] on the mesh's first device."""
    dp, sp = mesh.devices.shape
    if n_pixels % dp:
        raise ValueError(f"{n_pixels} pixels do not split over dp={dp}")
    shard_pixels = n_pixels // dp
    new_n = float(spp_per_device * sp)

    def step(meta, root_entry, lower, upper, color_table, emission_table,
             pmj_table, env, cam_o, cam_right, cam_up, cam_front,
             tan_half_fovy, lens_r, focus, accum, spp_base):
        rows = []
        for i in range(dp):
            totals = []
            for j in range(sp):
                dev = mesh.devices[i, j]
                args = _on(dev, meta, root_entry, lower, upper, color_table,
                           emission_table, pmj_table, env, cam_o, cam_right,
                           cam_up, cam_front, tan_half_fovy, lens_r, focus)
                frame = [torch.tensor(v, dtype=F32, device=dev) for v in (
                    1.0 / width, 1.0 / height, width / height,
                    emission_scale)]
                li = pt_sample(
                    *args, i * shard_pixels,
                    int(spp_base) + j * spp_per_device, *frame,
                    width=width, pix_packet=shard_pixels,
                    n_spp=spp_per_device, accel_kind=accel_kind,
                    stack_depth=stack_depth, has_emission=has_emission,
                    hdri_enabled=hdri_enabled, extra_implicit=True,
                ).reshape(spp_per_device, shard_pixels, 3)
                total = li[0]
                for s in range(1, spp_per_device):
                    total = total + li[s]
                totals.append(total)
            total = psum(totals)
            dev = total.device
            acc = accum[i * shard_pixels:(i + 1) * shard_pixels].to(dev)
            rows.append(acc + torch.cat(
                [total, torch.full((shard_pixels, 1), new_n, dtype=F32,
                                   device=dev)], dim=1))
        return all_gather(rows)

    return step
