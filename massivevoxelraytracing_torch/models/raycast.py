"""Primary-ray renderer (the reference's models/raycast.py): one ray per
pixel, face-normal or voxel-color shading.

A frame is generated on the device directly in 128x128-tile-major order
(rays of one tile are neighbours, so they take similar paths through the
tree), traced in one call of the acceleration structure, shaded, and
un-tiled by a reshape. Rays of the padding past the frame's edge start
parked at 1e9, outside the root box, and miss at once.

Ray generation and the shade are two stages, each a plain PyTorch
function (`_gen_rays_band`, `_shade_flat` / `_shade_untile_band`: the
reference's code in its operation order) and a hand-written CUDA kernel
(csrc/frame.cu: frame_raygen_kernel, frame_shade_kernel<COLOR, UNTILE>).
The wrappers `gen_rays` and `shade` run the plain stage for the CPU and
launch the kernel for a CUDA device or tensors (or raise; there is no
fallback). The camera goes to the ray kernel by value, as the float32
values the plain stage uses, so a frame copies nothing to the card before
its first launch. `render_frame(..., stages="plain")` runs the plain
stages (and the plain brick / octree walks) on any device.

Counters: LAUNCHES[name] counts each frame kernel's launches.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import camera as camera_ops
from ..ops.traverse import hit_normal
from ..ops.voxelize import _check, _f32, rgb8_to_f32
from . import accel as accel_lib

TILE = 128  # pixel tile edge
F32 = torch.float32
KERNELS = ("frame_raygen", "frame_shade")
LAUNCHES = dict.fromkeys(KERNELS, 0)


def reset_counters() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _shade_flat(color_table, rd, t, nmaj, vidx, *, show_color: bool):
    hit = t < 1e37
    if show_color:
        idx = torch.clamp(vidx.to(torch.int64), 0, color_table.shape[0] - 1)
        col = rgb8_to_f32(color_table[idx])
    else:
        col = (hit_normal(nmaj, rd) + 1.0) * 0.5
    rgb = torch.where(hit[:, None], col, 0.0)
    img = torch.clamp(rgb * 255.0 + 0.5, 0, 255).to(torch.uint8)
    return img, t


def render_rays(tree, ro, rd, show_color: bool = False,
                traversal: str = "mega"):
    """Render arbitrary rays (f32 [N, 3], numpy or tensors) on the tree's
    device. Returns (u8 [N, 3], f32 [N])."""
    dev = tree.device
    ro = torch.as_tensor(ro, dtype=F32, device=dev).contiguous()
    rd = torch.as_tensor(rd, dtype=F32, device=dev).contiguous()
    kind, depth, meta, root = accel_lib.accel_args(tree, traversal)
    t, nmaj, vidx = accel_lib.intersect_with(
        kind, depth, meta, root, tree.lower, tree.upper, ro, rd)
    return shade(_color_table(tree), rd, t, nmaj, vidx, show_color=show_color)


def tile_order(width: int, height: int, tile_w: int = 128, tile_h: int = 128):
    """Pixel permutation putting rectangular tiles contiguous."""
    idx = np.arange(width * height)
    px = idx % width
    py = idx // width
    key = (
        (py // tile_h) * ((width + tile_w - 1) // tile_w) + (px // tile_w)
    ) * (tile_w * tile_h) + (py % tile_h) * tile_w + (px % tile_w)
    return np.argsort(key, kind="stable")


def _gen_rays_tiled(cam_o, cam_right, cam_up, cam_front, tan_half_fovy, *,
                    width: int, height: int):
    """Whole-frame ray generation in 128x128-tile-major order."""
    return _gen_rays_band(
        cam_o, cam_right, cam_up, cam_front, tan_half_fovy, 0,
        width=width, height=height, band_tile_rows=-(-height // TILE),
    )


def _gen_rays_band(cam_o, cam_right, cam_up, cam_front, tan_half_fovy, py0,
                   *, width: int, height: int, band_tile_rows: int):
    """Tile-major rays for a band of tile rows starting at pixel row py0.
    cam_*: f32 [3] tensors and tan_half_fovy a 0-d f32 tensor, all on the
    target device. Float expressions in the reference's order; every
    divisor is a device tensor (on CUDA a CPU-scalar divisor becomes a
    reciprocal multiply)."""
    dev = cam_o.device
    ntx = -(-width // TILE)
    n_pad = ntx * TILE * band_tile_rows * TILE
    lane = torch.arange(n_pad, dtype=torch.int64, device=dev)
    ti = lane // (TILE * TILE)
    k = lane % (TILE * TILE)
    px = (ti % ntx) * TILE + (k % TILE)
    py = (ti // ntx) * TILE + (k // TILE) + py0
    live = (px < width) & (py < height)
    pxf = px.to(F32)
    pyf = py.to(F32)
    th = tan_half_fovy
    w = _f32(width, dev)
    h = _f32(height, dev)
    u = (-th + 2.0 * th * (pxf + 0.5) / w) * _f32(width / height, dev)
    v = th - 2.0 * th * (pyf + 0.5) / h
    rd = u[:, None] * cam_right + v[:, None] * cam_up + cam_front
    ro = torch.where(live[:, None], cam_o[None, :], 1e9)
    return ro.contiguous(), rd.contiguous()


def _shade_untile(color_table, rd, t, nmaj, vidx, *, width: int, height: int,
                  show_color: bool):
    return _shade_untile_band(
        color_table, rd, t, nmaj, vidx, width=width,
        band_tile_rows=-(-height // TILE), rows_out=height,
        show_color=show_color,
    )


def _shade_untile_band(color_table, rd, t, nmaj, vidx, *, width: int,
                       band_tile_rows: int, rows_out: int, show_color: bool):
    """Shade a band of tile rows (tile-major lanes) and un-tile it to
    (u8 [rows_out, width, 3], f32 [rows_out, width])."""
    ntx = -(-width // TILE)
    nty = band_tile_rows
    img, t = _shade_flat(color_table, rd, t, nmaj, vidx, show_color=show_color)

    def untile(x):
        c = tuple(x.shape[1:])
        y = x.reshape((nty, ntx, TILE, TILE) + c)
        y = y.permute((0, 2, 1, 3) + tuple(4 + i for i in range(len(c))))
        return y.reshape((nty * TILE, ntx * TILE) + c)[:rows_out, :width]

    return untile(img), untile(t)


def _color_table(tree):
    if tree.color is not None:
        return tree.color
    return torch.zeros(1, dtype=torch.int32, device=tree.device)


# ---------------------------------------------------------------------------
# the frame's stages: the wrappers (the plain stage for the CPU, the kernel
# for CUDA)
# ---------------------------------------------------------------------------

def _host_f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float32).reshape(-1)


def host_camera(o, right, up, front, tan_half_fovy) -> tuple:
    """The camera as host float32 values (numpy f32 [3] x 4, np.float32):
    what the plain stage rounds it to. Tensors on the card are read back
    once here."""
    vecs = []
    for name, v in (("o", o), ("right", right), ("up", up), ("front", front)):
        v = _host_f32(v)
        if v.shape != (3,):
            raise ValueError(f"camera {name} must hold 3 values, not {v.shape[0]}")
        vecs.append(v)
    th = _host_f32(tan_half_fovy)
    if th.shape != (1,):
        raise ValueError("tan_half_fovy must be one value")
    return (*vecs, np.float32(th[0]))


def camera_of(cam: camera_ops.Camera) -> tuple:
    """host_camera of a Camera."""
    return host_camera(cam.o, cam.right, cam.up, cam.front, cam.tan_half_fovy)


def _route(device: torch.device, name: str) -> str:
    """"cpu" (the plain stage) or "cuda" (the kernel); raises ValueError
    for another device."""
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"no {name} kernel for device {device}")
    return device.type


def _launched(name: str, rc: int, n: int) -> None:
    if rc != 0:
        from ..utils import cuda_build

        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc} "
                           f"({cuda_build.load().cuda_error_string(rc).decode()})")
    LAUNCHES[name] += n > 0


def _band_lanes(width: int, band_tile_rows: int) -> int:
    if width < 1 or band_tile_rows < 1:
        raise ValueError(f"width {width} and band_tile_rows {band_tile_rows} must be >= 1")
    return -(-width // TILE) * TILE * band_tile_rows * TILE


INT32_MAX = 2 ** 31 - 1


def _check_int32_band(width: int, height: int, py0: int, band_tile_rows: int,
                      n_pad: int) -> None:
    """frame_raygen_kernel's lane arithmetic is 32-bit: refuse a band whose
    floats (3 n_pad), pixel rows or sizes an int cannot index."""
    last_row = py0 + band_tile_rows * TILE
    if 3 * n_pad > INT32_MAX or max(width, height, last_row, -py0) > INT32_MAX:
        raise ValueError(
            f"band of {n_pad} lanes ({width}x{height}, rows from {py0}, "
            f"{band_tile_rows} tile rows) is past frame_raygen's 32-bit lane "
            f"arithmetic: 3 n_pad and every row must fit an int32")


def gen_rays(cam: tuple, py0: int, *, width: int, height: int,
             band_tile_rows: int, device):
    """The tile-major rays (ro, rd f32 [n_pad, 3]) of a band of
    band_tile_rows tile rows starting at pixel row py0, on `device`. cam:
    (o, right, up, front, tan_half_fovy), anything numpy takes or tensors
    (host_camera). The CPU runs _gen_rays_band; a CUDA device launches
    frame_raygen_kernel (a band past its 32-bit lane arithmetic raises
    ValueError before anything is allocated); another device raises
    ValueError."""
    device = torch.empty(0, device=device).device
    route = _route(device, "frame_raygen")
    o, right, up, front, th = host_camera(*cam)
    n_pad = _band_lanes(width, band_tile_rows)
    if route == "cpu":
        return _gen_rays_band(
            *(torch.from_numpy(v).to(device) for v in (o, right, up, front)),
            _f32(th, device), py0, width=width, height=height,
            band_tile_rows=band_tile_rows)
    _check_int32_band(width, height, int(py0), band_tile_rows, n_pad)
    import ctypes

    from ..utils import cuda_build

    vals = np.concatenate([o, right, up, front, np.array(
        [th, width, height, width / height], np.float32)])
    host = (ctypes.c_float * 16)(*vals.tolist())
    ro = torch.empty((n_pad, 3), dtype=F32, device=device)
    rd = torch.empty((n_pad, 3), dtype=F32, device=device)
    lib = cuda_build.load()
    with torch.cuda.device(device):
        rc = lib.frame_raygen_launch(ctypes.addressof(host), int(py0), width, height,
                                     band_tile_rows, ro.data_ptr(), rd.data_ptr(),
                                     torch.cuda.current_stream(device).cuda_stream)
    _launched("frame_raygen", rc, n_pad)
    return ro, rd


def shade(color_table, rd, t, nmaj, vidx, *, show_color: bool, width: int | None = None,
          band_tile_rows: int | None = None, rows_out: int | None = None):
    """Shade traced lanes: face normals from nmaj and rd, or the voxel
    colours of vidx (show_color). With width (and band_tile_rows,
    rows_out) the lanes are a tile-major band, un-tiled to (u8 [rows_out,
    width, 3], f32 [rows_out, width]) as _shade_untile_band; without, flat
    (u8 [N, 3], f32 [N]) as _shade_flat. CPU tensors run those plain
    stages; CUDA tensors launch frame_shade_kernel<show_color, untile>;
    another device, dtype or shape raises ValueError."""
    dev = t.device
    route = _route(dev, "frame_shade")
    n = t.shape[0] if t.dim() == 1 else -1
    for name, x, dtype, shape in (("t", t, F32, (n,)), ("nmaj", nmaj, torch.int32, (n,)),
                                  ("vidx", vidx, torch.int32, (n,)),
                                  ("rd", rd, F32, (n, 3))):
        _check(name, x, dtype, shape, dev)
    if (color_table.device != dev or color_table.dtype != torch.int32
            or color_table.dim() != 1 or color_table.numel() < 1
            or not color_table.is_contiguous()):
        raise ValueError(f"color_table: need a contiguous non-empty int32 [M] on {dev}")
    untile = width is not None
    if untile:
        if _band_lanes(width, band_tile_rows) != n or not 1 <= rows_out <= band_tile_rows * TILE:
            raise ValueError(f"{n} lanes are not a band of {band_tile_rows} tile rows "
                             f"{width} wide, or rows_out {rows_out} past it")
    if route == "cpu":
        if untile:
            return _shade_untile_band(color_table, rd, t, nmaj, vidx, width=width,
                                      band_tile_rows=band_tile_rows, rows_out=rows_out,
                                      show_color=show_color)
        return _shade_flat(color_table, rd, t, nmaj, vidx, show_color=show_color)
    from ..utils import cuda_build

    lead = (rows_out, width) if untile else (n,)
    img = torch.empty(lead + (3,), dtype=torch.uint8, device=dev)
    depth = torch.empty(lead, dtype=F32, device=dev)
    n_out = depth.numel()
    lib = cuda_build.load()
    with torch.cuda.device(dev):
        rc = lib.frame_shade_launch(
            int(bool(show_color)), int(untile), t.data_ptr(), nmaj.data_ptr(),
            vidx.data_ptr(), rd.data_ptr(), color_table.data_ptr(), color_table.shape[0],
            n_out, width if untile else 1, img.data_ptr(), depth.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _launched("frame_shade", rc, n_out)
    return img, depth


def render_frame(tree, cam: camera_ops.Camera, width: int, height: int,
                 show_color: bool = False, *, device, traversal: str = "mega",
                 stages: str | None = None):
    """Render one frame on `device`, where the tree must live, through the
    megakernel or the round driver (`traversal`, models/accel.py), or the
    brick / octree walk. Ray generation and the shade run their kernels on
    the card (gen_rays, shade); stages="plain" runs their plain stages and
    the plain walks on any device, with the camera copied to the device
    first (the route before the frame's kernels). Returns device tensors
    (u8 [H, W, 3] image, f32 [H, W] depth)."""
    device = torch.empty(0, device=device).device  # "cuda" -> "cuda:<current>"
    if tree.device != device:
        raise ValueError(f"tree lives on {tree.device}, not {device}")
    kind, depth, meta, root = accel_lib.accel_args(tree, traversal)
    if stages == "plain":
        ro, rd = _gen_rays_tiled(
            torch.as_tensor(cam.o, dtype=F32, device=device),
            torch.as_tensor(cam.right, dtype=F32, device=device),
            torch.as_tensor(cam.up, dtype=F32, device=device),
            torch.as_tensor(cam.front, dtype=F32, device=device),
            _f32(cam.tan_half_fovy, device),
            width=width, height=height,
        )
    else:
        ro, rd = gen_rays(camera_of(cam), 0, width=width, height=height,
                          band_tile_rows=-(-height // TILE), device=device)
    t, nmaj, vidx = accel_lib.intersect_with(
        kind, depth, meta, root, tree.lower, tree.upper, ro, rd, stages=stages)
    if stages == "plain":
        return _shade_untile(_color_table(tree), rd, t, nmaj, vidx,
                             width=width, height=height, show_color=show_color)
    return shade(_color_table(tree), rd, t, nmaj, vidx, show_color=show_color,
                 width=width, band_tile_rows=-(-height // TILE), rows_out=height)
