"""The primary frame's two stages (models/raycast.py: gen_rays and shade)
on the CPU, against the JAX package's _gen_rays_band and
_shade_untile_band / _shade_flat evaluated op by op (jax.disable_jit: no
fusion, no FMA contraction), bit for bit:

  * gen_rays on a whole 96x64 frame and on the second tile-row band of a
    200x130 frame (py0 = 128, a width that is not a multiple of 128);
  * shade for face normals and voxel colours, flat and un-tiled, on
    random traced lanes: misses, every nmajor, ±0 and NaN ray components,
    voxel indices below 0 and past the colour table;
  * render_frame's two routes (the wrappers; stages="plain") are the same
    on the CPU;
  * the wrappers refuse a wrong dtype, shape or device before any launch
    (no counter moves), and gen_rays a band past its kernel's 32-bit lane
    arithmetic.

The kernels themselves run on the card only (tests/test_torch_cuda.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from massivevoxelraytracing_tpu.models import raycast as jraycast
from massivevoxelraytracing_torch.models import raycast
from massivevoxelraytracing_torch.ops import camera
from massivevoxelraytracing_torch.utils import cuda_build

# The tensors here are small: one intra-op thread keeps the test runner's
# parallel workers from oversubscribing the cores.
torch.set_num_threads(1)

# (width, height, py0, band_tile_rows): a whole frame, and a band of a
# frame whose width is not a multiple of 128
BANDS = [(96, 64, 0, 1), (200, 130, 128, 1)]


def frame_camera():
    center = np.full(3, 0.5, np.float32)
    return camera.Camera.look_at(eye=center + np.array([0.9, 0.4, 1.4], np.float32),
                                 target=center, fovy_deg=41.0)


def assert_bits(got, want, what):
    got = np.ascontiguousarray(got)
    want = np.ascontiguousarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, what
    if got.dtype == np.float32:
        got, want = got.view(np.int32), want.view(np.int32)
    np.testing.assert_array_equal(got, want, err_msg=what)


@pytest.fixture(autouse=True)
def no_launch(monkeypatch):
    """The CPU route builds and launches nothing."""
    raycast.reset_counters()

    def refuse():
        raise AssertionError("the CPU route loaded the kernel library")

    monkeypatch.setattr(cuda_build, "load", refuse)
    yield
    assert raycast.LAUNCHES == dict.fromkeys(raycast.KERNELS, 0)


@pytest.mark.parametrize("width,height,py0,rows", BANDS)
def test_gen_rays_matches_jax_op_by_op(width, height, py0, rows):
    cam = frame_camera()
    jargs = (*(jnp.asarray(v, jnp.float32) for v in (cam.o, cam.right, cam.up, cam.front)),
             jnp.float32(cam.tan_half_fovy))
    with jax.disable_jit():
        want = jraycast._gen_rays_band(*jargs, jnp.int32(py0), width=width,
                                       height=height, band_tile_rows=rows)
    got = raycast.gen_rays(raycast.camera_of(cam), py0, width=width, height=height,
                           band_tile_rows=rows, device="cpu")
    n_pad = -(-width // 128) * 128 * rows * 128
    for name, g, w in zip(("ro", "rd"), got, want):
        assert tuple(g.shape) == (n_pad, 3)
        assert_bits(g.numpy(), np.asarray(w), name)
    # the padding past the frame's edge is parked
    live = np.asarray(want[0])[:, 0] < 1e8
    assert 0 < live.sum() < n_pad


@pytest.mark.parametrize("width,height,py0,rows", [
    (65536, 65536, 0, 86),               # 3 n_pad = 2,164,260,864
    (1 << 31, 8, 0, 1),                  # the width itself
    (128, 1 << 31, 0, 1),                # the height
    (128, 128, (1 << 31) - 128, 1),      # the band's last row
    (128, 128, -(1 << 31), 1)])          # its first
def test_gen_rays_refuses_a_band_past_32_bits_before_launch(monkeypatch, width, height,
                                                            py0, rows):
    """frame_raygen_kernel's lane arithmetic is 32-bit: the kernel route
    refuses such a band before it allocates or launches anything (the
    route forced to the kernel's; the fixture fails the test if the
    kernel library is loaded or a counter moves)."""
    monkeypatch.setattr(raycast, "_route", lambda device, name: "cuda")
    with pytest.raises(ValueError, match="32-bit"):
        raycast.gen_rays(raycast.camera_of(frame_camera()), py0, width=width, height=height,
                         band_tile_rows=rows, device="cpu")


def traced_lanes(n, rng):
    """Random traced lanes: ~40% misses, every nmajor, ±0 and NaN ray
    components, voxel indices below 0 and past a 300-entry colour table."""
    t = np.where(rng.random(n) < 0.6, rng.uniform(0.01, 3.0, n),
                 np.float32(3.402823466e38)).astype(np.float32)
    nmaj = rng.integers(-1, 3, n).astype(np.int32)
    vidx = rng.integers(-20, 320, n).astype(np.int32)
    rd = rng.normal(size=(n, 3)).astype(np.float32)
    rd[::7, 0] = 0.0
    rd[::11, 1] = -0.0
    rd[::13, 2] = np.nan
    table = rng.integers(-2 ** 31, 2 ** 31, 300).astype(np.int32)
    return table, rd, t, nmaj, vidx


@pytest.mark.parametrize("width,height,py0,rows", BANDS)
@pytest.mark.parametrize("show_color", [False, True])
@pytest.mark.parametrize("untile", [False, True])
def test_shade_matches_jax_op_by_op(width, height, py0, rows, show_color, untile):
    n = -(-width // 128) * 128 * rows * 128
    args = traced_lanes(n, np.random.default_rng(width + rows + 2 * show_color))
    rows_out = min(height - py0, rows * 128)
    with jax.disable_jit():
        jargs = [jnp.asarray(a) for a in args]
        if untile:
            want = jraycast._shade_untile_band(*jargs, width=width, band_tile_rows=rows,
                                               rows_out=rows_out, show_color=show_color)
        else:
            want = jraycast._shade_flat(*jargs, show_color=show_color)
    kw = dict(width=width, band_tile_rows=rows, rows_out=rows_out) if untile else {}
    got = raycast.shade(*(torch.from_numpy(a) for a in args), show_color=show_color, **kw)
    lead = (rows_out, width) if untile else (n,)
    assert tuple(got[0].shape) == lead + (3,) and tuple(got[1].shape) == lead
    assert_bits(got[0].numpy(), np.asarray(want[0]), "image")
    assert_bits(got[1].numpy(), np.asarray(want[1]), "depth")


def test_render_frame_routes_equal_on_cpu():
    """render_frame through the wrappers and through stages="plain" (its
    route before the frame's kernels) on a small random tree."""
    from massivevoxelraytracing_torch.ops import hako, morton

    rng = np.random.default_rng(5)
    c = torch.as_tensor(rng.integers(0, 32, size=(600, 3)))
    codes = morton.encode(c[:, 0], c[:, 1], c[:, 2]).unique()
    tree = hako.build_hako(codes, 32, device="cpu", dps=1.0 / 32)
    cam = frame_camera()
    for show_color in (False, True):
        a = raycast.render_frame(tree, cam, 150, 70, show_color, device="cpu")
        b = raycast.render_frame(tree, cam, 150, 70, show_color, device="cpu", stages="plain")
        for x, y, what in zip(a, b, ("image", "depth")):
            assert_bits(x.numpy(), y.numpy(), what)
        assert int((a[1] < 1e37).sum()) > 100
    with pytest.raises(ValueError, match="stages"):
        raycast.render_frame(tree, cam, 8, 8, device="cpu", stages="kernels")


def test_wrappers_refuse_bad_inputs_before_launch():
    cam = raycast.camera_of(frame_camera())
    with pytest.raises(ValueError, match="no frame_raygen kernel"):
        raycast.gen_rays(cam, 0, width=8, height=8, band_tile_rows=1, device="meta")
    with pytest.raises(ValueError, match=">= 1"):
        raycast.gen_rays(cam, 0, width=0, height=8, band_tile_rows=1, device="cpu")
    with pytest.raises(ValueError, match="3 values"):
        raycast.gen_rays((cam[0][:2],) + cam[1:], 0, width=8, height=8,
                         band_tile_rows=1, device="cpu")
    n = 128 * 128
    table, rd, t, nmaj, vidx = (torch.from_numpy(a) for a in
                                traced_lanes(n, np.random.default_rng(1)))
    good = dict(show_color=False, width=100, band_tile_rows=1, rows_out=100)
    raycast.shade(table, rd, t, nmaj, vidx, **good)
    bad = [
        ((table, rd, t.double(), nmaj, vidx), good, "t"),
        ((table, rd, t, nmaj.long(), vidx), good, "nmaj"),
        ((table, rd, t, nmaj, vidx[:-1]), good, "vidx"),
        ((table, rd[:, :2], t, nmaj, vidx), good, "rd"),
        ((table, rd.t().contiguous().t(), t, nmaj, vidx), good, "rd"),
        ((table.long(), rd, t, nmaj, vidx), good, "color_table"),
        ((table[:0], rd, t, nmaj, vidx), good, "color_table"),
        ((table, rd, t, nmaj, vidx), dict(good, width=300), "band"),
        ((table, rd, t, nmaj, vidx), dict(good, rows_out=129), "band"),
    ]
    for args, kw, what in bad:
        with pytest.raises(ValueError, match=what):
            raycast.shade(*args, **kw)
    meta = [x.to("meta") for x in (table, rd, t, nmaj, vidx)]
    with pytest.raises(ValueError, match="no frame_shade kernel"):
        raycast.shade(*meta, show_color=False)


def test_render_ab_has_its_earlier_sources_and_needs_a_card():
    """scripts/render_ab.py times frame_raygen and the bounce sample
    against the sources it keeps under csrc/earlier/, whose C entry points
    it renames; without a card it raises before building anything."""
    from massivevoxelraytracing_torch.scripts import render_ab

    for kernel, src in render_ab.EARLIER.items():
        with open(src) as f:
            text = f.read()
        assert all(name + "(" in text for name in render_ab.ENTRIES[kernel]), src
        assert f"{kernel}_kernel" in text, src
    with pytest.raises(RuntimeError, match="needs a card"):
        render_ab.run(device="cpu")
