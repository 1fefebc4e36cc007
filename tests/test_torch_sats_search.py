"""The sats HDRI backend's bisections in pt_bounce_sample_kernel's order,
which is hdri._upper_bound's: the port's against the JAX package's,
index for index, on the prefix tables' X searches (the last row of each of
the 7 tables) and Y searches (every column's masked prefix) of the bench
sky, a procedural 512 x 256 sky, skies of width or height 1, 2, 3, 127 and
129 and a sky whose columns step down; and on hand-made sequences that
step down by one, where the bisection's index is not the smallest i with
f(i) > b (a search for that index, k-ary or warp-cooperative, would be
wrong there). Each search sees the same f values, which both functions
take as a table indexed by the midpoint.

The kernel itself runs on the card only (tests/test_torch_cuda.py), held
there bit for bit against the plain stage on such skies.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from massivevoxelraytracing_tpu.ops import hdri as jhdri
from massivevoxelraytracing_torch.ops import hdri
from massivevoxelraytracing_torch.scripts import common
from massivevoxelraytracing_torch.utils import hdr
from test_torch_cuda import sats_step_downs, step_down_sky

# The tensors here are small: one intra-op thread keeps the test runner's
# parallel workers from oversubscribing the cores.
torch.set_num_threads(1)

INV_MAX = np.float32(1.0 / float(0xFFFFFFFF))


def sized_sky(w: int, h: int) -> np.ndarray:
    img = (np.random.default_rng(w * 1000 + h).random((h, w, 3)) ** 4).astype(np.float32)
    img[h // 3: h // 2 + 1, w // 4: w // 2 + 1] = 0.0
    return img


SKIES = {"bench": common.sky_img, "procedural 512x256": lambda: hdr.procedural_sky(512, 256),
         "step-down": step_down_sky,
         **{f"{w}x{h}": (lambda w=w, h=h: sized_sky(w, h))
            for w, h in ((1, 9), (2, 7), (3, 33), (127, 5), (129, 4),
                         (9, 1), (7, 2), (33, 3), (5, 127), (4, 129))}}


def searches(sats: np.ndarray):
    """[(f values [L, n + 1] f32, n, b [L] f32)] for the X searches of
    every table and the Y searches of every column: f as the plain stage
    computes it at every index m in [0, n] (hdri.importance_sample's ps_h,
    ps_v and vol_f), b random with each f value and its neighbours among
    them (none subnormal)."""
    rng = np.random.default_rng(sats.shape[1] * 7 + sats.shape[2])
    _, h, w = sats.shape
    ps_h = np.concatenate([np.zeros((7, 1), np.int64), sats[:, -1, :]], 1)  # [7, w + 1]
    fx = ps_h.astype(np.float32) * INV_MAX
    prev = np.concatenate([np.zeros_like(sats[:, :, :1]), sats[:, :, :-1]], 2)
    col = (sats - prev) & 0xFFFFFFFF                                        # [7, h, w]
    ps_v = np.concatenate([np.zeros((7, 1, w), np.int64), col], 1)           # [7, h + 1, w]
    vol = np.maximum(((ps_h[:, 1:] - ps_h[:, :-1]) & 0xFFFFFFFF).astype(np.float32), 1.0)
    fy = (ps_v.astype(np.float32) / vol[:, None, :]).transpose(0, 2, 1).reshape(7 * w, h + 1)
    out = []
    for f, n in ((fx, w), (fy, h)):
        picks = f[:, rng.integers(0, n + 1, 4)]
        b = np.concatenate([rng.random((f.shape[0], 12)).astype(np.float32), picks,
                            np.nextafter(picks, np.float32(2)),
                            np.nextafter(picks, np.float32(-1))], 1)
        # no subnormal b (the draws are multiples of 2^-23 or 2^-24): XLA on
        # the CPU reads one as zero
        b[np.abs(b) < np.finfo(np.float32).tiny] = 0.0
        lanes = np.repeat(np.arange(f.shape[0]), b.shape[1])
        out.append((f[lanes], n, b.reshape(-1)))
    return out


def both_ways(f: np.ndarray, n: int, b: np.ndarray):
    """(the port's _upper_bound, the JAX package's) on f [L, n + 1] and b
    [L]."""
    ft = torch.from_numpy(f)
    port = hdri._upper_bound(lambda m: ft.gather(1, m[:, None])[:, 0], n,
                             torch.from_numpy(b)).numpy()
    fj = jnp.asarray(f)
    jax = np.asarray(jhdri._upper_bound(
        lambda m: jnp.take_along_axis(fj, m[:, None], 1)[:, 0], n, jnp.asarray(b)))
    return port, jax.astype(np.int64)


@pytest.mark.parametrize("sky", list(SKIES))
def test_bisection_matches_jax_on_sats_tables(sky):
    img = SKIES[sky]()
    env = hdri.load(img, scale=1.0, use_alias=False, device="cpu")
    sats = env.sats.numpy()
    if sky == "bench":
        assert sats_step_downs(sats) == 0
    if sky == "step-down":
        assert sats_step_downs(sats) > 100
    for (f, n, b), what in zip(searches(sats), ("X", "Y")):
        port, jax = both_ways(f, n, b)
        np.testing.assert_array_equal(port, jax, err_msg=f"{sky} {what}")
        assert 0 <= port.min() and port.max() <= n


# Hand-made masked column prefixes that step down by one (as the floors of
# _build_sat_u32 can), in sixteenths of the column's volume.
STEP_DOWN_ROWS = [[0, 2, 5, 5, 4, 4, 4, 6, 9, 8, 12, 12, 11, 16],
                  [0, 1, 1, 0, 1, 3, 3, 2, 2, 7, 9, 9, 8, 16],
                  [0, 8, 8, 8, 7, 7, 7, 7, 6, 9, 16, 15, 15, 16]]


@pytest.mark.parametrize("row", range(len(STEP_DOWN_ROWS)))
def test_bisection_on_a_column_that_steps_down(row):
    f = np.asarray(STEP_DOWN_ROWS[row], np.float32)[None] / np.float32(16)
    n = f.shape[1] - 1
    b = np.unique(np.concatenate([f[0], f[0] + np.float32(1 / 64)])).astype(np.float32)
    fl = np.repeat(f, b.size, 0)
    port, jax = both_ways(fl, n, b)
    np.testing.assert_array_equal(port, jax)
    # the bisection's index is not the first f(i) > b on these rows
    first_above = np.argmax(np.concatenate([fl, np.full((b.size, 1), np.inf)], 1)
                            > b[:, None], 1)
    assert (port != first_above).any()
