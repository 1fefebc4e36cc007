"""The path tracer's sample chain in stages (ops/pt_chain.py): each plain
stage held bit for bit against the same composition of the JAX package's
functions, op by op (jax.disable_jit()), on random lanes with the edge
lanes in them and on the inputs a PT step gives the stages (a 64^3 scene,
16,384 lanes, so the compaction and the depth-0 implicit ray run); and on
the CPU pt_sample runs the plain stages (no kernel launches).

Transcendentals. The port evaluates cos / sin / atan2 in float64 and
rounds to float32 (ops/sampling._f64); XLA's float32 versions are not
correctly rounded (on 200,000 random angles jnp.cos differs from the
rounded float64 value on ~1.3% of them, jnp.arctan2 on ~16%, by an ulp).
So the JAX compositions here run with jnp.cos / sin / arctan2 replaced,
inside the JAX package's hdri and sampling modules only, by the same
rounded float64 values (`f64_transcendentals`); every other operation is
the JAX package's own, and every output is compared bit for bit. Next to
those, the stages that evaluate a transcendental run against the JAX
package's functions as they are (`*_near_unpatched_jax`): an output that
goes through cos / sin / atan2 is held to TRIG_ULPS, every other output
bit for bit, and the lanes that differ are counted and reported (the
test's `lanes_differing` property; on these inputs 1.4-2.3% of the
random lanes and 10% of the edge draws, by at most 2 ulp, all in the
cosine and NEE directions).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from massivevoxelraytracing_tpu.ops import bits as jbits
from massivevoxelraytracing_tpu.ops import hashing as jhashing
from massivevoxelraytracing_tpu.ops import hdri as jhdri
from massivevoxelraytracing_tpu.ops import rng as jrng
from massivevoxelraytracing_tpu.ops import sampling as jsampling
from massivevoxelraytracing_tpu.ops import traverse as jtraverse
from massivevoxelraytracing_tpu.ops import voxelize as jvox
from massivevoxelraytracing_tpu.utils import hdr
from massivevoxelraytracing_torch.models import pathtracer, scene
from massivevoxelraytracing_torch.ops import hako_mega, hdri, pt_chain, sampling

from test_torch_cuda import CHAIN_STAGES, chain_case, ico_scene

# The tensors here are small: one intra-op thread keeps the test runner's
# parallel workers from oversubscribing the cores.
torch.set_num_threads(1)

U32 = jnp.uint32
R = 4096
TRIG_ULPS = 2  # outputs through XLA's float32 cos / sin / atan2, unpatched


class _F64Jnp:
    """jax.numpy with cos / sin / arctan2 rounded from float64 (module
    docstring); every other name is jax.numpy's."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def _f64(fn, *xs):
        return jnp.asarray(fn(*(np.asarray(x, np.float64) for x in xs)).astype(np.float32))

    def cos(self, x):
        return self._f64(np.cos, x)

    def sin(self, x):
        return self._f64(np.sin, x)

    def arctan2(self, y, x):
        return self._f64(np.arctan2, y, x)


@pytest.fixture
def f64_transcendentals(monkeypatch):
    for mod in (jhdri, jsampling):
        monkeypatch.setattr(mod, "jnp", _F64Jnp())


@functools.lru_cache(maxsize=None)
def pmj_table():
    """test_torch_pathtracer.py's 16x512 PMJ table."""
    return jsampling.make_pmj_table(16, 512)


@functools.lru_cache(maxsize=None)
def sky():
    return hdr.procedural_sky(32, 16)


def envs(use_alias=True):
    return (jhdri.load(sky(), scale=1.0, use_alias=use_alias),
            hdri.load(sky(), scale=1.0, use_alias=use_alias, device="cpu"))


def np_of(x):
    return None if x is None else np.asarray(x)


def assert_bits(got, want, what: str) -> None:
    """Port output (torch) == JAX output bit for bit: floats as their
    bits; u32 values held in int64 against uint32; bools and ints
    exactly."""
    if want is None:
        assert got is None, what
        return
    g = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    w = np.asarray(want)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    if w.dtype == np.float32:
        assert g.dtype == np.float32, what
        g, w = g.view(np.uint32), w.view(np.uint32)
    else:
        g, w = g.astype(np.int64), w.astype(np.int64)
    bad = g != w
    assert not bad.any(), f"{what}: {int(bad.sum())} of {bad.size} values differ"


def _ordered(a: np.ndarray) -> np.ndarray:
    """float32 bits as integers in the floats' order (ulp distances)."""
    i = a.view(np.int32).astype(np.int64)
    return np.where(i < 0, -(i & 0x7FFFFFFF), i)


def assert_near(got, want, what: str, ulps: int) -> int:
    """Port output (torch) within `ulps` of the JAX output, float32 values
    compared in ulps (exactly for ulps=0, as assert_bits does); returns
    the lanes (rows) that differ at all."""
    g = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    w = np.asarray(want)
    assert g.shape == w.shape and g.dtype == w.dtype == np.float32, what
    d = np.abs(_ordered(g) - _ordered(w)).reshape(len(g), -1).max(axis=1)
    assert int(d.max(initial=0)) <= ulps, f"{what}: max {int(d.max())} ulp over {ulps}"
    return int((d > 0).sum())


def pcg64(pair):
    """A JAX (hi, lo) u64 -> int64 bits, as the port holds them."""
    hi, lo = (np.asarray(v).astype(np.uint64) for v in pair)
    return ((hi << np.uint64(32)) | lo).view(np.int64)


def make_s2d(pmj, stream, spp, pcg, dim):
    """The reference's s2d closure from dimension `dim` on: returns (s2d,
    state) where state[0] is the PCG32 (state, inc) or None."""
    box = [dim, pcg]

    def s2d():
        if box[1] is None:
            d = box[0]
            box[0] += 1
            return jsampling.pmj_sample2d(pmj, spp, jbits.u32(d), stream)
        state, inc = box[1]
        state, a = jrng.pcg32_next(state, inc)
        state, b = jrng.pcg32_next(state, inc)
        box[1] = (state, inc)
        return jbits.uniformf(a), jbits.uniformf(b)

    return s2d, box


# ---------------------------------------------------------------------------
# the stages as compositions of the JAX package's functions (the reference's
# pt_sample, models/pathtracer.py:160-341, cut at the same places)
# ---------------------------------------------------------------------------

def jax_lane_init(pmj, pix_perm, cam, pix_start, spp_base, *, width, pix_packet,
                  n_spp, spp_major, use_pmj):
    cam_o, cam_right, cam_up, cam_front, tan_half_fovy, lens_r, focus, inv_w, inv_h, \
        aspect = cam
    lane = jnp.arange(pix_packet * n_spp, dtype=U32)
    if spp_major:
        pix_off, spp_off = lane // U32(n_spp), lane % U32(n_spp)
    else:
        pix_off, spp_off = lane % U32(pix_packet), lane // U32(pix_packet)
    pix_idx = jbits.u32(pix_start) + pix_off
    if pix_perm is not None:
        pix_idx = jnp.take(pix_perm, pix_idx, mode="clip")
    px = pix_idx % U32(width)
    py = pix_idx // U32(width)
    stream = jhashing.hash_combine(U32(0), pix_idx)
    spp = jbits.u32(spp_base) + spp_off
    pcg = None if use_pmj else jrng.pcg32_init(jhashing.hash_combine(stream, spp), stream)
    s2d, box = make_s2d(pmj, stream, spp, pcg, 0)
    cu0, cu1 = s2d()
    lu0, lu1 = s2d()
    xf = (px.astype(jnp.float32) + cu0) * inv_w
    yf = (py.astype(jnp.float32) + cu1) * inv_h
    fx = focus * (-tan_half_fovy + 2.0 * tan_half_fovy * xf) * aspect
    fy = focus * (tan_half_fovy - 2.0 * tan_half_fovy * yf)
    lx = -lens_r + 2.0 * lens_r * lu0
    ly = -lens_r + 2.0 * lens_r * lu1
    rd = (fx - lx)[:, None] * cam_right + (fy - ly)[:, None] * cam_up + focus * cam_front
    ro = cam_o + lx[:, None] * cam_right + ly[:, None] * cam_up
    return stream, spp, box[1], ro, rd


def jax_primary_shade(env, emission, rd, t, vidx, *, hdri_on):
    n = t.shape[0]
    L = jnp.zeros((n, 3), jnp.float32)
    miss = t >= 1e37
    if hdri_on:
        L = jnp.where(miss[:, None], jhdri.sample_nearest(env, rd, primary=True), L)
    le = jvox.rgb8_to_f32(jnp.take(emission, vidx.astype(jnp.int32), mode="clip"))
    return jnp.ones((n, 3), jnp.float32), jnp.where(miss[:, None], L, le), miss


def jax_bounce_sample(env, color, pmj, vidx, nmaj, ro, rd, t, miss, stream, spp, pcg, *,
                      dim, hdri_on, extra):
    s2d, box = make_s2d(pmj, stream, spp, pcg, dim)
    alive = ~miss
    refl = jvox.rgb8_to_f32(jnp.take(color, vidx.astype(jnp.int32), mode="clip"))
    hit_n = jtraverse.hit_normal(nmaj, rd)
    hit_p = jnp.where(alive[:, None], ro + rd * jnp.where(miss, 0.0, t)[:, None], 1e9)
    dir_s = emissive = pdf = dir_e = None
    if hdri_on:
        u01 = s2d()
        u23 = s2d()
        dir_s, emissive, pdf = jhdri.importance_sample(
            env, hit_n, u01[0], u01[1], u23[0], u23[1], axis_aligned=True)
    if extra:
        eu = s2d()
        dir_e = jsampling.sample_lambertian(eu[0], eu[1], hit_n)
    bu = s2d()
    dir_b = jsampling.sample_lambertian(bu[0], bu[1], hit_n)
    ro_b = jnp.where(alive[:, None], hit_p, 1e9)
    assert np.array_equal(np.asarray(ro_b), np.asarray(hit_p))  # the BSDF origin is hit_p
    rd = jnp.where(alive[:, None], dir_b, rd)
    return refl, hit_n, hit_p, rd, dir_e, dir_s, emissive, pdf, box[1]


def jax_bounce_shade(emission, emission_scale, T, L, refl, hit_n, dir_s, emissive, pdf,
                     miss, nmaj, vidx, rd, t_s, t_e, v_e, t_b, nm_b, vi_b, *, n_extra,
                     depth, key):
    alive = ~miss
    if dir_s is not None:
        vis = alive & (t_s >= 1e37)
        cosw = jnp.maximum(jnp.sum(hit_n * dir_s, axis=-1), 0.0)
        contrib = T * (refl / jnp.pi) * (cosw / pdf)[:, None] * emissive
        L = jnp.where(vis[:, None], L + contrib, L)
    T = jnp.where(alive[:, None], T * refl, T)
    if t_e is not None:
        le_e = jvox.rgb8_to_f32(jnp.take(emission, v_e.astype(jnp.int32),
                                         mode="clip")) * emission_scale
        pick = alive & (t_e < 1e37)
        L = jnp.where(pick[:, None], L + T * le_e / float(1 + n_extra), L)
    new_hit = alive & (t_b < 1e37)
    le_b = jvox.rgb8_to_f32(jnp.take(emission, vi_b.astype(jnp.int32),
                                     mode="clip")) * emission_scale
    w_depth0 = 1.0 / float(1 + n_extra) if depth == 0 else 1.0
    L = jnp.where(new_hit[:, None], L + T * le_b * w_depth0, L)
    nmaj = jnp.where(new_hit, nm_b, nmaj)
    vidx = jnp.where(new_hit, vi_b, vidx)
    k = None
    if key:  # the next bounce's sort keys (pathtracer.py:256-261)
        octant = ((rd[:, 0] < 0).astype(U32) + 2 * (rd[:, 1] < 0).astype(U32)
                  + 4 * (rd[:, 2] < 0).astype(U32))
        k = (jnp.where(new_hit, octant, U32(8)), vidx)
    return T, L, t_b, nmaj, vidx, ~new_hit, k


def jax_compact(key, vidx, stream, spp, orig, nmaj, t, ro, rd, T, L):
    """The reference's one multi-operand sort on (key, vidx)
    (pathtracer.py:268-289), stable."""
    def bits(x):
        return jax.lax.bitcast_convert_type(x, U32)

    def f32(x):
        return jax.lax.bitcast_convert_type(x, jnp.float32)

    cols = [bits(a[:, k]) for a in (ro, rd, T, L) for k in range(3)]
    out = jax.lax.sort((key, vidx, stream, spp, orig, jbits.u32(nmaj + 1), bits(t), *cols),
                       num_keys=2, is_stable=True)
    vidx, stream, spp, orig, nmaj1, tb = out[1:7]
    v3 = [jnp.stack([f32(c) for c in out[7 + 3 * i: 10 + 3 * i]], axis=1) for i in range(4)]
    t = f32(tb)
    return (vidx, stream, spp, orig, nmaj1.astype(jnp.int32) - 1, t, *v3, t >= 1e37)


# ---------------------------------------------------------------------------
# random lanes, edge lanes among them
# ---------------------------------------------------------------------------

def tensors(c):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in c.items()}


def cams():
    from massivevoxelraytracing_torch.ops import camera

    cam = camera.Camera.look_at(eye=(0.9, 0.7, 2.1), target=(0.5, 0.45, 0.5),
                                fovy_deg=40.0, lens_r=0.03, focus=1.7)
    vals = [np.asarray(v, np.float32) for v in (cam.o, cam.right, cam.up, cam.front)]
    vals += [np.float32(v) for v in (cam.tan_half_fovy, cam.lens_r, cam.focus, 1.0 / 37,
                                     1.0 / 23, 37 / 23)]
    return (tuple(torch.from_numpy(np.asarray(v)) for v in vals),
            tuple(jnp.asarray(v) for v in vals))


@pytest.mark.parametrize("spp_major", [True, False])
@pytest.mark.parametrize("use_pmj", [True, False])
@pytest.mark.parametrize("perm", [True, False])
def test_lane_init_equals_jax(spp_major, use_pmj, perm):
    """Both lane layouts, PMJ and PCG32, a pix_perm with padding sentinels
    past the frame and positions past its end (clipped), pix_start and
    spp_base wrapping past 2^32."""
    pix_packet, n_spp, width = 1024, 4, 37
    p = None
    if perm:
        p = np.concatenate([np.random.default_rng(40).permutation(pix_packet - 64),
                            np.full(32, 5000)])
    t_cam, j_cam = cams()
    kw = dict(width=width, pix_packet=pix_packet, n_spp=n_spp, spp_major=spp_major,
              use_pmj=use_pmj)
    start, base = (1 << 32) - 700, (1 << 32) - 2
    got = pt_chain.lane_init_plain(torch.from_numpy(pmj_table()),
                                   None if p is None else torch.from_numpy(p), t_cam,
                                   start, base, **kw)
    with jax.disable_jit():
        want = jax_lane_init(jnp.asarray(pmj_table()),
                             None if p is None else jnp.asarray(p, U32), j_cam, start, base,
                             **kw)
    for i in (0, 1, 3, 4):
        assert_bits(got[i], want[i], f"lane_init output {i}")
    if use_pmj:
        assert got[2] is None and want[2] is None
    else:
        for g, w in zip(got[2], want[2]):
            assert_bits(g, pcg64(w), "PCG32 state")


@pytest.mark.parametrize("hdri_on", [True, False])
def test_primary_shade_equals_jax(f64_transcendentals, hdri_on):
    c = chain_case(np.random.default_rng(41), R)
    x = tensors(c)
    jenv, env = envs()
    got = pt_chain.primary_shade_plain(env, x["emission"], x["rd"], x["t"], x["vidx"],
                                       hdri=hdri_on)
    with jax.disable_jit():
        want = jax_primary_shade(jenv, jnp.asarray(c["emission"]), jnp.asarray(c["rd"]),
                                 jnp.asarray(c["t"]), jnp.asarray(c["vidx"]), hdri_on=hdri_on)
    for i, name in enumerate(("T", "L", "miss")):
        assert_bits(got[i], want[i], name)


def jax_sample_args(c, jenv, use_pmj):
    pcg = None
    if not use_pmj:
        pcg = tuple((jnp.asarray((v.view(np.uint64) >> np.uint64(32)).astype(np.uint32)),
                     jnp.asarray(v.astype(np.uint32))) for v in (c["pcg_state"], c["pcg_inc"]))
    return (jenv, jnp.asarray(c["color"]), jnp.asarray(pmj_table()), jnp.asarray(c["vidx"]),
            jnp.asarray(c["nmaj"]), jnp.asarray(c["ro"]), jnp.asarray(c["rd"]),
            jnp.asarray(c["t"]), jnp.asarray(c["miss"]), jnp.asarray(c["stream"], U32),
            jnp.asarray(c["spp"], U32), pcg)


def check_sample(got, want, pcg_on):
    names = ("refl", "hit_n", "hit_p", "rd", "dir_e", "dir_s", "emissive", "pdf")
    for i, name in enumerate(names):
        assert_bits(got[i], np_of(want[i]), name)
    if pcg_on:
        assert_bits(got[8][0], pcg64(want[8][0]), "PCG32 state")
    else:
        assert got[8] is None


@pytest.mark.parametrize("hdri_on", [True, False])
@pytest.mark.parametrize("extra", [True, False])
@pytest.mark.parametrize("use_pmj", [True, False])
def test_bounce_sample_equals_jax(f64_transcendentals, hdri_on, extra, use_pmj):
    """Dead lanes (a quarter: hit point parked at 1e9, direction kept),
    voxel indices past the tables, both sample streams."""
    c = chain_case(np.random.default_rng(42), R)
    x = tensors(c)
    jenv, env = envs()
    pcg = None if use_pmj else (x["pcg_state"], x["pcg_inc"])
    got = pt_chain.bounce_sample_plain(
        env, x["color"], torch.from_numpy(pmj_table()), x["vidx"], x["nmaj"], x["ro"],
        x["rd"], x["t"], x["miss"], x["stream"], x["spp"], pcg, dim=3, hdri=hdri_on,
        extra=extra)
    assert bool((got[2][x["miss"]] == 1e9).all())
    with jax.disable_jit():
        want = jax_bounce_sample(*jax_sample_args(c, jenv, use_pmj), dim=3,
                                 hdri_on=hdri_on, extra=extra)
    check_sample(got, want, not use_pmj)


def test_primary_shade_near_unpatched_jax(record_property):
    """The primary HDRI lookup against the JAX package's own arctan2: the
    texel (and so L) may move only as far as TRIG_ULPS allows."""
    c = chain_case(np.random.default_rng(41), R)
    x = tensors(c)
    jenv, env = envs()
    got = pt_chain.primary_shade_plain(env, x["emission"], x["rd"], x["t"], x["vidx"],
                                       hdri=True)
    with jax.disable_jit():
        want = jax_primary_shade(jenv, jnp.asarray(c["emission"]), jnp.asarray(c["rd"]),
                                 jnp.asarray(c["t"]), jnp.asarray(c["vidx"]), hdri_on=True)
    assert_bits(got[0], want[0], "T")
    assert_bits(got[2], want[2], "miss")
    n = assert_near(got[1], want[1], "L", TRIG_ULPS)
    record_property("lanes_differing", {"L": n})
    print(f"primary shade against unpatched JAX: L differs on {n} of {R} lanes")


@pytest.mark.parametrize("extra", [True, False])
@pytest.mark.parametrize("use_pmj", [True, False])
def test_bounce_sample_near_unpatched_jax(record_property, extra, use_pmj):
    """The bounce sample against the JAX package's own cos / sin: the
    directions (BSDF, implicit, NEE) and the NEE pdf within TRIG_ULPS;
    albedo, normal, hit point, radiance and the PCG32 state bit for bit."""
    c = chain_case(np.random.default_rng(42), R)
    x = tensors(c)
    jenv, env = envs()
    pcg = None if use_pmj else (x["pcg_state"], x["pcg_inc"])
    got = pt_chain.bounce_sample_plain(
        env, x["color"], torch.from_numpy(pmj_table()), x["vidx"], x["nmaj"], x["ro"],
        x["rd"], x["t"], x["miss"], x["stream"], x["spp"], pcg, dim=3, hdri=True,
        extra=extra)
    with jax.disable_jit():
        want = jax_bounce_sample(*jax_sample_args(c, jenv, use_pmj), dim=3, hdri_on=True,
                                 extra=extra)
    differ = {}
    for i, name in enumerate(("refl", "hit_n", "hit_p", "rd", "dir_e", "dir_s", "emissive",
                              "pdf")):
        if name in ("rd", "dir_e", "dir_s", "pdf") and want[i] is not None:
            differ[name] = assert_near(got[i], want[i], name, TRIG_ULPS)
        else:
            assert_bits(got[i], np_of(want[i]), name)
    if not use_pmj:
        assert_bits(got[8][0], pcg64(want[8][0]), "PCG32 state")
    record_property("lanes_differing", differ)
    print(f"bounce sample against unpatched JAX, lanes differing of {R}: {differ}")


@pytest.mark.parametrize("hdri_on", [True, False])
@pytest.mark.parametrize("extra", [True, False])
@pytest.mark.parametrize("key", [True, False])
def test_bounce_shade_equals_jax(hdri_on, extra, key):
    c = chain_case(np.random.default_rng(43), R)
    x = tensors(c)
    es = np.float32(7.5)
    nee = ("hit_n", "dir_s", "emissive", "pdf")
    tail = ("miss", "nmaj", "vidx", "rd")
    n_extra = int(extra)
    got = pt_chain.bounce_shade_plain(
        x["emission"], torch.tensor(es), x["T"], x["L"], x["refl"],
        *(x[k] if hdri_on else None for k in nee), *(x[k] for k in tail),
        x["t_s"] if hdri_on else None, x["t_e"] if extra else None,
        x["v_e"] if extra else None, x["t_b"], x["nm_b"], x["vi_b"],
        inv_extra=float(1 + n_extra), w_depth0=1.0 / (1 + n_extra), key=key)
    j = {k: jnp.asarray(v) for k, v in c.items()}
    with jax.disable_jit():
        want = jax_bounce_shade(
            j["emission"], jnp.float32(es), j["T"], j["L"], j["refl"],
            *(j[k] if hdri_on else None for k in nee), *(j[k] for k in tail),
            j["t_s"] if hdri_on else None, j["t_e"] if extra else None,
            j["v_e"] if extra else None, j["t_b"], j["nm_b"], j["vi_b"], n_extra=n_extra,
            depth=0, key=key)
    for i, name in enumerate(("T", "L", "t", "nmaj", "vidx", "miss")):
        assert_bits(got[i], want[i], name)
    if key:
        k = got[6].numpy()
        assert_bits(torch.from_numpy(k >> 32), want[6][0], "key: octant")
        assert_bits(torch.from_numpy(k & 0xFFFFFFFF), np.asarray(want[6][1]).view(np.uint32),
                    "key: voxel")
    else:
        assert got[6] is None


def test_compact_gather_equals_jax():
    """The compaction key (bounce_shade_plain) sorted by torch.sort and
    gathered == the reference's multi-operand sort on (octant, voxel):
    both sorts are stable (and every lane's voxel is distinct here)."""
    c = chain_case(np.random.default_rng(44), R)
    c["vidx"] = np.random.default_rng(45).permutation(R).astype(np.int32)
    x = tensors(c)
    new_hit = ~x["miss"]
    octant = ((x["rd"][:, 0] < 0).long() + 2 * (x["rd"][:, 1] < 0).long()
              + 4 * (x["rd"][:, 2] < 0).long())
    key = (torch.where(new_hit, octant, 8) << 32) | (x["vidx"].long() & 0xFFFFFFFF)
    lanes = [x[k] for k in ("vidx", "stream", "spp", "orig", "nmaj", "t", "ro", "rd", "T",
                            "L")]
    got = pt_chain.compact_gather_plain(torch.sort(key, stable=True).indices, *lanes)
    j = [jnp.asarray(c[k], U32 if k in ("stream", "spp", "orig") else None)
         for k in ("vidx", "stream", "spp", "orig", "nmaj", "t", "ro", "rd", "T", "L")]
    with jax.disable_jit():
        jkey = jnp.where(jnp.asarray(c["miss"]), U32(8), jnp.asarray(octant.numpy(), U32))
        want = jax_compact(jkey, *j)
    for i, name in enumerate(("vidx", "stream", "spp", "orig", "nmaj", "t", "ro", "rd", "T",
                              "L", "miss")):
        assert_bits(got[i], want[i], name)


def edge_nee_inputs():
    """Normals at exactly +-0.8 on each axis and one float32 step either
    side of it (select_table compares with float32(0.8)), and every
    combination of u at 0, just under 1 and 0.5: (n, [u0, u1, u2, u3])."""
    k = np.float32(0.8)
    vals = [k, np.nextafter(k, np.float32(1)), np.nextafter(k, np.float32(0))]
    normals = []
    for axis in range(3):
        for v in vals:
            for s in (1, -1):
                n = np.zeros(3, np.float32)
                n[axis] = s * v
                n[(axis + 1) % 3] = np.float32(0.6)
                normals.append(n)
    normals = np.asarray(normals, np.float32)
    us = np.asarray([0.0, np.nextafter(np.float32(1), np.float32(0)), 0.5], np.float32)
    grid = np.stack(np.meshgrid(np.arange(len(normals)), *([np.arange(3)] * 4),
                                indexing="ij"), -1).reshape(-1, 5)
    return normals[grid[:, 0]], [us[grid[:, i]] for i in range(1, 5)]


def test_nee_sample_edge_normals_and_uniforms_equal_jax(f64_transcendentals):
    """The bounce sample's NEE draw at the table thresholds (edge_nee_inputs)
    and the cosine directions at those u."""
    n, u = edge_nee_inputs()
    jenv, env = envs()
    got = hdri.importance_sample(env, torch.from_numpy(n), *(torch.from_numpy(v) for v in u))
    lam = sampling.sample_lambertian(*(torch.from_numpy(v) for v in (u[0], u[1], n)))
    with jax.disable_jit():
        want = jhdri.importance_sample(jenv, jnp.asarray(n), *(jnp.asarray(v) for v in u))
        jlam = jsampling.sample_lambertian(jnp.asarray(u[0]), jnp.asarray(u[1]), jnp.asarray(n))
        tables = jhdri.select_table(jenv, jnp.asarray(n), True)
    assert len(np.unique(np.asarray(tables))) == 7  # every table is picked
    for i, name in enumerate(("direction", "radiance", "pdf")):
        assert_bits(got[i], want[i], f"importance_sample {name}")
    assert_bits(lam, jlam, "sample_lambertian")


def test_nee_sample_edge_normals_near_unpatched_jax(record_property):
    """The same edge draws against the JAX package's own cos / sin: the
    table pick and the radiance bit for bit, the directions and the pdf
    within TRIG_ULPS."""
    n, u = edge_nee_inputs()
    jenv, env = envs()
    got = hdri.importance_sample(env, torch.from_numpy(n), *(torch.from_numpy(v) for v in u))
    lam = sampling.sample_lambertian(*(torch.from_numpy(v) for v in (u[0], u[1], n)))
    with jax.disable_jit():
        want = jhdri.importance_sample(jenv, jnp.asarray(n), *(jnp.asarray(v) for v in u))
        jlam = jsampling.sample_lambertian(jnp.asarray(u[0]), jnp.asarray(u[1]), jnp.asarray(n))
    assert_bits(got[1], want[1], "importance_sample radiance")
    differ = {"direction": assert_near(got[0], want[0], "direction", TRIG_ULPS),
              "pdf": assert_near(got[2], want[2], "pdf", TRIG_ULPS),
              "sample_lambertian": assert_near(lam, jlam, "sample_lambertian", TRIG_ULPS)}
    record_property("lanes_differing", differ)
    print(f"edge NEE draws against unpatched JAX, lanes differing of {len(n)}: {differ}")


# ---------------------------------------------------------------------------
# the stages on the inputs a PT step gives them
# ---------------------------------------------------------------------------

def test_stages_on_a_steps_inputs_equal_jax(f64_transcendentals, monkeypatch):
    """One 16-spp step of a 32x32 frame on the 64^3 icosphere with
    emissive voxels and a sky, 3 bounces, on the CPU: every stage call's
    outputs == the JAX composition's on the same inputs."""
    tri, col, emi, kw, cam = ico_scene(64)
    tree = scene.build_scene(tri, col, emi, device="cpu", **kw)
    assert tree.has_emission
    jenv, env = envs()
    pt = pathtracer.PathTracer(width=32, height=32, max_bounces=3, device="cpu")
    pt.pmj_table = torch.from_numpy(pmj_table())
    pt.setup()
    pt.env = env
    pt.update_scene(tree)
    calls = []
    for name in CHAIN_STAGES:
        def rec(*a, _real=getattr(pt_chain, name), _name=name, **k):
            out = _real(*a, **k)
            calls.append((_name, a, k, out))
            return out
        monkeypatch.setattr(pt_chain, name, rec)
    pt.step(cam)
    names = [c[0] for c in calls]
    assert names == ["lane_init", "primary_shade", "bounce_sample", "bounce_shade",
                     "compact_gather", "bounce_sample", "bounce_shade", "compact_gather",
                     "bounce_sample", "bounce_shade"]
    pmj = jnp.asarray(pmj_table())
    keys = None
    with jax.disable_jit():
        for i, (name, a, k, got) in enumerate(calls):
            ja = [None if v is None else jnp.asarray(v.numpy())
                  if isinstance(v, torch.Tensor) else v for v in a]
            if name == "lane_init":
                assert k["use_pmj"] and k["spp_major"] and a[1] is not None
                want = jax_lane_init(pmj, jnp.asarray(a[1].numpy(), U32),
                                     tuple(jnp.asarray(v.numpy()) for v in a[2]), a[3],
                                     a[4], **k)
            elif name == "primary_shade":
                want = jax_primary_shade(jenv, *ja[1:], hdri_on=k["hdri"])
            elif name == "bounce_sample":
                want = jax_bounce_sample(
                    jenv, ja[1], pmj, *ja[3:9], *(jnp.asarray(v.numpy(), U32) for v in a[9:11]),
                    None, dim=k["dim"], hdri_on=k["hdri"], extra=k["extra"])
            elif name == "bounce_shade":
                want = jax_bounce_shade(*ja, n_extra=int(k["inv_extra"]) - 1,
                                        depth=0 if k["w_depth0"] != 1.0 else 1, key=k["key"])
                assert k["key"] == (i < 8)
                keys = want[6]
                got, want = got[:6], want[:6]
            else:  # the previous shade's keys through the reference's sort
                lanes = [jnp.asarray(v.numpy(), U32 if j in (1, 2, 3) else None)
                         for j, v in enumerate(a[1:])]
                assert np.array_equal(np.asarray(keys[1]), a[1].numpy())
                want = jax_compact(keys[0], *lanes)
            for j, (g, w) in enumerate(zip(got, want)):
                if name == "lane_init" and j == 2:
                    assert g is None and w is None
                    continue
                assert_bits(g, np_of(w), f"call {i} ({name}) output {j}")


def test_chain_bytes_count_what_each_kernel_moves(monkeypatch):
    """scripts/common.chain_bytes on every stage call of a CPU step: the
    compaction gather moves every lane's state once each way (177 bytes
    a lane); every other stage moves its outputs at least, and less than
    all of its lane tensors and tables read whole and its outputs
    (pass-through outputs, lanes that skip a read and untouched table
    entries are not counted)."""
    from massivevoxelraytracing_torch.scripts import common

    tri, col, emi, kw, cam = ico_scene(64)
    tree = scene.build_scene(tri, col, emi, device="cpu", **kw)
    pt = pathtracer.PathTracer(width=32, height=32, max_bounces=2, device="cpu")
    pt.pmj_table = torch.from_numpy(pmj_table())
    pt.setup()
    pt.load_hdri(sky(), scale=1.0)
    pt.update_scene(tree)
    calls = []
    for name in CHAIN_STAGES:
        def rec(*a, _real=getattr(pt_chain, name), _name=name, **k):
            out = _real(*a, **k)
            calls.append((_name, a, k, out))
            return out
        monkeypatch.setattr(pt_chain, name, rec)
    pt.step(cam)
    assert {c[0] for c in calls} == set(CHAIN_STAGES)
    for name, a, k, out in calls:
        b = common.chain_bytes(name, a, k, out)
        outs = common.flat_tensors(out)
        n = outs[0].shape[0]
        env = a[0] if name in ("primary_shade", "bounce_sample") else None
        tables = [] if env is None else [env.pixels_primary, env.alias_prob, env.alias_idx,
                                         env.alias_pdf, env.pixels]
        whole = sum(common.nbytes(x) for x in common.flat_tensors(a) + outs + tables)
        if name == "compact_gather":
            assert b == 177 * n
        else:
            assert sum(common.nbytes(x) for x in outs) <= b < whole, name
    shade = next(c for c in calls if c[0] == "bounce_shade")
    t_b = shade[3][2]  # passed through: read on live lanes only, never written
    assert t_b is shade[1][16]
    with pytest.raises(ValueError, match="alias"):
        sats_env = dataclasses.replace(pt.env, use_alias=False)
        c = next(c for c in calls if c[0] == "bounce_sample")
        common.chain_bytes("bounce_sample", (sats_env, *c[1][1:]), c[2], c[3])


def test_cpu_pt_sample_runs_the_plain_stages():
    """On the CPU pt_sample takes the plain stages: no kernel launches,
    and hako_mega's plain version serves the traversals."""
    tri, col, emi, kw, cam = ico_scene(32)
    tree = scene.build_scene(tri, col, emi, device="cpu", **kw)
    pt = pathtracer.PathTracer(width=16, height=16, max_bounces=2, device="cpu")
    pt.pmj_table = torch.from_numpy(pmj_table())
    pt.setup()
    pt.load_hdri(sky(), scale=1.0)
    pt.update_scene(tree)
    pt_chain.reset_counters()
    hako_mega.reset_counters()
    pt.step(cam, n_spp=2)
    assert not any(pt_chain.LAUNCHES.values())
    assert hako_mega.LAUNCHES == 0
    assert bool(torch.isfinite(pt.accum).all()) and float(pt.accum[:, :3].sum()) > 0
    assert pt_chain.stages(None) is pt_chain and pt_chain.stages("plain") is pt_chain.PLAIN
    with pytest.raises(ValueError):
        pt_chain.stages("kernels")
