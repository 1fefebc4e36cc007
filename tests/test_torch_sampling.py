"""The port's hashing, bit scrambles, PCG32, PMJ sampling and environment
map against the JAX package, on the cases of tests/test_foundations.py and
tests/test_sampling_hdri.py.

Integer-valued functions are exact (hashes, scrambles, PCG32 outputs, the
PMJ points a sample picks, the HDRI tables). Floats: the port evaluates
cos / sin / atan2 in float64 and rounds to float32 (ops/sampling._f64),
while the JAX package uses XLA's float32 approximations and, jitted,
contracts multiply-adds; directions therefore differ by a few ulps (bound:
4 ulps of 1.0 per component, measured 1). Texel picks are exact except
where a coordinate lies within rounding of a texel boundary.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from massivevoxelraytracing_tpu.ops import bits as jbits
from massivevoxelraytracing_tpu.ops import hashing as jhashing
from massivevoxelraytracing_tpu.ops import hdri as jhdri
from massivevoxelraytracing_tpu.ops import rng as jrng
from massivevoxelraytracing_tpu.ops import sampling as jsampling
from massivevoxelraytracing_tpu.utils import hdr
from massivevoxelraytracing_torch.ops import bits, hashing, hdri, rng, sampling

# The tensors here are small: one intra-op thread keeps the test runner's
# parallel workers from oversubscribing the cores.
torch.set_num_threads(1)

RNG = np.random.default_rng(21)
DIR_ATOL = 4 * 2.0 ** -23  # 4 ulps of 1.0


def ru32(n):
    return RNG.integers(0, 1 << 32, size=n, dtype=np.uint64).astype(np.uint32)


def t64(a_u32):
    return torch.from_numpy(np.asarray(a_u32, np.uint32).astype(np.int64))


def as_u32(x):
    return np.asarray(x).astype(np.int64).astype(np.uint32)


EDGE = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE, 0xFFFFFFFF], np.uint32)


def words(n=4000):
    return np.concatenate([EDGE, ru32(n)])


# -- hashing -----------------------------------------------------------------

@pytest.mark.parametrize("n_args", [2, 3, 4])
def test_hash_combine_equals_jax(n_args):
    ks = [words() for _ in range(n_args)]
    got = hashing.hash_combine(*(t64(k) for k in ks))
    want = jhashing.hash_combine(*(jnp.asarray(k) for k in ks))
    np.testing.assert_array_equal(as_u32(got), np.asarray(want))
    # python-int words broadcast like the reference's scalar words
    got = hashing.hash_combine(t64(ks[0]), 31082745)
    want = jhashing.hash_combine(jnp.asarray(ks[0]), jnp.uint32(31082745))
    np.testing.assert_array_equal(as_u32(got), np.asarray(want))


def test_fmix_rotl_equal_jax():
    w = words()
    np.testing.assert_array_equal(as_u32(hashing.fmix32(t64(w))),
                                  np.asarray(jhashing.fmix32(jnp.asarray(w))))
    for r in (1, 13, 15, 31):
        np.testing.assert_array_equal(
            as_u32(hashing.rotl32(t64(w), r)),
            np.asarray(jhashing.rotl32(jnp.asarray(w), r)))


def test_murmur_incremental_vs_canonical():
    for _ in range(200):
        ws = ru32(int(RNG.integers(1, 9)))
        seed = int(ru32(1)[0])
        state = hashing.murmur_init(seed)
        for w in ws:
            state = hashing.murmur_combine(state, int(w))
        got = hashing.murmur_get(state)
        assert got == hashing.np_murmur3_x86_32(ws.tobytes(), seed)
        assert got == jhashing.np_murmur3_x86_32(ws.tobytes(), seed)
    for data in (b"", b"a", b"ab", b"abc", b"abcde", bytes(range(13))):
        assert (hashing.np_murmur3_x86_32(data, 7)
                == jhashing.np_murmur3_x86_32(data, 7))


# -- bits --------------------------------------------------------------------

def test_bit_scrambles_equal_jax():
    x, seed = words(), words()
    tx, ts, jx, js = t64(x), t64(seed), jnp.asarray(x), jnp.asarray(seed)
    for got, want in (
        (bits.reverse_bits(tx), jbits.reverse_bits(jx)),
        (bits.laine_karras_permutation(tx, ts), jbits.laine_karras_permutation(jx, js)),
        (bits.nested_uniform_scramble(tx, ts), jbits.nested_uniform_scramble(jx, js)),
    ):
        np.testing.assert_array_equal(as_u32(got), np.asarray(want))
    np.testing.assert_array_equal(bits.uniformf(tx).numpy(),
                                  np.asarray(jbits.uniformf(jx)))
    f = RNG.random(len(x)).astype(np.float32)
    f[:3] = [0.0, np.nextafter(np.float32(1), np.float32(0)), 0.5]
    got = bits.scramble_f32(torch.from_numpy(f), ts).numpy()
    np.testing.assert_array_equal(got, np.asarray(jbits.scramble_f32(jnp.asarray(f), js)))
    assert np.all((got >= 0) & (got < 1))


def test_reverse_bits_involution():
    x = t64(words())
    np.testing.assert_array_equal(bits.reverse_bits(bits.reverse_bits(x)).numpy(),
                                  x.numpy())
    assert int(bits.reverse_bits(torch.tensor([1]))[0]) == 0x80000000


# -- rng ---------------------------------------------------------------------

@pytest.mark.parametrize("seed,stream", [
    (0, 2525), (1, 0), (123456789, 987654321), (0xFFFFFFFF, 0x7FFFFFFF)])
def test_pcg32_equals_oracles(seed, stream):
    ref = rng.NpPCG32(seed, stream)
    jref = jrng.NpPCG32(seed, stream)
    state, inc = rng.pcg32_init(torch.tensor([seed]), torch.tensor([stream]))
    for _ in range(64):
        state, out = rng.pcg32_next(state, inc)
        want = ref.next_u32()
        assert int(out[0]) == want == jref.next_u32()
    assert ref.uniformf() == jref.uniformf()


def test_pcg32_vectorized_equals_jax():
    seeds, streams = words(2000), words(2000)
    state, inc = rng.pcg32_init(t64(seeds), t64(streams))
    jstate, jinc = jrng.pcg32_init(jnp.asarray(seeds), jnp.asarray(streams))
    for _ in range(4):
        state, out = rng.pcg32_next(state, inc)
        jstate, jout = jrng.pcg32_next(jstate, jinc)
        np.testing.assert_array_equal(as_u32(out), np.asarray(jout))
    # 64-bit seeds as (hi, lo) pairs
    hi, lo = words(2000), words(2000)
    state, inc = rng.pcg32_init((t64(hi), t64(lo)), (t64(lo), t64(hi)))
    jstate, jinc = jrng.pcg32_init((jnp.asarray(hi), jnp.asarray(lo)),
                                   (jnp.asarray(lo), jnp.asarray(hi)))
    _, out = rng.pcg32_next(state, inc)
    _, jout = jrng.pcg32_next(jstate, jinc)
    np.testing.assert_array_equal(as_u32(out), np.asarray(jout))


def test_lcg_shuffler_equals_jax():
    for _ in range(10):
        n = int(RNG.integers(2, 10_000))
        while True:
            params = rng.lcg_try_init(*(int(v) for v in ru32(2)), n)
            if params:
                break
        a, c, nn = params
        assert params == jrng.lcg_try_init(a, c, n)
        i = np.arange(n, dtype=np.uint32)
        got = rng.lcg_shuffle(t64(i), a, c, nn).numpy()
        assert len(np.unique(got)) == n and got.max() < n
        want = np.asarray(jrng.lcg_shuffle(jnp.asarray(i), jnp.uint32(a),
                                           jnp.uint32(c), jnp.uint32(nn)))
        np.testing.assert_array_equal(got, want)


# -- PMJ sampling --------------------------------------------------------------

@pytest.mark.parametrize("shape", [(8, 256), (128, 4096)])
def test_pmj_sample2d_equals_jax(shape):
    table = sampling.make_pmj_table(*shape)
    n = 4096
    idx, stream = RNG.integers(0, 1 << 20, n).astype(np.uint32), words(n - 6)
    for dim in (0, 1, 5, 17):
        x, y = sampling.pmj_sample2d(torch.from_numpy(table), t64(idx), dim, t64(stream))
        jx, jy = jsampling.pmj_sample2d(jnp.asarray(table), jnp.asarray(idx),
                                        jnp.uint32(dim), jnp.asarray(stream))
        np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
        np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
        assert np.all((x.numpy() >= 0) & (x.numpy() < 1))


# -- Lambertian ----------------------------------------------------------------

def unit_normals(n):
    z = RNG.normal(size=(n, 3)).astype(np.float32)
    return z / np.linalg.norm(z, axis=1, keepdims=True)


def test_orthonormal_basis():
    z = unit_normals(1000)
    x, y = (v.numpy() for v in sampling.orthonormal_basis(torch.from_numpy(z)))
    for a, b in [(x, y), (x, z), (y, z)]:
        np.testing.assert_allclose((a * b).sum(1), 0, atol=1e-5)
    np.testing.assert_allclose((x * x).sum(1), 1, atol=1e-5)
    np.testing.assert_allclose(np.cross(x, y), z, atol=1e-5)
    jx, jy = jsampling.orthonormal_basis(jnp.asarray(z))
    np.testing.assert_allclose(x, np.asarray(jx), rtol=0, atol=DIR_ATOL)
    np.testing.assert_allclose(y, np.asarray(jy), rtol=0, atol=DIR_ATOL)


def test_sample_lambertian_within_ulps_of_jax():
    n = 20000
    a, b = (RNG.random(n, dtype=np.float32) for _ in range(2))
    ng = unit_normals(n)
    got = sampling.sample_lambertian(*(torch.from_numpy(v) for v in (a, b, ng))).numpy()
    want = np.asarray(jsampling.sample_lambertian(jnp.asarray(a), jnp.asarray(b),
                                                  jnp.asarray(ng)))
    np.testing.assert_allclose(got, want, rtol=0, atol=DIR_ATOL)


def test_lambertian_cosine_distribution():
    n = 200_000
    a, b = (torch.from_numpy(RNG.random(n, dtype=np.float32)) for _ in range(2))
    ng = torch.tensor([[0.0, 0.0, 1.0]]).expand(n, 3)
    d = sampling.sample_lambertian(a, b, ng).numpy()
    assert np.all(d[:, 2] > -1e-6)
    np.testing.assert_allclose(np.linalg.norm(d, axis=1), 1, atol=1e-4)
    assert abs(d[:, 2].mean() - 2.0 / 3.0) < 3e-3  # E[cos] for pdf cos/pi


def test_luminance():
    rgb = RNG.random((100, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        sampling.luminance(torch.from_numpy(rgb)).numpy(),
        np.asarray(jsampling.luminance(jnp.asarray(rgb))))


# -- HDRI ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def envs():
    img = hdr.procedural_sky(64, 32, sun_intensity=50.0)
    prim = hdr.procedural_sky(128, 64, sun_intensity=50.0)
    return (img, hdri.load(img, prim, scale=1.5, device="cpu"),
            jhdri.load(img, prim, scale=1.5))


def test_load_tables_equal_jax(envs):
    _img, env, jenv = envs
    np.testing.assert_array_equal(env.sats.numpy(), np.asarray(jenv.sats).astype(np.int64))
    for key in ("pixels", "pixels_primary", "alias_prob", "alias_pdf"):
        np.testing.assert_array_equal(getattr(env, key).numpy(),
                                      np.asarray(getattr(jenv, key)))
    np.testing.assert_array_equal(env.alias_idx.numpy(), np.asarray(jenv.alias_idx))
    assert (env.width, env.height, env.width_primary, env.height_primary,
            env.scale) == (jenv.width, jenv.height, jenv.width_primary,
                           jenv.height_primary, jenv.scale)


def near_boundary(x, eps=1e-5):
    return np.abs(x - np.round(x)) < eps


def test_sample_nearest_equals_jax(envs):
    _img, env, jenv = envs
    d = unit_normals(20000)
    for primary in (False, True):
        got = hdri.sample_nearest(env, torch.from_numpy(d), primary).numpy()
        want = np.asarray(jhdri.sample_nearest(jenv, jnp.asarray(d), primary))
        off = np.any(got != want, axis=1)
        u, v = (np.asarray(x) for x in jhdri.get_spherical(jnp.asarray(d)))
        w = env.width_primary if primary else env.width
        h = env.height_primary if primary else env.height
        tie = near_boundary(u * w) | near_boundary(v * h)
        assert not np.any(off & ~tie), int((off & ~tie).sum())


def test_sample_nearest_matches_texel(envs):
    img, env, _jenv = envs
    c = hdri.sample_nearest(env, torch.tensor([[1.0, 0.0, 0.0]]), False).numpy()[0]
    np.testing.assert_allclose(c, img[16, 32] * 1.5, rtol=1e-6)


@pytest.mark.parametrize("use_alias", [True, False])
def test_importance_sample_within_ulps_of_jax(envs, use_alias):
    _img, env, jenv = envs
    env.use_alias = jenv.use_alias = use_alias
    n = 20000
    nrm = unit_normals(n)
    nrm[:600] = np.repeat(np.eye(3, dtype=np.float32), 200, axis=0)
    u = [RNG.random(n, dtype=np.float32) for _ in range(4)]
    d, L, pdf = (x.numpy() for x in hdri.importance_sample(
        env, torch.from_numpy(nrm), *(torch.from_numpy(x) for x in u)))
    jd, jL, jpdf = (np.asarray(x) for x in jhdri.importance_sample(
        jenv, jnp.asarray(nrm), *(jnp.asarray(x) for x in u)))
    # the texel pick (its radiance) is exact except at a boundary tie of
    # the first uniform (alias: u0 * n_texels; SAT: a prefix value)
    off = np.any(L != jL, axis=1)
    assert off.mean() < 1e-3, off.mean()
    same = ~off
    np.testing.assert_allclose(d[same], jd[same], rtol=0, atol=DIR_ATOL)
    np.testing.assert_allclose(pdf[same], jpdf[same], rtol=4 * 2.0 ** -23, atol=0)


@pytest.mark.parametrize("use_alias", [True, False])
def test_importance_sampling_unbiased(use_alias):
    img = hdr.procedural_sky(128, 64, sun_intensity=150.0)
    env = hdri.load(img, scale=1.0, use_alias=use_alias, device="cpu")
    sr = hdri._solid_angle_weights(128, 64)
    direct = (img.astype(np.float64) * sr[..., None]).sum((0, 1))
    n = 100_000
    u = [torch.from_numpy(RNG.random(n, dtype=np.float32)) for _ in range(4)]
    nrm = torch.tensor([[0.0, 1.0, 0.0]]).expand(n, 3)
    d, L, pdf = hdri.importance_sample(env, nrm, *u, axis_aligned=False)
    est = (L.double() / pdf.double()[:, None]).mean(0).numpy()
    np.testing.assert_allclose(est, direct, rtol=0.05)
    np.testing.assert_allclose(np.linalg.norm(d.numpy(), axis=1), 1, atol=1e-4)


def test_axis_tables_prefer_hemisphere():
    env = hdri.load(hdr.procedural_sky(64, 32, sun_intensity=0.0), scale=1.0,
                    device="cpu")
    n = 20000
    u = [torch.from_numpy(RNG.random(n, dtype=np.float32)) for _ in range(4)]
    for sign in (1.0, -1.0):
        nrm = torch.tensor([[0.0, sign, 0.0]]).expand(n, 3)
        d, _, _ = hdri.importance_sample(env, nrm, *u, axis_aligned=True)
        assert float((d[:, 1] * sign > 0).float().mean()) > 0.9


def test_select_table_equals_jax(envs):
    _img, env, jenv = envs
    nrm = unit_normals(5000)
    nrm[:6] = np.concatenate([np.eye(3), -np.eye(3)]).astype(np.float32)
    np.testing.assert_array_equal(
        hdri.select_table(env, torch.from_numpy(nrm), True).numpy(),
        np.asarray(jhdri.select_table(jenv, jnp.asarray(nrm), True)))


def test_get_spherical_within_ulps_of_jax():
    d = unit_normals(20000)
    u, v = (x.numpy() for x in hdri.get_spherical(torch.from_numpy(d)))
    with jax.disable_jit():
        ju, jv = (np.asarray(x) for x in jhdri.get_spherical(jnp.asarray(d)))
    np.testing.assert_allclose(u, ju, rtol=0, atol=DIR_ATOL)
    np.testing.assert_allclose(v, jv, rtol=0, atol=DIR_ATOL)
