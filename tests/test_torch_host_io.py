"""The port's host I/O and procedural scenes against the JAX package, on
the same seeded inputs: PNG bytes (the JAX package's Python encoder and
its native one where that builds), the Radiance HDR decode of files the
JAX writer made (flat) and of RLE files, the procedural sky, OBJ / PLY
parsing, the voxel PLY writer, .npz frames, the Ogawa container and the
Alembic reader and fixture writer, and the extra procedural meshes; all
exact. The host C++ readers (csrc/host_io.cpp) equal their plain
versions."""

import struct

import numpy as np
import pytest
import torch

from massivevoxelraytracing_tpu.utils import abcio as jabcio
from massivevoxelraytracing_tpu.utils import hdr as jhdr
from massivevoxelraytracing_tpu.utils import meshgen as jmeshgen
from massivevoxelraytracing_tpu.utils import native as jnative
from massivevoxelraytracing_tpu.utils import objio as jobjio
from massivevoxelraytracing_tpu.utils import ogawa as jogawa
from massivevoxelraytracing_tpu.utils import png as jpng
from massivevoxelraytracing_torch.utils import abcio, hdr, meshgen, objio, ogawa, png

# The tensors here are small: one intra-op thread keeps the test runner's
# parallel workers from oversubscribing the cores.
torch.set_num_threads(1)

RNG = np.random.default_rng(41)


@pytest.mark.parametrize("channels", [3, 4])
@pytest.mark.parametrize("level", [0, 1, 6])
def test_png_bytes_equal_jax(channels, level, tmp_path):
    img = RNG.integers(0, 256, size=(37, 53, channels), dtype=np.uint8)
    img[10:20] = 7  # a run, so the levels compress differently
    data = png.encode(img, level)
    assert data == jpng.encode(img, level)
    native = jnative.png_encode(img, level)
    if native is not None:  # the JAX package's zlib-linked encoder
        assert data == native
    path = str(tmp_path / "a.png")
    png.write(path, img, level)
    with open(path, "rb") as f:
        assert f.read() == data
    np.testing.assert_array_equal(png.read(path), img)
    np.testing.assert_array_equal(jpng.read(path), img)


def test_png_rejects_non_u8():
    with pytest.raises(ValueError):
        png.encode(np.zeros((4, 4, 3), np.float32))


def rle_encode(rgbe: np.ndarray) -> bytes:
    """New-style RLE scanlines: runs of >= 3 equal bytes, literals else."""
    h, w, _ = rgbe.shape
    out = bytearray()
    for y in range(h):
        out += bytes([2, 2, w >> 8, w & 255])
        for c in range(4):
            row = rgbe[y, :, c]
            x = 0
            while x < w:
                r = 1
                while x + r < w and r < 127 and row[x + r] == row[x]:
                    r += 1
                if r >= 3:
                    out += bytes([128 + r, int(row[x])])
                    x += r
                    continue
                lit = x
                while lit < w and lit - x < 128:
                    if lit + 2 < w and row[lit] == row[lit + 1] == row[lit + 2]:
                        break
                    lit += 1
                lit = max(lit, x + 1)
                out += bytes([lit - x]) + row[x:lit].tobytes()
                x = lit
    return bytes(out)


def hdr_image(h, w):
    img = (RNG.random((h, w, 3)) ** 3 * 50).astype(np.float32)
    img[2:5] = 1.25  # runs for the RLE
    img[0, 0] = 0.0  # e = 0
    return img


def test_hdr_flat_file_of_jax_writer(tmp_path):
    path = str(tmp_path / "flat.hdr")
    jhdr.write_hdr(path, hdr_image(9, 13))
    got = hdr.read_hdr(path)
    assert got.dtype == np.float32 and got.shape == (9, 13, 3)
    np.testing.assert_array_equal(got, jhdr.read_hdr(path))
    with open(path, "rb") as f:
        data = f.read()
    w, h, off = hdr._header(data)
    np.testing.assert_array_equal(hdr.decode_plain(data[off:], w, h), got)
    # the port's writer writes the same file
    img = hdr_image(9, 13)
    mine = str(tmp_path / "port.hdr")
    hdr.write_hdr(mine, img)
    jhdr.write_hdr(path, img)
    with open(path, "rb") as f1, open(mine, "rb") as f2:
        assert f1.read() == f2.read()


def test_hdr_rle_decode_equals_plain_and_jax(tmp_path):
    h, w = 11, 40
    img = hdr_image(h, w)
    flat = str(tmp_path / "flat.hdr")
    jhdr.write_hdr(flat, img)
    with open(flat, "rb") as f:
        data = f.read()
    _w, _h, off = hdr._header(data)
    rgbe = np.frombuffer(data[off:], np.uint8).reshape(h, w, 4)
    rle = str(tmp_path / "rle.hdr")
    with open(rle, "wb") as f:
        f.write(data[:off] + rle_encode(rgbe))
    got = hdr.read_hdr(rle)
    np.testing.assert_array_equal(got, hdr.read_hdr(flat))
    with open(rle, "rb") as f:
        pix = f.read()[off:]
    np.testing.assert_array_equal(hdr.decode_plain(pix, w, h), got)
    np.testing.assert_array_equal(got, jhdr.read_hdr(rle))
    with pytest.raises(ValueError):  # truncated: the decoder's error code
        hdr.decode(pix[: len(pix) // 2], w, h)


@pytest.mark.parametrize("kw", [
    {}, dict(width=64, height=32), dict(sun_dir=(-0.2, 0.9, 0.1), sun_radius=0.1,
                                        ground=0.1, sun_intensity=50.0)])
def test_procedural_sky_bit_equal(kw):
    got = hdr.procedural_sky(**kw)
    want = jhdr.procedural_sky(**kw)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def write_obj(path):
    v = (RNG.random((9, 3)) * 4 - 2).astype(np.float32)
    lines = ["# test", "o thing"]
    lines += [f"v {x!r} {y!r} {z!r}" for x, y, z in v.tolist()]
    lines += ["vt 0.5 0.5", "vn 0 1 0",
              "f 1 2 3", "f 4/1/1 5/1/1 6/1/1 7/1/1",      # a quad, /vt/vn
              "f -1 -2 -3",                                # negative indices
              "f 2//1 8//1 9//1 3//1 1//1"]                # a pentagon
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def test_obj_parse_equals_plain_and_jax(tmp_path):
    path = str(tmp_path / "m.obj")
    write_obj(path)
    got, col = objio.load_obj(path)
    assert col is None and got.shape == (1 + 2 + 1 + 3, 3, 3)
    plain, _ = objio.load_obj_plain(path)
    np.testing.assert_array_equal(got, plain)
    np.testing.assert_array_equal(got, jobjio.load_obj(path)[0])
    np.testing.assert_array_equal(objio.load(path)[0], got)


def write_ply(path, binary: bool, colors: bool):
    v = (RNG.random((6, 3)) - 0.5).astype(np.float32)
    c = RNG.integers(0, 256, (6, 3)).astype(np.uint8)
    faces = [[0, 1, 2], [2, 3, 4, 5], [5, 1, 0]]
    head = ["ply", "format " + ("binary_little_endian" if binary else "ascii") + " 1.0",
            "element vertex 6", "property float x", "property float y",
            "property float z"]
    if colors:
        head += ["property uchar red", "property uchar green", "property uchar blue"]
    head += [f"element face {len(faces)}", "property list uchar int vertex_indices",
             "end_header"]
    with open(path, "wb") as f:
        f.write(("\n".join(head) + "\n").encode())
        for i in range(6):
            if binary:
                f.write(struct.pack("<fff", *v[i]))
                if colors:
                    f.write(struct.pack("<BBB", *c[i]))
            else:
                row = [repr(float(x)) for x in v[i]]
                if colors:
                    row += [str(int(x)) for x in c[i]]
                f.write((" ".join(row) + "\n").encode())
        for fc in faces:
            if binary:
                f.write(struct.pack("<B" + "i" * len(fc), len(fc), *fc))
            else:
                f.write((" ".join(map(str, [len(fc)] + fc)) + "\n").encode())


@pytest.mark.parametrize("binary", [False, True])
@pytest.mark.parametrize("colors", [False, True])
def test_ply_parse_equals_jax(tmp_path, binary, colors):
    path = str(tmp_path / "m.ply")
    write_ply(path, binary, colors)
    tri, col = objio.load(path)
    jtri, jcol = jobjio.load_ply(path)
    np.testing.assert_array_equal(tri, jtri)
    assert tri.shape == (4, 3, 3)
    if colors:
        np.testing.assert_array_equal(col, jcol)
    else:
        assert col is None and jcol is None


@pytest.mark.parametrize("with_colors", [False, True])
def test_save_voxels_ply_bytes_equal_jax(tmp_path, with_colors):
    xyz = np.unique(RNG.integers(0, 6, (40, 3)), axis=0)
    colors = RNG.random((len(xyz), 3)).astype(np.float32) if with_colors else None
    origin = np.array([-0.5, 0.25, 1.0], np.float32)
    a, b = str(tmp_path / "a.ply"), str(tmp_path / "b.ply")
    objio.save_voxels_ply(a, xyz, 0.125, origin, colors)
    jobjio.save_voxels_ply(b, xyz, 0.125, origin, colors)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    tri, _ = objio.load_ply(a)
    assert len(tri) > 0


def test_npz_frames_equal_jax(tmp_path):
    p = str(tmp_path / "anim.npz")
    t0 = jmeshgen.icosphere(1)
    np.savez(p, tri_0000=t0, col_0000=np.full_like(t0, 0.5),
             tri_0001=t0 * 2.0, emi_0001=np.full_like(t0, 0.25))
    for frame in (0, 1):
        got = objio.load_npz_frame(p, frame)
        want = jobjio.load_npz_frame(p, frame)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_ogawa_container_round_trip(tmp_path):
    path = str(tmp_path / "t.ogawa")
    root = [b"hello", [b"a", [], b"", [b"deep"]], b""]
    ogawa.OgawaWriter().write(path, root)
    jpath = str(tmp_path / "j.ogawa")
    jogawa.OgawaWriter().write(jpath, root)
    with open(path, "rb") as f1, open(jpath, "rb") as f2:
        assert f1.read() == f2.read()
    with ogawa.OgawaReader(jpath) as r:
        w = r.group(r.root)
        assert bytes(r.data(w[0])) == b"hello"
        assert bytes(r.data(r.group(r.group(w[1])[3])[0])) == b"deep"


def abc_frames():
    frames, cols, emis = [], [], []
    for f in range(3):
        tri = jmeshgen.icosphere(1, radius=0.5 + 0.1 * f)
        frames.append(tri)
        cols.append(RNG.uniform(0, 1, (tri.size // 3, 3)).astype(np.float32))
        emis.append(RNG.uniform(0, 1, (tri.size // 3, 3)).astype(np.float32))
    return frames, cols, emis


def test_abc_written_by_jax_reads_equal(tmp_path):
    frames, cols, emis = abc_frames()
    path = str(tmp_path / "shot.abc")
    jabcio.write_fixture_abc(path, frames, cols, emis, fps=24.0)
    ar, jar = abcio.AbcArchive(path), jabcio.AbcArchive(path)
    assert ar.n_frames == jar.n_frames == 3
    assert ar.time_per_cycle == jar.time_per_cycle
    for f in (0, 1, 2, 7):  # 7: past the end holds the last sample
        for a, b in zip(ar.read_flat(f), jar.read_flat(f)):
            np.testing.assert_array_equal(a, b)
    ar.close()
    jar.close()
    # the port's fixture writer writes the same bytes (its sample keys
    # hash with the port's murmur3; the JAX package's with its native one)
    mine = str(tmp_path / "mine.abc")
    abcio.write_fixture_abc(mine, frames, cols, emis, fps=24.0)
    if jnative.get_lib() is not None:
        with open(path, "rb") as f1, open(mine, "rb") as f2:
            assert f1.read() == f2.read()


@pytest.mark.parametrize("kw", [dict(), dict(n_seg=384, n_ring=28),
                                dict(p=2, q=3, n_seg=64, n_ring=8, tube=0.21,
                                     center=(0.1, -0.2, 0.3))])
def test_torus_knot_bit_equal(kw):
    np.testing.assert_array_equal(meshgen.torus_knot(**kw), jmeshgen.torus_knot(**kw))


def test_random_soup_and_vertex_colors_bit_equal():
    for kw in (dict(n=200, seed=1, scale=0.8), dict(n=17, seed=5, center=(1, 2, 3))):
        a = meshgen.random_soup(**kw)
        b = jmeshgen.random_soup(**kw)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
        lo, hi = meshgen.mesh_bounds(a)
        np.testing.assert_array_equal(
            meshgen.vertex_colors_from_position(a, lo, hi),
            jmeshgen.vertex_colors_from_position(a, lo, hi))
