"""File formats of the port (eogs2_tpu_torch/io) against what the JAX
package's environment writes and reads: the PLY byte for byte against
eogs2_tpu's, the TIFF and PNG codecs (numpy, struct and zlib only) against
imageio (and its bundled tifffile) and Pillow, and the ImportError for a
file outside the codecs when neither library can be imported. Every
comparison is exact (bit for bit)."""

import struct
import sys
import zlib

import imageio.v2 as iio
import numpy as np
import pytest
import torch
from imageio.plugins._tifffile import TiffWriter
from PIL import Image

from eogs2_tpu.io import geotiff as jgeo
from eogs2_tpu.io import ply as jply
from eogs2_tpu_torch.io import geotiff as tgeo
from eogs2_tpu_torch.io import ply as tply
from eogs2_tpu_torch.io.png import read_png, write_png
from eogs2_tpu_torch.io.tiff import (ROWS_PER_STRIP, STRIP_OFFSETS,
                                     TILE_OFFSETS, read_tiff, write_tiff)

DTYPES = ("uint8", "uint16", "float32")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run this file's torch ops on one thread: beside the other test
    workers, torch's default pool (one thread per core) oversubscribes the
    cores and its many small parallel regions slow the file tenfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


BANDS = (1, 3, 4)


def _image(dtype, bands, h=37, w=53, seed=0):
    rng = np.random.RandomState(seed)
    shape = (h, w) if bands == 1 else (h, w, bands)
    if dtype == "float32":
        return rng.normal(0, 100, shape).astype(np.float32)
    return rng.randint(0, np.iinfo(dtype).max + 1, shape).astype(dtype)


def _block_libraries(monkeypatch):
    for m in ("imageio", "imageio.v2", "PIL", "PIL.Image"):
        monkeypatch.setitem(sys.modules, m, None)


# ---------------------------------------------------------------------------
# PLY
# ---------------------------------------------------------------------------


def _gaussians(n=57, rest=3, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.normal(size=(n, 3)).astype(np.float32),
            rng.normal(size=(n, 1, 3)).astype(np.float32),
            rng.normal(size=(n, rest, 3)).astype(np.float32),
            rng.normal(size=(n, 1)).astype(np.float32),
            rng.normal(size=(n, 3)).astype(np.float32),
            rng.normal(size=(n, 4)).astype(np.float32))


@pytest.mark.parametrize("rest,sh_degree", [(0, 0), (3, 1)])
def test_gaussian_ply_bytes_equal_jax(tmp_path, rest, sh_degree):
    g = _gaussians(rest=rest)
    jply.save_gaussians_ply(str(tmp_path / "j.ply"), *g)
    tply.save_gaussians_ply(str(tmp_path / "t.ply"), *g)
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
    for name in ("j.ply", "t.ply"):  # each package reads the other's
        tg = tply.load_gaussians_ply(str(tmp_path / name), sh_degree)
        jg = jply.load_gaussians_ply(str(tmp_path / name), sh_degree)
        for k, want in zip(("xyz", "features_dc", "features_rest", "opacity",
                            "scaling", "rotation"), g):
            np.testing.assert_array_equal(tg[k], want)
            np.testing.assert_array_equal(tg[k], jg[k])


def test_point_cloud_ply_bytes_equal_jax(tmp_path):
    rng = np.random.RandomState(1)
    xyz = rng.normal(size=(40, 3)).astype(np.float32)
    rgb = rng.uniform(0, 1, (40, 3)).astype(np.float32)
    jply.write_point_cloud(str(tmp_path / "j.ply"), xyz, rgb)
    tply.write_point_cloud(str(tmp_path / "t.ply"), xyz, rgb)
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
    txyz, trgb = tply.read_point_cloud(str(tmp_path / "j.ply"))
    jxyz, jrgb = jply.read_point_cloud(str(tmp_path / "t.ply"))
    np.testing.assert_array_equal(txyz, jxyz)
    np.testing.assert_array_equal(trgb, jrgb)


# ---------------------------------------------------------------------------
# TIFF
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bands", BANDS)
def test_tiff_reads_what_imageio_writes(tmp_path, dtype, bands):
    """imageio.v2.imwrite, as JAX's generate_scene writes every view."""
    a = _image(dtype, bands)
    iio.imwrite(str(tmp_path / "a.tif"), a)
    got, _ = read_tiff(str(tmp_path / "a.tif"))
    assert got.dtype == a.dtype
    np.testing.assert_array_equal(got, a)


LAYOUTS = {
    "strips_deflate": dict(rowsperstrip=7, compress=6),
    "predictor_deflate": dict(rowsperstrip=9, compress=6, predictor=True),
    "tiles": dict(tile=(16, 16)),
    "tiles_deflate": dict(tile=(16, 16), compress=6),
}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bands", BANDS)
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_tiff_reads_tifffile_layouts(tmp_path, dtype, bands, layout):
    """Strips of fewer rows than the height, tiles (edge tiles padded),
    Deflate, and the horizontal predictor on integers, from imageio's
    bundled tifffile."""
    kw = dict(LAYOUTS[layout])
    if kw.get("predictor") and dtype == "float32":
        kw["predictor"] = False  # tifffile predicts integers only
    a = _image(dtype, bands, seed=2)
    with TiffWriter(str(tmp_path / "a.tif")) as w:
        w.save(a, planarconfig="contig",
               photometric="rgb" if bands == 3 else "minisblack", **kw)
    got, tags = read_tiff(str(tmp_path / "a.tif"))
    if "tile" in kw:
        assert len(tags[TILE_OFFSETS]) > 1
    else:
        assert len(tags[STRIP_OFFSETS]) > 1 and tags[ROWS_PER_STRIP][0] < 37
    np.testing.assert_array_equal(got, a)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bands", BANDS)
def test_imageio_reads_what_the_port_writes(tmp_path, dtype, bands):
    a = _image(dtype, bands, seed=3)
    write_tiff(str(tmp_path / "t.tif"), a)
    got = iio.imread(str(tmp_path / "t.tif"))
    assert got.dtype == a.dtype
    np.testing.assert_array_equal(got, a)
    np.testing.assert_array_equal(read_tiff(str(tmp_path / "t.tif"))[0], a)


@pytest.mark.parametrize("dtype", ("uint8", "float32", "float64"))
def test_geotiff_matches_jax_pillow(tmp_path, dtype):
    """JAX's write_geotiff (Pillow, the geotags as DOUBLE arrays) read by
    the port, and the port's read by Pillow (JAX), with the same transform;
    float64 is stored as float32 by both."""
    a = _image("float32" if dtype == "float64" else dtype, 1, seed=4)
    a = a.astype(dtype)
    t = jgeo.Affine.from_origin(-12.5, 40.0, 0.5, 0.5)
    tt = tgeo.Affine(t.a, t.b, t.c, t.d, t.e, t.f)
    jgeo.write_geotiff(str(tmp_path / "j.tif"), a, t)
    tgeo.write_geotiff(str(tmp_path / "t.tif"), a, tt)
    want = a.astype(np.float32) if dtype == "float64" else a
    for name in ("j.tif", "t.tif"):
        ta, tp = tgeo.read_geotiff(str(tmp_path / name))
        ja, jp = jgeo.read_geotiff(str(tmp_path / name))
        assert ta.dtype == ja.dtype == want.dtype
        np.testing.assert_array_equal(ta, want)
        np.testing.assert_array_equal(ja, want)
        assert repr(tp["transform"]) == repr(jp["transform"]) == repr(t)


def test_lzw_tiff_needs_a_library(tmp_path, monkeypatch):
    """An LZW TIFF is read through Pillow; without Pillow and imageio the
    port raises ImportError naming the file and its compression."""
    a = _image("uint8", 1, seed=5)
    path = str(tmp_path / "lzw.tif")
    Image.fromarray(a).save(path, compression="tiff_lzw")
    np.testing.assert_array_equal(read_tiff(path)[0], a)
    _block_libraries(monkeypatch)
    with pytest.raises(ImportError, match=r"lzw\.tif.*compression 5"):
        read_tiff(path)


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------


def _smooth_image(shape, seed):
    """8-bit content with gradients, so that encoders filter its rows."""
    rng = np.random.RandomState(seed)
    a = np.cumsum(rng.randint(0, 9, shape), axis=1) + 20 * np.arange(
        shape[0]).reshape((-1,) + (1,) * (len(shape) - 1))
    return (a % 256).astype(np.uint8)


PNG_SHAPES = {"gray": (29, 41), "rgb": (29, 41, 3), "rgba": (29, 41, 4)}


@pytest.mark.parametrize("kind", sorted(PNG_SHAPES))
def test_png_interop_with_imageio_and_pillow(tmp_path, kind):
    a = _smooth_image(PNG_SHAPES[kind], seed=6)
    write_png(str(tmp_path / "t.png"), a)
    np.testing.assert_array_equal(iio.imread(str(tmp_path / "t.png")), a)
    np.testing.assert_array_equal(read_png(str(tmp_path / "t.png")), a)
    iio.imwrite(str(tmp_path / "i.png"), a)
    np.testing.assert_array_equal(read_png(str(tmp_path / "i.png")), a)
    Image.fromarray(a).save(str(tmp_path / "p.png"), optimize=True)
    np.testing.assert_array_equal(read_png(str(tmp_path / "p.png")), a)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _encode_filtered(a, filters):
    """A PNG of uint8 a [H, W, C] whose row y uses filter filters[y % 5]
    (PNG spec, section 9), encoded here, byte by byte."""
    h, w, c = a.shape
    raw = a.reshape(h, w * c).astype(int)
    body = bytearray()
    for y in range(h):
        f = filters[y % len(filters)]
        body.append(f)
        for i in range(w * c):
            x = raw[y, i]
            left = raw[y, i - c] if i >= c else 0
            up = raw[y - 1, i] if y else 0
            ul = raw[y - 1, i - c] if y and i >= c else 0
            pred = (0, left, up, (left + up) // 2, _paeth(left, up, ul))[f]
            body.append((x - pred) % 256)

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data)))

    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(body)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_png_reader_undoes_every_filter(tmp_path, channels):
    """Rows filtered with None, Sub, Up, Average and Paeth in turn: the
    port reads what imageio reads, and both give the image back."""
    a = _smooth_image((23, 19, channels), seed=7)
    path = tmp_path / "f.png"
    path.write_bytes(_encode_filtered(a, (0, 1, 2, 3, 4)))
    want = a[..., 0] if channels == 1 else a
    np.testing.assert_array_equal(iio.imread(str(path)), want)
    np.testing.assert_array_equal(read_png(str(path)), want)


def test_sixteen_bit_png_needs_a_library(tmp_path, monkeypatch):
    a = (np.arange(12 * 10, dtype=np.uint16).reshape(12, 10) * 500)
    path = str(tmp_path / "deep.png")
    iio.imwrite(path, a)
    np.testing.assert_array_equal(read_png(path), a)
    _block_libraries(monkeypatch)
    with pytest.raises(ImportError, match=r"deep\.png.*bit depth 16"):
        read_png(path)


def test_scene_init_from_ply_matches_jax(tmp_path):
    """load_scene(input_ply_name=...) takes its init points from
    <scene>/<name>.ply, as JAX's does."""
    from eogs2_tpu.data.synthetic import generate_scene
    from eogs2_tpu.scene import load_scene as j_load
    from eogs2_tpu_torch.scene import load_scene as t_load

    d = str(tmp_path / "scene")
    generate_scene(d, n_views=3, width=16, height=16, hf_res=32,
                   n_buildings=1, scale=4.0, seed=3)
    rng = np.random.RandomState(8)
    xyz = rng.uniform(-0.8, 0.8, (90, 3)).astype(np.float32)
    rgb = rng.uniform(0, 1, (90, 3)).astype(np.float32)
    jply.write_point_cloud(f"{d}/init.ply", xyz, rgb)
    js = j_load(d, images_msi_path=f"{d}/images", load_pan=False,
                input_ply_name="init")
    ts = t_load(d, images_msi_path=f"{d}/images", load_pan=False,
                input_ply_name="init", device="cpu")
    np.testing.assert_array_equal(ts.init_xyz, xyz)
    np.testing.assert_array_equal(ts.init_xyz, js.init_xyz)
    np.testing.assert_array_equal(ts.init_rgb, js.init_rgb)
    assert ts.cameras_extent == js.cameras_extent
    for a, b in zip(ts.train_views, js.train_views):
        np.testing.assert_array_equal(a.image, b.image)
