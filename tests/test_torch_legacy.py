"""The rest of the port's host-side surface, held against eogs2_tpu on the
CPU: the COLMAP model files (io/colmap.py), the legacy COLMAP and Blender
scene readers (scene_legacy.py), RPC projection, localisation and UTM
(dataset_creation/rpc.py), the RPC-to-affine conversion
(dataset_creation/to_affine.py), and the image-metrics CLI
(metrics_cli.py: PSNR, SSIM and the perceptual proxy on the device, LPIPS
with an injected VGG stack, the LPIPS heads' loader).
"""

import json
import os
import struct
import sys

import numpy as np
import pytest
import torch

from eogs2_tpu import metrics_cli as jm
from eogs2_tpu import scene_legacy as jl
from eogs2_tpu.dataset_creation import rpc as jrpc
from eogs2_tpu.dataset_creation import to_affine as jaff
from eogs2_tpu.io import colmap as jc
from eogs2_tpu_torch import metrics_cli as tm
from eogs2_tpu_torch import scene_legacy as tl
from eogs2_tpu_torch.dataset_creation import rpc as trpc
from eogs2_tpu_torch.dataset_creation import to_affine as taff
from eogs2_tpu_torch.io import colmap as tc
from eogs2_tpu_torch.io.ply import write_point_cloud
from eogs2_tpu_torch.io.png import write_png


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run this file's torch ops on one thread: beside the other test
    workers, torch's default pool (one thread per core) oversubscribes the
    cores and its many small parallel regions slow the file tenfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _assert_same(a, b, path="", atol=0.0):
    """Recursive equality of dataclasses, dicts, lists, arrays and
    numbers (floats within atol)."""
    if hasattr(a, "__dataclass_fields__"):
        assert type(a).__name__ == type(b).__name__, path
        for f in a.__dataclass_fields__:
            _assert_same(getattr(a, f), getattr(b, f), f"{path}.{f}", atol)
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}[{k!r}]", atol)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}[{i}]", atol)
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, path
        np.testing.assert_allclose(a, b, rtol=0, atol=atol, err_msg=path)
    elif isinstance(a, float):
        assert abs(a - b) <= atol, (path, a, b)
    else:
        assert a == b, (path, a, b)


# ---------------------------------------------------------------------------
# COLMAP and Blender
# ---------------------------------------------------------------------------


def _colmap_model(mod, n_images=9, seed=3):
    cams = {
        1: mod.ColmapCamera(1, "PINHOLE", 64, 48,
                            np.array([50.0, 48.0, 32.0, 24.0])),
        2: mod.ColmapCamera(2, "SIMPLE_PINHOLE", 32, 24,
                            np.array([26.0, 16.0, 12.0])),
    }
    rng = np.random.RandomState(seed)
    imgs = {}
    for i in range(1, n_images + 1):
        q = rng.randn(4)
        q /= np.linalg.norm(q)
        imgs[i] = mod.ColmapImage(i, q if q[0] >= 0 else -q, rng.randn(3),
                                  1 + i % 2, f"im_{i:03d}.png")
    xyz = rng.randn(50, 3)
    rgb = rng.randint(0, 256, (50, 3)).astype(np.uint8)
    return cams, imgs, xyz, rgb


def _write_colmap(mod, sparse, n_images=9):
    os.makedirs(sparse, exist_ok=True)
    cams, imgs, xyz, rgb = _colmap_model(mod, n_images)
    mod.write_cameras_binary(os.path.join(sparse, "cameras.bin"), cams)
    mod.write_images_binary(os.path.join(sparse, "images.bin"), imgs)
    mod.write_points3d_binary(os.path.join(sparse, "points3D.bin"), xyz, rgb)
    return cams, imgs


def test_colmap_files_match_jax(tmp_path):
    for mod, name in ((jc, "j"), (tc, "t")):
        _write_colmap(mod, str(tmp_path / name))
    for f in ("cameras.bin", "images.bin", "points3D.bin"):
        assert (tmp_path / "t" / f).read_bytes() == \
            (tmp_path / "j" / f).read_bytes(), f
    # a points file with tracks, which the readers skip
    with open(tmp_path / "t" / "points3D.bin", "wb") as fh:
        fh.write(struct.pack("<Q", 2))
        for i in range(2):
            fh.write(struct.pack("<qdddBBBdQ", i, 1.0 + i, 2.0, 3.0, 10, 20,
                                 30, 0.5, 2) + struct.pack("<iiii", 1, 0, 2,
                                                           5))
    _assert_same(tc.read_model(str(tmp_path / "t")),
                 jc.read_model(str(tmp_path / "t")))

    text = tmp_path / "txt"
    text.mkdir()
    (text / "cameras.txt").write_text(
        "# comment\n1 PINHOLE 640 480 500 480 320 240\n"
        "2 SIMPLE_PINHOLE 320 240 260 160 120\n")
    (text / "images.txt").write_text(
        "# two lines per image\n1 1 0 0 0 0.5 -0.25 2.0 1 a.png\n1.0 2.0 3\n"
        "2 0.5 0.5 0.5 0.5 1 2 3 2 b.png\n10.0 20.0 -1\n")
    (text / "points3D.txt").write_text("1 1.0 2.0 3.0 10 20 30 0.5\n"
                                       "2 -1 0 4 0 0 255 0.25 1 0\n")
    got, want = tc.read_model(str(text)), jc.read_model(str(text))
    _assert_same(got, want)
    assert got[1][2].name == "b.png" and len(got[2][0]) == 2
    R = tc.qvec2rotmat(want[1][2].qvec / np.linalg.norm(want[1][2].qvec))
    np.testing.assert_array_equal(tc.rotmat2qvec(R), jc.rotmat2qvec(R))


def _pngs(dirname, names, w, h, seed):
    os.makedirs(dirname, exist_ok=True)
    rng = np.random.RandomState(seed)
    for n in names:
        write_png(os.path.join(dirname, n),
                  rng.randint(0, 256, (h, w, 3)).astype(np.uint8))


def test_colmap_scene_matches_jax(tmp_path):
    _, imgs = _write_colmap(tc, str(tmp_path / "sparse" / "0"), n_images=16)
    _pngs(str(tmp_path / "images"), [im.name for im in imgs.values()
                                     if im.camera_id == 1], 64, 48, 0)
    _pngs(str(tmp_path / "images"), [im.name for im in imgs.values()
                                     if im.camera_id == 2], 32, 24, 1)
    for kw in (dict(eval_split=True, llffhold=8),
               dict(eval_split=False, load_images=False)):
        got = tl.load_colmap_scene(str(tmp_path), **kw)
        _assert_same(got, jl.load_colmap_scene(str(tmp_path), **kw))
    assert len(got.train_cameras) == 16 and got.train_cameras[0].image is None
    got = tl.load_colmap_scene(str(tmp_path), eval_split=True)
    assert len(got.test_cameras) == 2
    assert got.train_cameras[0].image.shape in ((48, 64, 3), (24, 32, 3))


def test_blender_scene_matches_jax(tmp_path):
    for split, n in (("train", 4), ("test", 2)):
        frames = []
        for i in range(n):
            th = i * np.pi / 2 + (0.3 if split == "test" else 0.0)
            c2w = np.eye(4)
            c2w[:3, :3] = [[np.cos(th), 0, np.sin(th)], [0, 1, 0],
                           [-np.sin(th), 0, np.cos(th)]]
            c2w[:3, 3] = [4 * np.sin(th), 0.0, 4 * np.cos(th)]
            frames.append({"file_path": f"./{split}/r_{i}",
                           "transform_matrix": c2w.tolist()})
        (tmp_path / f"transforms_{split}.json").write_text(
            json.dumps({"camera_angle_x": 0.7, "frames": frames}))
        _pngs(str(tmp_path / split), [f"r_{i}.png" for i in range(n)], 40,
              30, n)
    for kw in (dict(num_random_points=500), dict(eval_split=False,
                                                  load_images=False,
                                                  num_random_points=300)):
        _assert_same(tl.load_blender_scene(str(tmp_path), **kw),
                     jl.load_blender_scene(str(tmp_path), **kw))
    rng = np.random.RandomState(2)
    write_point_cloud(str(tmp_path / "points3d.ply"),
                      rng.randn(64, 3).astype(np.float32),
                      rng.randint(0, 256, (64, 3)).astype(np.uint8))
    got = tl.load_blender_scene(str(tmp_path))
    _assert_same(got, jl.load_blender_scene(str(tmp_path)))
    assert got.points.shape == (64, 3) and got.train_cameras[0].width == 40


def test_projection_and_fov_match_jax():
    for fx, fy, zn, zf in ((np.pi / 2, np.pi / 2, 0.1, 10.0),
                           (0.7, 0.5, 0.01, 100.0)):
        np.testing.assert_array_equal(
            tl.perspective_projection(fx, fy, znear=zn, zfar=zf),
            jl.perspective_projection(fx, fy, znear=zn, zfar=zf))
        assert tl.perspective_projection(fx, fy) .tolist() == \
            jl.perspective_projection(fx, fy).tolist()
    for f, px in ((500.0, 640), (260.0, 240)):
        assert tl.focal2fov(f, px) == jl.focal2fov(f, px)
        assert tl.fov2focal(0.7, px) == jl.fov2focal(0.7, px)


# ---------------------------------------------------------------------------
# RPC, UTM and the RPC-to-affine conversion
# ---------------------------------------------------------------------------


def make_rpc(shear=(0.0, 0.0), lon0=-58.58, lat0=-34.45, width=128,
             height=128, cubic=0.0):
    """A synthetic RPC00B (tests/test_dataset_creation.py's linear one,
    with optional small quadratic and cubic terms)."""
    num0, den = np.zeros(20), np.zeros(20)
    den[0] = 1.0
    den[8] = 0.5 * cubic
    col_num, row_num = num0.copy(), num0.copy()
    col_num[1], col_num[3] = 1.0, shear[0]
    row_num[2], row_num[3] = 1.0, shear[1]
    col_num[11], row_num[15], col_num[9] = cubic, -cubic, 0.3 * cubic
    return {
        "row_offset": height / 2, "col_offset": width / 2,
        "lat_offset": lat0, "lon_offset": lon0, "alt_offset": 0.0,
        "row_scale": height / 2, "col_scale": width / 2,
        "lat_scale": 0.0025, "lon_scale": 0.0025, "alt_scale": 100.0,
        "row_num": row_num.tolist(), "row_den": den.tolist(),
        "col_num": col_num.tolist(), "col_den": den.tolist(),
    }


def test_rpc_and_utm_match_jax():
    d = make_rpc(shear=(0.3, -0.2), cubic=0.05)
    rt, rj = trpc.RPCModel(d), jrpc.RPCModel(d)
    rng = np.random.RandomState(0)
    lon = rt.lon_offset + rng.uniform(-1, 1, 50) * rt.lon_scale * 0.5
    lat = rt.lat_offset + rng.uniform(-1, 1, 50) * rt.lat_scale * 0.5
    alt = rng.uniform(-20, 60, 50)
    col, row = rt.projection(lon, lat, alt)
    _assert_same((col, row), rj.projection(lon, lat, alt))
    lon2, lat2 = rt.localization(col, row, alt)
    _assert_same((lon2, lat2), rj.localization(col, row, alt))
    np.testing.assert_allclose(lon2, lon, atol=1e-9)
    assert rt.localization(col[0], row[0], alt[0]) == \
        rj.localization(col[0], row[0], alt[0])
    for args in ((-34.45, -58.58), (lat, lon), (60.0, 5.0), (75.0, 20.0)):
        _assert_same(trpc.from_latlon(*args), jrpc.from_latlon(*args))
    _assert_same(trpc.from_latlon(lat, lon, force_zone_number=22),
                 jrpc.from_latlon(lat, lon, force_zone_number=22))
    for el, az in ((35.0, 120.0), (80.0, 10.0)):
        _assert_same(taff.get_dir_vec_from_el_az(el, az),
                     jaff.get_dir_vec_from_el_az(el, az))


def test_convert_scene_matches_jax(tmp_path):
    md_dir = tmp_path / "meta"
    md_dir.mkdir()
    for i, sh in enumerate([(0.0, 0.0), (0.3, 0.1), (-0.2, 0.25),
                            (0.15, -0.3)]):
        md = {"img": f"img_{i:02d}.tif", "width": 128, "height": 128,
              "min_alt": -20.0, "max_alt": 60.0, "sun_elevation": 35.0,
              "sun_azimuth": 120.0 + 10 * i,
              "rpc": make_rpc(shear=sh, cubic=0.02 * i)}
        (md_dir / f"img_{i:02d}.json").write_text(json.dumps(md))
    kw = dict(test_fraction_last=1, grid=(9, 9, 9))
    got = taff.convert_scene(str(md_dir), str(tmp_path / "t"), **kw)
    want = jaff.convert_scene(str(md_dir), str(tmp_path / "j"), **kw)
    _assert_same(got, want, atol=1e-9)
    taff.validate(got)
    for f in ("train.txt", "test.txt"):
        assert (tmp_path / "t" / f).read_text() == \
            (tmp_path / "j" / f).read_text()
    _assert_same(json.loads((tmp_path / "t" / "affine_models.json")
                            .read_text()),
                 json.loads((tmp_path / "j" / "affine_models.json")
                            .read_text()), atol=1e-9)
    from eogs2_tpu_torch.scene import load_scene

    scene = load_scene(str(tmp_path / "t"), images_msi_path=None,
                       target_density=0.001, device="cpu")
    assert len(scene.train_views) == 3
    assert any("Nadir" in v.name for v in scene.test_views)


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def metric_dirs(tmp_path_factory):
    """Renders and GT as PNGs written by the port's codec (one gray pair,
    one with no counterpart)."""
    root = tmp_path_factory.mktemp("metrics")
    rng = np.random.RandomState(7)
    for i in range(3):
        gt = rng.randint(0, 256, (48, 40, 3)).astype(np.int16)
        ren = np.clip(gt + rng.randint(-40, 41, gt.shape), 0, 255)
        for d, img in (("gt", gt), ("renders", ren)):
            os.makedirs(root / d, exist_ok=True)
            write_png(str(root / d / f"v{i}.png"), img.astype(np.uint8))
    write_png(str(root / "gt" / "g.png"), rng.randint(0, 256, (40, 40), np.uint8))
    write_png(str(root / "renders" / "g.png"),
              rng.randint(0, 256, (40, 40), np.uint8))
    write_png(str(root / "renders" / "extra.png"),
              np.zeros((8, 8, 3), np.uint8))
    return str(root / "renders"), str(root / "gt")


def test_compute_metrics_matches_jax(metric_dirs, capsys):
    got = tm.compute_metrics(*metric_dirs, device="cpu")
    err = capsys.readouterr().err
    assert "perceptual_distance" in err and "torchvision" in err
    assert "fewer than 3 channels (1 of 4 images)" in err
    want = jm.compute_metrics(*metric_dirs)
    assert [r["name"] for r in got["per_image"]] == \
        [r["name"] for r in want["per_image"]] == ["g", "v0", "v1", "v2"]
    for a, b in zip(got["per_image"] + [got["mean"]],
                    want["per_image"] + [want["mean"]]):
        for k in ("psnr", "ssim", "perceptual"):
            assert abs(a[k] - b[k]) <= 1e-5, (a.get("name"), k, a[k], b[k])
    assert 5.0 < got["mean"]["psnr"] < 40.0


def test_metrics_cli_main(metric_dirs, tmp_path, capsys):
    out = tmp_path / "m.json"
    assert tm.main(["--renders", metric_dirs[0], "--gt", metric_dirs[1],
                    "--out", str(out), "--device", "cpu"]) == 0
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    saved = json.loads(out.read_text())
    assert printed == saved["mean"] and len(saved["per_image"]) == 4
    assert all(np.isfinite(v) for v in printed.values())


def _vgg16_features_stack(seed=0):
    """torchvision's vgg16().features layout (13 conv+ReLU, 5 max pools),
    seeded random weights."""
    torch.manual_seed(seed)
    layers, c = [], 3
    for v in (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512,
              512, "M", 512, 512, 512, "M"):
        if v == "M":
            layers.append(torch.nn.MaxPool2d(2, 2))
        else:
            layers += [torch.nn.Conv2d(c, v, 3, padding=1),
                       torch.nn.ReLU(inplace=True)]
            c = v
    return torch.nn.Sequential(*layers).eval()


def test_lpips_torch_matches_jax():
    net = _vgg16_features_stack()
    rng = np.random.RandomState(1)
    a, b = (rng.rand(3, 32, 32).astype(np.float32) for _ in range(2))
    lins = [rng.rand(w).astype(np.float32) for w in tm._VGG_WIDTHS]
    for lw in (None, lins):
        got = tm.lpips_torch(a, b, net=net, lin_weights=lw)
        assert got == jm.lpips_torch(a, b, net=net, lin_weights=lw) and got > 0
    assert tm.lpips_torch(a, a, net=net) == 0.0


def test_load_lpips_weights(tmp_path):
    rng = np.random.RandomState(0)
    lins = {f"lin{i}": rng.rand(1, w, 1, 1).astype(np.float32)
            for i, w in enumerate(tm._VGG_WIDTHS)}
    np.savez(tmp_path / "w.npz", **lins)
    got = tm.load_lpips_weights(str(tmp_path / "w.npz"))
    _assert_same(got, jm.load_lpips_weights(str(tmp_path / "w.npz")))
    assert [g.shape for g in got] == [(w,) for w in tm._VGG_WIDTHS]
    torch.save({f"lin{i}.model.1.weight": torch.as_tensor(v)
                for i, v in enumerate(lins.values())}, tmp_path / "vgg.pth")
    _assert_same(tm.load_lpips_weights(str(tmp_path / "vgg.pth")), got)
    lins["lin2"] = lins["lin2"][:, :100]
    np.savez(tmp_path / "bad.npz", **lins)
    with pytest.raises(ValueError, match="linear head shape"):
        tm.load_lpips_weights(str(tmp_path / "bad.npz"))


def test_jpg_without_an_image_library_names_the_file(tmp_path, monkeypatch):
    """PNGs and TIFFs go through the port's codecs; a JPEG needs Pillow or
    imageio (the card's machine has no imageio)."""
    d = tmp_path / "renders"
    d.mkdir()
    write_png(str(d / "a.png"), np.full((20, 20, 3), 200, np.uint8))
    (d / "b.jpg").write_bytes(b"\xff\xd8\xff\xe0 not decoded here")
    for m in ("imageio", "imageio.v2", "PIL", "PIL.Image"):
        monkeypatch.setitem(sys.modules, m, None)
    with pytest.raises(ImportError, match="b.jpg"):
        tm._load_dir(str(d))
    (d / "b.jpg").unlink()
    loaded = tm._load_dir(str(d))
    assert loaded["a"].shape == (3, 20, 20)
    assert loaded["a"].max() == pytest.approx(200 / 255)
