"""TSDF fusion, mesh export and the tsdf/full-eval CLI of the port, held
against eogs2_tpu on the CPU.

  * reconstruct_normals' weights and sample_sdf within 1e-5 of JAX's at
    64^2; integrate_views over five analytic views (tests/test_tsdf.py's
    helpers, with the image rows running south as a satellite image's: in
    make_affine's own orientation, v = +y, every view's cos-angle weight is
    0 in both packages and fusion leaves the volume as it was): per-view
    keep decisions (sdf >= -trunc) differing in at most
    1e-4 of the voxels, the volumes within 1e-5 wherever every decision
    agrees; one slab and many slabs bit-identical;
  * apply_prior and extract_dsm_points on the same volume as JAX's:
    bit-equal (an empty column included); run_tsdf end to end against JAX
    (the same NaN cells, the DSM within 1e-3 m) and against the heightfield
    with JAX's own bounds;
  * marching_tetrahedra and export_obj: the same vertices, faces and OBJ
    bytes as JAX's, on a sphere SDF and on an empty volume;
  * the CLI on the CPU with imageio and Pillow blocked (as on the card's
    machine): make-synthetic, train, render, tsdf --export-mesh (its DSM
    against JAX's run_tsdf_cli on the same altitude maps), eval-dsm of the
    TSDF DSM; full-eval printing both MAE lines.
"""

import argparse
import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eogs2_tpu.data.synthetic import _heightfield, _render_view, make_affine
from eogs2_tpu.eval import mesh as jmesh
from eogs2_tpu.eval import tsdf as jt
from eogs2_tpu.io import geotiff as jgeo
from eogs2_tpu_torch import cli
from eogs2_tpu_torch.eval import mesh as tmesh
from eogs2_tpu_torch.eval import tsdf as tt
from eogs2_tpu_torch.io.geotiff import read_geotiff

CPU = ["--device", "cpu"]
SCALE = 10.0
ALT = (-0.35, 0.35)
SHEARS = [(0.0, 0.0), (0.2, 0.0), (0.0, 0.2), (-0.2, 0.1), (0.1, -0.2)]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run this file's torch ops on one thread: beside the other test
    workers, torch's default pool (one thread per core) oversubscribes the
    cores and its many small parallel regions slow the file tenfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def card_machine(monkeypatch):
    """The card's machine has neither imageio nor (for the port) Pillow."""
    for m in ("imageio", "imageio.v2", "PIL", "PIL.Image"):
        monkeypatch.setitem(sys.modules, m, None)


@pytest.fixture(scope="module")
def analytic():
    """tests/test_tsdf.py's five analytic views of a 96^2 heightfield at
    64^2, rows running south (v = -y): (heightfield, {name: (coef, inter,
    altitude)})."""
    rng = np.random.RandomState(5)
    z, tex = _heightfield(96, 3, rng, ALT)
    sun_dir = np.array([0.3, 0.2, 0.9])
    maps = {}
    for i, shear in enumerate(SHEARS):
        a = make_affine(shear, 64, 64, ALT)
        a[1] *= -1.0
        _, surf_alt = _render_view(z, tex, a, sun_dir, 64, 64, alt_range=ALT,
                                   n_steps=96)
        maps[f"v{i}"] = (a[:, :3], a[:, 3], np.asarray(surf_alt, np.float32))
    return z, maps


def _bounds():
    return np.stack([np.array([-0.85, -0.85, ALT[0]]) * SCALE,
                     np.array([0.85, 0.85, ALT[1]]) * SCALE], axis=1)


def _views(maps, lib):
    stack = [np.stack([m[k] for m in maps.values()]).astype(np.float32)
             for k in range(3)]
    if lib == "jax":
        return jt.TsdfViews(*(jnp.asarray(x) for x in stack))
    return tt.TsdfViews(*(torch.as_tensor(x) for x in stack))


def test_normals_and_sample_sdf_match_jax(analytic):
    _, maps = analytic
    coef, inter, alt = maps["v3"]
    f32 = np.float32
    nj, wj = jt.reconstruct_normals(*(jnp.asarray(x, f32)
                                      for x in (coef, inter, alt)))
    nt, wt = tt.reconstruct_normals(*(torch.as_tensor(np.asarray(x, f32))
                                      for x in (coef, inter, alt)))
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), rtol=0, atol=1e-5)
    np.testing.assert_allclose(nt.numpy(), np.asarray(nj), rtol=0, atol=1e-5)
    assert 0.9 < float(wt.mean()) <= 1.0
    # make_affine's own orientation (rows running north): the normals point
    # along the view direction and every weight is 0, in both packages
    flip = np.array([1.0, -1.0, 1.0])
    north = [(flip[:, None] * coef).astype(f32), (flip * inter).astype(f32),
             np.ascontiguousarray(alt[::-1])]
    assert float(jt.reconstruct_normals(*map(jnp.asarray, north))[1].max()) == 0
    assert float(tt.reconstruct_normals(*map(torch.as_tensor, north))[1].max()) == 0

    rng = np.random.RandomState(0)
    pts = (rng.uniform(-1.0, 1.0, (4096, 3)) * [12.0, 12.0, 4.0]).astype(f32)
    outs_j = jt.sample_sdf(*(jnp.asarray(x, f32) for x in (coef, inter, alt)),
                           jnp.asarray(wj), jnp.asarray(pts), f32(SCALE))
    outs_t = tt.sample_sdf(*(torch.as_tensor(np.asarray(x, f32))
                             for x in (coef, inter, alt)), wt,
                           torch.as_tensor(pts), SCALE)
    sdf_j, valid_j, w_j = (np.asarray(x) for x in outs_j)
    sdf_t, valid_t, w_t = (x.numpy() for x in outs_t)
    np.testing.assert_array_equal(valid_t, valid_j)
    assert 0.3 < valid_t.mean() < 1.0
    np.testing.assert_allclose(sdf_t, sdf_j, rtol=0, atol=1e-5)
    np.testing.assert_allclose(w_t, w_j, rtol=0, atol=1e-5)


def test_integrate_views_matches_jax(analytic):
    _, maps = analytic
    vj = jt.TSDFVolume(_bounds(), 0.25, 4.0)
    vt = tt.TSDFVolume(_bounds(), 0.25, 4.0, device="cpu")
    assert vt.shape == vj.shape and vt.trunc == vj.trunc
    np.testing.assert_array_equal(vt.world_coords.numpy(),
                                  np.asarray(vj.world_coords))
    views_j, views_t = _views(maps, "jax"), _views(maps, "torch")
    vj.integrate_views(views_j, SCALE)
    vt.integrate_views(views_t, SCALE)

    # per-view keep decisions of both packages at every voxel
    wj, wt = jt._view_weights(views_j), tt._view_weights(views_t)
    agree = np.ones(vt.shape, bool)
    for i in range(len(maps)):
        sj, validj, _ = jt.sample_sdf(
            views_j.coefs[i], views_j.inters[i], views_j.altitudes[i], wj[i],
            vj.world_coords, jnp.float32(SCALE))
        st, validt, _ = tt.sample_sdf(
            views_t.coefs[i], views_t.inters[i], views_t.altitudes[i], wt[i],
            vt.world_coords, SCALE)
        keep_j = np.asarray(validj & (sj >= -vj.trunc))
        keep_t = (validt & (st >= -vt.trunc)).numpy()
        agree &= (keep_j == keep_t).reshape(vt.shape)
    assert (~agree).mean() <= 1e-4
    for name in ("tsdf", "weight"):
        a, b = getattr(vt, name).numpy(), np.asarray(getattr(vj, name))
        np.testing.assert_allclose(a[agree], b[agree], rtol=0, atol=1e-5,
                                   err_msg=name)
    assert (vt.weight.numpy() > 0).mean() > 0.3


def test_slab_chunking_is_exact(analytic):
    """One slab and many ragged slabs give the same bits."""
    _, maps = analytic
    views = _views(maps, "torch")
    outs = []
    for slab in (1 << 30, 1000):
        vol = tt.TSDFVolume(_bounds(), 0.25, 4.0, slab_voxels=slab,
                            device="cpu")
        assert vol.world_coords.shape[0] > 3 * 1000
        vol.integrate_views(views, SCALE)
        vol.apply_prior()
        outs.append((vol.tsdf.numpy(), vol.weight.numpy()))
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    np.testing.assert_array_equal(outs[0][1], outs[1][1])


def _random_volume(shape, seed):
    """A tsdf/weight pair with untouched voxels (1, 0), occupied runs,
    isolated occupied voxels and one column with no occupied voxel."""
    rng = np.random.RandomState(seed)
    tsdf = rng.uniform(-1.0, 1.0, shape).astype(np.float32)
    weight = rng.uniform(0.0, 3.0, shape).astype(np.float32)
    untouched = rng.rand(*shape) < 0.3
    tsdf[untouched], weight[untouched] = 1.0, 0.0
    tsdf[2, 3, :] = np.abs(tsdf[2, 3, :]) + 0.1  # no occupied voxel
    tsdf[5, 5, :] = 1.0
    tsdf[5, 5, 7] = -0.5  # isolated above the floor
    return tsdf, weight


def test_apply_prior_is_bit_equal_to_jax():
    tsdf, weight = _random_volume((12, 10, 16), 3)
    tj, wj = jt._apply_prior(jnp.asarray(tsdf), jnp.asarray(weight))
    tt_, wt = tt._apply_prior(torch.as_tensor(tsdf), torch.as_tensor(weight))
    np.testing.assert_array_equal(tt_.numpy(), np.asarray(tj))
    np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))
    assert (tt_.numpy() != tsdf).any()


def test_extract_dsm_points_is_bit_equal_to_jax():
    vb = np.array([[-3.0, 2.5], [-2.0, 2.5], [-1.0, 3.0]])
    vj = jt.TSDFVolume(vb, 0.5, 4.0)
    vt = tt.TSDFVolume(vb, 0.5, 4.0, device="cpu")
    tsdf, _ = _random_volume(vt.shape, 4)
    vj.tsdf, vt.tsdf = jnp.asarray(tsdf), torch.as_tensor(tsdf)
    cj, ct = vj.extract_dsm_points(), vt.extract_dsm_points()
    assert ct.dtype == cj.dtype == np.float64
    np.testing.assert_array_equal(ct, cj)
    # the empty column takes index 0, the lowest axis value
    assert ct[2 * vt.shape[1] + 3, 2] == np.float32(vt.axes[-1][0])


def test_run_tsdf_matches_jax_and_the_heightfield(analytic):
    z, maps = analytic
    lo, hi = np.array([-0.85, -0.85, ALT[0]]), np.array([0.85, 0.85, ALT[1]])
    kw = dict(scene_shift=np.zeros(3), vox_size=0.25, trunc_margin_fact=4.0,
              resolution=0.25)
    pj, dj = jt.run_tsdf("", maps, SCALE, lo, hi, **kw)
    pt, dt = tt.run_tsdf("", maps, SCALE, lo, hi, device="cpu", **kw)
    assert dt.shape == dj.shape and repr(pt["transform"]) == repr(
        pj["transform"])
    np.testing.assert_array_equal(np.isnan(dt), np.isnan(dj))
    np.testing.assert_allclose(dt, dj, rtol=0, atol=1e-3)
    assert np.isfinite(dt).mean() > 0.9

    t = pt["transform"]
    h, w = dt.shape
    jj, ii = np.mgrid[0:h, 0:w]
    xn, yn = (t.a * (ii + 0.5) + t.c) / SCALE, (t.e * (jj + 0.5) + t.f) / SCALE
    res = z.shape[0]
    ix = np.clip(((xn + 1) * 0.5 * (res - 1)).round().astype(int), 0, res - 1)
    iy = np.clip(((yn + 1) * 0.5 * (res - 1)).round().astype(int), 0, res - 1)
    inner = (np.abs(xn) < 0.8) & (np.abs(yn) < 0.8) & np.isfinite(dt)
    err = np.abs(dt[inner] - z[iy, ix][inner] * SCALE)
    assert np.median(err) < 0.3 and err.mean() < 0.8  # tests/test_tsdf.py's


def _sphere_sdf(n=25, r=8.0):
    ax = np.arange(n) - (n - 1) / 2.0
    x, y, zz = np.meshgrid(ax, ax, ax, indexing="ij")
    return np.sqrt(x * x + y * y + zz * zz) - r


@pytest.mark.parametrize("case", ["sphere", "empty"])
def test_mesh_and_obj_are_bit_equal_to_jax(tmp_path, case):
    vol = _sphere_sdf() if case == "sphere" else np.ones((8, 8, 8))
    axes = [np.linspace(-6.0, 6.0, vol.shape[0])] * 3
    for ax in (None, axes):
        vj, fj = jmesh.marching_tetrahedra(vol, 0.0, axes=ax)
        vt, ft = tmesh.marching_tetrahedra(vol, 0.0, axes=ax)
        assert vt.dtype == vj.dtype and ft.dtype == fj.dtype
        np.testing.assert_array_equal(vt, vj)
        np.testing.assert_array_equal(ft, fj)
    assert (len(ft) > 100) == (case == "sphere")
    jmesh.export_obj(str(tmp_path / "j.obj"), vj, fj)
    tmesh.export_obj(str(tmp_path / "t.obj"), vt, ft)
    assert (tmp_path / "t.obj").read_bytes() == (tmp_path / "j.obj").read_bytes()


def test_sharded_volume_is_not_ported():
    with pytest.raises(NotImplementedError, match="item 13"):
        tt.TSDFVolume(_bounds(), 0.25, 4.0, mesh=object(), device="cpu")


def test_cli_tsdf_chain(tmp_path, capsys, monkeypatch):
    d, out = str(tmp_path / "scene"), str(tmp_path / "run")
    with monkeypatch.context() as m:
        for mod in ("imageio", "imageio.v2", "PIL", "PIL.Image"):
            m.setitem(sys.modules, mod, None)
        assert cli.main(["make-synthetic", *CPU, "--out", d, "--n-views",
                         "4", "--width", "32", "--height", "32", "--hf-res",
                         "64", "--n-buildings", "2", "--scale", "10"]) == 0
        assert cli.main(["train", *CPU, "--scene-dir", d, "--iterations",
                         "10", "--model-path", out, "--tile-capacity", "256",
                         "--tile-chunk", "8"]) == 0
        assert cli.main(["render", *CPU, "--scene-dir", d, "--model-path",
                         out, "--tile-capacity", "256"]) == 0
        assert cli.main(["tsdf", *CPU, "--scene-dir", d, "--model-path", out,
                         "--vox-size", "0.5", "--export-mesh"]) == 0
        base = os.path.join(out, "test_opNone", "ours_10", "tsdf")
        capsys.readouterr()
        assert cli.main(["eval-dsm", *CPU, "--pred",
                         os.path.join(base, "dsm.tif"), "--gt-heightfield",
                         os.path.join(d, "gt_heightfield.npy"), "--scale",
                         "10"]) == 0
        mae = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert np.isfinite(mae["mae"])
        obj = open(os.path.join(base, "output_mesh.obj")).read().splitlines()
        assert sum(ln.startswith("f ") for ln in obj) > 100
        dsm_t, prof_t = read_geotiff(os.path.join(base, "dsm.tif"))

    # JAX's tsdf stage on the same altitude maps (it reads them with imageio)
    jout = str(tmp_path / "jax_tsdf")
    os.makedirs(os.path.join(jout, "point_cloud", "iteration_10"))
    os.symlink(os.path.join(out, "train_opNone"),
               os.path.join(jout, "train_opNone"))
    jt.run_tsdf_cli(argparse.Namespace(
        scene_dir=d, images_msi=None, images_pan=None, model_path=jout,
        iteration=-1, vox_size=0.5, trunc_margin_fact=4.0, export_mesh=True,
        n_devices=1))
    jbase = os.path.join(jout, "test_opNone", "ours_10", "tsdf")
    dsm_j, prof_j = jgeo.read_geotiff(os.path.join(jbase, "dsm.tif"))
    assert dsm_t.shape == dsm_j.shape and np.isfinite(dsm_t).mean() > 0.5
    assert repr(prof_t["transform"]) == repr(prof_j["transform"])
    np.testing.assert_array_equal(np.isnan(dsm_t), np.isnan(dsm_j))
    np.testing.assert_allclose(dsm_t, dsm_j, rtol=0, atol=1e-3)


def test_cli_full_eval(tmp_path, capsys, card_machine):
    d, out = str(tmp_path / "scene"), str(tmp_path / "run")
    assert cli.main(["make-synthetic", *CPU, "--out", d, "--n-views", "3",
                     "--width", "32", "--height", "32", "--hf-res", "64",
                     "--n-buildings", "1", "--scale", "8"]) == 0
    capsys.readouterr()
    assert cli.main(["full-eval", *CPU, "--scene-dir", d, "--model-path",
                     out, "--iterations", "5", "--tile-capacity", "256",
                     "--tile-chunk", "8", "--export-mesh"]) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith('{"stage"')]
    assert [ln["stage"] for ln in lines] == ["eval_dsm", "eval_dsm_tsdf"]
    assert all(np.isfinite(ln["mae"]) for ln in lines)
    base = os.path.join(out, "test_opNone", "ours_5", "tsdf")
    assert os.path.exists(os.path.join(base, "dsm.tif"))
    assert os.path.getsize(os.path.join(base, "output_mesh.obj")) > 0
