"""DSM evaluation parity: the port's registration (its native C++ build and
the numpy copy that is its plain version), MaeComputer, GeoTIFF IO,
evaluate_dsm_mae and the SH evaluation against eogs2_tpu's, both on the
CPU.

Inputs are made with numpy from fixed seeds. Tolerances:
  * registration: integer shifts equal, (a, b) within 1e-9 (the native
    build's OpenMP reductions sum in another order than numpy's);
  * MaeComputer: MAE and diff within 1e-9 (float64 on the host);
  * evaluate_dsm_mae on one small model: MAE within 1e-3 m at scale 12,
    with equal shifts (the renders agree within the fused blend's 2e-4);
  * eval_sh and sh_to_clamped_rgb for degrees 0-3: within 1e-5.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

from eogs2_tpu import native as j_native
from eogs2_tpu import pipeline as jpipe
from eogs2_tpu.data.synthetic import generate_scene
from eogs2_tpu.eval import mae as jmae
from eogs2_tpu.eval import registration as jreg
from eogs2_tpu.io import geotiff as jgeo
from eogs2_tpu.model import init_from_points as j_init
from eogs2_tpu.ops import sh as jsh
from eogs2_tpu.rasterizer import RasterizeConfig as JConfig
from eogs2_tpu.scene import load_scene as j_load
from eogs2_tpu_torch import native as t_native
from eogs2_tpu_torch import pipeline as tpipe
from eogs2_tpu_torch.eval import mae as tmae
from eogs2_tpu_torch.eval import registration as treg
from eogs2_tpu_torch.io import geotiff as tgeo
from eogs2_tpu_torch.model import GaussianModel
from eogs2_tpu_torch.ops import sh as tsh
from eogs2_tpu_torch.rasterizer import RasterizeConfig as TConfig
from eogs2_tpu_torch.scene import load_scene as t_load

SCALE = 12.0


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run this file's torch ops on one thread: beside the other test
    workers, torch's default pool (one thread per core) oversubscribes the
    cores and its many small parallel regions slow the file down."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dsm_pair(seed, shape=(150, 140), shift=(2, -3), b=-0.7, holes=0.02):
    """A smooth DSM with NaN holes and a shifted, offset copy of it."""
    rng = np.random.RandomState(seed)
    base = gaussian_filter(rng.rand(*shape) * 12, 2)
    base[rng.rand(*shape) < holes] = np.nan
    return base, jreg.apply_shift(base, shift[0], shift[1], 1.0, b)


# ---------------------------------------------------------------------------
# registration
# ---------------------------------------------------------------------------


REG_CASES = [(7, (150, 140), (2, -3), False), (8, (130, 210), (-4, 1), True),
             (9, (90, 96), (1, 2), False)]


@pytest.mark.parametrize("seed,shape,shift,scaling", REG_CASES)
def test_compute_shift_matches_jax(seed, shape, shift, scaling):
    """Numpy and native, against JAX's numpy and native, at sizes that
    recurse once (a side above 100) or not, with NaN holes."""
    ref, sec = _dsm_pair(seed, shape, shift)
    want = jreg.compute_shift(ref, sec, scaling=scaling)
    assert want[:2] == (-shift[0], -shift[1])
    for got in (treg.compute_shift(ref, sec, scaling=scaling),
                t_native.compute_shift(ref, sec, scaling=scaling),
                j_native.compute_shift(ref, sec, scaling=scaling)):
        assert got[:2] == want[:2]
        np.testing.assert_allclose(got[2:], want[2:], rtol=0, atol=1e-9)


def test_apply_shift_matches_jax():
    ref, sec = _dsm_pair(10)
    args = (sec, 3, -2, 1.2, 0.4, 0.01, -0.02)
    want = jreg.apply_shift(*args)
    for got in (treg.apply_shift(*args), t_native.apply_shift(*args)):
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        ok = ~np.isnan(want)
        np.testing.assert_allclose(got[ok], want[ok], rtol=1e-12, atol=0)


def test_native_rejects_mismatched_dsms():
    ref, sec = _dsm_pair(11, (60, 50))
    with pytest.raises(ValueError, match="shapes differ"):
        t_native.compute_shift(ref, sec[:-1])
    with pytest.raises(ValueError, match="2-D"):
        t_native.apply_shift(ref[None])


def test_native_build_failure_raises(monkeypatch, tmp_path):
    """No fallback: when g++ fails (with and without -march=native), the
    loader raises with the compiler's output."""
    monkeypatch.setattr(t_native, "_lib", None)
    monkeypatch.setattr(t_native.cuda_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(t_native, "_gxx", lambda: "false")
    with pytest.raises(RuntimeError, match="did not build"):
        t_native.get_lib()
    assert t_native._lib is None and os.listdir(tmp_path) == []


# ---------------------------------------------------------------------------
# MaeComputer, GeoTIFF
# ---------------------------------------------------------------------------


def _synthetic_gt(tmp_path, seed=0, res=64):
    rng = np.random.RandomState(seed)
    z = gaussian_filter(rng.rand(res, res), 3).astype(np.float32)
    np.save(os.path.join(tmp_path, "gt_heightfield.npy"), z)
    return str(tmp_path)


def _prediction(mc, seed, res=0.5):
    """The GT DSM shifted by (1, -2) px and 0.3 m, with noise and NaN
    holes, on a grid (of `res` m) one pixel larger than the ROI on every
    side."""
    rng = np.random.RandomState(seed)
    gt = mc.gt_dsm
    pred = np.full((gt.shape[0] + 2, gt.shape[1] + 2), np.nan)
    pred[1:-1, 1:-1] = jreg.apply_shift(gt, 1, -2, 1.0, 0.3)
    pred += 0.05 * rng.normal(size=pred.shape)
    pred[rng.rand(*pred.shape) < 0.03] = np.nan
    t = jgeo.Affine.from_origin(mc.ulx - res, mc.uly + res, res, res)
    return pred, t


@pytest.mark.parametrize("resolution", [0.5, 0.3])
def test_mae_computer_from_synthetic_matches_jax(tmp_path, resolution):
    d = _synthetic_gt(tmp_path)
    jm = jmae.MaeComputer.from_synthetic(d, SCALE, resolution)
    tm = tmae.MaeComputer.from_synthetic(d, SCALE, resolution)
    np.testing.assert_array_equal(tm.gt_dsm, jm.gt_dsm)
    assert (tm.ulx, tm.uly, tm.lrx, tm.lry) == (jm.ulx, jm.uly, jm.lrx,
                                                jm.lry)
    pred, t = _prediction(jm, seed=1, res=resolution)
    tt_ = tgeo.Affine(t.a, t.b, t.c, t.d, t.e, t.f)
    np.testing.assert_array_equal(tm.crop_pred(pred, tt_),
                                  jm.crop_pred(pred, t))
    jmae_, jdiff, jr = jm.compute_mae(pred, t)
    tmae_, tdiff, tr = tm.compute_mae(pred, tt_)
    assert 0.0 < jmae_ < 0.2
    assert abs(tmae_ - jmae_) <= 1e-9
    for got, want in ((tdiff, jdiff), (tr, jr)):
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        np.testing.assert_allclose(got[~np.isnan(want)],
                                   want[~np.isnan(want)], rtol=0, atol=1e-9)


def test_mask_dsm_matches_jax():
    rng = np.random.RandomState(3)
    dsm = rng.rand(40, 30)
    water = rng.rand(44, 33) < 0.1
    vis = rng.rand(40, 30) < 0.1
    tree = rng.rand(38, 30) < 0.8
    np.testing.assert_array_equal(tmae.mask_dsm(dsm, water, vis, tree),
                                  jmae.mask_dsm(dsm, water, vis, tree))
    mc_t = tmae.MaeComputer(dsm, (0, 20, 15, 0), tree_mask=tree,
                            water_mask=water, vis_mask=vis, filter_tree=True)
    mc_j = jmae.MaeComputer(dsm, (0, 20, 15, 0), tree_mask=tree,
                            water_mask=water, vis_mask=vis, filter_tree=True)
    np.testing.assert_array_equal(mc_t.get_gt_dsm(True), mc_j.get_gt_dsm(True))


def test_mae_all_nan_raises():
    mc = tmae.MaeComputer(np.ones((20, 20)), (0.0, 10.0, 10.0, 0.0))
    with pytest.raises(ValueError, match="NaN"):
        mc.compute_mae(np.full((20, 20), np.nan),
                       tgeo.Affine.from_origin(0.0, 10.0, 0.5, 0.5))


def test_geotiff_and_mae_from_path_match_jax(tmp_path):
    """Each package reads what the other wrote; compute_mae_from_path and
    from_gt_dir agree."""
    d = _synthetic_gt(tmp_path)
    jm = jmae.MaeComputer.from_synthetic(d, SCALE)
    pred, t = _prediction(jm, seed=2)
    pred = pred.astype(np.float32)
    tt_ = tgeo.Affine(t.a, t.b, t.c, t.d, t.e, t.f)
    tgeo.write_geotiff(str(tmp_path / "t.tif"), pred, tt_)
    jgeo.write_geotiff(str(tmp_path / "j.tif"), pred, t)
    for name in ("t.tif", "j.tif"):
        ta, tp = tgeo.read_geotiff(str(tmp_path / name))
        ja, jp = jgeo.read_geotiff(str(tmp_path / name))
        np.testing.assert_array_equal(ta, ja)
        np.testing.assert_array_equal(ta, pred)
        assert repr(tp["transform"]) == repr(jp["transform"]) == repr(t)
    tm = tmae.MaeComputer.from_synthetic(d, SCALE)
    want = jm.compute_mae_from_path(str(tmp_path / "j.tif"))[0]
    assert abs(tm.compute_mae_from_path(str(tmp_path / "t.tif"))[0]
               - want) <= 1e-9
    # the reference layout: {aoi}_DSM.tif with its ROI file and a water class
    gt_dir = tmp_path / "gt"
    gt_dir.mkdir()
    gt = jm.gt_dsm.astype(np.float32)
    jgeo.write_geotiff(str(gt_dir / "AOI_DSM.tif"), gt,
                       jgeo.Affine.from_origin(-SCALE, SCALE, 0.5, 0.5))
    np.savetxt(str(gt_dir / "AOI_DSM.txt"),
               [-SCALE, -SCALE, gt.shape[0], 0.5])
    cls = np.zeros(gt.shape, np.uint8)
    cls[:5] = 9
    jgeo.write_geotiff(str(gt_dir / "AOI_CLS.tif"), cls)
    jd = jmae.MaeComputer.from_gt_dir(str(gt_dir), "AOI")
    td = tmae.MaeComputer.from_gt_dir(str(gt_dir), "AOI")
    np.testing.assert_array_equal(td.gt_dsm, jd.gt_dsm)
    assert np.isnan(td.gt_dsm[:5]).all()
    assert abs(td.compute_mae(pred, tt_)[0] - jd.compute_mae(pred, t)[0]) \
        <= 1e-9


# ---------------------------------------------------------------------------
# evaluate_dsm_mae on one small model
# ---------------------------------------------------------------------------

# JAX's gather route (plain jnp, quicker to compile on the CPU than its
# fused route in interpret mode) at capacities above the scene's Gaussian
# count, so it clips nothing; the port's fused route
JCFG = JConfig(binning_mode="gather", tile_capacity=1024,
               max_tiles_per_gaussian=64)
TCFG = TConfig(binning_mode="fused")


def _knn_dist2(xyz, k=3):
    d2 = ((xyz[:, None, :] - xyz[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    return np.sort(d2, axis=1)[:, :k].mean(1)


def test_evaluate_dsm_mae_matches_jax(tmp_path):
    d = str(tmp_path)
    generate_scene(d, n_views=4, width=64, height=64, hf_res=128,
                   n_buildings=4, seed=3, scale=SCALE)
    js = j_load(d, rescaler_name="identity")
    ts = t_load(d, device="cpu")
    xyz, rgb = ts.init_xyz, ts.init_rgb
    n = xyz.shape[0]
    d2 = 0.25 * _knn_dist2(xyz.astype(np.float64))
    jm = j_init(xyz, rgb, n + 8, mean_knn_dist2=d2)
    params = {f: np.array(getattr(jm.params, f)) for f in
              ("xyz", "features_dc", "features_rest", "scaling", "rotation",
               "opacity")}
    aux = {f: np.array(getattr(jm.aux, f)) for f in
           ("alive", "max_radii2d", "xyz_gradient_accum", "denom")}
    rng = np.random.RandomState(4)
    op = rng.uniform(0.3, 0.95, n)
    params["opacity"][:n, 0] = np.log(op / (1 - op))
    params["xyz"][:n, 2] += rng.normal(0, 0.02, n)  # a DSM off the truth
    jm = jm.replace(params=jm.params.replace(
        **{k: jnp.asarray(v) for k, v in params.items()}))
    tm = GaussianModel.from_numpy(params, aux, device="cpu")
    jmc = jmae.MaeComputer.from_synthetic(d, SCALE)
    tmc = tmae.MaeComputer.from_synthetic(d, SCALE)
    jmae_, jdsm, jdiff, _ = jpipe.evaluate_dsm_mae(jm, js, jmc, JCFG)
    tmae_, tdsm, tdiff, _ = tpipe.evaluate_dsm_mae(tm, ts, tmc, TCFG)
    assert np.isfinite(tmae_) and 0.05 < jmae_ < SCALE
    assert abs(tmae_ - jmae_) <= 1e-3
    assert tdsm.shape == jdsm.shape and tdiff.shape == jdiff.shape
    # equal shifts: each package's Nadir DSM registered onto the GT
    shifts = []
    for pipe, m, s, mc, cfg, reg in ((jpipe, jm, js, jmc, JCFG, j_native),
                                     (tpipe, tm, ts, tmc, TCFG, t_native)):
        prof, dsm, _ = pipe.nadir_dsm(m, s, cfg)
        pred = mc.crop_pred(dsm[:, :, 0].astype(np.float64),
                            prof["transform"])
        shifts.append(reg.compute_shift(mc.gt_dsm, pred, scaling=False)[:2])
    assert shifts[0] == shifts[1]


# ---------------------------------------------------------------------------
# SH
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("deg", [0, 1, 2, 3])
def test_eval_sh_matches_jax(deg):
    rng = np.random.RandomState(deg)
    sh = rng.normal(size=(64, 3, (deg + 1) ** 2)).astype(np.float32)
    means = rng.normal(size=(64, 3)).astype(np.float32)
    campos = np.float32([0.3, -2.0, 5.0])
    d = means - campos
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    np.testing.assert_allclose(
        tsh.eval_sh(deg, torch.from_numpy(sh), torch.from_numpy(d)).numpy(),
        np.asarray(jsh.eval_sh(deg, jnp.asarray(sh), jnp.asarray(d))),
        atol=1e-5, rtol=0)
    got = tsh.sh_to_clamped_rgb(deg, torch.from_numpy(sh),
                                torch.from_numpy(means),
                                torch.from_numpy(campos)).numpy()
    want = np.asarray(jsh.sh_to_clamped_rgb(deg, jnp.asarray(sh),
                                            jnp.asarray(means),
                                            jnp.asarray(campos)))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert (got == 0).any() and (got > 0).any()  # the clamp is exercised
    with pytest.raises(ValueError):
        tsh.eval_sh(4, torch.from_numpy(sh), torch.from_numpy(d))
