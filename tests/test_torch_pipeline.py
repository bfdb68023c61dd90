"""Serving-path parity: the port's render_view_full and nadir_dsm against
eogs2_tpu's on one synthetic scene, both on the CPU.

The scene directory comes from eogs2_tpu.data.synthetic.generate_scene and
is loaded by both packages; the model is built by each package's
init_from_points from the same numpy points and kNN distances, then given
the same seeded numpy parameters (carried across with
GaussianModel.from_numpy). Renders agree within atol 2e-4 (the fused
blend's tolerance, tests/test_golden.py), and the DSM built from the same
(u, v, altitude) grid is the same array, NaNs included (both are float64
numpy on the host).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eogs2_tpu import pipeline as jpipe
from eogs2_tpu.data.synthetic import generate_scene
from eogs2_tpu.eval.dsm import compute_dsm_from_view as j_dsm
from eogs2_tpu.model import init_from_points as j_init
from eogs2_tpu.rasterizer import RasterizeConfig as JConfig
from eogs2_tpu.scene import load_scene as j_load
from eogs2_tpu.shading import CameraShadingParams as JShading
from eogs2_tpu.shading import init_shading_params as j_init_shading
from eogs2_tpu_torch import pipeline as tpipe
from eogs2_tpu_torch.eval.dsm import compute_dsm_from_view as t_dsm
from eogs2_tpu_torch.model import GaussianModel
from eogs2_tpu_torch.model import init_from_points as t_init
from eogs2_tpu_torch.rasterizer import RasterizeConfig as TConfig
from eogs2_tpu_torch.scene import load_scene as t_load
from eogs2_tpu_torch.shading import CameraShadingParams as TShading
from eogs2_tpu_torch.shading import init_shading_params as t_init_shading

ATOL = 2e-4
# capacities cover this scene, so the JAX route clips nothing
JCFG = JConfig(binning_mode="fused", eogs_features=True, tile_capacity=2048,
               max_tiles_per_gaussian=64)
TCFG = TConfig(binning_mode="fused", eogs_features=True)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run this file's torch ops on one thread: beside the other test
    workers, torch's default pool (one thread per core) oversubscribes the
    cores and its many small parallel regions slow the file down."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _knn_dist2(xyz, k=3):
    d2 = ((xyz[:, None, :] - xyz[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    return np.sort(d2, axis=1)[:, :k].mean(1)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("scene"))
    generate_scene(d, n_views=4, width=64, height=64, hf_res=128,
                   n_buildings=4, seed=0, scale=8.0)
    js = j_load(d, rescaler_name="identity")
    ts = t_load(d, device="cpu")
    xyz, rgb = ts.init_xyz, ts.init_rgb
    d2 = 0.25 * _knn_dist2(xyz.astype(np.float64))
    cap = xyz.shape[0] + 8
    jm = j_init(xyz, rgb, cap, mean_knn_dist2=d2)
    tm = t_init(xyz, rgb, cap, mean_knn_dist2=d2, device="cpu")

    rng = np.random.RandomState(1)
    n = xyz.shape[0]
    params, aux = tm.to_numpy()
    op = rng.uniform(0.2, 0.9, n)
    params["opacity"][:n, 0] = np.log(op / (1 - op))
    params["features_dc"][:n, 0] = (rng.uniform(0, 1, (n, 3)) - 0.5) / 0.28209479
    params["scaling"][:n] += rng.normal(0, 0.3, (n, 3))
    q = rng.normal(0, 1, (n, 4))
    params["rotation"][:n] = q / np.linalg.norm(q, axis=1, keepdims=True)
    jm2 = jm.replace(params=jm.params.replace(
        **{k: jnp.asarray(v) for k, v in params.items()}))
    tm2 = GaussianModel.from_numpy(params, aux, device="cpu")

    shade = dict(
        cc_weight=np.eye(3)[None] + 0.1 * rng.normal(size=(1, 3, 3)),
        cc_bias=0.05 * rng.normal(size=(1, 3)),
        inshadow=rng.uniform(0.05, 0.3, (1, 3)),
        last_row=np.zeros((1, 4)),
        exposure=np.eye(3, 4)[None],
        msi_to_pan_weight=rng.uniform(0.2, 0.5, (1, 3)),
        msi_to_pan_bias=0.01 * rng.normal(size=1),
    )
    jsh = JShading(**{k: jnp.asarray(v, jnp.float32) for k, v in shade.items()})
    tsh = TShading.from_numpy(shade, device="cpu")
    return dict(js=js, ts=ts, jm=jm, tm=tm, jm2=jm2, tm2=tm2, jsh=jsh,
                tsh=tsh)


def test_scene_and_model_carry_across(setup):
    js, ts, jm, tm = setup["js"], setup["ts"], setup["jm"], setup["tm"]
    assert [v.name for v in ts.train_views] == [v.name for v in js.train_views]
    assert [v.name for v in ts.test_views] == [v.name for v in js.test_views]
    np.testing.assert_array_equal(ts.init_xyz, js.init_xyz)
    np.testing.assert_array_equal(ts.scene_shift, js.scene_shift)
    assert ts.scene_scale == js.scene_scale
    for tv, jv in zip(ts.train_views + ts.test_views,
                      js.train_views + js.test_views):
        for f in ("affine", "sun_affine", "camera_to_sun", "altitude_bounds",
                  "centerofscene"):
            np.testing.assert_array_equal(getattr(tv.camera, f).numpy(),
                                          np.asarray(getattr(jv.camera, f)))
        assert (tv.camera.width, tv.camera.height, tv.camera.has_sun) == (
            jv.camera.width, jv.camera.height, jv.camera.has_sun)
    params, aux = tm.to_numpy()
    for f, v in params.items():
        np.testing.assert_allclose(v, np.asarray(getattr(jm.params, f)),
                                   rtol=1e-6, err_msg=f)
    for f, v in aux.items():
        np.testing.assert_array_equal(v, np.asarray(getattr(jm.aux, f)))
    back = GaussianModel.from_numpy(params, aux, device="cpu").to_numpy()
    for f in params:
        np.testing.assert_array_equal(back[0][f], params[f])
    for f in ("get_scaling", "get_opacity", "get_rgb"):
        np.testing.assert_allclose(getattr(tm, f)().detach().numpy(),
                                   np.asarray(getattr(jm, f)()), rtol=1e-6,
                                   atol=1e-7, err_msg=f)


def test_init_shading_params_match():
    j, t = j_init_shading(3, (5, 4)), t_init_shading(3, (5, 4), device="cpu")
    for f in ("cc_weight", "cc_bias", "inshadow", "last_row", "exposure",
              "msi_to_pan_weight", "msi_to_pan_bias", "transient_mask"):
        np.testing.assert_array_equal(getattr(t, f).numpy(),
                                      np.asarray(getattr(j, f)), err_msg=f)


@pytest.mark.parametrize("method", ["sun", "nadir", "resize", "last_row",
                                    "uv_grid", "uva"])
def test_camera_derivations_match(setup, method):
    jc = setup["js"].train_views[1].camera
    tc = setup["ts"].train_views[1].camera
    if method == "sun":
        (j, jm), (t, tm) = jc.sun_camera(2), tc.sun_camera(2)
        np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-6)
        assert (t.width, t.height) == (j.width, j.height)
    elif method == "nadir":
        (j, jm), (t, tm) = jc.nadir_camera(), tc.nadir_camera()
        np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-6)
    elif method == "resize":
        j, t = jc.resize_canvas(80, 96), tc.resize_canvas(80, 96)
        assert (t.width, t.height) == (80, 96)
    elif method == "last_row":
        r = np.float32([0.01, -0.02, 0.03, 0.5])
        j, t = jc.apply_last_row(jnp.asarray(r)), tc.apply_last_row(
            torch.from_numpy(r))
    elif method == "uv_grid":
        # the two linspace implementations round differently by an ulp
        np.testing.assert_allclose(tc.uv_grid().numpy(),
                                   np.asarray(jc.uv_grid()), atol=1e-6)
        return
    else:
        uva = np.random.RandomState(0).uniform(-1, 1, (10, 3)).astype(
            np.float32)
        xyz = tc.uva_to_ecef(torch.from_numpy(uva))
        np.testing.assert_allclose(xyz.numpy(),
                                   np.asarray(jc.uva_to_ecef(uva)),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(tc.ecef_to_uva(xyz).numpy(), uva,
                                   atol=1e-5)
        return
    np.testing.assert_allclose(t.affine.numpy(), np.asarray(j.affine),
                               rtol=1e-6, atol=1e-7)


def _compare_renders(tout, jout):
    assert set(tout) == set(jout)
    for k, want in jout.items():
        got = tout[k]
        if want is None:
            assert got is None, k
            continue
        assert got.shape == np.asarray(want).shape, k
        np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=0,
                                   err_msg=k)


def test_render_view_full_matches_jax(setup):
    jv = setup["js"].train_views[0]
    tv = setup["ts"].train_views[0]
    assert tv.camera.has_sun
    jout = jpipe.render_view_full(setup["jm2"], jv.camera, JCFG,
                                  shading=setup["jsh"], pan_mode="learned")
    tout = tpipe.render_view_full(setup["tm2"], tv.camera, TCFG,
                                  shading=setup["tsh"], pan_mode="learned")
    _compare_renders(tout, jout)
    assert tout["shadowmap"] is not None
    assert tout["final"].shape == (1, 64, 64)
    # the render is not trivial: splats cover the view
    assert tout["acc_opacity"].mean() > 0.5


def test_nadir_dsm_matches_jax(setup):
    jprof, jdsm, jout = jpipe.nadir_dsm(setup["jm2"], setup["js"], JCFG)
    tprof, tdsm, tout = tpipe.nadir_dsm(setup["tm2"], setup["ts"], TCFG)
    _compare_renders(tout, jout)
    assert tdsm.shape[2] == 1 and np.isfinite(tdsm).mean() > 0.9
    # the same (u, v, altitude) grid gives the same DSM, NaNs included
    uva = jout["rendered_uva"]
    jcam = [v for v in setup["js"].test_views if "Nadir" in v.name][0].camera
    tcam = [v for v in setup["ts"].test_views if "Nadir" in v.name][0].camera
    jp, jd = j_dsm(jcam, uva, setup["js"].scene_shift, setup["js"].scene_scale)
    tp, td = t_dsm(tcam, uva, setup["ts"].scene_shift, setup["ts"].scene_scale)
    np.testing.assert_array_equal(td, jd)
    assert repr(tp["transform"]) == repr(jp["transform"])
    assert (tp["height"], tp["width"]) == (jp["height"], jp["width"])


def test_renderer_matches_jax(setup):
    """renderer.render, rendered_uva_grid and the sun camera's
    render_resample_virtual_camera, the pieces render_view_full builds on."""
    from eogs2_tpu import renderer as jr
    from eogs2_tpu_torch import renderer as tr

    jcam = setup["js"].train_views[0].camera
    tcam = setup["ts"].train_views[0].camera
    bg = np.float32([0.2, 0.4, 0.6, -0.35, 0.0])
    jo = jr.render(setup["jm2"], jcam, jnp.asarray(bg), JCFG)
    to = tr.render(setup["tm2"], tcam, torch.from_numpy(bg), TCFG)
    for k in ("raw_render", "altitude", "acc_opacity"):
        np.testing.assert_allclose(to[k].detach().numpy(), np.asarray(jo[k]),
                                   atol=ATOL, rtol=0, err_msg=k)
    juva = jr.rendered_uva_grid(jcam, jo["altitude"])
    tuva = tr.rendered_uva_grid(tcam, to["altitude"].detach())
    np.testing.assert_allclose(tuva.numpy(), np.asarray(juva), atol=ATOL)
    np.testing.assert_allclose(
        tr.rendered_uva_grid(tcam, to["altitude"].detach(), 64, 64).numpy(),
        tuva.numpy(), atol=1e-6)
    (jsun, jc2s), (tsun, tc2s) = jcam.sun_camera(2), tcam.sun_camera(2)
    jres = jr.render_resample_virtual_camera(setup["jm2"], jsun, jc2s, juva,
                                             jnp.asarray(bg), JCFG)
    tres = tr.render_resample_virtual_camera(setup["tm2"], tsun, tc2s, tuva,
                                             torch.from_numpy(bg), TCFG)
    for name, got, want in zip(("rgb", "altitude", "uv", "render"), tres,
                               jres):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=ATOL, rtol=0, err_msg=name)
