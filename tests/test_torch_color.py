"""The flow bake, the colour operations and the Trainer's calls of them in
eogs2_tpu_torch against eogs2_tpu's, both on the CPU: the 5x5 min pool
and the shadow reset mask, apply_color_reset with its Adam-moment
surgery, normalize_colors_before_saving, cc_train_to_test, and the
Trainer's apply_flowmatching_to_affine and color_reset on one 3PAN
(eogsplus) state.

JAX's Trainer methods run on a namespace that holds the state, the scene
and the config they read (no setup, so no kNN compile); JAX renders on
its gather route (plain jnp), the port on the fused route. Inputs are
made with numpy from fixed seeds. Tolerances: the masks exact; parameters,
Adam moments, colour corrections and the baked affines atol 1e-6.
"""

import os
import types

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from scipy.ndimage import fourier_shift

import eogs2_tpu.config as jconfig
from eogs2_tpu import color_ops as jco
from eogs2_tpu import train as jt
from eogs2_tpu.data.synthetic import generate_scene
from eogs2_tpu.model import GaussianAux, GaussianModel as JModel
from eogs2_tpu.model import GaussianParams
from eogs2_tpu.rasterizer import RasterizeConfig as JConfig
from eogs2_tpu.scene import load_scene as j_load
from eogs2_tpu.shading import CameraShadingParams as JShading
import eogs2_tpu_torch.config as tconfig
from eogs2_tpu_torch import color_ops as tco
from eogs2_tpu_torch import train as tt
from eogs2_tpu_torch.data.synthetic import make_scene_arrays, scene_from_arrays
from eogs2_tpu_torch.model import GaussianModel
from eogs2_tpu_torch.pipeline import render_view_full
from eogs2_tpu_torch.rasterizer import RasterizeConfig
from eogs2_tpu_torch.shading import CameraShadingParams

SCENE_KW = dict(n_views=4, width=64, height=64, hf_res=64, n_buildings=3,
                seed=5, scale=7.0)
FIELDS = ("xyz", "features_dc", "features_rest", "scaling", "rotation",
          "opacity")
AUX = ("alive", "max_radii2d", "xyz_gradient_accum", "denom")
SHADE = ("cc_weight", "cc_bias", "inshadow", "last_row", "exposure",
         "msi_to_pan_weight", "msi_to_pan_bias", "transient_mask")
ATOL = 1e-6
# the (dy, dx) shift of each train view's GT against the render, px
SHIFTS = ((1.3, -0.6), (-2.2, 0.4), (0.7, 1.8))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run this file's torch ops on one thread: beside the other test
    workers, torch's default pool (one thread per core) oversubscribes the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=ATOL, err_msg=what)


def _random_tree(rng, cap, alive_frac=0.9):
    q = rng.normal(size=(cap, 4))
    params = dict(
        xyz=rng.uniform(-0.9, 0.9, (cap, 3)),
        features_dc=rng.normal(size=(cap, 1, 3)),
        features_rest=np.zeros((cap, 0, 3)),
        scaling=rng.uniform(-4.5, -3.0, (cap, 3)),
        rotation=q / np.linalg.norm(q, axis=1, keepdims=True),
        opacity=rng.uniform(-1, 3, (cap, 1)))
    aux = dict(alive=rng.uniform(size=cap) < alive_frac,
               max_radii2d=np.zeros(cap), xyz_gradient_accum=np.zeros(cap),
               denom=np.zeros(cap))
    mu = {f: rng.normal(size=p.shape) for f, p in params.items()}
    nu = {f: rng.uniform(0.1, 1.0, size=p.shape) for f, p in params.items()}

    def f32(d):
        return {k: v if v.dtype == bool else v.astype(np.float32)
                for k, v in d.items()}

    return f32(params), f32(aux), f32(mu), f32(nu)


def _jax_model(params, aux):
    return JModel(params=GaussianParams(**{k: jnp.asarray(params[k])
                                           for k in FIELDS}),
                  aux=GaussianAux(**{k: jnp.asarray(aux[k]) for k in AUX}))


def _torch_model(params, aux, mu, nu, cfg, extent=1.0):
    model = GaussianModel.from_numpy(params, aux, device="cpu")
    opt = tt.gaussian_optimizer(model, cfg, extent)
    for f in FIELDS:
        opt.state[getattr(model, f)] = dict(
            step=torch.tensor(3.0), exp_avg=torch.from_numpy(mu[f].copy()),
            exp_avg_sq=torch.from_numpy(nu[f].copy()))
    return model, opt


def _check_model(jparams, jmu, jnu, model, opt):
    for f in FIELDS:
        p = getattr(model, f)
        _close(p.detach(), getattr(jparams, f), f)
        _close(opt.state[p]["exp_avg"], getattr(jmu, f), f"mu {f}")
        _close(opt.state[p]["exp_avg_sq"], getattr(jnu, f), f"nu {f}")


def _shading(rng, v):
    shade = dict(
        cc_weight=np.eye(3)[None] + 0.2 * rng.normal(size=(v, 3, 3)),
        cc_bias=0.1 * rng.normal(size=(v, 3)),
        inshadow=rng.uniform(0.05, 0.3, (v, 3)), last_row=np.zeros((v, 4)),
        exposure=np.tile(np.eye(3, 4)[None], (v, 1, 1)),
        msi_to_pan_weight=np.ones((v, 3)) / 3, msi_to_pan_bias=np.zeros(v),
        transient_mask=np.zeros((v, 1, 1)))
    return {k: np.asarray(x, np.float32) for k, x in shade.items()}


def test_shadow_reset_and_color_reset_match_jax():
    """min_pool_5x5, shadow_reset_mask over three views (about a third of
    the Gaussians in shadow everywhere, some outside a view), and
    apply_color_reset's parameters and zeroed moments."""
    rng = np.random.RandomState(0)
    maps = rng.uniform(0.6, 1.0, (3, 20, 24)).astype(np.float32)
    maps[:, 5:15, 6:18] *= 0.4  # a shadowed block in every view
    uvs = rng.uniform(-1.1, 1.1, (3, 400, 2)).astype(np.float32)
    uvs[:, :150] = rng.uniform(-0.4, 0.3, (3, 150, 2))
    _close(tco.min_pool_5x5(torch.from_numpy(maps[0])),
           jco.min_pool_5x5(jnp.asarray(maps[0])))
    want = np.asarray(jco.shadow_reset_mask(jnp.asarray(maps),
                                            jnp.asarray(uvs)))
    got = tco.shadow_reset_mask(torch.from_numpy(maps),
                                torch.from_numpy(uvs)).numpy()
    np.testing.assert_array_equal(got, want)
    assert 50 < want.sum() < 350
    params, aux, mu, nu = _random_tree(rng, 400)
    jm = _jax_model(params, aux)
    jp = lambda d: GaussianParams(**{k: jnp.asarray(d[k]) for k in FIELDS})
    jm2, jmu, jnu = jco.apply_color_reset(jm, jp(mu), jp(nu),
                                          jnp.asarray(want))
    model, opt = _torch_model(params, aux, mu, nu, tconfig.eogsplus())
    tco.apply_color_reset(model, opt, torch.from_numpy(got))
    _check_model(jm2.params, jmu, jnu, model, opt)
    reset = got & aux["alive"]
    assert 0 < reset.sum() < got.sum()
    assert np.all(opt.state[model.opacity]["exp_avg"].numpy()[reset] == 0)


@pytest.mark.parametrize("ref", [0, 2])
def test_normalize_colors_before_saving_matches_jax(ref):
    rng = np.random.RandomState(1)
    params, aux, _, _ = _random_tree(rng, 300)
    shade = _shading(rng, 4)
    jparams, jsh = jco.normalize_colors_before_saving(
        _jax_model(params, aux).params,
        JShading(**{k: jnp.asarray(v) for k, v in shade.items()}),
        reference_idx=ref)
    model = GaussianModel.from_numpy(params, aux, device="cpu")
    sh = CameraShadingParams.from_numpy(shade, device="cpu")
    tco.normalize_colors_before_saving(model, sh, reference_idx=ref)
    for f in FIELDS:
        _close(getattr(model, f).detach(), getattr(jparams, f), f)
    for f in SHADE:
        _close(getattr(sh, f), getattr(jsh, f), f)
    # the reference camera's correction becomes the identity
    _close(sh.cc_weight[ref], np.eye(3))
    _close(sh.cc_bias[ref], np.zeros(3))


def test_cc_train_to_test_matches_jax():
    rng = np.random.RandomState(2)
    shade = _shading(rng, 6)
    train_idx, test_idx = np.array([0, 1, 3, 4]), np.array([2, 5])
    for mode in ("average", "ref"):
        want = jco.cc_train_to_test(
            JShading(**{k: jnp.asarray(v) for k, v in shade.items()}),
            jnp.asarray(train_idx), jnp.asarray(test_idx), mode, 1)
        got = tco.cc_train_to_test(
            CameraShadingParams.from_numpy(shade, device="cpu"),
            torch.from_numpy(train_idx), torch.from_numpy(test_idx), mode, 1)
        for f in SHADE:
            _close(getattr(got, f), getattr(want, f), f"{mode} {f}")


# ---------------------------------------------------------------------------
# the Trainer's flow bake and colour reset on one 3PAN state
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def trainers(tmp_path_factory):
    """One eogsplus (3PAN) state in a JAX namespace and a port Trainer: the
    init cloud with seeded colours, opacities, scales and rotations, the
    Gaussians past 4/5 of the cloud moved out of every view, and seeded
    shading and Adam moments. Each train view's PAN GT is the port's render
    of that state shifted by a known sub-pixel amount (SHIFTS), so that the
    bake has a correlation peak to find, as on a trained model; both
    packages read the same GT."""
    d = str(tmp_path_factory.mktemp("ms"))
    generate_scene(d, modality="ms", **SCENE_KW)
    js = j_load(d, images_pan_path=os.path.join(d, "images_pan"),
                load_msi=False)
    ts = scene_from_arrays(make_scene_arrays(modality="ms", **SCENE_KW),
                           device="cpu", load_msi=False)
    ttr = tt.Trainer(tconfig.eogsplus(), ts,
                     RasterizeConfig(binning_mode="fused", tile_cull=True),
                     device="cpu").setup()
    params, aux = ttr.model.to_numpy()
    n = ttr.init_count
    rng = np.random.RandomState(3)
    op = rng.uniform(0.3, 0.95, n)
    params["opacity"][:n, 0] = np.log(op / (1 - op))
    params["features_dc"][:n, 0] = (rng.uniform(0, 1, (n, 3)) - 0.5) / 0.28209479
    params["scaling"][:n] += rng.normal(0, 0.3, (n, 3))
    q = rng.normal(0, 1, (n, 4))
    params["rotation"][:n] = q / np.linalg.norm(q, axis=1, keepdims=True)
    params["xyz"][4 * n // 5:n, 0] += 3.0  # outside every view
    mu = {f: rng.normal(size=p.shape).astype(np.float32)
          for f, p in params.items()}
    nu = {f: rng.uniform(0.1, 1, p.shape).astype(np.float32)
          for f, p in params.items()}
    shade = _shading(rng, len(ttr.modal_views[0][1]))
    ttr.model, ttr.gauss_opt = _torch_model(params, aux, mu, nu, ttr.cfg,
                                            ts.cameras_extent)
    ttr.shading = CameraShadingParams.from_numpy(shade, device="cpu")
    pan = [v for v in js.train_views if v.image_type == "pan"]
    for vi, (tv, jv) in enumerate(zip(ttr.modal_views[0][1], pan)):
        final = render_view_full(ttr.model, tv.camera, ttr.raster_cfg,
                                 shading=ttr.shading, view_idx=vi,
                                 pan_mode="identity")["final"]
        gray = final.astype(np.float64).mean(0)
        moved = np.fft.ifft2(fourier_shift(np.fft.fft2(gray), SHIFTS[vi]))
        tv.image = jv.image = moved.real.astype(np.float32)[None]
    jp = lambda tree: GaussianParams(**{k: jnp.asarray(tree[k])
                                        for k in FIELDS})
    jm = _jax_model(params, aux)
    jsh = JShading(**{k: jnp.asarray(v) for k, v in shade.items()})
    jtr = types.SimpleNamespace(
        cfg=jconfig.eogsplus(), scene=js, pan_mode="identity",
        raster_cfg=JConfig(binning_mode="gather", tile_capacity=1024,
                           max_tiles_per_gaussian=64),
        consts=jt.build_scene_tensors_from_views(pan, repeat_gt=True),
        state=jt.TrainState(
            params=jm.params, aux=jm.aux, shading=jsh,
            g_opt=optax.ScaleByAdamState(count=jnp.int32(3), mu=jp(mu),
                                         nu=jp(nu)),
            c_opt=None, step=jnp.int32(3)),
        _steps={})
    return jtr, ttr


def test_flow_bake_matches_jax(trainers):
    """apply_flowmatching_to_affine: every train view rendered with its PAN
    conversion, the phase-correlation shift against its (repeated) GT, the
    affines adjusted; the port's steps are rebuilt and read the new
    affines."""
    jtr, ttr = trainers
    before = ttr.consts.affines.clone()
    ttr._get_step(tt.Phase())
    jt.Trainer.apply_flowmatching_to_affine(jtr)
    ttr.apply_flowmatching_to_affine()
    want = np.asarray(jtr.consts.affines)
    _close(ttr.consts.affines, want)
    # the intercepts moved by the GT's shift, within the parabola fit's
    # sub-pixel bias (tests/test_torch_flow.py's 0.25 px)
    w = ttr.consts.native_wh[0]
    moved = (ttr.consts.affines - before)[:, :2, 3].numpy() * w / 2
    np.testing.assert_allclose(moved, np.asarray(SHIFTS)[:, ::-1], rtol=0,
                               atol=0.25)
    assert ttr._steps == {}
    assert ttr._modalities()[0][1] is ttr.consts


def test_color_reset_matches_jax(trainers):
    """color_reset: the shadow maps of every train view with its sun, the
    mask (the Gaussians outside every view among it) exactly, then the
    reset parameters and zeroed moments."""
    jtr, ttr = trainers
    jt.Trainer.color_reset(jtr)
    ttr.color_reset()
    st = jtr.state
    _check_model(st.params, st.g_opt.mu, st.g_opt.nu, ttr.model,
                 ttr.gauss_opt)
    reset = (ttr.model.scaling[:, 0] == float(np.log(np.float32(1 / 400))))
    n = ttr.init_count
    assert bool(reset[4 * n // 5:n][ttr.model.alive[4 * n // 5:n]].all())
    assert 0 < int(reset.sum()) < n
