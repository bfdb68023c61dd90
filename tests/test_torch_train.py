"""Training-slice parity: eogs2_tpu_torch's losses, SSIM, kNN, cameras,
config, gates, synthetic scene, densification statistics, Adam and one
whole training step against eogs2_tpu's, both on the CPU (the port's
kernels run their plain versions there; JAX runs its fused route with the
Pallas kernels in interpret mode, as its own tests do).

Inputs are made with numpy from fixed seeds and handed to both packages;
JAX's random draws (background, random camera) are computed from its key
and fed to the port's step. Tolerances:
  * losses against tests/golden/losses1.npz: rel 2e-5 (test_golden_losses's);
  * losses and SSIM against JAX: rel 4e-5 (each package lies within 2e-5
    of the float64 golden, possibly on opposite sides: SSIM's convolutions
    sum in another order);
  * one step: loss terms rel 1e-4, gradients max-normalised 2e-4 (the
    rasterizer's gradient tolerance, tests/test_golden.py), densification
    statistics rel 2e-4, integer statistics exact;
  * kNN: rel 1e-5; cameras and config: exact or float32 round-off;
  * Adam: updates rel 5e-5 (the same formula; optax rounds b2 = 0.999 and
    its bias corrections to float32, about 1.3e-5 off, torch keeps them in
    float64).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import eogs2_tpu.config as jconfig
import eogs2_tpu.losses as JL
from eogs2_tpu import train as jt
from eogs2_tpu.cameras import AffineCamera as JCamera
from eogs2_tpu.data.synthetic import generate_scene
from eogs2_tpu.densify import prune_transparent as j_prune
from eogs2_tpu.model import GaussianAux, GaussianModel as JModel
from eogs2_tpu.model import GaussianParams
from eogs2_tpu.model import add_densification_stats as j_stats
from eogs2_tpu.model import init_from_points as j_init
from eogs2_tpu.ops.knn import mean_knn_dist2 as j_knn
from eogs2_tpu.ops.ssim import ssim as j_ssim
from eogs2_tpu.rasterizer import RasterizeConfig as JConfig
from eogs2_tpu.scene import load_scene as j_load
from eogs2_tpu.shading import CameraShadingParams as JShading
import eogs2_tpu_torch.config as tconfig
import eogs2_tpu_torch.losses as TL
from eogs2_tpu_torch import train as tt
from eogs2_tpu_torch.cameras import camera_from_reference_convention
from eogs2_tpu_torch.data.synthetic import (make_scene_arrays,
                                            scene_from_arrays, write_scene)
from eogs2_tpu_torch.densify import prune_transparent as t_prune
from eogs2_tpu_torch.model import GaussianModel
from eogs2_tpu_torch.model import add_densification_stats as t_stats
from eogs2_tpu_torch.model import init_from_points as t_init
from eogs2_tpu_torch.ops.knn import mean_knn_dist2 as t_knn
from eogs2_tpu_torch.ops.ssim import ssim as t_ssim
from eogs2_tpu_torch.rasterizer import RasterizeConfig
from eogs2_tpu_torch.scene import load_scene as t_load
from eogs2_tpu_torch.shading import CameraShadingParams

SCENE_KW = dict(n_views=4, width=64, height=64, hf_res=128, n_buildings=4,
                seed=0, scale=12.0)
LOSSES = os.path.join(os.path.dirname(__file__), "golden", "losses1.npz")
PRESETS = ("baseogs", "eogsplus", "learnwv", "optical_flow")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run this file's torch ops on one thread: beside the other test
    workers, torch's default pool (one thread per core) oversubscribes the
    cores and its many small parallel regions slow the file down."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.array(x))


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


# ---------------------------------------------------------------------------
# scene, config, gates
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """The same synthetic scene through JAX (written, then loaded) and
    through the port (built in memory)."""
    d = str(tmp_path_factory.mktemp("scene"))
    generate_scene(d, **SCENE_KW)
    js = j_load(d, images_msi_path=os.path.join(d, "images"), load_pan=False)
    ts = scene_from_arrays(make_scene_arrays(**SCENE_KW), device="cpu")
    return d, js, ts


def test_synthetic_scene_matches_jax(scenes):
    _, js, ts = scenes
    np.testing.assert_array_equal(ts.init_xyz, js.init_xyz)
    np.testing.assert_array_equal(ts.init_rgb, js.init_rgb)
    assert ts.cameras_extent == js.cameras_extent
    for split in ("train_views", "test_views"):
        jv, tv = getattr(js, split), getattr(ts, split)
        assert [v.name for v in tv] == [v.name for v in jv]
        for a, b in zip(tv, jv):
            assert (a.is_virtual, a.is_reference) == (b.is_virtual,
                                                      b.is_reference)
            if b.image is None:
                assert a.image is None
            else:
                np.testing.assert_array_equal(a.image, b.image)
            for f in ("affine", "sun_affine", "camera_to_sun",
                      "altitude_bounds", "centerofscene"):
                np.testing.assert_array_equal(
                    getattr(a.camera, f).numpy(), np.asarray(getattr(b.camera, f)))
            assert (a.camera.width, a.camera.height) == (b.camera.width,
                                                         b.camera.height)


def test_written_scene_loads_back(scenes, tmp_path):
    """write_scene + load_scene gives the scene built in memory."""
    d, _, ts = scenes
    write_scene(make_scene_arrays(**SCENE_KW), str(tmp_path))
    for path in (d, str(tmp_path)):
        ls = t_load(path, images_msi_path=os.path.join(path, "images"),
                    load_pan=False, device="cpu")
        for a, b in zip(ls.train_views + ls.test_views,
                        ts.train_views + ts.test_views):
            assert a.name == b.name
            if b.image is not None:
                np.testing.assert_array_equal(a.image, b.image)


@pytest.mark.parametrize("preset", PRESETS)
def test_config_presets_match(preset):
    want = dataclasses.asdict(jconfig.PRESETS[preset]("scene", 1234))
    got = dataclasses.asdict(tconfig.PRESETS[preset]("scene", 1234))
    assert got == want
    assert dataclasses.asdict(tconfig.TrainConfig()) == \
        dataclasses.asdict(jconfig.TrainConfig())


@pytest.mark.parametrize("preset", PRESETS)
def test_gates_and_phases_match(preset):
    jc = jconfig.PRESETS[preset]("", 40_000)
    tc = tconfig.PRESETS[preset]("", 40_000)
    o = jc.optimization
    edges = {o.iterstart_shadowmapping, o.iterstart_L_new_resample,
             o.iterstart_flowmatching, o.iterstart_learn_wv_transform,
             o.iterstart_learn_msitopan_params}
    its = sorted(set(range(0, 6000, 97)) | {e + d for e in edges
                                             for d in (-1, 0, 1)})
    for it in its:
        assert tt.make_gates(tc, it, 777) == jt.make_gates(jc, it, 777), it
        assert tuple(tt.phase_for_iteration(tc, it)) == \
            tuple(jt.phase_for_iteration(jc, it)), it


# ---------------------------------------------------------------------------
# kNN, init, random camera, densification statistics, pruning
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [300, 5000])
def test_knn_matches_jax(n):
    """n=300 takes the exact path, n=5000 the Morton-windowed one."""
    pts = np.random.RandomState(n).uniform(-1, 1, (n, 3)).astype(np.float32)
    want = np.asarray(j_knn(jnp.asarray(pts)))
    got = t_knn(torch.from_numpy(pts)).numpy()
    assert _rel(got, want) < 1e-5


def test_init_from_points_computes_knn():
    rng = np.random.RandomState(4)
    xyz = rng.uniform(-1, 1, (400, 3)).astype(np.float32)
    rgb = np.full((400, 3), 1.1, np.float32)
    jm = j_init(xyz, rgb, 512, opacity_init_value=0.05)
    tm = t_init(xyz, rgb, 512, opacity_init_value=0.05, device="cpu")
    params, aux = tm.to_numpy()
    for f, x in params.items():
        np.testing.assert_allclose(x, np.asarray(getattr(jm.params, f)),
                                   rtol=1e-5, atol=1e-6, err_msg=f)
    np.testing.assert_array_equal(aux["alive"], np.asarray(jm.aux.alive))


def test_random_camera_matches_jax():
    coef = [[1.0, 0.02, -0.2], [0.01, 1.0, 0.1], [0.0, 0.0, 1.0]]
    inter = [0.05, -0.03, 0.0]
    tcam = camera_from_reference_convention(coef, inter, width=64, height=64,
                                            centerofscene=(0.1, -0.2, 0.05),
                                            device="cpu")
    jcam = JCamera(affine=jnp.asarray(tcam.affine.numpy()),
                   sun_affine=jnp.zeros((3, 4)), camera_to_sun=jnp.eye(3),
                   altitude_bounds=jnp.asarray([0.0, 1.0]),
                   centerofscene=jnp.asarray([0.1, -0.2, 0.05]),
                   width=64, height=64)
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        draw = np.asarray(jax.random.normal(key, (2,)))
        jc, jm = jcam.random_camera(key, 0.5)
        tc, tm = tcam.random_camera(torch.from_numpy(draw), 0.5)
        np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=1e-7)
        np.testing.assert_allclose(tc.affine.numpy(), np.asarray(jc.affine),
                                   atol=1e-6)


def _models(n=300, seed=0):
    rng = np.random.RandomState(seed)
    params = dict(xyz=rng.normal(size=(n, 3)),
                  features_dc=rng.normal(size=(n, 1, 3)),
                  features_rest=np.zeros((n, 0, 3)),
                  scaling=rng.normal(size=(n, 3)),
                  rotation=rng.normal(size=(n, 4)),
                  opacity=rng.uniform(-8, 2, (n, 1)))
    aux = dict(alive=rng.uniform(size=n) < 0.8,
               max_radii2d=rng.uniform(0, 5, n),
               xyz_gradient_accum=rng.uniform(0, 1, n),
               denom=rng.randint(0, 5, n).astype(float))
    params = {k: np.asarray(v, np.float32) for k, v in params.items()}
    aux = {k: (v if k == "alive" else np.asarray(v, np.float32))
           for k, v in aux.items()}
    jm = JModel(params=GaussianParams(**{k: jnp.asarray(v)
                                         for k, v in params.items()}),
                aux=GaussianAux(**{k: jnp.asarray(v) for k, v in aux.items()}))
    return jm, GaussianModel.from_numpy(params, aux, device="cpu"), rng


def test_densification_stats_match_jax():
    jm, tm, rng = _models()
    grad = rng.normal(size=(300, 2)).astype(np.float32)
    radii = rng.randint(-1, 6, 300).astype(np.int32)
    jm = j_stats(jm, jnp.asarray(grad), jnp.asarray(radii))
    t_stats(tm, torch.from_numpy(grad), torch.from_numpy(radii))
    for f in ("xyz_gradient_accum", "denom", "max_radii2d"):
        np.testing.assert_allclose(getattr(tm, f).numpy(),
                                   np.asarray(getattr(jm.aux, f)), rtol=1e-6)


def test_prune_transparent_matches_jax():
    jm, tm, _ = _models()
    jm = j_prune(jm, -6.0)
    t_prune(tm, -6.0)
    np.testing.assert_array_equal(tm.alive.numpy(), np.asarray(jm.aux.alive))
    assert 0 < int(tm.alive.sum()) < 300


# ---------------------------------------------------------------------------
# losses and SSIM
# ---------------------------------------------------------------------------


def _golden_losses():
    g = np.load(LOSSES)
    j = {k: jnp.asarray(g[k]) for k in g.files}
    t = {k: torch.from_numpy(np.array(g[k])) for k in g.files}
    n_init = float(g["n_init"])

    def both(L, x, ssim):
        alive = x["opacity"] > -1  # all True, in either framework
        sa, sr = L.suncamera_loss(x["image"], x["sun_rgb"], x["sun_diff"],
                                  x["sun_uv"])
        ra, rr = L.randomcam_loss(x["altitude"], x["new_alt"], x["image"],
                                  x["new_rgb"], x["new_uv"])
        return {
            "ssim": ssim(x["image"], x["gt"]),
            "l1": L.l1_loss(x["image"], x["gt"]),
            "photometric": L.photometric_loss(x["image"], x["gt"], 0.2)[0],
            "opacity_loss": L.opacity_loss(x["opacity"], alive, n_init),
            "radii_opacity": L.radii_opacity_loss(x["opacity"], x["radii"],
                                                  n_init),
            "acc_opacity": L.accumulated_opacity_loss(1.0 - (1.0 - x["acc"])),
            "translucent": L.translucent_shadows_loss(x["shadowmap"]),
            "tv_altitude": L.tv_altitude_loss(x["altitude"]),
            "erank": L.erank_loss(x["scaling"], alive),
            "sun_alt": sa, "sun_rgb_loss": sr,
            "rand_alt": ra, "rand_rgb_loss": rr,
            "nll": L.transient_nll_loss(x["image"], x["gt"], x["transient"]),
        }

    return g, both(TL, t, t_ssim), both(JL, j, j_ssim)


GOLDEN_LOSS_NAMES = ("ssim", "l1", "photometric", "opacity_loss",
                     "radii_opacity", "acc_opacity", "translucent",
                     "tv_altitude", "erank", "sun_alt", "sun_rgb_loss",
                     "rand_alt", "rand_rgb_loss", "nll")


@pytest.fixture(scope="module")
def golden_losses():
    return _golden_losses()


@pytest.mark.parametrize("name", GOLDEN_LOSS_NAMES)
def test_losses_match_golden_and_jax(golden_losses, name):
    g, got, jax_val = golden_losses
    want = float(g[name])
    assert abs(float(got[name]) - want) / (abs(want) + 1e-12) < 2e-5
    assert abs(float(got[name]) - float(jax_val[name])) / \
        (abs(float(jax_val[name])) + 1e-12) < 4e-5


def test_masked_losses_match_jax():
    """The masked variants the step uses, on a padded canvas."""
    rng = np.random.RandomState(5)
    h, w = 40, 56
    img = rng.uniform(0, 1, (3, h, w)).astype(np.float32)
    gt = rng.uniform(0, 1, (3, h, w)).astype(np.float32)
    mask = np.zeros((1, h, w), np.float32)
    mask[:, :33, :47] = 1.0
    tm = rng.uniform(-0.2, 1.2, (h, w)).astype(np.float32)
    shadow = rng.uniform(0, 1, (h, w)).astype(np.float32)
    args = (img, gt, mask, tm, shadow)

    def run(L, ssim, img, gt, mask, tm, shadow):
        return [ssim(img, gt, mask=mask), *L.photometric_loss(img, gt, 0.2,
                                                              mask=mask),
                L.transient_nll_loss(img, gt, tm, mask=mask),
                L.translucent_shadows_loss(shadow, mask[0]),
                L.accumulated_opacity_loss(shadow, mask[0])]

    got = run(TL, t_ssim, *map(_t, args))
    want = run(JL, j_ssim, *map(jnp.asarray, args))
    for a, b in zip(got, want):
        assert abs(float(a) - float(b)) / (abs(float(b)) + 1e-12) < 4e-5


# ---------------------------------------------------------------------------
# Adam
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("eps", [1e-15, 1e-8])
def test_adam_matches_optax(eps):
    """torch.optim.Adam and optax.scale_by_adam fed the same gradients give
    the same updates (compared as updates, not as signs of a first step)."""
    rng = np.random.RandomState(0)
    p0 = rng.normal(size=(64, 3)).astype(np.float32)
    lr = 0.01
    p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = torch.optim.Adam([p], lr=lr, betas=(0.9, 0.999), eps=eps)
    tx = optax.scale_by_adam(b1=0.9, b2=0.999, eps=eps)
    st = tx.init(jnp.asarray(p0))
    for i in range(5):
        g = (rng.normal(size=p0.shape) * 10.0 ** rng.uniform(-6, 1, p0.shape)
             ).astype(np.float32)
        with torch.no_grad():  # Adam's state does not depend on p: start
            p.zero_()  # each step from 0, so p is the update itself
        p.grad = torch.from_numpy(g)
        opt.step()
        u, st = tx.update(jnp.asarray(g), st)
        np.testing.assert_allclose(p.detach().numpy(), -lr * np.asarray(u),
                                   rtol=5e-5, atol=0)


# ---------------------------------------------------------------------------
# one training step, and the Trainer
# ---------------------------------------------------------------------------


def _one_step_cfg(cfg):
    """Every term of the step switched on, so each is compared, and the
    learnable pose residual (last_row) with its gradient gate open."""
    cfg.model.camera_params.learn_wv_transform = True
    o = cfg.optimization
    for it in ("iterstart_shadowmapping", "iterstart_L_new_resample",
               "iterstart_learn_wv_transform",
               "iterstart_L_sun_resample", "iterstart_L_TV_altitude",
               "iterstart_L_erank", "iterstart_L_accumulated_opacity",
               "iterstart_L_nll", "iterstart_L_opacity_radii"):
        setattr(o, it, 0)
    for w in ("w_L_TV_altitude", "w_L_erank", "w_L_accumulated_opacity",
              "w_L_nll", "w_L_opacity_radii"):
        setattr(o, w, 0.002)
    return cfg


def _one_step(scenes, jraster, traster):
    """One step of each package from the same state, on the same view,
    with JAX's draws; JAX's gradients come back as the optimizer state of
    an optax transformation that stores them, the port's stay in .grad
    (its Adam runs at lr 0)."""
    _, js, ts = scenes
    n = len(js.init_xyz)
    cap = ((int(n * 1.25) + 127) // 128) * 128
    jm = j_init(js.init_xyz, js.init_rgb, cap)
    rng = np.random.RandomState(1)
    params = {f: np.array(getattr(jm.params, f)) for f in GaussianParams.__dataclass_fields__}
    op = rng.uniform(0.2, 0.9, n)
    params["opacity"][:n, 0] = np.log(op / (1 - op))
    params["features_dc"][:n, 0] = (rng.uniform(0, 1, (n, 3)) - 0.5) / 0.28209479
    params["scaling"][:n] += rng.normal(0, 0.3, (n, 3)) - 0.7
    q = rng.normal(0, 1, (n, 4))
    params["rotation"][:n] = q / np.linalg.norm(q, axis=1, keepdims=True)
    aux = {f: np.array(getattr(jm.aux, f)) for f in GaussianAux.__dataclass_fields__}
    v = len(js.train_views)
    shade = dict(
        cc_weight=np.eye(3)[None] + 0.1 * rng.normal(size=(v, 3, 3)),
        cc_bias=0.05 * rng.normal(size=(v, 3)),
        inshadow=rng.uniform(0.05, 0.3, (v, 3)), last_row=np.zeros((v, 4)),
        exposure=np.tile(np.eye(3, 4)[None], (v, 1, 1)),
        msi_to_pan_weight=np.ones((v, 3)) / 3, msi_to_pan_bias=np.zeros(v),
        transient_mask=rng.uniform(0.0, 0.3, (v, 1, 1)))
    shade = {k: np.asarray(x, np.float32) for k, x in shade.items()}
    jc = _one_step_cfg(jconfig.baseogs(iterations=10))
    tc = _one_step_cfg(tconfig.baseogs(iterations=10))
    iteration, view = 5, 1

    store = optax.GradientTransformation(
        lambda p: p, lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))
    jstep = jt.make_train_step(
        (("msi", jt.build_scene_tensors_from_views(js.train_views), None, 0),),
        jc, jraster,
        jt.Phase(enable_sun=True, enable_random=True, learn_pose=True),
        store, store,
        spatial_lr_scale=js.cameras_extent)
    gp = GaussianParams(**{k: jnp.asarray(x) for k, x in params.items()})
    sp = JShading(**{k: jnp.asarray(x) for k, x in shade.items()})
    state = jt.TrainState(
        params=gp, aux=GaussianAux(**{k: jnp.asarray(x) for k, x in aux.items()}),
        shading=sp, g_opt=gp, c_opt=sp, step=jnp.int32(0))
    key = jax.random.PRNGKey(3)
    new, jmetrics = jstep(state, jnp.int32(view), key,
                          jt.make_gates(jc, iteration, n))
    k_bg, k_rand = jax.random.split(jax.random.split(key, 1)[0])
    bg = np.asarray(jax.random.uniform(k_bg, (5,)))
    shear = np.asarray(jax.random.normal(k_rand, (2,)))

    model = GaussianModel.from_numpy(params, aux, device="cpu")
    shading = CameraShadingParams.from_numpy(shade, device="cpu")
    gopt = tt.gaussian_optimizer(model, tc, ts.cameras_extent)
    copt = tt.camera_optimizer(shading, tc)
    for group in gopt.param_groups + copt.param_groups:
        group["lr"] = 0.0
    tstep = tt.make_train_step(
        (("msi", tt.build_scene_tensors_from_views(ts.train_views,
                                                   device="cpu"), None, 0),),
        tc, traster,
        tt.Phase(enable_sun=True, enable_random=True, learn_pose=True), gopt,
        copt)
    tmetrics = tstep(model, shading, view, _t(bg), _t(shear),
                     tt.make_gates(tc, iteration, n))
    return dict(new=new, jmetrics=jmetrics, model=model, shading=shading,
                tmetrics=tmetrics, params=params)


@pytest.fixture(scope="module")
def one_step(scenes):
    """The step on the fused route (K1/K2's plain versions here)."""
    return _one_step(
        scenes,
        JConfig(binning_mode="fused", tile_cull=True, tile_capacity=2048,
                max_tiles_per_gaussian=64),
        RasterizeConfig(binning_mode="fused", tile_cull=True))


# the CLI's fast route: sorted binning and the K4 blend, at capacities that
# clip nothing in this scene
FAST = dict(binning_mode="sorted", use_pallas=True, tile_capacity=512,
            max_tiles_per_gaussian=64)


@pytest.fixture(scope="module")
def one_step_fast(scenes):
    """The step on the fast route (K4's plain versions here)."""
    return _one_step(scenes, JConfig(**FAST), RasterizeConfig(**FAST))


def _check_loss_terms(one_step):
    jm, tm = one_step["jmetrics"], one_step["tmetrics"]
    terms = [k for k in tm if k.startswith("L") or k in (
        "loss", "L1", "photometric", "psnr", "grad_m2d_max")]
    assert len(terms) >= 16
    for k in terms:
        assert abs(float(tm[k]) - float(jm[k])) <= \
            1e-4 * abs(float(jm[k])) + 1e-9, k
        assert float(jm[k]) != 0.0 or k == "L_opacity_radii", k
    for k in ("num_pairs", "max_tile", "max_tiles_per_gaussian",
              "clipped_pairs", "sat_frac"):
        assert float(tm[k]) == float(jm[k]), k


def test_one_step_loss_terms(one_step):
    _check_loss_terms(one_step)


def test_one_step_fast_loss_terms(one_step_fast):
    """The step on sorted + use_pallas against JAX's, at the fused step's
    tolerances; nothing clipped."""
    _check_loss_terms(one_step_fast)
    assert float(one_step_fast["tmetrics"]["max_tile"]) < FAST["tile_capacity"]


def _check_gaussian_gradients(one_step):
    new, model = one_step["new"], one_step["model"]
    for f in ("xyz", "features_dc", "scaling", "rotation", "opacity"):
        want = np.asarray(getattr(new.g_opt, f))
        assert np.abs(want).max() > 0, f
        assert _rel(getattr(model, f).grad.numpy(), want) < 2e-4, f
    # the lr-0 step moved nothing
    for f, x in one_step["params"].items():
        np.testing.assert_array_equal(getattr(model, f).detach().numpy(), x)


def test_one_step_gaussian_gradients(one_step):
    _check_gaussian_gradients(one_step)


def test_one_step_fast_gaussian_gradients(one_step_fast):
    _check_gaussian_gradients(one_step_fast)


def _check_shading_gradients(one_step):
    new, shading = one_step["new"], one_step["shading"]
    assert np.abs(np.asarray(new.c_opt.last_row)).max() > 0
    for f in ("cc_weight", "cc_bias", "inshadow", "last_row", "exposure",
              "msi_to_pan_weight", "msi_to_pan_bias", "transient_mask"):
        want = np.asarray(getattr(new.c_opt, f))
        got = getattr(shading, f).grad.numpy()
        if np.abs(want).max() == 0:  # gated or unused: zeros, as in JAX
            np.testing.assert_array_equal(got, want)
        else:
            assert _rel(got, want) < 2e-4, f


def test_one_step_shading_gradients(one_step):
    _check_shading_gradients(one_step)


def test_one_step_fast_shading_gradients(one_step_fast):
    _check_shading_gradients(one_step_fast)


def _check_densification_stats(one_step):
    new, model = one_step["new"], one_step["model"]
    np.testing.assert_array_equal(model.denom.numpy(),
                                  np.asarray(new.aux.denom))
    np.testing.assert_array_equal(model.max_radii2d.numpy(),
                                  np.asarray(new.aux.max_radii2d))
    assert _rel(model.xyz_gradient_accum.numpy(),
                new.aux.xyz_gradient_accum) < 2e-4


def test_one_step_densification_stats(one_step):
    _check_densification_stats(one_step)


def test_one_step_fast_densification_stats(one_step_fast):
    _check_densification_stats(one_step_fast)


def _trainer(scenes, iterations=4, **opt):
    _, _, ts = scenes
    cfg = tconfig.baseogs(iterations=iterations)
    cfg.optimization.iterstart_shadowmapping = 0
    cfg.optimization.iterstart_L_new_resample = 0
    cfg.logging.tb_log_interval = 2
    for k, v in opt.items():
        setattr(cfg.optimization, k, v)
    return tt.Trainer(cfg, ts, RasterizeConfig(binning_mode="fused",
                                               tile_cull=True),
                      device="cpu").setup()


def test_trainer_trains_and_prunes(scenes):
    tr = _trainer(scenes)
    before = {f: getattr(tr.model, f).detach().clone()
              for f in ("xyz", "features_dc", "scaling", "opacity")}
    alive0 = int(tr.model.alive.sum())
    with torch.no_grad():  # push a few Gaussians under the prune threshold
        tr.model.opacity[:5] = -7.0
    tr.train(4)
    assert [m["iteration"] for m in tr.metrics_history] == [2, 4]
    for m in tr.metrics_history:
        assert all(np.isfinite(v) for v in m.values())
        assert m["L_new_altitude_resample"] > 0 and m["alive"] == alive0 - 5
    for f, x in before.items():
        assert not torch.equal(getattr(tr.model, f).detach(), x), f
    assert float(tr.model.denom.max()) > 0


def test_step_raises_for_unported_options(scenes):
    """The multi-device options are ported; what JAX asserts raises:
    raster_backend='a2a' without a mesh (eogs2_tpu/train.py:184), and an
    unknown backend."""
    tr = _trainer(scenes)
    mods = (("msi", tr.consts, None, 0),)
    args = (tr.cfg, tr.raster_cfg, tt.Phase(), tr.gauss_opt, tr.cam_opt)
    with pytest.raises(ValueError, match="needs a mesh"):
        tt.make_train_step(mods, *args, raster_backend="a2a")
    with pytest.raises(ValueError, match="unknown raster_backend"):
        tt.make_train_step(mods, *args, raster_backend="pjit")
