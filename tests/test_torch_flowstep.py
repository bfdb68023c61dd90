"""One training step of the paper's recipes against eogs2_tpu's, both on the
CPU and on the fused route (the port's kernels run their plain versions
here; JAX runs its Pallas kernels in interpret mode, as its own tests do):

  * eogsplus: 3PAN (the PAN GT repeated to 3 channels, the identity PAN
    conversion) with the sun, the random camera and the flow-matching phase
    on, the warp accepted;
  * fixed: the dual MS mode, the MSI and the PAN camera of one view in one
    step (the WV3 conversion), their losses summed, the metrics prefixed
    and averaged, the radii maxed; the main renders only (the sun and the
    random camera are held in the eogsplus step). The random camera is
    not held here for a second reason: the bilinear resample's derivative
    in the sample position jumps at whole pixel positions, and the random
    camera's small shear (at most 0.01 of the altitude) puts its samples
    within float32 rounding of them wherever the rendered altitude is near
    0; in this scene's dual step one such sample falls on opposite sides in
    the two packages, and the Gaussian behind it differs by 2.5e-4 of the
    largest xyz gradient.
  * fixed at two sizes: the same mode on the benchmark's dual scene
    (``benchmark/scene_dual.py``: PAN 64^2, MSI 16^2, the MSI the 4x4 box
    mean of the colour render), with the sun, the random camera and the
    flow phase on both modalities, so each package builds one set of
    scene tensors per size. Here JAX runs with a tile capacity above the
    MSI render's single-tile demand (the port does not clip).

Both packages start from one seeded state on one ms scene, and the port's
step is fed JAX's draws (``jax.random.split(key, n_modalities)``, then
each key split into the background's and the random camera's). Tolerances:
loss terms rel 5e-5; gradients max-normalised 2e-4 and the densification
statistics rel 2e-4 (tests/test_torch_train.py's), integer statistics
exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import eogs2_tpu.config as jconfig
from benchmark.common import program_scene
from benchmark.scene_dual import make_scene_dual
from eogs2_tpu import train as jt
from eogs2_tpu.model import GaussianAux, GaussianParams
from eogs2_tpu.model import init_from_points as j_init
from eogs2_tpu.rasterizer import RasterizeConfig as JConfig
from eogs2_tpu.shading import CameraShadingParams as JShading
import eogs2_tpu_torch.config as tconfig
from eogs2_tpu_torch import train as tt
from eogs2_tpu_torch.data.synthetic import make_scene_arrays, scene_from_arrays
from eogs2_tpu_torch.model import GaussianModel
from eogs2_tpu_torch.rasterizer import RasterizeConfig
from eogs2_tpu_torch.shading import CameraShadingParams

SCENE_KW = dict(n_views=4, width=64, height=64, hf_res=128, n_buildings=4,
                seed=0, scale=12.0, modality="ms")
JRASTER = JConfig(binning_mode="fused", tile_cull=True, tile_capacity=2048,
                  max_tiles_per_gaussian=64)
TRASTER = RasterizeConfig(binning_mode="fused", tile_cull=True)
# benchmark/scene_dual.py's scene as tests/test_torch_dual_ms.py makes it
DUAL_SIZE = dict(n_views=3, width=64, height=64, hf_res=128, n_buildings=4,
                 scale=20.0, density=0.13, sun_el_az=[55.0, 120.0],
                 msi_factor=4)
SHADE = ("cc_weight", "cc_bias", "inshadow", "last_row", "exposure",
         "msi_to_pan_weight", "msi_to_pan_bias", "transient_mask")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run this file's torch ops on one thread: beside the other test
    workers, torch's default pool (one thread per core) oversubscribes the
    cores."""
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


@pytest.fixture(scope="module")
def arrays():
    return make_scene_arrays(**SCENE_KW)


def _cfg(pkg, mode):
    """eogsplus with the sun, the random camera and the flow phase from
    iteration 0, every warp accepted, in 3PAN or (eogsplus-fixed) in the
    dual mode; fixed with its main renders only."""
    if not mode.startswith("eogsplus"):
        return pkg._apply_mode(pkg.baseogs(iterations=10), mode)
    cfg = pkg.eogsplus(iterations=10)
    o = cfg.optimization
    o.iterstart_shadowmapping = 0
    o.iterstart_L_new_resample = 0
    o.iterstart_flowmatching = 0
    o.flowmatching.max_value_flow = 1e3
    if mode == "eogsplus-fixed":
        pkg._apply_mode(cfg, "fixed")
        cfg.model.repeat_gt = False
        cfg.model.share_color_correction = True
    return cfg


def _modalities(build, scene, cfg, pan_mode, **kw):
    msi = [v for v in scene.train_views if v.image_type == "msi"]
    pan = [v for v in scene.train_views if v.image_type == "pan"]
    mods = []
    if cfg.model.load_msi:
        mods.append(("msi", build(msi, **kw), None, 0))
    if cfg.model.load_pan:
        mods.append(("pan", build(pan, repeat_gt=cfg.model.repeat_gt, **kw),
                     pan_mode, 0))
    return tuple(mods)


def _state(scene, n_views):
    n = len(scene.init_xyz)
    cap = ((int(n * 1.25) + 127) // 128) * 128
    jm = j_init(scene.init_xyz, scene.init_rgb, cap)
    rng = np.random.RandomState(1)
    params = {f: np.array(getattr(jm.params, f))
              for f in GaussianParams.__dataclass_fields__}
    op = rng.uniform(0.2, 0.9, n)
    params["opacity"][:n, 0] = np.log(op / (1 - op))
    params["features_dc"][:n, 0] = (rng.uniform(0, 1, (n, 3)) - 0.5) / 0.28209479
    params["scaling"][:n] += rng.normal(0, 0.3, (n, 3)) - 0.7
    q = rng.normal(0, 1, (n, 4))
    params["rotation"][:n] = q / np.linalg.norm(q, axis=1, keepdims=True)
    aux = {f: np.array(getattr(jm.aux, f))
           for f in GaussianAux.__dataclass_fields__}
    v = n_views
    shade = dict(
        cc_weight=np.eye(3)[None] + 0.1 * rng.normal(size=(v, 3, 3)),
        cc_bias=0.05 * rng.normal(size=(v, 3)),
        inshadow=rng.uniform(0.05, 0.3, (v, 3)), last_row=np.zeros((v, 4)),
        exposure=np.tile(np.eye(3, 4)[None], (v, 1, 1)),
        msi_to_pan_weight=np.ones((v, 3)) / 3, msi_to_pan_bias=np.zeros(v),
        transient_mask=rng.uniform(0.0, 0.3, (v, 1, 1)))
    return n, params, aux, {k: np.asarray(x, np.float32)
                            for k, x in shade.items()}


def _one_step(arrays, mode, pan_mode, iteration=5, view=1, scene=None,
              jraster=JRASTER):
    """One step of each package from the same state, on the same view, with
    JAX's draws, on the scene of ``arrays`` (or ``scene``). JAX's gradients
    come back as the optimizer state of an optax transformation that stores
    them; the port's stay in .grad (its Adam runs at lr 0)."""
    jc, tc = _cfg(jconfig, mode), _cfg(tconfig, mode)
    if scene is None:
        scene = scene_from_arrays(arrays, device="cpu",
                                  load_msi=tc.model.load_msi,
                                  load_pan=tc.model.load_pan)
    n_views = sum(v.image_type == "pan" for v in scene.train_views)
    n, params, aux, shade = _state(scene, n_views)
    full = mode.startswith("eogsplus")
    phase = jt.Phase(enable_sun=full, enable_random=full,
                     enable_flowmatch=full)
    assert phase == jt.phase_for_iteration(jc, iteration)

    store = optax.GradientTransformation(
        lambda p: p, lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))
    jmods = _modalities(jt.build_scene_tensors_from_views, scene, jc,
                        pan_mode)
    jstep = jt.make_train_step(jmods, jc, jraster, phase, store, store,
                               spatial_lr_scale=scene.cameras_extent)
    gp = GaussianParams(**{k: jnp.asarray(x) for k, x in params.items()})
    sp = JShading(**{k: jnp.asarray(x) for k, x in shade.items()})
    state = jt.TrainState(
        params=gp,
        aux=GaussianAux(**{k: jnp.asarray(x) for k, x in aux.items()}),
        shading=sp, g_opt=gp, c_opt=sp, step=jnp.int32(0))
    key = jax.random.PRNGKey(3)
    new, jmetrics = jstep(state, jnp.int32(view), key,
                          jt.make_gates(jc, iteration, n))
    draws = [jax.random.split(k) for k in jax.random.split(key, len(jmods))]
    bg = np.stack([np.asarray(jax.random.uniform(kb, (5,)))
                   for kb, _ in draws])
    shear = np.stack([np.asarray(jax.random.normal(kr, (2,)))
                      for _, kr in draws])

    model = GaussianModel.from_numpy(params, aux, device="cpu")
    shading = CameraShadingParams.from_numpy(shade, device="cpu")
    gopt = tt.gaussian_optimizer(model, tc, scene.cameras_extent)
    copt = tt.camera_optimizer(shading, tc)
    for group in gopt.param_groups + copt.param_groups:
        group["lr"] = 0.0
    tmods = _modalities(tt.build_scene_tensors_from_views, scene, tc,
                        pan_mode, device="cpu")
    tstep = tt.make_train_step(tmods, tc, TRASTER, phase, gopt, copt)
    tmetrics = tstep(model, shading, view, _t(bg), _t(shear),
                     tt.make_gates(tc, iteration, n))
    return dict(new=new, jmetrics=jmetrics, model=model, shading=shading,
                tmetrics=tmetrics, params=params, mods=tmods)


@pytest.fixture(scope="module")
def eogsplus_step(arrays):
    return _one_step(arrays, "eogsplus", "identity")


@pytest.fixture(scope="module")
def fixed_step(arrays):
    return _one_step(arrays, "fixed", "fixed")


@pytest.fixture(scope="module")
def dual_sizes_step():
    dev = torch.device("cpu")
    scene = program_scene(make_scene_dual(DUAL_SIZE, 11, dev), dev)
    return _one_step(None, "eogsplus-fixed", "fixed", scene=scene,
                     jraster=JConfig(binning_mode="fused", tile_cull=True,
                                     tile_capacity=4096,
                                     max_tiles_per_gaussian=64))


STEPS = ("eogsplus_step", "fixed_step")


def _check_loss_terms(step, resample_atol=1e-9):
    jm, tm = step["jmetrics"], step["tmetrics"]
    assert sorted(k for k in jm if k in tm) == sorted(tm)
    terms = [k for k in tm if k.split("_", 1)[-1].startswith("L")
             or k.startswith("L") or k.endswith((
                 "loss", "L1", "photometric", "psnr", "flow_mag"))]
    terms.append("grad_m2d_max")
    for k in terms:
        assert abs(float(tm[k]) - float(jm[k])) <= \
            5e-5 * abs(float(jm[k])) + (
                resample_atol if "resample" in k else 1e-9), k
    for k in tm:
        if k.endswith(("num_pairs", "max_tile", "max_tiles_per_gaussian",
                       "clipped_pairs", "sat_frac")):
            assert float(tm[k]) == float(jm[k]), k
    return terms


def _check_gaussian_gradients(step):
    new, model = step["new"], step["model"]
    for f in ("xyz", "features_dc", "scaling", "rotation", "opacity"):
        want = np.asarray(getattr(new.g_opt, f))
        assert np.abs(want).max() > 0, f
        assert _rel(getattr(model, f).grad.numpy(), want) < 2e-4, f
    for f, x in step["params"].items():  # the lr-0 step moved nothing
        np.testing.assert_array_equal(getattr(model, f).detach().numpy(), x)


def _check_shading_gradients(step):
    new, shading = step["new"], step["shading"]
    for f in SHADE:
        want = np.asarray(getattr(new.c_opt, f))
        got = getattr(shading, f).grad.numpy()
        if np.abs(want).max() == 0:  # gated or unused: zeros, as in JAX
            np.testing.assert_array_equal(got, want)
        else:
            assert _rel(got, want) < 2e-4, f


def _check_densification_stats(step):
    new, model = step["new"], step["model"]
    np.testing.assert_array_equal(model.denom.numpy(),
                                  np.asarray(new.aux.denom))
    np.testing.assert_array_equal(model.max_radii2d.numpy(),
                                  np.asarray(new.aux.max_radii2d))
    assert _rel(model.xyz_gradient_accum.numpy(),
                new.aux.xyz_gradient_accum) < 2e-4


@pytest.mark.parametrize("which", STEPS)
def test_step_loss_terms(request, which):
    step = request.getfixturevalue(which)
    tm = step["tmetrics"]
    _check_loss_terms(step)
    if which == "eogsplus_step":
        # the flow phase ran and its warp was taken
        assert float(tm["flow_mag"]) > 0.1
        assert step["mods"][0][1].images.shape[1] == 3  # repeated PAN GT
    else:
        for k in ("photometric", "psnr", "L1"):
            assert float(tm[k]) == pytest.approx(
                0.5 * (float(tm[f"msi_{k}"]) + float(tm[f"pan_{k}"])),
                rel=1e-6)
        assert float(tm["pan_Lphotometric"]) != float(tm["msi_Lphotometric"])


@pytest.mark.parametrize("which", STEPS)
def test_step_gaussian_gradients(request, which):
    _check_gaussian_gradients(request.getfixturevalue(which))


@pytest.mark.parametrize("which", STEPS)
def test_step_shading_gradients(request, which):
    _check_shading_gradients(request.getfixturevalue(which))


@pytest.mark.parametrize("which", STEPS)
def test_step_densification_stats(request, which):
    _check_densification_stats(request.getfixturevalue(which))


def test_two_size_fixed_step_matches_jax(dual_sizes_step):
    """The fixed step at PAN 64^2 and MSI 16^2 with the sun, the random
    camera and the flow phase on both modalities: every loss term, every
    leaf's gradient and the densification statistics as JAX's.

    The resample terms are means of the gap between two renders that
    nearly agree, and each render's pixels differ between the packages by
    float32 sums in other orders (the MSI's one tile blends 2.8k pairs),
    which such a mean does not divide away: they take an absolute 1e-6
    besides (measured at most 3.6e-7, at a value of 2.2e-3; a render at the
    wrong size moves them by more than their value). On view 0 the random
    camera's tie at whole pixel positions (module docstring) shows: up to
    9 of the 2.8k Gaussians' screen-space gradients differ by up to 3%."""
    step = dual_sizes_step
    sizes = [tuple(c.images.shape[-2:]) for _, c, _, _ in step["mods"]]
    assert sizes == [(16, 16), (64, 64)]
    terms = _check_loss_terms(step, resample_atol=1e-6)
    for m in ("msi", "pan"):  # the sun's, the random camera's, the flow's
        assert {f"{m}_L_translucentshadows", f"{m}_L_new_altitude_resample",
                f"{m}_L_new_rgb_resample", f"{m}_flow_mag"} <= set(terms), m
        assert float(step["tmetrics"][f"{m}_L_new_rgb_resample"]) > 0, m
        assert float(step["tmetrics"][f"{m}_flow_mag"]) > 0.1, m
    _check_gaussian_gradients(step)
    _check_shading_gradients(step)
    _check_densification_stats(step)
