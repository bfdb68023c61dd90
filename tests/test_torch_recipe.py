"""The rest of the single-modality training recipe against eogs2_tpu's, both
on the CPU: densification by clone/split, the prune mask, the opacity reset
with its Adam-moment surgery, one densify iteration of the Trainer's
maintenance, early stopping, test_shading_params, training_report and
calibrate_opacity_init; and, marked slow, the train -> Nadir DSM -> MAE
chain of tests/test_e2e.py.

Inputs are made with numpy from fixed seeds and handed to both packages;
the split's standard-normal draws are JAX's (from ``jax.random.split`` of
its key), fed to the port. Tolerances:
  * densify functions and maintenance: parameters within 1e-6, ``alive``
    exact, Adam moments equal (zero at the same rows, untouched elsewhere);
  * test_shading_params: exact;
  * training_report: L1 and PSNR within 1e-4;
  * calibrate_opacity_init: within 1e-4 relative (every bisection decision
    has a margin above 1e-4 of mean accumulated opacity here, far above
    the renders' 2e-4 atol per pixel averaged over the view);
  * early stopping: the same break iteration and the same eval hook calls.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import eogs2_tpu.config as jconfig
from eogs2_tpu import densify as jd
from eogs2_tpu import train as jt
from eogs2_tpu.data.synthetic import generate_scene
from eogs2_tpu.model import GaussianAux, GaussianModel as JModel
from eogs2_tpu.model import GaussianParams
from eogs2_tpu.rasterizer import RasterizeConfig as JConfig
from eogs2_tpu.scene import load_scene as j_load
from eogs2_tpu.shading import CameraShadingParams as JShading
import eogs2_tpu_torch.config as tconfig
from eogs2_tpu_torch import densify as td
from eogs2_tpu_torch import train as tt
from eogs2_tpu_torch.data.synthetic import make_scene_arrays, scene_from_arrays
from eogs2_tpu_torch.eval.mae import MaeComputer as TMae
from eogs2_tpu_torch.model import GaussianModel
from eogs2_tpu_torch.pipeline import evaluate_dsm_mae as t_eval_mae
from eogs2_tpu_torch.rasterizer import RasterizeConfig
from eogs2_tpu_torch.shading import CameraShadingParams

SCENE_KW = dict(n_views=4, width=64, height=64, hf_res=128, n_buildings=4,
                seed=0, scale=12.0)
FIELDS = ("xyz", "features_dc", "features_rest", "scaling", "rotation",
          "opacity")
AUX = ("alive", "max_radii2d", "xyz_gradient_accum", "denom")
SHADE = ("cc_weight", "cc_bias", "inshadow", "last_row", "exposure",
         "msi_to_pan_weight", "msi_to_pan_bias", "transient_mask")
# JAX's gather route (plain jnp, quicker to compile on the CPU than its
# fused route in interpret mode) at capacities above the scene's Gaussian
# count, so it clips nothing; the port's fused route with the tile cull
JCFG = JConfig(binning_mode="gather", tile_capacity=1024,
               max_tiles_per_gaussian=64)
TCFG = RasterizeConfig(binning_mode="fused", tile_cull=True)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run this file's torch ops on one thread: beside the other test
    workers, torch's default pool (one thread per core) oversubscribes the
    cores and its many small parallel regions slow the file down."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# one state in both packages
# ---------------------------------------------------------------------------


def _random_state(cap, n, seed, extent):
    """Parameters, buffers and Adam moments: about 10% of the first n slots
    and every slot past n dead; log-scales around percent_dense * extent
    (0.01 extent), so that clone and split both select rows; accumulated
    gradients around the thresholds used below, some denominators 0."""
    rng = np.random.RandomState(seed)
    q = rng.normal(size=(cap, 4))
    params = dict(
        xyz=rng.normal(size=(cap, 3)),
        features_dc=rng.normal(size=(cap, 1, 3)),
        features_rest=np.zeros((cap, 0, 3)),
        scaling=np.log(extent * rng.uniform(0.003, 0.015, (cap, 3))),
        rotation=q * rng.uniform(0.5, 2.0, (cap, 1)),
        opacity=rng.uniform(-7, 3, (cap, 1)))
    alive = np.zeros(cap, bool)
    alive[:n] = rng.uniform(size=n) < 0.9
    aux = dict(alive=alive, max_radii2d=rng.uniform(0, 30, cap),
               xyz_gradient_accum=rng.uniform(0, 2e-3, cap),
               denom=rng.randint(0, 6, cap).astype(np.float64))
    mu = {f: rng.normal(size=p.shape) for f, p in params.items()}
    nu = {f: rng.uniform(0.1, 1.0, size=p.shape) for f, p in params.items()}
    f32 = lambda d: {k: (v if v.dtype == bool else v.astype(np.float32))
                     for k, v in d.items()}
    return f32(params), f32(aux), f32(mu), f32(nu)


def _jax_state(params, aux, mu, nu):
    jp = lambda d: GaussianParams(**{k: jnp.asarray(d[k]) for k in FIELDS})
    model = JModel(params=jp(params),
                   aux=GaussianAux(**{k: jnp.asarray(aux[k]) for k in AUX}))
    return model, jp(mu), jp(nu)


def _torch_state(params, aux, mu, nu, extent):
    model = GaussianModel.from_numpy(params, aux, device="cpu")
    opt = tt.gaussian_optimizer(model, tconfig.baseogs(), extent)
    for f in FIELDS:
        p = getattr(model, f)
        opt.state[p] = dict(step=torch.tensor(3.0),
                            exp_avg=torch.from_numpy(mu[f].copy()),
                            exp_avg_sq=torch.from_numpy(nu[f].copy()))
    return model, opt


def _check_state(jmodel, jmu, jnu, tmodel, topt):
    for f in FIELDS:
        np.testing.assert_allclose(getattr(tmodel, f).detach().numpy(),
                                   np.asarray(getattr(jmodel.params, f)),
                                   rtol=0, atol=1e-6, err_msg=f)
        st = topt.state[getattr(tmodel, f)]
        np.testing.assert_array_equal(st["exp_avg"].numpy(),
                                      np.asarray(getattr(jmu, f)), err_msg=f)
        np.testing.assert_array_equal(st["exp_avg_sq"].numpy(),
                                      np.asarray(getattr(jnu, f)), err_msg=f)
    for f in AUX:
        np.testing.assert_array_equal(getattr(tmodel, f).numpy(),
                                      np.asarray(getattr(jmodel.aux, f)),
                                      err_msg=f)


def _grads_avg(aux):
    return np.nan_to_num(aux["xyz_gradient_accum"]
                         / np.maximum(aux["denom"], 1e-12))


def _jit(fn, n_arrays):
    """fn jitted, its arguments past the first n_arrays static (one
    compile in place of many eager ones)."""
    return jax.jit(fn, static_argnums=tuple(range(n_arrays, n_arrays + 3)))


def _split_draws(key, shape):
    k1, k2 = jax.random.split(key)
    return [np.asarray(jax.random.normal(k, shape)) for k in (k1, k2)]


# ---------------------------------------------------------------------------
# densify.py
# ---------------------------------------------------------------------------

# one capacity everywhere, so JAX compiles each eager operation once
THR, PD, EXTENT, CAP = 4e-4, 0.01, 2.0, 512


@pytest.mark.parametrize("op", ["clone", "split", "clone_then_split",
                                "prune_mask", "reset_stats",
                                "reset_opacity"])
def test_densify_op_matches_jax(op):
    """Each function from one state with Adam moments. Clone and split
    select more rows than there are free slots (so some get none), and
    split runs after clone on its state, as the Trainer runs them."""
    params, aux, mu, nu = _random_state(CAP, 490, seed=1, extent=EXTENT)
    jm, jmu, jnu = _jax_state(params, aux, mu, nu)
    tm, opt = _torch_state(params, aux, mu, nu, EXTENT)
    g = _grads_avg(aux)
    free = CAP - int(aux["alive"].sum())
    small = np.exp(params["scaling"]).max(1) <= PD * EXTENT
    sel = (g >= THR) & aux["alive"]
    n_clone = 0
    if op in ("clone", "clone_then_split"):
        jm, jmu, jnu, jn = _jit(jd.densify_clone, 4)(
            jm, jmu, jnu, jnp.asarray(g), THR, PD, EXTENT)
        tn = td.densify_clone(tm, opt, torch.from_numpy(g), THR, PD, EXTENT)
        n_clone = int(tn)
        assert n_clone == int(jn) == min(int((sel & small).sum()), free) > 0
    if op in ("split", "clone_then_split"):
        key = jax.random.PRNGKey(5)
        d1, d2 = _split_draws(key, (CAP, 3))
        alive0 = np.asarray(jm.aux.alive).copy()
        jm, jmu, jnu, jn = _jit(jd.densify_split, 5)(
            jm, jmu, jnu, jnp.asarray(g), key, THR, PD, EXTENT)
        tn = td.densify_split(tm, opt, torch.from_numpy(g),
                              torch.from_numpy(d1), torch.from_numpy(d2), THR,
                              PD, EXTENT)
        # more are selected than slots are free: some get none
        assert (sel & ~small).sum() > free - n_clone
        assert int(tn) == int(jn) == free - n_clone > 0
        assert int(tn) == int(np.asarray(jm.aux.alive).sum() - alive0.sum())
    if op == "prune_mask":
        for size in (None, 20):
            want = np.asarray(jd.prune_mask(jm, 0.005, size, EXTENT, EXTENT))
            got = td.prune_mask(tm, 0.005, size, EXTENT, EXTENT).numpy()
            np.testing.assert_array_equal(got, want)
            assert 0 < got.sum() < got.size
        jm = jd.apply_prune(jm, jnp.asarray(want))
        td.apply_prune(tm, torch.from_numpy(got))
    if op == "reset_stats":
        jm = jd.reset_densification_stats(jm)
        td.reset_densification_stats(tm)
        assert float(tm.denom.abs().max()) == 0.0
    if op == "reset_opacity":
        jm, jmu, jnu = jd.reset_opacity_with_moments(jm, jmu, jnu)
        td.reset_opacity_with_moments(tm, opt)
        assert float(opt.state[tm.opacity]["exp_avg"].abs().max()) == 0.0
    _check_state(jm, jmu, jnu, tm, opt)


def test_free_slot_targets_match_jax():
    rng = np.random.RandomState(2)
    for _ in range(4):
        alive = rng.uniform(size=200) < rng.uniform(0.3, 0.95)
        want = rng.uniform(size=200) < 0.5
        js, jok = jd._free_slot_targets(jnp.asarray(alive), jnp.asarray(want))
        ts, tok = td._free_slot_targets(torch.from_numpy(alive),
                                        torch.from_numpy(want))
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
        ok = tok.numpy()
        np.testing.assert_array_equal(ts.numpy()[ok], np.asarray(js)[ok])
        assert not alive[ts.numpy()[ok]].any()


def test_reset_opacity_without_adam_state():
    """Before the first step torch's Adam has no state: the reset leaves
    it so (its moments are zero already)."""
    params, aux, mu, nu = _random_state(64, 60, seed=3, extent=EXTENT)
    model = GaussianModel.from_numpy(params, aux, device="cpu")
    opt = tt.gaussian_optimizer(model, tconfig.baseogs(), EXTENT)
    td.reset_opacity_with_moments(model, opt)
    assert not opt.state
    op = model.get_opacity().detach().numpy()
    assert (op[aux["alive"]] <= 0.01 + 1e-7).all()
    np.testing.assert_array_equal(model.opacity.detach().numpy()[~aux["alive"]],
                                  params["opacity"][~aux["alive"]])


# ---------------------------------------------------------------------------
# the Trainer
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("scene"))
    generate_scene(d, **SCENE_KW)
    js = j_load(d, images_msi_path=os.path.join(d, "images"), load_pan=False)
    ts = scene_from_arrays(make_scene_arrays(**SCENE_KW), device="cpu")
    return d, js, ts


def _recipe(pkg, iterations=30, **opt):
    """learnwv with clone/split densification every 5 iterations from 4
    and an opacity reset every 5."""
    cfg = pkg.learnwv(iterations=iterations)
    o = cfg.optimization
    o.only_prune = False
    o.densification.densify_from_iter = 4
    o.densification.densification_interval = 5
    o.densification.densify_grad_threshold = THR
    o.opacity_reset_interval = 5
    for k, v in opt.items():
        setattr(o, k, v)
    return cfg


def _trainers(scenes, cfg_j, cfg_t):
    _, js, ts = scenes
    jtr = jt.Trainer(cfg=cfg_j, scene=js, raster_cfg=JCFG).setup()
    ttr = tt.Trainer(cfg_t, ts, TCFG, device="cpu").setup()
    return jtr, ttr


def _set_model(jtr, ttr, params, aux, mu, nu):
    jm, jmu, jnu = _jax_state(params, aux, mu, nu)
    st = jtr.state
    jtr.state = st.replace(params=jm.params, aux=jm.aux,
                           g_opt=st.g_opt._replace(mu=jmu, nu=jnu))
    ttr.model, ttr.gauss_opt = _torch_state(params, aux, mu, nu,
                                            ttr.scene.cameras_extent)


def _scene_model(ttr, seed=1):
    """The Trainer's init model with seeded opacities, colours, scales and
    rotations (as tests/test_torch_pipeline.py sets them)."""
    params, aux = ttr.model.to_numpy()
    n = ttr.init_count
    rng = np.random.RandomState(seed)
    op = rng.uniform(0.2, 0.9, n)
    params["opacity"][:n, 0] = np.log(op / (1 - op))
    params["features_dc"][:n, 0] = (rng.uniform(0, 1, (n, 3)) - 0.5) / 0.28209479
    params["scaling"][:n] += rng.normal(0, 0.3, (n, 3))
    qq = rng.normal(0, 1, (n, 4))
    params["rotation"][:n] = qq / np.linalg.norm(qq, axis=1, keepdims=True)
    mu = {f: np.zeros_like(p) for f, p in params.items()}
    return params, aux, mu, mu


def test_maintenance_matches_jax(scenes, monkeypatch):
    """One densify iteration of Trainer._maintenance (clone, split, the
    size prune past the first opacity reset, fresh statistics, the
    transparent prune, then the opacity reset with its moments) from one
    state, with JAX's split draws."""
    jtr, ttr = _trainers(scenes, _recipe(jconfig), _recipe(tconfig))
    extent = ttr.scene.cameras_extent
    assert extent == jtr.scene.cameras_extent
    state = _random_state(CAP, 480, seed=4, extent=extent)
    _set_model(jtr, ttr, *state)
    _, k = jax.random.split(jtr.key)  # the key _maintenance splits off
    draws = torch.from_numpy(np.stack(_split_draws(k, (CAP, 3))))
    monkeypatch.setattr(torch, "randn", lambda *a, **kw: draws)
    iteration = 10  # densify (10 > 4, 10 % 5 == 0), size prune, reset
    jtr._maintenance(iteration)
    ttr._maintenance(iteration)
    jm = JModel(params=jtr.state.params, aux=jtr.state.aux)
    _check_state(jm, jtr.state.g_opt.mu, jtr.state.g_opt.nu, ttr.model,
                 ttr.gauss_opt)
    (ev,) = ttr.densify_log
    assert ev["cloned"] > 0 and ev["split"] > 0 and ev["selected"] > 0
    assert ev["alive_densified"] == ev["alive_before"] + ev["cloned"] \
        + ev["split"]
    assert ev["alive_pruned"] < ev["alive_densified"]
    assert float(ttr.model.denom.abs().max()) == 0.0


def test_shading_params_for_test_views_match_jax(scenes):
    for mode in ("average", "ref"):
        cj, ct = _recipe(jconfig), _recipe(tconfig)
        cj.model.train_to_test_cc_converter = mode
        ct.model.train_to_test_cc_converter = mode
        jtr, ttr = _trainers(scenes, cj, ct)
        rng = np.random.RandomState(6)
        shade = {f: rng.normal(size=np.asarray(getattr(jtr.state.shading, f)
                                               ).shape).astype(np.float32)
                 for f in SHADE}
        jtr.state = jtr.state.replace(shading=JShading(
            **{k: jnp.asarray(v) for k, v in shade.items()}))
        ttr.shading = CameraShadingParams.from_numpy(shade, device="cpu")
        want, got = jtr.test_shading_params(), ttr.test_shading_params()
        for f in SHADE:
            np.testing.assert_array_equal(getattr(got, f).numpy(),
                                          np.asarray(getattr(want, f)),
                                          err_msg=f"{mode} {f}")


class _Logger:
    def __init__(self):
        self.scalars, self.images = {}, {}

    def log_scalars(self, d, it):
        self.scalars.update(d)

    def log_image(self, tag, img, it):
        self.images[tag] = np.asarray(img)


def test_training_report_matches_jax(scenes):
    """L1 and PSNR per split against JAX's report; with a MaeComputer the
    port's report adds the Nadir DSM's MAE (evaluate_dsm_mae, held against
    JAX's in tests/test_torch_eval.py) and its two images."""
    d, _, _ = scenes
    jtr, ttr = _trainers(scenes, _recipe(jconfig), _recipe(tconfig))
    state = _scene_model(ttr)
    _set_model(jtr, ttr, *state)
    jl, tl = _Logger(), _Logger()
    want = jtr.training_report(7, logger=jl)
    got = ttr.training_report(7, logger=tl)
    assert set(got) == set(want)
    assert {"train/psnr_msi", "test/l1_loss_msi"} <= set(got)
    for k, v in want.items():
        assert abs(got[k] - v) <= 1e-4, k
    assert set(tl.images) == set(jl.images) and tl.scalars == got
    mc = TMae.from_synthetic(d, SCENE_KW["scale"])
    ttr.mae_computer = mc
    with_mae = ttr.training_report(8, logger=tl)
    assert with_mae["report/MAE"] == t_eval_mae(ttr.model, ttr.scene, mc,
                                                TCFG)[0]
    assert {"report/RDSM", "report/abs_diff"} <= set(tl.images)


def test_calibrate_opacity_init_matches_jax(scenes, monkeypatch):
    jtr, ttr = _trainers(scenes, _recipe(jconfig), _recipe(tconfig))
    accs = []
    render = tt.render_view_full

    def recording(*a, **kw):
        out = render(*a, **kw)
        accs.append(float(np.mean(out["acc_opacity"])))
        return out

    monkeypatch.setattr(tt, "render_view_full", recording)
    # at this target every decision's margin is above 1e-4
    want = jtr.calibrate_opacity_init(target_acc=0.9)
    got = ttr.calibrate_opacity_init(target_acc=0.9)
    assert abs(got - want) <= 1e-4 * want and 0.01 < got < 0.9
    assert len(accs) == 12 and min(abs(a - 0.9) for a in accs) > 1e-4
    np.testing.assert_allclose(ttr.model.opacity.detach().numpy(),
                               np.asarray(jtr.state.params.opacity),
                               rtol=1e-5, atol=0)


def test_early_stopping_matches_jax(scenes, monkeypatch):
    """A fixed photometric sequence through both loops: the break comes at
    the same logged interval (patience counts intervals; a zero metric is
    skipped), before that iteration's eval hook."""
    seq = [0.9, 0.8, 0.7, 0.75, 0.0, 0.0, 0.72, 0.69, 0.7, 0.71, 0.7, 0.7,
           0.7, 0.7, 0.7, 0.7, 0.7, 0.7, 0.7, 0.7]
    opt = dict(only_prune=True)
    cj, ct = _recipe(jconfig, 40, **opt), _recipe(tconfig, 40, **opt)
    for c in (cj, ct):
        c.logging.tb_log_interval = 2
        c.logging.testing_interval = 2
        c.optimization.early_stopping.use_early_stopping = True
        c.optimization.early_stopping.patience = 3
    jtr, ttr = _trainers(scenes, cj, ct)
    value = lambda it: seq[(it - 1) // 2]

    def jstep(state, view_idx, key, gates):
        it = int(state.step) + 1
        return state.replace(step=state.step + 1), {
            "photometric": jnp.float32(value(it)), "loss": jnp.float32(1.0)}

    monkeypatch.setattr(jtr, "_get_step", lambda phase: jstep)
    monkeypatch.setattr(ttr, "train_step", lambda it: {
        "photometric": torch.tensor(value(it), dtype=torch.float32),
        "loss": torch.tensor(1.0)})
    hooks = {"j": [], "t": []}
    jtr.eval_hook = lambda tr, st, it: hooks["j"].append(it)
    ttr.eval_hook = lambda tr, m, it: hooks["t"].append(it)
    jtr.train(40, progress=False)
    ttr.train(40, progress=False)
    stop = [m["iteration"] for m in jtr.metrics_history]
    assert [m["iteration"] for m in ttr.metrics_history] == stop
    # intervals 7 (0.69) resets the patience, 8-10 spend it: the break at
    # iteration 22 comes before its eval hook
    assert stop[-1] == 22
    assert hooks["t"] == hooks["j"] == list(range(2, 22, 2))


def test_check_supported_passes_items_7_and_8(scenes):
    """learnwv with densification, the opacity reset, early stopping,
    training_report and the eval hook trains (a short run)."""
    cfg = _recipe(tconfig, 6)
    cfg.optimization.iterstart_shadowmapping = 0
    cfg.optimization.iterstart_L_new_resample = 0
    cfg.optimization.early_stopping.use_early_stopping = True
    cfg.logging.tb_log_interval = 2
    cfg.logging.testing_interval = 3
    cfg.logging.big_testing_iterations = [6]
    tr = tt.Trainer(cfg, scenes[2], TCFG, device="cpu").setup()
    seen = []
    tr.eval_hook = lambda t, m, it: seen.append((it, m is t.model))
    logs = []
    tr.log_hook = lambda t, m, it: logs.append(it)
    tr.train(6)
    assert seen == [(3, True), (6, True)] and logs == [2, 4, 6]
    assert [e["iteration"] for e in tr.densify_log] == [5]
    assert all(np.isfinite(v) for m in tr.metrics_history for v in m.values())


# ---------------------------------------------------------------------------
# the end-to-end chain (tests/test_e2e.py's), slow
# ---------------------------------------------------------------------------


@pytest.mark.slow
def test_e2e_training_improves_dsm_mae(tmp_path):
    """tests/test_e2e.py's chain through the port: synthetic scene -> 550
    baseogs iterations (sun and random camera from 60) -> the Nadir DSM's
    MAE every 250 iterations; the final MAE beats the one at 250."""
    from eogs2_tpu_torch.scene import load_scene

    d = str(tmp_path)
    generate_scene(d, n_views=6, width=64, height=64, hf_res=128,
                   n_buildings=4, scale=12.0, seed=3)
    scene = load_scene(d, images_msi_path=os.path.join(d, "images"),
                       eval_split=True, load_pan=False, device="cpu")
    cfg = tconfig.baseogs(d, iterations=550)
    cfg.logging.tb_log_interval = 10
    cfg.logging.testing_interval = 250
    cfg.optimization.iterstart_shadowmapping = 60
    cfg.optimization.iterstart_L_new_resample = 60
    rcfg = RasterizeConfig(binning_mode="fused", tile_cull=True)
    tr = tt.Trainer(cfg, scene, rcfg, device="cpu").setup()
    mc = TMae.from_synthetic(d, scale=12.0, resolution=0.5)
    maes = {}
    tr.eval_hook = lambda t, m, it: maes.__setitem__(
        it, t_eval_mae(m, scene, mc, rcfg, resolution=0.5)[0])
    tr.train(progress=False)
    mae1 = t_eval_mae(tr.model, scene, mc, rcfg, resolution=0.5)[0]
    assert np.isfinite(mae1) and mae1 < maes[250]
    h = tr.metrics_history
    assert h[-1]["photometric"] < 0.6 * h[0]["photometric"]
