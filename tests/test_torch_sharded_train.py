"""The port's multi-device training on the CPU: Trainers in gloo process
groups of 2 and 4 ranks (tests/torch_parallel_worker.py, no JAX in the
ranks) held against the one-device port, views_per_step against JAX, and
the CLI's multi-device options.

  * a2a: the Trainer's steps (main, sun and random-camera renders through
    rasterize_a2a, capacities probed) against the one-device fused step:
    loss terms rel 1e-4, gradients max-normalised 2e-4, densification
    statistics rel 2e-4 (tests/test_torch_train.py's step tolerances); no
    pair dropped; dest_cap a multiple of 128;
  * gspmd with a mesh: the state after steps, densification, the opacity
    reset, a model save, a checkpoint and a restore equal to the one-device
    Trainer's within 1e-6;
  * views_per_step = 2: the port's step against JAX's vmapped step on one
    device (the step tolerances above), and over a ("d", "g") mesh of 4
    ranks against the port on one device;
  * dest_cap too small: dropped pairs in the metrics, the grow, no drops
    after it;
  * the CLI: train --n-devices 2 --raster-backend a2a --device cpu, render,
    tsdf --n-devices 2 equal to tsdf on one device; more ranks than cards
    raises.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import eogs2_tpu.config as jconfig
from eogs2_tpu import train as jt
from eogs2_tpu.data.synthetic import generate_scene
from eogs2_tpu.model import GaussianAux, GaussianParams
from eogs2_tpu.model import init_from_points as j_init
from eogs2_tpu.rasterizer import RasterizeConfig as JConfig
from eogs2_tpu.scene import load_scene as j_load
from eogs2_tpu.shading import CameraShadingParams as JShading
import eogs2_tpu_torch.config as tconfig
from eogs2_tpu_torch import cli
from eogs2_tpu_torch import train as tt
from eogs2_tpu_torch.data.synthetic import make_scene_arrays, \
    scene_from_arrays
from eogs2_tpu_torch.model import GaussianModel
from eogs2_tpu_torch.rasterizer import RasterizeConfig
from eogs2_tpu_torch.shading import CameraShadingParams
from tests import torch_parallel_worker as W

FUSED = dict(binning_mode="fused", tile_cull=True)
ALL_RENDERS = dict(iterstart_shadowmapping=0, iterstart_L_new_resample=0)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run this file's torch ops on one thread: beside the other test
    workers, torch's default pool oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


def _grads(rs):
    return {f: torch.cat([r["grads"][f] for r in rs]) for f in rs[0]["grads"]}


def _check_step(rs, one, grad_tol=2e-4, term_tol=1e-4):
    for r in rs:
        for m, w in zip(r["history"], one["history"]):
            for k in ("loss", "photometric", "L1", "psnr", "L_opacity",
                      "L_opacity_radii", "L_sun_altitude_resample",
                      "L_new_rgb_resample", "grad_m2d_max"):
                assert abs(m[k] - w[k]) <= term_tol * abs(w[k]) + 1e-9, k
            for k in ("num_pairs", "alive"):
                assert m[k] == w[k], k
    for f, g in _grads(rs).items():
        assert float(one["grads"][f].abs().max()) > 0, f
        assert _rel(g, one["grads"][f]) < grad_tol, f
    for k, g in rs[0]["shading_grad"].items():
        assert _rel(g, one["shading_grad"][k]) < grad_tol, k
    w = rs[0]["aux"]
    assert torch.equal(w["denom"], one["aux"]["denom"])
    assert torch.equal(w["max_radii2d"], one["aux"]["max_radii2d"])
    assert _rel(w["xyz_gradient_accum"],
                one["aux"]["xyz_gradient_accum"]) < 2e-4


def test_a2a_trainer_matches_one_device(tmp_path):
    """Two iterations of the three-render step on the a2a path at 2 ranks,
    the learnable pose on (its gradient is summed over the ranks)."""
    kw = dict(ALL_RENDERS, iterstart_learn_wv_transform=0)
    one = W.train_one(2, "gspmd", kw, FUSED, probe=True)
    rs = W.run(W.train_ranks, 2, tmp_path, 2, "a2a", ("g",), kw, FUSED,
               True)
    _check_step(rs, one)
    rc = rs[0]["raster_cfg"]
    assert rc.dest_cap % 128 == 0 and rc.dest_cap < 1 << 16
    for m in rs[0]["history"]:
        assert m["dropped_pairs"] == 0
        assert 0 < m["max_dest_count"] <= rc.dest_cap
        assert m["max_tile"] < rc.tile_capacity


def test_gspmd_trainer_equals_one_device(tmp_path):
    """Eight iterations with clone/split every 2 from iteration 3 and the
    opacity reset at 6, then the coordinator's model save and checkpoint
    and a restore into a fresh sharded Trainer: the state within 1e-6 of
    the one-device Trainer's."""
    kw = dict(ALL_RENDERS, **{"densification.densify_from_iter": 2,
                              "densification.densification_interval": 2,
                              "densification.densify_grad_threshold": 1e-5,
                              "opacity_reset_interval": 6,
                              "only_prune": False})
    one = W.train_one(8, "gspmd", kw, FUSED)
    save = str(tmp_path / "run")
    rs = W.run(W.train_ranks, 2, tmp_path / "ranks", 8, "gspmd", ("g",), kw,
               FUSED, False, save)
    assert any(d["cloned"] + d["split"] > 0 for d in one["densify_log"])
    assert rs[0]["densify_log"] == one["densify_log"]
    for r in rs:
        for part in ("params", "aux", "moments"):
            for f, x in r[part].items():
                np.testing.assert_allclose(
                    x.float().numpy(), one[part][f].float().numpy(),
                    atol=1e-6, rtol=0, err_msg=f"{part}.{f}")
        assert r["restored_equal"]
    tree = torch.load(os.path.join(save, "chkpnt"), weights_only=True)
    np.testing.assert_allclose(tree["params"]["xyz"].numpy(),
                               one["params"]["xyz"].numpy(), atol=1e-6)
    assert os.path.exists(os.path.join(save, "point_cloud", "iteration_8",
                                       "point_cloud.ply"))


@pytest.fixture(scope="module")
def batched(tmp_path_factory):
    """One step of each package with views_per_step = 2 from the same
    state, on views (0, 2), with JAX's draws; JAX's gradients come back as
    an optax state that stores them, the port's stay in .grad."""
    d = str(tmp_path_factory.mktemp("scene"))
    generate_scene(d, **W.SCENE_KW)
    js = j_load(d, images_msi_path=os.path.join(d, "images"), load_pan=False)
    ts = scene_from_arrays(make_scene_arrays(**W.SCENE_KW), device="cpu")
    n = len(js.init_xyz)
    cap = ((int(n * 1.25) + 127) // 128) * 128
    jm = j_init(js.init_xyz, js.init_rgb, cap)
    rng = np.random.RandomState(1)
    params = {f: np.array(getattr(jm.params, f))
              for f in GaussianParams.__dataclass_fields__}
    op = rng.uniform(0.2, 0.9, n)
    params["opacity"][:n, 0] = np.log(op / (1 - op))
    params["scaling"][:n] += rng.normal(0, 0.3, (n, 3)) - 0.7
    aux = {f: np.array(getattr(jm.aux, f))
           for f in GaussianAux.__dataclass_fields__}
    v = len(js.train_views)
    shade = dict(
        cc_weight=np.eye(3)[None] + 0.1 * rng.normal(size=(v, 3, 3)),
        cc_bias=0.05 * rng.normal(size=(v, 3)),
        inshadow=rng.uniform(0.05, 0.3, (v, 3)), last_row=np.zeros((v, 4)),
        exposure=np.tile(np.eye(3, 4)[None], (v, 1, 1)),
        msi_to_pan_weight=np.ones((v, 3)) / 3, msi_to_pan_bias=np.zeros(v),
        transient_mask=rng.uniform(0.0, 0.3, (v, 1, 1)))
    shade = {k: np.asarray(x, np.float32) for k, x in shade.items()}
    jc = jconfig.baseogs(iterations=10)
    tc = tconfig.baseogs(iterations=10)
    for c in (jc, tc):
        for k, x in ALL_RENDERS.items():
            setattr(c.optimization, k, x)
        c.optimization.views_per_step = 2
    iteration, views = 5, (0, 2)
    phase = dict(enable_sun=True, enable_random=True)

    store = optax.GradientTransformation(
        lambda p: p, lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))
    jraster = JConfig(binning_mode="fused", tile_cull=True,
                      tile_capacity=2048, max_tiles_per_gaussian=64)
    jstep = jt.make_train_step(
        (("msi", jt.build_scene_tensors_from_views(js.train_views), None,
          0),), jc, jraster, jt.Phase(**phase), store, store,
        spatial_lr_scale=js.cameras_extent)
    gp = GaussianParams(**{k: jnp.asarray(x) for k, x in params.items()})
    sp = JShading(**{k: jnp.asarray(x) for k, x in shade.items()})
    state = jt.TrainState(
        params=gp,
        aux=GaussianAux(**{k: jnp.asarray(x) for k, x in aux.items()}),
        shading=sp, g_opt=gp, c_opt=sp, step=jnp.int32(0))
    key = jax.random.PRNGKey(3)
    new, jmetrics = jstep(state, jnp.asarray(views, jnp.int32), key,
                          jt.make_gates(jc, iteration, n))
    bkeys = jax.random.split(jax.random.split(key, 1)[0], len(views))
    bg, shear = [], []
    for k in bkeys:
        k_bg, k_rand = jax.random.split(k)
        bg.append(np.asarray(jax.random.uniform(k_bg, (5,))))
        shear.append(np.asarray(jax.random.normal(k_rand, (2,))))

    model = GaussianModel.from_numpy(params, aux, device="cpu")
    shading = CameraShadingParams.from_numpy(shade, device="cpu")
    gopt = tt.gaussian_optimizer(model, tc, ts.cameras_extent)
    copt = tt.camera_optimizer(shading, tc)
    tstep = tt.make_train_step(
        (("msi", tt.build_scene_tensors_from_views(ts.train_views,
                                                   device="cpu"), None, 0),),
        tc, RasterizeConfig(**FUSED), tt.Phase(**phase), gopt, copt)
    tmetrics = tstep(model, shading, list(views),
                     torch.from_numpy(np.stack(bg))[:, None],
                     torch.from_numpy(np.stack(shear))[:, None],
                     tt.make_gates(tc, iteration, n))
    return dict(new=new, jmetrics=jmetrics, model=model, shading=shading,
                tmetrics=tmetrics)


def test_views_per_step_matches_jax(batched):
    jm, tm = batched["jmetrics"], batched["tmetrics"]
    for k in ("loss", "L1", "photometric", "psnr", "L_opacity",
              "L_sun_altitude_resample", "L_new_rgb_resample",
              "grad_m2d_max", "num_pairs", "sat_frac"):
        assert abs(float(tm[k]) - float(jm[k])) <= \
            1e-4 * abs(float(jm[k])) + 1e-9, k
    new, model = batched["new"], batched["model"]
    for f in ("xyz", "features_dc", "scaling", "rotation", "opacity"):
        want = np.asarray(getattr(new.g_opt, f))
        assert np.abs(want).max() > 0, f
        assert _rel(getattr(model, f).grad.numpy(), want) < 2e-4, f
    for f in ("cc_weight", "cc_bias", "exposure"):
        assert _rel(getattr(batched["shading"], f).grad.numpy(),
                    np.asarray(getattr(new.c_opt, f))) < 2e-4, f
    np.testing.assert_array_equal(model.denom.numpy(),
                                  np.asarray(new.aux.denom))
    np.testing.assert_array_equal(model.max_radii2d.numpy(),
                                  np.asarray(new.aux.max_radii2d))


def test_views_split_over_d_axis(tmp_path):
    """views_per_step = 2 over a ("d", "g") = (2, 2) mesh, gspmd: each "d"
    row renders one view, the gradients summed over "d"; one step against
    the one-device step."""
    kw = dict(ALL_RENDERS, views_per_step=2)
    one = W.train_one(1, "gspmd", kw, FUSED)
    rs = W.run(W.train_ranks, 4, tmp_path, 1, "gspmd", ("d", "g"), kw, FUSED)
    # ranks (d, g): the "g" shards are ranks 0-1 and 2-3's
    _check_step(rs[:2], one, grad_tol=1e-5, term_tol=1e-6)
    for f in one["grads"]:
        assert torch.equal(rs[0]["grads"][f], rs[2]["grads"][f]), f


def test_a2a_dest_cap_grows_after_drops(tmp_path):
    """A dest_cap far below the windows' demand drops pairs; the capacity
    check grows it past the windows and the next step drops none."""
    rs = W.run(W.grow_dest_cap, 2, tmp_path, 32)
    for r in rs:
        assert r["dropped_before"] > 0
        assert r["dest_cap"] > 32 and r["dest_cap"] % 128 == 0
        assert r["dropped_after"] == 0
        assert r["max_dest_after"] <= r["dest_cap"]


def test_cli_multi_device_chain(tmp_path):
    """train --raster-backend a2a in a group of 2 ranks joined with
    --coordinator/--num-processes/--process-id (each rank runs the command,
    as on hosts of one card each; TensorBoard blocked in the ranks, whose
    import dominates here) on a 64^2 synthetic scene; render; then tsdf
    --n-devices 2 (two local ranks started by the CLI) against tsdf on one
    device: the same DSM file."""
    d, run = str(tmp_path / "scene"), str(tmp_path / "run")
    cpu = ["--device", "cpu"]
    assert cli.main(["make-synthetic", *cpu, "--out", d, "--n-views", "4",
                     "--width", "64", "--height", "64", "--hf-res", "128",
                     "--n-buildings", "4", "--scale", "12"]) == 0
    rcs = W.run(W.cli_rank, 2, tmp_path / "ranks", [
        "train", *cpu, "--scene-dir", d, "--model-path", run,
        "--raster-mode", "fused", "--iterations", "3",
        "--raster-backend", "a2a", "--checkpoint-every", "3"])
    assert rcs == [0, 0]
    assert os.path.getsize(os.path.join(
        run, "point_cloud", "iteration_3", "point_cloud.ply")) > 0
    assert os.path.exists(os.path.join(run, "chkpnt3"))
    assert os.path.exists(os.path.join(run, "proc1", "metrics.json"))
    assert not os.path.exists(os.path.join(run, "proc1", "point_cloud"))
    assert cli.main(["render", *cpu, "--scene-dir", d, "--model-path", run,
                     "--tile-capacity", "256"]) == 0
    dsm = os.path.join(run, "test_opNone", "ours_3", "tsdf", "dsm.tif")
    assert cli.main(["tsdf", *cpu, "--scene-dir", d, "--model-path", run,
                     "--vox-size", "1.0", "--n-devices", "2"]) == 0
    sharded = open(dsm, "rb").read()
    assert cli.main(["tsdf", *cpu, "--scene-dir", d, "--model-path", run,
                     "--vox-size", "1.0"]) == 0
    assert open(dsm, "rb").read() == sharded


def test_cli_n_devices_above_visible_cards_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="--n-devices 2 needs 2 CUDA "
                                         "devices; 1 visible"):
        cli.main(["train", "--scene-dir", str(tmp_path), "--n-devices", "2"])
