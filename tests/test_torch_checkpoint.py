"""Checkpoints and model saves of the port (eogs2_tpu_torch/checkpoint.py,
Trainer.save_model / restore) on a tiny scene, on the CPU, on the safe
route (gather binning, the plain dense blend) in both packages.

  * the port's own round trip is bit-exact: parameters, bookkeeping,
    shading, both Adam states and the step count, and the step taken after
    a restore equals, bit for bit, the step the original Trainer takes with
    the same draws;
  * a JAX TrainState after 5 steps (its _state_to_pytree as numpy) loads
    into a port Trainer through state_from_numpy, and one more step in each
    package from there, with JAX's draws, agrees under
    tests/test_torch_train.py's one-step tolerances: loss terms rel 1e-4,
    the new first moments (the gradients folded in) max-normalised 2e-4;
    the parameters' Adam updates, whose size the carried count sets through
    the bias correction, max-normalised 2e-3 (Adam divides by sqrt(v), so
    the 2e-4 gradient tolerance grows where v is small);
  * a capacity mismatch raises;
  * save_model writes the PLY JAX writes for the same rows, and the test
    cameras' shading of test_shading_params.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import eogs2_tpu.config as jconfig
from eogs2_tpu import train as jt
from eogs2_tpu.checkpoint import _state_to_pytree
from eogs2_tpu.data.synthetic import generate_scene
from eogs2_tpu.io import ply as jply
from eogs2_tpu.rasterizer import RasterizeConfig as JConfig
from eogs2_tpu.scene import load_scene as j_load
import eogs2_tpu_torch.config as tconfig
from eogs2_tpu_torch import train as tt
from eogs2_tpu_torch.checkpoint import (restore_checkpoint, save_checkpoint,
                                        state_from_numpy)
from eogs2_tpu_torch.model import GaussianAux, GaussianParams
from eogs2_tpu_torch.rasterizer import RasterizeConfig
from eogs2_tpu_torch.scene import load_scene as t_load

SCENE_KW = dict(n_views=3, width=32, height=32, hf_res=64, n_buildings=2,
                scale=8.0, seed=1)
RC = dict(pair_capacity=1 << 14, tile_capacity=256, tile_chunk=8)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run this file's torch ops on one thread: beside the other test
    workers, torch's default pool (one thread per core) oversubscribes the
    cores and its many small parallel regions slow the file tenfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(config):
    cfg = config.baseogs(iterations=30)
    cfg.optimization.iterstart_shadowmapping = 0
    cfg.optimization.iterstart_L_new_resample = 0
    cfg.logging.tb_log_interval = 10
    return cfg


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("scene"))
    generate_scene(d, **SCENE_KW)
    return d


def _trainer(d, **load_kw):
    scene = t_load(d, images_msi_path=os.path.join(d, "images"),
                   load_pan=False, device="cpu", **load_kw)
    return tt.Trainer(_cfg(tconfig), scene, RasterizeConfig(**RC),
                      device="cpu").setup()


def _state(tr):
    """Every tensor of the Trainer's state, by name (copies)."""
    out = {}
    for f in GaussianParams._fields + GaussianAux._fields:
        out[f] = getattr(tr.model, f).detach().clone()
    for f in dataclasses.fields(tr.shading):
        out["shading." + f.name] = getattr(tr.shading, f.name).detach().clone()
    for name, opt in (("g", tr.gauss_opt), ("c", tr.cam_opt)):
        for i, p in enumerate(q for g in opt.param_groups for q in g["params"]):
            for k, v in opt.state.get(p, {}).items():
                out[f"{name}{i}.{k}"] = v.detach().clone()
    return out


def _assert_same_state(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        assert torch.equal(a[k], b[k]), k


def _draws(iteration, tr):
    g = torch.Generator().manual_seed(iteration)
    return (torch.rand(5, generator=g), torch.randn(2, generator=g),
            tt.make_gates(tr.cfg, iteration, tr.init_count))


def test_checkpoint_round_trip_is_bit_exact(scene_dir, tmp_path):
    tr = _trainer(scene_dir)
    tr.train(5, progress=False)
    ck = str(tmp_path / "ck")
    save_checkpoint(ck, tr, 5)
    tr2 = _trainer(scene_dir)
    assert tr2.restore(ck) == 5
    assert tr2.step == tr.step == 5
    before = _state(tr)
    _assert_same_state(_state(tr2), before)
    assert {int(s["step"]) for s in tr2.gauss_opt.state.values()} == {5}
    # the restored Trainer steps exactly as the original does
    phase = tt.phase_for_iteration(tr.cfg, 6)
    bg, shear, gates = _draws(6, tr)
    for t in (tr, tr2):
        t._get_step(phase)(t.model, t.shading, 1, bg, shear, gates)
    after = _state(tr)
    _assert_same_state(_state(tr2), after)
    assert not torch.equal(after["xyz"], before["xyz"])


def test_leaf_without_adam_state_gets_none(scene_dir, tmp_path):
    tr = _trainer(scene_dir)
    ck = str(tmp_path / "ck0")
    save_checkpoint(ck, tr, 0)  # before any step: no Adam state at all
    tr2 = _trainer(scene_dir)
    tr2.train(2, progress=False)
    assert len(tr2.gauss_opt.state) > 0
    assert restore_checkpoint(ck, tr2) == 0
    assert all("exp_avg" not in tr2.gauss_opt.state.get(p, {})
               for p in tr2.model.parameters() if p.numel())
    _assert_same_state(_state(tr2), _state(tr))


def test_capacity_mismatch_raises(scene_dir, tmp_path):
    tr = _trainer(scene_dir)
    ck = str(tmp_path / "ck")
    save_checkpoint(ck, tr, 0)
    other = _trainer(scene_dir, target_density=0.2)
    assert other.model.xyz.shape != tr.model.xyz.shape
    with pytest.raises(ValueError, match="same capacity"):
        other.restore(ck)


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


def test_jax_state_carries_into_the_port(scene_dir):
    """5 JAX steps, the state into the port, then one step each."""
    js = j_load(scene_dir, images_msi_path=os.path.join(scene_dir, "images"),
                load_pan=False)
    jtr = jt.Trainer(cfg=_cfg(jconfig), scene=js,
                     raster_cfg=JConfig(**RC)).setup()
    jtr.train(max_iterations=5, progress=False)
    tree = jax.tree.map(np.asarray, _state_to_pytree(jtr.state))
    assert int(tree["g_opt"]["count"]) == 5

    tr = _trainer(scene_dir)
    assert state_from_numpy(tree, tr) == 5 and tr.step == 5
    for f in GaussianParams._fields:
        np.testing.assert_array_equal(getattr(tr.model, f).detach().numpy(),
                                      tree["params"][f])
        if tree["params"][f].size:
            st = tr.gauss_opt.state[getattr(tr.model, f)]
            assert int(st["step"]) == 5
            np.testing.assert_array_equal(st["exp_avg"].numpy(),
                                          tree["g_opt"]["mu"][f])
    old = {f: tree["params"][f] for f in ("xyz", "features_dc", "scaling",
                                          "rotation", "opacity")}

    iteration, view = 6, 1
    key = jax.random.PRNGKey(3)
    jphase = jt.phase_for_iteration(jtr.cfg, iteration)
    new, jm = jtr._get_step(jphase)(
        jtr.state, jnp.int32(view), key,
        jt.make_gates(jtr.cfg, iteration, jtr.init_count))
    k_bg, k_rand = jax.random.split(jax.random.split(key, 1)[0])
    bg = torch.from_numpy(np.array(jax.random.uniform(k_bg, (5,))))
    shear = torch.from_numpy(np.array(jax.random.normal(k_rand, (2,))))
    tm = tr._get_step(tt.phase_for_iteration(tr.cfg, iteration))(
        tr.model, tr.shading, view, bg, shear,
        tt.make_gates(tr.cfg, iteration, tr.init_count))

    for k in ("loss", "L1", "photometric", "L_sun_altitude_resample",
              "L_new_altitude_resample"):
        assert abs(float(tm[k]) - float(jm[k])) <= \
            1e-4 * abs(float(jm[k])) + 1e-9, k
    for f, p0 in old.items():
        p = getattr(tr.model, f)
        st = tr.gauss_opt.state[p]
        assert int(st["step"]) == 6
        assert _rel(st["exp_avg"].numpy(), getattr(new.g_opt.mu, f)) < 2e-4, f
        jd = np.asarray(getattr(new.params, f)) - p0
        assert np.abs(jd).max() > 0, f
        assert _rel(p.detach().numpy() - p0, jd) < 2e-3, f


def test_save_model_files(scene_dir, tmp_path):
    tr = _trainer(scene_dir)
    tr.cfg.logging.model_path = str(tmp_path / "run")
    tr.cfg.save_iterations = (3,)
    tr.cfg.checkpoint_iterations = (4,)
    tr.train(4, progress=False)
    run = tmp_path / "run"
    assert (run / "point_cloud" / "iteration_3" / "point_cloud.ply").exists()
    assert (run / "chkpnt4").exists()
    assert tr.save_model() == 4

    alive = tr.model.alive.numpy()
    p = {f: getattr(tr.model, f).detach().numpy()[alive]
         for f in GaussianParams._fields}
    jply.save_gaussians_ply(str(tmp_path / "j.ply"), p["xyz"],
                            p["features_dc"], p["features_rest"],
                            p["opacity"], p["scaling"], p["rotation"])
    ply = run / "point_cloud" / "iteration_4" / "point_cloud.ply"
    assert ply.read_bytes() == (tmp_path / "j.ply").read_bytes()

    cam = run / "camera_params" / "iteration_4"
    want = tr.test_shading_params()
    got = torch.load(cam / "shading_test", weights_only=True)
    shading = torch.load(cam / "shading", weights_only=True)
    for f in dataclasses.fields(want):
        assert torch.equal(got[f.name], getattr(want, f.name)), f.name
        assert torch.equal(shading[f.name],
                           getattr(tr.shading, f.name).detach()), f.name
    adam = torch.load(run / "optimizer" / "iteration_4" / "adam",
                      weights_only=True)
    assert sorted(adam) == ["c_mu", "c_nu", "g_mu", "g_nu"]
    assert "features_rest" not in adam["g_mu"]  # zero-size at SH degree 0
    assert torch.equal(adam["g_nu"]["xyz"],
                       tr.gauss_opt.state[tr.model.xyz]["exp_avg_sq"])
