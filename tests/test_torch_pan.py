"""The PAN and dual-MS modalities of eogs2_tpu_torch against eogs2_tpu's,
both on the CPU: the GT rescalers, pansharpening, the PAN losses, the
synthetic scene in modality "ms" and its loading, the one-time
pansharpening of Trainer.setup; and the Trainer training every preset that
loads PAN cameras and every PAN mode (eogsplus, optical_flow, onlyPAN,
average, the dual MS fixed) with the flow phase, the flow bake, the colour
reset and normalize_colors_before_saving, and a dual-MS checkpoint
restored.

Inputs are made with numpy from fixed seeds and handed to both packages.
Tolerances: rescalers, pansharpening and the PAN losses rel 1e-5 (the
same float32 formulas; the resize's weight matrices contract in another
order); the ms scene's images and metadata bit-equal.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import eogs2_tpu.losses as JL
from eogs2_tpu import pansharpen as jps
from eogs2_tpu import rescalers as jres
from eogs2_tpu.data.synthetic import generate_scene
from eogs2_tpu.scene import load_scene as j_load
import eogs2_tpu_torch.config as tconfig
import eogs2_tpu_torch.losses as TL
from eogs2_tpu_torch import pansharpen as tps
from eogs2_tpu_torch import rescalers as tres
from eogs2_tpu_torch import train as tt
from eogs2_tpu_torch.checkpoint import save_checkpoint
from eogs2_tpu_torch.data.synthetic import (make_scene_arrays,
                                            scene_from_arrays, write_scene)
from eogs2_tpu_torch.io.tiff import read_tiff
from eogs2_tpu_torch.rasterizer import RasterizeConfig
from eogs2_tpu_torch.scene import load_scene as t_load

SCENE_KW = dict(n_views=3, width=32, height=32, hf_res=64, n_buildings=2,
                seed=3, scale=6.0)
RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run this file's torch ops on one thread: beside the other test
    workers, torch's default pool (one thread per core) oversubscribes the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


@pytest.fixture(scope="module")
def ms_scene(tmp_path_factory):
    """The ms scene written by JAX, and the port's in memory."""
    d = str(tmp_path_factory.mktemp("ms"))
    generate_scene(d, modality="ms", **SCENE_KW)
    return d, make_scene_arrays(modality="ms", **SCENE_KW)


def test_rescalers_match_jax():
    rng = np.random.RandomState(0)
    imgs = [rng.uniform(-0.2, 1.3, (3, 24, 20)).astype(np.float32),
            rng.uniform(0.1, 0.6, (1, 24, 20)).astype(np.float32)]
    for name in ("clamper", "standard_rescaler", "identity",
                 "histogram_equalizer", "CLAHE_rescaler",
                 "rescale_wrt_firstimage"):
        for img in imgs:
            ref = img + 0.05
            want = jres.load_rescaler(name, reference_image=ref)(img)
            got = tres.load_rescaler(name, reference_image=ref)(img)
            assert got.dtype == want.dtype, name
            assert _rel(got, want) <= RTOL, name
    with pytest.raises(ValueError, match="unknown rescaler"):
        tres.load_rescaler("nope")


def test_pansharpen_matches_jax():
    """Brovey, simple Brovey and IHS with the MSI upsampled (4x, and a
    non-integer ratio) and downsampled (the resize's antialiased kernel)."""
    rng = np.random.RandomState(1)
    for msi_hw, pan_hw in (((8, 6), (32, 24)), ((10, 7), (24, 20)),
                           ((30, 26), (12, 10))):
        msi = rng.uniform(0.05, 1.0, (3,) + msi_hw).astype(np.float32)
        pan = rng.uniform(0.05, 1.0, (1,) + pan_hw).astype(np.float32)
        want = np.asarray(jps.resize_chw(jnp.asarray(msi), pan_hw))
        assert _rel(tps.resize_chw(torch.from_numpy(msi), pan_hw), want) \
            <= RTOL
        for method in ("brovey", "simple_brovey", "ihs"):
            for p in ((pan, pan[0]) if method == "brovey" else (pan,)):
                want = np.asarray(jps.load_pansharp(method)(
                    jnp.asarray(p), jnp.asarray(msi)))
                got = tps.load_pansharp(method)(torch.from_numpy(p),
                                                torch.from_numpy(msi))
                assert got.shape == want.shape, method
                assert _rel(got, want) <= RTOL, (method, msi_hw)


def test_pan_losses_match_jax():
    rng = np.random.RandomState(2)
    pan = rng.uniform(0, 1, (1, 24, 20)).astype(np.float32)
    gt_pan = rng.uniform(0, 1, (1, 24, 20)).astype(np.float32)
    gt_msi = rng.uniform(0.1, 1, (3, 6, 5)).astype(np.float32)
    syn = rng.uniform(0, 1, (3, 24, 20)).astype(np.float32)
    flow = rng.normal(size=(2, 24, 20)).astype(np.float32)
    j, t = jnp.asarray, torch.from_numpy
    for want, got in (
            (JL.flowmatch_loss(j(flow)), TL.flowmatch_loss(t(flow))),
            (JL.pan_l2_loss(j(pan), j(gt_pan)),
             TL.pan_l2_loss(t(pan), t(gt_pan))),
            (JL.pan_gradient_loss(j(pan), j(gt_pan)),
             TL.pan_gradient_loss(t(pan), t(gt_pan))),
            (JL.pansharp_loss(j(syn), j(gt_pan), j(gt_msi)),
             TL.pansharp_loss(t(syn), t(gt_pan), t(gt_msi))),
            (JL.pansharp_loss(j(syn), j(gt_pan), j(gt_msi), "ihs"),
             TL.pansharp_loss(t(syn), t(gt_pan), t(gt_msi), "ihs"))):
        assert float(want) != 0.0
        assert _rel(got, want) <= RTOL


def test_ms_scene_matches_jax(ms_scene, tmp_path):
    """generate_scene(modality="ms"): JAX's files hold the port's images
    and metadata bit for bit; the port's written scene loads to the scene
    JAX loads, in the 3PAN selection (pan cameras only) and the dual one."""
    d, arrays = ms_scene
    with open(os.path.join(d, "affine_models.json")) as f:
        assert json.load(f) == json.loads(json.dumps(arrays.metadatas))
    assert set(arrays.metadatas) == {"msi", "pan"}
    for sub, imgs in (("images", arrays.images),
                      ("images_pan", arrays.images_pan)):
        assert sorted(os.listdir(os.path.join(d, sub))) == sorted(imgs)
        for name, img in imgs.items():
            got = read_tiff(os.path.join(d, sub, name))[0]
            assert got.dtype == img.dtype == np.float32
            np.testing.assert_array_equal(got, img)
    out = write_scene(arrays, str(tmp_path / "t"))
    for load_msi in (False, True):
        kw = dict(images_msi_path=os.path.join(d, "images"),
                  images_pan_path=os.path.join(d, "images_pan"),
                  load_msi=load_msi)
        js = j_load(d, **kw)
        kw.update(images_msi_path=os.path.join(out, "images"),
                  images_pan_path=os.path.join(out, "images_pan"))
        for ts in (t_load(out, device="cpu", **kw),
                   scene_from_arrays(arrays, device="cpu",
                                     load_msi=load_msi)):
            for split in ("train_views", "test_views"):
                jv, tv = getattr(js, split), getattr(ts, split)
                assert [(v.name, v.image_type) for v in tv] == \
                    [(v.name, v.image_type) for v in jv]
                for a, b in zip(tv, jv):
                    if b.image is None:
                        assert a.image is None
                    else:
                        np.testing.assert_array_equal(a.image, b.image)
                    np.testing.assert_array_equal(
                        a.camera.affine.numpy(), np.asarray(b.camera.affine))


def _fixed_cfg(iterations=4):
    cfg = tconfig._apply_mode(tconfig.baseogs(iterations=iterations),
                              "fixed")
    cfg.optimization.apply_pansharp = True
    return cfg


def test_setup_pansharpens_the_pan_gt_as_jax(ms_scene):
    """Trainer.setup's one-time Brovey of the PAN GT (train_pan.py:338-345,
    JAX's Trainer.setup: each pan view's GT becomes
    brovey(pan GT, the same view's MSI GT), 3 channels) and the dual MS
    layout: the modalities, pan_mode, one shading row per view
    (share_color_correction), both modalities at row offset 0."""
    _, arrays = ms_scene
    scene = scene_from_arrays(arrays, device="cpu")
    msi = {v.name: v.image for v in scene.train_views
           if v.image_type == "msi"}
    want = {v.name: np.asarray(jps.brovey(jnp.asarray(v.image),
                                          jnp.asarray(msi[v.name])))
            for v in scene.train_views if v.image_type == "pan"}
    tr = tt.Trainer(_fixed_cfg(), scene, device="cpu").setup()
    assert [(n, len(v)) for n, v in tr.modal_views] == [("msi", 2),
                                                        ("pan", 2)]
    assert tr.pan_mode == "fixed"
    assert tr.shading.cc_weight.shape[0] == 2
    assert [m[2:] for m in tr._modalities()] == [(None, 0), ("fixed", 0)]
    for vi, v in enumerate(tr.modal_views[1][1]):
        assert v.image.shape == (3, 32, 32)
        assert _rel(v.image, want[v.name]) <= RTOL, v.name
        np.testing.assert_array_equal(
            tr.consts_by_modality["pan"].images[vi].numpy(), v.image)


MODES = ("eogsplus", "optical_flow", "onlyPAN", "average", "fixed")


def _mode_cfg(mode, iterations=6):
    if mode in tconfig.PRESETS:
        cfg = tconfig.PRESETS[mode](iterations=iterations)
    else:
        cfg = tconfig._apply_mode(tconfig.baseogs(iterations=iterations),
                                  mode)
    o = cfg.optimization
    o.iterstart_shadowmapping = 0
    o.iterstart_L_new_resample = 0
    o.iterstart_flowmatching = 0
    o.flowmatching.apply_flowmatching = True
    o.itr_apply_flowmatching_to_affine = 3
    o.color_reset_iterations = 4
    o.normalize_colors_before_saving = True
    cfg.logging.tb_log_interval = 2
    return cfg


@pytest.mark.parametrize("mode", MODES)
def test_trainer_trains_mode(ms_scene, mode, tmp_path, capsys):
    """Every preset that loads PAN cameras and every PAN mode trains on the
    fused route on the CPU: the flow phase in each step (flow_mag per
    modality), the flow bake at 3 (the affines move, the steps rebuilt),
    the colour reset at 4, normalize_colors_before_saving at the last
    iteration; metrics finite, the PAN GT repeated to 3 channels only in
    3PAN; in the dual mode training_report covers both modalities and a
    checkpoint restores into a fresh Trainer."""
    _, arrays = ms_scene
    cfg = _mode_cfg(mode)
    scene = scene_from_arrays(arrays, device="cpu",
                              load_msi=cfg.model.load_msi,
                              load_pan=cfg.model.load_pan)
    tr = tt.Trainer(cfg, scene, RasterizeConfig(binning_mode="fused",
                                                tile_cull=True),
                    device="cpu").setup()
    names = [n for n, _ in tr.modal_views]
    assert names == (["msi", "pan"] if mode == "fixed" else ["pan"])
    channels = tr.consts_by_modality["pan"].images.shape[1]
    assert channels == (3 if cfg.model.repeat_gt else 1)
    affines0 = tr.consts.affines.clone()
    tr.train(progress=False)
    out = capsys.readouterr().out
    for event in ("baked flow-matching", "color reset applied",
                  "baked reference color correction"):
        assert event in out, event
    assert not torch.equal(tr.consts.affines, affines0)
    assert tr.consts is tr.consts_by_modality[names[0]]
    assert [m["iteration"] for m in tr.metrics_history] == [2, 4, 6]
    for m in tr.metrics_history:
        assert all(np.isfinite(v) for v in m.values()), m
        for n in names:
            assert (f"{n}_flow_mag" if len(names) > 1 else "flow_mag") in m
    if mode == "fixed":
        report = tr.training_report(6)
        for k in ("train/psnr_msi", "train/psnr_pan", "test/psnr_msi",
                  "test/psnr_pan"):
            assert np.isfinite(report[k]), k
        m = tr.metrics_history[-1]
        assert m["photometric"] == pytest.approx(
            0.5 * (m["msi_photometric"] + m["pan_photometric"]), rel=1e-6)
        path = str(tmp_path / "chkpnt6")
        save_checkpoint(path, tr, 6)
        tr2 = tt.Trainer(_mode_cfg(mode), scene,
                         RasterizeConfig(binning_mode="fused",
                                         tile_cull=True),
                         device="cpu").setup()
        assert tr2.restore(path) == 6
        for f in ("features_dc", "opacity"):
            assert torch.equal(getattr(tr2.model, f), getattr(tr.model, f))
        assert torch.equal(tr2.shading.cc_weight, tr.shading.cc_weight)
