"""The dual-modality ``fixed`` step at two image sizes: the program's
``Trainer.train_step`` against the plain reference
``benchmark/reference/train_dual.py`` (which imports neither the port nor
JAX), the benchmark's two-size scene, the WV3 conversion, and the Trainer
with a PAN camera four times the MSI camera's width.

The scene: ``benchmark/scene_dual.py`` at PAN 64^2 and MSI 16^2, 2 train
views, ~2.8k Gaussians; the recipe is the benchmark configuration
``eogsplus-fixed-1M-1024``'s, with the flow phase from the first step so
that the compared step runs it on both modalities. The program and the
reference share one step's inputs (module fixtures); torch on one thread.
"""

import json
import os

import pytest
import torch

from benchmark.common import program_config, program_scene
from benchmark.reference.train import cameras_extent, init_start
from benchmark.reference.train_dual import (MODALITIES, draws_dual, to_pan,
                                            train_reference_dual)
from benchmark.scene_dual import make_scene_dual
from eogs2_tpu_torch import shading
from eogs2_tpu_torch import train as tt
from eogs2_tpu_torch.observability import tracer
from eogs2_tpu_torch.rasterizer import RasterizeConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = dict(n_views=3, width=64, height=64, hf_res=128, n_buildings=4,
            scale=20.0, density=0.13, sun_el_az=[55.0, 120.0], msi_factor=4)
SEED = 5
GAUSS = ("xyz", "features_dc", "scaling", "rotation", "opacity")
SHADE = ("cc_weight", "cc_bias", "inshadow")
# The loss terms: each a float32 mean over the pixels of a render that the
# program's plain fused blend and the reference's blend sum in other
# orders; measured at most 5.1e-6 relative (the random camera's terms).
TERM_RTOL = 2e-5
# A leaf's gradient: float32 sums of per-pixel contributions in another
# order; measured at most 4.6e-6 of the leaf's largest element.
GRAD_TOL = 2e-5
# One Adam step from the init moves each element by about lr g / |g|:
# measured at most 4.4e-6 of the leaf's largest change.
CHANGE_TOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def dual_cfg():
    with open(os.path.join(ROOT, "benchmark", "configs",
                           "eogsplus-fixed-1M-1024.json")) as f:
        cfg = json.load(f)
    cfg["recipe"]["iterstart_flowmatching"] = 0
    return cfg


@pytest.fixture(scope="module")
def scene(one_torch_thread):
    return make_scene_dual(SIZE, 11, torch.device("cpu"))


@pytest.fixture(scope="module")
def program(scene):
    """The Trainer after its first step, with the renders' canvases, the
    main renders' radii, the step's metrics, gradients and changes."""
    cfg = dual_cfg()
    dev = torch.device("cpu")
    tr = tt.Trainer(program_config(cfg, SEED), program_scene(scene, dev),
                    RasterizeConfig(binning_mode="fused", tile_cull=True),
                    device=dev).setup()
    before = {k: getattr(tr.model, k).detach().clone() for k in GAUSS}
    before.update({k: getattr(tr.shading, k).detach().clone() for k in SHADE})
    renders, real = [], tt.rasterize

    def recording(*a, **k):
        ro = real(*a, **k)
        renders.append((a[7], a[8], ro.radii.detach().clone()))
        return ro

    tt.rasterize = recording
    try:
        metrics = tr.train_step(1)
    finally:
        tt.rasterize = real
    n = scene.init_xyz.shape[0]

    def leaf(k):
        return getattr(tr.model, k) if k in GAUSS else getattr(tr.shading, k)

    def rows(k, x):
        return x[:n] if k in GAUSS else x

    grads = {k: rows(k, leaf(k).grad).clone() for k in GAUSS + SHADE}
    change = {k: rows(k, leaf(k).detach() - before[k]) for k in GAUSS + SHADE}
    return dict(trainer=tr, metrics={k: float(v) for k, v in metrics.items()},
                grads=grads, change=change, renders=renders, n=n)


def reference(scene, fault=None):
    cfg = dual_cfg()
    dev = torch.device("cpu")
    mds = {m: [md for md in scene.metadatas[m]
               if md["img"] in scene.train_names] for m in MODALITIES}
    images = {"msi": [scene.images[md["img"]] for md in mds["msi"]],
              "pan": [scene.images_pan[md["img"]] for md in mds["pan"]]}
    views, bgs, shears = draws_dual(SEED, len(mds["msi"]), 1, dev)
    recipe = dict(cfg["recipe"], unsupported_terms_must_be_off=cfg[
        "unsupported_terms_must_be_off"])
    start = init_start(scene.init_xyz, scene.init_rgb, recipe,
                       len(mds["msi"]), dev)
    return train_reference_dual(mds, images, recipe, [1], views, bgs, shears,
                                start, cameras_extent(scene.init_xyz),
                                float(scene.init_xyz.shape[0]), "fp32", fault)


@pytest.fixture(scope="module")
def ref(scene):
    return reference(scene)


@pytest.fixture(scope="module")
def ref_pan_average(scene):
    return reference(scene, "pan_average")


def term_gaps(program, ref):
    """Each reference term's relative gap to the program's metric of it
    (the program names them without the weight's ``w_`` and writes the
    photometric term ``Lphotometric``)."""
    out = {}
    for key, value in ref["terms"][0].items():
        mod, name = key.split("_", 1)
        name = name[2:].replace("L_photometric", "Lphotometric")
        out[key] = abs(program["metrics"][f"{mod}_{name}"] - value) / abs(value)
    out["loss"] = abs(program["metrics"]["loss"] - ref["losses"][0]) / abs(
        ref["losses"][0])
    return out


def counted(ref):
    """The leaves compared: a leaf whose reference gradient is under a
    thousandth of the median leaf's is round-off (the rotations': the init
    Gaussians are isotropic, so the loss does not depend on them, and
    their gradient, ~1e-11, moves under Adam by its sign alone)."""
    top = {k: float(g.abs().max()) for k, g in ref["first_grad"].items()}
    med = sorted(top.values())[len(top) // 2]
    return [k for k in GAUSS + SHADE if top[k] >= 1e-3 * med]


def leaf_gaps(program, ref, key):
    """Each counted leaf's largest element gap, over the reference leaf's
    largest element."""
    mine, theirs = program["grads" if key == "first_grad" else "change"], \
        ref[key]
    return {k: float((mine[k] - theirs[k]).abs().max()
                     / theirs[k].abs().max()) for k in counted(ref)}


def test_loss_terms_match_reference(program, ref):
    gaps = term_gaps(program, ref)
    assert len(gaps) == 2 * 5 + 1  # five terms a modality and the sum
    assert max(gaps.values()) <= TERM_RTOL, gaps
    # the flow phase ran on both modalities
    assert program["metrics"]["msi_flow_mag"] > 0
    assert program["metrics"]["pan_flow_mag"] > 0


def test_gradients_match_reference(program, ref):
    assert "rotation" not in counted(ref) and len(counted(ref)) == 7
    gaps = leaf_gaps(program, ref, "first_grad")
    assert max(gaps.values()) <= GRAD_TOL, gaps
    # the rows past the init count are empty slots: no gradient
    tr = program["trainer"]
    assert not tr.model.xyz.grad[program["n"]:].any()


def test_adam_change_matches_reference(program, ref):
    gaps = leaf_gaps(program, ref, "change")
    assert max(gaps.values()) <= CHANGE_TOL, gaps


def test_planted_pan_average_fails(program, ref_pan_average):
    """The PAN camera converted by the mean of its colours in place of the
    WV3 weights: the comparison fails by more than ten times each
    tolerance."""
    r = ref_pan_average
    assert term_gaps(program, r)["pan_w_L_photometric"] > 10 * TERM_RTOL
    assert term_gaps(program, r)["loss"] > 10 * TERM_RTOL
    assert min(leaf_gaps(program, r, "first_grad").values()) > 10 * GRAD_TOL
    assert max(leaf_gaps(program, r, "change").values()) > 10 * CHANGE_TOL


def test_dual_scene_sizes_and_cameras(scene):
    from benchmark.scene import make_scene

    ms = make_scene(dict(SIZE, modality="ms"), 11, torch.device("cpu"))
    msi, pan = scene.metadatas["msi"], scene.metadatas["pan"]
    assert len(msi) == len(pan) == SIZE["n_views"] + 1  # and the Nadir
    for m, p in zip(msi, pan):
        assert (m["width"], m["height"]) == (16, 16)
        assert (p["width"], p["height"]) == (64, 64)
        assert m["img"] == p["img"]
        assert m["model"] == p["model"] and m["sun_model"] == p["sun_model"]
    for name, img in scene.images.items():
        assert img.shape == (3, 16, 16)
        assert scene.images_pan[name].shape == (1, 64, 64)
        # the 4x4 box mean of the PAN-size colour render
        box = ms.images[name].reshape(3, 16, 4, 16, 4).mean((2, 4))
        torch.testing.assert_close(img, box, rtol=0, atol=1e-6)
        assert torch.equal(scene.images_pan[name], ms.images_pan[name])
    assert torch.equal(scene.init_xyz, ms.init_xyz)


def test_msi_to_pan_fixed_matches_reference_and_is_made_once():
    img = torch.rand((3, 8, 8), generator=torch.Generator().manual_seed(0))
    shading._WV3.clear()
    tracer.enable()
    try:
        out = shading.msi_to_pan(img, "fixed")
        again = shading.msi_to_pan(img, "fixed")
        reads = tracer.summary()["reads"][""]
    finally:
        tracer.enable(False)
        tracer.reset()
    assert torch.equal(out, to_pan(img)) and torch.equal(out, again)
    # the weights are copied to the device once, not at every PAN render
    assert reads == {"shading.wv3": reads["shading.wv3"]}
    assert reads["shading.wv3"]["count"] == 1
    assert list(shading._WV3) == [(torch.float32, torch.device("cpu"))]


def test_trainer_two_sizes(program, scene):
    """Each modality renders its main, sun and random camera at its own
    size; the step keeps the larger of the two main renders' radii; the
    next step stays finite; training_report reads both modalities."""
    tr = program["trainer"]
    c = tr.consts_by_modality
    assert tuple(c["msi"].images.shape) == (2, 3, 16, 16)
    assert tuple(c["pan"].images.shape) == (2, 1, 64, 64)
    assert c["msi"].native_wh == (16, 16) and c["pan"].native_wh == (64, 64)
    assert [m[0] for m in tr.modal_views] == ["msi", "pan"]
    assert tr.shading.cc_weight.shape[0] == 2  # one correction a view
    sizes = [(w, h) for w, h, _ in program["renders"]]
    assert sizes == [(16, 16), (32, 32), (16, 16), (64, 64), (128, 128),
                     (64, 64)]
    msi_main, pan_main = program["renders"][0][2], program["renders"][3][2]
    assert (pan_main > msi_main).any() and (msi_main > 0).any()
    n = program["n"]
    want = torch.maximum(msi_main, pan_main)[:n].to(tr.model.max_radii2d.dtype)
    assert torch.equal(tr.model.max_radii2d[:n], want)
    m = tr.train_step(2)
    for k, v in m.items():
        assert torch.isfinite(v).all(), k
    rep = tr.training_report(2)
    assert set(rep) >= {"train/l1_loss_msi", "train/l1_loss_pan",
                        "train/psnr_msi", "train/psnr_pan"}
