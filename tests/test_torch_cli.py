"""The port's CLI (python -m eogs2_tpu_torch.cli) on the CPU.

  * tests/test_cli.py's chain (make-synthetic -> train with model saves,
    checkpoints, the MAE hook and the report -> render -> eval-dsm, and the
    video frames) and its resume, at its sizes (tsdf and full-eval:
    tests/test_torch_tsdf.py), with imageio,
    Pillow, cv2 and TensorBoard made unimportable as on the card's machine;
  * render_sets against eogs2_tpu's on the same saved model (a PLY and the
    shading JAX's load_shading reads, written in the port's format): the
    Nadir DSM, altitude, flowmatched_altitude and nadir_altitude_diff
    within 1e-4 m (NaN where JAX has NaN), every PNG within one level;
  * every option that cannot run as given raises (the multi-device
    options run in tests/test_torch_sharded_train.py), and without a card
    the CLI raises unless --device is given.
"""

import argparse
import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eogs2_tpu import render_artifacts as jra
from eogs2_tpu.data.synthetic import generate_scene
from eogs2_tpu.io import geotiff as jgeo
from eogs2_tpu.io import ply as jply
from eogs2_tpu.model import init_from_points as j_init
from eogs2_tpu.scene import load_scene as j_load
from eogs2_tpu.shading import init_shading_params as j_shading
from eogs2_tpu_torch import cli
from eogs2_tpu_torch import render_artifacts as tra
from eogs2_tpu_torch.io.geotiff import read_geotiff
from eogs2_tpu_torch.io.png import read_png

CPU = ["--device", "cpu"]
ARTIFACTS = ("altitude", "acc_opacity", "final", "raw_render", "cc", "gt",
             "nadir_pov", "nadirpovsampled", "nadiraltitudesampled",
             "nadir_altitude_diff", "flowmatched_altitude",
             "flow_matched_image", "gt_flowmatch")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run this file's torch ops on one thread: beside the other test
    workers, torch's default pool (one thread per core) oversubscribes the
    cores and its many small parallel regions slow the file tenfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def card_machine(monkeypatch):
    """The card's machine has none of these packages."""
    for m in ("imageio", "imageio.v2", "PIL", "PIL.Image", "cv2",
              "tensorboard", "torch.utils.tensorboard"):
        monkeypatch.setitem(sys.modules, m, None)


def test_cli_full_chain(tmp_path, capsys, card_machine):
    d = str(tmp_path / "scene")
    out = str(tmp_path / "run")
    assert cli.main(["make-synthetic", *CPU, "--out", d, "--n-views", "4",
                     "--width", "48", "--height", "48", "--hf-res", "96",
                     "--n-buildings", "2", "--scale", "10", "--seed", "0"]) == 0
    assert cli.main([
        "train", *CPU, "--scene-dir", d, "--preset", "baseogs",
        "--iterations", "40", "--model-path", out, "--tile-capacity", "256",
        "--tile-chunk", "8", "--checkpoint-every", "20",
        "--save-iterations", "20", "--eval-during-training",
        "--big-testing-iterations", "40",
    ]) == 0
    printed = capsys.readouterr().out
    assert "[ITER 40] report:" in printed and "[20] DSM MAE" not in printed
    for it in (20, 40):
        assert os.path.exists(os.path.join(out, "point_cloud",
                                           f"iteration_{it}",
                                           "point_cloud.ply"))
        assert os.path.exists(os.path.join(out, f"chkpnt{it}"))
        for sub in ("camera_params/iteration_{}/shading",
                    "camera_params/iteration_{}/shading_test",
                    "optimizer/iteration_{}/adam"):
            assert os.path.exists(os.path.join(out, sub.format(it))), sub
    rows = [json.loads(x) for x in open(os.path.join(out, "metrics.jsonl"))]
    assert {r["step"] for r in rows} >= {10, 20, 30, 40}
    assert json.load(open(os.path.join(out, "cfg_args.json")))[
        "iterations"] == 40
    assert len(json.load(open(os.path.join(out, "metrics.json")))) == 4
    assert os.listdir(os.path.join(out, "images"))  # the report's PNGs

    assert cli.main(["render", *CPU, "--scene-dir", d, "--model-path", out,
                     "--tile-capacity", "256", "--tile-chunk", "8",
                     "--random-pov"]) == 0
    dsm = os.path.join(out, "test_opNone", "ours_40", "dsm", "Nadir.tif")
    assert np.isfinite(read_geotiff(dsm)[0]).any()
    train_base = os.path.join(out, "train_opNone", "ours_40")
    for kind in ARTIFACTS + ("randompovsampled", "random_altitude_diff",
                             "random_occlusion_map"):
        assert os.listdir(os.path.join(train_base, kind)), kind
    assert read_png(os.path.join(out, "test_opNone", "ours_40", "png",
                                 "Nadir_dsm.png")).shape == \
        read_geotiff(dsm)[0].shape

    capsys.readouterr()
    assert cli.main(["eval-dsm", *CPU, "--pred", dsm, "--gt-heightfield",
                     os.path.join(d, "gt_heightfield.npy"), "--scale",
                     "10", "--out-dir", str(tmp_path / "eval")]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert np.isfinite(res["mae"])
    assert os.path.exists(tmp_path / "eval" / "rdsm_diff.tif")

    assert cli.main(["video", *CPU, "--scene-dir", d, "--model-path", out,
                     "--tile-capacity", "256", "--n-frames", "3"]) == 0
    frames = sorted(os.listdir(os.path.join(out, "video", "orbit_frames")))
    assert frames == [f"frame_{i:04d}.png" for i in range(3)]
    assert read_png(os.path.join(out, "video", "orbit_frames",
                                 frames[0])).shape == (48, 48, 3)


def test_cli_resume(tmp_path, capsys, card_machine):
    d = str(tmp_path / "scene")
    out = str(tmp_path / "run")
    cli.main(["make-synthetic", *CPU, "--out", d, "--n-views", "3", "--width",
              "32", "--height", "32", "--hf-res", "64", "--n-buildings", "2",
              "--scale", "8"])
    cli.main(["train", *CPU, "--scene-dir", d, "--preset", "baseogs",
              "--iterations", "20", "--model-path", out,
              "--tile-capacity", "256", "--tile-chunk", "8",
              "--checkpoint-every", "20"])
    out2 = str(tmp_path / "run2")
    capsys.readouterr()
    assert cli.main(["train", *CPU, "--scene-dir", d, "--preset", "baseogs",
                     "--iterations", "10", "--model-path", out2,
                     "--tile-capacity", "256", "--tile-chunk", "8",
                     "--start-checkpoint",
                     os.path.join(out, "chkpnt20")]) == 0
    printed = capsys.readouterr().out
    assert "restored checkpoint at iteration 20" in printed
    # the step count carries on from the checkpoint's, as in JAX
    assert os.listdir(os.path.join(out2, "point_cloud")) == ["iteration_30"]


# ---------------------------------------------------------------------------
# render_sets against JAX's
# ---------------------------------------------------------------------------


def _render_args(scene, run, **kw):
    return argparse.Namespace(
        model_path=run, iteration=-1, scene_dir=scene, images_msi=None,
        images_pan=None, need_rescale=False, log2_pair_capacity=14,
        tile_capacity=256, tile_chunk=8, max_tiles_per_gaussian=16,
        random_pov=False,
        random_pov_extent=0.2, **kw)


def _model_and_shading(scene, run_j, run_t, it=7):
    """A perturbed init model as a PLY in both runs; perturbed shading
    written by orbax (JAX's layout), read back through JAX's load_shading
    and written in the port's."""
    import orbax.checkpoint as ocp

    js = j_load(scene, images_msi_path=os.path.join(scene, "images"),
                load_pan=False)
    n = len(js.init_xyz)
    jm = j_init(js.init_xyz, js.init_rgb, n)
    p = {f: np.array(getattr(jm.params, f)) for f in
         ("xyz", "features_dc", "features_rest", "opacity", "scaling",
          "rotation")}
    rng = np.random.RandomState(0)
    op = rng.uniform(0.3, 0.95, n)
    p["opacity"][:, 0] = np.log(op / (1 - op))
    p["features_dc"][:, 0] = (rng.uniform(0, 1, (n, 3)) - 0.5) / 0.28209479
    p["scaling"] += rng.normal(0, 0.2, (n, 3)).astype(np.float32) + 0.3
    for run in (run_j, run_t):
        jply.save_gaussians_ply(
            os.path.join(run, "point_cloud", f"iteration_{it}",
                         "point_cloud.ply"),
            p["xyz"], p["features_dc"], p["features_rest"], p["opacity"],
            p["scaling"], p["rotation"])
    v = len(js.train_views)
    sh = j_shading(v)
    sh = sh.replace(
        cc_weight=sh.cc_weight + 0.05 * jnp.asarray(rng.normal(size=(v, 3, 3)),
                                                    jnp.float32),
        cc_bias=jnp.asarray(0.03 * rng.normal(size=(v, 3)), jnp.float32))
    test_sh = sh.replace(**{f: getattr(sh, f)[:1] for f in (
        "cc_weight", "cc_bias", "inshadow", "last_row", "exposure",
        "msi_to_pan_weight", "msi_to_pan_bias", "transient_mask")})
    ckptr = ocp.StandardCheckpointer()
    cam = os.path.join(run_j, "camera_params", f"iteration_{it}")
    for which, s in (("shading", sh), ("shading_test", test_sh)):
        ckptr.save(os.path.abspath(os.path.join(cam, which)),
                   {k: np.asarray(x) for k, x in s.__dict__.items()})
        ckptr.wait_until_finished()
        back = jra.load_shading(run_j, it, which)
        tcam = os.path.join(run_t, "camera_params", f"iteration_{it}")
        os.makedirs(tcam, exist_ok=True)
        torch.save({k: torch.from_numpy(np.array(x))
                    for k, x in back.__dict__.items()},
                   os.path.join(tcam, which))
    return it


def _files(base, ext):
    return sorted(os.path.relpath(os.path.join(r, f), base)
                  for r, _, fs in os.walk(base) for f in fs if f.endswith(ext))


def test_render_sets_matches_jax(tmp_path):
    scene = str(tmp_path / "scene")
    generate_scene(scene, n_views=3, width=32, height=32, hf_res=64,
                   n_buildings=2, scale=8.0, seed=1)
    run_j, run_t = str(tmp_path / "j"), str(tmp_path / "t")
    it = _model_and_shading(scene, run_j, run_t)
    assert jra.render_sets(_render_args(scene, run_j)) == 0
    assert tra.render_sets(_render_args(scene, run_t, device="cpu")) == 0

    tifs, pngs = _files(run_j, ".tif"), _files(run_j, ".png")
    assert _files(run_t, ".tif") == tifs and _files(run_t, ".png") == pngs
    base = f"train_opNone/ours_{it}/"
    compared = [f"test_opNone/ours_{it}/dsm/Nadir.tif"] + [
        t for t in tifs if t.startswith(base) and t.split("/")[2] in (
            "altitude", "flowmatched_altitude", "nadir_altitude_diff")]
    assert len(compared) == 1 + 3 * 2
    for t in compared:
        ja, jp = jgeo.read_geotiff(os.path.join(run_j, t))
        ta, tp = read_geotiff(os.path.join(run_t, t))
        assert ta.shape == ja.shape and np.isfinite(ja).mean() > 0.5, t
        np.testing.assert_array_equal(np.isnan(ta), np.isnan(ja), err_msg=t)
        np.testing.assert_allclose(ta, ja, rtol=0, atol=1e-4, err_msg=t)
        assert repr(tp["transform"]) == repr(jp["transform"]), t
    for p in pngs:
        ja = np.asarray(read_png(os.path.join(run_j, p)), np.int16)
        ta = np.asarray(read_png(os.path.join(run_t, p)), np.int16)
        assert ta.shape == ja.shape, p
        assert np.abs(ta - ja).max() <= 1, p
    profile = f"test_opNone/ours_{it}/dsm/profile.json"
    assert json.load(open(os.path.join(run_t, profile))) == \
        json.load(open(os.path.join(run_j, profile)))


# ---------------------------------------------------------------------------
# what is not ported, and the device
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_scene(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tiny"))
    generate_scene(d, n_views=3, width=32, height=32, hf_res=64,
                   n_buildings=1, scale=6.0, seed=2)
    return d


@pytest.mark.parametrize("argv,exc,match", [
    (["train", "--raster-backend", "a2a"], ValueError, "needs a mesh"),
    (["full-eval", "--raster-backend", "a2a"], ValueError, "needs a mesh"),
    (["train", "--coordinator", "localhost:1234"], ValueError,
     "number of processes"),
    (["tsdf", "--coordinator", "localhost:1234", "--num-processes", "2"],
     ValueError, "number of processes"),
    (["train", "--coordinator", "localhost:1234", "--process-id", "0"],
     ValueError, "number of processes"),
    (["train", "--steps-per-dispatch", "4"], NotImplementedError,
     "Deliberate differences"),
    (["train", "--trace-steps", "3"], ValueError, "A:B"),
])
def test_unported_options_raise(tiny_scene, tmp_path, argv, exc, match):
    """The options that cannot run as given raise before any work: the
    multi-device ones (ported; tests/test_torch_sharded_train.py runs them)
    where JAX asserts (a2a without a mesh) or a coordinator comes without
    the group's size or this process's id; --steps-per-dispatch, which has
    no counterpart."""
    with pytest.raises(exc, match=match):
        cli.main(argv + [*CPU, "--scene-dir", tiny_scene, "--model-path",
                         str(tmp_path / "run"), "--iterations", "2"])


@pytest.mark.parametrize("preset", ["eogsplus", "optical_flow"])
def test_cli_trains_pan_preset(tiny_scene, tmp_path, card_machine, preset):
    """The paper's presets train through the CLI on the tiny scene (3PAN:
    the scene's images loaded as PAN cameras) and write the model."""
    run = str(tmp_path / "run")
    assert cli.main(["train", "--preset", preset, *CPU, "--scene-dir",
                     tiny_scene, "--model-path", run, "--iterations",
                     "2"]) == 0
    with open(os.path.join(run, "cfg_args.json")) as f:
        assert json.load(f) == {"preset": preset, "scene_dir": tiny_scene,
                                "iterations": 2}
    assert os.path.getsize(os.path.join(
        run, "point_cloud", "iteration_2", "point_cloud.ply")) > 0


def test_cli_needs_a_card_without_device(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["make-synthetic", "--out", str(tmp_path / "s")],
                 ["eval-dsm", "--pred", "x.tif"],
                 ["train", "--scene-dir", str(tmp_path)]):
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(argv)
    assert not os.path.exists(tmp_path / "s")


def test_observability_matches_jax(tmp_path, tiny_scene, card_machine):
    """MetricsLogger writes JAX's JSONL rows and config snapshot (and, with
    no TensorBoard, PNGs); ProfilerContext, train --trace-steps (the
    profiler's trace and the program's spans of the iterations asked for)
    and nan_guard."""
    from eogs2_tpu import observability as jobs
    from eogs2_tpu_torch import observability as tobs
    from eogs2_tpu_torch.config import baseogs

    cfg = baseogs("scene")
    rows = [({"loss": torch.tensor(0.25), "psnr": 12.5, "name": "x"}, 10),
            ({"loss": np.float32(0.125), "alive": 7}, 20)]
    for mod, d in ((jobs, tmp_path / "j"), (tobs, tmp_path / "t")):
        lg = mod.MetricsLogger(str(d), use_tensorboard=False)
        for m, it in rows:
            lg.log_scalars(m, it)
        lg.save_config({"preset": "baseogs", "model": cfg.model,
                        "optimization": cfg.optimization})
        lg.close()
    for f in ("metrics.jsonl", "cfg_args.json"):
        assert (tmp_path / "t" / f).read_text() == \
            (tmp_path / "j" / f).read_text(), f
    lg = tobs.MetricsLogger(str(tmp_path / "t"))
    assert lg.tb is None  # no TensorBoard here: images become PNGs
    img = np.linspace(0, 1, 2 * 5 * 3, dtype=np.float32).reshape(3, 2, 5)
    lg.log_image("train/render", img, 30)
    lg.close()
    png = read_png(str(tmp_path / "t" / "images" / "train_render_000030.png"))
    np.testing.assert_array_equal(
        png, (np.clip(img, 0, 1).transpose(1, 2, 0) * 255).astype(np.uint8))

    with tobs.ProfilerContext(str(tmp_path / "prof")) as prof:
        torch.ones(4).sum()
    assert (tmp_path / "prof" / "trace.json").exists() and prof.profile
    run = tmp_path / "traced"
    assert cli.main(["train", *CPU, "--scene-dir", tiny_scene, "--model-path",
                     str(run), "--iterations", "4", "--trace-steps",
                     "2:3"]) == 0
    with open(run / "spans.json") as f:
        spans = json.load(f)
    steps = [s for s in spans["spans"] if s["name"] == "train.step"]
    assert [s["unit_id"] for s in steps] == [2, 3]
    assert spans["summary"]["units"] == {"train.step": 2}
    with open(run / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"train.step", "train.backward", "raster.emission"} <= names
    assert not tobs.tracer.recording()

    def two(x):
        return {"a": x.abs().clamp_max(1.0), "b": (x.sum(), 1)}

    guarded = tobs.nan_guard(two)
    assert guarded(torch.ones(3))["a"].shape == (3,)
    with pytest.raises(FloatingPointError, match=r"\['b'\]\[0\]"):
        guarded(torch.tensor([1.0, float("inf")]))


def test_metrics_logger_images_without_pillow(tmp_path, monkeypatch):
    """With TensorBoard but no Pillow (which its image summaries need), the
    scalars go to TensorBoard and the images to PNGs."""
    from eogs2_tpu_torch import observability as tobs

    for m in ("PIL", "PIL.Image"):
        monkeypatch.setitem(sys.modules, m, None)
    lg = tobs.MetricsLogger(str(tmp_path))
    assert lg.tb is not None
    lg.log_scalars({"loss": 0.5}, 1)
    lg.log_image("report/RDSM", np.full((1, 4, 6), 0.5, np.float32), 1)
    lg.close()
    png = read_png(str(tmp_path / "images" / "report_RDSM_000001.png"))
    assert png.shape == (4, 6) and (png == 127).all()
    assert any(f.startswith("events.out.tfevents") for f in os.listdir(tmp_path))
