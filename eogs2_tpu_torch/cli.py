"""Command-line orchestration.

Counterpart of ``eogs2_tpu/cli.py``, with its subcommands, argument names
and defaults; parity targets the reference's entry points train_pan.py
(train), render_pan.py (render artifacts), eval/eval_dsm.py (DSM MAE),
tsdf.py (TSDF fusion), full_eval_pan.py (train, render, eval-dsm and tsdf
in sequence) and render_video.py (video), driven by preset x scene flags:

  python -m eogs2_tpu_torch.cli make-synthetic --out <dir>
  python -m eogs2_tpu_torch.cli train --scene-dir <dir> --model-path <out>
  python -m eogs2_tpu_torch.cli render --scene-dir <dir> --model-path <out>
  python -m eogs2_tpu_torch.cli eval-dsm --pred <dsm.tif> --gt-heightfield <npy>
  python -m eogs2_tpu_torch.cli tsdf --scene-dir <dir> --model-path <out>
  python -m eogs2_tpu_torch.cli full-eval --scene-dir <dir> --model-path <out>
  python -m eogs2_tpu_torch.cli video --scene-dir <dir> --model-path <out>

``--device`` names the device (default: CUDA, and every subcommand raises
without it; ``--device cpu`` runs on the CPU). make-synthetic and eval-dsm
compute on the host only, as in JAX; tsdf fuses on the device and extracts
the mesh on the host.

Not ported yet, and raising NotImplementedError naming the ROADMAP item:
the multi-device options ``--n-devices`` > 1, ``--raster-backend a2a``,
``--coordinator``/``--num-processes``/``--process-id`` and
``--views-per-step`` > 1 (item 13). Every preset trains: ``eogsplus`` and
``optical_flow`` (3PAN, flow matching) load the scene's PAN cameras, from
``--images-pan`` (default ``<scene>/images``), as JAX's CLI does.
``--steps-per-dispatch`` other than 1 raises too: it batches steps into one
TPU dispatch and has no counterpart here (ROADMAP "Deliberate
differences"). Two additions are the port's own: ``--max-tiles-per-gaussian``
(default 16, JAX's fixed value), the dense routes' per-Gaussian tile
clamp, which ``render`` and ``video`` need above the widest Gaussian for
nothing to clip, as ``--tile-capacity`` above the densest tile; and
``full-eval`` takes tsdf's ``--export-mesh`` (JAX's full-eval writes no
mesh); it fuses at tsdf's default voxel size and truncation, as JAX's
does.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def _unported(what: str, item: int):
    raise NotImplementedError(
        f"{what} is not ported yet (ROADMAP Queue 1 item {item})")


def _load(args, load_pan=None, load_msi=None):
    from eogs2_tpu_torch.scene import load_scene

    images_msi = args.images_msi or os.path.join(args.scene_dir, "images")
    images_pan = args.images_pan or os.path.join(args.scene_dir, "images")
    return load_scene(
        args.scene_dir,
        images_msi_path=images_msi,
        images_pan_path=images_pan,
        eval_split=True,
        need_rescale=args.need_rescale,
        target_density=args.target_density,
        load_msi=load_msi if load_msi is not None else True,
        load_pan=load_pan if load_pan is not None else False,
        seed=args.seed,
        input_ply_name=args.input_ply_name,
        device=args.device,
    )


def _check_train_options(args):
    """Raise for the train options whose code is not ported."""
    if args.n_devices > 1:
        _unported(f"--n-devices {args.n_devices} (multi-chip training)", 13)
    if args.raster_backend != "gspmd":
        _unported(f"--raster-backend {args.raster_backend}", 13)
    if (args.coordinator is not None or args.num_processes is not None
            or args.process_id is not None):
        _unported("multi-host training (--coordinator, --num-processes, "
                  "--process-id)", 13)
    if args.views_per_step > 1:
        _unported(f"--views-per-step {args.views_per_step}", 13)
    if args.steps_per_dispatch != 1:
        raise NotImplementedError(
            f"--steps-per-dispatch {args.steps_per_dispatch}: several steps "
            f"per dispatch is a TPU dispatch knob with no counterpart in the "
            f"port (ROADMAP \"Deliberate differences\")")


def cmd_train(args):
    _check_train_options(args)
    from eogs2_tpu_torch.config import PRESETS
    from eogs2_tpu_torch.eval.mae import MaeComputer
    from eogs2_tpu_torch.observability import MetricsLogger
    from eogs2_tpu_torch.pipeline import evaluate_dsm_mae
    from eogs2_tpu_torch.rasterizer import RasterizeConfig
    from eogs2_tpu_torch.train import Trainer

    cfg = PRESETS[args.preset](args.scene_dir)
    if args.iterations:
        cfg.optimization.iterations = args.iterations
        cfg.optimization.densify_until_iter = args.iterations
    cfg.logging.model_path = args.model_path
    cfg.seed = args.seed
    if args.checkpoint_every:
        cfg.checkpoint_iterations = tuple(
            range(args.checkpoint_every, cfg.optimization.iterations + 1,
                  args.checkpoint_every)
        )
    scene = _load(args, load_pan=cfg.model.load_pan, load_msi=cfg.model.load_msi)
    rcfg = RasterizeConfig(
        pair_capacity=1 << args.log2_pair_capacity,
        tile_capacity=args.tile_capacity,
        tile_chunk=args.tile_chunk,
        max_tiles_per_gaussian=args.max_tiles_per_gaussian,
        binning_mode={"safe": "gather", "fast": "sorted",
                      "fused": "fused"}[args.raster_mode],
        use_pallas=args.raster_mode == "fast",
    )
    if args.opacity_init and args.opacity_init != "auto":
        cfg.model.opacity_init_value = float(args.opacity_init)
    if args.views_per_step:
        cfg.optimization.views_per_step = args.views_per_step
    tr = Trainer(cfg=cfg, scene=scene, raster_cfg=rcfg,
                 device=args.device).setup()
    if args.opacity_init == "auto":
        tr.calibrate_opacity_init()
    if args.start_checkpoint:
        it0 = tr.restore(args.start_checkpoint)
        print(f"restored checkpoint at iteration {it0}")

    logger = MetricsLogger(args.model_path)
    logger.save_config({"preset": args.preset, "scene_dir": args.scene_dir,
                        "model": cfg.model, "optimization": cfg.optimization})

    def log_hook(trainer, m, iteration):
        logger.log_scalars(m, iteration)
        if iteration % (50 * cfg.logging.tb_log_interval) == 0:
            print(
                f"[{iteration:6d}] loss={m['loss']:.4f} "
                f"photo={m['photometric']:.4f} psnr={m['psnr']:.2f} "
                f"alive={m['alive']}",
                flush=True,
            )

    tr.log_hook = log_hook
    tr.report_logger = logger  # big_testing_iterations report target
    if args.save_iterations:
        tr.cfg.save_iterations = tuple(
            int(x) for x in args.save_iterations.split(",") if x
        )
    if args.big_testing_iterations:
        tr.cfg.logging.big_testing_iterations = [
            int(x) for x in args.big_testing_iterations.split(",") if x
        ]

    if args.eval_during_training and os.path.exists(
        os.path.join(args.scene_dir, "gt_heightfield.npy")
    ):
        mc = MaeComputer.from_synthetic(args.scene_dir, scale=scene.scene_scale)
        tr.mae_computer = mc  # RDSM figure in training_report

        def mae_hook(trainer, model, iteration):
            mae, _, _, _ = evaluate_dsm_mae(model, scene, mc, rcfg)
            print(f"[{iteration}] DSM MAE {mae:.3f} m", flush=True)

        tr.eval_hook = mae_hook

    tr.train()
    logger.close()

    it = tr.save_model()
    with open(os.path.join(args.model_path, "cfg_args.json"), "w") as f:
        json.dump({"preset": args.preset, "scene_dir": args.scene_dir,
                   "iterations": it}, f)
    with open(os.path.join(args.model_path, "metrics.json"), "w") as f:
        json.dump(tr.metrics_history, f)
    print(f"saved model to {args.model_path} at iteration {it}")
    return 0


def cmd_render(args):
    from eogs2_tpu_torch.render_artifacts import render_sets

    return render_sets(args)


def cmd_video(args):
    """Orbit fly-around frames from a saved model (render_video.py parity)."""
    from eogs2_tpu_torch.rasterizer import RasterizeConfig
    from eogs2_tpu_torch.render_artifacts import load_model, load_shading
    from eogs2_tpu_torch.video import render_video

    model, it = load_model(args.model_path, args.iteration, device=args.device)
    shading = load_shading(args.model_path, it, device=args.device)
    scene = _load(args)
    base_view = next(
        (v for v in scene.train_views if not v.is_virtual), scene.train_views[0]
    )
    rcfg = RasterizeConfig(
        pair_capacity=1 << args.log2_pair_capacity,
        tile_capacity=args.tile_capacity,
        tile_chunk=args.tile_chunk,
        max_tiles_per_gaussian=args.max_tiles_per_gaussian,
    )
    out_path = args.out or os.path.join(args.model_path, "video", "orbit.mp4")
    written = render_video(
        model, base_view.camera, rcfg, out_path,
        n_frames=args.n_frames, fps=args.fps, max_shear=args.max_shear,
        shading=shading,
    )
    print(f"video written to {written}")
    return 0


def cmd_eval_dsm(args):
    from eogs2_tpu_torch.eval.mae import MaeComputer
    from eogs2_tpu_torch.io.geotiff import write_geotiff

    if args.gt_heightfield:
        mc = MaeComputer.from_synthetic(
            os.path.dirname(args.gt_heightfield), scale=args.scale
        )
    else:
        mc = MaeComputer.from_gt_dir(args.gt_dir, args.aoi_id,
                                     filter_tree=args.filter_tree)
    mae, diff, rdsm = mc.compute_mae_from_path(args.pred)
    print(json.dumps({"mae": mae, "aoi": args.aoi_id}))
    if args.out_dir:
        os.makedirs(args.out_dir, exist_ok=True)
        write_geotiff(os.path.join(args.out_dir, "rdsm_diff.tif"),
                      diff.astype(np.float32))
        write_geotiff(os.path.join(args.out_dir, "rdsm.tif"),
                      rdsm.astype(np.float32))
    return 0


def cmd_tsdf(args):
    from eogs2_tpu_torch.eval.tsdf import run_tsdf_cli

    return run_tsdf_cli(args)


def cmd_full_eval(args):
    """full_eval_pan.py parity: train -> render -> eval_dsm -> tsdf in one
    process (full_eval_pan.py:23-31)."""
    from eogs2_tpu_torch.eval.mae import MaeComputer
    from eogs2_tpu_torch.scene import load_scene

    rc = cmd_train(args)
    if rc:
        return rc
    args.iteration = -1
    rc = cmd_render(args)
    if rc:
        return rc
    pc_root = os.path.join(args.model_path, "point_cloud")
    it = max(int(d.split("_")[-1]) for d in os.listdir(pc_root))
    pred = os.path.join(args.model_path, "test_opNone", f"ours_{it}", "dsm",
                        "Nadir.tif")
    gt_hf = os.path.join(args.scene_dir, "gt_heightfield.npy")
    mc = None
    if os.path.exists(gt_hf):
        sc = load_scene(args.scene_dir, images_msi_path=None, eval_split=True,
                        target_density=0.001, device=args.device)
        mc = MaeComputer.from_synthetic(args.scene_dir, scale=sc.scene_scale)
    if mc is not None and os.path.exists(pred):
        mae, _, _ = mc.compute_mae_from_path(pred)
        print(json.dumps({"stage": "eval_dsm", "mae": mae}))
    args.vox_size = 0.5
    args.trunc_margin_fact = 4.0
    rc = cmd_tsdf(args)
    tsdf_pred = os.path.join(args.model_path, "test_opNone", f"ours_{it}",
                             "tsdf", "dsm.tif")
    if mc is not None and os.path.exists(tsdf_pred):
        mae, _, _ = mc.compute_mae_from_path(tsdf_pred)
        print(json.dumps({"stage": "eval_dsm_tsdf", "mae": mae}))
    return rc


def cmd_make_synthetic(args):
    from eogs2_tpu_torch.data.synthetic import generate_scene

    generate_scene(
        args.out,
        n_views=args.n_views,
        width=args.width,
        height=args.height,
        hf_res=args.hf_res,
        n_buildings=args.n_buildings,
        seed=args.seed,
        scale=args.scale,
    )
    print(f"synthetic scene written to {args.out}")
    return 0


def build_parser():
    p = argparse.ArgumentParser(prog="eogs2_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    def device(sp):
        sp.add_argument("--device", default=None,
                        help="torch device (default: CUDA; raises without "
                             "a CUDA device), e.g. cpu")

    def common(sp):
        device(sp)
        sp.add_argument("--scene-dir", required=False, default="")
        sp.add_argument("--images-msi", default=None)
        sp.add_argument("--images-pan", default=None)
        sp.add_argument("--model-path", default="output/run")
        sp.add_argument("--preset", default="baseogs")
        sp.add_argument("--iterations", type=int, default=0)
        sp.add_argument("--seed", type=int, default=1337)
        sp.add_argument("--need-rescale", action="store_true")
        sp.add_argument("--target-density", type=float, default=0.13)
        sp.add_argument("--input-ply-name", default=None,
                        help="init gaussians from <scene>/<name>.ply instead "
                             "of the uniform cloud (dataset_MS_affine.py:116-121)")
        sp.add_argument("--log2-pair-capacity", type=int, default=20)
        sp.add_argument("--tile-capacity", type=int, default=1024)
        sp.add_argument("--tile-chunk", type=int, default=64)
        sp.add_argument("--max-tiles-per-gaussian", type=int, default=16,
                        help="the dense routes' per-Gaussian tile clamp "
                             "(RasterizeConfig's; not a flag of JAX's CLI, "
                             "which keeps 16): render and video clip a "
                             "Gaussian wider than this")
        sp.add_argument("--eval-during-training", action="store_true")
        sp.add_argument("--iteration", type=int, default=-1)
        sp.add_argument("--start-checkpoint", default="")
        sp.add_argument("--checkpoint-every", type=int, default=0)
        sp.add_argument("--n-devices", type=int, default=1,
                        help="> 1 is not ported (ROADMAP Queue 1 item 13)")
        sp.add_argument("--raster-backend", default="gspmd",
                        choices=["gspmd", "a2a"],
                        help="a2a is not ported (ROADMAP Queue 1 item 13)")
        sp.add_argument("--coordinator", default=None,
                        help="multi-host; not ported (ROADMAP Queue 1 item 13)")
        sp.add_argument("--num-processes", type=int, default=None)
        sp.add_argument("--process-id", type=int, default=None)
        sp.add_argument("--steps-per-dispatch", type=int, default=1,
                        help="a TPU dispatch knob; only 1 here")
        sp.add_argument("--views-per-step", type=int, default=0,
                        help="> 1 is not ported (ROADMAP Queue 1 item 13); "
                             "0 = preset default")
        sp.add_argument(
            "--raster-mode", default="safe",
            choices=["safe", "fast", "fused"],
            help="safe = gather binning + the plain dense blend; fast = "
                 "sorted binning + the K4 tile-slot kernel; fused = the "
                 "ragged K1/K2 blend, no dense pair table",
        )
        sp.add_argument(
            "--opacity-init", default="",
            help="'auto' calibrates so mean acc-opacity ~0.999 at iter 1 "
                 "(the reference's empirical table, automated), or a float",
        )
        sp.add_argument("--random-pov", action="store_true",
                        help="also write random-camera resample artifacts "
                             "(render_pan.py:241-272)")
        sp.add_argument("--random-pov-extent", type=float, default=0.2)
        sp.add_argument("--save-iterations", default="",
                        help="comma list of mid-run model-save iterations")
        sp.add_argument("--big-testing-iterations", default="",
                        help="comma list of full train/test report iterations")

    for name, fn in [
        ("train", cmd_train),
        ("render", cmd_render),
        ("full-eval", cmd_full_eval),
        ("video", cmd_video),
    ]:
        sp = sub.add_parser(name)
        common(sp)
        if name == "full-eval":
            sp.add_argument("--export-mesh", action="store_true")
        if name == "video":
            sp.add_argument("--out", default="",
                            help="output path; the frames go to <out without "
                                 "extension>_frames/ (default "
                                 "<model-path>/video/orbit.mp4)")
            sp.add_argument("--n-frames", type=int, default=60)
            sp.add_argument("--fps", type=int, default=15)
            sp.add_argument("--max-shear", type=float, default=0.25)
        sp.set_defaults(fn=fn)

    sp = sub.add_parser("eval-dsm")
    device(sp)
    sp.add_argument("--pred", required=True)
    sp.add_argument("--gt-dir", default="")
    sp.add_argument("--aoi-id", default="")
    sp.add_argument("--gt-heightfield", default="")
    sp.add_argument("--scale", type=float, default=25.0)
    sp.add_argument("--filter-tree", action="store_true")
    sp.add_argument("--out-dir", default="")
    sp.set_defaults(fn=cmd_eval_dsm)

    sp = sub.add_parser("tsdf")
    common(sp)
    sp.add_argument("--vox-size", type=float, default=0.5)
    sp.add_argument("--trunc-margin-fact", type=float, default=4.0)
    sp.add_argument("--export-mesh", action="store_true")
    sp.set_defaults(fn=cmd_tsdf)

    sp = sub.add_parser("make-synthetic")
    device(sp)
    sp.add_argument("--out", required=True)
    sp.add_argument("--n-views", type=int, default=9)
    sp.add_argument("--width", type=int, default=128)
    sp.add_argument("--height", type=int, default=128)
    sp.add_argument("--hf-res", type=int, default=256)
    sp.add_argument("--n-buildings", type=int, default=6)
    sp.add_argument("--scale", type=float, default=25.0)
    sp.add_argument("--seed", type=int, default=0)
    sp.set_defaults(fn=cmd_make_synthetic)
    return p


def main(argv=None):
    from eogs2_tpu_torch.device import resolve_device

    args = build_parser().parse_args(argv)
    # every subcommand resolves its device first, so that without a card
    # and without --device each one fails the same way before any work
    args.device = resolve_device(args.device)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
