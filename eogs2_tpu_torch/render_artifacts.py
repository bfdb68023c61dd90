"""Render-stage artifact writer.

Counterpart of ``eogs2_tpu/render_artifacts.py``; parity target
``render_pan.py``: reload the saved model and camera parameters, render
every train/test view through the full pipeline, and write the artifact set
the downstream eval/TSDF stages consume: raw/shaded/cc/final renders,
altitude maps (the TSDF inputs), accumulated opacity, shadow maps, sun/nadir
resamples, the per-view DSMs, and the Nadir DSM with its profile and
preview (render_pan.py:122-147, 311-411).

Artifacts are written as .tif (float, ``io/geotiff.py``) and .png (preview,
``io/png.py``), neither needing imageio or Pillow, into the reference's
layout: <model_path>/{train,test}_opNone/ours_<iter>/<kind>/.

A deliberate difference: ``--random-pov``'s shear draw comes from a
``torch.Generator`` seeded ``1000 + view index`` (JAX draws from
``PRNGKey(1000 + view index)``), through :func:`random_pov_draw`.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from eogs2_tpu_torch.device import resolve_device
from eogs2_tpu_torch.eval.dsm import compute_dsm_from_view
from eogs2_tpu_torch.flow import apply_flow_to_image, phase_correlation_shift
from eogs2_tpu_torch.io import ply as plyio
from eogs2_tpu_torch.io.geotiff import write_geotiff
from eogs2_tpu_torch.io.png import write_png
from eogs2_tpu_torch.model import GaussianModel
from eogs2_tpu_torch.pipeline import nadir_dsm, render_view_full
from eogs2_tpu_torch.rasterizer import RasterizeConfig
from eogs2_tpu_torch.renderer import render_resample_virtual_camera
from eogs2_tpu_torch.scene import load_scene
from eogs2_tpu_torch.shading import CameraShadingParams

KINDS = ("final", "raw_render", "cc", "altitude", "acc_opacity", "shadowmap",
         "gt", "flowmatched_altitude", "nadir_pov", "sun_pov",
         "nadirpovsampled", "nadiraltitudesampled", "nadir_altitude_diff",
         "sunpovsampled", "flow_matched_image", "gt_flowmatch", "dsm")


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _save_float(path, arr):
    write_geotiff(path, np.asarray(_np(arr), np.float32))


def _save_png(path, arr):
    """Min-max normalised 8-bit preview (CHW or HW in)."""
    a = _np(arr)
    if a.ndim == 3 and a.shape[0] in (1, 3):  # CHW -> HWC
        a = a.transpose(1, 2, 0)
    if a.ndim == 3 and a.shape[-1] == 1:
        a = a[..., 0]
    lo, hi = np.nanmin(a), np.nanmax(a)
    if hi > lo:
        a = (a - lo) / (hi - lo)
    write_png(path, (np.clip(a, 0, 1) * 255).astype(np.uint8))


def random_pov_draw(view_index: int) -> torch.Tensor:
    """The random camera's standard-normal shear draw [2] for a view (on the
    CPU, so the card and the CPU draw the same)."""
    g = torch.Generator().manual_seed(1000 + view_index)
    return torch.randn(2, generator=g)


def load_model(model_path: str, iteration: int = -1, sh_degree: int = 0,
               capacity_headroom: float = 1.25, device=None):
    """searchForMaxIteration + load PLY (render_pan.py:150-165 analog):
    the saved Gaussians packed first, padded to the capacity with headroom
    (dead slots: scaling and opacity -10, rotation w = 1). Returns
    (GaussianModel, iteration)."""
    pc_root = os.path.join(model_path, "point_cloud")
    iters = [int(d.split("_")[-1]) for d in os.listdir(pc_root)]
    it = max(iters) if iteration == -1 else iteration
    raw = plyio.load_gaussians_ply(
        os.path.join(pc_root, f"iteration_{it}", "point_cloud.ply"), sh_degree
    )
    n = raw["xyz"].shape[0]
    cap = ((int(n * capacity_headroom) + 127) // 128) * 128

    def pad(x, fill=0.0):
        out = np.full((cap,) + x.shape[1:], fill, np.float32)
        out[:n] = x
        return out

    rotation = pad(raw["rotation"])
    rotation[n:, 0] = 1.0
    params = dict(
        xyz=pad(raw["xyz"]),
        features_dc=pad(raw["features_dc"]),
        features_rest=pad(raw["features_rest"]),
        scaling=pad(raw["scaling"], fill=-10.0),
        rotation=rotation,
        opacity=pad(raw["opacity"], fill=-10.0),
    )
    alive = np.zeros((cap,), bool)
    alive[:n] = True
    zeros = np.zeros((cap,), np.float32)
    aux = dict(alive=alive, max_radii2d=zeros, xyz_gradient_accum=zeros,
               denom=zeros)
    return GaussianModel.from_numpy(params, aux, sh_degree=sh_degree,
                                    device=device), it


def load_shading(model_path: str, iteration: int, which: str = "shading",
                 device=None):
    """The shading parameters save_model wrote (``which``: "shading" or
    "shading_test"), or None when there are none."""
    path = os.path.join(model_path, "camera_params", f"iteration_{iteration}",
                        which)
    if not os.path.exists(path):
        return None
    d = torch.load(path, map_location="cpu", weights_only=True)
    return CameraShadingParams.from_numpy(d, device=device)


@torch.no_grad()
def render_sets(args):
    """Render all artifacts for the saved run (render_pan.py:479-557).

    ``args`` carries the CLI's options (model_path, iteration, scene_dir,
    images_msi, images_pan, need_rescale, log2_pair_capacity,
    tile_capacity, tile_chunk, max_tiles_per_gaussian, random_pov,
    random_pov_extent, device). The renders use the capacity flags alone:
    the ``gather`` route with the plain dense blend, as in JAX."""
    dev = resolve_device(args.device)
    model, it = load_model(args.model_path, args.iteration, device=dev)
    shading = load_shading(args.model_path, it, device=dev)
    shading_test = load_shading(args.model_path, it, which="shading_test",
                                device=dev) or shading
    scene = load_scene(
        args.scene_dir,
        images_msi_path=args.images_msi or os.path.join(args.scene_dir, "images"),
        images_pan_path=args.images_pan or os.path.join(args.scene_dir, "images"),
        eval_split=True,
        need_rescale=args.need_rescale,
        load_pan=False,
        device=dev,
    )
    rcfg = RasterizeConfig(
        pair_capacity=1 << args.log2_pair_capacity,
        tile_capacity=args.tile_capacity,
        tile_chunk=args.tile_chunk,
        max_tiles_per_gaussian=args.max_tiles_per_gaussian,
    )

    for split, views in (("train", scene.train_views), ("test", scene.test_views)):
        base = os.path.join(args.model_path, f"{split}_opNone", f"ours_{it}")
        for kind in KINDS:
            os.makedirs(os.path.join(base, kind), exist_ok=True)
        for vi, view in enumerate(views):
            if view.is_virtual:
                continue
            out = render_view_full(
                model, view.camera, rcfg,
                shading=shading if split == "train" else shading_test,
                view_idx=vi if split == "train" else 0,
                with_sun=view.camera.has_sun,
            )
            name = view.name
            for kind in ("final", "raw_render", "cc"):
                _save_png(os.path.join(base, kind, name + ".png"), out[kind])
            _save_float(os.path.join(base, "altitude", name + ".tif"),
                        out["altitude"])
            _save_float(os.path.join(base, "acc_opacity", name + ".tif"),
                        out["acc_opacity"])
            if out["shadowmap"] is not None:
                _save_png(os.path.join(base, "shadowmap", name + ".png"),
                          out["shadowmap"])
            if view.image is not None:
                _save_png(os.path.join(base, "gt", name + ".png"), view.image)

            # per-view DSM (the reference writes dsm/<name>.iio for every
            # rendered view, render_pan.py:401-411, not just Nadir)
            vprofile, vdsm = compute_dsm_from_view(
                view.camera, out["rendered_uva"], scene.scene_shift,
                scene.scene_scale)
            write_geotiff(os.path.join(base, "dsm", name + ".tif"),
                          vdsm[:, :, 0].astype(np.float32),
                          transform=vprofile["transform"])

            if split == "train":
                _nadir_sun_random(model, view, vi, out, rcfg, base, args)

            # flow-matched altitude for the TSDF stage (render_pan.py:285-306):
            # shift the altitude map by the gt->render flow so TSDF fuses
            # registered depth
            if split == "train" and view.image is not None:
                gt = torch.as_tensor(view.image, device=dev)
                final = torch.as_tensor(out["final"][: gt.shape[0]],
                                        device=dev)
                dx, dy = phase_correlation_shift(gt, final)
                alt = torch.as_tensor(out["altitude"], device=dev)
                _save_float(
                    os.path.join(base, "flowmatched_altitude", name + ".tif"),
                    apply_flow_to_image(alt[None], dx, dy)[0])
                # the render warped by the same flow, and the (unwarped) gt
                _save_png(
                    os.path.join(base, "flow_matched_image", name + ".png"),
                    apply_flow_to_image(final, dx, dy))
                _save_png(os.path.join(base, "gt_flowmatch", name + ".png"),
                          view.image)

    # Nadir DSM (render_pan.py:401-411)
    dsm_dir = os.path.join(args.model_path, "test_opNone", f"ours_{it}", "dsm")
    os.makedirs(dsm_dir, exist_ok=True)
    profile, dsm, _ = nadir_dsm(model, scene, rcfg)
    write_geotiff(os.path.join(dsm_dir, "Nadir.tif"),
                  dsm[:, :, 0].astype(np.float32),
                  transform=profile["transform"])
    with open(os.path.join(dsm_dir, "profile.json"), "w") as f:
        t = profile["transform"]
        json.dump({"xoff": t.c, "yoff": t.f, "res": t.a,
                   "height": profile["height"], "width": profile["width"]}, f)
    # png preview of the DSM (render_pan.py:422-423 matplotlib analog)
    png_dir = os.path.join(args.model_path, "test_opNone", f"ours_{it}", "png")
    os.makedirs(png_dir, exist_ok=True)
    _save_png(os.path.join(png_dir, "Nadir_dsm.png"), dsm[:, :, 0])
    print(f"rendered artifacts for iteration {it} -> {args.model_path}")
    return 0


def _nadir_sun_random(model, view, vi, out, rcfg, base, args):
    """A train view's nadir-POV render and its resample onto the view
    (nadir_pov, nadirpovsampled, nadiraltitudesampled, nadir_altitude_diff),
    the sun's (sun_pov, sunpovsampled) and, with --random-pov, a random
    camera's (render_pan.py:241-272; the reference computes these but
    comments its writes out, so they are opt-in)."""
    cam, name = view.camera, view.name
    dev = model.xyz.device
    hn, wn = out["altitude"].shape[:2]
    uva = torch.as_tensor(out["rendered_uva"], device=dev)
    bgv = torch.tensor([1.0, 0.0, 1.0, float(cam.altitude_bounds[0]), 0.0],
                       dtype=torch.float32, device=dev)
    nadir_cam, cam2nadir = cam.nadir_camera()
    nout = render_view_full(model, nadir_cam, rcfg, with_sun=False)
    _save_png(os.path.join(base, "nadir_pov", name + ".png"),
              nout["raw_render"])
    n_rgb, n_alt, _, _ = render_resample_virtual_camera(
        model, nadir_cam, cam2nadir, uva, bgv, rcfg)
    _save_png(os.path.join(base, "nadirpovsampled", name + ".png"),
              n_rgb[:, :hn, :wn])
    n_alt = _np(n_alt)[:hn, :wn]
    _save_float(os.path.join(base, "nadiraltitudesampled", name + ".tif"),
                n_alt)
    alt2d = out["altitude"]
    if alt2d.ndim == 3:
        alt2d = alt2d[..., 0]
    _save_float(os.path.join(base, "nadir_altitude_diff", name + ".tif"),
                alt2d - n_alt)
    if cam.has_sun:
        sun_cam, cam2sun = cam.sun_camera(f=1)
        sout = render_view_full(model, sun_cam, rcfg, with_sun=False)
        _save_png(os.path.join(base, "sun_pov", name + ".png"),
                  sout["raw_render"])
        s_rgb, _, _, _ = render_resample_virtual_camera(
            model, sun_cam, cam2sun, uva, bgv, rcfg)
        _save_png(os.path.join(base, "sunpovsampled", name + ".png"),
                  s_rgb[:, :hn, :wn])
    if args.random_pov:
        rand_cam, cam2rand = cam.random_camera(
            random_pov_draw(vi).to(dev), args.random_pov_extent)
        r_rgb, r_alt, r_uv, _ = render_resample_virtual_camera(
            model, rand_cam, cam2rand, uva, bgv, rcfg)
        r_alt = _np(r_alt)[:hn, :wn]
        r_diff = alt2d - r_alt
        occl = (np.abs(r_diff) < 0.30) & np.all(
            np.abs(_np(r_uv))[:hn, :wn] < 1.0, axis=-1)
        for kind in ("randompovsampled", "random_altitude_diff",
                     "random_occlusion_map"):
            os.makedirs(os.path.join(base, kind), exist_ok=True)
        _save_png(os.path.join(base, "randompovsampled", name + ".png"),
                  _np(r_rgb)[:, :hn, :wn] * occl[None])
        _save_float(os.path.join(base, "random_altitude_diff", name + ".tif"),
                    r_diff)
        _save_float(os.path.join(base, "random_occlusion_map", name + ".tif"),
                    occl.astype(np.float32))
