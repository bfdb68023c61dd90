"""Inference pipeline: full per-view rendering, the Nadir DSM and its MAE.

Counterpart of ``eogs2_tpu/pipeline.py``; parity targets
``render_all_views`` (renderer_cc_shadow.py:148-193) and the test-iteration
DSM hook of train_pan.py:738-797 (render the Nadir test camera, build the
DSM, register against GT, report MAE). Everything renders under
``torch.no_grad()`` on the model's device; the DSM flatten, the
registration and the MAE run on the host in float64, as in JAX.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from eogs2_tpu_torch.cameras import AffineCamera
from eogs2_tpu_torch.eval.dsm import compute_dsm_from_view
from eogs2_tpu_torch.eval.mae import MaeComputer
from eogs2_tpu_torch.model import GaussianModel
from eogs2_tpu_torch.observability import host_read, span
from eogs2_tpu_torch.ops.projection import TILE
from eogs2_tpu_torch.ops.resample import grid_sample
from eogs2_tpu_torch.ops.sh import SH2RGB
from eogs2_tpu_torch.rasterizer import RasterizeConfig, rasterize
from eogs2_tpu_torch.scene import SceneData
from eogs2_tpu_torch.shading import CameraShadingParams, render_pipeline


def _pad16(x):
    return ((x + TILE - 1) // TILE) * TILE


def _np(x):
    if x is None:
        return None
    return host_read(lambda: x.detach().cpu().numpy(), "serve.to_host")


@torch.no_grad()
@span("serve.request", unit=True)
def render_view_full(
    model: GaussianModel,
    camera: AffineCamera,
    raster_cfg: RasterizeConfig,
    shading: Optional[CameraShadingParams] = None,
    view_idx: int = 0,
    bg: Optional[np.ndarray] = None,
    with_sun: bool = True,
    use_cc: bool = True,
    use_shadow: bool = True,
    pan_mode: Optional[str] = None,
    weird_pan_setup: bool = False,
):
    """Full no-grad pipeline for one view: main render, sun render resampled
    onto the main camera, shading. Returns a dict of numpy arrays cropped to
    the camera's native size."""
    dev = model.xyz.device
    wn, hn = camera.width, camera.height
    wp, hp = _pad16(wn), _pad16(hn)
    if bg is None:
        alt0 = host_read(camera.altitude_bounds[0], "serve.bg_altitude")
        bg = np.array([1.0, 0.0, 1.0, float(alt0), 0.0], np.float32)
    bg = host_read(lambda: torch.tensor(np.asarray(bg, np.float32),
                                        device=dev), "serve.bg")

    rgb = SH2RGB(model.features_dc[:, 0, :])
    scaling = torch.exp(model.scaling)
    opacity = torch.sigmoid(model.opacity[:, 0])

    def raster(cam, vw, vh):
        alt = cam.ecef_to_uva(model.xyz)[:, 2:3]
        feats = torch.cat([rgb, alt, torch.ones_like(alt)], dim=-1)
        return rasterize(
            model.xyz, scaling, model.rotation, opacity, feats,
            cam.resize_canvas(vw, vh).affine, bg, vw, vh, raster_cfg,
            alive=model.alive,
        )

    out = raster(camera, wp, hp)
    raw = out.image[:3]
    altitude = out.image[3]
    acc = out.image[4]

    # native-convention UV grid extended over the padding (train.py's)
    u = (2.0 * torch.arange(wp, device=dev) / (wn - 1)) - 1.0
    v = (2.0 * torch.arange(hp, device=dev) / (hn - 1)) - 1.0
    vv, uu = torch.meshgrid(v, u, indexing="ij")
    rendered_uva = torch.stack([uu, vv, altitude], dim=-1)

    sun_altitude_diff = None
    if with_sun and camera.has_sun:
        sun_cam, cam2sun = camera.sun_camera(f=2)
        sout = raster(sun_cam, _pad16(sun_cam.width), _pad16(sun_cam.height))
        v_uv = torch.einsum("ij,hwj->hwi", cam2sun, rendered_uva)[..., :2]
        samp = grid_sample(sout.image[3:4], v_uv, align_corners=True)[0]
        samp = torch.where(torch.any(torch.abs(v_uv) > 1.0, dim=-1), -100.0,
                           samp)
        sun_altitude_diff = altitude - samp

    if shading is not None:
        with span("serve.shading"):
            shaded_out = render_pipeline(
                raw,
                sun_altitude_diff,
                shading.cc_weight[view_idx],
                shading.cc_bias[view_idx],
                shading.inshadow[view_idx],
                use_cc=use_cc,
                use_shadow=use_shadow,
                exposure=shading.exposure[view_idx],
                pan_mode=pan_mode,
                pan_weight=shading.msi_to_pan_weight[view_idx],
                pan_bias=shading.msi_to_pan_bias[view_idx],
                weird_pan_setup=weird_pan_setup,
            )
    else:
        shaded_out = {"shadowmap": None, "cc": raw, "shaded": raw, "final": raw}

    def crop(x):
        x = _np(x)
        if x is None:
            return None
        return x[:, :hn, :wn] if x.ndim == 3 else x[:hn, :wn]

    with span("serve.to_host"):
        return {
            "raw_render": crop(raw),
            "altitude": crop(altitude),
            "acc_opacity": crop(acc),
            "cc": crop(shaded_out["cc"]),
            "shaded": crop(shaded_out["shaded"]),
            "final": crop(shaded_out["final"]),
            "shadowmap": crop(shaded_out["shadowmap"]),
            "rendered_uva": _np(rendered_uva)[:hn, :wn],
        }


def nadir_dsm(
    model: GaussianModel,
    scene: SceneData,
    raster_cfg: RasterizeConfig,
    resolution: Optional[float] = None,
    scene_name: str = "",
):
    """Render the Nadir test camera and flatten it into the DSM
    (train_pan.py:738-786). Returns (profile, dsm [H',W',1], render dict)."""
    nadir = [v for v in scene.test_views if "Nadir" in v.name]
    assert nadir, "scene has no Nadir test camera"
    cam = nadir[0].camera
    out = render_view_full(model, cam, raster_cfg, with_sun=False)
    profile, dsm = compute_dsm_from_view(
        cam,
        out["rendered_uva"],
        scene.scene_shift,
        scene.scene_scale,
        scene_name=scene_name,
        resolution=resolution,
    )
    return profile, dsm, out


def evaluate_dsm_mae(
    model: GaussianModel,
    scene: SceneData,
    mae_computer: MaeComputer,
    raster_cfg: RasterizeConfig,
    resolution: Optional[float] = None,
    scene_name: str = "",
):
    """The Nadir DSM (nadir_dsm: render on the model's device, flatten on
    the host) registered against the ground truth. Returns (mae, dsm
    [H',W',1], diff, registered dsm)."""
    profile, dsm, _ = nadir_dsm(model, scene, raster_cfg, resolution,
                                scene_name)
    mae, diff, rdsm = mae_computer.compute_mae(dsm[:, :, 0],
                                               profile["transform"])
    return mae, dsm, diff, rdsm
