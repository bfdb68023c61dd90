"""EOGS-level rendering: feature assembly, virtual-camera resampling.

Counterpart of ``eogs2_tpu/renderer.py``; parity targets
``gaussian_renderer/renderer.py`` (colors_precomp = [SH2RGB(f_dc), altitude,
1], renderer.py:87-93) and ``renderer_cc_shadow.py`` (render a virtual
camera, reproject the main camera's (u, v, alt) grid through cam2virt,
grid_sample, out-of-FOV altitude = -100, :6-54).
"""

from __future__ import annotations

import torch

from eogs2_tpu_torch.cameras import AffineCamera
from eogs2_tpu_torch.model import GaussianModel
from eogs2_tpu_torch.ops.resample import grid_sample
from eogs2_tpu_torch.rasterizer import RasterizeConfig, rasterize


def gaussian_features(model: GaussianModel, camera: AffineCamera):
    """[N,5] = rgb, altitude under this camera, constant 1."""
    rgb = model.get_rgb()
    alt = camera.ecef_to_uva(model.xyz)[:, 2:3]
    return torch.cat([rgb, alt, torch.ones_like(alt)], dim=-1)


def render(model: GaussianModel, camera: AffineCamera, bg,
           config: RasterizeConfig, width=None, height=None):
    """The 5-channel EOGS image from one camera, plus its split channels."""
    out = rasterize(
        model.xyz, model.get_scaling(), model.get_rotation_raw(),
        model.get_opacity(), gaussian_features(model, camera), camera.affine,
        bg, width=width or camera.width, height=height or camera.height,
        config=config, alive=model.alive,
    )
    return {
        "out": out,
        "raw_render": out.image[:3],
        "altitude": out.image[3],
        "acc_opacity": out.image[4],
    }


def render_resample_virtual_camera(model: GaussianModel,
                                   virtual_camera: AffineCamera, cam2virt,
                                   rendered_uva, bg, config: RasterizeConfig):
    """Render from `virtual_camera`, resample onto the true camera's grid.

    cam2virt [3,3] maps the true camera's UVA into the virtual one;
    rendered_uva [H,W,3] is the true render's (u, v, altitude). Returns
    (rgb sample [3,H,W], altitude sample [H,W], virtual uv [H,W,2],
    virtual render [5,Hv,Wv])."""
    virtual_render = render(model, virtual_camera, bg, config)["out"].image
    virtual_uv = torch.einsum("ij,hwj->hwi", cam2virt, rendered_uva)[..., :2]
    sample = grid_sample(virtual_render, virtual_uv, align_corners=True)
    out_of_fov = torch.any(torch.abs(virtual_uv) > 1.0, dim=-1)
    alt_sample = torch.where(out_of_fov, -100.0, sample[3])
    return sample[:3], alt_sample, virtual_uv, virtual_render


def rendered_uva_grid(camera: AffineCamera, altitude, width=None, height=None):
    """[H,W,3] camera UV grid stacked with the rendered altitude
    (train_pan.py:282); pass the padded size when rendering padded."""
    if width is None:
        uv = camera.uv_grid()
    else:
        kw = dict(dtype=altitude.dtype, device=altitude.device)
        u = torch.linspace(-1.0, 1.0, width, **kw)
        v = torch.linspace(-1.0, 1.0, height, **kw)
        vv, uu = torch.meshgrid(v, u, indexing="ij")
        uv = torch.stack([uu, vv], dim=-1)
    return torch.cat([uv, altitude[..., None]], dim=-1)
