"""The reference of ``render_view_full``: the main render, the sun render
resampled onto it, the colour correction and the shadow (identity colour
matrix and the 0.05 in-shadow scale of a fresh model), cropped to the
native size."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference.render import (TILE, camera, einsum, render,
                                        resize_canvas, sun_camera, uva)

C0 = 0.28209479177387814


@torch.no_grad()
def render_view(g, md, precision="fp32"):
    """g: the Gaussians (xyz, features_dc, scaling, rotation, opacity) as
    raw parameters; md: the view's metadata. Returns raw_render [3,H,W],
    altitude, acc_opacity [H,W], final [3,H,W]."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cam = camera(md, g["xyz"].device)
    wn, hn = cam.width, cam.height
    wp, hp = -(-wn // TILE) * TILE, -(-hn // TILE) * TILE
    dev = g["xyz"].device
    bg = torch.tensor([1.0, 0.0, 1.0, cam.alt_min, 0.0], device=dev)
    xyz, rot = g["xyz"], g["rotation"]
    rgb = g["features_dc"][:, 0, :] * C0 + 0.5
    scaling = torch.exp(g["scaling"])
    opac = torch.sigmoid(g["opacity"][:, 0])

    def raster(c, vw, vh):
        alt = uva(xyz, c.affine, precision)[:, 2:3]
        feats = torch.cat([rgb, alt, torch.ones_like(alt)], -1)
        return render(xyz, scaling, rot, opac, feats, resize_canvas(c, vw, vh),
                      bg, vw, vh, precision).image

    img = raster(cam, wp, hp)
    raw, altitude, acc = img[:3], img[3], img[4]
    u = 2.0 * torch.arange(wp, device=dev) / (wn - 1) - 1.0
    v = 2.0 * torch.arange(hp, device=dev) / (hn - 1) - 1.0
    vv, uu = torch.meshgrid(v, u, indexing="ij")
    ruva = torch.stack([uu, vv, altitude], -1)
    scam, cam2sun = sun_camera(cam, 2)
    simg = raster(scam, -(-scam.width // TILE) * TILE,
                  -(-scam.height // TILE) * TILE)
    v_uv = einsum("ij,hwj->hwi", cam2sun, ruva, precision)[..., :2]
    samp = F.grid_sample(simg[3:4][None], v_uv[None], mode="bilinear",
                         padding_mode="zeros", align_corners=True)[0, 0]
    samp = torch.where((v_uv.abs() > 1.0).any(-1), -100.0, samp)
    smap = torch.exp(0.4 * torch.clamp_max(altitude - samp, 0.0))
    final = smap[None] * raw + (1.0 - smap[None]) * 0.05 * raw
    return dict(raw_render=raw[:, :hn, :wn], altitude=altitude[:hn, :wn],
                acc_opacity=acc[:hn, :wn], final=final[:, :hn, :wn])
