"""Loss library: plain functions over tensors.

Counterpart of ``eogs2_tpu/losses.py``; parity targets (the reference's
``loss/`` package):
  * photometric: (1-l)L1 + l(1-SSIM)                  (shadow.py:20-28)
  * opacity: sum(opacity)/N_init                      (opacity.py:8-21)
  * radii opacity: visible-only variant               (opacity.py:24-36)
  * accumulated opacity: mean(1 - acc)                (opacity.py:39-45)
  * translucent shadows: binary entropy of shadowmap  (shadow.py:7-17)
  * sun-camera consistency                            (shadow.py:31-52)
  * random-camera consistency w/ occlusion mask       (main_loss.py:56-233)
  * total variation on altitude                       (main_loss.py:40-53)
  * erank anti-needle regularizer                     (main_loss.py:21-37)
  * transient-material Gaussian NLL                   (train_pan.py:433-449)

Masked variants take a pixel-validity mask so padded canvases train
correctly. The PAN losses arrive with the PAN modalities (ROADMAP Queue 1
item 9).
"""

from __future__ import annotations

import torch

from eogs2_tpu_torch.ops.ssim import ssim


def masked_mean(x, mask=None):
    if mask is None:
        return torch.mean(x)
    m = torch.broadcast_to(mask, x.shape)
    return torch.sum(x * m) / torch.clamp_min(torch.sum(m), 1.0)


def l1_loss(pred, gt, mask=None):
    return masked_mean(torch.abs(pred - gt), mask)


def photometric_loss(pred, gt, lambda_dssim: float = 0.2, mask=None):
    """(1-l)*L1 + l*(1-SSIM), both averaged over the valid pixels only.
    Returns (loss, L1)."""
    ll1 = l1_loss(pred, gt, mask)
    if mask is not None:
        pred = pred * mask
        gt = gt * mask
    s = ssim(pred, gt, mask=mask)
    return (1.0 - lambda_dssim) * ll1 + lambda_dssim * (1.0 - s), ll1


def opacity_loss(opacity, alive, init_count):
    """sum(alive opacities) / N_init (opacity.py:8-21)."""
    return torch.sum(torch.where(alive, opacity, 0.0)) / init_count


def radii_opacity_loss(opacity, radii, init_count):
    return torch.sum(torch.where(radii > 0, opacity, 0.0)) / init_count


def accumulated_opacity_loss(acc_render, mask=None):
    return masked_mean(1.0 - acc_render, mask)


def translucent_shadows_loss(shadowmap, mask=None):
    """Binary entropy pushing the shadow map to {0,1} (shadow.py:7-17)."""
    a = shadowmap
    b = torch.clamp(shadowmap, 0.05, 0.95)
    ent = -(a * torch.log2(b) + (1.0 - a) * torch.log2(1.0 - b))
    return masked_mean(ent, mask)


def tv_altitude_loss(altitude):
    d1 = torch.abs(altitude[..., 1:, :] - altitude[..., :-1, :])
    d2 = torch.abs(altitude[..., :, 1:] - altitude[..., :, :-1])
    return 0.5 * (torch.mean(d1) + torch.mean(d2))


def erank_loss(scaling, alive):
    """Effective-rank anti-needle regularizer (main_loss.py:21-37)."""
    s2 = scaling ** 2 + 1e-5
    q = s2 / torch.sum(s2, dim=1, keepdim=True)
    erankm1 = torch.expm1(-torch.sum(q * torch.log(q + 1e-6), dim=1))
    per = (torch.clamp_min(-torch.log(erankm1 + 1e-5), 0.0)
           + torch.sqrt(torch.amin(s2, dim=1)))
    return masked_mean(per, alive)


def suncamera_loss(raw_render, sun_rgb_sample, sun_altitude_diff, sun_uv):
    """Altitude/RGB consistency where the sun sees the surface
    (shadow.py:31-52). Returns (alt_term, rgb_term), zeros when the
    visibility mask is empty."""
    vis = (sun_altitude_diff > -1e-2) & torch.all(torch.abs(sun_uv) < 1, dim=-1)
    vis = vis.to(raw_render.dtype)
    n_vis = torch.sum(vis)
    denom = torch.clamp_min(n_vis, 1.0)
    alt = torch.sum(torch.abs(sun_altitude_diff) * vis) / denom
    rgb = torch.sum(torch.abs(raw_render - sun_rgb_sample) * vis[None]) / denom
    any_vis = n_vis > 0
    return torch.where(any_vis, alt, 0.0), torch.where(any_vis, rgb, 0.0)


def randomcam_loss(altitude_render, new_altitude_sample, rgb_render,
                   new_rgb_sample, new_uv, occlusion_threshold: float = 0.30):
    """Virtual-camera consistency with the |d_alt| < 0.3 occlusion mask
    (main_loss.py:142-160); the mask is detached like the reference's."""
    alt_diff = altitude_render - new_altitude_sample
    occ = (torch.abs(alt_diff) < occlusion_threshold) & torch.all(
        torch.abs(new_uv) < 1, dim=-1)
    occ = occ.to(altitude_render.dtype).detach()
    n_occ = torch.sum(occ)
    denom = torch.clamp_min(n_occ, 1.0)
    alt = torch.sum(torch.abs(alt_diff) * occ) / denom
    rgb = torch.sum(torch.abs(rgb_render - new_rgb_sample) * occ[None]) / denom
    any_occ = n_occ > 0
    return torch.where(any_occ, alt, 0.0), torch.where(any_occ, rgb, 0.0)


def gaussian_nll_loss(pred, target, var, eps: float = 1e-6, mask=None):
    """torch.nn.functional.gaussian_nll_loss (full=False), masked:
    0.5 * (log(max(var, eps)) + (pred-target)^2 / max(var, eps))."""
    v = torch.clamp_min(var, eps)
    nll = 0.5 * (torch.log(v) + (pred - target) ** 2 / v)
    return masked_mean(nll, mask)


def transient_nll_loss(image, gt_image, transient_mask, mask=None):
    """Transient-material NLL (train_pan.py:433-449): variance from the
    learnable per-pixel transient mask, (clip(m, 0, 1) + 1e-3)^2."""
    betaprime = (torch.clamp(transient_mask, 0.0, 1.0) + 1e-3) ** 2
    var = torch.broadcast_to(betaprime[None], image.shape)
    return gaussian_nll_loss(image, gt_image, var, mask=mask)
