"""Optical-flow camera refinement (internal camera refinement).

Counterpart of ``eogs2_tpu/flow.py``; parity target ``flowmatching/`` in
the reference, which wraps torchvision RAFT (flow_matching.py:76-86). As in
JAX, the constant-displacement mode (raft_small.yaml, the mean flow only,
flow_matching.py:67-74) is FFT phase correlation with a sub-pixel parabola
fit, and the dense mode (raft_large) is coarse-to-fine iterative
Lucas-Kanade flow; no learned weights.

Warp convention of apply_flow (flow_matching.py:225-253): flow maps
gt -> render; the render (and gt) are sampled at grid + flow with border
padding, align_corners=True.

The render stage (``render_artifacts.render_sets``) uses the phase
correlation and the warp; the training step's flow-matching phase uses
estimate_flow, apply_flow_to_image and flow_accept, and the Trainer's
flow bake phase_correlation_shift and adjust_affine.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from eogs2_tpu_torch import losses as L
from eogs2_tpu_torch.observability import host_read
from eogs2_tpu_torch.ops.resample import grid_sample


def _to_gray(img):
    return img.mean(dim=0) if img.dim() == 3 else img


def _hann2d(h, w, like):
    def hann(n):
        i = torch.arange(n, dtype=torch.float32, device=like.device)
        return 0.5 - 0.5 * torch.cos(2 * math.pi * i / (n - 1))

    return hann(h)[:, None] * hann(w)[None, :]


def phase_correlation_shift(img_ref, img_mov):
    """Estimate the translation (dx, dy) such that img_mov(x+dx, y+dy) ~
    img_ref(x, y), i.e. the flow from img_ref to img_mov, constant over the
    image ([C,H,W] or [H,W] tensors; 0-d tensors out). Sub-pixel via a
    3-point parabola around the correlation peak."""
    a = _to_gray(img_ref).to(torch.float32)
    b = _to_gray(img_mov).to(torch.float32)
    h, w = a.shape
    win = _hann2d(h, w, a)
    fa = torch.fft.rfft2((a - a.mean()) * win)
    fb = torch.fft.rfft2((b - b.mean()) * win)
    cross = fa * torch.conj(fb)
    cross = cross / torch.clamp_min(torch.abs(cross), 1e-12)
    corr = torch.fft.irfft2(cross, s=(h, w))
    peak = torch.argmax(corr)
    py, px = peak // w, peak % w

    def parabola(c_m, c_0, c_p):
        denom = c_m - 2 * c_0 + c_p
        return torch.where(torch.abs(denom) > 1e-12, 0.5 * (c_m - c_p) / denom,
                           0.0)

    # indexing by the peak's two device scalars waits for the card twice
    cy = host_read(lambda: corr[py, px], "flow.peak", syncs=2)
    sub_y = host_read(lambda: parabola(corr[(py - 1) % h, px], cy,
                                       corr[(py + 1) % h, px]),
                      "flow.sub_y", syncs=4)
    sub_x = host_read(lambda: parabola(corr[py, (px - 1) % w], cy,
                                       corr[py, (px + 1) % w]),
                      "flow.sub_x", syncs=4)
    dy = torch.where(py > h // 2, py - h, py).to(torch.float32) + sub_y
    dx = torch.where(px > w // 2, px - w, px).to(torch.float32) + sub_x
    # corr peak at (dy,dx) means b shifted by (dy,dx) aligns with a:
    # a(x) ~ b(x - d) => flow a->b is -d
    return -dx, -dy


def _warp_by_flow(img, flow_x, flow_y):
    """apply_flow parity: sample img [C,H,W] at (grid + flow), border
    padding, align_corners=True. flow_* may be 0-d or [H,W]."""
    _, h, w = img.shape
    yy, xx = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=img.device),
        torch.arange(w, dtype=torch.float32, device=img.device),
        indexing="ij")
    # border padding == clamp coordinates to the frame
    gx = torch.clamp(xx + flow_x, 0.0, w - 1.0)
    gy = torch.clamp(yy + flow_y, 0.0, h - 1.0)
    u = 2.0 * gx / (w - 1) - 1.0
    v = 2.0 * gy / (h - 1) - 1.0
    return grid_sample(img, torch.stack([u, v], dim=-1), align_corners=True)


def _smooth(x):
    """Separable [1, 4, 6, 4, 1] / 16 blur with zero padding
    (jnp.convolve(..., mode="same") along each axis)."""
    k = torch.tensor([1.0, 4.0, 6.0, 4.0, 1.0], device=x.device)
    k = (k / k.sum()).view(1, 1, 5)
    x = F.conv1d(x[:, None, :], k, padding=2)[:, 0, :]  # along rows
    return F.conv1d(x.T[:, None, :], k, padding=2)[:, 0, :].T


def lucas_kanade_flow(img_ref, img_mov, levels: int = 3, iters: int = 10):
    """Coarse-to-fine dense LK flow from img_ref to img_mov.

    Returns (flow_x, flow_y) [H,W]. Window = 2-pixel Gaussian smoothing of
    the normal equations (structure tensor)."""
    a0 = _to_gray(img_ref).to(torch.float32)
    b0 = _to_gray(img_mov).to(torch.float32)

    def down2(x):
        h, w = x.shape
        return _smooth(x)[: h - h % 2 : 2, : w - w % 2 : 2]

    pyr_a, pyr_b = [a0], [b0]
    for _ in range(levels - 1):
        pyr_a.append(down2(pyr_a[-1]))
        pyr_b.append(down2(pyr_b[-1]))

    fx = torch.zeros_like(pyr_a[-1])
    fy = torch.zeros_like(pyr_a[-1])
    for lvl in reversed(range(levels)):
        a, b = pyr_a[lvl], pyr_b[lvl]
        h, w = a.shape
        if fx.shape != a.shape:  # jax.image.resize's bilinear upsampling
            up = F.interpolate(torch.stack([fx, fy])[None], size=(h, w),
                               mode="bilinear", align_corners=False)[0]
            fx, fy = 2.0 * up[0], 2.0 * up[1]
        for _ in range(iters):
            bw = _warp_by_flow(b[None], fx, fy)[0]
            (ix,) = torch.gradient(bw, dim=1)
            (iy,) = torch.gradient(bw, dim=0)
            it = bw - a
            a11 = _smooth(ix * ix) + 1e-4
            a12 = _smooth(ix * iy)
            a22 = _smooth(iy * iy) + 1e-4
            b1 = _smooth(ix * it)
            b2 = _smooth(iy * it)
            det = a11 * a22 - a12 * a12
            dx = (-a22 * b1 + a12 * b2) / det
            dy = (a12 * b1 - a11 * b2) / det
            fx, fy = fx + dx, fy + dy
    return fx, fy


def estimate_flow(gt_image, render, perform_cst_displacement: bool = True):
    """Unified entry mirroring performOpticalmatching.get_flow: flow from
    gt to render; constant mode collapses to the phase-correlation shift.

    Returns (flow_x, flow_y) broadcastable to [H,W]."""
    if perform_cst_displacement:
        return phase_correlation_shift(gt_image, render)
    return lucas_kanade_flow(gt_image, render)


def apply_flow_to_image(img, flow_x, flow_y):
    """Warp `img` (the render) by the gt->render flow (apply_flow parity)."""
    return _warp_by_flow(img, flow_x, flow_y)


def flow_accept(criteria: str, flow_mag, image, warped, gt_image, valid,
                max_value_flow: float):
    """Warp acceptance test, perform_flow_matching parity
    (flow_matching.py:305-329); returns a bool tensor.

      * max_value_flow: accept when mean |flow| is below the threshold.
      * always: accept unconditionally.
      * psnr: accept when the warp improves PSNR vs GT (equivalently lowers
        the masked MSE).
      * l_photom: accept when the warp lowers (1-l)L1 + l(1-SSIM) with the
        reference's hardcoded lambda_dssim=0.2.
    """
    if criteria == "max_value_flow":
        return torch.as_tensor(flow_mag < max_value_flow)
    if criteria == "always":
        return torch.tensor(True, device=image.device)
    if criteria == "psnr":
        mse_b = L.masked_mean((image - gt_image) ** 2, valid)
        mse_a = L.masked_mean((warped - gt_image) ** 2, valid)
        return mse_a < mse_b
    if criteria == "l_photom":
        lp_b, _ = L.photometric_loss(image, gt_image, 0.2, mask=valid)
        lp_a, _ = L.photometric_loss(warped, gt_image, 0.2, mask=valid)
        return lp_a < lp_b
    raise ValueError(f"unknown flowmatching criteria {criteria!r}")


def adjust_affine(affine, img_w: int, img_h: int, mean_flow_x, mean_flow_y):
    """Bake the mean gt->render flow into the camera intercept
    (flow_matching_toaffine.py:11-25): b[0] -= dx * 2/W, b[1] -= dy * 2/H.

    `affine` is [3,4] math orientation; returns the corrected matrix."""
    out = affine.clone()
    out[0, 3] = out[0, 3] + (-mean_flow_x * 2.0 / img_w)
    out[1, 3] = out[1, 3] + (-mean_flow_y * 2.0 / img_h)
    return out
