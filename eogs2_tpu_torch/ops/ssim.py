"""SSIM with the 11x11 sigma-1.5 Gaussian window, and PSNR.

Counterpart of ``eogs2_tpu/ops/ssim.py``; parity target
``utils/loss_utils.py:43-85`` (the standard 3DGS SSIM): per-channel
depthwise convolution (``F.conv2d`` with ``groups=C``) with zero 'same'
padding, C1 = 0.01^2, C2 = 0.03^2, mean over everything or over a mask.
cuDNN's TF32 is off (eogs2_tpu_torch/__init__.py), so the convolutions run
in float32 on the card.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _gaussian_window(window_size: int, sigma: float, dtype, device):
    xs = torch.arange(window_size, dtype=dtype, device=device) \
        - window_size // 2
    g = torch.exp(-(xs ** 2) / (2.0 * sigma ** 2))
    g = g / torch.sum(g)
    return g[:, None] * g[None, :]  # [W,W]


def _depthwise_same(img, window):
    """img [C,H,W], window [K,K] -> same-padded depthwise conv (zero pad)."""
    c, k = img.shape[0], window.shape[0]
    kernel = window[None, None].expand(c, 1, k, k)
    return F.conv2d(img[None], kernel, padding=k // 2, groups=c)[0]


def ssim(img1, img2, window_size: int = 11, sigma: float = 1.5, mask=None):
    """Mean SSIM over [C,H,W] images (values expected in [0,1]).

    mask (broadcastable to [C,H,W]): average the SSIM map over valid pixels
    only, so a padded canvas neither dilutes nor shifts the value."""
    window = _gaussian_window(window_size, sigma, img1.dtype, img1.device)
    mu1 = _depthwise_same(img1, window)
    mu2 = _depthwise_same(img2, window)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = _depthwise_same(img1 * img1, window) - mu1_sq
    sigma2_sq = _depthwise_same(img2 * img2, window) - mu2_sq
    sigma12 = _depthwise_same(img1 * img2, window) - mu1_mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    ssim_map = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2)
    )
    if mask is None:
        return torch.mean(ssim_map)
    m = torch.broadcast_to(mask, ssim_map.shape).to(ssim_map.dtype)
    return torch.sum(ssim_map * m) / torch.clamp_min(torch.sum(m), 1.0)


def psnr(img1, img2):
    """Per-image PSNR, matching utils/image_utils.py:19-21."""
    mse = torch.mean((img1 - img2) ** 2)
    return 20.0 * torch.log10(1.0 / torch.sqrt(mse + 1e-12))
