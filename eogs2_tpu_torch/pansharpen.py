"""Pansharpening algorithms (image-prep time).

Counterpart of ``eogs2_tpu/pansharpen.py``; parity target
``pansharpening/``: Brovey (brovey.py:33-49), simple Brovey (brovey.py:5-30),
IHS (ihs.py:6-34), the resize helper and the factory
(load_pansharp.py:4-18). ``Trainer.setup`` applies one once to the PAN GT
when ``opt.apply_pansharp`` (train_pan.py:338-345). Inputs are tensors or
numpy arrays; outputs are tensors on the inputs' device.
"""

from __future__ import annotations

import torch


def _weight_mat(n_in: int, n_out: int, like) -> torch.Tensor:
    """[n_in, n_out] weights of a triangle-kernel resize along one axis:
    jax.image.resize's "bilinear" (scale_and_translate with antialiasing:
    the kernel is widened by the scale when downsampling; the weights of
    each output sample are normalised over the inputs, and a sample outside
    the input range gets none)."""
    scale = n_out / n_in
    inv = 1.0 / scale
    kscale = max(inv, 1.0)
    dt = like.dtype
    sample = ((torch.arange(n_out, dtype=dt, device=like.device) + 0.5) * inv
              - 0.5)
    x = torch.abs(sample[None, :] - torch.arange(n_in, dtype=dt,
                                                 device=like.device)[:, None])
    w = torch.clamp_min(1.0 - x / kscale, 0.0)
    total = w.sum(0, keepdim=True)
    w = torch.where(torch.abs(total) > 1000.0 * torch.finfo(torch.float32).eps,
                    w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, 0.0)


def resize_chw(img, out_hw, method="bilinear"):
    """[C,h,w] -> [C,H,W] (jax.image.resize's bilinear)."""
    if method != "bilinear":
        raise ValueError(f"resize method {method!r}: only bilinear")
    img = torch.as_tensor(img)
    h, w = img.shape[-2:]
    out_h, out_w = (int(s) for s in out_hw)
    if h != out_h:
        img = torch.einsum("chw,hH->cHw", img, _weight_mat(h, out_h, img))
    if w != out_w:
        img = torch.einsum("chw,wW->chW", img, _weight_mat(w, out_w, img))
    return img


def _pan_2d(img_pan):
    img_pan = torch.as_tensor(img_pan)
    return img_pan if img_pan.dim() == 2 else img_pan[0]


def brovey(img_pan, img_msi, w: float = 0.1):
    """Brovey: pansharped = pan / (w * sum_c msi_up) * msi_up.

    img_pan: [1,H,W] or [H,W]; img_msi: [C,h,w]. Returns [C,H,W]."""
    pan = _pan_2d(img_pan)
    msi_up = resize_chw(img_msi, pan.shape)
    denom = torch.clamp_min(w * torch.sum(msi_up, dim=0, keepdim=True), 1e-8)
    return (pan[None] / denom) * msi_up


def simple_brovey(img_pan, img_msi):
    """simple Brovey: ratio = pan / sum(msi_up)."""
    pan = _pan_2d(img_pan)
    msi_up = resize_chw(img_msi, pan.shape)
    ratio = pan[None] / (torch.sum(msi_up, dim=0, keepdim=True) + 1e-8)
    return msi_up * ratio


def ihs(img_pan, img_msi):
    """IHS: add the intensity delta to the upsampled MSI, clamp [0,1]."""
    pan = _pan_2d(img_pan)
    msi_up = resize_chw(img_msi, pan.shape)
    i0 = torch.mean(msi_up, dim=0)
    return torch.clamp(msi_up + (pan - i0)[None], 0.0, 1.0)


def load_pansharp(method: str):
    return {
        "brovey": brovey,
        "simple_brovey": simple_brovey,
        "ihs": ihs,
    }[method]
