"""GT-image normalizers applied at load time.

Counterpart of ``eogs2_tpu/rescalers.py``; parity target
``utils/rescaler/rescaler.py``: clamper (default), standard (per-image
min-max), rescale-wrt-first-image, histogram equalization, CLAHE,
identity. Numpy on the host, applied once per image by
``scene.build_scene``.
"""

from __future__ import annotations

import numpy as np


def clamper(x, min_val=0.0, max_val=1.0):
    return np.clip(x, min_val, max_val)


def standard_rescaler(x):
    mn = x.reshape(x.shape[0], -1).min(axis=1)[:, None, None]
    mx = x.reshape(x.shape[0], -1).max(axis=1)[:, None, None]
    return (x - mn) / (mx - mn + 1e-8)


def identity(x):
    return x


def histogram_equalizer(x):
    """Per-channel uint8 histogram equalization (torchvision equalize
    semantics)."""
    out = np.empty_like(x)
    for c in range(x.shape[0]):
        u8 = np.clip(x[c] * 255.0, 0, 255).astype(np.uint8)
        hist = np.bincount(u8.ravel(), minlength=256)
        nonzero = hist[hist > 0]
        if len(nonzero) <= 1:
            out[c] = x[c]
            continue
        step = (hist.sum() - nonzero[-1]) // 255
        if step == 0:
            out[c] = x[c]
            continue
        lut = (np.cumsum(hist) - hist // 2) // step
        lut = np.clip(np.concatenate([[0], lut[:-1]]), 0, 255)
        out[c] = lut[u8] / 255.0
    return out


def clahe(x, clip_limit=2.0, grid=(8, 8)):
    """CLAHE through cv2, imported at the call (the reference uses kornia;
    cv2 is the available equivalent, as in JAX)."""
    import cv2

    xn = standard_rescaler(x)
    cl = cv2.createCLAHE(clipLimit=clip_limit, tileGridSize=grid)
    out = np.empty_like(xn)
    for c in range(xn.shape[0]):
        u8 = np.clip(xn[c] * 255.0, 0, 255).astype(np.uint8)
        out[c] = cl.apply(u8) / 255.0
    return out


class FirstImageRescaler:
    """rescale_wrt_firstimage: normalize every image by the reference
    camera's per-channel min/max."""

    def __init__(self, reference_image):
        r = reference_image.reshape(reference_image.shape[0], -1)
        self.mn = r.min(axis=1)[:, None, None]
        self.mx = r.max(axis=1)[:, None, None]

    def __call__(self, x):
        return (x - self.mn) / (self.mx - self.mn + 1e-8)


def load_rescaler(name: str, reference_image=None):
    if name in ("clamper", None, ""):
        return clamper
    if name == "standard_rescaler":
        return standard_rescaler
    if name == "identity":
        return identity
    if name == "histogram_equalizer":
        return histogram_equalizer
    if name == "CLAHE_rescaler":
        return clahe
    if name == "rescale_wrt_firstimage":
        if reference_image is None:
            raise ValueError("rescale_wrt_firstimage needs the reference "
                             "image")
        return FirstImageRescaler(reference_image)
    raise ValueError(f"unknown rescaler {name}")
