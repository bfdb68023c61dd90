"""Per-camera shading: color correction -> sun shadow -> MSI->PAN.

Counterpart of ``eogs2_tpu/shading.py``; parity targets
AffineCamera.render_pipeline (affine_cameras.py:303-348), ShadowMap
(:33-40), PANAffineCamera (PAN_affine_cameras.py) and the MSI->PAN family
(scene/msi_to_pan/transf_msi_to_pan.py). Per-view learnables are stacked
[V, ...] tensors indexed by view.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from eogs2_tpu_torch.device import resolve_device
from eogs2_tpu_torch.observability import host_read

# Fixed WorldView-3 spectral weights (transf_msi_to_pan.py:5-24):
# pan = w3 * (sum_c w[c] * msi_c + w4)
WV3_PAN_PARAMS = (0.438469, 1.1331377, -0.6794343, 1.0, 0.0016913427)
_WV3 = {}  # (dtype, device) -> the weights [3], made once


def _wv3(dtype, device) -> torch.Tensor:
    """The three fixed WV3 weights on ``device``: a host list copied to
    the card waits for it, so the copy is made once per device and dtype,
    not at every PAN render."""
    w = _WV3.get((dtype, device))
    if w is None:
        w = _WV3[(dtype, device)] = host_read(
            lambda: torch.tensor(WV3_PAN_PARAMS[:3], dtype=dtype,
                                 device=device), "shading.wv3")
    return w


@dataclasses.dataclass
class CameraShadingParams:
    """Stacked per-view shading parameters ([V, ...])."""

    cc_weight: torch.Tensor  # [V,3,3] identity-initialized color matrix
    cc_bias: torch.Tensor  # [V,3]
    inshadow: torch.Tensor  # [V,3] in-shadow color scale (init 0.05)
    last_row: torch.Tensor  # [V,4] learnable pose residual (init 0)
    exposure: torch.Tensor  # [V,3,4] affine exposure (init [I|0])
    msi_to_pan_weight: torch.Tensor  # [V,3]
    msi_to_pan_bias: torch.Tensor  # [V]
    transient_mask: Optional[torch.Tensor] = None  # [V,H,W] or [V,1,1]

    @classmethod
    def from_numpy(cls, fields: dict, device=None) -> "CameraShadingParams":
        """From numpy arrays keyed by field name (e.g. a JAX params' fields);
        a missing or None transient_mask stays None."""
        dev = resolve_device(device)
        kw = {f.name: torch.tensor(np.asarray(fields[f.name], np.float32),
                                   device=dev)
              for f in dataclasses.fields(cls)
              if fields.get(f.name) is not None}
        return cls(**kw)


def init_shading_params(num_views: int, transient_hw=None,
                        transient_init: float = 0.01,
                        device=None) -> CameraShadingParams:
    """Identity color correction, 0.05 in-shadow scale, WV3 PAN weights."""
    t_shape = (num_views,) + (tuple(transient_hw) if transient_hw else (1, 1))
    return CameraShadingParams.from_numpy(dict(
        transient_mask=np.full(t_shape, transient_init, np.float32),
        cc_weight=np.tile(np.eye(3, dtype=np.float32)[None], (num_views, 1, 1)),
        cc_bias=np.zeros((num_views, 3), np.float32),
        inshadow=np.full((num_views, 3), 0.05, np.float32),
        last_row=np.zeros((num_views, 4), np.float32),
        exposure=np.tile(np.eye(3, 4, dtype=np.float32)[None],
                         (num_views, 1, 1)),
        msi_to_pan_weight=np.tile(
            np.asarray(WV3_PAN_PARAMS[:3], np.float32)[None], (num_views, 1)),
        msi_to_pan_bias=np.full((num_views,), WV3_PAN_PARAMS[4], np.float32),
    ), device=device)


def shadow_map(sun_altitude_diff):
    """exp(0.4 * min(diff, 0)) in (0, 1] (affine_cameras.py:33-40)."""
    return torch.exp(0.4 * torch.clamp_max(sun_altitude_diff, 0.0))


def apply_cc(img_chw, weight, bias):
    """1x1 conv color correction: out[c] = sum_k W[c,k] img[k] + b[c]."""
    return torch.einsum("ck,khw->chw", weight, img_chw) + bias[:, None, None]


def apply_exposure(img_chw, exposure):
    """Affine exposure out = E[:, :3] @ img + E[:, 3] (affine_cameras.py:313-323)."""
    return (torch.einsum("ck,khw->chw", exposure[:, :3], img_chw)
            + exposure[:, 3][:, None, None])


def msi_to_pan(img_chw, mode: str, weight=None, bias=None):
    """MSI (3ch) -> PAN (1ch): 'fixed' (WV3), 'learned', 'average',
    'identity', 'only_one_channel', 'fixedandtranslate' (detached fixed WV3
    path + learnable residual, transf_msi_to_pan.py:134-178)."""
    if mode == "identity":
        return img_chw
    if mode == "average":
        return torch.mean(img_chw, dim=0, keepdim=True)
    if mode == "only_one_channel":
        return img_chw[:1]
    wv3 = _wv3(img_chw.dtype, img_chw.device)
    if mode == "fixedandtranslate":
        fixed = (torch.sum(wv3[:, None, None] * img_chw, dim=0, keepdim=True)
                 + WV3_PAN_PARAMS[4]).detach()
        residual = (torch.sum(weight[:, None, None] * img_chw, dim=0,
                              keepdim=True) + bias)
        return fixed + residual
    if mode == "fixed":
        w, b, scale = wv3, WV3_PAN_PARAMS[4], WV3_PAN_PARAMS[3]
    elif mode == "learned":
        w, b, scale = weight, bias, 1.0
    else:
        raise ValueError(f"unknown msi_to_pan mode: {mode}")
    return scale * (torch.sum(w[:, None, None] * img_chw, dim=0, keepdim=True) + b)


def render_pipeline(
    raw_render,  # [3,H,W]
    sun_altitude_diff,  # [H,W] or None
    cc_weight,
    cc_bias,
    inshadow,
    use_cc: bool = True,
    use_shadow: bool = True,
    exposure=None,
    use_exposure: bool = False,
    pan_mode: Optional[str] = None,
    pan_weight=None,
    pan_bias=None,
    weird_pan_setup: bool = False,
):
    """Shading for one view -> dict shadowmap / cc / shaded / final."""
    if weird_pan_setup and pan_mode is not None:
        # PAN conversion first, then 1-channel cc (PAN_affine_cameras.py:148-176)
        pan = msi_to_pan(raw_render, pan_mode, pan_weight, pan_bias)
        cc = apply_cc(pan, cc_weight[:1, :1], cc_bias[:1]) if use_cc else pan
        if use_shadow and sun_altitude_diff is not None:
            s = shadow_map(sun_altitude_diff)
            shaded = s[None] * cc + (1.0 - s[None]) * inshadow[:1, None, None] * cc
        else:
            s = None
            shaded = cc
        return {"shadowmap": s, "cc": cc, "shaded": shaded, "final": shaded}

    if use_cc:
        cc = apply_cc(raw_render, cc_weight, cc_bias)
    elif use_exposure:
        cc = apply_exposure(raw_render, exposure)
    else:
        cc = raw_render

    if use_shadow and sun_altitude_diff is not None:
        s = shadow_map(sun_altitude_diff)
        shaded = s[None] * cc + (1.0 - s[None]) * inshadow[:, None, None] * cc
    else:
        s = None
        shaded = cc

    if pan_mode is not None:
        shaded = msi_to_pan(shaded, pan_mode, pan_weight, pan_bias)

    return {"shadowmap": s, "cc": cc, "shaded": shaded, "final": shaded}
