"""Colour maintenance operations.

Counterpart of ``eogs2_tpu/color_ops.py``; parity targets:
  * color_reset (densification_pruning/color_reset_op.py:41-88): render all
    train views, 5x5 min-pool each shadow map, sample it at the Gaussians'
    projected UV; the Gaussians in shadow in every view get their colour,
    opacity and scale reset and their Adam moments zeroed.
  * normalize_before_saving (utils/save_utils.py:10-34): bake the reference
    camera's colour correction into the Gaussian colours and re-express
    every camera's correction relative to it.
  * cc train->test conversion (utils/convert_color_correction.py): copy the
    reference correction, or the train cameras' average, onto test cameras.

``apply_color_reset`` and ``normalize_colors_before_saving`` write the
model's parameters (and, for the reset, ``torch.optim.Adam``'s moments) in
place, as ``densify.py`` does; JAX returns new trees.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from eogs2_tpu_torch.model import GaussianModel, inverse_sigmoid
from eogs2_tpu_torch.ops.resample import grid_sample
from eogs2_tpu_torch.ops.sh import RGB2SH, SH2RGB
from eogs2_tpu_torch.shading import CameraShadingParams


def min_pool_5x5(x):
    """1 - maxpool(1-x) with a 5x5 window, stride 1, pad 2 ([H,W])."""
    return -F.max_pool2d(-x[None, None], 5, stride=1, padding=2)[0, 0]


def shadow_reset_mask(shadowmaps, proj_uvs):
    """[V,H,W] shadow maps + [V,N,2] per-view Gaussian UVs -> [N] bool mask
    of the Gaussians in deep shadow in every view."""
    per_view = []
    for shadow, uv in zip(shadowmaps, proj_uvs):
        pooled = min_pool_5x5(shadow)
        samp = grid_sample(pooled[None], uv[None], align_corners=True)[0, 0]
        per_view.append(samp < 0.5)
    return torch.stack(per_view).all(dim=0)


@torch.no_grad()
def apply_color_reset(model: GaussianModel, opt: torch.optim.Optimizer,
                      to_reset) -> None:
    """Colour to 1.1, opacity to 0.005, scale to 1/400 on the alive rows of
    ``to_reset``; their Adam moments of those three leaves zeroed
    (color_reset_op.py:64-88). In place."""
    to_reset = to_reset & model.alive
    f32 = dict(dtype=torch.float32, device=model.opacity.device)
    news = {
        model.opacity: inverse_sigmoid(torch.tensor(0.005, **f32)),
        model.features_dc: RGB2SH(torch.tensor(1.1, **f32)),
        model.scaling: torch.log(torch.tensor(1.0 / 400, **f32)),
    }
    for p, value in news.items():
        m = to_reset.reshape((-1,) + (1,) * (p.dim() - 1))
        p.copy_(torch.where(m, value, p))
        state = opt.state.get(p)
        if state:
            for key in ("exp_avg", "exp_avg_sq"):
                state[key].copy_(torch.where(m, 0.0, state[key]))


@torch.no_grad()
def normalize_colors_before_saving(model: GaussianModel,
                                   shading: CameraShadingParams,
                                   reference_idx: int) -> None:
    """Bake the reference camera's cc into the Gaussian colours and
    re-express every camera's cc relative to it (save_utils.py:10-34). In
    place."""
    a1 = shading.cc_weight[reference_idx]
    b1 = shading.cc_bias[reference_idx]
    a1inv = torch.linalg.inv(a1.double()).float()
    rgb = SH2RGB(model.features_dc)  # [N,1,3]
    normalized = torch.einsum("ij,nkj->nki", a1, rgb) + b1
    new_w = torch.einsum("vij,jk->vik", shading.cc_weight, a1inv)
    new_b = shading.cc_bias - torch.einsum("vij,j->vi", new_w, b1)
    model.features_dc.copy_(RGB2SH(normalized))
    shading.cc_weight.copy_(new_w)
    shading.cc_bias.copy_(new_b)


def cc_train_to_test(shading: CameraShadingParams, train_idx, test_idx,
                     mode: str = "average",
                     reference_idx: int = 0) -> CameraShadingParams:
    """Fill the test cameras' cc from the train cameras'
    (convert_color_correction.py). ``shading`` holds stacked parameters of
    the train and test views; train_idx / test_idx index its view axis.
    Returns new parameters."""
    if mode == "ref":
        w = shading.cc_weight[reference_idx]
        b = shading.cc_bias[reference_idx]
    elif mode == "average":
        w = torch.mean(shading.cc_weight[train_idx], dim=0)
        b = torch.mean(shading.cc_bias[train_idx], dim=0)
    else:
        raise NotImplementedError(mode)
    cc_w = shading.cc_weight.detach().clone()
    cc_b = shading.cc_bias.detach().clone()
    cc_w[test_idx] = w.detach()
    cc_b[test_idx] = b.detach()
    return dataclasses.replace(shading, cc_weight=cc_w, cc_bias=cc_b)
