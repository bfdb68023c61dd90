"""Fixed-capacity Gaussian model as an nn.Module.

Counterpart of ``eogs2_tpu/model.py``; parity target the reference's
``scene/gaussian_model.py``. The raw (pre-activation) parameters are
``nn.Parameter``s and the per-Gaussian bookkeeping is registered as buffers,
with the same capacity-padded layout and ``alive`` mask as the JAX model, so
weights carry across with :meth:`GaussianModel.from_numpy` /
:meth:`GaussianModel.to_numpy`.

Activations (gaussian_model.py:34-53): scaling = exp, opacity = sigmoid,
rotation handed to the rasterizer raw (the reference kernel skips the
quaternion normalization, forward.cu:126).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from eogs2_tpu_torch.device import resolve_device
from eogs2_tpu_torch.ops.sh import RGB2SH, SH2RGB


class GaussianParams(NamedTuple):
    """Raw optimizable parameters, capacity-padded."""

    xyz: torch.Tensor  # [Nmax,3]
    features_dc: torch.Tensor  # [Nmax,1,3] SH DC coefficients
    features_rest: torch.Tensor  # [Nmax,R,3] higher SH bands (R may be 0)
    scaling: torch.Tensor  # [Nmax,3] log-scales
    rotation: torch.Tensor  # [Nmax,4] raw quaternions
    opacity: torch.Tensor  # [Nmax,1] logit-opacities


class GaussianAux(NamedTuple):
    """Non-optimized per-Gaussian state."""

    alive: torch.Tensor  # [Nmax] bool
    max_radii2d: torch.Tensor  # [Nmax] float
    xyz_gradient_accum: torch.Tensor  # [Nmax] float
    denom: torch.Tensor  # [Nmax] float


class GaussianModel(nn.Module):
    def __init__(self, params: GaussianParams, aux: GaussianAux,
                 sh_degree: int = 0):
        super().__init__()
        for name, value in params._asdict().items():
            setattr(self, name, nn.Parameter(value))
        for name, value in aux._asdict().items():
            self.register_buffer(name, value)
        self.sh_degree = sh_degree

    @property
    def params(self) -> GaussianParams:
        return GaussianParams(*(getattr(self, f) for f in GaussianParams._fields))

    @property
    def aux(self) -> GaussianAux:
        return GaussianAux(*(getattr(self, f) for f in GaussianAux._fields))

    # ---- activated views --------------------------------------------------

    @property
    def num_alive(self):
        return self.alive.sum()

    def get_scaling(self):
        return torch.exp(self.scaling)

    def get_opacity(self):
        return torch.sigmoid(self.opacity[:, 0])

    def get_rotation_raw(self):
        return self.rotation

    def get_rgb(self):
        return SH2RGB(self.features_dc[:, 0, :])

    def capacity(self) -> int:
        return self.xyz.shape[0]

    # ---- weights across packages ------------------------------------------

    @classmethod
    def from_numpy(cls, params: dict, aux: dict, sh_degree: int = 0,
                   device=None) -> "GaussianModel":
        """Build from the GaussianParams/GaussianAux fields as numpy arrays
        (e.g. ``np.asarray`` of each field of a JAX model). The arrays are
        copied: the model never aliases the caller's memory."""
        dev = resolve_device(device)
        p = GaussianParams(*(
            torch.tensor(np.asarray(params[f], np.float32), device=dev)
            for f in GaussianParams._fields
        ))
        a = GaussianAux(
            alive=torch.tensor(np.asarray(aux["alive"], bool), device=dev),
            **{f: torch.tensor(np.asarray(aux[f], np.float32), device=dev)
               for f in GaussianAux._fields[1:]},
        )
        return cls(p, a, sh_degree)

    def to_numpy(self):
        """(params dict, aux dict) of numpy copies; inverse of from_numpy."""
        def np_(x):
            return x.detach().cpu().numpy().copy()

        return ({f: np_(getattr(self, f)) for f in GaussianParams._fields},
                {f: np_(getattr(self, f)) for f in GaussianAux._fields})


def init_from_points(
    xyz: np.ndarray,
    rgb: np.ndarray,
    capacity: int,
    sh_degree: int = 0,
    opacity_init_value: float = 0.01,
    mean_knn_dist2=None,
    device=None,
) -> GaussianModel:
    """create_from_pcd parity (gaussian_model.py:159-221).

    Scale init = log(sqrt(clamp(mean 3-NN squared distance, 1e-7))),
    isotropic; rotation = identity; opacity = logit(opacity_init_value);
    slots [N:] start dead. mean_knn_dist2 ([N]) is computed on ``device``
    by ops/knn.py when None."""
    n = xyz.shape[0]
    if capacity < n:
        raise ValueError(f"capacity {capacity} is below the {n} points")
    if mean_knn_dist2 is None:
        from eogs2_tpu_torch.ops.knn import mean_knn_dist2 as knn

        pts = torch.tensor(np.asarray(xyz, np.float32),
                           device=resolve_device(device))
        mean_knn_dist2 = knn(pts).cpu().numpy()
    dist2 = np.maximum(np.asarray(mean_knn_dist2), 1e-7)
    scales = np.log(np.sqrt(dist2))[:, None].repeat(3, axis=1)

    def pad(x, fill=0.0):
        out = np.full((capacity,) + x.shape[1:], fill, dtype=np.float32)
        out[:n] = x
        return out

    rots = pad(np.zeros((n, 4), np.float32))
    rots[:, 0] = 1.0
    v = float(opacity_init_value)
    opac = np.full((n, 1), np.log(v / (1.0 - v)), np.float32)
    n_rest = (sh_degree + 1) ** 2 - 1
    alive = np.zeros((capacity,), bool)
    alive[:n] = True
    zeros = np.zeros((capacity,), np.float32)
    return GaussianModel.from_numpy(
        dict(
            xyz=pad(xyz.astype(np.float32)),
            features_dc=pad(np.asarray(RGB2SH(rgb))[:, None, :].astype(np.float32)),
            features_rest=np.zeros((capacity, n_rest, 3), np.float32),
            scaling=pad(scales.astype(np.float32), fill=-10.0),
            rotation=rots,
            opacity=pad(opac, fill=-10.0),
        ),
        dict(alive=alive, max_radii2d=zeros, xyz_gradient_accum=zeros,
             denom=zeros),
        sh_degree=sh_degree,
        device=device,
    )


def inverse_sigmoid(x):
    return torch.log(x / (1.0 - x))


@torch.no_grad()
def reset_opacity(model: GaussianModel) -> None:
    """opacity <- min(opacity, 0.01) on the alive Gaussians, in place
    (gaussian_model.py:347-352). The caller also zeroes the opacity Adam
    moments (densify.reset_opacity_with_moments)."""
    new_raw = inverse_sigmoid(torch.clamp_max(model.get_opacity(), 0.01))
    model.opacity.copy_(torch.where(model.alive[:, None], new_raw[:, None],
                                    model.opacity))


@torch.no_grad()
def add_densification_stats(model: GaussianModel, grad_ndc, radii) -> None:
    """Accumulate ||dL/dmean2d_ndc||_2 of the visible Gaussians
    (gaussian_model.py:719-723) and track the largest screen radius
    (train_pan.py:683-686). Updates the model's buffers in place."""
    visible = radii > 0
    norm = torch.linalg.vector_norm(grad_ndc[:, :2], dim=-1)
    model.xyz_gradient_accum += torch.where(visible, norm, 0.0)
    model.denom += visible.to(model.denom.dtype)
    torch.maximum(model.max_radii2d,
                  torch.where(visible, radii.to(model.max_radii2d.dtype), 0.0),
                  out=model.max_radii2d)
