"""Per-Gaussian preprocessing for the affine (pushbroom) camera.

Counterpart of ``eogs2_tpu/ops/projection.py``; parity target
``preprocessCUDA`` (forward.cu:155-283) and ``computeCov2D`` (:74-112):

  * projection is the plain affine map uva = A @ [xyz, 1] (no perspective
    divide); u, v are NDC, the third output is the normalized altitude;
  * cov2d = J Sigma J^T with the constant Jacobian J = diag(W/2, H/2) A[:2,:3],
    then +0.3 px dilation and the optional antialiasing opacity rescale;
  * radius = ceil(3 sqrt(lambda_max)); getRect truncates toward zero, then
    clamps to the grid (``Tensor.to(torch.int32)`` truncates like C's int());
  * the composite order is altitude-descending: depth = -altitude, which
    takes both signs (ops/fused_raster.py keys the sort order-preservingly).

Plain tensor code; autograd supplies the gradients (incl. dL/d(affine)).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from eogs2_tpu_torch.observability import host_read

TILE = 16  # BLOCK_X = BLOCK_Y = 16 (cuda_rasterizer/config.h:16-17)


class Preprocessed(NamedTuple):
    """Per-Gaussian screen-space quantities (all [N] or [N, k])."""

    mean2d: torch.Tensor  # [N,2] pixel coordinates of the projected center
    depth: torch.Tensor  # [N] sort key = -altitude (ascending == top first)
    conic: torch.Tensor  # [N,3] inverse 2D covariance (a, b, c)
    opacity: torch.Tensor  # [N] opacity (after optional antialias rescale)
    radius: torch.Tensor  # [N] int32 screen-space radius, 0 == culled
    rect_min: torch.Tensor  # [N,2] int32 tile rect (x,y) inclusive
    rect_size: torch.Tensor  # [N,2] int32 tile rect extent (w,h)
    tiles_touched: torch.Tensor  # [N] int32 number of tiles overlapped


def ndc_to_pixel(ndc, size):
    """((v + 1) * S - 1) / 2 — reference ndc2Pix (auxiliary.h:40-43)."""
    return ((ndc + 1.0) * size - 1.0) * 0.5


def project_points(means3d, affine):
    """uva = A @ [x,y,z,1]. affine: [3,4] row-major (math orientation)."""
    return means3d @ affine[:, :3].T + affine[:, 3]


def compute_cov2d_direct(scales, quats, affine, width, height,
                         scale_modifier: float = 1.0):
    """(scale, raw quat) -> (cxx, cxy, cyy) without [N,3,3] intermediates.

    Same math as build_cov3d + compute_cov2d: cov2d = (J R) diag(s^2) (J R)^T
    with the unnormalized-quaternion rotation, written as [N] columns."""
    px = host_read(lambda: torch.tensor([0.5 * width, 0.5 * height],
                                        dtype=scales.dtype,
                                        device=scales.device),
                   "projection.px")
    J = px[:, None] * affine[:2, :3]  # [2,3] constant Jacobian
    r, x, y, z = quats[:, 0], quats[:, 1], quats[:, 2], quats[:, 3]
    R00 = 1.0 - 2.0 * (y * y + z * z)
    R01 = 2.0 * (x * y - r * z)
    R02 = 2.0 * (x * z + r * y)
    R10 = 2.0 * (x * y + r * z)
    R11 = 1.0 - 2.0 * (x * x + z * z)
    R12 = 2.0 * (y * z - r * x)
    R20 = 2.0 * (x * z - r * y)
    R21 = 2.0 * (y * z + r * x)
    R22 = 1.0 - 2.0 * (x * x + y * y)
    # A = J @ R: rows a (screen x) and b (screen y)
    a0 = J[0, 0] * R00 + J[0, 1] * R10 + J[0, 2] * R20
    a1 = J[0, 0] * R01 + J[0, 1] * R11 + J[0, 2] * R21
    a2 = J[0, 0] * R02 + J[0, 1] * R12 + J[0, 2] * R22
    b0 = J[1, 0] * R00 + J[1, 1] * R10 + J[1, 2] * R20
    b1 = J[1, 0] * R01 + J[1, 1] * R11 + J[1, 2] * R21
    b2 = J[1, 0] * R02 + J[1, 1] * R12 + J[1, 2] * R22
    s0 = scale_modifier * scales[:, 0]
    s1 = scale_modifier * scales[:, 1]
    s2 = scale_modifier * scales[:, 2]
    s0, s1, s2 = s0 * s0, s1 * s1, s2 * s2
    cxx = a0 * a0 * s0 + a1 * a1 * s1 + a2 * a2 * s2
    cxy = a0 * b0 * s0 + a1 * b1 * s1 + a2 * b2 * s2
    cyy = b0 * b0 * s0 + b1 * b1 * s1 + b2 * b2 * s2
    return torch.stack([cxx, cxy, cyy], dim=-1)


def compute_cov2d(cov3d6, affine, width, height):
    """2D screen covariance before dilation, J Sigma J^T, as (cxx, cxy, cyy)."""
    from eogs2_tpu_torch.ops.gaussians import cov3d_to_matrix

    scale = torch.tensor([0.5 * width, 0.5 * height], dtype=cov3d6.dtype,
                         device=cov3d6.device)
    J = scale[:, None] * affine[:2, :3]  # [2,3]
    cov = torch.einsum("ij,...jk,lk->...il", J, cov3d_to_matrix(cov3d6), J)
    return torch.stack([cov[..., 0, 0], cov[..., 0, 1], cov[..., 1, 1]], dim=-1)


def preprocess_gaussians(
    means3d,
    cov3d6,
    opacities,
    affine,
    width: int,
    height: int,
    antialiasing: bool = False,
    alive=None,
    cov2d=None,
) -> Preprocessed:
    """FORWARD::preprocess for one camera, vectorized over Gaussians.

    cov3d6 is ignored when the [N,3] screen covariance ``cov2d`` is given
    (the compute_cov2d_direct path); ``alive`` culls dead slots."""
    uva = project_points(means3d, affine)  # [N,3]
    px = ndc_to_pixel(uva[:, 0], width)
    py = ndc_to_pixel(uva[:, 1], height)
    mean2d = torch.stack([px, py], dim=-1)
    depth = -uva[:, 2]  # altitude-descending composite order

    cov = cov2d if cov2d is not None else compute_cov2d(
        cov3d6, affine, width, height
    )
    h_var = 0.3
    det_cov = cov[:, 0] * cov[:, 2] - cov[:, 1] * cov[:, 1]
    cxx = cov[:, 0] + h_var
    cxy = cov[:, 1]
    cyy = cov[:, 2] + h_var
    det = cxx * cyy - cxy * cxy

    if antialiasing:
        h_conv_scaling = torch.sqrt(torch.clamp_min(det_cov / det, 0.000025))
    else:
        h_conv_scaling = 1.0

    valid_det = det > 0.0
    det_safe = torch.where(valid_det, det, 1.0)
    det_inv = 1.0 / det_safe
    conic = torch.stack([cyy * det_inv, -cxy * det_inv, cxx * det_inv], dim=-1)

    mid = 0.5 * (cxx + cyy)
    disc = torch.sqrt(torch.clamp_min(mid * mid - det_safe, 0.1))
    lambda_max = mid + disc
    radius_f = torch.ceil(3.0 * torch.sqrt(torch.clamp_min(lambda_max, 0.0)))

    grid_x = (width + TILE - 1) // TILE
    grid_y = (height + TILE - 1) // TILE

    def rect(v):  # getRect (auxiliary.h:45-55): truncate, then clamp
        return v.to(torch.int32)

    rmin_x = rect((px - radius_f) / TILE).clamp(0, grid_x)
    rmin_y = rect((py - radius_f) / TILE).clamp(0, grid_y)
    rmax_x = rect((px + radius_f + TILE - 1) / TILE).clamp(0, grid_x)
    rmax_y = rect((py + radius_f + TILE - 1) / TILE).clamp(0, grid_y)
    rect_w = rmax_x - rmin_x
    rect_h = rmax_y - rmin_y

    visible = valid_det & (rect_w > 0) & (rect_h > 0)
    if alive is not None:
        visible = visible & alive
    radius = torch.where(visible, radius_f, 0.0).to(torch.int32)
    rect_w = torch.where(visible, rect_w, 0)
    rect_h = torch.where(visible, rect_h, 0)

    return Preprocessed(
        mean2d=mean2d,
        depth=depth,
        conic=conic,
        opacity=opacities * h_conv_scaling,
        radius=radius,
        rect_min=torch.stack([rmin_x, rmin_y], dim=-1),
        rect_size=torch.stack([rect_w, rect_h], dim=-1),
        tiles_touched=rect_w * rect_h,
    )
