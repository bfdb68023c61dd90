"""3D covariance from (scale, quaternion) — computeCov3D (forward.cu:117-151).

Sigma = R S^2 R^T from an UNNORMALIZED quaternion: the reference feeds raw
quaternions to the kernel and skips normalization (forward.cu:126), so
``quat_to_rotmat`` normalizes only when asked.
"""

from __future__ import annotations

import torch


def quat_to_rotmat(q, normalize: bool = False):
    """Quaternion (w, x, y, z) -> [..., 3, 3] rotation matrix."""
    if normalize:
        q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    r, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    row0 = torch.stack(
        [1.0 - 2.0 * (y * y + z * z), 2.0 * (x * y - r * z), 2.0 * (x * z + r * y)],
        dim=-1,
    )
    row1 = torch.stack(
        [2.0 * (x * y + r * z), 1.0 - 2.0 * (x * x + z * z), 2.0 * (y * z - r * x)],
        dim=-1,
    )
    row2 = torch.stack(
        [2.0 * (x * z - r * y), 2.0 * (y * z + r * x), 1.0 - 2.0 * (x * x + y * y)],
        dim=-1,
    )
    return torch.stack([row0, row1, row2], dim=-2)


def build_cov3d(scales, quats, scale_modifier: float = 1.0):
    """Sigma = R diag(s^2) R^T packed as (xx, xy, xz, yy, yz, zz), the
    reference cov3D buffer layout. quats are raw (not normalized)."""
    R = quat_to_rotmat(quats, normalize=False)
    s = scale_modifier * scales
    sigma = torch.einsum("...ij,...j,...kj->...ik", R, s * s, R)
    return torch.stack(
        [sigma[..., 0, 0], sigma[..., 0, 1], sigma[..., 0, 2],
         sigma[..., 1, 1], sigma[..., 1, 2], sigma[..., 2, 2]],
        dim=-1,
    )


def cov3d_to_matrix(cov6):
    """Unpack the 6-vector into the symmetric [..., 3, 3] matrix."""
    xx, xy, xz, yy, yz, zz = (cov6[..., i] for i in range(6))
    return torch.stack(
        [torch.stack([xx, xy, xz], -1), torch.stack([xy, yy, yz], -1),
         torch.stack([xz, yz, zz], -1)],
        dim=-2,
    )
