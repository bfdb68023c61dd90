"""Affine (RPC-approximated pushbroom) cameras with tensors on a device.

Counterpart of ``eogs2_tpu/cameras.py``; parity target the reference's
``scene/cameras/affine_cameras.py``. The camera is a [3,4] matrix in math
orientation, uva = A @ [xyz, 1], and every derivation returns a new
camera.

Conventions: u, v are NDC in [-1, 1] over the native image, the third row
gives the normalized altitude; pixel = ((ndc + 1) * size - 1) / 2.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from eogs2_tpu_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class AffineCamera:
    affine: torch.Tensor  # [3,4] world -> (u, v, altitude)
    sun_affine: torch.Tensor  # [3,4] sun-aligned affine (zeros if absent)
    camera_to_sun: torch.Tensor  # [3,3] UVA -> UVA map into the sun camera
    altitude_bounds: torch.Tensor  # [2] (min_alt, max_alt), normalized
    centerofscene: torch.Tensor  # [3] scene center in world coords
    width: int = 0
    height: int = 0
    has_sun: bool = True

    def replace(self, **changes) -> "AffineCamera":
        return dataclasses.replace(self, **changes)

    @property
    def device(self) -> torch.device:
        return self.affine.device

    # ---- projections ------------------------------------------------------

    def ecef_to_uva(self, xyz):
        """uva = A @ [xyz, 1] (reference ECEF_to_UVA, affine_cameras.py:432)."""
        return xyz @ self.affine[:, :3].T + self.affine[:, 3]

    def uva_to_ecef(self, uva):
        """Inverse map (float32; host-side eval redoes it in float64)."""
        ainv = torch.linalg.inv(self.affine[:, :3])
        return (uva - self.affine[:, 3]) @ ainv.T

    def uv_grid(self):
        """[H,W,2] NDC grid in [-1,1] (reference UV_grid, indexing='xy')."""
        kw = dict(dtype=self.affine.dtype, device=self.device)
        u = torch.linspace(-1.0, 1.0, self.width, **kw)
        v = torch.linspace(-1.0, 1.0, self.height, **kw)
        vv, uu = torch.meshgrid(v, u, indexing="ij")
        return torch.stack([uu, vv], dim=-1)

    # ---- derived cameras --------------------------------------------------

    def sun_camera(self, f: int = 2):
        """Sun-POV camera with an f-times footprint (affine_cameras.py:350-370):
        S @ A_sun with S = diag(1/f, 1/f, 1); returns (camera, cam2virt)."""
        s = torch.tensor([1.0 / f, 1.0 / f, 1.0], dtype=self.affine.dtype,
                         device=self.device)
        cam = self.replace(affine=self.sun_affine * s[:, None],
                           width=self.width * f, height=self.height * f)
        return cam, s[:, None] * self.camera_to_sun

    def nadir_camera(self):
        """Shear-removed (vertical) camera (affine_cameras.py:372-401)."""
        A = self.affine[:, :3]
        b = self.affine[:, 3]
        q = A[:, 2]  # A @ (0, 0, 1)
        q = q / q[2]
        M = torch.eye(3, dtype=A.dtype, device=A.device)
        M[:2, 2] = -q[:2]
        new_b = (torch.eye(3, dtype=A.dtype, device=A.device) - M) @ (
            A @ self.centerofscene) + b
        cam = self.replace(affine=torch.cat([M @ A, new_b[:, None]], dim=1))
        return cam, M

    def random_camera(self, shear_draw, extent: float):
        """Randomly UV-sheared virtual camera for the consistency loss
        (sample_random_camera, affine_cameras.py:403-430):
        M[:2, 2] += clip(shear_draw, -1, 1) * extent, where shear_draw is a
        standard-normal draw [2] the caller makes (JAX draws it from a key
        inside; here a test can feed JAX's draw). Returns (camera, M)."""
        A = self.affine[:, :3]
        b = self.affine[:, 3]
        shear = torch.clamp(shear_draw.to(A), -1.0, 1.0) * extent
        eye = torch.eye(3, dtype=A.dtype, device=A.device)
        M = eye.clone()
        M[:2, 2] = M[:2, 2] + shear
        new_b = (eye - M) @ (A @ self.centerofscene) + b
        cam = self.replace(affine=torch.cat([M @ A, new_b[:, None]], dim=1))
        return cam, M

    def resize_canvas(self, new_width: int, new_height: int) -> "AffineCamera":
        """Rescale the NDC frame so rendering at (new_w, new_h) reproduces the
        native pixel mapping on the overlap (pads to a common canvas)."""
        sx = self.width / new_width
        sy = self.height / new_height
        kw = dict(dtype=self.affine.dtype, device=self.device)
        row_scale = torch.tensor([sx, sy, 1.0], **kw)
        # pixel = ((u+1)*W - 1)/2 ; ((u'+1)*W' - 1)/2 == pixel
        # => u' = s*u + (s - 1),  s = W/W'
        inter_shift = torch.tensor([sx - 1.0, sy - 1.0, 0.0], **kw)
        new_affine = self.affine * row_scale[:, None]
        new_affine = torch.cat(
            [new_affine[:, :3], (new_affine[:, 3] + inter_shift)[:, None]], 1
        )
        return self.replace(affine=new_affine, width=new_width,
                            height=new_height)

    def apply_last_row(self, last_row) -> "AffineCamera":
        """Learnable pose residual (renderer.py:47-53): affine[:, 3] += r[:3]."""
        a = self.affine
        return self.replace(
            affine=torch.cat([a[:, :3], (a[:, 3] + last_row[:3])[:, None]], 1)
        )


def camera_from_reference_convention(coef, inter, sun_coef=None, sun_inter=None,
                                     camera_to_sun=None,
                                     altitude_bounds=(0.0, 1.0),
                                     centerofscene=(0.0, 0.0, 0.0),
                                     width=0, height=0, device=None):
    """Build from affine_models.json fields (coef_ [3,3], intercept_ [3])."""
    dev = resolve_device(device)
    affine = np.concatenate([np.asarray(coef), np.asarray(inter)[:, None]], 1)
    has_sun = sun_coef is not None
    if has_sun:
        sun_affine = np.concatenate(
            [np.asarray(sun_coef), np.asarray(sun_inter)[:, None]], axis=1
        )
        cam2sun = np.asarray(camera_to_sun)
    else:
        sun_affine = np.zeros((3, 4))
        cam2sun = np.eye(3)

    def t(x):
        return torch.tensor(np.asarray(x, np.float32), device=dev)

    return AffineCamera(
        affine=t(affine),
        sun_affine=t(sun_affine),
        camera_to_sun=t(cam2sun),
        altitude_bounds=t(altitude_bounds),
        centerofscene=t(centerofscene),
        width=int(width),
        height=int(height),
        has_sun=has_sun,
    )
