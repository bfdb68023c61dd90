"""Fly-around video rendering.

Counterpart of ``eogs2_tpu/video.py``; parity target ``render_video.py`` +
``to_affine_video.py``: render an interpolated virtual-camera trajectory
(orbiting UV shear around the nadir camera). The frames are written as a
PNG sequence (``io/png.py``), which is what JAX's ``render_video`` writes
where cv2 is not installed; the port has no mp4 encoder.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from eogs2_tpu_torch.io.png import write_png
from eogs2_tpu_torch.pipeline import render_view_full


def orbit_cameras(base_camera, n_frames: int = 60, max_shear: float = 0.25):
    """Cameras whose view direction orbits the vertical: shear magnitude
    `max_shear` rotating through 2*pi (the reference's nadir_pov video)."""
    cams = []
    nadir, _ = base_camera.nadir_camera()
    A = nadir.affine[:, :3].detach().cpu().numpy().astype(np.float64)
    b = nadir.affine[:, 3].detach().cpu().numpy().astype(np.float64)
    center = base_camera.centerofscene.detach().cpu().numpy().astype(np.float64)
    for i in range(n_frames):
        ang = 2 * np.pi * i / n_frames
        m = np.eye(3)
        m[0, 2] = max_shear * np.cos(ang)
        m[1, 2] = max_shear * np.sin(ang)
        new_a = m @ A
        new_b = (np.eye(3) - m) @ (A @ center) + b
        affine = np.concatenate([new_a, new_b[:, None]], axis=1)
        cams.append(nadir.replace(affine=torch.tensor(
            affine.astype(np.float32), device=nadir.device)))
    return cams


def render_video(
    model,
    base_camera,
    raster_cfg,
    out_path: str,
    n_frames: int = 60,
    fps: int = 15,
    max_shear: float = 0.25,
    shading=None,
    view_idx: int = 0,
):
    """Render the orbit; writes ``<out_path without extension>_frames/
    frame_NNNN.png`` and returns that directory (``fps`` is an encoder's
    setting, kept for JAX's signature)."""
    seq_dir = os.path.splitext(out_path)[0] + "_frames"
    os.makedirs(seq_dir, exist_ok=True)
    for i, cam in enumerate(orbit_cameras(base_camera, n_frames, max_shear)):
        out = render_view_full(model, cam, raster_cfg, shading=shading,
                               view_idx=view_idx, with_sun=cam.has_sun)
        img = np.clip(out["final"], 0, 1)
        if img.shape[0] == 1:
            img = np.repeat(img, 3, axis=0)
        write_png(os.path.join(seq_dir, f"frame_{i:04d}.png"),
                  (img.transpose(1, 2, 0) * 255).astype(np.uint8))
    return seq_dir
