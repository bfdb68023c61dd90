"""Synthetic satellite scene pieces: heightfield and affine camera models.

The numpy builders of ``eogs2_tpu/data/synthetic.py`` that the serving path
needs: a textured heightfield (ground + rectangular buildings) over
[-1, 1]^2, the pushbroom-like affine camera, and its sun model in the
reference's to_affine.py schema. Writing whole scene directories with
rendered images arrives with training.
"""

from __future__ import annotations

import numpy as np


def _heightfield(res: int, n_buildings: int, rng, alt_range=(-0.35, 0.35)):
    """[res,res] heightfield over [-1,1]^2, plus the texture [res,res,3]."""
    z = np.full((res, res), alt_range[0], np.float32)
    tex = 0.25 + 0.5 * rng.rand(res, res, 3).astype(np.float32) * 0.15
    # large-scale texture variation
    gx, gy = np.meshgrid(np.linspace(0, 6.28, res), np.linspace(0, 6.28, res))
    tex[..., 0] += 0.15 * np.sin(gx) * np.cos(2 * gy)
    tex[..., 1] += 0.15 * np.cos(2 * gx) * np.sin(gy)
    tex[..., 2] += 0.1 * np.sin(gx + gy)
    for _ in range(n_buildings):
        w = rng.randint(res // 16, res // 5)
        h = rng.randint(res // 16, res // 5)
        x0 = rng.randint(0, res - w)
        y0 = rng.randint(0, res - h)
        hgt = rng.uniform(0.15, 1.0) * (alt_range[1] - alt_range[0]) + alt_range[0]
        z[y0 : y0 + h, x0 : x0 + w] = np.maximum(z[y0 : y0 + h, x0 : x0 + w], hgt)
        col = 0.3 + 0.6 * rng.rand(3)
        tex[y0 : y0 + h, x0 : x0 + w] = col
    return z, np.clip(tex, 0.0, 1.0)


def make_affine(view_shear, width, height, alt_range):
    """Pushbroom-like affine: u = x - shear_x * z, v = y - shear_y * z,
    altitude passthrough ([3,4] float64)."""
    sx, sy = view_shear
    return np.array(
        [[1.0, 0.0, -sx, 0.0], [0.0, 1.0, -sy, 0.0], [0.0, 0.0, 1.0, 0.0]],
        np.float64,
    )


def sun_model_from_affine(A3x4, sun_dir):
    """to_affine.py:79-115: normalize sun_dir so (A @ s).z == 1; shear the
    camera affine so the sun direction maps to the w axis.
    Returns (sun_A [3,3], sun_b [3], s [3], camera_to_sun [3,3])."""
    A = np.asarray(A3x4)[:, :3]
    b = np.asarray(A3x4)[:, 3]
    s = np.asarray(sun_dir, np.float64)
    s = s / (A @ s)[2]
    As = A @ s
    myM = np.array([[1, 0, -As[0]], [0, 1, -As[1]], [0, 0, 1]], np.float64)
    sun_A = myM @ A
    sun_b = b - sun_A @ np.zeros(3) + A @ np.zeros(3)  # center-of-scene = 0
    return sun_A, sun_b, s, myM
