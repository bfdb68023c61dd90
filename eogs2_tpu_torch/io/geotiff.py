"""Minimal GeoTIFF IO without rasterio (counterpart of
``eogs2_tpu/io/geotiff.py``).

Reads rasters through ``io/tiff.py`` (which hands the TIFFs it does not
decode itself to Pillow or imageio) and extracts the georeferencing from
the raw TIFF tags (ModelPixelScaleTag 33550, ModelTiepointTag 33922).
Writes uncompressed GeoTIFFs with those tags as DOUBLE arrays, as JAX's
Pillow writer does. Neither needs Pillow for the files the system writes.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from eogs2_tpu_torch.io.tiff import read_tiff, write_tiff

MODEL_PIXEL_SCALE = 33550
MODEL_TIEPOINT = 33922


class Affine:
    """Row-major 2D affine (a, b, c, d, e, f): x = a*col + b*row + c."""

    def __init__(self, a, b, c, d, e, f):
        self.a, self.b, self.c, self.d, self.e, self.f = a, b, c, d, e, f

    @classmethod
    def from_origin(cls, xoff, yoff, xres, yres):
        return cls(xres, 0.0, xoff, 0.0, -yres, yoff)

    def __mul__(self, colrow):
        col, row = colrow
        return (
            self.a * col + self.b * row + self.c,
            self.d * col + self.e * row + self.f,
        )

    def inv(self, xy):
        x, y = xy
        det = self.a * self.e - self.b * self.d
        x -= self.c
        y -= self.f
        return (
            (self.e * x - self.b * y) / det,
            (-self.d * x + self.a * y) / det,
        )

    def __repr__(self):
        return f"Affine({self.a}, {self.b}, {self.c}, {self.d}, {self.e}, {self.f})"


def read_geotiff(path: str) -> Tuple[np.ndarray, Dict]:
    """Returns (array [H,W] or [H,W,C] of the first image, profile with
    'transform' when geo tags exist)."""
    arr, tags = read_tiff(path)
    transform = None
    if MODEL_PIXEL_SCALE in tags and MODEL_TIEPOINT in tags:
        sx, sy = tags[MODEL_PIXEL_SCALE][:2]
        # tiepoint: (i, j, k, x, y, z) raster->model
        i0, j0, _, x0, y0, _ = tags[MODEL_TIEPOINT][:6]
        transform = Affine(sx, 0.0, x0 - i0 * sx, 0.0, -sy, y0 + j0 * sy)
    profile = {
        "height": arr.shape[0],
        "width": arr.shape[1],
        "dtype": arr.dtype,
        "transform": transform,
    }
    return arr, profile


def write_geotiff(path: str, arr: np.ndarray, transform: Optional[Affine] = None,
                  crs: Optional[str] = None):
    """Write a single-band float32 (or uint8/16) TIFF with geo tags; float64
    is stored as float32, as Pillow's writer does in JAX."""
    arr = np.asarray(arr)
    if arr.ndim == 3 and arr.shape[2] == 1:
        arr = arr[:, :, 0]
    if arr.dtype == np.float64:
        arr = arr.astype(np.float32)
    tags = {}
    if transform is not None:
        tags[MODEL_PIXEL_SCALE] = (12, (float(transform.a),
                                        float(-transform.e), 0.0))
        tags[MODEL_TIEPOINT] = (12, (0.0, 0.0, 0.0, float(transform.c),
                                     float(transform.f), 0.0))
    write_tiff(path, arr, tags)
