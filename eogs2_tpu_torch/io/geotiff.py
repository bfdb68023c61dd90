"""Minimal GeoTIFF IO without rasterio (counterpart of
``eogs2_tpu/io/geotiff.py``).

Reads rasters via Pillow (any TIFF compression Pillow supports) and extracts
the georeferencing from the raw TIFF tags (ModelPixelScaleTag 33550,
ModelTiepointTag 33922). Writes uncompressed float32 GeoTIFFs with those
tags. Pillow is imported only by ``read_geotiff`` and ``write_geotiff``: the
DSM and MAE path needs only the ``Affine`` transform, and runs without it.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

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
    """Returns (array [H,W] or [H,W,C], profile with 'transform' when
    geo tags exist)."""
    from PIL import Image

    Image.MAX_IMAGE_PIXELS = None
    with Image.open(path) as im:
        frames = []
        try:
            i = 0
            while True:
                im.seek(i)
                frames.append(np.asarray(im))
                i += 1
        except EOFError:
            pass
        arr = frames[0] if len(frames) == 1 else np.stack(frames, axis=-1)
        tags = getattr(im, "tag_v2", None)
        transform = None
        if tags is not None and MODEL_PIXEL_SCALE in tags and MODEL_TIEPOINT in tags:
            sx, sy = tags[MODEL_PIXEL_SCALE][:2]
            tp = tags[MODEL_TIEPOINT]
            # tiepoint: (i, j, k, x, y, z) raster->model
            i0, j0, _, x0, y0, _ = tp[:6]
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
    """Write a single-band float32 (or uint8/16) TIFF with geo tags."""
    from PIL import Image, TiffImagePlugin

    arr = np.asarray(arr)
    if arr.ndim == 3 and arr.shape[2] == 1:
        arr = arr[:, :, 0]
    im = Image.fromarray(arr)
    info = TiffImagePlugin.ImageFileDirectory_v2()
    if transform is not None:
        info[MODEL_PIXEL_SCALE] = (
            float(transform.a),
            float(-transform.e),
            0.0,
        )
        info[MODEL_TIEPOINT] = (
            0.0, 0.0, 0.0,
            float(transform.c), float(transform.f), 0.0,
        )
        info.tagtype[MODEL_PIXEL_SCALE] = 12  # DOUBLE
        info.tagtype[MODEL_TIEPOINT] = 12
    im.save(path, tiffinfo=info)
