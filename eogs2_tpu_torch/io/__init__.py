"""File formats: TIFF and GeoTIFF, PNG, PLY.

The port decodes the files the system writes itself (``tiff.py``,
``png.py``); :func:`read_with_library` reads any other image through
Pillow or imageio, which are imported only then.
"""

from __future__ import annotations

import os

import numpy as np


class Unsupported(Exception):
    """A file outside what the port's own codecs decode; the text says
    what it holds."""


def read_with_library(path: str, what: str) -> np.ndarray:
    """What Pillow (every page stacked on the last axis) or, where Pillow
    cannot decode the file, imageio reads from path. ``what`` says what the
    file holds; ImportError names it when neither library can read it."""
    try:
        from PIL import Image
    except ImportError:
        Image = None
    if Image is not None:
        Image.MAX_IMAGE_PIXELS = None
        try:
            with Image.open(path) as im:
                frames = []
                try:
                    while True:
                        im.seek(len(frames))
                        frames.append(np.asarray(im))
                except EOFError:
                    pass
            return frames[0] if len(frames) == 1 else np.stack(frames, -1)
        except OSError:  # a file Pillow cannot decode: try imageio
            pass
    try:
        import imageio.v2 as iio
    except ImportError:
        raise ImportError(
            f"{path} is {what}; reading it needs Pillow or imageio, and "
            f"neither can read it here") from None
    return np.asarray(iio.imread(path))


def read_image(path: str) -> np.ndarray:
    """Pixels of the image at path: a TIFF through ``io/tiff.py``, a PNG
    through ``io/png.py``, any other format through
    :func:`read_with_library`."""
    ext = os.path.splitext(path)[1].lower()
    if ext in (".tif", ".tiff"):
        from eogs2_tpu_torch.io.tiff import read_tiff

        return read_tiff(path)[0]
    if ext == ".png":
        from eogs2_tpu_torch.io.png import read_png

        return read_png(path)
    return read_with_library(path, f"a {ext or 'extension-less'} image")
