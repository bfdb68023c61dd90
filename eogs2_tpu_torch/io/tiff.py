"""TIFF reader and writer in numpy, struct and zlib.

The JAX package reads and writes its images through imageio and Pillow; a
machine with neither (the card's) must still read a scene and write the
render stage's artifacts, so the port carries its own TIFF codec for the
files the system makes and the ones it is given most often.

Reads little-endian classic TIFFs (the first image of the file) with
chunky samples (PlanarConfiguration 1), any number of samples per pixel of
uint8, uint16 or float32, in strips or tiles, uncompressed (1) or Deflate
(8, 32946), with Predictor 1 or, for integers, 2 (horizontal differencing).
That covers what imageio's bundled tifffile writes (the synthetic scene's
float32 views) and what Pillow writes (JAX's GeoTIFFs). Any other file
(LZW or JPEG compression, BigTIFF, big-endian, planar or signed samples) is
handed to Pillow or imageio, imported only then; without either,
:func:`read_tiff` raises ImportError naming the file and what it holds.

Writes uncompressed chunky strips, with extra tags (e.g. the GeoTIFF
ModelPixelScale 33550 and ModelTiepoint 33922 as DOUBLE arrays).
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, Optional, Tuple

import numpy as np

from eogs2_tpu_torch.io import Unsupported, read_with_library

# tag numbers
WIDTH, HEIGHT, BITS, COMPRESSION, PHOTOMETRIC = 256, 257, 258, 259, 262
STRIP_OFFSETS, SAMPLES, ROWS_PER_STRIP, STRIP_COUNTS = 273, 277, 278, 279
PLANAR, PREDICTOR, EXTRA_SAMPLES, SAMPLE_FORMAT = 284, 317, 338, 339
TILE_WIDTH, TILE_LENGTH, TILE_OFFSETS, TILE_COUNTS = 322, 323, 324, 325

# field type -> (struct code, size); 2 (ASCII) and 7 (UNDEFINED) are bytes
_TYPES = {1: ("B", 1), 2: ("s", 1), 3: ("H", 2), 4: ("I", 4), 5: ("II", 8),
          6: ("b", 1), 7: ("s", 1), 8: ("h", 2), 9: ("i", 4), 10: ("ii", 8),
          11: ("f", 4), 12: ("d", 8)}
# (bits per sample, SampleFormat) -> numpy dtype
_DTYPES = {(8, 1): np.dtype("u1"), (16, 1): np.dtype("<u2"),
           (32, 3): np.dtype("<f4")}
_DEFLATE = (8, 32946)


def _read_ifd(data: bytes, offset: int) -> Dict[int, tuple]:
    """The tags of the IFD at offset: tag -> tuple of values (bytes for
    ASCII and UNDEFINED)."""
    (n,) = struct.unpack_from("<H", data, offset)
    tags = {}
    for i in range(n):
        tag, typ, count, raw = struct.unpack_from("<HHI4s", data,
                                                  offset + 2 + 12 * i)
        if typ not in _TYPES:
            continue  # a type no baseline tag uses
        code, size = _TYPES[typ]
        nbytes = size * count
        if nbytes <= 4:
            buf = raw[:nbytes]
        else:
            (ptr,) = struct.unpack("<I", raw)
            buf = data[ptr:ptr + nbytes]
        if code == "s":
            tags[tag] = bytes(buf)
        else:
            tags[tag] = struct.unpack(f"<{count * len(code)}{code[0]}", buf)
    return tags


def _read_tags(data: bytes) -> Dict[int, tuple]:
    """The first image's tags of a little-endian classic TIFF's bytes."""
    if data[:4] != b"II*\x00":
        kind = {b"MM\x00*": "a big-endian TIFF", b"II+\x00": "a BigTIFF",
                b"MM\x00+": "a big-endian BigTIFF"}.get(data[:4])
        raise Unsupported(kind or "not a TIFF")
    (offset,) = struct.unpack_from("<I", data, 4)
    return _read_ifd(data, offset)


def _one(tags, tag, default=None):
    v = tags.get(tag)
    if v is None:
        if default is None:
            raise Unsupported(f"TIFF tag {tag} missing")
        return default
    return v[0]


def _decode(data: bytes, tags) -> np.ndarray:
    """The first image's pixels, [H, W] or [H, W, samples]."""
    w, h = _one(tags, WIDTH), _one(tags, HEIGHT)
    spp = _one(tags, SAMPLES, 1)
    bits = set(tags.get(BITS, (1,)))
    fmts = set(tags.get(SAMPLE_FORMAT, (1,)))
    comp = _one(tags, COMPRESSION, 1)
    pred = _one(tags, PREDICTOR, 1)
    if _one(tags, PLANAR, 1) != 1:
        raise Unsupported("planar (PlanarConfiguration 2) samples")
    if len(bits) != 1 or len(fmts) != 1 or \
            (min(bits), min(fmts)) not in _DTYPES:
        raise Unsupported(f"{sorted(bits)}-bit samples of SampleFormat "
                          f"{sorted(fmts)}")
    dtype = _DTYPES[(min(bits), min(fmts))]
    if comp not in (1, *_DEFLATE):
        raise Unsupported(f"compression {comp}")
    if pred not in (1, 2) or (pred == 2 and dtype.kind == "f"):
        raise Unsupported(f"predictor {pred} on {dtype} samples")

    def chunk(i, offsets, counts, rows, cols):
        buf = data[offsets[i]:offsets[i] + counts[i]]
        if comp != 1:
            buf = zlib.decompress(buf)
        n = rows * cols * spp
        a = np.frombuffer(buf, dtype, count=n).reshape(rows, cols, spp)
        if pred == 2:  # undo horizontal differencing, wrapping as stored
            a = np.cumsum(a, axis=1, dtype=dtype)
        return a

    out = np.empty((h, w, spp), dtype)
    if TILE_OFFSETS in tags:
        tw, tl = _one(tags, TILE_WIDTH), _one(tags, TILE_LENGTH)
        offsets, counts = tags[TILE_OFFSETS], tags[TILE_COUNTS]
        across = -(-w // tw)
        for i in range(len(offsets)):
            r0, c0 = (i // across) * tl, (i % across) * tw
            a = chunk(i, offsets, counts, tl, tw)
            out[r0:r0 + tl, c0:c0 + tw] = a[:h - r0, :w - c0]
    else:
        rps = min(_one(tags, ROWS_PER_STRIP, h), h)
        offsets, counts = tags[STRIP_OFFSETS], tags[STRIP_COUNTS]
        for i in range(len(offsets)):
            r0 = i * rps
            rows = min(rps, h - r0)
            out[r0:r0 + rows] = chunk(i, offsets, counts, rows, w)
    return out[..., 0] if spp == 1 else out


def read_tiff(path: str) -> Tuple[np.ndarray, Dict[int, tuple]]:
    """(pixels of the first image, [H, W] or [H, W, samples]; its tags,
    tag -> tuple of values, {} when the header could not be parsed)."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        tags = _read_tags(data)
    except Unsupported as e:
        return read_with_library(path, str(e)), {}
    try:
        return _decode(data, tags), tags
    except Unsupported as e:
        return read_with_library(path, f"a TIFF with {e}"), tags


def write_tiff(path: str, arr: np.ndarray,
               extra_tags: Optional[Dict[int, Tuple[int, tuple]]] = None):
    """Write arr ([H, W] or [H, W, samples] of uint8, uint16 or float32) as
    one uncompressed chunky strip. extra_tags: tag -> (numeric field type,
    values), e.g. {33550: (12, (sx, sy, 0.0))}."""
    arr = np.asarray(arr)
    kinds = {np.dtype("u1"): (8, 1), np.dtype("<u2"): (16, 1),
             np.dtype("<f4"): (32, 3)}
    dt = arr.dtype.newbyteorder("<") if arr.dtype.itemsize > 1 else arr.dtype
    if dt not in kinds or arr.ndim not in (2, 3):
        raise ValueError(f"write_tiff: {arr.dtype} array of shape "
                         f"{arr.shape}; want [H, W(, C)] uint8, uint16 or "
                         f"float32")
    h, w = arr.shape[:2]
    spp = 1 if arr.ndim == 2 else arr.shape[2]
    bits, fmt = kinds[dt]
    pixels = np.ascontiguousarray(arr, dt).tobytes()
    tags = {
        WIDTH: (4, (w,)), HEIGHT: (4, (h,)), BITS: (3, (bits,) * spp),
        COMPRESSION: (3, (1,)), PHOTOMETRIC: (3, (2 if spp == 3 else 1,)),
        STRIP_OFFSETS: (4, (0,)), SAMPLES: (3, (spp,)),
        ROWS_PER_STRIP: (4, (h,)), STRIP_COUNTS: (4, (len(pixels),)),
        PLANAR: (3, (1,)), SAMPLE_FORMAT: (3, (fmt,) * spp),
    }
    if spp not in (1, 3):
        tags[EXTRA_SAMPLES] = (3, (0,) * (spp - 1))
    tags.update(extra_tags or {})
    entries = sorted(tags.items())
    # layout: header, IFD, the values too long for their entry, pixels
    heap = 8 + 2 + 12 * len(entries) + 4
    fields, values = [], []
    for tag, (typ, vals) in entries:
        code = _TYPES[typ][0]
        body = struct.pack(f"<{len(vals)}{code[0]}", *vals)
        count = len(vals) // len(code)
        if len(body) > 4:
            values.append(body + b"\x00" * (len(body) % 2))
            body = struct.pack("<I", heap)
            heap += len(values[-1])
        fields.append([tag, typ, count, body.ljust(4, b"\x00")])
    for f in fields:
        if f[0] == STRIP_OFFSETS:
            f[3] = struct.pack("<I", heap)  # the pixels follow the values
    with open(path, "wb") as out:
        out.write(b"II*\x00" + struct.pack("<IH", 8, len(fields)))
        for tag, typ, count, body in fields:
            out.write(struct.pack("<HHI", tag, typ, count) + body)
        out.write(struct.pack("<I", 0))  # no next IFD
        out.write(b"".join(values))
        out.write(pixels)
