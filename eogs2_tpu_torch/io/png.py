"""PNG reader and writer in numpy and zlib.

Writes 8-bit gray, RGB and RGBA images: the signature, IHDR, one IDAT of
filter-0 rows compressed by zlib, IEND, each chunk with its zlib.crc32.
Reads non-interlaced 8-bit gray, gray+alpha, RGB and RGBA PNGs with all
five row filters (other writers, imageio's and Pillow's among them, pick a
filter per row). Any other PNG (16-bit, palette, interlaced) is handed to
Pillow or imageio, imported only then; without either, :func:`read_png`
raises ImportError naming the file and what it holds.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from eogs2_tpu_torch.io import Unsupported, read_with_library

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # colour type -> samples per pixel
_COLOUR_TYPE = {1: 0, 3: 2, 4: 6}


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray):
    """Write img, uint8 [H, W] (gray), [H, W, 1], [H, W, 3] or [H, W, 4]."""
    img = np.asarray(img)
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    c = 1 if img.ndim == 2 else img.shape[2]
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or c not in (1, 3, 4):
        raise ValueError(f"write_png: {img.dtype} image of shape "
                         f"{img.shape}; want uint8 [H, W(, 1|3|4)]")
    h, w = img.shape[:2]
    rows = np.zeros((h, 1 + w * c), np.uint8)  # filter byte 0 per row
    rows[:, 1:] = img.reshape(h, w * c)
    with open(path, "wb") as f:
        f.write(SIGNATURE)
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8,
                                            _COLOUR_TYPE[c], 0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        f.write(_chunk(b"IEND", b""))


def _unfilter(raw: bytes, h: int, w: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters (PNG spec, section 9) -> [H, W * bpp]."""
    stride = w * bpp
    rows = np.frombuffer(raw, np.uint8, count=h * (stride + 1))
    rows = rows.reshape(h, stride + 1)
    out = np.zeros((h + 1, stride), np.uint8)  # row 0: the zero row above
    for y in range(h):
        ftype, line = rows[y, 0], rows[y, 1:]
        up = out[y]
        if ftype == 0:
            out[y + 1] = line
        elif ftype == 1:  # Sub: running sum of each sample along the row
            s = line.reshape(w, bpp).cumsum(axis=0, dtype=np.uint8)
            out[y + 1] = s.reshape(-1)
        elif ftype == 2:  # Up
            out[y + 1] = line + up
        elif ftype in (3, 4):  # Average, Paeth: sequential along the row
            cur = bytearray(stride)
            ln, upl = line.tolist(), up.tolist()
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                b = upl[i]
                if ftype == 3:
                    pred = (a + b) >> 1
                else:
                    c = upl[i - bpp] if i >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (
                        b if pb <= pc else c)
                cur[i] = (ln[i] + pred) & 0xFF
            out[y + 1] = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"PNG row filter {ftype} is not defined")
    return out[1:]


def _decode(data: bytes) -> np.ndarray:
    if data[:8] != SIGNATURE:
        raise Unsupported("not a PNG")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        n, kind = struct.unpack_from(">I4s", data, pos)
        body = data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack_from(">I", data, pos + 8 + n)
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"PNG chunk {kind!r} fails its CRC")
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + n
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in _CHANNELS or interlace:
        raise Unsupported(f"a PNG of bit depth {depth}, colour type "
                          f"{ctype}, interlace {interlace}")
    c = _CHANNELS[ctype]
    img = _unfilter(zlib.decompress(b"".join(idat)), h, w, c).reshape(h, w, c)
    return img[..., 0] if c == 1 else img


def read_png(path: str) -> np.ndarray:
    """uint8 [H, W] (gray) or [H, W, C], as imageio reads it."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        return _decode(data)
    except Unsupported as e:
        return read_with_library(path, str(e))
