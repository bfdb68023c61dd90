"""COLMAP sparse-model parsing (binary and text).

Counterpart of ``eogs2_tpu/io/colmap.py`` (a copy: numpy and struct on the
host). Parity target: ``scene/colmap_loader.py`` (reference) — the legacy Colmap
loader kept from upstream 3DGS. Implements the public COLMAP model format:

  cameras.bin   u64 count; per camera: i32 id, i32 model_id, u64 w, u64 h,
                f64 params[num_params(model)]
  images.bin    u64 count; per image: i32 id, f64 qvec[4], f64 tvec[3],
                i32 camera_id, cstring name, u64 n_pts2d,
                (f64 x, f64 y, i64 point3d_id) * n_pts2d
  points3D.bin  u64 count; per point: i64 id, f64 xyz[3], u8 rgb[3],
                f64 error, u64 track_len, (i32 image_id, i32 p2d_idx)*len

Only SIMPLE_PINHOLE / PINHOLE intrinsics are consumed downstream (the
reference asserts the same, colmap_loader.py:199).
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass
from typing import Dict

import numpy as np

# model_id -> (name, num_params)
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}
CAMERA_MODEL_IDS = {name: mid for mid, (name, _) in CAMERA_MODELS.items()}


@dataclass
class ColmapCamera:
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


@dataclass
class ColmapImage:
    id: int
    qvec: np.ndarray  # [4] (w, x, y, z)
    tvec: np.ndarray  # [3]
    camera_id: int
    name: str


def qvec2rotmat(q):
    """World->camera rotation from a COLMAP (w,x,y,z) quaternion."""
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def rotmat2qvec(R):
    """Inverse of qvec2rotmat (largest-component-stable)."""
    t = np.trace(R)
    if t > 0:
        w = 0.5 * np.sqrt(1.0 + t)
        x = (R[2, 1] - R[1, 2]) / (4 * w)
        y = (R[0, 2] - R[2, 0]) / (4 * w)
        z = (R[1, 0] - R[0, 1]) / (4 * w)
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(max(R[i, i] - R[j, j] - R[k, k] + 1.0, 1e-12))
        q = np.zeros(4)
        q[i + 1] = 0.5 * s
        q[0] = (R[k, j] - R[j, k]) / (2 * s)
        q[j + 1] = (R[j, i] + R[i, j]) / (2 * s)
        q[k + 1] = (R[k, i] + R[i, k]) / (2 * s)
        w, x, y, z = q
    q = np.array([w, x, y, z])
    return q if q[0] >= 0 else -q


def _read(fid, fmt):
    size = struct.calcsize("<" + fmt)
    return struct.unpack("<" + fmt, fid.read(size))


def read_cameras_binary(path) -> Dict[int, ColmapCamera]:
    cams = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "Q")
        for _ in range(n):
            cid, mid, w, h = _read(f, "iiQQ")
            name, np_ = CAMERA_MODELS[mid]
            params = np.array(_read(f, "d" * np_))
            cams[cid] = ColmapCamera(cid, name, int(w), int(h), params)
    return cams


def read_cameras_text(path) -> Dict[int, ColmapCamera]:
    cams = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            cid, model, w, h = int(parts[0]), parts[1], int(parts[2]), int(parts[3])
            cams[cid] = ColmapCamera(cid, model, w, h,
                                     np.array([float(x) for x in parts[4:]]))
    return cams


def read_images_binary(path) -> Dict[int, ColmapImage]:
    imgs = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "Q")
        for _ in range(n):
            iid = _read(f, "i")[0]
            qvec = np.array(_read(f, "dddd"))
            tvec = np.array(_read(f, "ddd"))
            cam_id = _read(f, "i")[0]
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (n2d,) = _read(f, "Q")
            f.read(24 * n2d)  # skip 2D points (x, y, point3d_id)
            imgs[iid] = ColmapImage(iid, qvec, tvec, cam_id, name.decode())
    return imgs


def read_images_text(path) -> Dict[int, ColmapImage]:
    imgs = {}
    with open(path) as f:
        lines = [ln.strip() for ln in f
                 if ln.strip() and not ln.startswith("#")]
    for i in range(0, len(lines), 2):  # every image uses two lines
        parts = lines[i].split()
        iid = int(parts[0])
        qvec = np.array([float(x) for x in parts[1:5]])
        tvec = np.array([float(x) for x in parts[5:8]])
        imgs[iid] = ColmapImage(iid, qvec, tvec, int(parts[8]), parts[9])
    return imgs


def read_points3d_binary(path):
    """-> (xyz [N,3] f64, rgb [N,3] u8, err [N])."""
    with open(path, "rb") as f:
        (n,) = _read(f, "Q")
        xyz = np.empty((n, 3))
        rgb = np.empty((n, 3), np.uint8)
        err = np.empty(n)
        for i in range(n):
            _read(f, "q")
            xyz[i] = _read(f, "ddd")
            rgb[i] = _read(f, "BBB")
            err[i] = _read(f, "d")[0]
            (tl,) = _read(f, "Q")
            f.read(8 * tl)
    return xyz, rgb, err


def read_points3d_text(path):
    xyz, rgb, err = [], [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            p = line.split()
            xyz.append([float(x) for x in p[1:4]])
            rgb.append([int(x) for x in p[4:7]])
            err.append(float(p[7]))
    return np.array(xyz), np.array(rgb, np.uint8), np.array(err)


# --- writers (for tests / interop) ---


def write_cameras_binary(path, cams: Dict[int, ColmapCamera]):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cams)))
        for c in cams.values():
            mid = CAMERA_MODEL_IDS[c.model]
            f.write(struct.pack("<iiQQ", c.id, mid, c.width, c.height))
            f.write(struct.pack("<" + "d" * len(c.params), *c.params))


def write_images_binary(path, imgs: Dict[int, ColmapImage]):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(imgs)))
        for im in imgs.values():
            f.write(struct.pack("<i", im.id))
            f.write(struct.pack("<dddd", *im.qvec))
            f.write(struct.pack("<ddd", *im.tvec))
            f.write(struct.pack("<i", im.camera_id))
            f.write(im.name.encode() + b"\x00")
            f.write(struct.pack("<Q", 0))


def write_points3d_binary(path, xyz, rgb):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(xyz)))
        for i in range(len(xyz)):
            f.write(struct.pack("<q", i))
            f.write(struct.pack("<ddd", *xyz[i]))
            f.write(struct.pack("<BBB", *rgb[i]))
            f.write(struct.pack("<d", 0.0))
            f.write(struct.pack("<Q", 0))


def read_model(sparse_dir):
    """Read {cameras, images, points3D} preferring .bin, falling back to .txt
    (colmap_loader parity: reference tries binary then text,
    dataset_readers.py:140-152)."""
    def pick(base, rb, rt):
        b = os.path.join(sparse_dir, base + ".bin")
        t = os.path.join(sparse_dir, base + ".txt")
        if os.path.exists(b):
            return rb(b)
        return rt(t)

    cams = pick("cameras", read_cameras_binary, read_cameras_text)
    imgs = pick("images", read_images_binary, read_images_text)
    pts = pick("points3D", read_points3d_binary, read_points3d_text)
    return cams, imgs, pts
