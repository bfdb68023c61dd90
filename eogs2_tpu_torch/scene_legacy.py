"""Legacy perspective-scene readers: COLMAP sparse models and Blender
(NeRF-synthetic) transforms.

Counterpart of ``eogs2_tpu/scene_legacy.py`` (a copy on the host); images
are read through the port's own codecs (``io/tiff.py``, ``io/png.py``), and
other formats through Pillow or imageio, imported only then.

Parity target: ``scene/dataset_readers/dataset_readers.py`` (readColmapSceneInfo
:133-238, readNerfSyntheticInfo :302-341) and ``scene/cameras.py`` — the
upstream-3DGS loaders the reference keeps alongside the affine satellite
path. They are off the EOGS hot path (SURVEY §2.2) but part of the public
surface; this module provides the same capability on plain numpy
structures (no nn.Modules).

Conventions follow COLMAP/3DGS: images store world->camera (qvec, tvec);
`R` below is the camera->world rotation (the transpose), `T` the
world->camera translation — exactly the pairing the 3DGS camera class
expects (dataset_readers.py:88-96 analog).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from eogs2_tpu_torch.io import read_image
from eogs2_tpu_torch.io.colmap import qvec2rotmat, read_model


def focal2fov(focal: float, pixels: float) -> float:
    return 2.0 * np.arctan(pixels / (2.0 * focal))


def fov2focal(fov: float, pixels: float) -> float:
    return pixels / (2.0 * np.tan(fov / 2.0))


@dataclass
class PerspectiveCameraInfo:
    uid: int
    name: str
    R: np.ndarray  # [3,3] camera->world rotation
    T: np.ndarray  # [3] world->camera translation
    fovx: float
    fovy: float
    width: int
    height: int
    image_path: str = ""
    image: Optional[np.ndarray] = None  # [H,W,C] float in [0,1] if loaded

    @property
    def world_to_cam(self) -> np.ndarray:
        m = np.eye(4)
        m[:3, :3] = self.R.T
        m[:3, 3] = self.T
        return m

    @property
    def center(self) -> np.ndarray:
        return -self.R @ self.T


@dataclass
class LegacySceneInfo:
    train_cameras: List[PerspectiveCameraInfo]
    test_cameras: List[PerspectiveCameraInfo]
    points: np.ndarray  # [N,3]
    colors: np.ndarray  # [N,3] float in [0,1]
    translate: np.ndarray = field(default_factory=lambda: np.zeros(3))
    radius: float = 1.0


def nerfpp_norm(cams: List[PerspectiveCameraInfo]):
    """getNerfppNorm parity: bounding sphere of the camera centers
    (translate = -center, radius = 1.1 * max distance)."""
    centers = np.stack([c.center for c in cams])
    avg = centers.mean(axis=0)
    radius = float(np.linalg.norm(centers - avg, axis=1).max() * 1.1)
    return -avg, radius


def _maybe_load_image(path):
    if not path or not os.path.exists(path):
        return None
    img = np.asarray(read_image(path), np.float32)
    return img / 255.0 if img.max() > 1.0 + 1e-6 else img


def load_colmap_scene(
    path: str,
    images_dir: str = "images",
    eval_split: bool = False,
    llffhold: int = 8,
    load_images: bool = True,
) -> LegacySceneInfo:
    """readColmapSceneInfo parity: sparse/0 model -> cameras + point cloud;
    eval holdout = every `llffhold`-th camera (dataset_readers.py:196-203)."""
    sparse = os.path.join(path, "sparse", "0")
    if not os.path.isdir(sparse):
        sparse = path
    cams, imgs, (xyz, rgb, _err) = read_model(sparse)

    infos = []
    for iid in sorted(imgs):
        im = imgs[iid]
        cam = cams[im.camera_id]
        if cam.model == "SIMPLE_PINHOLE":
            f = cam.params[0]
            fovx = focal2fov(f, cam.width)
            fovy = focal2fov(f, cam.height)
        elif cam.model == "PINHOLE":
            fovx = focal2fov(cam.params[0], cam.width)
            fovy = focal2fov(cam.params[1], cam.height)
        else:
            raise ValueError(
                f"unsupported COLMAP camera model {cam.model} "
                "(SIMPLE_PINHOLE/PINHOLE only, as in the reference)"
            )
        ipath = os.path.join(path, images_dir, im.name)
        infos.append(
            PerspectiveCameraInfo(
                uid=iid, name=im.name,
                R=qvec2rotmat(im.qvec).T, T=np.asarray(im.tvec),
                fovx=float(fovx), fovy=float(fovy),
                width=cam.width, height=cam.height,
                image_path=ipath,
                image=_maybe_load_image(ipath) if load_images else None,
            )
        )
    infos.sort(key=lambda c: c.name)
    if eval_split:
        train = [c for i, c in enumerate(infos) if i % llffhold != 0]
        test = [c for i, c in enumerate(infos) if i % llffhold == 0]
    else:
        train, test = infos, []
    translate, radius = nerfpp_norm(train)
    return LegacySceneInfo(
        train_cameras=train, test_cameras=test,
        points=np.asarray(xyz, np.float32),
        colors=np.asarray(rgb, np.float32) / 255.0,
        translate=translate, radius=radius,
    )


def _read_transforms(path, fname, load_images):
    fp = os.path.join(path, fname)
    if not os.path.exists(fp):
        return []
    with open(fp) as f:
        meta = json.load(f)
    fovx = meta["camera_angle_x"]
    out = []
    for i, frame in enumerate(meta["frames"]):
        c2w = np.array(frame["transform_matrix"], np.float64)
        # Blender/NeRF uses OpenGL axes: flip y and z to COLMAP convention
        # (dataset_readers.py:258-262 analog)
        c2w[:3, 1:3] *= -1.0
        w2c = np.linalg.inv(c2w)
        name = os.path.basename(frame["file_path"])
        ipath = os.path.join(path, frame["file_path"])
        for ext in ("", ".png", ".jpg"):
            if os.path.exists(ipath + ext):
                ipath = ipath + ext
                break
        img = _maybe_load_image(ipath) if load_images else None
        w = img.shape[1] if img is not None else int(meta.get("w", 800))
        h = img.shape[0] if img is not None else int(meta.get("h", 800))
        fovy = focal2fov(fov2focal(fovx, w), h)
        out.append(
            PerspectiveCameraInfo(
                uid=i, name=name,
                R=np.asarray(w2c[:3, :3]).T, T=np.asarray(w2c[:3, 3]),
                fovx=float(fovx), fovy=float(fovy), width=w, height=h,
                image_path=ipath, image=img,
            )
        )
    return out


def load_blender_scene(
    path: str,
    eval_split: bool = True,
    load_images: bool = True,
    num_random_points: int = 100_000,
    seed: int = 0,
) -> LegacySceneInfo:
    """readNerfSyntheticInfo parity: transforms_{train,test}.json; when the
    scene ships no point cloud, init `num_random_points` random points in
    [-1.3, 1.3]^3 with random colors (dataset_readers.py:322-333)."""
    train = _read_transforms(path, "transforms_train.json", load_images)
    test = _read_transforms(path, "transforms_test.json", load_images)
    if not eval_split:
        train, test = train + test, []
    ply = os.path.join(path, "points3d.ply")
    if os.path.exists(ply):
        from eogs2_tpu_torch.io.ply import read_point_cloud

        xyz, rgb = read_point_cloud(ply)
    else:
        rng = np.random.RandomState(seed)
        xyz = (rng.random((num_random_points, 3)) * 2.6 - 1.3).astype(np.float32)
        rgb = rng.random((num_random_points, 3)).astype(np.float32)
    translate, radius = nerfpp_norm(train)
    return LegacySceneInfo(
        train_cameras=train, test_cameras=test,
        points=np.asarray(xyz, np.float32), colors=np.asarray(rgb, np.float32),
        translate=translate, radius=radius,
    )


def perspective_projection(fovx, fovy, znear=0.01, zfar=100.0):
    """getProjectionMatrix parity (graphics_utils.py:51-84 analog)."""
    tx, ty = np.tan(fovx / 2), np.tan(fovy / 2)
    m = np.zeros((4, 4))
    m[0, 0] = 1.0 / tx
    m[1, 1] = 1.0 / ty
    m[2, 2] = zfar / (zfar - znear)
    m[2, 3] = -(zfar * znear) / (zfar - znear)
    m[3, 2] = 1.0
    return m
