"""Scene assembly: affine_models.json reader, images, uniform point init,
splits.

Counterpart of ``eogs2_tpu/scene.py``; parity targets ``dataset_affine.py``
(metadata -> cameras :331-396, uniform init :247-295, train/test split with
the synthetic Nadir camera appended to test :305-328) and
``dataset_MS_affine.py`` (paired {pan, msi} metadata).
:func:`build_scene` assembles a SceneData from metadata and images already
in memory; :func:`load_scene` reads them from a scene directory (TIFFs and
PNGs through ``io/tiff.py`` and ``io/png.py``, which need neither imageio
nor Pillow) and calls it, with the init points of ``<scene>/<name>.ply``
when ``input_ply_name`` is given (dataset_MS_affine.py:116-121). The MS
format's {"pan", "msi"} groups pair a PAN and an MSI view per index; in the
single-modality list format, a run that loads no MSI (3PAN, onlyPAN,
average) takes the same metadata as PAN cameras. The GT is normalized at
load by any rescaler of ``rescalers.py``.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional

import numpy as np

from eogs2_tpu_torch.cameras import AffineCamera, camera_from_reference_convention
from eogs2_tpu_torch.io import read_image
from eogs2_tpu_torch.io.ply import read_point_cloud
from eogs2_tpu_torch.rescalers import load_rescaler


@dataclasses.dataclass
class ViewData:
    """One training/eval view (one modality)."""

    name: str
    image_type: str  # "msi" | "pan"
    camera: AffineCamera
    image: Optional[np.ndarray]  # [C,H,W] float32 in [0,1]; None if not loaded
    reference_altitude: Optional[np.ndarray] = None
    is_reference: bool = False
    is_virtual: bool = False


@dataclasses.dataclass
class SceneData:
    train_views: List[ViewData]
    test_views: List[ViewData]
    init_xyz: np.ndarray  # [N,3]
    init_rgb: np.ndarray  # [N,3]
    # normalization: world = normalized * scale + shift ; UTM zone (n, l)
    scene_shift: np.ndarray
    scene_scale: float
    scene_n: int
    scene_l: str
    cameras_extent: float

    @property
    def reference_view(self) -> ViewData:
        return self.train_views[0]

    def views_by_name(self) -> Dict[str, ViewData]:
        return {v.name: v for v in self.train_views + self.test_views}


def _camera_from_metadata(md: dict, device=None) -> AffineCamera:
    model = md["model"]
    sun = md.get("sun_model")
    return camera_from_reference_convention(
        coef=model["coef_"],
        inter=model["intercept_"],
        sun_coef=sun["coef_"] if sun else None,
        sun_inter=sun["intercept_"] if sun else None,
        camera_to_sun=sun["camera_to_sun"] if sun else None,
        altitude_bounds=(md["min_alt"], md["max_alt"]),
        centerofscene=md["centerofscene_UTM"],
        width=md["width"],
        height=md["height"],
        device=device,
    )


def uniform_point_init(
    min_world, max_world, scale: float, target_density: float = 0.13, seed: int = 0
):
    """Uniform init at `target_density` Gaussians per true cubic meter: draw
    in [-1,1]^3, keep points inside the 1.1x-margin world bbox;
    N_total = density * 8 * scale^3."""
    rng = np.random.RandomState(seed)
    min_world = np.asarray(min_world, np.float64)
    max_world = np.asarray(max_world, np.float64)
    num = int(target_density * (2.0**3) * float(scale) ** 3)
    xyz = rng.rand(num, 3) * 2.0 - 1.0
    inside = np.all(xyz > min_world * 1.1, axis=1) & np.all(xyz < max_world * 1.1, axis=1)
    xyz = xyz[inside].astype(np.float32)
    rgb = np.full((len(xyz), 3), 1.1, np.float32)  # reference inits colors to 1.1
    return xyz, rgb


def _load_image(images_dir: str, name: str, need_rescale: bool):
    """[C,H,W] float32 from images_dir/name, or None if it is missing."""
    path = os.path.join(images_dir, name)
    if not os.path.exists(path):
        return None
    img = np.asarray(read_image(path)).astype(np.float32)
    if img.ndim == 2:
        img = img[..., None]
    if need_rescale:
        img = img / 255.0
    return img.transpose(2, 0, 1)


def build_scene(
    metadatas,
    images_msi: Optional[Dict[str, np.ndarray]] = None,
    images_pan: Optional[Dict[str, np.ndarray]] = None,
    split=None,
    target_density: float = 0.13,
    load_msi: bool = True,
    load_pan: bool = True,
    seed: int = 0,
    scale_factor_z: float = 1.0,
    rescaler_name: str = "clamper",
    device=None,
    init_points=None,
) -> SceneData:
    """SceneData from affine_models.json's content and images in memory.

    metadatas: the single-modality list, or the MS {"pan", "msi"} dict;
    images_msi / images_pan: image file name -> [C,H,W] float32 (a missing
    name leaves the view without an image); split: (train names, test
    names) as in train.txt / test.txt, or None to train on every view;
    init_points: (xyz [N,3], rgb [N,3]) in place of the uniform cloud."""
    if isinstance(metadatas, dict):  # MS format
        groups = {k: v for k, v in metadatas.items() if k in ("pan", "msi")}
    else:
        groups = {"msi" if load_msi else "pan": metadatas}

    views: List[ViewData] = []
    n_views = len(next(iter(groups.values())))
    model_md = None
    for i in range(n_views):
        for kind, mds in groups.items():
            if (kind == "msi" and not load_msi) or (kind == "pan" and not load_pan):
                continue
            md = mds[i]
            model_md = md
            images = images_pan if kind == "pan" else images_msi
            img = None
            if images and not md.get("virtual_camera", False) \
                    and md["img"] != "Nadir":
                img = images.get(md["img"])
            views.append(
                ViewData(
                    name=md["img"].replace(".tif", ""),
                    image_type=kind,
                    camera=_camera_from_metadata(md, device),
                    image=img,
                    is_virtual=md.get("virtual_camera", False),
                )
            )

    # split: all-but-last by train.txt/test.txt, last (Nadir) -> test
    per_view = max(1, len(groups))
    if split is not None:
        def names(xs):
            return {x.replace(".json", "").replace(".tif", "") for x in xs}

        train_names, test_names = names(split[0]), names(split[1])
        train_views, test_views = [], []
        body, tail = views[: len(views) - per_view], views[len(views) - per_view :]
        for v in body:
            if v.name in train_names:
                train_views.append(v)
            elif v.name in test_names:
                test_views.append(v)
            else:
                raise RuntimeError(f"view {v.name} in neither split")
        test_views.extend(tail)  # synthetic Nadir camera
    else:
        train_views, test_views = views, []

    train_views[0].is_reference = True

    # GT normalization at load (utils/rescaler/rescaler.py:149-172)
    if rescaler_name and rescaler_name != "identity":
        rescale = load_rescaler(rescaler_name,
                                reference_image=train_views[0].image)
        for v in train_views + test_views:
            if v.image is not None:
                v.image = np.asarray(rescale(v.image), np.float32)

    model = model_md["model"]
    if init_points is not None:
        xyz, rgb = (np.asarray(x, np.float32) for x in init_points)
    else:
        max_world = list(model["max_world"])
        max_world[2] = max_world[2] * scale_factor_z  # z-stretch of the init volume
        xyz, rgb = uniform_point_init(
            model["min_world"], max_world, model["scale"], target_density, seed
        )
    radius = np.linalg.norm(xyz - xyz.mean(0), axis=1).max() * 2.0

    return SceneData(
        train_views=train_views,
        test_views=test_views,
        init_xyz=xyz,
        init_rgb=rgb,
        scene_shift=np.asarray(model["center"], np.float64),
        scene_scale=float(model["scale"]),
        scene_n=int(model.get("n", 17)),
        scene_l=str(model.get("l", "R")),
        cameras_extent=float(radius),
    )


def load_scene(
    path: str,
    images_msi_path: Optional[str] = None,
    images_pan_path: Optional[str] = None,
    eval_split: bool = True,
    need_rescale: bool = False,
    target_density: float = 0.13,
    load_msi: bool = True,
    load_pan: bool = True,
    seed: int = 0,
    scale_factor_z: float = 1.0,
    rescaler_name: str = "clamper",
    input_ply_name: Optional[str] = None,
    device=None,
) -> SceneData:
    """Load a scene directory holding affine_models.json (+ train/test.txt),
    with the images of images_msi_path / images_pan_path when given, and
    the init points of ``<path>/<input_ply_name>.ply`` when that is given
    (dataset_affine.py:298-302) instead of the uniform cloud.

    Handles the single-modality list format and the MS {"pan", "msi"}
    format of the reference's to_affine output."""
    with open(os.path.join(path, "affine_models.json")) as f:
        metadatas = json.load(f)
    groups = (metadatas if isinstance(metadatas, dict)
              else {"msi" if load_msi else "pan": metadatas})

    def read(images_dir, kind):
        if not images_dir or kind not in groups:
            return None
        out = {}
        for md in groups[kind]:
            if md.get("virtual_camera", False) or md["img"] == "Nadir":
                continue
            img = _load_image(images_dir, md["img"], need_rescale)
            if img is not None:
                out[md["img"]] = img
        return out

    split = None
    if eval_split and os.path.exists(os.path.join(path, "train.txt")):
        with open(os.path.join(path, "train.txt")) as f:
            train_names = f.read().split()
        with open(os.path.join(path, "test.txt")) as f:
            test_names = f.read().split()
        split = (train_names, test_names)
    return build_scene(
        metadatas,
        read(images_msi_path, "msi") if load_msi else None,
        read(images_pan_path, "pan") if load_pan else None,
        split=split, target_density=target_density, load_msi=load_msi,
        load_pan=load_pan, seed=seed, scale_factor_z=scale_factor_z,
        rescaler_name=rescaler_name, device=device,
        init_points=(None if input_ply_name is None else read_point_cloud(
            os.path.join(path, f"{input_ply_name}.ply"))),
    )
