"""Scene assembly: affine_models.json reader, uniform point init, splits.

Counterpart of ``eogs2_tpu/scene.py`` for camera-only loads; parity targets
``dataset_affine.py`` (metadata -> cameras :331-396, uniform init :247-295,
train/test split with the synthetic Nadir camera appended to test
:305-328) and ``dataset_MS_affine.py`` (paired {pan, msi} metadata).
Image loading and the GT rescalers arrive with training.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional

import numpy as np

from eogs2_tpu_torch.cameras import AffineCamera, camera_from_reference_convention


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


def load_scene(
    path: str,
    eval_split: bool = True,
    target_density: float = 0.13,
    load_msi: bool = True,
    load_pan: bool = True,
    seed: int = 0,
    scale_factor_z: float = 1.0,
    device=None,
) -> SceneData:
    """Load the cameras of a scene directory holding affine_models.json
    (+ train/test.txt); views carry no images.

    Handles the single-modality list format and the MS {"pan", "msi"}
    format of the reference's to_affine output."""
    with open(os.path.join(path, "affine_models.json")) as f:
        metadatas = json.load(f)

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
            views.append(
                ViewData(
                    name=md["img"].replace(".tif", ""),
                    image_type=kind,
                    camera=_camera_from_metadata(md, device),
                    image=None,
                    is_virtual=md.get("virtual_camera", False),
                )
            )

    # split: all-but-last by train.txt/test.txt, last (Nadir) -> test
    per_view = max(1, len(groups))
    if eval_split and os.path.exists(os.path.join(path, "train.txt")):
        with open(os.path.join(path, "train.txt")) as f:
            train_names = {x.replace(".json", "").replace(".tif", "") for x in f.read().split()}
        with open(os.path.join(path, "test.txt")) as f:
            test_names = {x.replace(".json", "").replace(".tif", "") for x in f.read().split()}
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

    model = model_md["model"]
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
