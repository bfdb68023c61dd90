"""DSM extraction from a rendered view (utils/dsm_utils.py:7-52).

Map the (u, v, altitude) grid of a rendered view back to normalized world
coordinates, un-normalize to UTM, and flatten the cloud onto a regular grid
(plyflatten(radius=1, sigma=inf): mean of the points whose footprint covers
the cell). Host-side numpy in float64, as in ``eogs2_tpu/eval/dsm.py``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from eogs2_tpu_torch.io.geotiff import Affine


def flatten_cloud(
    cloud: np.ndarray,
    xoff: float,
    yoff: float,
    resolution: float,
    xsize: int,
    ysize: int,
    radius: int = 1,
) -> np.ndarray:
    """[N,3] points -> [ysize,xsize] mean-height raster (NaN where empty)."""
    x, y, z = cloud[:, 0], cloud[:, 1], cloud[:, 2]
    col = (x - xoff) / resolution
    row = (yoff - y) / resolution
    acc = np.zeros((ysize, xsize), np.float64)
    cnt = np.zeros((ysize, xsize), np.int64)
    base_c = np.floor(col).astype(np.int64)
    base_r = np.floor(row).astype(np.int64)
    for dr in range(-radius + 1, radius):
        for dc in range(-radius + 1, radius):
            cc = base_c + dc
            rr = base_r + dr
            ok = (cc >= 0) & (cc < xsize) & (rr >= 0) & (rr < ysize)
            np.add.at(acc, (rr[ok], cc[ok]), z[ok])
            np.add.at(cnt, (rr[ok], cc[ok]), 1)
    with np.errstate(invalid="ignore"):
        out = np.where(cnt > 0, acc / np.maximum(cnt, 1), np.nan)
    return out.astype(np.float32)


def resolution_for_scene(scene_name: str) -> float:
    if "IARPA" in scene_name:
        return 0.3
    if "JAX" in scene_name:
        return 0.5
    # synthetic scenes carry their own convention; default to 0.5 m/px
    return 0.5


def compute_dsm_from_view(
    camera,
    rendered_uva: np.ndarray,
    scene_shift,
    scene_scale: float,
    scene_name: str = "",
    resolution: Optional[float] = None,
    crs: Optional[str] = None,
) -> Tuple[dict, np.ndarray]:
    """UVA grid -> UTM point cloud -> flattened DSM.

    camera: AffineCamera of the rendered view (the Nadir test camera);
    rendered_uva [H,W,3]; world = normalized * scene_scale + scene_shift.
    Returns (profile, dsm [H',W',1])."""
    affine = np.asarray(camera.affine.detach().cpu(), np.float64)
    ainv = np.linalg.inv(affine[:, :3])
    uva = np.asarray(rendered_uva, np.float64).reshape(-1, 3)
    cloud = (uva - affine[:, 3]) @ ainv.T
    cloud = cloud * float(scene_scale) + np.asarray(scene_shift, np.float64)

    res = resolution if resolution is not None else resolution_for_scene(scene_name)
    xmin, xmax = cloud[:, 0].min(), cloud[:, 0].max()
    ymin, ymax = cloud[:, 1].min(), cloud[:, 1].max()
    xoff = np.floor(xmin / res) * res
    xsize = int(1 + np.floor((xmax - xoff) / res))
    yoff = np.ceil(ymax / res) * res
    ysize = int(1 - np.floor((ymin - yoff) / res))

    dsm = flatten_cloud(cloud, xoff, yoff, res, xsize, ysize, radius=1)
    profile = {
        "dtype": dsm.dtype,
        "height": dsm.shape[0],
        "width": dsm.shape[1],
        "count": 1,
        "nodata": float("nan"),
        "crs": crs,
        "transform": Affine.from_origin(xoff, yoff, res, res),
    }
    return profile, dsm[:, :, None]
