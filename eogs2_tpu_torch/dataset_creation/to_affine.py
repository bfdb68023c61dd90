"""RPC -> affine dataset creation (offline, host-side numpy).

Counterpart of ``eogs2_tpu/dataset_creation/to_affine.py`` (a copy, float64
on the host); its output loads through ``eogs2_tpu_torch.scene.load_scene``.

Parity target: ``scripts/dataset_creation/`` —
  * scene-wide normalized-UTM frame from corner localizations of all RPCs
    (converter.py:62-125: center/shift = mean of ground-level corners,
    scale = max corner distance, bbox in normalized coords)
  * per-image least-squares fit of world -> (u, v, alt) affine on a
    31x37x29 image-grid localized through the RPC (utils_to_affine.py:58-95)
  * sun direction from azimuth/elevation (utils_to_affine.py:47-55), sun
    affine = shear of the camera affine with (A_sun @ sun_dir) = e_z
    (to_affine.py:79-115)
  * a synthetic perfectly-nadir virtual camera appended (to_affine.py:239-253)
  * invariant checks (utils_to_affine.test, utils_to_affine.py:29-43)
  * writes affine_models.json + train.txt/test.txt consumed by the scene
    loader.

Input layout: a directory of per-image metadata json files, each containing
{img, width, height, min_alt, max_alt, sun_elevation, sun_azimuth, rpc}.
"""

from __future__ import annotations

import json
import os
from glob import glob
from typing import List, Optional

import numpy as np

from eogs2_tpu_torch.dataset_creation.rpc import RPCModel, from_latlon


def get_dir_vec_from_el_az(elevation_deg, azimuth_deg):
    """utils_to_affine.py:47-55 (elevation 0 at nadir convention)."""
    el = np.radians(90 - elevation_deg)
    az = np.radians(azimuth_deg)
    return -1.0 * np.array(
        [np.sin(az) * np.cos(el), np.cos(az) * np.cos(el), np.sin(el)]
    )


class SceneConverter:
    """Scene-wide normalized-UTM world frame (converter.py:62-125)."""

    def __init__(self, scene_metadatas: List[dict]):
        vertices = []
        ground = []
        n = l = None
        for md in scene_metadatas:
            rpc = RPCModel(md["rpc"], dict_format="rpcm")
            for u in (0, md["width"] - 1):
                for v in (0, md["height"] - 1):
                    for a in (md["min_alt"], md["max_alt"]):
                        lon, lat = rpc.localization(u, v, a)
                        x, y, n, l = from_latlon(lat, lon, force_zone_number=n)
                        vertices.append([x, y, a])
                    lon, lat = rpc.localization(u, v, 0.0)
                    x, y, n, l = from_latlon(lat, lon, force_zone_number=n)
                    ground.append([x, y, 0.0])
        vertices = np.asarray(vertices)
        ground = np.asarray(ground)
        self.shift = ground.mean(axis=0)
        self.centerofscene_UTM = self.shift
        self.n = n
        self.l = l
        self.scale = float(
            np.max(np.linalg.norm(vertices - self.shift, axis=1))
        )
        world = (vertices - self.shift) / self.scale
        self.min_world = world.min(axis=0)
        self.max_world = world.max(axis=0)

    def lonlat_to_world(self, lon, lat, alt):
        x, y, _, _ = from_latlon(lat, lon, force_zone_number=self.n)
        utm_pts = np.stack([x, y, np.broadcast_to(alt, np.shape(x))], axis=-1)
        return (utm_pts - self.shift) / self.scale


def approximate_w2v_affine(rpc: RPCModel, width, height, min_alt, max_alt,
                           converter: SceneConverter,
                           grid=(31, 37, 29)):
    """Least-squares world -> (u_ndc, v_ndc, alt_norm) fit
    (utils_to_affine.py:58-95). Returns (coef [3,3], intercept [3])."""
    nu, nv, na = grid
    u = np.linspace(0, width - 1, nu)
    v = np.linspace(0, height - 1, nv)
    a = np.linspace(min_alt, max_alt, na)
    U, V, A = np.meshgrid(u, v, a, indexing="ij")
    uva = np.stack([U, V, A], axis=-1)
    view = (uva + np.array([0.5, 0.5, 0.0])) * np.array(
        [1.0 / width, 1.0 / height, 1.0]
    )
    view[..., :2] = view[..., :2] * 2 - 1
    # NOTE: the altitude output stays in *normalized world* units: the
    # reference divides A by nothing here but regresses onto world coords
    # whose z is altitude/scale — reproduce exactly: target alt = raw meters
    # scaled implicitly by the regression target 'view' using A directly.
    lon, lat = rpc.localization(U.ravel(), V.ravel(), A.ravel())
    world = converter.lonlat_to_world(lon, lat, A.ravel())
    X = np.concatenate([world, np.ones((len(world), 1))], axis=1)
    Y = view.reshape(-1, 3)
    sol, *_ = np.linalg.lstsq(X, Y, rcond=None)
    coef = sol[:3].T  # [3,3]
    intercept = sol[3]
    return coef, intercept


def sun_model(coef, intercept, sun_elevation, sun_azimuth, centerofscene):
    """to_affine.py:79-115 (pipeline_msi sun construction)."""
    local_sun_dir = -get_dir_vec_from_el_az(
        elevation_deg=90 - float(sun_elevation), azimuth_deg=float(sun_azimuth)
    )
    sun_dir = local_sun_dir / (coef @ local_sun_dir)[2]
    a_s = coef @ sun_dir
    my_m = np.array([[1, 0, -a_s[0]], [0, 1, -a_s[1]], [0, 0, 1]], np.float64)
    sun_a = my_m @ coef
    sun_b = -sun_a @ centerofscene + coef @ centerofscene + intercept
    return {
        "coef_": sun_a.tolist(),
        "intercept_": sun_b.tolist(),
        "sun_dir_ecef": sun_dir.tolist(),
        "camera_to_sun": my_m.tolist(),
    }


def create_nadir_metadata(template_md: dict, converter: SceneConverter) -> dict:
    """Synthetic perfectly-vertical camera (to_affine.py:239-253): axes
    swapped (u = world_y, v = world_x), altitude row scaled back to meters;
    the sun model is inherited from the template camera (the reference
    deepcopies it)."""
    import copy

    md = copy.deepcopy(template_md)
    md["img"] = "Nadir"
    md["virtual_camera"] = True
    md["model"]["coef_"] = [
        [0.0, 1.0, 0.0],
        [1.0, 0.0, 0.0],
        [0.0, 0.0, float(converter.scale)],
    ]
    md["model"]["intercept_"] = [0.0, 0.0, 0.0]
    return md


def validate(metadatas: List[dict]):
    """utils_to_affine.test parity: every camera affine maps every sun
    direction to the w axis with unit third component; Nadir present."""
    for mi in metadatas:
        a = np.array(mi["model"]["coef_"])
        for mj in metadatas:
            s = np.array(mj["sun_model"]["sun_dir_ecef"])
            z = (a @ s)[2]
            assert abs(z - 1) < 1e-4, z
    assert "Nadir" in [m["img"] for m in metadatas]


def convert_scene(
    metadata_dir: str,
    out_dir: str,
    test_fraction_last: int = 2,
    scale_factor_z: float = 1.0,
    grid=(31, 37, 29),
):
    """Full to_affine pipeline: read per-image metadata jsons, fit affines,
    write affine_models.json + splits. Returns the metadata list."""
    files = sorted(glob(os.path.join(metadata_dir, "*.json")))
    assert files, f"no metadata jsons in {metadata_dir}"
    metadatas = [json.load(open(f)) for f in files]
    converter = SceneConverter(metadatas)

    out = []
    for md in metadatas:
        rpc = RPCModel(md["rpc"], dict_format="rpcm")
        coef, intercept = approximate_w2v_affine(
            rpc, md["width"], md["height"], md["min_alt"], md["max_alt"],
            converter, grid=grid,
        )
        entry = {
            "img": md["img"],
            "width": md["width"],
            "height": md["height"],
            # NOTE raw meters: the fitted affine's third row outputs altitude
            # in meters (the reference regresses view z = A unscaled,
            # utils_to_affine.py:76-80), so the bounds stay in meters too.
            "min_alt": md["min_alt"],
            "max_alt": md["max_alt"],
            "sun_elevation": md["sun_elevation"],
            "sun_azimuth": md["sun_azimuth"],
            "virtual_camera": False,
            "centerofscene_UTM": [0.0, 0.0, 0.0],
            "model": {
                "coef_": coef.tolist(),
                "intercept_": intercept.tolist(),
                "scale": converter.scale,
                "n": int(converter.n),
                "l": str(converter.l),
                "center": converter.shift.tolist(),
                "min_world": converter.min_world.tolist(),
                "max_world": converter.max_world.tolist(),
            },
            "sun_model": sun_model(
                coef, intercept, md["sun_elevation"], md["sun_azimuth"],
                np.zeros(3),
            ),
        }
        out.append(entry)

    out.append(create_nadir_metadata(out[-1], converter))
    validate(out)

    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "affine_models.json"), "w") as f:
        json.dump(out, f)
    names = [m["img"] for m in out[:-1]]
    train = names[:-test_fraction_last] if test_fraction_last else names
    test = names[len(names) - test_fraction_last:] if test_fraction_last else []
    with open(os.path.join(out_dir, "train.txt"), "w") as f:
        f.write("\n".join(train))
    with open(os.path.join(out_dir, "test.txt"), "w") as f:
        f.write("\n".join(test))
    return out
