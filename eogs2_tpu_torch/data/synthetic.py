"""Synthetic satellite scene generator (reference-schema compatible).

Counterpart of ``eogs2_tpu/data/synthetic.py`` (numpy only): a textured
heightfield (ground + rectangular buildings) over [-1, 1]^2, pushbroom-like
affine cameras with their sun models in the reference's to_affine.py schema
(model/sun_model/camera_to_sun, normalized world frame, the Nadir virtual
camera appended, train/test split), and ground-truth images rendered
analytically by marching each pixel's affine ray into the heightfield, with
cast sun shadows.

The JAX package's ``generate_scene`` is split in two:
:func:`make_scene_arrays` returns the metadata and the images in memory (no
file and no imageio needed, e.g. on a machine without imageio), and
:func:`write_scene` writes the directory (``affine_models.json``,
``images/*.tif``, the split files, the ground-truth heightfield), importing
imageio only there. :func:`scene_from_arrays` turns the in-memory form into
a ``SceneData`` through the same code path ``scene.load_scene`` takes after
reading files. Only the single-modality ("msi") scene is built: the
panchromatic companions of ``modality="ms"`` arrive with the PAN
modalities (ROADMAP Queue 1 item 9).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, NamedTuple

import numpy as np


def _heightfield(res: int, n_buildings: int, rng, alt_range=(-0.35, 0.35)):
    """[res,res] heightfield over [-1,1]^2, plus the texture [res,res,3]."""
    z = np.full((res, res), alt_range[0], np.float32)
    tex = 0.25 + 0.5 * rng.rand(res, res, 3).astype(np.float32) * 0.15
    # large-scale texture variation
    gx, gy = np.meshgrid(np.linspace(0, 6.28, res), np.linspace(0, 6.28, res))
    tex[..., 0] += 0.15 * np.sin(gx) * np.cos(2 * gy)
    tex[..., 1] += 0.15 * np.cos(2 * gx) * np.sin(gy)
    tex[..., 2] += 0.1 * np.sin(gx + gy)
    for _ in range(n_buildings):
        w = rng.randint(res // 16, res // 5)
        h = rng.randint(res // 16, res // 5)
        x0 = rng.randint(0, res - w)
        y0 = rng.randint(0, res - h)
        hgt = rng.uniform(0.15, 1.0) * (alt_range[1] - alt_range[0]) + alt_range[0]
        z[y0 : y0 + h, x0 : x0 + w] = np.maximum(z[y0 : y0 + h, x0 : x0 + w], hgt)
        col = 0.3 + 0.6 * rng.rand(3)
        tex[y0 : y0 + h, x0 : x0 + w] = col
    return z, np.clip(tex, 0.0, 1.0)


def _sample_field(field, x, y):
    """Nearest-neighbor sample of a [-1,1]^2 field at world (x, y)."""
    res = field.shape[0]
    ix = np.clip(((x + 1) * 0.5 * (res - 1)).round().astype(int), 0, res - 1)
    iy = np.clip(((y + 1) * 0.5 * (res - 1)).round().astype(int), 0, res - 1)
    return field[iy, ix]


def _render_view(z, tex, affine, sun_dir, width, height, shadow_dim=0.45,
                 alt_range=(-0.35, 0.35), n_steps=64):
    """Analytic render: for each pixel (u,v), march altitude a from top to
    bottom along the inverse affine ray until it dips under the heightfield.

    affine: [3,4] world->(u_ndc, v_ndc, altitude). Returns [H,W,3] image and
    [H,W] surface altitude.
    """
    A = affine[:, :3]
    b = affine[:, 3]
    Ainv = np.linalg.inv(A)
    us = (2 * (np.arange(width) + 0.5) / width) - 1
    vs = (2 * (np.arange(height) + 0.5) / height) - 1
    U, V = np.meshgrid(us, vs)  # [H,W]
    alts = np.linspace(alt_range[1], alt_range[0], n_steps)
    surf_alt = np.full(U.shape, alt_range[0], np.float32)
    found = np.zeros(U.shape, bool)
    for a in alts:
        uva = np.stack([U, V, np.full_like(U, a)], -1)
        xyz = (uva - b) @ Ainv.T
        zs = _sample_field(z, xyz[..., 0], xyz[..., 1])
        hit = (~found) & (zs >= a)
        surf_alt[hit] = zs[hit]
        found |= hit
    # refine: world point at the found altitude
    uva = np.stack([U, V, surf_alt], -1)
    xyz = (uva - b) @ Ainv.T
    color = _sample_field(tex, xyz[..., 0], xyz[..., 1])

    # cast shadows: walk from the surface toward the sun; shadowed if the
    # heightfield rises above the ray
    lit = np.ones(U.shape, bool)
    sd = sun_dir / np.linalg.norm(sun_dir)
    if sd[2] < -1e-3:  # pointing down; flip to walk up toward the sun
        sd = -sd
    ts = np.linspace(0.02, 2.0, 48)
    for t in ts:
        p = xyz + t * sd
        inside = (np.abs(p[..., 0]) < 1) & (np.abs(p[..., 1]) < 1)
        zs = _sample_field(z, p[..., 0], p[..., 1])
        lit &= ~(inside & (zs > p[..., 2] + 1e-3))
    shade = np.where(lit, 1.0, shadow_dim)[..., None]
    return (color * shade).astype(np.float32), surf_alt


def make_affine(view_shear, width, height, alt_range):
    """Pushbroom-like affine: u = x - shear_x * z, v = y - shear_y * z,
    altitude passthrough ([3,4] float64)."""
    sx, sy = view_shear
    return np.array(
        [[1.0, 0.0, -sx, 0.0], [0.0, 1.0, -sy, 0.0], [0.0, 0.0, 1.0, 0.0]],
        np.float64,
    )


def sun_model_from_affine(A3x4, sun_dir):
    """to_affine.py:79-115: normalize sun_dir so (A @ s).z == 1; shear the
    camera affine so the sun direction maps to the w axis.
    Returns (sun_A [3,3], sun_b [3], s [3], camera_to_sun [3,3])."""
    A = np.asarray(A3x4)[:, :3]
    b = np.asarray(A3x4)[:, 3]
    s = np.asarray(sun_dir, np.float64)
    s = s / (A @ s)[2]
    As = A @ s
    myM = np.array([[1, 0, -As[0]], [0, 1, -As[1]], [0, 0, 1]], np.float64)
    sun_A = myM @ A
    sun_b = b - sun_A @ np.zeros(3) + A @ np.zeros(3)  # center-of-scene = 0
    return sun_A, sun_b, s, myM


class SyntheticScene(NamedTuple):
    """A synthetic scene in memory (what generate_scene writes)."""

    metadatas: List[dict]  # affine_models.json: one dict per view
    images: Dict[str, np.ndarray]  # file name -> [H,W,3] float32
    train_names: List[str]
    test_names: List[str]
    heightfield: np.ndarray  # [res,res] ground-truth altitude
    texture: np.ndarray  # [res,res,3]


def make_scene_arrays(
    n_views: int = 9,
    width: int = 128,
    height: int = 128,
    hf_res: int = 256,
    n_buildings: int = 6,
    seed: int = 0,
    scale: float = 25.0,
    sun_el_az=(55.0, 120.0),
) -> SyntheticScene:
    """Build the scene in memory: the same metadata, images and ground
    truth as eogs2_tpu's generate_scene(out_dir, ...) writes for these
    arguments (modality "msi"). The normalized world is [-1,1]^3 with `scale` meters per
    unit (so the 0.13/m^3 density init yields ~0.13*8*scale^3 points)."""
    rng = np.random.RandomState(seed)
    alt_range = (-0.35, 0.35)
    z, tex = _heightfield(hf_res, n_buildings, rng, alt_range)

    el, az = sun_el_az
    el_r = np.radians(90 - el)
    az_r = np.radians(az)
    sun_dir = np.array(
        [np.sin(az_r) * np.cos(el_r), np.cos(az_r) * np.cos(el_r), np.sin(el_r)]
    )
    shears = []
    for i in range(n_views):
        ang = 2 * np.pi * i / max(n_views, 1)
        mag = 0.25 if i % 3 else 0.12
        shears.append((mag * np.cos(ang), mag * np.sin(ang)))
    min_world = np.array([-0.85, -0.85, alt_range[0]])
    max_world = np.array([0.85, 0.85, alt_range[1]])

    def metadata(name, A, virtual):
        sun_A, sun_b, sdir, myM = sun_model_from_affine(A, sun_dir)
        return {
            "img": name, "width": width, "height": height,
            "min_alt": float(alt_range[0]), "max_alt": float(alt_range[1]),
            "virtual_camera": virtual, "centerofscene_UTM": [0.0, 0.0, 0.0],
            "sun_elevation": el, "sun_azimuth": az,
            "model": {
                "coef_": A[:, :3].tolist(), "intercept_": A[:, 3].tolist(),
                "scale": scale, "n": 17, "l": "R", "center": [0.0, 0.0, 0.0],
                "min_world": min_world.tolist(),
                "max_world": max_world.tolist(),
            },
            "sun_model": {
                "coef_": sun_A.tolist(), "intercept_": sun_b.tolist(),
                "sun_dir_ecef": sdir.tolist(), "camera_to_sun": myM.tolist(),
            },
        }

    metadatas, images = [], {}
    train_names, test_names = [], []
    for i, shear in enumerate(shears):
        A = make_affine(shear, width, height, alt_range)
        img, _ = _render_view(z, tex, A, sun_dir, width, height,
                              alt_range=alt_range)
        name = f"view_{i:02d}.tif"
        images[name] = img
        metadatas.append(metadata(name, A, False))
        (test_names if i == len(shears) - 1 else train_names).append(name)
    # synthetic perfectly-nadir virtual camera (to_affine.py:239-253)
    metadatas.append(metadata(
        "Nadir", make_affine((0.0, 0.0), width, height, alt_range), True))
    return SyntheticScene(
        metadatas=metadatas, images=images, train_names=train_names,
        test_names=test_names, heightfield=z, texture=tex)


def write_scene(s: SyntheticScene, out_dir: str) -> str:
    """Write a reference-schema scene directory; returns its path."""
    import imageio.v2 as iio

    os.makedirs(os.path.join(out_dir, "images"), exist_ok=True)
    for name, img in s.images.items():
        iio.imwrite(os.path.join(out_dir, "images", name), img)
    with open(os.path.join(out_dir, "affine_models.json"), "w") as f:
        json.dump(s.metadatas, f)
    with open(os.path.join(out_dir, "train.txt"), "w") as f:
        f.write("\n".join(s.train_names))
    with open(os.path.join(out_dir, "test.txt"), "w") as f:
        f.write("\n".join(s.test_names))
    np.save(os.path.join(out_dir, "gt_heightfield.npy"), s.heightfield)
    np.save(os.path.join(out_dir, "gt_texture.npy"), s.texture)
    return out_dir


def scene_from_arrays(s: SyntheticScene, device=None, **kw):
    """The SceneData that scene.load_scene would build from this scene
    written to disk and read back with its images/; kw are build_scene's
    remaining options."""
    from eogs2_tpu_torch.scene import build_scene

    images = {k: v.transpose(2, 0, 1) for k, v in s.images.items()}
    return build_scene(s.metadatas, images, split=(s.train_names,
                                                   s.test_names),
                       device=device, **kw)
