"""The benchmark's synthetic scene, made from the seed on the device.

A frozen copy of ``eogs2_tpu_torch.data.synthetic.make_scene_arrays`` (the
heightfield, the cameras and their sun models) with the expensive part, the
analytic render of every view (a march of each pixel's affine ray into the
heightfield, then a walk towards the sun for the cast shadows), moved onto
the device in float64. The heightfield, the texture and the buildings draw
from ``numpy.random.RandomState(seed)`` in the same order as the original,
so at equal arguments the two give the same scene up to the rounding of the
nearest-neighbour lookups. The uniform init cloud (``scene.uniform_point_init``:
``density * 8 * scale^3`` draws in [-1, 1]^3, kept inside the 1.1x world
box, colour 1.1) is drawn on the device from a ``torch.Generator``.

Nothing here imports the program: the harness hands the arrays to it.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

ALT_RANGE = (-0.35, 0.35)
WV3_PAN = (0.438469, 1.1331377, -0.6794343, 1.0, 0.0016913427)


class Scene(NamedTuple):
    metadatas: List[dict]  # affine_models.json's list, the Nadir camera last
    images: Dict[str, torch.Tensor]  # name -> [3,H,W] float32 on the device
    train_names: List[str]
    test_names: List[str]
    init_xyz: torch.Tensor  # [N,3] float32 on the device
    init_rgb: torch.Tensor  # [N,3]
    heightfield: np.ndarray
    images_pan: Optional[Dict[str, torch.Tensor]] = None  # name -> [1,H,W]

    @property
    def views(self) -> List[dict]:
        """The cameras' metadata (one list also in the MS format)."""
        md = self.metadatas
        return md["msi"] if isinstance(md, dict) else md


def heightfield(res: int, n_buildings: int, rng):
    """[res,res] altitude and [res,res,3] texture (synthetic._heightfield)."""
    z = np.full((res, res), ALT_RANGE[0], np.float32)
    tex = 0.25 + 0.5 * rng.rand(res, res, 3).astype(np.float32) * 0.15
    gx, gy = np.meshgrid(np.linspace(0, 6.28, res), np.linspace(0, 6.28, res))
    tex[..., 0] += 0.15 * np.sin(gx) * np.cos(2 * gy)
    tex[..., 1] += 0.15 * np.cos(2 * gx) * np.sin(gy)
    tex[..., 2] += 0.1 * np.sin(gx + gy)
    for _ in range(n_buildings):
        w = rng.randint(res // 16, res // 5)
        h = rng.randint(res // 16, res // 5)
        x0 = rng.randint(0, res - w)
        y0 = rng.randint(0, res - h)
        hgt = (rng.uniform(0.15, 1.0) * (ALT_RANGE[1] - ALT_RANGE[0])
               + ALT_RANGE[0])
        z[y0:y0 + h, x0:x0 + w] = np.maximum(z[y0:y0 + h, x0:x0 + w], hgt)
        tex[y0:y0 + h, x0:x0 + w] = 0.3 + 0.6 * rng.rand(3)
    return z, np.clip(tex, 0.0, 1.0)


def _sample(field, x, y):
    """Nearest-neighbour lookup of a [-1,1]^2 field ([res,res] or
    [res,res,3]) at world (x, y), as synthetic._sample_field."""
    res = field.shape[0]
    ix = ((x + 1) * 0.5 * (res - 1)).round().long().clamp(0, res - 1)
    iy = ((y + 1) * 0.5 * (res - 1)).round().long().clamp(0, res - 1)
    return field[iy, ix]


def render_view(z, tex, affine, sun_dir, width, height, shadow_dim=0.45,
                n_steps=64):
    """synthetic._render_view on the device: [3,H,W] float32 image."""
    dev = z.device
    A = torch.tensor(affine[:, :3], dtype=torch.float64, device=dev)
    b = torch.tensor(affine[:, 3], dtype=torch.float64, device=dev)
    ainv_t = torch.linalg.inv(A).T
    us = (2 * (torch.arange(width, dtype=torch.float64, device=dev) + 0.5)
          / width) - 1
    vs = (2 * (torch.arange(height, dtype=torch.float64, device=dev) + 0.5)
          / height) - 1
    V, U = torch.meshgrid(vs, us, indexing="ij")
    alts = np.linspace(ALT_RANGE[1], ALT_RANGE[0], n_steps)
    surf = torch.full(U.shape, ALT_RANGE[0], dtype=torch.float32, device=dev)
    found = torch.zeros(U.shape, dtype=torch.bool, device=dev)
    for a in alts:
        uva = torch.stack([U, V, torch.full_like(U, float(a))], -1)
        xyz = (uva - b) @ ainv_t
        zs = _sample(z, xyz[..., 0], xyz[..., 1])
        hit = (~found) & (zs.double() >= a)
        surf = torch.where(hit, zs, surf)
        found |= hit
    uva = torch.stack([U, V, surf.double()], -1)
    xyz = (uva - b) @ ainv_t
    color = _sample(tex, xyz[..., 0], xyz[..., 1])
    lit = torch.ones(U.shape, dtype=torch.bool, device=dev)
    sd = np.asarray(sun_dir, np.float64) / np.linalg.norm(sun_dir)
    if sd[2] < -1e-3:
        sd = -sd
    sd_t = torch.tensor(sd, dtype=torch.float64, device=dev)
    for t in np.linspace(0.02, 2.0, 48):
        p = xyz + float(t) * sd_t
        inside = (p[..., 0].abs() < 1) & (p[..., 1].abs() < 1)
        zs = _sample(z, p[..., 0], p[..., 1])
        lit &= ~(inside & (zs.double() > p[..., 2] + 1e-3))
    shade = torch.where(lit, 1.0, shadow_dim).to(torch.float32)
    return (color * shade[..., None]).permute(2, 0, 1).contiguous()


def make_affine(shear):
    sx, sy = shear
    return np.array([[1.0, 0.0, -sx, 0.0], [0.0, 1.0, -sy, 0.0],
                     [0.0, 0.0, 1.0, 0.0]], np.float64)


def sun_model(A3x4, sun_dir):
    """to_affine.py:79-115 (synthetic.sun_model_from_affine)."""
    A, b = A3x4[:, :3], A3x4[:, 3]
    s = np.asarray(sun_dir, np.float64)
    s = s / (A @ s)[2]
    As = A @ s
    myM = np.array([[1, 0, -As[0]], [0, 1, -As[1]], [0, 0, 1]], np.float64)
    sun_A = myM @ A
    return sun_A, b - sun_A @ np.zeros(3) + A @ np.zeros(3), s, myM


def make_scene(size: dict, seed: int, device) -> Scene:
    """The scene of ``size`` (n_views, width, hf_res, n_buildings, scale,
    density, sun_el_az, modality) from ``seed``, its images and init cloud
    on ``device``; modality "ms" adds each view's panchromatic companion,
    the WV3 combination of its colours (synthetic.with_pan)."""
    n_views, width = size["n_views"], size["width"]
    height, scale = size.get("height", width), float(size["scale"])
    rng = np.random.RandomState(seed % 2**32)
    z_np, tex_np = heightfield(size["hf_res"], size["n_buildings"], rng)
    z = torch.from_numpy(z_np).to(device)
    tex = torch.from_numpy(tex_np).to(device)
    el, az = size.get("sun_el_az", (55.0, 120.0))
    el_r, az_r = math.radians(90 - el), math.radians(az)
    sun_dir = np.array([math.sin(az_r) * math.cos(el_r),
                        math.cos(az_r) * math.cos(el_r), math.sin(el_r)])
    min_world = [-0.85, -0.85, ALT_RANGE[0]]
    max_world = [0.85, 0.85, ALT_RANGE[1]]

    def metadata(name, A, virtual):
        sun_A, sun_b, sdir, myM = sun_model(A, sun_dir)
        return {
            "img": name, "width": width, "height": height,
            "min_alt": float(ALT_RANGE[0]), "max_alt": float(ALT_RANGE[1]),
            "virtual_camera": virtual, "centerofscene_UTM": [0.0, 0.0, 0.0],
            "sun_elevation": el, "sun_azimuth": az,
            "model": {"coef_": A[:, :3].tolist(),
                      "intercept_": A[:, 3].tolist(), "scale": scale,
                      "n": 17, "l": "R", "center": [0.0, 0.0, 0.0],
                      "min_world": min_world, "max_world": max_world},
            "sun_model": {"coef_": sun_A.tolist(),
                          "intercept_": sun_b.tolist(),
                          "sun_dir_ecef": sdir.tolist(),
                          "camera_to_sun": myM.tolist()},
        }

    metadatas, images, train_names, test_names = [], {}, [], []
    for i in range(n_views):
        ang = 2 * np.pi * i / max(n_views, 1)
        mag = 0.25 if i % 3 else 0.12
        A = make_affine((mag * np.cos(ang), mag * np.sin(ang)))
        name = f"view_{i:02d}.tif"
        images[name] = render_view(z, tex, A, sun_dir, width, height)
        metadatas.append(metadata(name, A, False))
        (test_names if i == n_views - 1 else train_names).append(name)
    metadatas.append(metadata("Nadir", make_affine((0.0, 0.0)), True))
    xyz, rgb = init_cloud(min_world, max_world, scale,
                          size.get("density", 0.13), seed, device)
    pan = None
    if size.get("modality", "msi") == "ms":
        w = torch.tensor(WV3_PAN[:3], device=device)
        pan = {k: WV3_PAN[3] * ((v * w[:, None, None]).sum(0, keepdim=True)
                                + WV3_PAN[4]) for k, v in images.items()}
        metadatas = {"msi": metadatas, "pan": metadatas}
    return Scene(metadatas, images, train_names, test_names, xyz, rgb, z_np,
                 pan)


def init_cloud(min_world, max_world, scale, density, seed, device):
    """The uniform init (scene.uniform_point_init's rule) drawn on the
    device: [N,3] points inside the 1.1x world box, colour 1.1."""
    num = int(density * 8.0 * scale ** 3)
    gen = torch.Generator(device=device).manual_seed(seed)
    xyz = torch.rand((num, 3), generator=gen, device=device,
                     dtype=torch.float64) * 2.0 - 1.0
    lo = torch.tensor(min_world, dtype=torch.float64, device=device) * 1.1
    hi = torch.tensor(max_world, dtype=torch.float64, device=device) * 1.1
    xyz = xyz[((xyz > lo) & (xyz < hi)).all(dim=1)].to(torch.float32)
    return xyz, torch.full_like(xyz, 1.1)
