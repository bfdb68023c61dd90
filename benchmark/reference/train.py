"""The reference training step of the baseogs recipe (train_pan.py's
iteration on one MSI view) and its Adam, in plain PyTorch.

One step: the main render at the padded canvas; the sun render at twice the
footprint, resampled onto the main view (its altitude gives the shadow
map); the colour correction and the shadow; the random virtual camera's
render, resampled; the losses (photometric (1 - l) L1 + l (1 - SSIM), the
opacity sum over the init count, the random camera's consistency under its
occlusion mask, the sun camera's, the translucent-shadow entropy), each
with its weight and iteration gate; autograd; Adam on every leaf (eps 1e-15
on the Gaussians, 1e-8 on the shading); the prune of raw opacities below
``min_opacity``. The recipe's numbers come from the configuration's file.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.render import (TILE, camera, einsum, mean_knn_dist2,
                                        random_camera, render, resize_canvas,
                                        sun_camera, uva)

C0 = 0.28209479177387814
GAUSS_LEAVES = ("xyz", "features_dc", "scaling", "rotation", "opacity")
SHADING_LEAVES = ("cc_weight", "cc_bias", "inshadow")


def ssim(a, b, mask, precision):
    """Mean SSIM (11x11, sigma 1.5, zero 'same' padding) over the mask."""
    xs = torch.arange(11, dtype=a.dtype, device=a.device) - 5
    g = torch.exp(-(xs ** 2) / (2.0 * 1.5 ** 2))
    g = g / g.sum()
    win = (g[:, None] * g[None, :])[None, None].expand(a.shape[0], 1, 11, 11)

    def conv(x):
        if precision == "tf32":
            from benchmark.reference.render import tf32
            return F.conv2d(tf32(x)[None], tf32(win.contiguous()), padding=5,
                            groups=x.shape[0])[0]
        return F.conv2d(x[None], win, padding=5, groups=x.shape[0])[0]

    mu1, mu2 = conv(a), conv(b)
    s1 = conv(a * a) - mu1 * mu1
    s2 = conv(b * b) - mu2 * mu2
    s12 = conv(a * b) - mu1 * mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    m = ((2 * mu1 * mu2 + c1) * (2 * s12 + c2)) / (
        (mu1 * mu1 + mu2 * mu2 + c1) * (s1 + s2 + c2))
    mk = torch.broadcast_to(mask, m.shape)
    return (m * mk).sum() / mk.sum().clamp_min(1.0)


def shift(ref, mov):
    """The constant gt -> render flow (dx, dy) by phase correlation (the
    flow phase's RAFT-small stand-in): the grey images' mean removed, a Hann
    window, the normalised cross-power spectrum, its peak and a 3-point
    parabola through it on each axis."""
    a, b = ref.mean(0), mov.mean(0)
    h, w = a.shape

    def hann(n):
        i = torch.arange(n, dtype=torch.float32, device=a.device)
        return 0.5 - 0.5 * torch.cos(2 * math.pi * i / (n - 1))

    win = hann(h)[:, None] * hann(w)[None, :]
    cross = torch.fft.rfft2((a - a.mean()) * win) * torch.conj(
        torch.fft.rfft2((b - b.mean()) * win))
    corr = torch.fft.irfft2(cross / cross.abs().clamp_min(1e-12), s=(h, w))
    peak = int(torch.argmax(corr))
    py, px = peak // w, peak % w

    def sub(cm, c0, cp):
        d = float(cm - 2 * c0 + cp)
        return 0.5 * float(cm - cp) / d if abs(d) > 1e-12 else 0.0

    dy = (py - h if py > h // 2 else py) + sub(
        corr[(py - 1) % h, px], corr[py, px], corr[(py + 1) % h, px])
    dx = (px - w if px > w // 2 else px) + sub(
        corr[py, (px - 1) % w], corr[py, px], corr[py, (px + 1) % w])
    return -dx, -dy


def warp(img, fx, fy):
    """img sampled at (pixel + flow), border padding, align_corners."""
    _, h, w = img.shape
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32,
                                         device=img.device),
                            torch.arange(w, dtype=torch.float32,
                                         device=img.device), indexing="ij")
    gx = torch.clamp(xx + fx, 0.0, w - 1.0) * (2.0 / (w - 1)) - 1.0
    gy = torch.clamp(yy + fy, 0.0, h - 1.0) * (2.0 / (h - 1)) - 1.0
    return F.grid_sample(img[None], torch.stack([gx, gy], -1)[None],
                         mode="bilinear", padding_mode="zeros",
                         align_corners=True)[0]


def masked_mean(x, mask):
    mk = torch.broadcast_to(mask, x.shape)
    return (x * mk).sum() / mk.sum().clamp_min(1.0)


def init_state(xyz, rgb, recipe, device) -> Dict[str, torch.Tensor]:
    """The Gaussians of create_from_pcd: isotropic log-scale of the root
    mean 3-NN squared distance, identity rotation, the init opacity."""
    n = xyz.shape[0]
    d2 = torch.clamp_min(mean_knn_dist2(xyz), 1e-7)
    v = float(recipe["opacity_init_value"])
    return dict(
        xyz=xyz.clone(),
        features_dc=((rgb - 0.5) / C0)[:, None, :].clone(),
        scaling=torch.log(torch.sqrt(d2))[:, None].repeat(1, 3),
        rotation=torch.tensor([1.0, 0.0, 0.0, 0.0], device=device).repeat(n, 1),
        opacity=torch.full((n, 1), math.log(v / (1.0 - v)), device=device),
    )


def init_shading(n_views, device):
    return dict(cc_weight=torch.eye(3, device=device).repeat(n_views, 1, 1),
                cc_bias=torch.zeros((n_views, 3), device=device),
                inshadow=torch.full((n_views, 3), 0.05, device=device))


def gate(recipe, key, iteration):
    return 1.0 if iteration > recipe[key] else 0.0


def render_virtual(xyz, scaling, rot, opac, rgb, vcam, cam2virt, vw, vh,
                   rendered_uva, bg, alive, precision):
    """A virtual camera's render resampled onto the main view: (rgb [3],
    altitude with -100 outside [H,W], the resampling grid [H,W,2])."""
    feats = torch.cat([rgb, uva(xyz, vcam.affine, precision)[:, 2:3],
                       torch.ones_like(rgb[:, :1])], -1)
    out = render(xyz, scaling, rot, opac, feats, resize_canvas(vcam, vw, vh),
                 bg, vw, vh, precision, alive)
    v_uv = einsum("ij,hwj->hwi", cam2virt, rendered_uva, precision)[..., :2]
    samp = F.grid_sample(out.image[:4][None], v_uv[None], mode="bilinear",
                         padding_mode="zeros", align_corners=True)[0]
    alt = torch.where((v_uv.abs() > 1.0).any(-1), -100.0, samp[3])
    return samp[:3], alt, v_uv


def step_loss(g, sh, alive, cam, gt, valid, bg_draw, shear_draw, vi,
              iteration, recipe, init_count, precision, fault=None):
    """The total loss of one iteration on view ``vi``. ``fault`` plants a
    fault for the check's own test: "half_batch" (the photometric terms
    over the top half of the rows only), "altered" (a 16x16 block of the
    main render's colours changed where it is produced)."""
    r = recipe
    wn, hn = cam.width, cam.height
    wp, hp = -(-wn // TILE) * TILE, -(-hn // TILE) * TILE
    dev = g["xyz"].device
    bg = bg_draw.clone()
    bg[3] = cam.alt_min
    bg[4] = 0.0
    xyz = g["xyz"]
    rgb = g["features_dc"][:, 0, :] * C0 + 0.5
    scaling = torch.exp(g["scaling"])
    opac = torch.sigmoid(g["opacity"][:, 0])
    rot = g["rotation"]
    ones = torch.ones_like(rgb[:, :1])
    main = render(xyz, scaling, rot, opac,
                  torch.cat([rgb, uva(xyz, cam.affine, precision)[:, 2:3], ones], -1),
                  resize_canvas(cam, wp, hp), bg, wp, hp, precision, alive)
    raw, altitude, acc = main.image[:3], main.image[3], main.image[4]
    if fault == "altered":
        raw = raw + torch.nn.functional.pad(
            torch.full((3, 16, 16), 0.25, device=dev),
            (0, raw.shape[2] - 16, 0, raw.shape[1] - 16))
    u = 2.0 * torch.arange(wp, device=dev) / (wn - 1) - 1.0
    v = 2.0 * torch.arange(hp, device=dev) / (hn - 1) - 1.0
    vv, uu = torch.meshgrid(v, u, indexing="ij")
    rendered_uva = torch.stack([uu, vv, altitude], -1)

    terms = {}
    smap = None
    if gate(r, "iterstart_shadowmapping", iteration):
        scam, cam2sun = sun_camera(cam, 2)
        sw = -(-scam.width // TILE) * TILE
        shh = -(-scam.height // TILE) * TILE
        sun_rgb, sun_alt, sun_uv = render_virtual(
            xyz, scaling, rot, opac, rgb, scam, cam2sun, sw, shh,
            rendered_uva, bg, alive, precision)
        diff = altitude - sun_alt
        smap = torch.exp(0.4 * torch.clamp_max(diff, 0.0))
        if gate(r, "iterstart_L_sun_resample", iteration):
            vis = ((diff > -1e-2) & (sun_uv.abs() < 1).all(-1)).to(raw.dtype)
            den = vis.sum().clamp_min(1.0)
            terms["w_L_sun_altitude_resample"] = (diff.abs() * vis).sum() / den
            terms["w_L_sun_rgb_resample"] = (
                (raw - sun_rgb).abs() * vis).sum() / den

    cc = einsum("ck,khw->chw", sh["cc_weight"][vi], raw, precision) \
        + sh["cc_bias"][vi][:, None, None]
    image = cc
    if smap is not None:
        image = smap[None] * cc + (1.0 - smap[None]) \
            * sh["inshadow"][vi][:, None, None] * cc
        b = torch.clamp(smap, 0.05, 0.95)
        ent = -(smap * torch.log2(b) + (1.0 - smap) * torch.log2(1.0 - b))
        terms["w_L_translucentshadows"] = masked_mean(ent, valid[0])

    if r.get("load_pan") and not r.get("load_msi", True):
        if r["msi_to_pan_name"] != "identity":
            raise ValueError("the reference renders PAN as the identity")
    fm = r.get("flowmatching", {})
    if fm.get("apply_flowmatching") and iteration > r["iterstart_flowmatching"] \
            and iteration < fm["iterend_flowmatching"]:
        if not fm["perform_cst_displacement"] or \
                fm["criteria"] != "max_value_flow":
            raise ValueError("the reference's flow phase is the constant "
                             "shift under max_value_flow")
        fx, fy = shift(gt, image.detach())
        if 0.5 * (abs(fx) + abs(fy)) < fm["max_value_flow"]:
            image = warp(image, fx, fy)

    if gate(r, "iterstart_L_new_resample", iteration):
        ncam, cam2new = random_camera(cam, shear_draw,
                                      r["virtual_camera_extent"])
        new_rgb, new_alt, new_uv = render_virtual(
            xyz, scaling, rot, opac, rgb, ncam, cam2new, wp, hp,
            rendered_uva, bg, alive, precision)
        ad = altitude - new_alt
        occ = ((ad.abs() < 0.30) & (new_uv.abs() < 1).all(-1)).to(raw.dtype).detach()
        den = occ.sum().clamp_min(1.0)
        terms["w_L_new_altitude_resample"] = (ad.abs() * occ).sum() / den
        terms["w_L_new_rgb_resample"] = ((raw - new_rgb).abs() * occ).sum() / den

    if gate(r, "iterstart_L_opacity", iteration) and \
            iteration < r["iterend_L_opacity"]:
        terms["w_L_opacity"] = torch.where(alive, opac, 0.0).sum() / init_count
    if fault == "half_batch":
        half = image.shape[1] // 2
        image, gt, valid = image[:, :half], gt[:, :half], valid[:, :half]
    l1 = masked_mean((image - gt).abs(), valid)
    lam = r["lambda_dssim"]
    terms["w_L_photometric"] = (1.0 - lam) * l1 + lam * (
        1.0 - ssim(image * valid, gt * valid, valid, precision))
    for key in r["unsupported_terms_must_be_off"]:
        if r[key] != 0.0:
            raise ValueError(f"the reference has no {key}")
    return sum(r[k] * t for k, t in terms.items()), acc


def init_start(xyz, rgb, recipe, n_views, device) -> dict:
    """The state before the first iteration: the init Gaussians and
    shading, Adam's moments at zero, no step taken, every Gaussian alive."""
    leaves = {**init_state(xyz, rgb, recipe, device),
              **init_shading(n_views, device)}
    return dict(leaves=leaves,
                m={k: torch.zeros_like(v) for k, v in leaves.items()},
                s2={k: torch.zeros_like(v) for k, v in leaves.items()},
                t={k: 0 for k in leaves},
                alive=torch.ones(xyz.shape[0], dtype=torch.bool,
                                 device=device))


def train_reference(scene_md, images, recipe, iterations: List[int], views,
                    bg_draws, shear_draws, start: dict, extent: float,
                    init_count: float, precision="fp32", fault=None):
    """The iterations ``iterations`` (in order) from the state ``start``
    (leaves, Adam's moments ``m`` and ``s2``, its step counts ``t``, the
    alive mask): per iteration its loss; the first iteration's gradient of
    every leaf; every leaf's change after the last. ``views``,
    ``bg_draws``, ``shear_draws`` are indexed by iteration - 1; ``views``
    index the train views, ``images`` their [3,H,W] GT."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = start["alive"].device
    cams = [camera(md, dev) for md in scene_md]
    leaves = {k: v.detach().clone() for k, v in start["leaves"].items()}
    g = {k: leaves[k] for k in GAUSS_LEAVES}
    sh = {k: leaves[k] for k in SHADING_LEAVES}
    for v in leaves.values():
        v.requires_grad_(True)
    lr = dict(xyz=recipe["position_lr_init"] * extent,
              features_dc=recipe["feature_lr"], scaling=recipe["scaling_lr"],
              rotation=recipe["rotation_lr"], opacity=recipe["opacity_lr"],
              **{k: recipe["camera_lr"] for k in SHADING_LEAVES})
    eps = {k: (1e-15 if k in GAUSS_LEAVES else 1e-8) for k in leaves}
    m = {k: start["m"][k].clone() for k in leaves}
    s2 = {k: start["s2"][k].clone() for k in leaves}
    t = dict(start["t"])
    alive = start["alive"].clone()
    losses, first_grad = [], {}
    for it in iterations:
        vi = views[it - 1]
        cam = cams[vi]
        gt = images[vi].clamp(0.0, 1.0)
        valid = torch.ones_like(gt[:1])
        total, _ = step_loss(g, sh, alive, cam, gt, valid, bg_draws[it - 1],
                             shear_draws[it - 1], vi, it, recipe, init_count,
                             precision, fault)
        grads = torch.autograd.grad(total, list(leaves.values()),
                                    allow_unused=True)
        losses.append(float(total.detach()))
        with torch.no_grad():
            for (k, p), gr in zip(leaves.items(), grads):
                gr = torch.zeros_like(p) if gr is None else gr
                if it == iterations[0]:
                    first_grad[k] = gr.clone()
                t[k] += 1
                m[k].mul_(0.9).add_(gr, alpha=0.1)
                s2[k].mul_(0.999).addcmul_(gr, gr, value=0.001)
                bc1, bc2 = 1 - 0.9 ** t[k], 1 - 0.999 ** t[k]
                den = (s2[k].sqrt() / math.sqrt(bc2)).add_(eps[k])
                p.addcdiv_(m[k], den, value=-lr[k] / bc1)
            alive &= ~(g["opacity"][:, 0] < recipe["min_opacity"])
    change = {k: (v.detach() - start["leaves"][k]) for k, v in leaves.items()}
    return dict(losses=losses, first_grad=first_grad, change=change)


def cameras_extent(xyz):
    """scene.build_scene's extent: twice the largest distance to the mean."""
    x = xyz.double()
    return float(torch.linalg.norm(x - x.mean(0), dim=1).max() * 2.0)


def draws(seed: int, n_views: int, n_steps: int, device):
    """The Trainer's inputs of its first steps from its seed: the view of
    each (a fresh np.random.RandomState(seed) permutation per epoch, taken
    from its end), and per step one uniform [5] background and one normal
    [2] shear from a torch.Generator on the device."""
    rng = np.random.RandomState(seed)
    gen = torch.Generator(device=device).manual_seed(seed)
    stack, views, bgs, shears = [], [], [], []
    for _ in range(n_steps):
        if not stack:
            stack = list(rng.permutation(n_views))
        views.append(int(stack.pop()))
        bgs.append(torch.rand((1, 5), generator=gen, device=device)[0])
        shears.append(torch.randn((1, 2), generator=gen, device=device)[0])
    return views, bgs, shears
