"""The reference training step of the EOGS++ dual-modality ``fixed`` recipe
(``experiments=eogsplus mode=fixed``), in plain PyTorch, float32.

Mode ``fixed`` loads the PAN and the MSI image of every view
(``dataset_MS_affine.py``), and each iteration renders both cameras of one
view (``get_list_cam``, ``utils/camera_utils.py:22-31``): per modality, at
that modality's own size, the main render, the sun render at twice the
footprint resampled onto it, the colour correction and the shadow
(``benchmark.reference.train``'s parts); the PAN camera then takes the fixed
WorldView-3 combination of its shaded colours, 1.0 (0.438469 r + 1.1331377
g - 0.6794343 b + 0.0016913427) (``PAN_affine_cameras.py:73, 129``,
``transf_msi_to_pan.py:5-24``, ``weird_pan_setup`` off). Each modality then
runs its flow phase and its loss terms against its own ground truth (the
MSI's three channels, the PAN's one); the modalities' losses are summed
(``train_pan.py:268-469``) and one Adam step is taken over the shared
leaves, the colour correction shared by the two cameras of a view
(``share_color_correction``).

Departures from the source, as in ``benchmark.reference.train``: the flow
phase is the constant shift by phase correlation (RAFT's stand-in), and the
draws are the program's inputs: per step one uniform [2, 5] background and
one normal [2, 2] shear, one row per modality in the order MSI, PAN. The
source's ``repeat_gt`` and ``weird_pan_setup`` paths are not taken.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from benchmark.reference.render import (TILE, camera, einsum, render,
                                        random_camera, resize_canvas,
                                        sun_camera, uva)
from benchmark.reference.train import (C0, GAUSS_LEAVES, SHADING_LEAVES,
                                       gate, masked_mean, render_virtual,
                                       shift, ssim, warp)

WV3_PAN = (0.438469, 1.1331377, -0.6794343, 1.0, 0.0016913427)
MODALITIES = ("msi", "pan")


def to_pan(image, mode="fixed"):
    """The PAN camera's one channel from the shaded colours [3,H,W]: the
    fixed WV3 combination, or (the check's own fault) their mean."""
    if mode == "average":
        return image.mean(0, keepdim=True)
    w = torch.tensor(WV3_PAN[:3], device=image.device)
    return WV3_PAN[3] * ((w[:, None, None] * image).sum(0, keepdim=True)
                         + WV3_PAN[4])


def modality_loss(g, sh, alive, cam, gt, valid, bg_draw, shear_draw, vi,
                  iteration, recipe, init_count, precision, pan, fault=None,
                  terms=None):
    """The loss of one modality's camera of view ``vi`` at iteration
    ``iteration``; ``pan`` converts the shaded colours to PAN; ``terms``, a
    dict, receives each term before its weight. ``fault`` plants a fault
    for the check's own test: "half_batch" (the photometric terms over the
    top half of the rows only), "altered" (a 16x16 block of the main
    render's colours changed), "pan_average" (the PAN camera converted by
    the mean of its colours in place of the WV3 weights)."""
    r = recipe
    terms = {} if terms is None else terms
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
                  torch.cat([rgb, uva(xyz, cam.affine, precision)[:, 2:3],
                             ones], -1),
                  resize_canvas(cam, wp, hp), bg, wp, hp, precision, alive)
    raw, altitude = main.image[:3], main.image[3]
    if fault == "altered":
        raw = raw + torch.nn.functional.pad(
            torch.full((3, 16, 16), 0.25, device=dev),
            (0, raw.shape[2] - 16, 0, raw.shape[1] - 16))
    u = 2.0 * torch.arange(wp, device=dev) / (wn - 1) - 1.0
    v = 2.0 * torch.arange(hp, device=dev) / (hn - 1) - 1.0
    vv, uu = torch.meshgrid(v, u, indexing="ij")
    rendered_uva = torch.stack([uu, vv, altitude], -1)

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
    if pan:
        image = to_pan(image, "average" if fault == "pan_average" else "fixed")

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
        occ = ((ad.abs() < 0.30) & (new_uv.abs() < 1).all(-1)).to(
            raw.dtype).detach()
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
    return sum(r[k] * t for k, t in terms.items())


def check_recipe(recipe):
    """The recipe this reference computes: both modalities, the fixed WV3
    conversion, one colour correction a view, neither repeat_gt nor
    weird_pan_setup."""
    if not (recipe.get("load_msi") and recipe.get("load_pan")):
        raise ValueError("the dual reference loads both modalities")
    if recipe.get("msi_to_pan_name") != "fixed":
        raise ValueError("the dual reference converts PAN by the fixed WV3 "
                         "weights")
    if recipe.get("repeat_gt") or recipe.get("weird_pan_setup") or \
            not recipe.get("share_color_correction", True):
        raise ValueError("the dual reference shares the colour correction "
                         "and renders PAN as one channel")


def train_reference_dual(scene_md: Dict[str, list],
                         images: Dict[str, list], recipe,
                         iterations: List[int], views, bg_draws, shear_draws,
                         start: dict, extent: float, init_count: float,
                         precision="fp32", fault=None):
    """``benchmark.reference.train.train_reference`` over the two
    modalities: per iteration the sum of the MSI and the PAN camera's loss
    of the view, then one Adam step. ``scene_md`` and ``images`` hold per
    modality the train views' cameras and their GT ([3,h,w] MSI, [1,H,W]
    PAN); ``bg_draws`` and ``shear_draws`` are [2, 5] and [2, 2] a step,
    row 0 the MSI's. Also returns ``terms``: per iteration each
    modality's terms before their weights, as ``<modality>_<weight key>``."""
    check_recipe(recipe)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = start["alive"].device
    cams = {m: [camera(md, dev) for md in scene_md[m]] for m in MODALITIES}
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
    losses, first_grad, step_terms = [], {}, []
    for it in iterations:
        vi = views[it - 1]
        total, named = 0.0, {}
        for j, mod in enumerate(MODALITIES):
            gt = images[mod][vi].clamp(0.0, 1.0)
            terms = {}
            total = total + modality_loss(
                g, sh, alive, cams[mod][vi], gt, torch.ones_like(gt[:1]),
                bg_draws[it - 1][j], shear_draws[it - 1][j], vi, it, recipe,
                init_count, precision, pan=mod == "pan", fault=fault,
                terms=terms)
            named.update({f"{mod}_{k}": float(v.detach())
                          for k, v in terms.items()})
        step_terms.append(named)
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
    return dict(losses=losses, first_grad=first_grad, change=change,
                terms=step_terms)


def draws_dual(seed: int, n_views: int, n_steps: int, device):
    """The Trainer's inputs of its first dual steps from its seed: the view
    of each (a fresh np.random.RandomState(seed) permutation per epoch,
    taken from its end), and per step one uniform [2, 5] background and
    one normal [2, 2] shear from a torch.Generator on the device."""
    rng = np.random.RandomState(seed)
    gen = torch.Generator(device=device).manual_seed(seed)
    stack, views, bgs, shears = [], [], [], []
    for _ in range(n_steps):
        if not stack:
            stack = list(rng.permutation(n_views))
        views.append(int(stack.pop()))
        bgs.append(torch.rand((2, 5), generator=gen, device=device))
        shears.append(torch.randn((2, 2), generator=gen, device=device))
    return views, bgs, shears
