"""Training: the step over one or two modalities, and the Trainer.

Counterpart of ``eogs2_tpu/train.py``; parity target ``train_pan.py:97-811``,
the per-iteration recipe: main render -> sun-camera render resampled onto
it -> shading -> random-camera consistency -> weighted loss sum -> Adam ->
densification statistics and pruning.

  * The step renders on any route of ``rasterize``: the Trainer's default
    is ``RasterizeConfig()``, the ``gather`` mode with the plain dense blend
    (the CLI's ``safe``), as in JAX; ``sorted`` with ``use_pallas`` (the
    CLI's ``fast``) blends with kernel K4, and ``fused`` with K1/K2 (or K3
    with ``payload_col=False``). The trainer always uses the EOGS channel
    layout, so ``eogs_features`` is set.
  * State is a :class:`GaussianModel` (raw parameters as nn.Parameters,
    bookkeeping as buffers) and a :class:`CameraShadingParams` whose leaves
    require grad, with two ``torch.optim.Adam``: the Gaussians' (eps 1e-15,
    one param group per leaf at the JAX ``lr_tree`` rates) and the shading
    parameters' (eps 1e-8, ``camera_lr``). torch's Adam computes optax's
    ``scale_by_adam`` update, m_hat / (sqrt(v_hat) + eps); every leaf gets a
    gradient each step (zeros where the loss does not reach it), so every
    leaf's moments and step count advance as optax's do.
  * The step renders one modality (MSI, or PAN through a ``pan_mode``:
    3PAN's identity, onlyPAN's one channel, average) or two (the dual MS
    ``fixed`` mode: the MSI and the PAN camera of one view), sums their
    losses before one optimizer step and keeps the larger radii.
  * The step takes its random draws as inputs, one row per modality (the
    background's uniform [5] and the random camera's standard-normal [2]);
    the Trainer draws them from its own ``torch.Generator``. JAX draws them
    from keys.
  * The flow-matching phase (the paper's internal camera refinement)
    estimates the gt->render flow of the detached images, warps the render
    and keeps the warp where the criteria accept it, on the device.
  * The densification statistic (viewspace-gradient norm) is the gradient
    of a zero NDC offset of the projected centres, as in JAX.

The dense modes clip at ``tile_capacity`` and ``max_tiles_per_gaussian``,
as in JAX, so the Trainer grows them on JAX's triggers (every 50
iterations: ``tile_capacity`` when the densest tile reaches 95% of it,
``max_tiles_per_gaussian`` when the widest Gaussian exceeds it), each to the
power-of-two bucket of the observed demand, as JAX's reprobe re-sizes to
live demand rather than stepping one bucket; with nothing to recompile, a
grow is a config replace. ``probe_capacities`` sizes the single-tier
capacities (and ``dest_cap``) from the live state; on the a2a path the
grow re-probes, as JAX's does. Not ported: the probe's big tier,
``next_buckets`` and ``prewarm_bucket_ladder`` (compile-cache
warmers), ``early_exit_auto``, ``steps_per_dispatch`` and the step's
``.chunk`` (lax.scan) path.

The Trainer runs every recipe of ``config.PRESETS`` as JAX's does: the
modality modes of ``config._apply_mode`` with pansharpening of the PAN GT,
densification by clone/split with the size prune, the opacity reset with
its Adam-moment surgery (``densify.py``; the split's draws come from the
Trainer's generator), the flow bake into the affines, the colour reset and
``normalize_colors_before_saving`` (``color_ops.py``), early stopping, the
``log_hook``, the ``eval_hook``
every ``testing_interval`` (e.g. the Nadir DSM's MAE,
``pipeline.evaluate_dsm_mae``), ``training_report`` at
``big_testing_iterations``, ``calibrate_opacity_init``, model saves
(``save_model``, at ``save_iterations``) and full checkpoints
(``checkpoint.py``, at ``checkpoint_iterations``; ``restore`` resumes from
one), in JAX's directory layout with a ``torch.save`` file where JAX
writes an orbax directory. Several devices (JAX's ``mesh`` and
``raster_backend``, parallel/): the Trainer keeps its rank's shard of the
Gaussians and the step runs either the one-device step on the joined
shards (``gspmd``) or the all_to_all pair-exchange rasterizer (``a2a``);
``views_per_step`` batches views, split over a "d" mesh axis
(``make_train_step``).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from eogs2_tpu_torch import losses as L
from eogs2_tpu_torch.cameras import AffineCamera
from eogs2_tpu_torch.checkpoint import (restore_checkpoint, save_checkpoint,
                                        state_to_tree)
from eogs2_tpu_torch.color_ops import (apply_color_reset,
                                       normalize_colors_before_saving,
                                       shadow_reset_mask)
from eogs2_tpu_torch.config import TrainConfig
from eogs2_tpu_torch.densify import (apply_prune, densify_clone,
                                     densify_split, prune_mask,
                                     prune_transparent,
                                     reset_densification_stats,
                                     reset_opacity_with_moments)
from eogs2_tpu_torch.device import resolve_device
from eogs2_tpu_torch.flow import (adjust_affine, apply_flow_to_image,
                                  estimate_flow, flow_accept,
                                  phase_correlation_shift)
from eogs2_tpu_torch.io.ply import save_gaussians_ply
from eogs2_tpu_torch.observability import host_read, span
from eogs2_tpu_torch.model import (GaussianModel, GaussianParams,
                                   add_densification_stats, init_from_points)
from eogs2_tpu_torch.ops.projection import TILE
from eogs2_tpu_torch.ops.resample import grid_sample
from eogs2_tpu_torch.ops.sh import SH2RGB
from eogs2_tpu_torch.pansharpen import load_pansharp
from eogs2_tpu_torch.parallel.sharded_raster import rasterize_a2a
from eogs2_tpu_torch.pipeline import evaluate_dsm_mae, render_view_full
from eogs2_tpu_torch.rasterizer import RasterizeConfig, rasterize
from eogs2_tpu_torch.scene import SceneData
from eogs2_tpu_torch.shading import (CameraShadingParams, init_shading_params,
                                     render_pipeline)


@dataclasses.dataclass
class SceneTensors:
    """Per-view constants stacked on the device ([V, ...])."""

    affines: torch.Tensor  # [V,3,4]
    sun_affines: torch.Tensor  # [V,3,4]
    cam2sun: torch.Tensor  # [V,3,3]
    alt_bounds: torch.Tensor  # [V,2]
    images: torch.Tensor  # [V,C,Hp,Wp] zero-padded GT
    image_valid: torch.Tensor  # [V,1,Hp,Wp]
    centerofscene: torch.Tensor  # [3]
    native_wh: Tuple[int, int] = (0, 0)


class Phase(NamedTuple):
    """The step's structure flags (one step function each)."""

    enable_sun: bool = False
    enable_random: bool = False
    learn_pose: bool = False
    enable_flowmatch: bool = False


def _pad_to_tile(img):
    c, h, w = img.shape
    hp = ((h + TILE - 1) // TILE) * TILE
    wp = ((w + TILE - 1) // TILE) * TILE
    out = np.zeros((c, hp, wp), img.dtype)
    out[:, :h, :w] = img
    mask = np.zeros((1, hp, wp), np.float32)
    mask[:, :h, :w] = 1.0
    return out, mask


def build_scene_tensors_from_views(views, repeat_gt: bool = False,
                                   device=None) -> SceneTensors:
    dev = resolve_device(device)
    w0, h0 = views[0].camera.width, views[0].camera.height
    affines, suns, c2s, bounds, imgs, masks = [], [], [], [], [], []
    for v in views:
        if (v.camera.width, v.camera.height) != (w0, h0):
            raise ValueError("all train views must share a size")
        img = v.image
        if img is None:
            raise ValueError(f"train view {v.name} has no image")
        if img.shape[0] == 1 and repeat_gt:
            img = np.repeat(img, 3, axis=0)
        pimg, pmask = _pad_to_tile(img.astype(np.float32))
        imgs.append(pimg)
        masks.append(pmask)
        affines.append(v.camera.affine)
        suns.append(v.camera.sun_affine)
        c2s.append(v.camera.camera_to_sun)
        bounds.append(v.camera.altitude_bounds)

    def stack(xs):
        return torch.stack([x.to(dev) for x in xs])

    return SceneTensors(
        affines=stack(affines),
        sun_affines=stack(suns),
        cam2sun=stack(c2s),
        alt_bounds=stack(bounds),
        images=torch.from_numpy(np.stack(imgs)).to(dev),
        image_valid=torch.from_numpy(np.stack(masks)).to(dev),
        centerofscene=views[0].camera.centerofscene.to(dev, torch.float32),
        native_wh=(w0, h0),
    )


def native_uv_grid(width_native, height_native, width_padded, height_padded,
                   device=None):
    """UV grid in the reference's linspace(-1,1,native) convention, extended
    over the padded canvas (affine_cameras.py:139-143). [Hp,Wp,2]"""
    dev = resolve_device(device)
    u = (2.0 * torch.arange(width_padded, device=dev) / (width_native - 1)) - 1.0
    v = (2.0 * torch.arange(height_padded, device=dev) / (height_native - 1)) - 1.0
    vv, uu = torch.meshgrid(v, u, indexing="ij")
    return torch.stack([uu, vv], dim=-1).to(torch.float32)


def make_gates(cfg: TrainConfig, iteration: int,
               init_count: int) -> Dict[str, np.float32]:
    """0/1 multipliers of the iteration-gated loss terms and gradients."""
    o = cfg.optimization

    def gate(start, end=None):
        on = iteration > start and (end is None or iteration < end)
        return np.float32(1.0 if on else 0.0)

    return {
        "opacity": gate(o.iterstart_L_opacity, o.iterend_L_opacity),
        "opacity_radii": gate(o.iterstart_L_opacity_radii, o.iterend_L_opacity_radii),
        "sun_resample": gate(o.iterstart_L_sun_resample),
        "new_resample": gate(o.iterstart_L_new_resample),
        "tv": gate(o.iterstart_L_TV_altitude),
        "erank": gate(o.iterstart_L_erank),
        "acc_opacity": gate(o.iterstart_L_accumulated_opacity),
        "learn_msitopan": np.float32(
            0.0
            if (o.freeze_start_msitopan_params
                and iteration < o.iterstart_learn_msitopan_params)
            else 1.0
        ),
        "learn_pose": gate(o.iterstart_learn_wv_transform - 1),
        "flowmatch": gate(
            o.iterstart_flowmatching, o.flowmatching.iterend_flowmatching
        ),
        "nll": gate(getattr(o, "iterstart_L_nll", 9_999_999_999)),
        "init_count": np.float32(init_count),
    }


def phase_for_iteration(cfg: TrainConfig, iteration: int) -> Phase:
    o = cfg.optimization
    return Phase(
        enable_sun=iteration > o.iterstart_shadowmapping,
        enable_random=iteration > o.iterstart_L_new_resample,
        learn_pose=cfg.model.camera_params.learn_wv_transform,
        enable_flowmatch=(
            o.flowmatching.apply_flowmatching
            and iteration > o.iterstart_flowmatching
            and iteration < o.flowmatching.iterend_flowmatching
        ),
    )


def gaussian_optimizer(model: GaussianModel, cfg: TrainConfig,
                       spatial_lr_scale: float) -> torch.optim.Adam:
    """Adam over the Gaussian leaves at the JAX lr_tree rates
    (train.py:205-212), eps 1e-15."""
    o = cfg.optimization
    lr = dict(xyz=o.position_lr_init * spatial_lr_scale,
              features_dc=o.feature_lr, features_rest=o.feature_lr / 20.0,
              scaling=o.scaling_lr, rotation=o.rotation_lr,
              opacity=o.opacity_lr)
    return torch.optim.Adam(
        [{"params": [getattr(model, k)], "lr": v} for k, v in lr.items()],
        betas=(0.9, 0.999), eps=1e-15)


def camera_optimizer(shading: CameraShadingParams,
                     cfg: TrainConfig) -> torch.optim.Adam:
    """Adam over the shading leaves at camera_lr, eps 1e-8 (the leaves are
    made to require grad here)."""
    leaves = [getattr(shading, f.name).requires_grad_(True)
              for f in dataclasses.fields(shading)
              if getattr(shading, f.name) is not None]
    return torch.optim.Adam(leaves, lr=cfg.optimization.camera_lr,
                            betas=(0.9, 0.999), eps=1e-8)


class _Gaussians(NamedTuple):
    """The Gaussians' tensors a step reads (the joined shards on gspmd
    with a mesh)."""

    xyz: torch.Tensor
    features_dc: torch.Tensor
    features_rest: torch.Tensor
    scaling: torch.Tensor
    rotation: torch.Tensor
    opacity: torch.Tensor
    alive: torch.Tensor


def make_train_step(
    modalities,  # tuple of (name, SceneTensors, pan_mode | None, shading_idx_off)
    cfg: TrainConfig,
    raster_cfg: RasterizeConfig,
    phase: Phase,
    gauss_opt: torch.optim.Optimizer,
    cam_opt: torch.optim.Optimizer,
    raster_backend: str = "gspmd",
    mesh=None,
) -> Callable:
    """The step for one Phase: step(model, shading, view_idx, bg_draw,
    shear_draw, gates) -> metrics (a dict of 0-d tensors, not synced).

    ``modalities`` lists the cameras rendered per iteration: one entry for
    the single-modality modes, the (msi, pan) pair of view ``view_idx`` for
    the dual MS mode (get_list_cam parity, utils/camera_utils.py:22-31);
    the losses of all entries are summed before the one optimizer step
    (train_pan.py:268-469). bg_draw [M, 5] uniform in [0, 1) (used when
    random_background) and shear_draw [M, 2] standard normal (the random
    camera's draw), one row per modality (a single modality may pass [5]
    and [2]); gates from make_gates. The step updates the model, the
    shading parameters and both optimizers in place.

    ``views_per_step`` > 1 (JAX's vmap over a view batch): ``view_idx`` is
    a list of views and the draws carry a leading view axis ([V, M, 5],
    [V, M, 2], one draw per view); the views' losses are summed, their
    metrics averaged and their radii maxed, as in JAX.

    With a ``mesh`` (parallel.mesh.make_mesh), ``model`` is this rank's
    shard of the Gaussians over "g" (parallel.mesh.shard_gaussian_state):

      * ``raster_backend="gspmd"``: the shards are joined (all_gather, whose
        backward keeps this rank's slice) and the step is the one-device
        step on the whole set, on every rank; JAX lets GSPMD partition the
        one-device step, whose sorts gather.
      * ``raster_backend="a2a"``: every render goes through
        ``parallel.sharded_raster.rasterize_a2a`` (each rank preprocesses
        its shard, blends its band of tile rows); the whole image comes back
        on every rank, which computes the whole loss; the per-Gaussian loss
        terms read the joined arrays; the camera's affine is summed over
        the ranks where it meets this rank's Gaussians. JAX asserts the
        mesh and views_per_step == 1 here (train.py:184, :893); so does
        the port (ValueError).
      * with a "d" axis, each "d" row renders its share of the views
        (view j on row j mod d) and the gradients (Gaussians, shading, the
        densification statistic) are summed over "d".

    The metrics are the same on every rank. On ``a2a`` the step's
    ``max_tile``, ``max_tiles_per_gaussian`` and ``max_dest_count`` are the
    largest over its renders and ``dropped_pairs`` their sum (every render
    clips at ``tile_capacity``, ``max_tiles_per_gaussian`` and
    ``dest_cap`` there); JAX reports the main render's."""
    import torch.distributed as dist

    from eogs2_tpu_torch.parallel.distributed import (all_gather_cat,
                                                      all_reduce_, sum_grad)
    from eogs2_tpu_torch.parallel.mesh import axis_group, axis_rank, axis_size

    o = cfg.optimization
    vps = getattr(o, "views_per_step", 1)
    if raster_backend == "a2a":
        if mesh is None:
            raise ValueError("raster_backend='a2a' needs a mesh")
        if vps > 1:
            raise ValueError("raster_backend='a2a' shards the image over "
                             "the mesh: views_per_step must be 1")
    elif raster_backend != "gspmd":
        raise ValueError(f"unknown raster_backend {raster_backend!r}")
    a2a = raster_backend == "a2a"
    g_group, d_group = axis_group(mesh, "g"), axis_group(mesh, "d")
    n_d, d_rank = axis_size(mesh, "d"), axis_rank(mesh, "d")
    join = mesh is not None and not a2a  # gspmd: the whole set per rank
    cam_params = cfg.model.camera_params
    fm = o.flowmatching
    # the trainer always renders the EOGS channel layout [rgb, alt, 1]
    raster_cfg = dataclasses.replace(raster_cfg, eogs_features=True)

    def build_modality_loss(consts: SceneTensors, pan_mode, idx_off: int):
        wn, hn = consts.native_wh
        hp, wp = consts.images.shape[-2:]
        uv_grid = native_uv_grid(wn, hn, wp, hp, device=consts.images.device)

        def camera_loss(model, sp, m2d_off, view_idx, bg_draw, shear_draw,
                        gates):
            # model: the Gaussians' tensors (a GaussianModel, or the joined
            # shards on gspmd with a mesh)
            vi = view_idx + idx_off
            affine = consts.affines[view_idx]
            if phase.learn_pose:
                affine = torch.cat(
                    [affine[:, :3],
                     (affine[:, 3] + sp.last_row[vi, :3])[:, None]], dim=1)
            cam = AffineCamera(
                affine=affine, sun_affine=consts.sun_affines[view_idx],
                camera_to_sun=consts.cam2sun[view_idx],
                altitude_bounds=consts.alt_bounds[view_idx],
                centerofscene=consts.centerofscene, width=wn, height=hn)
            # a2a: the camera as this rank's Gaussians see it, its affine's
            # gradient summed over the ranks (the rasterizer sums its own)
            cam_g = (cam.replace(affine=sum_grad(cam.affine, g_group))
                     if a2a else cam)

            if o.random_background:
                bg = bg_draw.to(torch.float32).clone()
            else:
                bg = torch.full((5,),
                                1.0 if cfg.model.white_background else 0.0,
                                device=affine.device)
            if o.copy_background_firschan:
                bg[1:3] = bg[0]
            bg[3] = cam.altitude_bounds[0]
            # a Python scalar written into a device tensor waits for the card
            host_read(lambda: bg.__setitem__(4, 0.0), "train.bg_zero")

            # ---- main render (at the padded canvas) ----
            xyz = model.xyz
            rgb = SH2RGB(model.features_dc[:, 0, :])
            alt = cam_g.ecef_to_uva(xyz)[:, 2:3]
            ones = torch.ones_like(alt)
            scaling = torch.exp(model.scaling)
            opacity = torch.sigmoid(model.opacity[:, 0])
            outs = []

            def raster(feats, aff, w, h, off=None):
                if a2a:
                    ro = rasterize_a2a(mesh, xyz, scaling, model.rotation,
                                       opacity, feats, aff, bg, w, h,
                                       raster_cfg, alive=model.alive,
                                       mean2d_ndc_offset=off)
                else:
                    ro = rasterize(xyz, scaling, model.rotation, opacity,
                                   feats, aff, bg, w, h, raster_cfg,
                                   alive=model.alive, mean2d_ndc_offset=off)
                outs.append(ro)
                return ro

            out = raster(torch.cat([rgb, alt, ones], dim=-1),
                         cam.resize_canvas(wp, hp).affine, wp, hp, m2d_off)
            raw_render = out.image[:3]
            altitude = out.image[3]
            acc_opacity = out.image[4]
            rendered_uva = torch.cat([uv_grid, altitude[..., None]], dim=-1)

            def render_virtual(vcam, vcam_g, cam2virt, vw, vh):
                vfeats = torch.cat([rgb, vcam_g.ecef_to_uva(xyz)[:, 2:3],
                                    ones], dim=-1)
                vout = raster(vfeats, vcam.affine, vw, vh)
                v_uv = torch.einsum("ij,hwj->hwi", cam2virt,
                                    rendered_uva)[..., :2]
                samp = grid_sample(vout.image[:4], v_uv, align_corners=True)
                alt_s = torch.where(torch.any(torch.abs(v_uv) > 1.0, dim=-1),
                                    -100.0, samp[3])
                return samp[:3], alt_s, v_uv

            terms = {}
            sun_altitude_diff = None
            if phase.enable_sun:
                sun_cam, cam2sun = cam.sun_camera(f=2)
                sun_g = cam_g.sun_camera(f=2)[0] if a2a else sun_cam
                sw = ((sun_cam.width + TILE - 1) // TILE) * TILE
                sh = ((sun_cam.height + TILE - 1) // TILE) * TILE
                sun_rgb, sun_alt, sun_uv = render_virtual(
                    sun_cam.resize_canvas(sw, sh), sun_g, cam2sun, sw, sh)
                sun_altitude_diff = altitude - sun_alt
                alt_t, rgb_t = L.suncamera_loss(raw_render, sun_rgb,
                                                sun_altitude_diff, sun_uv)
                terms["L_sun_altitude_resample"] = gates["sun_resample"] * alt_t
                terms["L_sun_rgb_resample"] = gates["sun_resample"] * rgb_t

            # ---- shading pipeline ----
            shaded_out = render_pipeline(
                raw_render, sun_altitude_diff, sp.cc_weight[vi],
                sp.cc_bias[vi], sp.inshadow[vi], use_cc=cam_params.use_cc,
                use_shadow=cam_params.use_shadow, exposure=sp.exposure[vi],
                use_exposure=cam_params.use_exposure, pan_mode=pan_mode,
                pan_weight=sp.msi_to_pan_weight[vi],
                pan_bias=sp.msi_to_pan_bias[vi],
                weird_pan_setup=cfg.model.weird_pan_setup)
            image = shaded_out["final"]
            gt_image = consts.images[view_idx]
            valid = consts.image_valid[view_idx]

            # ---- flow matching (internal camera refinement) ----
            # perform_flow_matching parity (flow_matching.py:293-329): the
            # gt->render flow of the detached images, the render warped into
            # the gt frame, kept when the criteria accept it and the gate is
            # open; all on the device, nothing synced
            flow_mag = image.new_zeros(())
            if phase.enable_flowmatch:
                fdx, fdy = estimate_flow(gt_image.detach(), image.detach(),
                                         fm.perform_cst_displacement)
                flow_mag = 0.5 * (torch.mean(torch.abs(fdx))
                                  + torch.mean(torch.abs(fdy)))
                warped = apply_flow_to_image(image, fdx, fdy)
                accept = flow_accept(fm.criteria, flow_mag, image, warped,
                                     gt_image, valid, fm.max_value_flow)
                accept = accept & (gates["flowmatch"] > 0.5)
                image = torch.where(accept, warped, image)

            # ---- random virtual camera consistency ----
            if phase.enable_random:
                new_cam, cam2new = cam.random_camera(shear_draw,
                                                     o.virtual_camera_extent)
                new_g = (cam_g.random_camera(shear_draw,
                                             o.virtual_camera_extent)[0]
                         if a2a else new_cam)
                new_rgb, new_alt, new_uv = render_virtual(
                    new_cam.resize_canvas(wp, hp), new_g, cam2new, wp, hp)
                alt_t, rgb_t = L.randomcam_loss(altitude, new_alt, raw_render,
                                                new_rgb, new_uv)
                terms["L_new_altitude_resample"] = gates["new_resample"] * alt_t
                terms["L_new_rgb_resample"] = gates["new_resample"] * rgb_t

            # ---- scalar regularizers ----
            # (a2a: on the joined shards, whose backward keeps this rank's
            # slice)
            init_count = gates["init_count"]
            if a2a:
                opacity_all, alive_all, radii_all, scaling_all = (
                    all_gather_cat(x, g_group) for x in
                    (opacity, model.alive, out.radii, scaling))
            else:
                opacity_all, alive_all, radii_all, scaling_all = (
                    opacity, model.alive, out.radii, scaling)
            terms["L_opacity"] = gates["opacity"] * L.opacity_loss(
                opacity_all, alive_all, init_count)
            terms["L_opacity_radii"] = gates["opacity_radii"] * \
                L.radii_opacity_loss(opacity_all, radii_all, init_count)
            terms["L_erank"] = gates["erank"] * L.erank_loss(scaling_all,
                                                             alive_all)
            terms["L_TV_altitude"] = gates["tv"] * L.tv_altitude_loss(altitude)
            terms["L_accumulated_opacity"] = gates["acc_opacity"] * \
                L.accumulated_opacity_loss(acc_opacity, valid[0])
            if shaded_out["shadowmap"] is not None:
                terms["L_translucentshadows"] = L.translucent_shadows_loss(
                    shaded_out["shadowmap"], valid[0])
            else:
                terms["L_translucentshadows"] = image.new_zeros(())
            terms["L_nll"] = gates["nll"] * L.transient_nll_loss(
                image, gt_image, sp.transient_mask[vi], mask=valid)
            photometric, ll1 = L.photometric_loss(image, gt_image,
                                                  o.lambda_dssim, mask=valid)
            terms["Lphotometric"] = photometric

            zero = image.new_zeros(())
            total = (
                o.w_L_photometric * terms["Lphotometric"]
                + o.w_L_opacity * terms["L_opacity"]
                + o.w_L_opacity_radii * terms["L_opacity_radii"]
                + o.w_L_sun_altitude_resample
                * terms.get("L_sun_altitude_resample", zero)
                + o.w_L_sun_rgb_resample
                * terms.get("L_sun_rgb_resample", zero)
                + o.w_L_new_altitude_resample
                * terms.get("L_new_altitude_resample", zero)
                + o.w_L_new_rgb_resample
                * terms.get("L_new_rgb_resample", zero)
                + o.w_L_TV_altitude * terms["L_TV_altitude"]
                + o.w_L_erank * terms["L_erank"]
                + o.w_L_translucentshadows * terms["L_translucentshadows"]
                + o.w_L_accumulated_opacity * terms["L_accumulated_opacity"]
                + getattr(o, "w_L_nll", 0.0) * terms["L_nll"]
            )
            with torch.no_grad():
                metrics = {
                    "loss": total.detach(),
                    "flow_mag": flow_mag.detach(),
                    "L1": ll1.detach(),
                    "photometric": photometric.detach(),
                    "psnr": -10.0 * torch.log10(
                        L.masked_mean((image - gt_image) ** 2, valid)
                        + 1e-12),
                    "num_pairs": out.num_pairs,
                    "max_tile": out.max_tile_count,
                    "max_tiles_per_gaussian": out.max_tiles_per_gaussian_seen,
                    "sat_frac": L.masked_mean(
                        (out.final_t < 1e-2).float(), valid[0]),
                    "clipped_pairs": (
                        out.clipped_pairs if out.clipped_pairs is not None
                        else torch.zeros((), dtype=torch.int64,
                                         device=image.device)),
                    **{k: v.detach() for k, v in terms.items()},
                }
                if a2a:
                    metrics.update(
                        max_tile=torch.stack([r.max_tile_count
                                              for r in outs]).max(),
                        max_tiles_per_gaussian=torch.stack([
                            r.max_tiles_per_gaussian_seen
                            for r in outs]).max(),
                        max_dest_count=torch.stack([r.max_dest_count
                                                    for r in outs]).max(),
                        dropped_pairs=torch.stack([r.dropped_pairs
                                                   for r in outs]).sum())
            return total, metrics, out.radii

        return camera_loss

    mod_losses = [(name, build_modality_loss(consts, pan_mode, idx_off))
                  for (name, consts, pan_mode, idx_off) in modalities]
    n_mod = len(mod_losses)

    def view_batch(closs, model, sp, m2d_off, views, bgs, shears, gates):
        """views_per_step > 1: this "d" row's views; the losses summed,
        the metrics averaged over all views and the radii maxed over them
        (over the "d" rows too)."""
        if len(views) < n_d:
            raise ValueError(f"{len(views)} views a step over a \"d\" axis "
                             f"of {n_d}: every row needs a view")
        t, sums, r = None, None, None
        for j in range(d_rank, len(views), n_d):
            tj, mj, rj = closs(model, sp, m2d_off, views[j], bgs[j],
                               shears[j], gates)
            keys = list(mj)
            vec = torch.stack([mj[k].to(torch.float64) for k in keys])
            t = tj if t is None else t + tj
            sums = vec if sums is None else sums + vec
            r = rj if r is None else torch.maximum(r, rj)
        all_reduce_(sums, group=d_group)
        all_reduce_(r, dist.ReduceOp.MAX, d_group)
        means = (sums / len(views)).to(torch.float32)
        return t, dict(zip(keys, means)), r

    def loss_fn(model, sp, m2d_off, view_idx, bg_draws, shear_draws, gates):
        total, metrics, radii = None, {}, None
        for i, (name, closs) in enumerate(mod_losses):
            if isinstance(view_idx, (list, tuple)):
                t, m, r = view_batch(closs, model, sp, m2d_off, view_idx,
                                     bg_draws[:, i], shear_draws[:, i], gates)
            else:
                t, m, r = closs(model, sp, m2d_off, view_idx, bg_draws[i],
                                shear_draws[i], gates)
            total = t if total is None else total + t
            prefix = "" if n_mod == 1 else f"{name}_"
            metrics.update({prefix + k: v for k, v in m.items()})
            radii = r if radii is None else torch.maximum(radii, r)
        if n_mod > 1:
            metrics["loss"] = total.detach()
            for k in ("photometric", "psnr", "L1"):
                metrics[k] = sum(metrics[f"{n}_{k}"]
                                 for n, _ in mod_losses) / n_mod
        return total, metrics, radii

    def step(model: GaussianModel, shading: CameraShadingParams,
             view_idx, bg_draw, shear_draw, gates):
        gates = {k: float(v) for k, v in gates.items()}
        gauss_opt.zero_grad(set_to_none=True)
        cam_opt.zero_grad(set_to_none=True)
        gv = model
        if join:  # the whole set on every rank
            gv = GaussianParams(*(all_gather_cat(getattr(model, f), g_group)
                                  for f in GaussianParams._fields))
            gv = _Gaussians(*gv, alive=all_gather_cat(model.alive, g_group))
        m2d_off = torch.zeros((gv.xyz.shape[0], 2), dtype=torch.float32,
                              device=model.xyz.device, requires_grad=True)
        batched = isinstance(view_idx, (list, tuple))
        lead = (len(view_idx),) if batched else ()
        with span("train.forward"):
            total, metrics, radii = loss_fn(
                gv, shading, m2d_off, view_idx,
                bg_draw.reshape(lead + (n_mod, 5)),
                shear_draw.reshape(lead + (n_mod, 2)), gates)
        with span("train.backward"):
            total.backward()
        if n_d > 1:  # the views' gradients summed over "d"
            for opt in (gauss_opt, cam_opt):
                for group in opt.param_groups:
                    for p in group["params"]:
                        if p.grad is None:
                            p.grad = torch.zeros_like(p)
                        all_reduce_(p.grad, group=d_group)
            all_reduce_(m2d_off.grad, group=d_group)
        # every leaf steps, as in optax (a leaf the loss does not reach
        # gets a zero gradient, so its moments and step count advance)
        for opt in (gauss_opt, cam_opt):
            for group in opt.param_groups:
                for p in group["params"]:
                    if p.grad is None:
                        p.grad = torch.zeros_like(p)
        # freeze gates of the camera parameters (msi_to_pan until its
        # iteration gate, last_row until iterstart_learn_wv_transform)
        shading.msi_to_pan_weight.grad.mul_(gates["learn_msitopan"])
        shading.msi_to_pan_bias.grad.mul_(gates["learn_msitopan"])
        shading.last_row.grad.mul_(gates["learn_pose"])

        g_m2d = m2d_off.grad
        grad_max = g_m2d.abs().max()
        if join:  # back to this rank's slice
            lo = model.xyz.shape[0] * axis_rank(mesh, "g")
            g_m2d = g_m2d[lo:lo + model.xyz.shape[0]]
            radii = radii[lo:lo + model.xyz.shape[0]]
        elif a2a:
            all_reduce_(grad_max, dist.ReduceOp.MAX, g_group)
        if o.optimizer_type == "sparse_adam":
            # only Gaussians visible this step move; moments still advance
            vis = radii > 0
            before = [p.detach().clone() for g in gauss_opt.param_groups
                      for p in g["params"]]
        with span("train.optimizer"):
            gauss_opt.step()
            cam_opt.step()
        if o.optimizer_type == "sparse_adam":
            with torch.no_grad():
                ps = [p for g in gauss_opt.param_groups for p in g["params"]]
                for p, old in zip(ps, before):
                    m = vis.reshape((-1,) + (1,) * (p.dim() - 1))
                    p.copy_(torch.where(m, p, old))
        add_densification_stats(model, g_m2d, radii)
        metrics["grad_m2d_max"] = grad_max
        return metrics

    return step


# the MSI -> PAN conversions of shading.msi_to_pan
PAN_MODES = ("fixed", "identity", "average", "only_one_channel", "learned",
             "fixedandtranslate")


@dataclasses.dataclass
class Trainer:
    """Host-side orchestration on one device: camera sampling, phase
    scheduling, the step over the modalities, densify/prune/reset cadence,
    the flow bake and the colour reset, metrics averaged every
    ``tb_log_interval`` iterations, early stopping, the hooks and, on the
    dense modes, the capacity grow every 50.

    ``Trainer(cfg, scene, raster_cfg).setup().train(n)``; ``device=None``
    means CUDA (raises without it), ``device="cpu"`` runs the plain
    versions of the kernels.

    Hooks: ``log_hook(trainer, metrics, iteration)`` at every logged
    interval, in place of the progress print; ``eval_hook(trainer, model,
    iteration)`` every ``testing_interval`` iterations (JAX passes its
    TrainState as the second argument; the port has none, so it passes the
    GaussianModel, ``trainer.model``). ``report_logger`` (anything with
    ``log_scalars(dict, it)`` and ``log_image(tag, img, it)``) receives
    ``training_report``'s output; with ``mae_computer`` (an
    ``eval.mae.MaeComputer``) set, the report holds the Nadir DSM's MAE.

    Several devices (JAX's ``mesh`` and ``raster_backend``): with ``mesh``
    (parallel.mesh.make_mesh, one rank per card, every rank running the
    same Trainer on the same scene and seed) each rank keeps its shard of
    the Gaussians and their Adam moments over "g" (``_place``), and the
    step is ``make_train_step``'s for ``raster_backend`` ("gspmd" or
    "a2a"). Densification, the hooks, the report, the calibration, the
    flow bake, the colour reset, saves and checkpoints run on the whole
    model, joined from the shards for the call (``whole``), and what they
    change goes back to the shards; so their results are the one-device
    Trainer's. Saves and checkpoints are written by the coordinator (rank
    0) only; every rank takes part in joining them."""

    cfg: TrainConfig
    scene: SceneData
    raster_cfg: RasterizeConfig = RasterizeConfig()
    device: Optional[object] = None
    eval_hook: Optional[Callable] = None
    log_hook: Optional[Callable] = None
    report_logger: Optional[object] = None
    mae_computer: Optional[object] = None
    mesh: Optional[object] = None
    raster_backend: str = "gspmd"

    def _place(self, model):
        """This rank's shard of a whole model (the model itself without a
        mesh)."""
        if self.mesh is None:
            return model
        from eogs2_tpu_torch.parallel.mesh import shard_gaussian_state

        return shard_gaussian_state(model, self.mesh)[0]

    def whole(self) -> "Trainer":
        """This Trainer without a mesh, holding the whole model (the
        shards joined in rank order) and a Gaussian Adam over it with the
        joined moments; everything else is shared with this Trainer. Every
        rank must call it (it gathers). Without a mesh: self."""
        if self.mesh is None:
            return self
        import copy

        from eogs2_tpu_torch.model import GaussianAux
        from eogs2_tpu_torch.parallel.distributed import all_gather_cat
        from eogs2_tpu_torch.parallel.mesh import adam_like, axis_group

        group = axis_group(self.mesh, "g")

        def join(x):
            return all_gather_cat(x.detach(), group)

        with torch.no_grad():
            model = GaussianModel(
                GaussianParams(*(join(getattr(self.model, f))
                                 for f in GaussianParams._fields)),
                GaussianAux(*(join(getattr(self.model, f))
                              for f in GaussianAux._fields)),
                self.model.sh_degree)
            opt = adam_like(self.gauss_opt,
                            [getattr(model, f)
                             for f in GaussianParams._fields], join)
        view = copy.copy(self)
        view.mesh, view.raster_backend = None, "gspmd"
        view.model, view.gauss_opt, view._steps = model, opt, {}
        return view

    @torch.no_grad()
    def _take_shard(self, view: "Trainer") -> None:
        """Copy this rank's rows of ``view``'s (whole's) model and Adam
        moments into the shard, in place, and its step count."""
        from eogs2_tpu_torch.model import GaussianAux
        from eogs2_tpu_torch.parallel.mesh import gauss_range

        lo, hi = gauss_range(view.model.xyz.shape[0], self.mesh)
        for f in GaussianParams._fields + GaussianAux._fields:
            getattr(self.model, f).copy_(getattr(view.model, f)[lo:hi])
        for f in GaussianParams._fields:
            src = view.gauss_opt.state.get(getattr(view.model, f))
            if not src or "exp_avg" not in src:
                continue
            p = getattr(self.model, f)
            st = self.gauss_opt.state[p]
            if "exp_avg" not in st:
                st["step"] = src["step"].clone()
                st["exp_avg"] = torch.zeros_like(p)
                st["exp_avg_sq"] = torch.zeros_like(p)
            st["step"].copy_(src["step"])
            st["exp_avg"].copy_(src["exp_avg"][lo:hi])
            st["exp_avg_sq"].copy_(src["exp_avg_sq"][lo:hi])
        self.step = view.step

    def _on_whole(self, method, *args, write_back: bool = False):
        """``method(whole, *args)``; with ``write_back`` what it changed in
        the model goes back to the shard. Without a mesh: method(self)."""
        if self.mesh is None:
            return method(self, *args)
        view = self.whole()
        out = method(view, *args)
        if write_back:
            self._take_shard(view)
        return out

    def setup(self):
        cfg = self.cfg
        dev = resolve_device(self.device)
        self.device = dev
        # group the views by modality (an MS scene pairs msi and pan per
        # view index)
        msi = [v for v in self.scene.train_views if v.image_type == "msi"]
        pan = [v for v in self.scene.train_views if v.image_type == "pan"]
        # one-time pansharpening of the PAN ground truth
        # (train_pan.py:338-345: gt <- pansharp(pan, msi))
        if cfg.optimization.apply_pansharp and cfg.model.load_pan and pan:
            method = load_pansharp(cfg.optimization.pansharp_method)
            msi_by_name = {v.name: v for v in msi}
            for pv in pan:
                mv = msi_by_name.get(pv.name)
                if mv is not None and pv.image is not None \
                        and mv.image is not None:
                    pv.image = method(pv.image, mv.image).numpy()
        modal = ([("msi", msi)] if cfg.model.load_msi and msi else []) + \
            ([("pan", pan)] if cfg.model.load_pan and pan else [])
        if not modal:
            raise ValueError("no views selected by load_msi/load_pan")
        if len(modal) == 2 and len(msi) != len(pan):
            raise ValueError("unpaired MS views")
        self.modal_views = modal
        self.consts_by_modality = {
            name: build_scene_tensors_from_views(
                views, repeat_gt=cfg.model.repeat_gt and name == "pan",
                device=dev)
            for name, views in modal}
        self.consts = self.consts_by_modality[modal[0][0]]
        n_init = len(self.scene.init_xyz)
        capacity = int(n_init * cfg.model.capacity_headroom)
        capacity = ((capacity + 127) // 128) * 128
        self.model = self._place(init_from_points(
            self.scene.init_xyz, self.scene.init_rgb, capacity=capacity,
            sh_degree=cfg.model.sh_degree,
            opacity_init_value=cfg.model.opacity_init_value, device=dev))
        self.init_count = n_init
        # shading rows: one per view, or one per view and modality without
        # share_color_correction (each modality at its idx_off)
        num_views = len(modal[0][1])
        self._share_cc = cfg.model.share_color_correction
        num_shading = num_views * (1 if self._share_cc or len(modal) == 1
                                   else len(modal))
        transient_hw = (tuple(self.consts.images.shape[-2:])
                        if cfg.model.use_transient else None)
        self.shading = init_shading_params(
            num_shading, transient_hw=transient_hw,
            transient_init=cfg.model.transient_init_value, device=dev)
        # the PAN conversion applies to the pan cameras only; in the
        # single-modality modes every view has the same type
        self.pan_mode = None
        if cfg.model.load_pan and any(v.image_type == "pan"
                                      for v in self.scene.train_views):
            if cfg.model.msi_to_pan_name not in PAN_MODES:
                raise ValueError(f"unknown msi_to_pan_name "
                                 f"{cfg.model.msi_to_pan_name!r}")
            self.pan_mode = cfg.model.msi_to_pan_name
        if self.pan_mode == "fixedandtranslate":
            # the residual starts at zero, so the output is the fixed WV3
            # path's (transf_msi_to_pan.py:134-178, shading.msi_to_pan)
            self.shading.msi_to_pan_weight.zero_()
            self.shading.msi_to_pan_bias.zero_()
        self.gauss_opt = gaussian_optimizer(self.model, cfg,
                                            self.scene.cameras_extent)
        self.cam_opt = camera_optimizer(self.shading, cfg)
        self._steps = {}
        self._view_stack = []
        self.rng = np.random.RandomState(cfg.seed)
        self.generator = torch.Generator(device=dev).manual_seed(cfg.seed)
        self.metrics_history = []
        # one entry per densify event: counts and alive (host ints)
        self.densify_log = []
        self.step = 0  # optimizer steps taken (JAX's TrainState.step)
        return self

    def set_raster_cfg(self, raster_cfg: RasterizeConfig):
        """Render with raster_cfg from the next step on."""
        if raster_cfg != self.raster_cfg:
            self.raster_cfg = raster_cfg
            self._steps = {}  # the steps hold the config they were built with

    def _grow_capacities(self, metrics):
        """The dense modes' capacity grow, checked every 50 iterations on
        the step's main render (one host sync of two scalars): JAX's
        triggers (the densest tile at 95% of tile_capacity, a Gaussian wider
        than max_tiles_per_gaussian), and each capacity re-sized to the
        demand's bucket (RasterizeConfig.bucketed, the densest tile kept
        below 95% of it), never shrunk."""
        rc = self.raster_cfg

        def seen(key):  # the largest over the modalities' main renders
            keys = ([key] if key in metrics
                    else [f"{n}_{key}" for n, _ in self.modal_views])
            return max(float(metrics[k]) for k in keys)

        if self.raster_backend == "a2a":
            return self._grow_a2a(seen)
        if rc.binning_mode == "fused":
            return  # the fused route reads neither capacity

        want = rc.bucketed(seen("max_tile") / 0.95,
                           seen("max_tiles_per_gaussian"))
        self.set_raster_cfg(dataclasses.replace(
            rc, tile_capacity=max(rc.tile_capacity, want.tile_capacity),
            max_tiles_per_gaussian=max(rc.max_tiles_per_gaussian,
                                       want.max_tiles_per_gaussian)))

    def _grow_a2a(self, seen):
        """The a2a path's capacity grow (JAX's rebucket check with
        reprobe_on_grow, train.py:1420-1560): when a render of the step came
        near a capacity (the densest tile at 95% of tile_capacity, a
        Gaussian wider than max_tiles_per_gaussian, a window at 95% of
        dest_cap) or dropped pairs, re-probe every capacity from the live
        state at slack 1.5; dest_cap at least JAX's step (1.5x after a drop,
        else 1.3x the largest window, in multiples of 1024). Nothing
        shrinks."""
        rc = self.raster_cfg
        mdc, ndrop = seen("max_dest_count"), seen("dropped_pairs")
        if not (seen("max_tile") >= 0.95 * rc.tile_capacity
                or seen("max_tiles_per_gaussian") > rc.max_tiles_per_gaussian
                or ndrop > 0 or mdc >= 0.95 * rc.dest_cap):
            return
        if ndrop > 0:
            print(f"WARNING: the a2a exchange dropped {int(ndrop)} pairs "
                  f"(window {int(mdc)} against dest_cap {rc.dest_cap}); "
                  f"growing", flush=True)
        step = (_upm(rc.dest_cap * 1.5, 1024) if ndrop > 0
                else _upm(np.ceil(mdc * 1.3), 1024))
        probed = self.probe_capacities(slack=1.5)
        self.set_raster_cfg(dataclasses.replace(
            probed,
            tile_capacity=max(rc.tile_capacity, probed.tile_capacity),
            max_tiles_per_gaussian=max(rc.max_tiles_per_gaussian,
                                       probed.max_tiles_per_gaussian),
            dest_cap=max(rc.dest_cap, probed.dest_cap, step)))

    @torch.no_grad()
    def probe_capacities(self, slack: float = 1.2) -> RasterizeConfig:
        """Size the capacities that clip on the a2a path and the dense
        modes from the current state, with ``slack`` (JAX's
        probe_capacities, train.py:920-1108, for the single-tier emission
        the port's routes have): tile_capacity above the densest tile (a
        multiple of 512), max_tiles_per_gaussian above the widest
        Gaussian's rect tiles (a power of two, at least 4), and, on the a2a
        path, dest_cap above the largest (source rank, destination band)
        window (a multiple of 128).

        Each train view is preprocessed at the canvas the step renders it
        at, and so is its sun camera when the recipe renders the sun (JAX
        probes the views
        only; the step's sun render is twice their size). The demand is
        counted on the pairs the emission makes, with tile_cull as
        configured (JAX counts the rect rows, unculled). Returns the new
        config, also installed."""
        from eogs2_tpu_torch.ops.binning import grid_dims
        from eogs2_tpu_torch.ops.pair_pipeline import emit_pairs
        from eogs2_tpu_torch.ops.projection import (compute_cov2d_direct,
                                                    preprocess_gaussians)
        import torch.distributed as dist

        from eogs2_tpu_torch.parallel.distributed import all_reduce_
        from eogs2_tpu_torch.parallel.mesh import axis_group, axis_size

        rc, model = self.raster_cfg, self.model
        group = axis_group(self.mesh, "g")
        n = axis_size(self.mesh, "g")
        scaling = torch.exp(model.scaling)
        opacity = torch.sigmoid(model.opacity[:, 0])
        o = self.cfg.optimization
        cams = []
        for v in self.modal_views[0][1]:
            cam = v.camera
            wp = -(-cam.width // TILE) * TILE
            hp = -(-cam.height // TILE) * TILE
            cams.append((cam.resize_canvas(wp, hp), wp, hp))
            if cam.has_sun and o.iterstart_shadowmapping < o.iterations:
                sun = cam.sun_camera(f=2)[0]
                sw = -(-sun.width // TILE) * TILE
                sh = -(-sun.height // TILE) * TILE
                cams.append((sun.resize_canvas(sw, sh), sw, sh))
        max_tile = max_dest = widest = 0
        for cam, w, h in cams:
            cov2d = compute_cov2d_direct(scaling, model.rotation, cam.affine,
                                         w, h)
            prep = preprocess_gaussians(model.xyz, None, opacity, cam.affine,
                                        w, h, alive=model.alive, cov2d=cov2d)
            gx, gy = grid_dims(w, h)
            tile = emit_pairs(prep, gx, tile_cull=rc.tile_cull).tile
            per_tile = torch.bincount(tile, minlength=gx * gy)
            tpb = -(-gy // n) * gx
            per_band = torch.bincount(tile // tpb, minlength=n)
            stats = torch.stack([per_band.max(),
                                 prep.tiles_touched.max().to(torch.int64)])
            all_reduce_(per_tile, group=group)
            all_reduce_(stats, dist.ReduceOp.MAX, group)
            max_tile = max(max_tile, int(per_tile.max()))
            max_dest, widest = (max(max_dest, int(stats[0])),
                                max(widest, int(stats[1])))
        tcap = 4
        while tcap < np.ceil(widest * slack):
            tcap <<= 1
        updates = dict(tile_capacity=_upm(np.ceil(max_tile * slack), 512),
                       max_tiles_per_gaussian=tcap)
        if self.raster_backend == "a2a":
            updates["dest_cap"] = _upm(np.ceil(max_dest * slack), 128)
        self.set_raster_cfg(dataclasses.replace(rc, **updates))
        print(f"probed capacities: K={updates['tile_capacity']} (densest "
              f"tile {max_tile}), tcap={tcap} (widest {widest} tiles)"
              + (f", dest_cap={updates['dest_cap']} (window {max_dest})"
                 if "dest_cap" in updates else ""), flush=True)
        return self.raster_cfg

    def _modalities(self):
        """make_train_step's modalities: (name, SceneTensors, pan_mode,
        shading row offset) per modality."""
        num_views = len(self.modal_views[0][1])
        return tuple(
            (name, self.consts_by_modality[name],
             self.pan_mode if name == "pan" else None,
             0 if (self._share_cc or i == 0) else i * num_views)
            for i, (name, _) in enumerate(self.modal_views))

    def _get_step(self, phase: Phase):
        if phase not in self._steps:
            self._steps[phase] = make_train_step(
                self._modalities(), self.cfg, self.raster_cfg, phase,
                self.gauss_opt, self.cam_opt,
                raster_backend=self.raster_backend, mesh=self.mesh)
        return self._steps[phase]

    @span("train.maintenance")
    def _maintenance(self, iteration: int):
        """Pruning / densification / opacity reset (train_pan.py:672-736),
        in JAX's order (eogs2_tpu/train.py:1184-1232)."""
        o = self.cfg.optimization
        model = self.model
        if iteration < o.densify_until_iter:
            d = o.densification
            if (not o.only_prune and iteration > d.densify_from_iter
                    and iteration % d.densification_interval == 0):
                # moves Gaussians between slots: on the whole model
                self._on_whole(Trainer._densify, iteration, write_back=True)
            prune_transparent(model, o.min_opacity)
        if (o.opacity_reset_interval >= 0
                and iteration % o.opacity_reset_interval == 0
                and iteration < o.iterend_opacity_reset_interval):
            reset_opacity_with_moments(model, self.gauss_opt)

    def _densify(self, iteration: int):
        """One densify event: clone, then split (on the state after the
        clone), then the prune by opacity and size (the size test only past
        the first opacity reset), then fresh densification statistics."""
        o, model = self.cfg.optimization, self.model
        d, extent = o.densification, self.scene.cameras_extent
        with torch.no_grad():
            grads_avg = torch.nan_to_num(
                model.xyz_gradient_accum / model.denom.clamp_min(1e-12))
            alive0 = model.alive.clone()
            n_clone = densify_clone(model, self.gauss_opt, grads_avg,
                                    d.densify_grad_threshold,
                                    o.percent_dense, extent)
            draws = torch.randn((2,) + tuple(model.xyz.shape),
                                generator=self.generator, device=self.device)
            n_split = densify_split(model, self.gauss_opt, grads_avg,
                                    draws[0], draws[1],
                                    d.densify_grad_threshold,
                                    o.percent_dense, extent)
            grown = model.alive.sum()
            size_thr = 20 if iteration > o.opacity_reset_interval else None
            apply_prune(model, prune_mask(model, 0.005, size_thr, extent,
                                          extent))
            reset_densification_stats(model)
            counts = host_read(torch.stack([
                ((grads_avg >= d.densify_grad_threshold) & alive0).sum(),
                alive0.sum(), n_clone, n_split, grown,
                model.alive.sum()]), "densify.counts")
        self.densify_log.append(dict(zip(
            ("iteration", "selected", "alive_before", "cloned", "split",
             "alive_densified", "alive_pruned"), [iteration] + counts)))

    def apply_flowmatching_to_affine(self):
        """Bake each train view's mean gt->render flow into its camera
        affine (adjust_affine_from_flow, flow_matching_toaffine.py:28-92):
        render_view_full of the view, the phase-correlation shift of the GT
        against the render, adjust_affine; the steps are rebuilt with the
        new affines. The first modality's views, whose SceneTensors the
        steps read."""
        name, views = self.modal_views[0]
        consts = self.consts_by_modality[name]
        wn, hn = consts.native_wh
        new_affines = []
        model = self.whole().model
        for vi, view in enumerate(views):
            cam = view.camera.replace(affine=consts.affines[vi])
            out = render_view_full(
                model, cam, self.raster_cfg, shading=self.shading,
                view_idx=vi, with_sun=cam.has_sun, pan_mode=self.pan_mode)
            gt = view.image
            if gt.shape[0] == 1 and self.cfg.model.repeat_gt:
                gt = np.repeat(gt, 3, axis=0)
            final = out["final"][: gt.shape[0]]
            dx, dy = phase_correlation_shift(
                torch.from_numpy(gt).to(self.device),
                torch.from_numpy(final).to(self.device))
            new_affines.append(adjust_affine(consts.affines[vi], wn, hn,
                                             float(dx), float(dy)))
        consts = dataclasses.replace(consts, affines=torch.stack(new_affines))
        self.consts_by_modality[name] = consts
        self.consts = self.consts_by_modality[self.modal_views[0][0]]
        self._steps = {}  # the steps hold the affines they were built with

    def color_reset(self):
        """Reset the Gaussians that lie in shadow in every train view
        (color_reset_op.py:41-88): each view's shadow map from
        render_view_full with its sun, min-pooled and sampled at the
        Gaussians' projected UV (color_ops.py); colour, opacity, scale and
        their Adam moments reset in place."""
        if self.mesh is not None:
            return self._on_whole(Trainer.color_reset, write_back=True)
        shadowmaps, uvs = [], []
        for (_, views), (_, _, pan_mode, idx_off) in zip(self.modal_views,
                                                         self._modalities()):
            for vi, view in enumerate(views):
                if not view.camera.has_sun:
                    continue
                out = render_view_full(
                    self.model, view.camera, self.raster_cfg,
                    shading=self.shading, view_idx=vi + idx_off,
                    with_sun=True, pan_mode=pan_mode)
                if out["shadowmap"] is None:
                    continue
                shadowmaps.append(torch.from_numpy(out["shadowmap"]))
                with torch.no_grad():
                    uvs.append(view.camera.ecef_to_uva(self.model.xyz)[:, :2])
        if not shadowmaps:
            return
        mask = shadow_reset_mask(torch.stack(shadowmaps).to(self.device),
                                 torch.stack(uvs))
        apply_color_reset(self.model, self.gauss_opt, mask)

    def train_step(self, iteration: int) -> Dict[str, torch.Tensor]:
        """One iteration: pick a view (a fresh permutation of the views each
        epoch, from np.random.RandomState(seed) as JAX does), run the step of
        this iteration's phase with its gates and draws, then the
        maintenance (prune, densify, opacity reset). Returns the step's
        metrics as device tensors (nothing synced by the step)."""
        with span("train.step", unit=iteration):
            n_views = len(self.modal_views[0][1])
            vps = min(getattr(self.cfg.optimization, "views_per_step", 1),
                      n_views)
            picked = []
            while len(picked) < max(vps, 1):
                if not self._view_stack:
                    self._view_stack = list(self.rng.permutation(n_views))
                picked.append(int(self._view_stack.pop()))
            view_idx = picked if vps > 1 else picked[0]
            step = self._get_step(phase_for_iteration(self.cfg, iteration))
            gates = make_gates(self.cfg, iteration, self.init_count)
            # the step's random inputs, one row per modality (and per view
            # with views_per_step > 1): the background's uniform [5], the
            # random camera's standard-normal shear [2]
            g, dev, m = self.generator, self.device, len(self.modal_views)
            lead = (vps,) if vps > 1 else ()
            bg_draw = torch.rand(lead + (m, 5), generator=g, device=dev)
            shear_draw = torch.randn(lead + (m, 2), generator=g, device=dev)
            metrics = step(self.model, self.shading, view_idx, bg_draw,
                           shear_draw, gates)
            self.step += 1
            self._maintenance(iteration)
            return metrics

    def train(self, max_iterations: Optional[int] = None,
              progress: bool = True) -> GaussianModel:
        """Run iterations 1..n (cfg.optimization.iterations by default), in
        JAX's order within an iteration: the step and maintenance, the
        capacity grow (every 50), the logged means with the log hook and
        early stopping (every tb_log_interval; a stop breaks before this
        iteration's eval hook), the eval hook, training_report, the model
        save (save_iterations), the checkpoint (checkpoint_iterations, to
        ``<model_path>/chkpnt<iteration>``). After ``restore`` the loop
        runs 1..n again, as JAX's does."""
        o, log = self.cfg.optimization, self.cfg.logging
        iters = max_iterations or o.iterations
        # early stopping (callback_utils.py:1-44): patience counts logged
        # intervals, a zero metric is skipped
        es = o.early_stopping
        best = np.inf if es.operator == "min" else -np.inf
        patience_left = es.patience
        interval: list = []
        t0 = time.time()
        for iteration in range(1, iters + 1):
            interval.append(self.train_step(iteration))
            if iteration % 50 == 0:
                self._grow_capacities(interval[-1])
            if iteration == o.itr_apply_flowmatching_to_affine:
                self.apply_flowmatching_to_affine()
                print("baked flow-matching shifts into camera affines")
            if iteration == o.color_reset_iterations:
                self.color_reset()
                print("color reset applied")
            if iteration % log.tb_log_interval == 0:
                m = mean_metrics(interval)
                m["iteration"] = iteration
                m["alive"] = self.num_alive()
                m["it_per_s"] = log.tb_log_interval / max(time.time() - t0,
                                                          1e-9)
                t0 = time.time()
                interval = []
                self.metrics_history.append(m)
                if self.log_hook:
                    self.log_hook(self, m, iteration)
                elif progress and iteration % (10 * log.tb_log_interval) == 0:
                    print(f"[{iteration:6d}] loss={m['loss']:.4f} "
                          f"photo={m['photometric']:.4f} psnr={m['psnr']:.2f} "
                          f"alive={m['alive']} {m['it_per_s']:.1f} it/s",
                          flush=True)
                if es.use_early_stopping:
                    val = m.get(es.metric_name, 0.0)
                    if val != 0.0:
                        better = (val < best if es.operator == "min"
                                  else val > best)
                        if better:
                            best = val
                            patience_left = es.patience
                        else:
                            patience_left -= 1
                        if patience_left <= 0:
                            print(f"early stopping at iteration {iteration}")
                            break
            if self.eval_hook and iteration % log.testing_interval == 0:
                self.eval_hook(self, self.whole().model, iteration)
            if iteration in (log.big_testing_iterations or ()):
                self.training_report(iteration)
            # mid-run model saves (train_pan.py:622-660)
            if iteration in self.cfg.save_iterations:
                print(f"[ITER {iteration}] saving gaussians", flush=True)
                self.save_model(iteration)
            if iteration == iters and o.normalize_colors_before_saving:
                normalize_colors_before_saving(self.model, self.shading,
                                               reference_idx=0)
                print("baked reference color correction into Gaussian colors")
            if iteration in self.cfg.checkpoint_iterations:
                path = os.path.join(log.model_path, f"chkpnt{iteration}")
                self.save_checkpoint(path, iteration)
                print(f"checkpoint saved: {path}")
        return self.model

    def calibrate_opacity_init(self, target_acc: float = 0.999,
                               iters: int = 12) -> float:
        """Set the alive Gaussians' opacity so that the mean accumulated
        opacity of train view 0's render (no sun) is about ``target_acc``
        (the CLI's ``--opacity-init auto``): a log-space bisection over
        [1e-4, 0.9], ``iters`` renders. Returns the value."""
        if self.mesh is not None:
            return self._on_whole(Trainer.calibrate_opacity_init, target_acc,
                                  iters, write_back=True)
        model = self.model
        cam = self.scene.train_views[0].camera
        saved = model.opacity.detach().clone()

        def mean_acc(op_value):
            with torch.no_grad():
                model.opacity.fill_(float(np.log(op_value / (1.0 - op_value))))
            out = render_view_full(model, cam, self.raster_cfg, with_sun=False)
            return float(np.mean(out["acc_opacity"]))

        lo, hi = 1e-4, 0.9
        for _ in range(iters):
            mid = float(np.sqrt(lo * hi))
            if mean_acc(mid) < target_acc:
                lo = mid
            else:
                hi = mid
        value = float(np.sqrt(lo * hi))
        raw = float(np.log(value / (1.0 - value)))
        with torch.no_grad():
            model.opacity.copy_(torch.where(model.alive[:, None],
                                            saved.new_tensor(raw), saved))
        print(f"calibrated opacity_init_value = {value:.4f} "
              f"(mean acc opacity target {target_acc})")
        return value

    def save_model(self, iteration: Optional[int] = None) -> int:
        """Model save (train_pan.py:622-660): the alive Gaussians' PLY
        (``point_cloud/iteration_N/point_cloud.ply``, the bytes JAX writes
        for the same rows), the shading parameters and the test cameras'
        (``camera_params/iteration_N/{shading,shading_test}``) and the Adam
        moments (``optimizer/iteration_N/adam``: g_mu, g_nu, c_mu, c_nu by
        field), each a torch.save file of CPU tensors where JAX writes an
        orbax directory. N is ``iteration``, else the step count. Returns
        N. With a mesh, the coordinator writes the whole model."""
        it = self.step if iteration is None else int(iteration)
        if self.mesh is not None:
            from eogs2_tpu_torch.parallel.distributed import is_coordinator

            view = self.whole()
            if is_coordinator():
                Trainer.save_model(view, it)
            return it
        root = self.cfg.logging.model_path
        alive = self.model.alive.cpu().numpy()
        p = {f: getattr(self.model, f).detach().cpu().numpy()[alive]
             for f in GaussianParams._fields}
        save_gaussians_ply(
            os.path.join(root, "point_cloud", f"iteration_{it}",
                         "point_cloud.ply"),
            p["xyz"], p["features_dc"], p["features_rest"], p["opacity"],
            p["scaling"], p["rotation"])
        tree = state_to_tree(self)
        cam_dir = os.path.join(root, "camera_params", f"iteration_{it}")
        opt_dir = os.path.join(root, "optimizer", f"iteration_{it}")
        for d in (cam_dir, opt_dir):
            os.makedirs(d, exist_ok=True)
        test_sh = self.test_shading_params()
        torch.save(tree["shading"], os.path.join(cam_dir, "shading"))
        torch.save({f.name: getattr(test_sh, f.name).cpu()
                    for f in dataclasses.fields(test_sh)
                    if getattr(test_sh, f.name) is not None},
                   os.path.join(cam_dir, "shading_test"))
        # JAX drops absent and zero-size moments (orbax refuses them)
        adam = {f"{g}_{m}": {k: v for k, v in tree[f"{g}_opt"][m].items()
                             if v is not None and v.numel() > 0}
                for g in ("g", "c") for m in ("mu", "nu")}
        torch.save(adam, os.path.join(opt_dir, "adam"))
        return it

    def restore(self, path: str) -> int:
        """Resume from a checkpoint written at checkpoint_iterations, with
        the Adam states (train_pan.py:122-124), in place; returns the saved
        iteration. With a mesh, every rank reads the whole file and keeps
        its shard."""
        return self._on_whole(lambda t: restore_checkpoint(path, t),
                              write_back=True)

    def save_checkpoint(self, path: str, iteration: int) -> None:
        """checkpoint.save_checkpoint of the whole Trainer; with a mesh the
        coordinator writes it."""
        from eogs2_tpu_torch.parallel.distributed import is_coordinator

        view = self.whole()
        if is_coordinator():
            save_checkpoint(path, view, iteration)

    def num_alive(self) -> int:
        """The live Gaussians over every shard (one host sync)."""
        n = self.model.alive.sum()
        if self.mesh is not None:
            from eogs2_tpu_torch.parallel.distributed import all_reduce_
            from eogs2_tpu_torch.parallel.mesh import axis_group

            all_reduce_(n, group=axis_group(self.mesh, "g"))
        return int(n)

    def test_shading_params(self) -> CameraShadingParams:
        """Shading parameters for test cameras: the train cameras' colour
        correction converted by ``train_to_test_cc_converter`` ('ref': view
        0's, else their average; convert_color_correction.py), the other
        leaves view 0's with a zero pose residual. One entry, for any test
        view."""
        sh = self.shading
        with torch.no_grad():
            if self.cfg.model.train_to_test_cc_converter == "ref":
                w, b = sh.cc_weight[:1], sh.cc_bias[:1]
            else:  # the mean as jnp.mean rounds it: the sum times 1/V
                inv = 1.0 / sh.cc_weight.shape[0]
                w = sh.cc_weight.sum(0, keepdim=True) * inv
                b = sh.cc_bias.sum(0, keepdim=True) * inv
            fields = {f.name: getattr(sh, f.name)
                      for f in dataclasses.fields(sh)}
            fields = {k: None if v is None else v[:1].detach().clone()
                      for k, v in fields.items()}
            fields.update(cc_weight=w.detach().clone(),
                          cc_bias=b.detach().clone(),
                          last_row=torch.zeros_like(fields["last_row"]))
        return CameraShadingParams(**fields)

    def training_report(self, iteration: int, logger=None,
                        max_images: int = 5) -> Dict[str, float]:
        """Full train/test evaluation report (train_pan.py:838-1025): renders
        every train and test camera through the full shading pipeline (test
        cameras with test_shading_params), logs per-modality L1/PSNR scalars
        and up to ``max_images`` rendered images per split and, with
        ``mae_computer`` set, the Nadir DSM's MAE and its registered DSM and
        |diff| images. ``logger`` (else ``report_logger``) needs
        ``log_scalars`` and ``log_image``. Returns the scalars."""
        if self.mesh is not None:
            return self._on_whole(Trainer.training_report, iteration, logger,
                                  max_images)
        logger = logger if logger is not None else self.report_logger
        test_sh = self.test_shading_params()
        report = {}
        for split in ("train", "test"):
            sums = {}
            n_logged = 0
            for (mname, tviews), (_, _, pan_mode, idx_off) in zip(
                    self.modal_views, self._modalities()):
                views = (tviews if split == "train"
                         else [v for v in self.scene.test_views
                               if v.image_type == mname and not v.is_virtual])
                for vi, view in enumerate(views):
                    if view.image is None:
                        continue
                    out = render_view_full(
                        self.model, view.camera, self.raster_cfg,
                        shading=self.shading if split == "train" else test_sh,
                        view_idx=vi + idx_off if split == "train" else 0,
                        with_sun=view.camera.has_sun, pan_mode=pan_mode)
                    gt = np.clip(view.image, 0.0, 1.0)
                    img = out["final"]
                    c = min(img.shape[0], gt.shape[0])
                    h = min(img.shape[1], gt.shape[1])
                    w = min(img.shape[2], gt.shape[2])
                    img, gt = img[:c, :h, :w], gt[:c, :h, :w]
                    mse = float(np.mean((img - gt) ** 2))
                    l1, ps, n = sums.get(mname, (0.0, 0.0, 0))
                    sums[mname] = (l1 + float(np.mean(np.abs(img - gt))),
                                   ps + float(-10.0 * np.log10(mse + 1e-12)),
                                   n + 1)
                    if logger is not None and n_logged < max_images:
                        tag = f"{split}_v_{view.name[:5]}_{mname}"
                        logger.log_image(f"{tag}/render", img, iteration)
                        logger.log_image(f"{tag}/ground_truth", gt,
                                         iteration)
                        n_logged += 1
            for mname, (l1, ps, n) in sums.items():
                if n:
                    report[f"{split}/l1_loss_{mname}"] = l1 / n
                    report[f"{split}/psnr_{mname}"] = ps / n
        # the registered DSM and its |diff| against the ground truth
        # (train_pan.py:966-1023)
        if self.mae_computer is not None:
            mae, _, diff, rdsm = evaluate_dsm_mae(
                self.model, self.scene, self.mae_computer, self.raster_cfg)
            report["report/MAE"] = float(mae)
            if logger is not None:
                for tag, arr in (("RDSM", rdsm), ("abs_diff", np.abs(diff))):
                    a = np.asarray(arr, np.float32)
                    finite = np.isfinite(a)
                    lo = np.nanmin(a[finite]) if finite.any() else 0.0
                    hi = np.nanmax(a[finite]) if finite.any() else 1.0
                    norm = np.where(finite, (a - lo) / max(hi - lo, 1e-9),
                                    0.0)
                    logger.log_image(f"report/{tag}", norm[None], iteration)
        if logger is not None:
            logger.log_scalars(report, iteration)
        if report:
            pretty = {k: round(v, 4) for k, v in report.items()}
            print(f"[ITER {iteration}] report: {pretty}", flush=True)
        return report


def _upm(x, m: int) -> int:
    """x rounded up to a multiple of m, at least m."""
    return max(m, ((int(x) + m - 1) // m) * m)


def mean_metrics(steps) -> Dict[str, float]:
    """Per-key means of a list of step metrics, read with one host sync."""
    keys = list(steps[0])
    vals = torch.stack([torch.stack([m[k].to(torch.float64) for k in keys])
                        for m in steps]).mean(0).cpu().numpy()
    return dict(zip(keys, (float(x) for x in vals)))
