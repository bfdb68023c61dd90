"""Training: the baseogs step and a lean Trainer.

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
  * The step takes its random draws as inputs (the background's uniform
    [5] and the random camera's standard-normal [2]); the Trainer draws
    them from its own ``torch.Generator``. JAX draws them from keys.
  * The densification statistic (viewspace-gradient norm) is the gradient
    of a zero NDC offset of the projected centres, as in JAX.

The dense modes clip at ``tile_capacity`` and ``max_tiles_per_gaussian``,
as in JAX, so the Trainer grows them on JAX's triggers (every 50
iterations: ``tile_capacity`` when the densest tile reaches 95% of it,
``max_tiles_per_gaussian`` when the widest Gaussian exceeds it), each to the
power-of-two bucket of the observed demand, as JAX's reprobe re-sizes to
live demand rather than stepping one bucket; with nothing to recompile, a
grow is a config replace. Not ported: ``probe_capacities`` itself (ROADMAP
Queue 3), ``next_buckets`` and ``prewarm_bucket_ladder`` (compile-cache
warmers), ``early_exit_auto``, ``steps_per_dispatch`` and the step's
``.chunk`` (lax.scan) path.

The Trainer runs the rest of the single-modality recipe as JAX's does:
densification by clone/split with the size prune, the opacity reset with
its Adam-moment surgery (``densify.py``; the split's draws come from the
Trainer's generator), early stopping, the ``log_hook``, the ``eval_hook``
every ``testing_interval`` (e.g. the Nadir DSM's MAE,
``pipeline.evaluate_dsm_mae``), ``training_report`` at
``big_testing_iterations``, and ``calibrate_opacity_init``.
Still to port (ROADMAP Queue 1): flow matching, colour reset, PAN
modalities and pansharpening (item 9); checkpoints and model saves (item
12); the multi-device backends (item 13). The Trainer raises
NotImplementedError when a config asks for one of them.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from eogs2_tpu_torch import losses as L
from eogs2_tpu_torch.cameras import AffineCamera
from eogs2_tpu_torch.config import TrainConfig
from eogs2_tpu_torch.densify import (apply_prune, densify_clone,
                                     densify_split, prune_mask,
                                     prune_transparent,
                                     reset_densification_stats,
                                     reset_opacity_with_moments)
from eogs2_tpu_torch.device import resolve_device
from eogs2_tpu_torch.model import (GaussianModel, add_densification_stats,
                                   init_from_points)
from eogs2_tpu_torch.ops.projection import TILE
from eogs2_tpu_torch.ops.resample import grid_sample
from eogs2_tpu_torch.ops.sh import SH2RGB
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


def make_train_step(
    modalities,  # tuple of (name, SceneTensors, pan_mode | None, shading_idx_off)
    cfg: TrainConfig,
    raster_cfg: RasterizeConfig,
    phase: Phase,
    gauss_opt: torch.optim.Optimizer,
    cam_opt: torch.optim.Optimizer,
    raster_backend: str = "gspmd",
) -> Callable:
    """The step for one Phase: step(model, shading, view_idx, bg_draw,
    shear_draw, gates) -> metrics (a dict of 0-d tensors, not synced).

    One modality on one device: bg_draw [5] uniform in [0, 1) (used when
    random_background), shear_draw [2] standard normal (the random camera's
    draw), gates from make_gates. The step updates the model, the shading
    parameters and both optimizers in place."""
    o = cfg.optimization
    if len(modalities) != 1 or modalities[0][2] is not None:
        raise NotImplementedError(
            "the port trains one modality without PAN conversion so far; "
            "the PAN and dual MS modalities are ROADMAP Queue 1 item 9")
    if phase.enable_flowmatch:
        raise NotImplementedError(
            "flow matching is ROADMAP Queue 1 item 9 (eogs2_tpu/flow.py)")
    if getattr(o, "views_per_step", 1) > 1:
        raise NotImplementedError(
            "views_per_step > 1 is not ported (a TPU batching extension; "
            "ROADMAP Queue 1 item 13 with the multi-device step)")
    if raster_backend != "gspmd":
        raise NotImplementedError(
            f"raster_backend={raster_backend!r}: the multi-device path is "
            f"ROADMAP Queue 1 item 13")
    cam_params = cfg.model.camera_params
    # the trainer always renders the EOGS channel layout [rgb, alt, 1]
    raster_cfg = dataclasses.replace(raster_cfg, eogs_features=True)
    _, consts, pan_mode, idx_off = modalities[0]
    wn, hn = consts.native_wh
    hp, wp = consts.images.shape[-2:]
    uv_grid = native_uv_grid(wn, hn, wp, hp, device=consts.images.device)

    def camera_loss(model, sp, m2d_off, view_idx, bg_draw, shear_draw, gates):
        vi = view_idx + idx_off
        affine = consts.affines[view_idx]
        if phase.learn_pose:
            affine = torch.cat(
                [affine[:, :3], (affine[:, 3] + sp.last_row[vi, :3])[:, None]],
                dim=1)
        cam = AffineCamera(
            affine=affine, sun_affine=consts.sun_affines[view_idx],
            camera_to_sun=consts.cam2sun[view_idx],
            altitude_bounds=consts.alt_bounds[view_idx],
            centerofscene=consts.centerofscene, width=wn, height=hn)

        if o.random_background:
            bg = bg_draw.to(torch.float32).clone()
        else:
            bg = torch.full((5,), 1.0 if cfg.model.white_background else 0.0,
                            device=affine.device)
        if o.copy_background_firschan:
            bg[1:3] = bg[0]
        bg[3] = cam.altitude_bounds[0]
        bg[4] = 0.0

        # ---- main render (at the padded canvas) ----
        xyz = model.xyz
        rgb = SH2RGB(model.features_dc[:, 0, :])
        alt = cam.ecef_to_uva(xyz)[:, 2:3]
        ones = torch.ones_like(alt)
        scaling = torch.exp(model.scaling)
        opacity = torch.sigmoid(model.opacity[:, 0])

        def raster(feats, aff, w, h, off=None):
            return rasterize(xyz, scaling, model.rotation, opacity, feats,
                             aff, bg, w, h, raster_cfg, alive=model.alive,
                             mean2d_ndc_offset=off)

        out = raster(torch.cat([rgb, alt, ones], dim=-1),
                     cam.resize_canvas(wp, hp).affine, wp, hp, m2d_off)
        raw_render = out.image[:3]
        altitude = out.image[3]
        acc_opacity = out.image[4]
        rendered_uva = torch.cat([uv_grid, altitude[..., None]], dim=-1)

        def render_virtual(vcam, cam2virt, vw, vh):
            vfeats = torch.cat([rgb, vcam.ecef_to_uva(xyz)[:, 2:3], ones],
                               dim=-1)
            vout = raster(vfeats, vcam.affine, vw, vh)
            v_uv = torch.einsum("ij,hwj->hwi", cam2virt, rendered_uva)[..., :2]
            samp = grid_sample(vout.image[:4], v_uv, align_corners=True)
            alt_s = torch.where(torch.any(torch.abs(v_uv) > 1.0, dim=-1),
                                -100.0, samp[3])
            return samp[:3], alt_s, v_uv

        terms = {}
        sun_altitude_diff = None
        if phase.enable_sun:
            sun_cam, cam2sun = cam.sun_camera(f=2)
            sw = ((sun_cam.width + TILE - 1) // TILE) * TILE
            sh = ((sun_cam.height + TILE - 1) // TILE) * TILE
            sun_rgb, sun_alt, sun_uv = render_virtual(
                sun_cam.resize_canvas(sw, sh), cam2sun, sw, sh)
            sun_altitude_diff = altitude - sun_alt
            alt_t, rgb_t = L.suncamera_loss(raw_render, sun_rgb,
                                            sun_altitude_diff, sun_uv)
            terms["L_sun_altitude_resample"] = gates["sun_resample"] * alt_t
            terms["L_sun_rgb_resample"] = gates["sun_resample"] * rgb_t

        # ---- shading pipeline ----
        shaded_out = render_pipeline(
            raw_render, sun_altitude_diff, sp.cc_weight[vi], sp.cc_bias[vi],
            sp.inshadow[vi], use_cc=cam_params.use_cc,
            use_shadow=cam_params.use_shadow, exposure=sp.exposure[vi],
            use_exposure=cam_params.use_exposure, pan_mode=pan_mode,
            pan_weight=sp.msi_to_pan_weight[vi],
            pan_bias=sp.msi_to_pan_bias[vi],
            weird_pan_setup=cfg.model.weird_pan_setup)
        image = shaded_out["final"]
        gt_image = consts.images[view_idx]
        valid = consts.image_valid[view_idx]

        # ---- random virtual camera consistency ----
        if phase.enable_random:
            new_cam, cam2new = cam.random_camera(shear_draw,
                                                 o.virtual_camera_extent)
            new_rgb, new_alt, new_uv = render_virtual(
                new_cam.resize_canvas(wp, hp), cam2new, wp, hp)
            alt_t, rgb_t = L.randomcam_loss(altitude, new_alt, raw_render,
                                            new_rgb, new_uv)
            terms["L_new_altitude_resample"] = gates["new_resample"] * alt_t
            terms["L_new_rgb_resample"] = gates["new_resample"] * rgb_t

        # ---- scalar regularizers ----
        init_count = gates["init_count"]
        terms["L_opacity"] = gates["opacity"] * L.opacity_loss(
            opacity, model.alive, init_count)
        terms["L_opacity_radii"] = gates["opacity_radii"] * \
            L.radii_opacity_loss(opacity, out.radii, init_count)
        terms["L_erank"] = gates["erank"] * L.erank_loss(scaling, model.alive)
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
            + o.w_L_sun_altitude_resample * terms.get("L_sun_altitude_resample", zero)
            + o.w_L_sun_rgb_resample * terms.get("L_sun_rgb_resample", zero)
            + o.w_L_new_altitude_resample * terms.get("L_new_altitude_resample", zero)
            + o.w_L_new_rgb_resample * terms.get("L_new_rgb_resample", zero)
            + o.w_L_TV_altitude * terms["L_TV_altitude"]
            + o.w_L_erank * terms["L_erank"]
            + o.w_L_translucentshadows * terms["L_translucentshadows"]
            + o.w_L_accumulated_opacity * terms["L_accumulated_opacity"]
            + getattr(o, "w_L_nll", 0.0) * terms["L_nll"]
        )
        with torch.no_grad():
            metrics = {
                "loss": total.detach(),
                "L1": ll1.detach(),
                "photometric": photometric.detach(),
                "psnr": -10.0 * torch.log10(
                    L.masked_mean((image - gt_image) ** 2, valid) + 1e-12),
                "num_pairs": out.num_pairs,
                "max_tile": out.max_tile_count,
                "max_tiles_per_gaussian": out.max_tiles_per_gaussian_seen,
                "sat_frac": L.masked_mean((out.final_t < 1e-2).float(),
                                          valid[0]),
                "clipped_pairs": (out.clipped_pairs
                                  if out.clipped_pairs is not None
                                  else torch.zeros((), dtype=torch.int64,
                                                   device=image.device)),
                **{k: v.detach() for k, v in terms.items()},
            }
        return total, metrics, out.radii

    def step(model: GaussianModel, shading: CameraShadingParams,
             view_idx: int, bg_draw, shear_draw, gates):
        gates = {k: float(v) for k, v in gates.items()}
        m2d_off = torch.zeros((model.xyz.shape[0], 2), dtype=torch.float32,
                              device=model.xyz.device, requires_grad=True)
        gauss_opt.zero_grad(set_to_none=True)
        cam_opt.zero_grad(set_to_none=True)
        total, metrics, radii = camera_loss(model, shading, m2d_off, view_idx,
                                            bg_draw, shear_draw, gates)
        total.backward()
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

        if o.optimizer_type == "sparse_adam":
            # only Gaussians visible this step move; moments still advance
            vis = radii > 0
            before = [p.detach().clone() for g in gauss_opt.param_groups
                      for p in g["params"]]
        gauss_opt.step()
        cam_opt.step()
        if o.optimizer_type == "sparse_adam":
            with torch.no_grad():
                ps = [p for g in gauss_opt.param_groups for p in g["params"]]
                for p, old in zip(ps, before):
                    m = vis.reshape((-1,) + (1,) * (p.dim() - 1))
                    p.copy_(torch.where(m, p, old))
        add_densification_stats(model, m2d_off.grad, radii)
        metrics["grad_m2d_max"] = m2d_off.grad.abs().max()
        return metrics

    return step


_UNPORTED = "is not ported yet (ROADMAP Queue 1 item {})"


@dataclasses.dataclass
class Trainer:
    """Host-side orchestration for one modality on one device: camera
    sampling, phase scheduling, the step, densify/prune/reset cadence,
    metrics averaged every ``tb_log_interval`` iterations, early stopping,
    the hooks and, on the dense modes, the capacity grow every 50.

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
    ``eval.mae.MaeComputer``) set, the report holds the Nadir DSM's MAE."""

    cfg: TrainConfig
    scene: SceneData
    raster_cfg: RasterizeConfig = RasterizeConfig()
    device: Optional[object] = None
    eval_hook: Optional[Callable] = None
    log_hook: Optional[Callable] = None
    report_logger: Optional[object] = None
    mae_computer: Optional[object] = None

    def setup(self):
        cfg = self.cfg
        dev = resolve_device(self.device)
        self.device = dev
        if cfg.optimization.apply_pansharp:
            raise NotImplementedError("pansharpening " + _UNPORTED.format(9))
        msi = [v for v in self.scene.train_views if v.image_type == "msi"]
        pan = [v for v in self.scene.train_views if v.image_type == "pan"]
        modal = ([("msi", msi)] if cfg.model.load_msi and msi else []) + \
            ([("pan", pan)] if cfg.model.load_pan and pan else [])
        if len(modal) != 1 or modal[0][0] != "msi":
            raise NotImplementedError(
                "the PAN and dual MS modalities " + _UNPORTED.format(9)
                + "; the port trains the onlyMSI mode")
        self.modal_views = modal
        views = modal[0][1]
        self.consts = build_scene_tensors_from_views(views, device=dev)
        n_init = len(self.scene.init_xyz)
        capacity = int(n_init * cfg.model.capacity_headroom)
        capacity = ((capacity + 127) // 128) * 128
        self.model = init_from_points(
            self.scene.init_xyz, self.scene.init_rgb, capacity=capacity,
            sh_degree=cfg.model.sh_degree,
            opacity_init_value=cfg.model.opacity_init_value, device=dev)
        self.init_count = n_init
        transient_hw = (tuple(self.consts.images.shape[-2:])
                        if cfg.model.use_transient else None)
        self.shading = init_shading_params(
            len(views), transient_hw=transient_hw,
            transient_init=cfg.model.transient_init_value, device=dev)
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
        if rc.binning_mode == "fused":
            return  # the fused route reads neither capacity
        want = rc.bucketed(float(metrics["max_tile"]) / 0.95,
                           float(metrics["max_tiles_per_gaussian"]))
        self.set_raster_cfg(dataclasses.replace(
            rc, tile_capacity=max(rc.tile_capacity, want.tile_capacity),
            max_tiles_per_gaussian=max(rc.max_tiles_per_gaussian,
                                       want.max_tiles_per_gaussian)))

    def _get_step(self, phase: Phase):
        if phase not in self._steps:
            self._steps[phase] = make_train_step(
                (("msi", self.consts, None, 0),), self.cfg, self.raster_cfg,
                phase, self.gauss_opt, self.cam_opt)
        return self._steps[phase]

    def _check_supported(self, iters: int):
        """Raise before the first step if the run would reach a part of the
        recipe that is not ported yet."""
        cfg, o = self.cfg, self.cfg.optimization
        todo = []
        if o.itr_apply_flowmatching_to_affine <= iters:
            todo.append(("baking flow into the affines", 9))
        if o.color_reset_iterations <= iters:
            todo.append(("the colour reset", 9))
        if o.normalize_colors_before_saving:
            todo.append(("normalize_colors_before_saving", 9))
        if any(i <= iters for i in (*cfg.save_iterations,
                                    *cfg.checkpoint_iterations)):
            todo.append(("model saves and checkpoints", 12))
        if todo:
            what, item = todo[0]
            raise NotImplementedError(f"{what} " + _UNPORTED.format(item))

    def _maintenance(self, iteration: int):
        """Pruning / densification / opacity reset (train_pan.py:672-736),
        in JAX's order (eogs2_tpu/train.py:1184-1232)."""
        o = self.cfg.optimization
        model = self.model
        if iteration < o.densify_until_iter:
            d = o.densification
            if (not o.only_prune and iteration > d.densify_from_iter
                    and iteration % d.densification_interval == 0):
                self._densify(iteration)
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
            counts = torch.stack([
                ((grads_avg >= d.densify_grad_threshold) & alive0).sum(),
                alive0.sum(), n_clone, n_split, grown,
                model.alive.sum()]).tolist()  # one host sync
        self.densify_log.append(dict(zip(
            ("iteration", "selected", "alive_before", "cloned", "split",
             "alive_densified", "alive_pruned"), [iteration] + counts)))

    def train_step(self, iteration: int) -> Dict[str, torch.Tensor]:
        """One iteration: pick a view (a fresh permutation of the views each
        epoch, from np.random.RandomState(seed) as JAX does), run the step of
        this iteration's phase with its gates and draws, then the
        maintenance (prune, densify, opacity reset). Returns the step's
        metrics as device tensors (nothing synced by the step)."""
        if not self._view_stack:
            self._view_stack = list(self.rng.permutation(
                len(self.modal_views[0][1])))
        view_idx = int(self._view_stack.pop())
        step = self._get_step(phase_for_iteration(self.cfg, iteration))
        gates = make_gates(self.cfg, iteration, self.init_count)
        # the step's random inputs: the background's uniform [5], the
        # random camera's standard-normal shear [2]
        g, dev = self.generator, self.device
        bg_draw = torch.rand(5, generator=g, device=dev)
        shear_draw = torch.randn(2, generator=g, device=dev)
        metrics = step(self.model, self.shading, view_idx, bg_draw,
                       shear_draw, gates)
        self._maintenance(iteration)
        return metrics

    def train(self, max_iterations: Optional[int] = None,
              progress: bool = True) -> GaussianModel:
        """Run iterations 1..n (cfg.optimization.iterations by default), in
        JAX's order within an iteration: the step and maintenance, the
        capacity grow (every 50), the logged means with the log hook and
        early stopping (every tb_log_interval; a stop breaks before this
        iteration's eval hook), the eval hook, training_report."""
        o, log = self.cfg.optimization, self.cfg.logging
        iters = max_iterations or o.iterations
        self._check_supported(iters)
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
            if iteration % log.tb_log_interval == 0:
                m = mean_metrics(interval)
                m["iteration"] = iteration
                m["alive"] = int(self.model.alive.sum())
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
                self.eval_hook(self, self.model, iteration)
            if iteration in (log.big_testing_iterations or ()):
                self.training_report(iteration)
        return self.model

    def calibrate_opacity_init(self, target_acc: float = 0.999,
                               iters: int = 12) -> float:
        """Set the alive Gaussians' opacity so that the mean accumulated
        opacity of train view 0's render (no sun) is about ``target_acc``
        (the CLI's ``--opacity-init auto``): a log-space bisection over
        [1e-4, 0.9], ``iters`` renders. Returns the value."""
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
        logger = logger if logger is not None else self.report_logger
        test_sh = self.test_shading_params()
        report = {}
        for split in ("train", "test"):
            sums = {}
            n_logged = 0
            for mname, tviews in self.modal_views:
                views = (tviews if split == "train"
                         else [v for v in self.scene.test_views
                               if v.image_type == mname and not v.is_virtual])
                for vi, view in enumerate(views):
                    if view.image is None:
                        continue
                    out = render_view_full(
                        self.model, view.camera, self.raster_cfg,
                        shading=self.shading if split == "train" else test_sh,
                        view_idx=vi if split == "train" else 0,
                        with_sun=view.camera.has_sun)
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


def mean_metrics(steps) -> Dict[str, float]:
    """Per-key means of a list of step metrics, read with one host sync."""
    keys = list(steps[0])
    vals = torch.stack([torch.stack([m[k].to(torch.float64) for k in keys])
                        for m in steps]).mean(0).cpu().numpy()
    return dict(zip(keys, (float(x) for x in vals)))
