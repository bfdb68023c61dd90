"""Typed configuration tree.

The port's own copy of ``eogs2_tpu/config.py`` (framework-free dataclasses,
the same names, defaults and presets), so that one recipe reads the same in
both packages. Parity target: the reference's Hydra tree (``gs_config/``)
and typed param groups (``arguments/__init__.py``); defaults mirror
``gs_config/train.yaml`` field for field, and the iteration gates keep the
"iterstart_*/iterend_*" naming.

The trainer of this package runs every preset and every modality mode of
``_apply_mode``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple


@dataclasses.dataclass
class EarlyStoppingConfig:
    use_early_stopping: bool = False
    patience: int = 600  # multiplied by tb_log_interval ticks
    operator: str = "min"
    metric_name: str = "photometric"


@dataclasses.dataclass
class FlowMatchingConfig:
    apply_flowmatching: bool = False
    max_value_flow: float = 5.0
    flowmatch_msi: bool = True
    flowmatch_pan: bool = True
    perform_cst_displacement: bool = True
    mode: str = "upscale"
    model_name: str = "small"  # 'small' -> phase-correlation constant shift
    criteria: str = "max_value_flow"
    iterend_flowmatching: int = 9_999_999
    num_flow_updates: int = 12


@dataclasses.dataclass
class DensificationConfig:
    densify_from_iter: int = 500
    densification_interval: int = 100
    densify_grad_threshold: float = 2e-6


@dataclasses.dataclass
class CameraParamsConfig:
    use_cc: bool = True
    use_exposure: bool = False
    learn_wv_transform: bool = False
    learn_wv_only_lastparam: bool = True
    use_shadow: bool = True


@dataclasses.dataclass
class OptimizationConfig:
    iterations: int = 10_000
    position_lr_init: float = 0.00016
    feature_lr: float = 0.0025
    opacity_lr: float = 0.05
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001
    percent_dense: float = 0.01
    lambda_dssim: float = 0.2
    camera_lr: float = 0.01

    densification: DensificationConfig = dataclasses.field(
        default_factory=DensificationConfig
    )
    opacity_reset_interval: int = 3000
    iterend_opacity_reset_interval: int = 999_999_999
    only_prune: bool = True
    densify_until_iter: int = 10_000
    min_opacity: float = -6.0  # RAW logit threshold for only_prune
    color_reset_iterations: int = 9_999_999_999

    random_background: bool = True
    copy_background_firschan: bool = False
    optimizer_type: str = "default"  # "default" | "sparse_adam"
    views_per_step: int = 1  # TPU extension: cameras batched per optimizer step

    # iteration gates (train.yaml values)
    iterstart_shadowmapping: int = 1000
    iterstart_L_opacity: int = -1
    iterend_L_opacity: int = 99_999_999
    iterstart_L_opacity_radii: int = 999_999
    iterend_L_opacity_radii: int = 99_999_999_999
    iterstart_L_sun_resample: int = 9_999_999_999
    iterstart_L_new_resample: int = 1000
    iterstart_L_TV_altitude: int = 9_999_999_999
    iterstart_L_erank: int = 9_999_999_999
    iterstart_L_accumulated_opacity: int = 9_999_999_999
    iterstart_L_nll: int = 9_999_999_999
    iterstart_L_flowmatch: int = 99_999_999
    iterend_L_flowmatch: int = 9_999_999
    iterstart_flowmatching: int = 1500
    itr_apply_flowmatching_to_affine: int = 99_999_999
    iterstart_learn_wv_transform: int = 1500
    freeze_start_msitopan_params: bool = True
    iterstart_learn_msitopan_params: int = 5000

    # loss weights (train.yaml)
    w_L_photometric: float = 1.0
    w_L_opacity: float = 0.10
    w_L_opacity_radii: float = 0.0
    w_L_sun_altitude_resample: float = 0.01
    w_L_sun_rgb_resample: float = 0.10
    w_L_new_altitude_resample: float = 0.01
    w_L_new_rgb_resample: float = 0.10
    w_L_TV_altitude: float = 0.0
    w_L_erank: float = 0.0
    w_L_translucentshadows: float = 0.01
    w_L_accumulated_opacity: float = 0.0
    w_L_nll: float = 0.0
    w_L_flowmatch: float = 0.1
    virtual_camera_extent: float = 0.01
    randomcamera_render_type: str = "rawrender"

    apply_pansharp: bool = False
    pansharp_method: str = "brovey"
    normalize_colors_before_saving: bool = False

    early_stopping: EarlyStoppingConfig = dataclasses.field(
        default_factory=EarlyStoppingConfig
    )
    flowmatching: FlowMatchingConfig = dataclasses.field(
        default_factory=FlowMatchingConfig
    )


@dataclasses.dataclass
class ModelConfig:
    sh_degree: int = 0
    white_background: bool = False
    target_density: float = 0.13
    opacity_init_value: float = 0.01
    scale_factor_z: float = 1.0
    camera_params: CameraParamsConfig = dataclasses.field(
        default_factory=CameraParamsConfig
    )
    # fixed|average|identity|only_one_channel|learned|fixedandtranslate
    msi_to_pan_name: str = "fixed"
    share_color_correction: bool = True
    weird_pan_setup: bool = False
    load_pan: bool = True
    load_msi: bool = True
    repeat_gt: bool = False
    rescaler_name: str = "clamper"
    train_to_test_cc_converter: str = "average"
    capacity_headroom: float = 1.25  # fixed-capacity slack over init count
    use_transient: bool = False  # transient_params (train.yaml)
    transient_init_value: float = 0.01


@dataclasses.dataclass
class LoggingConfig:
    tb_log_interval: int = 10
    big_testing_iterations: Optional[List[int]] = None
    testing_interval: int = 100  # DSM-MAE eval cadence (test_iterations)
    model_path: str = "output/run"


@dataclasses.dataclass
class TrainConfig:
    scene_dir: str = ""
    images_msi_path: Optional[str] = None
    images_pan_path: Optional[str] = None
    seed: int = 1337
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    optimization: OptimizationConfig = dataclasses.field(
        default_factory=OptimizationConfig
    )
    logging: LoggingConfig = dataclasses.field(default_factory=LoggingConfig)
    save_iterations: Tuple[int, ...] = ()
    checkpoint_iterations: Tuple[int, ...] = ()
    antialiasing: bool = False


# ---- experiment presets (gs_config/experiments/*.yaml) ---------------------


def _apply_mode(cfg: TrainConfig, mode: str) -> TrainConfig:
    m = cfg.model
    if mode == "onlyMSI":
        m.load_pan, m.load_msi = False, True
    elif mode == "3PAN":
        m.load_pan, m.load_msi = True, False
        m.msi_to_pan_name = "identity"
        m.repeat_gt = True
    elif mode == "onlyPAN":
        m.load_pan, m.load_msi = True, False
        m.msi_to_pan_name = "only_one_channel"
    elif mode == "average":
        m.load_pan, m.load_msi = True, False
        m.msi_to_pan_name = "average"
    elif mode == "fixed":
        m.load_pan, m.load_msi = True, True
        m.msi_to_pan_name = "fixed"
    else:
        raise ValueError(f"unknown mode {mode}")
    return cfg


def baseogs(scene_dir: str = "", iterations: int = 5000) -> TrainConfig:
    """experiments/baseogs.yaml: onlyMSI, no opacity reset, 5k iterations."""
    cfg = TrainConfig(scene_dir=scene_dir)
    cfg = _apply_mode(cfg, "onlyMSI")
    cfg.optimization.iterations = iterations
    cfg.optimization.densify_until_iter = iterations
    cfg.optimization.opacity_reset_interval = 999_999_999
    return cfg


def eogsplus(scene_dir: str = "", iterations: int = 40_000) -> TrainConfig:
    """experiments/eogsplus.yaml: 3PAN, early stopping on photometric,
    constant-displacement flow matching, 40k iterations."""
    cfg = TrainConfig(scene_dir=scene_dir)
    cfg = _apply_mode(cfg, "3PAN")
    o = cfg.optimization
    o.iterations = iterations
    o.densify_until_iter = iterations
    o.early_stopping = EarlyStoppingConfig(
        use_early_stopping=True, operator="min", metric_name="photometric"
    )
    o.flowmatching = FlowMatchingConfig(
        apply_flowmatching=True, perform_cst_displacement=True, model_name="small"
    )
    return cfg


def learnwv(scene_dir: str = "", iterations: int = 40_000) -> TrainConfig:
    """experiments/learnwv.yaml: onlyMSI + learnable last-row pose."""
    cfg = TrainConfig(scene_dir=scene_dir)
    cfg = _apply_mode(cfg, "onlyMSI")
    cfg.optimization.iterations = iterations
    cfg.optimization.densify_until_iter = iterations
    cfg.model.camera_params.learn_wv_transform = True
    cfg.model.camera_params.learn_wv_only_lastparam = True
    return cfg


def optical_flow(scene_dir: str = "", iterations: int = 40_000) -> TrainConfig:
    """experiments/optical_flow.yaml: 3PAN + flow matching on raw RPCs."""
    cfg = eogsplus(scene_dir, iterations)
    cfg.optimization.early_stopping.use_early_stopping = False
    return cfg


PRESETS = {
    "baseogs": baseogs,
    "eogsplus": eogsplus,
    "learnwv": learnwv,
    "optical_flow": optical_flow,
}
