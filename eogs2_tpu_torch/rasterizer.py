"""Public rasterizer: preprocess -> emission + sort -> K1 blend -> image.

Counterpart of ``eogs2_tpu/rasterizer.py``. Only the ``fused`` route is
ported so far (ops/fused_raster.py); the ``gather`` and ``sorted`` modes
raise NotImplementedError until ROADMAP Queue 1 item 11 ports them.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from eogs2_tpu_torch.ops.binning import grid_dims
from eogs2_tpu_torch.ops.gaussians import build_cov3d
from eogs2_tpu_torch.ops.projection import (
    TILE,
    compute_cov2d_direct,
    preprocess_gaussians,
)

NUM_CHANNELS = 5  # RGB + altitude + constant-1 (config.h:15)


@dataclasses.dataclass(frozen=True)
class RasterizeConfig:
    """Same fields and defaults as eogs2_tpu.rasterizer.RasterizeConfig.

    The port reads binning_mode, antialiasing, eogs_features and tile_cull.
    Emission is sized by demand and the blend walks every pair, so the
    capacities (pair_capacity, tile_capacity, max_tiles_per_gaussian, big_k,
    big_tcap, rect_cap, big_rect_cap, dest_cap) never clip; the TPU layout
    knobs (tile_chunk, payload_col, k_chunk, early_exit) change no output;
    use_custom_vjp and use_pallas belong to the modes not yet ported. All
    are accepted so one config drives both packages."""

    pair_capacity: int = 1 << 20
    tile_capacity: int = 1024
    max_tiles_per_gaussian: int = 16
    tile_chunk: int = 128
    antialiasing: bool = False
    use_custom_vjp: bool = True
    use_pallas: bool = False
    binning_mode: str = "gather"
    dest_cap: int = 1 << 16
    early_exit: bool = True
    payload_col: bool = True
    k_chunk: int = 0
    big_k: int = 0
    big_tcap: int = 64
    eogs_features: bool = False
    tile_cull: bool = False
    rect_cap: int = 0
    big_rect_cap: int = 0


class RasterOut(NamedTuple):
    image: torch.Tensor  # [C,H,W]
    final_t: torch.Tensor  # [H,W] remaining transmittance
    radii: torch.Tensor  # [N] int32 screen radius (0 = culled)
    mean2d_ndc: torch.Tensor  # [N,2] projected centers in NDC
    num_pairs: torch.Tensor  # [] pair demand (live pairs with tile_cull)
    max_tile_count: torch.Tensor  # [] densest tile
    max_tiles_per_gaussian_seen: Optional[torch.Tensor] = None
    dropped_pairs: Optional[torch.Tensor] = None  # multi-device path only
    clipped_pairs: Optional[torch.Tensor] = None  # always 0 on the port
    big_max_tiles_seen: Optional[torch.Tensor] = None
    max_dest_count: Optional[torch.Tensor] = None  # multi-device path only
    bulk_rect_max_seen: Optional[torch.Tensor] = None


def rasterize(
    means3d,
    scales,
    quats,
    opacities,
    features,
    affine,
    bg,
    width: int,
    height: int,
    config: RasterizeConfig = RasterizeConfig(),
    alive=None,
    mean2d_ndc_offset=None,
) -> RasterOut:
    """Render C=5 feature channels through the affine camera.

    means3d [N,3]; scales [N,3] activated; quats [N,4] raw (w,x,y,z);
    opacities [N] activated; features [N,5] (rgb, altitude, 1); affine
    [3,4] world -> (u_ndc, v_ndc, altitude); bg [5], composited as
    out + final_t * bg; alive optional [N] bool; mean2d_ndc_offset optional
    [N,2] whose gradient is the viewspace-point gradient in NDC units.
    Runs on the device of its tensors."""
    if config.binning_mode != "fused":
        raise NotImplementedError(
            f"binning_mode={config.binning_mode!r} is not ported yet (ROADMAP "
            f"Queue 1 item 11, the other raster modes); use binning_mode="
            f"'fused'"
        )
    from eogs2_tpu_torch.ops.fused_raster import rasterize_fused

    cov2d = compute_cov2d_direct(scales, quats, affine, width, height)
    prep = preprocess_gaussians(
        means3d, None, opacities, affine, width, height,
        antialiasing=config.antialiasing, alive=alive, cov2d=cov2d,
    )
    if mean2d_ndc_offset is not None:
        px_scale = torch.tensor([0.5 * width, 0.5 * height],
                                dtype=prep.mean2d.dtype,
                                device=prep.mean2d.device)
        prep = prep._replace(mean2d=prep.mean2d + mean2d_ndc_offset * px_scale)

    grid_x, grid_y = grid_dims(width, height)
    fo = rasterize_fused(prep, features, width, height,
                         eogs_features=config.eogs_features,
                         tile_cull=config.tile_cull)
    out = fo.out8[:, :, :5] + fo.out8[:, :, 5:6] * bg[None, None, :]
    ro = _assemble(prep, out, fo.out8[:, :, 5], fo.num_pairs,
                   fo.max_tile_count, features.shape[-1], width, height,
                   grid_x, grid_y)
    return ro._replace(
        max_tiles_per_gaussian_seen=fo.bulk_max_tiles,
        clipped_pairs=fo.clipped_pairs,
        big_max_tiles_seen=fo.big_max_tiles,
        bulk_rect_max_seen=fo.bulk_rect_max_tiles,
    )


def _assemble(prep, out, final_t, num_pairs, max_tile_count, c,
              width, height, grid_x, grid_y) -> RasterOut:
    """Tile-major [T, P, C] blend output -> RasterOut image/stats."""
    img = out.reshape(grid_y, grid_x, TILE, TILE, c)
    img = img.permute(0, 2, 1, 3, 4).reshape(grid_y * TILE, grid_x * TILE, c)
    img = img[:height, :width]
    ft = final_t.reshape(grid_y, grid_x, TILE, TILE)
    ft = ft.permute(0, 2, 1, 3).reshape(grid_y * TILE, grid_x * TILE)
    ft = ft[:height, :width]
    scale_ndc = torch.tensor([2.0 / width, 2.0 / height],
                             dtype=prep.mean2d.dtype, device=prep.mean2d.device)
    return RasterOut(
        image=img.permute(2, 0, 1),
        final_t=ft,
        radii=prep.radius,
        mean2d_ndc=prep.mean2d * scale_ndc,
        num_pairs=num_pairs,
        max_tile_count=max_tile_count,
        max_tiles_per_gaussian_seen=prep.tiles_touched.max(),
    )


def reference_rasterize(
    means3d, scales, quats, opacities, features, affine, bg, width, height,
    antialiasing=False, alive=None,
):
    """O(N * H * W) dense oracle — no tiling, no capacities.

    The same skip rules and early-out threshold as ``rasterize``: sorts ALL
    Gaussians by depth and composites every one over every pixel of the
    tiles its rect covers. Returns (image [C,H,W], final_t [H,W], radii)."""
    cov3d6 = build_cov3d(scales, quats)
    prep = preprocess_gaussians(
        means3d, cov3d6, opacities, affine, width, height,
        antialiasing=antialiasing, alive=alive,
    )
    order = torch.argsort(prep.depth, stable=True)
    visible = prep.radius[order] > 0
    mean2d = prep.mean2d[order]
    conic = prep.conic[order]
    opac = prep.opacity[order]
    feat = features[order]

    dev, dt = means3d.device, means3d.dtype
    ys = torch.arange(height, dtype=dt, device=dev)
    xs = torch.arange(width, dtype=dt, device=dev)
    py, px = torch.meshgrid(ys, xs, indexing="ij")
    pix = torch.stack([px.reshape(-1), py.reshape(-1)], dim=-1)  # [P,2]

    d = mean2d[None, :, :] - pix[:, None, :]
    dx, dy = d[..., 0], d[..., 1]
    a, b, c3 = conic[:, 0], conic[:, 1], conic[:, 2]
    power = -0.5 * (a * dx * dx + c3 * dy * dy) - b * dx * dy
    alpha_raw = torch.clamp_max(
        opac[None, :] * torch.exp(torch.clamp_max(power, 0.0)), 0.99
    )
    # a pixel sees a Gaussian only inside the tiles of its rect (getRect)
    ptile = (pix / TILE).to(torch.int32)
    rmin = prep.rect_min[order]
    rmax = rmin + prep.rect_size[order]
    in_rect = torch.all(
        (ptile[:, None, :] >= rmin[None, :, :])
        & (ptile[:, None, :] < rmax[None, :, :]),
        dim=-1,
    )
    keep = (visible[None, :] & in_rect & (power <= 0.0)
            & (alpha_raw >= 1.0 / 255.0))
    alpha = torch.where(keep, alpha_raw, 0.0)
    one_minus = 1.0 - alpha
    cp = torch.cumprod(one_minus, dim=-1)
    live = cp >= 1e-4
    t_before = torch.cat([torch.ones_like(cp[:, :1]), cp[:, :-1]], dim=-1)
    w = torch.where(live, alpha * t_before, 0.0)
    out = w @ feat
    final_t = torch.prod(torch.where(live, one_minus, 1.0), dim=-1)
    out = out + final_t[:, None] * bg[None, :]
    img = out.reshape(height, width, -1).permute(2, 0, 1)
    return img, final_t.reshape(height, width), prep.radius
