"""Public rasterizer: preprocess -> binning -> blend -> image.

Counterpart of ``eogs2_tpu/rasterizer.py``, with every route of it:

  * ``fused``: demand-sized emission, one sort, the ragged per-tile blend
    K1/K2 on the column payload or K3 on the row payload (``payload_col``),
    ops/fused_raster.py;
  * ``gather`` and ``sorted``: the dense [T, K] view of the sorted pairs,
    packed [T, 16, K] (ops/pair_pipeline.densify_pairs; the two modes
    compute the same thing and share it here), blended by the plain dense
    blend (ops/blend.py, on slices of the table) or, with ``use_pallas``,
    by the tile-slot kernel K4 (ops/blend_cuda.py).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from eogs2_tpu_torch.observability import host_read, span
from eogs2_tpu_torch.ops.binning import grid_dims
from eogs2_tpu_torch.ops.blend import blend_tiles
from eogs2_tpu_torch.ops.blend_cuda import BlendTilesPallas
from eogs2_tpu_torch.ops.fused_raster import rasterize_fused
from eogs2_tpu_torch.ops.gaussians import build_cov3d
from eogs2_tpu_torch.ops.pair_pipeline import densify_pairs
from eogs2_tpu_torch.ops.projection import (
    TILE,
    compute_cov2d_direct,
    preprocess_gaussians,
)

NUM_CHANNELS = 5  # RGB + altitude + constant-1 (config.h:15)


@dataclasses.dataclass(frozen=True)
class RasterizeConfig:
    """Same fields and defaults as eogs2_tpu.rasterizer.RasterizeConfig.

    The port reads binning_mode, antialiasing, eogs_features, tile_cull and
    payload_col (fused route); tile_capacity, max_tiles_per_gaussian,
    use_pallas, use_custom_vjp and tile_chunk (dense modes).

    Which capacities clip: on the dense modes, as in JAX, each Gaussian
    emits at most max_tiles_per_gaussian rect tiles and each tile blends at
    most tile_capacity (K) pairs; num_pairs, max_tile_count and
    max_tiles_per_gaussian_seen report the demand before the clamps, and the
    Trainer grows both. The fused route sizes its emission by demand and
    walks every pair, so nothing clips there. pair_capacity, big_k,
    big_tcap, rect_cap, big_rect_cap and dest_cap size JAX's static tables
    and clip nothing here; k_chunk and early_exit are TPU tuning knobs that
    change no output (K4 takes any K). All are accepted so one config
    drives both packages."""

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

    def bucketed(self, max_tile: int,
                 max_tiles_per_gaussian: int) -> "RasterizeConfig":
        """The dense modes' capacities in the next power-of-two bucket that
        fits the observed sizes (JAX's rule): tile_capacity above max_tile,
        at least 128; max_tiles_per_gaussian at least the widest Gaussian,
        at least 4."""

        def up(x, lo):
            c = lo
            while c < x:
                c <<= 1
            return c

        return dataclasses.replace(
            self,
            tile_capacity=up(int(max_tile) + 1, 128),
            max_tiles_per_gaussian=up(int(max_tiles_per_gaussian), 4),
        )


class RasterOut(NamedTuple):
    image: torch.Tensor  # [C,H,W]
    final_t: torch.Tensor  # [H,W] remaining transmittance
    radii: torch.Tensor  # [N] int32 screen radius (0 = culled)
    mean2d_ndc: torch.Tensor  # [N,2] projected centers in NDC
    num_pairs: torch.Tensor  # [] pair demand (live pairs with tile_cull)
    max_tile_count: torch.Tensor  # [] densest tile, before the K clamp
    max_tiles_per_gaussian_seen: Optional[torch.Tensor] = None
    dropped_pairs: Optional[torch.Tensor] = None  # multi-device path only
    clipped_pairs: Optional[torch.Tensor] = None  # fused: always 0; dense: None
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
    if config.binning_mode not in ("fused", "gather", "sorted"):
        raise ValueError(f"unknown binning_mode {config.binning_mode!r}")
    prep = preprocess(means3d, scales, quats, opacities, affine, width,
                      height, antialiasing=config.antialiasing, alive=alive,
                      mean2d_ndc_offset=mean2d_ndc_offset)

    grid_x, grid_y = grid_dims(width, height)
    if config.binning_mode == "fused":
        fo = rasterize_fused(prep, features, width, height,
                             eogs_features=config.eogs_features,
                             tile_cull=config.tile_cull,
                             payload_col=config.payload_col)
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

    with span("raster.emission"):
        pd = densify_pairs(prep, features, width, height,
                           tcap=config.max_tiles_per_gaussian,
                           tile_capacity=config.tile_capacity)
    with span("raster.blend"):
        if config.use_pallas:
            out, final_t = BlendTilesPallas.apply(pd.data, bg, grid_x)
        else:
            d = pd.data.transpose(1, 2)  # [T, K, 16]
            ids = torch.arange(grid_x * grid_y, device=prep.mean2d.device)
            origins = torch.stack([ids % grid_x, ids // grid_x], -1).to(
                prep.mean2d.dtype) * TILE
            out, final_t = blend_tiles(d[..., 0:2], d[..., 2:5], d[..., 5],
                                       d[..., 6:11], pd.mask, origins, bg,
                                       tile_chunk=config.tile_chunk,
                                       use_custom_vjp=config.use_custom_vjp)
    return _assemble(prep, out, final_t, pd.num_pairs, pd.max_tile_count,
                     features.shape[-1], width, height, grid_x, grid_y)


def preprocess(means3d, scales, quats, opacities, affine, width: int,
               height: int, antialiasing: bool = False, alive=None,
               mean2d_ndc_offset=None):
    """The front half of ``rasterize`` and of the a2a path: projection and
    culling, and the optional [N, 2] NDC offset added to the centers."""
    with span("raster.preprocess"):
        cov2d = compute_cov2d_direct(scales, quats, affine, width, height)
        prep = preprocess_gaussians(means3d, None, opacities, affine, width,
                                    height, antialiasing=antialiasing,
                                    alive=alive, cov2d=cov2d)
        if mean2d_ndc_offset is not None:
            px_scale = host_read(lambda: torch.tensor(
                [0.5 * width, 0.5 * height], dtype=prep.mean2d.dtype,
                device=prep.mean2d.device), "raster.px_scale")
            prep = prep._replace(
                mean2d=prep.mean2d + mean2d_ndc_offset * px_scale)
    return prep


def to_ndc(mean2d, width: int, height: int):
    """Pixel centers [N, 2] -> NDC units (the ``mean2d_ndc`` output)."""
    scale_ndc = host_read(lambda: torch.tensor(
        [2.0 / width, 2.0 / height], dtype=mean2d.dtype,
        device=mean2d.device), "raster.scale_ndc")
    return mean2d * scale_ndc


def _assemble(prep, out, final_t, num_pairs, max_tile_count, c,
              width, height, grid_x, grid_y) -> RasterOut:
    """Tile-major [T, P, C] blend output -> RasterOut image/stats."""
    img = out.reshape(grid_y, grid_x, TILE, TILE, c)
    img = img.permute(0, 2, 1, 3, 4).reshape(grid_y * TILE, grid_x * TILE, c)
    img = img[:height, :width]
    ft = final_t.reshape(grid_y, grid_x, TILE, TILE)
    ft = ft.permute(0, 2, 1, 3).reshape(grid_y * TILE, grid_x * TILE)
    ft = ft[:height, :width]
    return RasterOut(
        image=img.permute(2, 0, 1),
        final_t=ft,
        radii=prep.radius,
        mean2d_ndc=to_ndc(prep.mean2d, width, height),
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
