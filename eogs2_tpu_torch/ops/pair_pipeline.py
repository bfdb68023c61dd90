"""Pair emission for the fused route: one (Gaussian, tile) pair per rect tile.

Counterpart of the emission-key logic of ``eogs2_tpu/ops/pair_pipeline.py``
(``_tier_keys`` and ``_tier_keys_compact``) and of its ellipse-exact tile
cull. The JAX package emits into static [tcap, N] tables because XLA's
shapes are static; here the pair list is sized by TRUE demand, as the CUDA
reference sizes its BinningState (rasterizer_impl.cu:280-288): an exclusive
prefix sum of the per-Gaussian tile counts, every rect tile of every
Gaussian emitted, and (with ``tile_cull``) culled slots dropped. Nothing
is ever clipped, so the tcap/big_k/rect_cap capacities have nothing to do.

Emission order is Gaussian-major (each Gaussian's rect tiles row-major,
culled ones removed in place — the same within-Gaussian order as the
compacting tier).
"""

from __future__ import annotations

import torch

from eogs2_tpu_torch.ops.projection import TILE

# conservative slack on the cull threshold, covering f32 rounding drift
# between the closed-form box minimum and the blend's per-pixel test
_CULL_MARGIN = 1e-3


def _tile_qmin(a, b, c, lx, ux, ly, uy):
    """Exact min over the box dx in [lx,ux], dy in [ly,uy] of the
    Mahalanobis quadratic q = a dx^2 + 2 b dx dy + c dy^2 (the blend's power
    is -q/2). Exact for a PSD conic; the four corners make it an
    under-estimate for an indefinite one, so a cull built on it is
    conservative."""
    inside = (lx <= 0) & (0 <= ux) & (ly <= 0) & (0 <= uy)

    def q(dx, dy):
        return a * dx * dx + 2.0 * b * dx * dy + c * dy * dy

    def edge_x(e):  # dx fixed at e, minimize over dy
        t = torch.clamp(-b * e / torch.where(c > 0, c, 1e-12), ly, uy)
        return q(e, t)

    def edge_y(e):  # dy fixed at e, minimize over dx
        t = torch.clamp(-b * e / torch.where(a > 0, a, 1e-12), lx, ux)
        return q(t, e)

    qm = torch.minimum(
        torch.minimum(torch.minimum(edge_x(lx), edge_x(ux)),
                      torch.minimum(edge_y(ly), edge_y(uy))),
        torch.minimum(torch.minimum(q(lx, ly), q(lx, uy)),
                      torch.minimum(q(ux, ly), q(ux, uy))),
    )
    return torch.where(inside, 0.0, qm)


def _slot_cull_mask(rect_min, tx, ty, cull):
    """[P] True where the pair's tile is provably dead: every pixel of the
    tile has alpha < 1/255 or power > 0 (the forward.cu skip pair), so
    dropping the pair is output-exact.

    rect_min [P,2], tx/ty [P] rect offsets, cull = (mean2d [P,2],
    conic [P,3], tau [P]) — all per pair."""
    mean2d, conic, tau = cull
    x0 = (rect_min[:, 0] + tx).to(torch.float32) * TILE
    y0 = (rect_min[:, 1] + ty).to(torch.float32) * TILE
    mx, my = mean2d[:, 0], mean2d[:, 1]
    qmin = _tile_qmin(
        conic[:, 0], conic[:, 1], conic[:, 2],
        mx - (x0 + TILE - 1.0), mx - x0,
        my - (y0 + TILE - 1.0), my - y0,
    )
    dead = qmin > tau + _CULL_MARGIN
    return torch.where(torch.isfinite(qmin), dead, False)


def cull_tau(opacity):
    """Per-Gaussian cull threshold: opac*exp(-q/2) >= 1/255 iff
    q <= 2 ln(255*opac)."""
    return 2.0 * torch.log(torch.clamp_min(opacity, 1e-30) * 255.0)


def emit_pairs(prep, grid_x: int, tile_cull: bool = False):
    """Demand-sized emission.

    Returns (gid [P] int64 Gaussian index, tile [P] int64 tile id) for every
    (Gaussian, rect tile) pair, Gaussian-major; with ``tile_cull`` the
    provably dead pairs are dropped."""
    dev = prep.depth.device
    tiles = prep.tiles_touched.to(torch.int64)
    n = tiles.shape[0]
    total = int(tiles.sum()) if n else 0
    gid = torch.repeat_interleave(
        torch.arange(n, device=dev), tiles, output_size=total
    )
    first = torch.cumsum(tiles, 0) - tiles  # exclusive prefix sum
    j = torch.arange(total, device=dev) - first[gid]
    rect_min = prep.rect_min.to(torch.int64)[gid]
    rw = prep.rect_size[:, 0].to(torch.int64).clamp_min(1)[gid]
    ty = torch.div(j, rw, rounding_mode="floor")
    tx = j - ty * rw
    tile = (rect_min[:, 1] + ty) * grid_x + (rect_min[:, 0] + tx)
    if tile_cull:
        cull = (prep.mean2d[gid], prep.conic[gid],
                cull_tau(prep.opacity)[gid])
        live = ~_slot_cull_mask(rect_min, tx, ty, cull)
        gid, tile = gid[live], tile[live]
    return gid, tile
