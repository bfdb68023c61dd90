"""Tile-local alpha compositing of the dense modes, as plain tensor code.

Counterpart of ``eogs2_tpu/ops/blend.py``: the ``use_pallas=False`` route
of the ``gather`` and ``sorted`` modes, which the JAX package also runs as
plain array code with no Pallas kernel. It stays plain PyTorch on every
device. (K4, the kernel of ``use_pallas``, is ops/blend_cuda.py.)

Per tile, the K slots are composited as vectorised scans:

  alpha_k = min(0.99, op_k exp(min(power_k, 0))), zeroed when the slot is
            empty, power > 0 or alpha < 1/255 (the CUDA skip rules)
  cp_k    = exp(cumsum_k log1p(-alpha))   (transmittance after k)
  live_k  = cp_k >= 1e-4                  (a prefix of the slots)
  out     = sum_k f_k alpha_k cp_k / (1 - alpha_k) [live]  +  final_t bg

The custom backward (``use_custom_vjp``) is JAX's hand-derived one: suffix
sums instead of the CUDA back-to-front recurrence, and no derivative
through the 0.99 clamp (the reference's quirk, backward.cu:574,624); it
keeps only the inputs and recomputes the forward. Without it, autograd runs
through a checkpointed forward.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from eogs2_tpu_torch.ops.projection import TILE

ALPHA_EPS = 1.0 / 255.0  # a pair with alpha below this is skipped
ALPHA_MAX = 0.99  # alpha clamp
T_EPS = 1e-4  # a pixel stops once its transmittance would fall below this


def _pixel_grid(origins):
    """[T, TILE*TILE, 2] pixel coordinates of tiles at origins [T, 2]."""
    r = torch.arange(TILE, dtype=origins.dtype, device=origins.device)
    py, px = torch.meshgrid(r, r, indexing="ij")
    pix = torch.stack([px.reshape(-1), py.reshape(-1)], dim=-1)
    return origins[:, None, :] + pix[None]


def _alphas(mean2d, conic, opacity, mask, origins):
    """Effective alpha [T, P, K] with all CUDA skip rules; also G, dx, dy
    and the keep mask."""
    d = mean2d[:, None, :, :] - _pixel_grid(origins)[:, :, None, :]
    dx, dy = d[..., 0], d[..., 1]
    a, b, c = (conic[:, None, :, i] for i in range(3))
    power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
    g = torch.exp(torch.clamp_max(power, 0.0))
    alpha_raw = torch.clamp_max(opacity[:, None, :] * g, ALPHA_MAX)
    keep = mask[:, None, :] & (power <= 0.0) & (alpha_raw >= ALPHA_EPS)
    return torch.where(keep, alpha_raw, 0.0), g, dx, dy, keep


def _composite(alpha):
    """(one_minus, logs, cp, live, t_before, w), each [T, P, K]."""
    one_minus = 1.0 - alpha
    logs = torch.log1p(-alpha)
    cp = torch.exp(torch.cumsum(logs, dim=-1))
    live = cp >= T_EPS
    t_before = cp / one_minus  # one_minus >= 0.01
    w = torch.where(live, alpha * t_before, 0.0)
    return one_minus, logs, cp, live, t_before, w


def _blend_forward(mean2d, conic, opacity, feat, mask, origins, bg):
    alpha, _, _, _, _ = _alphas(mean2d, conic, opacity, mask, origins)
    _, logs, _, live, _, w = _composite(alpha)
    out = w @ feat  # [T, P, C]
    final_t = torch.exp(torch.where(live, logs, 0.0).sum(-1))
    return out + final_t[..., None] * bg, final_t


class _BlendTiles(torch.autograd.Function):
    """Composite a chunk of tiles; the backward is JAX's closed form."""

    @staticmethod
    def forward(ctx, mean2d, conic, opacity, feat, mask, origins, bg):
        out, final_t = _blend_forward(mean2d, conic, opacity, feat, mask,
                                      origins, bg)
        ctx.save_for_backward(mean2d, conic, opacity, feat, mask, origins,
                              bg, final_t)
        return out, final_t

    @staticmethod
    def backward(ctx, g_out, g_final_t):
        mean2d, conic, opacity, feat, mask, origins, bg, final_t = \
            ctx.saved_tensors
        alpha, g, dx, dy, keep = _alphas(mean2d, conic, opacity, mask,
                                         origins)
        one_minus, _, _, live, t_before, w = _composite(alpha)
        g_feat = w.transpose(1, 2) @ g_out  # [T, K, C]
        fdot = g_out @ feat.transpose(1, 2)  # [T, P, K]
        contrib = w * fdot
        suffix = contrib.sum(-1, keepdim=True) - torch.cumsum(contrib, -1)
        bg_dot = g_out @ bg + g_final_t  # [T, P]
        g_alpha = fdot * t_before - (
            suffix + final_t[..., None] * bg_dot[..., None]) / one_minus
        g_alpha = torch.where(live & keep, g_alpha, 0.0)
        g_opacity = (g_alpha * g).sum(1)
        gG = g_alpha * opacity[:, None, :] * g
        a, b, c = (conic[:, None, :, i] for i in range(3))
        g_mean2d = torch.stack([(gG * (-(a * dx) - b * dy)).sum(1),
                                (gG * (-(c * dy) - b * dx)).sum(1)], -1)
        g_conic = torch.stack([(gG * (-0.5 * dx * dx)).sum(1),
                               (gG * (-dx * dy)).sum(1),
                               (gG * (-0.5 * dy * dy)).sum(1)], -1)
        g_bg = (final_t[..., None] * g_out).sum((0, 1))
        return g_mean2d, g_conic, g_opacity, g_feat, None, None, g_bg


def blend_tile(mean2d, conic, opacity, feat, mask, origin, bg):
    """Composite one 16x16 tile.

    mean2d [K,2] pixel-space centres (front-to-back sorted), conic [K,3],
    opacity [K], feat [K,C], mask [K] bool, origin [2] the tile's top-left
    pixel, bg [C] composited as out + T_final * bg (forward.cu:401-410).
    Returns (out [TILE*TILE, C], final_t [TILE*TILE])."""
    out, final_t = _BlendTiles.apply(mean2d[None], conic[None], opacity[None],
                                     feat[None], mask[None], origin[None], bg)
    return out[0], final_t[0]


def blend_tiles(mean2d, conic, opacity, feat, mask, origins, bg,
                tile_chunk=64, use_custom_vjp=True):
    """Composite a batch of tiles with bounded memory.

    mean2d [T,K,2], conic [T,K,3], opacity [T,K], feat [T,K,C], mask [T,K]
    bool, origins [T,2] pixel origin per tile, bg [C]. tile_chunk tiles are
    composited at a time, so the [chunk, P, K] intermediates stay bounded
    (the custom backward recomputes them per chunk). use_custom_vjp: the
    hand-derived backward; otherwise autograd through a checkpointed
    forward. Returns (out [T, TILE*TILE, C], final_t [T, TILE*TILE])."""
    outs, fts = [], []
    for t0 in range(0, mean2d.shape[0], max(1, tile_chunk)):
        args = [x[t0:t0 + tile_chunk] for x in (mean2d, conic, opacity, feat,
                                                 mask, origins)]
        if use_custom_vjp:
            out, ft = _BlendTiles.apply(*args, bg)
        else:
            out, ft = checkpoint(_blend_forward, *args, bg,
                                 use_reentrant=False)
        outs.append(out)
        fts.append(ft)
    return torch.cat(outs), torch.cat(fts)
