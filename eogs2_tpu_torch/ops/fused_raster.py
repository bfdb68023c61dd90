"""Fused rasterization: demand-sized emission, one sort, the K1 blend kernel.

Counterpart of ``eogs2_tpu/ops/fused_raster.py`` (forward). After one sort
of the (tile, depth) keys each tile's pairs are a contiguous range
[tstart[t], tstart[t] + cnt[t]) of the sorted payload, and the blend kernel
K1 (``csrc/fused_blend_fwd.cu``) walks that range per tile.

Differences from the JAX package, all deliberate:

  * Emission is sized by true demand (ops/pair_pipeline.emit_pairs), so
    the static tcap / big_k / big_tcap / rect_cap / big_rect_cap tiers of
    ``_emission_tabs`` do not exist and never clip.
  * The blend walks EVERY pair of a tile, as the CUDA reference does: the
    port does not stop at ``tile_capacity`` (the JAX kernel walks
    min(cnt, tile_capacity)). So ``clipped_pairs`` is always 0 here; the
    parity tests run JAX with tile_capacity >= max_tile_count.
  * The sort is ONE stable ``torch.sort`` of an int64 key
    ``tile << 32 | orderable(depth)``. depth = -altitude takes both signs,
    so the raw float bits would mis-order negative depths: the key flips all
    bits of a negative float and sets the sign bit of a positive one, which
    orders the uint32 keys as the floats.
  * Tie order: the emission is Gaussian-major here and tcap-major in JAX,
    so two pairs with exactly equal (tile, depth) keys composite in a
    different order than in JAX (both sorts are stable over their own
    emission). Parity scenes have no exact depth ties; seeded random means
    have none.
  * The payload is a structure of arrays [11, P] float32 (mx, my, conic
    a/b/c, opacity, 5 features), 44 B/pair. The TPU layout knobs
    (payload_col, k_chunk, early_exit, tile_chunk) only change the JAX
    kernels' layout, never their output, and are ignored.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from eogs2_tpu_torch.ops.binning import grid_dims
from eogs2_tpu_torch.ops.blend import ALPHA_EPS, ALPHA_MAX, T_EPS
from eogs2_tpu_torch.ops.pair_pipeline import emit_pairs
from eogs2_tpu_torch.ops.projection import TILE, Preprocessed

P = TILE * TILE  # pixels per tile
NF = 11  # payload rows: mx, my, conic a/b/c, opacity, 5 features
NC = 5  # feature channels the blend composites
POWER_TOL = 1e-4  # keep rule power <= 1e-4 (see csrc/fused_blend_fwd.cu)


class FusedOut(NamedTuple):
    out8: torch.Tensor  # [T, P, 8]: 5 channels, final_t, n_contrib, 0
    tile_count: torch.Tensor  # [T] pairs per tile
    num_pairs: torch.Tensor  # [] demand (live pairs when tile_cull)
    max_tile_count: torch.Tensor  # [] densest tile
    clipped_pairs: torch.Tensor  # [] always 0: emission and blend never clip
    bulk_max_tiles: torch.Tensor  # [] widest Gaussian (active tiles w/ cull)
    big_max_tiles: torch.Tensor  # [] widest Gaussian rect
    bulk_rect_max_tiles: torch.Tensor  # [] widest Gaussian rect


class SortedPairs(NamedTuple):
    pay: torch.Tensor  # [NF, P] f32 payload in (tile, depth) order
    tstart: torch.Tensor  # [T] i32 first sorted pair of each tile
    cnt: torch.Tensor  # [T] i32 pairs per tile
    gid: torch.Tensor  # [P] i64 Gaussian of each sorted pair


def depth_key(depth):
    """float32 [N] -> int64 [N] in [0, 2^32) ordered as the floats."""
    bits = depth.contiguous().view(torch.int32).to(torch.int64)
    return torch.where(bits < 0, ~bits & 0xFFFFFFFF, bits | 0x80000000)


def sort_pairs(prep: Preprocessed, features, width: int, height: int,
               tile_cull: bool = False, eogs: bool = False) -> SortedPairs:
    """Emission, sort and tile ranges; the sorted payload for K1.

    eogs: features are [rgb, altitude, 1]; the sort depth is then
    -features[:, 3], the altitude row is rebuilt from the sorted key and the
    constant row from ones (as eogs2_tpu's _fused_fwd does)."""
    grid_x, grid_y = grid_dims(width, height)
    n_tiles = grid_x * grid_y
    keys = Preprocessed(*(x.detach() for x in prep))
    depth = -features[:, 3].detach() if eogs else keys.depth
    gid, tile = emit_pairs(keys, grid_x, tile_cull=tile_cull)
    key = (tile << 32) | depth_key(depth)[gid]
    skey, perm = torch.sort(key, stable=True)
    gid = gid[perm]
    cols = [prep.mean2d[:, 0], prep.mean2d[:, 1], prep.conic[:, 0],
            prep.conic[:, 1], prep.conic[:, 2], prep.opacity]
    if eogs:
        cols += [features[:, j] for j in range(3)]
    else:
        cols += [features[:, j] for j in range(features.shape[1])]
    pay = torch.stack(cols, 0).index_select(1, gid)
    if eogs:
        sdepth = depth[gid]
        pay = torch.cat([pay, -sdepth[None], torch.ones_like(sdepth)[None]])
    bounds = torch.searchsorted(
        skey >> 32, torch.arange(n_tiles + 1, device=skey.device)
    )
    tstart = bounds[:-1].to(torch.int32)
    cnt = (bounds[1:] - bounds[:-1]).to(torch.int32)
    return SortedPairs(pay.contiguous(), tstart, cnt, gid)


def fused_blend_fwd_plain(pay, tstart, cnt, grid_x: int,
                          chunk_elems: int = 1 << 25):
    """Plain PyTorch version of K1 (same function, same [T, P, 8] output).

    Pads each tile's pairs to the longest range of its chunk of tiles and
    composites with a cumprod over the pair axis, chunked over tiles so that
    a chunk holds at most ~chunk_elems pair-pixel values. The pair axis is
    not the innermost one: torch then scans it sequentially per pixel, so the
    products round as the kernel's T *= (1 - alpha) does."""
    dev = pay.device
    n_tiles = tstart.shape[0]
    out8 = torch.zeros((n_tiles, P, 8), dtype=torch.float32, device=dev)
    cnt_host = cnt.cpu()
    kmax = max(int(cnt_host.max()), 1) if n_tiles else 1
    tc = max(1, chunk_elems // (P * kmax))
    lpix = torch.arange(P, device=dev)
    lx = (lpix % TILE).to(torch.float32)
    ly = (lpix // TILE).to(torch.float32)
    last = max(pay.shape[1] - 1, 0)
    for t0 in range(0, n_tiles, tc):
        t1 = min(t0 + tc, n_tiles)
        k_len = int(cnt_host[t0:t1].max())
        if k_len == 0:
            out8[t0:t1, :, 5] = 1.0
            continue
        ids = torch.arange(t0, t1, device=dev)
        k = torch.arange(k_len, device=dev)
        valid = k[None, :] < cnt[t0:t1, None]  # [tc, K]
        idx = torch.clamp(tstart[t0:t1, None].to(torch.int64) + k[None, :],
                          max=last)
        g = pay[:, idx]  # [NF, tc, K]
        px = ((ids % grid_x) * TILE).to(torch.float32)[:, None] + lx  # [tc, P]
        py = ((ids // grid_x) * TILE).to(torch.float32)[:, None] + ly
        dx = g[0][..., None] - px[:, None, :]  # [tc, K, P]
        dy = g[1][..., None] - py[:, None, :]
        a, b, c = g[2][..., None], g[3][..., None], g[4][..., None]
        power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
        alpha_raw = torch.clamp_max(
            g[5][..., None] * torch.exp(torch.clamp_max(power, 0.0)), ALPHA_MAX
        )
        keep = valid[..., None] & (power <= POWER_TOL) & (alpha_raw >= ALPHA_EPS)
        alpha = torch.where(keep, alpha_raw, 0.0)
        cp = torch.cumprod(1.0 - alpha, dim=1)  # T after each pair
        live = cp >= T_EPS
        t_before = torch.cat([torch.ones_like(cp[:, :1]), cp[:, :-1]], dim=1)
        w = torch.where(live, alpha * t_before, 0.0)
        out8[t0:t1, :, :NC] = torch.einsum("tkp,ctk->tpc", w, g[6:6 + NC])
        out8[t0:t1, :, 5] = torch.where(live, cp, 1.0).amin(dim=1)
        pos = (k + 1).to(torch.float32)[None, :, None]
        out8[t0:t1, :, 6] = torch.where(keep & live, pos, 0.0).amax(dim=1)
    return out8


def fused_blend_fwd(pay, tstart, cnt, grid_x: int):
    """K1: per-tile front-to-back composite -> out8 [T, 256, 8] float32.

    CPU tensors go to :func:`fused_blend_fwd_plain`. CUDA tensors launch the
    hand-written kernel (csrc/fused_blend_fwd.cu, built at first use) or
    raise; nothing on the card falls back to the plain version.

    The ranges must lie inside the payload (tstart + cnt <= pay.shape[1]),
    as sort_pairs makes them; the kernel does not check it, since that
    would wait for the card."""
    if grid_x < 1 or tstart.shape[0] % grid_x:
        raise ValueError(f"{tstart.shape[0]} tiles do not fill rows of "
                         f"grid_x={grid_x}")
    if pay.device.type == "cpu":
        return fused_blend_fwd_plain(pay, tstart, cnt, grid_x)
    if pay.device.type != "cuda":
        raise ValueError(f"fused_blend_fwd: unsupported device {pay.device}")
    n_tiles = tstart.shape[0]
    if pay.dtype != torch.float32 or pay.dim() != 2 or pay.shape[0] != NF:
        raise ValueError(f"pay must be float32 [{NF}, P], got "
                         f"{pay.dtype} {tuple(pay.shape)}")
    for name, x in (("tstart", tstart), ("cnt", cnt)):
        if x.dtype != torch.int32 or x.shape != (n_tiles,):
            raise ValueError(f"{name} must be int32 [{n_tiles}], got "
                             f"{x.dtype} {tuple(x.shape)}")
    for name, x in (("pay", pay), ("tstart", tstart), ("cnt", cnt)):
        if x.device != pay.device or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {pay.device}")
    from eogs2_tpu_torch.ops import cuda_build

    lib = cuda_build.load("fused_blend_fwd")
    fn = lib.eogs2_fused_blend_fwd
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out8 = torch.empty((n_tiles, P, 8), dtype=torch.float32, device=pay.device)
    with torch.cuda.device(pay.device):
        err = fn(pay.data_ptr(), pay.shape[1], tstart.data_ptr(),
                 cnt.data_ptr(), n_tiles, grid_x, out8.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_blend_fwd kernel launch failed: CUDA "
                           f"error {err}")
    fused_blend_fwd.launches += 1
    return out8


fused_blend_fwd.launches = 0  # kernel launches on the card


class FusedBlend(torch.autograd.Function):
    """Differentiable wrapper of K1; its backward is kernel K2."""

    @staticmethod
    def forward(ctx, pay, tstart, cnt, grid_x):
        return fused_blend_fwd(pay, tstart, cnt, grid_x)

    @staticmethod
    def backward(ctx, g_out8):
        raise NotImplementedError("K2 lands with the training slice")


def rasterize_fused(prep: Preprocessed, features, width: int, height: int,
                    eogs_features: bool = False,
                    tile_cull: bool = False) -> FusedOut:
    """Fused forward: FusedOut with out8 before the background composite.

    eogs_features: features are [rgb, altitude, 1] (renderer.py's layout);
    the sort depth is then -features[:, 3] (see sort_pairs).
    tile_cull: drop provably dead pairs at emission (output-exact)."""
    grid_x, _ = grid_dims(width, height)
    if features.shape[1] != NC:
        raise ValueError(f"the fused blend composites {NC} channels, got "
                         f"features of shape {tuple(features.shape)}")
    eogs = bool(eogs_features)
    sp = sort_pairs(prep, features, width, height, tile_cull, eogs)
    out8 = FusedBlend.apply(sp.pay, sp.tstart, sp.cnt, grid_x)
    dev = out8.device
    tiles = prep.tiles_touched.to(torch.int64)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    rect_max = tiles.max() if tiles.numel() else zero
    if tile_cull:
        # demand under culling is the live pair count (dead tiles are not
        # demand), per Gaussian its live tiles
        num_pairs = torch.tensor(sp.gid.shape[0], device=dev)
        active = torch.bincount(sp.gid, minlength=tiles.shape[0])
        bulk_max = active.max() if active.numel() else zero
    else:
        num_pairs = tiles.sum()
        bulk_max = rect_max
    return FusedOut(
        out8=out8,
        tile_count=sp.cnt,
        num_pairs=num_pairs,
        max_tile_count=sp.cnt.max(),
        clipped_pairs=zero,
        bulk_max_tiles=bulk_max,
        big_max_tiles=rect_max,
        bulk_rect_max_tiles=rect_max,
    )
