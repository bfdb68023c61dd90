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

Backward: K2 (``csrc/fused_blend_bwd.cu``) writes dL/d(payload) per SORTED
pair row (every row belongs to exactly one tile, so no atomics). The rows
go back to per-Gaussian gradients in ``_GatherPairs.backward`` without
atomics either: the emission is Gaussian-major, so scattering the sorted
rows back through the sort's permutation (a permutation: no two rows
collide) leaves each Gaussian's rows contiguous, and one segment sum
(``torch.segment_reduce``, sequential within each segment) adds them in a
fixed order. Gradients are therefore deterministic run to run; JAX does the
same with a return sort and ``emission_reduce``. Autograd of a plain
``index_select`` would use ``index_add_``, which is atomic on CUDA.
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


class _GatherPairs(torch.autograd.Function):
    """cols [k, N] -> cols[:, sgid] [k, P], with a deterministic backward.

    perm [P] is the sort's permutation (sorted row i came from emission row
    perm[i]) and lengths [N] the pairs of each Gaussian in the
    Gaussian-major emission (see the module docstring)."""

    @staticmethod
    def forward(ctx, cols, sgid, perm, lengths):
        ctx.save_for_backward(perm, lengths)
        return cols.index_select(1, sgid)

    @staticmethod
    def backward(ctx, g_pay):
        perm, lengths = ctx.saved_tensors
        k, n = g_pay.shape[0], lengths.shape[0]
        if perm.shape[0] == 0:
            return g_pay.new_zeros((k, n)), None, None, None
        g_em = g_pay.new_empty((perm.shape[0], k))
        g_em[perm] = g_pay.t()  # back to emission order
        g = torch.segment_reduce(g_em, "sum", lengths=lengths, axis=0,
                                 unsafe=True)  # [N, k]
        return g.t(), None, None, None


def sort_pairs(prep: Preprocessed, features, width: int, height: int,
               tile_cull: bool = False, eogs: bool = False) -> SortedPairs:
    """Emission, sort and tile ranges; the sorted payload for K1.

    eogs: features are [rgb, altitude, 1]; the sort depth is then
    -features[:, 3] (detached, as eogs2_tpu's _fused_fwd keys it), and the
    constant row is built from ones, so it carries no gradient (JAX returns
    zeros for it). The altitude row is features[:, 3] itself, bit-equal to
    the negated sort depth, and carries the altitude gradient to xyz."""
    grid_x, grid_y = grid_dims(width, height)
    n_tiles = grid_x * grid_y
    keys = Preprocessed(*(x.detach() for x in prep))
    depth = -features[:, 3].detach() if eogs else keys.depth
    gid, tile = emit_pairs(keys, grid_x, tile_cull=tile_cull)
    key = (tile << 32) | depth_key(depth)[gid]
    skey, perm = torch.sort(key, stable=True)
    lengths = torch.bincount(gid, minlength=depth.shape[0])
    gid = gid[perm]
    cols = [prep.mean2d[:, 0], prep.mean2d[:, 1], prep.conic[:, 0],
            prep.conic[:, 1], prep.conic[:, 2], prep.opacity]
    if eogs:
        cols += [features[:, j] for j in range(4)]
        cols.append(torch.ones_like(depth))
    else:
        cols += [features[:, j] for j in range(features.shape[1])]
    pay = _GatherPairs.apply(torch.stack(cols, 0), gid, perm, lengths)
    bounds = torch.searchsorted(
        skey >> 32, torch.arange(n_tiles + 1, device=skey.device)
    )
    tstart = bounds[:-1].to(torch.int32)
    cnt = (bounds[1:] - bounds[:-1]).to(torch.int32)
    return SortedPairs(pay.contiguous(), tstart, cnt, gid)


def _tile_chunks(cnt, chunk_elems: int):
    """(t0, t1, k_len) ranges of tiles whose padded pair-pixel block holds
    at most ~chunk_elems values; k_len is the chunk's longest range."""
    n_tiles = cnt.shape[0]
    cnt_host = cnt.cpu()
    kmax = max(int(cnt_host.max()), 1) if n_tiles else 1
    tc = max(1, chunk_elems // (P * kmax))
    for t0 in range(0, n_tiles, tc):
        t1 = min(t0 + tc, n_tiles)
        yield t0, t1, int(cnt_host[t0:t1].max())


def _chunk_fields(pay, tstart, cnt, grid_x, t0, t1, k_len):
    """The blend's per pair-pixel quantities for tiles [t0, t1), as the
    kernels compute them: (idx, valid, g, dx, dy, G, alpha, keep, cp,
    live, t_before, w), pair-pixel arrays [tc, K, P]."""
    dev = pay.device
    lpix = torch.arange(P, device=dev)
    ids = torch.arange(t0, t1, device=dev)
    k = torch.arange(k_len, device=dev)
    valid = k[None, :] < cnt[t0:t1, None]  # [tc, K]
    idx = torch.clamp(tstart[t0:t1, None].to(torch.int64) + k[None, :],
                      max=max(pay.shape[1] - 1, 0))
    g = pay[:, idx]  # [NF, tc, K]
    px = ((ids % grid_x) * TILE).to(torch.float32)[:, None] + \
        (lpix % TILE).to(torch.float32)  # [tc, P]
    py = ((ids // grid_x) * TILE).to(torch.float32)[:, None] + \
        (lpix // TILE).to(torch.float32)
    dx = g[0][..., None] - px[:, None, :]  # [tc, K, P]
    dy = g[1][..., None] - py[:, None, :]
    a, b, c = g[2][..., None], g[3][..., None], g[4][..., None]
    power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
    G = torch.exp(torch.clamp_max(power, 0.0))
    alpha_raw = torch.clamp_max(g[5][..., None] * G, ALPHA_MAX)
    keep = valid[..., None] & (power <= POWER_TOL) & (alpha_raw >= ALPHA_EPS)
    alpha = torch.where(keep, alpha_raw, 0.0)
    cp = torch.cumprod(1.0 - alpha, dim=1)  # T after each pair
    live = cp >= T_EPS
    t_before = torch.cat([torch.ones_like(cp[:, :1]), cp[:, :-1]], dim=1)
    w = torch.where(live, alpha * t_before, 0.0)
    return idx, valid, g, dx, dy, G, alpha, keep, cp, live, t_before, w


def fused_blend_fwd_plain(pay, tstart, cnt, grid_x: int,
                          chunk_elems: int = 1 << 25):
    """Plain PyTorch version of K1 (same function, same [T, P, 8] output).

    Pads each tile's pairs to the longest range of its chunk of tiles and
    composites with a cumprod over the pair axis, chunked over tiles so that
    a chunk holds at most ~chunk_elems pair-pixel values. The pair axis is
    not the innermost one: torch then scans it sequentially per pixel, so the
    products round as the kernel's T *= (1 - alpha) does."""
    n_tiles = tstart.shape[0]
    out8 = torch.zeros((n_tiles, P, 8), dtype=torch.float32, device=pay.device)
    for t0, t1, k_len in _tile_chunks(cnt, chunk_elems):
        if k_len == 0:
            out8[t0:t1, :, 5] = 1.0
            continue
        _, _, g, _, _, _, _, keep, cp, live, _, w = _chunk_fields(
            pay, tstart, cnt, grid_x, t0, t1, k_len)
        out8[t0:t1, :, :NC] = torch.einsum("tkp,ctk->tpc", w, g[6:6 + NC])
        out8[t0:t1, :, 5] = torch.where(live, cp, 1.0).amin(dim=1)
        pos = torch.arange(1, k_len + 1, device=pay.device,
                           dtype=torch.float32)[None, :, None]
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
    n_tiles = _check_blend_inputs("fused_blend_fwd", pay, tstart, cnt)
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


def fused_blend_bwd_plain(pay, tstart, cnt, out8, g_out8, grid_x: int,
                          chunk_elems: int = 1 << 24):
    """Plain PyTorch version of K2 (same function, same [NF, P] output).

    Recomputes the forward per chunk of tiles as fused_blend_fwd_plain does,
    then, per pair and pixel (front to back, cumsum over the pair axis):

      fdot    = sum_c g_pix_c f_c,  total = sum_c acc_c g_pix_c
      suffix  = total - (prefix of w fdot, this pair included)
      g_alpha = fdot T_before - (suffix + final_T g_ft) / (1 - alpha)
                (0 unless the pair is kept and live)
      gG      = g_alpha op G,  G = exp(min(power, 0))

    and sums over the tile's pixels: g_mx = -gG (a dx + b dy), g_my =
    -gG (c dy + b dx), g_a = -gG dx^2 / 2, g_b = -gG dx dy, g_c = -gG dy^2 / 2,
    g_op = g_alpha G, g_f = w g_pix. No derivative through the 0.99 clamp,
    and the gradient flows through min(power, 0) as if it were power (JAX's
    conventions, eogs2_tpu/ops/fused_raster.py:_bwd_kernel_col)."""
    g_pay = torch.zeros_like(pay)
    for t0, t1, k_len in _tile_chunks(cnt, chunk_elems):
        if k_len == 0:
            continue
        idx, valid, g, dx, dy, G, alpha, keep, _, live, t_before, w = \
            _chunk_fields(pay, tstart, cnt, grid_x, t0, t1, k_len)
        o, go = out8[t0:t1], g_out8[t0:t1]  # [tc, P, 8]
        g_pix = go[..., :NC]
        total = (o[..., :NC] * g_pix).sum(-1)[:, None, :]  # [tc, 1, P]
        tail = (o[..., 5] * go[..., 5])[:, None, :]
        fdot = torch.einsum("ctk,tpc->tkp", g[6:6 + NC], g_pix)
        suffix = total - torch.cumsum(w * fdot, dim=1)
        g_alpha = fdot * t_before - (suffix + tail) / (1.0 - alpha)
        g_alpha = torch.where(keep & live, g_alpha, 0.0)
        gG = g_alpha * (g[5][..., None] * G)
        a, b, c = g[2][..., None], g[3][..., None], g[4][..., None]
        rows = torch.stack([
            -(gG * (a * dx + b * dy)).sum(-1),
            -(gG * (c * dy + b * dx)).sum(-1),
            (-0.5 * gG * dx * dx).sum(-1),
            (-gG * dx * dy).sum(-1),
            (-0.5 * gG * dy * dy).sum(-1),
            (g_alpha * G).sum(-1),
        ] + list(torch.einsum("tkp,tpc->ctk", w, g_pix)))  # [NF, tc, K]
        g_pay[:, idx[valid]] = rows[:, valid]
    return g_pay


def _check_blend_inputs(name, pay, tstart, cnt, *maps):
    """Validate the kernels' inputs on the card; returns the tile count."""
    n_tiles = tstart.shape[0]
    if pay.dtype != torch.float32 or pay.dim() != 2 or pay.shape[0] != NF:
        raise ValueError(f"pay must be float32 [{NF}, P], got "
                         f"{pay.dtype} {tuple(pay.shape)}")
    for arg, x in (("tstart", tstart), ("cnt", cnt)):
        if x.dtype != torch.int32 or x.shape != (n_tiles,):
            raise ValueError(f"{arg} must be int32 [{n_tiles}], got "
                             f"{x.dtype} {tuple(x.shape)}")
    for arg, x in maps:
        if x.dtype != torch.float32 or x.shape != (n_tiles, P, 8):
            raise ValueError(f"{arg} must be float32 [{n_tiles}, {P}, 8], "
                             f"got {x.dtype} {tuple(x.shape)}")
    for arg, x in (("pay", pay), ("tstart", tstart), ("cnt", cnt), *maps):
        if x.device != pay.device or not x.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous on "
                             f"{pay.device}")
    return n_tiles


def fused_blend_bwd(pay, tstart, cnt, out8, g_out8, grid_x: int):
    """K2: per sorted pair row, dL/d(mx, my, conic a, b, c, opacity,
    f0..f4) -> g_pay [NF, P] float32 (rows no pixel reached are 0).

    out8 is K1's output for the same inputs, g_out8 its cotangent (channels
    0-4 the pre-background channels, 5 final_T; 6-7 ignored). CPU tensors go
    to :func:`fused_blend_bwd_plain`; CUDA tensors launch the hand-written
    kernel (csrc/fused_blend_bwd.cu, built at first use) or raise, never
    falling back to the plain version on the card."""
    if grid_x < 1 or tstart.shape[0] % grid_x:
        raise ValueError(f"{tstart.shape[0]} tiles do not fill rows of "
                         f"grid_x={grid_x}")
    if pay.device.type == "cpu":
        return fused_blend_bwd_plain(pay, tstart, cnt, out8, g_out8, grid_x)
    if pay.device.type != "cuda":
        raise ValueError(f"fused_blend_bwd: unsupported device {pay.device}")
    n_tiles = _check_blend_inputs("fused_blend_bwd", pay, tstart, cnt,
                                  ("out8", out8), ("g_out8", g_out8))
    from eogs2_tpu_torch.ops import cuda_build

    fn = cuda_build.load("fused_blend_bwd").eogs2_fused_blend_bwd
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    g_pay = torch.empty_like(pay)
    with torch.cuda.device(pay.device):
        err = fn(pay.data_ptr(), pay.shape[1], tstart.data_ptr(),
                 cnt.data_ptr(), n_tiles, grid_x, out8.data_ptr(),
                 g_out8.data_ptr(), g_pay.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_blend_bwd kernel launch failed: CUDA "
                           f"error {err}")
    fused_blend_bwd.launches += 1
    return g_pay


fused_blend_bwd.launches = 0  # kernel launches on the card


class FusedBlend(torch.autograd.Function):
    """Differentiable K1; its backward is kernel K2."""

    @staticmethod
    def forward(ctx, pay, tstart, cnt, grid_x):
        out8 = fused_blend_fwd(pay, tstart, cnt, grid_x)
        ctx.save_for_backward(pay, tstart, cnt, out8)
        ctx.grid_x = grid_x
        return out8

    @staticmethod
    def backward(ctx, g_out8):
        pay, tstart, cnt, out8 = ctx.saved_tensors
        g_pay = fused_blend_bwd(pay, tstart, cnt, out8, g_out8.contiguous(),
                                ctx.grid_x)
        return g_pay, None, None, None


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
