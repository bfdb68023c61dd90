"""Fused rasterization: demand-sized emission, one sort, the K1/K3 blend.

Counterpart of ``eogs2_tpu/ops/fused_raster.py``. After one sort of the
(tile, depth) keys each tile's pairs are a contiguous range
[tstart[t], tstart[t] + cnt[t]) of the sorted payload, and the blend kernel
walks that range per tile: K1 (``csrc/fused_blend_fwd.cu``) on the column
payload, K3 (the same source, row load) on the row payload.

Differences from the JAX package, all deliberate:

  * Emission is sized by true demand (ops/pair_pipeline.emit_pairs; on
    the card the count and write passes of ``csrc/emit_pairs.cu``), so
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
  * The payload holds 11 fields per pair (mx, my, conic a/b/c, opacity, 5
    features) in one of two layouts, as JAX's ``payload_col`` chooses:
    columns, a structure of arrays [11, P] float32 (44 B/pair, K1/K2), or
    rows, [P, 16] float32 with one 64-byte row per pair and fields 11-15
    zero (K3; JAX's wide layout pads each row to 128 lanes for the TPU).
    Both give the same bits. The other TPU knobs (k_chunk, early_exit,
    tile_chunk) change no output and are ignored.

Backward: K2 (``csrc/fused_blend_bwd.cu``; K3 on rows) writes dL/d(payload)
per SORTED pair (every pair belongs to exactly one tile, so no atomics). The
pairs go back to per-Gaussian gradients in ``_GatherPairs.backward``
without atomics either: the emission is Gaussian-major, so scattering the
sorted rows back through the sort's permutation (a permutation: no two rows
collide) leaves each Gaussian's rows contiguous, and one segment sum
(``torch.segment_reduce``, sequential within each segment) adds them in a
fixed order. Gradients are therefore deterministic run to run; JAX does the
same with a return sort and ``emission_reduce``. Autograd of a plain
``index_select`` would use ``index_add_``, which is atomic on CUDA.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from eogs2_tpu_torch.observability import host_read, span
from eogs2_tpu_torch.ops.binning import grid_dims, sort_emission
from eogs2_tpu_torch.ops.blend import ALPHA_EPS, ALPHA_MAX, T_EPS
from eogs2_tpu_torch.ops.pair_pipeline import emission_sum, emit_pairs
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


NFR = 16  # row payload width: the 11 fields and 5 zeros, 64 B per pair


class SortedPairs(NamedTuple):
    pay: torch.Tensor  # [NF, P] (columns) or [P, NFR] (rows) f32, sorted
    tstart: torch.Tensor  # [T] i32 first sorted pair of each tile
    cnt: torch.Tensor  # [T] i32 pairs per tile
    gid: torch.Tensor  # [P] i64 Gaussian of each sorted pair
    lengths: Optional[torch.Tensor] = None  # [N] i64 pairs of each Gaussian


class _GatherPairs(torch.autograd.Function):
    """x.index_select(dim, sgid): per-Gaussian [k, N] columns (dim 1) or
    [N, k] rows (dim 0) -> per sorted pair, with a deterministic backward.

    perm [P] is the sort's permutation (sorted pair i came from emission
    pair perm[i]) and lengths [N] the pairs of each Gaussian in the
    Gaussian-major emission (see the module docstring)."""

    @staticmethod
    def forward(ctx, x, sgid, perm, lengths, dim=1):
        ctx.save_for_backward(perm, lengths)
        ctx.dim = dim
        return x.index_select(dim, sgid)

    @staticmethod
    def backward(ctx, g_pay):
        perm, lengths = ctx.saved_tensors
        g_rows = g_pay if ctx.dim == 0 else g_pay.t()  # [P, k]
        g = emission_sum(g_rows, perm, lengths)  # [N, k]
        return (g if ctx.dim == 0 else g.t()), None, None, None, None


def sort_pairs(prep: Preprocessed, features, width: int, height: int,
               tile_cull: bool = False, eogs: bool = False,
               rows: bool = False) -> SortedPairs:
    """Emission, sort and tile ranges; the sorted payload for K1, or for K3
    with ``rows`` ([P, 16], one 64-byte row per pair).

    eogs: features are [rgb, altitude, 1]; the sort depth is then
    -features[:, 3] (detached, as eogs2_tpu's _fused_fwd keys it), and the
    constant row is built from ones, so it carries no gradient (JAX returns
    zeros for it). The altitude row is features[:, 3] itself, bit-equal to
    the negated sort depth, and carries the altitude gradient to xyz."""
    grid_x, grid_y = grid_dims(width, height)
    keys = Preprocessed(*(x.detach() for x in prep))
    depth = -features[:, 3].detach() if eogs else keys.depth
    with span("raster.emission"):
        em = emit_pairs(keys, grid_x, tile_cull=tile_cull, depth=depth)
        gid, perm, tstart, cnt = sort_emission(em, grid_x * grid_y)
        lengths = em.lengths
    pay = _GatherPairs.apply(payload(prep, features, eogs, rows), gid, perm,
                             lengths, 0 if rows else 1)
    return SortedPairs(pay.contiguous(), tstart, cnt, gid, lengths)


def payload(prep: Preprocessed, features, eogs: bool = False,
            rows: bool = False):
    """The per-Gaussian payload the pairs gather: [11, N], or [N, 16] with
    ``rows`` (5 zero fields more); eogs as in sort_pairs."""
    if features.shape[1] != NC:
        raise ValueError(f"the blend composites {NC} channels, got features "
                         f"of shape {tuple(features.shape)}")
    cols = [prep.mean2d[:, 0], prep.mean2d[:, 1], prep.conic[:, 0],
            prep.conic[:, 1], prep.conic[:, 2], prep.opacity]
    cols += [features[:, j] for j in range(NC - 1 if eogs else NC)]
    if eogs:
        cols.append(torch.ones_like(prep.opacity))
    if rows:
        cols += [torch.zeros_like(prep.opacity)] * (NFR - NF)
    return torch.stack(cols, 1 if rows else 0)


def _tile_chunks(cnt, chunk_elems: int):
    """(t0, t1, k_len) ranges of tiles whose padded pair-pixel block holds
    at most ~chunk_elems values; k_len is the chunk's longest range."""
    n_tiles = cnt.shape[0]
    cnt_host = host_read(cnt.cpu, "blend_plain.cnt")
    kmax = max(int(cnt_host.max()), 1) if n_tiles else 1
    tc = max(1, chunk_elems // (P * kmax))
    for t0 in range(0, n_tiles, tc):
        t1 = min(t0 + tc, n_tiles)
        yield t0, t1, int(cnt_host[t0:t1].max())


def _chunk_fields(pay, tstart, cnt, grid_x, t0, t1, k_len, tile0=0):
    """The blend's per pair-pixel quantities for tiles [t0, t1), as the
    kernels compute them: (idx, valid, g, dx, dy, G, alpha, keep, cp,
    live, t_before, w), pair-pixel arrays [tc, K, P]. Local tile t has the
    pixels of global tile tile0 + t."""
    dev = pay.device
    lpix = torch.arange(P, device=dev)
    ids = torch.arange(t0 + tile0, t1 + tile0, device=dev)
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


def fused_blend_fwd_plain(pay, tstart, cnt, grid_x: int, tile0: int = 0,
                          chunk_elems: int = 1 << 25):
    """Plain PyTorch version of K1 (same function, same [T, P, 8] output;
    local tile t covers the pixels of global tile tile0 + t).

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
            pay, tstart, cnt, grid_x, t0, t1, k_len, tile0)
        out8[t0:t1, :, :NC] = torch.einsum("tkp,ctk->tpc", w, g[6:6 + NC])
        out8[t0:t1, :, 5] = torch.where(live, cp, 1.0).amin(dim=1)
        pos = torch.arange(1, k_len + 1, device=pay.device,
                           dtype=torch.float32)[None, :, None]
        out8[t0:t1, :, 6] = torch.where(keep & live, pos, 0.0).amax(dim=1)
    return out8


def _check_grid(tstart, grid_x):
    if grid_x < 1 or tstart.shape[0] % grid_x:
        raise ValueError(f"{tstart.shape[0]} tiles do not fill rows of "
                         f"grid_x={grid_x}")


def _on_card(name, pay):
    """True for a CUDA payload (launch the kernel), False for a CPU one
    (take the plain version); any other device raises."""
    if pay.device.type == "cpu":
        return False
    if pay.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {pay.device}")
    return True


_VP, _I = ctypes.c_void_p, ctypes.c_int


def fused_blend_fwd(pay, tstart, cnt, grid_x: int, tile0: int = 0):
    """K1: per-tile front-to-back composite -> out8 [T, 256, 8] float32.
    Local tile t is global tile tile0 + t of a frame grid_x tiles wide (a
    row band's first tile on the multi-device path, 0 on the whole frame).

    CPU tensors go to :func:`fused_blend_fwd_plain`. CUDA tensors launch the
    hand-written kernel (csrc/fused_blend_fwd.cu, built at first use) or
    raise; nothing on the card falls back to the plain version.

    The ranges must lie inside the payload (tstart + cnt <= pay.shape[1]),
    as sort_pairs makes them; the kernel does not check it, since that
    would wait for the card."""
    _check_grid(tstart, grid_x)
    if not _on_card("fused_blend_fwd", pay):
        return fused_blend_fwd_plain(pay, tstart, cnt, grid_x, tile0)
    n_tiles = _check_blend_inputs("fused_blend_fwd", pay, tstart, cnt)
    from eogs2_tpu_torch.ops import cuda_build

    fn = cuda_build.entry("fused_blend_fwd", "eogs2_fused_blend_fwd",
                          [_VP, ctypes.c_longlong, _VP, _VP, _I, _I, _I, _VP,
                           _VP])
    out8 = torch.empty((n_tiles, P, 8), dtype=torch.float32, device=pay.device)
    with torch.cuda.device(pay.device):
        err = fn(pay.data_ptr(), pay.shape[1], tstart.data_ptr(),
                 cnt.data_ptr(), n_tiles, grid_x, int(tile0), out8.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
    cuda_build.check_launch(err, "fused_blend_fwd")
    fused_blend_fwd.launches += 1
    return out8


fused_blend_fwd.launches = 0  # kernel launches on the card


def _cols(pay_rows):
    """Row payload [P, 16] -> the column payload [11, P] it holds."""
    return pay_rows[:, :NF].t().contiguous()


def fused_blend_fwd_rows(pay, tstart, cnt, grid_x: int, tile0: int = 0):
    """K3 forward: K1 on the row payload [P, 16] (one 64-byte row per
    pair) -> the same out8, bit for bit. CPU tensors take K1's plain
    version on the columns; CUDA tensors launch the kernel (the row load of
    csrc/fused_blend_fwd.cu) or raise."""
    _check_grid(tstart, grid_x)
    if not _on_card("fused_blend_fwd_rows", pay):
        return fused_blend_fwd_plain(_cols(pay), tstart, cnt, grid_x, tile0)
    n_tiles = _check_blend_inputs("fused_blend_fwd_rows", pay, tstart, cnt,
                                  rows=True)
    from eogs2_tpu_torch.ops import cuda_build

    fn = cuda_build.entry("fused_blend_fwd", "eogs2_fused_blend_fwd_rows",
                          [_VP, _VP, _VP, _I, _I, _I, _VP, _VP])
    out8 = torch.empty((n_tiles, P, 8), dtype=torch.float32, device=pay.device)
    with torch.cuda.device(pay.device):
        err = fn(pay.data_ptr(), tstart.data_ptr(), cnt.data_ptr(), n_tiles,
                 grid_x, int(tile0), out8.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
    cuda_build.check_launch(err, "fused_blend_fwd_rows")
    fused_blend_fwd_rows.launches += 1
    return out8


fused_blend_fwd_rows.launches = 0  # kernel launches on the card


def fused_blend_bwd_plain(pay, tstart, cnt, out8, g_out8, grid_x: int,
                          tile0: int = 0, chunk_elems: int = 1 << 24):
    """Plain PyTorch version of K2 (same function, same [NF, P] output;
    tile0 as in fused_blend_fwd_plain).

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
            _chunk_fields(pay, tstart, cnt, grid_x, t0, t1, k_len, tile0)
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


def _check_blend_inputs(name, pay, tstart, cnt, *maps, rows=False):
    """Validate the kernels' inputs on the card; returns the tile count."""
    n_tiles = tstart.shape[0]
    if rows:
        if (pay.dtype != torch.float32 or pay.dim() != 2
                or pay.shape[1] != NFR):
            raise ValueError(f"pay must be float32 [P, {NFR}], got "
                             f"{pay.dtype} {tuple(pay.shape)}")
    elif pay.dtype != torch.float32 or pay.dim() != 2 or pay.shape[0] != NF:
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


def fused_blend_bwd(pay, tstart, cnt, out8, g_out8, grid_x: int,
                    tile0: int = 0):
    """K2: per sorted pair row, dL/d(mx, my, conic a, b, c, opacity,
    f0..f4) -> g_pay [NF, P] float32 (rows no pixel reached are 0; rows in
    no tile's range are not written). tile0 as in fused_blend_fwd.

    out8 is K1's output for the same inputs, g_out8 its cotangent (channels
    0-4 the pre-background channels, 5 final_T; 6-7 ignored). CPU tensors go
    to :func:`fused_blend_bwd_plain`; CUDA tensors launch the hand-written
    kernel (csrc/fused_blend_bwd.cu, built at first use) or raise, never
    falling back to the plain version on the card."""
    _check_grid(tstart, grid_x)
    if not _on_card("fused_blend_bwd", pay):
        return fused_blend_bwd_plain(pay, tstart, cnt, out8, g_out8, grid_x,
                                     tile0)
    n_tiles = _check_blend_inputs("fused_blend_bwd", pay, tstart, cnt,
                                  ("out8", out8), ("g_out8", g_out8))
    from eogs2_tpu_torch.ops import cuda_build

    fn = cuda_build.entry("fused_blend_bwd", "eogs2_fused_blend_bwd",
                          [_VP, ctypes.c_longlong, _VP, _VP, _I, _I, _I, _VP,
                           _VP, _VP, _VP])
    g_pay = torch.empty_like(pay)
    with torch.cuda.device(pay.device):
        err = fn(pay.data_ptr(), pay.shape[1], tstart.data_ptr(),
                 cnt.data_ptr(), n_tiles, grid_x, int(tile0), out8.data_ptr(),
                 g_out8.data_ptr(), g_pay.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
    cuda_build.check_launch(err, "fused_blend_bwd")
    fused_blend_bwd.launches += 1
    return g_pay


fused_blend_bwd.launches = 0  # kernel launches on the card


def fused_blend_bwd_rows(pay, tstart, cnt, out8, g_out8, grid_x: int,
                         tile0: int = 0):
    """K3 backward: K2 on the row payload [P, 16] -> g_pay [P, 16] (fields
    11-15 zero), K2's gradients transposed, bit for bit. CPU tensors take
    K2's plain version on the columns; CUDA tensors launch the kernel (the
    row load and store of csrc/fused_blend_bwd.cu) or raise."""
    _check_grid(tstart, grid_x)
    if not _on_card("fused_blend_bwd_rows", pay):
        g = fused_blend_bwd_plain(_cols(pay), tstart, cnt, out8, g_out8,
                                  grid_x, tile0)
        return torch.nn.functional.pad(g.t(), (0, NFR - NF))
    n_tiles = _check_blend_inputs("fused_blend_bwd_rows", pay, tstart, cnt,
                                  ("out8", out8), ("g_out8", g_out8),
                                  rows=True)
    from eogs2_tpu_torch.ops import cuda_build

    fn = cuda_build.entry("fused_blend_bwd", "eogs2_fused_blend_bwd_rows",
                          [_VP, _VP, _VP, _I, _I, _I, _VP, _VP, _VP, _VP])
    g_pay = torch.empty_like(pay)
    with torch.cuda.device(pay.device):
        err = fn(pay.data_ptr(), tstart.data_ptr(), cnt.data_ptr(), n_tiles,
                 grid_x, int(tile0), out8.data_ptr(), g_out8.data_ptr(), g_pay.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
    cuda_build.check_launch(err, "fused_blend_bwd_rows")
    fused_blend_bwd_rows.launches += 1
    return g_pay


fused_blend_bwd_rows.launches = 0  # kernel launches on the card


class FusedBlend(torch.autograd.Function):
    """Differentiable fused blend: K1 and K2 on the column payload, K3 on
    the row payload (``rows``); local tile t is global tile tile0 + t."""

    @staticmethod
    @span("raster.blend")
    def forward(ctx, pay, tstart, cnt, grid_x, rows=False, tile0=0):
        fwd = fused_blend_fwd_rows if rows else fused_blend_fwd
        out8 = fwd(pay, tstart, cnt, grid_x, tile0)
        ctx.save_for_backward(pay, tstart, cnt, out8)
        ctx.grid_x, ctx.rows, ctx.tile0 = grid_x, rows, tile0
        return out8

    @staticmethod
    @span("raster.blend_bwd")
    def backward(ctx, g_out8):
        pay, tstart, cnt, out8 = ctx.saved_tensors
        bwd = fused_blend_bwd_rows if ctx.rows else fused_blend_bwd
        g_pay = bwd(pay, tstart, cnt, out8, g_out8.contiguous(), ctx.grid_x,
                    ctx.tile0)
        return g_pay, None, None, None, None, None


def rasterize_fused(prep: Preprocessed, features, width: int, height: int,
                    eogs_features: bool = False, tile_cull: bool = False,
                    payload_col: bool = True) -> FusedOut:
    """Fused forward: FusedOut with out8 before the background composite.

    eogs_features: features are [rgb, altitude, 1] (renderer.py's layout);
    the sort depth is then -features[:, 3] (see sort_pairs).
    tile_cull: drop provably dead pairs at emission (output-exact).
    payload_col: the column payload and K1/K2; False: the row payload and
    K3 (the same output, bit for bit)."""
    grid_x, _ = grid_dims(width, height)
    eogs = bool(eogs_features)
    rows = not payload_col
    sp = sort_pairs(prep, features, width, height, tile_cull, eogs, rows)
    out8 = FusedBlend.apply(sp.pay, sp.tstart, sp.cnt, grid_x, rows)
    dev = out8.device
    tiles = prep.tiles_touched.to(torch.int64)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    rect_max = tiles.max() if tiles.numel() else zero
    if tile_cull:
        # demand under culling is the live pair count (dead tiles are not
        # demand), per Gaussian its live tiles
        num_pairs = torch.full((), sp.gid.shape[0], dtype=torch.int64,
                               device=dev)
        bulk_max = sp.lengths.max() if sp.lengths.numel() else zero
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
