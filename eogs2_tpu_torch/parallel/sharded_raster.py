"""Multi-device rasterization: Gaussian-sharded preprocess, tile-band-sharded
blend, one all_to_all pair exchange each way.

Counterpart of ``eogs2_tpu/parallel/sharded_raster.py``, running the same
hand-written blend kernels as the single-device fused route (K1/K2 on the
column payload, K3 on the row payload; ops/fused_raster.py) at a band
offset. Each rank of the mesh axis "g" holds N/n Gaussians and owns one
contiguous band of tile rows (so an image's SSIM and resample halos never
cross more than a band edge). Per rank:

  1. preprocess its Gaussians; emit its pairs: each Gaussian's first
     min(tiles, tcap) rect tiles, row-major, with ``tile_cull`` dropping the
     provably dead ones (JAX's single-tier ``_emission_keys`` pair set, in
     the port's compact Gaussian-major emission, ops/pair_pipeline.emit_pairs);
  2. ONE stable sort by destination band; window d (``_windows``) is the
     ``dest_cap`` rows starting at the first pair for rank d; rows past a
     window's count (or past ``dest_cap``: dropped, counted in
     ``dropped_pairs``) are sent as pads (tile = n_tiles, depth = inf);
  3. ONE ``all_to_all_single`` of the [n, dest_cap, 13] windows (tile,
     depth and the 11 payload fields);
  4. ONE stable sort of what it received by (tile, depth), ties in receive
     order; K1 (or K3) blends the band's tiles with ``tile0`` = the band's
     first tile, each tile walking at most ``tile_capacity`` pairs (JAX's
     kernels walk min(cnt, k_cap)).

The whole exchange, sort and blend is one autograd Function. Its backward
runs K2 (or K3) at the same ``tile0``, zeroes the rows no tile walked (pads,
pairs past ``tile_capacity``), un-sorts to receive order, sends the
gradients back with the transposed ``all_to_all_single``, puts the windows
back (``_unwindows``: later windows overwrite earlier windows' zero tails),
and un-sorts to emission order; one segment sum per Gaussian follows
(ops/fused_raster._GatherPairs). Dropped pairs get zero gradient, as the
forward's clipping gives.

The band images are joined on every rank (parallel.distributed.
all_gather_cat, whose backward keeps this rank's band of the gradient), so
``rasterize_a2a`` returns the whole image, as ``rasterize`` does, with the
per-Gaussian outputs (radii, mean2d_ndc) of this rank's shard. The affine
and the background are replicated inputs of a sharded computation: their
gradients are summed over the ranks (``sum_grad``).

One departure from JAX, deliberate: JAX's ``rasterize_a2a`` pads the canvas
height to a multiple of 16 n and preprocesses at the padded height, which
stretches the image vertically when the height is not such a multiple
(ROADMAP Queue 3). The port preprocesses at the true height and pads only
the tile grid with empty rows, so the image is ``rasterize``'s at every
height.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from eogs2_tpu_torch.observability import span
from eogs2_tpu_torch.ops import fused_raster as fr
from eogs2_tpu_torch.ops.binning import depth_key, grid_dims
from eogs2_tpu_torch.ops.pair_pipeline import emit_pairs
from eogs2_tpu_torch.ops.projection import (TILE, Preprocessed,
                                            compute_cov2d_direct,
                                            preprocess_gaussians)
from eogs2_tpu_torch.parallel.distributed import (all_gather_cat,
                                                  group_size, sum_grad)
from eogs2_tpu_torch.parallel.mesh import axis_group, axis_rank, axis_size

NF_PAY = 11  # payload floats per pair: mx, my, ca, cb, cc, op, f0..f4
NX = NF_PAY + 2  # exchanged per pair: tile, depth and the payload


class A2AStatics(NamedTuple):
    n_shards: int
    rank: int
    group: object  # the "g" process group (None for one rank)
    tiles_per_band: int
    n_tiles: int
    grid_x: int
    dest_cap: int
    k_cap: int
    col: bool = True  # the column payload (K1/K2), else the row one (K3)


def _windows(col, starts, dest_cap: int, n_shards: int):
    """Cut the [pl, ...] sorted rows into per-destination windows
    [n_shards, dest_cap, ...]: window d is the dest_cap rows from
    starts[d], the rows past the end zero (JAX's dynamic_slice of the
    zero-padded column)."""
    pad = col.new_zeros((dest_cap,) + tuple(col.shape[1:]))
    col_p = torch.cat([col, pad])
    idx = (starts.to(torch.int64)[:, None]
           + torch.arange(dest_cap, device=col.device)[None, :])
    return col_p[idx]


def _unwindows(gwin, starts, pl: int, dest_cap: int, n_shards: int):
    """Transpose of _windows: window d written at starts[d], in increasing
    d, into zeros [pl + dest_cap, ...], then cut to pl rows. Window d's tail
    (send pads, zero gradient) overlaps at most window d+1's real rows,
    which are written after it, so every real row keeps its own value."""
    buf = gwin.new_zeros((pl + dest_cap,) + tuple(gwin.shape[2:]))
    ar = torch.arange(dest_cap, device=gwin.device)
    for d in range(n_shards):
        buf.index_copy_(0, starts[d].to(torch.int64) + ar, gwin[d])
    return buf[:pl]


def _exchange(x, s: A2AStatics):
    """all_to_all_single of [n, dest_cap, F]: chunk d goes to rank d; the
    result's chunk d came from rank d."""
    if s.n_shards == 1:
        return x
    with span("a2a.exchange"):
        x = x.contiguous()
        out = torch.empty_like(x, memory_format=torch.contiguous_format)
        dist.all_to_all_single(out, x, group=s.group)
    return out


def _send_ok(counts, s: A2AStatics):
    """[n, dest_cap] True where window d's slot holds a real pair."""
    slot = torch.arange(s.dest_cap, device=counts.device)
    return slot[None, :] < counts.clamp_max(s.dest_cap)[:, None]


class _A2ABlend(torch.autograd.Function):
    """pay_em [11, P] (emission order), tile_em [P] int64, depth_em [P] ->
    (out8 [tiles_per_band, 256, 8] of this rank's band, stats [3] int64:
    the band's densest tile, the largest window, the pairs this rank
    dropped)."""

    @staticmethod
    def forward(ctx, pay_em, tile_em, depth_em, s: A2AStatics):
        dev, n, pl = pay_em.device, s.n_shards, tile_em.shape[0]
        tile0 = s.rank * s.tiles_per_band
        dest = torch.clamp_max(
            torch.div(tile_em, s.tiles_per_band, rounding_mode="floor"),
            n - 1)
        _, em_s = torch.sort(dest, stable=True)
        counts = torch.bincount(dest, minlength=n)
        starts = torch.cumsum(counts, 0) - counts
        rows = torch.cat([tile_em.to(torch.float32)[:, None],
                          depth_em.to(torch.float32)[:, None], pay_em.t()],
                         1)[em_s]  # [P, 13] sorted by destination
        ok = _send_ok(counts, s)
        fill = torch.zeros(NX, device=dev)
        fill[0], fill[1] = float(s.n_tiles), float("inf")
        send = torch.where(ok[..., None], _windows(rows, starts, s.dest_cap,
                                                   n), fill)
        recv = _exchange(send, s).reshape(n * s.dest_cap, NX)

        rtile = recv[:, 0].to(torch.int64)
        _, perm2 = torch.sort((rtile << 32) | depth_key(recv[:, 1]),
                              stable=True)
        srt = recv[perm2]
        stile = rtile[perm2]
        bounds = torch.searchsorted(
            stile, tile0 + torch.arange(s.tiles_per_band + 1, device=dev))
        tstart = bounds[:-1].to(torch.int32)
        cnt = (bounds[1:] - bounds[:-1]).to(torch.int32)
        cnt_k = cnt.clamp_max(s.k_cap)
        if s.col:
            pay = srt[:, 2:].t().contiguous()
            out8 = fr.fused_blend_fwd(pay, tstart, cnt_k, s.grid_x, tile0)
        else:
            pay = torch.nn.functional.pad(srt[:, 2:], (0, fr.NFR - NF_PAY))
            out8 = fr.fused_blend_fwd_rows(pay, tstart, cnt_k, s.grid_x,
                                           tile0)
        stats = torch.stack([
            cnt.max().to(torch.int64), counts.max(),
            (counts - s.dest_cap).clamp_min(0).sum()])
        ctx.s = s
        ctx.save_for_backward(pay, tstart, cnt_k, out8, perm2, stile, em_s,
                              starts, counts)
        ctx.mark_non_differentiable(stats)
        return out8, stats

    @staticmethod
    def backward(ctx, g_out8, g_stats):
        s = ctx.s
        pay, tstart, cnt_k, out8, perm2, stile, em_s, starts, counts = \
            ctx.saved_tensors
        tile0 = s.rank * s.tiles_per_band
        g_out8 = g_out8.contiguous()
        if s.col:
            g = fr.fused_blend_bwd(pay, tstart, cnt_k, out8, g_out8,
                                   s.grid_x, tile0).t()
        else:
            g = fr.fused_blend_bwd_rows(pay, tstart, cnt_k, out8, g_out8,
                                        s.grid_x, tile0)[:, :NF_PAY]
        # the rows no tile walked (pads, pairs past tile_capacity) were not
        # written by the kernel: zero them
        r = stile.shape[0]
        pos = torch.arange(r, device=g.device)
        t_loc = (stile - tile0).clamp(0, s.tiles_per_band - 1)
        walked = ((stile < tile0 + s.tiles_per_band) & (stile >= tile0)
                  & (pos - tstart.to(torch.int64)[t_loc]
                     < cnt_k.to(torch.int64)[t_loc]))
        g = torch.where(walked[:, None], g, 0.0)
        g_recv = torch.empty_like(g)
        g_recv[perm2] = g  # back to receive order (a permutation)
        g_send = _exchange(g_recv.reshape(s.n_shards, s.dest_cap, NF_PAY), s)
        g_send = torch.where(_send_ok(counts, s)[..., None], g_send, 0.0)
        pl = em_s.shape[0]
        g_sorted1 = _unwindows(g_send, starts, pl, s.dest_cap, s.n_shards)
        g_em = torch.empty_like(g_sorted1)
        g_em[em_s] = g_sorted1  # back to emission order
        return g_em.t(), None, None, None


def _gather_stats(local, group):
    """[k] int64 per rank -> [n, k] on every rank."""
    n = group_size(group)
    if n == 1:
        return local[None]
    parts = [torch.empty_like(local) for _ in range(n)]
    dist.all_gather(parts, local.contiguous(), group=group)
    return torch.stack(parts)


def sharded_rasterize(
    mesh,
    means3d, scales, quats, opacities, feat, alive, affine, bg,
    width: int, height: int,
    tcap: int = 8,
    dest_cap: int = 1 << 15,
    tile_capacity: int = 512,
    k_chunk: int = 128,
    axis: str = "g",
    mean2d_ndc_offset=None,
    interpret=None,
    col: bool = True,
    tile_cull: bool = False,
):
    """Differentiable multi-device render, this rank's part.

    The per-Gaussian inputs are this rank's shard of the "g" axis (every
    rank the same count); affine [3, 4] and bg [5] are replicated. The
    canvas is width x height; its tile rows are padded with empty rows to
    a multiple of the axis size. Returns a dict: ``image`` [5, rows*16,
    width'] and ``final_t`` of this rank's row band (background
    composited), ``radii`` and ``mean2d_ndc`` of the shard, the stats
    ``max_tile_count``, ``max_dest_count``, ``max_tiles_per_gaussian_seen``
    (maxima over the ranks), ``dropped_pairs`` (summed) and
    ``pairs_per_chip`` [n]. k_chunk and interpret are TPU knobs, accepted
    and unused."""
    group, n = axis_group(mesh, axis), axis_size(mesh, axis)
    rank = axis_rank(mesh, axis)
    grid_x, grid_y = grid_dims(width, height)
    rows_per = -(-grid_y // n)
    tpb = rows_per * grid_x
    s = A2AStatics(n_shards=n, rank=rank, group=group, tiles_per_band=tpb,
                   n_tiles=tpb * n, grid_x=grid_x, dest_cap=int(dest_cap),
                   k_cap=int(tile_capacity), col=col)
    affine = sum_grad(affine, group)
    bg = sum_grad(bg, group)
    cov2d = compute_cov2d_direct(scales, quats, affine, width, height)
    prep = preprocess_gaussians(means3d, None, opacities, affine, width,
                                height, alive=alive, cov2d=cov2d)
    if mean2d_ndc_offset is not None:
        px_scale = torch.tensor([0.5 * width, 0.5 * height],
                                dtype=prep.mean2d.dtype,
                                device=prep.mean2d.device)
        prep = prep._replace(mean2d=prep.mean2d + mean2d_ndc_offset * px_scale)
    keys = Preprocessed(*(x.detach() for x in prep))
    gid, tile, lengths, _ = emit_pairs(keys, grid_x, tile_cull=tile_cull,
                                       tcap=tcap)
    cols = torch.stack([prep.mean2d[:, 0], prep.mean2d[:, 1],
                        prep.conic[:, 0], prep.conic[:, 1], prep.conic[:, 2],
                        prep.opacity] + [feat[:, j]
                                         for j in range(feat.shape[1])])
    if cols.shape[0] != NF_PAY:
        raise ValueError(f"the blend composites 5 channels, got features "
                         f"of shape {tuple(feat.shape)}")
    ident = torch.arange(gid.shape[0], device=gid.device)
    pay_em = fr._GatherPairs.apply(cols, gid, ident, lengths, 1)
    out8, stats = _A2ABlend.apply(pay_em, tile, keys.depth[gid], s)

    img8 = out8.reshape(rows_per, grid_x, TILE, TILE, 8)
    img8 = img8.permute(4, 0, 2, 1, 3).reshape(8, rows_per * TILE,
                                               grid_x * TILE)
    final_t = img8[5]
    image = img8[:5] + final_t[None] * bg[:, None, None]
    tiles = keys.tiles_touched.to(torch.int64)
    local = torch.cat([stats, torch.stack([
        torch.tensor(gid.shape[0], device=stats.device),
        tiles.max() if tiles.numel() else stats.new_zeros(())])])
    every = _gather_stats(local, group)  # [n, 5]
    scale_ndc = torch.tensor([2.0 / width, 2.0 / height],
                             dtype=prep.mean2d.dtype,
                             device=prep.mean2d.device)
    return dict(
        image=image, final_t=final_t, radii=prep.radius,
        max_tile_count=every[:, 0].max(), max_dest_count=every[:, 1].max(),
        dropped_pairs=every[:, 2].sum(),
        max_tiles_per_gaussian_seen=every[:, 4].max(),
        pairs_per_chip=every[:, 3], mean2d_ndc=prep.mean2d.detach() * scale_ndc,
    )


def rasterize_a2a(
    mesh,
    means3d, scales, quats, opacities, feat, affine, bg,
    width: int, height: int,
    config,
    alive=None,
    mean2d_ndc_offset=None,
    axis: str = "g",
):
    """``rasterize`` on the all_to_all path, with its RasterOut contract.

    The per-Gaussian inputs (and ``alive``, ``mean2d_ndc_offset``) are this
    rank's shard; ``image`` [5, H, W] and ``final_t`` are the whole frame on
    every rank (the bands joined; the backward keeps this rank's band of
    their gradients); ``radii`` and ``mean2d_ndc`` are the shard's;
    ``num_pairs`` the pairs emitted over all ranks; ``max_tile_count`` the
    densest tile's demand (before the ``tile_capacity`` clip);
    ``max_tiles_per_gaussian_seen`` the widest Gaussian's rect tiles (before
    the ``max_tiles_per_gaussian`` clamp); ``max_dest_count`` the largest
    exchange window's demand against ``config.dest_cap``, and
    ``dropped_pairs`` the pairs past it (zero gradient). Reads
    ``max_tiles_per_gaussian``, ``tile_capacity``, ``dest_cap``,
    ``payload_col`` and ``tile_cull`` of ``config``."""
    from eogs2_tpu_torch.rasterizer import RasterOut

    if alive is None:
        alive = torch.ones(means3d.shape[0], dtype=torch.bool,
                           device=means3d.device)
    out = sharded_rasterize(
        mesh, means3d, scales, quats, opacities, feat, alive, affine, bg,
        width, height, tcap=config.max_tiles_per_gaussian,
        dest_cap=config.dest_cap, tile_capacity=config.tile_capacity,
        axis=axis, mean2d_ndc_offset=mean2d_ndc_offset,
        col=config.payload_col, tile_cull=config.tile_cull)
    group = axis_group(mesh, axis)
    image = all_gather_cat(out["image"], group, dim=1)[:, :height, :width]
    final_t = all_gather_cat(out["final_t"], group, dim=0)[:height, :width]
    return RasterOut(
        image=image,
        final_t=final_t,
        radii=out["radii"],
        mean2d_ndc=out["mean2d_ndc"],
        num_pairs=out["pairs_per_chip"].sum(),
        max_tile_count=out["max_tile_count"],
        max_tiles_per_gaussian_seen=out["max_tiles_per_gaussian_seen"],
        dropped_pairs=out["dropped_pairs"],
        max_dest_count=out["max_dest_count"],
    )


def sharded_render(
    mesh,
    means3d, scales, quats, opacities, feat, alive, affine, bg,
    width: int, height: int,
    tcap: int = 8,
    dest_cap: int = 1 << 15,
    tile_capacity: int = 512,
    tile_chunk: int = 64,
    axis: str = "g",
):
    """JAX's back-compat wrapper: (image [5, H, W], the whole frame on every
    rank, stats [max_tile_count, max_dest_count]). tile_chunk is a TPU
    knob, accepted and unused."""
    out = sharded_rasterize(
        mesh, means3d, scales, quats, opacities, feat, alive, affine, bg,
        width, height, tcap=tcap, dest_cap=dest_cap,
        tile_capacity=tile_capacity, axis=axis)
    group = axis_group(mesh, axis)
    image = all_gather_cat(out["image"], group, dim=1)[:, :height, :width]
    return image, torch.stack([out["max_tile_count"],
                               out["max_dest_count"]])

