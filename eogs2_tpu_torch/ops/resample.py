"""Bilinear grid sampling (renderer_cc_shadow.py:37-41 semantics).

align_corners=True with zero padding outside; callers overwrite
out-of-FOV altitude with -100 themselves. Counterpart of
``eogs2_tpu/ops/resample.py``, a jnp transcription of ``F.grid_sample``
(tests/test_ops.py holds it against ``F.grid_sample``).

The forward is ``F.grid_sample``'s (deterministic). Its backward is not:
the CUDA kernel adds dL/d(img) with atomics, so the training step's
gradients would change from run to run. :class:`_GridSample` keeps the
forward and computes the backward without atomics:

  * dL/d(grid) is per output pixel: ``aten.grid_sampler_2d_backward`` with
    ``output_mask=[False, True]``, which skips the input gradient and with
    it every atomic add;
  * dL/d(img) is each input pixel's sum of its taps' contributions, in a
    fixed order: the four taps of every output pixel give entries (flat
    target pixel, tap weight x upstream gradient), taps outside the image
    go to one extra target that is dropped (F.grid_sample's backward skips
    them; JAX's ``tap`` multiplies them by 0), a stable sort by target
    makes each pixel's entries one contiguous run (tap-major, then output
    pixel), and a pairwise tree adds each run: in pass s (s = 1, 2, 4,
    ...) the entry at offset 2s k of its run takes in the entry s after
    it, until the run's head holds the sum. Each pass is one elementwise
    update of all entries, so a resample takes log2 of its longest run in
    passes. (``torch.segment_reduce`` over the same runs, the other
    deterministic sum at hand, is several times slower on the card:
    PERF.md section 6, PR 11.)

The tap weights are F.grid_sample's (``(x0 + 1 - fx) * (y0 + 1 - fy)`` for
the north-west tap, ...), so the input gradient is the exact derivative of
the forward up to the order of the sum. At a whole pixel (fx an integer)
both packages take the floor's side: the derivative is one-sided there.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_BILINEAR, _ZEROS = 0, 0  # aten's interpolation and padding mode codes


def _source_index(coord, size: int, align_corners: bool):
    """F.grid_sample's unnormalisation of [-1, 1] to pixel coordinates."""
    if align_corners:
        return (coord + 1) / 2 * (size - 1)
    return ((coord + 1) * size - 1) / 2


def img_grad(g, grid, shape, align_corners: bool = True):
    """dL/d(img) [C,H,W] of grid_sample(img, grid) for the upstream
    gradient g [C,Ho,Wo], summed per input pixel in a fixed order (the
    module docstring); no atomics, one host sync (the longest run)."""
    c, h, w = shape
    fx = _source_index(grid[..., 0], w, align_corners)
    fy = _source_index(grid[..., 1], h, align_corners)
    x0, y0 = torch.floor(fx), torch.floor(fy)
    x1, y1 = x0 + 1, y0 + 1
    # taps nw, ne, sw, se with F.grid_sample's weights
    xs = torch.stack([x0, x1, x0, x1])
    ys = torch.stack([y0, y0, y1, y1])
    wts = torch.stack([(x1 - fx) * (y1 - fy), (fx - x0) * (y1 - fy),
                       (x1 - fx) * (fy - y0), (fx - x0) * (fy - y0)])
    inb = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    flat = (ys.clamp(0, h - 1).to(torch.int64) * w
            + xs.clamp(0, w - 1).to(torch.int64))
    tgt = torch.where(inb, flat, h * w).reshape(-1)  # h*w: dropped
    # one row per channel, one column per tap (column gathers are coalesced
    # where row gathers of 4 floats are not)
    vals = (wts[None] * g[:, None]).reshape(c, -1)
    tgt_s, order = torch.sort(tgt, stable=True)
    cols = vals[:, order]
    n = tgt_s.shape[0]
    idx = torch.arange(n, device=tgt_s.device)
    head = torch.searchsorted(tgt_s, tgt_s)  # the first column of each run
    pos = idx - head
    # the longest run of an input pixel (the dropped run of the taps
    # outside the image, which can hold most columns, is never summed)
    longest = int(torch.where(tgt_s < h * w, pos, 0).max()) + 1 if n else 0
    step = 1
    while step < longest:
        nxt = torch.cat([head[step:], head.new_full((step,), -1)])
        take = ((pos % (2 * step)) == 0) & (nxt == head)
        later = torch.cat([cols[:, step:], cols.new_zeros((c, step))], 1)
        cols = torch.where(take, cols + later, cols)
        step *= 2
    # each run's head holds its sum; the other columns go to a column that
    # is dropped (written by many, read by none)
    sums = cols.new_zeros((c, h * w + 2))
    sums[:, torch.where(pos == 0, tgt_s, h * w + 1)] = cols
    return sums[:, :h * w].reshape(c, h, w)


class _GridSample(torch.autograd.Function):
    @staticmethod
    def forward(ctx, img, grid, align_corners):
        ctx.align_corners = align_corners
        ctx.save_for_backward(img, grid)
        return F.grid_sample(img[None], grid[None], mode="bilinear",
                             padding_mode="zeros",
                             align_corners=align_corners)[0]

    @staticmethod
    def backward(ctx, g):
        img, grid = ctx.saved_tensors
        g_img = g_grid = None
        if ctx.needs_input_grad[1]:
            g_grid = torch.ops.aten.grid_sampler_2d_backward(
                g[None].contiguous(), img[None], grid[None], _BILINEAR,
                _ZEROS, ctx.align_corners, [False, True])[1][0]
        if ctx.needs_input_grad[0]:
            g_img = img_grad(g, grid, img.shape, ctx.align_corners)
        return g_img, g_grid, None


def grid_sample(img, grid, align_corners: bool = True):
    """img [C,H,W], grid [Ho,Wo,2] of (u, v) in [-1, 1] -> [C,Ho,Wo];
    the backward is deterministic (_GridSample)."""
    return _GridSample.apply(img, grid, align_corners)
