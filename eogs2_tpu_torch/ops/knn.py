"""Mean squared distance to the 3 nearest neighbours.

Counterpart of ``eogs2_tpu/ops/knn.py``; parity target the ``simple-knn``
CUDA submodule (Morton sort + box-pruned exact 3-NN), used once at init to
set the Gaussians' scales (gaussian_model.py:179-186). Exact for
N <= exact_threshold; above it, points are sorted along a Morton curve and
each takes the 3 nearest among its +-window neighbours in that order (the
same algorithm as the JAX package, so the two agree on every point). Both
paths are chunked over points, so 1M points need a few hundred MB.
"""

from __future__ import annotations

import torch


def _morton_order(points):
    """Approximate spatial sort: scale to [0, 1024), interleave bits."""
    lo = torch.amin(points, dim=0)
    hi = torch.amax(points, dim=0)
    q = ((points - lo) / torch.clamp_min(hi - lo, 1e-9) * 1023.0).to(
        torch.int64)

    def spread(x):
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        x = (x | (x << 2)) & 0x09249249
        return x

    code = spread(q[:, 0]) | (spread(q[:, 1]) << 1) | (spread(q[:, 2]) << 2)
    return torch.argsort(code, stable=True)


_CHUNK = 1 << 16  # points per chunk: [65536, 129, 3] candidates, ~100 MB


def _windowed_knn(points, order, window: int):
    """Exact 3-NN within a +-window neighbourhood of the sorted order."""
    n = points.shape[0]
    sorted_pts = points[order]
    offsets = torch.arange(-window, window + 1, device=points.device)
    mean3 = torch.empty((n,), dtype=points.dtype, device=points.device)
    for i0 in range(0, n, _CHUNK):
        rows = torch.arange(i0, min(i0 + _CHUNK, n), device=points.device)
        idx = rows[:, None] + offsets[None, :]
        valid = (idx >= 0) & (idx < n) & (offsets[None, :] != 0)
        cand = sorted_pts[idx.clamp(0, n - 1)]  # [c, 2W+1, 3]
        d2 = torch.sum((cand - sorted_pts[rows][:, None, :]) ** 2, dim=-1)
        d2 = torch.where(valid, d2, torch.inf)
        mean3[rows] = torch.mean(torch.topk(d2, 3, dim=1, largest=False)[0],
                                 dim=-1)
    out = torch.empty_like(mean3)
    out[order] = mean3
    return out


def mean_knn_dist2(points, window: int = 64, exact_threshold: int = 4096):
    """[N] mean squared distance to the 3 nearest neighbours of each point
    (points [N,3] float32, N >= 4)."""
    n = points.shape[0]
    if n > exact_threshold:
        return _windowed_knn(points, _morton_order(points), window)
    out = torch.empty((n,), dtype=points.dtype, device=points.device)
    step = max(1, (_CHUNK * 64) // n)  # [step, n] distances, <= 16 MB
    for i0 in range(0, n, step):
        rows = slice(i0, min(i0 + step, n))
        d2 = torch.sum((points[rows, None, :] - points[None, :, :]) ** 2,
                       dim=-1)
        d2[torch.arange(d2.shape[0]), torch.arange(i0, i0 + d2.shape[0])] = \
            torch.inf
        out[rows] = torch.mean(torch.topk(d2, 3, dim=1, largest=False)[0],
                               dim=-1)
    return out
