"""DSM registration: multiscale NCC integer shift + z-affine.

Parity target: ``eval/dsmr.py`` (numba-jitted pixel loops). Re-expressed as
vectorized NumPy: the +-irange NCC search slides `sec` over `ref` with
NaN-aware masked statistics, recursing on 2x NaN-mean downsampling exactly
like recursive_ncc (dsmr.py:146-179). The z mapping is a*z+b with a fixed
to 1 for the reference's usage (dsmr.py:198-225, eval_dsm.py:60).

A copy of ``eogs2_tpu/eval/registration.py``. In the port it is the plain
version of the native registration (``native/dsmr.cpp``), which the tests
hold against it; the MAE path runs the native one.
"""

from __future__ import annotations

import numpy as np


def downsample2x(u: np.ndarray) -> np.ndarray:
    """NaN-mean 2x downsample (dsmr.py:15-43)."""
    h, w = u.shape
    hp, wp = (h + 1) // 2 * 2, (w + 1) // 2 * 2
    pad = np.full((hp, wp), np.nan, u.dtype)
    pad[:h, :w] = u
    blocks = pad.reshape(hp // 2, 2, wp // 2, 2).transpose(0, 2, 1, 3).reshape(
        hp // 2, wp // 2, 4
    )
    with np.errstate(invalid="ignore"):
        cnt = np.sum(np.isfinite(blocks), axis=-1)
        s = np.nansum(blocks, axis=-1)
        out = np.where(cnt > 0, s / np.maximum(cnt, 1), np.nan)
    return out


def _shifted_view(v, dx, dy):
    """v sampled at (i+dx, j+dy), NaN outside — valnan semantics."""
    h, w = v.shape
    out = np.full_like(v, np.nan)
    src_y0, src_y1 = max(dy, 0), min(h + dy, h)
    src_x0, src_x1 = max(dx, 0), min(w + dx, w)
    dst_y0, dst_y1 = src_y0 - dy, src_y1 - dy
    dst_x0, dst_x1 = src_x0 - dx, src_x1 - dx
    if src_y1 > src_y0 and src_x1 > src_x0:
        out[dst_y0:dst_y1, dst_x0:dst_x1] = v[src_y0:src_y1, src_x0:src_x1]
    return out


def mean_std(u, v, dx=0, dy=0):
    """NaN-aware joint stats of u and v shifted by (dx,dy) (dsmr.py:94-134)."""
    vv = _shifted_view(v, dx, dy)
    ok = np.isfinite(u) & np.isfinite(vv)
    count = int(ok.sum())
    if count == 0:
        return np.nan, np.nan, np.nan, np.nan, np.nan
    uu = u[ok]
    vs = vv[ok]
    muu = uu.mean()
    muv = vs.mean()
    du = uu - muu
    dv = vs - muv
    sigu = np.sqrt(np.mean(du * du))
    sigv = np.sqrt(np.mean(dv * dv))
    xcorr = np.mean(du * dv)
    return muu, muv, sigu, sigv, xcorr


def ncc(u, v, dx=0, dy=0):
    _, _, sigu, sigv, xcorr = mean_std(u, v, dx, dy)
    return xcorr / (sigu * sigv + 1e-8)


def compute_ncc(u, v, irange, initdx, initdy):
    best = (-np.inf, initdx, initdy)
    for dy in range(initdy - irange, initdy + irange + 1):
        for dx in range(initdx - irange, initdx + irange + 1):
            c = ncc(u, v, dx, dy)
            if c > best[0]:
                best = (c, dx, dy)
    return best[1], best[2]


def recursive_ncc(u, v, irange=5, dx=0, dy=0):
    if min(u.shape) > 100:
        dx2, dy2 = recursive_ncc(downsample2x(u), downsample2x(v), irange,
                                 dx // 2, dy // 2)
        dx, dy = dx2 * 2, dy2 * 2
    return compute_ncc(u, v, irange, dx, dy)


def compute_shift(dsm_ref, dsm_sec, scaling=True):
    """(dx, dy, a, b) registering dsm_sec onto dsm_ref (dsmr.py:198-225)."""
    dx, dy = recursive_ncc(dsm_ref, dsm_sec)
    muu, muv, sigu, sigv, _ = mean_std(dsm_ref, dsm_sec, dx, dy)
    a = sigu / sigv if scaling else 1.0
    b = muu - muv * a
    return dx, dy, a, b


def apply_shift(in_dsm, dx=0, dy=0, a=1.0, b=0.0, c=0.0, d=0.0):
    """out[j,i] = a * in[j+dy, i+dx] + b + c*i + d*j (dsmr.py:183-194)."""
    shifted = _shifted_view(in_dsm, dx, dy)
    if c != 0.0 or d != 0.0:
        jj, ii = np.mgrid[0 : in_dsm.shape[0], 0 : in_dsm.shape[1]]
        return a * shifted + b + c * ii + d * jj
    return a * shifted + b


def dsm_pointwise_diff(pred_dsm, gt_dsm):
    """Register + clip + diff (eval_dsm.py:56-70)."""
    transform = compute_shift(gt_dsm, pred_dsm, scaling=False)
    pred_rdsm = apply_shift(pred_dsm, *transform)
    h = min(pred_rdsm.shape[0], gt_dsm.shape[0])
    w = min(pred_rdsm.shape[1], gt_dsm.shape[1])
    pred_rdsm = np.clip(pred_rdsm, np.nanmin(gt_dsm) - 10, np.nanmax(gt_dsm) + 10)
    diff = pred_rdsm[:h, :w] - gt_dsm[:h, :w]
    return diff, pred_rdsm
