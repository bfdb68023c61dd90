"""DSM altitude-MAE evaluation against lidar ground truth.

Counterpart of ``eogs2_tpu/eval/mae.py``; parity target ``eval/eval_dsm.py``
Mae_Computer: load the GT DSM + water / visibility / tree masks, crop the
prediction to the GT ROI window, register with NCC + z-shift (the native
C++/OpenMP registration, ``native/dsmr.cpp``), MAE = nanmean(|diff|),
raising when the diff is all-NaN (eval_dsm.py:334-341). Host-side numpy in
float64, as in JAX.

Synthetic scenes (data/synthetic.py) carry their GT as a heightfield .npy;
`MaeComputer.from_synthetic` adapts it to the same interface so the whole
eval path is exercised without DFC2019/IARPA data.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from eogs2_tpu_torch import native
from eogs2_tpu_torch.io.geotiff import Affine, read_geotiff


def dsm_pointwise_diff(pred_dsm, gt_dsm):
    """Register + clip + diff (eval_dsm.py:56-70) with the native
    registration (eogs2_tpu_torch/native), which raises if it cannot be
    built; eval/registration.py is its plain version."""
    transform = native.compute_shift(gt_dsm, pred_dsm, scaling=False)
    pred_rdsm = native.apply_shift(pred_dsm, *transform)
    h = min(pred_rdsm.shape[0], gt_dsm.shape[0])
    w = min(pred_rdsm.shape[1], gt_dsm.shape[1])
    pred_rdsm = np.clip(pred_rdsm, np.nanmin(gt_dsm) - 10, np.nanmax(gt_dsm) + 10)
    diff = pred_rdsm[:h, :w] - gt_dsm[:h, :w]
    return diff, pred_rdsm


def mask_dsm(dsm, water_mask=None, vis_mask=None, tree_mask=None):
    dsm = dsm.copy()
    if water_mask is not None:
        wm = water_mask[: dsm.shape[0], : dsm.shape[1]]
        dsm[wm] = np.nan
    if vis_mask is not None:
        dsm[vis_mask] = np.nan
    if tree_mask is not None:
        if dsm.shape != tree_mask.shape:
            dsm = dsm[: tree_mask.shape[0], : tree_mask.shape[1]]
        dsm[~tree_mask] = np.nan
    return dsm


class MaeComputer:
    def __init__(self, gt_dsm: np.ndarray, roi: tuple, tree_mask=None,
                 water_mask=None, vis_mask=None, filter_tree: bool = False):
        """roi = (ulx, uly, lrx, lry) in model coordinates."""
        self.tree_mask = tree_mask
        self.gt_dsm = mask_dsm(
            gt_dsm,
            water_mask=water_mask,
            vis_mask=vis_mask,
            tree_mask=tree_mask if filter_tree else None,
        )
        self.ulx, self.uly, self.lrx, self.lry = roi
        self._gt_dsm_masked = None

    # ---- constructors -----------------------------------------------------

    @classmethod
    def from_gt_dir(cls, gt_dir: str, aoi_id: str, enable_vis_mask=True,
                    filter_tree=False, masks_dir: Optional[str] = None):
        """Reference layout: {aoi}_DSM.tif (+ _DSM.txt ROI for DFC2019),
        {aoi}_CLS.tif segmentation (class 9 == water), optional vis/tree
        masks (eval_dsm.py:79-151)."""
        gt_dsm_path = os.path.join(gt_dir, f"{aoi_id}_DSM.tif")
        gt_dsm, prof = read_geotiff(gt_dsm_path)
        gt_dsm = np.asarray(gt_dsm, np.float64)
        txt = os.path.join(gt_dir, f"{aoi_id}_DSM.txt")
        if os.path.exists(txt):
            xoff, yoff, size, res = np.loadtxt(txt)
        else:
            t = prof["transform"]
            assert t is not None, f"no geo info for {gt_dsm_path}"
            xoff = t.c
            size = min(prof["height"], prof["width"])
            res = t.a
            yoff = t.f + t.e * prof["height"]  # bottom
        ulx, uly = xoff, yoff + size * res
        lrx, lry = xoff + size * res, yoff

        water_mask = None
        for seg_name in (f"{aoi_id}_CLS_v2.tif", f"{aoi_id}_CLS.tif"):
            seg_path = os.path.join(gt_dir, seg_name)
            if os.path.exists(seg_path):
                seg, _ = read_geotiff(seg_path)
                water_mask = np.asarray(seg) == 9
                break
        vis_mask = None
        tree_mask = None
        if masks_dir:
            vp = os.path.join(masks_dir, "vis_masks", f"{aoi_id}.tif")
            if enable_vis_mask and os.path.exists(vp):
                vis_mask = np.asarray(read_geotiff(vp)[0]) > 0.5
            tp = os.path.join(masks_dir, "tree_masks", f"{aoi_id}.png")
            if os.path.exists(tp):
                import imageio.v2 as iio

                tree_mask = np.asarray(iio.imread(tp))
                if tree_mask.ndim == 3:
                    tree_mask = tree_mask[..., 0]
                tree_mask = tree_mask > 0.5
        return cls(gt_dsm, (ulx, uly, lrx, lry), tree_mask=tree_mask,
                   water_mask=water_mask, vis_mask=vis_mask,
                   filter_tree=filter_tree)

    @classmethod
    def from_synthetic(cls, scene_dir: str, scale: float, resolution: float = 0.5,
                       alt_only_buildings: bool = False):
        """Adapt a synthetic scene's gt_heightfield.npy: the heightfield is
        over normalized [-1,1]^2; express it as a UTM DSM at `resolution` on
        the same grid the predicted DSM will use."""
        z = np.load(os.path.join(scene_dir, "gt_heightfield.npy"))
        # resample the heightfield to the DSM resolution over world extent
        extent = 2.0 * scale  # meters
        size = int(round(extent / resolution))
        yy, xx = np.mgrid[0:size, 0:size]
        # grid cell centers in normalized coords; row 0 = +y (north up)
        xn = (xx + 0.5) / size * 2 - 1
        yn = 1 - (yy + 0.5) / size * 2
        res_hf = z.shape[0]
        ix = np.clip(((xn + 1) * 0.5 * (res_hf - 1)).round().astype(int), 0, res_hf - 1)
        iy = np.clip(((yn + 1) * 0.5 * (res_hf - 1)).round().astype(int), 0, res_hf - 1)
        gt = z[iy, ix] * scale  # altitude in meters
        ulx, uly = -scale, scale
        lrx, lry = scale, -scale
        return cls(gt.astype(np.float64), (ulx, uly, lrx, lry))

    # ---- core -------------------------------------------------------------

    def crop_pred(self, pred_dsm: np.ndarray, transform: Affine):
        """Crop the prediction to the GT ROI window (eval_dsm.py:302-316)."""
        ulc, ulr = transform.inv((self.ulx, self.uly))
        lrc, lrr = transform.inv((self.lrx, self.lry))
        r0, r1 = int(round(ulr)), int(round(lrr))
        c0, c1 = int(round(ulc)), int(round(lrc))
        h, w = pred_dsm.shape[:2]
        out = np.full((r1 - r0, c1 - c0), np.nan, np.float64)
        rr0, rr1 = max(r0, 0), min(r1, h)
        cc0, cc1 = max(c0, 0), min(c1, w)
        if rr1 > rr0 and cc1 > cc0:
            out[rr0 - r0 : rr1 - r0, cc0 - c0 : cc1 - c0] = pred_dsm[rr0:rr1, cc0:cc1]
        return out

    def get_gt_dsm(self, force_use_tree_mask=False):
        if force_use_tree_mask and self.tree_mask is not None:
            if self._gt_dsm_masked is None:
                self._gt_dsm_masked = mask_dsm(self.gt_dsm, tree_mask=self.tree_mask)
            return self._gt_dsm_masked
        return self.gt_dsm

    def compute_mae(self, pred_dsm: np.ndarray, transform: Affine,
                    force_use_tree_mask=False):
        pred = self.crop_pred(np.asarray(pred_dsm, np.float64).squeeze(), transform)
        gt = self.get_gt_dsm(force_use_tree_mask)
        diff, rdsm = dsm_pointwise_diff(pred, gt)
        mae = np.nanmean(np.abs(diff.ravel()))
        if np.isnan(mae):
            raise ValueError("MAE is NaN: the diff contains only NaN values")
        return float(mae), diff, rdsm

    def compute_mae_from_path(self, pred_dsm_path: str, force_use_tree_mask=False):
        arr, prof = read_geotiff(pred_dsm_path)
        return self.compute_mae(arr, prof["transform"], force_use_tree_mask)
