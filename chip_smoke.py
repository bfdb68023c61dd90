#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (eogs2_tpu_torch) on one GPU.

    python3 chip_smoke.py [--multicard]

Run from the root of a checkout on a machine with an NVIDIA Hopper card and
the CUDA toolkit. It builds every kernel from the sources in the checkout,
holds each against its plain PyTorch version on the card, drives the serving
path and the training path at full width and checks what comes out. Every
phase prints one JSON line; any failure raises, so the exit code is non-zero
and the final ``{"ok": true, ...}`` line is never printed. Without a CUDA
device it exits with code 1 before doing anything.

Phases (the fused route's, 1-6, run first, in the order they had before
the dense routes were added, so that their times stay comparable):
  1. card name and power limit (nvidia-smi), kernel build time, ptxas's
     register report; no kernel may spill;
  2. K1 (csrc/fused_blend_fwd.cu) against fused_blend_fwd_plain on three
     256x256 scenes of 20k seeded Gaussians — altitudes of both signs, the
     same with tile_cull, and a dense scene whose pixels saturate (the early
     exit runs) — channels 0-4 within atol 2e-4 and final_T within 2e-5
     (tests/test_golden.py's tolerances: pairs at the 1/255 and T_EPS
     edges) and n_contrib (channel 6) exact; plus a 128x128 fused render
     against the dense O(N*P) oracle
     (reference_rasterize), image and final_T within atol 5e-5;
  3. the serving path at full width: 1,000,000 seeded Gaussians on a
     synthetic heightfield, a 1024x1024 view with its sun model (the sun
     render is 2048x2048) through render_view_full with sun and shading,
     then nadir_dsm; K1's, the emission passes' and the preprocess
     kernels' launch counts over that run (one count and one write pass
     and one preprocess forward a render, no backward), its median time of 3
     runs after one warm-up, peak memory, the outputs checked; one profiled
     run of each entry point (device time by kernel, device busy share);
     K1 against its plain version at each of the three renders' exact
     inputs, with its time, the plain version's and its bound; the
     emission's two passes (csrc/emit_pairs.cu), fed by the main path's
     preprocess, against the plain emission
     at the view's and the sun's inputs with tile_cull and at the view's
     without it at tcap 16: gid, tile, sort key and counts bit-equal, with
     both times and the bound; the preprocess's forward and backward
     kernels (csrc/preprocess.cu) against the plain preprocess at the 1M
     Gaussians through the view, the sun and the view at the dual cell's
     256x256 MSI canvas, with an alive mask and an NDC offset: conic,
     opacity and radius bit-equal, mean2d and depth within 2 ulp, rects
     apart only where mean2d is; every gradient, the affine's and the
     offset's too, within 1e-5 (gap of the norms) of autograd's and of the
     plain twin's, two backward launches bit-equal; both kernels' times,
     the plain versions' and the byte bounds;
  4. K2 (csrc/fused_blend_bwd.cu) against fused_blend_bwd_plain on the same
     three scenes with a seeded random cotangent, per payload row max-abs
     error over the row's max-abs value <= 2e-4 (tests/test_golden.py's
     gradient tolerance), rows without gradient exactly 0, and two launches
     bitwise equal; plus every input's gradient of a 128x128 render
     through the kernels against the plain versions on the CPU (same
     tolerance);
  5. the training path at full width: the synthetic scene of
     scripts/train_scale.py (7 views at 1024x1024, hf_res 768, 24
     buildings, seed 11) at scale 142, whose uniform init keeps about 1.0M
     points, built in memory; the baseogs recipe with the sun and random
     camera on from iteration 1 (every step renders main 1024^2, sun 2048^2
     and random 1024^2, each forward and backward) on the fused route with
     tile_cull; 2 warm-up steps, then 10 timed steps, each ending in
     torch.cuda.synchronize(); K1, K2, the emission passes' and the
     preprocess kernels' launches over the timed steps (3 each a step),
     peak memory, every metric finite, parameters moved, alive before and
     after; one profiled step; K1 and K2 at each of the three renders'
     exact inputs of a step (captured from the step; K1's out8 equal to the
     step's), with their times, the plain versions' and their bounds, and
     their sums over the step;
  6. K3 (the row-payload load of csrc/fused_blend_fwd.cu and
     fused_blend_bwd.cu) on the three 256x256 scenes: out8 equal to K1's
     and g_pay equal to K2's transposed, bit for bit, and within the
     tolerances above of the plain versions; then at the train render's
     captured inputs (times, bound) and one training step with
     payload_col=False, which launches K3 and not K1/K2;
  7. K4 (csrc/blend_tiles_fwd.cu, blend_tiles_bwd.cu) against its plain
     versions on packed tiles of three seeds with random masks, K 256 and
     1024: channels 0-4 atol 2e-4, final_t 2e-5, n_contrib exact; the
     backward per row <= 2e-4 of the row's largest value, bitwise
     deterministic, zero in rows 11-15 and past each tile's walk; and two
     cases whose masks end early, as a render's do (K 1024 and 700);
  8. the CLI's fast route (sorted binning, K4) in training, on the scene of
     phase 5: capacities bucketed (RasterizeConfig.bucketed, the JAX
     Trainer's rule) from one untimed step's demand, 2 warm-up
     and 10 timed steps, 3 K4 forward and 3 K4 backward launches per step
     and none of K1/K2/K3, no render clipped, every metric finite, every
     leaf moved, peak memory; one profiled step; K4 forward and backward
     at each of the three renders' captured inputs of one step (main, sun,
     random camera), at the tolerances of phase 7, with their times, the
     plain versions' and their bounds, and their sums over the step;
  9. the serving path on gather + use_pallas at 1,000,000 Gaussians and
     1024x1024: 2 K4 launches per render_view_full and 1 per nadir_dsm,
     median of 3 runs after one warm-up, the serve checks of phase 3; K4
     forward against its plain version at each of the three renders' exact
     tables (captured from one more run), at the tolerances of phase 7,
     with its time and bound there;
 10. the rest of the single-modality recipe on the scene of phase 5:
     learnwv on the fused route with tile_cull, calibrate_opacity_init
     (12 renders of view 0, K1 only), then 30 iterations of Trainer.train
     with clone/split densification every 5 from iteration 4, the opacity
     reset every 10, early stopping, the Nadir DSM's MAE (evaluate_dsm_mae
     against the scene's heightfield, the native registration) as the eval
     hook every 10 and training_report at 30; per densify event the clone
     and split counts and alive, the main render's pairs before and after,
     each hook's wall time split into the Nadir render, the host flatten
     and the registration, the MAEs, the report's scalars, K1's and K2's
     launches, the step's ms before and after densification. It fails if
     alive does not grow after an event that selected rows while slots were
     free, if an opacity Adam moment is nonzero after a reset, if an MAE
     or a step's metric is not finite, or if a render clips;
 11. the CLI end to end through cli.main, on the scene of phase 5 (the
     phase's path, run after phase 10 and before phase 9): make-synthetic
     writes the scene (load_scene of it gives phase 5's init cloud and
     images, bit for bit); train (baseogs, --raster-mode fused, 100
     iterations, a model save and a checkpoint at 50 and 100, the MAE hook
     and training_report at 100); chkpnt100 restored into a fresh Trainer
     (every parameter, bookkeeping row, shading leaf and Adam moment
     bit-equal, Adam step 100); train --start-checkpoint chkpnt50 for 10
     iterations; render (the gather route with the plain blend, K 16384
     above every render's densest tile and max_tiles_per_gaussian 1024
     above its widest Gaussian, both checked), its Nadir.tif equal to
     nadir_dsm of load_model's model and the PLY's rows equal to the
     checkpoint's alive rows; eval-dsm of that DSM within 0.05 m of the
     hook's MAE; tsdf --export-mesh of the render's 6 train altitude maps
     at 0.5 m voxels (483 x 483 x 199 = 46,424,511 voxels, 12 slabs) and
     eval-dsm of its DSM (seconds by part, peak memory, mesh size, the TSDF
     DSM's MAE beside the Nadir DSM's); the same maps mirrored to run south
     (the synthetic affines' v = +y gives every view weight 0) through
     run_tsdf at full size with the mesh, and the TSDF gates at 4 m: one
     slab against slabs of 1000 voxels bit-identical, the card's
     integration and run_tsdf against the port's own on the CPU
     (tests/test_torch_tsdf.py's tolerances); the video's 8 frames. Stage
     seconds, save_model's seconds, the checkpoint's bytes, the render's
     seconds per view. Neither imageio nor Pillow may be imported;
 12. the paper's recipe (eogsplus: 3PAN, flow matching, the flow bake, the
     colour operations) on the scene of phase 5 in modality "ms" (each
     view's PAN companion derived from its MSI image, run after phase 11):
     30 iterations of Trainer.train on the fused route with tile_cull, the
     sun, the random camera and the flow phase in every step, the flow bake
     at 20, a colour reset at 25, normalize_colors_before_saving at 30;
     then 12 steps with the flow phase off and 10 with it on again, each
     timed; the bake's shifts and seconds, the colour reset's mask count
     and seconds; K1 and K2 at the step's main render against their plain
     versions (phase 5's tolerances); phase_correlation_shift of a PAN
     render against itself rolled by (+3, -2) px within 0.05 px; then the
     dual MS mode "fixed" (msi and pan per step: 6 renders) for 5 steps
     with the flow phase and 5 without. K1 and K2 launches of both runs,
     the preprocess kernels' of the dual one (6 forward, 6 backward a
     step);
 13. full-eval through cli.main at a reduced size (run after phase 9):
     make-synthetic of a 256x256 scene with 9 views, full-eval (baseogs,
     --raster-mode fused, 200 iterations, --export-mesh): train, render,
     the Nadir DSM's MAE, tsdf, the TSDF DSM's MAE, both stage lines finite,
     the TSDF DSM and the OBJ written, no render clipped; metrics_cli on
     the test renders against their GT (a finite PSNR); K1 and K2
     launches; imageio and Pillow blocked;
 14. the safe route (gather, the plain dense blend) in one training step at
     256x256 with about 20k Gaussians, on the card and on the CPU from the
     same state and draws: loss terms within rel 1e-4, every gradient
     within 2e-4 of its largest value; it launches no hand-written kernel;
 15. the multi-device path on the card (phase_multidevice, after phase
     14): an NCCL process group of world size 1 and its ("g",) mesh; K1,
     K2 and K3 at a band offset on phase 3's view render cut into 4 row
     bands (tile0 = each band's first tile) against their plain versions
     at the same tile0 (phase 2's and 4's tolerances), the bands put
     together bit-equal to the whole frame; on phase 5's scene, 2 warm-up
     and 10 timed fused steps, then 2 + 10 steps of a Trainer with
     raster_backend="a2a" on the mesh (every render through the band sort,
     the windows, the exchange, the (tile, depth) sort and K1/K2 at the
     band offset, and back), capacities by probe_capacities: ms per step
     beside the fused step's, K1/K2 launches (3 each a step), no pair
     dropped, the largest window against dest_cap, peak memory; one
     profiled a2a step; one a2a step on the row payload (3 K3 launches
     each way); one main render through rasterize_a2a against rasterize on
     the fused route (image atol 5e-5, gradients 2e-4 of the largest);
     the sharded TSDF at 0.5 m on the a2a model's 6 train altitude maps
     mirrored south equal to the unsharded one; a gspmd step with the mesh
     against the one-device step (the same loss; every leaf's gradient,
     the rotation's included, within 2e-4 of its largest value, and two
     one-device steps bit-equal) and 3 views_per_step=2 steps on a 256^2
     scene;
 16. the multi-device path on four cards (phase_multicard, with 4 or more
     cards visible; with fewer, a line before the last says it did not
     run): 4 ranks, one card each, over NCCL on phase 5's scene (written
     once to an .npz), each holding (a) one a2a main render against the
     one-card fused render on rank 0 (image atol 5e-5, gradients 2e-4 of
     the largest, no pair dropped, K1/K2/K3 at its band's tile0 against
     the plain versions), (b) the a2a Trainer (step 1 twice bit-equal,
     the row payload's step 1 with the same loss bits, 2 + 10 timed
     steps, the exchanges' times and bytes, the windows, peak memory, one
     profiled step; the one-card fused Trainer's steps on rank 0, step
     1's loss within rel 1e-6), (c) a gspmd step and 3 views_per_step=2
     steps on a ("d", "g") = 2 x 2 mesh against one card's, (d) the
     sharded TSDF against the unsharded one bit for bit; then (e) the
     CLI: train --n-devices 4 --raster-backend a2a, render, tsdf
     --n-devices 4, eval-dsm, and a one-card restore of the checkpoint;
 17. the kernel table line (K1's and K2's launches include phases 10, 11,
     12, 13, 15 and 16; K3's the row-payload steps of 15 and 16; the
     preprocess's the counted runs of 3, 5 and 12's dual mode), then the
     last line.

Beside these, after phase 5 two fused Trainers from one seed take step 1
(every leaf's gradient bit-equal: the resample's backward is
deterministic), and the fused and the fast step are timed with the port's
resample against F.grid_sample's own backward in paired turns
(resample_ab); after phase 7, phase_resample holds the resample at the sun
resample's shape against F.grid_sample.

    python3 chip_smoke.py --multicard

runs only phase 1 and phase 16 (and a kernels line of K1-K3 from it); it
raises when fewer than 4 cards are visible.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_FP32_FLOPS = 67e12  # FP32 outside the tensor cores, H100 SXM
ATOL_CH, ATOL_T = 2e-4, 2e-5
FIELDS = ("xyz", "features_dc", "scaling", "rotation", "opacity")  # leaves

CARD = {}


def log(obj):
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


# ----------------------------------------------------------------------------
# scenes
# ----------------------------------------------------------------------------


def random_scene(n, width, seed, scale_px=(0.5, 2.5), opac=(0.05, 0.95),
                 alt=(-0.5, 0.5)):
    """Seeded Gaussians over the NDC square viewed by a sheared affine
    camera: (means, scales, quats, opacities, features, affine, bg) numpy."""
    rng = np.random.RandomState(seed)
    means = np.empty((n, 3), np.float32)
    means[:, :2] = rng.uniform(-0.9, 0.9, (n, 2))
    means[:, 2] = rng.uniform(*alt, n)
    px_per_unit = width / 2.0
    scales = np.exp(rng.uniform(np.log(scale_px[0]), np.log(scale_px[1]),
                                (n, 3))) / px_per_unit
    quats = rng.normal(0, 1, (n, 4))
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    opacities = rng.uniform(*opac, n)
    affine = np.array([[0.9, 0.05, 0.15, 0.01], [-0.04, 0.88, -0.2, -0.02],
                       [0.0, 0.0, 1.0, 0.0]], np.float32)
    altitude = means @ affine[2, :3] + affine[2, 3]
    feats = np.concatenate([rng.uniform(0, 1, (n, 3)), altitude[:, None],
                            np.ones((n, 1))], 1)
    bg = np.array([0.3, 0.5, 0.2, -1.0, 0.0])
    f32 = [np.ascontiguousarray(x, np.float32)
           for x in (means, scales, quats, opacities, feats, affine, bg)]
    return f32


def serve_scene(n, width, seed, device):
    """The serving workload: model, view camera, scene with its Nadir
    camera, shading params. Gaussians lie on a synthetic heightfield inside
    the synthetic world box, anisotropic, randomly rotated, colored by the
    heightfield's texture."""
    from eogs2_tpu_torch.cameras import camera_from_reference_convention
    from eogs2_tpu_torch.data.synthetic import (_heightfield, make_affine,
                                                sun_model_from_affine)
    from eogs2_tpu_torch.model import GaussianModel
    from eogs2_tpu_torch.ops.sh import RGB2SH
    from eogs2_tpu_torch.scene import SceneData, ViewData
    from eogs2_tpu_torch.shading import CameraShadingParams

    rng = np.random.RandomState(seed)
    alt_range = (-0.35, 0.35)
    res = 1024
    z, tex = _heightfield(res, 24, rng, alt_range)
    xy = rng.uniform(-0.85, 0.85, (n, 2))
    ix = np.clip(((xy + 1) * 0.5 * (res - 1)).round().astype(int), 0, res - 1)
    alt = np.clip(z[ix[:, 1], ix[:, 0]] + rng.normal(0, 0.003, n), *alt_range)
    xyz = np.concatenate([xy, alt[:, None]], 1).astype(np.float32)
    rgb = tex[ix[:, 1], ix[:, 0]]
    px = 2.0 / width  # world units per pixel at NDC span 2
    scales = np.exp(rng.uniform(np.log(0.5), np.log(3.0), (n, 3))) * px
    # unit quaternions: the rasterizer takes them raw (unnormalized), so a
    # random 4-vector's norm would scale every covariance by |q|^4
    quats = rng.normal(0, 1, (n, 4))
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    opac = rng.uniform(0.05, 0.95, n)
    zeros = np.zeros(n, np.float32)
    model = GaussianModel.from_numpy(
        dict(xyz=xyz, features_dc=RGB2SH(rgb)[:, None, :],
             features_rest=np.zeros((n, 0, 3)), scaling=np.log(scales),
             rotation=quats, opacity=np.log(opac / (1 - opac))[:, None]),
        dict(alive=np.ones(n, bool), max_radii2d=zeros,
             xyz_gradient_accum=zeros, denom=zeros),
        device=device,
    )
    el, az = np.radians(90 - 55.0), np.radians(120.0)
    sun_dir = np.array([np.sin(az) * np.cos(el), np.cos(az) * np.cos(el),
                        np.sin(el)])

    def camera(shear):
        A = make_affine(shear, width, width, alt_range)
        sA, sb, _, cam2sun = sun_model_from_affine(A, sun_dir)
        return camera_from_reference_convention(
            A[:, :3], A[:, 3], sA, sb, cam2sun, altitude_bounds=alt_range,
            width=width, height=width, device=device)

    view = camera((0.2, 0.1))
    nadir = camera((0.0, 0.0))
    scene = SceneData(
        train_views=[ViewData("view_00", "msi", view, None)],
        test_views=[ViewData("Nadir", "msi", nadir, None, is_virtual=True)],
        init_xyz=xyz, init_rgb=rgb, scene_shift=np.zeros(3),
        scene_scale=25.0, scene_n=17, scene_l="R", cameras_extent=2.0,
    )
    shading = CameraShadingParams.from_numpy(dict(
        cc_weight=np.eye(3)[None] + 0.05 * rng.normal(size=(1, 3, 3)),
        cc_bias=0.02 * rng.normal(size=(1, 3)),
        inshadow=rng.uniform(0.05, 0.3, (1, 3)),
        last_row=np.zeros((1, 4)), exposure=np.eye(3, 4)[None],
        msi_to_pan_weight=np.ones((1, 3)) / 3, msi_to_pan_bias=np.zeros(1),
    ), device=device)
    return model, view, scene, shading


# ----------------------------------------------------------------------------
# K1 against its plain version
# ----------------------------------------------------------------------------


def sorted_inputs(means, scales, quats, opac, feats, affine, width, height,
                  tile_cull=False, eogs=False):
    """The exact inputs rasterize() hands K1 for this render."""
    from eogs2_tpu_torch.ops.fused_raster import sort_pairs
    from eogs2_tpu_torch.ops.projection import (compute_cov2d_direct,
                                                preprocess_gaussians)

    cov2d = compute_cov2d_direct(scales, quats, affine, width, height)
    prep = preprocess_gaussians(means, None, opac, affine, width, height,
                                cov2d=cov2d)
    return sort_pairs(prep, feats, width, height, tile_cull, eogs)


def compare_k1(sp, grid_x):
    """Kernel vs plain on the same inputs -> (report, kernel out8)."""
    import torch

    from eogs2_tpu_torch.ops.fused_raster import (fused_blend_fwd,
                                                  fused_blend_fwd_plain)

    k = fused_blend_fwd(sp.pay, sp.tstart, sp.cnt, grid_x)
    p = fused_blend_fwd_plain(sp.pay, sp.tstart, sp.cnt, grid_x)
    torch.cuda.synchronize()
    err_ch = float((k[..., :5] - p[..., :5]).abs().max())
    err_t = float((k[..., 5] - p[..., 5]).abs().max())
    rep = dict(pairs=int(sp.pay.shape[1]), max_tile_count=int(sp.cnt.max()),
               max_abs_err_ch0_4=err_ch, max_abs_err_final_t=err_t,
               n_contrib_mismatches=int((k[..., 6] != p[..., 6]).sum()),
               saturated_pixel_share=float((k[..., 5] < 1e-2).float().mean()))
    if not (err_ch <= ATOL_CH and err_t <= ATOL_T
            and rep["n_contrib_mismatches"] == 0 and torch.isfinite(k).all()):
        raise AssertionError(f"K1 disagrees with its plain version: {rep}")
    return rep, k


def time_cuda(fn, reps):
    """Mean ms per call over `reps` calls, by CUDA events, after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def k1_work(sp, grid_x, chunk_elems=1 << 25, tile0=0):
    """What this K1 call's data needs, counted with fused_blend_fwd_plain's
    arithmetic: each pixel evaluates its tile's pairs front to back up to and
    including the pair at which it stops (all of them when it never
    saturates) and composites its kept live pairs; each tile reads its pairs
    up to its pixels' deepest stop; tile t of the call is tile tile0 + t
    of the frame. Returns (evaluations, composites, pairs read)."""
    import torch

    from eogs2_tpu_torch.ops.blend import ALPHA_EPS, ALPHA_MAX, T_EPS
    from eogs2_tpu_torch.ops.fused_raster import P, POWER_TOL, TILE

    pay, tstart, cnt = sp.pay, sp.tstart, sp.cnt
    dev, n_tiles = pay.device, tstart.shape[0]
    cnt_host = cnt.cpu()
    tc = max(1, chunk_elems // (P * max(int(cnt_host.max()), 1)))
    lpix = torch.arange(P, device=dev)
    evals = comps = read = 0
    for t0 in range(0, n_tiles, tc):
        t1 = min(t0 + tc, n_tiles)
        k_len = int(cnt_host[t0:t1].max())
        if k_len == 0:
            continue
        ids = torch.arange(t0, t1, device=dev) + tile0
        k = torch.arange(k_len, device=dev)
        valid = k[None, :] < cnt[t0:t1, None]
        idx = torch.clamp(tstart[t0:t1, None].long() + k[None, :],
                          max=max(pay.shape[1] - 1, 0))
        g = pay[:, idx]  # [11, tc, K]
        px = ((ids % grid_x) * TILE)[:, None] + lpix % TILE
        py = ((ids // grid_x) * TILE)[:, None] + lpix // TILE
        dx = g[0][..., None] - px[:, None, :].float()
        dy = g[1][..., None] - py[:, None, :].float()
        power = (-0.5 * (g[2][..., None] * dx * dx + g[4][..., None] * dy * dy)
                 - g[3][..., None] * dx * dy)
        alpha = torch.clamp_max(
            g[5][..., None] * torch.exp(torch.clamp_max(power, 0.0)),
            ALPHA_MAX)
        keep = valid[..., None] & (power <= POWER_TOL) & (alpha >= ALPHA_EPS)
        cp = torch.cumprod(1.0 - torch.where(keep, alpha, 0.0), dim=1)
        live = cp >= T_EPS
        n_live = live.sum(dim=1)  # [tc, P] pairs before the stop
        n_tile = cnt[t0:t1, None].long()
        stop = torch.where(n_live < n_tile, n_live + 1, n_tile)
        evals += int(stop.sum())
        comps += int((keep & live).sum())
        read += int(stop.amax(dim=1).sum())
    return evals, comps, read


# K1's FP32 operations per pair-pixel evaluation: dx, dy, the power quadratic
# (9), the power test, min, exp, op * g, the 0.99 clamp, the alpha test; and
# per composite: 1 - alpha, T (1 - alpha), the T_EPS test, alpha T, and a
# multiply-add for each of the 5 channels
K1_OPS_PER_EVAL, K1_OPS_PER_COMPOSITE = 17, 14
K1_BYTES_PER_PAIR = 44  # 11 float32 payload rows


def k1_bound(sp, grid_x, tile0=0):
    """Least time the card needs for this K1 call: the larger of the bytes
    this data makes it move (the payload up to each tile's deepest stop, the
    tile ranges, out8) over the HBM rate and its FP32 operations over the
    FP32 peak."""
    evals, comps, read = k1_work(sp, grid_x, tile0=tile0)
    n_tiles = sp.tstart.shape[0]
    bytes_ = K1_BYTES_PER_PAIR * read + 8 * n_tiles + n_tiles * 256 * 8 * 4
    ops = K1_OPS_PER_EVAL * evals + K1_OPS_PER_COMPOSITE * comps
    t_bytes = bytes_ / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_FP32_FLOPS * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=bytes_, ops=ops, evaluations=evals, composites=comps,
                pairs_read=read,
                evaluations_without_early_exit=int(sp.cnt.long().sum()) * 256)


def compare_k2(sp, grid_x, out8, seed=0):
    """K2 vs its plain version on the same inputs and a seeded random
    cotangent -> (report, kernel g_pay, g_out8)."""
    import torch

    gen = torch.Generator(device=out8.device).manual_seed(seed)
    g_out8 = torch.randn(out8.shape, generator=gen, device=out8.device)
    return compare_k2_at(sp, grid_x, out8, g_out8) + (g_out8,)


def compare_k2_at(sp, grid_x, out8, g_out8):
    import torch

    from eogs2_tpu_torch.ops.fused_raster import (fused_blend_bwd,
                                                  fused_blend_bwd_plain)

    k = fused_blend_bwd(sp.pay, sp.tstart, sp.cnt, out8, g_out8, grid_x)
    k_again = fused_blend_bwd(sp.pay, sp.tstart, sp.cnt, out8, g_out8, grid_x)
    p = fused_blend_bwd_plain(sp.pay, sp.tstart, sp.cnt, out8, g_out8, grid_x)
    torch.cuda.synchronize()
    scale = p.abs().amax(dim=1)
    live = scale > 0  # a row with no gradient (the constant row) must stay 0
    err_rows = ((k - p).abs().amax(dim=1) / scale.clamp_min(1e-30))
    rep = dict(pairs=int(sp.pay.shape[1]),
               max_row_rel_err=float(err_rows[live].max()),
               max_abs_err=float((k - p).abs().max()),
               rows_without_gradient=int((~live).sum()),
               bitwise_deterministic=bool(torch.equal(k, k_again)))
    if not (rep["max_row_rel_err"] <= K2_ROW_TOL and rep["bitwise_deterministic"]
            and bool((k[~live] == 0).all()) and bool(torch.isfinite(k).all())):
        raise AssertionError(f"K2 disagrees with its plain version: {rep}")
    return rep, k


# K2's FP32 operations: per pair-pixel evaluation (each pixel evaluates the
# pairs before its last composite) the recomputation K1 does (17); per
# contributing (kept, live) pair-pixel: 1 - alpha, T (1 - alpha), the T_EPS
# test, alpha T (4), fdot (9), prefix (2), suffix (1), g_alpha (4), gG (2),
# the 11 payload gradients (25) and their 11 sums over the tile's pixels (11)
K2_OPS_PER_EVAL, K2_OPS_PER_CONTRIB = 17, 58
K2_OPS_PER_PIXEL = 10  # total = acc . g_pix (9), final_T g_ft (1)
K2_ROW_TOL = 2e-4


def k2_bound(sp, grid_x, out8, tile0=0):
    """Least time the card needs for this K2 call: the larger of the bytes
    it must move (the payload up to each tile's deepest walk, g_pay written
    for every pair the tiles hold, out8 and g_out8 read, the tile ranges)
    over the HBM rate and its FP32 operations over the FP32 peak.
    Evaluations are the pixels' walk lengths (out8 channel 6),
    contributions the composites K1 made (k1_work); tile t of the call is
    tile tile0 + t of the frame."""
    _, comps, _ = k1_work(sp, grid_x, tile0=tile0)
    last = out8[..., 6].double()
    evals = int(last.sum())
    read = int(last.amax(dim=1).sum())
    n_tiles = sp.tstart.shape[0]
    bytes_ = (K1_BYTES_PER_PAIR * (read + int(sp.cnt.long().sum()))
              + 2 * n_tiles * 256 * 8 * 4 + 8 * n_tiles)
    ops = (K2_OPS_PER_EVAL * evals + K2_OPS_PER_CONTRIB * comps
           + K2_OPS_PER_PIXEL * n_tiles * 256)
    t_bytes = bytes_ / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_FP32_FLOPS * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=bytes_, ops=ops, evaluations=evals, contributions=comps,
                pairs_read=read)


# ----------------------------------------------------------------------------
# phases
# ----------------------------------------------------------------------------


def phase_build():
    from eogs2_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    names = [b[0] for b in cuda_build.build_all()]
    for name in names:
        cuda_build.load(name)
    # ptxas's report, from this build or kept beside an earlier one
    logs = {n: cuda_build.build_logs.get(n, "") for n in names}
    spills = {n: sum(int(b) for b in re.findall(
        r"(\d+) bytes spill (?:stores|loads)", text))
        for n, text in logs.items()}
    log(dict(phase="build", kernels=names,
             seconds=time.perf_counter() - t0, spill_bytes=spills,
             ptxas={n: text.strip()[-600:] for n, text in logs.items()},
             **CARD))
    if any(spills.values()) or not all("spill" in t for t in logs.values()):
        raise AssertionError(f"ptxas spilled registers, or its report is "
                             f"missing: {spills}")


def phase_k1_small(device):
    import torch

    from eogs2_tpu_torch.rasterizer import (RasterizeConfig, rasterize,
                                            reference_rasterize)

    w = 256
    for name, (arrs, cull) in small_scenes(20000, w).items():
        t = [torch.as_tensor(a, device=device) for a in arrs]
        sp = sorted_inputs(*t[:6], w, w, tile_cull=cull)
        rep, _ = compare_k1(sp, w // 16)
        if name == "dense_saturating" and rep["saturated_pixel_share"] < 0.5:
            raise AssertionError(f"dense scene does not saturate: {rep}")
        log(dict(phase="k1_vs_plain", scene=name, width=w, height=w,
                 tile_cull=cull, **rep, **CARD))

    arrs = random_scene(512, 128, seed=7, scale_px=(1.0, 5.0))
    t = [torch.as_tensor(a, device=device) for a in arrs]
    out = rasterize(*t, 128, 128, RasterizeConfig(binning_mode="fused"))
    img, ft, _ = reference_rasterize(*t, 128, 128)
    e_img = float((out.image - img).abs().max())
    e_ft = float((out.final_t - ft).abs().max())
    log(dict(phase="fused_vs_dense_oracle", width=128, height=128,
             max_abs_err_image=e_img, max_abs_err_final_t=e_ft, **CARD))
    if not (e_img <= 5e-5 and e_ft <= 5e-5):
        raise AssertionError("fused render disagrees with the dense oracle")


def profile_run(fn, top=12):
    """One run of fn under torch.profiler: the device time of each kernel
    and copy, the device's busy share of the run's wall time (the
    profiler's own cost included), the top kernels by device time, and the
    top PyTorch operators by the device time of the kernels they launched
    themselves (which operator a kernel belongs to)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    # device-side events only (kernels, copies): a CPU op's device time is
    # its kernels' time counted a second time
    events = prof.key_averages()
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in events
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    ops = [(e.key, e.self_device_time_total / 1e3, e.count)
           for e in events
           if e.device_type == DeviceType.CPU
           and e.self_device_time_total > 0]
    ops.sort(key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows)
    return dict(wall_ms=wall_ms, device_ms=device_ms,
                device_busy_share=device_ms / wall_ms,
                kernels=[dict(name=k[:80], ms=ms, calls=c)
                         for k, ms, c in rows[:top]],
                operators=[dict(name=k[:60], ms=ms, calls=c)
                           for k, ms, c in ops[:top]])


def median_ms(fn, runs=3):
    """Median host-clock ms of `runs` calls, each ending in a synchronize."""
    import torch

    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times), times


def check_serve_outputs(out, nout, dsm, scene, width):
    """The serving gates (PERF.md section 2): outputs finite, acc_opacity in
    [0, 1], the render's shape, >= 90% of DSM cells finite and inside the
    altitude bounds. Returns the DSM's statistics."""
    for key, arr in list(out.items()) + list(nout.items()):
        if arr is not None and not np.isfinite(arr).all():
            raise AssertionError(f"non-finite values in {key}")
    acc_tol = 1e-5  # sum of alpha*T over pairs equals 1 - final_T only to f32
    for o in (out, nout):
        acc = o["acc_opacity"]
        if acc.min() < -acc_tol or acc.max() > 1 + acc_tol:
            raise AssertionError(f"acc_opacity outside [0,1]: "
                                 f"{acc.min()} {acc.max()}")
    if out["raw_render"].shape != (3, width, width):
        raise AssertionError(f"raw_render shape {out['raw_render'].shape}")
    cells = dsm[..., 0]
    finite_share = float(np.isfinite(cells).mean())
    lo, hi = (float(b) * scene.scene_scale + float(scene.scene_shift[2])
              for b in scene.test_views[0].camera.altitude_bounds)
    h = cells[np.isfinite(cells)]
    if finite_share < 0.9 or h.min() < lo - 1e-3 or h.max() > hi + 1e-3:
        raise AssertionError(f"DSM check failed: finite {finite_share}, "
                             f"heights [{h.min()}, {h.max()}] vs [{lo}, {hi}]")
    return dict(dsm_shape=list(cells.shape), dsm_finite_share=finite_share,
                dsm_height_range=[float(h.min()), float(h.max())],
                dsm_height_bounds=[lo, hi])


def serve_renders(view, scene, width):
    """The serving path's three fused renders: name -> (camera, width)."""
    sun_cam, _ = view.sun_camera(f=2)
    return {"view": (view, width), "sun": (sun_cam, 2 * width),
            "nadir": (scene.test_views[0].camera, width)}


def serve_render_inputs(model, cam, w):
    """The exact inputs render_view_full or nadir_dsm hands K1 for cam."""
    import torch

    from eogs2_tpu_torch.renderer import gaussian_features

    with torch.no_grad():
        feats = gaussian_features(model, cam)
        return sorted_inputs(model.xyz, model.get_scaling(), model.rotation,
                             model.get_opacity(), feats,
                             cam.resize_canvas(w, w).affine, w, w, eogs=True)


def phase_serve(device, n=1_000_000, width=1024):
    import torch

    from eogs2_tpu_torch.ops.fused_raster import (fused_blend_fwd,
                                                  fused_blend_fwd_plain)
    from eogs2_tpu_torch.ops.pair_pipeline import count_pairs, write_pairs
    from eogs2_tpu_torch.ops.projection import preprocess_bwd, preprocess_fwd
    from eogs2_tpu_torch.pipeline import nadir_dsm, render_view_full
    from eogs2_tpu_torch.rasterizer import RasterizeConfig

    t0 = time.perf_counter()
    model, view, scene, shading = serve_scene(n, width, seed=0, device=device)
    cfg = RasterizeConfig(binning_mode="fused", eogs_features=True)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    def rvf():
        return render_view_full(model, view, cfg, shading=shading)

    def nadir():
        return nadir_dsm(model, scene, cfg)

    # the counted run (also the warm-up): counts set to 0 just before each
    # entry point and read just after
    torch.cuda.reset_peak_memory_stats()
    fused_blend_fwd.launches = 0
    count_pairs.launches = write_pairs.launches = 0
    preprocess_fwd.launches = preprocess_bwd.launches = 0
    out = rvf()
    torch.cuda.synchronize()
    launches_rvf = fused_blend_fwd.launches
    emit_rvf = (count_pairs.launches, write_pairs.launches)
    prep_rvf = (preprocess_fwd.launches, preprocess_bwd.launches)
    fused_blend_fwd.launches = 0
    count_pairs.launches = write_pairs.launches = 0
    preprocess_fwd.launches = preprocess_bwd.launches = 0
    profile, dsm, nout = nadir()
    torch.cuda.synchronize()
    launches_nadir = fused_blend_fwd.launches
    emit_nadir = (count_pairs.launches, write_pairs.launches)
    prep_nadir = (preprocess_fwd.launches, preprocess_bwd.launches)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    if launches_rvf != 2 or launches_nadir != 1:
        raise AssertionError(f"K1 launches: render_view_full {launches_rvf} "
                             f"(want 2), nadir_dsm {launches_nadir} (want 1)")
    if emit_rvf != (2, 2) or emit_nadir != (1, 1):
        raise AssertionError(f"emission (count, write) launches: "
                             f"render_view_full {emit_rvf} (want (2, 2)), "
                             f"nadir_dsm {emit_nadir} (want (1, 1))")
    if prep_rvf != (2, 0) or prep_nadir != (1, 0):
        raise AssertionError(f"preprocess (forward, backward) launches: "
                             f"render_view_full {prep_rvf} (want (2, 0)), "
                             f"nadir_dsm {prep_nadir} (want (1, 0))")

    rvf_ms, rvf_all = median_ms(rvf)
    nadir_ms, nadir_all = median_ms(nadir)
    for name, fn in (("render_view_full", rvf), ("nadir_dsm", nadir)):
        log(dict(phase="serve_profile", entry_point=name, **profile_run(fn),
                 **CARD))

    log(dict(phase="serve", gaussians=n, width=width, height=width,
             sun_width=2 * width, config="fused, eogs_features",
             setup_s=setup_s,
             render_view_full_ms=rvf_ms, render_view_full_runs_ms=rvf_all,
             nadir_dsm_ms=nadir_ms, nadir_dsm_runs_ms=nadir_all,
             peak_mem_gib=peak_gib, k1_launches_render_view_full=launches_rvf,
             k1_launches_nadir_dsm=launches_nadir,
             emit_launches_render_view_full=emit_rvf,
             emit_launches_nadir_dsm=emit_nadir,
             preprocess_launches_render_view_full=prep_rvf,
             preprocess_launches_nadir_dsm=prep_nadir,
             **check_serve_outputs(out, nout, dsm, scene, width), **CARD))

    # ---- K1 at the three renders' exact inputs --------------------------
    per_render = {}
    for name, (cam, w) in serve_renders(view, scene, width).items():
        sp = serve_render_inputs(model, cam, w)
        rep, k = compare_k1(sp, w // 16)
        gx = w // 16
        rep["ms"] = time_cuda(
            lambda: fused_blend_fwd(sp.pay, sp.tstart, sp.cnt, gx), 20)
        rep["plain_ms"] = time_cuda(
            lambda: fused_blend_fwd_plain(sp.pay, sp.tstart, sp.cnt, gx), 1)
        rep.update(k1_bound(sp, gx))
        per_render[name] = rep
        log(dict(phase="k1_at_serve_shape", render=name, width=w, height=w,
                 **rep, **CARD))
        del sp, k
    emission = phase_emission_at_serve_shape(model, view, scene, width)
    prep = phase_preprocess_at_main_shapes(model, view, width)
    return (per_render, launches_rvf + launches_nadir,
            sum(emit_rvf) + sum(emit_nadir), emission,
            prep_rvf[0] + prep_nadir[0], prep)


EMIT_OPS_PER_TILE = 110  # the cull test's FP32 operations
# rect_min, rect_size, tiles, depth read, the count written
EMIT_BYTES_PER_GAUSSIAN = 8 + 8 + 4 + 4 + 8
EMIT_CULL_BYTES_PER_GAUSSIAN = 8 + 12 + 4  # mean2d, conic, thr read
EMIT_BYTES_PER_PAIR = 24  # gid, tile, key written


def emission_bound(walk, pairs):
    """Least time the card needs for the emission, whatever its design:
    each per-Gaussian input it reads once (mean2d, conic and the threshold
    only with a cull), each Gaussian's count and the pairs written, against
    one cull test at every walked tile."""
    n = walk.tiles.shape[0]
    walked = int(walk.tiles.long().sum())
    cull = walk.thr is not None
    bytes_ = ((EMIT_BYTES_PER_GAUSSIAN
               + (EMIT_CULL_BYTES_PER_GAUSSIAN if cull else 0)) * n
              + EMIT_BYTES_PER_PAIR * pairs)
    ops = EMIT_OPS_PER_TILE * walked if cull else 0
    t_bytes = bytes_ / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_FP32_FLOPS * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=bytes_, ops=ops, walked_tiles=walked)


def phase_emission_at_serve_shape(model, view, scene, width):
    """The emission's two passes (csrc/emit_pairs.cu) against the plain
    emission on the same walk, fed by the main path's preprocess
    (rasterizer.preprocess: on the card csrc/preprocess.cu's forward
    kernel), at the serving renders' exact inputs (the 1024^2 view and its
    2048^2 sun with tile_cull, as the benchmark's cells render; the view
    without it and at tcap 16, the dense modes'): gid,
    tile, sort key and counts bit-equal. Times of both (the whole emission:
    passes, prefix sum, the read of the total) and the bound."""
    import torch

    from eogs2_tpu_torch.ops.binning import grid_dims
    from eogs2_tpu_torch.ops.pair_pipeline import (count_pairs, emit_pairs,
                                                   emit_walk_plain, walk_of,
                                                   write_pairs)
    from eogs2_tpu_torch.rasterizer import preprocess
    from eogs2_tpu_torch.renderer import gaussian_features

    renders = serve_renders(view, scene, width)
    cases = [("view", True, None), ("sun", True, None), ("view", False, 16)]
    reps = {}
    for name, cull, tcap in cases:
        cam, w = renders[name]
        with torch.no_grad():  # the preprocess the main path runs
            prep = preprocess(model.xyz, model.get_scaling(), model.rotation,
                              model.get_opacity(),
                              cam.resize_canvas(w, w).affine, w, w)
            depth = -gaussian_features(model, cam)[:, 3]
        gx, _ = grid_dims(w, w)
        walk = walk_of(prep, cull, tcap)
        launches = (count_pairs.launches, write_pairs.launches)
        em = emit_pairs(prep, gx, tile_cull=cull, tcap=tcap, depth=depth)
        if (count_pairs.launches - launches[0],
                write_pairs.launches - launches[1]) != (1, 1):
            raise AssertionError("emit_pairs did not launch one count and "
                                 "one write pass")
        ref = emit_walk_plain(walk, gx, depth)
        torch.cuda.synchronize()
        equal = {f: bool(torch.equal(a, b))
                 for f, a, b in zip(em._fields, em, ref)}
        rep = dict(gaussians=int(prep.depth.shape[0]),
                   pre_cull_pairs=int(walk.tiles.long().sum()),
                   pairs=int(em.gid.shape[0]),
                   widest=int(walk.tiles.max()),
                   over_32_tiles=int((walk.tiles > 32).sum()),
                   bit_equal=equal)
        if not all(equal.values()):
            raise AssertionError(f"the emission kernel disagrees with the "
                                 f"plain emission: {rep}")
        del em, ref
        rep["ms"] = time_cuda(lambda: emit_pairs(prep, gx, tile_cull=cull,
                                                 tcap=tcap, depth=depth), 20)
        rep["count_ms"] = time_cuda(lambda: count_pairs(walk, gx), 20)
        rep["plain_ms"] = time_cuda(
            lambda: emit_walk_plain(walk_of(prep, cull, tcap), gx, depth), 3)
        rep.update(emission_bound(walk, rep["pairs"]))
        key = f"{name}{'' if cull else '_nocull_tcap16'}"
        reps[key] = rep
        log(dict(phase="emission_at_serve_shape", render=name, width=w,
                 height=w, tile_cull=cull, tcap=tcap, **rep, **CARD))
        del prep, walk, depth
    return reps


# each per-Gaussian input read once and each output written once: forward
# xyz, scale, quat, opacity, alive and the NDC offset in, Preprocessed out;
# backward xyz, scale, quat, opacity and the four cotangents in, the
# gradients of xyz, scale, quat, opacity and the offset out
PREP_FWD_BYTES = 12 + 12 + 16 + 4 + 1 + 8 + 52
PREP_BWD_BYTES = 12 + 12 + 16 + 4 + 28 + 52
PREP_LEAVES = ("means3d", "scales", "quats", "opacities", "affine", "offset")


def preprocess_plain(means, scales, quats, opac, affine, w, h, alive,
                     offset):
    """rasterizer.preprocess's plain tensor code where the inputs lie (on
    the card the rasterizer takes the kernels)."""
    import torch

    from eogs2_tpu_torch.ops.projection import (compute_cov2d_direct,
                                                preprocess_gaussians)

    cov2d = compute_cov2d_direct(scales, quats, affine, w, h)
    prep = preprocess_gaussians(means, None, opac, affine, w, h, alive=alive,
                                cov2d=cov2d)
    px = torch.tensor([0.5 * w, 0.5 * h], device=means.device)
    return prep._replace(mean2d=prep.mean2d + offset * px)


def ulps(got, want):
    """|got - want| in units of the last place of want, or of 1 where
    |want| < 1 (tests/test_torch_kernels.py's rule)."""
    import torch

    w = want.abs().clamp_min(1.0)
    return (got - want).abs() / (torch.nextafter(w, w + 1) - w)


def grad_gap(got, want):
    """The gap of the norms over the larger norm; inf where the NaNs of
    the two differ."""
    import torch

    if not torch.equal(got.isnan(), want.isnan()):
        return float("inf")
    got, want = got.nan_to_num(), want.nan_to_num()
    scale = max(float(got.norm()), float(want.norm()), 1e-30)
    return float((got - want).norm()) / scale


def compare_preprocess(k, p):
    """The forward kernel's Preprocessed k against the plain p: conic,
    opacity and radius bit for bit, mean2d and depth within 2 ulp, a rect
    differing only where mean2d does and by at most one tile."""
    import torch

    rep = dict(bit_equal={f: bool(torch.equal(getattr(k, f), getattr(p, f)))
                          for f in ("conic", "opacity", "radius")},
               max_ulps={f: float(ulps(getattr(k, f), getattr(p, f)).max())
                         for f in ("mean2d", "depth")})
    moved = (k.mean2d != p.mean2d).any(-1)
    rects = {}
    for f in ("rect_min", "rect_size", "tiles_touched"):
        diff = (getattr(k, f) != getattr(p, f)).reshape(moved.shape[0],
                                                        -1).any(-1)
        rects[f] = dict(
            differ=int(diff.sum()), differ_unmoved=int((diff & ~moved).sum()),
            max_abs=int((getattr(k, f) - getattr(p, f)).abs().max()))
    rep.update(rects=rects, mean2d_moved=int(moved.sum()))
    rep["ok"] = (all(rep["bit_equal"].values())
                 and max(rep["max_ulps"].values()) <= 2.0
                 and not any(r["differ_unmoved"] for r in rects.values())
                 and rects["rect_min"]["max_abs"] <= 1
                 and rects["rect_size"]["max_abs"] <= 1)
    return rep


def phase_preprocess_at_main_shapes(model, view, width, seed=0):
    """The preprocess's kernels (csrc/preprocess.cu) against the plain
    preprocess on the card at the main paths' shapes: the serving scene's
    1M Gaussians through the 1024^2 view, its 2048^2 sun and the view at
    the dual cell's 256^2 MSI canvas, with a seeded alive mask (4 in 5)
    and a seeded NDC offset, as the flow phase hands it. Forward:
    compare_preprocess. Backward from seeded cotangents, the affine's and
    the offset's gradients too: every leaf within 1e-5 (the gap of the
    norms over the larger norm) of autograd of the plain preprocess and of
    the kernel's plain twin (preprocess_backward_plain), two calls bit for
    bit. Times of both kernels, of the plain forward and of the plain
    forward with autograd's backward, and the byte bounds."""
    import torch

    from eogs2_tpu_torch.ops.projection import (preprocess_backward_plain,
                                                preprocess_bwd,
                                                preprocess_fwd)

    sun_cam, _ = view.sun_camera(f=2)
    shapes = {"view": (view, width), "sun": (sun_cam, 2 * width),
              "msi": (view, width // 4)}
    dev = model.xyz.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    with torch.no_grad():
        ins = [x.detach().contiguous() for x in (
            model.xyz, model.get_scaling(), model.rotation,
            model.get_opacity())]
    n = ins[0].shape[0]
    alive = torch.rand(n, generator=gen, device=dev) > 0.2
    offset = 1e-3 * torch.randn((n, 2), generator=gen, device=dev)
    cts = [torch.randn(s, generator=gen, device=dev)
           for s in ((n, 2), (n,), (n, 3), (n,))]
    reps = {}
    for name, (cam, w) in shapes.items():
        affine = cam.resize_canvas(w, w).affine.detach().contiguous()
        args = (*ins, affine, w, w)
        before = (preprocess_fwd.launches, preprocess_bwd.launches)
        k = preprocess_fwd(*args, alive=alive, offset=offset)
        bwd = [preprocess_bwd(*args, cts, offset_grad=True, affine_grad=True)
               for _ in range(2)]
        launched = (preprocess_fwd.launches - before[0],
                    preprocess_bwd.launches - before[1])
        with torch.no_grad():
            p = preprocess_plain(*ins, affine, w, w, alive, offset)
        rep = compare_preprocess(k, p)
        rep["visible"] = int((k.radius > 0).sum())
        del k, p
        leaves = [x.clone().requires_grad_(True) for x in (*ins, affine,
                                                           offset)]
        p = preprocess_plain(*leaves[:5], w, w, alive, leaves[5])
        auto = torch.autograd.grad(
            sum((c * o).sum() for c, o in zip(cts, p[:4])), leaves)
        del p, leaves
        twin = preprocess_backward_plain(*args, cts)
        rep["bwd_bitwise_repeatable"] = all(
            torch.equal(a.view(torch.int32), b.view(torch.int32))
            for a, b in zip(*bwd))
        rep["bwd_gap_autograd"] = {f: grad_gap(g, a) for f, g, a in
                                   zip(PREP_LEAVES, bwd[0], auto)}
        rep["bwd_gap_twin"] = {f: grad_gap(g, t) for f, g, t in
                               zip(PREP_LEAVES, bwd[0], twin)}
        del bwd, auto, twin
        ok = (rep.pop("ok") and launched == (1, 2)
              and rep["bwd_bitwise_repeatable"]
              and max(rep["bwd_gap_autograd"].values()) < 1e-5
              and max(rep["bwd_gap_twin"].values()) < 1e-5)
        if not ok:
            raise AssertionError(f"the preprocess kernels disagree with the "
                                 f"plain preprocess at the {name} render "
                                 f"(launches {launched}): {rep}")

        def plain_fwd_bwd():
            leaves = [x.clone().requires_grad_(True)
                      for x in (*ins, affine, offset)]
            p = preprocess_plain(*leaves[:5], w, w, alive, leaves[5])
            torch.autograd.grad(
                sum((c * o).sum() for c, o in zip(cts, p[:4])), leaves)

        def plain_fwd():
            with torch.no_grad():
                preprocess_plain(*ins, affine, w, w, alive, offset)

        rep.update(
            fwd_ms=time_cuda(lambda: preprocess_fwd(
                *args, alive=alive, offset=offset), 20),
            bwd_ms=time_cuda(lambda: preprocess_bwd(
                *args, cts, offset_grad=True, affine_grad=True), 20),
            plain_fwd_ms=time_cuda(plain_fwd, 3),
            plain_fwd_bwd_ms=time_cuda(plain_fwd_bwd, 3),
            fwd_bound_ms=PREP_FWD_BYTES * n / H100_BYTES_PER_S * 1e3,
            bwd_bound_ms=PREP_BWD_BYTES * n / H100_BYTES_PER_S * 1e3)
        reps[name] = rep
        log(dict(phase="preprocess_at_main_shape", render=name, width=w,
                 height=w, gaussians=n, **rep, **CARD))
    return reps


def small_scenes(n, w):
    """The three seeded scenes of the small kernel checks: altitudes of both
    signs, the same with tile_cull, and a dense scene whose pixels saturate
    (the early exit runs): name -> (arrays, tile_cull)."""
    return {
        "both_signs": (random_scene(n, w, seed=1), False),
        "both_signs_tile_cull": (random_scene(n, w, seed=1), True),
        "dense_saturating": (random_scene(n, w, seed=2, scale_px=(2.0, 6.0),
                                          opac=(0.5, 0.99)), True),
    }


def phase_k2_small(device, w=256, n=20000):
    import torch

    from eogs2_tpu_torch.ops.fused_raster import fused_blend_fwd
    from eogs2_tpu_torch.rasterizer import RasterizeConfig, rasterize

    errs = []
    for name, (arrs, cull) in small_scenes(n, w).items():
        t = [torch.as_tensor(a, device=device) for a in arrs]
        sp = sorted_inputs(*t[:6], w, w, tile_cull=cull)
        out8 = fused_blend_fwd(sp.pay, sp.tstart, sp.cnt, w // 16)
        rep, _, _ = compare_k2(sp, w // 16, out8)
        errs.append(rep["max_row_rel_err"])
        log(dict(phase="k2_vs_plain", scene=name, width=w, height=w,
                 tile_cull=cull, **rep, **CARD))

    # every input's gradient through the kernels vs the plain versions
    ct = np.random.RandomState(0).normal(size=(5, 128, 128)).astype(np.float32)
    grads = []
    for dev in (device, torch.device("cpu")):
        arrs = random_scene(512, 128, seed=7, scale_px=(1.0, 5.0))
        leaves = [torch.tensor(a, device=dev, requires_grad=True)
                  for a in arrs[:6]]
        off = torch.zeros((512, 2), device=dev, requires_grad=True)
        out = rasterize(*leaves, torch.tensor(arrs[6], device=dev), 128, 128,
                        RasterizeConfig(binning_mode="fused",
                                        eogs_features=True),
                        mean2d_ndc_offset=off)
        (out.image * torch.from_numpy(ct).to(dev)).sum().backward()
        grads.append([x.grad.cpu() for x in leaves + [off]])
    names = ("means", "scales", "quats", "opacities", "features", "affine",
             "mean2d_ndc_offset")
    rel = {k: float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
           for k, a, b in zip(names, *grads)}
    log(dict(phase="rasterize_grads_card_vs_cpu", width=128, height=128,
             max_normalised_err=rel, **CARD))
    if max(rel.values()) > K2_ROW_TOL:
        raise AssertionError(f"gradients on the card disagree: {rel}")
    return max(errs)


class capture_blend_calls:
    """Within the block, record what every differentiable blend of the
    fused route receives: the payload of each forward, and each backward's
    K2 inputs (payload, ranges, out8, cotangent, grid_x). rasterize_fused
    reads FusedBlend from its module, so the block swaps in a subclass that
    records and then runs the original forward and backward (the kernels
    launch and count as usual). With `keep`, only the last `keep` of each
    are held, so a long run does not hold every step's inputs."""

    def __init__(self, keep=None):
        self.keep = keep

    def __enter__(self):
        import collections

        from eogs2_tpu_torch.ops import fused_raster as fr

        self.fr, orig = fr, fr.FusedBlend
        self.fwd_pays = collections.deque(maxlen=self.keep)
        self.bwd_calls = collections.deque(maxlen=self.keep)
        cap = self

        class Recording(orig):
            @staticmethod
            def forward(ctx, pay, tstart, cnt, grid_x, rows=False):
                cap.fwd_pays.append(pay.detach())
                return orig.forward(ctx, pay, tstart, cnt, grid_x, rows)

            @staticmethod
            def backward(ctx, g_out8):
                pay, tstart, cnt, out8 = ctx.saved_tensors
                cap.bwd_calls.append((pay.detach(), tstart, cnt,
                                      out8.detach(),
                                      g_out8.detach().contiguous(),
                                      ctx.grid_x))
                return orig.backward(ctx, g_out8)

        self.orig, fr.FusedBlend = orig, Recording
        return self

    def __exit__(self, *exc):
        self.fr.FusedBlend = self.orig


def train_scene_arrays(width=1024, scale=142.0, n_views=7, hf_res=768,
                       n_buildings=24):
    """The arrays (images, metadata, the ground-truth heightfield) of the
    synthetic scene of scripts/train_scale.py."""
    from eogs2_tpu_torch.data.synthetic import make_scene_arrays

    return make_scene_arrays(n_views=n_views, width=width, height=width,
                             hf_res=hf_res, n_buildings=n_buildings,
                             seed=11, scale=scale)


def train_scene(device, width=1024, scale=142.0, n_views=7, hf_res=768,
                n_buildings=24):
    """The synthetic scene of scripts/train_scale.py, built once in memory
    and shared by the training phases: (scene, host seconds, its arrays:
    images, metadata, the ground-truth heightfield)."""
    from eogs2_tpu_torch.data.synthetic import scene_from_arrays

    t0 = time.perf_counter()
    arrays = train_scene_arrays(width, scale, n_views, hf_res, n_buildings)
    scene = scene_from_arrays(arrays, device=device)
    scene_s = time.perf_counter() - t0
    log(dict(phase="train_scene", init_gaussians=len(scene.init_xyz),
             train_views=len(scene.train_views), width=width, scale=scale,
             host_s=scene_s, **CARD))
    return scene, scene_s, arrays


def train_recipe(iterations):
    """baseogs with the sun and random camera on from iteration 1, so every
    step is the full three-render step."""
    from eogs2_tpu_torch.config import baseogs

    cfg = baseogs(iterations=iterations)
    cfg.optimization.iterstart_shadowmapping = 0
    cfg.optimization.iterstart_L_new_resample = 0
    return cfg


TRAIN_RENDERS = ("main", "sun", "random")  # the order a step renders them


def phase_train(device, scene, scene_s, width=1024, warmup=2, timed=10):
    import torch

    from eogs2_tpu_torch.ops.fused_raster import (SortedPairs,
                                                  fused_blend_bwd,
                                                  fused_blend_bwd_plain,
                                                  fused_blend_fwd,
                                                  fused_blend_fwd_plain)
    from eogs2_tpu_torch.ops.knn import mean_knn_dist2
    from eogs2_tpu_torch.ops.pair_pipeline import count_pairs, write_pairs
    from eogs2_tpu_torch.ops.projection import preprocess_bwd, preprocess_fwd
    from eogs2_tpu_torch.rasterizer import RasterizeConfig
    from eogs2_tpu_torch.train import Trainer, mean_metrics

    n_init = len(scene.init_xyz)
    t0 = time.perf_counter()
    mean_knn_dist2(torch.tensor(scene.init_xyz, device=device))
    torch.cuda.synchronize()
    knn_s = time.perf_counter() - t0

    cfg = train_recipe(warmup + timed)
    rcfg = RasterizeConfig(binning_mode="fused", tile_cull=True)
    t0 = time.perf_counter()
    tr = Trainer(cfg, scene, rcfg, device=device).setup()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    start = {f: getattr(tr.model, f).detach().clone() for f in FIELDS}
    alive0 = int(tr.model.alive.sum())

    tr.train(warmup, progress=False)
    torch.cuda.synchronize()
    # the counted, timed run: counts set to 0 just before, read just after
    torch.cuda.reset_peak_memory_stats()
    fused_blend_fwd.launches = 0
    fused_blend_bwd.launches = 0
    count_pairs.launches = write_pairs.launches = 0
    preprocess_fwd.launches = preprocess_bwd.launches = 0
    steps, step_ms = [], []
    for it in range(warmup + 1, warmup + timed + 1):
        t = time.perf_counter()
        steps.append(tr.train_step(it))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
    k1_launches, k2_launches = fused_blend_fwd.launches, fused_blend_bwd.launches
    emit_launches = (count_pairs.launches, write_pairs.launches)
    prep_launches = (preprocess_fwd.launches, preprocess_bwd.launches)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    if k1_launches != 3 * timed or k2_launches != 3 * timed:
        raise AssertionError(f"launches over {timed} steps: K1 {k1_launches}, "
                             f"K2 {k2_launches} (want {3 * timed} each)")
    if emit_launches != (3 * timed, 3 * timed):
        raise AssertionError(f"emission (count, write) launches over {timed} "
                             f"steps: {emit_launches} (want {3 * timed} "
                             f"each)")
    if prep_launches != (3 * timed, 3 * timed):
        raise AssertionError(f"preprocess (forward, backward) launches over "
                             f"{timed} steps: {prep_launches} (want "
                             f"{3 * timed} each)")
    metrics = mean_metrics(steps)
    every = torch.stack([torch.stack([m[k].double() for k in m])
                         for m in steps])
    if not bool(torch.isfinite(every).all()):
        raise AssertionError(f"non-finite metrics: {metrics}")
    moved = {f: float((getattr(tr.model, f).detach() - x).abs().max())
             for f, x in start.items()}
    if min(moved.values()) <= 0:
        raise AssertionError(f"parameters did not move: {moved}")
    alive1 = int(tr.model.alive.sum())
    log(dict(phase="train", init_gaussians=n_init,
             capacity=int(tr.model.xyz.shape[0]), width=width,
             recipe="baseogs, sun and random camera from iteration 1",
             config="fused, tile_cull, eogs_features",
             ms_per_step=statistics.median(step_ms), step_ms=step_ms,
             k1_launches_per_step=k1_launches / timed,
             k2_launches_per_step=k2_launches / timed,
             emit_launches_per_step=sum(emit_launches) / timed,
             preprocess_launches_per_step=[c / timed for c in prep_launches],
             peak_mem_gib=peak_gib,
             scene_host_s=scene_s, knn_s=knn_s, setup_s=setup_s,
             alive_before=alive0, alive_after=alive1, max_param_change=moved,
             metrics=metrics, **CARD))

    log(dict(phase="train_profile",
             **profile_run(lambda: tr.train_step(warmup + timed + 1)), **CARD))

    # K1 and K2 at each render's exact inputs of one step
    with capture_blend_calls() as cap:
        tr.train_step(warmup + timed + 2)
        torch.cuda.synchronize()
    bwd = {c[0].data_ptr(): c for c in cap.bwd_calls}
    calls = [bwd[p.data_ptr()] for p in cap.fwd_pays]
    del cap, bwd
    if len(calls) != 3:
        raise AssertionError(f"captured {len(calls)} fused renders, want 3")
    k1_at, k2_at = {}, {}
    for name, (pay, tstart, cnt, out8, g_out8, gx) in zip(TRAIN_RENDERS,
                                                           calls):
        sp = SortedPairs(pay, tstart, cnt, None)
        k1, k1_out8 = compare_k1(sp, gx)
        k1["equals_step_out8"] = bool(torch.equal(k1_out8, out8))
        if not k1["equals_step_out8"]:
            raise AssertionError(f"K1 at the {name} render differs from the "
                                 f"step's own out8")
        k1.update(ms=time_cuda(
            lambda: fused_blend_fwd(pay, tstart, cnt, gx), 10),
            plain_ms=time_cuda(
                lambda: fused_blend_fwd_plain(pay, tstart, cnt, gx), 1),
            **k1_bound(sp, gx))
        k2, _ = compare_k2_at(sp, gx, out8, g_out8)
        k2.update(ms=time_cuda(
            lambda: fused_blend_bwd(pay, tstart, cnt, out8, g_out8, gx), 10),
            plain_ms=time_cuda(
                lambda: fused_blend_bwd_plain(pay, tstart, cnt, out8, g_out8,
                                              gx), 1),
            **k2_bound(sp, gx, out8))
        log(dict(phase="k1_k2_at_train_shape", render=name, width=16 * gx,
                 height=16 * (tstart.shape[0] // gx),
                 max_tile_count=int(cnt.max()), k1=k1, k2=k2, **CARD))
        k1_at[name], k2_at[name] = k1, k2
        del sp, k1_out8
    log(dict(phase="k1_k2_per_step", renders=list(TRAIN_RENDERS),
             **{f"{k}_{key}": sum(r[key] for r in at.values())
                for k, at in (("k1", k1_at), ("k2", k2_at))
                for key in ("ms", "bound_ms", "plain_ms")}, **CARD))
    return (k2_at, k1_at, k1_launches, k2_launches, sum(emit_launches),
            calls[0], tr, prep_launches)


def leaf_grads(tr):
    """Every optimised leaf's gradient after a step (the Gaussians' and the
    shading's), by name."""
    return {f"{i}.{j}": p.grad for i, opt in enumerate((tr.gauss_opt,
                                                        tr.cam_opt))
            for j, p in enumerate(q for g in opt.param_groups
                                  for q in g["params"])}


def segment_sum_ms(g, grid, shape):
    """Time of torch.segment_reduce summing img_grad's sorted tap entries
    by target pixel (the other deterministic sum at hand; img_grad adds
    the runs by a pairwise tree instead)."""
    import torch

    from eogs2_tpu_torch.ops.resample import _source_index

    c, h, w = shape
    fx = _source_index(grid[..., 0], w, True)
    fy = _source_index(grid[..., 1], h, True)
    x0, y0 = torch.floor(fx), torch.floor(fy)
    xs = torch.stack([x0, x0 + 1, x0, x0 + 1])
    ys = torch.stack([y0, y0, y0 + 1, y0 + 1])
    inb = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    tgt = torch.where(inb, ys.clamp(0, h - 1).long() * w
                      + xs.clamp(0, w - 1).long(), h * w).reshape(-1)
    tgt_s, order = torch.sort(tgt, stable=True)
    rows = g.reshape(c, -1).repeat(1, 4)[:, order].t().contiguous()
    lengths = torch.bincount(tgt_s, minlength=h * w + 1)
    return time_cuda(lambda: torch.segment_reduce(
        rows, "sum", lengths=lengths, axis=0, unsafe=True), 10)


def phase_resample(device, c=4, h=2048, ho=1024):
    """The deterministic resample (ops/resample.py) at the sun resample's
    shape (a c-channel h^2 render sampled on an ho^2 grid, partly outside):
    forward bit-equal to F.grid_sample's, both gradients within 1e-6 of
    their largest value of F.grid_sample's (atomic) backward, two backward
    calls bit-equal; times of the two backward passes, and of
    aten.grid_sampler_2d_backward with the input gradient masked off
    (output_mask [False, True]: no atomic add) and on, of img_grad, and of
    torch.segment_reduce over img_grad's runs."""
    import torch
    import torch.nn.functional as F

    from eogs2_tpu_torch.ops.resample import grid_sample, img_grad

    gen = torch.Generator(device=device).manual_seed(5)
    img = torch.randn((c, h, h), generator=gen, device=device)
    v, u = torch.meshgrid(*(torch.linspace(-1, 1, ho, device=device),) * 2,
                          indexing="ij")
    grid = torch.stack([0.55 * u + 0.12 * v + 0.3,
                        -0.08 * u + 0.6 * v - 0.45], -1)
    g = torch.randn((c, ho, ho), generator=gen, device=device)

    def run(fn):
        x = img.clone().requires_grad_(True)
        gr = grid.clone().requires_grad_(True)
        out = fn(x, gr)
        out.backward(g)
        return out.detach(), x.grad, gr.grad

    def plain(x, gr):
        return F.grid_sample(x[None], gr[None], mode="bilinear",
                             padding_mode="zeros", align_corners=True)[0]

    a, b, ref = run(grid_sample), run(grid_sample), run(plain)

    def rel(x, y):
        return float((x - y).abs().max() / y.abs().max().clamp_min(1e-30))

    def aten_bwd(mask):
        return torch.ops.aten.grid_sampler_2d_backward(
            g[None], img[None], grid[None], 0, 0, True, mask)

    rep = dict(
        shape=dict(img=[c, h, h], grid=[ho, ho]),
        forward_bitwise_equal=bool(torch.equal(a[0], ref[0])),
        img_grad_rel_err=rel(a[1], ref[1]),
        grid_grad_rel_err=rel(a[2], ref[2]),
        bitwise_deterministic=all(bool(torch.equal(x, y))
                                  for x, y in zip(a, b)),
        grid_grad_masked_equals_full=bool(torch.equal(
            aten_bwd([False, True])[1], aten_bwd([True, True])[1])),
        aten_bwd_grid_only_ms=time_cuda(lambda: aten_bwd([False, True]), 10),
        aten_bwd_both_ms=time_cuda(lambda: aten_bwd([True, True]), 10),
        img_grad_ms=time_cuda(lambda: img_grad(g, grid, img.shape), 10),
        segment_reduce_same_runs_ms=segment_sum_ms(g, grid, img.shape),
        port_fwd_bwd_ms=time_cuda(lambda: run(grid_sample), 10),
        f_grid_sample_fwd_bwd_ms=time_cuda(lambda: run(plain), 10),
        tolerance="gradients 1e-6 of the largest (tests/test_torch_"
                  "resample.py)")
    log(dict(phase="resample", **rep, **CARD))
    if not (rep["forward_bitwise_equal"] and rep["bitwise_deterministic"]
            and rep["grid_grad_masked_equals_full"]
            and rep["img_grad_rel_err"] <= 1e-6
            and rep["grid_grad_rel_err"] <= 1e-6):
        raise AssertionError(f"the resample: {rep}")
    return rep


def phase_repeatable_step(device, scene):
    """Two fused train-1M-1024 Trainers from the same seed (the same state
    and draws) take step 1: the loss and every leaf's gradient bit-equal."""
    import torch

    from eogs2_tpu_torch.rasterizer import RasterizeConfig
    from eogs2_tpu_torch.train import Trainer

    rcfg = RasterizeConfig(binning_mode="fused", tile_cull=True)
    runs = []
    for _ in range(2):
        tr = Trainer(train_recipe(20), scene, rcfg, device=device).setup()
        m = tr.train_step(1)
        runs.append((float(m["loss"]), {k: v.clone() for k, v in
                                        leaf_grads(tr).items()}))
        torch.cuda.synchronize()
    (la, ga), (lb, gb) = runs
    equal = {k: bool(torch.equal(ga[k], gb[k])) for k in ga}
    rep = dict(loss_bitwise_equal=la == lb, leaves=len(equal),
               grads_bitwise_equal=all(equal.values()),
               differing_leaves=[k for k, v in equal.items() if not v])
    log(dict(phase="repeatable_step", cell="train-1M-1024", **rep, **CARD))
    if not (rep["loss_bitwise_equal"] and rep["grads_bitwise_equal"]):
        raise AssertionError(f"two steps from one state differ: {rep}")
    return tr


def resample_ab(tr, iteration, route, rounds=5):
    """tr's training step with the port's resample (this tree) and with
    F.grid_sample's own autograd (the parent's resample, whose backward adds
    atomically), one step at a time: one warm-up of each, then parent,
    this, this, parent, `rounds` times; per round this tree's mean less
    the parent's, and the parent's own spread (PERF.md section 2's paired
    rule). Every step repeats `iteration`."""
    import torch
    import torch.nn.functional as F

    from eogs2_tpu_torch import train as train_mod

    def parent(img, grid, align_corners=True):
        return F.grid_sample(img[None], grid[None], mode="bilinear",
                             padding_mode="zeros",
                             align_corners=align_corners)[0]

    this = train_mod.grid_sample
    ms = {"parent": [], "this": []}
    try:
        for turn in ("parent", "this") + ("parent", "this", "this",
                                          "parent") * rounds:
            train_mod.grid_sample = parent if turn == "parent" else this
            torch.cuda.synchronize()
            t = time.perf_counter()
            tr.train_step(iteration)
            torch.cuda.synchronize()
            ms[turn].append((time.perf_counter() - t) * 1e3)
    finally:
        train_mod.grid_sample = this
    p, t = ms["parent"][1:], ms["this"][1:]
    diff = [(t[2 * r] + t[2 * r + 1] - p[2 * r] - p[2 * r + 1]) / 2
            for r in range(rounds)]
    spread = [abs(p[2 * r] - p[2 * r + 1]) for r in range(rounds)]
    rep = dict(route=route, parent_ms=p, this_ms=t,
               parent_median_ms=statistics.median(p),
               this_median_ms=statistics.median(t),
               round_diff_ms=diff, parent_spread_ms=spread,
               median_diff_ms=statistics.median(diff),
               median_parent_spread_ms=statistics.median(spread))
    log(dict(phase="resample_ab", **rep, **CARD))
    return rep


# ----------------------------------------------------------------------------
# K3: the fused route's row payload
# ----------------------------------------------------------------------------


def rows_of(pay):
    """Column payload [11, P] -> the row payload [P, 16] K3 reads."""
    import torch

    from eogs2_tpu_torch.ops.fused_raster import NF, NFR

    return torch.nn.functional.pad(pay.t(), (0, NFR - NF)).contiguous()


def compare_k3(sp, grid_x, g_out8):
    """K3 forward and backward against K1 and K2 (bit for bit) and against
    the plain versions (K1's and K2's on the columns) on the same inputs."""
    import torch

    from eogs2_tpu_torch.ops.fused_raster import (NF, fused_blend_bwd,
                                                  fused_blend_bwd_rows,
                                                  fused_blend_fwd,
                                                  fused_blend_fwd_plain,
                                                  fused_blend_fwd_rows)

    rows = rows_of(sp.pay)
    out8 = fused_blend_fwd(sp.pay, sp.tstart, sp.cnt, grid_x)
    out8_rows = fused_blend_fwd_rows(rows, sp.tstart, sp.cnt, grid_x)
    plain = fused_blend_fwd_plain(sp.pay, sp.tstart, sp.cnt, grid_x)
    g_col = fused_blend_bwd(sp.pay, sp.tstart, sp.cnt, out8, g_out8, grid_x)
    g_rows = fused_blend_bwd_rows(rows, sp.tstart, sp.cnt, out8, g_out8,
                                  grid_x)
    torch.cuda.synchronize()
    rep = dict(
        pairs=int(sp.pay.shape[1]),
        fwd_bitwise_equal_k1=bool(torch.equal(out8_rows, out8)),
        bwd_bitwise_equal_k2=bool(torch.equal(g_rows[:, :NF].t(), g_col)
                                  and (g_rows[:, NF:] == 0).all()),
        max_abs_err_ch0_4=float((out8_rows[..., :5] - plain[..., :5])
                                .abs().max()),
        max_abs_err_final_t=float((out8_rows[..., 5] - plain[..., 5])
                                  .abs().max()))
    if not (rep["fwd_bitwise_equal_k1"] and rep["bwd_bitwise_equal_k2"]
            and rep["max_abs_err_ch0_4"] <= ATOL_CH
            and rep["max_abs_err_final_t"] <= ATOL_T):
        raise AssertionError(f"K3 disagrees with K1/K2: {rep}")
    return rep, rows


def phase_k3_small(device, w=256, n=20000):
    """K3 against K1/K2 (bit for bit, K2's bits being held against its
    plain version in phase_k2_small) and against K1's plain version."""
    import torch

    from eogs2_tpu_torch.ops.fused_raster import fused_blend_fwd

    errs = []
    for name, (arrs, cull) in small_scenes(n, w).items():
        t = [torch.as_tensor(a, device=device) for a in arrs]
        sp = sorted_inputs(*t[:6], w, w, tile_cull=cull)
        out8 = fused_blend_fwd(sp.pay, sp.tstart, sp.cnt, w // 16)
        gen = torch.Generator(device=device).manual_seed(0)
        g_out8 = torch.randn(out8.shape, generator=gen, device=device)
        rep, _ = compare_k3(sp, w // 16, g_out8)
        errs.append(max(rep["max_abs_err_ch0_4"], rep["max_abs_err_final_t"]))
        log(dict(phase="k3_vs_k1_k2", scene=name, width=w, height=w,
                 tile_cull=cull, **rep, **CARD))
    return max(errs)


def k3_bound(sp, grid_x, out8, tile0=0):
    """K1's and K2's bounds with the row payload's bytes: a pair row is 64 B
    (its 44 B of fields lie in two 32-byte sectors of one row)."""
    fwd = k1_bound(sp, grid_x, tile0)
    bwd = k2_bound(sp, grid_x, out8, tile0)
    for b, pairs_read, pairs_written in ((fwd, fwd["pairs_read"], 0),
                                         (bwd, bwd["pairs_read"],
                                          int(sp.cnt.long().sum()))):
        extra = (K3_BYTES_PER_PAIR - K1_BYTES_PER_PAIR) * (pairs_read
                                                           + pairs_written)
        b["bytes"] += extra
        t_bytes = b["bytes"] / H100_BYTES_PER_S * 1e3
        t_ops = b["ops"] / H100_FP32_FLOPS * 1e3
        b.update(bound_ms=max(t_bytes, t_ops),
                 bound_by="bytes" if t_bytes >= t_ops else "operations")
    return fwd, bwd


K3_BYTES_PER_PAIR = 64  # one row: 11 fields and 5 zeros


def phase_k3_at_train_shape(device, captured, tr, k1, k2):
    """K3 at the train render's captured K1/K2 inputs, then one training
    step with payload_col=False (fused route on the row payload)."""
    import dataclasses

    import torch

    from eogs2_tpu_torch.ops.fused_raster import (SortedPairs, fused_blend_bwd,
                                                  fused_blend_bwd_rows,
                                                  fused_blend_fwd,
                                                  fused_blend_fwd_rows)

    pay, tstart, cnt, out8, g_out8, gx = captured
    sp = SortedPairs(pay, tstart, cnt, None)
    rep, rows = compare_k3(sp, gx, g_out8)
    fwd_b, bwd_b = k3_bound(sp, gx, out8)
    fwd = dict(ms=time_cuda(
        lambda: fused_blend_fwd_rows(rows, tstart, cnt, gx), 10),
        k1_ms_same_call=time_cuda(
            lambda: fused_blend_fwd(pay, tstart, cnt, gx), 10),
        plain_ms=k1["plain_ms"], **fwd_b)
    bwd = dict(ms=time_cuda(
        lambda: fused_blend_bwd_rows(rows, tstart, cnt, out8, g_out8, gx), 10),
        k2_ms_same_call=time_cuda(
            lambda: fused_blend_bwd(pay, tstart, cnt, out8, g_out8, gx), 10),
        plain_ms=k2["plain_ms"], **bwd_b)
    log(dict(phase="k3_at_train_shape", render="main", **rep, fwd=fwd,
             bwd=bwd, **CARD))
    del rows

    # the fused route on the row payload: one step launches K3, not K1/K2
    tr.set_raster_cfg(dataclasses.replace(tr.raster_cfg, payload_col=False))
    for f in (fused_blend_fwd, fused_blend_bwd, fused_blend_fwd_rows,
              fused_blend_bwd_rows):
        f.launches = 0
    metrics = tr.train_step(100)
    torch.cuda.synchronize()
    counts = dict(k1=fused_blend_fwd.launches, k2=fused_blend_bwd.launches,
                  k3_fwd=fused_blend_fwd_rows.launches,
                  k3_bwd=fused_blend_bwd_rows.launches)
    finite = bool(torch.isfinite(torch.stack(
        [m.double() for m in metrics.values()])).all())
    log(dict(phase="train_step_payload_rows", launches=counts,
             finite=finite, **CARD))
    if counts != dict(k1=0, k2=0, k3_fwd=3, k3_bwd=3) or not finite:
        raise AssertionError(f"payload_col=False step: {counts}, "
                             f"finite {finite}")
    return rep, fwd, bwd, counts


# ----------------------------------------------------------------------------
# K4: the tile-slot blend of the dense modes
# ----------------------------------------------------------------------------


def packed_tiles(device, t, k, seed, grid_x, prefix=False):
    """tests/test_blend_pallas.make_tiles's packed [T, 16, K] table: centres
    near their tile, random masks (prefix: each tile's first `count` slots,
    as the dense view fills them)."""
    import torch

    rng = np.random.RandomState(seed)
    origins = np.stack([(np.arange(t) % grid_x) * 16,
                        (np.arange(t) // grid_x) * 16], -1)
    mean2d = origins[:, None, :] + rng.uniform(-4, 20, (t, k, 2))
    conic = np.zeros((t, k, 3))
    conic[..., 0] = rng.uniform(0.05, 0.3, (t, k))
    conic[..., 2] = rng.uniform(0.05, 0.3, (t, k))
    conic[..., 1] = rng.uniform(-0.02, 0.02, (t, k))
    opac = rng.uniform(0.1, 0.9, (t, k))
    feat = rng.uniform(0, 1, (t, k, 5))
    mask = rng.rand(t, k) > 0.1
    if prefix:
        mask = np.arange(k)[None, :] < rng.randint(0, k + 1, (t, 1))
    rows = [mean2d[..., 0], mean2d[..., 1], conic[..., 0], conic[..., 1],
            conic[..., 2], opac] + [feat[..., i] for i in range(5)] + [mask]
    data = np.zeros((t, 16, k), np.float32)
    data[:, :12] = np.stack(rows, 1)
    return torch.tensor(data, device=device)


K4_ROW_TOL = 2e-4


def compare_k4_fwd(data, grid_x):
    """K4 forward against its plain version on the same table: channels 0-4
    within ATOL_CH, final_t within ATOL_T, n_contrib exact, channel 7 zero.
    Returns (report, out)."""
    import torch

    from eogs2_tpu_torch.ops.blend_cuda import (blend_forward,
                                                blend_forward_plain)

    out = blend_forward(data, grid_x)
    ref = blend_forward_plain(data, grid_x)
    torch.cuda.synchronize()
    rep = dict(tiles=int(data.shape[0]), k=int(data.shape[2]),
               max_abs_err_ch0_4=float((out[..., :5] - ref[..., :5])
                                       .abs().max()),
               max_abs_err_final_t=float((out[..., 5] - ref[..., 5])
                                         .abs().max()),
               n_contrib_mismatches=int((out[..., 6] != ref[..., 6]).sum()),
               saturated_pixel_share=float((out[..., 5] < 1e-2).float()
                                           .mean()))
    if not (rep["max_abs_err_ch0_4"] <= ATOL_CH
            and rep["max_abs_err_final_t"] <= ATOL_T
            and rep["n_contrib_mismatches"] == 0
            and bool((out[..., 7] == 0).all())
            and bool(torch.isfinite(out).all())):
        raise AssertionError(f"K4 forward disagrees with its plain version: "
                             f"{rep}")
    return rep, out


def compare_k4(data, grid_x, gout=None, seed=0):
    """K4 forward and backward against their plain versions on the same
    inputs; gout defaults to a seeded random cotangent with the forward's
    final_t and n_contrib. Also two backward launches, bitwise equal."""
    import torch

    from eogs2_tpu_torch.ops.blend_cuda import (blend_backward,
                                                blend_backward_plain,
                                                slots_in_use)

    rep, out = compare_k4_fwd(data, grid_x)
    if gout is None:
        gen = torch.Generator(device=data.device).manual_seed(seed)
        gout = torch.randn(out.shape, generator=gen, device=data.device)
        gout[..., 6:8] = out[..., 5:7]
    g = blend_backward(data, gout, grid_x)
    g2 = blend_backward(data, gout, grid_x)
    g_ref = blend_backward_plain(data, gout, grid_x)
    torch.cuda.synchronize()
    scale = g_ref[:, :11].abs().amax(dim=(0, 2))
    live = scale > 0
    err_rows = ((g[:, :11] - g_ref[:, :11]).abs().amax(dim=(0, 2))
                / scale.clamp_min(1e-30))
    # slots past each tile's walk (its deepest n_contrib, its last pair)
    n_walk = torch.minimum(gout[..., 7].amax(dim=1).long(),
                           slots_in_use(data))
    past = (torch.arange(data.shape[2], device=data.device)[None, :]
            >= n_walk[:, None])
    rep.update(bwd_max_row_rel_err=float(err_rows[live].max()),
               bwd_max_abs_err=float((g - g_ref).abs().max()),
               bwd_deterministic=bool(torch.equal(g, g2)),
               bwd_unreached_slots=int(past.sum()))
    ok = (rep["bwd_max_row_rel_err"] <= K4_ROW_TOL
          and rep["bwd_deterministic"]
          and bool((g[:, 11:] == 0).all()) and bool((g[:, :11][:, ~live] == 0)
                                                     .all())
          and bool((g.transpose(1, 2)[past] == 0).all())
          and bool(torch.isfinite(g).all()))
    if not ok:
        raise AssertionError(f"K4 disagrees with its plain version: {rep}")
    return rep, out, gout


def phase_k4_small(device):
    worst = {}
    cases = [(k, seed, False) for k in (256, 1024) for seed in (0, 1, 2)]
    cases += [(1024, 3, True)]  # masks that end early, as in a render
    cases += [(700, 4, True)]  # the backward's lowest batch partial
    for k, seed, prefix in cases:
        rep, _, _ = compare_k4(packed_tiles(device, 48, k, seed, 8, prefix),
                               8, seed=seed)
        log(dict(phase="k4_vs_plain", seed=seed, prefix_masks=prefix, **rep,
                 **CARD))
        for key, v in rep.items():
            if "err" in key:
                worst[key] = max(worst.get(key, 0.0), v)
    return worst


# K4 forward's FP32 operations (counted from csrc/blend_tiles_fwd.cu): per
# slot-pixel evaluation (a pixel inside the slot's alpha-cut ellipse, which
# needs the exp) dx, dy, the power quadratic (9), the power test, min, exp,
# op * G, the 0.99 clamp and the alpha test (17); per slot a tile walks,
# the cull that decides every pixel outside that ellipse at once
# (blend_common.cuh:slot_blocks): the mask test and the cut log(eps / op)
# - 1e-3 (4), det, -2 cut, the two half-widths (8), the centre's offset
# (2) and each of the 4 warp blocks' box test (4 compares, 16) = 30; per
# composite (kept, live) log1p, its add, exp, the T_EPS test, 1 - alpha,
# the division, alpha * T and a multiply-add for each of the 5 channels
# (17). exp and log1p count as one operation each: the SFU's rate is not
# in the bound.
K4F_OPS_PER_EVAL, K4_OPS_PER_CULL, K4F_OPS_PER_COMPOSITE = 17, 30, 17
# K4 backward's: per evaluation and per cull the same; per contribution
# 1 - alpha, exp(log final_t - s_after) (2), T (1), w (1), fdot (9),
# g_alpha (4), gG (2), the 11 gradients (34), the suffix and log sums (4:
# log1p counted once) and the 11 sums over the tile's pixels (11) = 69;
# per pixel log(final_t) and final_t g_ft (2)
K4B_OPS_PER_EVAL, K4B_OPS_PER_CONTRIB, K4B_OPS_PER_PIXEL = 17, 69, 2
K4_BYTES_READ_PER_SLOT = 48  # rows 0-11 of the packed table
K4_GRAD_BYTES_PER_SLOT = 44  # rows 0-10 of gdata, the ones with a gradient
K4_BYTES_PER_SLOT = 64  # a slot of the [T, 16, K] table


def k4_work(data, out, grid_x, chunk_elems=1 << 24):
    """What this data needs of K4, counted with the plain version's
    arithmetic. Forward: each pixel walks the slots up to and including the
    one at which it stops, or up to its tile's last pair; each tile reads
    its mask row and its slots up to its pixels' deepest walk, and culls
    each of them once. Backward: each pixel walks the slots below its
    n_contrib; contributions are the kept live slots; each tile reads and
    culls its slots below its deepest n_contrib (and its last pair). An
    evaluation is a walked slot of a pair whose power at the pixel passes
    the cheap test, power <= 0 and !(power < cut), cut = log(eps / op) -
    1e-3 (blend_common.cuh:alpha_cut): only there is the exp needed."""
    import torch

    from eogs2_tpu_torch.ops.blend import ALPHA_EPS
    from eogs2_tpu_torch.ops.blend_cuda import slot_fields, slots_in_use

    n_tiles, _, k = data.shape
    n_slots = slots_in_use(data)  # [T]
    n_contrib = out[..., 6].long()  # [T, P]
    walk_f = torch.minimum(n_contrib + 1, n_slots[:, None])
    walk_b = torch.minimum(n_contrib, n_slots[:, None])
    kmax = max(int(n_slots.max()), 1)
    tc = max(1, chunk_elems // (256 * kmax))
    w = dict(fwd_evals=0, contributions=0, bwd_evals=0)
    for t0 in range(0, n_tiles, tc):
        t1 = min(t0 + tc, n_tiles)
        k_len = int(n_slots[t0:t1].max())
        if k_len == 0:
            continue
        _, _, dx, dy, keep = slot_fields(data, grid_x, t0, t1, k_len)
        d = data[t0:t1, :, :k_len, None]
        power = (-0.5 * (d[:, 2] * dx * dx + d[:, 4] * dy * dy)
                 - d[:, 3] * dx * dy)
        del dx, dy
        cut = torch.log(ALPHA_EPS / d[:, 5]) - 1e-3
        tested = (d[:, 11] > 0.5) & (power <= 0.0) & ~(power < cut)
        del power
        kk = torch.arange(k_len, device=data.device)[None, :, None]
        walked = kk < walk_f[t0:t1, None, :]
        live = kk < walk_b[t0:t1, None, :]
        w["fwd_evals"] += int((walked & tested).sum())
        w["contributions"] += int((keep & live).sum())
        w["bwd_evals"] += int((live & tested).sum())
    w["fwd_slots_read"] = int(walk_f.amax(dim=1).sum())
    w["bwd_slots_read"] = int(walk_b.amax(dim=1).sum())
    w["mask_bytes"] = 4 * n_tiles * k
    return w


def k4_bounds(data, out, grid_x):
    """Least times the card needs for this K4 forward and backward: the
    larger of bytes over the HBM rate (forward: the mask rows, the table up
    to each tile's walk, out written; backward: the same reads, gout read,
    gdata's gradient rows 0-10 up to each tile's walk written) and FP32
    operations over the FP32 peak. The backward's zeros (rows 11-15, the
    slots past the walk) carry no gradient: their write is a cost of the
    [T, 16, K] interface, given apart as padded_table_write_ms."""
    w = k4_work(data, out, grid_x)
    n_tiles, _, k = data.shape
    maps = n_tiles * 256 * 8 * 4
    res = {}
    for name, bytes_, ops in (
            ("fwd", K4_BYTES_READ_PER_SLOT * w["fwd_slots_read"] + maps
             + w["mask_bytes"],
             K4F_OPS_PER_EVAL * w["fwd_evals"]
             + K4_OPS_PER_CULL * w["fwd_slots_read"]
             + K4F_OPS_PER_COMPOSITE * w["contributions"]),
            ("bwd", (K4_BYTES_READ_PER_SLOT + K4_GRAD_BYTES_PER_SLOT)
             * w["bwd_slots_read"] + maps + w["mask_bytes"],
             K4B_OPS_PER_EVAL * w["bwd_evals"]
             + K4_OPS_PER_CULL * w["bwd_slots_read"]
             + K4B_OPS_PER_CONTRIB * w["contributions"]
             + K4B_OPS_PER_PIXEL * n_tiles * 256)):
        t_bytes = bytes_ / H100_BYTES_PER_S * 1e3
        t_ops = ops / H100_FP32_FLOPS * 1e3
        res[name] = dict(bound_ms=max(t_bytes, t_ops),
                         bound_by="bytes" if t_bytes >= t_ops
                         else "operations", bytes=bytes_, ops=ops)
    res["bwd"]["padded_table_write_ms"] = (
        (K4_BYTES_PER_SLOT * n_tiles * k
         - K4_GRAD_BYTES_PER_SLOT * w["bwd_slots_read"])
        / H100_BYTES_PER_S * 1e3)
    return res, w


class capture_k4_calls:
    """Within the block, record what every K4 blend of the dense routes
    receives: each forward's (packed table, grid_x) and each backward's
    (table, gout, grid_x). rasterize reads BlendTilesPallas from its module, so the block
    swaps in a subclass that records and then runs the original (the
    kernels launch and count as usual)."""

    def __enter__(self):
        from eogs2_tpu_torch import rasterizer
        from eogs2_tpu_torch.ops.blend_cuda import backward_gout

        self.mod, orig = rasterizer, rasterizer.BlendTilesPallas
        self.fwd, self.bwd = [], []
        cap = self

        class Recording(orig):
            @staticmethod
            def forward(ctx, data, bg, grid_x):
                cap.fwd.append((data.detach(), grid_x))
                return orig.forward(ctx, data, bg, grid_x)

            @staticmethod
            def backward(ctx, g_img, g_ft):
                data, bg, final_t, n_contrib = ctx.saved_tensors
                cap.bwd.append((data.detach(), backward_gout(
                    g_img, g_ft, bg, final_t, n_contrib), ctx.grid_x))
                return orig.backward(ctx, g_img, g_ft)

        self.orig, rasterizer.BlendTilesPallas = orig, Recording
        return self

    def __exit__(self, *exc):
        self.mod.BlendTilesPallas = self.orig


class record_renders:
    """Within the block, every rasterize call made through the named
    modules (default: the training step's) records its demand statistics
    (max_tile_count, max_tiles_per_gaussian_seen) as device tensors, read
    after the block."""

    def __init__(self, *module_names):
        self.names = module_names or ("train",)

    def __enter__(self):
        import importlib

        import torch

        self.mods = [importlib.import_module(f"eogs2_tpu_torch.{n}")
                     for n in self.names]
        self.origs = [m.rasterize for m in self.mods]
        self.stats = []

        def recording(orig):
            def rasterize(*args, **kw):
                out = orig(*args, **kw)
                self.stats.append(torch.stack(
                    [out.max_tile_count.long(),
                     out.max_tiles_per_gaussian_seen.long()]))
                return out
            return rasterize

        for m, orig in zip(self.mods, self.origs):
            m.rasterize = recording(orig)
        return self

    def __exit__(self, *exc):
        for m, orig in zip(self.mods, self.origs):
            m.rasterize = orig

    def maxima(self):
        """(densest tile, widest Gaussian) over the recorded renders."""
        import torch

        m = torch.stack(self.stats).amax(dim=0).tolist()
        return int(m[0]), int(m[1])


def fast_trainer(scene, device, iterations):
    """A Trainer on the CLI's fast route (sorted binning, K4), sized by
    the JAX Trainer's rule: one untimed step (iteration 1) with no emission
    clamp and a small K, whose renders' demand statistics count before the
    K clamp, then RasterizeConfig.bucketed of that demand. Returns
    (trainer, config, demand, the leaves before the sizing step)."""
    from eogs2_tpu_torch.rasterizer import RasterizeConfig
    from eogs2_tpu_torch.train import Trainer

    size_cfg = RasterizeConfig(binning_mode="sorted", use_pallas=True,
                               tile_capacity=128,
                               max_tiles_per_gaussian=1 << 20)
    tr = Trainer(train_recipe(iterations), scene, size_cfg,
                 device=device).setup()
    start = {f: getattr(tr.model, f).detach().clone() for f in FIELDS}
    with record_renders() as rec:
        tr.train_step(1)
    demand = rec.maxima()
    rcfg = size_cfg.bucketed(*demand)
    tr.set_raster_cfg(rcfg)
    return tr, rcfg, demand, start


def phase_train_fast(device, scene, width=1024, warmup=2, timed=10):
    """The CLI's fast route (sorted binning, K4) in training."""
    import torch

    from eogs2_tpu_torch.ops.blend_cuda import (blend_backward,
                                                blend_backward_plain,
                                                blend_forward,
                                                blend_forward_plain)
    from eogs2_tpu_torch.ops.fused_raster import (fused_blend_bwd,
                                                  fused_blend_bwd_rows,
                                                  fused_blend_fwd,
                                                  fused_blend_fwd_rows)
    from eogs2_tpu_torch.train import mean_metrics

    t0 = time.perf_counter()
    tr, rcfg, demand, start = fast_trainer(scene, device,
                                           warmup + timed + 1)
    k, tcap = rcfg.tile_capacity, rcfg.max_tiles_per_gaussian
    for it in range(2, warmup + 2):
        tr.train_step(it)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    kernels = (blend_forward, blend_backward, fused_blend_fwd,
               fused_blend_bwd, fused_blend_fwd_rows, fused_blend_bwd_rows)
    torch.cuda.reset_peak_memory_stats()
    for f in kernels:
        f.launches = 0
    steps, step_ms = [], []
    with record_renders() as rec:
        for it in range(warmup + 2, warmup + timed + 2):
            t = time.perf_counter()
            steps.append(tr.train_step(it))
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t) * 1e3)
    launches = [f.launches for f in kernels]
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    if launches != [3 * timed, 3 * timed, 0, 0, 0, 0]:
        raise AssertionError(f"launches over {timed} fast steps (K4 fwd, K4 "
                             f"bwd, K1, K2, K3 fwd, K3 bwd): {launches}")
    seen = rec.maxima()
    if not (seen[0] < k and seen[1] <= tcap) or len(rec.stats) != 3 * timed:
        raise AssertionError(f"a render clipped: densest tile {seen[0]} vs "
                             f"K {k}, widest Gaussian {seen[1]} vs {tcap}")
    metrics = mean_metrics(steps)
    every = torch.stack([torch.stack([m[key].double() for key in m])
                         for m in steps])
    if not bool(torch.isfinite(every).all()):
        raise AssertionError(f"non-finite metrics: {metrics}")
    moved = {f: float((getattr(tr.model, f).detach() - x).abs().max())
             for f, x in start.items()}
    if min(moved.values()) <= 0:
        raise AssertionError(f"parameters did not move: {moved}")
    log(dict(phase="train_fast", init_gaussians=len(scene.init_xyz),
             width=width, recipe="baseogs, sun and random camera from "
             "iteration 1", config=f"sorted, use_pallas, tile_capacity {k}, "
             f"max_tiles_per_gaussian {tcap}",
             sizing_step_demand=dict(max_tile=demand[0],
                                     max_tiles_per_gaussian=demand[1]),
             timed_renders_max=dict(max_tile=seen[0],
                                    max_tiles_per_gaussian=seen[1]),
             ms_per_step=statistics.median(step_ms), step_ms=step_ms,
             k4_fwd_launches_per_step=launches[0] / timed,
             k4_bwd_launches_per_step=launches[1] / timed,
             peak_mem_gib=peak_gib, setup_s=setup_s,
             max_param_change=moved, metrics=metrics, **CARD))

    log(dict(phase="train_fast_profile",
             **profile_run(lambda: tr.train_step(warmup + timed + 2)),
             **CARD))

    # K4 at each render's exact inputs of one step (main, sun, random)
    with capture_k4_calls() as cap:
        tr.train_step(warmup + timed + 3)
        torch.cuda.synchronize()
    bwd_of = {c[0].data_ptr(): c for c in cap.bwd}
    calls = [bwd_of[d.data_ptr()] for d, _ in cap.fwd]  # in render order
    del cap, bwd_of
    resample_ab(tr, warmup + timed + 2, "fast")
    del tr
    if len(calls) != 3:
        raise AssertionError(f"captured {len(calls)} K4 renders, want 3")
    reps, fwd_at, bwd_at = {}, {}, {}
    for name in TRAIN_RENDERS:
        data, gout, gx = calls.pop(0)  # drop each table once it is done
        rep, out, _ = compare_k4(data, gx, gout=gout)
        bounds, work = k4_bounds(data, out, gx)
        fwd = dict(ms=time_cuda(lambda: blend_forward(data, gx), 10),
                   plain_ms=time_cuda(lambda: blend_forward_plain(data, gx),
                                      1),
                   **bounds["fwd"])
        bwd = dict(ms=time_cuda(lambda: blend_backward(data, gout, gx), 10),
                   plain_ms=time_cuda(
                       lambda: blend_backward_plain(data, gout, gx), 1),
                   **bounds["bwd"])
        log(dict(phase="k4_at_train_shape", render=name, width=16 * gx,
                 height=data.shape[0] // gx * 16,
                 pairs=int(data[:, 11].sum()), **rep, work=work, fwd=fwd,
                 bwd=bwd, **CARD))
        reps[name], fwd_at[name], bwd_at[name] = rep, fwd, bwd
        del data, gout, out
    log(dict(phase="k4_per_step", renders=list(TRAIN_RENDERS),
             **{f"{k}_{key}": sum(r[key] for r in at.values())
                for k, at in (("k4_fwd", fwd_at), ("k4_bwd", bwd_at))
                for key in ("ms", "bound_ms", "plain_ms")},
             k4_bwd_padded_table_write_ms=sum(
                 r["padded_table_write_ms"] for r in bwd_at.values()),
             **CARD))
    return reps, fwd_at, bwd_at, launches[0], launches[1]


class time_dsm_parts:
    """Within the block, the wall seconds of evaluate_dsm_mae's parts: the
    Nadir render (pipeline.render_view_full, which ends in the outputs'
    copy to the host), the host flatten (pipeline.compute_dsm_from_view)
    and the crop, registration and MAE (MaeComputer.compute_mae)."""

    def __enter__(self):
        from eogs2_tpu_torch import pipeline
        from eogs2_tpu_torch.eval.mae import MaeComputer

        self.seconds = {}
        self.saved = [(pipeline, "render_view_full", "nadir_render_s"),
                      (pipeline, "compute_dsm_from_view", "flatten_s"),
                      (MaeComputer, "compute_mae", "registration_mae_s")]
        for owner, attr, key in self.saved:
            setattr(owner, attr, self._timed(getattr(owner, attr), key))
        return self

    def _timed(self, fn, key):
        def timed(*a, **kw):
            t = time.perf_counter()
            out = fn(*a, **kw)
            self.seconds[key] = (self.seconds.get(key, 0.0)
                                 + time.perf_counter() - t)
            return out
        timed.orig = fn
        return timed

    def __exit__(self, *exc):
        for owner, attr, _ in self.saved:
            setattr(owner, attr, getattr(owner, attr).orig)


def recipe_config(iterations):
    """learnwv with the sun and random camera on from iteration 1, clone/
    split densification every 5 iterations from 4, the opacity reset every
    10, the DSM hook every 10, early stopping with patience for every
    step, and training_report at the last step."""
    from eogs2_tpu_torch.config import learnwv

    cfg = learnwv(iterations=iterations)
    o = cfg.optimization
    o.iterstart_shadowmapping = 0
    o.iterstart_L_new_resample = 0
    o.only_prune = False
    o.densification.densify_from_iter = 4
    o.densification.densification_interval = 5
    o.opacity_reset_interval = 10
    o.early_stopping.use_early_stopping = True
    o.early_stopping.patience = iterations
    cfg.logging.tb_log_interval = 5
    cfg.logging.testing_interval = 10
    cfg.logging.big_testing_iterations = [iterations]
    return cfg


def phase_recipe(device, scene, heightfield, iterations=30):
    """The rest of the single-modality recipe at full width: learnwv on
    the fused route with tile_cull on the train-1M-1024 scene, the opacity
    calibrated first (12 Nadir-less renders of view 0), then `iterations`
    iterations through Trainer.train with clone/split densification, the
    opacity reset, early stopping, the Nadir DSM's MAE as the eval hook and
    training_report at the end. Returns the K1 and K2 launches of the run
    (calibration included)."""
    import tempfile

    import torch

    from eogs2_tpu_torch.eval.mae import MaeComputer
    from eogs2_tpu_torch.ops.fused_raster import (fused_blend_bwd,
                                                  fused_blend_fwd)
    from eogs2_tpu_torch.pipeline import evaluate_dsm_mae
    from eogs2_tpu_torch.rasterizer import RasterizeConfig
    from eogs2_tpu_torch.train import Trainer

    cfg = recipe_config(iterations)
    o = cfg.optimization
    rcfg = RasterizeConfig(binning_mode="fused", tile_cull=True)
    tr = Trainer(cfg, scene, rcfg, device=device).setup()
    capacity = int(tr.model.xyz.shape[0])
    with tempfile.TemporaryDirectory() as gt_dir:
        np.save(os.path.join(gt_dir, "gt_heightfield.npy"), heightfield)
        mc = MaeComputer.from_synthetic(gt_dir, scale=scene.scene_scale)
    tr.mae_computer = mc

    fused_blend_fwd.launches = 0
    fused_blend_bwd.launches = 0
    t = time.perf_counter()
    opacity = tr.calibrate_opacity_init()
    calib_s = time.perf_counter() - t
    calib = (fused_blend_fwd.launches, fused_blend_bwd.launches)
    if calib != (12, 0):
        raise AssertionError(f"calibration launched K1, K2 {calib}, want "
                             f"12, 0")

    hooks = []

    def hook(trainer, model, iteration):
        with time_dsm_parts() as parts:
            t = time.perf_counter()
            mae = evaluate_dsm_mae(model, trainer.scene, mc,
                                   trainer.raster_cfg)[0]
            wall = time.perf_counter() - t
        hooks.append(dict(iteration=iteration, mae=mae, wall_s=wall,
                          **parts.seconds))
        if not np.isfinite(mae):
            raise AssertionError(f"MAE at iteration {iteration}: {mae}")

    steps, step_ms, resets = {}, {}, []
    train_step = tr.train_step

    def timed_step(iteration):
        torch.cuda.synchronize()
        t = time.perf_counter()
        m = train_step(iteration)
        torch.cuda.synchronize()
        step_ms[iteration] = (time.perf_counter() - t) * 1e3
        steps[iteration] = m
        if iteration % o.opacity_reset_interval == 0:  # just reset
            st = tr.gauss_opt.state[tr.model.opacity]
            nz = int((st["exp_avg"] != 0).sum() + (st["exp_avg_sq"] != 0).sum())
            resets.append(dict(iteration=iteration, nonzero_moments=nz))
            if nz:
                raise AssertionError(f"{nz} opacity moments nonzero after "
                                     f"the reset at {iteration}")
        return m

    report = {}
    training_report = tr.training_report

    def timed_report(iteration, **kw):
        t = time.perf_counter()
        report.update(training_report(iteration, **kw))
        report["wall_s"] = time.perf_counter() - t
        return report

    tr.train_step, tr.training_report, tr.eval_hook = (timed_step,
                                                       timed_report, hook)
    fused_blend_fwd.launches = 0
    fused_blend_bwd.launches = 0
    t = time.perf_counter()
    tr.train(progress=False)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t
    k1, k2 = fused_blend_fwd.launches, fused_blend_bwd.launches

    ran = sorted(steps)
    if ran != list(range(1, iterations + 1)):
        raise AssertionError(f"iterations run: {ran}")
    if k2 != 3 * iterations or k1 < 3 * iterations + len(hooks):
        raise AssertionError(f"K1 {k1}, K2 {k2} launches over "
                             f"{iterations} iterations")
    every = torch.stack([torch.stack([m[k].double() for k in m])
                         for m in steps.values()])
    if not bool(torch.isfinite(every).all()):
        raise AssertionError("non-finite step metrics")
    if any(int(m["clipped_pairs"]) for m in steps.values()):
        raise AssertionError("a render clipped")
    for ev in tr.densify_log:
        if ev["selected"] and ev["alive_before"] < capacity and not (
                ev["cloned"] + ev["split"] > 0 and ev["alive_densified"]
                == ev["alive_before"] + ev["cloned"] + ev["split"]):
            raise AssertionError(f"alive did not grow: {ev}")
    if (len(hooks) != iterations // cfg.logging.testing_interval
            or len(resets) != iterations // o.opacity_reset_interval
            or not tr.densify_log or "report/MAE" not in report
            or not all(np.isfinite(v) for v in report.values())):
        raise AssertionError(f"hooks {hooks}, resets {resets}, densify "
                             f"{tr.densify_log}, report {report}")
    first = tr.densify_log[0]["iteration"]  # densified after its step
    before = [step_ms[i] for i in range(2, first)]
    after = [step_ms[i] for i in range(tr.densify_log[-1]["iteration"] + 1,
                                       iterations + 1)]
    log(dict(phase="recipe", recipe="learnwv; sun and random camera from "
             "iteration 1; clone/split every 5 from 4; opacity reset every "
             "10; DSM MAE hook every 10; early stopping; training_report "
             f"at {iterations}", config="fused, tile_cull, eogs_features",
             init_gaussians=len(scene.init_xyz), capacity=capacity,
             width=int(scene.train_views[0].camera.width),
             calibrated_opacity=opacity, calibration_s=calib_s,
             calibration_k1_launches=calib[0], train_s=train_s,
             k1_launches=k1, k2_launches=k2,
             densify_events=tr.densify_log, opacity_resets=resets,
             main_render_pairs={i: int(steps[i]["num_pairs"])
                                for i in (1, first, first + 1,
                                          iterations)},
             step_ms_before_densify=before,
             step_ms_median_before_densify=statistics.median(before),
             step_ms_after_densify=after,
             step_ms_median_after_densify=statistics.median(after),
             densify_step_ms={e["iteration"]: step_ms[e["iteration"]]
                              for e in tr.densify_log},
             dsm_hooks=hooks, report=report,
             early_stopping_iterations=[m["iteration"]
                                        for m in tr.metrics_history],
             **CARD))
    return k1 + calib[0], k2


CLI_ARTIFACTS = ("altitude", "acc_opacity", "final", "raw_render", "cc", "gt",
                 "nadir_pov", "nadirpovsampled", "nadiraltitudesampled",
                 "nadir_altitude_diff", "flowmatched_altitude",
                 "flow_matched_image", "gt_flowmatch")  # tests/test_cli.py


class StageRunner:
    """Runs a command-line main (`main(argv)`, by default the one given)
    as a named stage: its stdout captured into `printed[stage]` and echoed
    to stderr, its wall seconds, ending in a synchronize, in
    `stages[stage]`; a return code other than 0 raises."""

    def __init__(self, device, main):
        self.device, self.main = device, main
        self.stages, self.printed = {}, {}

    def __call__(self, stage, argv, main=None):
        import contextlib
        import io

        import torch

        buf = io.StringIO()
        t = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = (main or self.main)(argv)
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        self.stages[stage] = time.perf_counter() - t
        self.printed[stage] = buf.getvalue()
        print(buf.getvalue(), end="", file=sys.stderr, flush=True)
        print(f"{stage}: {self.stages[stage]:.1f} s", file=sys.stderr,
              flush=True)
        if rc != 0:
            raise AssertionError(f"{stage} ({argv[0]}) returned {rc}")
        gc.collect()


class image_libraries_blocked:
    """Within the block imageio and Pillow are unimportable: the card's
    installation has Pillow (its TensorBoard's image encoder) and no
    imageio, and a phase run so shows that the port reads and writes its
    files without them. `loaded()` lists those of them in sys.modules."""

    NAMES = ("imageio", "imageio.v2", "PIL", "PIL.Image")

    def __enter__(self):
        self.saved = {m: sys.modules.get(m) for m in self.NAMES}
        sys.modules.update(dict.fromkeys(self.NAMES))
        return self

    @staticmethod
    def loaded():
        return sorted(m for m in sys.modules if m.split(".")[0] in
                      ("imageio", "PIL") and sys.modules[m] is not None)

    def __exit__(self, *exc):
        for m, mod in self.saved.items():
            if mod is None:
                del sys.modules[m]
            else:
                sys.modules[m] = mod


def phase_cli(device, scene, width=1024, scale=142.0, n_views=7, hf_res=768,
              n_buildings=24, iterations=100, resume_iterations=10,
              frames=8, tile_capacity=16384, max_tiles_per_gaussian=1024,
              vox_size=0.5, gate_vox_size=4.0):
    """The CLI end to end through cli.main, on the card, in a temporary
    directory: make-synthetic of train-1M-1024's scene (checked against
    `scene`, the same scene built in memory), train (baseogs on the fused
    route, a model save and a checkpoint every iterations/2, the MAE hook
    and training_report at the end), the checkpoint restored into a fresh
    Trainer (bit-equal), a resumed run from the first checkpoint, render
    (the gather route with the plain blend, tile_capacity above every
    render's densest tile), eval-dsm of its Nadir DSM, tsdf --export-mesh
    of the render's altitude maps at vox_size (its seconds by part, voxels,
    slabs, peak memory, the mesh) and eval-dsm of the TSDF DSM, the TSDF
    checks (tsdf_checks) on the same altitude maps, and the video's frames.
    Neither imageio nor Pillow may be imported (both are blocked in
    sys.modules for the phase). Returns the K1 and K2 launches of the
    run."""
    with image_libraries_blocked():
        return _phase_cli(device, scene, width, scale, n_views, hf_res,
                          n_buildings, iterations, resume_iterations, frames,
                          tile_capacity, max_tiles_per_gaussian, vox_size,
                          gate_vox_size)


def _phase_cli(device, scene, width, scale, n_views, hf_res, n_buildings,
               iterations, resume_iterations, frames, tile_capacity,
               max_tiles_per_gaussian, vox_size, gate_vox_size):
    import tempfile

    import torch

    from eogs2_tpu_torch import cli
    from eogs2_tpu_torch import train as train_mod
    from eogs2_tpu_torch.config import baseogs
    from eogs2_tpu_torch.io.geotiff import read_geotiff
    from eogs2_tpu_torch.io.ply import load_gaussians_ply
    from eogs2_tpu_torch.ops.fused_raster import (fused_blend_bwd,
                                                  fused_blend_fwd)
    from eogs2_tpu_torch.pipeline import nadir_dsm
    from eogs2_tpu_torch.rasterizer import RasterizeConfig
    from eogs2_tpu_torch.render_artifacts import load_model
    from eogs2_tpu_torch.scene import load_scene
    from eogs2_tpu_torch.train import Trainer

    dev = ["--device", str(device)]
    run = StageRunner(device, cli.main)
    stages, printed = run.stages, run.printed
    save_s = []
    save_model = train_mod.Trainer.save_model

    def timed_save(self, *a, **kw):
        t = time.perf_counter()
        it = save_model(self, *a, **kw)
        save_s.append(time.perf_counter() - t)
        return it

    with tempfile.TemporaryDirectory() as tmp:
        sdir, runp, run2 = (os.path.join(tmp, n) for n in ("scene", "run",
                                                          "run2"))
        fused_blend_fwd.launches = 0
        fused_blend_bwd.launches = 0
        run("make_synthetic", ["make-synthetic", *dev, "--out", sdir,
                               "--n-views", str(n_views), "--width",
                               str(width), "--height", str(width),
                               "--hf-res", str(hf_res), "--n-buildings",
                               str(n_buildings), "--scale", str(scale),
                               "--seed", "11"])
        loaded = load_scene(sdir, images_msi_path=os.path.join(sdir, "images"),
                            load_pan=False, device=device)
        pairs = list(zip(loaded.train_views + loaded.test_views,
                         scene.train_views + scene.test_views))
        if not (np.array_equal(loaded.init_xyz, scene.init_xyz)
                and len(pairs) == len(scene.train_views + scene.test_views)
                and all(a.name == b.name and (a.image is None) == (
                    b.image is None) and (a.image is None or np.array_equal(
                        a.image, b.image)) for a, b in pairs)):
            raise AssertionError("the written scene does not load back as "
                                 "the scene in memory")

        half = iterations // 2
        train_mod.Trainer.save_model = timed_save
        try:
            run("train", ["train", *dev, "--scene-dir", sdir, "--model-path",
                          runp, "--preset", "baseogs", "--raster-mode",
                          "fused", "--iterations", str(iterations),
                          "--checkpoint-every", str(half),
                          "--save-iterations", str(half),
                          "--eval-during-training",
                          "--big-testing-iterations", str(iterations)])
        finally:
            train_mod.Trainer.save_model = save_model
        train_k = (fused_blend_fwd.launches, fused_blend_bwd.launches)
        for rel in (f"point_cloud/iteration_{half}", "point_cloud/iteration_"
                    f"{iterations}", f"chkpnt{half}", f"chkpnt{iterations}",
                    f"camera_params/iteration_{iterations}/shading_test",
                    f"optimizer/iteration_{iterations}/adam",
                    "metrics.jsonl", "metrics.json", "cfg_args.json",
                    "images"):
            if not os.path.exists(os.path.join(runp, rel)):
                raise AssertionError(f"train wrote no {rel}")
        hook = re.findall(rf"\[{iterations}\] DSM MAE (\S+) m",
                          printed["train"])
        if len(hook) != 1 or not np.isfinite(float(hook[0])):
            raise AssertionError(f"no finite MAE hook line at {iterations}")
        hook_mae = float(hook[0])
        ckpt = os.path.join(runp, f"chkpnt{iterations}")

        # the last checkpoint into a fresh Trainer, built as the CLI builds
        # it (the CLI's default seed 1337 for the init cloud)
        t = time.perf_counter()
        saved = torch.load(ckpt, map_location="cpu", weights_only=True)
        fresh = Trainer(baseogs(sdir), load_scene(
            sdir, images_msi_path=os.path.join(sdir, "images"),
            load_pan=False, seed=1337, device=device),
            RasterizeConfig(binning_mode="fused"), device=device).setup()
        if fresh.restore(ckpt) != iterations or fresh.step != iterations:
            raise AssertionError("restore returned another iteration")
        mismatched = []
        for group, names in (("params", FIELDS + ("features_rest",)),
                             ("aux", ("alive", "max_radii2d",
                                      "xyz_gradient_accum", "denom"))):
            for f in names:
                if not torch.equal(getattr(fresh.model, f).detach().cpu(),
                                   saved[group][f]):
                    mismatched.append(f"{group}.{f}")
        for f, v in saved["shading"].items():
            if not torch.equal(getattr(fresh.shading, f).detach().cpu(), v):
                mismatched.append(f"shading.{f}")
        moments = 0
        for key, opt, leaves in (
                ("g_opt", fresh.gauss_opt, {f: getattr(fresh.model, f)
                                            for f in saved["g_opt"]["mu"]}),
                ("c_opt", fresh.cam_opt, {f: getattr(fresh.shading, f)
                                          for f in saved["c_opt"]["mu"]})):
            for f, p in leaves.items():
                st = opt.state[p]
                moments += 2
                if (int(st["step"]) != iterations or not torch.equal(
                        st["exp_avg"].cpu(), saved[key]["mu"][f])
                        or not torch.equal(st["exp_avg_sq"].cpu(),
                                           saved[key]["nu"][f])):
                    mismatched.append(f"{key}.{f}")
        restore_s = time.perf_counter() - t
        alive = saved["aux"]["alive"].numpy()
        del fresh
        gc.collect()
        if mismatched:
            raise AssertionError(f"restored state differs: {mismatched}")

        run("resume", ["train", *dev, "--scene-dir", sdir, "--model-path",
                       run2, "--preset", "baseogs", "--raster-mode", "fused",
                       "--iterations", str(resume_iterations),
                       "--start-checkpoint",
                       os.path.join(runp, f"chkpnt{half}")])
        if not os.path.exists(os.path.join(
                run2, "point_cloud", f"iteration_{half + resume_iterations}")):
            raise AssertionError("the resumed run saved no model at its step")
        k1, k2 = fused_blend_fwd.launches, fused_blend_bwd.launches

        rargs = ["--scene-dir", sdir, "--model-path", runp,
                 "--tile-capacity", str(tile_capacity),
                 "--max-tiles-per-gaussian", str(max_tiles_per_gaussian)]
        with record_renders("pipeline", "renderer") as demand:
            run("render", ["render", *dev, *rargs])
        renders = len(demand.stats)
        densest, widest = demand.maxima()
        rcfg = RasterizeConfig(tile_capacity=tile_capacity, tile_chunk=64,
                               max_tiles_per_gaussian=max_tiles_per_gaussian)
        if densest >= tile_capacity or widest > max_tiles_per_gaussian:
            raise AssertionError(f"a render clipped: densest tile {densest} "
                                 f"(K {tile_capacity}), widest Gaussian "
                                 f"{widest} tiles")
        base = os.path.join(runp, "train_opNone", f"ours_{iterations}")
        n_train = len(loaded.train_views)
        empty = [k for k in CLI_ARTIFACTS
                 if len(os.listdir(os.path.join(base, k))) != n_train]
        if empty:
            raise AssertionError(f"artifact kinds without every train view: "
                                 f"{empty}")
        nadir_tif = os.path.join(runp, "test_opNone", f"ours_{iterations}",
                                 "dsm", "Nadir.tif")
        written, _ = read_geotiff(nadir_tif)
        model, it = load_model(runp, device=device)
        _, dsm, _ = nadir_dsm(model, loaded, rcfg)
        nadir_equal = bool(np.array_equal(written, dsm[:, :, 0].astype(
            np.float32), equal_nan=True))
        ply = load_gaussians_ply(os.path.join(
            runp, "point_cloud", f"iteration_{iterations}",
            "point_cloud.ply"))
        ply_equal = all(np.array_equal(
            ply[f].reshape(int(alive.sum()), -1),
            saved["params"][f].numpy()[alive].reshape(int(alive.sum()), -1))
            for f in FIELDS)
        del model, saved
        gc.collect()
        if it != iterations or not nadir_equal or not ply_equal:
            raise AssertionError(f"render: iteration {it}, Nadir.tif equal "
                                 f"{nadir_equal}, PLY rows equal {ply_equal}")

        run("eval_dsm", ["eval-dsm", *dev, "--pred", nadir_tif,
                         "--gt-heightfield",
                         os.path.join(sdir, "gt_heightfield.npy"),
                         "--scale", str(scale)])
        eval_mae = json.loads(printed["eval_dsm"].strip().splitlines()[-1])[
            "mae"]
        if not (np.isfinite(eval_mae) and abs(eval_mae - hook_mae) <= 0.05):
            raise AssertionError(f"eval-dsm MAE {eval_mae}, hook's "
                                 f"{hook_mae}")

        # TSDF fusion of the render's train altitude maps, then its DSM's MAE
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        with time_tsdf_parts(device) as tsdf_parts:
            run("tsdf", ["tsdf", *dev, "--scene-dir", sdir, "--model-path",
                         runp, "--vox-size", str(vox_size),
                         "--export-mesh"])
        tsdf_peak = (torch.cuda.max_memory_allocated()
                     if device.type == "cuda" else None)
        tsdf_dir = os.path.join(runp, "test_opNone", f"ours_{iterations}",
                                "tsdf")
        run("eval_dsm_tsdf", ["eval-dsm", *dev, "--pred",
                              os.path.join(tsdf_dir, "dsm.tif"),
                              "--gt-heightfield",
                              os.path.join(sdir, "gt_heightfield.npy"),
                              "--scale", str(scale)])
        tsdf_mae = json.loads(printed["eval_dsm_tsdf"].strip().splitlines()[
            -1])["mae"]
        tsdf_dsm, _ = read_geotiff(os.path.join(tsdf_dir, "dsm.tif"))
        if not (np.isfinite(tsdf_mae) and np.isfinite(tsdf_dsm).mean() > 0.5
                and tsdf_parts.faces > 0 and os.path.getsize(os.path.join(
                    tsdf_dir, "output_mesh.obj")) > 0):
            raise AssertionError(f"tsdf: MAE {tsdf_mae}, finite share "
                                 f"{np.isfinite(tsdf_dsm).mean()}, faces "
                                 f"{tsdf_parts.faces}")
        tsdf_log = dict(stage_s=stages["tsdf"], parts_s=tsdf_parts.parts(
            stages["tsdf"]), voxels=tsdf_parts.voxels, shape=tsdf_parts.shape,
            slabs=tsdf_parts.slabs, max_memory_allocated=tsdf_peak,
            mesh_vertices=tsdf_parts.vertices, mesh_faces=tsdf_parts.faces,
            weight_max=tsdf_parts.weight_max, tsdf_dsm_mae=tsdf_mae,
            nadir_dsm_mae=eval_mae)
        del tsdf_dsm
        gc.collect()
        checks = tsdf_checks(device, loaded, os.path.join(base, "altitude"),
                             sdir, scale, vox_size, gate_vox_size, tmp)

        with record_renders("pipeline", "renderer") as vdemand:
            run("video", ["video", *dev, *rargs, "--n-frames", str(frames)])
        vdensest, vwidest = vdemand.maxima()
        frame_dir = os.path.join(runp, "video", "orbit_frames")
        if sorted(os.listdir(frame_dir)) != [f"frame_{i:04d}.png"
                                             for i in range(frames)]:
            raise AssertionError("video frames missing")
        ckpt_bytes = os.path.getsize(ckpt)
        ply_bytes = os.path.getsize(os.path.join(
            runp, "point_cloud", f"iteration_{iterations}", "point_cloud.ply"))

    libs = image_libraries_blocked.loaded()
    if libs:
        raise AssertionError(f"the CLI imported {libs}")
    if k2 != iterations + resume_iterations or k1 <= k2:
        raise AssertionError(f"K1 {k1}, K2 {k2} launches over "
                             f"{iterations} + {resume_iterations} iterations")
    rendered = sum(1 for v in loaded.train_views + loaded.test_views
                   if not v.is_virtual)
    log(dict(phase="cli", config="train-1M-1024's scene through cli.main: "
             f"make-synthetic; train baseogs --raster-mode fused, "
             f"{iterations} iterations, model save and checkpoint every "
             f"{half}, the MAE hook and training_report at {iterations}; "
             f"restore; resume {resume_iterations} from chkpnt{half}; "
             f"render (gather, plain blend, K {tile_capacity}, "
             f"max_tiles_per_gaussian {max_tiles_per_gaussian}); eval-dsm; "
             f"video {frames} frames",
             init_gaussians=len(loaded.init_xyz), width=width,
             stage_s=stages, save_model_s=save_s, restore_check_s=restore_s,
             checkpoint_bytes=ckpt_bytes, ply_bytes=ply_bytes,
             restored_moments=moments, render_views=rendered,
             render_s_per_view=stages["render"] / rendered,
             render_calls=renders, max_tile_count=densest,
             max_tiles_per_gaussian_seen=widest,
             video_max_tile_count=vdensest,
             video_max_tiles_per_gaussian_seen=vwidest,
             hook_mae=hook_mae, eval_dsm_mae=eval_mae,
             train_k1_k2=train_k, k1_launches=k1, k2_launches=k2,
             nadir_tif_equal=nadir_equal, ply_rows_equal=ply_equal,
             **CARD))
    log(dict(phase="cli_tsdf", config=f"tsdf --export-mesh at {vox_size} m "
             f"voxels of the render's {n_train} train altitude maps at "
             f"{width}^2 (the 1M-Gaussian model of phase cli), then "
             "eval-dsm of its DSM", **tsdf_log, **CARD))
    log(dict(phase="tsdf_checks", **checks, **CARD))
    return k1, k2


class time_tsdf_parts:
    """Within the block, the wall seconds of run_tsdf's parts, each call
    ending in a synchronize: the voxel grid (TSDFVolume.__init__), the view
    weights (_view_weights), the rest of integrate_views, the prior, the
    mesh (extract_mesh and export_obj) and the DSM (extract_dsm_points and
    flatten_cloud); and the volume's shape and slabs, the largest weight,
    the mesh's vertices and faces."""

    def __init__(self, device):
        self.device = device

    def __enter__(self):
        from eogs2_tpu_torch.eval import dsm, mesh, tsdf

        self.seconds = {}
        self.shape = self.slabs = None
        self.vertices = self.faces = self.weight_max = None
        vol = tsdf.TSDFVolume
        self.saved = [(vol, "__init__", "volume_s"),
                      (tsdf, "_view_weights", "view_weights_s"),
                      (vol, "integrate_views", "integrate_s"),
                      (vol, "apply_prior", "prior_s"),
                      (vol, "extract_mesh", "mesh_s"),
                      (mesh, "export_obj", "mesh_s"),
                      (vol, "extract_dsm_points", "dsm_s"),
                      (dsm, "flatten_cloud", "dsm_s")]
        for owner, attr, key in self.saved:
            setattr(owner, attr, self._timed(getattr(owner, attr), key))
        return self

    def _sync(self):
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def _timed(self, fn, key):
        def timed(*a, **kw):
            self._sync()
            t = time.perf_counter()
            out = fn(*a, **kw)
            self._sync()
            self.seconds[key] = (self.seconds.get(key, 0.0)
                                 + time.perf_counter() - t)
            if fn.__name__ == "__init__":
                v = a[0]
                self.shape = list(v.shape)
                n = int(np.prod(v.shape))
                self.slabs = -(-n // max(1, min(v.slab_voxels, n)))
            elif fn.__name__ == "extract_mesh":
                self.vertices, self.faces = len(out[0]), len(out[1])
            elif fn.__name__ == "integrate_views":
                self.weight_max = float(a[0].weight.max())
            return out
        timed.orig = fn
        return timed

    @property
    def voxels(self):
        return int(np.prod(self.shape))

    def parts(self, total):
        """The seconds by part, integrate without the view weights, and
        the rest of `total` (the scene and altitude reads, the writes)."""
        p = dict(self.seconds)
        p["integrate_s"] -= p.get("view_weights_s", 0.0)
        p["rest_s"] = total - sum(p.values())
        return p

    def __exit__(self, *exc):
        for owner, attr, _ in self.saved:
            setattr(owner, attr, getattr(owner, attr).orig)


def south_maps(maps):
    """The same views with their image rows running south (the v axis and
    the rows mirrored, so each pixel sees the same ground point): the
    synthetic scene's affines (make_affine) have v = +y, for which every
    view's cos-angle weight is 0 in both packages and fusion leaves the
    volume as it was."""
    flip = np.array([1.0, -1.0, 1.0], np.float32)
    return {k: (flip[:, None] * c, flip * i, np.ascontiguousarray(a[::-1]))
            for k, (c, i, a) in maps.items()}


def tsdf_checks(device, scene, alt_dir, sdir, scale, vox_size, gate_vox_size,
                tmp):
    """On the render's train altitude maps of phase cli (`scene` is the
    loaded scene, `alt_dir` the maps' directory), mirrored to run south so
    the views carry weight (south_maps): run_tsdf at vox_size without the
    mesh (the CLI stage times the mesh; here: seconds by part, peak memory,
    the DSM's MAE against the scene's heightfield); then the gates at gate_vox_size: one slab against
    slabs of 1000 voxels bit-identical on the card, and the card's
    integrate_views and run_tsdf against the port's own on the CPU (per-view
    keep decisions differing in at most 1e-4 of the voxels, tsdf and
    weight within 1e-5 where every decision agrees; the same NaN cells,
    the DSM within 1e-3 m), tests/test_torch_tsdf.py's tolerances."""
    import torch

    from eogs2_tpu_torch.eval import tsdf
    from eogs2_tpu_torch.eval.mae import MaeComputer
    from eogs2_tpu_torch.io.geotiff import read_geotiff, write_geotiff

    with open(os.path.join(sdir, "affine_models.json")) as f:
        md0 = json.load(f)[0]["model"]
    maps = {}
    for v in scene.train_views:
        alt, _ = read_geotiff(os.path.join(alt_dir, v.name + ".tif"))
        a = v.camera.affine.detach().cpu().numpy()
        maps[v.name] = (a[:, :3], a[:, 3], np.asarray(alt, np.float32))
    maps = south_maps(maps)
    bounds = (md0["scale"], md0["min_world"], md0["max_world"],
              md0["center"])

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    with time_tsdf_parts(device) as parts:
        profile, dsm = tsdf.run_tsdf(sdir, maps, *bounds, vox_size=vox_size,
                                     device=device)
    total = time.perf_counter() - t
    peak = (torch.cuda.max_memory_allocated() if device.type == "cuda"
            else None)
    path = os.path.join(tmp, "south_dsm.tif")
    write_geotiff(path, dsm, transform=profile["transform"])
    mae = MaeComputer.from_synthetic(sdir, scale=scale).compute_mae_from_path(
        path)[0]
    finite = float(np.isfinite(dsm).mean())
    del dsm
    gc.collect()

    # gates at gate_vox_size
    cpu = torch.device("cpu")

    def views(dev):
        return tsdf.TsdfViews(*(torch.as_tensor(np.stack(
            [m[k] for m in maps.values()]).astype(np.float32), device=dev)
            for k in range(3)))

    vb = np.stack([np.asarray(md0["min_world"]), np.asarray(
        md0["max_world"])], axis=1) * md0["scale"]
    slab_vols = []
    for slab in (1 << 30, 1000):
        vol = tsdf.TSDFVolume(vb, gate_vox_size, 4.0, slab_voxels=slab,
                              device=device)
        vol.integrate_views(views(device), md0["scale"])
        vol.apply_prior()
        slab_vols.append(vol)
    slab_equal = bool(torch.equal(slab_vols[0].tsdf, slab_vols[1].tsdf)
                      and torch.equal(slab_vols[0].weight,
                                      slab_vols[1].weight))
    vols = {}
    for dev in (device, cpu):
        vol = tsdf.TSDFVolume(vb, gate_vox_size, 4.0, device=dev)
        vol.integrate_views(views(dev), md0["scale"])
        vols[dev.type] = vol
    vc, vh = vols[device.type], vols["cpu"]
    wc, wh = tsdf._view_weights(views(device)), tsdf._view_weights(views(cpu))
    agree = torch.ones(vh.shape, dtype=torch.bool)
    for i in range(len(maps)):
        keeps = []
        for vol, w, vv in ((vc, wc, views(device)), (vh, wh, views(cpu))):
            sdf, valid, _ = tsdf.sample_sdf(
                vv.coefs[i], vv.inters[i], vv.altitudes[i], w[i],
                vol.world_coords, md0["scale"])
            keeps.append((valid & (sdf >= -vol.trunc)).cpu())
        agree &= (keeps[0] == keeps[1]).reshape(vh.shape)
    volume_err = max(float((getattr(vc, f).cpu() - getattr(vh, f)).abs()[
        agree].max()) for f in ("tsdf", "weight"))
    keep_differ = float((~agree).float().mean())
    weighted = float((vh.weight > 0).float().mean())
    outs = {}
    for dev in (device, cpu):
        outs[dev.type] = tsdf.run_tsdf(sdir, maps, *bounds,
                                       vox_size=gate_vox_size, device=dev)[1]
    dc, dh = outs[device.type], outs["cpu"]
    nan_equal = bool(np.array_equal(np.isnan(dc), np.isnan(dh)))
    dsm_err = float(np.nanmax(np.abs(dc - dh))) if np.isfinite(dh).any() \
        else float("nan")
    out = dict(
        config=f"run_tsdf on the phase's {len(maps)} train altitude maps "
               f"mirrored to run south, {vox_size} m; gates at "
               f"{gate_vox_size} m",
        south_s=total, south_parts_s=parts.parts(total),
        south_voxels=parts.voxels, south_shape=parts.shape,
        south_slabs=parts.slabs, south_max_memory_allocated=peak,
        south_weight_max=parts.weight_max, south_dsm_mae=mae,
        south_dsm_finite=finite, gate_shape=list(vh.shape),
        gate_weighted_share=weighted, gate_slabs_bit_equal=slab_equal,
        gate_keep_differ_share=keep_differ, gate_volume_max_err=volume_err,
        gate_dsm_nan_equal=nan_equal, gate_dsm_max_err=dsm_err)
    if not (np.isfinite(mae) and finite > 0.5
            and weighted > 0.1 and slab_equal and keep_differ <= 1e-4
            and volume_err <= 1e-5 and nan_equal and dsm_err <= 1e-3):
        raise AssertionError(f"tsdf checks: {out}")
    return out


# ----------------------------------------------------------------------------
# full-eval: train, render, the Nadir DSM's MAE, tsdf, the TSDF DSM's MAE
# ----------------------------------------------------------------------------


def phase_full_eval(device, width=256, n_views=9, iterations=200,
                    tile_capacity=4096, max_tiles_per_gaussian=1024):
    """cli.main's full-eval at a reduced size, as users run it after
    training: make-synthetic of a width^2 scene with n_views views, then
    full-eval --preset baseogs --raster-mode fused for `iterations`
    iterations with --export-mesh (train, render on the gather route with
    the plain blend, the Nadir DSM's MAE, tsdf, the TSDF DSM's MAE); both
    stage lines must print finite MAEs, the TSDF DSM and the OBJ must
    exist; then metrics_cli on the test views' renders against their GT
    (a finite PSNR). K1 and K2 are held against their plain versions at
    the last training step's render, captured from the run. Imageio and
    Pillow are blocked, as in phase cli. Returns the K1 and K2 launches of
    the full-eval run and the two kernels' reports at that render."""
    import tempfile

    import torch

    from eogs2_tpu_torch import cli, metrics_cli
    from eogs2_tpu_torch.ops.fused_raster import (SortedPairs,
                                                  fused_blend_bwd,
                                                  fused_blend_fwd)

    dev = ["--device", str(device)]
    run = StageRunner(device, cli.main)
    stages, printed = run.stages, run.printed

    with image_libraries_blocked(), tempfile.TemporaryDirectory() as tmp:
        sdir, runp = os.path.join(tmp, "scene"), os.path.join(tmp, "run")
        run("make_synthetic", [
            "make-synthetic", *dev, "--out", sdir, "--n-views", str(n_views),
            "--width", str(width), "--height", str(width)])
        fused_blend_fwd.launches = 0
        fused_blend_bwd.launches = 0
        with record_renders("pipeline", "renderer") as demand, \
                capture_blend_calls(keep=1) as cap:
            run("full_eval", [
                "full-eval", *dev, "--scene-dir", sdir, "--model-path", runp,
                "--preset", "baseogs", "--raster-mode", "fused",
                "--iterations", str(iterations), "--tile-capacity",
                str(tile_capacity), "--max-tiles-per-gaussian",
                str(max_tiles_per_gaussian), "--export-mesh"])
        k1, k2 = fused_blend_fwd.launches, fused_blend_bwd.launches
        # K1 and K2 at the last training step's render (baseogs renders
        # once a step before iteration 1000)
        pay, tstart, cnt, out8, g_out8, gx = cap.bwd_calls[-1]
        del cap
        sp = SortedPairs(pay, tstart, cnt, None)
        k1_rep, k1_out8 = compare_k1(sp, gx)
        if not torch.equal(k1_out8, out8):
            raise AssertionError("K1 at full-eval's last training render "
                                 "differs from the step's own out8")
        k2_rep, _ = compare_k2_at(sp, gx, out8, g_out8)
        del sp, k1_out8, pay, tstart, cnt, out8, g_out8
        densest, widest = demand.maxima()
        lines = [json.loads(ln) for ln in printed["full_eval"].splitlines()
                 if ln.startswith('{"stage"')]
        maes = {ln["stage"]: ln["mae"] for ln in lines}
        out = os.path.join(runp, "test_opNone", f"ours_{iterations}")
        written = {f: os.path.exists(os.path.join(out, "tsdf", f))
                   for f in ("dsm.tif", "output_mesh.obj")}
        run("metrics", [
            "--renders", os.path.join(out, "final"), "--gt",
            os.path.join(out, "gt"), "--device", str(device)],
            main=metrics_cli.main)
        metrics = json.loads(printed["metrics"].strip().splitlines()[-1])
        libs = image_libraries_blocked.loaded()
    log(dict(phase="full_eval", config=f"make-synthetic {width}^2, "
             f"{n_views} views; full-eval baseogs --raster-mode fused, "
             f"{iterations} iterations, render K {tile_capacity}, "
             f"max_tiles_per_gaussian {max_tiles_per_gaussian}, tsdf at 0.5 m "
             "with the mesh; metrics_cli on the test renders",
             stage_s=stages, maes=maes, written=written, metrics=metrics,
             max_tile_count=densest, max_tiles_per_gaussian_seen=widest,
             k1_launches=k1, k2_launches=k2, k1_at_last_render=k1_rep,
             k2_at_last_render=k2_rep, **CARD))
    if not (list(maes) == ["eval_dsm", "eval_dsm_tsdf"]
            and all(np.isfinite(v) for v in maes.values())
            and all(written.values()) and np.isfinite(metrics["psnr"])
            and k2 == iterations and k1 >= k2 and not libs
            and densest < tile_capacity and widest <= max_tiles_per_gaussian):
        raise AssertionError(f"full-eval: MAEs {maes}, files {written}, "
                             f"metrics {metrics}, K1 {k1}, K2 {k2}, "
                             f"libraries {libs}, densest {densest}, widest "
                             f"{widest}")
    return k1, k2, k1_rep, k2_rep


# ----------------------------------------------------------------------------
# the paper's eogsplus recipe: 3PAN, flow matching, the flow bake, the colour
# operations; then the dual MS mode
# ----------------------------------------------------------------------------


def eogsplus_config(iterations, mode=None):
    """eogsplus (3PAN, early stopping on photometric, constant-displacement
    flow matching) with the sun, the random camera and the flow phase from
    iteration 1 (the preset starts flow matching at 1500), the flow bake at
    2/3 of the run, a colour reset 5 iterations later, and
    normalize_colors_before_saving at the last iteration; early stopping
    with patience for every interval. ``mode`` switches the PAN mode (e.g.
    the dual MS "fixed")."""
    from eogs2_tpu_torch.config import _apply_mode, eogsplus

    cfg = eogsplus(iterations=iterations)
    if mode is not None:
        cfg = _apply_mode(cfg, mode)
    o = cfg.optimization
    o.iterstart_shadowmapping = 0
    o.iterstart_L_new_resample = 0
    o.iterstart_flowmatching = 0
    o.itr_apply_flowmatching_to_affine = 2 * iterations // 3
    o.color_reset_iterations = 2 * iterations // 3 + 5
    o.normalize_colors_before_saving = True
    o.early_stopping.patience = iterations
    cfg.logging.tb_log_interval = 5
    return cfg


class record_calls:
    """Within the block, `owner.name` records each call's arguments and
    result (the original runs as usual). A kernel wrapper counts its
    launches on its module's name (`fused_blend_fwd.launches += 1`), which
    is the stand-in's within the block: the stand-in starts from the
    original's count and hands its count back at the end."""

    def __init__(self, owner, name):
        self.owner, self.name, self.calls = owner, name, []

    def __enter__(self):
        orig = self.orig = getattr(self.owner, self.name)

        def wrapper(*args, **kw):
            out = orig(*args, **kw)
            self.calls.append((args, kw, out))
            return out

        if hasattr(orig, "launches"):
            wrapper.launches = orig.launches
        self.wrapper = wrapper
        setattr(self.owner, self.name, wrapper)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self.orig)
        if hasattr(self.orig, "launches"):
            self.orig.launches = self.wrapper.launches


def timed_steps(tr, iterations):
    """Host-clock ms of tr.train_step at each of `iterations`, each ending
    in a synchronize; returns (ms list, metrics list)."""
    import torch

    ms, metrics = [], []
    for it in iterations:
        torch.cuda.synchronize()
        t = time.perf_counter()
        metrics.append(tr.train_step(it))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
    return ms, metrics


def check_metrics(steps, what):
    import torch

    every = torch.stack([torch.stack([m[k].double() for k in m])
                         for m in steps])
    if not bool(torch.isfinite(every).all()):
        raise AssertionError(f"{what}: non-finite step metrics")
    if any(int(v) for m in steps for k, v in m.items()
           if k.endswith("clipped_pairs")):
        raise AssertionError(f"{what}: a render clipped")


def phase_eogsplus(device, arrays, iterations=30, fixed_iterations=5,
                   extra=10):
    """The paper's recipe at full width (cell train-1M-1024-eogsplus): the
    train-1M-1024 scene in modality "ms" (each view's PAN companion derived
    from `arrays`, the MSI scene phase 5 built), eogsplus on the fused route
    with tile_cull: `iterations` iterations of Trainer.train with the flow
    phase in every step, the flow bake, the colour reset and
    normalize_colors_before_saving; then `extra` steps with the flow phase
    off and `extra` with it on again; then the dual MS mode "fixed" (msi and
    pan per step) for `fixed_iterations` steps with the flow phase and as
    many without. K1 and K2 at the eogsplus step's main render against
    their plain versions; one profiled eogsplus step;
    phase_correlation_shift of a PAN render against itself rolled by
    (+3, -2) px. Returns the K1 and K2 launches of the
    phase's main path (comparisons excluded) and the K1/K2 reports."""
    import torch

    from eogs2_tpu_torch import train as train_mod
    from eogs2_tpu_torch.data.synthetic import scene_from_arrays, with_pan
    from eogs2_tpu_torch.flow import phase_correlation_shift
    from eogs2_tpu_torch.ops.fused_raster import (SortedPairs,
                                                  fused_blend_bwd,
                                                  fused_blend_bwd_plain,
                                                  fused_blend_fwd,
                                                  fused_blend_fwd_plain)
    from eogs2_tpu_torch.ops.projection import preprocess_bwd, preprocess_fwd
    from eogs2_tpu_torch.pipeline import render_view_full
    from eogs2_tpu_torch.rasterizer import RasterizeConfig
    from eogs2_tpu_torch.train import Trainer

    t0 = time.perf_counter()
    ms_arrays = with_pan(arrays)
    rcfg = RasterizeConfig(binning_mode="fused", tile_cull=True)
    cfg = eogsplus_config(iterations)
    o = cfg.optimization
    scene = scene_from_arrays(ms_arrays, device=device,
                              load_msi=cfg.model.load_msi,
                              load_pan=cfg.model.load_pan)
    tr = Trainer(cfg, scene, rcfg, device=device).setup()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    if ([n for n, _ in tr.modal_views] != ["pan"] or tr.pan_mode != "identity"
            or tr.consts.images.shape[1] != 3):
        raise AssertionError("eogsplus did not set up 3PAN")
    start = {f: getattr(tr.model, f).detach().clone() for f in FIELDS}
    width = int(tr.consts.native_wh[0])

    # the counted run: counts set to 0 just before, read just after
    fused_blend_fwd.launches = 0
    fused_blend_bwd.launches = 0
    step_ms, steps, events = {}, {}, {}
    train_step = tr.train_step

    def timed_step(iteration):
        torch.cuda.synchronize()
        t = time.perf_counter()
        m = train_step(iteration)
        torch.cuda.synchronize()
        step_ms[iteration] = (time.perf_counter() - t) * 1e3
        steps[iteration] = m
        return m

    def timed(name, fn):
        def run():
            k1 = fused_blend_fwd.launches
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            events[name] = dict(s=time.perf_counter() - t,
                                k1_launches=fused_blend_fwd.launches - k1)
        return run

    affines0 = tr.consts.affines.clone()
    tr.train_step = timed_step
    tr.apply_flowmatching_to_affine = timed(
        "flow_bake", tr.apply_flowmatching_to_affine)
    tr.color_reset = timed("color_reset", tr.color_reset)
    with record_calls(train_mod, "phase_correlation_shift") as shifts, \
            record_calls(train_mod, "apply_color_reset") as resets:
        t = time.perf_counter()
        tr.train(progress=False)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t
    del tr.train_step, tr.apply_flowmatching_to_affine, tr.color_reset
    ran = sorted(steps)
    if ran != list(range(1, iterations + 1)):
        raise AssertionError(f"iterations run: {ran}")
    check_metrics(list(steps.values()), "eogsplus")
    if not all(float(m["flow_mag"]) > 0 for m in steps.values()):
        raise AssertionError("a step's flow phase found no flow")
    bake = [(float(out[0]), float(out[1])) for _, _, out in shifts.calls]
    if len(bake) != len(tr.modal_views[0][1]) or "flow_bake" not in events:
        raise AssertionError(f"the flow bake ran {len(bake)} shifts")
    moved = (tr.consts.affines - affines0)[:, :2, 3].double() * width / 2
    want = -torch.tensor(bake, dtype=torch.float64, device=moved.device)
    if not torch.allclose(moved, want, atol=1e-3):
        raise AssertionError(f"the baked affines moved {moved.tolist()}, "
                             f"the shifts were {bake}")
    if len(resets.calls) != 1:
        raise AssertionError(f"{len(resets.calls)} colour resets")
    mask = resets.calls[0][0][2]
    reset_count = int((mask & tr.model.alive).sum())

    # the flow phase's cost: the same step with the phase off (2 warm-up
    # steps, then `extra`), then on again
    it = iter(range(iterations + 1, iterations + 3 + 2 * extra))
    o.flowmatching.apply_flowmatching = False
    off_ms, off_steps = timed_steps(tr, [next(it) for _ in range(2 + extra)])
    o.flowmatching.apply_flowmatching = True
    on_ms, on_steps = timed_steps(tr, list(it))
    k1_launches, k2_launches = fused_blend_fwd.launches, fused_blend_bwd.launches
    check_metrics(off_steps + on_steps, "eogsplus, flow on/off")
    if any(float(m["flow_mag"]) != 0 for m in off_steps):
        raise AssertionError("the flow phase ran with its gate off")
    n_views = len(tr.modal_views[0][1])
    n_steps = iterations + 2 + 2 * extra
    for name in ("flow_bake", "color_reset"):
        if events[name]["k1_launches"] != 2 * n_views:
            raise AssertionError(f"{name}: {events[name]} (want "
                                 f"{2 * n_views} K1 launches)")
    if (k2_launches != 3 * n_steps
            or k1_launches != 3 * n_steps + 4 * n_views):
        raise AssertionError(f"eogsplus: K1 {k1_launches}, K2 {k2_launches}"
                             f" launches over {n_steps} steps, a bake and a "
                             f"colour reset")
    moved_params = {f: float((getattr(tr.model, f).detach() - x).abs().max())
                    for f, x in start.items()}
    if min(moved_params.values()) <= 0:
        raise AssertionError(f"parameters did not move: {moved_params}")

    # K1 and K2 at the eogsplus step's main render
    with capture_blend_calls() as cap:
        tr.train_step(iterations + 3 + 2 * extra)
        torch.cuda.synchronize()
    bwd = {c[0].data_ptr(): c for c in cap.bwd_calls}
    calls = [bwd[p.data_ptr()] for p in cap.fwd_pays]
    del cap, bwd
    if len(calls) != 3:
        raise AssertionError(f"captured {len(calls)} fused renders, want 3")
    pay, tstart, cnt, out8, g_out8, gx = calls[0]
    sp = SortedPairs(pay, tstart, cnt, None)
    k1, k1_out8 = compare_k1(sp, gx)
    if not torch.equal(k1_out8, out8):
        raise AssertionError("K1 at the eogsplus main render differs from "
                             "the step's own out8")
    k1.update(ms=time_cuda(lambda: fused_blend_fwd(pay, tstart, cnt, gx), 10),
              plain_ms=time_cuda(
                  lambda: fused_blend_fwd_plain(pay, tstart, cnt, gx), 1),
              **k1_bound(sp, gx))
    k2, _ = compare_k2_at(sp, gx, out8, g_out8)
    k2.update(ms=time_cuda(
        lambda: fused_blend_bwd(pay, tstart, cnt, out8, g_out8, gx), 10),
        plain_ms=time_cuda(lambda: fused_blend_bwd_plain(
            pay, tstart, cnt, out8, g_out8, gx), 1),
        **k2_bound(sp, gx, out8))
    del calls, sp, k1_out8, pay, tstart, cnt, out8, g_out8
    log(dict(phase="eogsplus_profile", **profile_run(
        lambda: tr.train_step(iterations + 4 + 2 * extra)), **CARD))

    # phase correlation on the card: a PAN render against itself rolled
    view = tr.modal_views[0][1][0]
    final = render_view_full(tr.model, view.camera, rcfg,
                             shading=tr.shading, view_idx=0,
                             pan_mode=tr.pan_mode)["final"]
    ref = torch.from_numpy(final).to(device)
    mov = torch.roll(ref, shifts=(-2, 3), dims=(1, 2))
    dx, dy = (float(v) for v in phase_correlation_shift(ref, mov))
    if abs(dx - 3.0) > 0.05 or abs(dy + 2.0) > 0.05:
        raise AssertionError(f"phase correlation found ({dx}, {dy}), want "
                             f"(3, -2)")
    report = dict(
        phase="eogsplus", cell="train-1M-1024-eogsplus",
        recipe=(f"eogsplus (3PAN, early stopping on photometric, constant-"
                f"displacement flow matching); sun, random camera and flow "
                f"phase from iteration 1; flow bake at "
                f"{o.itr_apply_flowmatching_to_affine}, colour reset at "
                f"{o.color_reset_iterations}, normalize_colors_before_saving"
                f" at {iterations}"),
        config="fused, tile_cull, eogs_features",
        init_gaussians=len(scene.init_xyz), width=width,
        train_views=n_views, setup_s=setup_s,
        train_s=train_s, iterations=iterations,
        ms_per_step=statistics.median(step_ms[i]
                                      for i in range(3, iterations + 1)),
        step_ms=[step_ms[i] for i in ran],
        ms_per_step_flow_off=statistics.median(off_ms[2:]),
        step_ms_flow_off=off_ms,
        ms_per_step_flow_on_again=statistics.median(on_ms),
        step_ms_flow_on_again=on_ms,
        flow_bake_s=events["flow_bake"]["s"],
        flow_bake_k1_launches=events["flow_bake"]["k1_launches"],
        flow_bake_shifts_px=bake,
        color_reset_s=events["color_reset"]["s"],
        color_reset_k1_launches=events["color_reset"]["k1_launches"],
        color_reset_mask_count=reset_count,
        flow_mag=[float(steps[i]["flow_mag"]) for i in ran],
        photometric=[float(steps[i]["photometric"]) for i in ran],
        early_stopping_iterations=[m["iteration"]
                                   for m in tr.metrics_history],
        phase_correlation_check=dict(rolled_px=[3, -2], found=[dx, dy]),
        k1_launches=k1_launches, k2_launches=k2_launches,
        k1_at_main_render=k1, k2_at_main_render=k2,
        max_param_change=moved_params, **CARD)
    del tr, scene
    gc.collect()

    # the dual MS mode: msi and pan per step
    cfg = eogsplus_config(2 * fixed_iterations, mode="fixed")
    scene = scene_from_arrays(ms_arrays, device=device)
    tr = Trainer(cfg, scene, rcfg, device=device).setup()
    if [n for n, _ in tr.modal_views] != ["msi", "pan"] or \
            tr.pan_mode != "fixed":
        raise AssertionError("fixed did not set up msi + pan")
    fused_blend_fwd.launches = 0
    fused_blend_bwd.launches = 0
    preprocess_fwd.launches = preprocess_bwd.launches = 0
    fixed_on, fixed_steps = timed_steps(tr, range(1, fixed_iterations + 1))
    cfg.optimization.flowmatching.apply_flowmatching = False
    fixed_off, off_steps = timed_steps(
        tr, range(fixed_iterations + 1, 2 * fixed_iterations + 1))
    fk1, fk2 = fused_blend_fwd.launches, fused_blend_bwd.launches
    fprep = (preprocess_fwd.launches, preprocess_bwd.launches)
    check_metrics(fixed_steps + off_steps, "fixed")
    if fk1 != 6 * 2 * fixed_iterations or fk2 != fk1:
        raise AssertionError(f"fixed: K1 {fk1}, K2 {fk2} launches over "
                             f"{2 * fixed_iterations} steps (6 each)")
    if fprep != (fk1, fk1):
        raise AssertionError(f"fixed: preprocess (forward, backward) "
                             f"launches {fprep} over {2 * fixed_iterations} "
                             f"steps (6 each)")
    report.update(
        fixed_ms_per_step=statistics.median(fixed_on[2:]),
        fixed_step_ms=fixed_on,
        fixed_ms_per_step_flow_off=statistics.median(fixed_off[2:]),
        fixed_step_ms_flow_off=fixed_off,
        fixed_k1_launches=fk1, fixed_k2_launches=fk2,
        fixed_preprocess_launches=fprep,
        fixed_metrics={k: float(v) for k, v in fixed_steps[-1].items()})
    log(report)
    del tr, scene
    gc.collect()
    return k1_launches + fk1, k2_launches + fk2, k1, k2, fprep


def dense_serve_cfg(model, view, scene, width):
    """gather + use_pallas for serving, its capacities bucketed from the
    three renders' demand (view, sun, Nadir), so that nothing clips.
    Returns (config, demand per render)."""
    import torch

    from eogs2_tpu_torch.ops.binning import bin_gaussians
    from eogs2_tpu_torch.ops.projection import (compute_cov2d_direct,
                                                preprocess_gaussians)
    from eogs2_tpu_torch.rasterizer import RasterizeConfig

    demand = []
    with torch.no_grad():
        for cam, w in serve_renders(view, scene, width).values():
            aff = cam.resize_canvas(w, w).affine
            cov2d = compute_cov2d_direct(model.get_scaling(), model.rotation,
                                         aff, w, w)
            prep = preprocess_gaussians(model.xyz, None, model.get_opacity(),
                                        aff, w, w, cov2d=cov2d)
            b = bin_gaussians(prep, w, w, max_tiles_per_gaussian=1 << 20)
            demand.append((int(b.max_tile_count),
                           int(prep.tiles_touched.max())))
    cfg = RasterizeConfig(binning_mode="gather", use_pallas=True,
                          eogs_features=True).bucketed(
        max(d[0] for d in demand), max(d[1] for d in demand))
    return cfg, demand


def phase_serve_dense(device, n=1_000_000, width=1024):
    """The serving path on gather + use_pallas (K4 forward)."""
    import torch

    from eogs2_tpu_torch.ops.blend_cuda import blend_forward
    from eogs2_tpu_torch.pipeline import nadir_dsm, render_view_full

    t0 = time.perf_counter()
    model, view, scene, shading = serve_scene(n, width, seed=0, device=device)
    cfg, demand = dense_serve_cfg(model, view, scene, width)
    k, tcap = cfg.tile_capacity, cfg.max_tiles_per_gaussian
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    def rvf():
        return render_view_full(model, view, cfg, shading=shading)

    def nadir():
        return nadir_dsm(model, scene, cfg)

    torch.cuda.reset_peak_memory_stats()
    blend_forward.launches = 0
    out = rvf()
    torch.cuda.synchronize()
    launches_rvf = blend_forward.launches
    blend_forward.launches = 0
    _, dsm, nout = nadir()
    torch.cuda.synchronize()
    launches_nadir = blend_forward.launches
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    if launches_rvf != 2 or launches_nadir != 1:
        raise AssertionError(f"K4 launches: render_view_full {launches_rvf} "
                             f"(want 2), nadir_dsm {launches_nadir} (want 1)")
    rvf_ms, rvf_all = median_ms(rvf)
    nadir_ms, nadir_all = median_ms(nadir)

    # K4 forward at each render's exact table (view, sun, Nadir), captured
    # from one more run of each entry point
    with capture_k4_calls() as cap:
        rvf()
        nadir()
        torch.cuda.synchronize()
    tables = cap.fwd
    del cap
    if len(tables) != 3:
        raise AssertionError(f"captured {len(tables)} K4 tables, want 3")
    worst, at = {}, {}
    for name in ("view", "sun", "nadir"):
        data, gx = tables.pop(0)
        rep, k4_out = compare_k4_fwd(data, gx)
        fwd = dict(ms=time_cuda(lambda: blend_forward(data, gx), 10),
                   **k4_bounds(data, k4_out, gx)[0]["fwd"])
        log(dict(phase="k4_at_serve_shape", render=name, width=16 * gx,
                 height=data.shape[0] // gx * 16,
                 pairs=int(data[:, 11].sum()), **rep, fwd=fwd, **CARD))
        for key, v in rep.items():
            if "err" in key or "mismatch" in key:
                worst[key] = max(worst.get(key, 0), v)
        at[name] = fwd
        del data, k4_out

    log(dict(phase="serve_dense", gaussians=n, width=width, height=width,
             sun_width=2 * width,
             config=f"gather, use_pallas, eogs_features, tile_capacity {k}, "
             f"max_tiles_per_gaussian {tcap}",
             demand_view_sun_nadir=demand, setup_s=setup_s,
             render_view_full_ms=rvf_ms, render_view_full_runs_ms=rvf_all,
             nadir_dsm_ms=nadir_ms, nadir_dsm_runs_ms=nadir_all,
             peak_mem_gib=peak_gib, k4_launches_render_view_full=launches_rvf,
             k4_launches_nadir_dsm=launches_nadir,
             **check_serve_outputs(out, nout, dsm, scene, width), **CARD))
    return launches_rvf + launches_nadir, worst, at


def safe_trainer(scene, device, seed=1):
    """A Trainer on the safe route (gather, the plain dense blend) at lr 0,
    its Gaussians given seeded random opacities, colours, anisotropic scales
    and rotations (tests/test_torch_train.py's one-step state): the uniform
    init's isotropic Gaussians have no rotation gradient to compare."""
    import torch

    from eogs2_tpu_torch import train as tt
    from eogs2_tpu_torch.rasterizer import RasterizeConfig

    tr = tt.Trainer(train_recipe(10), scene,
                    RasterizeConfig(tile_capacity=1024,
                                    max_tiles_per_gaussian=256),
                    device=device).setup()
    for opt in (tr.gauss_opt, tr.cam_opt):
        for group in opt.param_groups:
            group["lr"] = 0.0
    rng = np.random.RandomState(seed)
    n = tr.init_count
    op = rng.uniform(0.2, 0.9, n)
    q = rng.normal(0, 1, (n, 4))
    new = dict(opacity=np.log(op / (1 - op))[:, None],
               features_dc=((rng.uniform(0, 1, (n, 3)) - 0.5)
                            / 0.28209479)[:, None, :],
               scaling=rng.normal(0, 0.3, (n, 3)) - 0.7,
               rotation=q / np.linalg.norm(q, axis=1, keepdims=True))
    with torch.no_grad():
        for f, x in new.items():
            p = getattr(tr.model, f)
            if f == "scaling":
                x = p[:n].cpu().numpy() + x
            p[:n] = torch.as_tensor(x, dtype=p.dtype, device=p.device)
    return tr


def safe_step(tr, bg, shear, iteration=5, view=1):
    """One training step of tr with the given draws: (metrics, gradients)."""
    import torch

    from eogs2_tpu_torch import train as tt

    dev = tr.device
    step = tt.make_train_step((("msi", tr.consts, None, 0),), tr.cfg,
                              tr.raster_cfg,
                              tt.phase_for_iteration(tr.cfg, iteration),
                              tr.gauss_opt, tr.cam_opt)
    metrics = step(tr.model, tr.shading, view, torch.tensor(bg, device=dev),
                   torch.tensor(shear, device=dev),
                   tt.make_gates(tr.cfg, iteration, tr.init_count))
    grads = {f: getattr(tr.model, f).grad.cpu() for f in FIELDS}
    return {k: float(v) for k, v in metrics.items()}, grads


def phase_safe_small(device):
    """One step of the safe route on the card against the same step on the
    CPU, from the same state (the CPU model's parameters) and draws."""
    import torch

    from eogs2_tpu_torch.data.synthetic import (make_scene_arrays,
                                                scene_from_arrays)
    from eogs2_tpu_torch.ops.blend_cuda import blend_backward, blend_forward
    from eogs2_tpu_torch.ops.fused_raster import (fused_blend_bwd,
                                                  fused_blend_bwd_rows,
                                                  fused_blend_fwd,
                                                  fused_blend_fwd_rows)

    arrays = make_scene_arrays(n_views=4, width=256, height=256, hf_res=256,
                               n_buildings=6, seed=3, scale=38.0)
    bg = np.float32([0.2, 0.7, 0.4, 0.0, 0.0])
    shear = np.float32([0.3, -0.5])
    cpu_tr = safe_trainer(scene_from_arrays(arrays, device="cpu"), "cpu")
    card_tr = safe_trainer(scene_from_arrays(arrays, device=device), device)
    card_tr.model.load_state_dict(cpu_tr.model.state_dict())
    kernels = (blend_forward, blend_backward, fused_blend_fwd,
               fused_blend_bwd, fused_blend_fwd_rows, fused_blend_bwd_rows)
    for f in kernels:
        f.launches = 0
    t0 = time.perf_counter()
    card, card_g = safe_step(card_tr, bg, shear)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    launches = [f.launches for f in kernels]
    t0 = time.perf_counter()
    cpu, cpu_g = safe_step(cpu_tr, bg, shear)
    cpu_s = time.perf_counter() - t0
    terms = [k for k in cpu if k.startswith("L") or k in (
        "loss", "L1", "photometric", "psnr")]
    rel_terms = {k: abs(card[k] - cpu[k]) / (abs(cpu[k]) + 1e-12)
                 for k in terms}
    rel_grads = {f: float((card_g[f] - cpu_g[f]).abs().max()
                          / cpu_g[f].abs().max().clamp_min(1e-30))
                 for f in cpu_g}
    log(dict(phase="safe_small", width=256, height=256,
             gaussians=int(cpu_tr.model.alive.sum()),
             config="gather, plain dense blend, tile_capacity 1024",
             max_tile=cpu["max_tile"], loss=card["loss"],
             max_rel_err_terms=max(rel_terms.values()),
             rel_err_grads=rel_grads, hand_kernel_launches=launches,
             card_step_s=card_s, cpu_step_s=cpu_s, **CARD))
    if not (all(np.isfinite(list(card.values())))
            and cpu["max_tile"] < 1024
            and max(rel_terms.values()) <= 1e-4
            and max(rel_grads.values()) <= 2e-4 and not any(launches)):
        raise AssertionError(f"safe route step: terms {rel_terms}, grads "
                             f"{rel_grads}, launches {launches}")


# ----------------------------------------------------------------------------
# the multi-device path on one card: NCCL world size 1
# ----------------------------------------------------------------------------


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def phase_bands(device, bands=4, n=1_000_000, width=1024):
    """K1/K2/K3 at a band offset on serve-1M-1024's view render: its sorted
    ranges cut into `bands` row bands, each launched at tile0 = its first
    tile and held against the plain versions (compare_at_band); the bands
    put together bit-equal to the whole frame's K1 out8 and K2 rows."""
    import torch

    from eogs2_tpu_torch.ops.fused_raster import (fused_blend_bwd,
                                                  fused_blend_fwd, sort_pairs)
    from eogs2_tpu_torch.ops.projection import (compute_cov2d_direct,
                                                preprocess_gaussians)
    from eogs2_tpu_torch.renderer import gaussian_features

    model, view, _, _ = serve_scene(n, width, seed=0, device=device)
    with torch.no_grad():
        feats = gaussian_features(model, view)
        aff = view.resize_canvas(width, width).affine
        cov2d = compute_cov2d_direct(model.get_scaling(), model.rotation, aff,
                                     width, width)
        prep = preprocess_gaussians(model.xyz, None, model.get_opacity(), aff,
                                    width, width, cov2d=cov2d)
        sp = sort_pairs(prep, feats, width, width, eogs=True)
    del model, prep, cov2d, feats
    gx = width // 16
    whole = fused_blend_fwd(sp.pay, sp.tstart, sp.cnt, gx)
    gen = torch.Generator(device=device).manual_seed(0)
    g_out8 = torch.randn(whole.shape, generator=gen, device=device)
    g_whole = fused_blend_bwd(sp.pay, sp.tstart, sp.cnt, whole, g_out8, gx)
    reps, outs = [], []
    g_bands = torch.zeros_like(g_whole)
    tpb = sp.tstart.shape[0] // bands
    for b in range(bands):
        part = slice(b * tpb, (b + 1) * tpb)
        rep, k1, k2, rows = compare_at_band(
            sp.pay, sp.tstart[part].contiguous(), sp.cnt[part].contiguous(),
            gx, b * tpb, g_out8[part].contiguous(), timing=True)
        reps.append(dict(band=b, **rep))
        outs.append(k1)
        g_bands[:, rows] = k2
    torch.cuda.synchronize()
    out = dict(bands_k1_bitwise_equal_whole=bool(torch.equal(
        torch.cat(outs), whole)),
        bands_k2_bitwise_equal_whole=bool(torch.equal(g_bands, g_whole)))
    log(dict(phase="k1_k2_k3_at_band_offset", render="serve view",
             width=width, height=width, pairs=int(sp.pay.shape[1]),
             bands=reps, **out, **CARD))
    if not all(out.values()):
        raise AssertionError(f"the bands differ from the whole frame: {out}")
    return reps


# the 256^2 scene of the gspmd and views_per_step checks
SMALL_SCENE = dict(n_views=5, width=256, height=256, hf_res=256,
                   n_buildings=6, seed=3, scale=25.0)


def small_trainer(scene, device, mesh=None, backend="gspmd", **opt):
    """A Trainer on a small scene, the sun and random camera from
    iteration 1, the fused route with tile_cull."""
    from eogs2_tpu_torch.rasterizer import RasterizeConfig
    from eogs2_tpu_torch.train import Trainer

    cfg = train_recipe(10)
    for k, v in opt.items():
        setattr(cfg.optimization, k, v)
    return Trainer(cfg, scene, RasterizeConfig(binning_mode="fused",
                                               tile_cull=True),
                   device=device, mesh=mesh, raster_backend=backend).setup()


def phase_multidevice(device, arrays, warmup=2, timed=10, band_n=1_000_000,
                      band_width=1024, small_width=256, tsdf_vox=0.5):
    """The multi-device path on one card (cell train-1M-1024-a2a): an NCCL
    process group of world size 1 (a TCP rendezvous on a free local port;
    no gloo and no CPU stand in), its ("g",) mesh; K1/K2/K3 at a band
    offset (phase_bands); on phase 5's scene (rebuilt from `arrays`) the
    fused step timed beside the a2a step (Trainer(mesh, raster_backend=
    "a2a"): every render through rasterize_a2a, capacities sized by
    probe_capacities), each `warmup` + `timed` steps, K1/K2 launches of the
    a2a run, no pair dropped, the largest window against dest_cap, peak
    memory, one profiled a2a step, one a2a step on the row payload (K3);
    one main render's image and per-Gaussian gradients through
    rasterize_a2a against rasterize on the fused route; a gspmd step with
    the mesh against the one-device step and 3 views_per_step=2 steps on a
    256^2 scene; the sharded TSDF on the a2a model's train altitude maps
    mirrored south (south_maps) equal to the unsharded one. Returns the
    band reports and the a2a run's launches."""
    import torch
    import torch.distributed as dist

    from eogs2_tpu_torch.data.synthetic import (make_scene_arrays,
                                                scene_from_arrays)
    from eogs2_tpu_torch.eval import tsdf
    from eogs2_tpu_torch.ops import fused_raster as fr
    from eogs2_tpu_torch.parallel.distributed import init_distributed
    from eogs2_tpu_torch.parallel.mesh import make_mesh
    from eogs2_tpu_torch.parallel.sharded_raster import rasterize_a2a
    from eogs2_tpu_torch.pipeline import render_view_full
    from eogs2_tpu_torch.rasterizer import RasterizeConfig, rasterize
    from eogs2_tpu_torch.renderer import gaussian_features
    from eogs2_tpu_torch.train import Trainer, mean_metrics

    t_phase = time.perf_counter()
    init_distributed(f"tcp://127.0.0.1:{free_port()}", 1, 0, device=device)
    try:
        backend = dist.get_backend()
        if device.type == "cuda" and backend != "nccl":
            raise AssertionError(f"process group backend {backend}")
        mesh = make_mesh(1)
        bands = phase_bands(device, n=band_n, width=band_width)
        gc.collect()

        scene = scene_from_arrays(arrays, device=device)
        rcfg = RasterizeConfig(binning_mode="fused", tile_cull=True)
        runs = {}
        for name in ("fused", "a2a"):
            cfg = train_recipe(warmup + timed + 3)
            t = time.perf_counter()
            tr = Trainer(cfg, scene, rcfg, device=device,
                         mesh=mesh if name == "a2a" else None,
                         raster_backend="a2a" if name == "a2a" else "gspmd"
                         ).setup()
            probed = tr.probe_capacities() if name == "a2a" else None
            torch.cuda.synchronize()
            setup_s = time.perf_counter() - t
            tr.train(warmup, progress=False)
            torch.cuda.reset_peak_memory_stats()
            fr.fused_blend_fwd.launches = 0
            fr.fused_blend_bwd.launches = 0
            ms, steps = timed_steps(tr, range(warmup + 1, warmup + timed + 1))
            launches = (fr.fused_blend_fwd.launches,
                        fr.fused_blend_bwd.launches)
            peak = torch.cuda.max_memory_allocated() / 2**30
            check_metrics(steps, name)
            m = mean_metrics(steps)
            runs[name] = dict(ms_per_step=statistics.median(ms), step_ms=ms,
                              setup_s=setup_s, peak_mem_gib=peak,
                              k1_launches=launches[0],
                              k2_launches=launches[1])
            if name == "fused":
                del tr
                gc.collect()
                continue
            if launches != (3 * timed, 3 * timed):
                raise AssertionError(f"a2a launches {launches}, want "
                                     f"{3 * timed} each")
            dropped = max(int(x["dropped_pairs"]) for x in steps)
            max_dest = max(int(x["max_dest_count"]) for x in steps)
            if dropped or max_dest > tr.raster_cfg.dest_cap:
                raise AssertionError(f"a2a dropped {dropped} pairs (window "
                                     f"{max_dest}, dest_cap "
                                     f"{tr.raster_cfg.dest_cap})")
            runs[name].update(
                dest_cap=probed.dest_cap, tile_capacity=probed.tile_capacity,
                max_tiles_per_gaussian=probed.max_tiles_per_gaussian,
                dropped_pairs=dropped, max_dest_count=max_dest,
                max_tile_count=max(int(x["max_tile"]) for x in steps),
                num_pairs_main=m["num_pairs"], loss=m["loss"])
        a2a_tr = tr
        log(dict(phase="multidevice_step", cell="train-1M-1024-a2a",
                 backend=backend, world_size=dist.get_world_size(),
                 init_gaussians=len(scene.init_xyz),
                 recipe="baseogs, sun and random camera from iteration 1",
                 config="fused, tile_cull; a2a on a 1-rank mesh",
                 a2a_over_fused=runs["a2a"]["ms_per_step"]
                 / runs["fused"]["ms_per_step"], **runs, **CARD))
        log(dict(phase="multidevice_profile", backend="a2a",
                 **profile_run(lambda: a2a_tr.train_step(warmup + timed + 1)),
                 **CARD))

        # K3: one a2a step on the row payload
        for k in ("fused_blend_fwd", "fused_blend_bwd",
                  "fused_blend_fwd_rows", "fused_blend_bwd_rows"):
            getattr(fr, k).launches = 0
        a2a_tr.set_raster_cfg(dataclasses.replace(a2a_tr.raster_cfg,
                                                  payload_col=False))
        check_metrics([a2a_tr.train_step(warmup + timed + 2)], "a2a K3")
        torch.cuda.synchronize()
        k3_launches = (fr.fused_blend_fwd_rows.launches,
                       fr.fused_blend_bwd_rows.launches)
        if k3_launches != (3, 3) or fr.fused_blend_fwd.launches \
                or fr.fused_blend_bwd.launches:
            raise AssertionError(f"a2a row-payload step: K3 {k3_launches}, "
                                 f"K1 {fr.fused_blend_fwd.launches}")
        a2a_tr.set_raster_cfg(dataclasses.replace(a2a_tr.raster_cfg,
                                                  payload_col=True))

        # one main render: rasterize_a2a against rasterize (fused)
        model = a2a_tr.model
        cam = scene.train_views[0].camera
        w = cam.width
        inputs = [x.detach().clone().requires_grad_(True) for x in
                  (model.xyz, model.get_scaling(), model.rotation,
                   model.get_opacity())]
        with torch.no_grad():
            feats = gaussian_features(model, cam)
        feats.requires_grad_(True)
        bg = torch.tensor([0.3, 0.5, 0.2, -1.0, 0.0], device=device)
        aff = cam.resize_canvas(w, w).affine
        gen = torch.Generator(device=device).manual_seed(1)
        cot = torch.rand((5, w, w), generator=gen, device=device)
        cfg_r = dataclasses.replace(a2a_tr.raster_cfg, eogs_features=False)
        grads, imgs = {}, {}
        for route in ("a2a", "fused"):
            for x in inputs + [feats]:
                x.grad = None
            if route == "a2a":
                out = rasterize_a2a(mesh, *inputs, feats, aff, bg, w, w,
                                    cfg_r, alive=model.alive)
            else:
                out = rasterize(*inputs, feats, aff, bg, w, w, cfg_r,
                                alive=model.alive)
            (out.image * cot).sum().backward()
            imgs[route] = out.image.detach()
            grads[route] = [x.grad.detach().clone()
                            for x in inputs + [feats]]
        torch.cuda.synchronize()
        img_err = float((imgs["a2a"] - imgs["fused"]).abs().max())
        grad_err = max(float((a - b).abs().max() / b.abs().max()
                             .clamp_min(1e-30))
                       for a, b in zip(grads["a2a"], grads["fused"]))
        render = dict(image_max_abs_err=img_err,
                      grad_max_rel_err=grad_err,
                      tolerance="image atol 5e-5, gradients 2e-4 of the "
                                "largest (tests/test_sharded.py, "
                                "tests/test_golden.py)",
                      image_bitwise_equal=bool(torch.equal(imgs["a2a"],
                                                           imgs["fused"])))
        del grads, imgs, inputs, feats, cot
        if not (img_err <= 5e-5 and grad_err <= 2e-4):
            raise AssertionError(f"a2a render against fused: {render}")

        # the sharded TSDF on the a2a model's train altitude maps, south
        md0 = arrays.metadatas[0]["model"]
        maps = {}
        for v in scene.train_views:
            alt = render_view_full(a2a_tr.model, v.camera,
                                   a2a_tr.raster_cfg)["altitude"]
            a = v.camera.affine.detach().cpu().numpy()
            maps[v.name] = (a[:, :3], a[:, 3], np.asarray(alt, np.float32))
        maps = south_maps(maps)
        views = tsdf.TsdfViews(*(torch.as_tensor(np.stack(
            [m[k] for m in maps.values()]).astype(np.float32), device=device)
            for k in range(3)))
        vb = np.stack([np.asarray(md0["min_world"]),
                       np.asarray(md0["max_world"])], axis=1) * md0["scale"]
        vols = []
        for m in (None, mesh):
            vol = tsdf.TSDFVolume(vb, tsdf_vox, 4.0, mesh=m, device=device)
            vol.integrate_views(views, md0["scale"])
            vol.apply_prior()
            vols.append(vol)
        tsdf_rep = dict(
            voxels=int(np.prod(vols[0].shape)),
            weighted_share=float((vols[0].weight > 0).float().mean()),
            sharded_bitwise_equal=bool(
                torch.equal(vols[0].tsdf, vols[1].tsdf)
                and torch.equal(vols[0].weight, vols[1].weight)))
        del vols, views, maps, a2a_tr, tr, model
        gc.collect()
        if not tsdf_rep["sharded_bitwise_equal"] or \
                tsdf_rep["weighted_share"] <= 0.1:
            raise AssertionError(f"sharded TSDF: {tsdf_rep}")

        # gspmd with the mesh, and views_per_step = 2, on a 256^2 scene
        small = scene_from_arrays(make_scene_arrays(**dict(
            SMALL_SCENE, width=small_width, height=small_width)),
            device=device)
        plain, again, meshed = (small_trainer(small, device, mesh=m)
                                for m in (None, None, mesh))
        steps = [t.train_step(1) for t in (plain, again, meshed)]

        def grad_diff(a, b):
            return {f: float((getattr(a.model, f).grad
                              - getattr(b.model, f).grad).abs().max()
                             / getattr(b.model, f).grad.abs().max()
                             .clamp_min(1e-30)) for f in FIELDS}

        gspmd_err, spread = grad_diff(meshed, plain), grad_diff(again, plain)
        loss_err = abs(float(steps[2]["loss"]) - float(steps[0]["loss"]))
        vps = small_trainer(small, device, views_per_step=2)
        vps_ms, vps_steps = timed_steps(vps, range(1, 4))
        check_metrics(vps_steps, "views_per_step=2")
        others = dict(gspmd_mesh_step_grad_rel_err=gspmd_err,
                      plain_steps_grad_rel_spread=spread,
                      gspmd_mesh_step_loss_abs_err=loss_err,
                      views_per_step_2_ms=vps_ms,
                      views_per_step_2_loss=[float(m["loss"])
                                             for m in vps_steps])
        if loss_err > 1e-6 * abs(float(steps[0]["loss"])) or max(
                gspmd_err.values()) > K2_ROW_TOL or any(spread.values()):
            raise AssertionError(f"gspmd step with the mesh: {others}")
        log(dict(phase="multidevice_checks", render_a2a_vs_fused=render,
                 tsdf_south_sharded=tsdf_rep, **others,
                 phase_s=time.perf_counter() - t_phase, **CARD))
        return bands, runs["a2a"], k3_launches
    finally:
        dist.destroy_process_group()


# ----------------------------------------------------------------------------
# the multi-device path on four cards: one rank per card over NCCL
# ----------------------------------------------------------------------------

MULTICARD_RANKS = 4


def save_scene_arrays(arrays, path):
    """make_scene_arrays' scene in one .npz: the images as arrays, the rest
    (metadata, names, heightfield, texture) pickled."""
    import pickle

    names = sorted(arrays.images)
    rest = pickle.dumps((arrays._replace(images={}), names))
    np.savez(path, rest=np.frombuffer(rest, np.uint8),
             **{f"image{i}": arrays.images[k] for i, k in enumerate(names)})


def load_scene_arrays(path):
    import pickle

    with np.load(path) as z:
        rest, names = pickle.loads(z["rest"].tobytes())
        return rest._replace(images={k: z[f"image{i}"]
                                     for i, k in enumerate(names)})


class time_exchanges:
    """Within the block, each all_to_all_single of the a2a path
    (parallel.sharded_raster._exchange) is timed by CUDA events on the
    calling stream (until the stream may use what it received); with
    `count`, the real pairs of each forward window are counted too.
    `calls` holds (payload width: 13 forward, 11 backward, bytes sent,
    start event, end event, per-window counts or None)."""

    def __init__(self, count=False):
        self.count, self.calls = count, []

    def __enter__(self):
        import torch

        from eogs2_tpu_torch.parallel import sharded_raster as sr

        self.sr, orig = sr, sr._exchange
        self.orig = orig
        timed = torch.cuda.is_available()

        def spy(x, s):
            if s.n_shards == 1:
                return orig(x, s)
            ev = ([torch.cuda.Event(enable_timing=True) for _ in range(2)]
                  if timed else [None, None])
            if timed:
                ev[0].record()
            out = orig(x, s)
            if timed:
                ev[1].record()
            counts = (torch.isfinite(x[..., 1]).sum(1)
                      if self.count and x.shape[-1] == sr.NX else None)
            self.calls.append((x.shape[-1], x.numel() * x.element_size(),
                               *ev, counts))
            return out

        sr._exchange = spy
        return self

    def __exit__(self, *exc):
        self.sr._exchange = self.orig


def walked_rows(tstart, cnt):
    """The payload rows the tiles walk: [tstart[t], tstart[t] + cnt[t])."""
    import torch

    cnt = cnt.long()
    base = torch.repeat_interleave(tstart.long(), cnt)
    first = torch.repeat_interleave(torch.cumsum(cnt, 0) - cnt, cnt)
    return base + torch.arange(base.shape[0], device=base.device) - first


def compare_at_band(pay, tstart, cnt, gx, tile0, g_out8, out8=None,
                    timing=False):
    """K1, K2 and K3 on one band of a frame's tiles (tile t of the call is
    tile tile0 + t of the frame) against the plain versions at the same
    tile0: K1 channels 0-4 within ATOL_CH, final_T within ATOL_T,
    n_contrib exact (and equal to `out8`, the render's own, when given);
    K2 per walked row within K2_ROW_TOL of the row's largest value and
    bitwise deterministic; K3 (the row payload) bit-equal to K1/K2. With
    `timing`, the kernels' times, the plain versions' and the bounds.
    Returns (report, K1's out8, K2's walked rows, their indices)."""
    import torch

    from eogs2_tpu_torch.ops.fused_raster import (NF, NFR, SortedPairs,
                                                  fused_blend_bwd,
                                                  fused_blend_bwd_plain,
                                                  fused_blend_bwd_rows,
                                                  fused_blend_fwd,
                                                  fused_blend_fwd_plain,
                                                  fused_blend_fwd_rows)

    k1 = fused_blend_fwd(pay, tstart, cnt, gx, tile0)
    p1 = fused_blend_fwd_plain(pay, tstart, cnt, gx, tile0)
    rows = walked_rows(tstart, cnt)
    k2 = fused_blend_bwd(pay, tstart, cnt, k1, g_out8, gx, tile0)[:, rows]
    k2b = fused_blend_bwd(pay, tstart, cnt, k1, g_out8, gx, tile0)[:, rows]
    p2 = fused_blend_bwd_plain(pay, tstart, cnt, k1, g_out8, gx,
                               tile0)[:, rows]
    pay_r = torch.nn.functional.pad(pay.t(), (0, NFR - NF)).contiguous()
    k3 = fused_blend_fwd_rows(pay_r, tstart, cnt, gx, tile0)
    k3b = fused_blend_bwd_rows(pay_r, tstart, cnt, k1, g_out8, gx,
                               tile0)[rows, :NF]
    scale = p2.abs().amax(dim=1)
    live = scale > 0
    err = (k2 - p2).abs().amax(dim=1) / scale.clamp_min(1e-30)
    rep = dict(
        tile0=int(tile0), tiles=int(tstart.shape[0]),
        pairs=int(rows.shape[0]),
        k1_max_abs_err_ch0_4=float((k1[..., :5] - p1[..., :5]).abs().max()),
        k1_max_abs_err_final_t=float((k1[..., 5] - p1[..., 5]).abs().max()),
        k1_n_contrib_mismatches=int((k1[..., 6] != p1[..., 6]).sum()),
        k1_equals_render_out8=out8 is None or bool(torch.equal(k1, out8)),
        k2_max_row_rel_err=float(err[live].max()) if bool(live.any())
        else 0.0,
        k2_max_abs_err=float((k2 - p2).abs().max()),
        k2_bitwise_deterministic=bool(torch.equal(k2, k2b)),
        k3_fwd_bitwise_equal_k1=bool(torch.equal(k3, k1)),
        k3_bwd_bitwise_equal_k2=bool(torch.equal(k3b.t(), k2)))
    if not (rep["k1_max_abs_err_ch0_4"] <= ATOL_CH
            and rep["k1_max_abs_err_final_t"] <= ATOL_T
            and rep["k1_n_contrib_mismatches"] == 0
            and rep["k1_equals_render_out8"]
            and rep["k2_max_row_rel_err"] <= K2_ROW_TOL
            and rep["k2_bitwise_deterministic"]
            and rep["k3_fwd_bitwise_equal_k1"]
            and rep["k3_bwd_bitwise_equal_k2"]
            and bool((k2[~live] == 0).all())
            and bool(torch.isfinite(k2).all())):
        raise AssertionError(f"K1/K2/K3 at a band offset disagree: {rep}")
    if timing:
        sp = SortedPairs(pay, tstart, cnt, None)
        k3f, k3w = k3_bound(sp, gx, k1, tile0)
        rep.update(
            k3_fwd=dict(ms=time_cuda(lambda: fused_blend_fwd_rows(
                pay_r, tstart, cnt, gx, tile0), 10), **k3f),
            k3_bwd=dict(ms=time_cuda(lambda: fused_blend_bwd_rows(
                pay_r, tstart, cnt, k1, g_out8, gx, tile0), 10), **k3w))
        rep.update(
            k1=dict(ms=time_cuda(lambda: fused_blend_fwd(
                pay, tstart, cnt, gx, tile0), 10),
                plain_ms=time_cuda(lambda: fused_blend_fwd_plain(
                    pay, tstart, cnt, gx, tile0), 1),
                **k1_bound(sp, gx, tile0)),
            k2=dict(ms=time_cuda(lambda: fused_blend_bwd(
                pay, tstart, cnt, k1, g_out8, gx, tile0), 10),
                plain_ms=time_cuda(lambda: fused_blend_bwd_plain(
                    pay, tstart, cnt, k1, g_out8, gx, tile0), 1),
                **k2_bound(sp, gx, k1, tile0)))
    return rep, k1, k2, rows


def counted(module, name):
    """A stand-in for the kernel wrapper `module.name` that counts its calls
    as the wrapper counts its launches, on the module's name (on the CPU
    the wrappers take their plain versions and count nothing; the CPU
    rehearsal of the launch gates counts the calls)."""
    fn = getattr(module, name)

    def wrapper(*args, **kw):
        getattr(module, name).launches += 1
        return fn(*args, **kw)

    wrapper.launches = 0
    return wrapper


def _rel_err(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def multicard_rank(rank, n, scene_path, opts):
    """One rank of phase_multicard, in a process group of n ranks that the
    caller has started (NCCL with one card a rank, or gloo on the CPU for
    the rehearsal); every rank loads the same scene (the data model is
    host-replicated). Each gate raises. Returns this rank's report (rank
    0's holds the comparisons with one card).

    opts: warmup, timed (the a2a Trainer's steps), tsdf_vox, and
    optionally small_scene (make_scene_arrays' arguments of the gspmd and
    views_per_step scene; SMALL_SCENE by default); on CUDA the kernels are
    timed.

      (a) one main render through rasterize_a2a against rasterize on the
          fused route on rank 0 alone (no group), from the same state:
          image within atol 5e-5, every input's per-Gaussian gradient
          within 2e-4 of its largest value, no pair dropped, K1/K2 launched
          at each rank's band tile0 (not 0 on ranks 1..n-1), and held
          there against their plain versions;
      (b) the a2a Trainer (train-1M-1024's recipe, capacities by
          probe_capacities): step 1 twice from the same state, bit-equal
          on every rank; step 1 on the row payload (K3) with the column
          step's loss bits; warmup + timed steps, each ending in a
          synchronize and a barrier, with the all_to_all_single times,
          K1/K2 launches and the peak memory; the windows of one more
          step; on rank 0 alone the one-card fused Trainer's warmup +
          timed steps from the same seed: step 1's loss within rel 1e-6;
      (c) a gspmd step against one card's on a small scene (loss rel
          1e-6, every leaf's gradient within 2e-4 of its largest), then 3
          views_per_step=2 steps on a ("d", "g") mesh against one card's
          (losses rel 1e-6);
      (d) the sharded TSDF on the a2a model's train altitude maps, mirrored
          south, equal bit for bit to rank 0's unsharded volume."""
    import torch
    import torch.distributed as dist

    from eogs2_tpu_torch.data.synthetic import (make_scene_arrays,
                                                scene_from_arrays)
    from eogs2_tpu_torch.eval import tsdf
    from eogs2_tpu_torch.ops import fused_raster as fr
    from eogs2_tpu_torch.parallel.distributed import (all_gather_cat,
                                                      all_processes_allclose)
    from eogs2_tpu_torch.parallel.mesh import axis_group, make_mesh
    from eogs2_tpu_torch.parallel.sharded_raster import rasterize_a2a
    from eogs2_tpu_torch.pipeline import render_view_full
    from eogs2_tpu_torch.rasterizer import RasterizeConfig, rasterize
    from eogs2_tpu_torch.renderer import gaussian_features
    from eogs2_tpu_torch.train import Trainer

    cuda = dist.get_backend() == "nccl"
    dev = (torch.device("cuda", torch.cuda.current_device()) if cuda
           else torch.device("cpu"))
    warmup, timed = opts["warmup"], opts["timed"]
    if not cuda:  # the plain versions count nothing: count their calls
        for k in ("fused_blend_fwd", "fused_blend_bwd",
                  "fused_blend_fwd_rows", "fused_blend_bwd_rows"):
            setattr(fr, k, counted(fr, k))

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def barrier():
        sync()
        dist.barrier()

    def every_rank(ok):
        """ok on every rank (a MIN all_reduce of one flag)."""
        t = torch.tensor([int(bool(ok))], device=dev)
        dist.all_reduce(t, op=dist.ReduceOp.MIN)
        return bool(t.item())

    def gathered(x):
        return all_gather_cat(x.detach().contiguous(), group)

    t_rank = time.perf_counter()
    arrays = load_scene_arrays(scene_path)
    scene = scene_from_arrays(arrays, device=dev)
    mesh = make_mesh(n)
    group = axis_group(mesh, "g")
    rcfg = RasterizeConfig(binning_mode="fused", tile_cull=True)
    steps_cfg = warmup + timed + 3
    rep = dict(rank=rank, device=str(dev),
               rank_card=torch.cuda.get_device_name(dev) if cuda else "cpu")

    def a2a_trainer(**cfg_kw):
        tr = Trainer(train_recipe(steps_cfg), scene, rcfg, device=dev,
                     mesh=mesh, raster_backend="a2a").setup()
        probed = tr.probe_capacities()
        if cfg_kw:
            tr.set_raster_cfg(dataclasses.replace(probed, **cfg_kw))
        return tr, probed

    # (a) one main render: rasterize_a2a at n ranks against rasterize
    t = time.perf_counter()
    tr_a, probed = a2a_trainer()
    model = tr_a.model
    cam = scene.train_views[0].camera
    w = cam.width
    inputs = [x.detach().clone().requires_grad_(True) for x in
              (model.xyz, model.get_scaling(), model.rotation,
               model.get_opacity())]
    with torch.no_grad():
        feats = gaussian_features(model, cam)
    feats.requires_grad_(True)
    bg = torch.tensor([0.3, 0.5, 0.2, -1.0, 0.0], device=dev)
    aff = cam.resize_canvas(w, w).affine
    gen = torch.Generator(device=dev).manual_seed(1)
    cot = torch.rand((5, w, w), generator=gen, device=dev)
    cfg_r = dataclasses.replace(tr_a.raster_cfg, eogs_features=False)
    with record_calls(fr, "fused_blend_fwd") as k1c, \
            record_calls(fr, "fused_blend_bwd") as k2c:
        out = rasterize_a2a(mesh, *inputs, feats, aff, bg, w, w, cfg_r,
                            alive=model.alive)
        (out.image * cot).sum().backward()
    sync()
    img_a2a = out.image.detach()
    dropped = int(out.dropped_pairs)
    g_a2a = [gathered(x.grad) for x in inputs + [feats]]
    (pay, tstart, cnt, gx, tile0), _, out8 = k1c.calls[0]
    band, *_ = compare_at_band(pay, tstart, cnt, gx, tile0,
                               k2c.calls[0][0][4], out8=out8, timing=cuda)
    del pay, tstart, cnt, out8
    tile0s = [(int(a[0][4]), int(b[0][6]))
              for a, b in zip(k1c.calls, k2c.calls)]
    whole = tr_a.whole()
    del out, inputs, feats, k1c, k2c
    render = None
    if rank == 0:
        wm = whole.model
        ref_in = [x.detach().clone().requires_grad_(True) for x in
                  (wm.xyz, wm.get_scaling(), wm.rotation, wm.get_opacity())]
        with torch.no_grad():
            rfeats = gaussian_features(wm, cam)
        rfeats.requires_grad_(True)
        ref = rasterize(*ref_in, rfeats, aff, bg, w, w, cfg_r, alive=wm.alive)
        (ref.image * cot).sum().backward()
        sync()
        grad_err = {name: _rel_err(a, x.grad) for name, a, x in zip(
            ("xyz", "scaling", "rotation", "opacity", "features"), g_a2a,
            ref_in + [rfeats])}
        render = dict(
            image_max_abs_err=float((img_a2a - ref.image.detach()).abs()
                                    .max()),
            image_bitwise_equal=bool(torch.equal(img_a2a,
                                                 ref.image.detach())),
            grad_max_rel_err=grad_err, dropped_pairs=dropped,
            tolerance="image atol 5e-5, gradients 2e-4 of the largest "
                      "(tests/test_sharded.py, tests/test_golden.py)")
        del ref, ref_in, rfeats
        if not (render["image_max_abs_err"] <= 5e-5
                and max(grad_err.values()) <= K2_ROW_TOL and dropped == 0):
            raise AssertionError(f"a2a render against fused: {render}")
    del whole, g_a2a, img_a2a, cot
    if rank > 0 and (band["tile0"] == 0 or any(a == 0 or b == 0
                                               for a, b in tile0s)):
        raise AssertionError(f"rank {rank} launched at tile0 {tile0s}")
    rep.update(render_a2a_vs_fused=render, band=band, tile0s=tile0s,
               dest_cap=probed.dest_cap,
               tile_capacity=probed.tile_capacity,
               max_tiles_per_gaussian=probed.max_tiles_per_gaussian,
               render_check_s=time.perf_counter() - t)
    barrier()

    # (b) the a2a Trainer: step 1 twice from one state, and on the rows
    t = time.perf_counter()
    m_a = tr_a.train_step(1)
    loss_a, grads_a = m_a["loss"].clone(), {
        k: v.clone() for k, v in leaf_grads(tr_a).items()}
    del tr_a, m_a
    gc.collect()
    tr, _ = a2a_trainer()
    m1 = tr.train_step(1)
    same = bool(torch.equal(m1["loss"], loss_a)) and all(
        torch.equal(v, grads_a[k]) for k, v in leaf_grads(tr).items())
    rep["step1_repeat_bitwise_equal"] = same
    all_same = every_rank(same)
    for k in ("fused_blend_fwd_rows", "fused_blend_bwd_rows"):
        getattr(fr, k).launches = 0
    tr_rows, _ = a2a_trainer(payload_col=False)
    m_rows = tr_rows.train_step(1)
    sync()
    k3_launches = (fr.fused_blend_fwd_rows.launches,
                   fr.fused_blend_bwd_rows.launches)
    rows_equal = bool(torch.equal(m_rows["loss"], loss_a))
    del tr_rows, m_rows, grads_a
    gc.collect()
    rep.update(k3_step_launches=k3_launches, k3_loss_bitwise_equal=rows_equal)
    if not all_same:
        raise AssertionError("two a2a steps from one state differ on a rank "
                             f"(rank {rank}: {same})")
    if k3_launches != (3, 3) or not rows_equal:
        raise AssertionError(f"the a2a row-payload step: K3 {k3_launches}, "
                             f"loss equal {rows_equal}")

    losses = [float(m1["loss"])]
    for it in range(2, warmup + 1):
        losses.append(float(tr.train_step(it)["loss"]))
    barrier()
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    for k in ("fused_blend_fwd", "fused_blend_bwd"):
        getattr(fr, k).launches = 0
    step_ms, steps = [], []
    with time_exchanges() as ex:
        for it in range(warmup + 1, warmup + timed + 1):
            barrier()
            t0 = time.perf_counter()
            steps.append(tr.train_step(it))
            barrier()
            step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = (fr.fused_blend_fwd.launches, fr.fused_blend_bwd.launches)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30 if cuda else None
    losses += [float(m["loss"]) for m in steps]
    check_metrics(steps, "a2a at n ranks")
    if launches != (3 * timed, 3 * timed):
        raise AssertionError(f"a2a launches {launches}, want {3 * timed} "
                             f"each")
    dropped = max(int(m["dropped_pairs"]) for m in steps)
    max_dest = max(int(m["max_dest_count"]) for m in steps)
    if dropped or max_dest > tr.raster_cfg.dest_cap:
        raise AssertionError(f"a2a dropped {dropped} pairs (window "
                             f"{max_dest}, dest_cap {tr.raster_cfg.dest_cap})")
    exchange = None
    if cuda:
        fwd = [c for c in ex.calls if c[0] == 13]
        bwd = [c for c in ex.calls if c[0] != 13]
        exchange = dict(
            fwd_ms={name: [c[2].elapsed_time(c[3]) for c in fwd[i::3]]
                    for i, name in enumerate(TRAIN_RENDERS)},
            bwd_ms_in_call_order=[[c[2].elapsed_time(c[3])
                                   for c in bwd[3 * s:3 * s + 3]]
                                  for s in range(timed)],
            fwd_bytes_sent=fwd[0][1], bwd_bytes_sent=bwd[0][1])
    del ex
    # the windows of one more step (counted, not timed)
    with time_exchanges(count=True) as ex:
        tr.train_step(warmup + timed + 1)
    sync()
    counts = [c[4] for c in ex.calls if c[4] is not None]
    del ex
    # one profiled step on rank 0 (the others step along unprofiled)
    profile = None
    barrier()
    if cuda and rank == 0:
        profile = profile_run(lambda: tr.train_step(warmup + timed + 2))
    else:
        tr.train_step(warmup + timed + 2)
    barrier()
    windows = {}
    for name, c in zip(TRAIN_RENDERS, counts):
        mat = gathered(c[None])  # [source rank, destination band]
        windows[name] = dict(max=int(mat.max()),
                             mean=float(mat.double().mean()),
                             per_source_and_band=mat.tolist())
    rep.update(a2a=dict(
        step_ms=step_ms, ms_per_step=statistics.median(step_ms),
        losses=losses, k1_launches=launches[0], k2_launches=launches[1],
        peak_mem_gib=peak, dest_cap=tr.raster_cfg.dest_cap,
        max_dest_count=max_dest, dropped_pairs=dropped, exchange=exchange,
        windows=windows, profile=profile, num_pairs_main=float(np.mean(
            [float(m["num_pairs"]) for m in steps]))),
        a2a_s=time.perf_counter() - t)
    barrier()

    # (b) the one-card fused Trainer on rank 0 alone, the same seed
    if rank == 0:
        t = time.perf_counter()
        one = Trainer(train_recipe(steps_cfg), scene, rcfg,
                      device=dev).setup()
        one_losses = [float(one.train_step(it)["loss"])
                      for it in range(1, warmup + 1)]
        one_ms, one_steps = (timed_steps(one, range(warmup + 1,
                                                    warmup + timed + 1))
                             if cuda else ([], [one.train_step(it) for it in
                                                range(warmup + 1,
                                                      warmup + timed + 1)]))
        one_losses += [float(m["loss"]) for m in one_steps]
        del one, one_steps
        gc.collect()
        rel = [abs(a - b) / abs(b) for a, b in zip(losses, one_losses)]
        rep["one_card_fused"] = dict(
            ms_per_step=statistics.median(one_ms) if one_ms else None,
            step_ms=one_ms, losses=one_losses, loss_rel_diff=rel,
            a2a_over_fused=(rep["a2a"]["ms_per_step"]
                            / statistics.median(one_ms)) if one_ms else None,
            s=time.perf_counter() - t)
        if rel[0] > 1e-6:
            raise AssertionError(f"a2a step 1's loss against one card's: "
                                 f"{rel[0]}")
    barrier()

    # (d) the sharded TSDF on the a2a model's train altitude maps, south
    t = time.perf_counter()
    whole = tr.whole()
    md0 = arrays.metadatas[0]["model"]
    maps = {}
    for v in scene.train_views:
        alt = render_view_full(whole.model, v.camera,
                               tr.raster_cfg)["altitude"]
        a = v.camera.affine.detach().cpu().numpy()
        maps[v.name] = (a[:, :3], a[:, 3], np.asarray(alt, np.float32))
    del whole, tr
    gc.collect()
    maps = south_maps(maps)
    views = tsdf.TsdfViews(*(torch.as_tensor(np.stack(
        [m[k] for m in maps.values()]).astype(np.float32), device=dev)
        for k in range(3)))
    maps_equal = all_processes_allclose(views.altitudes)
    vb = np.stack([np.asarray(md0["min_world"]),
                   np.asarray(md0["max_world"])], axis=1) * md0["scale"]
    vol = tsdf.TSDFVolume(vb, opts["tsdf_vox"], 4.0, mesh=mesh, device=dev)
    vol.integrate_views(views, md0["scale"])
    vol.apply_prior()
    tsdf_rep = None
    if rank == 0:
        one = tsdf.TSDFVolume(vb, opts["tsdf_vox"], 4.0, device=dev)
        one.integrate_views(views, md0["scale"])
        one.apply_prior()
        tsdf_rep = dict(
            voxels=int(np.prod(one.shape)), maps_equal_on_ranks=maps_equal,
            weighted_share=float((one.weight > 0).float().mean()),
            sharded_bitwise_equal=bool(torch.equal(one.tsdf, vol.tsdf)
                                       and torch.equal(one.weight,
                                                       vol.weight)))
        del one
        if not (tsdf_rep["sharded_bitwise_equal"] and maps_equal
                and tsdf_rep["weighted_share"] > 0.1):
            raise AssertionError(f"sharded TSDF: {tsdf_rep}")
    del vol, views, maps
    gc.collect()
    rep.update(tsdf_south_sharded=tsdf_rep, tsdf_s=time.perf_counter() - t)
    barrier()

    # (c) gspmd against one card, then views_per_step=2 over ("d", "g")
    t = time.perf_counter()
    small_kw = opts.get("small_scene", SMALL_SCENE)
    small = scene_from_arrays(make_scene_arrays(**small_kw), device=dev)
    meshed = small_trainer(small, dev, mesh=mesh)
    m_g = meshed.train_step(1)
    g_g = {f: gathered(getattr(meshed.model, f).grad) for f in FIELDS}
    del meshed
    dg = make_mesh(n, axes=("d", "g"))
    vps = small_trainer(small, dev, mesh=dg, views_per_step=2)
    vps_loss = [float(vps.train_step(it)["loss"]) for it in range(1, 4)]
    del vps
    gspmd = None
    if rank == 0:
        plain = small_trainer(small, dev)
        m_p = plain.train_step(1)
        grad_err = {f: _rel_err(g_g[f], getattr(plain.model, f).grad)
                    for f in FIELDS}
        loss_rel = abs(float(m_g["loss"]) - float(m_p["loss"])) \
            / abs(float(m_p["loss"]))
        del plain
        one_vps = small_trainer(small, dev, views_per_step=2)
        one_vps_loss = [float(one_vps.train_step(it)["loss"])
                        for it in range(1, 4)]
        del one_vps
        vps_rel = [abs(a - b) / abs(b) for a, b in zip(vps_loss,
                                                       one_vps_loss)]
        gspmd = dict(width=small_kw["width"], loss_rel_diff=loss_rel,
                     grad_max_rel_err=grad_err,
                     views_per_step_2_mesh=dict(zip(dg.mesh_dim_names,
                                                    dg.shape)),
                     views_per_step_2_losses=vps_loss,
                     one_card_views_per_step_2_losses=one_vps_loss,
                     views_per_step_2_loss_rel_diff=vps_rel)
        if not (loss_rel <= 1e-6 and max(grad_err.values()) <= K2_ROW_TOL
                and max(vps_rel) <= 1e-6):
            raise AssertionError(f"gspmd at {n} ranks against one card: "
                                 f"{gspmd}")
    rep.update(gspmd=gspmd, gspmd_s=time.perf_counter() - t,
               rank_s=time.perf_counter() - t_rank)
    barrier()
    return rep


def _multicard_entry(rank, n, url, tmp, scene_path, opts):
    """A rank of phase_multicard: NCCL on card `rank`, multicard_rank, its
    report written to tmp/rank<rank>.json."""
    import torch.distributed as dist

    from eogs2_tpu_torch.parallel.distributed import init_distributed

    init_distributed(url, n, rank, device="cuda")
    try:
        rep = multicard_rank(rank, n, scene_path, opts)
        with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
            json.dump(rep, f)
    finally:
        dist.destroy_process_group()


def phase_multicard_cli(device, n, width=256, n_views=9, scale=25.0,
                        iterations=20, tile_capacity=4096,
                        max_tiles_per_gaussian=1024):
    """The CLI's group options at n ranks, from this process: make-synthetic
    of full-eval-256's scene, train --n-devices n --raster-backend a2a
    --raster-mode fused for `iterations` iterations with a save and a
    checkpoint at the last, render on one device, tsdf --n-devices n,
    eval-dsm of the Nadir and the TSDF DSMs on one device. The run
    directory must hold one PLY and one checkpoint (the coordinator's),
    both MAEs must be finite, and a one-device Trainer.restore of the
    checkpoint must hold the saved (joined) model, bit for bit, with the
    PLY's rows."""
    import tempfile

    import torch

    from eogs2_tpu_torch import cli
    from eogs2_tpu_torch.config import baseogs
    from eogs2_tpu_torch.io.ply import load_gaussians_ply
    from eogs2_tpu_torch.rasterizer import RasterizeConfig
    from eogs2_tpu_torch.scene import load_scene
    from eogs2_tpu_torch.train import Trainer

    dev = ["--device", device.type]
    run = StageRunner(device, cli.main)
    with image_libraries_blocked(), tempfile.TemporaryDirectory() as tmp:
        sdir, runp = os.path.join(tmp, "scene"), os.path.join(tmp, "run")
        run("make_synthetic", [
            "make-synthetic", *dev, "--out", sdir, "--n-views", str(n_views),
            "--width", str(width), "--height", str(width), "--scale",
            str(scale)])
        run("train", [
            "train", *dev, "--scene-dir", sdir, "--model-path", runp,
            "--preset", "baseogs", "--n-devices", str(n),
            "--raster-backend", "a2a", "--raster-mode", "fused",
            "--iterations", str(iterations), "--save-iterations",
            str(iterations), "--checkpoint-every", str(iterations)])
        files = [os.path.relpath(os.path.join(d, f), runp)
                 for d, _, fs in os.walk(runp) for f in fs]
        plys = [f for f in files if f.endswith(".ply")]
        ckpts = [f for f in files if os.path.basename(f).startswith("chkpnt")]
        rargs = ["--scene-dir", sdir, "--model-path", runp,
                 "--tile-capacity", str(tile_capacity),
                 "--max-tiles-per-gaussian", str(max_tiles_per_gaussian)]
        run("render", ["render", *dev, *rargs])
        run("tsdf", ["tsdf", *dev, "--scene-dir", sdir, "--model-path", runp,
                     "--n-devices", str(n)])
        out = os.path.join(runp, "test_opNone", f"ours_{iterations}")
        maes = {}
        for name, pred in (("nadir", os.path.join(out, "dsm", "Nadir.tif")),
                           ("tsdf", os.path.join(out, "tsdf", "dsm.tif"))):
            run(f"eval_dsm_{name}", [
                "eval-dsm", *dev, "--pred", pred, "--gt-heightfield",
                os.path.join(sdir, "gt_heightfield.npy"), "--scale",
                str(scale)])
            maes[name] = json.loads(run.printed[f"eval_dsm_{name}"]
                                    .strip().splitlines()[-1])["mae"]
        # the checkpoint into a one-device Trainer, built as the CLI builds
        # it (the CLI's default seed 1337 for the init cloud)
        ckpt = os.path.join(runp, f"chkpnt{iterations}")
        saved = torch.load(ckpt, map_location="cpu", weights_only=True)
        fresh = Trainer(baseogs(sdir), load_scene(
            sdir, images_msi_path=os.path.join(sdir, "images"),
            load_pan=False, seed=1337, device=device),
            RasterizeConfig(binning_mode="fused"), device=device).setup()
        restored_it = fresh.restore(ckpt)
        alive = saved["aux"]["alive"].numpy()
        ply = load_gaussians_ply(os.path.join(
            runp, "point_cloud", f"iteration_{iterations}",
            "point_cloud.ply"))
        restored = dict(
            iteration=restored_it, adam_step=fresh.step,
            params_equal=all(torch.equal(getattr(fresh.model, f).detach()
                                         .cpu(), saved["params"][f])
                             for f in FIELDS + ("features_rest",)),
            alive_equal=bool(torch.equal(fresh.model.alive.cpu(),
                                         saved["aux"]["alive"])),
            ply_rows_equal=all(np.array_equal(
                ply[f].reshape(int(alive.sum()), -1),
                getattr(fresh.model, f).detach().cpu().numpy()[alive]
                .reshape(int(alive.sum()), -1)) for f in FIELDS))
        del fresh, saved
        gc.collect()
        libs = image_libraries_blocked.loaded()
    rep = dict(stage_s=run.stages, plys=plys, checkpoints=ckpts, maes=maes,
               restored=restored, image_libraries=libs)
    if not (len(plys) == 1 and len(ckpts) == 1
            and all(np.isfinite(v) for v in maes.values())
            and restored["iteration"] == iterations
            and restored["adam_step"] == iterations
            and restored["params_equal"] and restored["alive_equal"]
            and restored["ply_rows_equal"] and not libs):
        raise AssertionError(f"the CLI at {n} ranks: {rep}")
    return rep


def phase_multicard(device, arrays=None, n=MULTICARD_RANKS, warmup=2,
                    timed=10, tsdf_vox=0.5):
    """The multi-device path at n ranks, one card each, over NCCL (cell
    train-1M-1024-a2a-4card). This process builds the scene's arrays (or
    takes phase 5's), writes them once to an .npz in a temporary directory,
    frees its cached device memory and starts n ranks with
    torch.multiprocessing.spawn (a file rendezvous beside the .npz); each
    runs multicard_rank. Then phase_multicard_cli from this process.
    Returns (the ranks' reports, the CLI's report)."""
    import tempfile

    import torch
    import torch.multiprocessing as mp

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        t = time.perf_counter()
        if arrays is None:
            arrays = train_scene_arrays()
        scene_path = os.path.join(tmp, "scene.npz")
        save_scene_arrays(arrays, scene_path)
        del arrays
        write_s = time.perf_counter() - t
        gc.collect()
        torch.cuda.empty_cache()
        opts = dict(warmup=warmup, timed=timed, tsdf_vox=tsdf_vox)
        t = time.perf_counter()
        mp.spawn(_multicard_entry, args=(n, f"file://{tmp}/rendezvous", tmp,
                                         scene_path, opts), nprocs=n)
        ranks_s = time.perf_counter() - t
        reps = []
        for r in range(n):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                reps.append(json.load(f))
    cli_rep = phase_multicard_cli(device, n)
    r0 = reps[0]
    a2a = r0["a2a"]
    log(dict(phase="multicard", cell="train-1M-1024-a2a-4card", ranks=n,
             backend="nccl", cards=[r["rank_card"] for r in reps],
             recipe="baseogs, sun and random camera from iteration 1",
             config="fused, tile_cull; a2a on a ('g',) mesh of "
                    f"{n} ranks, one card each",
             a2a_ms_per_step=a2a["ms_per_step"],
             one_card_fused_ms_per_step=r0["one_card_fused"]["ms_per_step"],
             a2a_over_one_card_fused=r0["one_card_fused"]["a2a_over_fused"],
             peak_mem_gib=[r["a2a"]["peak_mem_gib"] for r in reps],
             dest_cap=a2a["dest_cap"], max_dest_count=a2a["max_dest_count"],
             windows={k: dict(max=v["max"], mean=v["mean"])
                      for k, v in a2a["windows"].items()},
             tile0s=[r["tile0s"] for r in reps],
             band_k1_ms=[r["band"]["k1"]["ms"] for r in reps],
             band_k2_ms=[r["band"]["k2"]["ms"] for r in reps],
             scene_write_s=write_s, ranks_s=ranks_s,
             phase_s=time.perf_counter() - t_phase, **CARD))
    for r in reps:
        log(dict(phase="multicard_rank", **r, **CARD))
    log(dict(phase="multicard_cli", **cli_rep, **CARD))
    return reps, cli_rep


def kernel_entry(name, source, replaces, launches, at, **extra):
    """One kernel's entry of the kernels line: its source, the TPU kernel
    it replaces, its launches on the main path, `extra` (errors, per-step
    sums) and `at`'s time, plain version's time and bound."""
    return dict(name=name, route="cuda",
                source=f"eogs2_tpu_torch/csrc/{source}",
                replaces=f"eogs2_tpu/ops/{replaces}", launches=launches,
                **extra, ms=at["ms"], plain_ms=at["plain_ms"],
                bound_ms=at["bound_ms"], bound_by=at["bound_by"],
                library_ms=None)


def multicard_entries(reps):
    """The four-card run's K1, K2 and K3 numbers for the kernels line: the
    launches of the ranks' main path summed (the timed a2a steps; K3's
    row-payload step), and the slowest rank's band time with that band's
    plain time and bound."""
    def at(key, plain_key=None):
        r = max(reps, key=lambda r: r["band"][key]["ms"])["band"]
        b = r[key]
        return dict(ms=b["ms"], plain_ms=r[plain_key or key]["plain_ms"],
                    bound_ms=b["bound_ms"], bound_by=b["bound_by"],
                    tile0=r["tile0"])

    launches = dict(
        k1=sum(r["a2a"]["k1_launches"] for r in reps),
        k2=sum(r["a2a"]["k2_launches"] for r in reps),
        k3_fwd=sum(r["k3_step_launches"][0] for r in reps),
        k3_bwd=sum(r["k3_step_launches"][1] for r in reps))
    return launches, dict(k1=at("k1"), k2=at("k2"),
                          k3_fwd=at("k3_fwd", "k1"),
                          k3_bwd=at("k3_bwd", "k2"))


def multicard_only(device, card_count):
    """`--multicard`: the build, phase_multicard and a kernels line of the
    four-card path's kernels (K1, K2, K3; K4 is not on it)."""
    log(dict(phase="cards", nvidia_smi=subprocess.run(
        ["nvidia-smi", "--query-gpu=index,name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()))
    phase_build()
    reps, _ = phase_multicard(device)
    launches, at = multicard_entries(reps)
    bands = [r["band"] for r in reps]
    err1 = max(max(b["k1_max_abs_err_ch0_4"], b["k1_max_abs_err_final_t"])
               for b in bands)
    row2 = max(b["k2_max_row_rel_err"] for b in bands)
    abs2 = max(b["k2_max_abs_err"] for b in bands)

    log({"kernels": [
        kernel_entry("fused_blend_fwd (K1)", "fused_blend_fwd.cu",
                     "fused_raster.py:532", launches["k1"], at["k1"],
                     at_band_tile0=at["k1"]["tile0"],
                     max_abs_err=err1, ranks=card_count),
        kernel_entry("fused_blend_bwd (K2)", "fused_blend_bwd.cu",
                     "fused_raster.py:614", launches["k2"], at["k2"],
                     at_band_tile0=at["k2"]["tile0"],
                     max_abs_err=abs2, max_row_rel_err=row2,
                     ranks=card_count),
        kernel_entry("fused_blend_fwd_rows (K3 forward)",
                     "fused_blend_fwd.cu", "fused_raster.py:236",
                     launches["k3_fwd"], at["k3_fwd"],
                     at_band_tile0=at["k3_fwd"]["tile0"], max_abs_err=err1,
                     bitwise_equal_k1=all(b["k3_fwd_bitwise_equal_k1"]
                                          for b in bands), ranks=card_count),
        kernel_entry("fused_blend_bwd_rows (K3 backward)",
                     "fused_blend_bwd.cu", "fused_raster.py:317",
                     launches["k3_bwd"], at["k3_bwd"],
                     at_band_tile0=at["k3_bwd"]["tile0"], max_abs_err=abs2,
                     max_row_rel_err=row2,
                     bitwise_equal_k2=all(b["k3_bwd_bitwise_equal_k2"]
                                          for b in bands), ranks=card_count),
    ]})


def main(argv=None) -> int:
    import torch

    argv = sys.argv[1:] if argv is None else list(argv)
    unknown = [a for a in argv if a != "--multicard"]
    if unknown:
        raise SystemExit(f"chip_smoke: unknown arguments {unknown}")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    cards = torch.cuda.device_count()
    if "--multicard" in argv and cards < MULTICARD_RANKS:
        raise RuntimeError(f"chip_smoke --multicard needs {MULTICARD_RANKS} "
                           f"cards; {cards} visible")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import eogs2_tpu_torch  # noqa: F401  (fails outside a checkout)

    line = card_line()
    print(line, flush=True)
    name, limit = (s.strip() for s in line.split(",", 1))
    CARD.update(card=name, power_limit=limit)
    device = torch.device("cuda")
    if "--multicard" in argv:
        multicard_only(device, cards)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": cards}}), flush=True)
        return 0

    # the fused route's phases first, in the order and state they had
    # before the dense routes were added, so their times stay comparable
    phase_build()
    phase_k1_small(device)
    k2_small_err = phase_k2_small(device)
    (per_render, serve_launches, serve_emit, emission, serve_prep,
     prep) = phase_serve(device)
    scene, scene_s, arrays = train_scene(device)
    (k2_at, k1_at, k1_launches, k2_launches, train_emit, captured,
     tr, train_prep) = phase_train(device, scene, scene_s)
    k2 = k2_at["main"]
    k3, k3_fwd, k3_bwd, k3_launches = phase_k3_at_train_shape(
        device, captured, tr, k1_at["main"], k2)
    del captured, tr
    gc.collect()  # the trainer's reference cycles hold device memory
    tr = phase_repeatable_step(device, scene)
    resample_ab(tr, 2, "fused")
    del tr
    gc.collect()
    k3_small_err = phase_k3_small(device)
    k4_small = phase_k4_small(device)
    phase_resample(device)
    k4_at, k4f_at, k4b_at, k4f_launches, k4b_launches = phase_train_fast(
        device, scene)
    gc.collect()
    recipe_k1, recipe_k2 = phase_recipe(device, scene, arrays.heightfield)
    gc.collect()
    cli_k1, cli_k2 = phase_cli(device, scene)
    del scene
    gc.collect()
    (eplus_k1, eplus_k2, eplus_k1_rep, eplus_k2_rep,
     dual_prep) = phase_eogsplus(device, arrays)
    gc.collect()
    k4_serve_launches, k4_serve, k4_serve_at = phase_serve_dense(device)
    full_k1, full_k2, full_k1_rep, full_k2_rep = phase_full_eval(device)
    phase_safe_small(device)
    bands, a2a, k3_a2a = phase_multidevice(device, arrays)
    gc.collect()
    four = dict(k1=0, k2=0, k3_fwd=0, k3_bwd=0)
    multicard = {}
    if cards >= MULTICARD_RANKS:
        reps, _ = phase_multicard(device, arrays)
        four, at = multicard_entries(reps)
        multicard = {k: dict(four_card_launches=four[k],
                             four_card_band_ms=at[k]["ms"],
                             four_card_band_tile0=at[k]["tile0"])
                     for k in four}
    else:
        print(f"phase_multicard needs {MULTICARD_RANKS} cards; {cards} "
              f"visible: not run", flush=True)
    del arrays
    gc.collect()
    tile0 = dict(
        tile0_bands=[(b["tile0"], b["tiles"]) for b in bands],
        tile0_k1_max_abs_err=max(max(b["k1_max_abs_err_ch0_4"],
                                     b["k1_max_abs_err_final_t"])
                                 for b in bands),
        tile0_k2_max_row_rel_err=max(b["k2_max_row_rel_err"] for b in bands),
        a2a_step_launches=a2a["k1_launches"])

    view = per_render["view"]

    def per_step(at):  # a training step's three renders
        return dict(train_step_ms={k: r["ms"] for k, r in at.items()},
                    train_step_bound_ms={k: r["bound_ms"]
                                         for k, r in at.items()})

    emit = emission["view"]
    prep_view = prep["view"]
    log({"kernels": [
        dict(name="preprocess (forward and backward kernels)", route="cuda",
             source="eogs2_tpu_torch/csrc/preprocess.cu",
             replaces=None,  # XLA ops in JAX (ops/projection.py)
             launches=dict(forward=serve_prep + train_prep[0] + dual_prep[0],
                           backward=train_prep[1] + dual_prep[1]),
             bit_equal_conic_opacity_radius=all(
                 all(r["bit_equal"].values()) for r in prep.values()),
             max_ulps_mean2d_depth=max(max(r["max_ulps"].values())
                                       for r in prep.values()),
             bwd_max_gap=max(max(*r["bwd_gap_autograd"].values(),
                                 *r["bwd_gap_twin"].values())
                             for r in prep.values()),
             ms=prep_view["fwd_ms"], plain_ms=prep_view["plain_fwd_ms"],
             bound_ms=prep_view["fwd_bound_ms"], bound_by="bytes",
             library_ms=None,
             backward=dict(ms=prep_view["bwd_ms"],
                           plain_fwd_bwd_ms=prep_view["plain_fwd_bwd_ms"],
                           bound_ms=prep_view["bwd_bound_ms"],
                           bound_by="bytes"),
             at_main_shape={k: {key: r[key] for key in (
                 "fwd_ms", "bwd_ms", "plain_fwd_ms", "plain_fwd_bwd_ms",
                 "fwd_bound_ms", "bwd_bound_ms")} for k, r in prep.items()}),
        dict(name="emit_pairs (count and write passes)", route="cuda",
             source="eogs2_tpu_torch/csrc/emit_pairs.cu",
             replaces=None,  # XLA ops in JAX (pair_pipeline._tier_keys*)
             launches=serve_emit + train_emit,
             bit_equal=all(all(r["bit_equal"].values())
                           for r in emission.values()),
             ms=emit["ms"], plain_ms=emit["plain_ms"],
             bound_ms=emit["bound_ms"], bound_by=emit["bound_by"],
             library_ms=None,
             at_serve_shape={k: dict(ms=r["ms"], plain_ms=r["plain_ms"],
                                     bound_ms=r["bound_ms"])
                             for k, r in emission.items()}),
        kernel_entry("fused_blend_fwd (K1)", "fused_blend_fwd.cu",
              "fused_raster.py:532", serve_launches + k1_launches
              + recipe_k1 + cli_k1 + eplus_k1 + full_k1
              + a2a["k1_launches"] + four["k1"], view,
              max_abs_err=max(max(r["max_abs_err_ch0_4"],
                                  r["max_abs_err_final_t"])
                              for r in (*per_render.values(),
                                        *k1_at.values(), eplus_k1_rep,
                                        full_k1_rep)),
              n_contrib_mismatches=sum(r["n_contrib_mismatches"]
                                       for r in (*per_render.values(),
                                                 *k1_at.values(),
                                                 eplus_k1_rep, full_k1_rep)),
              **per_step(k1_at), **tile0, **multicard.get("k1", {})),
        kernel_entry("fused_blend_bwd (K2)", "fused_blend_bwd.cu",
              "fused_raster.py:614", k2_launches + recipe_k2 + cli_k2
              + eplus_k2 + full_k2 + a2a["k2_launches"] + four["k2"], k2,
              max_abs_err=max(r["max_abs_err"]
                              for r in (*k2_at.values(), eplus_k2_rep,
                                        full_k2_rep)),
              max_row_rel_err=max(k2_small_err, *(r["max_row_rel_err"]
                                                  for r in (*k2_at.values(),
                                                            eplus_k2_rep,
                                                            full_k2_rep))),
              **per_step(k2_at), **tile0, **multicard.get("k2", {})),
        kernel_entry("fused_blend_fwd_rows (K3 forward)",
              "fused_blend_fwd.cu", "fused_raster.py:236",
              k3_launches["k3_fwd"] + k3_a2a[0] + four["k3_fwd"], k3_fwd,
              max_abs_err=max(k3["max_abs_err_ch0_4"],
                              k3["max_abs_err_final_t"], k3_small_err),
              bitwise_equal_k1=k3["fwd_bitwise_equal_k1"]
              and all(b["k3_fwd_bitwise_equal_k1"] for b in bands),
              tile0_bands=tile0["tile0_bands"], a2a_step_launches=k3_a2a[0],
              **multicard.get("k3_fwd", {})),
        kernel_entry("fused_blend_bwd_rows (K3 backward)",
              "fused_blend_bwd.cu", "fused_raster.py:317",
              k3_launches["k3_bwd"] + k3_a2a[1] + four["k3_bwd"], k3_bwd,
              max_abs_err=k2["max_abs_err"],
              max_row_rel_err=k2["max_row_rel_err"],
              bitwise_equal_k2=k3["bwd_bitwise_equal_k2"]
              and all(b["k3_bwd_bitwise_equal_k2"] for b in bands),
              tile0_bands=tile0["tile0_bands"], a2a_step_launches=k3_a2a[1],
              **multicard.get("k3_bwd", {})),
        kernel_entry("blend_forward (K4 forward)", "blend_tiles_fwd.cu",
              "blend_pallas.py:134", k4f_launches + k4_serve_launches,
              k4f_at["main"],
              max_abs_err=max(k4_small["max_abs_err_ch0_4"],
                              k4_small["max_abs_err_final_t"],
                              k4_serve["max_abs_err_ch0_4"],
                              k4_serve["max_abs_err_final_t"],
                              *(max(r["max_abs_err_ch0_4"],
                                    r["max_abs_err_final_t"])
                                for r in k4_at.values())),
              n_contrib_mismatches=k4_serve["n_contrib_mismatches"]
              + sum(r["n_contrib_mismatches"] for r in k4_at.values()),
              **per_step(k4f_at),
              serve_ms={k: r["ms"] for k, r in k4_serve_at.items()},
              serve_bound_ms={k: r["bound_ms"]
                              for k, r in k4_serve_at.items()}),
        kernel_entry("blend_backward (K4 backward)", "blend_tiles_bwd.cu",
              "blend_pallas.py:194", k4b_launches, k4b_at["main"],
              max_abs_err=max(r["bwd_max_abs_err"] for r in k4_at.values()),
              max_row_rel_err=max(k4_small["bwd_max_row_rel_err"],
                                  *(r["bwd_max_row_rel_err"]
                                    for r in k4_at.values())),
              **per_step(k4b_at)),
    ]})
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
