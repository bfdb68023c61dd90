#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (eogs2_tpu_torch) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA Hopper card and
the CUDA toolkit. It builds every kernel from the sources in the checkout,
holds each against its plain PyTorch version on the card, drives the serving
path at full width and checks what comes out. Every phase prints one JSON
line; any failure raises, so the exit code is non-zero and the final
``{"ok": true, ...}`` line is never printed. Without a CUDA device it exits
with code 1 before doing anything.

Phases:
  1. card name and power limit (nvidia-smi), kernel build time;
  2. K1 (csrc/fused_blend_fwd.cu) against fused_blend_fwd_plain on three
     256x256 scenes of 20k seeded Gaussians — altitudes of both signs, the
     same with tile_cull, and a dense scene whose pixels saturate (the early
     exit runs) — channels 0-4 within atol 2e-4 and final_T within 2e-5
     (tests/test_golden.py's tolerances: pairs at the 1/255 and T_EPS
     edges); plus a 128x128 fused render against the dense O(N*P) oracle
     (reference_rasterize), image and final_T within atol 5e-5;
  3. the serving path at full width: 1,000,000 seeded Gaussians on a
     synthetic heightfield, a 1024x1024 view with its sun model (the sun
     render is 2048x2048) through render_view_full with sun and shading,
     then nadir_dsm; K1's launch counts over that run, its median time of 3
     runs after one warm-up, peak memory, the outputs checked; one profiled
     run of each entry point (device time by kernel, device busy share);
     K1 against its plain version at each of the three renders' exact
     inputs, with its time, the plain version's and its bound;
  4. the kernel table line, then the last line.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_FP32_FLOPS = 67e12  # FP32 outside the tensor cores, H100 SXM
ATOL_CH, ATOL_T = 2e-4, 2e-5

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
    if not (err_ch <= ATOL_CH and err_t <= ATOL_T and torch.isfinite(k).all()):
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


def k1_work(sp, grid_x, chunk_elems=1 << 25):
    """What this K1 call's data needs, counted with fused_blend_fwd_plain's
    arithmetic: each pixel evaluates its tile's pairs front to back up to and
    including the pair at which it stops (all of them when it never
    saturates) and composites its kept live pairs; each tile reads its pairs
    up to its pixels' deepest stop. Returns (evaluations, composites, pairs
    read)."""
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
        ids = torch.arange(t0, t1, device=dev)
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


def k1_bound(sp, grid_x):
    """Least time the card needs for this K1 call: the larger of the bytes
    this data makes it move (the payload up to each tile's deepest stop, the
    tile ranges, out8) over the HBM rate and its FP32 operations over the
    FP32 peak."""
    evals, comps, read = k1_work(sp, grid_x)
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


# ----------------------------------------------------------------------------
# phases
# ----------------------------------------------------------------------------


def phase_build():
    from eogs2_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    names = cuda_build.build_all()
    for name in names:
        cuda_build.load(name)
    log(dict(phase="build", kernels=names,
             seconds=time.perf_counter() - t0,
             ptxas={n: cuda_build.build_logs.get(n, "cached").strip()[-600:]
                    for n in names}, **CARD))


def phase_k1_small(device):
    import torch

    from eogs2_tpu_torch.rasterizer import (RasterizeConfig, rasterize,
                                            reference_rasterize)

    w = 256
    scenes = {
        "both_signs": (random_scene(20000, w, seed=1), False),
        "both_signs_tile_cull": (random_scene(20000, w, seed=1), True),
        "dense_saturating": (random_scene(20000, w, seed=2,
                                          scale_px=(2.0, 6.0),
                                          opac=(0.5, 0.99)), True),
    }
    for name, (arrs, cull) in scenes.items():
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
    profiler's own cost included), and the top kernels by device time."""
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
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows)
    return dict(wall_ms=wall_ms, device_ms=device_ms,
                device_busy_share=device_ms / wall_ms,
                kernels=[dict(name=k[:80], ms=ms, calls=c)
                         for k, ms, c in rows[:top]])


def phase_serve(device, n=1_000_000, width=1024):
    import torch

    from eogs2_tpu_torch.ops.fused_raster import (fused_blend_fwd,
                                                  fused_blend_fwd_plain)
    from eogs2_tpu_torch.pipeline import nadir_dsm, render_view_full
    from eogs2_tpu_torch.rasterizer import RasterizeConfig
    from eogs2_tpu_torch.renderer import gaussian_features

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
    out = rvf()
    torch.cuda.synchronize()
    launches_rvf = fused_blend_fwd.launches
    fused_blend_fwd.launches = 0
    profile, dsm, nout = nadir()
    torch.cuda.synchronize()
    launches_nadir = fused_blend_fwd.launches
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    if launches_rvf != 2 or launches_nadir != 1:
        raise AssertionError(f"K1 launches: render_view_full {launches_rvf} "
                             f"(want 2), nadir_dsm {launches_nadir} (want 1)")

    def median_ms(fn):
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        return statistics.median(times), times

    rvf_ms, rvf_all = median_ms(rvf)
    nadir_ms, nadir_all = median_ms(nadir)
    for name, fn in (("render_view_full", rvf), ("nadir_dsm", nadir)):
        log(dict(phase="serve_profile", entry_point=name, **profile_run(fn),
                 **CARD))

    # ---- output checks --------------------------------------------------
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
    log(dict(phase="serve", gaussians=n, width=width, height=width,
             sun_width=2 * width, config="fused, eogs_features",
             setup_s=setup_s,
             render_view_full_ms=rvf_ms, render_view_full_runs_ms=rvf_all,
             nadir_dsm_ms=nadir_ms, nadir_dsm_runs_ms=nadir_all,
             peak_mem_gib=peak_gib, k1_launches_render_view_full=launches_rvf,
             k1_launches_nadir_dsm=launches_nadir,
             dsm_shape=list(cells.shape), dsm_finite_share=finite_share,
             dsm_height_range=[float(h.min()), float(h.max())],
             dsm_height_bounds=[lo, hi], **CARD))

    # ---- K1 at the three renders' exact inputs --------------------------
    @torch.no_grad()
    def render_inputs(cam, w):
        feats = gaussian_features(model, cam)
        return sorted_inputs(model.xyz, model.get_scaling(), model.rotation,
                             model.get_opacity(), feats,
                             cam.resize_canvas(w, w).affine, w, w, eogs=True)

    sun_cam, _ = view.sun_camera(f=2)
    renders = {"view": (view, width), "sun": (sun_cam, 2 * width),
               "nadir": (scene.test_views[0].camera, width)}
    per_render = {}
    for name, (cam, w) in renders.items():
        sp = render_inputs(cam, w)
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
    return per_render, launches_rvf + launches_nadir


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import eogs2_tpu_torch  # noqa: F401  (fails outside a checkout)

    line = card_line()
    print(line, flush=True)
    name, limit = (s.strip() for s in line.split(",", 1))
    CARD.update(card=name, power_limit=limit)
    device = torch.device("cuda")

    phase_build()
    phase_k1_small(device)
    per_render, launches = phase_serve(device)

    view = per_render["view"]
    log({"kernels": [{
        "name": "fused_blend_fwd",
        "route": "cuda",
        "source": "eogs2_tpu_torch/csrc/fused_blend_fwd.cu",
        "replaces": "eogs2_tpu/ops/fused_raster.py:532",
        "launches": launches,
        "max_abs_err": max(max(r["max_abs_err_ch0_4"],
                               r["max_abs_err_final_t"])
                           for r in per_render.values()),
        "ms": view["ms"],
        "plain_ms": view["plain_ms"],
        "bound_ms": view["bound_ms"],
        "bound_by": view["bound_by"],
        "library_ms": None,
    }]})
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
