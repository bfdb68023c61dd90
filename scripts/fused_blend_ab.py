#!/usr/bin/env python3
"""K1 and K2 of the port's fused route, built from two source trees and
timed against each other in one process on one card.

    python3 scripts/fused_blend_ab.py [--parent DIR] [--out FILE]

Run from the root of a checkout of the PyTorch/CUDA port on a machine with
an NVIDIA Hopper card and the CUDA toolkit. ``--parent`` names the root of
another checkout (for example ``git archive`` of the parent commit unpacked
in an ignored directory); its ``eogs2_tpu_torch/csrc/fused_blend_{fwd,bwd}.cu``
are built with this checkout's nvcc flags and, since the C interface is the
same, launched through this checkout's wrappers in place of its kernels.
Without ``--parent`` only this checkout's kernels are timed.

  1. Inputs: one step of chip_smoke.py's train-1M-1024 cell (the scene of
     scripts/train_scale.py at scale 142, baseogs with the sun and the
     random camera, fused with tile_cull), captured at its three renders
     (main, sun 2048^2, random camera) after two warm-up steps, and the
     serve-1M-1024 cell's three K1 renders (view, sun, Nadir).
  2. Both builds of K1 at the six renders and of K2 at the three training
     renders, in turns (parent, this tree, this tree, parent), 10 launches
     each timed by CUDA events after one warm-up;
     K1's final_T and n_contrib against this tree's bit for bit and its
     channels 0-4 within 2e-4, K2's rows against this tree's (max error
     over the row's largest value), each run twice and compared bit for
     bit.
  3. With --parent: the fused training step, render_view_full and
     nadir_dsm with the parent's kernels and with this tree's, interleaved
     one call at a time (parent, this, this, parent, five times: 10 calls
     of each, medians), and each build's peak memory over its steps. In
     every turn K2 runs once more at the main render's inputs and must give
     that build's bits from step 2, which shows whose kernels the turn ran.
     Per round, the change's two calls against the parent's two: the
     difference of the means, and the parent's own spread (the larger
     minus the smaller of its two calls), the yardstick PERF.md section 2
     states for a later change.

Prints one JSON line per measurement and writes them all, with the card's
name and power limit, to --out (default output/fused_blend_ab.json, an
ignored directory of the checkout).
Exits with code 1 without a CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

KERNELS = ("fused_blend_fwd", "fused_blend_bwd")
RECORDS = []


def log(obj):
    obj = dict(obj, **cs.CARD)
    RECORDS.append(obj)
    cs.log(obj)


@contextlib.contextmanager
def kernels_from(libs):
    """Within the block the wrappers launch the given libraries ({source
    name: CDLL}): cuda_build caches the package's build of each source under
    its name, and the wrappers look it up at every launch (cuda_build.entry;
    end_to_end checks it by the bits of K2)."""
    from eogs2_tpu_torch.ops import cuda_build

    saved = {k: cuda_build._libs.get(k) for k in libs}
    cuda_build._libs.update(libs)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                cuda_build._libs.pop(k)
            else:
                cuda_build._libs[k] = v


def build(parent_csrc):
    """Build everything in parallel: {build name: {source name: CDLL}}."""
    from eogs2_tpu_torch.ops import cuda_build

    builds = {"this": [(k,) for k in KERNELS]}
    if parent_csrc:
        builds["parent"] = [(k, parent_csrc) for k in KERNELS]
    t0 = time.perf_counter()
    cuda_build.build_all([b for bs in builds.values() for b in bs])
    libs = {name: {b[0]: cuda_build.load(*b) for b in bs}
            for name, bs in builds.items()}
    regs = {}
    for name, bs in builds.items():
        for b in bs:
            text = cuda_build.build_logs.get(cuda_build._key(*b), "cached")
            regs[f"{name}:{b[0]}"] = [ln.strip() for ln in text.splitlines()
                                      if "registers" in ln]
    log(dict(phase="ab_build", seconds=time.perf_counter() - t0,
             ptxas=regs))
    return libs


def train_inputs(device):
    """(trainer, {render: K2 inputs}) after two warm-up steps."""
    import torch

    from eogs2_tpu_torch.rasterizer import RasterizeConfig
    from eogs2_tpu_torch.train import Trainer

    scene, _ = cs.train_scene(device)
    tr = Trainer(cs.train_recipe(1000), scene,
                 RasterizeConfig(binning_mode="fused", tile_cull=True),
                 device=device).setup()
    tr.train(2, progress=False)
    with cs.capture_blend_calls() as cap:
        tr.train_step(3)
        torch.cuda.synchronize()
    bwd = {c[0].data_ptr(): c for c in cap.bwd_calls}
    calls = [bwd[p.data_ptr()] for p in cap.fwd_pays]
    return tr, dict(zip(cs.TRAIN_RENDERS, calls))


def row_err(got, want):
    scale = want.abs().amax(dim=1)
    live = scale > 0
    err = (got - want).abs().amax(dim=1) / scale.clamp_min(1e-30)
    return float(err[live].max()) if bool(live.any()) else 0.0


def time_kernels(libs, order, k1_inputs, k2_inputs):
    """K1 and K2 of every build in `order`, then again in reverse order.
    Returns the checks that failed and each build's K2 output at the main
    render."""
    import torch

    from eogs2_tpu_torch.ops.fused_raster import (fused_blend_bwd,
                                                  fused_blend_fwd)

    def k1(a):
        return fused_blend_fwd(a[0], a[1], a[2], a[-1])

    def k2(a):
        return fused_blend_bwd(*a)

    with kernels_from(libs["this"]):
        ref1 = {r: k1(a) for r, a in k1_inputs.items()}
        ref2 = {r: k2(a) for r, a in k2_inputs.items()}
    times, checks, k2_main = {}, {}, {}
    for lib in order + order[::-1]:
        with kernels_from(libs[lib]):
            for kern, inputs, fn in (("k1", k1_inputs, k1),
                                     ("k2", k2_inputs, k2)):
                for render, a in inputs.items():
                    ms = cs.time_cuda(lambda: fn(a), 10)
                    times.setdefault((lib, kern, render), []).append(ms)
                    if (lib, kern, render) in checks:
                        continue
                    out, again = fn(a), fn(a)
                    torch.cuda.synchronize()
                    ref = (ref1 if kern == "k1" else ref2)[render]
                    c = dict(bitwise_equal_this=bool(torch.equal(out, ref)),
                             bitwise_deterministic=bool(torch.equal(out,
                                                                    again)))
                    if kern == "k2" and render == "main":
                        k2_main[lib] = out
                    if kern == "k1":
                        c.update(decisions_equal_this=bool(torch.equal(
                            out[..., 5:], ref[..., 5:])),
                            max_abs_err_ch0_4_vs_this=float(
                                (out[..., :5] - ref[..., :5]).abs().max()))
                    else:
                        c.update(row_err_vs_this=row_err(out, ref))
                    checks[(lib, kern, render)] = c
    for (lib, kern, render), ms in times.items():
        log(dict(phase="ab_kernel", build=lib, kernel=kern, render=render,
                 ms=statistics.mean(ms), ms_each_turn=ms,
                 **checks[(lib, kern, render)]))
    sums = {}
    for (lib, kern, render), ms in times.items():
        if render in cs.TRAIN_RENDERS:
            key = f"{kern}_train_step_ms"
            sums.setdefault(lib, {}).setdefault(key, 0.0)
            sums[lib][key] += statistics.mean(ms)
    for lib, s in sums.items():
        log(dict(phase="ab_kernel_step_sum", build=lib, **s))
    bad = {k: c for k, c in checks.items()
           if not c["bitwise_deterministic"]
           or (k[1] == "k1" and not (c["decisions_equal_this"] and
                                     c["max_abs_err_ch0_4_vs_this"]
                                     <= cs.ATOL_CH))
           or (k[1] == "k2" and c["row_err_vs_this"] > cs.K2_ROW_TOL)}
    return bad, k2_main


def end_to_end(libs, tr, model, view, scene, shading, k2_probe, k2_main,
               rounds=5):
    """The fused step, render_view_full and nadir_dsm with the parent's
    kernels and with this tree's, interleaved one call at a time (parent,
    this, this, parent, ...) so that both see the same training state.
    In every turn K2 runs at `k2_probe` (the main render's inputs) and must
    give k2_main[build]. Returns the turns whose K2 gave other bits."""
    import torch

    from eogs2_tpu_torch.ops.fused_raster import fused_blend_bwd
    from eogs2_tpu_torch.pipeline import nadir_dsm, render_view_full
    from eogs2_tpu_torch.rasterizer import RasterizeConfig

    cfg = RasterizeConfig(binning_mode="fused", eogs_features=True)
    turns = ("parent", "this", "this", "parent") * rounds
    it = 10
    for lib in ("parent", "this"):  # warm-up
        with kernels_from(libs[lib]):
            tr.train_step(it)
            it += 1
    res = {lib: dict(step=[], peak=[], rvf=[], nadir=[]) for lib in turns}
    wrong = []
    for i, lib in enumerate(turns):
        with kernels_from(libs[lib]):
            if not torch.equal(fused_blend_bwd(*k2_probe), k2_main[lib]):
                wrong.append((i, lib))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            tr.train_step(it)
            torch.cuda.synchronize()
            res[lib]["step"].append((time.perf_counter() - t) * 1e3)
            res[lib]["peak"].append(torch.cuda.max_memory_allocated() / 2**30)
            it += 1
            res[lib]["rvf"].append(cs.median_ms(
                lambda: render_view_full(model, view, cfg, shading=shading),
                1)[0])
            res[lib]["nadir"].append(cs.median_ms(
                lambda: nadir_dsm(model, scene, cfg), 1)[0])
    for lib, r in res.items():
        log(dict(phase="ab_end_to_end", build=lib,
                 fused_step_ms=statistics.median(r["step"]),
                 fused_step_all_ms=r["step"],
                 train_peak_mem_gib=max(r["peak"]),
                 render_view_full_ms=statistics.median(r["rvf"]),
                 render_view_full_all_ms=r["rvf"],
                 nadir_dsm_ms=statistics.median(r["nadir"]),
                 nadir_dsm_all_ms=r["nadir"]))
    # per round (parent, this, this, parent): this tree's mean less the
    # parent's, and the parent's own spread within the round
    paired = {}
    for key, name in (("step", "fused_step"), ("rvf", "render_view_full"),
                      ("nadir", "nadir_dsm")):
        p, t = res["parent"][key], res["this"][key]
        paired[name + "_diff_ms"] = [(t[2 * r] + t[2 * r + 1] -
                                      p[2 * r] - p[2 * r + 1]) / 2
                                     for r in range(rounds)]
        paired[name + "_parent_spread_ms"] = [abs(p[2 * r] - p[2 * r + 1])
                                              for r in range(rounds)]
    log(dict(phase="ab_paired", rounds=rounds, **paired,
             k2_builds_differ=not torch.equal(k2_main["parent"],
                                              k2_main["this"]),
             k2_wrong_turns=wrong))
    return wrong


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="root of the checkout to compare with")
    ap.add_argument("--out", default=os.path.join(ROOT, "output",
                                                  "fused_blend_ab.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("fused_blend_ab: no CUDA device; nothing was run",
              file=sys.stderr)
        return 1
    line = cs.card_line()
    print(line, flush=True)
    name, limit = (s.strip() for s in line.split(",", 1))
    cs.CARD.update(card=name, power_limit=limit)
    device = torch.device("cuda")
    parent_csrc = (os.path.join(os.path.abspath(args.parent),
                                "eogs2_tpu_torch", "csrc")
                   if args.parent else None)

    libs = build(parent_csrc)
    tr, train_calls = train_inputs(device)
    model, view, scene, shading = cs.serve_scene(1_000_000, 1024, seed=0,
                                                 device=device)
    k1_inputs = {r: c[:3] + (c[-1],) for r, c in train_calls.items()}
    for r, (cam, w) in cs.serve_renders(view, scene, 1024).items():
        sp = cs.serve_render_inputs(model, cam, w)
        k1_inputs["serve_" + r] = (sp.pay, sp.tstart, sp.cnt, w // 16)
    order = (["parent"] if parent_csrc else []) + ["this"]
    bad, k2_main = time_kernels(libs, order, k1_inputs, train_calls)
    k2_probe = train_calls["main"]
    del k1_inputs, train_calls
    if parent_csrc:
        wrong = end_to_end(libs, tr, model, view, scene, shading, k2_probe,
                           k2_main)
        if wrong:
            bad["end_to_end_k2_not_the_turns_build"] = wrong
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(RECORDS, f, indent=1)
    if bad:
        print(f"fused_blend_ab: outputs disagree: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
