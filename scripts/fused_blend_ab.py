#!/usr/bin/env python3
"""The port's blend kernels (K1 and K2 of the fused route, K4 of the dense
routes) built from two source trees and timed against each other in one
process on one card.

    python3 scripts/fused_blend_ab.py [--parent DIR] [--variant NAME=DIR ...]
                                      [--out FILE]

Run from the root of a checkout of the PyTorch/CUDA port on a machine with
an NVIDIA Hopper card and the CUDA toolkit. ``--parent`` names the root of
another checkout (for example ``git archive`` of the parent commit unpacked
in an ignored directory); its ``eogs2_tpu_torch/csrc/fused_blend_{fwd,bwd}.cu``
and ``blend_tiles_{fwd,bwd}.cu`` are built with this checkout's nvcc flags
and, since the C interfaces are the same, launched through this checkout's
wrappers in place of its kernels. Without ``--parent`` only this
checkout's kernels are timed. Each ``--variant`` names another checkout
(for example a copy of this one with one change to its kernels) whose
kernels are built and timed in step 2 beside the others, under NAME.

  1. Inputs: the train-1M-1024 scene of chip_smoke.py (scripts/train_scale.py
     at scale 142, baseogs with the sun and the random camera) and the
     serve-1M-1024 scene. Fused route: one step with tile_cull, captured at
     its three renders (main, sun 2048^2, random camera) after two warm-up
     steps, and the serving's three K1 renders (view, sun, Nadir). Dense
     routes: one step of the CLI's `fast` route (sorted + use_pallas, K
     bucketed from a sizing step) captured at its three renders after two
     warm-up steps, and the three K4 tables of `gather` + K4 serving.
  2. Every build of each kernel at each of its captured renders, one render
     after another, in turns (parent, this tree, the variants, then the same
     in reverse), 10 launches each timed by CUDA events after one warm-up.
     K1's and K4 forward's final_T and n_contrib against this tree's bit
     for bit and their channels 0-4 within 2e-4;
     K2's and K4 backward's rows against this tree's (max error over the
     row's largest value, 2e-4); each build run twice and compared bit for
     bit. Per build, each kernel's sum over a training step's renders.
  3. With --parent, for each route: the training step (fused, `fast`),
     render_view_full and nadir_dsm (fused, `gather` + K4) with the
     parent's kernels and with this tree's, interleaved one call at a time
     (parent, this, this, parent, five times: 10 calls of each, medians),
     and each build's peak memory over its steps. In every turn the route's
     backward kernel (K2, K4 backward) runs once more at the main render's
     inputs and must give that build's bits from step 2, which shows whose
     kernels the turn ran. Per round, the change's two calls against the
     parent's two: the difference of the means, and the parent's own spread
     (the larger minus the smaller of its two calls), the yardstick PERF.md
     section 2 states for a later change.

Prints one JSON line per measurement and writes them all, with the card's
name and power limit, to --out (default output/fused_blend_ab.json, an
ignored directory of the checkout).
Exits with code 1 without a CUDA device, or when a check fails.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

KERNELS = ("fused_blend_fwd", "fused_blend_bwd", "blend_tiles_fwd",
           "blend_tiles_bwd")
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
    end_to_end checks it by the backward kernel's bits)."""
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


def build(trees):
    """Build everything in parallel: {build name: {source name: CDLL}};
    trees {build name: checkout root} besides this checkout."""
    from eogs2_tpu_torch.ops import cuda_build

    builds = {"this": [(k,) for k in KERNELS]}
    for name, root in trees.items():
        csrc = os.path.join(os.path.abspath(root), "eogs2_tpu_torch", "csrc")
        builds[name] = [(k, csrc) for k in KERNELS]
    t0 = time.perf_counter()
    cuda_build.build_all([b for bs in builds.values() for b in bs])
    libs = {name: {b[0]: cuda_build.load(*b) for b in bs}
            for name, bs in builds.items()}
    regs = {}
    for name, bs in builds.items():
        for b in bs:
            text = cuda_build.build_logs.get(cuda_build._key(*b), "cached")
            regs[f"{name}:{b[0]}"] = [ln.strip() for ln in text.splitlines()
                                      if "registers" in ln or "spill" in ln]
    log(dict(phase="ab_build", seconds=time.perf_counter() - t0,
             ptxas=regs))
    return libs


def fused_inputs(scene, device):
    """(trainer, {render: K2 inputs}) of the fused route after two warm-up
    steps."""
    import torch

    from eogs2_tpu_torch.rasterizer import RasterizeConfig
    from eogs2_tpu_torch.train import Trainer

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


def fast_inputs(scene, device):
    """(trainer, {render: K4 backward inputs (data, gout, grid_x)}) of the
    `fast` route after the sizing step and two warm-up steps."""
    import torch

    tr, _, _, _ = cs.fast_trainer(scene, device, 1000)
    for it in (2, 3):
        tr.train_step(it)
    with cs.capture_k4_calls() as cap:
        tr.train_step(4)
        torch.cuda.synchronize()
    bwd = {c[0].data_ptr(): c for c in cap.bwd}
    calls = [bwd[d.data_ptr()] for d, _ in cap.fwd]
    return tr, dict(zip(cs.TRAIN_RENDERS, calls))


def dense_serve_tables(model, view, scene, cfg):
    """{render: (table, grid_x)} of K4 forward on `gather` + K4 serving."""
    import torch

    from eogs2_tpu_torch.pipeline import nadir_dsm, render_view_full

    with cs.capture_k4_calls() as cap:
        render_view_full(model, view, cfg)
        nadir_dsm(model, scene, cfg)
        torch.cuda.synchronize()
    return {"serve_" + r: t for r, t in zip(("view", "sun", "nadir"),
                                            cap.fwd)}


def row_err(got, want, rows_dim):
    """The worst row's max |got - want| over its max |want| (rows on
    `rows_dim`, taken one at a time: a K4 table is 8.6 GB at the sun render);
    rows without gradient in `want` are skipped."""
    worst = 0.0
    for r in range(got.shape[rows_dim]):
        g, w = got.select(rows_dim, r), want.select(rows_dim, r)
        scale = float(w.abs().max())
        if scale > 0:
            worst = max(worst, float((g - w).abs().max()) / scale)
    return worst


def fwd_checks(out, ref):
    """K1, K4 forward: decisions (final_T, n_contrib, channel 7) bit for bit,
    channels 0-4 within cs.ATOL_CH."""
    ok_bits = bool((out[..., 5:] == ref[..., 5:]).all())
    err = float((out[..., :5] - ref[..., :5]).abs().max())
    return dict(decisions_equal_this=ok_bits, max_abs_err_ch0_4_vs_this=err,
                ok=ok_bits and err <= cs.ATOL_CH)


def bwd_checks(rows_dim):
    """K2 (rows on dim 0), K4 backward (rows on dim 1): every row within
    cs.K2_ROW_TOL of its largest value."""
    def check(out, ref):
        err = row_err(out, ref, rows_dim)
        return dict(row_err_vs_this=err, ok=err <= cs.K2_ROW_TOL)
    return check


CHECKS = {"k1": fwd_checks, "k2": bwd_checks(0), "k4_fwd": fwd_checks,
          "k4_bwd": bwd_checks(1)}
PROBES = {"fused": "k2", "dense": "k4_bwd"}  # a route's build-proving kernel


def time_kernels(libs, order, cases):
    """cases {(kernel, render): fn launching it once}: each case with every
    build in `order`, then in reverse order, one case after another. Returns
    the checks that failed and each build's output of each route's probe
    kernel at the main render."""
    import torch

    times, checks, probe = {}, {}, {}
    for (kern, render), fn in cases.items():
        with kernels_from(libs["this"]):
            ref = fn()
        for lib in order + order[::-1]:
            key = (lib, kern, render)
            with kernels_from(libs[lib]):
                times.setdefault(key, []).append(cs.time_cuda(fn, 10))
                if key in checks:
                    continue
                out, again = fn(), fn()
                torch.cuda.synchronize()
            checks[key] = dict(
                bitwise_equal_this=bool(torch.equal(out, ref)),
                bitwise_deterministic=bool(torch.equal(out, again)),
                **CHECKS[kern](out, ref))
            if render == "main" and kern in PROBES.values():
                probe.setdefault(lib, {})[kern] = out
            del out, again
        del ref
    for key, ms in times.items():
        log(dict(phase="ab_kernel", build=key[0], kernel=key[1],
                 render=key[2], ms=statistics.mean(ms), ms_each_turn=ms,
                 **checks[key]))
    sums = {}
    for (lib, kern, render), ms in times.items():
        if render in cs.TRAIN_RENDERS:
            s = sums.setdefault(lib, {})
            s[f"{kern}_train_step_ms"] = (s.get(f"{kern}_train_step_ms", 0.0)
                                          + statistics.mean(ms))
    for lib, s in sums.items():
        log(dict(phase="ab_kernel_step_sum", build=lib, **s))
    bad = {k: c for k, c in checks.items()
           if not (c["bitwise_deterministic"] and c["ok"])}
    return bad, probe


def end_to_end(libs, route, step, rvf, nadir, probe_fn, probe_bits,
               rounds=5):
    """The route's training step (`step(it)`), render_view_full and
    nadir_dsm with the parent's kernels and with this tree's, interleaved
    one call at a time (parent, this, this, parent, ...) so that both see
    the same training state. In every turn `probe_fn` (the route's backward
    kernel at the main render's inputs) must give probe_bits[build].
    Returns the turns whose probe gave other bits."""
    import torch

    turns = ("parent", "this", "this", "parent") * rounds
    it = 10
    for lib in ("parent", "this"):  # warm-up
        with kernels_from(libs[lib]):
            step(it)
            it += 1
    res = {lib: dict(step=[], peak=[], rvf=[], nadir=[]) for lib in turns}
    wrong = []
    for i, lib in enumerate(turns):
        with kernels_from(libs[lib]):
            if not torch.equal(probe_fn(), probe_bits[lib]):
                wrong.append((i, lib))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            step(it)
            torch.cuda.synchronize()
            res[lib]["step"].append((time.perf_counter() - t) * 1e3)
            res[lib]["peak"].append(torch.cuda.max_memory_allocated() / 2**30)
            it += 1
            res[lib]["rvf"].append(cs.median_ms(rvf, 1)[0])
            res[lib]["nadir"].append(cs.median_ms(nadir, 1)[0])
    for lib, r in res.items():
        log(dict(phase="ab_end_to_end", route=route, build=lib,
                 step_ms=statistics.median(r["step"]), step_all_ms=r["step"],
                 train_peak_mem_gib=max(r["peak"]),
                 render_view_full_ms=statistics.median(r["rvf"]),
                 render_view_full_all_ms=r["rvf"],
                 nadir_dsm_ms=statistics.median(r["nadir"]),
                 nadir_dsm_all_ms=r["nadir"]))
    # per round (parent, this, this, parent): this tree's mean less the
    # parent's, and the parent's own spread within the round
    paired = {}
    for key, name in (("step", "step"), ("rvf", "render_view_full"),
                      ("nadir", "nadir_dsm")):
        p, t = res["parent"][key], res["this"][key]
        paired[name + "_diff_ms"] = [(t[2 * r] + t[2 * r + 1] -
                                      p[2 * r] - p[2 * r + 1]) / 2
                                     for r in range(rounds)]
        paired[name + "_parent_spread_ms"] = [abs(p[2 * r] - p[2 * r + 1])
                                              for r in range(rounds)]
    log(dict(phase="ab_paired", route=route, rounds=rounds, **paired,
             builds_differ=not torch.equal(probe_bits["parent"],
                                           probe_bits["this"]),
             probe_wrong_turns=wrong))
    return wrong


def run_route(route, libs, order, cases, trainer, probe_case, rvf, nadir):
    """Time the route's kernels, then (with a parent) its end-to-end turns.
    Returns the checks that failed."""
    bad, probe = time_kernels(libs, order, cases)
    cases.clear()  # the captured inputs, but for the probe's
    if "parent" in libs:
        kern = PROBES[route]
        wrong = end_to_end(libs, route, trainer.train_step, rvf, nadir,
                           probe_case, {b: p[kern] for b, p in probe.items()})
        if wrong:
            bad[f"{route}_end_to_end_not_the_turns_build"] = wrong
    return bad


def main() -> int:
    import torch

    from eogs2_tpu_torch.ops.blend_cuda import blend_backward, blend_forward
    from eogs2_tpu_torch.ops.fused_raster import (fused_blend_bwd,
                                                  fused_blend_fwd)
    from eogs2_tpu_torch.pipeline import nadir_dsm, render_view_full
    from eogs2_tpu_torch.rasterizer import RasterizeConfig

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="root of the checkout to compare with")
    ap.add_argument("--variant", action="append", default=[],
                    metavar="NAME=DIR", help="another checkout to time")
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
    trees = dict(v.split("=", 1) for v in args.variant)
    if args.parent:
        trees["parent"] = args.parent
    libs = build(trees)
    order = (["parent"] if args.parent else []) + ["this"] + [
        v for v in trees if v != "parent"]
    scene, _ = cs.train_scene(device)
    model, view, scene_s, shading = cs.serve_scene(1_000_000, 1024, seed=0,
                                                   device=device)

    # the fused route: K1 and K2
    tr, calls = fused_inputs(scene, device)
    cases = {}
    for r, c in calls.items():
        cases["k1", r] = lambda c=c: fused_blend_fwd(c[0], c[1], c[2], c[-1])
        cases["k2", r] = lambda c=c: fused_blend_bwd(*c)
    for r, (cam, w) in cs.serve_renders(view, scene_s, 1024).items():
        sp = cs.serve_render_inputs(model, cam, w)
        cases["k1", "serve_" + r] = (lambda sp=sp, gx=w // 16:
                                     fused_blend_fwd(sp.pay, sp.tstart,
                                                     sp.cnt, gx))
    probe = calls["main"]
    del calls, sp
    cfg = RasterizeConfig(binning_mode="fused", eogs_features=True)
    bad = run_route(
        "fused", libs, order, cases, tr, lambda: fused_blend_bwd(*probe),
        lambda: render_view_full(model, view, cfg, shading=shading),
        lambda: nadir_dsm(model, scene_s, cfg))
    del tr, probe
    gc.collect()  # the trainer's reference cycles hold device memory

    # the dense routes: K4 forward and backward
    tr, calls = fast_inputs(scene, device)
    dense_cfg, _ = cs.dense_serve_cfg(model, view, scene_s, 1024)
    cases = {}
    for r, (data, gout, gx) in calls.items():
        cases["k4_fwd", r] = lambda d=data, gx=gx: blend_forward(d, gx)
        cases["k4_bwd", r] = (lambda d=data, g=gout, gx=gx:
                              blend_backward(d, g, gx))
    for r, (data, gx) in dense_serve_tables(model, view, scene_s,
                                            dense_cfg).items():
        cases["k4_fwd", r] = lambda d=data, gx=gx: blend_forward(d, gx)
    probe = calls["main"]
    del calls, data, gout
    bad.update(run_route(
        "dense", libs, order, cases, tr, lambda: blend_backward(*probe),
        lambda: render_view_full(model, view, dense_cfg, shading=shading),
        lambda: nadir_dsm(model, scene_s, dense_cfg)))

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(RECORDS, f, indent=1)
    if bad:
        print(f"fused_blend_ab: outputs disagree: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
