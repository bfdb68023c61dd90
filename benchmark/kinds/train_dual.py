"""Kind ``train_dual``: the ``train`` kind's closed loop of
``Trainer.train_step`` on a configuration that renders two modalities a
step, the MSI and the PAN camera of one view at their own sizes (mode
``fixed``): six renders a step, the losses summed before one Adam step.

Set-up, the timed window, the traced window and the check are the
``train`` kind's (its ``Loop``, ``leaves``, ``numbers`` and window draw,
imported), on the dual scene of ``benchmark/scene_dual.py`` and against the
dual reference (``benchmark/reference/train_dual.py``). The traced window
counts every render's ``num_pairs`` (the ``train`` kind's ``pairs``) and
splits them by canvas size, so the MSI renders' pairs are read apart from
the PAN's (``pairs_msi``); the work the ``train`` readers ``mfu`` and
``k*_roofline`` count is each modality's three renders, from the
reference's own pair lists (``counts.py``), in the ``train`` kind's form.

Readings (``control.py``): the program against the float32 reference, the
reference in TF32 (the control), and the faults ``half_batch`` and
``pan_average`` (the PAN camera converted by the mean of its colours in
place of the WV3 weights) planted in the reference.
"""

from __future__ import annotations

import time

import torch

from benchmark import counts
from benchmark.common import (Run, free, program_config, program_scene, sync,
                              trainer_seed)
from benchmark.kinds.train import (Loop, leaves, norms, numbers, step_renders,
                                   window_iteration)
from benchmark.reference.render import TILE
from benchmark.reference.train import (GAUSS_LEAVES, SHADING_LEAVES,
                                       cameras_extent, init_start)
from benchmark.reference.train_dual import (MODALITIES, draws_dual,
                                            train_reference_dual)
from benchmark.scene_dual import make_scene_dual
from benchmark.tracing import traced


def dual_setup(cfg, traffic, seed, device):
    """The Trainer on the dual scene after its checked steps, and the
    program's readings of them (the ``train`` kind's ``train_setup``)."""
    from eogs2_tpu_torch.rasterizer import RasterizeConfig
    from eogs2_tpu_torch.train import Trainer

    parts, t = {}, time.perf_counter()
    scene = make_scene_dual(cfg["scene"], cfg["scene"]["seed"], device)
    sync(device)
    parts["scene"], t = time.perf_counter() - t, time.perf_counter()
    tr = Trainer(program_config(cfg, seed), program_scene(scene, device),
                 RasterizeConfig(**cfg["route"]), device=device).setup()
    sync(device)
    parts["trainer"], t = time.perf_counter() - t, time.perf_counter()
    start = {n: p.detach().clone() for n, p, _ in leaves(tr)}
    losses, grad1 = [], {}
    for it in range(1, traffic["checked_steps"] + 1):
        losses.append(tr.train_step(it)["loss"])
        if it == 1:
            grad1 = {n: float(torch.linalg.vector_norm(
                opt.state[p]["exp_avg"] / 0.1)) if "exp_avg" in opt.state[p]
                else 0.0 for n, p, opt in leaves(tr)}
    change = {n: float(torch.linalg.vector_norm(p.detach() - start[n]))
              for n, p, _ in leaves(tr)}
    out = dict(losses=[float(x) for x in losses], first_grad=grad1,
               change=change)
    parts["checked_steps"] = time.perf_counter() - t
    return tr, scene, out, parts


def msi_canvases(cfg):
    """The canvas widths of the MSI camera's renders: the main and random
    camera's, and the sun's at twice the footprint."""
    w = cfg["scene"]["width"] // cfg["scene"]["msi_factor"]
    return {-(-w // TILE) * TILE, -(-2 * w // TILE) * TILE}


def run(cell, cfg, traffic, args, device, t0) -> Run:
    from eogs2_tpu_torch import train as program_train

    check_it = window_iteration(traffic, args.seed)
    if check_it <= traffic["checked_steps"] + traffic["warmup_steps"]:
        raise ValueError("window_check must fall after the warm-up steps")
    tr, scene, out, parts = dual_setup(cfg, traffic, args.seed, device)
    run = Run(program_out={"first": out}, scene=scene, setup_parts=parts)
    loop = Loop(tr, traffic["checked_steps"], check_it)

    t = time.perf_counter()
    for _ in range(traffic["warmup_steps"]):
        loop.step()
    sync(device)
    parts["warmup"] = time.perf_counter() - t
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    run.setup_s = time.perf_counter() - t0
    loop.losses.clear()
    w0 = time.perf_counter()
    while time.perf_counter() - w0 < args.seconds:
        t = time.perf_counter()
        loop.step()
        run.unit_s.append(time.perf_counter() - t)
    sync(device)
    run.window_s = time.perf_counter() - w0
    run.done = len(loop.losses)
    run.failed = int((~torch.isfinite(torch.stack(loop.losses))).sum())
    while loop.kept is None:  # a short window: reach the checked step
        loop.step()

    if args.trace:
        state = {f: getattr(tr.model, f).detach().clone()
                 for f in ("xyz", "scaling", "rotation", "opacity",
                           "features_dc", "alive")}
        first = loop.it + 1
        pairs, real = [], program_train.rasterize

        def counting(*a, **k):  # (canvas width, num_pairs) of each render
            ro = real(*a, **k)
            pairs.append((a[7], ro.num_pairs))
            return ro

        program_train.rasterize = counting
        try:
            with traced(lambda: sync(device)) as trace:
                for _ in range(traffic["traced_steps"]):
                    loop.step()
        finally:
            program_train.rasterize = real
        run.work = dict(state=state, first=first, last=loop.it)
        with traced(lambda: sync(device), host=True) as named:
            for _ in range(traffic["gap_steps"]):
                loop.step()
        trace.gaps = named.gaps
        run.trace, run.traced_units = trace, traffic["traced_steps"]
        msi = msi_canvases(cfg)
        run.counters["pairs"] = float(sum(float(n) for _, n in pairs))
        run.counters["pairs_msi"] = float(sum(
            float(n) for w, n in pairs if w in msi))
    if device.type == "cuda":
        run.memory_peak_bytes = int(torch.cuda.max_memory_allocated(device))
    run.program_out["window"] = loop.window_out()
    del tr, loop
    free(device)
    if args.trace:
        run.work = dual_work(cfg, scene, run.work, args.seed, device)
    return run


def train_views(scene, modality):
    return [m for m in scene.metadatas[modality]
            if m["img"] in scene.train_names]


def reference(cfg, scene, seed, device, iterations, start, precision,
              fault=None):
    """The dual reference's iterations from ``start`` (None: the init) on
    the Trainer's own draws, as norms."""
    mds = {m: train_views(scene, m) for m in MODALITIES}
    images = {"msi": [scene.images[m["img"]] for m in mds["msi"]],
              "pan": [scene.images_pan[m["img"]] for m in mds["pan"]]}
    n_views = len(mds["msi"])
    views, bgs, shears = draws_dual(trainer_seed(seed), n_views,
                                    iterations[-1], device)
    recipe = dict(cfg["recipe"],
                  unsupported_terms_must_be_off=cfg[
                      "unsupported_terms_must_be_off"])
    if start is None:
        start = init_start(scene.init_xyz, scene.init_rgb, recipe, n_views,
                           device)
    else:
        names = GAUSS_LEAVES + SHADING_LEAVES
        start = dict(start, **{k: {n: start[k][n] for n in names}
                               for k in ("leaves", "m", "s2", "t")})
    out = train_reference_dual(mds, images, recipe, iterations, views, bgs,
                               shears, start, cameras_extent(scene.init_xyz),
                               float(scene.init_xyz.shape[0]), precision,
                               fault)
    return dict(losses=out["losses"], first_grad=norms(out["first_grad"]),
                change=norms(out["change"]))


def compare(cfg, traffic, scene, seed, device, first, window,
            precision="fp32", fault=None, refs=None):
    """The ``train`` kind's ``compare`` against the dual reference."""
    n = traffic["checked_steps"]
    r1 = reference(cfg, scene, seed, device, list(range(1, n + 1)), None,
                   precision, fault)
    rw = reference(cfg, scene, seed, device, [window["iteration"]],
                   window["start"], precision, fault)
    if refs is None:
        a, b, c, d = first, r1, window["prog"], rw
    else:
        a, b, c, d = r1, refs[0], rw, refs[1]
    out = numbers(a, b)
    out.update({f"window_{k}": v for k, v in numbers(c, d).items()})
    return out, (r1, rw)


def check(cfg, traffic, run, seed, device):
    return compare(cfg, traffic, run.scene, seed, device,
                   run.program_out["first"], run.program_out["window"])[0]


def readings(cfg, traffic, seed, device):
    """The program against the float32 reference (the lower reading), the
    reference in TF32 in the program's place (the control), and the faults
    half_batch and pan_average planted in the reference, at the first
    steps and at the window's checked step."""
    tr, scene, first, _ = dual_setup(cfg, traffic, seed, device)
    loop = Loop(tr, traffic["checked_steps"],
                window_iteration(traffic, seed))
    while loop.kept is None:
        loop.step()
    window = loop.window_out()
    del tr, loop
    free(device)
    out = {}
    out["program"], refs = compare(cfg, traffic, scene, seed, device, first,
                                   window)
    for name, precision, fault in (("control", "tf32", None),
                                   ("half_batch", "fp32", "half_batch"),
                                   ("pan_average", "fp32", "pan_average")):
        out[name] = compare(cfg, traffic, scene, seed, device, first, window,
                            precision, fault, refs)[0]
    return out


def dual_work(cfg, scene, work, seed, device):
    """Per traced step, the work of its six renders (each modality's main,
    sun and random camera) at the state the traced window started from,
    one count per distinct view; the step's operations with each
    modality's per-pixel terms at its own size and Adam once."""
    mds = {m: train_views(scene, m) for m in MODALITIES}
    views, bgs, shears = draws_dual(trainer_seed(seed), len(mds["msi"]),
                                    work["last"], device)
    extent = cfg["recipe"]["virtual_camera_extent"]
    by_view, steps = {}, []
    for i in range(work["first"], work["last"] + 1):
        v = views[i - 1]
        if v not in by_view:
            by_view[v] = {m: step_renders(work["state"], mds[m][v],
                                          shears[i - 1][j], extent,
                                          bgs[i - 1][j])
                          for j, m in enumerate(MODALITIES)}
        steps.append(by_view[v])
    n_params = sum(int(t.numel()) for k, t in work["state"].items()
                   if k != "alive")
    ops = 0.0
    for s in steps:
        for j, m in enumerate(MODALITIES):
            md = mds[m][0]
            ops += counts.train_step_ops(s[m], n_params if j == 0 else 0,
                                         md["height"], md["width"])
    return dict(steps=[s["msi"] + s["pan"] for s in steps], ops=ops)
