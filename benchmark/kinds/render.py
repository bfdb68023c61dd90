"""Kind ``render``: a closed loop of one caller, each request
``pipeline.render_view_full`` of one of the scene's image views (a fresh
seeded permutation of them per round), its sun model and shading, every
output copied to the host. The served model is made on the device from the
seed as the mix's ``model`` block says.

The check: a seeded sample of the window's requests, every output (image,
altitude, opacity, shaded image) against the reference's render of the
same view: the largest mean absolute gap of an output, and the largest gap
of any pixel.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from benchmark import counts
from benchmark.common import Run, cell_scene, free, program_scene, sync
from benchmark.reference.render import (TILE, blend_work, camera,
                                        mean_knn_dist2, render, resize_canvas,
                                        sun_camera, uva)
from benchmark.reference.serve import render_view
from benchmark.reference.train import C0
from benchmark.tracing import traced

CHECKED_KEYS = ("raw_render", "altitude", "acc_opacity", "final")


def serve_model(scene, model_cfg, seed, device):
    """The served Gaussians as raw parameters, made on the device from the
    seed: the scene's init points; log-scales of the init rule plus a
    uniform spread per axis; random unit rotations; opacities and colours
    uniform in the mix's ranges."""
    xyz = scene.init_xyz
    n = xyz.shape[0]
    gen = torch.Generator(device=device).manual_seed(seed + 1)

    def u(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=device)

    base = torch.log(torch.sqrt(torch.clamp_min(mean_knn_dist2(xyz), 1e-7)))
    spread = model_cfg["log_scale_spread"]
    rot = torch.randn((n, 4), generator=gen, device=device)
    op = u((n, 1), *model_cfg["opacity"])
    return dict(xyz=xyz.clone(),
                features_dc=((u((n, 1, 3), *model_cfg["colour"]) - 0.5) / C0),
                scaling=base[:, None] + u((n, 3), -spread, spread),
                rotation=rot / torch.linalg.vector_norm(rot, dim=1,
                                                        keepdim=True),
                opacity=torch.log(op / (1.0 - op)))


def program_model(g, device):
    from eogs2_tpu_torch.model import GaussianAux, GaussianModel, GaussianParams

    n = g["xyz"].shape[0]
    z = torch.zeros(n, device=device)
    return GaussianModel(
        GaussianParams(g["xyz"].clone(), g["features_dc"].clone(),
                       torch.zeros((n, 0, 3), device=device),
                       g["scaling"].clone(), g["rotation"].clone(),
                       g["opacity"].clone()),
        GaussianAux(torch.ones(n, dtype=torch.bool, device=device), z,
                    z.clone(), z.clone()))


def request_order(seed, n_views, n):
    rng = np.random.RandomState(seed % 2**32)
    order = []
    while len(order) < n:
        order.extend(int(v) for v in rng.permutation(n_views))
    return order[:n]


def render_setup(cfg, traffic, seed, device):
    """The served model and the program's objects of a render cell: (scene,
    the image views' metadata, their program cameras, the raw parameters,
    the program's model, shading and raster config)."""
    from eogs2_tpu_torch.rasterizer import RasterizeConfig
    from eogs2_tpu_torch.shading import init_shading_params

    scene = cell_scene(cfg, device)
    names = scene.train_names + scene.test_names
    by_name = {m["img"]: m for m in scene.views}
    mds = [by_name[n] for n in names]
    pscene = program_scene(scene, device)
    cams = {v.name: v.camera for v in pscene.train_views + pscene.test_views}
    cams = [cams[n.replace(".tif", "")] for n in names]
    g = serve_model(scene, traffic["model"], seed, device)
    return (scene, mds, cams, g, program_model(g, device),
            init_shading_params(len(cams), device=device),
            RasterizeConfig(**cfg["route"]))


def run(cell, cfg, traffic, args, device, t0) -> Run:
    from eogs2_tpu_torch.pipeline import render_view_full

    t = time.perf_counter()
    scene, mds, cams, g, model, shading, rcfg = render_setup(
        cfg, traffic, args.seed, device)
    sync(device)
    run = Run(scene=scene)
    run.setup_parts["scene_and_model"] = time.perf_counter() - t
    order = request_order(args.seed, len(cams), 100_000)
    rng = np.random.RandomState((args.seed + 7) % 2**32)
    checked = set(rng.choice(traffic["checked_within"],
                             traffic["checked_requests"], replace=False)
                  .tolist())
    k = 0

    def request(keep=False):
        nonlocal k
        vi = order[k]
        k += 1
        with torch.profiler.record_function("bench.render_view_full"):
            out = render_view_full(model, cams[vi], rcfg, shading=shading,
                                   view_idx=vi, with_sun=True)
        if keep:
            run.program_out[len(run.program_out)] = (
                vi, {key: out[key] for key in CHECKED_KEYS})

    t = time.perf_counter()
    for _ in range(traffic["warmup_requests"]):
        request()
    sync(device)
    run.setup_parts["warmup"] = time.perf_counter() - t
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    run.setup_s = time.perf_counter() - t0
    first = k
    w0 = time.perf_counter()
    while time.perf_counter() - w0 < args.seconds:
        t = time.perf_counter()
        request(keep=(k - first) in checked)
        run.latencies.append(time.perf_counter() - t)
    sync(device)
    run.window_s = time.perf_counter() - w0
    run.done = len(run.latencies)
    while k - first <= max(checked):  # a short window: serve the sample
        request(keep=(k - first) in checked)
    if args.trace:
        tfirst = k
        with traced(lambda: sync(device)) as trace:
            for _ in range(traffic["traced_requests"]):
                request()
        traced_views = order[tfirst:k]
        with traced(lambda: sync(device), host=True) as named:
            for _ in range(traffic["gap_requests"]):
                request()
        trace.gaps = named.gaps
        run.trace, run.traced_units = trace, traffic["traced_requests"]
    if device.type == "cuda":
        run.memory_peak_bytes = int(torch.cuda.max_memory_allocated(device))
    del model, cams, shading
    free(device)
    run.work = dict(g=g, mds=mds)
    if args.trace:
        run.work.update(render_work(g, mds, traced_views, device))
    return run


def numbers(outputs, g, mds, precision="fp32") -> dict:
    """outputs: {i: (view, {key: numpy array})} of the program."""
    mean_gap = max_gap = 0.0
    refs = {}
    for vi, prog in outputs.values():
        if vi not in refs:
            refs[vi] = {k: v.cpu().numpy()
                        for k, v in render_view(g, mds[vi], precision).items()}
        for key, p in prog.items():
            d = np.abs(np.asarray(p, np.float64) - refs[vi][key])
            if not np.isfinite(d).all():
                return dict(mean_gap=math.inf, max_gap=math.inf)
            mean_gap = max(mean_gap, float(d.mean()))
            max_gap = max(max_gap, float(d.max()))
    return dict(mean_gap=mean_gap, max_gap=max_gap)


def check(cfg, traffic, run, seed, device):
    if not run.program_out:
        return dict(mean_gap=math.inf, max_gap=math.inf)
    return numbers(run.program_out, run.work["g"], run.work["mds"])


def readings(cfg, traffic, seed, device):
    """The program against the float32 reference (the lower reading), the
    reference in TF32 in its place (the control) and the fault altered (a
    16x16 block of the image changed), on the first checked_requests of
    the seed's order."""
    from eogs2_tpu_torch.pipeline import render_view_full

    _, mds, cams, g, model, shading, rcfg = render_setup(
        cfg, traffic, seed, device)
    views = request_order(seed, len(cams), traffic["checked_requests"])
    prog = {}
    for i, vi in enumerate(views):
        out = render_view_full(model, cams[vi], rcfg, shading=shading,
                               view_idx=vi, with_sun=True)
        prog[i] = (vi, {k: out[k] for k in CHECKED_KEYS})
    del model, cams, shading
    free(device)
    res = {"program": numbers(prog, g, mds)}
    ctl, alt = {}, {}
    for i, vi in enumerate(views):
        r = render_view(g, mds[vi], "tf32")
        ctl[i] = (vi, {k: v.cpu().numpy() for k, v in r.items()})
        a = {k: v.cpu().numpy().copy() for k, v in
             render_view(g, mds[vi], "fp32").items()}
        a["raw_render"][:, :16, :16] += np.float32(0.25)
        alt[i] = (vi, a)
    res["control"] = numbers(ctl, g, mds)
    res["altered"] = numbers(alt, g, mds)
    return res


@torch.no_grad()
def render_work(g, mds, views, device):
    """Per traced request, the work of its main and sun renders."""
    xyz, rot = g["xyz"], g["rotation"]
    scal = torch.exp(g["scaling"])
    opac = torch.sigmoid(g["opacity"][:, 0])
    rgb = g["features_dc"][:, 0, :] * C0 + 0.5
    by_view, steps = {}, []
    for v in views:
        if v not in by_view:
            cam = camera(mds[v], device)
            scam, _ = sun_camera(cam, 2)
            works = []
            bg = torch.tensor([1.0, 0.0, 1.0, cam.alt_min, 0.0], device=device)
            for c in (cam, scam):
                w, h = -(-c.width // TILE) * TILE, -(-c.height // TILE) * TILE
                feats = torch.cat([rgb, uva(xyz, c.affine, "fp32")[:, 2:3],
                                   torch.ones_like(rgb[:, :1])], -1)
                r = render(xyz, scal, rot, opac, feats,
                           resize_canvas(c, w, h), bg, w, h, "fp32")
                works.append(blend_work(r, feats))
                del r
            by_view[v] = works
        steps.append(by_view[v])
    h, w = mds[0]["height"], mds[0]["width"]
    return dict(steps=steps, ops=sum(counts.render_ops(s, h, w)
                                     for s in steps))
