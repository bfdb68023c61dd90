"""Kind ``train``: a closed loop of ``Trainer.train_step`` as
``Trainer.train`` runs it (the capacity grow every 50 iterations, the
logged means every ``tb_log_interval``), on the configuration's recipe and
route.

Set-up builds the Trainer on the configuration's scene, runs its first
``checked_steps`` through the same call (the reference follows them) and
``warmup_steps`` more; the window then runs steps until ``--seconds`` have
passed. Inside it, at an iteration drawn from the seed after the first
grow (``window_check``), the loop keeps the state before the step and the
norms of its gradients and changes after it: the reference takes that one
step from the same state (it follows the program from the program's own
state there; the first steps check the start from the init).

The check: each of the first steps' loss, every leaf's first gradient
norm (as Adam holds it after step 1: exp_avg / 0.1) and its change over
the steps; and the window step's loss, every leaf's gradient norm (as the
optimizer got it) and its change. Each number is the gap between the
program's norm and the reference's, over the reference's norm of that leaf
or of the median leaf, whichever is larger, at the worst leaf; the loss
gap is relative. A leaf whose reference gradient is under a thousandth of
the median leaf's is left out (it moves under Adam by round-off alone).
"""

from __future__ import annotations

import dataclasses
import statistics
import time

import torch

from benchmark import counts
from benchmark.common import (Run, cell_scene, free, program_config,
                              program_scene, sync, trainer_seed)
from benchmark.reference.render import (TILE, blend_work, camera,
                                        random_camera, render, resize_canvas,
                                        sun_camera, uva)
from benchmark.reference.train import (C0, GAUSS_LEAVES, SHADING_LEAVES,
                                       cameras_extent, draws, init_start,
                                       train_reference)
from benchmark.tracing import traced


def leaves(tr):
    """(name, tensor, optimizer) of every leaf the Trainer's Adams step."""
    from eogs2_tpu_torch.model import GaussianParams

    out = [(f, getattr(tr.model, f), tr.gauss_opt)
           for f in GaussianParams._fields]
    out += [(f.name, getattr(tr.shading, f.name), tr.cam_opt)
            for f in dataclasses.fields(tr.shading)
            if getattr(tr.shading, f.name) is not None]
    return [x for x in out if x[1].numel() > 0]


def norms(d):
    return {k: float(torch.linalg.vector_norm(v)) for k, v in d.items()}


def train_setup(cfg, traffic, seed, device):
    """The Trainer after its checked steps, and the program's readings of
    them: each step's loss, each leaf's first gradient as Adam holds it
    (exp_avg / (1 - beta1) after step 1) and its change over the steps."""
    from eogs2_tpu_torch.rasterizer import RasterizeConfig
    from eogs2_tpu_torch.train import Trainer

    parts, t = {}, time.perf_counter()
    scene = cell_scene(cfg, device)
    sync(device)
    parts["scene"], t = time.perf_counter() - t, time.perf_counter()
    tr = Trainer(program_config(cfg, seed), program_scene(scene, device),
                 RasterizeConfig(**cfg["route"]), device=device).setup()
    sync(device)
    parts["trainer"], t = time.perf_counter() - t, time.perf_counter()
    start = {n: p.detach().clone() for n, p, _ in leaves(tr)}
    losses, grad1 = [], {}
    n_checked = traffic["checked_steps"]
    for it in range(1, n_checked + 1):
        m = tr.train_step(it)
        losses.append(m["loss"])
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


def window_iteration(traffic, seed) -> int:
    """The window's checked iteration: after the grow at ``after``, one of
    the ``span`` that follow, drawn from the seed."""
    w = traffic["window_check"]
    return w["after"] + 1 + seed % w["span"]


class Loop:
    """The window's loop on one Trainer, from iteration ``it`` + 1. At
    iteration ``check_it`` it keeps the state before the step (every
    leaf, Adam's moments and step counts, the alive mask) and the
    norms of the gradients and changes and the loss after it, on the
    device."""

    def __init__(self, tr, it, check_it):
        from eogs2_tpu_torch.train import mean_metrics

        self.tr, self.it, self.check_it = tr, it, check_it
        self.mean_metrics = mean_metrics
        self.log_every = tr.cfg.logging.tb_log_interval
        self.interval, self.losses, self.kept = [], [], None

    def step(self):
        tr = self.tr
        self.it += 1
        keep = self.it == self.check_it
        if keep:
            before = self._state()
        with torch.profiler.record_function("bench.train_step"):
            m = tr.train_step(self.it)
        if keep:  # norms on the device, read once the window has closed
            vn = torch.linalg.vector_norm
            self.kept = dict(
                iteration=self.it, start=before, loss=m["loss"].detach().clone(),
                grad={n: vn(p.grad) if p.grad is not None
                      else torch.zeros((), device=p.device)
                      for n, p, _ in leaves(tr)},
                change={n: vn(p.detach() - before["leaves"][n])
                        for n, p, _ in leaves(tr)})
        self.losses.append(m["loss"])
        self.interval.append(m)
        if self.it % 50 == 0:
            with torch.profiler.record_function("bench.grow"):
                tr._grow_capacities(m)
        if self.it % self.log_every == 0:
            with torch.profiler.record_function("bench.log_means"):
                self.mean_metrics(self.interval)
                tr.num_alive()
            self.interval = []
        return m

    def _state(self):
        st = {"leaves": {}, "m": {}, "s2": {}, "t": {}}
        for n, p, opt in leaves(self.tr):
            s = opt.state.get(p, {})  # none before Adam's first step
            st["leaves"][n] = p.detach().clone()
            st["m"][n] = s.get("exp_avg", torch.zeros_like(p)).clone()
            st["s2"][n] = s.get("exp_avg_sq", torch.zeros_like(p)).clone()
            st["t"][n] = torch.as_tensor(s.get("step", 0)).clone()
        st["alive"] = self.tr.model.alive.clone()
        return st

    def window_out(self):
        """The program's readings of the checked window step, and the
        state the reference starts from."""
        k = self.kept
        start = k["start"]
        start["t"] = {n: int(v) for n, v in start["t"].items()}
        prog = dict(losses=[float(k["loss"])],
                    first_grad={n: float(v) for n, v in k["grad"].items()},
                    change={n: float(v) for n, v in k["change"].items()})
        return dict(iteration=k["iteration"], start=start, prog=prog)


def run(cell, cfg, traffic, args, device, t0) -> Run:
    from eogs2_tpu_torch import train as program_train

    check_it = window_iteration(traffic, args.seed)
    n0 = traffic["checked_steps"] + traffic["warmup_steps"]
    if check_it <= n0:
        raise ValueError("window_check must fall after the warm-up steps")
    tr, scene, out, parts = train_setup(cfg, traffic, args.seed, device)
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

        def counting(*a, **k):
            ro = real(*a, **k)
            pairs.append(ro.num_pairs)
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
        run.counters["pairs"] = float(torch.stack(pairs).double().sum())
    if device.type == "cuda":
        run.memory_peak_bytes = int(torch.cuda.max_memory_allocated(device))
    run.program_out["window"] = loop.window_out()
    del tr, loop
    free(device)
    if args.trace:
        run.work = train_work(cfg, scene, run.work, args.seed, device)
    return run


def train_views(scene):
    return [m for m in scene.views if m["img"] in scene.train_names]


def ground_truth(cfg, scene, mds):
    r = cfg["recipe"]
    if r.get("load_msi", True):
        return [scene.images[m["img"]] for m in mds]
    if not r.get("repeat_gt"):  # the PAN companions, as three channels
        raise ValueError("the reference renders PAN as three channels")
    return [scene.images_pan[m["img"]].repeat(3, 1, 1) for m in mds]


def reference(cfg, scene, seed, device, iterations, start, precision,
              fault=None):
    """The reference's iterations from ``start`` (None: the init) on the
    Trainer's own draws, as norms."""
    mds = train_views(scene)
    views, bgs, shears = draws(trainer_seed(seed), len(mds), iterations[-1],
                               device)
    recipe = dict(cfg["recipe"],
                  unsupported_terms_must_be_off=cfg[
                      "unsupported_terms_must_be_off"])
    if start is None:
        start = init_start(scene.init_xyz, scene.init_rgb, recipe, len(mds),
                           device)
    else:
        names = GAUSS_LEAVES + SHADING_LEAVES
        start = dict(start, **{k: {n: start[k][n] for n in names}
                               for k in ("leaves", "m", "s2", "t")})
    out = train_reference(mds, ground_truth(cfg, scene, mds), recipe,
                          iterations, views, bgs, shears, start,
                          cameras_extent(scene.init_xyz),
                          float(scene.init_xyz.shape[0]), precision, fault)
    return dict(losses=out["losses"], first_grad=norms(out["first_grad"]),
                change=norms(out["change"]))


def numbers(prog: dict, ref: dict) -> dict:
    """prog, ref: losses [n], first_grad {leaf: norm}, change {leaf: norm}."""
    names = sorted(set(prog["first_grad"]) | set(ref["first_grad"]))
    rg = {n: ref["first_grad"].get(n, 0.0) for n in names}
    med = statistics.median(rg.values())
    counted = [n for n in names if rg[n] >= 1e-3 * med]
    rc = {n: ref["change"].get(n, 0.0) for n in counted}
    medc = statistics.median(rc.values())

    def gap(a, b, floor):
        return abs(a - b) / max(b, floor, 1e-30)

    return dict(
        loss_gap=max(gap(a, b, 0.0) for a, b in zip(prog["losses"],
                                                      ref["losses"])),
        grad_gap=max(gap(prog["first_grad"].get(n, 0.0), rg[n], med)
                     for n in counted),
        change_gap=max(gap(prog["change"].get(n, 0.0), rc[n], medc)
                       for n in counted))


def compare(cfg, traffic, scene, seed, device, first, window,
            precision="fp32", fault=None, refs=None):
    """The cell's numbers of the program's readings ``first`` and
    ``window`` (or, with ``refs``, of the reference at ``precision`` and
    ``fault`` against the float32 reference ``refs``)."""
    n = traffic["checked_steps"]
    it = window["iteration"]
    r1 = reference(cfg, scene, seed, device, list(range(1, n + 1)), None,
                   precision, fault)
    rw = reference(cfg, scene, seed, device, [it], window["start"],
                   precision, fault)
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
    half_batch and altered planted in the reference (reference.train
    .step_loss), at the first steps and at the window's checked step."""
    tr, scene, first, _ = train_setup(cfg, traffic, seed, device)
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
                                   ("altered", "fp32", "altered")):
        out[name] = compare(cfg, traffic, scene, seed, device, first, window,
                            precision, fault, refs)[0]
    return out


@torch.no_grad()
def step_renders(state, md, shear, extent, bg):
    """The reference's preprocessing and pair lists of a step's three
    renders (main, sun, random camera) at a Gaussian state, as blend work
    dicts."""
    alive = state["alive"]
    xyz = state["xyz"][alive]
    scal = torch.exp(state["scaling"][alive])
    rot = state["rotation"][alive]
    opac = torch.sigmoid(state["opacity"][alive][:, 0])
    rgb = state["features_dc"][alive][:, 0, :] * C0 + 0.5
    cam = camera(md, xyz.device)
    scam, _ = sun_camera(cam, 2)
    ncam, _ = random_camera(cam, shear, extent)
    works = []
    for c, w, h in ((cam, cam.width, cam.height),
                    (scam, scam.width, scam.height), (ncam, cam.width,
                                                      cam.height)):
        w, h = -(-w // TILE) * TILE, -(-h // TILE) * TILE
        feats = torch.cat([rgb, uva(xyz, c.affine, "fp32")[:, 2:3],
                           torch.ones_like(rgb[:, :1])], -1)
        r = render(xyz, scal, rot, opac, feats, resize_canvas(c, w, h), bg,
                   w, h, "fp32")
        works.append(blend_work(r, feats))
        del r
    return works


def train_work(cfg, scene, work, seed, device):
    """Per traced step, the work of its three renders at the state the
    traced window started from (one count per distinct view)."""
    mds = train_views(scene)
    views, bgs, shears = draws(trainer_seed(seed), len(mds), work["last"],
                               device)
    by_view, steps = {}, []
    for i in range(work["first"], work["last"] + 1):
        v = views[i - 1]
        if v not in by_view:
            by_view[v] = step_renders(work["state"], mds[v], shears[i - 1],
                                      cfg["recipe"]["virtual_camera_extent"],
                                      bgs[i - 1])
        steps.append(by_view[v])
    n_params = sum(int(t.numel()) for k, t in work["state"].items()
                   if k != "alive")
    w, h = scene.views[0]["width"], scene.views[0]["height"]
    return dict(steps=steps, ops=sum(counts.train_step_ops(s, n_params, h, w)
                                     for s in steps))
