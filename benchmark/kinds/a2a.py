"""Kind ``a2a``: the ``train`` kind's closed loop of ``Trainer.train_step``
on the multi-device path: ``cell["chips"]`` ranks, one process a card, in
one NCCL group (gloo on the CPU), each running the a2a Trainer
(``Trainer(mesh=make_mesh(n), raster_backend="a2a")``) on the same scene
and seed with its shard of the Gaussians, its capacities probed after
set-up as the CLI does.

The host side is held steady: each rank pins itself to its own quarter of
the cores the job may use (those local to its card first, where
``/sys/bus/pci`` says which) with as many torch threads, and the loop stops
by a flag that rank 0 decides on its clock and broadcasts every
``stop_every`` steps, so the ranks wait for one another no more often than
the step itself makes them. ``step_ms`` is rank 0's window over the steps
completed; set-up runs from the harness's start to rank 0's window.

The traced run first records the program's spans on every rank for
``traced_steps`` steps, with no profiler on any: read from them are rank
0's device interval of the ``a2a.exchange`` spans a step, and the largest
less the smallest of the ranks' mean ``train.step`` host interval. Then
the profiler traces rank 0's device activity over as many steps, and its
host operations over ``gap_steps`` more, while the other ranks step along.

The check: the first ``checked_steps`` steps' loss, every leaf's first
gradient and its change, each norm assembled over the shards, against the
one-card reference (``benchmark.reference.train``) run by the harness's
process after the ranks have ended. Readings (``control.py``): the program
against the float32 reference, the reference in TF32, ``half_batch``.
"""

from __future__ import annotations

import math
import os
import shutil
import socket
import sys
import tempfile
import time

import torch

from benchmark.common import (Run, cell_scene, program_config, program_scene,
                              sync)


READING_RANKS = 4  # the cell's chips


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def card_cores(card: int):
    """The CPUs local to CUDA card ``card`` (its PCI device's
    ``local_cpulist``), or [] where that cannot be read."""
    p = torch.cuda.get_device_properties(card)
    ids = [getattr(p, k, None) for k in ("pci_domain_id", "pci_bus_id",
                                         "pci_device_id")]
    if None in ids:
        return []
    path = "/sys/bus/pci/devices/%04x:%02x:%02x.0/local_cpulist" % tuple(ids)
    try:
        with open(path) as f:
            text = f.read().strip()
    except OSError:
        return []
    cores = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        cores += range(int(lo), int(hi or lo) + 1)
    return cores


def pin(rank: int, n: int, cuda: bool):
    """Pin this process to its own quarter (1/n) of the cores the job may
    use, those local to rank r's card first, the ranks' shares disjoint
    (every rank computes them all, in rank order); torch's threads to
    match. Returns the cores."""
    allowed = sorted(os.sched_getaffinity(0))
    per = max(1, len(allowed) // n)
    taken, mine = set(), allowed
    for r in range(n):
        local = card_cores(r) if cuda else []
        pick = [c for c in local if c in allowed and c not in taken][:per]
        pick += [c for c in allowed
                 if c not in taken and c not in pick][:per - len(pick)]
        taken |= set(pick)
        if r == rank:
            mine = pick
    os.sched_setaffinity(0, mine)
    torch.set_num_threads(len(mine))
    return mine


def assembled_norms(tr, values: dict, group) -> dict:
    """{leaf: norm} of per-leaf tensors, a Gaussian leaf's over every
    shard (its squares summed over the ranks), a shading leaf's (the same
    on every rank) as it is."""
    import torch.distributed as dist

    from eogs2_tpu_torch.model import GaussianParams

    out = {}
    for name, v in values.items():
        if name in GaussianParams._fields:
            sq = torch.sum(v.detach().double() ** 2).reshape(1)
            dist.all_reduce(sq, group=group)
            out[name] = math.sqrt(float(sq))
        else:
            out[name] = float(torch.linalg.vector_norm(v))
    return out


def rank_main(rank, n, cfg, traffic, opts):
    """One rank: pin, join the group, set up, the checked steps, the
    warm-up, the timed window, the traced window; writes its results to
    ``opts["tmp"]/rank<r>.pt``."""
    import torch.distributed as dist

    from benchmark.kinds.train import Loop, leaves
    from benchmark.tracing import traced
    from eogs2_tpu_torch.observability import tracer
    from eogs2_tpu_torch.parallel.distributed import init_distributed
    from eogs2_tpu_torch.parallel.mesh import axis_group, make_mesh
    from eogs2_tpu_torch.rasterizer import RasterizeConfig
    from eogs2_tpu_torch.train import Trainer

    cuda = opts["cuda"]
    if cuda:
        torch.cuda.set_device(rank)
    cores = pin(rank, n, cuda)
    init_distributed(opts["url"], n, rank, device="cuda" if cuda else "cpu")
    try:
        dev = (torch.device("cuda", rank) if cuda else torch.device("cpu"))
        parts, t = {}, time.perf_counter()
        parts["ranks"] = t - opts["t0"]
        mesh = make_mesh(n)
        group = axis_group(mesh, "g")
        scene = cell_scene(cfg, dev)
        sync(dev)
        parts["scene"], t = time.perf_counter() - t, time.perf_counter()
        tr = Trainer(program_config(cfg, opts["seed"]),
                     program_scene(scene, dev),
                     RasterizeConfig(**cfg["route"]), device=dev, mesh=mesh,
                     raster_backend="a2a").setup()
        del scene
        tr.probe_capacities()
        sync(dev)
        parts["trainer"], t = time.perf_counter() - t, time.perf_counter()
        start = {k: p.detach().clone() for k, p, _ in leaves(tr)}
        losses, grad1 = [], {}
        for it in range(1, traffic["checked_steps"] + 1):
            losses.append(tr.train_step(it)["loss"])
            if it == 1:
                grad1 = assembled_norms(tr, {
                    k: (opt.state[p]["exp_avg"] / 0.1
                        if "exp_avg" in opt.state[p] else torch.zeros(1))
                    for k, p, opt in leaves(tr)}, group)
        change = assembled_norms(tr, {k: p.detach() - start[k]
                                      for k, p, _ in leaves(tr)}, group)
        del start
        first = dict(losses=[float(x) for x in losses], first_grad=grad1,
                     change=change)
        parts["checked_steps"] = time.perf_counter() - t
        if opts.get("setup_only"):
            torch.save(dict(first=first), os.path.join(
                opts["tmp"], f"rank{rank}.pt"))
            return
        run = Run(program_out={"first": first}, setup_parts=parts)
        loop = Loop(tr, traffic["checked_steps"], None)
        t = time.perf_counter()
        for _ in range(traffic["warmup_steps"]):
            loop.step()
        sync(dev)
        dist.barrier()
        parts["warmup"] = time.perf_counter() - t
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        run.setup_s = time.perf_counter() - opts["t0"]
        loop.losses.clear()
        stop = torch.zeros(1, device=dev)
        every = traffic["stop_every"]
        w0 = time.perf_counter()
        while True:
            t = time.perf_counter()
            loop.step()
            run.unit_s.append(time.perf_counter() - t)
            if len(loop.losses) % every == 0:
                if rank == 0:
                    stop.fill_(float(time.perf_counter() - w0
                                     >= opts["seconds"]))
                dist.broadcast(stop, 0)
                if float(stop):
                    break
        sync(dev)
        run.window_s = time.perf_counter() - w0
        run.done = len(loop.losses)
        run.failed = int((~torch.isfinite(torch.stack(loop.losses))).sum())

        step_host_ms = None
        if opts["trace"]:
            # the program's spans on every rank, no profiler on any
            tracer.enable()
            for _ in range(traffic["traced_steps"]):
                loop.step()
            sync(dev)
            tracer.enable(False)
            u = tracer.per_unit("train.step")
            tracer.reset()
            spans = u["spans"] if u else {}
            if "train.step" in spans:
                step_host_ms = spans["train.step"]["host_ms"]
            if "a2a.exchange" in spans:
                run.counters["exchange_ms"] = spans["a2a.exchange"][
                    "device_ms"]
            # then rank 0's device activity under the profiler
            if rank == 0:
                with traced(lambda: sync(dev)) as trace:
                    for _ in range(traffic["traced_steps"]):
                        loop.step()
                with traced(lambda: sync(dev), host=True) as named:
                    for _ in range(traffic["gap_steps"]):
                        loop.step()
                trace.gaps = named.gaps
                run.trace, run.traced_units = trace, traffic["traced_steps"]
            else:
                for _ in range(traffic["traced_steps"] + traffic["gap_steps"]):
                    loop.step()
            sync(dev)
        if cuda:
            run.memory_peak_bytes = int(torch.cuda.max_memory_allocated(dev))
        torch.save(dict(run=run, step_host_ms=step_host_ms, cores=cores),
                   os.path.join(opts["tmp"], f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(n, cfg, traffic, device, t0, **opts):
    """Run ``rank_main`` on ``n`` ranks; their results in rank order."""
    import torch.multiprocessing as mp

    from benchmark.kinds import a2a  # the ranks import it by this name

    tmp = tempfile.mkdtemp(prefix="bench_a2a_")
    try:
        opts.update(tmp=tmp, t0=t0, cuda=device.type == "cuda",
                    url=f"tcp://localhost:{free_port()}")
        mp.spawn(a2a.rank_main, args=(n, cfg, traffic, opts), nprocs=n)
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(n)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def run(cell, cfg, traffic, args, device, t0) -> Run:
    ranks = spawn(cell["chips"], cfg, traffic, device, t0, seed=args.seed,
                  seconds=args.seconds, trace=args.trace)
    run = ranks[0]["run"]
    steps = [r["step_host_ms"] for r in ranks]
    if None not in steps:
        run.counters["rank_skew_ms"] = max(steps) - min(steps)
    print("cores by rank: " + "; ".join(
        ",".join(map(str, r["cores"])) for r in ranks), file=sys.stderr,
          flush=True)
    return run


def check(cfg, traffic, run, seed, device):
    from benchmark.kinds.train import numbers, reference

    n = traffic["checked_steps"]
    ref = reference(cfg, cell_scene(cfg, device), seed, device,
                    list(range(1, n + 1)), None, "fp32")
    return numbers(run.program_out["first"], ref)


def readings(cfg, traffic, seed, device):
    """The program's first steps at four ranks against the float32
    reference (the lower reading), the reference in TF32 in its place (the
    control) and half_batch planted in the reference."""
    from benchmark.kinds.train import numbers, reference

    first = spawn(READING_RANKS, cfg, traffic, device, time.perf_counter(),
                  seed=seed, seconds=0.0, trace=0,
                  setup_only=True)[0]["first"]
    scene = cell_scene(cfg, device)
    its = list(range(1, traffic["checked_steps"] + 1))
    ref = reference(cfg, scene, seed, device, its, None, "fp32")
    out = {"program": numbers(first, ref)}
    for name, precision, fault in (("control", "tf32", None),
                                   ("half_batch", "fp32", "half_batch")):
        out[name] = numbers(reference(cfg, scene, seed, device, its, None,
                                      precision, fault), ref)
    return out
