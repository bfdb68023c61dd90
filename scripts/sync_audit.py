"""Hold the tracer's host-read count against the card's own count of
syncs, and time what the tracer costs when it records.

    python3 scripts/sync_audit.py [--seed N] [--blocks 8] [--units 20]
                                  [--out output/sync_audit.json]

On a CUDA card, for one step of each benchmark training configuration
(``baseogs-1M-1024``, ``eogsplus-1M-1024``, the dual-modality
``eogsplus-fixed-1M-1024``) and one request of the render cell, at the
benchmark's sizes: every sync that
``torch.cuda.set_sync_debug_mode("warn")`` reports from a frame of
``eogs2_tpu_torch`` (by stack), beside the tracer's ``host_read`` count
and sites of the same unit. Then the cost of recording: blocks of
``--units`` steps (requests) on one Trainer (served model) with the tracer
off and on in the order off, on, on, off, ..., each block timed between
two syncs; the paired differences are the cost on against off. The last
block on gives each span's means a step (request): host time, self time
and device interval, without a profiler.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import statistics
import sys
import time
import traceback
import warnings

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(kind, name):
    with open(os.path.join(ROOT, "benchmark", kind, name + ".json")) as f:
        return json.load(f)


def audit(fn, tracer, unit):
    """Run fn once with the sync debug mode on and the tracer recording:
    (the program's syncs by innermost program frame, the tracer's reads
    by site)."""
    import torch

    syncs = collections.Counter()
    shown = warnings.showwarning

    def show(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return shown(message, category, filename, lineno, file, line)
        mine = [f for f in traceback.extract_stack()[:-1]
                if "eogs2_tpu_torch" in f.filename
                and not f.filename.endswith("observability.py")]
        if mine:
            f = mine[-1]
            syncs[f"{os.path.relpath(f.filename, ROOT)}:{f.lineno}"] += 1

    tracer.reset()
    tracer.enable()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
            tracer.enable(False)
    torch.cuda.synchronize()
    u = tracer.per_unit(unit)
    tracer.reset()
    return dict(debug_mode=sum(syncs.values()), host_reads=u["reads"],
                equal=sum(syncs.values()) == u["reads"],
                debug_sites=dict(syncs), read_sites=u["sites"])


def cost(fn, tracer, unit, blocks, units):
    """ms a unit with the tracer off and on, blocks in the order off, on,
    on, off, ...; the paired differences (on - off) of each round; and the
    spans' means a unit over the last block on (no profiler: host times
    as the untimed runs have them)."""
    import torch

    times, stages = {False: [], True: []}, None
    for b in range(blocks):
        on = b % 4 in (1, 2)
        tracer.enable(on)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(units):
            fn()
        torch.cuda.synchronize()
        times[on].append((time.perf_counter() - t) / units * 1e3)
        tracer.enable(False)
        if on:
            stages = tracer.per_unit(unit)
        tracer.reset()
    diffs = [a - b for a, b in zip(times[True], times[False])]
    return dict(off_ms=times[False], on_ms=times[True], on_minus_off=diffs,
                median_diff=statistics.median(diffs), stages=stages)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seed", type=int, default=4_215_000_001)
    p.add_argument("--blocks", type=int, default=8)
    p.add_argument("--units", type=int, default=20)
    p.add_argument("--out", default="output/sync_audit.json")
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from benchmark.common import load_kind
    from eogs2_tpu_torch.observability import tracer
    from eogs2_tpu_torch.pipeline import render_view_full

    dev = torch.device("cuda", 0)
    out = dict(device=torch.cuda.get_device_name(dev), seed=args.seed)
    train, dual = load_kind(ROOT, "train"), load_kind(ROOT, "train_dual")
    for name, mix, setup in (
            ("baseogs-1M-1024", "train", train.train_setup),
            ("eogsplus-1M-1024", "train", train.train_setup),
            ("eogsplus-fixed-1M-1024", "train-dual", dual.dual_setup)):
        cfg, tf = _load("configs", name), _load("traffic", mix)
        tr, _, _, _ = setup(cfg, tf, args.seed, dev)
        it = [tf["checked_steps"]]

        def step():
            it[0] += 1
            tr.train_step(it[0])

        for _ in range(tf["warmup_steps"]):
            step()
        out[name] = dict(audit=audit(step, tracer, "train.step"),
                         cost=cost(step, tracer, "train.step", args.blocks,
                                   args.units))
        print(name, json.dumps(out[name]), flush=True)
        del tr
        torch.cuda.empty_cache()

    cfg, tf = _load("configs", "baseogs-1M-1024"), _load("traffic", "render")
    _, _, cams, _, model, shading, rcfg = load_kind(
        ROOT, "render").render_setup(cfg, tf, args.seed, dev)
    k = [0]

    def request():
        vi = k[0] % len(cams)
        k[0] += 1
        render_view_full(model, cams[vi], rcfg, shading=shading, view_idx=vi,
                         with_sun=True)

    for _ in range(tf["warmup_requests"]):
        request()
    out["render"] = dict(audit=audit(request, tracer, "serve.request"),
                         cost=cost(request, tracer, "serve.request",
                                   args.blocks, args.units))
    print("render", json.dumps(out["render"]), flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    bad = [k for k, v in out.items()
           if isinstance(v, dict) and not v["audit"]["equal"]]
    print("host_reads equal the debug mode's syncs" if not bad
          else f"host_reads differ from the debug mode's syncs: {bad}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
