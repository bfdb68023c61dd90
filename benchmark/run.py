"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell is found by name in BENCHMARK.json; its configuration in the file
the configs entry names, its traffic mix in ``benchmark/traffic/<mix>.json``
(data), the code that drives and checks that mix's ``kind`` in
``benchmark/kinds/<kind>.py`` (``common.py`` says what a kind provides),
its per-layer metrics as readers ``benchmark/metrics/<metric>.py`` and its
limits in ``benchmark/limits/<cell>.json``. So a new cell, configuration,
mix, kind or metric is new files and entries, never an edit.

``--trace 0`` prints the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics, read from a traced window after the timed one. Every
run checks the timed path's outputs against the plain reference (the
kind's ``check``) and prints each compared number beside its limit, on
standard error and under ``checks`` in the result line, which is the last
line of standard output. Without enough CUDA devices it exits 2 and prints
no result.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "eogs2_tpu"}


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def cache_env(root):
    """Every build and kernel cache at a fixed directory of the checkout;
    transformers, if anything loads it, kept off JAX."""
    cache = os.path.join(root, "benchmark", ".cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["USE_FLAX"] = "0"


def load_cell(root, workload):
    """(cell, configuration, traffic mix, per-layer metrics, end-to-end
    metrics) of a workload, all by name."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    with open(os.path.join(root, entry["file"])) as f:
        cfg = json.load(f)
    with open(os.path.join(root, "benchmark", "traffic",
                           f"{cell['traffic']}.json")) as f:
        traffic = json.load(f)

    def mine(m):
        return workload in m.get("workloads", [workload])

    return (cell, cfg, traffic, [m for m in bench["per_layer"] if mine(m)],
            [m for m in bench["end_to_end"] if mine(m)])


def reader(root, name):
    """The ``read(ctx)`` of benchmark/metrics/<name>.py."""
    from benchmark.common import load_module

    return load_module(os.path.join(root, "benchmark", "metrics",
                                    f"{name}.py"), "bench_metric_").read


class Ctx:
    """What a per-layer reader sees: the run (its traced window, counters
    and counts), the cell and its number of chips."""

    def __init__(self, run, cell):
        self.run, self.trace, self.cell = run, run.trace, cell
        self.chips = cell["chips"]


def end_to_end(run) -> dict:
    out = {"setup_s": run.setup_s}
    if run.done and run.latencies:
        out["view_ms"] = run.window_s / run.done * 1e3
    elif run.done:
        out["step_ms"] = run.window_s / run.done * 1e3
    return out


def loaded_forbidden():
    return sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)


def main(argv=None, root=ROOT, device=None) -> int:
    """Run the cell; ``device`` (tests only) skips the look for CUDA."""
    args = parse(argv)
    cache_env(root)
    if root not in sys.path:
        sys.path.insert(0, root)
    cell, cfg, traffic, per_layer, e2e = load_cell(root, args.workload)
    import torch

    if device is None:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < cell["chips"]:
            print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
                  f"found {torch.cuda.device_count()}", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    device = torch.device(device)
    from benchmark import check
    from benchmark.common import load_kind

    kind = load_kind(root, traffic["kind"])
    run = kind.run(cell, cfg, traffic, args, device, T0)
    bad = loaded_forbidden()
    if bad:
        print(f"the run loaded {bad}", file=sys.stderr)
        return 3
    t_ref = time.perf_counter()
    numbers = kind.check(cfg, traffic, run, args.seed, device)
    print(f"setup {run.setup_s:.3f} s, window {run.window_s:.3f} s, "
          f"reference {time.perf_counter() - t_ref:.3f} s", file=sys.stderr)
    rest = run.setup_s - sum(run.setup_parts.values())
    print("setup parts (s): " + ", ".join(
        f"{k} {v:.3f}" for k, v in run.setup_parts.items())
        + f", imports and the rest {rest:.3f}", file=sys.stderr)
    units = run.latencies or run.unit_s
    if len(units) > 4:
        q = statistics.quantiles(units, n=4)
        print(f"host ms a unit: q1 {q[0] * 1e3:.2f} median {q[1] * 1e3:.2f} "
              f"q3 {q[2] * 1e3:.2f} max {max(units) * 1e3:.2f} "
              f"({len(units)} units)", file=sys.stderr)
    correct, rows = check.judge(numbers, check.limits(root, args.workload))
    metrics = {}
    if args.trace:
        ctx = Ctx(run, cell)
        for m in per_layer:
            value = reader(root, m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = end_to_end(run)
        for m in e2e:
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else str(device))
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": kind, "count": cell["chips"],
           "memory_peak_bytes": run.memory_peak_bytes}
    result = {"correct": correct, "attempted": run.done,
              "failed": run.failed, "metrics": metrics, "device": dev}
    if args.trace:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
        result["breakdown"] = run.trace.breakdown()
    result["checks"] = rows
    for name, r in rows.items():
        print(f"check {name} {r['value']!r} limit {r['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
