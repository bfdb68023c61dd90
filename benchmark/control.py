"""The readings that the limits in benchmark/limits/ were set from, at a
cell's own size on the card, many seeds in one process (the benchmark's
own runs never run this):

    python3 benchmark/control.py --workload <cell> --seeds 1 2 3 ...

Per seed, one JSON line of the cell's kind's ``readings``: ``program``
(the program's timed entry against the reference in float32: the lower
reading), ``control`` (the reference in TF32 put in the program's place),
and the faults the kind plants (a train cell: ``half_batch`` and
``altered``, reference.train.step_loss, at the first steps and at the
window's checked step). A state left unchanged reads 1 on the gradient and
change gaps by the measure and needs no run.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import torch

    from benchmark.common import load_kind
    from benchmark.run import cache_env, load_cell

    cache_env(ROOT)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell, cfg, traffic, _, _ = load_cell(ROOT, args.workload)
    kind = load_kind(ROOT, traffic["kind"])
    rows = []
    for seed in args.seeds:
        t = time.perf_counter()
        row = dict(workload=args.workload, seed=seed,
                   **kind.readings(cfg, traffic, seed, device))
        row["seconds"] = time.perf_counter() - t
        rows.append(row)
        print(json.dumps(row), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
