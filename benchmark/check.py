"""The judgement that decides ``correct``: each number that the cell's kind
compared (``check`` of ``benchmark/kinds/<kind>.py``) beside its limit in
``benchmark/limits/<cell>.json``.
"""

from __future__ import annotations

import json
import math
import os


def limits(root, workload):
    with open(os.path.join(root, "benchmark", "limits",
                           f"{workload}.json")) as f:
        return json.load(f)


def judge(numbers: dict, lims: dict):
    """(correct, {name: {value, limit}}): every limit has its number,
    finite and at or under it (a number the run did not give reads inf)."""
    rows = {k: {"value": numbers.get(k, math.inf), "limit": lim}
            for k, lim in lims.items()}
    ok = bool(rows) and all(math.isfinite(r["value"])
                            and r["value"] <= r["limit"]
                            for r in rows.values())
    return ok, rows
