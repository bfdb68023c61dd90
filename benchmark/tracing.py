"""The traced window: torch.profiler over a few steps or requests, read
into device time by kernel and the device's busy time (device activity
only); and a short second window with the host's operations too, which
names what the host was doing in the longest device idle gaps.

The profiler slows the host that launches the work: a baseogs step took
154 ms under it against 118-132 ms untraced on an H100. So a share of the
window's time (``counts.mfu``, ``counts.idle``) divides by the timed
window's time a unit, and only device times are read from here.
"""

from __future__ import annotations

import time
from contextlib import contextmanager


class Trace:
    """What one traced window showed: ``kernels`` {name: [seconds, calls]}
    of every device operation (kernels, copies, sets), ``busy_s`` their
    union, ``window_s`` the host-clock length of the window, ``gaps`` the
    longest device idle gaps as (host op, seconds)."""

    def __init__(self):
        self.kernels, self.busy_s, self.window_s, self.gaps = {}, 0.0, 0.0, []

    def seconds(self, *needles) -> float:
        """Device seconds of the operations whose name holds a needle."""
        return sum(s for k, (s, _) in self.kernels.items()
                   if any(n in k for n in needles))

    def breakdown(self, top=10) -> dict:
        ops = sorted(self.kernels.items(), key=lambda kv: -kv[1][0])[:top]
        return {"device_ops": [[k[:120], s] for k, (s, _) in ops],
                "idle_gaps": [[n[:120], s] for n, s in self.gaps[:top]]}


@contextmanager
def traced(sync, host=False):
    """Profile the body between two device syncs (with ``host``, the host's
    operations too); yields the Trace, filled when the body ends."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    tr = Trace()
    sync()
    import torch

    card = torch.cuda.is_available()
    acts = ([ProfilerActivity.CUDA] if card else []) + (
        [ProfilerActivity.CPU] if host or not card else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        yield tr
        sync()
        tr.window_s = time.perf_counter() - t0
    events = prof.events()
    dev, host = [], []
    for e in events:
        r = e.time_range
        if e.device_type == DeviceType.CUDA:
            dev.append((r.start, r.end, e.name))
        elif e.device_type == DeviceType.CPU:
            host.append((r.start, r.end, e.name))
    # the profiler also puts each record_function span on the device's
    # timeline as an annotation: no device operation has a host op's name
    spans = {n for _, _, n in host}
    dev = [d for d in dev if d[2] not in spans and not d[2].startswith("bench.")]
    for s, e, name in dev:
        acc = tr.kernels.setdefault(name, [0.0, 0])
        acc[0] += (e - s) * 1e-6
        acc[1] += 1
    dev.sort()
    merged = []
    for s, e, _ in dev:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    tr.busy_s = sum(e - s for s, e in merged) * 1e-6
    gaps = [(merged[i][1], merged[i + 1][0])
            for i in range(len(merged) - 1)]
    gaps.sort(key=lambda g: g[0] - g[1])
    for a, b in gaps[:10]:
        mid = 0.5 * (a + b)
        inside = [(e - s, n) for s, e, n in host if s <= mid <= e]
        named = [x for x in inside if x[1].startswith(("aten::", "bench."))]
        pick = min(named or inside or [(0.0, "(no host op)")])
        tr.gaps.append((pick[1], (b - a) * 1e-6))
