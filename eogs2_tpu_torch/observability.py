"""Observability: metrics logging, profiling, non-finite guards.

Counterpart of ``eogs2_tpu/observability.py``; parity targets (SURVEY.md
section 5):
  * TensorBoard scalars/images per loss term + PSNR/SSIM + Gaussian count
    (train_pan.py:509-568): through torch.utils.tensorboard where it
    imports, always mirrored to a JSONL file; without TensorBoard, or
    without the Pillow its image summaries need, images are written as
    PNGs (``io/png.py``).
  * the run-config snapshot (cfg_args parity), JSON.
  * tracing: a torch.profiler context writing a Chrome trace, and the
    program's own spans and host-read counters (:class:`Tracer`), written
    beside it.
  * the CUDA CHECK(debug)/detect_anomaly analog: :func:`nan_guard` raises
    when a function returns a non-finite tensor (JAX: checkify).
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import itertools
import json
import os
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch
from torch.autograd import profiler as _autograd_profiler

from eogs2_tpu_torch.io.png import write_png


class MetricsLogger:
    """JSONL + optional TensorBoard scalar logger."""

    def __init__(self, log_dir: str, use_tensorboard: bool = True,
                 remote: Optional[Callable] = None):
        os.makedirs(log_dir, exist_ok=True)
        self.log_dir = log_dir
        self.jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self.remote = remote
        self.tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:  # no tensorboard package: PNGs instead
                SummaryWriter = None
            if SummaryWriter is not None:
                self.tb = SummaryWriter(log_dir)

    def log_scalars(self, metrics: dict, step: int):
        row = {"step": step}
        for k, v in metrics.items():
            try:
                row[k] = float(v)
            except (TypeError, ValueError):
                continue
        self.jsonl.write(json.dumps(row) + "\n")
        self.jsonl.flush()
        if self.tb is not None:
            for k, v in row.items():
                if k != "step":
                    self.tb.add_scalar(k, v, step)
        if self.remote is not None:
            self.remote(row, step)

    def log_image(self, tag: str, img_chw, step: int):
        arr = np.clip(np.asarray(img_chw), 0, 1)
        if self.tb is not None:
            try:
                self.tb.add_image(tag, arr, step)
                return
            except ImportError:  # TensorBoard encodes images with Pillow
                pass
        d = os.path.join(self.log_dir, "images")
        os.makedirs(d, exist_ok=True)
        if arr.ndim == 3:
            arr = arr.transpose(1, 2, 0)
        write_png(os.path.join(d, f"{tag.replace('/', '_')}_{step:06d}.png"),
                  (arr * 255).astype(np.uint8))

    def save_config(self, cfg, name: str = "cfg_args.json"):
        """Run-config snapshot (train_pan.py:826-828 parity)."""

        def enc(o):
            if dataclasses.is_dataclass(o):
                return dataclasses.asdict(o)
            if isinstance(o, (np.integer, np.floating)):
                return float(o)
            return str(o)

        with open(os.path.join(self.log_dir, name), "w") as f:
            json.dump(cfg, f, default=enc, indent=1)

    def close(self):
        self.jsonl.close()
        if self.tb is not None:
            self.tb.close()


class ProfilerContext:
    """``with ProfilerContext(dir): ...`` records the block with
    torch.profiler (the CPU, and CUDA where present) and writes
    ``<dir>/trace.json`` (Chrome trace format) and the tracer's spans of
    the block, ``<dir>/spans.json`` (:meth:`Tracer.dump`), on exit. The
    tracer records while the profiler does, so the program's spans are in
    the Chrome trace too, on the kernels' clock. ``self.profile`` holds
    the profiler for ``key_averages()``."""

    def __init__(self, log_dir: str, enabled: bool = True):
        self.log_dir = log_dir
        self.enabled = enabled
        self.profile = None

    def __enter__(self):
        if self.enabled:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            tracer.reset()
            self.profile = torch.profiler.profile(activities=acts)
            self.profile.__enter__()
        return self

    def __exit__(self, *exc):
        if self.enabled:
            self.profile.__exit__(*exc)
            os.makedirs(self.log_dir, exist_ok=True)
            self.profile.export_chrome_trace(
                os.path.join(self.log_dir, "trace.json"))
            tracer.dump(os.path.join(self.log_dir, "spans.json"))
        return False


def trace_iterations(train_step: Callable, first: int, last: int,
                     log_dir: str) -> Callable:
    """``Trainer.train_step`` wrapped so that iterations first..last run
    inside one :class:`ProfilerContext` on ``log_dir``: it opens before
    iteration ``first`` and writes trace.json and spans.json after
    iteration ``last`` (the CLI's ``train --trace-steps A:B``)."""
    ctx = ProfilerContext(log_dir)

    def step(iteration: int):
        if iteration == first:
            ctx.__enter__()
        try:
            return train_step(iteration)
        finally:
            if iteration == last:
                ctx.__exit__(None, None, None)

    return step


class _Span:
    """One open or closed span of the :class:`Tracer`."""

    __slots__ = ("tracer", "name", "unit", "id", "parent", "unit_name",
                 "unit_id", "thread", "t0", "t1", "events", "annotation",
                 "outer")

    def __init__(self, tracer, name, unit):
        self.tracer, self.name, self.unit = tracer, name, unit

    def __enter__(self):
        tr = self.tracer
        self.thread = threading.get_ident()
        with tr._lock:
            stack = tr._open.setdefault(self.thread, [])
            self.outer = tr._unit
            if self.unit is not None:  # a unit span: number it, make it current
                if self.unit is True:
                    tr._unit_seq[self.name] += 1
                    self.unit = tr._unit_seq[self.name]
                tr._units[self.name] += 1
                tr._unit = (self.name, self.unit, self.thread)
            cur = tr._unit
            self.unit_name, self.unit_id = (cur[0], cur[1]) if cur else ("", None)
            # on autograd's engine thread (no span open there) the parent
            # is the span the unit's thread waits in: train.backward
            parents = stack or (tr._open.get(cur[2], []) if cur else [])
            self.parent = parents[-1].id if parents else None
            self.id = next(tr._ids)
            stack.append(self)
        self.annotation = None
        if _autograd_profiler._is_profiler_enabled:
            self.annotation = torch.profiler.record_function(self.name)
            self.annotation.__enter__()
        self.events = None
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter_ns()
        if self.events is not None:
            self.events[1].record()
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        tr = self.tracer
        with tr._lock:
            stack = tr._open.get(self.thread, [])
            if stack and stack[-1] is self:
                stack.pop()
            if self.unit is not None:
                tr._unit = self.outer
            if len(tr._spans) == tr._spans.maxlen:
                tr.dropped += 1
            tr._spans.append(self)
        return False

    def __call__(self, fn):
        return _decorate(self.tracer, self.name, self.unit, fn)


class _Off:
    """The shared no-op context a span is while the tracer is off."""

    __slots__ = ("tracer", "name", "unit")

    def __init__(self, tracer, name, unit):
        self.tracer, self.name, self.unit = tracer, name, unit

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False

    def __call__(self, fn):
        return _decorate(self.tracer, self.name, self.unit, fn)


def _decorate(tracer, name, unit, fn):
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with tracer.span(name, unit):
            return fn(*args, **kwargs)

    return wrapped


def _union_ns(intervals):
    """Length of the union of (start, end) intervals."""
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


class Tracer:
    """The program's spans and host-read counters, one recorder per
    process (:data:`tracer`).

    It records exactly while a ``torch.profiler`` profile is active, or
    while :meth:`enable` has turned it on. Off, :meth:`span` is one flag
    check that returns a shared no-op context, and :meth:`host_read` one
    flag check before the plain read: no profiler annotation, no CUDA
    event, no clock read, no sync.

    On, a span records its name, its host start and end
    (``time.perf_counter_ns``), its parent span and the unit it belongs to
    (a unit span: ``train.step`` per training iteration, ``serve.request``
    per request). With CUDA in use it records a pair of CUDA events on the
    current stream, read as a device interval only by :meth:`summary` and
    :meth:`dump` (after a sync); while a profiler records, it is also a
    ``record_function`` range, so the profiler's trace shows it beside the
    kernels. Spans that autograd's engine thread opens in a backward take
    the span their unit's thread waits in (``train.backward``) as parent.
    Closed spans are kept in a bounded buffer (the oldest dropped first,
    counted in ``dropped``); unit and host-read counts are totals.

    Host clocks run slow under the profiler (a baseogs step on an H100:
    154 ms traced, 118-132 ms untraced); device intervals and counts do
    not."""

    def __init__(self, capacity: int = 200_000):
        self._lock = threading.Lock()
        self._forced = False
        self._capacity = capacity
        self._off = {}
        self.reset()

    def reset(self):
        """Forget every span and count (open spans stay open)."""
        with self._lock:
            self._spans = collections.deque(maxlen=self._capacity)
            self._open = {}
            self._ids = itertools.count()
            self._unit = None
            self._units = collections.Counter()
            self._unit_seq = collections.Counter()
            self._reads = {}
            self.dropped = 0

    def enable(self, on: bool = True):
        """Record whether or not a profiler is active (an operator's
        switch); ``enable(False)`` leaves recording to the profiler."""
        self._forced = bool(on)

    def recording(self) -> bool:
        return self._forced or _autograd_profiler._is_profiler_enabled

    def span(self, name: str, unit=None):
        """Context manager (also a decorator) of the span ``name``. ``unit``
        makes it a unit span: an id (the training iteration), or True to
        number the units of ``name`` in order."""
        if not (self._forced or _autograd_profiler._is_profiler_enabled):
            # one no-op per name (and per numbered unit, for a decorator);
            # an id such as the iteration does not make another
            key = name if unit is None else (name, unit is True)
            off = self._off.get(key)
            if off is None:
                off = self._off.setdefault(
                    key, _Off(self, name, True if unit is True else None))
            return off
        return _Span(self, name, unit)

    def host_read(self, x, site: str, syncs: int = 1):
        """A read from the device to the host: ``x.tolist()`` of a tensor,
        or the result of ``x()`` for a callable, an operation that waits
        for the card implicitly (a boolean mask, ``bincount``, indexing by
        a device scalar, a blocking copy of a host value to the card).
        Returns what the plain read returns. On, counts ``syncs`` waits at
        ``site`` (``bincount`` waits twice) under the current unit and adds
        the host time the call blocked."""
        if not (self._forced or _autograd_profiler._is_profiler_enabled):
            return x() if callable(x) else x.tolist()
        t0 = time.perf_counter_ns()
        value = x() if callable(x) else x.tolist()
        dt = time.perf_counter_ns() - t0
        with self._lock:
            unit = self._unit[0] if self._unit is not None else ""
            r = self._reads.setdefault((unit, site), [0, 0])
            r[0] += syncs
            r[1] += dt
        return value

    def spans(self):
        """The closed spans as dicts, device intervals resolved (syncs
        the card when any span holds events)."""
        with self._lock:
            spans = list(self._spans)
        if any(s.events is not None for s in spans):
            torch.cuda.synchronize()
        out = []
        for s in spans:
            host_ms = (s.t1 - s.t0) * 1e-6
            # on the CPU the host is the device that ran the span's work
            dev_ms = (s.events[0].elapsed_time(s.events[1])
                      if s.events is not None else host_ms)
            out.append(dict(id=s.id, name=s.name, parent=s.parent,
                            unit=s.unit_name, unit_id=s.unit_id,
                            thread=s.thread, t0_ns=s.t0, t1_ns=s.t1,
                            host_ms=host_ms, device_ms=dev_ms))
        return out

    def summary(self, spans=None) -> dict:
        """Totals of the recorded spans and reads, by unit name ("" outside
        any unit): ``units`` {unit: count}; ``spans`` {unit: {name:
        {count, host_ms, self_ms, device_ms}}}, self_ms the host time no
        child span covers; ``reads`` {unit: {site: {count, wait_ms}}};
        ``dropped`` the spans the buffer lost."""
        spans = self.spans() if spans is None else spans
        children = collections.defaultdict(list)
        for s in spans:
            if s["parent"] is not None:
                children[s["parent"]].append(s)
        by_unit = {}
        for s in spans:
            acc = by_unit.setdefault(s["unit"], {}).setdefault(
                s["name"], dict(count=0, host_ms=0.0, self_ms=0.0,
                                device_ms=0.0))
            inside = [(max(c["t0_ns"], s["t0_ns"]), min(c["t1_ns"], s["t1_ns"]))
                      for c in children[s["id"]]]
            covered = _union_ns([i for i in inside if i[1] > i[0]])
            acc["count"] += 1
            acc["host_ms"] += s["host_ms"]
            acc["self_ms"] += s["host_ms"] - covered * 1e-6
            acc["device_ms"] += s["device_ms"]
        with self._lock:
            reads = {}
            for (unit, site), (n, ns) in self._reads.items():
                reads.setdefault(unit, {})[site] = dict(count=n,
                                                        wait_ms=ns * 1e-6)
            units = dict(self._units)
        return dict(units=units, spans=by_unit, reads=reads,
                    dropped=self.dropped)

    def per_unit(self, unit: str) -> Optional[dict]:
        """The summary of the unit spans ``unit`` over their count: {units,
        spans {name: {count, host_ms, self_ms, device_ms}}, reads,
        read_wait_ms, sites {site: count}}, each a mean a unit; None when
        no such unit was recorded."""
        s = self.summary()
        n = s["units"].get(unit, 0)
        if not n:
            return None
        spans = {name: {k: v / n for k, v in acc.items()}
                 for name, acc in s["spans"].get(unit, {}).items()}
        sites = s["reads"].get(unit, {})
        return dict(units=n, spans=spans,
                    reads=sum(r["count"] for r in sites.values()) / n,
                    read_wait_ms=sum(r["wait_ms"] for r in sites.values()) / n,
                    sites={k: r["count"] / n for k, r in sites.items()})

    def dump(self, path: str):
        """Write the spans (``spans``: id, name, parent, unit, unit_id,
        thread, host start and end in ns, host_ms, device_ms) and the
        summary as JSON."""
        spans = self.spans()
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(dict(spans=spans, summary=self.summary(spans)), f)


tracer = Tracer()
span = tracer.span
host_read = tracer.host_read


def _tensors(out, path="out"):
    if torch.is_tensor(out):
        yield path, out
    elif isinstance(out, dict):
        for k, v in out.items():
            yield from _tensors(v, f"{path}[{k!r}]")
    elif isinstance(out, (tuple, list)):
        for i, v in enumerate(out):
            yield from _tensors(v, f"{path}[{i}]")


def nan_guard(fn):
    """Wrap fn so that a NaN or Inf in any floating tensor it returns
    (nested in tuples, lists and dicts) raises FloatingPointError naming
    the output, the analog of the reference's CHECK_CUDA(debug) and
    detect_anomaly paths (JAX: checkify_nan_guard). Each check reads one
    flag from the device."""

    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        for path, t in _tensors(out):
            if t.is_floating_point() and not bool(torch.isfinite(t).all()):
                raise FloatingPointError(f"non-finite values in {path} of "
                                         f"{getattr(fn, '__name__', fn)}")
        return out

    return wrapped
