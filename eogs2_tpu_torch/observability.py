"""Observability: metrics logging, profiling, non-finite guards.

Counterpart of ``eogs2_tpu/observability.py``; parity targets (SURVEY.md
section 5):
  * TensorBoard scalars/images per loss term + PSNR/SSIM + Gaussian count
    (train_pan.py:509-568): through torch.utils.tensorboard where it
    imports, always mirrored to a JSONL file; without TensorBoard, or
    without the Pillow its image summaries need, images are written as
    PNGs (``io/png.py``).
  * the run-config snapshot (cfg_args parity), JSON.
  * tracing: a torch.profiler context writing a Chrome trace, and a
    per-stage wall-clock summary.
  * the CUDA CHECK(debug)/detect_anomaly analog: :func:`nan_guard` raises
    when a function returns a non-finite tensor (JAX: checkify).
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

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
    ``<dir>/trace.json`` (Chrome trace format) on exit; ``self.profile``
    holds the profiler for ``key_averages()``."""

    def __init__(self, log_dir: str, enabled: bool = True):
        self.log_dir = log_dir
        self.enabled = enabled
        self.profile = None

    def __enter__(self):
        if self.enabled:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self.profile = torch.profiler.profile(activities=acts)
            self.profile.__enter__()
        return self

    def __exit__(self, *exc):
        if self.enabled:
            self.profile.__exit__(*exc)
            os.makedirs(self.log_dir, exist_ok=True)
            self.profile.export_chrome_trace(
                os.path.join(self.log_dir, "trace.json"))
        return False


class StepTimer:
    """Lightweight per-stage wall-clock accounting."""

    def __init__(self):
        self.totals = {}
        self.counts = {}

    def track(self, name: str):
        timer = self

        class _Ctx:
            def __enter__(self):
                self.t0 = time.perf_counter()

            def __exit__(self, *exc):
                dt = time.perf_counter() - self.t0
                timer.totals[name] = timer.totals.get(name, 0.0) + dt
                timer.counts[name] = timer.counts.get(name, 0) + 1
                return False

        return _Ctx()

    def summary(self):
        return {
            k: {"total_s": round(v, 4), "mean_ms": round(v / self.counts[k] * 1e3, 3)}
            for k, v in self.totals.items()
        }


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
