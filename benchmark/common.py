"""What the kinds of traffic share: the Run a kind hands back, the loading
of a kind or a reader by name, the cell's scene and the program's config
and scene objects made from it.

A kind is a module ``benchmark/kinds/<kind>.py``, named by the ``kind`` of
a traffic mix's data file, with

- ``run(cell, cfg, traffic, args, device, t0) -> Run``: set-up, the timed
  window of ``args.seconds``, with ``args.trace`` the traced window, and
  what the check compares. ``device`` is the first card (or, in the tests,
  the CPU); a kind whose cell asks for several chips starts its ranks
  itself, one card each, and hands back rank 0's Run.
- ``check(cfg, traffic, run, seed, device) -> {number: value}``: the
  program's outputs of the timed path against the plain reference.
- ``readings(cfg, traffic, seed, device) -> {reading: {number: value}}``:
  the program's, the control's and the faults' readings that the limits
  are set from (``control.py``).

So a new mix of a kind is one data file; a new kind is one module more.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import os
import re
import sys
from typing import Optional

import torch

from benchmark.scene import make_scene
from benchmark.tracing import Trace


@dataclasses.dataclass
class Run:
    setup_s: float = 0.0
    window_s: float = 0.0
    done: int = 0  # steps or requests completed in the window
    failed: int = 0
    latencies: list = dataclasses.field(default_factory=list)
    unit_s: list = dataclasses.field(default_factory=list)  # host time a unit
    trace: Optional[Trace] = None
    traced_units: int = 0
    counters: dict = dataclasses.field(default_factory=dict)
    work: dict = dataclasses.field(default_factory=dict)
    memory_peak_bytes: int = 0
    program_out: dict = dataclasses.field(default_factory=dict)
    scene: object = None
    setup_parts: dict = dataclasses.field(default_factory=dict)  # seconds


def load_module(path: str, prefix: str):
    """The module of the file at ``path``, loaded once under a name made
    from ``prefix`` and the file's whole path."""
    name = prefix + re.sub(r"\W", "_", os.path.abspath(path)[:-3])
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return sys.modules[name]


def load_kind(root: str, kind: str):
    return load_module(os.path.join(root, "benchmark", "kinds", f"{kind}.py"),
                       "bench_kind_")


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def free(device):
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def cell_scene(cfg: dict, device):
    """The configuration's scene: one dataset for every run, drawn from the
    configuration's own ``scene.seed`` (--seed changes the order and the
    draws of the work, never the dataset)."""
    return make_scene(cfg["scene"], cfg["scene"]["seed"], device)


def trainer_seed(seed: int) -> int:
    return seed % 2**32


def program_config(cfg: dict, seed: int):
    """The program's TrainConfig: the preset with the configuration's
    recipe values set, the Trainer's seed from --seed."""
    from eogs2_tpu_torch.config import PRESETS

    tc = PRESETS[cfg["preset"]](iterations=cfg["iterations"])
    for key, value in cfg["recipe"].items():
        for node in (tc.optimization, tc.model, tc.model.camera_params):
            if hasattr(node, key):
                if isinstance(value, dict):  # a nested group, key by key
                    for k, v in value.items():
                        if not hasattr(getattr(node, key), k):
                            raise KeyError(f"recipe key {key}.{k} is not in "
                                           f"the program's config")
                        setattr(getattr(node, key), k, v)
                else:
                    setattr(node, key, value)
                break
        else:
            raise KeyError(f"recipe key {key} is not in the program's config")
    tc.seed = trainer_seed(seed)
    return tc


def program_scene(scene, device):
    from eogs2_tpu_torch.scene import build_scene

    images = {k: v.cpu().numpy() for k, v in scene.images.items()}
    pan = (None if scene.images_pan is None else
           {k: v.cpu().numpy() for k, v in scene.images_pan.items()})
    return build_scene(scene.metadatas, images, pan,
                       split=(scene.train_names, scene.test_names),
                       init_points=(scene.init_xyz.cpu().numpy(),
                                    scene.init_rgb.cpu().numpy()),
                       device=device)
