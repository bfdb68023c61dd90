"""The port stands alone: eogs2_tpu_torch imports neither JAX nor anything
of eogs2_tpu (whose name it shares as a prefix, so every check matches the
module name ``eogs2_tpu`` or the prefix ``eogs2_tpu.``, never a bare string
prefix), and its entry points default to CUDA and raise without it."""

import ast
import os
import pkgutil
import subprocess
import sys

import pytest
import torch

import eogs2_tpu_torch
from eogs2_tpu_torch import default_device

PKG_DIR = os.path.dirname(eogs2_tpu_torch.__file__)
ROOT = os.path.dirname(PKG_DIR)
FORBIDDEN_ROOTS = ("jax", "jaxlib", "flax", "optax", "eogs2_tpu")


def _forbidden(module: str) -> bool:
    return any(module == r or module.startswith(r + ".")
               for r in FORBIDDEN_ROOTS)


def _modules():
    names = ["eogs2_tpu_torch"]
    for info in pkgutil.walk_packages([PKG_DIR], prefix="eogs2_tpu_torch."):
        names.append(info.name)
    return names


def test_module_walk_reaches_the_multi_device_package():
    names = _modules()
    for mod in ("parallel", "parallel.distributed", "parallel.mesh",
                "parallel.sharded_raster"):
        assert f"eogs2_tpu_torch.{mod}" in names, mod


def test_forbidden_matcher_respects_the_shared_prefix():
    assert _forbidden("eogs2_tpu") and _forbidden("eogs2_tpu.ops.blend")
    assert _forbidden("jax.numpy") and _forbidden("flax")
    assert not _forbidden("eogs2_tpu_torch")
    assert not _forbidden("eogs2_tpu_torch.ops.fused_raster")
    assert not _forbidden("jaxtyping")


def test_importing_every_module_loads_no_jax():
    mods = _modules()
    for m in ("ops.fused_raster", "ops.blend_cuda", "ops.blend",
              "ops.binning", "ops.pair_pipeline", "pipeline", "train",
              "losses", "config", "densify", "ops.ssim", "ops.knn",
              "data.synthetic", "cli", "checkpoint", "flow", "observability",
              "render_artifacts", "video", "io.tiff", "io.png", "io.ply"):
        assert "eogs2_tpu_torch." + m in mods, m
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        f"roots = {FORBIDDEN_ROOTS!r}\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if any(m == r or m.startswith(r + '.') for r in roots))\n"
        "print(repr(bad))\n"
    )
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]", proc.stdout


def test_importing_every_module_loads_no_optional_library():
    """The card's machine has none of these: no module of the package may
    need one to import (a module imports one, where it must, only in the
    function that reads a file outside the port's own codecs)."""
    code = (
        "import importlib, sys\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "roots = ('imageio', 'PIL', 'cv2', 'orbax', 'tensorboard')\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if any(m == r or m.startswith(r + '.') for r in roots))\n"
        "print(repr(bad))\n"
    )
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]", proc.stdout


def test_no_forbidden_import_in_source():
    """The package and chip_smoke.py, which drives it on the card."""
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, files in os.walk(PKG_DIR):
        paths += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    bad = []
    for path in paths:
        with open(path) as fh:
            tree = ast.parse(fh.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [(path, n) for n in names if _forbidden(n)]
    assert len(paths) > 20 and not bad, bad


def test_precision_is_pinned_to_float32():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_default_device_raises_without_cuda(monkeypatch):
    import numpy as np

    from eogs2_tpu_torch.cameras import camera_from_reference_convention
    from eogs2_tpu_torch.config import baseogs
    from eogs2_tpu_torch.model import GaussianModel, init_from_points
    from eogs2_tpu_torch.shading import init_shading_params
    from eogs2_tpu_torch.train import Trainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        default_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        camera_from_reference_convention([[1, 0, 0], [0, 1, 0], [0, 0, 1]],
                                         [0, 0, 0])
    with pytest.raises(RuntimeError, match="CUDA"):
        init_shading_params(1)
    with pytest.raises(RuntimeError, match="CUDA"):
        GaussianModel.from_numpy({}, {})
    with pytest.raises(RuntimeError, match="CUDA"):
        init_from_points(np.zeros((8, 3), np.float32),
                         np.ones((8, 3), np.float32), 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(baseogs(), scene=None).setup()
    # an explicit device is honoured
    cam = camera_from_reference_convention(
        [[1, 0, 0], [0, 1, 0], [0, 0, 1]], [0, 0, 0], device="cpu")
    assert cam.device.type == "cpu"
