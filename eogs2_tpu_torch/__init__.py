"""EOGS2 in PyTorch with hand-written CUDA kernels for NVIDIA Hopper.

The PyTorch/CUDA counterpart of ``eogs2_tpu`` (the JAX/Pallas package,
which stays the reference). Module layout and names mirror ``eogs2_tpu``
so each counterpart is easy to find. This package imports neither JAX nor
anything of ``eogs2_tpu``.

Ported so far: every route of ``rasterize`` with its kernels (``fused``:
K1/K2, ``csrc/fused_blend_{fwd,bwd}.cu``, and K3, their row-payload load;
``gather``/``sorted``: the plain dense blend or K4,
``csrc/blend_tiles_{fwd,bwd}.cu``); the serving path (sun resampling,
shading, the Nadir DSM and its MAE); every training recipe of
``config.PRESETS``, among them the paper's ``eogsplus``, in every modality
mode (``train.Trainer``: three renders per step and modality, the loss
stack, flow matching, Adam, densification, opacity and colour resets, the
flow bake, early stopping, hooks, reports, model saves and checkpoints;
``rescalers.py``, ``pansharpen.py``, ``color_ops.py``); and the host-side
surface: the CLI (``cli.py``),
``checkpoint.py``, ``render_artifacts.py``, ``video.py``, ``flow.py``,
``observability.py`` and the file formats of ``io/`` (TIFF, PNG and PLY
in numpy, so neither imageio nor Pillow is needed); and the multi-device
path (``parallel/``: the process group and mesh, the sharded Gaussian
state, the all_to_all pair-exchange rasterizer with K1/K2/K3 at a band
offset; sharded and multi-view training, the sharded TSDF, the CLI's
``--n-devices`` and multi-host options). ROADMAP.md lists what is left.
"""

__version__ = "0.1.0"

import torch as _torch

# float32 everywhere (counterpart of eogs2_tpu/__init__.py's "highest"
# matmul precision): reduced-precision matmuls destabilized training
# (DESIGN.md section 6), and cuDNN defaults to TF32 for convolutions.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from eogs2_tpu_torch.device import default_device  # noqa: E402,F401
from eogs2_tpu_torch.rasterizer import RasterizeConfig, rasterize  # noqa: E402,F401
from eogs2_tpu_torch.cameras import AffineCamera  # noqa: E402,F401
