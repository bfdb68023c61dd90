"""EOGS2 in PyTorch with hand-written CUDA kernels for NVIDIA Hopper.

The PyTorch/CUDA counterpart of ``eogs2_tpu`` (the JAX/Pallas package,
which stays the reference). Module layout and names mirror ``eogs2_tpu``
so each counterpart is easy to find. This package imports neither JAX nor
anything of ``eogs2_tpu``.

Ported so far: the serving path — forward render on the ``fused`` route
(preprocess -> demand-sized emission + sort -> the K1 blend kernel,
``csrc/fused_blend_fwd.cu``), sun resampling, shading and the Nadir DSM.
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
