"""Bilinear grid sampling (renderer_cc_shadow.py:37-41 semantics).

align_corners=True with zero padding outside; callers overwrite
out-of-FOV altitude with -100 themselves. ``eogs2_tpu/ops/resample.py`` is a
jnp transcription of exactly this call (tests/test_ops.py holds it against
``F.grid_sample``), so the port calls it directly.
"""

from __future__ import annotations

import torch.nn.functional as F


def grid_sample(img, grid, align_corners: bool = True):
    """img [C,H,W], grid [Ho,Wo,2] of (u, v) in [-1, 1] -> [C,Ho,Wo]."""
    return F.grid_sample(img[None], grid[None], mode="bilinear",
                         padding_mode="zeros",
                         align_corners=align_corners)[0]
