"""Spherical-harmonics DC band <-> RGB (reference utils/sh_utils.py).

The EOGS recipes run with sh_degree=0, so only the DC band is on the path;
``eval_sh`` for higher degrees arrives when a path needs it. Both functions
work on torch tensors and numpy arrays alike.
"""

from __future__ import annotations

C0 = 0.28209479177387814


def RGB2SH(rgb):
    return (rgb - 0.5) / C0


def SH2RGB(sh):
    return sh * C0 + 0.5
