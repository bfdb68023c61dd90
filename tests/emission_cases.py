"""Shared inputs of the emission tests (``tests/test_torch_emission.py`` on
the CPU, the ``cuda`` cases of ``tests/test_torch_kernels.py`` on the card):
a seeded scene whose first Gaussians are the emission's edge cases. Not a
test module; the test files import it by its base name, as pytest puts
``tests/`` on the import path.
"""

import numpy as np
import torch

from eogs2_tpu_torch.ops.binning import grid_dims
from eogs2_tpu_torch.ops.projection import (Preprocessed,
                                            compute_cov2d_direct,
                                            preprocess_gaussians)

W = H = 96


def special_prep(n=600, width=W, height=H, seed=0, device="cpu"):
    """A seeded Preprocessed of n Gaussians with the emission's edge cases
    in its first rows: 0 a Gaussian with no tile (tiles_touched 0), 1 the
    whole grid (wider than a warp's 32 tiles and than any small tcap, most
    of it culled), 2 a NaN conic, 3 a NaN opacity, 4 an indefinite conic,
    5 a faint Gaussian (opacity under 1/255: every tile culled). Returns
    (prep, features [n, 5])."""
    rng = np.random.RandomState(seed)
    means = rng.uniform(-0.95, 0.95, (n, 3))
    scales = np.exp(rng.uniform(np.log(0.01), np.log(0.2), (n, 3)))
    quats = rng.normal(0, 1, (n, 4))
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    opac = rng.uniform(0.002, 0.9, n)
    affine = np.array([[0.9, 0.05, 0.15, 0.01], [-0.04, 0.88, -0.2, -0.02],
                       [0.0, 0.0, 1.0, 0.0]])
    feat = np.concatenate([rng.uniform(0, 1, (n, 3)), means[:, 2:3],
                           np.ones((n, 1))], 1)
    t = [torch.tensor(a, dtype=torch.float32)
         for a in (means, scales, quats, opac, affine, feat)]
    cov2d = compute_cov2d_direct(t[1], t[2], t[4], width, height)
    p = preprocess_gaussians(t[0], None, t[3], t[4], width, height,
                             cov2d=cov2d)
    gx, gy = grid_dims(width, height)
    rect_min, rect_size = p.rect_min.clone(), p.rect_size.clone()
    conic, opacity = p.conic.clone(), p.opacity.clone()
    mean2d = p.mean2d.clone()
    rect_size[0] = 0
    rect_min[1], rect_size[1] = torch.tensor([0, 0]), torch.tensor([gx, gy])
    mean2d[1] = torch.tensor([0.5 * width, 0.4 * height])
    conic[1] = torch.tensor([0.02, 0.0, 0.03])
    opacity[1] = 0.5
    conic[2, 1] = float("nan")
    opacity[3] = float("nan")
    conic[4] = torch.tensor([0.05, 0.2, 0.04])
    opacity[5] = 1e-3
    for i in (2, 3, 4, 5):
        rect_min[i] = torch.tensor([1, 1])
        rect_size[i] = torch.tensor([3, 2])
    prep = Preprocessed(mean2d, p.depth, conic, opacity, p.radius, rect_min,
                        rect_size, rect_size[:, 0] * rect_size[:, 1])
    return (Preprocessed(*(x.to(device) for x in prep)),
            t[5].to(device))
