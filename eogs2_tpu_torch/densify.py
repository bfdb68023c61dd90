"""Pruning as a masked update of the fixed-capacity model.

Counterpart of the ``only_prune`` path of ``eogs2_tpu/densify.py``
(train_pan.py:674-677): a pruned Gaussian's slot is marked dead in the
``alive`` buffer; its parameters and Adam moments stay where they are, and
a dead slot is never rendered. Both functions update the buffer in place.

Densification by clone/split, the size-based prune mask and the opacity
reset with its Adam-moment surgery are not ported yet (ROADMAP Queue 1
item 7); the Trainer raises where a recipe needs them.
"""

from __future__ import annotations

import torch

from eogs2_tpu_torch.model import GaussianModel


@torch.no_grad()
def prune_transparent(model: GaussianModel, min_opacity_raw: float) -> None:
    """Kill the Gaussians whose RAW (logit) opacity is below
    ``min_opacity_raw`` (train_pan.py:674-677 compares _opacity < -6.0)."""
    apply_prune(model, model.opacity[:, 0] < min_opacity_raw)


@torch.no_grad()
def apply_prune(model: GaussianModel, kill) -> None:
    model.alive &= ~kill
