"""Tile grid helpers (the dense gather binning arrives with the gather mode)."""

from __future__ import annotations

from eogs2_tpu_torch.ops.projection import TILE


def grid_dims(width: int, height: int):
    """(tiles across, tiles down) for a width x height canvas."""
    return (width + TILE - 1) // TILE, (height + TILE - 1) // TILE
