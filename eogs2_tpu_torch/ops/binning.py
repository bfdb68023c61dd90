"""Tile binning of the dense modes: pairs per tile, depth-sorted, and the
dense [T, K] view of them.

Counterpart of ``eogs2_tpu/ops/binning.py``. The JAX package emits a static
[N, max_tiles_per_gaussian] table with pad entries because XLA's shapes are
static; here the emission is sized by demand and Gaussian-major
(ops/pair_pipeline.emit_pairs) with the same clamp: each Gaussian emits its
first min(tiles_touched, max_tiles_per_gaussian) rect tiles in row-major
order. One stable ``torch.sort`` of an int64 ``tile << 32 | depth_key(depth)``
key orders the pairs and ``searchsorted`` gives each tile's range, as for
the fused route. Tie order: two pairs with exactly equal (tile, depth) keys
composite in emission order, which is Gaussian-major here and tcap-major in
JAX's ``sorted`` mode.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from eogs2_tpu_torch.ops.projection import TILE


class Binning(NamedTuple):
    pair_gauss: torch.Tensor  # [P] int64 Gaussian of each sorted pair
    pair_tile: torch.Tensor  # [P] int64 tile of each sorted pair (no pads)
    tile_start: torch.Tensor  # [n_tiles] int32 first sorted pair of a tile
    tile_count: torch.Tensor  # [n_tiles] int32 pairs in each tile
    num_pairs: torch.Tensor  # [] demand, sum(tiles_touched) before clamping
    max_tile_count: torch.Tensor  # [] densest tile (after the tcap clamp)
    perm: torch.Tensor  # [P] sorted pair i came from emission pair perm[i]
    lengths: torch.Tensor  # [N] pairs each Gaussian emitted


def grid_dims(width: int, height: int):
    """(tiles across, tiles down) for a width x height canvas."""
    return (width + TILE - 1) // TILE, (height + TILE - 1) // TILE


def depth_key(depth):
    """float32 [N] -> int64 [N] in [0, 2^32) ordered as the floats.

    depth takes both signs (depth = -altitude), so the raw float bits would
    mis-order negative depths: the key flips all bits of a negative float
    and sets the sign bit of a positive one."""
    bits = depth.contiguous().view(torch.int32).to(torch.int64)
    return torch.where(bits < 0, ~bits & 0xFFFFFFFF, bits | 0x80000000)


def sort_emission(em, n_tiles: int):
    """Stable sort of an emission (ops/pair_pipeline.Emission, its key
    built) by (tile, depth[gid]).

    Returns (sorted gid, perm, tstart, cnt): perm is the sort's permutation,
    tstart/cnt [n_tiles] int32 each tile's range."""
    skey, perm = torch.sort(em.key, stable=True)
    bounds = torch.searchsorted(
        skey >> 32, torch.arange(n_tiles + 1, device=skey.device))
    tstart = bounds[:-1].to(torch.int32)
    cnt = (bounds[1:] - bounds[:-1]).to(torch.int32)
    return em.gid[perm], perm, tstart, cnt


def bin_gaussians(prep, width: int, height: int, pair_capacity: int = 0,
                  max_tiles_per_gaussian: int = 16) -> Binning:
    """The depth-sorted per-tile pair list of the dense modes.

    pair_capacity is accepted for JAX's signature and unused: the emission
    is sized by demand. prep is read detached (binning has no gradient)."""
    # imported here: pair_pipeline imports this module
    from eogs2_tpu_torch.ops.pair_pipeline import emit_pairs

    grid_x, grid_y = grid_dims(width, height)
    em = emit_pairs(prep, grid_x, tcap=max_tiles_per_gaussian,
                    depth=prep.depth.detach())
    sgid, perm, tstart, cnt = sort_emission(em, grid_x * grid_y)
    tiles = prep.tiles_touched.to(torch.int64)
    return Binning(
        pair_gauss=sgid,
        pair_tile=em.tile[perm],
        tile_start=tstart,
        tile_count=cnt,
        num_pairs=tiles.sum(),
        max_tile_count=cnt.max(),
        perm=perm,
        lengths=em.lengths,
    )


def tile_pair_indices(binning: Binning, tile_capacity: int):
    """Dense [n_tiles, K] view of the sorted pair list, K = tile_capacity.

    Returns (pair_idx, mask): pair_idx[t, k] indexes the sorted pairs, mask
    marks k < min(tile_count[t], K). Tiles denser than K drop their back
    pairs (the host picks K from max_tile_count, as in JAX); pair_idx is 0
    where the mask is off."""
    k = torch.arange(tile_capacity, device=binning.tile_start.device)
    idx = binning.tile_start.to(torch.int64)[:, None] + k[None, :]
    mask = k[None, :] < binning.tile_count.clamp_max(tile_capacity)[:, None]
    return torch.where(mask, idx, 0), mask
