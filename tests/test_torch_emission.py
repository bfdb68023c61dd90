"""The emission's per-Gaussian counts and its waits for the card
(``eogs2_tpu_torch/ops/pair_pipeline.py``), on the CPU, torch on one thread.

``emit_pairs`` returns each Gaussian's pair count beside the pairs; the
sort, ``SortedPairs`` and ``rasterize_fused`` take it where they counted
the pairs again with ``bincount``. On the card the emission is the two
passes of ``csrc/emit_pairs.cu`` around one read of the total; here that
path runs with the passes replaced by the plain version (counted nothing),
so what is counted is what the code around the kernels waits for.
"""

import pytest
import torch

from eogs2_tpu_torch.observability import tracer
from eogs2_tpu_torch.ops import fused_raster, pair_pipeline
from eogs2_tpu_torch.ops.binning import depth_key, grid_dims
from eogs2_tpu_torch.ops.fused_raster import rasterize_fused, sort_pairs
from eogs2_tpu_torch.ops.pair_pipeline import (emit_pairs, emit_walk_plain,
                                               walk_of)
from eogs2_tpu_torch.ops.projection import Preprocessed

from emission_cases import H, W, special_prep


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run this file's torch ops on one thread (see test_torch_fused.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def clean_tracer():
    tracer.enable(False)
    tracer.reset()
    yield
    tracer.enable(False)
    tracer.reset()


@pytest.mark.parametrize("tile_cull,tcap", [(False, None), (False, 3),
                                            (True, None), (True, 3)])
def test_counts_equal_bincount(tile_cull, tcap):
    prep, _ = special_prep()
    gx, _ = grid_dims(W, H)
    em = emit_pairs(prep, gx, tile_cull=tile_cull, tcap=tcap,
                    depth=prep.depth)
    n = prep.depth.shape[0]
    assert em.lengths.dtype == torch.int64 and em.lengths.shape == (n,)
    assert torch.equal(em.lengths, torch.bincount(em.gid, minlength=n))
    # Gaussian-major, each Gaussian's tiles in row-major order
    assert (em.gid[1:] >= em.gid[:-1]).all()
    same = em.gid[1:] == em.gid[:-1]
    assert (em.tile[1:][same] > em.tile[:-1][same]).all()
    assert torch.equal(em.key, (em.tile << 32) | depth_key(prep.depth)[em.gid])
    tiles = prep.tiles_touched.to(torch.int64)
    if tcap is not None:
        tiles = tiles.clamp_max(tcap)
    assert em.lengths[0] == 0 and em.lengths[1] <= tiles[1]
    if tile_cull:
        assert (em.lengths <= tiles).all() and em.lengths[5] == 0
        assert 0 < em.lengths[1] < tiles[1] or tcap is not None
        # a NaN conic or opacity culls nothing: its qmin or tau is NaN
        assert em.lengths[2] == tiles[2] and em.lengths[3] == tiles[3]
    else:
        assert torch.equal(em.lengths, tiles)


def test_sorted_pairs_carry_counts_and_stats_unchanged():
    """SortedPairs carries the counts; rasterize_fused's num_pairs and
    bulk_max_tiles are what the bincount of the pairs gave."""
    prep, feat = special_prep(seed=1)
    n = prep.depth.shape[0]
    for cull in (False, True):
        sp = sort_pairs(prep, feat, W, H, tile_cull=cull, eogs=True)
        assert torch.equal(sp.lengths, torch.bincount(sp.gid, minlength=n))
        assert int(sp.cnt.sum()) == sp.gid.shape[0]
        out = rasterize_fused(prep, feat, W, H, eogs_features=True,
                              tile_cull=cull)
        active = torch.bincount(sp.gid, minlength=n)
        tiles = prep.tiles_touched.to(torch.int64)
        assert out.num_pairs.dtype == torch.int64
        if cull:
            assert int(out.num_pairs) == sp.gid.shape[0]
            assert int(out.bulk_max_tiles) == int(active.max())
        else:
            assert int(out.num_pairs) == int(tiles.sum())
            assert int(out.bulk_max_tiles) == int(tiles.max())
        assert torch.equal(out.tile_count, sp.cnt)


def _card_path(monkeypatch):
    """Route the fused render through the card's emission (emit_walk) with
    the two kernel passes replaced by the plain version, which the tracer
    does not count; returns the passes' calls."""
    calls = []

    def plain(w, grid_x, depth=None):
        tracer.enable(False)
        try:
            return emit_walk_plain(w, grid_x, depth)
        finally:
            tracer.enable(True)

    def count(w, grid_x):
        calls.append("count")
        return plain(w, grid_x).lengths

    def write(w, grid_x, ends, lengths, total, depth=None):
        calls.append("write")
        assert torch.equal(ends, torch.cumsum(lengths, 0))
        em = plain(w, grid_x, depth)
        assert total == em.gid.shape[0] and torch.equal(em.lengths, lengths)
        return em.gid, em.tile, em.key

    def emit(prep, grid_x, tile_cull=False, tcap=None, depth=None):
        return pair_pipeline.emit_walk(walk_of(prep, tile_cull, tcap),
                                       grid_x, depth)

    monkeypatch.setattr(pair_pipeline, "count_pairs", count)
    monkeypatch.setattr(pair_pipeline, "write_pairs", write)
    monkeypatch.setattr(fused_raster, "emit_pairs", emit)
    return calls


@pytest.mark.parametrize("tile_cull", [False, True])
def test_one_wait_per_render_on_the_card_path(monkeypatch, tile_cull):
    """A fused render waits for the card once in the emission and the sort
    together (emit.total) on the card's path; the CPU's plain path waits
    there three times with the cull (the total, the two masks) and once
    without. Both give the same render."""
    prep, feat = special_prep(seed=2)
    tracer.enable()
    plain = rasterize_fused(prep, feat, W, H, eogs_features=True,
                            tile_cull=tile_cull)
    sites = tracer.summary()["reads"][""]
    emission = {k: v["count"] for k, v in sites.items()
                if k.startswith(("emit.", "sort.", "raster."))}
    assert emission == ({"emit.total": 1, "emit.cull_gid": 1,
                         "emit.cull_tile": 1} if tile_cull
                        else {"emit.total": 1})
    tracer.reset()
    calls = _card_path(monkeypatch)
    card = rasterize_fused(prep, feat, W, H, eogs_features=True,
                           tile_cull=tile_cull)
    sites = tracer.summary()["reads"][""]
    emission = {k: v["count"] for k, v in sites.items()
                if k.startswith(("emit.", "sort.", "raster."))}
    assert emission == {"emit.total": 1}
    assert calls == ["count", "write"]
    for a, b in zip(plain, card):
        assert torch.equal(a, b)


def test_empty_scene_and_all_culled():
    gx, _ = grid_dims(W, H)
    prep, feat = special_prep()
    empty = Preprocessed(*(x[:0] for x in prep))
    em = emit_pairs(empty, gx, tile_cull=True, depth=empty.depth)
    assert em.gid.shape == em.tile.shape == em.key.shape == (0,)
    assert em.lengths.shape == (0,)
    # every Gaussian under 1/255 (past the NaN conic, which culls nothing)
    rest = Preprocessed(*(x[6:] for x in prep))
    faint = rest._replace(opacity=torch.full_like(rest.opacity, 1e-3))
    em = emit_pairs(faint, gx, tile_cull=True, depth=faint.depth)
    assert em.gid.shape == (0,) and (em.lengths == 0).all()
    assert int(faint.tiles_touched.sum()) > 0
    out = rasterize_fused(faint, feat[6:], W, H, eogs_features=True,
                          tile_cull=True)
    assert int(out.num_pairs) == 0 and int(out.bulk_max_tiles) == 0
    assert (out.out8[..., 5] == 1).all() and (out.tile_count == 0).all()


def test_kernel_passes_take_only_card_tensors():
    """The passes of csrc/emit_pairs.cu launch only on CUDA tensors of the
    walk's shapes; emit_pairs takes the plain version for CPU tensors and
    raises on any other device."""
    prep, _ = special_prep()
    gx, _ = grid_dims(W, H)
    w = walk_of(prep, tile_cull=True)
    with pytest.raises(ValueError, match="not a CUDA device"):
        pair_pipeline.count_pairs(w, gx)
    n = prep.depth.shape[0]
    ends = torch.zeros(n, dtype=torch.int64)
    with pytest.raises(ValueError, match="depth must be"):
        pair_pipeline.write_pairs(w, gx, ends, ends, 0, prep.depth[:3])
    with pytest.raises(ValueError, match="unsupported device"):
        emit_pairs(Preprocessed(*(x.to("meta") for x in prep)), gx)
