"""The frozen operation and byte counts on a case counted by hand."""

import pytest
import torch

from benchmark import counts
from benchmark.reference.render import blend_work, render


def one_tile_scene():
    """Two Gaussians on one 16x16 tile seen through the identity affine:
    a point-sized one of opacity 0.9 centred on pixel (4, 4), whose alpha
    reaches 1/255 at the pixel and its 8 neighbours only (power -1/(2*0.3)
    per unit step, dilation 0.3: alpha 0.9, 0.170, 0.032 at distances 0,
    1, sqrt 2; 0.0011 at 2), and one of opacity 0.002 at (12, 12), whose
    alpha never reaches 1/255."""
    def ndc(p):
        return (2 * p + 1) / 16 - 1

    xyz = torch.tensor([[ndc(4), ndc(4), 0.0], [ndc(12), ndc(12), -0.1]])
    scales = torch.full((2, 3), 1e-6)
    quats = torch.tensor([[1.0, 0, 0, 0]] * 2)
    opac = torch.tensor([0.9, 0.002])
    feats = torch.cat([torch.rand(2, 3), xyz[:, 2:], torch.ones(2, 1)], -1)
    aff = torch.tensor([[1.0, 0, 0, 0], [0, 1.0, 0, 0], [0, 0, 1.0, 0]])
    return render(xyz, scales, quats, opac, feats, aff, torch.zeros(5), 16,
                  16, "fp32"), feats


def test_hand_counted_work():
    r, feats = one_tile_scene()
    w = blend_work(r, feats)
    assert w == dict(composites=9, pairs_used=1, tiles=1, pixels=256,
                     gaussians=2, pairs_listed=1)
    assert counts.k1(w) == dict(ops=31 * 9, bytes=44 + 8 + 32 * 256)
    assert counts.k2(w) == dict(ops=75 * 9 + 10 * 256,
                                bytes=88 + 2 * 32 * 256 + 8)
    assert counts.bound_s(counts.k1(w)) == pytest.approx(
        (44 + 8 + 32 * 256) / 3.35e12)


def test_step_and_request_totals():
    r, feats = one_tile_scene()
    w = blend_work(r, feats)
    step = counts.train_step_ops([w] * 3, n_params=28, height=16, width=16)
    blends = 3 * (31 * 9 + 75 * 9 + 10 * 256)
    pre = 3 * 3 * counts.PREPROCESS_OPS * 2
    pixels = 3 * (2 * counts.RESAMPLE_OPS_PER_PIXEL + counts.PIXEL_OPS
                  + counts.SSIM_OPS_PER_PIXEL) * 256
    assert step == blends + pre + pixels + counts.ADAM_OPS * 28
    req = counts.render_ops([w] * 2, height=16, width=16)
    assert req == 2 * (31 * 9 + counts.PREPROCESS_OPS * 2) + (
        counts.RESAMPLE_OPS_PER_PIXEL + counts.PIXEL_OPS) * 256


@pytest.mark.parametrize("kind", ["train", "render"])
def test_counted_units_are_the_traced_ones(tmp_path, kind):
    """The counts of a traced run cover exactly its traced steps or
    requests, not the host-named ones after them."""
    import argparse
    import time

    from benchmark.common import load_kind
    from benchmark.run import load_cell
    from tiny import make_root

    root = make_root(str(tmp_path))
    cell, cfg, traffic, _, _ = load_cell(root, f"tiny.{kind}")
    args = argparse.Namespace(seed=11, seconds=0.2, trace=1)
    run = load_kind(root, kind).run(cell, cfg, traffic, args,
                                    torch.device("cpu"), time.perf_counter())
    assert len(run.work["steps"]) == run.traced_units > 0
    assert run.work["ops"] > 0
