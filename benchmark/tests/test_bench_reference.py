"""The reference against the port's CPU path at a tiny size: the render
(the fused route's plain versions) and a whole cell's comparison."""

import pytest
import torch

from benchmark.reference.render import render
from tiny import make_root, run_cell


def random_gaussians(n, seed):
    g = torch.Generator().manual_seed(seed)
    xyz = torch.rand((n, 3), generator=g) * 1.6 - 0.8
    scales = torch.exp(torch.rand((n, 3), generator=g) * 2 - 5.5)
    quats = torch.randn((n, 4), generator=g)
    opac = torch.rand(n, generator=g) * 0.9 + 0.05
    feats = torch.cat([torch.rand((n, 3), generator=g), xyz[:, 2:],
                       torch.ones(n, 1)], -1)
    return xyz, scales, quats, opac, feats


@pytest.mark.parametrize("seed", [0, 1])
def test_render_matches_port(seed):
    from eogs2_tpu_torch.rasterizer import RasterizeConfig, rasterize

    xyz, scales, quats, opac, feats = random_gaussians(3000, seed)
    aff = torch.tensor([[1.0, 0.1, -0.2, 0.0], [0.05, 1.0, 0.1, 0.0],
                        [0.0, 0.0, 1.0, 0.0]])
    bg = torch.tensor([0.2, 0.3, 0.4, -0.35, 0.0])
    ref = render(xyz, scales, quats, opac, feats, aff, bg, 96, 64, "fp32")
    out = rasterize(xyz, scales, quats, opac, feats, aff, bg, 96, 64,
                    RasterizeConfig(binning_mode="fused", tile_cull=True,
                                    eogs_features=True))
    torch.testing.assert_close(out.image, ref.image, atol=2e-5, rtol=0)
    torch.testing.assert_close(out.final_t, ref.final_t, atol=2e-6, rtol=0)


def test_render_gradients_match_port():
    from eogs2_tpu_torch.rasterizer import RasterizeConfig, rasterize

    xyz, scales, quats, opac, feats = random_gaussians(1500, 3)
    aff = torch.tensor([[1.0, 0.0, -0.1, 0.0], [0.0, 1.0, 0.2, 0.0],
                        [0.0, 0.0, 1.0, 0.0]])
    bg = torch.zeros(5)
    w = torch.randn(5, 48, 64, generator=torch.Generator().manual_seed(9))

    def grads(fn):
        leaves = [t.clone().requires_grad_(True)
                  for t in (xyz, scales, quats, opac, feats)]
        (fn(*leaves) * w).sum().backward()
        return [t.grad for t in leaves]

    got = grads(lambda *a: rasterize(
        *a, aff, bg, 64, 48, RasterizeConfig(binning_mode="fused",
                                             tile_cull=True)).image)
    want = grads(lambda *a: render(*a, aff, bg, 64, 48, "fp32").image)
    for g, r in zip(got, want):
        torch.testing.assert_close(g, r, atol=1e-4 * float(r.abs().max()),
                                   rtol=0)


@pytest.mark.parametrize("config,cell", [
    ("baseogs-1M-1024", "tiny.train"), ("baseogs-1M-1024", "tiny.render"),
    ("eogsplus-1M-1024", "tiny.train")])
def test_cell_correct_on_the_cpu(tmp_path, capsys, config, cell):
    root = make_root(str(tmp_path), config)
    rc, res, err = run_cell(root, cell, capsys)
    assert rc == 0 and res["correct"], err
    assert res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    for name, row in res["checks"].items():
        assert f"check {name} " in err
