"""Hand-written CUDA kernels against their plain PyTorch versions, on the
card. Marked ``cuda``: they skip where no CUDA device is present (CUDA
kernels have no CPU or interpret mode; the CPU tests hold the plain
versions against JAX instead). The file imports neither JAX nor
eogs2_tpu, so it runs on a machine with the card and no JAX, without the
JAX test harness of tests/conftest.py:

    python -m pytest tests/test_torch_kernels.py -m cuda --noconftest

Tolerances: K1's channels 0-4 atol 2e-4 and final_T atol 2e-5, those of
tests/test_golden.py (pairs at the 1/255 and T_EPS edges may be decided
differently after a one-ulp difference in exp). K2 and the gradients of
rasterize: per payload row / per input, max-abs error over the max-abs
value < 2e-4 (test_golden.py's gradient tolerance; sums over pixels run in
another order).
"""

import numpy as np
import pytest
import torch

from eogs2_tpu_torch.ops.fused_raster import (fused_blend_bwd,
                                              fused_blend_bwd_plain,
                                              fused_blend_fwd,
                                              fused_blend_fwd_plain,
                                              sort_pairs)
from eogs2_tpu_torch.ops.projection import (compute_cov2d_direct,
                                            preprocess_gaussians)
from eogs2_tpu_torch.rasterizer import (RasterizeConfig, rasterize,
                                        reference_rasterize)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the K1 and K2 kernels run only "
                    "on the card")
    return torch.device("cuda")


def _scene(device, n, seed):
    """tests/test_rasterizer.make_scene's seeded scene, built here without
    JAX: means, scales, quats, opacities, features (rgb, altitude, 1),
    affine, bg."""
    rng = np.random.RandomState(seed)
    means = rng.uniform(-0.9, 0.9, (n, 3))
    scales = np.exp(rng.uniform(np.log(0.02), np.log(0.08), (n, 3)))
    quats = rng.normal(0, 1, (n, 4))
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    opac = rng.uniform(0.05, 0.8, (n,))
    rgb = rng.uniform(0, 1, (n, 3))
    affine = np.array([[0.9, 0.05, 0.15, 0.01], [-0.04, 0.88, -0.2, -0.02],
                       [0.0, 0.0, 1.0, 0.0]])
    alt = means @ affine[2, :3] + affine[2, 3]
    feat = np.concatenate([rgb, alt[:, None], np.ones((n, 1))], axis=1)
    bg = np.array([0.3, 0.5, 0.2, -1.0, 0.0])
    return [torch.tensor(a, dtype=torch.float32, device=device)
            for a in (means, scales, quats, opac, feat, affine, bg)]


@pytest.mark.cuda
@pytest.mark.parametrize("tile_cull", [False, True])
@pytest.mark.parametrize("wh", [(128, 128), (80, 48)])
def test_k1_matches_plain(cuda, tile_cull, wh):
    w, h = wh
    args = _scene(cuda, 2048, seed=3)
    cov2d = compute_cov2d_direct(args[1], args[2], args[5], w, h)
    prep = preprocess_gaussians(args[0], None, args[3], args[5], w, h,
                                cov2d=cov2d)
    sp = sort_pairs(prep, args[4], w, h, tile_cull=tile_cull)
    before = fused_blend_fwd.launches
    k = fused_blend_fwd(sp.pay, sp.tstart, sp.cnt, (w + 15) // 16)
    assert fused_blend_fwd.launches == before + 1
    p = fused_blend_fwd_plain(sp.pay, sp.tstart, sp.cnt, (w + 15) // 16)
    torch.cuda.synchronize()
    assert torch.isfinite(k).all()
    torch.testing.assert_close(k[..., :5], p[..., :5], atol=2e-4, rtol=0)
    torch.testing.assert_close(k[..., 5], p[..., 5], atol=2e-5, rtol=0)
    assert (k[..., 7] == 0).all()


@pytest.mark.cuda
def test_fused_render_on_card_matches_oracle(cuda):
    args = _scene(cuda, 512, seed=7)
    out = rasterize(*args, 128, 128, RasterizeConfig(binning_mode="fused"))
    img, ft, _ = reference_rasterize(*args, 128, 128)
    torch.testing.assert_close(out.image, img, atol=5e-5, rtol=1e-4)
    torch.testing.assert_close(out.final_t, ft, atol=5e-5, rtol=1e-4)


@pytest.mark.cuda
def test_k1_rejects_bad_inputs(cuda):
    pay = torch.zeros((11, 8), device=cuda)
    idx = torch.zeros((4,), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="float32"):
        fused_blend_fwd(pay.double(), idx, idx, 2)
    with pytest.raises(ValueError, match="int32"):
        fused_blend_fwd(pay, idx.long(), idx, 2)
    with pytest.raises(ValueError, match="contiguous"):
        fused_blend_fwd(pay.t().contiguous().t(), idx, idx, 2)


def _row_err(got, want):
    """Per payload row: max |got - want| / max |want|; the worst row."""
    scale = want.abs().amax(dim=1).clamp_min(1e-30)
    return float(((got - want).abs().amax(dim=1) / scale).max())


@pytest.mark.cuda
@pytest.mark.parametrize("tile_cull", [False, True])
@pytest.mark.parametrize("wh", [(128, 128), (80, 48)])
def test_k2_matches_plain(cuda, tile_cull, wh):
    w, h = wh
    args = _scene(cuda, 2048, seed=3)
    cov2d = compute_cov2d_direct(args[1], args[2], args[5], w, h)
    prep = preprocess_gaussians(args[0], None, args[3], args[5], w, h,
                                cov2d=cov2d)
    sp = sort_pairs(prep, args[4], w, h, tile_cull=tile_cull, eogs=True)
    gx = (w + 15) // 16
    out8 = fused_blend_fwd(sp.pay, sp.tstart, sp.cnt, gx)
    gen = torch.Generator(device=cuda).manual_seed(0)
    g_out8 = torch.randn(out8.shape, generator=gen, device=cuda)
    before = fused_blend_bwd.launches
    k = fused_blend_bwd(sp.pay, sp.tstart, sp.cnt, out8, g_out8, gx)
    assert fused_blend_bwd.launches == before + 1
    p = fused_blend_bwd_plain(sp.pay, sp.tstart, sp.cnt, out8, g_out8, gx)
    torch.cuda.synchronize()
    assert torch.isfinite(k).all()
    assert _row_err(k[:10], p[:10]) < 2e-4  # the constant row has none
    # deterministic: no atomics, the same bits on a second launch
    k2 = fused_blend_bwd(sp.pay, sp.tstart, sp.cnt, out8, g_out8, gx)
    assert torch.equal(k, k2)


@pytest.mark.cuda
def test_rasterize_grads_on_card_match_cpu(cuda):
    """Every input's gradient through the kernels on the card against the
    plain versions on the CPU."""
    ct = torch.from_numpy(np.random.RandomState(0).normal(
        size=(5, 128, 128)).astype(np.float32))
    grads = []
    for dev in (cuda, torch.device("cpu")):
        args = _scene(dev, 512, seed=7)
        leaves = [a.clone().requires_grad_(True) for a in args[:6]]
        off = torch.zeros((512, 2), device=dev, requires_grad=True)
        out = rasterize(*leaves, args[6], 128, 128,
                        RasterizeConfig(binning_mode="fused",
                                        eogs_features=True),
                        mean2d_ndc_offset=off)
        (out.image * ct.to(dev)).sum().backward()
        grads.append([x.grad.cpu() for x in leaves + [off]])
    for got, want in zip(*grads):
        assert float((got - want).abs().max()
                     / want.abs().max().clamp_min(1e-30)) < 2e-4


@pytest.mark.cuda
def test_k2_rejects_bad_inputs(cuda):
    pay = torch.zeros((11, 8), device=cuda)
    idx = torch.zeros((4,), dtype=torch.int32, device=cuda)
    out8 = torch.zeros((4, 256, 8), device=cuda)
    with pytest.raises(ValueError, match="float32"):
        fused_blend_bwd(pay, idx, idx, out8.double(), out8, 2)
    with pytest.raises(ValueError, match="int32"):
        fused_blend_bwd(pay, idx, idx.long(), out8, out8, 2)
    with pytest.raises(ValueError, match="contiguous"):
        fused_blend_bwd(pay, idx, idx, out8,
                        out8.transpose(0, 1).contiguous().transpose(0, 1), 2)
