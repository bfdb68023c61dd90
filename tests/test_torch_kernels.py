"""Hand-written CUDA kernels against their plain PyTorch versions, on the
card. Marked ``cuda``: they skip where no CUDA device is present (CUDA
kernels have no CPU or interpret mode; the CPU tests hold the plain
versions against JAX instead). The file imports neither JAX nor
eogs2_tpu, so it runs on a machine with the card and no JAX, without the
JAX test harness of tests/conftest.py:

    python -m pytest tests/test_torch_kernels.py -m cuda --noconftest

Tolerances: K1's and K4's channels 0-4 atol 2e-4 and final_T atol 2e-5,
those of tests/test_golden.py (pairs at the 1/255 and T_EPS edges may be
decided differently after a one-ulp difference in exp); K1's and K4's
n_contrib exact. K2, K4 backward and the gradients of rasterize: per payload row /
per input, max-abs error over the max-abs value < 2e-4 (test_golden.py's
gradient tolerance; sums over pixels run in another order). K3 equals
K1/K2 bit for bit (the same arithmetic, another load). The emission's
two passes (csrc/emit_pairs.cu) equal the plain emission bit for bit.
Beside them, render_view_full's copy-out into page-locked host slots
equals the blocking copies it replaced bit for bit.
"""

import numpy as np
import pytest
import torch

from eogs2_tpu_torch import densify, pipeline
from eogs2_tpu_torch.config import baseogs
from eogs2_tpu_torch.model import GaussianModel
from eogs2_tpu_torch.ops.blend_cuda import (blend_backward,
                                            blend_backward_plain,
                                            blend_forward, blend_forward_plain,
                                            slots_in_use)
from eogs2_tpu_torch.ops.fused_raster import (NF, fused_blend_bwd,
                                              fused_blend_bwd_plain,
                                              fused_blend_bwd_rows,
                                              fused_blend_fwd,
                                              fused_blend_fwd_plain,
                                              fused_blend_fwd_rows,
                                              rasterize_fused, sort_pairs)
from eogs2_tpu_torch.ops.pair_pipeline import (count_pairs, emit_pairs,
                                               emit_walk_plain, walk_of,
                                               write_pairs)
from eogs2_tpu_torch.ops.projection import (Preprocessed,
                                            compute_cov2d_direct,
                                            preprocess_gaussians)
from eogs2_tpu_torch.rasterizer import (RasterizeConfig, rasterize,
                                        reference_rasterize)
from eogs2_tpu_torch.train import gaussian_optimizer
# tests/ is on sys.path: pytest imports these files by their base name
from emission_cases import special_prep


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels run "
                    "only on the card")
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
@pytest.mark.parametrize("wh", [(128, 128), (80, 48), (176, 32)])
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
    assert torch.equal(k[..., 6], p[..., 6])
    assert (k[..., 7] == 0).all()


def _long_tiles(device, seed=0):
    """A sorted column payload over a 4 x 2 tile grid (64 x 32 pixels) whose
    tiles hold 700 (three 256-pair batches), 0, 300 (opaque: its pixels
    stop early), 513, 0, 40, 1 and 256 pairs. Gaussians of 1.5-4 px near
    their tile, opacities 0.005-0.05 (pixels that never saturate walk every
    batch) except in the opaque tile."""
    rng = np.random.RandomState(seed)
    counts = [700, 0, 300, 513, 0, 40, 1, 256]
    cols = []
    for t, c in enumerate(counts):
        ox, oy = (t % 4) * 16, (t // 4) * 16
        sig = rng.uniform(1.5, 4.0, (c, 2))
        op = rng.uniform(0.5, 0.99, c) if t == 2 else rng.uniform(0.005,
                                                                  0.05, c)
        cols.append(np.stack([
            ox + rng.uniform(-4, 20, c), oy + rng.uniform(-4, 20, c),
            1 / sig[:, 0] ** 2, rng.uniform(-0.02, 0.02, c),
            1 / sig[:, 1] ** 2, op, *rng.uniform(0, 1, (5, c))]))
    pay = np.concatenate(cols, 1).astype(np.float32)
    cnt = np.array(counts, np.int32)
    tstart = np.concatenate([[0], np.cumsum(cnt)[:-1]]).astype(np.int32)
    return [torch.tensor(a, device=device) for a in (pay, tstart, cnt)]


@pytest.mark.cuda
def test_k1_k2_long_and_empty_tiles(cuda):
    """K1, K2 and K3 over three batches in one tile, over tiles with no
    pair and one pair, and at a batch edge, against the plain versions."""
    pay, tstart, cnt = _long_tiles(cuda)
    k = fused_blend_fwd(pay, tstart, cnt, 4)
    p = fused_blend_fwd_plain(pay, tstart, cnt, 4)
    torch.cuda.synchronize()
    torch.testing.assert_close(k[..., :5], p[..., :5], atol=2e-4, rtol=0)
    torch.testing.assert_close(k[..., 5], p[..., 5], atol=2e-5, rtol=0)
    assert torch.equal(k[..., 6], p[..., 6])
    assert (k[0, :, 6] > 512).any()  # pixels composited in the third batch
    assert (k[2, :, 6] < 300).all() and (k[2, :, 5] < 1e-2).all()  # stopped
    for t in (1, 4):  # no pair: nothing composited, T stays 1
        assert (k[t, :, :5] == 0).all() and (k[t, :, 5] == 1).all()
        assert (k[t, :, 6] == 0).all()
    gen = torch.Generator(device=cuda).manual_seed(1)
    g_out8 = torch.randn(k.shape, generator=gen, device=cuda)
    g = fused_blend_bwd(pay, tstart, cnt, k, g_out8, 4)
    g_plain = fused_blend_bwd_plain(pay, tstart, cnt, k, g_out8, 4)
    torch.cuda.synchronize()
    assert torch.isfinite(g).all()
    assert _row_err(g, g_plain) < 2e-4
    rows = torch.nn.functional.pad(pay.t(), (0, 16 - NF)).contiguous()
    assert torch.equal(fused_blend_fwd_rows(rows, tstart, cnt, 4), k)
    g_rows = fused_blend_bwd_rows(rows, tstart, cnt, k, g_out8, 4)
    assert torch.equal(g_rows[:, :NF].t(), g) and (g_rows[:, NF:] == 0).all()


@pytest.mark.cuda
def test_k2_bitwise_deterministic(cuda):
    """Two launches of K2 on the same inputs give the same bits: every sum
    runs in a fixed order and nothing is added atomically."""
    pay, tstart, cnt = _long_tiles(cuda, seed=2)
    out8 = fused_blend_fwd(pay, tstart, cnt, 4)
    gen = torch.Generator(device=cuda).manual_seed(2)
    g_out8 = torch.randn(out8.shape, generator=gen, device=cuda)
    first = fused_blend_bwd(pay, tstart, cnt, out8, g_out8, 4)
    for _ in range(3):
        assert torch.equal(fused_blend_bwd(pay, tstart, cnt, out8, g_out8, 4),
                           first)


@pytest.mark.cuda
def test_k1_nan_power_is_not_kept(cuda):
    """A pair whose power is NaN (a NaN conic) is not kept, as the plain
    version decides (power <= 1e-4 is false for NaN); K2 skips it too."""
    pay, tstart, cnt = _long_tiles(cuda, seed=3)
    pay[2, 5] = float("nan")  # conic a of the first tile's sixth pair
    k = fused_blend_fwd(pay, tstart, cnt, 4)
    p = fused_blend_fwd_plain(pay, tstart, cnt, 4)
    torch.cuda.synchronize()
    assert torch.isfinite(k).all()
    torch.testing.assert_close(k[..., :5], p[..., :5], atol=2e-4, rtol=0)
    assert torch.equal(k[..., 6], p[..., 6])
    gen = torch.Generator(device=cuda).manual_seed(3)
    g_out8 = torch.randn(k.shape, generator=gen, device=cuda)
    g = fused_blend_bwd(pay, tstart, cnt, k, g_out8, 4)
    g_plain = fused_blend_bwd_plain(pay, tstart, cnt, k, g_out8, 4)
    keep = torch.ones(pay.shape[1], dtype=torch.bool, device=cuda)
    keep[5] = False  # its own mean and conic rows are NaN in both
    assert torch.isfinite(g[:, keep]).all()
    assert _row_err(g[:, keep], g_plain[:, keep]) < 2e-4


def _bad_opacities(pay):
    """test_k4_matches_plain's zero_neg_nan_opacity case on a column
    payload: opacity 0 at every seventh pair, -0.5 and NaN at others."""
    pay[5, ::7] = 0.0
    pay[5, 3::7] = -0.5
    pay[5, 5::7] = float("nan")
    return torch.isnan(pay[5])


@pytest.mark.cuda
def test_k1_nan_opacity_is_not_kept(cuda):
    """A pair whose opacity is 0, negative or NaN is not kept, as the plain
    version decides (min(0.99, NaN) stays NaN, and NaN >= 1/255 is
    false)."""
    pay, tstart, cnt = _long_tiles(cuda, seed=4)
    _bad_opacities(pay)
    k = fused_blend_fwd(pay, tstart, cnt, 4)
    p = fused_blend_fwd_plain(pay, tstart, cnt, 4)
    torch.cuda.synchronize()
    assert torch.isfinite(k).all()
    torch.testing.assert_close(k[..., :5], p[..., :5], atol=2e-4, rtol=0)
    torch.testing.assert_close(k[..., 5], p[..., 5], atol=2e-5, rtol=0)
    assert torch.equal(k[..., 6], p[..., 6])


@pytest.mark.cuda
def test_k2_nan_opacity_rows_are_zero(cuda):
    """K2 gives a pair whose opacity is NaN zero gradient rows, where the
    plain version's mean and conic rows are NaN (0 * NaN); it writes NaN
    nowhere, and every other row agrees with the plain version."""
    pay, tstart, cnt = _long_tiles(cuda, seed=5)
    nan_op = _bad_opacities(pay)
    out8 = fused_blend_fwd_plain(pay, tstart, cnt, 4)
    gen = torch.Generator(device=cuda).manual_seed(5)
    g_out8 = torch.randn(out8.shape, generator=gen, device=cuda)
    g = fused_blend_bwd(pay, tstart, cnt, out8, g_out8, 4)
    g_plain = fused_blend_bwd_plain(pay, tstart, cnt, out8, g_out8, 4)
    torch.cuda.synchronize()
    assert torch.isfinite(g).all()
    assert (g[:, nan_op] == 0).all()
    finite = torch.isfinite(g_plain)
    assert not finite[:, nan_op].all()  # the plain version's NaN rows
    assert (g[~finite] == 0).all()
    for r in range(NF):
        ok = finite[r]
        err = (g[r][ok] - g_plain[r][ok]).abs().max()
        assert float(err / g_plain[r][ok].abs().max().clamp_min(1e-30)) < 2e-4
    assert torch.equal(g, fused_blend_bwd(pay, tstart, cnt, out8, g_out8, 4))


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
@pytest.mark.parametrize("wh", [(128, 128), (80, 48), (176, 32)])
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


def _tiles(device, t, k, seed, grid_x, prefix=False):
    """tests/test_blend_pallas.make_tiles's packed [T, 16, K] table, built
    here without JAX: centres near their tile, random masks (prefix: each
    tile's first `count` slots, as the dense view fills them)."""
    rng = np.random.RandomState(seed)
    origins = np.stack([(np.arange(t) % grid_x) * 16,
                        (np.arange(t) // grid_x) * 16], -1)
    mean2d = origins[:, None, :] + rng.uniform(-4, 20, (t, k, 2))
    conic = np.zeros((t, k, 3))
    conic[..., 0] = rng.uniform(0.05, 0.3, (t, k))
    conic[..., 2] = rng.uniform(0.05, 0.3, (t, k))
    conic[..., 1] = rng.uniform(-0.02, 0.02, (t, k))
    opac = rng.uniform(0.1, 0.9, (t, k))
    feat = rng.uniform(0, 1, (t, k, 5))
    mask = rng.rand(t, k) > 0.1
    if prefix:
        mask = np.arange(k)[None, :] < rng.randint(0, k + 1, (t, 1))
    rows = [mean2d[..., 0], mean2d[..., 1], conic[..., 0], conic[..., 1],
            conic[..., 2], opac] + [feat[..., i] for i in range(5)] + [mask]
    data = np.zeros((t, 16, k), np.float32)
    data[:, :12] = np.stack(rows, 1)
    return torch.tensor(data, device=device)


def _k4_case(device, case, k, seed, prefix):
    """(data, grid_x, clean) for a K4 case: _tiles' random table, changed
    as the case says; `clean` is the table the plain versions get (the same
    but for the dirty case, whose empty slots it zeroes)."""
    t, gx = (22, 11) if case == "grid_11x2" else (12, 4)
    data = _tiles(device, t, k, seed, grid_x=gx, prefix=prefix)
    rng = np.random.RandomState(100 + seed)
    if case in ("full", "all_die_first_batch"):
        data[:, 11] = 1.0
    if case == "full":  # faint splats: pixels stay live over every batch
        data[:, 5] = torch.tensor(rng.uniform(0.005, 0.05, (t, k)),
                                  dtype=torch.float32)
    elif case == "all_die_first_batch":  # broad, opaque: dead in a few slots
        data[:, 2] = data[:, 4] = 1e-3
        data[:, 3] = 0.0
        data[:, 5] = 0.98
    elif case == "empty_tile":
        data[[1, 5], 11] = 0.0
    elif case == "nan_power":
        data[0, 2, 3] = float("nan")  # conic a of an unmasked slot
        data[0, 11, 3] = 1.0
    elif case == "zero_neg_nan_opacity":
        data[:, 5, ::7] = 0.0
        data[:, 5, 3::7] = -0.5
        data[:, 5, 5::7] = float("nan")
    clean = data
    if case == "dirty_masked":  # empty slots holding NaN and 1e30
        empty = data[:, 11] <= 0.5
        clean = data.clone()
        clean[:, :11] *= (~empty)[:, None, :]
        for f, v in ((0, 1e30), (2, float("nan")), (5, float("nan")),
                     (6, 1e30), (1, -1e30)):
            data[:, f][empty] = v
    return data, gx, clean


_K4_CASES = ([("random", k, seed, prefix) for prefix in (False, True)
              for k in (256, 1024) for seed in (0, 1, 2)]
             + [("full", 1024, 0, False), ("full", 700, 1, False),
                ("empty_tile", 256, 2, False), ("dirty_masked", 512, 3, False),
                ("nan_power", 300, 4, False),
                ("zero_neg_nan_opacity", 300, 5, False),
                ("all_die_first_batch", 1024, 6, False),
                ("grid_11x2", 300, 7, False)])


@pytest.mark.cuda
@pytest.mark.parametrize("case,k,seed,prefix", _K4_CASES)
def test_k4_matches_plain(cuda, case, k, seed, prefix):
    """K4 forward and backward against their plain versions: random masks
    (prefix: each tile's first slots, as the dense view fills them), walks
    over three and more 256-slot batches (the backward's lowest batch
    partial at K = 700), empty tiles, empty slots holding NaN and 1e30, a
    NaN power, opacity 0, negative and NaN (not kept: the plain version's
    clamp keeps NaN), pixels that all die in the first batch, an 11 x 2
    tile grid. The backward is bitwise deterministic and zero in rows 11-15
    and past each tile's walk."""
    data, gx, clean = _k4_case(cuda, case, k, seed, prefix)
    before = blend_forward.launches
    out = blend_forward(data, gx)
    assert blend_forward.launches == before + 1
    ref = blend_forward_plain(clean, gx)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out[..., :5], ref[..., :5], atol=2e-4, rtol=0)
    torch.testing.assert_close(out[..., 5], ref[..., 5], atol=2e-5, rtol=0)
    assert torch.equal(out[..., 6], ref[..., 6])
    assert (out[..., 7] == 0).all()
    if case == "dirty_masked":  # what an empty slot holds changes nothing
        assert torch.equal(out, blend_forward(clean, gx))
    gen = torch.Generator(device=cuda).manual_seed(seed)
    gout = torch.randn(out.shape, generator=gen, device=cuda)
    gout[..., 6:8] = out[..., 5:7]
    before = blend_backward.launches
    g = blend_backward(data, gout, gx)
    assert blend_backward.launches == before + 1
    g_ref = blend_backward_plain(clean, gout, gx)
    torch.cuda.synchronize()
    assert torch.isfinite(g).all() and (g[:, 11:] == 0).all()
    # the plain version's rows of a NaN-power or NaN-opacity slot are NaN
    # (0 * NaN); the kernel's are 0
    finite = torch.isfinite(g_ref)
    assert (g[~finite] == 0).all()
    for r in range(11):
        ok = finite[:, r]
        err = (g[:, r][ok] - g_ref[:, r][ok]).abs().max()
        assert float(err / g_ref[:, r][ok].abs().max().clamp_min(1e-30)) < 2e-4
    n_walk = torch.minimum(out[..., 6].amax(dim=1).long(),
                           slots_in_use(data))
    past = torch.arange(k, device=cuda)[None, :] >= n_walk[:, None]
    assert (g.transpose(1, 2)[past] == 0).all()
    # deterministic: no atomics, the same bits on a second launch
    assert torch.equal(g, blend_backward(data, gout, gx))
    if case == "full":  # the walk spans three and more batches
        assert (out[..., 6] == k).all()
    elif case == "all_die_first_batch":
        assert (out[..., 6] < 256).all()
    elif case == "empty_tile":
        assert (out[[1, 5], :, 5] == 1).all() and (out[[1, 5], :, 6] == k).all()
        assert (g[[1, 5]] == 0).all()
    elif case == "dirty_masked":
        assert torch.equal(g, blend_backward(clean, gout, gx))


@pytest.mark.cuda
@pytest.mark.parametrize("tile_cull", [False, True])
def test_k3_equals_k1_k2(cuda, tile_cull):
    w = h = 128
    args = _scene(cuda, 2048, seed=3)
    cov2d = compute_cov2d_direct(args[1], args[2], args[5], w, h)
    prep = preprocess_gaussians(args[0], None, args[3], args[5], w, h,
                                cov2d=cov2d)
    col = sort_pairs(prep, args[4], w, h, tile_cull=tile_cull, eogs=True)
    row = sort_pairs(prep, args[4], w, h, tile_cull=tile_cull, eogs=True,
                     rows=True)
    assert torch.equal(row.pay[:, :NF].t(), col.pay)
    out8 = fused_blend_fwd(col.pay, col.tstart, col.cnt, 8)
    before = fused_blend_fwd_rows.launches
    out8_rows = fused_blend_fwd_rows(row.pay, row.tstart, row.cnt, 8)
    assert fused_blend_fwd_rows.launches == before + 1
    assert torch.equal(out8_rows, out8)
    gen = torch.Generator(device=cuda).manual_seed(0)
    g_out8 = torch.randn(out8.shape, generator=gen, device=cuda)
    g_col = fused_blend_bwd(col.pay, col.tstart, col.cnt, out8, g_out8, 8)
    g_row = fused_blend_bwd_rows(row.pay, row.tstart, row.cnt, out8, g_out8, 8)
    torch.cuda.synchronize()
    assert torch.equal(g_row[:, :NF].t(), g_col)
    assert (g_row[:, NF:] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [False, True])
@pytest.mark.parametrize("bands", [2, 4])
def test_k1_k2_k3_at_band_offset(cuda, rows, bands):
    """K1/K2 (K3 with rows) on each row band of a frame, at the band's
    first tile (tile0 != 0, as the a2a path launches them): each band
    against the plain version at the same tile0 (K1: channels 0-4 2e-4,
    final_T 2e-5, n_contrib exact; K2: per row 2e-4), and the bands put
    together bit-equal to the whole frame."""
    w = h = 128
    args = _scene(cuda, 2048, seed=3)
    cov2d = compute_cov2d_direct(args[1], args[2], args[5], w, h)
    prep = preprocess_gaussians(args[0], None, args[3], args[5], w, h,
                                cov2d=cov2d)
    sp = sort_pairs(prep, args[4], w, h, tile_cull=True, eogs=True)
    row = sort_pairs(prep, args[4], w, h, tile_cull=True, eogs=True,
                     rows=True)
    gx = w // 16
    whole = fused_blend_fwd(sp.pay, sp.tstart, sp.cnt, gx)
    gen = torch.Generator(device=cuda).manual_seed(0)
    g_out8 = torch.randn(whole.shape, generator=gen, device=cuda)
    g_whole = fused_blend_bwd(sp.pay, sp.tstart, sp.cnt, whole, g_out8, gx)
    fwd, bwd = ((fused_blend_fwd_rows, fused_blend_bwd_rows) if rows
                else (fused_blend_fwd, fused_blend_bwd))
    pay = row.pay if rows else sp.pay
    tpb = whole.shape[0] // bands
    outs, g_sum = [], torch.zeros_like(g_whole)
    for b in range(bands):
        part = slice(b * tpb, (b + 1) * tpb)
        ts, cn = sp.tstart[part].contiguous(), sp.cnt[part].contiguous()
        go = g_out8[part].contiguous()
        k = fwd(pay, ts, cn, gx, b * tpb)
        p = fused_blend_fwd_plain(sp.pay, ts, cn, gx, b * tpb)
        torch.testing.assert_close(k[..., :5], p[..., :5], atol=2e-4, rtol=0)
        torch.testing.assert_close(k[..., 5], p[..., 5], atol=2e-5, rtol=0)
        assert torch.equal(k[..., 6], p[..., 6])
        g = bwd(pay, ts, cn, k, go, gx, b * tpb)
        g = g[:, :NF].t() if rows else g
        gp = fused_blend_bwd_plain(sp.pay, ts, cn, k, go, gx, b * tpb)
        band_rows = torch.zeros(sp.pay.shape[1], dtype=torch.bool,
                                device=cuda)
        lo, hi = int(ts[0]), int(ts[-1] + cn[-1])
        band_rows[lo:hi] = True
        assert _row_err(g[:10, band_rows], gp[:10, band_rows]) < 2e-4
        outs.append(k)
        g_sum[:, band_rows] = g[:, band_rows]
    torch.cuda.synchronize()
    assert torch.equal(torch.cat(outs), whole)
    assert torch.equal(g_sum, g_whole)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["gather", "sorted"])
def test_dense_rasterize_on_card_matches_cpu(cuda, mode):
    """The K4 route's image and every input's gradient on the card against
    the plain versions on the CPU."""
    ct = torch.from_numpy(np.random.RandomState(0).normal(
        size=(5, 128, 128)).astype(np.float32))
    cfg = RasterizeConfig(binning_mode=mode, use_pallas=True,
                          tile_capacity=256, max_tiles_per_gaussian=64)
    res = []
    for dev in (cuda, torch.device("cpu")):
        args = _scene(dev, 512, seed=7)
        leaves = [a.clone().requires_grad_(True) for a in args[:6]]
        off = torch.zeros((512, 2), device=dev, requires_grad=True)
        out = rasterize(*leaves, args[6], 128, 128, cfg,
                        mean2d_ndc_offset=off)
        (out.image * ct.to(dev)).sum().backward()
        res.append([out.image.detach().cpu(), out.final_t.detach().cpu()]
                   + [x.grad.cpu() for x in leaves + [off]])
    (img, ft, *got), (img_c, ft_c, *want) = res
    torch.testing.assert_close(img, img_c, atol=2e-4, rtol=0)
    torch.testing.assert_close(ft, ft_c, atol=2e-5, rtol=0)
    for g, w in zip(got, want):
        assert float((g - w).abs().max()
                     / w.abs().max().clamp_min(1e-30)) < 2e-4


def _densify_state(device, cap=4096, n=4000, seed=0):
    """A seeded model with free slots, densification statistics and Adam
    moments, on `device`."""
    rng = np.random.RandomState(seed)
    params = dict(xyz=rng.normal(size=(cap, 3)),
                  features_dc=rng.normal(size=(cap, 1, 3)),
                  features_rest=np.zeros((cap, 0, 3)),
                  scaling=np.log(rng.uniform(0.003, 0.015, (cap, 3))),
                  rotation=rng.normal(size=(cap, 4)),
                  opacity=rng.uniform(-7, 3, (cap, 1)))
    alive = np.zeros(cap, bool)
    alive[:n] = rng.uniform(size=n) < 0.9
    aux = dict(alive=alive, max_radii2d=rng.uniform(0, 30, cap),
               xyz_gradient_accum=rng.uniform(0, 2e-3, cap),
               denom=rng.randint(0, 6, cap).astype(np.float32))
    model = GaussianModel.from_numpy(params, aux, device=device)
    opt = gaussian_optimizer(model, baseogs(), 1.0)
    for p in (model.xyz, model.features_dc, model.features_rest,
              model.scaling, model.rotation, model.opacity):
        opt.state[p] = dict(
            step=torch.tensor(3.0),
            exp_avg=torch.tensor(rng.normal(size=p.shape), dtype=torch.float32,
                                 device=device),
            exp_avg_sq=torch.tensor(rng.uniform(0.1, 1, p.shape),
                                    dtype=torch.float32, device=device))
    draws = torch.tensor(rng.normal(size=(2, cap, 3)), dtype=torch.float32,
                         device=device)
    return model, opt, draws


@pytest.mark.cuda
def test_densify_and_reset_on_card_match_cpu(cuda):
    """One densify event (clone, then split with the same draws, the size
    prune, fresh statistics) and an opacity reset with its moments, on card
    tensors and on CPU tensors from the same inputs: alive, the buffers,
    the moments and every copied row exactly; the rows the card computes
    (the split's children: exp, log, a normalised 3x3 product; the reset
    opacity: sigmoid and log) within 1e-6, the float32 rounding of those
    functions on the card and on the CPU."""
    res = []
    for dev in (cuda, torch.device("cpu")):
        model, opt, draws = _densify_state(dev)
        g = torch.nan_to_num(model.xyz_gradient_accum
                             / model.denom.clamp_min(1e-12))
        counts = [int(densify.densify_clone(model, opt, g, 4e-4, 0.01, 1.0))]
        counts.append(int(densify.densify_split(model, opt, g, draws[0],
                                                draws[1], 4e-4, 0.01, 1.0)))
        densify.apply_prune(model, densify.prune_mask(model, 0.005, 20, 1.0,
                                                      1.0))
        densify.reset_densification_stats(model)
        densify.reset_opacity_with_moments(model, opt)
        res.append((counts, model, opt))
    (c_card, m_card, o_card), (c_cpu, m_cpu, o_cpu) = res
    assert c_card == c_cpu and min(c_cpu) > 0
    for f in ("alive", "max_radii2d", "xyz_gradient_accum", "denom"):
        assert torch.equal(getattr(m_card, f).cpu(), getattr(m_cpu, f)), f
    for f in ("xyz", "features_dc", "features_rest", "scaling", "rotation",
              "opacity"):
        got, want = getattr(m_card, f).detach().cpu(), getattr(m_cpu, f)
        if f in ("xyz", "scaling", "opacity"):
            torch.testing.assert_close(got, want.detach(), rtol=1e-6,
                                       atol=1e-6)
        else:
            assert torch.equal(got, want.detach()), f
        for k in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(o_card.state[getattr(m_card, f)][k].cpu(),
                               o_cpu.state[getattr(m_cpu, f)][k]), (f, k)
    assert (o_cpu.state[m_cpu.opacity]["exp_avg"] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("tile_cull,tcap", [(False, None), (False, 3),
                                            (True, None), (True, 3)])
def test_emission_matches_plain(cuda, tile_cull, tcap):
    """The two passes of csrc/emit_pairs.cu against the plain emission on
    the same walk, bit for bit: gid, tile, the sort key and the counts. The
    scenes' first rows are special_prep's edge cases (no tile, the whole
    grid: walked by a warp, wider than tcap; a NaN conic, a NaN opacity, an
    indefinite conic, a faint Gaussian); at 400^2 many rects are wider than
    a warp's 32 tiles."""
    for width, seed in ((96, 0), (400, 1)):
        prep, _ = special_prep(n=3000, width=width, height=width, seed=seed,
                               device=cuda)
        gx = (width + 15) // 16
        before = (count_pairs.launches, write_pairs.launches)
        em = emit_pairs(prep, gx, tile_cull=tile_cull, tcap=tcap,
                        depth=prep.depth)
        assert (count_pairs.launches, write_pairs.launches) == (
            before[0] + 1, before[1] + 1)
        ref = emit_walk_plain(walk_of(prep, tile_cull, tcap), gx, prep.depth)
        torch.cuda.synchronize()
        assert ref.gid.shape[0] > 0
        for f, a, b in zip(em._fields, em, ref):
            assert a.dtype == torch.int64 and torch.equal(a, b), f
        if width == 400 and tcap is None:
            assert int(prep.tiles_touched.gt(32).sum()) > 10


@pytest.mark.cuda
def test_emission_empty_and_all_culled(cuda):
    """No Gaussian, and Gaussians whose every tile is culled: no pair, every
    count 0, the render the background's."""
    prep, feat = special_prep(device=cuda)
    gx = (96 + 15) // 16
    empty = Preprocessed(*(x[:0] for x in prep))
    em = emit_pairs(empty, gx, tile_cull=True, depth=empty.depth)
    assert em.gid.shape == em.tile.shape == em.key.shape == (0,)
    assert em.lengths.shape == (0,)
    rest = Preprocessed(*(x[6:] for x in prep))
    faint = rest._replace(opacity=torch.full_like(rest.opacity, 1e-3))
    em = emit_pairs(faint, gx, tile_cull=True, depth=faint.depth)
    assert em.gid.shape == (0,) and (em.lengths == 0).all()
    out = rasterize_fused(faint, feat[6:], 96, 96, eogs_features=True,
                          tile_cull=True)
    torch.cuda.synchronize()
    assert int(out.num_pairs) == 0 and (out.out8[..., 5] == 1).all()


@pytest.mark.cuda
def test_sort_pairs_on_card_matches_cpu(cuda):
    """sort_pairs on the card (the emission kernels, the sort, the ranges,
    the payload gather) against sort_pairs on the CPU (the plain emission)
    from the same inputs: pay, tstart, cnt, gid and the counts equal."""
    prep, feat = special_prep(n=3000, width=256, height=256, seed=4)
    on_card = Preprocessed(*(x.to(cuda) for x in prep))
    for cull in (False, True):
        want = sort_pairs(prep, feat, 256, 256, tile_cull=cull, eogs=True)
        got = sort_pairs(on_card, feat.to(cuda), 256, 256, tile_cull=cull,
                         eogs=True)
        torch.testing.assert_close(got.pay.cpu(), want.pay, rtol=0, atol=0,
                                   equal_nan=True)
        for f in ("tstart", "cnt", "gid", "lengths"):
            assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f


@pytest.mark.cuda
def test_render_view_full_copies_out_through_page_locked_slots(cuda,
                                                              monkeypatch):
    """render_view_full on the card, five requests at a 64^2 scene (two
    views) with sun and shading, the first result kept whole and the
    second by a slice of one output: every output equals the blocking
    ``.cpu().numpy()`` copy of the same device output bit for bit and lies
    in page-locked memory; one ``serve.to_host`` wait a request; the kept
    arrays read the same after the later requests, the third of which
    takes a new slot that the last two reuse."""
    from eogs2_tpu_torch.data.synthetic import (make_scene_arrays,
                                                scene_from_arrays)
    from eogs2_tpu_torch.model import init_from_points
    from eogs2_tpu_torch.observability import tracer
    from eogs2_tpu_torch.shading import init_shading_params

    scene = scene_from_arrays(make_scene_arrays(
        n_views=3, width=64, height=64, hf_res=128, n_buildings=4, seed=0,
        scale=12.0), device=cuda)
    n = scene.init_xyz.shape[0]
    model = init_from_points(scene.init_xyz, scene.init_rgb, n,
                             opacity_init_value=0.5, device=cuda)
    views = scene.train_views
    shading = init_shading_params(len(views), device=cuda)
    rcfg = RasterizeConfig(binning_mode="fused", tile_cull=True)
    slot_to_host = pipeline.to_host
    wants = []

    def to_host(outs, hn, wn, slots=None):
        assert (hn, wn) == (64, 64)  # a whole number of tiles: no crop
        wants.append({k: None if x is None else x.cpu().numpy()
                      for k, x in outs.items()})
        return slot_to_host(outs, hn, wn, slots)

    monkeypatch.setattr(pipeline, "to_host", to_host)
    monkeypatch.setattr(pipeline, "HOST_SLOTS",
                        pipeline.HostSlots(pipeline.page_locked))

    def request(i):
        cam = views[i % len(views)].camera
        assert cam.has_sun
        out = pipeline.render_view_full(model, cam, rcfg, shading=shading,
                                        view_idx=i % len(views))
        for k, v in wants[-1].items():
            if v is None:
                assert out[k] is None, k
                continue
            assert out[k].shape == v.shape and out[k].dtype == v.dtype, k
            assert out[k].tobytes() == v.tobytes(), k
            assert torch.from_numpy(out[k]).is_pinned(), k
        return out

    tracer.reset()
    tracer.enable()
    try:
        kept = request(0)
        snap = {k: None if v is None else v.copy() for k, v in kept.items()}
        part = request(1)["final"][0, 3:9]
        part_snap = part.copy()
        for i in (2, 3, 4):
            request(i)
        u = tracer.per_unit("serve.request")
    finally:
        tracer.enable(False)
        tracer.reset()
    assert kept["shadowmap"] is not None
    assert not np.shares_memory(kept["shaded"], kept["final"])
    for k, v in snap.items():
        assert v is None or kept[k].tobytes() == v.tobytes(), k
    assert part.tobytes() == part_snap.tobytes()
    assert u["units"] == 5 and u["sites"]["serve.to_host"] == 1
    assert u["counts"] == {"serve.slot.new": 0.6, "serve.slot.reused": 0.4}
