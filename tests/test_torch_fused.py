"""Fused-route parity: eogs2_tpu_torch.rasterize(binning_mode="fused") on
the CPU, where the K1 and K2 wrappers run their plain PyTorch versions,
against the JAX fused route (Pallas in interpret mode), the port's own dense
oracle and the frozen float64 golden scene.

Tolerances: image atol 5e-5 / rtol 1e-4 against JAX and the oracle (the
blend's products and sums round in another order); the golden checks use
tests/test_golden.py's own tolerances (pairs at the 1/255 and T_EPS edges).
Gradients of every input, against JAX and the golden: max-normalised
relative error < 2e-4 (test_golden.py's gradient tolerance; 2e-3 with
antialiasing, as there).
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax

from eogs2_tpu.rasterizer import rasterize as jrasterize
from eogs2_tpu_torch.ops.binning import depth_key
from eogs2_tpu_torch.ops.fused_raster import (_GatherPairs,
                                              fused_blend_bwd,
                                              fused_blend_bwd_plain,
                                              fused_blend_fwd,
                                              fused_blend_fwd_plain,
                                              sort_pairs)
from eogs2_tpu_torch.ops.projection import (compute_cov2d_direct,
                                            preprocess_gaussians)
from eogs2_tpu_torch.rasterizer import (RasterizeConfig, rasterize,
                                        reference_rasterize)
from tests.test_fused import CFG_F
from tests.test_rasterizer import make_scene

W = H = 128
ATOL, RTOL = 5e-5, 1e-4
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "scene1.npz")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run this file's torch ops on one thread: beside the other test
    workers, torch's default pool (one thread per core) oversubscribes the
    cores and its many small parallel regions slow the file down."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(args):
    return [torch.from_numpy(np.array(a)) for a in args]


def _cfg(**kw):
    return RasterizeConfig(binning_mode="fused", **kw)


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("kw", [
    {},
    {"tile_cull": True},
    {"eogs_features": True},
    {"eogs_features": True, "tile_cull": True},
])
def test_fused_matches_jax(kw):
    args = make_scene(n=512, seed=7)
    jo = jrasterize(*args, W, H, dataclasses.replace(CFG_F, **kw))
    to = rasterize(*_t(args), W, H, _cfg(**kw))
    assert int(jo.max_tile_count) <= CFG_F.tile_capacity  # JAX walked all
    _close(to.image, jo.image)
    _close(to.final_t, jo.final_t)
    np.testing.assert_array_equal(to.radii.numpy(), np.asarray(jo.radii))
    _close(to.mean2d_ndc, jo.mean2d_ndc, atol=1e-6, rtol=1e-5)
    for name in ("num_pairs", "max_tile_count", "clipped_pairs",
                 "max_tiles_per_gaussian_seen", "big_max_tiles_seen",
                 "bulk_rect_max_seen"):
        assert int(getattr(to, name)) == int(getattr(jo, name)), name
    assert int(to.clipped_pairs) == 0


@pytest.mark.parametrize("wh,tile_cull", [((128, 128), False),
                                          ((80, 48), True)])
def test_fused_matches_oracle(wh, tile_cull):
    w, h = wh
    args = _t(make_scene(n=512, seed=7))
    out = rasterize(*args, w, h, _cfg(tile_cull=tile_cull))
    img, ft, radii = reference_rasterize(*args, w, h)
    _close(out.image, img)
    _close(out.final_t, ft)
    np.testing.assert_array_equal(out.radii.numpy(), radii.numpy())


def test_fused_never_clips_at_tile_capacity():
    """The port walks every pair of a tile whatever tile_capacity says (the
    CUDA reference's behaviour): a tile_capacity far below the densest tile
    changes nothing and clips nothing."""
    args = _t(make_scene(n=512, seed=7))
    out = rasterize(*args, W, H, _cfg(tile_capacity=8,
                                      max_tiles_per_gaussian=1))
    assert int(out.max_tile_count) > 8
    assert int(out.clipped_pairs) == 0
    img, ft, _ = reference_rasterize(*args, W, H)
    _close(out.image, img)
    _close(out.final_t, ft)


@pytest.mark.parametrize("tag,aa,atol_img,atol_t", [
    ("noaa", False, 2e-4, 2e-5),
    ("aa", True, 2e-3, 6e-4),
])
def test_golden_forward(tag, aa, atol_img, atol_t):
    g = np.load(GOLDEN)
    w, h = int(g["width"]), int(g["height"])
    args = _t([g[k] for k in ("means", "scales", "quats", "opac", "feat",
                              "affine", "bg")])
    off = torch.zeros((args[0].shape[0], 2))
    out = rasterize(*args, w, h, _cfg(antialiasing=aa),
                    mean2d_ndc_offset=off)
    _close(out.image, g[f"{tag}_image"], atol=atol_img, rtol=0)
    _close(out.final_t, g[f"{tag}_final_T"], atol=atol_t, rtol=0)


def test_alive_mask():
    means, scales, quats, opac, feat, affine, bg = _t(make_scene(n=128,
                                                                seed=5))
    alive = torch.arange(128) < 64
    out = rasterize(means, scales, quats, opac, feat, affine, bg, W, H,
                    _cfg(), alive=alive)
    half = rasterize(means[:64], scales[:64], quats[:64], opac[:64],
                     feat[:64], affine, bg, W, H, _cfg())
    _close(out.image, half.image)
    jo = jrasterize(*make_scene(n=128, seed=5), W, H, CFG_F,
                    alive=jnp.asarray(alive.numpy()))
    _close(out.image, jo.image)
    assert int(out.num_pairs) == int(jo.num_pairs)


def test_nothing_visible_renders_background():
    """No live Gaussian: an empty pair list, every tile composites nothing
    and the image is the background."""
    args = _t(make_scene(n=64, seed=2))
    out = rasterize(*args, 48, 32, _cfg(), alive=torch.zeros(64, dtype=bool))
    assert int(out.num_pairs) == 0 and int(out.max_tile_count) == 0
    assert (out.final_t == 1).all()
    _close(out.image, args[6][:, None, None].expand(5, 32, 48), atol=0,
           rtol=0)


def test_depth_key_orders_both_signs():
    """depth = -altitude takes both signs: the int key must order negative
    depths as the floats do (raw float bits would reverse them)."""
    rng = np.random.RandomState(0)
    d = np.concatenate([rng.normal(0, 1, 500), rng.normal(0, 1e-30, 20),
                        [0.0, np.inf, -np.inf, 3.5, -3.5]]).astype(np.float32)
    keys = depth_key(torch.from_numpy(d))
    assert keys.min() >= 0 and keys.max() < 2 ** 32
    order = torch.sort(keys, stable=True).indices.numpy()
    np.testing.assert_array_equal(order, np.argsort(d, kind="stable"))


def test_stack_straddling_zero_altitude():
    """Concentric opaque splats whose altitudes take both signs: the
    composite order (top first) decides every pixel of the stack."""
    n = 12
    rng = np.random.RandomState(3)
    means = np.zeros((n, 3), np.float32)
    means[:, :2] = rng.normal(0, 0.02, (n, 2))
    means[:, 2] = rng.permutation(np.linspace(-0.5, 0.5, n))
    scales = np.full((n, 3), 0.15, np.float32)
    quats = np.tile(np.float32([1, 0, 0, 0]), (n, 1))
    opac = np.full(n, 0.6, np.float32)
    feat = np.concatenate([rng.uniform(0, 1, (n, 3)), means[:, 2:3],
                           np.ones((n, 1))], 1).astype(np.float32)
    affine = np.float32([[1, 0, 0.1, 0], [0, 1, -0.1, 0], [0, 0, 1, 0]])
    bg = np.float32([0.3, 0.5, 0.2, -1.0, 0.0])
    args = (means, scales, quats, opac, feat, affine, bg)
    for kw in ({}, {"eogs_features": True}):
        out = rasterize(*_t(args), 64, 64, _cfg(**kw))
        img, ft, _ = reference_rasterize(*_t(args), 64, 64)
        _close(out.image, img)
        jo = jrasterize(*map(jnp.asarray, args), 64, 64,
                        dataclasses.replace(CFG_F, **kw))
        _close(out.image, jo.image)
    # the topmost splat's colour dominates the centre pixel
    top = int(np.argmax(means[:, 2]))
    centre = out.image[:3, 32, 32].numpy()
    assert np.abs(centre - feat[top, :3]).max() < 0.5


def test_plain_blend_chunking_is_invisible():
    """fused_blend_fwd_plain's tile chunking only bounds memory: one tile
    per chunk gives the same out8, channel 6 (n_contrib) included."""
    args = _t(make_scene(n=512, seed=7))
    cov2d = compute_cov2d_direct(args[1], args[2], args[5], W, H)
    prep = preprocess_gaussians(args[0], None, args[3], args[5], W, H,
                                cov2d=cov2d)
    sp = sort_pairs(prep, args[4], W, H)
    whole = fused_blend_fwd(sp.pay, sp.tstart, sp.cnt, W // 16)
    tiny = fused_blend_fwd_plain(sp.pay, sp.tstart, sp.cnt, W // 16,
                                 chunk_elems=1)
    torch.testing.assert_close(whole, tiny, rtol=0, atol=0)
    assert (whole[..., 7] == 0).all()
    assert whole[..., 6].max() <= sp.cnt.max()
    # n_contrib is the 1-based position of the pixel's last composited pair
    assert (whole[..., 6] == torch.floor(whole[..., 6])).all()


GRAD_NAMES = ("means", "scales", "quats", "opacities", "features", "affine",
              "mean2d_ndc")


def _rel_err(got, want):
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max()
                 / (np.abs(want).max() + 1e-30))


def _port_grads(args, ct, w, h, cfg):
    """Gradients of sum(image * ct) w.r.t. the 6 inputs and a zero NDC
    offset, through the port's fused route."""
    leaves = [torch.tensor(np.array(a), requires_grad=True)
              for a in args[:6]]
    off = torch.zeros((leaves[0].shape[0], 2), requires_grad=True)
    out = rasterize(*leaves, torch.tensor(np.array(args[6])), w, h, cfg,
                    mean2d_ndc_offset=off)
    (out.image * torch.from_numpy(np.asarray(ct))).sum().backward()
    return [x.grad.numpy() for x in leaves + [off]]


@pytest.mark.parametrize("kw", [
    {},
    {"tile_cull": True},
    {"eogs_features": True},
    {"eogs_features": True, "tile_cull": True},
])
def test_fused_grads_match_jax(kw):
    """Every input's gradient, features included: with eogs_features the
    altitude column (3) carries the altitude gradient, as in JAX, and the
    constant column (4) gets none."""
    args = make_scene(n=512, seed=7)
    ct = np.random.RandomState(0).normal(size=(5, H, W)).astype(np.float32)
    cfg = dataclasses.replace(CFG_F, **kw)

    def loss(*xs):
        out = jrasterize(*xs[:6], args[6], W, H, cfg,
                         mean2d_ndc_offset=xs[6])
        return jnp.sum(out.image * ct)

    want = jax.grad(loss, argnums=tuple(range(7)))(
        *args[:6], jnp.zeros((512, 2), jnp.float32))
    got = _port_grads(args, ct, W, H, _cfg(**kw))
    for name, g, j in zip(GRAD_NAMES, got, want):
        assert np.abs(np.asarray(j)).max() > 0, name
        assert _rel_err(g, j) < 2e-4, name
    assert _rel_err(got[4][:, 3], np.asarray(want[4])[:, 3]) < 2e-4
    if kw.get("eogs_features"):
        assert (got[4][:, 4] == 0).all()


def test_altitude_row_carries_gradient():
    """eogs layout: the sorted payload's altitude row is features[:, 3]
    itself, so a loss on it reaches that column (the sort key stays
    detached; the constant row gets no gradient)."""
    args = _t(make_scene(n=256, seed=3))
    feats = args[4].clone().requires_grad_(True)
    cov2d = compute_cov2d_direct(args[1], args[2], args[5], W, H)
    prep = preprocess_gaussians(args[0], None, args[3], args[5], W, H,
                                cov2d=cov2d)
    sp = sort_pairs(prep, feats, W, H, eogs=True)
    torch.testing.assert_close(sp.pay[9], feats[sp.gid, 3], rtol=0, atol=0)
    sp.pay[9].sum().backward()
    want = torch.bincount(sp.gid, minlength=256).float()
    torch.testing.assert_close(feats.grad[:, 3], want, rtol=0, atol=0)
    assert (feats.grad[:, [0, 1, 2, 4]] == 0).all()


@pytest.mark.parametrize("tag,aa,tol", [("noaa", False, 2e-4),
                                        ("aa", True, 2e-3)])
def test_golden_grads(tag, aa, tol):
    g = np.load(GOLDEN)
    w, h = int(g["width"]), int(g["height"])
    args = [g[k] for k in ("means", "scales", "quats", "opac", "feat",
                           "affine", "bg")]
    got = _port_grads(args, g["ct"], w, h, _cfg(antialiasing=aa))
    for name, grad in zip(GRAD_NAMES, got):
        assert _rel_err(grad, g[f"{tag}_g_{name}"]) < tol, name


def test_gather_pairs_backward_is_a_segment_sum():
    """The deterministic per-pair -> per-Gaussian reduction equals the
    scatter-add that autograd of index_select would do."""
    rng = np.random.RandomState(0)
    lengths = torch.from_numpy(rng.randint(0, 5, 40))
    gid = torch.repeat_interleave(torch.arange(40), lengths)  # Gaussian-major
    perm = torch.from_numpy(rng.permutation(gid.shape[0]))
    cols = torch.randn(11, 40, dtype=torch.float64, requires_grad=True)
    pay = _GatherPairs.apply(cols, gid[perm], perm, lengths)
    torch.testing.assert_close(pay, cols[:, gid[perm]], rtol=0, atol=0)
    g_pay = torch.randn_like(pay)
    pay.backward(g_pay)
    want = torch.zeros(11, 40, dtype=torch.float64).index_add_(
        1, gid[perm], g_pay)
    torch.testing.assert_close(cols.grad, want)


def test_plain_bwd_chunking_is_invisible():
    """fused_blend_bwd_plain's tile chunking only bounds memory; rows no
    pixel reached are zero."""
    args = _t(make_scene(n=512, seed=7))
    cov2d = compute_cov2d_direct(args[1], args[2], args[5], W, H)
    prep = preprocess_gaussians(args[0], None, args[3], args[5], W, H,
                                cov2d=cov2d)
    sp = sort_pairs(prep, args[4], W, H)
    out8 = fused_blend_fwd(sp.pay, sp.tstart, sp.cnt, W // 16)
    g_out8 = torch.from_numpy(
        np.random.RandomState(1).normal(size=out8.shape).astype(np.float32))
    whole = fused_blend_bwd(sp.pay, sp.tstart, sp.cnt, out8, g_out8, W // 16)
    tiny = fused_blend_bwd_plain(sp.pay, sp.tstart, sp.cnt, out8, g_out8,
                                 W // 16, chunk_elems=1)
    torch.testing.assert_close(whole, tiny, rtol=0, atol=0)
    assert torch.isfinite(whole).all()
    # g_out8's channels 6-7 are ignored
    g2 = g_out8.clone()
    g2[..., 6:] = 0
    torch.testing.assert_close(
        fused_blend_bwd(sp.pay, sp.tstart, sp.cnt, out8, g2, W // 16), whole,
        rtol=0, atol=0)
    # a pair past every pixel's last composite has zero gradient
    pos = torch.arange(sp.pay.shape[1]) - sp.tstart.long().repeat_interleave(
        sp.cnt.long())
    last = out8[..., 6].amax(1).long().repeat_interleave(sp.cnt.long())
    assert (pos >= last).any()
    assert (whole[:, pos >= last] == 0).all()


def test_wrapper_takes_only_cpu_or_cuda():
    pay = torch.zeros((11, 4), device="meta")
    idx = torch.zeros((1,), dtype=torch.int32, device="meta")
    out8 = torch.zeros((1, 256, 8), device="meta")
    with pytest.raises(ValueError, match="device"):
        fused_blend_fwd(pay, idx, idx, 1)
    with pytest.raises(ValueError, match="device"):
        fused_blend_bwd(pay, idx, idx, out8, out8, 1)
    idx = torch.zeros((3,), dtype=torch.int32)
    out8 = torch.zeros((3, 256, 8))
    with pytest.raises(ValueError, match="grid_x"):
        fused_blend_fwd(torch.zeros((11, 4)), idx, idx, 2)
    with pytest.raises(ValueError, match="grid_x"):
        fused_blend_bwd(torch.zeros((11, 4)), idx, idx, out8, out8, 2)
