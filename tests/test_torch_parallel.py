"""The port's multi-device rasterizer and TSDF (eogs2_tpu_torch/parallel/)
on the CPU, in gloo process groups of 1, 2 and 4 ranks started with
torch.multiprocessing (tests/torch_parallel_worker.py, which imports no
JAX; a file rendezvous in tmp_path), held against eogs2_tpu.

  * rasterize_a2a and sharded_render at 1, 2 and 4 ranks against JAX's
    single-device rasterize (its default gather route, on the same
    capacities) with JAX's own sharded tolerances (tests/test_sharded.py):
    image atol 5e-5 rtol 1e-4, the gradients of means, opacity and affine
    atol 1e-3 rtol 2e-3; the RasterOut contract (num_pairs, mean2d_ndc,
    radii, max_dest_count) at a height that is not a multiple of 16 n;
    tile_cull against the unculled render;
  * _windows / _unwindows against JAX's functions;
  * dropped pairs: the count and their zero gradients;
  * the TSDF volume split over 2 ranks equal to the unsharded one, bit for
    bit, with the pad path taken;
  * make_mesh's axes and factoring, the Gaussian shard with its pad and its
    Adam moments, make_global_array, all_processes_allclose;
  * K1/K2's plain versions at a band offset (tile0): the bands of a frame
    put together agree with the whole frame.

Tier-1 never calls JAX's sharded_rasterize: interpret-mode Pallas over the
virtual devices takes minutes.
"""

import numpy as np
import pytest
import torch

import eogs2_tpu.parallel.sharded_raster as jsr
from eogs2_tpu.rasterizer import RasterizeConfig as JConfig
from eogs2_tpu.rasterizer import rasterize as jrasterize
from eogs2_tpu_torch.parallel import sharded_raster as tsr
from tests import torch_parallel_worker as W
from tests.test_rasterizer import make_scene

W_ = 128
CAPS = dict(tile_capacity=256, max_tiles_per_gaussian=16)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run this file's torch ops on one thread: beside the other test
    workers, torch's default pool oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _arrays(n=512):
    return [np.asarray(a) for a in make_scene(n=n, seed=7)]


def _jax_render(arrays, width, height, cfg_kw):
    """JAX's single-device render, its image and the gradients of
    sum(image[:3]^2) for means, opacity, affine."""
    import jax
    import jax.numpy as jnp

    means, scales, quats, opac, feat, affine, bg = map(jnp.asarray, arrays)
    cfg = JConfig(**cfg_kw)

    def loss(means, opac, affine):
        out = jrasterize(means, scales, quats, opac, feat, affine, bg, width,
                         height, cfg)
        return jnp.sum(out.image[:3] ** 2), out

    (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                         has_aux=True)(means, opac, affine)
    return out, [np.asarray(g) for g in grads]


def _cat(rs, key):
    return torch.cat([r[key] for r in rs]).numpy()


@pytest.mark.parametrize("ranks", [1, 2, 4])
def test_a2a_matches_jax_rasterize(tmp_path, ranks):
    arrays = _arrays()
    jout, jg = _jax_render(arrays, W_, W_, dict(tile_chunk=16, **CAPS))
    rs = W.run(W.a2a_render, ranks, tmp_path, arrays, W_, W_,
               dict(dest_cap=1 << 12, **CAPS))
    want = np.asarray(jout.image)
    for r in rs:  # the whole image on every rank
        np.testing.assert_allclose(r["image"].numpy(), want, atol=5e-5,
                                   rtol=1e-4)
        np.testing.assert_allclose(r["render_image"].numpy(), want,
                                   atol=5e-5, rtol=1e-4)
        assert r["dropped_pairs"] == 0
    for got, w, name in ((_cat(rs, "g_means"), jg[0], "means"),
                         (_cat(rs, "g_opac"), jg[1], "opacity"),
                         (rs[0]["g_affine"].numpy(), jg[2], "affine")):
        assert np.abs(w).max() > 0, name
        np.testing.assert_allclose(got, w, atol=1e-3, rtol=2e-3,
                                   err_msg=name)
    # the affine's gradient is the same on every rank
    for r in rs[1:]:
        np.testing.assert_array_equal(r["g_affine"], rs[0]["g_affine"])


def test_a2a_rasterout_contract(tmp_path):
    """num_pairs is the emitted pairs over all ranks, mean2d_ndc and radii
    the shard's, at 112 rows (not a multiple of 16 * 2: the grid is padded
    with an empty tile row); the image is still rasterize's."""
    arrays = _arrays()
    h = 112
    jout, _ = _jax_render(arrays, W_, h, dict(tile_chunk=16, **CAPS))
    rs = W.run(W.a2a_render, 2, tmp_path, arrays, W_, h,
               dict(dest_cap=1 << 12, **CAPS), True)
    r = rs[0]
    assert r["num_pairs"] == int(jout.num_pairs)
    assert 0 < r["max_dest_count"] <= r["num_pairs"]
    assert r["max_tile_count"] == int(jout.max_tile_count)
    np.testing.assert_allclose(_cat(rs, "mean2d_ndc"),
                               np.asarray(jout.mean2d_ndc), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_array_equal(_cat(rs, "radii"), np.asarray(jout.radii))
    np.testing.assert_allclose(r["image"].numpy(), np.asarray(jout.image),
                               atol=5e-5, rtol=1e-4)
    assert r["image"].shape == (5, h, W_)
    # the NDC offset's gradient (the densification statistic) is there
    assert np.abs(_cat(rs, "g_off")).max() > 0


def test_a2a_tile_cull_matches_single(tmp_path):
    """tile_cull on the a2a path: the same image as JAX's unculled render,
    fewer pairs than the port's own unculled a2a render."""
    arrays = _arrays()
    jout, _ = _jax_render(arrays, W_, W_, dict(tile_chunk=16, **CAPS))
    culled = W.run(W.a2a_render, 2, tmp_path / "cull", arrays, W_, W_,
                   dict(dest_cap=1 << 12, tile_cull=True, **CAPS))
    plain = W.run(W.a2a_render, 2, tmp_path / "plain", arrays, W_, W_,
                  dict(dest_cap=1 << 12, **CAPS))
    assert culled[0]["dropped_pairs"] == 0
    np.testing.assert_allclose(culled[0]["image"].numpy(),
                               np.asarray(jout.image), atol=5e-5, rtol=1e-4)
    assert culled[0]["num_pairs"] < plain[0]["num_pairs"]


def test_windows_match_jax():
    import jax.numpy as jnp

    rng = np.random.RandomState(0)
    for pl, n, cap in ((50, 4, 16), (7, 2, 8), (0, 3, 4), (40, 3, 8)):
        counts = rng.multinomial(pl, np.ones(n) / n)
        starts = (np.cumsum(counts) - counts).astype(np.int32)
        col = rng.normal(size=pl).astype(np.float32)
        want = np.asarray(jsr._windows(jnp.asarray(col), jnp.asarray(starts),
                                       cap, n))
        got = tsr._windows(torch.from_numpy(col), torch.from_numpy(starts),
                           cap, n)
        np.testing.assert_array_equal(got.numpy(), want)
        # the transpose, on windows whose tails past each count are zero
        # (the send pads' gradient)
        gwin = rng.normal(size=(n, cap)).astype(np.float32)
        gwin[np.arange(cap)[None, :] >= np.minimum(counts, cap)[:, None]] = 0
        want = np.asarray(jsr._unwindows(jnp.asarray(gwin),
                                         jnp.asarray(starts), pl, cap, n))
        got = tsr._unwindows(torch.from_numpy(gwin),
                             torch.from_numpy(starts), pl, cap, n)
        np.testing.assert_array_equal(got.numpy(), want)


def test_dropped_pairs_get_zero_gradient(tmp_path):
    """A dest_cap below the windows' demand drops pairs: each rank's count
    is summed into dropped_pairs, and exactly the dropped pairs have zero
    gradient."""
    arrays = _arrays(n=256)
    rs = W.run(W.a2a_dropped, 2, tmp_path, arrays, W_, W_, 64)
    total = sum(r["own_drops"] for r in rs)
    assert total > 0
    for r in rs:
        assert r["dropped"] == total
        g, kept = r["g_pay"], r["kept"]
        assert not bool(kept.all())
        assert bool((g[:, ~kept] == 0).all())
        assert bool((g[:, kept].abs().sum(0) > 0).any())


def test_sharded_tsdf_matches_unsharded(tmp_path):
    """tests/test_sharded.py:226-262 for the port, on views whose rows run
    south (so fusion does work): 2 ranks, slabs of 997 voxels (odd: the
    pad path), bit-equal to the unsharded volume."""
    from eogs2_tpu.data.synthetic import _heightfield, _render_view, \
        make_affine
    from eogs2_tpu_torch.eval.tsdf import TSDFVolume, TsdfViews

    rng = np.random.RandomState(5)
    alt_range = (-0.35, 0.35)
    z, tex = _heightfield(48, 2, rng, alt_range)
    coefs, inters, alts = [], [], []
    for shear in [(0.0, 0.0), (0.2, 0.0), (0.0, 0.2)]:
        a = make_affine(shear, 32, 32, alt_range)
        a[1] *= -1.0
        _, surf = _render_view(z, tex, a, np.array([0.3, 0.2, 0.9]), 32, 32,
                               alt_range=alt_range, n_steps=48)
        coefs.append(a[:, :3])
        inters.append(a[:, 3])
        alts.append(surf)
    coefs, inters, alts = (np.stack(x).astype(np.float32)
                           for x in (coefs, inters, alts))
    scale = 10.0
    vb = np.array([[-8.5, 8.5], [-8.5, 8.5],
                   [alt_range[0] * scale, alt_range[1] * scale]])
    ref = TSDFVolume(vb, 0.5, 4.0, device="cpu")
    ref.integrate_views(TsdfViews(*(torch.from_numpy(x) for x in
                                    (coefs, inters, alts))), scale)
    ref.apply_prior()
    rs = W.run(W.tsdf, 2, tmp_path, coefs, inters, alts, vb, 0.5, scale)
    assert rs[0]["voxels"] % 2 and rs[0]["voxels"] % 997
    assert float(ref.weight.max()) > 0  # fusion did work
    for r in rs:
        assert torch.equal(r["tsdf"], ref.tsdf)
        assert torch.equal(r["weight"], ref.weight)


def test_mesh_and_gaussian_shard(tmp_path):
    from eogs2_tpu_torch.parallel.distributed import init_distributed

    assert init_distributed() is False  # no coordinator: nothing to do
    rs = W.run(W.mesh_helpers, 4, tmp_path)
    assert all(r["g"] == (("g",), (4,)) for r in rs)
    assert all(r["dg"] == (("d", "g"), (2, 2)) for r in rs)
    assert [r["dg_ranks"] for r in rs] == [(0, 0, 2), (0, 1, 2), (1, 0, 2),
                                           (1, 1, 2)]
    # 10 Gaussians padded to 12: 3 a rank, the last two rows dead
    xyz = torch.cat([r["xyz"] for r in rs])
    alive = torch.cat([r["alive"] for r in rs])
    assert xyz.shape == (12, 3) and alive.tolist() == [True] * 10 + [False] * 2
    assert torch.cat([r["rotation"] for r in rs])[10:, 0].tolist() == [1, 1]
    assert torch.cat([r["scaling"] for r in rs])[10:].eq(-10).all()
    mom = torch.cat([r["exp_avg"] for r in rs])
    assert bool((mom[:10] != 0).all()) and bool((mom[10:] == 0).all())
    assert all(r["step"] == 1.0 and r["lr"] == 0.1 for r in rs)
    assert [r["part"].tolist() for r in rs] == [[4 * i + j for j in range(4)]
                                                for i in range(4)]
    assert all(r["same"] and not r["differs"] for r in rs)
    assert [r["coordinator"] for r in rs] == [True, False, False, False]


def test_plain_blend_bands_equal_whole_frame():
    """K1's and K2's plain versions at tile0: a frame's sorted ranges cut
    into 4 row bands, each blended at its band offset, put together agree
    with the whole frame's out8 (channels 0-4 2e-4, final_T 2e-5,
    n_contrib exact) and g_pay (per row 2e-4 of its largest value): the
    tolerances of the kernels against these plain versions. (The plain
    versions batch tiles into chunks by the longest range, so a band's
    einsums may round apart from the frame's; the kernels' bands are
    bit-equal on the card, tests/test_torch_kernels.py.)"""
    from eogs2_tpu_torch.ops.fused_raster import (fused_blend_bwd_plain,
                                                  fused_blend_fwd_plain,
                                                  sort_pairs)
    from eogs2_tpu_torch.ops.projection import (compute_cov2d_direct,
                                                preprocess_gaussians)

    t = [torch.from_numpy(a) for a in _arrays()]
    cov2d = compute_cov2d_direct(t[1], t[2], t[5], W_, W_)
    prep = preprocess_gaussians(t[0], None, t[3], t[5], W_, W_, cov2d=cov2d)
    sp = sort_pairs(prep, t[4], W_, W_)
    gx = W_ // 16
    whole = fused_blend_fwd_plain(sp.pay, sp.tstart, sp.cnt, gx)
    g_out8 = torch.randn(whole.shape, generator=torch.Generator()
                         .manual_seed(0))
    g_whole = fused_blend_bwd_plain(sp.pay, sp.tstart, sp.cnt, whole, g_out8,
                                    gx)
    tpb = whole.shape[0] // 4
    outs, g_band = [], torch.zeros_like(g_whole)
    for b in range(4):
        band = slice(b * tpb, (b + 1) * tpb)
        o = fused_blend_fwd_plain(sp.pay, sp.tstart[band], sp.cnt[band], gx,
                                  b * tpb)
        outs.append(o)
        g_band += fused_blend_bwd_plain(sp.pay, sp.tstart[band],
                                        sp.cnt[band], o, g_out8[band], gx,
                                        b * tpb)
    got = torch.cat(outs)
    torch.testing.assert_close(got[..., :5], whole[..., :5], atol=2e-4,
                               rtol=0)
    torch.testing.assert_close(got[..., 5], whole[..., 5], atol=2e-5, rtol=0)
    assert torch.equal(got[..., 6], whole[..., 6])
    scale = g_whole.abs().amax(dim=1).clamp_min(1e-30)
    assert float(((g_band - g_whole).abs().amax(dim=1) / scale).max()) < 2e-4
