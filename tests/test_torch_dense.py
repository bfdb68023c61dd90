"""Dense-mode parity: eogs2_tpu_torch's ``gather`` and ``sorted`` raster
modes (binning, the dense pair table, the plain dense blend and K4's plain
versions, which the wrappers take for CPU tensors) against eogs2_tpu's on
the CPU, with JAX's Pallas blend in interpret mode as its own tests run it;
and the fused route's row payload (K3's) against its column payload.

Tolerances (tests/test_golden.py's): image atol 2e-4, final_t atol 2e-5,
every gradient's max-abs error over its max-abs value < 2e-4; the plain K4
against JAX's interpret-mode K4 at the same tolerances, with n_contrib
exact; integer binning results exact.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eogs2_tpu.ops import binning as jbin
from eogs2_tpu.ops.blend import blend_tiles as j_blend_tiles
from eogs2_tpu.ops.blend_pallas import (blend_backward_pallas,
                                        blend_forward_pallas,
                                        blend_tiles_pallas)
from eogs2_tpu.ops.blend_pallas import pack_tile_data as j_pack
from eogs2_tpu.ops.pair_pipeline import densify_pairs as j_densify
from eogs2_tpu.ops.projection import (compute_cov2d_direct as j_cov2d,
                                      preprocess_gaussians as j_prep)
from eogs2_tpu.rasterizer import RasterizeConfig as JConfig
from eogs2_tpu.rasterizer import rasterize as jrasterize
from eogs2_tpu_torch.ops import binning as tbin
from eogs2_tpu_torch.ops.blend import blend_tile, blend_tiles
from eogs2_tpu_torch.ops.blend_cuda import (BlendTilesPallas, blend_backward,
                                            blend_backward_plain,
                                            blend_forward, blend_forward_plain)
from eogs2_tpu_torch.ops.pair_pipeline import _DensePairs, densify_pairs
from eogs2_tpu_torch.ops.projection import (compute_cov2d_direct,
                                            preprocess_gaussians)
from eogs2_tpu_torch.rasterizer import RasterizeConfig, rasterize
from eogs2_tpu_torch.train import Trainer
from tests.test_blend_pallas import make_tiles
from tests.test_rasterizer import make_scene

W = H = 64
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "scene1.npz")
GRAD_NAMES = ("means", "scales", "quats", "opacities", "features", "affine",
              "mean2d_ndc")
DENSE = [("gather", False), ("gather", True), ("sorted", False),
         ("sorted", True)]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run this file's torch ops on one thread: beside the other test
    workers, torch's default pool (one thread per core) oversubscribes the
    cores and its many small parallel regions slow the file down."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.array(x))


def _rel_err(got, want):
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max()
                 / (np.abs(want).max() + 1e-30))


def _preps(args, w, h):
    """The same scene preprocessed by both packages."""
    jp = j_prep(args[0], None, args[3], args[5], w, h,
                cov2d=j_cov2d(args[1], args[2], args[5], w, h))
    t = [_t(a) for a in args]
    tp = preprocess_gaussians(t[0], None, t[3], t[5], w, h,
                              cov2d=compute_cov2d_direct(t[1], t[2], t[5],
                                                         w, h))
    return jp, tp


# ---------------------------------------------------------------------------
# binning and the dense pair table
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tcap,k", [(64, 256), (2, 16)])
def test_binning_matches_jax(tcap, k):
    """Tile ranges, demand and the dense [T, K] view of the sorted pairs;
    (2, 16) clips both at max_tiles_per_gaussian and at K."""
    args = make_scene(n=300, seed=7)
    jp, tp = _preps(args, W, H)
    jb = jax.jit(lambda p: jbin.bin_gaussians(p, W, H,
                                              max_tiles_per_gaussian=tcap))(jp)
    tb = tbin.bin_gaussians(tp, W, H, max_tiles_per_gaussian=tcap)
    for f in ("tile_start", "tile_count", "num_pairs", "max_tile_count"):
        np.testing.assert_array_equal(getattr(tb, f).numpy(),
                                      np.asarray(getattr(jb, f)), f)
    n_pairs = int(tb.tile_count.sum())
    np.testing.assert_array_equal(tb.pair_gauss.numpy(),
                                  np.asarray(jb.pair_gauss)[:n_pairs])
    np.testing.assert_array_equal(tb.pair_tile.numpy(),
                                  np.asarray(jb.pair_tile)[:n_pairs])
    jidx, jmask = jbin.tile_pair_indices(jb, k)
    tidx, tmask = tbin.tile_pair_indices(tb, k)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    if tcap == 2:
        assert int(tp.tiles_touched.max()) > tcap
        assert int(tb.max_tile_count) > k
        assert int(tb.num_pairs) > n_pairs


@pytest.mark.parametrize("tcap,k", [(64, 256), (2, 16)])
def test_densify_pairs_matches_jax(tcap, k):
    """Values, mask and counts of the packed dense table (JAX's dense table
    through its pack_tile_data), and its backward (the deterministic slot ->
    emission -> segment-sum path) against JAX's VJP."""
    args = make_scene(n=300, seed=7)
    feats = np.asarray(args[4])
    jp, tp = _preps(args, W, H)
    tf = _t(feats).requires_grad_(True)
    m2 = tp.mean2d.detach().requires_grad_(True)
    tp = tp._replace(mean2d=m2)
    td = densify_pairs(tp, tf, W, H, tcap=tcap, tile_capacity=k)
    ct = np.random.RandomState(0).normal(size=td.data.shape).astype(np.float32)

    def packed(d):
        x = d.data
        return j_pack(x[..., 0:2], x[..., 2:5], x[..., 5], x[..., 6:], d.mask)

    def jloss(m2, f):
        d = j_densify(jp._replace(mean2d=m2), f, W, H, tcap=tcap,
                      tile_capacity=k)
        return jnp.sum(packed(d) * ct), (d, packed(d))

    (_, (jd, jdata)), jg = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jp.mean2d, jnp.asarray(feats))
    np.testing.assert_array_equal(td.mask.numpy(), np.asarray(jd.mask))
    np.testing.assert_array_equal(td.tile_count.numpy(),
                                  np.asarray(jd.tile_count))
    assert int(td.num_pairs) == int(jd.num_pairs)
    assert int(td.max_tile_count) == int(jd.max_tile_count)
    np.testing.assert_allclose(td.data.detach().numpy(), np.asarray(jdata),
                               atol=1e-6, rtol=1e-6)
    (td.data * _t(ct)).sum().backward()
    np.testing.assert_allclose(m2.grad.numpy(), np.asarray(jg[0]), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(tf.grad.numpy(), np.asarray(jg[1]), atol=1e-5,
                               rtol=1e-5)


def test_dense_pairs_backward_is_a_segment_sum():
    """The dense table's backward equals the scatter-add autograd of
    pay[gid] would do; a pair dropped past K and rows 11-15 give nothing."""
    args = make_scene(n=300, seed=7)
    _, tp = _preps(args, W, H)
    b = tbin.bin_gaussians(tp, W, H, max_tiles_per_gaussian=8)
    idx, mask = tbin.tile_pair_indices(b, 8)
    pay = torch.randn(300, 11, dtype=torch.float64, requires_grad=True)
    dense = _DensePairs.apply(pay, b.pair_gauss, b.perm, b.lengths, idx, mask)
    g = torch.randn_like(dense)
    dense.backward(g)
    gidx = b.pair_gauss[idx]
    want = torch.zeros(300, 11, dtype=torch.float64).index_add_(
        0, gidx[mask], g[:, :11].transpose(1, 2)[mask])
    assert (dense[:, 11] == mask).all() and (dense[:, 12:] == 0).all()
    torch.testing.assert_close(pay.grad, want)
    assert int(b.max_tile_count) > 8  # some pairs were dropped


# ---------------------------------------------------------------------------
# the plain dense blend and K4's plain versions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("custom", [True, False])
def test_blend_tiles_matches_jax(custom):
    m2, co, op, ft, mk, org, bg = make_tiles(t=6, k=64, seed=2, grid_x=3)
    w = np.arange(5.0, dtype=np.float32) + 1.0

    def jloss(m2, co, op, ft, bg):
        out, fin = j_blend_tiles(m2, co, op, ft, mk, org, bg, tile_chunk=4,
                                 use_custom_vjp=custom)
        return jnp.sum(out * w) + 0.3 * jnp.sum(fin ** 2), (out, fin)

    (_, (jout, jfin)), jg = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1, 2, 3, 4), has_aux=True))(m2, co, op, ft, bg)
    leaves = [_t(x).requires_grad_(True) for x in (m2, co, op, ft, bg)]
    out, fin = blend_tiles(*leaves[:4], _t(mk), _t(org), leaves[4],
                           tile_chunk=4, use_custom_vjp=custom)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=2e-4, rtol=0)
    np.testing.assert_allclose(fin.detach().numpy(), np.asarray(jfin),
                               atol=2e-5, rtol=0)
    ((out * _t(w)).sum() + 0.3 * (fin ** 2).sum()).backward()
    for x, g in zip(leaves, jg):
        assert _rel_err(x.grad.numpy(), g) < 2e-4
    one, one_t = blend_tile(*(_t(x)[0] for x in (m2, co, op, ft, mk, org)),
                            _t(bg))
    np.testing.assert_allclose(one.numpy(), out[0].detach().numpy(),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(one_t.numpy(), fin[0].detach().numpy(),
                               atol=1e-7, rtol=0)


@pytest.mark.parametrize("k", [128, 256])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_k4_matches_jax_interpret(k, seed):
    """blend_forward_plain / blend_backward_plain against the JAX kernels in
    interpret mode, random masks; n_contrib exact."""
    m2, co, op, ft, mk, _, _ = make_tiles(t=8, k=k, seed=seed, grid_x=4)
    data = j_pack(m2, co, op, ft, mk)
    jo = np.asarray(blend_forward_pallas(data, 4, k_chunk=k, interpret=True))
    to = blend_forward(_t(data), 4).numpy()
    np.testing.assert_allclose(to[..., :5], jo[..., :5], atol=2e-4, rtol=0)
    np.testing.assert_allclose(to[..., 5], jo[..., 5], atol=2e-5, rtol=0)
    np.testing.assert_array_equal(to[..., 6], jo[..., 6])
    assert (to[..., 7] == 0).all()
    assert 0 < (jo[..., 6] < k).mean() < 1  # some pixels stop, some do not
    gout = np.random.RandomState(seed).normal(size=jo.shape).astype(
        np.float32)
    gout[..., 6:8] = jo[..., 5:7]
    jg = np.asarray(blend_backward_pallas(data, jnp.asarray(gout), 4,
                                          k_chunk=k, interpret=True))
    tg = blend_backward(_t(data), _t(gout), 4).numpy()
    for r in range(11):
        assert _rel_err(tg[:, r], jg[:, r]) < 2e-4, r
    assert (tg[:, 11:] == 0).all()


def test_plain_k4_skips_trailing_empty_slots():
    """Masks that end early, as the dense view makes them (k < count), one
    tile without a pair: the plain K4 skips the empty slots after each
    tile's last pair and still gives JAX's out (n_contrib K for a pixel
    live through them) and gradients."""
    m2, co, op, ft, mk, _, _ = make_tiles(t=8, k=128, seed=4, grid_x=4)
    count = np.array([0, 3, 17, 40, 64, 90, 128, 111])
    mk = np.arange(128)[None, :] < count[:, None]
    data = j_pack(m2, co, op, ft, jnp.asarray(mk))
    jo = np.asarray(blend_forward_pallas(data, 4, k_chunk=128,
                                         interpret=True))
    to = blend_forward(_t(data), 4).numpy()
    np.testing.assert_allclose(to[..., :5], jo[..., :5], atol=2e-4, rtol=0)
    np.testing.assert_allclose(to[..., 5], jo[..., 5], atol=2e-5, rtol=0)
    np.testing.assert_array_equal(to[..., 6], jo[..., 6])
    assert (to[0, :, 6] == 128).all() and (to[0, :, 5] == 1).all()
    gout = np.random.RandomState(4).normal(size=jo.shape).astype(np.float32)
    gout[..., 6:8] = jo[..., 5:7]
    jg = np.asarray(blend_backward_pallas(data, jnp.asarray(gout), 4,
                                          k_chunk=128, interpret=True))
    tg = blend_backward(_t(data), _t(gout), 4).numpy()
    for r in range(11):
        assert _rel_err(tg[:, r], jg[:, r]) < 2e-4, r
    assert (tg[~np.broadcast_to(mk[:, None, :], tg.shape)] == 0).all()


def test_plain_k4_chunking_is_invisible():
    m2, co, op, ft, mk, _, _ = make_tiles(t=8, k=128, seed=1, grid_x=4)
    data = _t(j_pack(m2, co, op, ft, mk))
    whole = blend_forward_plain(data, 4)
    tiny = blend_forward_plain(data, 4, chunk_elems=1)
    torch.testing.assert_close(whole, tiny, rtol=0, atol=0)
    gout = torch.randn(whole.shape, generator=torch.Generator().manual_seed(0))
    gout[..., 6:8] = whole[..., 5:7]
    torch.testing.assert_close(blend_backward_plain(data, gout, 4),
                               blend_backward_plain(data, gout, 4,
                                                    chunk_elems=1),
                               rtol=0, atol=0)


def test_blend_tiles_pallas_contract_matches_jax():
    """BlendTilesPallas: (img with background, final_t), and the gradients
    of data and bg, against blend_tiles_pallas in interpret mode."""
    m2, co, op, ft, mk, _, bg = make_tiles(t=4, k=128, seed=3, grid_x=2)
    jdata = j_pack(m2, co, op, ft, mk)
    data = _t(jdata)
    w = np.arange(5.0, dtype=np.float32) + 1.0

    def jloss(d, bg):
        img, fin = blend_tiles_pallas(d, bg, 2, 128, True)
        return jnp.sum(img * w) + 0.3 * jnp.sum(fin ** 2), (img, fin)

    (_, (jimg, jfin)), (jgd, jgb) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jdata, bg)
    d = data.clone().requires_grad_(True)
    b = _t(bg).requires_grad_(True)
    img, fin = BlendTilesPallas.apply(d, b, 2)
    np.testing.assert_allclose(img.detach().numpy(), np.asarray(jimg),
                               atol=2e-4, rtol=0)
    np.testing.assert_allclose(fin.detach().numpy(), np.asarray(jfin),
                               atol=2e-5, rtol=0)
    ((img * _t(w)).sum() + 0.3 * (fin ** 2).sum()).backward()
    for got, want in zip(_t(d.grad).split(1, dim=1)[:11],
                         np.split(np.asarray(jgd), 16, axis=1)):
        assert _rel_err(got.numpy(), want) < 2e-4
    assert (d.grad[:, 11:] == 0).all()
    assert _rel_err(b.grad.numpy(), jgb) < 2e-4


def test_k4_wrappers_take_only_cpu_or_cuda():
    data = torch.zeros((2, 16, 8), device="meta")
    gout = torch.zeros((2, 256, 8), device="meta")
    with pytest.raises(ValueError, match="device"):
        blend_forward(data, 1)
    with pytest.raises(ValueError, match="device"):
        blend_backward(data, gout, 1)
    with pytest.raises(ValueError, match="grid_x"):
        blend_forward(torch.zeros((3, 16, 8)), 2)
    with pytest.raises(ValueError, match="data"):
        blend_forward(torch.zeros((2, 12, 8)), 1)
    with pytest.raises(ValueError, match="gout"):
        blend_backward(torch.zeros((2, 16, 8)), torch.zeros((2, 256, 7)), 1)


# ---------------------------------------------------------------------------
# rasterize on every dense route, and the fused route's row payload
# ---------------------------------------------------------------------------


def _cfg(mode, pallas, **kw):
    kw = dict(dict(tile_capacity=256, max_tiles_per_gaussian=64,
                   tile_chunk=16), **kw)
    return dict(binning_mode=mode, use_pallas=pallas, **kw)


def _port_grads(args, ct, w, h, cfg):
    leaves = [torch.tensor(np.array(a), requires_grad=True)
              for a in args[:6]]
    off = torch.zeros((leaves[0].shape[0], 2), requires_grad=True)
    out = rasterize(*leaves, _t(args[6]), w, h, cfg, mean2d_ndc_offset=off)
    (out.image * _t(ct)).sum().backward()
    return out, [x.grad.numpy() for x in leaves + [off]]


@pytest.mark.parametrize("mode,pallas", DENSE)
def test_dense_rasterize_matches_jax(mode, pallas):
    """Image, final_t, demand statistics and every input's gradient (affine
    and the NDC offset included) against JAX's rasterize."""
    args = make_scene(n=300, seed=7)
    ct = np.random.RandomState(0).normal(size=(5, H, W)).astype(np.float32)
    cfg = _cfg(mode, pallas)

    def loss(*xs):
        out = jrasterize(*xs[:6], args[6], W, H, JConfig(**cfg),
                         mean2d_ndc_offset=xs[6])
        return jnp.sum(out.image * ct), out

    (_, jo), want = jax.jit(jax.value_and_grad(
        loss, argnums=tuple(range(7)), has_aux=True))(
        *args[:6], jnp.zeros((300, 2), jnp.float32))
    to, got = _port_grads(args, ct, W, H, RasterizeConfig(**cfg))
    assert int(jo.max_tile_count) <= cfg["tile_capacity"]
    np.testing.assert_allclose(to.image.detach().numpy(), np.asarray(jo.image),
                               atol=2e-4, rtol=0)
    np.testing.assert_allclose(to.final_t.detach().numpy(),
                               np.asarray(jo.final_t), atol=2e-5, rtol=0)
    for f in ("num_pairs", "max_tile_count", "max_tiles_per_gaussian_seen"):
        assert int(getattr(to, f)) == int(getattr(jo, f)), f
    assert to.clipped_pairs is None and jo.clipped_pairs is None
    for name, g, j in zip(GRAD_NAMES, got, want):
        assert np.abs(np.asarray(j)).max() > 0, name
        assert _rel_err(g, j) < 2e-4, name


@pytest.mark.parametrize("mode,pallas", DENSE)
def test_dense_golden(mode, pallas):
    """tests/golden/scene1.npz (the float64 oracle) at test_golden.py's
    tolerances."""
    g = np.load(GOLDEN)
    w, h = int(g["width"]), int(g["height"])
    args = [g[k] for k in ("means", "scales", "quats", "opac", "feat",
                           "affine", "bg")]
    out, grads = _port_grads(args, g["ct"], w, h,
                             RasterizeConfig(**_cfg(mode, pallas,
                                                    tile_chunk=64)))
    assert int(out.max_tile_count) <= 256
    np.testing.assert_allclose(out.image.detach().numpy(), g["noaa_image"],
                               atol=2e-4, rtol=0)
    np.testing.assert_allclose(out.final_t.detach().numpy(),
                               g["noaa_final_T"], atol=2e-5, rtol=0)
    for name, grad in zip(GRAD_NAMES, grads):
        assert _rel_err(grad, g[f"noaa_g_{name}"]) < 2e-4, name


def test_dense_modes_clip_as_jax():
    """A tile_capacity and max_tiles_per_gaussian below the demand clip the
    same pairs in both packages; the demand statistics show it."""
    args = make_scene(n=300, seed=7)
    for pallas in (False, True):
        cfg = _cfg("sorted", pallas, tile_capacity=16,
                   max_tiles_per_gaussian=2)
        jo = jrasterize(*args, W, H, JConfig(**cfg))
        to = rasterize(*(_t(a) for a in args), W, H, RasterizeConfig(**cfg))
        assert int(to.max_tile_count) > 16
        assert int(to.max_tiles_per_gaussian_seen) > 2
        np.testing.assert_allclose(to.image.numpy(), np.asarray(jo.image),
                                   atol=2e-4, rtol=0)
        np.testing.assert_allclose(to.final_t.numpy(), np.asarray(jo.final_t),
                                   atol=2e-5, rtol=0)


@pytest.mark.parametrize("kw", [{}, {"eogs_features": True,
                                     "tile_cull": True}])
def test_fused_rows_equal_columns(kw):
    """payload_col=False (K3's row payload) gives the column route's image
    and every gradient bit for bit."""
    args = make_scene(n=300, seed=7)
    ct = np.random.RandomState(1).normal(size=(5, H, W)).astype(np.float32)
    res = []
    for col in (True, False):
        cfg = RasterizeConfig(binning_mode="fused", payload_col=col, **kw)
        out, grads = _port_grads(args, ct, W, H, cfg)
        res.append([out.image.detach().numpy(),
                    out.final_t.detach().numpy()] + grads)
    for a, b in zip(*res):
        np.testing.assert_array_equal(a, b)


def test_unknown_mode_raises():
    args = [_t(a) for a in make_scene(n=16, seed=0)]
    with pytest.raises(ValueError, match="binning_mode"):
        rasterize(*args, 32, 32, RasterizeConfig(binning_mode="dense"))


# ---------------------------------------------------------------------------
# the Trainer's defaults and capacity grow
# ---------------------------------------------------------------------------


def test_trainer_default_route_is_jax_default():
    from eogs2_tpu.train import Trainer as JTrainer

    tr = Trainer.__dataclass_fields__["raster_cfg"].default
    jt = JTrainer.__dataclass_fields__["raster_cfg"].default
    assert tr == RasterizeConfig()
    assert dataclasses.asdict(tr) == dataclasses.asdict(jt)


@pytest.mark.parametrize("max_tile,mtg,want", [
    (900, 16, (1024, 16)),
    (972, 16, (1024, 16)),
    (973, 16, (2048, 16)),
    (973, 17, (2048, 32)),
    (10, 40, (1024, 64)),
    (7185, 196, (8192, 256)),
])
def test_capacity_grow_rule(max_tile, mtg, want):
    """JAX's triggers (the densest tile at 95% of tile_capacity, a Gaussian
    wider than max_tiles_per_gaussian), each capacity re-sized to the
    demand's power-of-two bucket, the densest tile below 95% of it; the
    fused route reads neither and keeps its config."""
    for mode in ("sorted", "fused"):
        rc = RasterizeConfig(binning_mode=mode, use_pallas=True)
        tr = Trainer(cfg=None, scene=None, raster_cfg=rc)
        tr._grow_capacities({"max_tile": torch.tensor(max_tile),
                             "max_tiles_per_gaussian": torch.tensor(mtg)})
        got = tr.raster_cfg
        if mode == "fused":
            assert got is rc
            continue
        assert (got.tile_capacity, got.max_tiles_per_gaussian) == want
        assert (got is rc) == (want == (1024, 16))
        assert max_tile < 0.95 * got.tile_capacity or got is rc


@pytest.mark.parametrize("seen", [(0, 1), (127, 4), (128, 5), (7185, 196),
                                  (1013, 16)])
def test_bucketed_matches_jax(seen):
    got = RasterizeConfig(binning_mode="sorted").bucketed(*seen)
    want = JConfig(binning_mode="sorted").bucketed(*seen)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
