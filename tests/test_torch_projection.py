"""Preprocess parity: eogs2_tpu_torch.ops.projection against eogs2_tpu's.

The same seeded numpy inputs go through both packages on the CPU. Float
fields agree within rtol 1e-5 (atol 1e-6 for entries that cancel to ~0:
both sides run the same float32 expressions, so any difference is
operation-order rounding); the integer fields (radius, tile rect, tiles
touched) must be exactly equal, since they decide which tiles a Gaussian
is binned into.

The closed-form backward (``preprocess_backward_plain``, the plain twin of
the card's backward kernel) is held against autograd of the plain forward
and against JAX's VJP, per leaf as the gap of the norms over the larger
norm (< 1e-5), NaN where they are NaN.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eogs2_tpu.ops import projection as jproj
from eogs2_tpu_torch.ops import projection as tproj
from eogs2_tpu_torch.ops.gaussians import build_cov3d
from tests.test_rasterizer import make_scene

RTOL, ATOL = 1e-5, 1e-6
INT_FIELDS = ("radius", "rect_min", "rect_size", "tiles_touched")


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


def _check_prep(jp, tp):
    for name in jproj.Preprocessed._fields:
        want = np.asarray(getattr(jp, name))
        got = getattr(tp, name).numpy()
        assert got.shape == want.shape, name
        if name in INT_FIELDS:
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                       err_msg=name)


@pytest.mark.parametrize("seed,wh,antialiasing", [
    (0, (64, 64), False),
    (1, (80, 48), False),
    (2, (128, 128), True),
])
def test_preprocess_matches_jax(seed, wh, antialiasing):
    w, h = wh
    means, scales, quats, opac, _, affine, _ = make_scene(n=256, seed=seed)
    alive = np.random.RandomState(seed).rand(256) > 0.2
    jc = jproj.compute_cov2d_direct(scales, quats, affine, w, h)
    tc = tproj.compute_cov2d_direct(_t(scales), _t(quats), _t(affine), w, h)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=RTOL,
                               atol=ATOL)
    jp = jproj.preprocess_gaussians(means, None, opac, affine, w, h,
                                    antialiasing=antialiasing,
                                    alive=jnp.asarray(alive), cov2d=jc)
    tp = tproj.preprocess_gaussians(_t(means), None, _t(opac), _t(affine),
                                    w, h, antialiasing=antialiasing,
                                    alive=_t(alive), cov2d=tc)
    _check_prep(jp, tp)


def test_preprocess_degenerate_determinants():
    """Rank-deficient splats (det(cov2d) == 0, the antialiasing clamp) and
    indefinite screen covariances (det <= 0 after dilation: culled with
    radius 0) take the same branches in both packages."""
    rng = np.random.RandomState(5)
    n, w, h = 64, 64, 64
    means, scales, quats, opac, _, affine, _ = make_scene(n=n, seed=9)
    scales = np.asarray(scales).copy()
    scales[:16, 1:] = 0.0  # needle: rank-1 covariance
    scales[16:24] = 0.0  # point: zero covariance
    cov = np.asarray(jproj.compute_cov2d_direct(
        jnp.asarray(scales), quats, affine, w, h)).copy()
    # indefinite: (cxx + .3)(cyy + .3) - cxy^2 < 0
    cov[24:40, 0] = -1.0
    cov[24:40, 2] = -1.0
    cov[24:40, 1] = rng.uniform(0.8, 2.0, 16)
    for aa in (False, True):
        jp = jproj.preprocess_gaussians(means, None, opac, affine, w, h,
                                        antialiasing=aa,
                                        cov2d=jnp.asarray(cov))
        tp = tproj.preprocess_gaussians(_t(means), None, _t(opac),
                                        _t(affine), w, h, antialiasing=aa,
                                        cov2d=_t(cov))
        _check_prep(jp, tp)
        assert (tp.radius[24:40] == 0).all()
        assert (tp.radius[:24] > 0).any()


def test_cov2d_direct_matches_composed():
    """compute_cov2d_direct == build_cov3d + compute_cov2d with raw
    (unnormalized) quaternions, values and gradients (mirrors
    tests/test_ops.py's JAX check)."""
    rng = np.random.RandomState(11)
    n, w, h = 257, 96, 96
    scales = torch.from_numpy(
        np.exp(rng.normal(-3, 0.5, (n, 3))).astype(np.float32))
    quats = torch.from_numpy(rng.normal(0, 1, (n, 4)).astype(np.float32))
    affine = torch.tensor([[1.0, 0.05, 0.3, 0.0], [0.02, 1.0, -0.2, 0.0],
                           [0.0, 0.0, 1.0, 0.0]])
    wts = torch.from_numpy(rng.uniform(-1, 1, (n, 3)).astype(np.float32))

    def composed(s, q, a):
        return tproj.compute_cov2d(build_cov3d(s, q), a, w, h)

    def direct(s, q, a):
        return tproj.compute_cov2d_direct(s, q, a, w, h)

    np.testing.assert_allclose(composed(scales, quats, affine).numpy(),
                               direct(scales, quats, affine).numpy(),
                               atol=1e-5, rtol=1e-5)
    grads = []
    for fn in (composed, direct):
        args = [x.clone().requires_grad_(True) for x in (scales, quats, affine)]
        (wts * fn(*args)).sum().backward()
        grads.append([a.grad.numpy() for a in args])
    for a_, b_ in zip(*grads):
        scale = np.abs(a_).max() + 1e-6
        np.testing.assert_allclose(a_ / scale, b_ / scale, atol=1e-5)


GRAD_GAP = 1e-5
LEAVES = ("means3d", "scales", "quats", "opacities", "affine", "offset")


def _torch_vjp(means, scales, quats, opac, affine, w, h, cts, aa, alive):
    """Autograd of the plain forward (rasterizer.preprocess on the CPU) with
    an NDC offset of zeros: the gradients of LEAVES."""
    from eogs2_tpu_torch.rasterizer import preprocess

    leaves = [_t(x).clone().requires_grad_(True)
              for x in (means, scales, quats, opac, affine)]
    off = torch.zeros((leaves[0].shape[0], 2), requires_grad=True)
    prep = preprocess(*leaves, w, h, antialiasing=aa, alive=alive,
                      mean2d_ndc_offset=off)
    loss = sum((_t(c) * o).sum() for c, o in zip(cts, prep[:4]))
    return torch.autograd.grad(loss, leaves + [off])


def _jax_vjp(means, scales, quats, opac, affine, w, h, cts, aa, alive):
    """JAX's VJP of eogs2_tpu's preprocess with the same offset."""
    def f(m, s, q, o, a, off):
        cov = jproj.compute_cov2d_direct(s, q, a, w, h)
        p = jproj.preprocess_gaussians(m, None, o, a, w, h, antialiasing=aa,
                                       alive=alive, cov2d=cov)
        px = jnp.asarray([0.5 * w, 0.5 * h], jnp.float32)
        return p.mean2d + off * px, p.depth, p.conic, p.opacity

    n = np.asarray(means).shape[0]
    _, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (means, scales, quats,
                                                   opac, affine)),
                     jnp.zeros((n, 2), jnp.float32))
    return [_t(g) for g in vjp(tuple(jnp.asarray(c) for c in cts))]


def _check_grads(got, want):
    for name, g, w in zip(LEAVES, got, want):
        assert g.shape == w.shape, name
        assert torch.equal(g.isnan(), w.isnan()), name
        g, w = g.nan_to_num(), w.nan_to_num()
        scale = max(float(g.norm()), float(w.norm()), 1e-30)
        assert float((g - w).norm()) / scale < GRAD_GAP, name


def _cotangents(n, seed):
    rng = np.random.RandomState(100 + seed)
    return [rng.normal(size=s).astype(np.float32)
            for s in ((n, 2), (n,), (n, 3), (n,))]


@pytest.mark.parametrize("antialiasing", [False, True])
@pytest.mark.parametrize("seed,wh", [(0, (64, 64)), (1, (80, 48)),
                                     (2, (128, 128))])
def test_backward_twin_matches_autograd_and_jax(seed, wh, antialiasing):
    """The closed-form gradients of every leaf, the affine's and the NDC
    offset's too, against autograd of the plain forward and JAX's VJP."""
    w, h = wh
    means, scales, quats, opac, _, affine, _ = make_scene(n=256, seed=seed)
    affine = np.asarray(affine).copy()
    affine[2] = [0.1, -0.2, 1.0, 0.3]  # an altitude row with every term
    alive = np.random.RandomState(seed).rand(256) > 0.2
    cts = _cotangents(256, seed)
    twin = tproj.preprocess_backward_plain(
        *(_t(x) for x in (means, scales, quats, opac, affine)), w, h,
        [_t(c) for c in cts], antialiasing=antialiasing)
    args = (means, scales, quats, opac, affine, w, h, cts, antialiasing)
    _check_grads(twin, _torch_vjp(*args, _t(alive)))
    _check_grads(twin, _jax_vjp(*args, jnp.asarray(alive)))


@pytest.mark.parametrize("antialiasing", [False, True])
def test_backward_twin_degenerate_determinants(antialiasing):
    """Needles and points (det_cov 0) and long needles whose dilated det
    rounds to 0 or below (culled; det_safe the constant 1, so no gradient
    through det): the same gradients, and the same NaN where the antialias
    ratio divides by a zero det."""
    n, w, h = 64, 64, 64
    means, scales, quats, opac, _, affine, _ = make_scene(n=n, seed=9)
    scales = np.asarray(scales).copy()
    scales[:16, 1:] = 0.0  # needle: rank-1 covariance
    scales[16:24] = 0.0  # point: zero covariance
    scales[24:40, 0] = np.geomspace(1e2, 1e5, 16)  # det rounds to <= 0
    scales[24:40, 1:] = 1e-3
    cov = tproj.compute_cov2d_direct(_t(scales), _t(quats), _t(affine), w, h)
    det = (cov[:, 0] + 0.3) * (cov[:, 2] + 0.3) - cov[:, 1] * cov[:, 1]
    assert (det[24:40] < 0).any() and (det[24:40] == 0).any()
    cts = _cotangents(n, 9)
    twin = tproj.preprocess_backward_plain(
        *(_t(x) for x in (means, scales, quats, opac, affine)), w, h,
        [_t(c) for c in cts], antialiasing=antialiasing)
    args = (means, scales, quats, opac, affine, w, h, cts, antialiasing)
    _check_grads(twin, _torch_vjp(*args, None))
    _check_grads(twin, _jax_vjp(*args, None))


def test_backward_twin_without_cotangents():
    """A cotangent left out (None) counts as zero."""
    means, scales, quats, opac, _, affine, _ = make_scene(n=32, seed=4)
    ins = [_t(x) for x in (means, scales, quats, opac, affine)]
    cts = [_t(c) for c in _cotangents(32, 4)]
    full = tproj.preprocess_backward_plain(*ins, 48, 48,
                                           [cts[0], None, cts[2], None])
    zeros = tproj.preprocess_backward_plain(
        *ins, 48, 48, [cts[0], torch.zeros(32), cts[2], torch.zeros(32)])
    for a, b in zip(full, zeros):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
