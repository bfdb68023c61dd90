"""Flow estimation of the port (eogs2_tpu_torch/flow.py) against
eogs2_tpu/flow.py, both on the CPU, on seeded inputs.

The inputs are noise images (lightly blurred) moved by a known integer
plus sub-pixel shift through the Fourier shift theorem, so that every
frequency carries signal: phase correlation normalises each frequency's
cross-power to unit magnitude, and on a smooth image the near-empty high
frequencies turn one-ulp FFT differences into a different peak.
Tolerances: shifts 1e-3 px; warps 1e-5; the LK building blocks (the
separable blur, the bilinear upsampling, the warp by a dense flow, the
image gradient) 1e-6; LK flow with one iteration per pyramid level 1e-4 px
over the whole frame. At the default ten iterations per level the
undamped Gauss-Newton steps amplify float32 round-off in both packages,
most at the border, where the zero-padded blur leaves the normal
equations nearly singular, so the two flows drift far beyond 1e-4 px
there; the interior's median flow is compared, within 1e-3 px;
flow_accept decisions exact; adjust_affine 1e-6 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from scipy.ndimage import fourier_shift, gaussian_filter

import eogs2_tpu.flow as J
import eogs2_tpu_torch.flow as T

SHIFTS = [(3.3, -2.6), (-5.2, 4.4), (0.4, 0.3), (7.25, 1.5)]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run this file's torch ops on one thread: beside the other test
    workers, torch's default pool (one thread per core) oversubscribes the
    cores and its many small parallel regions slow the file tenfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(dx, dy, shape=(96, 96), sigma=0.7, seed=0):
    rng = np.random.RandomState(seed)
    img = gaussian_filter(rng.rand(*shape), sigma)
    moved = np.fft.ifft2(fourier_shift(np.fft.fft2(img), (dy, dx))).real
    return img.astype(np.float32)[None], moved.astype(np.float32)[None]


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("dx,dy", SHIFTS)
def test_phase_correlation_and_warp_match_jax(dx, dy):
    ref, mov = _pair(dx, dy)
    jdx, jdy = J.phase_correlation_shift(jnp.asarray(ref), jnp.asarray(mov))
    tdx, tdy = T.phase_correlation_shift(_t(ref), _t(mov))
    assert abs(float(tdx) - float(jdx)) < 1e-3
    assert abs(float(tdy) - float(jdy)) < 1e-3
    assert abs(float(tdx) - dx) < 0.25 and abs(float(tdy) - dy) < 0.25
    jw = J.apply_flow_to_image(jnp.asarray(mov), jdx, jdy)
    tw = T.apply_flow_to_image(_t(mov), _t(jdx), _t(jdy))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0, atol=1e-5)


def test_lucas_kanade_blocks_match_jax():
    rng = np.random.RandomState(1)
    x = rng.rand(50, 70).astype(np.float32)
    k = jnp.array([1.0, 4.0, 6.0, 4.0, 1.0]) / 16.0
    jsm = jax.vmap(lambda r: jnp.convolve(r, k, mode="same"))(jnp.asarray(x))
    jsm = jax.vmap(lambda c: jnp.convolve(c, k, mode="same"))(jsm.T).T
    np.testing.assert_allclose(T._smooth(_t(x)).numpy(), np.asarray(jsm),
                               rtol=0, atol=1e-6)
    for lo, hi in (((25, 35), (50, 70)), ((12, 17), (25, 35))):
        f = rng.rand(*lo).astype(np.float32)
        up = F.interpolate(_t(f)[None, None], size=hi, mode="bilinear",
                           align_corners=False)[0, 0]
        np.testing.assert_allclose(
            up.numpy(), np.asarray(jax.image.resize(jnp.asarray(f), hi,
                                                    "bilinear")),
            rtol=0, atol=1e-6)
    fx, fy = (rng.uniform(-2, 2, (50, 70)).astype(np.float32) for _ in "xy")
    np.testing.assert_allclose(
        T._warp_by_flow(_t(x[None]), _t(fx), _t(fy)).numpy(),
        np.asarray(J._warp_by_flow(jnp.asarray(x[None]), jnp.asarray(fx),
                                   jnp.asarray(fy))), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(
        torch.gradient(_t(x), dim=1)[0].numpy(),
        np.asarray(jnp.gradient(jnp.asarray(x), axis=1)))


@pytest.mark.parametrize("shape", [(50, 70), (64, 48)])
def test_lucas_kanade_matches_jax(shape):
    ref, mov = _pair(1.3, 0.6, shape=shape, sigma=1.0, seed=2)
    # one Gauss-Newton iteration per pyramid level: the whole frame
    jf = J.lucas_kanade_flow(jnp.asarray(ref), jnp.asarray(mov), iters=1)
    tf = T.lucas_kanade_flow(_t(ref), _t(mov), iters=1)
    for t, j in zip(tf, jf):
        assert t.shape == shape
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0,
                                   atol=1e-4)
    # the default 10 per level, through estimate_flow: the interior's
    # median flow (round-off grows over the iterations, in both packages)
    jf = J.estimate_flow(jnp.asarray(ref), jnp.asarray(mov),
                         perform_cst_displacement=False)
    tf = T.estimate_flow(_t(ref), _t(mov), perform_cst_displacement=False)
    inner = np.s_[8:-8, 8:-8]
    for t, j, want in zip(tf, jf, (1.3, 0.6)):
        med = float(np.median(t.numpy()[inner]))
        assert abs(med - float(np.median(np.asarray(j)[inner]))) < 1e-3
        assert abs(med - want) < 0.1


def test_flow_accept_decisions_match_jax():
    ref, mov = _pair(4.0, 0.0, sigma=2.0, seed=3)
    gt, render = np.repeat(ref, 3, 0), np.repeat(mov, 3, 0)
    dx, dy = J.phase_correlation_shift(jnp.asarray(gt), jnp.asarray(render))
    good = J.apply_flow_to_image(jnp.asarray(render), dx, dy)
    bad = J.apply_flow_to_image(jnp.asarray(render), dx + 20.0, dy)
    valid = np.ones((1,) + gt.shape[1:], bool)
    mag = float(0.5 * (abs(dx) + abs(dy)))
    seen = set()
    for crit in ("max_value_flow", "always", "psnr", "l_photom"):
        for warped in (good, bad):
            for thr in (5.0, 1.0):
                j = bool(J.flow_accept(crit, mag, jnp.asarray(render), warped,
                                       jnp.asarray(gt), jnp.asarray(valid),
                                       thr))
                t = bool(T.flow_accept(crit, mag, _t(render), _t(warped),
                                       _t(gt), _t(valid), thr))
                assert t == j, (crit, thr)
                seen.add((crit, j))
    assert len(seen) == 7  # every criterion but "always" both ways
    with pytest.raises(ValueError):
        T.flow_accept("nope", mag, _t(render), _t(good), _t(gt), _t(valid), 0)


def test_adjust_affine_matches_jax():
    a = np.array([[1.0, 0, 0.2, 0.1], [0, 1.0, -0.1, -0.1],
                  [0, 0, 1.0, 0.3]], np.float32)
    j = J.adjust_affine(jnp.asarray(a), img_w=100, img_h=50,
                        mean_flow_x=jnp.float32(5.3),
                        mean_flow_y=jnp.float32(-2.1))
    t = T.adjust_affine(_t(a), img_w=100, img_h=50,
                        mean_flow_x=torch.tensor(5.3),
                        mean_flow_y=torch.tensor(-2.1))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6, atol=0)
    np.testing.assert_array_equal(t.numpy()[2], a[2])
