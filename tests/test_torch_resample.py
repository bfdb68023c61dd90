"""The port's deterministic bilinear resample (eogs2_tpu_torch/ops/
resample.py) against ``F.grid_sample`` and against eogs2_tpu's
``grid_sample`` and its ``jax.vjp``, on the CPU; one ``cuda`` case on the
card.

Tolerances: the forward is F.grid_sample's own (bit-equal to it) and
JAX's within atol 1e-6 (float32, the same four taps summed in another
order); each gradient within 1e-6 of its largest value against
F.grid_sample's backward and JAX's VJP (float32 sums over the taps in
another order; JAX's weights are (1 - tx)(1 - ty), F.grid_sample's
(x0 + 1 - fx)(y0 + 1 - fy), one rounding apart). The derivative jumps at
whole pixels, so the random cases draw their sample points at least 1e-3
px away from them, and one case samples exactly on whole pixels, where
both packages and F.grid_sample take the floor's side.

JAX is imported inside the tests that use it, so that the card's machine
(no JAX) can run the ``cuda`` case alone:

    python -m pytest tests/test_torch_resample.py -m cuda --noconftest
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from eogs2_tpu_torch.ops.resample import grid_sample, img_grad

TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run this file's torch ops on one thread: beside the other test
    workers, torch's default pool oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the card's grid_sample backward "
                    "is the one that adds atomically")
    return torch.device("cuda")


def _off_pixels(coord, size, align_corners, margin=1e-3):
    """coord moved so that its pixel coordinate is at least `margin` px
    from a whole pixel."""
    f = ((coord + 1) / 2 * (size - 1) if align_corners
         else ((coord + 1) * size - 1) / 2)
    frac = f - np.floor(f)
    f = np.where(frac < margin, f + 2 * margin,
                 np.where(frac > 1 - margin, f - 2 * margin, f))
    return (f / (size - 1) * 2 - 1 if align_corners
            else (2 * f + 1) / size - 1).astype(np.float32)


def _case(seed, c, h, w, ho, wo, align_corners=True, lo=-1.0, hi=1.0):
    rng = np.random.RandomState(seed)
    img = rng.normal(0, 1, (c, h, w)).astype(np.float32)
    gx = _off_pixels(rng.uniform(lo, hi, (ho, wo)), w, align_corners)
    gy = _off_pixels(rng.uniform(lo, hi, (ho, wo)), h, align_corners)
    grid = np.stack([gx, gy], -1).astype(np.float32)
    cot = rng.normal(0, 1, (c, ho, wo)).astype(np.float32)
    return img, grid, cot


def _port(img, grid, cot, align_corners=True, device="cpu"):
    x = torch.tensor(img, device=device, requires_grad=True)
    g = torch.tensor(grid, device=device, requires_grad=True)
    out = grid_sample(x, g, align_corners=align_corners)
    (out * torch.tensor(cot, device=device)).sum().backward()
    return out.detach().cpu(), x.grad.cpu(), g.grad.cpu()


def _torch_ref(img, grid, cot, align_corners=True, device="cpu"):
    x = torch.tensor(img, device=device, requires_grad=True)
    g = torch.tensor(grid, device=device, requires_grad=True)
    out = F.grid_sample(x[None], g[None], mode="bilinear",
                        padding_mode="zeros", align_corners=align_corners)[0]
    (out * torch.tensor(cot, device=device)).sum().backward()
    return out.detach().cpu(), x.grad.cpu(), g.grad.cpu()


def _jax_ref(img, grid, cot):
    import jax
    import jax.numpy as jnp

    from eogs2_tpu.ops.resample import grid_sample as jgrid_sample

    @jax.jit
    def fwd_vjp(a, b, c):
        out, vjp = jax.vjp(lambda a, b: jgrid_sample(a, b, True), a, b)
        return (out,) + vjp(c)

    return tuple(torch.from_numpy(np.array(a)) for a in fwd_vjp(
        jnp.asarray(img), jnp.asarray(grid), jnp.asarray(cot)))


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _agree(got, want, fwd_exact=False):
    if fwd_exact:
        assert torch.equal(got[0], want[0])
    else:
        assert float((got[0] - want[0]).abs().max()) <= TOL
    assert _rel(got[1], want[1]) <= TOL
    assert _rel(got[2], want[2]) <= TOL


@pytest.mark.parametrize("align_corners", [True, False])
def test_matches_torch_grid_sample(align_corners):
    case = _case(0, 3, 40, 56, 24, 32, align_corners)
    _agree(_port(*case, align_corners), _torch_ref(*case, align_corners),
           fwd_exact=True)


def test_matches_jax_grid_sample_and_vjp():
    case = _case(1, 4, 48, 40, 32, 24)
    _agree(_port(*case), _jax_ref(*case))


def test_sun_shaped_resample():
    """The training step's sun resample scaled down: C=5, a 64^2 render
    sampled on a 32^2 grid (2048^2 to 1024^2 at full size) through an
    affine map whose edge samples fall outside the render."""
    rng = np.random.RandomState(2)
    img = rng.normal(0, 1, (5, 64, 64)).astype(np.float32)
    v, u = np.meshgrid(np.linspace(-1, 1, 32), np.linspace(-1, 1, 32),
                       indexing="ij")
    gx = _off_pixels(0.55 * u + 0.12 * v + 0.3, 64, True)
    gy = _off_pixels(-0.08 * u + 0.6 * v - 0.45, 64, True)
    grid = np.stack([gx, gy], -1).astype(np.float32)
    cot = rng.normal(0, 1, (5, 32, 32)).astype(np.float32)
    got = _port(img, grid, cot)
    _agree(got, _torch_ref(img, grid, cot), fwd_exact=True)
    _agree(got, _jax_ref(img, grid, cot))


def test_whole_pixels_take_the_floor_side():
    """Samples exactly on whole pixels (w - 1 = 8, so u = -1 + k/4 is
    pixel k exactly): the forward is the pixel, dL/d(img) puts the whole
    weight on it, and dL/d(grid) is F.grid_sample's one-sided derivative
    toward the next pixel (JAX's, from the floor, is the same)."""
    rng = np.random.RandomState(3)
    img = rng.normal(0, 1, (2, 9, 9)).astype(np.float32)
    k = rng.randint(0, 9, (6, 7, 2))
    grid = (-1 + k / 4.0).astype(np.float32)
    cot = rng.normal(0, 1, (2, 6, 7)).astype(np.float32)
    got = _port(img, grid, cot)
    assert torch.equal(got[0], torch.from_numpy(img[:, k[..., 1],
                                                    k[..., 0]]))
    want = _torch_ref(img, grid, cot)
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    _agree(got, _jax_ref(img, grid, cot))


def test_out_of_bounds_taps_are_dropped():
    """Samples partly and wholly outside the image, and far outside: the
    taps outside add nothing; an upstream gradient of inf at a sample
    whose taps are all outside reaches no pixel (JAX's masked taps would
    carry 0 * inf there)."""
    case = _case(4, 3, 20, 24, 16, 16, lo=-1.4, hi=1.4)
    _agree(_port(*case), _torch_ref(*case), fwd_exact=True)
    _agree(_port(*case), _jax_ref(*case))
    img, grid, cot = case
    grid[0, 0] = (5.0, -7.0)
    cot[:, 0, 0] = np.inf
    g_img = img_grad(torch.tensor(cot), torch.tensor(grid), img.shape)
    assert bool(torch.isfinite(g_img).all())


def test_backward_uses_no_accumulating_scatter(monkeypatch):
    """The backward calls no index_add_, scatter_add_ or index_put_ (the
    accumulating forms are atomic on CUDA), and the grid gradient's
    grid_sampler_2d_backward asks for the grid's part only."""
    def refuse(name):
        def call(*args, **kw):
            raise AssertionError(f"{name} on the resample's backward")
        return call

    for name in ("index_add_", "index_add", "scatter_add_", "scatter_add",
                 "scatter_reduce_", "index_put_", "index_put"):
        monkeypatch.setattr(torch.Tensor, name, refuse(name))
    for name in ("index_add", "scatter_add", "scatter_reduce", "index_put",
                 "index_put_"):
        monkeypatch.setattr(torch, name, refuse(name))
    masks = []
    orig = torch.ops.aten.grid_sampler_2d_backward

    def spy(*args):
        masks.append(list(args[6]))
        return orig(*args)

    monkeypatch.setattr(torch.ops.aten, "grid_sampler_2d_backward", spy)
    case = _case(5, 2, 12, 12, 8, 8)
    got = _port(*case)
    assert masks == [[False, True]]
    _agree(got, _torch_ref(*case), fwd_exact=True)


@pytest.mark.cuda
def test_card_backward_is_deterministic(cuda):
    """On the card: two backward calls give the same bits, and agree with
    F.grid_sample's (atomic) backward within 1e-6 of the largest value,
    at the sun resample's shape (a 2048^2 render of 4 channels sampled
    on a 1024^2 grid)."""
    rng = np.random.RandomState(6)
    img = rng.normal(0, 1, (4, 2048, 2048)).astype(np.float32)
    v, u = np.meshgrid(np.linspace(-1, 1, 1024), np.linspace(-1, 1, 1024),
                       indexing="ij")
    grid = np.stack([0.5 * u + 0.1 * v, -0.1 * u + 0.5 * v],
                    -1).astype(np.float32)
    cot = rng.normal(0, 1, (4, 1024, 1024)).astype(np.float32)
    a = _port(img, grid, cot, device=cuda)
    b = _port(img, grid, cot, device=cuda)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    want = _torch_ref(img, grid, cot, device=cuda)
    _agree(a, want, fwd_exact=True)
