"""The yardstick of the ``mfu`` and ``*_roofline`` metrics: the operations
and bytes a step or a request needs, counted from its inputs and state by
the reference's own preprocessing (``reference.render.blend_work``), never
from the pairs the program emitted.

A blend must evaluate and composite every (pixel, Gaussian) whose alpha
reaches 1/255 before the pixel's transmittance stop (``composites``) and
read every pair that composites somewhere in its tile (``pairs_used``).
The per-evaluation costs are those the port's kernels were bounded with
(K1: the power quadratic, exp, clamps and tests, 17 FP32 operations an
evaluation, 14 a composite; K2: the recomputation, 17, and 58 a
contribution; 11 float32 payload fields, 44 bytes a pair). Everything else
of a step is counted from shapes, at its least: the preprocess per
Gaussian, the resamples, shading and losses per pixel, SSIM's five 11x11
depthwise convolutions of three channels, Adam per parameter; backward as
twice the forward. So a program that culls, fuses or drops work cannot
move the count.

Peaks of one NVIDIA H100 SXM (data sheet, dense): 67 TFLOP/s FP32 outside
the tensor cores, 3.35 TB/s HBM3.
"""

from __future__ import annotations

FP32_FLOPS = 67e12
HBM_BYTES = 3.35e12

K1_OPS_PER_EVAL, K1_OPS_PER_COMPOSITE = 17, 14
K2_OPS_PER_EVAL, K2_OPS_PER_CONTRIB, K2_OPS_PER_PIXEL = 17, 58, 10
BYTES_PER_PAIR = 44
OUT8_BYTES = 8 * 4  # per pixel: 5 channels, final T, n_contrib, pad

PREPROCESS_OPS = 120  # projection, cov2d, conic, radius, rect per Gaussian
SSIM_OPS_PER_PIXEL = 5 * 3 * 11 * 11 * 2
RESAMPLE_OPS_PER_PIXEL = 4 * 8 + 12
PIXEL_OPS = 60  # shading, shadow map, the L1 and consistency terms
ADAM_OPS = 12


def k1(work: dict) -> dict:
    c = work["composites"]
    return dict(ops=(K1_OPS_PER_EVAL + K1_OPS_PER_COMPOSITE) * c,
                bytes=BYTES_PER_PAIR * work["pairs_used"] + 8 * work["tiles"]
                + OUT8_BYTES * work["pixels"])


def k2(work: dict) -> dict:
    c = work["composites"]
    return dict(ops=(K2_OPS_PER_EVAL + K2_OPS_PER_CONTRIB) * c
                + K2_OPS_PER_PIXEL * work["pixels"],
                bytes=2 * BYTES_PER_PAIR * work["pairs_used"]
                + 2 * OUT8_BYTES * work["pixels"] + 8 * work["tiles"])


def bound_s(c: dict) -> float:
    """The least time of a kernel's count: operations or bytes at peak."""
    return max(c["ops"] / FP32_FLOPS, c["bytes"] / HBM_BYTES)


def train_step_ops(works, n_params: int, height: int, width: int) -> float:
    """A training step's operations: each render's blend forward (K1) and
    backward (K2) and preprocess (forward and twice for backward), the two
    resamples and the per-pixel terms at the main view, SSIM, Adam."""
    ops = 0.0
    for w in works:
        ops += k1(w)["ops"] + k2(w)["ops"] + 3 * PREPROCESS_OPS * w["gaussians"]
    hw = height * width
    ops += 3 * (2 * RESAMPLE_OPS_PER_PIXEL + PIXEL_OPS
                + SSIM_OPS_PER_PIXEL) * hw
    return ops + ADAM_OPS * n_params


def render_ops(works, height: int, width: int) -> float:
    """A view request's operations: each render's blend and preprocess,
    the resample and the shading at the main view."""
    ops = sum(k1(w)["ops"] + PREPROCESS_OPS * w["gaussians"] for w in works)
    return ops + (RESAMPLE_OPS_PER_PIXEL + PIXEL_OPS) * height * width


def kernel_share(ctx, count, needle):
    """A kernel's share of its roofline over a traced window, in percent:
    the least time of the window's counted work (``count`` is k1 or k2 of
    each render of each traced step or request) over the device time of
    the kernels whose name holds ``needle``; None when none ran."""
    t = ctx.trace.seconds(needle) if ctx.trace else 0.0
    steps = ctx.run.work.get("steps") if ctx.run.work else None
    if not t or not steps:
        return None
    least = sum(bound_s(count(w)) for s in steps for w in s)
    return 100.0 * least / t


def unit_s(ctx):
    """Host seconds a step or request in the timed (untraced) window."""
    run = ctx.run
    return run.window_s / run.done if run.done else None


def mfu(ctx):
    """The counted operations of a traced step or request over the timed
    window's time a unit (the profiler slows the traced window) times the
    FP32 peak of the cards used, in percent."""
    u = unit_s(ctx)
    if not ctx.trace or not ctx.run.work.get("ops") or not u:
        return None
    per_unit = ctx.run.work["ops"] / ctx.run.traced_units
    return 100.0 * per_unit / (u * FP32_FLOPS * ctx.chips)


def idle(ctx):
    """The device's idle share, in percent: 100 (1 - b / u), b the traced
    device busy time a unit (the union of its operations), u the timed
    window's host time a unit. Not clipped: a share under 0 says the
    traced units held more device work than the timed ones."""
    u = unit_s(ctx)
    if not ctx.trace or not ctx.run.traced_units or not u:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.run.traced_units / u)
