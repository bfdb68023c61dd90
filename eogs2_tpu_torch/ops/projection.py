"""Per-Gaussian preprocessing for the affine (pushbroom) camera.

Counterpart of ``eogs2_tpu/ops/projection.py``; parity target
``preprocessCUDA`` (forward.cu:155-283) and ``computeCov2D`` (:74-112):

  * projection is the plain affine map uva = A @ [xyz, 1] (no perspective
    divide); u, v are NDC, the third output is the normalized altitude;
  * cov2d = J Sigma J^T with the constant Jacobian J = diag(W/2, H/2) A[:2,:3],
    then +0.3 px dilation and the optional antialiasing opacity rescale;
  * radius = ceil(3 sqrt(lambda_max)); getRect truncates toward zero, then
    clamps to the grid (``Tensor.to(torch.int32)`` truncates like C's int());
  * the composite order is altitude-descending: depth = -altitude, which
    takes both signs (ops/fused_raster.py keys the sort order-preservingly).

On the CPU this is plain tensor code and autograd supplies the gradients
(incl. dL/d(affine)). On the card ``preprocess_cuda`` runs the whole front
half of a render as one forward kernel and one backward kernel
(``csrc/preprocess.cu``): the same outputs (conic, opacity and radius bit
for bit; mean2d and depth to an ulp or two, since the plain projection goes
through a matrix product) and the closed-form gradients of
``preprocess_backward_plain``, the kernel's plain twin.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from eogs2_tpu_torch.observability import host_read, span, tracer

TILE = 16  # BLOCK_X = BLOCK_Y = 16 (cuda_rasterizer/config.h:16-17)


class Preprocessed(NamedTuple):
    """Per-Gaussian screen-space quantities (all [N] or [N, k])."""

    mean2d: torch.Tensor  # [N,2] pixel coordinates of the projected center
    depth: torch.Tensor  # [N] sort key = -altitude (ascending == top first)
    conic: torch.Tensor  # [N,3] inverse 2D covariance (a, b, c)
    opacity: torch.Tensor  # [N] opacity (after optional antialias rescale)
    radius: torch.Tensor  # [N] int32 screen-space radius, 0 == culled
    rect_min: torch.Tensor  # [N,2] int32 tile rect (x,y) inclusive
    rect_size: torch.Tensor  # [N,2] int32 tile rect extent (w,h)
    tiles_touched: torch.Tensor  # [N] int32 number of tiles overlapped


def ndc_to_pixel(ndc, size):
    """((v + 1) * S - 1) / 2 — reference ndc2Pix (auxiliary.h:40-43)."""
    return ((ndc + 1.0) * size - 1.0) * 0.5


def project_points(means3d, affine):
    """uva = A @ [x,y,z,1]. affine: [3,4] row-major (math orientation)."""
    return means3d @ affine[:, :3].T + affine[:, 3]


def compute_cov2d_direct(scales, quats, affine, width, height,
                         scale_modifier: float = 1.0):
    """(scale, raw quat) -> (cxx, cxy, cyy) without [N,3,3] intermediates.

    Same math as build_cov3d + compute_cov2d: cov2d = (J R) diag(s^2) (J R)^T
    with the unnormalized-quaternion rotation, written as [N] columns."""
    px = host_read(lambda: torch.tensor([0.5 * width, 0.5 * height],
                                        dtype=scales.dtype,
                                        device=scales.device),
                   "projection.px")
    J = px[:, None] * affine[:2, :3]  # [2,3] constant Jacobian
    r, x, y, z = quats[:, 0], quats[:, 1], quats[:, 2], quats[:, 3]
    R00 = 1.0 - 2.0 * (y * y + z * z)
    R01 = 2.0 * (x * y - r * z)
    R02 = 2.0 * (x * z + r * y)
    R10 = 2.0 * (x * y + r * z)
    R11 = 1.0 - 2.0 * (x * x + z * z)
    R12 = 2.0 * (y * z - r * x)
    R20 = 2.0 * (x * z - r * y)
    R21 = 2.0 * (y * z + r * x)
    R22 = 1.0 - 2.0 * (x * x + y * y)
    # A = J @ R: rows a (screen x) and b (screen y)
    a0 = J[0, 0] * R00 + J[0, 1] * R10 + J[0, 2] * R20
    a1 = J[0, 0] * R01 + J[0, 1] * R11 + J[0, 2] * R21
    a2 = J[0, 0] * R02 + J[0, 1] * R12 + J[0, 2] * R22
    b0 = J[1, 0] * R00 + J[1, 1] * R10 + J[1, 2] * R20
    b1 = J[1, 0] * R01 + J[1, 1] * R11 + J[1, 2] * R21
    b2 = J[1, 0] * R02 + J[1, 1] * R12 + J[1, 2] * R22
    s0 = scale_modifier * scales[:, 0]
    s1 = scale_modifier * scales[:, 1]
    s2 = scale_modifier * scales[:, 2]
    s0, s1, s2 = s0 * s0, s1 * s1, s2 * s2
    cxx = a0 * a0 * s0 + a1 * a1 * s1 + a2 * a2 * s2
    cxy = a0 * b0 * s0 + a1 * b1 * s1 + a2 * b2 * s2
    cyy = b0 * b0 * s0 + b1 * b1 * s1 + b2 * b2 * s2
    return torch.stack([cxx, cxy, cyy], dim=-1)


def compute_cov2d(cov3d6, affine, width, height):
    """2D screen covariance before dilation, J Sigma J^T, as (cxx, cxy, cyy)."""
    from eogs2_tpu_torch.ops.gaussians import cov3d_to_matrix

    scale = torch.tensor([0.5 * width, 0.5 * height], dtype=cov3d6.dtype,
                         device=cov3d6.device)
    J = scale[:, None] * affine[:2, :3]  # [2,3]
    cov = torch.einsum("ij,...jk,lk->...il", J, cov3d_to_matrix(cov3d6), J)
    return torch.stack([cov[..., 0, 0], cov[..., 0, 1], cov[..., 1, 1]], dim=-1)


def preprocess_gaussians(
    means3d,
    cov3d6,
    opacities,
    affine,
    width: int,
    height: int,
    antialiasing: bool = False,
    alive=None,
    cov2d=None,
) -> Preprocessed:
    """FORWARD::preprocess for one camera, vectorized over Gaussians.

    cov3d6 is ignored when the [N,3] screen covariance ``cov2d`` is given
    (the compute_cov2d_direct path); ``alive`` culls dead slots."""
    uva = project_points(means3d, affine)  # [N,3]
    px = ndc_to_pixel(uva[:, 0], width)
    py = ndc_to_pixel(uva[:, 1], height)
    mean2d = torch.stack([px, py], dim=-1)
    depth = -uva[:, 2]  # altitude-descending composite order

    cov = cov2d if cov2d is not None else compute_cov2d(
        cov3d6, affine, width, height
    )
    h_var = 0.3
    det_cov = cov[:, 0] * cov[:, 2] - cov[:, 1] * cov[:, 1]
    cxx = cov[:, 0] + h_var
    cxy = cov[:, 1]
    cyy = cov[:, 2] + h_var
    det = cxx * cyy - cxy * cxy

    if antialiasing:
        h_conv_scaling = torch.sqrt(torch.clamp_min(det_cov / det, 0.000025))
    else:
        h_conv_scaling = 1.0

    valid_det = det > 0.0
    det_safe = torch.where(valid_det, det, 1.0)
    det_inv = 1.0 / det_safe
    conic = torch.stack([cyy * det_inv, -cxy * det_inv, cxx * det_inv], dim=-1)

    mid = 0.5 * (cxx + cyy)
    disc = torch.sqrt(torch.clamp_min(mid * mid - det_safe, 0.1))
    lambda_max = mid + disc
    radius_f = torch.ceil(3.0 * torch.sqrt(torch.clamp_min(lambda_max, 0.0)))

    grid_x = (width + TILE - 1) // TILE
    grid_y = (height + TILE - 1) // TILE

    def rect(v):  # getRect (auxiliary.h:45-55): truncate, then clamp
        return v.to(torch.int32)

    rmin_x = rect((px - radius_f) / TILE).clamp(0, grid_x)
    rmin_y = rect((py - radius_f) / TILE).clamp(0, grid_y)
    rmax_x = rect((px + radius_f + TILE - 1) / TILE).clamp(0, grid_x)
    rmax_y = rect((py + radius_f + TILE - 1) / TILE).clamp(0, grid_y)
    rect_w = rmax_x - rmin_x
    rect_h = rmax_y - rmin_y

    visible = valid_det & (rect_w > 0) & (rect_h > 0)
    if alive is not None:
        visible = visible & alive
    radius = torch.where(visible, radius_f, 0.0).to(torch.int32)
    rect_w = torch.where(visible, rect_w, 0)
    rect_h = torch.where(visible, rect_h, 0)

    return Preprocessed(
        mean2d=mean2d,
        depth=depth,
        conic=conic,
        opacity=opacities * h_conv_scaling,
        radius=radius,
        rect_min=torch.stack([rmin_x, rmin_y], dim=-1),
        rect_size=torch.stack([rect_w, rect_h], dim=-1),
        tiles_touched=rect_w * rect_h,
    )


def _rotation(quats):
    """[N, 3, 3] rotation of the unnormalised quaternions (w, x, y, z), as
    compute_cov2d_direct builds it."""
    r, x, y, z = quats.unbind(-1)
    return torch.stack([
        1.0 - 2.0 * (y * y + z * z), 2.0 * (x * y - r * z),
        2.0 * (x * z + r * y),
        2.0 * (x * y + r * z), 1.0 - 2.0 * (x * x + z * z),
        2.0 * (y * z - r * x),
        2.0 * (x * z - r * y), 2.0 * (y * z + r * x),
        1.0 - 2.0 * (x * x + y * y),
    ], dim=-1).reshape(-1, 3, 3)


def preprocess_backward_plain(means3d, scales, quats, opacities, affine,
                              width: int, height: int, grads,
                              antialiasing: bool = False):
    """Closed-form gradients of the preprocess (compute_cov2d_direct, then
    preprocess_gaussians, then mean2d + offset * (W/2, H/2)): the plain
    twin of the backward kernel of csrc/preprocess.cu, which the tests hold
    against autograd and JAX. No path runs it.

    grads: the cotangents of (mean2d [N, 2], depth [N], conic [N, 3],
    opacity [N]), None for zero. Returns the gradients of (means3d, scales,
    quats, opacities, affine [3, 4], the NDC offset [N, 2]). Autograd's
    rules: none through det where det <= 0 (det_safe is the constant 1
    there), none through clamp_min below its bound."""
    n = means3d.shape[0]
    g_m2d, g_depth, g_conic, g_op = (
        means3d.new_zeros(shape) if g is None else g
        for g, shape in zip(grads, ((n, 2), (n,), (n, 3), (n,))))
    hw, hh = 0.5 * width, 0.5 * height
    # mean2d = ((uva + 1) S - 1) / 2 + offset S / 2, depth = -uva[2]
    g_uva = torch.stack([g_m2d[:, 0] * hw, g_m2d[:, 1] * hh, -g_depth], -1)

    J = torch.stack([hw * affine[0, :3], hh * affine[1, :3]])  # [2, 3]
    R = _rotation(quats)
    # rows a and b of J R and the covariance (c0, c1, c2) in
    # compute_cov2d_direct's order of operations, so that the clamp and the
    # det tests below see the forward's bits (a matrix product or a sum
    # over a dim may round otherwise)
    a, b = (J[i, 0] * R[:, 0] + J[i, 1] * R[:, 1] + J[i, 2] * R[:, 2]
            for i in (0, 1))
    s = scales * scales

    def sum3(t):
        return t[:, 0] + t[:, 1] + t[:, 2]

    c0, c1, c2 = sum3(a * a * s), sum3(a * b * s), sum3(b * b * s)
    xx, xy, yy = c0 + 0.3, c1, c2 + 0.3
    det = xx * yy - xy * xy
    valid = det > 0.0
    det_inv = 1.0 / torch.where(valid, det, 1.0)
    # conic = (yy, -xy, xx) / det_safe
    gca, gcb, gcc = g_conic.unbind(-1)
    g_xx, g_yy, g_xy = gcc * det_inv, gca * det_inv, -(gcb * det_inv)
    g_inv = gca * yy - gcb * xy + gcc * xx
    g_det = torch.where(valid, -g_inv * det_inv * det_inv, 0.0)
    if antialiasing:  # opacity * sqrt(clamp_min(det_cov / det, 0.000025))
        ratio = (c0 * c2 - c1 * c1) / det
        h = torch.sqrt(torch.clamp_min(ratio, 0.000025))
        g_opac = g_op * h
        g_ratio = torch.where(ratio >= 0.000025,
                              g_op * opacities / (2.0 * h), 0.0)
        g_dc = g_ratio / det
        g_det = g_det - g_ratio * ratio / det
    else:
        g_opac, g_dc = g_op, 0.0
    # det = xx yy - xy^2, det_cov = c0 c2 - c1^2
    g0 = g_xx + g_det * yy + g_dc * c2
    g2 = g_yy + g_det * xx + g_dc * c0
    g1 = g_xy - 2.0 * g_det * xy - 2.0 * g_dc * c1
    # c0 = sum a^2 s, c1 = sum a b s, c2 = sum b^2 s
    g0, g1, g2 = g0[:, None], g1[:, None], g2[:, None]
    g_ab = torch.stack([2.0 * g0 * a * s + g1 * b * s,
                        g1 * a * s + 2.0 * g2 * b * s], 1)  # [N, 2, 3]
    g_s = g0 * a * a + g1 * a * b + g2 * b * b
    g_scales = 2.0 * g_s * scales
    gR = J.T @ g_ab  # [N, 3, 3]
    gJ = (g_ab @ R.transpose(1, 2)).sum(0)  # [2, 3]
    r, x, y, z = quats.unbind(-1)
    g = gR.reshape(-1, 9).unbind(-1)  # g[3 m + k] = dL/dR[m][k]
    g_quats = 2.0 * torch.stack([
        -z * g[1] + y * g[2] + z * g[3] - x * g[5] - y * g[6] + x * g[7],
        y * g[1] + z * g[2] + y * g[3] - 2.0 * x * g[4] - r * g[5]
        + z * g[6] + r * g[7] - 2.0 * x * g[8],
        -2.0 * y * g[0] + x * g[1] + r * g[2] + x * g[3] + z * g[5]
        - r * g[6] + z * g[7] - 2.0 * y * g[8],
        -2.0 * z * g[0] - r * g[1] + x * g[2] + r * g[3] - 2.0 * z * g[4]
        + y * g[5] + x * g[6] + y * g[7],
    ], -1)
    g_affine = torch.cat([g_uva.T @ means3d, g_uva.sum(0)[:, None]], 1)
    g_affine[:2, :3] += torch.stack([hw * gJ[0], hh * gJ[1]])
    return (g_uva @ affine[:, :3], g_scales, g_quats, g_opac, g_affine,
            g_uva[:, :2])


_VP, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_NB = 256  # threads per block of csrc/preprocess.cu


def _check(name, arg, x, shape, dtype, dev):
    if x.dtype != dtype or tuple(x.shape) != shape:
        raise ValueError(f"{name}: {arg} must be {dtype} {list(shape)}, got "
                         f"{x.dtype} {list(x.shape)}")
    if x.device != dev or not x.is_contiguous():
        raise ValueError(f"{name}: {arg} must be contiguous on {dev}")


def _ptr(x):
    return None if x is None else x.data_ptr()


def _count(means3d):
    """N of means3d [N, 3] (-1 for a scalar, which the checks refuse)."""
    return means3d.shape[0] if means3d.dim() else -1


def _check_gaussians(name, means3d, scales, quats, opacities, affine,
                     **more):
    """Raise unless every input is a contiguous float32 tensor of its shape
    on one CUDA device (``more``: name -> (tensor or None, shape, dtype));
    returns N."""
    dev = means3d.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: {dev} is not a CUDA device")
    n = _count(means3d)
    f32 = torch.float32
    for arg, (x, shape, dtype) in dict(
            means3d=(means3d, (n, 3), f32), scales=(scales, (n, 3), f32),
            quats=(quats, (n, 4), f32), opacities=(opacities, (n,), f32),
            affine=(affine, (3, 4), f32), **more).items():
        if x is not None:
            _check(name, arg, x, shape, dtype, dev)
    return n


def preprocess_fwd(means3d, scales, quats, opacities, affine, width: int,
                   height: int, antialiasing: bool = False, alive=None,
                   offset=None) -> Preprocessed:
    """The forward kernel (csrc/preprocess.cu) on the card: every field of
    Preprocessed, mean2d moved by the NDC ``offset`` [N, 2] times
    (W/2, H/2) when given, ``alive`` [N] bool culling. Raises unless the
    inputs are contiguous float32 tensors on one CUDA device."""
    n = _count(means3d)
    _check_gaussians("preprocess_fwd", means3d, scales, quats, opacities,
                     affine, alive=(alive, (n,), torch.bool),
                     offset=(offset, (n, 2), torch.float32))
    from eogs2_tpu_torch.ops import cuda_build

    fn = cuda_build.entry("preprocess", "eogs2_preprocess_fwd",
                          [_VP] * 7 + [_LL, _I, _I, _I] + [_VP] * 9)
    dev = means3d.device
    f, i = torch.float32, torch.int32
    prep = Preprocessed(*(torch.empty(shape, dtype=t, device=dev)
                          for shape, t in (((n, 2), f), ((n,), f),
                                           ((n, 3), f), ((n,), f),
                                           ((n,), i), ((n, 2), i),
                                           ((n, 2), i), ((n,), i))))
    ins = (means3d, scales, quats, opacities, affine, alive, offset)
    with torch.cuda.device(dev):
        err = fn(*(_ptr(x) for x in ins), n,
                 int(width), int(height), int(bool(antialiasing)),
                 *(x.data_ptr() for x in prep),
                 torch.cuda.current_stream().cuda_stream)
    cuda_build.check_launch(err, "preprocess_fwd")
    preprocess_fwd.launches += 1
    tracer.count("raster.preprocess.cuda")
    return prep


preprocess_fwd.launches = 0  # kernel launches on the card


def preprocess_bwd(means3d, scales, quats, opacities, affine, width: int,
                   height: int, grads, antialiasing: bool = False,
                   offset_grad: bool = False, affine_grad: bool = False):
    """The backward kernel (csrc/preprocess.cu) on the card: the gradients
    of (means3d, scales, quats, opacities, affine, offset) from the
    cotangents ``grads`` of (mean2d, depth, conic, opacity), each None for
    zero; the affine's [3, 4] (summed without atomics, the same bits every
    call) only with ``affine_grad`` and the offset's [N, 2] only with
    ``offset_grad``, else None. As preprocess_backward_plain computes."""
    n = _count(means3d)
    g_mean2d, g_depth, g_conic, g_opacity = grads
    f32 = torch.float32
    _check_gaussians("preprocess_bwd", means3d, scales, quats, opacities,
                     affine, g_mean2d=(g_mean2d, (n, 2), f32),
                     g_depth=(g_depth, (n,), f32),
                     g_conic=(g_conic, (n, 3), f32),
                     g_opacity=(g_opacity, (n,), f32))
    from eogs2_tpu_torch.ops import cuda_build

    fn = cuda_build.entry("preprocess", "eogs2_preprocess_bwd",
                          [_VP] * 5 + [_LL, _I, _I, _I] + [_VP] * 12)
    dev = means3d.device
    outs = [torch.empty_like(x) for x in (means3d, scales, quats, opacities)]
    g_affine = g_offset = partial = None
    if affine_grad:
        g_affine = torch.empty((3, 4), dtype=f32, device=dev)
        partial = torch.empty((max(1, (n + _NB - 1) // _NB), 12), dtype=f32,
                              device=dev)
    if offset_grad:
        g_offset = torch.empty((n, 2), dtype=f32, device=dev)
    with torch.cuda.device(dev):
        err = fn(*(x.data_ptr() for x in (means3d, scales, quats, opacities,
                                          affine)),
                 n, int(width), int(height), int(bool(antialiasing)),
                 *(_ptr(g) for g in grads), *(x.data_ptr() for x in outs),
                 _ptr(g_offset), _ptr(partial), _ptr(g_affine),
                 torch.cuda.current_stream().cuda_stream)
    cuda_build.check_launch(err, "preprocess_bwd")
    preprocess_bwd.launches += 1
    return (*outs, g_affine, g_offset)


preprocess_bwd.launches = 0  # kernel launches on the card


class _Preprocess(torch.autograd.Function):
    """preprocess_fwd with preprocess_bwd as its backward; the integer
    fields carry no gradient."""

    @staticmethod
    def forward(ctx, means3d, scales, quats, opacities, affine, offset, alive,
                width, height, antialiasing):
        prep = preprocess_fwd(means3d, scales, quats, opacities, affine,
                              width, height, antialiasing, alive, offset)
        ctx.save_for_backward(means3d, scales, quats, opacities, affine)
        ctx.camera = (width, height, antialiasing)
        ctx.mark_non_differentiable(*prep[4:])
        ctx.set_materialize_grads(False)
        return tuple(prep)

    @staticmethod
    @span("raster.preprocess.bwd")
    def backward(ctx, g_mean2d, g_depth, g_conic, g_opacity, *_):
        width, height, antialiasing = ctx.camera
        need = ctx.needs_input_grad
        grads = tuple(None if g is None else g.contiguous()
                      for g in (g_mean2d, g_depth, g_conic, g_opacity))
        g = preprocess_bwd(*ctx.saved_tensors, width, height, grads,
                           antialiasing=antialiasing, offset_grad=need[5],
                           affine_grad=need[4])
        return (*g, None, None, None, None)


def preprocess_cuda(means3d, scales, quats, opacities, affine, width: int,
                    height: int, antialiasing: bool = False, alive=None,
                    mean2d_ndc_offset=None) -> Preprocessed:
    """The preprocess of one camera on the card, differentiable in means3d,
    scales, quats, opacities, affine and the NDC offset [N, 2] of mean2d:
    one forward launch, one backward launch (two with the affine's
    gradient). Raises for a tensor off the card."""
    def c(x):
        return None if x is None else x.contiguous()

    return Preprocessed(*_Preprocess.apply(
        c(means3d), c(scales), c(quats), c(opacities), c(affine),
        c(mean2d_ndc_offset), c(alive), int(width), int(height),
        bool(antialiasing)))
