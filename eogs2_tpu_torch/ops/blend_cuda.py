"""K4: the tile-slot blend of the dense modes, as hand-written CUDA kernels.

Counterpart of ``eogs2_tpu/ops/blend_pallas.py``, the ``use_pallas``
route of the ``gather`` and ``sorted`` modes. The per-pair data of each
tile's K slots arrives packed as one [T, 16, K] float32 table (rows 0 mx,
1 my, 2-4 conic, 5 opacity, 6-10 features, 11 mask, 12-15 zero), as
ops/pair_pipeline.densify_pairs gathers it:

  * ``blend_forward`` launches ``csrc/blend_tiles_fwd.cu`` -> out [T, 256, 8]
    (channels 0-4 the colour before the background, 5 final_t, 6 n_contrib,
    the number of live slots, 7 zero);
  * ``blend_backward`` launches ``csrc/blend_tiles_bwd.cu``, one back-to-
    front pass from final_t and n_contrib -> gdata [T, 16, K];
  * ``BlendTilesPallas`` is the differentiable pair, with the contract of
    ``blend_tiles_pallas``.

Both wrappers take their plain PyTorch versions (``blend_forward_plain``,
``blend_backward_plain``, which follow blend_pallas.py's formulas) only for
CPU tensors; on the card they launch the kernel or raise.
"""

from __future__ import annotations

import ctypes

import torch

from eogs2_tpu_torch.ops.blend import ALPHA_EPS, ALPHA_MAX, T_EPS
from eogs2_tpu_torch.ops.projection import TILE

P = TILE * TILE  # pixels per tile
NF = 16  # packed rows (12 used)
NC = 5  # feature channels

_VP, _I = ctypes.c_void_p, ctypes.c_int


def slot_fields(data, grid_x, t0, t1, k_len):
    """Per slot and pixel of tiles [t0, t1), slots [0, k_len), as the
    kernels compute them: (alpha, G, dx, dy, keep), each [tc, k_len, P]. The
    slot axis is not the innermost one, so a cumsum over it runs
    sequentially per pixel on the card, in the kernels' order."""
    dev = data.device
    d = data[t0:t1, :, :k_len]
    ids = torch.arange(t0, t1, device=dev)
    lpix = torch.arange(P, device=dev)
    px = ((ids % grid_x) * TILE).to(torch.float32)[:, None] + \
        (lpix % TILE).to(torch.float32)
    py = ((ids // grid_x) * TILE).to(torch.float32)[:, None] + \
        (lpix // TILE).to(torch.float32)
    dx = d[:, 0, :, None] - px[:, None, :]
    dy = d[:, 1, :, None] - py[:, None, :]
    a, b, c = d[:, 2, :, None], d[:, 3, :, None], d[:, 4, :, None]
    power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
    G = torch.exp(torch.clamp_max(power, 0.0))
    alpha_raw = torch.clamp_max(d[:, 5, :, None] * G, ALPHA_MAX)
    keep = (d[:, 11, :, None] > 0.5) & (power <= 0.0) & (alpha_raw >= ALPHA_EPS)
    return torch.where(keep, alpha_raw, 0.0), G, dx, dy, keep


def slots_in_use(data):
    """[T] slots up to each tile's last pair (its mask row's last set
    slot): the empty slots after it change nothing, and the kernels skip
    them."""
    k = data.shape[2]
    pos = torch.arange(1, k + 1, device=data.device)
    return torch.where(data[:, 11] > 0.5, pos, 0).amax(dim=1) if k else \
        torch.zeros(data.shape[0], dtype=torch.int64, device=data.device)


def _chunks(data, chunk_elems):
    """(t0, t1, k_len) ranges of tiles of at most ~chunk_elems slot-pixel
    values, k_len the chunk's longest run of slots in use."""
    n_slots = slots_in_use(data).cpu()
    kmax = max(int(n_slots.max()), 1) if n_slots.numel() else 1
    tc = max(1, chunk_elems // (P * kmax))
    for t0 in range(0, data.shape[0], tc):
        t1 = min(t0 + tc, data.shape[0])
        yield t0, t1, int(n_slots[t0:t1].max())


def blend_forward_plain(data, grid_x: int, chunk_elems: int = 1 << 25):
    """Plain PyTorch version of K4 forward (the same [T, 256, 8] output).

    Per chunk of tiles: s = cumsum of log1p(-alpha) over the slots, cp =
    exp(s), live = cp >= 1e-4, w = alpha cp / (1 - alpha) where live;
    channel 5 is exp(s) at the last live slot (exp of the live slots' log
    sum), channel 6 the count of live slots. The slots after a chunk's last
    pair are empty: they change nothing, and a pixel live up to them is
    live at slot K."""
    n_tiles, _, k = data.shape
    out = torch.zeros((n_tiles, P, 8), dtype=torch.float32, device=data.device)
    out[..., 5] = 1.0
    out[..., 6] = float(k)
    for t0, t1, k_len in _chunks(data, chunk_elems):
        if k_len == 0:
            continue
        alpha, _, _, _, _ = slot_fields(data, grid_x, t0, t1, k_len)
        s = torch.cumsum(torch.log1p(-alpha), dim=1)
        cp = torch.exp(s)
        live = cp >= T_EPS
        w = torch.where(live, alpha * (cp / (1.0 - alpha)), 0.0)
        out[t0:t1, :, :NC] = torch.einsum("tkp,tck->tpc", w,
                                          data[t0:t1, 6:6 + NC, :k_len])
        out[t0:t1, :, 5] = torch.exp(torch.where(live, s, 0.0).amin(dim=1))
        n_live = live.sum(dim=1)
        out[t0:t1, :, 6] = torch.where(n_live == k_len, k, n_live).to(
            torch.float32)
    return out


def _after(x):
    """Sum over the slots strictly after each slot (dim 1), accumulated
    back to front as the backward kernel accumulates it."""
    rev = torch.cumsum(x.flip(1), dim=1).flip(1)
    return torch.cat([rev[:, 1:], torch.zeros_like(rev[:, :1])], dim=1)


def blend_backward_plain(data, gout, grid_x: int, chunk_elems: int = 1 << 24):
    """Plain PyTorch version of K4 backward (the same [T, 16, K] output).

    gout [T, 256, 8]: 0-4 dL/d(channel), 5 dL/dfinal_t (background term
    folded in), 6 final_t, 7 n_contrib. The live slots are those below
    n_contrib; per slot and pixel (blend_pallas.py:_bwd_kernel):

      s_after = sum of log1p(-alpha) over the live slots after the slot
      cp      = exp(log final_t - s_after),  T = cp / (1 - alpha),  w = alpha T
      suffix  = sum of w fdot over the slots after,  fdot = sum_c g_c f_c
      g_alpha = fdot T - (suffix + final_t g_ft) / (1 - alpha)  (kept, live)

    then g_op = sum g_alpha G, gG = g_alpha op G, g_mx = sum gG (-(a dx) -
    b dy), g_my = sum gG (-(c dy) - b dx), g_a = sum gG (-dx^2/2), g_b =
    sum gG (-dx dy), g_c = sum gG (-dy^2/2), g_f = sum w g, over the pixels."""
    gdata = torch.zeros_like(data)
    for t0, t1, k_len in _chunks(data, chunk_elems):
        if k_len == 0:
            continue  # no pair: no gradient
        alpha, G, dx, dy, keep = slot_fields(data, grid_x, t0, t1, k_len)
        go, d = gout[t0:t1], data[t0:t1, :, :k_len]
        kk = torch.arange(k_len, device=data.device, dtype=torch.float32)
        g_pix = go[..., :NC]  # [tc, P, 5]
        tail = (go[..., 6] * go[..., 5])[:, None, :]  # final_t g_ft
        log_ft = torch.log(go[..., 6])[:, None, :]
        livem = kk[None, :, None] < go[..., 7][:, None, :]
        one_minus = 1.0 - alpha
        s_after = _after(torch.where(livem, torch.log1p(-alpha), 0.0))
        t_before = torch.exp(log_ft - s_after) / one_minus
        w = torch.where(livem, alpha * t_before, 0.0)
        fdot = g_pix[:, None, :, 0] * d[:, 6, :, None]
        for c in range(1, NC):
            fdot = fdot + g_pix[:, None, :, c] * d[:, 6 + c, :, None]
        suffix = _after(w * fdot)
        g_alpha = fdot * t_before - (suffix + tail) / one_minus
        g_alpha = torch.where(livem & keep, g_alpha, 0.0)
        a, b, c = d[:, 2, :, None], d[:, 3, :, None], d[:, 4, :, None]
        gG = g_alpha * d[:, 5, :, None] * G
        g = gdata[t0:t1, :, :k_len]
        g[:, 0] = (gG * (-(a * dx) - b * dy)).sum(-1)
        g[:, 1] = (gG * (-(c * dy) - b * dx)).sum(-1)
        g[:, 2] = (gG * (-0.5 * dx * dx)).sum(-1)
        g[:, 3] = (gG * (-dx * dy)).sum(-1)
        g[:, 4] = (gG * (-0.5 * dy * dy)).sum(-1)
        g[:, 5] = (g_alpha * G).sum(-1)
        g[:, 6:6 + NC] = torch.einsum("tkp,tpc->tck", w, g_pix)
    return gdata


def _check(name, data, grid_x, gout=None):
    """Validate inputs; True when they lie on the card (launch the kernel),
    False on the CPU (take the plain version)."""
    if data.dim() != 3 or data.shape[1] != NF or data.dtype != torch.float32:
        raise ValueError(f"{name}: data must be float32 [T, {NF}, K], got "
                         f"{data.dtype} {tuple(data.shape)}")
    n_tiles = data.shape[0]
    if grid_x < 1 or n_tiles % grid_x:
        raise ValueError(f"{n_tiles} tiles do not fill rows of "
                         f"grid_x={grid_x}")
    if gout is not None and (gout.dtype != torch.float32
                             or gout.shape != (n_tiles, P, 8)):
        raise ValueError(f"{name}: gout must be float32 [{n_tiles}, {P}, 8],"
                         f" got {gout.dtype} {tuple(gout.shape)}")
    if data.device.type == "cpu":
        return False
    if data.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {data.device}")
    for arg, x in (("data", data), ("gout", gout)):
        if x is not None and (x.device != data.device
                              or not x.is_contiguous()):
            raise ValueError(f"{name}: {arg} must be contiguous on "
                             f"{data.device}")
    return True


def blend_forward(data, grid_x: int):
    """K4 forward: data [T, 16, K] -> out [T, 256, 8] float32.

    CPU tensors go to :func:`blend_forward_plain`; CUDA tensors launch the
    hand-written kernel (csrc/blend_tiles_fwd.cu, built at first use) or
    raise."""
    if not _check("blend_forward", data, grid_x):
        return blend_forward_plain(data, grid_x)
    from eogs2_tpu_torch.ops import cuda_build

    fn = cuda_build.entry("blend_tiles_fwd", "eogs2_blend_tiles_fwd",
                          [_VP, _I, _I, _I, _VP, _VP])
    n_tiles, _, k = data.shape
    out = torch.empty((n_tiles, P, 8), dtype=torch.float32, device=data.device)
    with torch.cuda.device(data.device):
        err = fn(data.data_ptr(), n_tiles, k, grid_x, out.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
    cuda_build.check_launch(err, "blend_forward")
    blend_forward.launches += 1
    return out


blend_forward.launches = 0  # kernel launches on the card


def blend_backward(data, gout, grid_x: int):
    """K4 backward: data [T, 16, K], gout [T, 256, 8] -> gdata [T, 16, K]
    float32 (rows 11-15 zero).

    CPU tensors go to :func:`blend_backward_plain`; CUDA tensors launch the
    hand-written kernel (csrc/blend_tiles_bwd.cu, built at first use) or
    raise."""
    if not _check("blend_backward", data, grid_x, gout):
        return blend_backward_plain(data, gout, grid_x)
    from eogs2_tpu_torch.ops import cuda_build

    fn = cuda_build.entry("blend_tiles_bwd", "eogs2_blend_tiles_bwd",
                          [_VP, _VP, _I, _I, _I, _VP, _VP])
    n_tiles, _, k = data.shape
    gdata = torch.empty_like(data)
    with torch.cuda.device(data.device):
        err = fn(data.data_ptr(), gout.data_ptr(), n_tiles, k, grid_x,
                 gdata.data_ptr(), torch.cuda.current_stream().cuda_stream)
    cuda_build.check_launch(err, "blend_backward")
    blend_backward.launches += 1
    return gdata


blend_backward.launches = 0  # kernel launches on the card


def backward_gout(g_img, g_ft, bg, final_t, n_contrib):
    """K4 backward's per-pixel input [T, P, 8] from the cotangents of
    (img, final_t): channels 0-4 g_img, 5 g_ft + g_img . bg (the background
    term), 6 final_t, 7 n_contrib (blend_pallas.py:_bwd)."""
    g_ft_total = g_ft + torch.einsum("tpc,c->tp", g_img, bg)
    return torch.cat([g_img, g_ft_total[..., None], final_t[..., None],
                      n_contrib[..., None]], dim=-1).contiguous()


class BlendTilesPallas(torch.autograd.Function):
    """data [T, 16, K] packed, bg [5] -> (img [T, P, 5] with the background
    composited, final_t [T, P]); the contract of blend_tiles_pallas. The
    forward is K4 forward, the backward K4 backward; it also returns the
    background's gradient."""

    @staticmethod
    def forward(ctx, data, bg, grid_x):
        out = blend_forward(data, grid_x)
        final_t = out[:, :, 5]
        ctx.save_for_backward(data, bg, final_t, out[:, :, 6])
        ctx.grid_x = grid_x
        return out[:, :, :NC] + final_t[..., None] * bg, final_t

    @staticmethod
    def backward(ctx, g_img, g_ft):
        data, bg, final_t, n_contrib = ctx.saved_tensors
        gout = backward_gout(g_img, g_ft, bg, final_t, n_contrib)
        gdata = blend_backward(data, gout, ctx.grid_x)
        g_bg = torch.einsum("tp,tpc->c", final_t, g_img)
        return gdata, g_bg, None
