"""The reference render: affine cameras, preprocess, tile pairs and the
front-to-back blend of the 3DGS rasterizer (forward.cu/backward.cu), in
plain PyTorch, in blocks of tiles so that a 2048^2 render of a million
Gaussians fits.

Rules kept from the original rasterizer: the projection uva = A [x, 1]
with pixel = ((ndc + 1) S - 1) / 2; cov2d = J R diag(s^2) R^T J^T of the
raw (unnormalised) quaternion with J = diag(W/2, H/2) A[:2, :3], dilated by
0.3; radius ceil(3 sqrt(lambda_max)); a Gaussian reaches only the tiles of
its rect; alpha = min(0.99, op exp(power)), a pair is skipped where power
> 0 or alpha < 1/255, and a pixel stops before the pair that would take its
transmittance below 1e-4; the composite order is depth = -altitude
ascending, ties by index. A pair list holds, per tile, the Gaussians whose
alpha can reach 1/255 somewhere in the tile (the bounding box of that
ellipse), which drops nothing the blend would keep.

The blend is an autograd Function: the forward runs block by block without
a graph, the backward recomputes each block with one and takes its
gradient, so the memory is one block's.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

TILE = 16
PIX = TILE * TILE
ALPHA_EPS = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4
BLOCK_ELEMS = 1 << 25  # pair-pixel evaluations per block


def tf32(x):
    """x rounded to TF32 (10 mantissa bits, round to nearest even); the
    gradient passes through the rounding."""
    b = x.detach().contiguous().view(torch.int32)
    b = (b + 0xFFF + ((b >> 13) & 1)) & ~0x1FFF
    return x + (b.view(torch.float32) - x).detach()


def mm(a, b, precision):
    """a @ b in float32, or with TF32 inputs."""
    if precision == "tf32":
        a, b = tf32(a), tf32(b)
    return a @ b


def einsum(eq, a, b, precision):
    if precision == "tf32":
        a, b = tf32(a), tf32(b)
    return torch.einsum(eq, a, b)


class Camera(NamedTuple):
    affine: torch.Tensor  # [3,4] float32
    sun_affine: torch.Tensor  # [3,4]
    cam2sun: torch.Tensor  # [3,3]
    alt_min: float
    width: int
    height: int


def camera(md: dict, device) -> Camera:
    """A camera of affine_models.json (float32 on ``device``)."""
    def t(rows):
        return torch.tensor(rows, dtype=torch.float32, device=device)

    m, s = md["model"], md["sun_model"]
    aff = [r + [b] for r, b in zip(m["coef_"], m["intercept_"])]
    saff = [r + [b] for r, b in zip(s["coef_"], s["intercept_"])]
    return Camera(t(aff), t(saff), t(s["camera_to_sun"]),
                  float(md["min_alt"]), int(md["width"]), int(md["height"]))


def resize_canvas(cam: Camera, w: int, h: int) -> torch.Tensor:
    """The affine that renders the native pixels at a (w, h) canvas."""
    sx, sy = cam.width / w, cam.height / h
    a = cam.affine * torch.tensor([sx, sy, 1.0], device=cam.affine.device)[:, None]
    shift = torch.tensor([sx - 1.0, sy - 1.0, 0.0], device=a.device)
    return torch.cat([a[:, :3], (a[:, 3] + shift)[:, None]], 1)


def sun_camera(cam: Camera, f: int = 2):
    """The sun's view at f times the footprint, and the UVA map into it."""
    s = torch.tensor([1.0 / f, 1.0 / f, 1.0], device=cam.affine.device)
    return (cam._replace(affine=cam.sun_affine * s[:, None],
                         width=cam.width * f, height=cam.height * f),
            s[:, None] * cam.cam2sun)


def random_camera(cam: Camera, shear_draw, extent: float):
    """The UV-sheared virtual camera (scene centre at the origin)."""
    A, b = cam.affine[:, :3], cam.affine[:, 3]
    M = torch.eye(3, device=A.device)
    M[:2, 2] = M[:2, 2] + torch.clamp(shear_draw, -1.0, 1.0) * extent
    return cam._replace(affine=torch.cat([M @ A, b[:, None]], 1)), M


def uva(xyz, affine, precision):
    return mm(xyz, affine[:, :3].T, precision) + affine[:, 3]


class Prep(NamedTuple):
    mean2d: torch.Tensor  # [N,2] pixels
    conic: torch.Tensor  # [N,3]
    opacity: torch.Tensor  # [N]
    depth: torch.Tensor  # [N]
    cov: torch.Tensor  # [N,3] dilated screen covariance
    rect: torch.Tensor  # [N,4] int64 tile rect x0, y0, x1, y1 (exclusive)
    visible: torch.Tensor  # [N] bool


def preprocess(xyz, scales, quats, opacity, affine, w, h, precision,
               alive=None) -> Prep:
    p = uva(xyz, affine, precision)
    mean2d = torch.stack([((p[:, 0] + 1.0) * w - 1.0) * 0.5,
                          ((p[:, 1] + 1.0) * h - 1.0) * 0.5], -1)
    r, x, y, z = quats.unbind(-1)
    R = torch.stack([
        1.0 - 2.0 * (y * y + z * z), 2.0 * (x * y - r * z), 2.0 * (x * z + r * y),
        2.0 * (x * y + r * z), 1.0 - 2.0 * (x * x + z * z), 2.0 * (y * z - r * x),
        2.0 * (x * z - r * y), 2.0 * (y * z + r * x), 1.0 - 2.0 * (x * x + y * y),
    ], -1).reshape(-1, 3, 3)
    J = torch.tensor([0.5 * w, 0.5 * h], device=xyz.device)[:, None] * affine[:2, :3]
    M = einsum("ij,njk->nik", J, R, precision) * scales[:, None, :]  # [N,2,3]
    cov = einsum("nik,njk->nij", M, M, precision)
    cxx, cxy, cyy = cov[:, 0, 0] + 0.3, cov[:, 0, 1], cov[:, 1, 1] + 0.3
    det = cxx * cyy - cxy * cxy
    ok = det > 0.0
    det_s = torch.where(ok, det, 1.0)
    conic = torch.stack([cyy / det_s, -cxy / det_s, cxx / det_s], -1)
    mid = 0.5 * (cxx + cyy)
    lam = mid + torch.sqrt(torch.clamp_min(mid * mid - det_s, 0.1))
    radius = torch.ceil(3.0 * torch.sqrt(torch.clamp_min(lam, 0.0)))
    gx, gy = -(-w // TILE), -(-h // TILE)
    px, py = mean2d[:, 0].detach(), mean2d[:, 1].detach()
    rd = radius.detach()
    rect = torch.stack([
        ((px - rd) / TILE).to(torch.int32).clamp(0, gx),
        ((py - rd) / TILE).to(torch.int32).clamp(0, gy),
        ((px + rd + TILE - 1) / TILE).to(torch.int32).clamp(0, gx),
        ((py + rd + TILE - 1) / TILE).to(torch.int32).clamp(0, gy)],
        -1).long()
    visible = ok & (rect[:, 2] > rect[:, 0]) & (rect[:, 3] > rect[:, 1])
    if alive is not None:
        visible = visible & alive
    return Prep(mean2d, conic, opacity, -p[:, 2],
                torch.stack([cxx, cxy, cyy], -1), rect, visible)


class Plan(NamedTuple):
    """The pairs of a render sorted by (tile, depth), and blocks of tiles."""

    gauss: torch.Tensor  # [P] Gaussian of each sorted pair
    start: torch.Tensor  # [T] first pair of each tile
    count: torch.Tensor  # [T] pairs of each tile
    blocks: list  # (tile ids [b], K) per block
    grid_x: int
    n_tiles: int


@torch.no_grad()
def plan(prep: Prep, w: int, h: int, block_elems: int = BLOCK_ELEMS) -> Plan:
    """Every (tile, Gaussian) pair where the Gaussian's alpha can reach
    1/255 inside the tile and the tile lies in its rect."""
    dev = prep.mean2d.device
    gx, gy = -(-w // TILE), -(-h // TILE)
    op = prep.opacity.detach()
    t = torch.log(torch.clamp_min(op * 255.0, 1e-30)) + 1e-3
    cov = prep.cov.detach()
    hx = torch.sqrt(2.0 * t.clamp_min(0) * cov[:, 0]) + 0.01
    hy = torch.sqrt(2.0 * t.clamp_min(0) * cov[:, 2]) + 0.01
    px, py = prep.mean2d[:, 0].detach(), prep.mean2d[:, 1].detach()
    x0 = torch.maximum(torch.floor((px - hx) / TILE).long(), prep.rect[:, 0])
    y0 = torch.maximum(torch.floor((py - hy) / TILE).long(), prep.rect[:, 1])
    x1 = torch.minimum(torch.floor((px + hx) / TILE).long() + 1, prep.rect[:, 2])
    y1 = torch.minimum(torch.floor((py + hy) / TILE).long() + 1, prep.rect[:, 3])
    use = prep.visible & (op * 255.0 >= 1.0) & torch.isfinite(px) \
        & torch.isfinite(py) & (x1 > x0) & (y1 > y0)
    g = torch.nonzero(use)[:, 0]
    nx, ny = (x1 - x0)[g], (y1 - y0)[g]
    per = nx * ny
    pg = torch.repeat_interleave(g, per)
    first = torch.cumsum(per, 0) - per
    local = torch.arange(pg.shape[0], device=dev) - torch.repeat_interleave(first, per)
    rep_nx = torch.repeat_interleave(nx, per)
    tx = x0[pg] + local % rep_nx
    ty = y0[pg] + local // rep_nx
    tile = ty * gx + tx
    n = prep.depth.shape[0]
    rank = torch.empty(n, dtype=torch.long, device=dev)
    rank[torch.argsort(prep.depth.detach(), stable=True)] = torch.arange(n, device=dev)
    order = torch.argsort(tile * n + rank[pg])
    gauss, tile = pg[order], tile[order]
    n_tiles = gx * gy
    count = torch.bincount(tile, minlength=n_tiles)
    start = torch.cumsum(count, 0) - count
    cnt_h = count.cpu()
    by_size = torch.argsort(cnt_h, descending=True, stable=True)
    blocks, i = [], 0
    sizes = cnt_h[by_size].tolist()
    while i < n_tiles and sizes[i] > 0:
        k = sizes[i]
        b = max(1, block_elems // (k * PIX))
        ids = by_size[i:i + b]
        blocks.append((ids.to(dev), k))
        i += len(ids)
    return Plan(gauss, start, count, blocks, gx, n_tiles)


def _block(pl: Plan, ids, k, mean2d, conic, opacity, feats):
    """One block's per-pixel output [b,PIX,C], final T [b,PIX], and the
    masks of its evaluations (kept, live) [b,K,PIX]."""
    dev = mean2d.device
    kk = torch.arange(k, device=dev)
    cnt = pl.count[ids]
    valid = kk[None, :] < cnt[:, None]
    idx = (pl.start[ids][:, None] + kk[None, :]).clamp(max=max(pl.gauss.shape[0] - 1, 0))
    g = pl.gauss[idx]  # [b,K]
    lp = torch.arange(PIX, device=dev)
    ox = (ids % pl.grid_x) * TILE
    oy = (ids // pl.grid_x) * TILE
    pxx = (ox[:, None] + lp % TILE).float()  # [b,PIX]
    pyy = (oy[:, None] + lp // TILE).float()
    m, c = mean2d[g], conic[g]
    dx = m[..., 0, None] - pxx[:, None, :]
    dy = m[..., 1, None] - pyy[:, None, :]
    power = (-0.5 * (c[..., 0, None] * dx * dx + c[..., 2, None] * dy * dy)
             - c[..., 1, None] * dx * dy)
    alpha = torch.clamp_max(opacity[g][..., None]
                            * torch.exp(torch.clamp_max(power, 0.0)), ALPHA_MAX)
    keep = valid[..., None] & (power <= 0.0) & (alpha >= ALPHA_EPS)
    a = torch.where(keep, alpha, 0.0)
    cp = torch.cumprod(1.0 - a, dim=1)
    live = (cp >= T_EPS).detach()
    t_before = torch.cat([torch.ones_like(cp[:, :1]), cp[:, :-1]], dim=1)
    wgt = torch.where(live, a * t_before, 0.0)
    return wgt, feats[g], torch.prod(torch.where(live, 1.0 - a, 1.0), dim=1), keep & live


class _Blend(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mean2d, conic, opacity, feats, pl, precision):
        n_t = pl.n_tiles
        out = mean2d.new_zeros((n_t, PIX, feats.shape[-1]))
        ft = mean2d.new_ones((n_t, PIX))
        for ids, k in pl.blocks:
            wgt, f, t, _ = _block(pl, ids, k, mean2d, conic, opacity, feats)
            out[ids] = einsum("bkp,bkc->bpc", wgt, f, precision)
            ft[ids] = t
        ctx.save_for_backward(mean2d, conic, opacity, feats)
        ctx.pl, ctx.precision = pl, precision
        return out, ft

    @staticmethod
    def backward(ctx, g_out, g_ft):
        mean2d, conic, opacity, feats = ctx.saved_tensors
        pl = ctx.pl
        leaves = [x.detach().requires_grad_(True)
                  for x in (mean2d, conic, opacity, feats)]
        grads = [torch.zeros_like(x) for x in leaves]
        for ids, k in pl.blocks:
            with torch.enable_grad():
                wgt, f, t, _ = _block(pl, ids, k, *leaves)
                o = einsum("bkp,bkc->bpc", wgt, f, ctx.precision)
                gs = torch.autograd.grad((o, t), leaves,
                                         (g_out[ids], g_ft[ids]),
                                         allow_unused=True)
            for acc, gi in zip(grads, gs):
                if gi is not None:
                    acc += gi
        return (*grads, None, None)


class Render(NamedTuple):
    image: torch.Tensor  # [C,H,W], background composited
    final_t: torch.Tensor  # [H,W]
    prep: Prep
    plan: Plan


def render(xyz, scales, quats, opacity, feats, affine, bg, w, h, precision,
           alive=None) -> Render:
    """C = feats.shape[-1] channels at a (w, h) canvas (multiples of 16)."""
    prep = preprocess(xyz, scales, quats, opacity, affine, w, h, precision,
                      alive)
    pl = plan(prep, w, h)
    out, ft = _Blend.apply(prep.mean2d, prep.conic, prep.opacity, feats, pl,
                           precision)
    gx, gy = pl.grid_x, pl.n_tiles // pl.grid_x
    c = feats.shape[-1]
    img = out.reshape(gy, gx, TILE, TILE, c).permute(4, 0, 2, 1, 3)
    img = img.reshape(c, gy * TILE, gx * TILE)
    fti = ft.reshape(gy, gx, TILE, TILE).permute(0, 2, 1, 3).reshape(
        gy * TILE, gx * TILE)
    img = img + fti[None] * bg[:, None, None]
    return Render(img, fti, prep, pl)


@torch.no_grad()
def blend_work(r: Render, feats) -> dict:
    """What any blend of this render must do: the (pixel, Gaussian)
    evaluations that composite (alpha >= 1/255 before the pixel's stop),
    and the pairs that composite into at least one pixel of their tile."""
    comps = pairs = 0
    pl, prep = r.plan, r.prep
    for ids, k in pl.blocks:
        _, _, _, used = _block(pl, ids, k, prep.mean2d, prep.conic,
                               prep.opacity, feats)
        comps += int(used.sum())
        pairs += int(used.any(dim=2).sum())
    n_tiles = pl.n_tiles
    return dict(composites=comps, pairs_used=pairs, tiles=n_tiles,
                pixels=n_tiles * PIX, gaussians=int(prep.visible.sum()),
                pairs_listed=int(pl.count.sum()))


def mean_knn_dist2(points, window: int = 64, chunk: int = 1 << 16,
                   exact_below: int = 4096):
    """Mean squared distance to the 3 nearest neighbours (the init's scale
    rule, simple-knn's role): exact up to ``exact_below`` points, above it
    among the +-window neighbours along a Morton order."""
    if points.shape[0] <= exact_below:
        d2 = ((points[:, None, :] - points[None, :, :]) ** 2).sum(-1)
        d2.fill_diagonal_(math.inf)
        return torch.topk(d2, 3, dim=1, largest=False)[0].mean(-1)
    lo, hi = points.amin(0), points.amax(0)
    q = ((points - lo) / torch.clamp_min(hi - lo, 1e-9) * 1023.0).long()

    def spread(v):
        v = (v | (v << 16)) & 0x030000FF
        v = (v | (v << 8)) & 0x0300F00F
        v = (v | (v << 4)) & 0x030C30C3
        return (v | (v << 2)) & 0x09249249

    code = spread(q[:, 0]) | (spread(q[:, 1]) << 1) | (spread(q[:, 2]) << 2)
    order = torch.argsort(code, stable=True)
    n, sp = points.shape[0], points[order]
    off = torch.arange(-window, window + 1, device=points.device)
    out = torch.empty(n, device=points.device)
    for i0 in range(0, n, chunk):
        rows = torch.arange(i0, min(i0 + chunk, n), device=points.device)
        idx = rows[:, None] + off[None, :]
        ok = (idx >= 0) & (idx < n) & (off[None, :] != 0)
        d2 = ((sp[idx.clamp(0, n - 1)] - sp[rows][:, None, :]) ** 2).sum(-1)
        d2 = torch.where(ok, d2, math.inf)
        out[rows] = torch.topk(d2, 3, dim=1, largest=False)[0].mean(-1)
    res = torch.empty_like(out)
    res[order] = out
    return res
