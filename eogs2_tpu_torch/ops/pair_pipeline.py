"""Pair emission, and the packed [T, 16, K] pair table of the dense modes.

Counterpart of the emission-key logic of ``eogs2_tpu/ops/pair_pipeline.py``
(``_tier_keys`` and ``_tier_keys_compact``) and of its ellipse-exact tile
cull. The JAX package emits into static [tcap, N] tables because XLA's
shapes are static; here the pair list is sized by TRUE demand, as the CUDA
reference sizes its BinningState (rasterizer_impl.cu:280-288): an exclusive
prefix sum of the per-Gaussian tile counts, every rect tile of every
Gaussian emitted, and (with ``tile_cull``) culled slots dropped. On the
fused route nothing is clipped, so the tcap/big_k/rect_cap capacities have
nothing to do. The dense modes clamp each Gaussian to its first
``max_tiles_per_gaussian`` rect tiles, as JAX's dense table does.

Emission order is Gaussian-major (each Gaussian's rect tiles row-major,
culled ones removed in place — the same within-Gaussian order as the
compacting tier). On the card the emission is the two passes of
``csrc/emit_pairs.cu`` (the reference's duplicateWithKeys after its
tiles_touched scan): a count of each Gaussian's live tiles, one prefix sum
and one read of the total, and a write of the pairs at each Gaussian's
offset, so no pre-cull pair exists. The plain version (``emit_walk_plain``,
the CPU's path) expands every walked tile and drops the dead ones; the two
agree bit for bit. Both return each Gaussian's pair count (``lengths``),
which the sort, the deterministic backward and the statistics take.

``densify_pairs`` is the counterpart of ``eogs2_tpu/ops/pair_pipeline.py:
densify_pairs`` (the ``sorted`` mode): the dense view of the sorted pairs,
K slots per tile, with a deterministic backward. It gathers straight into
the packed [T, 16, K] layout that K4 reads (JAX's ``pack_tile_data`` of its
dense table), so the plain blend reads slices of the same table. The port's
``gather`` mode runs the same function: JAX's two modes differ only in how
XLA moves the payload (a random gather against payload-carrying sorts), not
in what they compute.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from eogs2_tpu_torch.observability import host_read
from eogs2_tpu_torch.ops.binning import (bin_gaussians, depth_key,
                                         tile_pair_indices)
from eogs2_tpu_torch.ops.projection import TILE

# conservative slack on the cull threshold, covering f32 rounding drift
# between the closed-form box minimum and the blend's per-pixel test
_CULL_MARGIN = 1e-3


def _tile_qmin(a, b, c, lx, ux, ly, uy):
    """Exact min over the box dx in [lx,ux], dy in [ly,uy] of the
    Mahalanobis quadratic q = a dx^2 + 2 b dx dy + c dy^2 (the blend's power
    is -q/2). Exact for a PSD conic; the four corners make it an
    under-estimate for an indefinite one, so a cull built on it is
    conservative."""
    inside = (lx <= 0) & (0 <= ux) & (ly <= 0) & (0 <= uy)

    def q(dx, dy):
        return a * dx * dx + 2.0 * b * dx * dy + c * dy * dy

    def edge_x(e):  # dx fixed at e, minimize over dy
        t = torch.clamp(-b * e / torch.where(c > 0, c, 1e-12), ly, uy)
        return q(e, t)

    def edge_y(e):  # dy fixed at e, minimize over dx
        t = torch.clamp(-b * e / torch.where(a > 0, a, 1e-12), lx, ux)
        return q(t, e)

    qm = torch.minimum(
        torch.minimum(torch.minimum(edge_x(lx), edge_x(ux)),
                      torch.minimum(edge_y(ly), edge_y(uy))),
        torch.minimum(torch.minimum(q(lx, ly), q(lx, uy)),
                      torch.minimum(q(ux, ly), q(ux, uy))),
    )
    return torch.where(inside, 0.0, qm)


def _slot_cull_mask(rect_min, tx, ty, cull):
    """[P] True where the pair's tile is provably dead: every pixel of the
    tile has alpha < 1/255 or power > 0 (the forward.cu skip pair), so
    dropping the pair is output-exact.

    rect_min [P,2], tx/ty [P] rect offsets, cull = (mean2d [P,2],
    conic [P,3], thr [P]) — all per pair; thr = cull_tau + _CULL_MARGIN."""
    mean2d, conic, thr = cull
    x0 = (rect_min[:, 0] + tx).to(torch.float32) * TILE
    y0 = (rect_min[:, 1] + ty).to(torch.float32) * TILE
    mx, my = mean2d[:, 0], mean2d[:, 1]
    qmin = _tile_qmin(
        conic[:, 0], conic[:, 1], conic[:, 2],
        mx - (x0 + TILE - 1.0), mx - x0,
        my - (y0 + TILE - 1.0), my - y0,
    )
    dead = qmin > thr
    return torch.where(torch.isfinite(qmin), dead, False)


def cull_tau(opacity):
    """Per-Gaussian cull threshold: opac*exp(-q/2) >= 1/255 iff
    q <= 2 ln(255*opac)."""
    return 2.0 * torch.log(torch.clamp_min(opacity, 1e-30) * 255.0)


class Emission(NamedTuple):
    gid: torch.Tensor  # [P] int64 Gaussian of each pair, Gaussian-major
    tile: torch.Tensor  # [P] int64 tile of each pair
    lengths: torch.Tensor  # [N] int64 pairs each Gaussian emitted
    key: Optional[torch.Tensor]  # [P] int64 tile << 32 | depth_key, or None


class Walk(NamedTuple):
    """The per-Gaussian inputs of the emission, as both versions read them:
    each Gaussian walks its first ``tiles`` rect tiles in row-major order."""
    rect_min: torch.Tensor  # [N, 2] int32
    rect_size: torch.Tensor  # [N, 2] int32
    tiles: torch.Tensor  # [N] int32 min(tiles_touched, tcap)
    mean2d: torch.Tensor  # [N, 2] float32
    conic: torch.Tensor  # [N, 3] float32
    thr: Optional[torch.Tensor]  # [N] float32 cull threshold; None: no cull


def walk_of(prep, tile_cull: bool = False, tcap: Optional[int] = None):
    """The Walk of prep: contiguous, in the kernels' types."""
    tiles = prep.tiles_touched.to(torch.int32)
    if tcap is not None:
        tiles = tiles.clamp_max(tcap)
    thr = None
    if tile_cull:
        thr = (cull_tau(prep.opacity) + _CULL_MARGIN).to(
            torch.float32).contiguous()
    return Walk(prep.rect_min.to(torch.int32).contiguous(),
                prep.rect_size.to(torch.int32).contiguous(),
                tiles.contiguous(),
                prep.mean2d.to(torch.float32).contiguous(),
                prep.conic.to(torch.float32).contiguous(), thr)


def emit_walk_plain(w: Walk, grid_x: int, depth=None) -> Emission:
    """Plain PyTorch version of the emission (the kernels' exact output):
    every walked rect tile of every Gaussian becomes a pair, then the dead
    ones are dropped by two boolean masks. Waits for the card three times
    with a cull (the total, the two masks), once without."""
    dev = w.tiles.device
    tiles = w.tiles.to(torch.int64)
    n = tiles.shape[0]
    total = host_read(tiles.sum(), "emit.total") if n else 0
    gid = torch.repeat_interleave(
        torch.arange(n, device=dev), tiles, output_size=total
    )
    first = torch.cumsum(tiles, 0) - tiles  # exclusive prefix sum
    j = torch.arange(total, device=dev) - first[gid]
    rect_min = w.rect_min.to(torch.int64)[gid]
    rw = w.rect_size[:, 0].to(torch.int64).clamp_min(1)[gid]
    ty = torch.div(j, rw, rounding_mode="floor")
    tx = j - ty * rw
    tile = (rect_min[:, 1] + ty) * grid_x + (rect_min[:, 0] + tx)
    lengths = tiles
    if w.thr is not None:
        live = ~_slot_cull_mask(rect_min, tx, ty,
                                (w.mean2d[gid], w.conic[gid], w.thr[gid]))
        lengths = torch.zeros_like(tiles).index_add_(0, gid,
                                                     live.to(torch.int64))
        # boolean masks: each waits for the card to count the live pairs
        gid = host_read(lambda: gid[live], "emit.cull_gid")
        tile = host_read(lambda: tile[live], "emit.cull_tile")
    key = None
    if depth is not None:
        key = (tile << 32) | depth_key(depth)[gid]
    return Emission(gid, tile, lengths, key)


_VP, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _walk_args(w: Walk, depth=None):
    """The kernels' per-Gaussian pointer arguments and N; raises unless
    every input lies on one CUDA device in its shape."""
    n, dev = w.tiles.shape[0], w.tiles.device
    shapes = dict(rect_min=(n, 2), rect_size=(n, 2), mean2d=(n, 2),
                  conic=(n, 3))
    for name, x in (*w._asdict().items(), ("depth", depth)):
        shape = shapes.get(name, (n,))
        if x is not None and (x.device != dev or x.shape != shape):
            raise ValueError(f"emission: {name} must be {list(shape)} on "
                             f"{dev}, got {list(x.shape)} on {x.device}")
    if dev.type != "cuda":
        raise ValueError(f"emission kernels: {dev} is not a CUDA device")
    thr = w.thr is not None
    return (w.rect_min.data_ptr(), w.rect_size.data_ptr(), w.tiles.data_ptr(),
            w.mean2d.data_ptr() if thr else None,
            w.conic.data_ptr() if thr else None,
            w.thr.data_ptr() if thr else None, w.tiles.shape[0])


def count_pairs(w: Walk, grid_x: int):
    """The count pass (csrc/emit_pairs.cu) on the card: [N] int64, the live
    tiles among each Gaussian's walked rect tiles."""
    from eogs2_tpu_torch.ops import cuda_build

    args = _walk_args(w)
    fn = cuda_build.entry("emit_pairs", "eogs2_emit_count",
                          [_VP, _VP, _VP, _VP, _VP, _VP, _LL, _I, _VP, _VP])
    lengths = torch.empty(w.tiles.shape[0], dtype=torch.int64,
                          device=w.tiles.device)
    with torch.cuda.device(w.tiles.device):
        err = fn(*args, grid_x, lengths.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
    cuda_build.check_launch(err, "count_pairs")
    count_pairs.launches += 1
    return lengths


count_pairs.launches = 0  # kernel launches on the card


def write_pairs(w: Walk, grid_x: int, ends, lengths, total: int,
                depth=None):
    """The write pass (csrc/emit_pairs.cu) on the card: (gid, tile, key)
    [total] int64, Gaussian g's live pairs at [ends[g] - lengths[g],
    ends[g]); key None unless depth [N] is given."""
    from eogs2_tpu_torch.ops import cuda_build

    dev = w.tiles.device
    if depth is not None:
        depth = depth.to(torch.float32).contiguous()
    args = _walk_args(w, depth)
    fn = cuda_build.entry("emit_pairs", "eogs2_emit_write",
                          [_VP, _VP, _VP, _VP, _VP, _VP, _LL, _I, _VP, _VP,
                           _VP, _VP, _VP, _VP, _VP])
    gid, tile = (torch.empty(total, dtype=torch.int64, device=dev)
                 for _ in range(2))
    key = None if depth is None else torch.empty(total, dtype=torch.int64,
                                                 device=dev)
    with torch.cuda.device(dev):
        err = fn(*args, grid_x, ends.data_ptr(), lengths.data_ptr(),
                 None if depth is None else depth.data_ptr(), gid.data_ptr(),
                 tile.data_ptr(), None if key is None else key.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
    cuda_build.check_launch(err, "write_pairs")
    write_pairs.launches += 1
    return gid, tile, key


write_pairs.launches = 0  # kernel launches on the card


def emit_walk(w: Walk, grid_x: int, depth=None) -> Emission:
    """The emission on the card: the count pass, one prefix sum, one wait
    for the total (site ``emit.total``), the write pass."""
    lengths = count_pairs(w, grid_x)
    ends = torch.cumsum(lengths, 0)
    n = lengths.shape[0]
    total = host_read(ends[-1], "emit.total") if n else 0
    gid, tile, key = write_pairs(w, grid_x, ends, lengths, total, depth)
    return Emission(gid, tile, lengths, key)


def emit_pairs(prep, grid_x: int, tile_cull: bool = False,
               tcap: Optional[int] = None, depth=None) -> Emission:
    """Demand-sized emission.

    Returns an Emission: (gid [P] int64 Gaussian index, tile [P] int64 tile
    id) for every (Gaussian, rect tile) pair, Gaussian-major, each
    Gaussian's tiles row-major; with ``tile_cull`` the provably dead pairs
    are dropped; with ``tcap`` each Gaussian emits only its first
    min(tiles_touched, tcap) rect tiles. ``lengths`` [N] the pairs of each
    Gaussian; ``key`` the sort key ``tile << 32 | depth_key(depth)[gid]``
    when ``depth`` [N] is given.

    CPU tensors take the plain version (:func:`emit_walk_plain`); CUDA
    tensors launch the two passes of csrc/emit_pairs.cu (:func:`emit_walk`)
    or raise."""
    dev = prep.tiles_touched.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"emit_pairs: unsupported device {dev}")
    w = walk_of(prep, tile_cull, tcap)
    if dev.type == "cpu":
        return emit_walk_plain(w, grid_x, depth)
    return emit_walk(w, grid_x, depth)


def emission_sum(g_sorted, perm, lengths):
    """Per-pair rows in sorted order [P, k] -> per-Gaussian sums [N, k],
    deterministically: the rows go back to emission order through the sort's
    permutation (no two collide), where each Gaussian's rows are contiguous
    (the emission is Gaussian-major), and one segment sum adds them in
    order."""
    k, n = g_sorted.shape[1], lengths.shape[0]
    if perm.shape[0] == 0:
        return g_sorted.new_zeros((n, k))
    g_em = g_sorted.new_empty((perm.shape[0], k))
    g_em[perm] = g_sorted
    return torch.segment_reduce(g_em, "sum", lengths=lengths, axis=0,
                                unsafe=True)


NF = 16  # rows of the packed table
MASK_ROW = 11  # after mx, my, conic a/b/c, opacity and 5 features


class PairDense(NamedTuple):
    data: torch.Tensor  # [T, 16, K] packed (rows below), 0 in empty slots
    mask: torch.Tensor  # [T, K] bool, a pair in the slot
    tile_count: torch.Tensor  # [T] pairs per tile (before the K clamp)
    num_pairs: torch.Tensor  # [] demand, before the tcap clamp
    max_tile_count: torch.Tensor  # [] densest tile, before the K clamp


class _DensePairs(torch.autograd.Function):
    """pay [N, 11] -> the packed table [T, 16, K]: a slot holding a pair has
    its Gaussian's pay row in rows 0-10 and 1 in row 11 (the mask); every
    other entry is 0. One gather writes the table, with a deterministic
    backward.

    sgid [P] is the Gaussian of each sorted pair, perm [P] the sort's
    permutation (sorted pair i came from emission pair perm[i]), lengths
    [N] each Gaussian's emitted pairs, idx/mask [T, K] the dense view
    (tile_pair_indices). Backward: dense slot -> sorted position -> emission
    position by the permutation -> one segment sum (emission_sum); autograd
    of a gather would add with index_put_(accumulate=True), atomic on CUDA.
    A pair the view dropped (past K) gets no gradient, and rows 11-15 none
    at all."""

    @staticmethod
    def forward(ctx, pay, sgid, perm, lengths, idx, mask):
        ctx.save_for_backward(perm, lengths, idx, mask)
        n, f = pay.shape
        # one column per Gaussian and a zero column that fills empty slots
        table = pay.new_zeros((NF, n + 1))
        table[:f, :n] = pay.T
        table[MASK_ROW, :n] = 1.0
        if sgid.numel() == 0:  # no pair at all
            col = torch.full_like(idx, n)
        else:
            col = torch.where(mask, sgid[idx], n)
        # gather reads the stride-0 expansions in place (broadcast advanced
        # indexing would materialise [T, 16, K] int64 indices on CUDA)
        t, k = col.shape
        return torch.gather(table[None].expand(t, NF, n + 1), 2,
                            col[:, None, :].expand(t, NF, k))

    @staticmethod
    def backward(ctx, g_data):
        perm, lengths, idx, mask = ctx.saved_tensors
        f = MASK_ROW  # rows 0-10 carry pay's gradient
        g_sorted = g_data.new_zeros((perm.shape[0], f))
        # each sorted pair sits in at most one slot
        g_sorted[idx[mask]] = g_data[:, :f].transpose(1, 2)[mask]
        return (emission_sum(g_sorted, perm, lengths), None, None, None,
                None, None)


def densify_pairs(prep, features, width: int, height: int, tcap: int,
                  tile_capacity: int) -> PairDense:
    """Differentiable packed [T, 16, K] pair table, K = tile_capacity.

    Rows: 0 mx, 1 my, 2-4 conic a, b, c, 5 opacity, 6-10 features (5
    channels), 11 mask, 12-15 zero. Each Gaussian emits its first tcap rect
    tiles; a tile keeps its first K pairs front to back and drops the rest,
    as JAX does (num_pairs and max_tile_count report the demand before
    either clamp, so a caller sees clipping)."""
    if features.shape[-1] != MASK_ROW - 6:
        raise ValueError(f"the dense modes composite {MASK_ROW - 6} "
                         f"channels, got {features.shape[-1]}")
    b = bin_gaussians(prep, width, height, max_tiles_per_gaussian=tcap)
    idx, mask = tile_pair_indices(b, tile_capacity)
    pay = torch.cat([prep.mean2d, prep.conic, prep.opacity[:, None],
                     features], dim=-1)
    data = _DensePairs.apply(pay, b.pair_gauss, b.perm, b.lengths, idx, mask)
    return PairDense(data=data, mask=mask, tile_count=b.tile_count,
                     num_pairs=b.num_pairs, max_tile_count=b.max_tile_count)
