"""Densification, pruning and resets as masked updates of the
fixed-capacity model.

Counterpart of ``eogs2_tpu/densify.py``; parity target the reference's
tensor-reallocating versions (gaussian_model.py:451-723) and their
optimizer-state surgery:
  * prune_points: drop rows + slice Adam moments  -> clear ``alive``
  * densify_and_clone / densify_and_split: cat rows + zero new moments
                                                  -> write free slots, zero
                                                     the moments there
  * reset_opacity: opacity <- min(op, 0.01), zero the opacity moments
  * only_prune (train_pan.py:674-677): raw opacity < min_opacity (-6.0)

Every function updates the model's parameters and buffers in place, under
``torch.no_grad()``: the ``nn.Parameter`` objects stay the ones the
optimizer holds. The Adam moments are the ``exp_avg`` and ``exp_avg_sq`` of
``torch.optim.Adam.state[p]`` for each parameter p of the Gaussians'
optimizer (one param group per leaf, ``train.gaussian_optimizer``); a
parameter with no state yet (before its first step) has all-zero moments
already. Adam's per-parameter ``step`` is left alone, as JAX leaves optax's
shared count.
"""

from __future__ import annotations

import torch

from eogs2_tpu_torch.model import GaussianModel, GaussianParams, reset_opacity
from eogs2_tpu_torch.ops.gaussians import quat_to_rotmat


@torch.no_grad()
def prune_transparent(model: GaussianModel, min_opacity_raw: float) -> None:
    """Kill the Gaussians whose RAW (logit) opacity is below
    ``min_opacity_raw`` (train_pan.py:674-677 compares _opacity < -6.0)."""
    apply_prune(model, model.opacity[:, 0] < min_opacity_raw)


@torch.no_grad()
def prune_mask(model: GaussianModel, min_opacity: float, max_screen_size,
               scene_extent: float, screen_size_threshold: float):
    """densify_and_prune's prune criterion (gaussian_model.py:705-714):
    activated opacity < min_opacity, or too big on screen / in world."""
    mask = model.get_opacity() < min_opacity
    if max_screen_size is not None:
        big_vs = model.max_radii2d > max_screen_size
        big_ws = model.get_scaling().amax(dim=1) > 0.1 * screen_size_threshold
        mask = mask | big_vs | big_ws
    return mask & model.alive


@torch.no_grad()
def apply_prune(model: GaussianModel, kill) -> None:
    model.alive &= ~kill


def _free_slot_targets(alive, want):
    """For each selected source i (want[i]), a distinct dead slot: the k-th
    selected source gets the k-th dead slot, counted in ``alive`` before
    any write. Returns (slot [N] int64, ok [N] bool): ok[i] means a free
    slot was left for source i; slot[i] is meaningful only there."""
    n = alive.shape[0]
    dead = ~alive
    dead_rank = torch.cumsum(dead, 0) - 1  # int64 (JAX's is int32)
    # positions of the dead slots in order: JAX's mode="drop" scatter, with
    # the live slots sent to a spill row past the end
    dead_pos = torch.zeros(n + 1, dtype=torch.int64, device=alive.device)
    dead_pos.index_copy_(0, torch.where(dead, dead_rank, n),
                         torch.arange(n, device=alive.device))
    want_rank = torch.cumsum(want, 0) - 1
    ok = want & (want_rank < dead.sum())
    return dead_pos[want_rank.clamp(0, n - 1)], ok


def _zero_moments(opt: torch.optim.Optimizer, rows) -> None:
    """Zero the Adam moments of every Gaussian leaf at ``rows``."""
    for group in opt.param_groups:
        for p in group["params"]:
            state = opt.state.get(p)
            if state:
                state["exp_avg"][rows] = 0.0
                state["exp_avg_sq"][rows] = 0.0


def _write_rows(model: GaussianModel, src, dst, rows: dict) -> None:
    """Row src[k] of each leaf (of ``rows[f]`` where given, else of the
    leaf itself) to row dst[k], in place."""
    for f in GaussianParams._fields:
        p = getattr(model, f)
        p.index_copy_(0, dst, rows.get(f, p)[src])


@torch.no_grad()
def densify_clone(model: GaussianModel, opt: torch.optim.Optimizer,
                  grads_avg, grad_threshold: float, percent_dense: float,
                  scene_extent: float):
    """Clone small high-gradient Gaussians into free slots
    (gaussian_model.py:625-659): the copies get identical parameters and
    zeroed Adam moments. Returns the number cloned (a 0-d tensor)."""
    sel = ((grads_avg >= grad_threshold)
           & (model.get_scaling().amax(dim=1) <= percent_dense * scene_extent)
           & model.alive)
    slot, ok = _free_slot_targets(model.alive, sel)
    src = ok.nonzero()[:, 0]
    dst = slot[src]
    _write_rows(model, src, dst, {})
    model.alive[dst] = True
    _zero_moments(opt, dst)
    return ok.sum()


@torch.no_grad()
def densify_split(model: GaussianModel, opt: torch.optim.Optimizer,
                  grads_avg, draw1, draw2, grad_threshold: float,
                  percent_dense: float, scene_extent: float):
    """Split large high-gradient Gaussians in two (gaussian_model.py:
    573-623): children at mean + R (draw * std), scale / (0.8 * 2); the
    original dies. draw1, draw2 [Nmax, 3] are standard-normal draws (JAX's
    from ``jax.random.split(key)``; the Trainer's from its generator).

    Fixed-capacity version, as JAX's: child 1 goes to a free slot, child 0
    overwrites the parent's slot (only where the free-slot write succeeded,
    so a failed split leaves the parent untouched); both get zeroed
    moments. Returns the number split (a 0-d tensor)."""
    sel = ((grads_avg >= grad_threshold)
           & (model.get_scaling().amax(dim=1) > percent_dense * scene_extent)
           & model.alive)
    stds = model.get_scaling()
    # build_rotation normalizes the quaternion here (utils/general_utils.py:
    # 88-110), unlike the rasterizer path
    rotn = quat_to_rotmat(model.rotation, normalize=True)
    child1 = torch.einsum("nij,nj->ni", rotn, draw1 * stds) + model.xyz
    child2 = torch.einsum("nij,nj->ni", rotn, draw2 * stds) + model.xyz
    child_scaling = torch.log(stds / (0.8 * 2))

    slot, ok = _free_slot_targets(model.alive, sel)
    src = ok.nonzero()[:, 0]
    dst = slot[src]
    _write_rows(model, src, dst, {"xyz": child2, "scaling": child_scaling})
    model.xyz.index_copy_(0, src, child1[src])
    model.scaling.index_copy_(0, src, child_scaling[src])
    model.alive[dst] = True
    _zero_moments(opt, torch.cat([dst, src]))
    return ok.sum()


@torch.no_grad()
def reset_densification_stats(model: GaussianModel) -> None:
    model.xyz_gradient_accum.zero_()
    model.denom.zero_()
    model.max_radii2d.zero_()


@torch.no_grad()
def reset_opacity_with_moments(model: GaussianModel,
                               opt: torch.optim.Optimizer) -> None:
    """reset_opacity, and zero the opacity Adam moments
    (gaussian_model.py:347-352 + replace_tensor_to_optimizer)."""
    reset_opacity(model)
    state = opt.state.get(model.opacity)
    if state:
        state["exp_avg"].zero_()
        state["exp_avg_sq"].zero_()
