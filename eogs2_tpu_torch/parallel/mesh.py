"""The device mesh and the Gaussian shard of the model.

Counterpart of ``eogs2_tpu/parallel/mesh.py``. The axes of parallelism are
JAX's:

  * "g" (Gaussian): the model's N dimension. Each rank keeps a contiguous
    slice of the N-major parameters, bookkeeping and Adam moments;
    preprocessing and the parameter update stay local.
  * "d" (data): the views of a step (``views_per_step``); each "d" row
    renders its share of the views and the gradients are summed over "d".
  * tile bands: inside the all_to_all rasterizer (sharded_raster.py), each
    rank of "g" blends one contiguous band of tile rows.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the process
group (one rank per card), with JAX's axis names and factoring.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist

from eogs2_tpu_torch.model import GaussianAux, GaussianModel, GaussianParams


def make_mesh(n_devices: Optional[int] = None,
              axes: Sequence[str] = ("g",)):
    """A ("g",) or ("d", "g") DeviceMesh over the process group's ranks.

    ``n_devices`` must be the group's size (None: the group's size). The
    ("d", "g") form gives "d" the small factor, 2 or 4 (the largest that
    leaves "g" at least 2), as JAX's make_mesh does. The device type is the
    group's: CUDA under NCCL, the CPU under gloo."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "parallel.distributed.init_distributed first")
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if n != world:
        raise ValueError(f"a mesh of {n} devices over a process group of "
                         f"{world} ranks")
    axes = tuple(axes)
    if len(axes) == 1:
        shape = (n,)
    elif len(axes) == 2:
        d = 1
        for cand in (2, 4):
            if n % cand == 0 and n // cand >= 2:
                d = cand
        shape = (d, n // d)
    else:
        raise ValueError(axes)
    dev_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(dev_type, shape, mesh_dim_names=axes)


def axis_size(mesh, axis: str) -> int:
    """The number of ranks along ``axis`` (1 without a mesh or the axis)."""
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        return 1
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_rank(mesh, axis: str) -> int:
    """This rank's coordinate along ``axis`` (0 without one)."""
    if axis_size(mesh, axis) == 1:
        return 0
    return mesh.get_local_rank(axis)


def axis_group(mesh, axis: str):
    """The process group of this rank's line along ``axis`` (None without
    one: the collectives are then no-ops)."""
    if axis_size(mesh, axis) == 1:
        return None
    return mesh.get_group(axis)


def gauss_range(n: int, mesh, axis: str = "g"):
    """(lo, hi): this rank's contiguous slice of n Gaussians."""
    m = n // axis_size(mesh, axis)
    r = axis_rank(mesh, axis)
    return r * m, (r + 1) * m


# the dead rows' values, as init_from_points pads the capacity
_PAD = dict(scaling=-10.0, opacity=-10.0)


@torch.no_grad()
def pad_gaussians(model: GaussianModel, multiple: int) -> GaussianModel:
    """``model`` with N padded by dead Gaussians (alive False, init_from_
    points's pad values) up to a multiple of ``multiple``; the model itself
    when N already is one (JAX asserts it, sharded_raster.py:365)."""
    n = model.xyz.shape[0]
    pad = (-n) % multiple
    if pad == 0:
        return model

    def grow(x, fill):
        ext = x.new_full((pad,) + tuple(x.shape[1:]), fill)
        return torch.cat([x.detach(), ext])

    params = {f: grow(getattr(model, f), _PAD.get(f, 0.0))
              for f in GaussianParams._fields}
    params["rotation"][n:, 0] = 1.0
    aux = {f: grow(getattr(model, f), False if f == "alive" else 0.0)
           for f in GaussianAux._fields}
    return GaussianModel(GaussianParams(**params), GaussianAux(**aux),
                         model.sh_degree)


def adam_like(opt: torch.optim.Adam, new_params, take=None):
    """A torch Adam over ``new_params`` (one per parameter of ``opt``, in
    its order) with ``opt``'s groups' hyper-parameters; each parameter's
    state is ``take(old_state_tensor)`` of the old one (moments) with its
    step copied."""
    old = [p for g in opt.param_groups for p in g["params"]]
    if len(old) != len(new_params):
        raise ValueError("one new parameter per optimizer parameter")
    groups, it = [], iter(new_params)
    for g in opt.param_groups:
        ng = {k: v for k, v in g.items() if k != "params"}
        ng["params"] = [next(it) for _ in g["params"]]
        groups.append(ng)
    new = torch.optim.Adam(groups)
    for p_old, p_new in zip(old, new_params):
        st = opt.state.get(p_old)
        if st and "exp_avg" in st:
            new.state[p_new] = {
                "step": st["step"].clone(),
                "exp_avg": take(st["exp_avg"]).clone(),
                "exp_avg_sq": take(st["exp_avg_sq"]).clone(),
            }
    return new


@torch.no_grad()
def shard_gaussian_state(model: GaussianModel, mesh, axis: str = "g",
                         opt: Optional[torch.optim.Adam] = None):
    """This rank's shard of a host-replicated model: (local model, local
    Adam or None).

    N is padded with dead Gaussians to a multiple of the axis size; the
    local model holds rows [lo, hi) of every N-major parameter and buffer,
    and the local Adam (built when ``opt``, the whole model's, is given)
    the same rows of each moment. Everything else (the shading parameters
    and their Adam) stays replicated: each rank keeps its own copy."""
    full = pad_gaussians(model, axis_size(mesh, axis))
    lo, hi = gauss_range(full.xyz.shape[0], mesh, axis)
    params = GaussianParams(*(getattr(full, f).detach()[lo:hi].clone()
                              for f in GaussianParams._fields))
    aux = GaussianAux(*(getattr(full, f)[lo:hi].clone()
                        for f in GaussianAux._fields))
    local = GaussianModel(params, aux, model.sh_degree)
    if opt is None:
        return local, None
    n0 = model.xyz.shape[0]

    def take(x):
        if x.shape[0] != n0:
            raise ValueError("an optimizer state that is not N-major")
        return pad_rows(x, full.xyz.shape[0])[lo:hi]

    return local, adam_like(opt, [getattr(local, f)
                                  for f in GaussianParams._fields], take)


def pad_rows(x, n: int):
    """x with zero rows appended up to n rows."""
    if x.shape[0] == n:
        return x
    return torch.cat([x, x.new_zeros((n - x.shape[0],) + tuple(x.shape[1:]))])
