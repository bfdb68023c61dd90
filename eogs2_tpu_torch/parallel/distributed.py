"""Process group bootstrap and the collectives of the multi-device path.

Counterpart of ``eogs2_tpu/parallel/distributed.py``. JAX runs one process
per host, each seeing all of its chips; torch runs one process (one rank)
per card, so a mesh of n cards is a process group of n ranks. The data model
is JAX's: the scene (images, cameras, init cloud) is host-replicated, every
rank loads the same files and takes the same random draws; the Gaussian
N-major state is split over the "g" axis (``mesh.shard_gaussian_state``).

Where JAX's GSPMD moves data implicitly, the port calls the collectives
here, each an autograd Function with the gradient a replicated loss needs:

  * :func:`all_gather_cat` joins the ranks' equal-sized shards along a dim
    (image row bands, per-Gaussian arrays). Every rank then computes the
    same loss on the whole, so each rank's gradient of the joined tensor is
    already the whole gradient: the backward keeps this rank's slice. (The
    backward of ``torch.distributed.nn``'s all_gather sums over ranks, which
    for a loss computed on every rank is n times too large.)
  * :func:`sum_grad` is the identity forward and sums the gradient over the
    ranks backward: a replicated tensor (a camera's affine) used in a
    sharded computation (each rank's Gaussians) collects every rank's part.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from eogs2_tpu_torch.device import resolve_device


def init_distributed(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device=None,
) -> bool:
    """Join the process group when a coordinator is configured (the CLI
    flags, or EOGS2_COORDINATOR / EOGS2_NUM_PROCESSES / EOGS2_PROCESS_ID);
    returns False and does nothing without one, so every entry point can
    call it unconditionally.

    ``coordinator`` is ``host:port`` of rank 0 (a TCP rendezvous) or any
    ``torch.distributed`` init URL (``tcp://...``, ``file://...``). The
    backend is NCCL when ``device`` resolves to CUDA (the default: each rank
    binds ``cuda:<rank % visible cards>``) and gloo only when the caller
    names the CPU. A group that fails to start raises; nothing falls back to
    another backend or device."""
    coordinator = coordinator or os.environ.get("EOGS2_COORDINATOR")
    if num_processes is None and "EOGS2_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["EOGS2_NUM_PROCESSES"])
    if process_id is None and "EOGS2_PROCESS_ID" in os.environ:
        process_id = int(os.environ["EOGS2_PROCESS_ID"])
    if coordinator is None:
        return False
    if num_processes is None or process_id is None:
        raise ValueError("a coordinator needs the number of processes and "
                         "this process's id")
    if dist.is_initialized():
        return True
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
        backend = "nccl"
    elif dev.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"no process group backend for device {dev}")
    url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group(backend, init_method=url,
                            world_size=int(num_processes),
                            rank=int(process_id))
    return True


def is_coordinator() -> bool:
    """True on the process that owns host-side side effects (logging,
    model saves, checkpoints): rank 0, or always outside a process group."""
    return not dist.is_initialized() or dist.get_rank() == 0


def group_size(group) -> int:
    """The ranks of ``group``; None is no group (one rank, no collective:
    a mesh axis of size 1), ``dist.group.WORLD`` the whole process group."""
    if group is None or not dist.is_initialized():
        return 1
    return dist.get_world_size(group)


def group_rank(group) -> int:
    """This rank's index in ``group`` (0 for None, as group_size)."""
    if group is None or not dist.is_initialized():
        return 0
    return dist.get_rank(group)


def make_global_array(host_x, mesh, axis: Optional[str] = None):
    """This rank's part of a host-replicated array (every rank passes the
    same ``host_x``): its contiguous slice of dim 0 over the mesh axis
    ``axis`` (dim 0 must divide by the axis size), or all of it when
    ``axis`` is None (replicated). Counterpart of JAX's make_global_array
    with P(axis) / P()."""
    x = torch.as_tensor(host_x)
    if axis is None:
        return x
    n = mesh.size(mesh.mesh_dim_names.index(axis))
    r = mesh.get_local_rank(axis)
    if x.shape[0] % n:
        raise ValueError(f"dim 0 ({x.shape[0]}) does not divide by the "
                         f"{axis!r} axis ({n})")
    m = x.shape[0] // n
    return x[r * m:(r + 1) * m]


def all_processes_allclose(x, atol: float = 0.0) -> bool:
    """Debug guard: a replicated value is the same on every rank (catches
    per-rank nondeterminism in scene loading)."""
    group = dist.group.WORLD if dist.is_initialized() else None
    if group_size(group) == 1:
        return True
    x = torch.as_tensor(x)
    parts = [torch.empty_like(x) for _ in range(group_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return all(bool(torch.all(torch.abs(p - parts[0]) <= atol))
               for p in parts)


class _AllGatherCat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        n, r = group_size(group), group_rank(group)
        ctx.dim, ctx.rank, ctx.size = dim, r, x.shape[dim]
        if n == 1:
            return x.clone()
        flag = x.dtype == torch.bool  # gloo gathers no bool
        x = (x.to(torch.uint8) if flag else x).contiguous()
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=group)
        out = torch.cat(parts, dim)
        return out.to(torch.bool) if flag else out

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.rank * ctx.size, ctx.size), None, None


def all_gather_cat(x, group, dim: int = 0):
    """The ranks' equal-sized ``x`` joined along ``dim`` in rank order, on
    every rank of ``group`` (None: x itself, a copy); backward keeps this
    rank's slice of the gradient (see the module docstring)."""
    return _AllGatherCat.apply(x, group, dim)


class _SumGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if group_size(ctx.group) > 1:
            g = g.clone()
            dist.all_reduce(g, group=ctx.group)
        return g, None


def sum_grad(x, group):
    """Identity forward; the gradient summed over the ranks of ``group``
    backward (None: no sum)."""
    return _SumGrad.apply(x, group)


def all_reduce_(x, op=None, group=None):
    """In-place all_reduce (sum by default) over ``group`` of a tensor no
    gradient flows through; a no-op for None or a group of one rank."""
    if group_size(group) > 1:
        dist.all_reduce(x, op=op or dist.ReduceOp.SUM, group=group)
    return x
