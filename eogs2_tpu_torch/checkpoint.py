"""Checkpoint / resume.

Counterpart of ``eogs2_tpu/checkpoint.py``; parity target the reference's
training checkpoints (torch.save((gaussians.capture(), iteration)) at
checkpoint_iterations, restored with the Adam state;
gaussian_model.py:73-107, train_pan.py:122-124, 799-807).

A checkpoint is one ``torch.save`` file (JAX writes an orbax directory)
holding a plain dict in JAX's ``_state_to_pytree`` schema: ``params``,
``aux`` and ``shading`` by field, ``g_opt`` and ``c_opt`` as ``{count, mu:
{field: ...}, nu: {field: ...}}``, ``step`` and ``iteration``. Tensors are
saved on the CPU, so a file written on the card loads anywhere.

Restoring writes into the Trainer's existing parameters, buffers and Adam
states in place: the Trainer's step closes over those objects, so a rebound
tensor or a rebuilt optimizer would leave it stepping the old ones. The
mapping from JAX's optax state to torch's Adam: the one ``count`` of a tree
is each leaf's ``step``; ``mu``/``nu`` of a field are the ``exp_avg``/
``exp_avg_sq`` of that field's tensor, matched by name. A leaf whose moments
are None had no Adam state at save time and gets none. Zero-size leaves
(``features_rest`` at SH degree 0) are kept like the others: torch.save
takes them, where orbax makes JAX drop them. :func:`state_from_numpy`
takes the same tree as numpy arrays, so it also loads a JAX TrainState
(``jax.tree.map(np.asarray, _state_to_pytree(s))``).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict

import numpy as np
import torch

from eogs2_tpu_torch.model import GaussianAux, GaussianParams


def _gauss_leaves(trainer) -> Dict[str, torch.Tensor]:
    return {f: getattr(trainer.model, f) for f in GaussianParams._fields}


def _shading_leaves(trainer) -> Dict[str, torch.Tensor]:
    sh = trainer.shading
    return {f.name: getattr(sh, f.name) for f in dataclasses.fields(sh)
            if getattr(sh, f.name) is not None}


def _adam_tree(opt: torch.optim.Adam, leaves: Dict[str, torch.Tensor]):
    held = {k: opt.state[p] for k, p in leaves.items()
            if "exp_avg" in opt.state.get(p, {})}
    steps = {int(st["step"]) for st in held.values()}
    if len(steps) > 1:
        raise ValueError(f"Adam leaves at different steps {sorted(steps)}")

    def moment(key):
        return {k: (held[k][key].detach().cpu().clone() if k in held
                    else None) for k in leaves}

    return {"count": torch.tensor(steps.pop() if steps else 0),
            "mu": moment("exp_avg"), "nu": moment("exp_avg_sq")}


def state_to_tree(trainer) -> dict:
    """The Trainer's whole state in JAX's _state_to_pytree schema, as CPU
    tensors (copies)."""
    def cpu(x):
        return x.detach().cpu().clone()

    model = trainer.model
    return {
        "params": {k: cpu(v) for k, v in _gauss_leaves(trainer).items()},
        "aux": {f: cpu(getattr(model, f)) for f in GaussianAux._fields},
        "shading": {k: cpu(v) for k, v in _shading_leaves(trainer).items()},
        "g_opt": _adam_tree(trainer.gauss_opt, _gauss_leaves(trainer)),
        "c_opt": _adam_tree(trainer.cam_opt, _shading_leaves(trainer)),
        "step": torch.tensor(int(trainer.step)),
    }


def _put(dst: torch.Tensor, src, name: str):
    src = src if torch.is_tensor(src) else torch.from_numpy(np.array(src))
    if tuple(src.shape) != tuple(dst.shape):
        # the capacity is fixed at setup (JAX: "capacity must match")
        raise ValueError(f"checkpoint leaf {name} has shape "
                         f"{tuple(src.shape)}, the Trainer's is "
                         f"{tuple(dst.shape)}: restore into a Trainer of "
                         f"the same capacity and views")
    dst.copy_(src.to(dst.dtype))


@torch.no_grad()
def _restore_adam(opt: torch.optim.Adam, leaves, saved: dict, prefix: str):
    count = int(np.asarray(saved["count"]))
    for k, p in leaves.items():
        mu, nu = saved["mu"].get(k), saved["nu"].get(k)
        if mu is None or nu is None:
            opt.state.pop(p, None)
            continue
        st = opt.state[p]
        if "exp_avg" not in st:
            st["step"] = torch.tensor(0.0, dtype=torch.float32)
            st["exp_avg"] = torch.zeros_like(p)
            st["exp_avg_sq"] = torch.zeros_like(p)
        st["step"].fill_(count)
        _put(st["exp_avg"], mu, f"{prefix}.mu.{k}")
        _put(st["exp_avg_sq"], nu, f"{prefix}.nu.{k}")


@torch.no_grad()
def state_from_numpy(tree: dict, trainer) -> int:
    """Load a _state_to_pytree-schema tree of arrays (numpy, or CPU tensors)
    into the set-up Trainer in place; returns tree["iteration"] (or the
    step when the tree has none)."""
    model = trainer.model
    for k, p in _gauss_leaves(trainer).items():
        _put(p, tree["params"][k], f"params.{k}")
    for f in GaussianAux._fields:
        _put(getattr(model, f), tree["aux"][f], f"aux.{f}")
    for k, p in _shading_leaves(trainer).items():
        if tree["shading"].get(k) is not None:
            _put(p, tree["shading"][k], f"shading.{k}")
    _restore_adam(trainer.gauss_opt, _gauss_leaves(trainer), tree["g_opt"],
                  "g_opt")
    _restore_adam(trainer.cam_opt, _shading_leaves(trainer), tree["c_opt"],
                  "c_opt")
    trainer.step = int(np.asarray(tree["step"]))
    return int(np.asarray(tree.get("iteration", tree["step"])))


def save_checkpoint(path: str, trainer, iteration: int):
    """Write the Trainer's state and the iteration to one file (its
    directory is created, as orbax creates JAX's)."""
    tree = state_to_tree(trainer)
    tree["iteration"] = torch.tensor(int(iteration))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save(tree, path)


def restore_checkpoint(path: str, trainer) -> int:
    """Restore a save_checkpoint file into the set-up Trainer (same
    capacity and views) in place; returns the saved iteration."""
    tree = torch.load(path, map_location="cpu", weights_only=True)
    return state_from_numpy(tree, trainer)
