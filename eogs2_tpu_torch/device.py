"""Device selection for the PyTorch/CUDA port.

The port runs on CUDA unless the caller names another device: constructors
take ``device=None`` and resolve it through :func:`default_device`, which
raises when no CUDA device is present instead of quietly picking the CPU.
Functions on tensors run wherever their tensors live.
"""

from __future__ import annotations

import torch


def default_device() -> torch.device:
    """The device the port's entry points use when none is given: CUDA.

    Raises RuntimeError without a CUDA device; pass ``device="cpu"``
    explicitly to run on the CPU (as the CPU tests do)."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "eogs2_tpu_torch runs on CUDA by default and found no CUDA "
            "device; pass device='cpu' to run on the CPU"
        )
    return torch.device("cuda")


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device, or :func:`default_device` when None."""
    return default_device() if device is None else torch.device(device)
