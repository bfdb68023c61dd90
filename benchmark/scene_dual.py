"""The dual-modality scene: each view's PAN image and its MSI image at a
quarter of the PAN's width, as a WorldView-3 pair is (PAN 0.31 m, MSI
1.24 m a pixel).

``benchmark.scene.make_scene`` in modality "ms" renders every view's colours
at the PAN size and makes its PAN companion, the WV3 combination of those
colours. Here the MSI image is the ``msi_factor`` x ``msi_factor`` box mean of
the same colour render, and the MSI camera is the PAN camera at the MSI
size: an affine camera maps to normalised image coordinates, so one affine
serves both sizes, and the MSI pixel centres are the means of the PAN pixel
centres they cover. Nothing here imports the program.
"""

from __future__ import annotations

import torch.nn.functional as F

from benchmark.scene import Scene, make_scene


def make_scene_dual(size: dict, seed: int, device) -> Scene:
    """The scene of ``size`` (``make_scene``'s keys, the PAN size in
    ``width``/``height``, and ``msi_factor``) from ``seed``: metadatas
    {"msi": the cameras at the MSI size, "pan": at the PAN size}, images
    the MSI [3,h,w], images_pan the PAN [1,H,W]."""
    f = int(size["msi_factor"])
    s = make_scene(dict(size, modality="ms"), seed, device)
    pan_md = s.metadatas["pan"]
    if pan_md[0]["width"] % f or pan_md[0]["height"] % f:
        raise ValueError(f"the PAN size is no multiple of msi_factor {f}")
    msi_md = [dict(m, width=m["width"] // f, height=m["height"] // f)
              for m in pan_md]
    msi = {k: F.avg_pool2d(v[None], f)[0] for k, v in s.images.items()}
    return s._replace(metadatas={"msi": msi_md, "pan": pan_md}, images=msi)
