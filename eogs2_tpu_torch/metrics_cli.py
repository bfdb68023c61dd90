"""Image-metrics CLI: PSNR / SSIM / perceptual distance over rendered dirs.

Counterpart of ``eogs2_tpu/metrics_cli.py``; parity target ``metrics.py``
(:38-117) + ``lpipsPyTorch/``. PSNR, SSIM and the perceptual proxy's SSIM
run on the device (CUDA unless ``--device`` names another). LPIPS-vgg
needs torchvision's pretrained VGG16 weights; without them (the CPU test
machine and the card's machine have no torchvision, and nothing is
downloaded) the perceptual metric is a gradient-domain + multi-scale SSIM distance
(documented substitute — deterministic, weight-free), and
:func:`compute_metrics` says once on stderr which measure it computed and
why. When torchvision and its cached VGG16 weights ARE present,
``lpips_torch`` uses them.

Images are read through the port's codecs (``.png``, ``.tif``); a ``.jpg``
needs Pillow or imageio, imported at the read.

Usage: python -m eogs2_tpu_torch.metrics_cli --renders <dir> --gt <dir>
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from eogs2_tpu_torch.device import resolve_device
from eogs2_tpu_torch.io import read_image


def _load_dir(d):
    out = {}
    for f in sorted(os.listdir(d)):
        if f.lower().endswith((".png", ".tif", ".jpg")):
            img = np.asarray(read_image(os.path.join(d, f))).astype(np.float32)
            if img.max() > 1.5:
                img = img / 255.0
            if img.ndim == 2:
                img = img[..., None]
            out[os.path.splitext(f)[0]] = img.transpose(2, 0, 1)
    return out


def perceptual_distance(a, b, device=None):
    """Weight-free perceptual proxy: 1 - mean(multiscale SSIM) blended with
    gradient-magnitude L1. Returns a distance in [0, ~1]."""
    from eogs2_tpu_torch.ops.ssim import ssim

    dev = resolve_device(device)
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    ta = torch.as_tensor(a, device=dev)
    tb = torch.as_tensor(b, device=dev)
    total = 0.0
    wsum = 0.0
    for scale_w, factor in ((0.5, 1), (0.3, 2), (0.2, 4)):
        if min(a.shape[-2:]) // factor < 16:
            break
        aa = ta[:, ::factor, ::factor]
        bb = tb[:, ::factor, ::factor]
        total += scale_w * (1.0 - float(ssim(aa, bb)))
        wsum += scale_w
    ga = np.abs(np.gradient(a, axis=-1)) + np.abs(np.gradient(a, axis=-2))
    gb = np.abs(np.gradient(b, axis=-1)) + np.abs(np.gradient(b, axis=-2))
    grad_term = float(np.mean(np.abs(ga - gb)))
    return (total / max(wsum, 1e-9)) + grad_term


_VGG_SLICES = ((0, 4), (4, 9), (9, 16), (16, 23), (23, 30))  # relu1_2..relu5_3
# channel widths of the five LPIPS-vgg blocks (linear-head vector lengths)
_VGG_WIDTHS = (64, 128, 256, 512, 512)


def load_lpips_weights(path: str):
    """Load the LPIPS v0.1 learned linear-head weights.

    Accepts either (a) an .npz with arrays ``lin0``..``lin4`` of lengths
    (64, 128, 256, 512, 512), or (b) the official richzhang/PerceptualSimilarity
    ``vgg.pth`` torch checkpoint (keys ``lin{i}.model.1.weight`` of shape
    [1, C, 1, 1]). Returns a list of five 1-D float32 numpy arrays.

    The weights themselves cannot ship with this offline image (zero
    egress; the reference's lpipsPyTorch also downloads them at runtime) —
    point ``EOGS2_LPIPS_WEIGHTS`` at either file to get metric-exact LPIPS
    (lpipsPyTorch/modules/lpips.py parity).
    """
    if path.endswith(".npz"):
        z = np.load(path)
        lins = [np.asarray(z[f"lin{i}"], np.float32).reshape(-1)
                for i in range(5)]
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
        lins = [
            np.asarray(
                sd[f"lin{i}.model.1.weight"], np.float32
            ).reshape(-1)
            for i in range(5)
        ]
    for lin, width in zip(lins, _VGG_WIDTHS):
        if lin.shape != (width,):
            raise ValueError(
                f"linear head shape {lin.shape} != ({width},)"
            )
    return lins


def _vgg16_features():
    """torchvision's VGG16 `features` with its ImageNet weights, from
    torch's hub cache only. Raises ImportError without torchvision and
    FileNotFoundError when the weights are not cached (nothing is
    downloaded)."""
    from torchvision.models import VGG16_Weights, vgg16

    weights = VGG16_Weights.IMAGENET1K_V1
    cached = os.path.join(torch.hub.get_dir(), "checkpoints",
                          os.path.basename(weights.url))
    if not os.path.exists(cached):
        raise FileNotFoundError(
            f"VGG16's ImageNet weights are not in {cached}")
    return vgg16(weights=weights).features.eval()


def lpips_torch(a, b, net=None, lin_weights=None):
    """LPIPS-vgg perceptual distance via torchvision VGG16 features.

    Matches the reference's lpipsPyTorch math (lpipsPyTorch/modules/
    lpips.py): ImageNet-normalize, run the 5 VGG16 conv blocks,
    unit-normalize activations along channels, square the difference,
    apply the per-channel learned linear head (a 1x1 conv), spatially
    average, and SUM over blocks.

    `lin_weights` (five 1-D arrays, see load_lpips_weights) selects the
    CALIBRATED path — bit-matching the reference given the same VGG
    backbone. When None, block outputs are averaged with unit weights
    (uncalibrated; the learned heads are not shipped with torchvision).

    `net` (a torchvision `vgg16(...).features`-style module) may be
    injected — tests exercise the pipeline with seeded random weights; the
    images go to the device of its parameters. When omitted, requires
    torchvision + locally cached VGG16_Weights.IMAGENET1K_V1 (neither
    machine the port runs on has them — callers fall back to
    perceptual_distance; see compute_metrics). Raises ImportError /
    FileNotFoundError when unavailable.
    """
    if net is None:
        net = _vgg16_features()
    dev = next(net.parameters()).device
    mean = torch.tensor([0.485, 0.456, 0.406], device=dev).view(1, 3, 1, 1)
    std = torch.tensor([0.229, 0.224, 0.225], device=dev).view(1, 3, 1, 1)

    def feats(x):
        x = torch.as_tensor(np.asarray(x, np.float32), device=dev)[None, :3]
        x = (x - mean) / std
        out = []
        for lo, hi in _VGG_SLICES:
            for layer in net[lo:hi]:
                x = layer(x)
            out.append(x / (x.norm(dim=1, keepdim=True) + 1e-10))
        return out

    with torch.no_grad():
        diffs = [
            (fa - fb) ** 2 for fa, fb in zip(feats(a), feats(b))
        ]
        if lin_weights is not None:
            # calibrated: per-channel weighted sum (the learned 1x1 conv),
            # spatial mean, sum over blocks — exactly the reference chain
            total = sum(
                float(
                    (torch.as_tensor(np.asarray(w, np.float32), device=dev)
                     .view(1, -1, 1, 1) * d).sum(1).mean()
                )
                for w, d in zip(lin_weights, diffs)
            )
            return total
        total = sum(float(d.sum(1).mean()) for d in diffs)
    return total / len(_VGG_SLICES)


def compute_metrics(render_dir: str, gt_dir: str, device=None):
    from eogs2_tpu_torch.ops.ssim import psnr, ssim

    dev = resolve_device(device)
    renders = _load_dir(render_dir)
    gts = _load_dir(gt_dir)
    rows = []
    # calibrated LPIPS when the official weights are pointed at via env
    # (EOGS2_LPIPS_WEIGHTS=<vgg.pth or .npz>, see load_lpips_weights)
    lins = None
    wpath = os.environ.get("EOGS2_LPIPS_WEIGHTS", "")
    if wpath and os.path.exists(wpath):
        try:
            lins = load_lpips_weights(wpath)
        except (OSError, KeyError, ValueError) as e:
            print(f"metrics: LPIPS heads not loaded from {wpath}: {e}",
                  file=sys.stderr)
    net, why = None, None
    measures = {}  # the perceptual measure computed -> its image count
    for name, r in renders.items():
        if name not in gts:
            continue
        g = gts[name]
        c = min(r.shape[0], g.shape[0])
        h = min(r.shape[1], g.shape[1])
        w = min(r.shape[2], g.shape[2])
        r2, g2 = r[:c, :h, :w], g[:c, :h, :w]
        if c >= 3 and why is None and net is None:
            try:
                net = _vgg16_features().to(dev)
            except (ImportError, FileNotFoundError) as e:
                why = str(e)  # torchvision/weights absent: proxy for all
        if c >= 3 and net is not None:
            perceptual = lpips_torch(r2, g2, net=net, lin_weights=lins)
            measure = ("LPIPS-vgg" if lins is not None else "LPIPS-vgg "
                       "without its learned heads (EOGS2_LPIPS_WEIGHTS unset)")
        else:
            perceptual = perceptual_distance(r2, g2, device=dev)
            measure = ("the weight-free proxy perceptual_distance (multi-"
                       "scale SSIM + gradient L1), not LPIPS: " + (
                           why if c >= 3 else "fewer than 3 channels"))
        measures[measure] = measures.get(measure, 0) + 1
        tr = torch.as_tensor(r2, device=dev)
        tg = torch.as_tensor(g2, device=dev)
        rows.append(
            {
                "name": name,
                "psnr": float(psnr(tr, tg)),
                "ssim": float(ssim(tr, tg)),
                "perceptual": perceptual,
            }
        )
    for measure, n in measures.items():
        print(f"metrics: perceptual = {measure} ({n} of {len(rows)} images)",
              file=sys.stderr)
    summary = {
        k: float(np.mean([r[k] for r in rows])) if rows else float("nan")
        for k in ("psnr", "ssim", "perceptual")
    }
    return {"per_image": rows, "mean": summary}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--renders", required=True)
    p.add_argument("--gt", required=True)
    p.add_argument("--out", default="")
    p.add_argument("--device", default=None,
                   help="torch device (default: CUDA; raises without a "
                        "CUDA device), e.g. cpu")
    args = p.parse_args(argv)
    res = compute_metrics(args.renders, args.gt,
                          device=resolve_device(args.device))
    print(json.dumps(res["mean"]))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
