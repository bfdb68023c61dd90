"""Inference pipeline: full per-view rendering, the Nadir DSM and its MAE.

Counterpart of ``eogs2_tpu/pipeline.py``; parity targets
``render_all_views`` (renderer_cc_shadow.py:148-193) and the test-iteration
DSM hook of train_pan.py:738-797 (render the Nadir test camera, build the
DSM, register against GT, report MAE). Everything renders under
``torch.no_grad()`` on the model's device; the DSM flatten, the
registration and the MAE run on the host in float64, as in JAX. On the
card a view's outputs reach the host through :class:`HostSlots`.
"""

from __future__ import annotations

import mmap
import threading
import weakref
from typing import Callable, Optional

import numpy as np
import torch

from eogs2_tpu_torch.cameras import AffineCamera
from eogs2_tpu_torch.eval.dsm import compute_dsm_from_view
from eogs2_tpu_torch.eval.mae import MaeComputer
from eogs2_tpu_torch.model import GaussianModel
from eogs2_tpu_torch.observability import host_read, span, tracer
from eogs2_tpu_torch.ops.projection import TILE
from eogs2_tpu_torch.ops.resample import grid_sample
from eogs2_tpu_torch.ops.sh import SH2RGB
from eogs2_tpu_torch.rasterizer import RasterizeConfig, rasterize
from eogs2_tpu_torch.scene import SceneData
from eogs2_tpu_torch.shading import CameraShadingParams, render_pipeline


def _pad16(x):
    return ((x + TILE - 1) // TILE) * TILE


def _np(x):
    if x is None:
        return None
    return host_read(lambda: x.detach().cpu().numpy(), "serve.to_host")


# The page-locked host bytes that the copy-out's slots hold at most; past
# it a request takes one blocking copy an output, as on the CPU.
HOST_SLOT_CAP = 1 << 30
_ALIGN = 256  # of each output's offset in a slot


def page_locked(nbytes: int) -> torch.Tensor:
    """``nbytes`` (a whole number of pages) of host memory as a uint8
    tensor, page-locked for the card (``cudaHostRegister``) until the
    tensor is freed. The locked range starts and ends on a page of its
    own, so no two slots lock one page."""
    t = torch.empty(nbytes + mmap.PAGESIZE, dtype=torch.uint8)
    off = -t.data_ptr() % mmap.PAGESIZE
    slot = t[off:off + nbytes]
    rt = torch.cuda.cudart()
    torch.cuda.check_error(rt.cudaHostRegister(slot.data_ptr(), nbytes, 0))
    weakref.finalize(slot, rt.cudaHostUnregister, slot.data_ptr())
    return slot


class HostSlots:
    """Host slots that a request's outputs are copied into, each output in
    its own region of one slot, with one wait for all the copies; the
    outputs come back as numpy views of the slot.

    A slot is used again only once no array handed out from it, nor any
    view of one, is alive: every output is made on one array of the slot,
    made anew for the request, and numpy collapses the base of any view of
    an output to that array (the first whose base is not an array), which
    the slot watches by a weak reference. A caller that keeps its outputs
    keeps its slot, and the next request takes another.

    Slots are a power of two bytes (at least a page) from ``alloc``, and
    hold at most ``cap`` bytes together: a new slot drops free ones too
    small for the request, smallest first, to make room, and a request
    with no room is not copied (:meth:`copy_out` returns None)."""

    def __init__(self, alloc: Callable[[int], torch.Tensor],
                 cap: int = HOST_SLOT_CAP):
        self.alloc, self.cap = alloc, cap
        self._slots = []  # [uint8 tensor, weak reference to its array]
        self._lock = threading.Lock()

    def _take(self, nbytes: int):
        """(a new array of a free slot, "reused" or "new"), or None when
        the cap leaves no room."""
        with self._lock:
            free = sorted((s for s in self._slots if s[1]() is None),
                          key=lambda s: s[0].numel())
            fit = [s for s in free if s[0].numel() >= nbytes]
            if fit:
                slot, how = fit[0], "reused"
            else:
                size = max(1 << (nbytes - 1).bit_length(), mmap.PAGESIZE)
                held = sum(s[0].numel() for s in self._slots)
                if held - sum(s[0].numel() for s in free) + size > self.cap:
                    return None
                for s in free:
                    if held + size <= self.cap:
                        break
                    self._slots.remove(s)
                    held -= s[0].numel()
                slot, how = [self.alloc(size), None], "new"
                self._slots.append(slot)
            arr = slot[0].numpy()
            slot[1] = weakref.ref(arr)
            return arr, how

    def copy_out(self, outs: dict) -> Optional[dict]:
        """{key: numpy array} of the tensors ``outs`` (None stays None),
        copied into one slot, each by a non-blocking copy, then one wait
        (a ``host_read`` at ``serve.to_host``); None when the cap leaves no
        room. Counts the request's copy-out as ``serve.slot.reused``,
        ``serve.slot.new`` or ``serve.slot.fallback``."""
        offs, end = {}, 0
        for k, x in outs.items():
            if x is not None:
                offs[k] = end
                end += -(-x.numel() * x.element_size() // _ALIGN) * _ALIGN
        got = self._take(max(end, 1))
        tracer.count("serve.slot." + (got[1] if got else "fallback"))
        if got is None:
            return None
        arr = got[0]
        host, dev = {}, torch.device("cpu")
        for k, x in outs.items():
            if x is None:
                host[k] = None
                continue
            dtype = torch.empty(0, dtype=x.dtype).numpy().dtype
            host[k] = np.ndarray(tuple(x.shape), dtype, buffer=arr,
                                 offset=offs[k])
            torch.from_numpy(host[k]).copy_(x.detach(), non_blocking=True)
            dev = x.device

        def wait():  # for every copy; on the host they have run already
            if dev.type == "cuda":
                torch.cuda.current_stream(dev).synchronize()

        host_read(wait, "serve.to_host")
        return host


# the slots of render_view_full on the card
HOST_SLOTS = HostSlots(page_locked)


def to_host(outs: dict, hn: int, wn: int,
            slots: Optional[HostSlots] = None) -> dict:
    """The outputs ``outs`` of a view as numpy arrays cropped to ``hn`` x
    ``wn`` (``rendered_uva`` [H, W, 3], the rest [C, H, W] or [H, W]):
    through ``slots`` where given and under its cap, else by one blocking
    copy an output."""
    host = slots.copy_out(outs) if slots is not None else None
    if host is None:
        host = {k: _np(x) for k, x in outs.items()}
    return {k: None if x is None
            else x[:hn, :wn] if k == "rendered_uva" or x.ndim == 2
            else x[:, :hn, :wn]
            for k, x in host.items()}


@torch.no_grad()
@span("serve.request", unit=True)
def render_view_full(
    model: GaussianModel,
    camera: AffineCamera,
    raster_cfg: RasterizeConfig,
    shading: Optional[CameraShadingParams] = None,
    view_idx: int = 0,
    bg: Optional[np.ndarray] = None,
    with_sun: bool = True,
    use_cc: bool = True,
    use_shadow: bool = True,
    pan_mode: Optional[str] = None,
    weird_pan_setup: bool = False,
):
    """Full no-grad pipeline for one view: main render, sun render resampled
    onto the main camera, shading. Returns a dict of numpy arrays cropped to
    the camera's native size."""
    dev = model.xyz.device
    wn, hn = camera.width, camera.height
    wp, hp = _pad16(wn), _pad16(hn)
    if bg is None:
        alt0 = host_read(camera.altitude_bounds[0], "serve.bg_altitude")
        bg = np.array([1.0, 0.0, 1.0, float(alt0), 0.0], np.float32)
    bg = host_read(lambda: torch.tensor(np.asarray(bg, np.float32),
                                        device=dev), "serve.bg")

    rgb = SH2RGB(model.features_dc[:, 0, :])
    scaling = torch.exp(model.scaling)
    opacity = torch.sigmoid(model.opacity[:, 0])

    def raster(cam, vw, vh):
        alt = cam.ecef_to_uva(model.xyz)[:, 2:3]
        feats = torch.cat([rgb, alt, torch.ones_like(alt)], dim=-1)
        return rasterize(
            model.xyz, scaling, model.rotation, opacity, feats,
            cam.resize_canvas(vw, vh).affine, bg, vw, vh, raster_cfg,
            alive=model.alive,
        )

    out = raster(camera, wp, hp)
    raw = out.image[:3]
    altitude = out.image[3]
    acc = out.image[4]

    # native-convention UV grid extended over the padding (train.py's)
    u = (2.0 * torch.arange(wp, device=dev) / (wn - 1)) - 1.0
    v = (2.0 * torch.arange(hp, device=dev) / (hn - 1)) - 1.0
    vv, uu = torch.meshgrid(v, u, indexing="ij")
    rendered_uva = torch.stack([uu, vv, altitude], dim=-1)

    sun_altitude_diff = None
    if with_sun and camera.has_sun:
        sun_cam, cam2sun = camera.sun_camera(f=2)
        sout = raster(sun_cam, _pad16(sun_cam.width), _pad16(sun_cam.height))
        v_uv = torch.einsum("ij,hwj->hwi", cam2sun, rendered_uva)[..., :2]
        samp = grid_sample(sout.image[3:4], v_uv, align_corners=True)[0]
        samp = torch.where(torch.any(torch.abs(v_uv) > 1.0, dim=-1), -100.0,
                           samp)
        sun_altitude_diff = altitude - samp

    if shading is not None:
        with span("serve.shading"):
            shaded_out = render_pipeline(
                raw,
                sun_altitude_diff,
                shading.cc_weight[view_idx],
                shading.cc_bias[view_idx],
                shading.inshadow[view_idx],
                use_cc=use_cc,
                use_shadow=use_shadow,
                exposure=shading.exposure[view_idx],
                pan_mode=pan_mode,
                pan_weight=shading.msi_to_pan_weight[view_idx],
                pan_bias=shading.msi_to_pan_bias[view_idx],
                weird_pan_setup=weird_pan_setup,
            )
    else:
        shaded_out = {"shadowmap": None, "cc": raw, "shaded": raw, "final": raw}

    outs = {
        "raw_render": raw,
        "altitude": altitude,
        "acc_opacity": acc,
        "cc": shaded_out["cc"],
        "shaded": shaded_out["shaded"],
        "final": shaded_out["final"],
        "shadowmap": shaded_out["shadowmap"],
        "rendered_uva": rendered_uva,
    }
    with span("serve.to_host"):
        return to_host(outs, hn, wn,
                       HOST_SLOTS if dev.type == "cuda" else None)


def nadir_dsm(
    model: GaussianModel,
    scene: SceneData,
    raster_cfg: RasterizeConfig,
    resolution: Optional[float] = None,
    scene_name: str = "",
):
    """Render the Nadir test camera and flatten it into the DSM
    (train_pan.py:738-786). Returns (profile, dsm [H',W',1], render dict)."""
    nadir = [v for v in scene.test_views if "Nadir" in v.name]
    assert nadir, "scene has no Nadir test camera"
    cam = nadir[0].camera
    out = render_view_full(model, cam, raster_cfg, with_sun=False)
    profile, dsm = compute_dsm_from_view(
        cam,
        out["rendered_uva"],
        scene.scene_shift,
        scene.scene_scale,
        scene_name=scene_name,
        resolution=resolution,
    )
    return profile, dsm, out


def evaluate_dsm_mae(
    model: GaussianModel,
    scene: SceneData,
    mae_computer: MaeComputer,
    raster_cfg: RasterizeConfig,
    resolution: Optional[float] = None,
    scene_name: str = "",
):
    """The Nadir DSM (nadir_dsm: render on the model's device, flatten on
    the host) registered against the ground truth. Returns (mae, dsm
    [H',W',1], diff, registered dsm)."""
    profile, dsm, _ = nadir_dsm(model, scene, raster_cfg, resolution,
                                scene_name)
    mae, diff, rdsm = mae_computer.compute_mae(dsm[:, :, 0],
                                               profile["transform"])
    return mae, dsm, diff, rdsm
