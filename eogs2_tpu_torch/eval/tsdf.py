"""TSDF multi-view depth fusion + DSM extraction, on the card.

Counterpart of ``eogs2_tpu/eval/tsdf.py``; parity target the reference's
``tsdf.py`` (RangeImageEOGS + TSDFVolume):
  * per-view slanted altitude map -> SDF sampler along the view direction
    (tsdf.py:325-368), with surface normals from robust one-sided finite
    differences on 5x5 windows (tsdf.py:243-320) and weights =
    cos(view, normal) clamped to [0,1];
  * weighted running-average TSDF integration (tsdf.py:459-520);
  * priors: floor occupied, isolated-voxel removal by a 3^3 box count,
    fill-below-surface (tsdf.py:602-637);
  * DSM extraction: highest tsdf<0 voxel per column -> flatten
    (tsdf.py:530-600).

Plain PyTorch over a fixed [Nx,Ny,Nz] voxel grid in float32 (the TSDF has
no hand-written kernel in either package). Integration walks the flat voxel
axis in slabs of ``slab_voxels`` and runs every view over each slab. Every
3x3 product, cross product and norm is written out as single elementwise
operations in a fixed order, so a voxel's value does not depend on how many
voxels share the call: one slab and many give the same bits. The weight
images (finite differences of positions a pixel apart, which magnify an
ulp of the positions about a thousandfold at 1024^2) get the same bits on
the CPU and on the card: the 3x3 inverses are taken in float32 on the
host (torch.linalg.inv differs by device), once per view and fusion, and
no division is by a Python number (CUDA multiplies by its reciprocal
there).

Several devices: with ``mesh=`` (parallel.mesh.make_mesh; the CLI's
``--n-devices`` or ``--coordinator``) each slab's flat voxel axis is split
over the mesh's ranks, padded to a rank multiple with neutral rows (tsdf 1,
weight 0), and the parts are all_gathered: the numbers are the unsharded
ones, bit for bit (a voxel's value does not depend on its neighbours in the
call), as JAX's sharded integration gives its single-chip ones.

NOTE the reference uses a pixel-center UV convention here —
(idx + 0.5)/size * 2 - 1 — that differs from the rasterizer's ndc2Pix; we
reproduce it faithfully (tsdf.py:247-253).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from eogs2_tpu_torch.device import resolve_device
from eogs2_tpu_torch.ops.resample import grid_sample


class TsdfViews(NamedTuple):
    """Stacked per-view data ([V, ...])."""

    coefs: torch.Tensor  # [V,3,3]
    inters: torch.Tensor  # [V,3]
    altitudes: torch.Tensor  # [V,H,W]


def _apply3(m, x):
    """x @ m.T for [..., 3] x and a 3x3 m, one multiply-add chain per
    output component."""
    return torch.stack([x[..., 0] * m[j, 0] + x[..., 1] * m[j, 1]
                        + x[..., 2] * m[j, 2] for j in range(3)], dim=-1)


def _norm3(x):
    """Euclidean norm over the last axis of [..., 3]."""
    return torch.sqrt(x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1]
                      + x[..., 2] * x[..., 2])


def _cross3(a, b):
    """Cross product over the last axis of [..., 3]."""
    return torch.stack([a[..., (j + 1) % 3] * b[..., (j + 2) % 3]
                        - a[..., (j + 2) % 3] * b[..., (j + 1) % 3]
                        for j in range(3)], dim=-1)


def _div(x, s):
    """x / s for a Python number s, as a true division on every device."""
    return x / torch.tensor(s, dtype=x.dtype, device=x.device)


def _inv3(m):
    """Inverse of a float32 3x3 (or of each in a [V,3,3] stack), taken in
    float32 on the host so that every device gets the same bits."""
    return torch.linalg.inv(m.detach().cpu()).to(m.device)


def _view_world_positions(coef, inter, altitude, ainv=None):
    """World position of each pixel's surface (tsdf.py:243-258 convention).
    ``ainv`` is inv(coef) where the caller has it."""
    h, w = altitude.shape
    f32 = np.float32

    def centres(n):  # float32 (idx + 0.5) / n * 2 - 1, as JAX computes it
        c = (np.arange(n, dtype=f32) + f32(0.5)) / f32(n) * f32(2) - f32(1)
        return torch.as_tensor(c, device=altitude.device)

    u, v = centres(w), centres(h)
    # reference meshgrid is (U, V) with indexing "ij" over (width, height),
    # then transposes altitude; equivalently build [H, W] directly:
    view = torch.stack([u[None, :].expand(h, w), v[:, None].expand(h, w),
                        altitude], dim=-1)  # [H,W,3]
    if ainv is None:
        ainv = _inv3(coef)
    return _apply3(ainv, view - inter)  # [H,W,3]


def _robust_one_sided(line):
    """Robust one-sided finite difference from the five [H,W,3] samples of
    a 5-tap line through each pixel (tsdf.py:272-305)."""
    center = line[2]
    pred_left = line[0] + 2.0 * (line[1] - line[0])
    pred_right = line[4] + 2.0 * (line[3] - line[4])
    err_l = _norm3(pred_left - center)
    err_r = _norm3(pred_right - center)
    d_l = (center - line[0]) * 0.5
    d_r = (line[4] - center) * 0.5
    return torch.where((err_l < err_r)[..., None], d_l, d_r)


def reconstruct_normals(coef, inter, altitude, ainv=None):
    """[H,W,3] unit surface normals + [H,W] cos-angle weights.

    The 5x5 window around each pixel (zero padded by 2, as F.unfold pads)
    enters only through its centre row and centre column, which are taken
    as slices of the padded positions instead of JAX's [H,W,3,5,5] stack.
    ``ainv`` is inv(coef) where the caller has it."""
    if ainv is None:
        ainv = _inv3(coef)
    pos = _view_world_positions(coef, inter, altitude, ainv)  # [H,W,3]
    h, w, _ = pos.shape
    padded = F.pad(pos, (0, 0, 2, 2, 2, 2))  # zero pad (F.unfold pads 0)
    dx = _robust_one_sided([padded[2:2 + h, k:k + w] for k in range(5)])
    dy = _robust_one_sided([padded[k:k + h, 2:2 + w] for k in range(5)])
    n = _cross3(dx, dy)
    n = n / torch.clamp_min(_norm3(n), 1e-6)[..., None]
    view_dir = ainv[:, 2]  # solve(coef, e_z)
    view_dir = view_dir / torch.clamp_min(_norm3(view_dir), 1e-6)
    cosang = (n[..., 0] * -view_dir[0] + n[..., 1] * -view_dir[1]
              + n[..., 2] * -view_dir[2])
    return n, torch.clamp(cosang, 0.0, 1.0)


def sample_sdf(coef, inter, altitude, weights_img, world_pts, model_scale,
               ainv=None):
    """(sdf [N], valid [N], weights [N]) — tsdf.py:325-368. ``ainv`` is
    inv(coef) where the caller has it."""
    pts = _div(world_pts, model_scale)
    view = _apply3(coef, pts) + inter  # [N,3]
    feats = torch.stack([altitude, weights_img], dim=0)  # [2,H,W]
    samp = grid_sample(feats, view[None, :, :2], align_corners=True)[:, 0]
    alt_s, w_s = samp[0], samp[1]
    valid = torch.all(torch.abs(view[:, :2]) <= 1.0, dim=1)
    view_new = torch.stack([view[:, 0], view[:, 1], alt_s], dim=1)
    if ainv is None:
        ainv = _inv3(coef)
    world_new = _apply3(ainv, view_new - inter)
    dist = _norm3(world_new - pts)
    sdf = dist * torch.sign(view[:, 2] - alt_s) * model_scale
    return sdf, valid, w_s


class TSDFVolume:
    def __init__(self, vol_bounds: np.ndarray, vox_size: float,
                 trunc_margin_fact: float, mesh=None,
                 slab_voxels: int = 1 << 22, device=None):
        """vol_bounds [3,2] in meters (already scaled).

        ``slab_voxels`` bounds peak memory: integration walks the flat
        voxel axis in slabs of this many voxels (the last one shorter), so
        the transient [N]-sized sample_sdf tensors are O(slab) instead of
        O(Nvox). ``mesh`` (a DeviceMesh over the process group) splits
        each slab's voxels over its ranks (module docstring)."""
        self.mesh = mesh
        self.device = resolve_device(device)
        self.vox_size = float(vox_size)
        self.trunc = trunc_margin_fact * vox_size
        self.slab_voxels = int(slab_voxels)
        vb = np.asarray(vol_bounds, np.float64)
        nvox = np.ceil((vb[:, 1] - vb[:, 0]) // vox_size + 1).astype(int)
        self.shape = tuple(int(x) for x in nvox)
        starts = vb[:, 0]
        ends = vb[:, 0] + nvox * vox_size
        self.axes = [
            np.linspace(starts[i], ends[i], self.shape[i]) for i in range(3)
        ]
        # JAX casts the float64 meshgrid to float32; each coordinate is the
        # float32 of its axis value, so the grid is built on the device from
        # the float32 axes with the same bits
        grids = torch.meshgrid(
            *(torch.as_tensor(a.astype(np.float32), device=self.device)
              for a in self.axes), indexing="ij")
        self.world_coords = torch.stack(grids, dim=-1).reshape(-1, 3)
        del grids
        self.tsdf = torch.ones(self.shape, dtype=torch.float32,
                               device=self.device)
        self.weight = torch.zeros(self.shape, dtype=torch.float32,
                                  device=self.device)

    def integrate_views(self, views: TsdfViews, model_scale: float):
        """Integration of all views, slab-chunked over the flat voxel axis.

        Per-view cos-angle weight images are computed ONCE up front (they
        depend only on the altitude maps, not on the voxels), then each
        slab of ``slab_voxels`` voxels runs the full view loop — the
        per-voxel op sequence does not depend on the slab, so results are
        exact, with peak memory O(slab)."""
        n = self.world_coords.shape[0]
        tsdf_f = self.tsdf.reshape(-1).clone()
        weight_f = self.weight.reshape(-1).clone()
        ainvs = _inv3(views.coefs)  # [V,3,3], once per fusion
        w_imgs = _view_weights(views, ainvs)  # [V,H,W]
        slab = max(1, min(self.slab_voxels, n))
        for lo in range(0, n, slab):
            hi = min(lo + slab, n)
            tsdf_f[lo:hi], weight_f[lo:hi] = self._integrate_part(
                views, ainvs, w_imgs, self.world_coords[lo:hi], tsdf_f[lo:hi],
                weight_f[lo:hi], float(model_scale))
        self.tsdf = tsdf_f.reshape(self.shape)
        self.weight = weight_f.reshape(self.shape)

    def _integrate_part(self, views, ainvs, w_imgs, wc, t, w, model_scale):
        """_integrate_slab of one slab, its voxels split over the mesh's
        ranks: each integrates its contiguous part (the slab padded with
        neutral rows to a rank multiple) and the parts are gathered."""
        if self.mesh is None:
            return _integrate_slab(views, ainvs, w_imgs, wc, t, w,
                                   model_scale, self.trunc)
        import torch.distributed as dist

        from eogs2_tpu_torch.parallel.distributed import all_gather_cat

        group = self.mesh.get_group() if self.mesh.ndim == 1 \
            else dist.group.WORLD
        ranks, rank = dist.get_world_size(group), dist.get_rank(group)
        m = t.shape[0]
        pad = (-m) % ranks
        if pad:
            t = torch.cat([t, t.new_ones(pad)])
            w = torch.cat([w, w.new_zeros(pad)])
            wc = torch.cat([wc, wc[-1:].expand(pad, 3)])
        k = (m + pad) // ranks
        part = slice(rank * k, (rank + 1) * k)
        t_p, w_p = _integrate_slab(views, ainvs, w_imgs, wc[part], t[part],
                                   w[part], model_scale, self.trunc)
        return (all_gather_cat(t_p, group)[:m],
                all_gather_cat(w_p, group)[:m])

    def apply_prior(self):
        self.tsdf, self.weight = _apply_prior(self.tsdf, self.weight)

    def extract_mesh(self, world_coords: bool = True):
        """(vertices, faces) of the level-0 TSDF isosurface
        (tsdf.py:520-528; marching tetrahedra instead of mcubes), on the
        host."""
        from eogs2_tpu_torch.eval.mesh import marching_tetrahedra

        return marching_tetrahedra(
            self.tsdf.cpu().numpy(), 0.0,
            axes=self.axes if world_coords else None,
        )

    def extract_dsm_points(self):
        """[Nx*Ny, 3] cloud of (x, y, z_surface) in volume coordinates
        (float64; z is the float32 axis value, as in JAX)."""
        idx = torch.arange(self.shape[-1], device=self.device)
        v2 = (self.tsdf < 0) * idx
        indices = torch.argmax(v2, dim=-1)  # 0 for a column with none
        z = torch.as_tensor(self.axes[-1].astype(np.float32),
                            device=self.device)[indices]
        xg, yg = np.meshgrid(self.axes[0], self.axes[1], indexing="ij")
        cloud = np.stack(
            [xg.reshape(-1), yg.reshape(-1), z.cpu().numpy().reshape(-1)],
            axis=1)
        return cloud


def _view_weights(views, ainvs=None):
    """[V,H,W] cos-angle weight images, one reconstruct_normals per view.

    Computed once per fusion instead of per (view x slab), one view at a
    time. ``ainvs`` is the [V,3,3] stack of the coefs' inverses where the
    caller has it."""
    if ainvs is None:
        ainvs = _inv3(views.coefs)
    return torch.stack([
        reconstruct_normals(c, i, a, ai)[1]
        for c, i, a, ai in zip(views.coefs, views.inters, views.altitudes,
                               ainvs)])


def _integrate_view(coef, inter, altitude, ainv, w_img, world_coords, tsdf,
                    weight, model_scale, trunc):
    sdf, valid, w_s = sample_sdf(coef, inter, altitude, w_img, world_coords,
                                 model_scale, ainv)
    mask = valid & (sdf >= -trunc)
    tval = torch.clamp_max(_div(sdf, trunc), 1.0)
    w_new = weight + torch.where(mask, w_s, 0.0)
    t_new = torch.where(
        mask & (w_new > 0),
        (weight * tsdf + w_s * tval) / torch.clamp_min(w_new, 1e-12),
        tsdf,
    )
    return t_new, w_new


def _integrate_slab(views, ainvs, w_imgs, world_coords, tsdf, weight,
                    model_scale, trunc):
    """Weighted running-average TSDF update of one voxel slab over ALL
    views (tsdf.py:459-520 semantics), the views in order."""
    for i in range(views.coefs.shape[0]):
        tsdf, weight = _integrate_view(
            views.coefs[i], views.inters[i], views.altitudes[i], ainvs[i],
            w_imgs[i], world_coords, tsdf, weight, model_scale, trunc,
        )
    return tsdf, weight


def _apply_prior(tsdf, weight):
    untouched = (weight == 0) & (tsdf == 1.0)
    # floor occupied
    tsdf = tsdf.clone()
    weight = weight.clone()
    tsdf[:, :, 0] = -1.0
    weight[:, :, 0] = 1.0
    occ = tsdf <= 0
    # remove isolated occupied voxels (3^3 neighborhood count == 1): a
    # 'SAME' zero-padded box sum of the occupancy (exact in float32; the
    # rounding only guards a convolution algorithm that is not)
    k = torch.ones((1, 1, 3, 3, 3), dtype=torch.float32, device=tsdf.device)
    occ_conv = F.conv3d(occ[None, None].to(torch.float32), k, padding=1)[0, 0]
    isolated = (torch.round(occ_conv) == 1) & occ
    del occ_conv
    tsdf = torch.where(isolated, 1.0, tsdf)
    weight = torch.where(isolated, 0.0, weight)
    # fill below surface
    occ = tsdf <= 0
    idx = torch.arange(tsdf.shape[-1], device=tsdf.device)
    top = torch.argmax(occ * idx, dim=-1)  # [Nx,Ny] highest occupied index
    fill = (idx[None, None, :] < top[:, :, None]) & untouched
    tsdf = torch.where(fill, -1.0, tsdf)
    weight = torch.where(fill, 1.0, weight)
    return tsdf, weight


def run_tsdf(
    scene_dir: str,
    altitude_maps: dict,
    model_scale: float,
    min_world,
    max_world,
    scene_shift,
    vox_size: float = 0.5,
    trunc_margin_fact: float = 4.0,
    resolution: float = 0.5,
    export_mesh_path: str | None = None,
    mesh=None,
    device=None,
):
    """Full TSDF pipeline on in-memory altitude maps {view_name: (coef,
    inter, altitude[H,W])}. Returns (profile, dsm). ``mesh`` shards the
    integration (TSDFVolume); the mesh file is written by the coordinator
    only."""
    from eogs2_tpu_torch.eval.dsm import flatten_cloud
    from eogs2_tpu_torch.io.geotiff import Affine

    vol_bounds = np.stack([np.asarray(min_world), np.asarray(max_world)], axis=1)
    vol_bounds = vol_bounds * model_scale
    vol = TSDFVolume(vol_bounds, vox_size, trunc_margin_fact, mesh=mesh,
                     device=device)
    coefs, inters, alts = [], [], []
    for name, (coef, inter, alt) in altitude_maps.items():
        coefs.append(coef)
        inters.append(inter)
        alts.append(alt)

    def stacked(arrays):
        return torch.as_tensor(np.stack(arrays).astype(np.float32),
                               device=vol.device)

    views = TsdfViews(coefs=stacked(coefs), inters=stacked(inters),
                      altitudes=stacked(alts))
    vol.integrate_views(views, model_scale)
    vol.apply_prior()
    from eogs2_tpu_torch.parallel.distributed import is_coordinator

    if export_mesh_path and is_coordinator():
        from eogs2_tpu_torch.eval.mesh import export_obj

        verts, faces = vol.extract_mesh()
        export_obj(export_mesh_path, verts, faces)
    cloud = vol.extract_dsm_points()
    cloud = cloud + np.asarray(scene_shift)

    xmin, xmax = cloud[:, 0].min(), cloud[:, 0].max()
    ymin, ymax = cloud[:, 1].min(), cloud[:, 1].max()
    xoff = np.floor(xmin / resolution) * resolution
    xsize = int(1 + np.floor((xmax - xoff) / resolution))
    yoff = np.ceil(ymax / resolution) * resolution
    ysize = int(1 - np.floor((ymin - yoff) / resolution))
    dsm = flatten_cloud(cloud, xoff, yoff, resolution, xsize, ysize, radius=1)
    profile = {
        "height": dsm.shape[0],
        "width": dsm.shape[1],
        "transform": Affine.from_origin(xoff, yoff, resolution, resolution),
    }
    return profile, dsm


def run_tsdf_cli(args):
    """CLI: read rendered altitude maps from the model dir, fuse, evaluate."""
    import json
    import os

    from eogs2_tpu_torch.io.geotiff import read_geotiff, write_geotiff
    from eogs2_tpu_torch.scene import load_scene

    from eogs2_tpu_torch.parallel.distributed import is_coordinator

    scene = load_scene(
        args.scene_dir,
        images_msi_path=args.images_msi or os.path.join(args.scene_dir, "images"),
        images_pan_path=args.images_pan or os.path.join(args.scene_dir, "images"),
        eval_split=True,
        load_pan=False,
        device=args.device,
    )
    pc_root = os.path.join(args.model_path, "point_cloud")
    it = max(int(d.split("_")[-1]) for d in os.listdir(pc_root)) \
        if args.iteration == -1 else args.iteration
    alt_dir = os.path.join(args.model_path, "train_opNone", f"ours_{it}", "altitude")
    with open(os.path.join(args.scene_dir, "affine_models.json")) as f:
        metas = json.load(f)
    if isinstance(metas, dict):
        metas = metas.get("pan", next(iter(metas.values())))
    md0 = metas[0]["model"]
    maps = {}
    for v in scene.train_views:
        p = os.path.join(alt_dir, v.name + ".tif")
        if not os.path.exists(p):
            continue
        alt, _ = read_geotiff(p)
        affine = v.camera.affine.detach().cpu().numpy()
        maps[v.name] = (affine[:, :3], affine[:, 3],
                        np.asarray(alt, np.float32))
    if not maps:
        raise FileNotFoundError(f"no altitude maps found in {alt_dir}")
    out_dir = os.path.join(args.model_path, "test_opNone", f"ours_{it}", "tsdf")
    os.makedirs(out_dir, exist_ok=True)
    mesh_path = (
        os.path.join(out_dir, "output_mesh.obj")
        if getattr(args, "export_mesh", False) else None
    )
    profile, dsm = run_tsdf(
        args.scene_dir, maps, md0["scale"], md0["min_world"], md0["max_world"],
        md0["center"], vox_size=args.vox_size,
        trunc_margin_fact=args.trunc_margin_fact,
        resolution=0.3 if "IARPA" in args.scene_dir else 0.5,
        export_mesh_path=mesh_path,
        mesh=getattr(args, "mesh", None),
        device=args.device,
    )
    if is_coordinator():  # in a process group, rank 0 writes
        write_geotiff(os.path.join(out_dir, "dsm.tif"),
                      dsm.astype(np.float32), transform=profile["transform"])
        print(f"tsdf dsm written to {out_dir}/dsm.tif")
    return 0
