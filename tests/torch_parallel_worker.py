"""Ranks of the port's multi-device tests: gloo process groups on the CPU.

``run(fn, n, tmp)`` starts ``n`` ranks with torch.multiprocessing.spawn,
each joining one gloo group through a ``file://`` rendezvous in ``tmp`` (no
port, so concurrent test workers never collide), calls ``fn(rank, n,
*args)`` and saves what it returns; ``run`` returns the ranks' results in
rank order. This module imports neither JAX nor eogs2_tpu, so the ranks
load only the port.
"""

from __future__ import annotations

import os

import numpy as np
import torch


def _entry(rank, n, tmp, fn, args):
    import torch.distributed as dist

    from eogs2_tpu_torch.parallel.distributed import init_distributed

    torch.set_num_threads(1)
    url = f"file://{tmp}/rendezvous"
    os.environ["EOGS2_TEST_RENDEZVOUS"] = url
    init_distributed(url, n, rank, device="cpu")
    try:
        out = fn(rank, n, *args)
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run(fn, n, tmp, *args):
    import torch.multiprocessing as mp

    tmp = str(tmp)
    os.makedirs(tmp, exist_ok=True)
    mp.spawn(_entry, args=(n, tmp, fn, args), nprocs=n)
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in range(n)]


# ---------------------------------------------------------------------------
# the rasterizer
# ---------------------------------------------------------------------------


def a2a_render(rank, n, arrays, width, height, cfg_kw, offset=False):
    """rasterize_a2a of this rank's shard and sharded_render's image; the
    gradients of sum(image[:3]^2) for means, opacity, affine and the NDC
    offset."""
    from eogs2_tpu_torch.parallel.mesh import make_mesh
    from eogs2_tpu_torch.parallel.sharded_raster import (rasterize_a2a,
                                                         sharded_render)
    from eogs2_tpu_torch.rasterizer import RasterizeConfig

    mesh = make_mesh(n)
    t = [torch.from_numpy(np.asarray(a)) for a in arrays]
    m = t[0].shape[0] // n
    part = slice(rank * m, (rank + 1) * m)
    means = t[0][part].clone().requires_grad_(True)
    opac = t[3][part].clone().requires_grad_(True)
    affine = t[5].clone().requires_grad_(True)
    off = torch.zeros((m, 2), requires_grad=True) if offset else None
    cfg = RasterizeConfig(**cfg_kw)
    out = rasterize_a2a(mesh, means, t[1][part], t[2][part], opac,
                        t[4][part], affine, t[6], width, height, cfg,
                        mean2d_ndc_offset=off)
    (out.image[:3] ** 2).sum().backward()
    img, stats = sharded_render(
        mesh, t[0][part], t[1][part], t[2][part], t[3][part], t[4][part],
        torch.ones(m, dtype=torch.bool), t[5], t[6], width, height,
        tcap=cfg.max_tiles_per_gaussian, dest_cap=cfg.dest_cap,
        tile_capacity=cfg.tile_capacity)
    return dict(
        image=out.image.detach(), final_t=out.final_t.detach(),
        render_image=img, render_stats=stats,
        g_means=means.grad, g_opac=opac.grad, g_affine=affine.grad,
        g_off=None if off is None else off.grad,
        radii=out.radii, mean2d_ndc=out.mean2d_ndc,
        num_pairs=int(out.num_pairs), max_tile_count=int(out.max_tile_count),
        max_dest_count=int(out.max_dest_count),
        dropped_pairs=int(out.dropped_pairs),
        max_tiles_per_gaussian_seen=int(out.max_tiles_per_gaussian_seen))


def a2a_dropped(rank, n, arrays, width, height, dest_cap):
    """A render whose windows overflow dest_cap: the reported drops against
    this rank's own count of its emission per band, and the gradient of
    each emitted pair (zero for the dropped ones)."""
    from eogs2_tpu_torch.ops.binning import grid_dims
    from eogs2_tpu_torch.ops.pair_pipeline import emit_pairs
    from eogs2_tpu_torch.ops.projection import (compute_cov2d_direct,
                                                preprocess_gaussians)
    from eogs2_tpu_torch.parallel import sharded_raster as sr
    from eogs2_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(n)
    t = [torch.from_numpy(np.asarray(a)) for a in arrays]
    m = t[0].shape[0] // n
    part = slice(rank * m, (rank + 1) * m)
    grabbed = {}
    orig = sr._A2ABlend.apply

    def spy(pay_em, tile_em, depth_em, s):
        pay_em.retain_grad()
        grabbed.update(pay=pay_em, tile=tile_em)
        return orig(pay_em, tile_em, depth_em, s)

    sr._A2ABlend.apply = spy
    try:
        out = sr.sharded_rasterize(
            mesh, t[0][part], t[1][part], t[2][part],
            t[3][part].clone().requires_grad_(True), t[4][part],
            torch.ones(m, dtype=torch.bool), t[5], t[6], width, height,
            tcap=64, dest_cap=dest_cap, tile_capacity=4096)
    finally:
        sr._A2ABlend.apply = orig
    (out["image"][:3] ** 2).sum().backward()
    gx, gy = grid_dims(width, height)
    cov2d = compute_cov2d_direct(t[1][part], t[2][part], t[5], width, height)
    prep = preprocess_gaussians(t[0][part], None, t[3][part], t[5], width,
                                height, cov2d=cov2d)
    tile = emit_pairs(prep, gx, tcap=64).tile
    tpb = -(-gy // n) * gx
    dest = torch.clamp_max(tile // tpb, n - 1)
    counts = torch.bincount(dest, minlength=n)
    # the position of each emitted pair within its window
    order = torch.sort(dest, stable=True)[1]
    slot = torch.empty_like(order)
    starts = torch.cumsum(counts, 0) - counts
    slot[order] = torch.arange(len(order)) - starts[dest[order]]
    return dict(dropped=int(out["dropped_pairs"]),
                own_drops=int((counts - dest_cap).clamp_min(0).sum()),
                g_pay=grabbed["pay"].grad, kept=slot < dest_cap)


# ---------------------------------------------------------------------------
# the TSDF, the mesh helpers
# ---------------------------------------------------------------------------


def tsdf(rank, n, coefs, inters, alts, bounds, vox, scale):
    """A sharded TSDFVolume's integration and prior."""
    from eogs2_tpu_torch.eval.tsdf import TSDFVolume, TsdfViews
    from eogs2_tpu_torch.parallel.mesh import make_mesh

    views = TsdfViews(coefs=torch.tensor(coefs), inters=torch.tensor(inters),
                      altitudes=torch.tensor(alts))
    vol = TSDFVolume(bounds, vox, 4.0, mesh=make_mesh(n), slab_voxels=997,
                     device="cpu")
    vol.integrate_views(views, scale)
    vol.apply_prior()
    return dict(tsdf=vol.tsdf, weight=vol.weight,
                voxels=int(np.prod(vol.shape)))


def mesh_helpers(rank, n):
    """make_mesh's axes and factoring, the Gaussian shard with its pad,
    make_global_array and all_processes_allclose."""
    from eogs2_tpu_torch.model import init_from_points
    from eogs2_tpu_torch.parallel.distributed import (
        all_processes_allclose, is_coordinator, make_global_array)
    from eogs2_tpu_torch.parallel.mesh import (axis_rank, axis_size,
                                               make_mesh, shard_gaussian_state)

    g = make_mesh(n)
    dg = make_mesh(n, axes=("d", "g"))
    rng = np.random.RandomState(3)
    model = init_from_points(rng.uniform(-1, 1, (10, 3)),
                             rng.uniform(0, 1, (10, 3)), capacity=10,
                             mean_knn_dist2=np.full(10, 0.01), device="cpu")
    opt = torch.optim.Adam([getattr(model, f) for f in
                            ("xyz", "features_dc", "features_rest",
                             "scaling", "rotation", "opacity")], lr=0.1)
    for p in opt.param_groups[0]["params"]:
        p.grad = torch.full_like(p, 0.5)
    opt.step()
    local, lopt = shard_gaussian_state(model, g, opt=opt)
    return dict(
        g=(tuple(g.mesh_dim_names), tuple(g.shape)),
        dg=(tuple(dg.mesh_dim_names), tuple(dg.shape)),
        dg_ranks=(axis_rank(dg, "d"), axis_rank(dg, "g"), axis_size(dg, "d")),
        xyz=local.xyz.detach(), alive=local.alive,
        rotation=local.rotation.detach(), scaling=local.scaling.detach(),
        exp_avg=lopt.state[local.xyz]["exp_avg"],
        step=float(lopt.state[local.xyz]["step"]),
        lr=lopt.param_groups[0]["lr"],
        part=make_global_array(torch.arange(4 * n), g, "g"),
        same=all_processes_allclose(torch.ones(3)),
        differs=all_processes_allclose(torch.full((3,), float(rank))),
        coordinator=is_coordinator())


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

SCENE_KW = dict(n_views=4, width=64, height=64, hf_res=128, n_buildings=4,
                seed=0, scale=12.0)


def trainer(n_iters, backend, mesh_axes, cfg_kw, raster_kw, device="cpu",
            mesh=None, probe=False):
    """A Trainer on the synthetic scene of SCENE_KW after n_iters
    iterations; with a mesh, the whole model joined."""
    from eogs2_tpu_torch.config import baseogs
    from eogs2_tpu_torch.data.synthetic import (make_scene_arrays,
                                                scene_from_arrays)
    from eogs2_tpu_torch.rasterizer import RasterizeConfig
    from eogs2_tpu_torch.train import Trainer

    scene = scene_from_arrays(make_scene_arrays(**SCENE_KW), device=device)
    cfg = baseogs(iterations=max(n_iters, 1))
    cfg.logging.tb_log_interval = 1
    for k, v in cfg_kw.items():
        obj = cfg.optimization
        *path, last = k.split(".")
        for p in path:
            obj = getattr(obj, p)
        setattr(obj, last, v)
    tr = Trainer(cfg, scene, RasterizeConfig(**raster_kw), device=device,
                 mesh=mesh, raster_backend=backend).setup()
    if probe:
        tr.probe_capacities()
    tr.train(n_iters, progress=False)
    return tr


def _report(tr):
    whole = tr.whole()
    grads = {f: getattr(tr.model, f).grad for f in
             ("xyz", "features_dc", "scaling", "rotation", "opacity")}
    return dict(
        params={f: getattr(whole.model, f).detach() for f in
                ("xyz", "features_dc", "scaling", "rotation", "opacity")},
        aux={f: getattr(whole.model, f) for f in
             ("alive", "max_radii2d", "xyz_gradient_accum", "denom")},
        moments={f: whole.gauss_opt.state[getattr(whole.model, f)]["exp_avg"]
                 for f in ("xyz", "opacity")},
        grads=grads, history=tr.metrics_history, raster_cfg=tr.raster_cfg,
        densify_log=tr.densify_log,
        shading_grad={k: getattr(tr.shading, k).grad for k in
                      ("cc_weight", "last_row", "exposure")})


def train_ranks(rank, n, n_iters, backend, axes, cfg_kw, raster_kw,
                probe=False, save_dir=None):
    """A sharded Trainer's state after n_iters iterations (the whole model,
    this rank's gradients); with save_dir, the coordinator's model save
    and checkpoint there."""
    from eogs2_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(n, axes=axes)
    tr = trainer(n_iters, backend, axes, cfg_kw, raster_kw, mesh=mesh,
                 probe=probe)
    out = _report(tr)
    if save_dir:
        import torch.distributed as dist

        tr.cfg.logging.model_path = save_dir
        tr.save_model(n_iters)
        path = os.path.join(save_dir, "chkpnt")
        tr.save_checkpoint(path, n_iters)
        dist.barrier()  # the coordinator's file is written
        fresh = trainer(0, backend, axes, cfg_kw, raster_kw, mesh=mesh)
        it = fresh.restore(path)
        back = _report(fresh)
        out["restored_equal"] = it == n_iters and fresh.step == tr.step and \
            all(torch.equal(back[k][f], out[k][f])
                for k in ("params", "aux", "moments") for f in out[k])
    return out


def grow_dest_cap(rank, n, dest_cap):
    """An a2a Trainer at a dest_cap too small: a step that drops pairs,
    the capacity check (which the loop runs every 50 iterations), a step
    after it."""
    from eogs2_tpu_torch.parallel.mesh import make_mesh

    tr = trainer(1, "a2a", ("g",), {}, dict(
        binning_mode="fused", dest_cap=dest_cap, tile_capacity=4096,
        max_tiles_per_gaussian=64), mesh=make_mesh(n))
    before = tr.metrics_history[-1]
    tr._grow_capacities(before)
    after = tr.train_step(2)
    return dict(dropped_before=before["dropped_pairs"],
                dest_cap=tr.raster_cfg.dest_cap,
                dropped_after=int(after["dropped_pairs"]),
                max_dest_after=int(after["max_dest_count"]))


def train_one(n_iters, backend, cfg_kw, raster_kw, probe=False):
    """The same on one device, no process group."""
    return _report(trainer(n_iters, backend, None, cfg_kw, raster_kw,
                           probe=probe))


def cli_rank(rank, n, argv):
    """cli.main(argv) as rank ``rank`` of the group this process is in,
    joined through the CLI's --coordinator flags (TensorBoard blocked)."""
    import sys

    from eogs2_tpu_torch import cli

    for mod in ("tensorboard", "torch.utils.tensorboard"):
        sys.modules[mod] = None
    return cli.main(list(argv) + [
        "--coordinator", os.environ["EOGS2_TEST_RENDEZVOUS"],
        "--num-processes", str(n), "--process-id", str(rank)])
