"""Isosurface triangle-mesh extraction + OBJ export, on the host.

Counterpart of ``eogs2_tpu/eval/mesh.py``, a numpy copy of it (a one-shot
export after TSDF fusion, as the port's ``eval/dsm.py`` is a host copy):
the same vertices, faces and OBJ bytes for the same volume. Parity target:
reference ``tsdf.py:520-528`` — ``mcubes.marching_cubes(tsdf_vol, 0)``
followed by ``mcubes.export_obj`` when ``export_mesh`` is set
(``tsdf.py:720,782``).

PyMCubes is not available offline, so the same zero-isosurface is extracted
with a self-contained **marching-tetrahedra** lattice: every voxel cell is
split into 6 tetrahedra around the main diagonal, and the 16-entry tet case
table is *derived in code* (no hand-typed 256x16 marching-cubes LUT to get
wrong).  The result is a crack-free closed triangle mesh of the same
surface, with outward-consistent winding.  Fully vectorized numpy.

Differences vs the reference (documented, deliberate):
  * triangulation pattern differs from classic marching cubes (more, smaller
    triangles across ambiguous cells) but represents the same isosurface;
  * vertices can be emitted in world coordinates (callers pass per-axis
    coordinate vectors); the reference exports raw voxel-index coordinates.
"""

from __future__ import annotations

import numpy as np

# Cube corner numbering (offsets in index space).
_CORNER_OFFSETS = np.array(
    [
        [0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
        [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1],
    ],
    np.int64,
)

# Six tetrahedra sharing the 0-6 main diagonal; consecutive tets share a
# face, so the decomposition (and hence the mesh) is crack-free.
_TET_CORNERS = np.array(
    [
        [0, 5, 1, 6],
        [0, 1, 2, 6],
        [0, 2, 3, 6],
        [0, 3, 7, 6],
        [0, 7, 4, 6],
        [0, 4, 5, 6],
    ],
    np.int64,
)


def _build_case_table():
    """For each of the 16 inside-masks of a tet's 4 vertices, the list of
    triangles; each triangle is 3 edges, each edge an (inside_vertex,
    outside_vertex) pair of tet-local vertex ids."""
    cases = []
    for case in range(16):
        inside = [v for v in range(4) if case >> v & 1]
        outside = [v for v in range(4) if not case >> v & 1]
        tris = []
        if len(inside) == 1:
            i = inside[0]
            e = [(i, j) for j in outside]
            tris = [(e[0], e[1], e[2])]
        elif len(inside) == 3:
            j = outside[0]
            e = [(i, j) for i in inside]
            tris = [(e[0], e[1], e[2])]
        elif len(inside) == 2:
            i0, i1 = inside
            j0, j1 = outside
            e00, e01 = (i0, j0), (i0, j1)
            e10, e11 = (i1, j0), (i1, j1)
            # quad cycle e00 -> e01 -> e11 -> e10
            tris = [(e00, e01, e11), (e00, e11, e10)]
        cases.append(tris)
    return cases


_CASES = _build_case_table()


def marching_tetrahedra(vol, iso: float = 0.0, axes=None):
    """Extract the ``vol < iso`` boundary surface.

    Args:
      vol: [Nx, Ny, Nz] scalar field ("inside" where vol < iso — for a TSDF
        that is the occupied side, matching the reference's level-0 surface).
      iso: isolevel.
      axes: optional per-axis coordinate vectors ([Nx], [Ny], [Nz]); when
        given, vertices are mapped from index space to these coordinates
        (must be uniformly spaced, as TSDFVolume's are).

    Returns:
      (vertices [V, 3] float32, faces [F, 3] int32) with deduplicated
      vertices and outward (toward vol >= iso) winding.
    """
    vol = np.asarray(vol, np.float32)
    nx, ny, nz = vol.shape
    if min(nx, ny, nz) < 2:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)

    inside_grid = vol < iso
    # Active cells: the 8 corners disagree.
    c = inside_grid
    acc = np.zeros((nx - 1, ny - 1, nz - 1), np.int8)
    for dx, dy, dz in _CORNER_OFFSETS:
        acc += c[dx : dx + nx - 1, dy : dy + ny - 1, dz : dz + nz - 1]
    active = (acc > 0) & (acc < 8)
    base = np.argwhere(active)  # [C, 3]
    if base.size == 0:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)

    corner_idx = base[:, None, :] + _CORNER_OFFSETS[None]  # [C, 8, 3]
    vals = vol[corner_idx[..., 0], corner_idx[..., 1], corner_idx[..., 2]]
    pos = corner_idx.astype(np.float32)

    tp = pos[:, _TET_CORNERS, :].reshape(-1, 4, 3)  # [T, 4, 3]
    tv = vals[:, _TET_CORNERS].reshape(-1, 4)  # [T, 4]
    t_in = tv < iso
    caseid = t_in @ np.array([1, 2, 4, 8])

    tri_chunks = []
    for case in range(1, 15):
        sel = np.nonzero(caseid == case)[0]
        if sel.size == 0:
            continue
        p, v = tp[sel], tv[sel]
        ins = np.nonzero(np.array([case >> b & 1 for b in range(4)]))[0]
        centroid_in = p[:, ins, :].mean(axis=1)  # [M, 3]
        for tri in _CASES[case]:
            corners = []
            for a, b in tri:  # a inside, b outside
                va, vb = v[:, a], v[:, b]
                t = (iso - va) / np.where(
                    np.abs(vb - va) < 1e-12, 1e-12, vb - va
                )
                corners.append(p[:, a, :] + t[:, None] * (p[:, b, :] - p[:, a, :]))
            p0, p1, p2 = corners
            # orient outward: normal should point away from the inside side
            n = np.cross(p1 - p0, p2 - p0)
            outward = ((p0 + p1 + p2) / 3.0) - centroid_in
            flip = np.einsum("md,md->m", n, outward) < 0.0
            p1f = np.where(flip[:, None], p2, p1)
            p2f = np.where(flip[:, None], p1, p2)
            tri_chunks.append(np.stack([p0, p1f, p2f], axis=1))
    if not tri_chunks:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)
    tris = np.concatenate(tri_chunks, axis=0)  # [F, 3, 3]

    # Deduplicate vertices (every vertex lies on a lattice edge; exact-ish
    # dedup by rounded coordinates in index space).
    flat = tris.reshape(-1, 3)
    key = np.round(flat.astype(np.float64), 5)
    uniq, inv = np.unique(key, axis=0, return_inverse=True)
    faces = inv.reshape(-1, 3).astype(np.int32)
    verts = uniq.astype(np.float32)
    # drop degenerate triangles (zero-area slivers where iso hits a corner)
    ok = (
        (faces[:, 0] != faces[:, 1])
        & (faces[:, 1] != faces[:, 2])
        & (faces[:, 0] != faces[:, 2])
    )
    faces = faces[ok]

    if axes is not None:
        for d in range(3):
            ax = np.asarray(axes[d], np.float64)
            step = (ax[-1] - ax[0]) / max(len(ax) - 1, 1)
            verts[:, d] = ax[0] + verts[:, d] * step
    return verts, faces


def export_obj(path: str, vertices, faces):
    """Write a Wavefront OBJ (parity: ``mcubes.export_obj``)."""
    vertices = np.asarray(vertices, np.float32)
    faces = np.asarray(faces, np.int64)
    # JAX's header line, so both packages write the same bytes
    lines = ["# eogs2_tpu TSDF isosurface\n"]
    lines += [f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n" for v in vertices]
    lines += [f"f {f[0] + 1} {f[1] + 1} {f[2] + 1}\n" for f in faces]
    with open(path, "w") as fh:
        fh.writelines(lines)
