"""Minimal PLY reader/writer (binary little-endian), replacing plyfile.

Counterpart of ``eogs2_tpu/io/ply.py`` (numpy only, as there): for the
same arrays both packages write the same bytes, so a PLY from either loads
in the other. Parity target: the Gaussian PLY schema of
``scene/gaussian_model.py:296-345`` (x,y,z, nx,ny,nz, f_dc_*, f_rest_*,
opacity, scale_*, rot_*) and the point-cloud PLY of
``scene/dataset_readers/dataset_utils.py`` (xyz, normals, rgb).
"""

from __future__ import annotations

import io
import os
from typing import Dict, List, Tuple

import numpy as np

_DTYPES = {
    "float": "<f4",
    "float32": "<f4",
    "double": "<f8",
    "float64": "<f8",
    "uchar": "u1",
    "uint8": "u1",
    "char": "i1",
    "int8": "i1",
    "short": "<i2",
    "ushort": "<u2",
    "int": "<i4",
    "int32": "<i4",
    "uint": "<u4",
    "uint32": "<u4",
}


def write_ply(path: str, fields: Dict[str, np.ndarray]):
    """Write a binary_little_endian PLY with one 'vertex' element.

    fields: ordered {name: [N] float32/uint8 array}.
    """
    names = list(fields)
    n = len(fields[names[0]])
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    cols = []
    for name in names:
        arr = np.ascontiguousarray(fields[name])
        assert arr.shape == (n,), (name, arr.shape)
        if arr.dtype == np.uint8:
            ply_t = "uchar"
        else:
            arr = arr.astype("<f4")
            ply_t = "float"
        header.append(f"property {ply_t} {name}")
        cols.append(arr)
    header.append("end_header")
    rec = np.rec.fromarrays(cols, names=names)
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        f.write(rec.tobytes())


def read_ply(path: str) -> Dict[str, np.ndarray]:
    """Read the 'vertex' element of an ascii or binary_little_endian PLY."""
    with open(path, "rb") as f:
        data = f.read()
    head_end = data.find(b"end_header")
    if head_end < 0:
        raise ValueError(f"not a PLY file: {path}")
    head_end = data.find(b"\n", head_end) + 1
    header = data[:head_end].decode("ascii", "replace").splitlines()
    fmt = "binary_little_endian"
    props: List[Tuple[str, str]] = []
    count = 0
    in_vertex = False
    for line in header:
        parts = line.strip().split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            in_vertex = parts[1] == "vertex"
            if in_vertex:
                count = int(parts[2])
        elif parts[0] == "property" and in_vertex:
            if parts[1] == "list":
                raise ValueError("list properties unsupported")
            props.append((parts[2], _DTYPES[parts[1]]))
    if fmt == "ascii":
        body = np.loadtxt(io.BytesIO(data[head_end:]), max_rows=count)
        body = body.reshape(count, len(props))
        return {name: body[:, i] for i, (name, _) in enumerate(props)}
    if fmt != "binary_little_endian":
        raise ValueError(f"unsupported PLY format {fmt}")
    dtype = np.dtype([(name, t) for name, t in props])
    rec = np.frombuffer(data[head_end : head_end + count * dtype.itemsize], dtype=dtype)
    return {name: np.asarray(rec[name]) for name, _ in props}


def write_point_cloud(path: str, xyz: np.ndarray, rgb: np.ndarray):
    """storePly parity: xyz + zero normals + uint8 rgb."""
    zeros = np.zeros(len(xyz), np.float32)
    rgb255 = np.clip(rgb * 255.0, 0, 255).astype(np.uint8)
    write_ply(
        path,
        {
            "x": xyz[:, 0],
            "y": xyz[:, 1],
            "z": xyz[:, 2],
            "nx": zeros,
            "ny": zeros,
            "nz": zeros,
            "red": rgb255[:, 0],
            "green": rgb255[:, 1],
            "blue": rgb255[:, 2],
        },
    )


def read_point_cloud(path: str):
    """fetchPly parity -> (xyz [N,3] f32, rgb [N,3] f32 in [0,1])."""
    f = read_ply(path)
    xyz = np.stack([f["x"], f["y"], f["z"]], axis=1).astype(np.float32)
    if "red" in f:
        rgb = np.stack([f["red"], f["green"], f["blue"]], axis=1).astype(np.float32)
        if rgb.max() > 1.5:
            rgb = rgb / 255.0
    else:
        rgb = np.ones_like(xyz)
    return xyz, rgb


def save_gaussians_ply(path: str, xyz, f_dc, f_rest, opacity, scaling, rotation):
    """GaussianModel.save_ply parity (gaussian_model.py:310-345).

    Args are numpy arrays: xyz [N,3], f_dc [N,1,3], f_rest [N,R,3],
    opacity [N,1] (raw logits), scaling [N,3] (log), rotation [N,4].
    """
    n = len(xyz)
    fields = {
        "x": xyz[:, 0],
        "y": xyz[:, 1],
        "z": xyz[:, 2],
        "nx": np.zeros(n, np.float32),
        "ny": np.zeros(n, np.float32),
        "nz": np.zeros(n, np.float32),
    }
    # reference stores features channel-major: transpose(1,2).flatten
    dc = np.transpose(f_dc, (0, 2, 1)).reshape(n, -1)
    for i in range(dc.shape[1]):
        fields[f"f_dc_{i}"] = dc[:, i]
    rest = np.transpose(f_rest, (0, 2, 1)).reshape(n, -1)
    for i in range(rest.shape[1]):
        fields[f"f_rest_{i}"] = rest[:, i]
    fields["opacity"] = opacity[:, 0]
    for i in range(scaling.shape[1]):
        fields[f"scale_{i}"] = scaling[:, i]
    for i in range(rotation.shape[1]):
        fields[f"rot_{i}"] = rotation[:, i]
    write_ply(path, fields)


def load_gaussians_ply(path: str, sh_degree: int = 0):
    """GaussianModel.load_ply parity -> dict of raw parameter arrays."""
    f = read_ply(path)
    n = len(f["x"])
    xyz = np.stack([f["x"], f["y"], f["z"]], 1).astype(np.float32)
    dc_names = sorted(
        (k for k in f if k.startswith("f_dc_")), key=lambda s: int(s.split("_")[-1])
    )
    f_dc = np.stack([f[k] for k in dc_names], 1).reshape(n, 3, -1)
    f_dc = np.transpose(f_dc, (0, 2, 1)).astype(np.float32)  # [N,1,3]
    rest_names = sorted(
        (k for k in f if k.startswith("f_rest_")), key=lambda s: int(s.split("_")[-1])
    )
    r = (sh_degree + 1) ** 2 - 1
    if rest_names:
        fr = np.stack([f[k] for k in rest_names], 1).reshape(n, 3, r)
        f_rest = np.transpose(fr, (0, 2, 1)).astype(np.float32)
    else:
        f_rest = np.zeros((n, r, 3), np.float32)
    opacity = f["opacity"].astype(np.float32)[:, None]
    sc_names = sorted(
        (k for k in f if k.startswith("scale_")), key=lambda s: int(s.split("_")[-1])
    )
    scaling = np.stack([f[k] for k in sc_names], 1).astype(np.float32)
    rot_names = sorted(
        (k for k in f if k.startswith("rot_")), key=lambda s: int(s.split("_")[-1])
    )
    rotation = np.stack([f[k] for k in rot_names], 1).astype(np.float32)
    return {
        "xyz": xyz,
        "features_dc": f_dc,
        "features_rest": f_rest,
        "opacity": opacity,
        "scaling": scaling,
        "rotation": rotation,
    }
