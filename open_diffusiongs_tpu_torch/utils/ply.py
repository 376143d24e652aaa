"""PLY writer for 3D Gaussians — NumPy, byte-identical layout to
open_diffusiongs_tpu/utils/ply.py:22-80 (which imports ops.gaussians and,
through it, jax).

Binary little-endian; properties x, y, z (f4), red, green, blue (u1
preview colours), f_dc_0..2, f_rest_* (padded to SH degree 3 for
SuperSplat-style viewers), opacity, scale_0..2, rot_0..3 — all raw
(pre-activation) values (reference gs_core.py:636-712).
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np

from ..ops.gaussians import NumpyGaussians

SH_C0 = 0.28209479177387814


def _build_dtype(n_f_dc: int, n_f_rest: int) -> np.dtype:
    fields: List[Tuple[str, str]] = [("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                                     ("red", "u1"), ("green", "u1"),
                                     ("blue", "u1")]
    fields += [(f"f_dc_{i}", "<f4") for i in range(n_f_dc)]
    fields += [(f"f_rest_{i}", "<f4") for i in range(n_f_rest)]
    fields += [("opacity", "<f4")]
    fields += [(f"scale_{i}", "<f4") for i in range(3)]
    fields += [(f"rot_{i}", "<f4") for i in range(4)]
    return np.dtype(fields)


def save_gaussians_ply(g: NumpyGaussians, path: str,
                       enable_gs_viewer: bool = True) -> None:
    """Write raw Gaussians to a 3DGS-convention PLY."""
    if os.path.dirname(path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
    n = g.xyz.shape[0]
    sh_degree = int(round(g.features.shape[1] ** 0.5)) - 1
    f_dc = g.features[:, 0, :].astype(np.float32)           # [n, 3]
    rgb = np.clip((SH_C0 * f_dc + 0.5) * 255.0, 0, 255).astype(np.uint8)

    if sh_degree > 0:
        # [n, SH-1, 3] -> [n, 3, SH-1] -> flat (channel-major)
        f_rest = g.features[:, 1:, :].transpose(0, 2, 1).reshape(n, -1)
    else:
        f_rest = np.zeros((n, 0), np.float32)
    if enable_gs_viewer:
        want = 3 * ((3 + 1) ** 2 - 1)                        # pad to degree 3
        if f_rest.shape[1] < want:
            pad = np.zeros((n, want), np.float32)
            pad[:, :f_rest.shape[1]] = f_rest
            f_rest = pad

    dtype = _build_dtype(3, f_rest.shape[1])
    el = np.empty(n, dtype=dtype)
    el["x"], el["y"], el["z"] = g.xyz[:, 0], g.xyz[:, 1], g.xyz[:, 2]
    el["red"], el["green"], el["blue"] = rgb[:, 0], rgb[:, 1], rgb[:, 2]
    for i in range(3):
        el[f"f_dc_{i}"] = f_dc[:, i]
    for i in range(f_rest.shape[1]):
        el[f"f_rest_{i}"] = f_rest[:, i]
    el["opacity"] = g.opacity[:, 0]
    for i in range(3):
        el[f"scale_{i}"] = g.scaling[:, i]
    for i in range(4):
        el[f"rot_{i}"] = g.rotation[:, i]

    header = ["ply", "format binary_little_endian 1.0",
              f"element vertex {n}"]
    type_map = {"<f4": "float", "u1": "uchar"}
    for name, (dt, _) in dtype.fields.items():
        header.append(f"property {type_map[dt.str.lstrip('|')]} {name}")
    header.append("end_header")
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        f.write(el.tobytes())
