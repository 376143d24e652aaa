"""Artifact saving: images, image grids, videos, Gaussian PLYs with
turntables, textured OBJ/MTL, colormapped scalar images, npz dumps, frame
sequences and point clouds; camera orbits for templates and turntables.

The port's copy of open_diffusiongs_tpu/utils/saving.py (the functional
replacement of the reference SaverMixin, utils/saving.py:24-751), written
on NumPy (that module imports jax at import time) except for
`save_gaussians`' turntable, which renders through the port's
ops/rasterize.py::render: on the card, one tile-blend launch
(csrc/blend_fwd.cu) a frame.  Videos are MJPEG AVI (utils/video.py).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch
from PIL import Image

from ..ops import rasterize
from ..ops.gaussians import Gaussians, NumpyGaussians
from .ply import save_gaussians_ply
from .video import to_uint8, write_mjpeg_avi


def _ensure_dir(path: str):
    if os.path.dirname(path):
        os.makedirs(os.path.dirname(path), exist_ok=True)


def save_image(path: str, img: np.ndarray) -> str:
    """img: [h, w, 3] float [0,1] or uint8."""
    _ensure_dir(path)
    if img.dtype != np.uint8:
        img = to_uint8(img)
    Image.fromarray(img).save(path)
    return path


def save_image_grid(path: str, imgs: np.ndarray, ncols: Optional[int] = None
                    ) -> str:
    """imgs: [n, h, w, 3] -> single grid png (SaverMixin.save_image_grid)."""
    n, h, w, c = imgs.shape
    ncols = ncols or n
    nrows = -(-n // ncols)
    grid = np.ones((nrows * h, ncols * w, c), imgs.dtype) \
        * (255 if imgs.dtype == np.uint8 else 1.0)
    for i in range(n):
        r, col = divmod(i, ncols)
        grid[r * h:(r + 1) * h, col * w:(col + 1) * w] = imgs[i]
    return save_image(path, grid)


def save_video(path: str, frames: Sequence[np.ndarray], fps: int = 30) -> str:
    """frames: [t, h, w, 3] float or uint8 -> MJPEG AVI."""
    frames = [to_uint8(f) if f.dtype != np.uint8 else f for f in frames]
    _ensure_dir(path)
    if not path.endswith(".avi"):
        path = os.path.splitext(path)[0] + ".avi"
    write_mjpeg_avi(path, frames, fps=fps)
    return path


def chw_to_hwc(x: np.ndarray) -> np.ndarray:
    return np.moveaxis(np.asarray(x), -3, -1)


def turntable_cameras(n_frames: int = 60, radius: float = 2.7,
                      elevation_deg: float = 15.0, h: int = 512, w: int = 512,
                      fov_deg: float = 40.0, focal: float = None):
    """Orbit c2ws (OpenCV convention, z-up world) and intrinsics
    (render_turntable, gs_core.py:1201-1219 spirit); a focal override
    replaces the fov.  Returns (c2ws [n, 4, 4], fxfycxcy [n, 4]) f32."""
    f = focal if focal is not None \
        else 0.5 * w / np.tan(np.radians(fov_deg) / 2)
    ele = np.radians(elevation_deg)
    c2ws, fxy = [], []
    for i in range(n_frames):
        ang = 2 * np.pi * i / n_frames
        eye = np.asarray([radius * np.cos(ele) * np.cos(ang),
                          radius * np.cos(ele) * np.sin(ang),
                          radius * np.sin(ele)], np.float64)
        z = -eye / np.linalg.norm(eye)
        up = np.asarray([0.0, 0.0, 1.0])
        x = np.cross(z, up)
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        c2w = np.eye(4)
        c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = x, y, z, eye
        c2ws.append(c2w)
        fxy.append([f, f, w / 2.0, h / 2.0])
    return (np.stack(c2ws).astype(np.float32),
            np.asarray(fxy, np.float32))


def save_gaussians(g: NumpyGaussians, path_ply: str,
                   save_turntable: bool = False, h: int = 256, w: int = 256,
                   raster_cfg=None, fps: int = 30,
                   turntable_frames: int = 36, device="cuda") -> str:
    """PLY (+ optional turntable AVI) (SaverMixin.save_gaussians,
    saving.py:452-469; JAX saving.py:92-110).  The turntable renders the
    Gaussians from `turntable_frames` orbit cameras in one `render` call on
    `device` (the card unless the caller asks for the CPU), frames
    channels last as JAX's `channels_first=False` gives them, and writes
    `<ply stem>_turntable.avi`."""
    save_gaussians_ply(g, path_ply)
    if save_turntable:
        cfg = raster_cfg or rasterize.RasterizeConfig()
        c2ws, fxy = turntable_cameras(turntable_frames, h=h, w=w)
        dev = torch.device(device)
        gb = Gaussians(*(torch.as_tensor(np.asarray(x), device=dev)[None]
                         for x in g))
        with torch.no_grad():
            out = rasterize.render(gb, torch.as_tensor(c2ws, device=dev)[None],
                                   torch.as_tensor(fxy, device=dev)[None],
                                   h, w, cfg=cfg)
        frames = out["render"][0].permute(0, 2, 3, 1).cpu().numpy()
        save_video(os.path.splitext(path_ply)[0] + "_turntable.avi",
                   frames, fps=fps)
    return path_ply


def save_obj(path: str, v_pos: np.ndarray, t_pos_idx: np.ndarray,
             v_nrm: Optional[np.ndarray] = None,
             v_tex: Optional[np.ndarray] = None,
             t_tex_idx: Optional[np.ndarray] = None,
             v_rgb: Optional[np.ndarray] = None,
             save_mat: bool = False,
             Ka=(0.0, 0.0, 0.0), Kd=(1.0, 1.0, 1.0), Ks=(0.0, 0.0, 0.0),
             map_Kd: Optional[np.ndarray] = None,
             map_Ks: Optional[np.ndarray] = None,
             map_Bump: Optional[np.ndarray] = None,
             map_format: str = "png") -> list:
    """Textured OBJ/MTL export (SaverMixin.save_obj/_save_obj/_save_mtl,
    reference utils/saving.py:533-713): positions, optional normals/uvs/
    vertex-colors, and a material file with Ka/Kd/Ks constants or texture
    maps (map_Kd/map_Ks/map_Bump written next to the .mtl; HWC in [0, 1]).
    Returns the list of written paths."""
    if not path.endswith(".obj"):
        path += ".obj"
    _ensure_dir(path)
    paths = []
    matname, mtllib = None, None
    if save_mat:
        matname = "default"
        mtl_path = path[:-4] + ".mtl"
        mtllib = os.path.basename(mtl_path)
        lines = [f"newmtl {matname}",
                 f"Ka {Ka[0]} {Ka[1]} {Ka[2]}"]
        for tag, img, fname in (("map_Kd", map_Kd, f"texture_kd.{map_format}"),
                                ("map_Ks", map_Ks, f"texture_ks.{map_format}"),
                                ("map_Bump", map_Bump,
                                 f"texture_nrm.{map_format}")):
            if img is not None:
                tex_path = os.path.join(os.path.dirname(path) or ".", fname)
                save_image(tex_path, np.asarray(img))
                lines.append(f"{tag} {fname}")
                paths.append(tex_path)
            elif tag == "map_Kd":
                lines.append(f"Kd {Kd[0]} {Kd[1]} {Kd[2]}")
            elif tag == "map_Ks":
                lines.append(f"Ks {Ks[0]} {Ks[1]} {Ks[2]}")
        with open(mtl_path, "w") as f:
            f.write("\n".join(lines) + "\n")
        paths.append(mtl_path)

    out = []
    if matname is not None:
        out += [f"mtllib {mtllib}", "g object", f"usemtl {matname}"]
    for i, v in enumerate(np.asarray(v_pos)):
        line = f"v {v[0]} {v[1]} {v[2]}"
        if v_rgb is not None:
            c = np.asarray(v_rgb)[i]
            line += f" {c[0]} {c[1]} {c[2]}"
        out.append(line)
    if v_nrm is not None:
        out += [f"vn {v[0]} {v[1]} {v[2]}" for v in np.asarray(v_nrm)]
    if v_tex is not None:
        out += [f"vt {v[0]} {1.0 - v[1]}" for v in np.asarray(v_tex)]
    for i, tri in enumerate(np.asarray(t_pos_idx)):
        face = "f"
        for j in range(3):
            face += f" {tri[j] + 1}/"
            if v_tex is not None:
                ti = np.asarray(t_tex_idx)[i][j] if t_tex_idx is not None \
                    else tri[j]
                face += f"{ti + 1}"
            face += "/"
            if v_nrm is not None:
                face += f"{tri[j] + 1}"
        out.append(face)
    with open(path, "w") as f:
        f.write("\n".join(out) + "\n")
    paths.append(path)
    return paths


def save_grayscale_image(path: str, img: np.ndarray,
                         data_range: Optional[tuple] = None,
                         cmap: Optional[str] = "turbo") -> str:
    """Colormapped scalar-image saver (SaverMixin.save_grayscale_image,
    saving.py:244-255).  img: [h, w]; cmap None -> plain grayscale."""
    from .visualizers import colormap
    img = np.asarray(img, np.float32)
    vmin, vmax = data_range if data_range else (None, None)
    if cmap is None:
        lo = np.min(img) if vmin is None else vmin
        hi = np.max(img) if vmax is None else vmax
        t = np.clip((img - lo) / max(hi - lo, 1e-8), 0, 1)
        rgb = np.stack([t] * 3, axis=-1)
    else:
        rgb = colormap(img, vmin, vmax,
                       cmap="viridis" if cmap == "viridis" else "turbo")
    return save_image(path, rgb)


def save_data(path: str, data) -> str:
    """npz dump of an array or dict of arrays (SaverMixin.save_data,
    saving.py:378-390; the reference's .npy/.npz torch-free dumps)."""
    _ensure_dir(path)
    if not path.endswith(".npz"):
        path += ".npz"
    if isinstance(data, dict):
        np.savez(path, **{k: np.asarray(v) for k, v in data.items()})
    else:
        np.savez(path, data=np.asarray(data))
    return path


def save_img_sequence(path: str, img_dir: str, matcher: str = "*.png",
                      fps: int = 24) -> str:
    """Assemble saved frames into a video (SaverMixin.save_img_sequence,
    saving.py:397-432; MJPEG-AVI here, no ffmpeg in the image)."""
    import glob as _glob
    frames = []
    for f in sorted(_glob.glob(os.path.join(img_dir, matcher))):
        frames.append(np.asarray(Image.open(f).convert("RGB"), np.float32)
                      / 255.0)
    assert frames, f"no frames matching {matcher} in {img_dir}"
    return save_video(path, frames, fps=fps)


def save_xyz_points(path: str, points: np.ndarray,
                    normals: Optional[np.ndarray] = None) -> str:
    """ASCII PLY point cloud (SaverMixin.save_xyz_normal_points /
    save_vertices_as_ply_open3d, saving.py:444-531)."""
    _ensure_dir(path)
    points = np.asarray(points, np.float32).reshape(-1, 3)
    props = ["property float x", "property float y", "property float z"]
    cols = [points]
    if normals is not None:
        props += ["property float nx", "property float ny",
                  "property float nz"]
        cols.append(np.asarray(normals, np.float32).reshape(-1, 3))
    body = np.concatenate(cols, axis=1)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n"
                f"element vertex {len(points)}\n" + "\n".join(props)
                + "\nend_header\n")
        for row in body:
            f.write(" ".join(f"{v:.6f}" for v in row) + "\n")
    return path
