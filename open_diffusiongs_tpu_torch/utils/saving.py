"""Artifact saving: images, image grids, videos; camera orbits for
templates and turntables (NumPy).

The port's copies of the parts of open_diffusiongs_tpu/utils/saving.py
that the CLI and systems/eval_utils.py call (save_image, save_image_grid,
save_video, chw_to_hwc, :27-62) and of turntable_cameras (:64-89), written
on NumPy: that module imports jax at import time.  Videos are MJPEG AVI
(utils/video.py).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
from PIL import Image

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
