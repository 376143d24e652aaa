"""Camera orbits for templates and turntables (NumPy).

A jax-free copy of open_diffusiongs_tpu/utils/saving.py::turntable_cameras
(:64-89): that module imports jax at import time.
"""

from __future__ import annotations

import numpy as np


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
