"""Orbit-camera math (kiui.cam-compatible, pure NumPy).

The reference re-anchors GObjaverse poses relative to the first view via
kiui's `undo_orbit_camera` / `orbit_camera` (data/base.py:190-201).
Conventions (kiui, OpenGL): world y up; elevation in [-90, 90] measured
from the xz-plane toward -y (camera above the object has negative y? no:
campos.y = -r*sin(elevation), so positive elevation looks DOWN from above
+y... matching kiui: ele < 0 means camera above);
azimuth in [0, 360) from +z toward +x; camera looks at the origin with
OpenGL axes (x right, y up, z backward).

The port's own copy of open_diffusiongs_tpu/data/cameras.py.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _normalize(v):
    return v / (np.linalg.norm(v) + 1e-20)


def look_at(campos: np.ndarray, target: np.ndarray) -> np.ndarray:
    """OpenGL look-at rotation (kiui.cam.look_at, opengl=True)."""
    forward = _normalize(campos - target)     # OpenGL camera looks along -z
    up = np.asarray([0.0, 1.0, 0.0])
    right = _normalize(np.cross(up, forward))
    up = _normalize(np.cross(forward, right))
    return np.stack([right, up, forward], axis=1)


def orbit_camera(elevation: float, azimuth: float, radius: float = 1.0,
                 target=None) -> np.ndarray:
    """kiui.cam.orbit_camera: (ele, azi, r) -> OpenGL c2w [4, 4]."""
    ele = np.deg2rad(elevation)
    azi = np.deg2rad(azimuth)
    x = radius * np.cos(ele) * np.sin(azi)
    y = -radius * np.sin(ele)
    z = radius * np.cos(ele) * np.cos(azi)
    campos = np.asarray([x, y, z], np.float64)
    if target is not None:
        campos = campos + np.asarray(target, np.float64)
    T = np.eye(4)
    T[:3, :3] = look_at(campos, np.zeros(3) if target is None
                        else np.asarray(target))
    T[:3, 3] = campos
    return T


def undo_orbit_camera(T: np.ndarray) -> Tuple[float, float, float]:
    """kiui.cam.undo_orbit_camera: OpenGL c2w -> (elevation, azimuth, radius)
    in degrees (target assumed at origin)."""
    campos = T[:3, 3]
    radius = float(np.linalg.norm(campos))
    elevation = float(np.rad2deg(np.arcsin(-campos[1] / radius)))
    azimuth = float(np.rad2deg(np.arctan2(campos[0], campos[2])))
    return elevation, azimuth, radius
