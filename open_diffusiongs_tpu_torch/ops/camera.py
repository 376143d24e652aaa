"""Camera math (OpenCV convention) in PyTorch.

Counterpart of open_diffusiongs_tpu/ops/camera.py:28-102: camera-to-world
matrices in OpenCV convention (x right, y down, z forward), znear 0.01,
zfar 100, and the intrinsics-aware projection matrix of the CUDA
rasterizer, in column-vector form (`P @ W2C @ [p; 1]`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

ZNEAR = 0.01
ZFAR = 100.0


class CameraParams(NamedTuple):
    """Per-view camera data (leading dims broadcastable).

    w2c [..., 4, 4]; proj [..., 4, 4]; full_proj = proj @ w2c;
    cam_pos [..., 3] (c2w[:3, 3]); fxfycxcy [..., 4];
    tanfov [..., 2] = (w / 2fx, h / 2fy).
    """

    w2c: torch.Tensor
    proj: torch.Tensor
    full_proj: torch.Tensor
    cam_pos: torch.Tensor
    fxfycxcy: torch.Tensor
    tanfov: torch.Tensor


def projection_matrix(fxfycxcy: torch.Tensor, h: int, w: int,
                      znear: float = ZNEAR, zfar: float = ZFAR
                      ) -> torch.Tensor:
    """Intrinsics projection matrix: fxfycxcy [..., 4] -> [..., 4, 4]."""
    fx, fy, cx, cy = fxfycxcy.unbind(-1)
    zero = torch.zeros_like(fx)
    one = torch.ones_like(fx)
    z22 = torch.full_like(fx, -(zfar + znear) / (zfar - znear))
    z23 = torch.full_like(fx, -(2.0 * zfar * znear) / (zfar - znear))
    rows = [
        torch.stack([2.0 * fx / w, zero, 2.0 * (cx / w) - 1.0, zero], -1),
        torch.stack([zero, 2.0 * fy / h, 2.0 * (cy / h) - 1.0, zero], -1),
        torch.stack([zero, zero, z22, z23], -1),
        torch.stack([zero, zero, one, zero], -1),
    ]
    return torch.stack(rows, dim=-2)


def make_camera(c2w: torch.Tensor, fxfycxcy: torch.Tensor, h: int, w: int
                ) -> CameraParams:
    """CameraParams from [..., 4, 4] c2w and [..., 4] intrinsics."""
    c2w = c2w.float()
    fxfycxcy = fxfycxcy.float()
    w2c = torch.linalg.inv(c2w)
    proj = projection_matrix(fxfycxcy, h, w)
    fx, fy = fxfycxcy[..., 0], fxfycxcy[..., 1]
    return CameraParams(
        w2c=w2c, proj=proj, full_proj=torch.matmul(proj, w2c),
        cam_pos=c2w[..., :3, 3], fxfycxcy=fxfycxcy,
        tanfov=torch.stack([w / (2.0 * fx), h / (2.0 * fy)], -1))


def ndc2pix(v: torch.Tensor, size: int) -> torch.Tensor:
    """NDC [-1, 1] -> pixel coordinate ((v + 1) S - 1) / 2: pixel centres
    at integer coordinates (auxiliary.h ndc2Pix)."""
    return ((v + 1.0) * size - 1.0) * 0.5
