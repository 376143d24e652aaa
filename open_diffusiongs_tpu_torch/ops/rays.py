"""Per-pixel camera rays from poses + intrinsics (PyTorch).

Counterpart of open_diffusiongs_tpu/ops/rays.py:19-59: pixel centres at
(i + 0.5), camera direction ((u + 0.5 - cx) / fx, (v + 0.5 - cy) / fy, 1)
rotated to world and L2-normalized; origin at the camera centre.
"""

from __future__ import annotations

from typing import Tuple

import torch


def pixel_rays(c2w: torch.Tensor, fxfycxcy: torch.Tensor, h: int, w: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """World-space rays (ray_o, ray_d), each [..., h, w, 3] f32; ray_d has
    unit norm.  c2w [..., 4, 4] (OpenCV), fxfycxcy [..., 4]."""
    c2w = c2w.float()
    fxfycxcy = fxfycxcy.float()
    dev = c2w.device
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev),
                            indexing="ij")
    fx, fy, cx, cy = (fxfycxcy[..., i, None, None] for i in range(4))
    dir_x = (xx + 0.5 - cx) / fx
    dir_y = (yy + 0.5 - cy) / fy
    d_cam = torch.stack([dir_x, dir_y, torch.ones_like(dir_x)], -1)
    rot = c2w[..., :3, :3]
    d_world = torch.einsum("...hwc,...dc->...hwd", d_cam, rot)
    d_world = d_world / torch.linalg.norm(d_world, dim=-1, keepdim=True)
    o_world = c2w[..., None, None, :3, 3].expand(d_world.shape)
    return o_world, d_world


def rays_chw(c2w: torch.Tensor, fxfycxcy: torch.Tensor, h: int, w: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Channels-first [..., 3, h, w] rays (the reference layout)."""
    ray_o, ray_d = pixel_rays(c2w, fxfycxcy, h, w)
    return ray_o.movedim(-1, -3), ray_d.movedim(-1, -3)
