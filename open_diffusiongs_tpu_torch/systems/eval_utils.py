"""Validation artifact helpers: trajectory videos, scene PLY + path videos.

Counterpart of open_diffusiongs_tpu/systems/eval_utils.py (which imports
jax for its render), itself the equivalent of the reference's
validation-side savers:
  * display_timestep_on_video (systems/utils.py:761-793): timestep label
    drawn on each frame;
  * the x_t / pred_x0 trajectory mp4s and scene PLY + slerp camera-path
    video of diffusion_gs_system_scene.validation_step (:203-219,
    saving.py:472-504).
The frames are NumPy and PIL, as in JAX; the path video renders through
the port's ops/rasterize.py::render on `device` (the blend kernel on a
GPU).
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np
import torch
from PIL import Image, ImageDraw

from ..ops import rasterize
from ..ops.gaussians import Gaussians, NumpyGaussians
from ..utils.ply import save_gaussians_ply
from ..utils.pose_interp import get_interpolated_poses_many
from ..utils.saving import save_video
from ..utils.video import to_uint8


def overlay_timestep(frame: np.ndarray, label: str) -> np.ndarray:
    """Draw a timestep label onto a [h, w, 3] uint8 frame
    (display_timestep_on_video equivalent)."""
    img = Image.fromarray(frame)
    draw = ImageDraw.Draw(img)
    draw.rectangle([2, 2, 10 + 8 * len(label), 18], fill=(0, 0, 0))
    draw.text((6, 4), label, fill=(255, 255, 0))
    return np.asarray(img)


def trajectory_video_frames(traj: np.ndarray, cond: np.ndarray,
                            timesteps: Sequence[int]) -> List[np.ndarray]:
    """traj: [T, v, 3, h, w] float; cond: [1, 3, h, w] -> frames
    [h, (v+1)*w, 3] uint8 with 't=...' labels (validation_step :180-195)."""
    frames = []
    for i in range(traj.shape[0]):
        full = np.concatenate([cond, traj[i]], axis=0)     # [v+1, 3, h, w]
        row = np.concatenate(list(full.transpose(0, 2, 3, 1)), axis=1)
        frame = to_uint8(row)
        label = f"t={int(timesteps[i])}" if i < len(timesteps) else "t=0"
        frames.append(overlay_timestep(frame, label))
    return frames


def save_trajectory_videos(out_dir: str, uid: str, traj_xt: np.ndarray,
                           traj_x0: np.ndarray, cond: np.ndarray,
                           timesteps: Sequence[int], fps: int = 24) -> None:
    os.makedirs(out_dir, exist_ok=True)
    save_video(os.path.join(out_dir, f"{uid}_traj_xt.avi"),
               trajectory_video_frames(traj_xt, cond, timesteps), fps=fps)
    save_video(os.path.join(out_dir, f"{uid}_traj_xstart.avi"),
               trajectory_video_frames(traj_x0, cond, timesteps), fps=fps)


@torch.no_grad()
def path_video_frames(g: NumpyGaussians, keyframe_c2ws: np.ndarray,
                      fxfycxcy: np.ndarray, h: int, w: int,
                      steps_per_transition: int = 10, raster_cfg=None,
                      device: torch.device | str = "cpu") -> np.ndarray:
    """Renders [n, h, w, 3] along the slerp path through the keyframes,
    with the first keyframe's intrinsics (saving.py:472-504)."""
    path = get_interpolated_poses_many(np.asarray(keyframe_c2ws),
                                       steps_per_transition)
    fxy = np.tile(np.asarray(fxfycxcy, np.float32)[:1], (len(path), 1))
    cfg = raster_cfg or rasterize.RasterizeConfig()
    gb = Gaussians(*(torch.from_numpy(np.ascontiguousarray(x))[None]
                     .to(device) for x in g))
    out = rasterize.render(gb, torch.from_numpy(path)[None].to(device),
                           torch.from_numpy(fxy)[None].to(device), h, w,
                           cfg=cfg)
    return out["render"][0].permute(0, 2, 3, 1).cpu().numpy()


def save_scene_gaussians(out_dir: str, uid: str, g: NumpyGaussians,
                         keyframe_c2ws: Optional[np.ndarray] = None,
                         fxfycxcy: Optional[np.ndarray] = None,
                         h: int = 256, w: int = 256,
                         render_video: bool = True,
                         steps_per_transition: int = 10,
                         raster_cfg=None,
                         device: torch.device | str = "cpu") -> None:
    """PLY + slerp camera-path render video (saving.py:472-504)."""
    os.makedirs(out_dir, exist_ok=True)
    save_gaussians_ply(g, os.path.join(out_dir, f"{uid}.ply"))
    if not render_video or keyframe_c2ws is None:
        return
    frames = path_video_frames(g, keyframe_c2ws, fxfycxcy, h, w,
                               steps_per_transition, raster_cfg, device)
    save_video(os.path.join(out_dir, f"{uid}_path.avi"), frames, fps=24)
