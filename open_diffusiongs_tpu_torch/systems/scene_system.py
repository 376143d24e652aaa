"""Scene-level system (RE10K): training loss + sampling + eval dumps.

Counterpart of open_diffusiongs_tpu/systems/scene_system.py, the
equivalent of the reference "diffusion-gs-scene-system"
(systems/diffusion_gs_system_scene.py:26-239).  Differences from the
object system it extends:
  * no depth ground truth: the xyz loss term is zero (:96-104 passes no
    gt_img_aligned_xyz);
  * sampling uses clip_denoised=False (:178), as the object system's does;
  * eval saves npz result packages (render_images + input images) for the
    metric CLI (save_result_for_eval, :221-228) — the reference's `.pt`
    dumps become `.npz`.
The scene DiT (`plk` ray PE, [near, far] depth head) is the object one's
DGSDenoiser with the scene keys (systems/builder.py).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from .. import register
from .object_system import ObjectSystem, ObjectSystemConfig

SCENE_SYSTEM = "diffusion-gs-scene-system"


@dataclasses.dataclass(frozen=True)
class SceneSystemConfig(ObjectSystemConfig):
    save_intermediate_video: bool = True
    save_result_for_eval: bool = False


@register(SCENE_SYSTEM)
class SceneSystem(ObjectSystem):
    """Shares the ObjectSystem training/sampling machinery; the only scene
    difference in the loss is the absence of depth ground truth."""

    cfg: SceneSystemConfig

    def _gt_xyz(self, batch, ray_o, ray_d):
        # RE10K has no depth: the xyz loss term is zero (the reference
        # passes no gt_img_aligned_xyz, diffusion_gs_system_scene.py:96-104)
        return None

    @staticmethod
    def save_result_for_eval(trial_dir: str, step: int, uid: str,
                             render_images: np.ndarray,
                             input_images: np.ndarray) -> str:
        """npz dump for eval_scene_result (reference saves .pt, :221-228)."""
        d = os.path.join(trial_dir, "save", f"it{step}")
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, f"{uid}.npz")
        np.savez_compressed(path, render_images=render_images,
                            image=input_images)
        return path
