"""Object-level system: model + schedules + the sampling loop (PyTorch).

Counterpart of open_diffusiongs_tpu/systems/object_system.py
(ObjectSystemConfig, __init__, init_params, make_model_fn and sample,
:42-112, :213-264).  The denoiser is an nn.Module owned by the system and
placed on an explicit `device`; weights come from `init_params(generator)`
or from `self.model.load_state_dict` (reference names, utils/convert.py).
Training (loss, LPIPS, optimizer) is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from .. import register
from ..diffusion import create_schedule, p_sample_loop
from ..models.denoiser import DGSDenoiser
from ..ops import rasterize
from ..ops.rays import rays_chw


@dataclasses.dataclass(frozen=True)
class ObjectSystemConfig:
    num_inference_steps: int = 30
    num_train_timesteps: int = 1000
    noise_schedule: str = "squaredcos_cap_v2"
    bg_color: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    raster: rasterize.RasterizeConfig = rasterize.RasterizeConfig()
    # keyword arguments of DGSDenoiser
    shape_model: Dict[str, Any] = dataclasses.field(default_factory=dict)


@register("diffusion-gs-system")
class ObjectSystem:
    """Owns the denoiser and the schedules; `sample` is the 30-step
    image -> Gaussians generation (pipline_obj.py:297-306)."""

    def __init__(self, cfg: ObjectSystemConfig,
                 device: torch.device | str = "cpu"):
        self.cfg = cfg
        self.device = torch.device(device)
        # built without storage; init_params / load_state_dict fill it
        with torch.device("meta"):
            model = DGSDenoiser(**dict(cfg.shape_model))
        self.model = model.to_empty(device=self.device).eval()
        self.sched_infer = create_schedule(
            str(cfg.num_inference_steps), cfg.noise_schedule,
            cfg.num_train_timesteps)

    def init_params(self, generator: torch.Generator) -> DGSDenoiser:
        """Random init from `generator` (its device must be the system's):
        Linear weights ~ N(0, 0.02), zero biases, truncated-normal
        free-Gaussian embedding.  Returns the model."""
        self.model.init_weights(generator)
        return self.model

    def make_model_fn(self, c2w: torch.Tensor, fxfycxcy: torch.Tensor,
                      h: int, w: int, skip_cond_render: int = 0):
        """model_fn(images, t) -> (renders, (gaussians, alpha, counters))
        for the diffusion loop: renders the views it is fed, minus the first
        `skip_cond_render` (condition) views, whose renders the loop never
        reads."""
        ray_o, ray_d = rays_chw(c2w, fxfycxcy, h, w)
        rc2w = c2w[:, skip_cond_render:]
        rfxy = fxfycxcy[:, skip_cond_render:]

        def model_fn(images, t):
            g, _ = self.model(images, ray_o, ray_d, t)
            out = rasterize.render(g, rc2w, rfxy, h, w,
                                   bg_color=self.cfg.bg_color,
                                   cfg=self.cfg.raster)
            counters = {k: out[k] for k in ("overflow_tiles",
                                            "overflow_gaussians",
                                            "binned_entries")}
            return out["render"].float(), (g, out["alpha"], counters)
        return model_fn

    @torch.no_grad()
    def sample(self, cond_images: torch.Tensor, c2w: torch.Tensor,
               fxfycxcy: torch.Tensor,
               generator: Optional[torch.Generator] = None,
               noise: Optional[torch.Tensor] = None,
               noise_fn=None) -> Dict[str, Any]:
        """Generation.  cond_images [b, n_cond, 3, h, w]; c2w / fxfycxcy
        [b, v_total, ...] with the condition views first.  `noise` (the
        initial x_T) and `noise_fn` (per-step noise) replace draws from
        `generator` when given.

        Returns sample, renders (every view, t = 0), gaussians, alpha and
        the t = 0 render's overflow counters."""
        b, n_cond, _, h, w = cond_images.shape
        v_total = c2w.shape[1]
        if noise is None:
            noise = torch.randn((b, v_total - n_cond, 3, h, w),
                                generator=generator, dtype=torch.float32,
                                device=cond_images.device)
        # the loop never reads the condition views' renders; the t = 0
        # step renders every view
        loop_fn = self.make_model_fn(c2w, fxfycxcy, h, w,
                                     skip_cond_render=n_cond)
        final_fn = self.make_model_fn(c2w, fxfycxcy, h, w)
        # clip_denoised=False: every reference sampling call site disables
        # the [-1, 1] clamp (pipline_obj.py:302)
        out = p_sample_loop(self.sched_infer, loop_fn, cond_images.float(),
                            noise, generator, clip_denoised=False,
                            final_model_fn=final_fn, noise_fn=noise_fn)
        gaussians, alpha, counters = out.pop("aux")
        out.update(gaussians=gaussians, alpha=alpha, **counters)
        return out
