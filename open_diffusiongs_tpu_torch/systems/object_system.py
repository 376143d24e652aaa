"""Object-level system: model + schedules, the training loss and the
sampling loop (PyTorch).

Counterpart of open_diffusiongs_tpu/systems/object_system.py
(ObjectSystemConfig, __init__, init_params, load_pretrained, _gt_xyz,
train_loss, make_model_fn and sample, :42-264).  The denoiser is an
nn.Module owned by the system and placed on an explicit `device`; weights
come from `init_params(generator)`, then the config's stage-2 bootstraps
(`load_pretrained`), or from utils/checkpoint.py (reference names).  The
optimizer and the step around `train_loss` are parallel/train_step.py.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, Optional, Tuple

import torch

from .. import register
from ..diffusion import create_schedule, p_sample_loop, q_sample
from ..models.denoiser import DGSDenoiser
from ..ops import rasterize
from ..ops.rays import rays_chw
from ..parallel.shard import shard_for_mesh
from ..utils.schedules import C, C_max
from . import losses as losses_lib


@dataclasses.dataclass(frozen=True)
class ObjectSystemConfig:
    num_inference_steps: int = 30
    num_train_timesteps: int = 1000
    noise_schedule: str = "squaredcos_cap_v2"
    # loss lambdas: float or [start_step, v0, v1, end_step]
    # (configs/diffusionGS_rel.yaml:50-56)
    lambda_diffusion: Any = (150, 0.0, 1.0, 151)
    lambda_lpips: Any = (150, 0.0, 0.5, 151)
    lambda_ssim: Any = 0.0
    lambda_pointsdist: Any = (150, 1.0, 0.0, 151)
    lambda_xyz: Any = (150, 0.0, 0.025, 151)
    use_lpips: bool = True
    lpips_weights: Optional[str] = None
    # a random-init VGG is harmful as a loss: LPIPS without converted
    # pretrained weights needs this explicit opt-in
    allow_random_lpips: bool = False
    bg_color: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    raster: rasterize.RasterizeConfig = rasterize.RasterizeConfig()
    # keyword arguments of DGSDenoiser
    shape_model: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # stage-2 bootstraps (load_pretrained): a strict load of the whole
    # denoiser, then a partial load that skips the listed modules
    pretrained_model_name_or_path: Optional[str] = None
    weights: Optional[str] = None
    weights_ignore_modules: Tuple[str, ...] = ()


def _weights(key: str, path: str) -> Dict[str, torch.Tensor]:
    """load_weights_file(path), its missing-source error naming the config
    key that set it."""
    from ..utils.checkpoint import load_weights_file
    try:
        return load_weights_file(path)
    except FileNotFoundError as e:
        raise FileNotFoundError(f"{key}: {e}") from e


@register("diffusion-gs-system")
class ObjectSystem:
    """Owns the denoiser and the schedules; `train_loss` is the reference
    forward (diffusion_gs_system.py:71-124), `sample` the 30-step
    image -> Gaussians generation (pipline_obj.py:297-306)."""

    def __init__(self, cfg: ObjectSystemConfig,
                 device: torch.device | str = "cpu", mesh=None):
        self.cfg = cfg
        self.device = torch.device(device)
        # parallel/mesh.py::Mesh of the run (None: one rank); its seq ring,
        # if any, reaches the DiT through cfg.shape_model["seq"]
        self.mesh = mesh
        # built without storage; init_params / load_state_dict fill it
        with torch.device("meta"):
            model = DGSDenoiser(**dict(cfg.shape_model))
        self.model = model.to_empty(device=self.device).eval()
        self.sched_train = create_schedule(
            None, cfg.noise_schedule, cfg.num_train_timesteps)
        self.sched_infer = create_schedule(
            str(cfg.num_inference_steps), cfg.noise_schedule,
            cfg.num_train_timesteps)
        # The reference always uses pretrained lpips-VGG.  Sampling never
        # touches LPIPS, so init only records the gap; train_loss refuses
        # to run if the config weights LPIPS without its weights.
        self._lpips_missing = (cfg.use_lpips and cfg.lpips_weights is None
                               and not cfg.allow_random_lpips)
        self.lpips_params = (
            losses_lib.lpips_init_params(cfg.lpips_weights,
                                         device=self.device)
            if cfg.use_lpips and not self._lpips_missing else None)

    def init_params(self, generator: torch.Generator) -> DGSDenoiser:
        """Random init from `generator` (its device must be the system's):
        Linear weights ~ N(0, 0.02), zero biases, truncated-normal
        free-Gaussian embedding.  Under tensor or pipeline parallelism the
        one-rank model is initialized and this rank's part of it kept
        (parallel/shard.py), so every layout starts from the same params.
        Returns the model."""
        mesh = self.mesh
        if mesh is None or (mesh.tp == 1 and mesh.pp == 1):
            self.model.init_weights(generator)
            return self.model
        one = {k: v for k, v in self.cfg.shape_model.items()
               if k not in ("seq", "model", "pipe")}
        with torch.device("meta"):
            whole = DGSDenoiser(**one)
        whole = whole.to_empty(device=self.device)
        whole.init_weights(generator)
        self.model.load_state_dict(shard_for_mesh(whole.state_dict(), mesh),
                                   strict=True)
        return self.model

    def load_pretrained(self) -> DGSDenoiser:
        """Apply the config's weight bootstraps to the initialized model
        (JAX object_system.py:114-140), in place:
          1. `pretrained_model_name_or_path`: strict load of the whole
             denoiser (the stage-2-from-stage-1 recipe);
          2. `weights`: non-strict load, skipping the modules named in
             `weights_ignore_modules` (their init values stay).
        Sources are those of utils/checkpoint.py::load_weights_file, whole
        tensors cut to this rank's part under tensor or pipeline
        parallelism."""
        from ..utils import checkpoint as ckpt_lib
        cfg = self.cfg
        if cfg.pretrained_model_name_or_path:
            src = _weights("shape_model.pretrained_model_name_or_path",
                           cfg.pretrained_model_name_or_path)
            print(f"Loading pretrained shape model from "
                  f"{cfg.pretrained_model_name_or_path}")
            ckpt_lib.load_module_weights(
                self.model, shard_for_mesh(src, self.mesh), strict=True)
        if cfg.weights:
            key = "system.weights"
            ignore = None
            if cfg.weights_ignore_modules:
                key += (" (with system.weights_ignore_modules "
                        f"{list(cfg.weights_ignore_modules)})")
                ignore = ("^(?:" + "|".join(
                    re.escape(m) for m in cfg.weights_ignore_modules)
                    + r")(\.|$)")
            src = _weights(key, cfg.weights)
            ckpt_lib.load_module_weights(
                self.model, shard_for_mesh(src, self.mesh), ignore=ignore,
                strict=False)
        return self.model

    def _gt_xyz(self, batch, ray_o: torch.Tensor, ray_d: torch.Tensor
                ) -> Optional[torch.Tensor]:
        """Ground-truth pixel points from the input views' depth."""
        return ray_o + ray_d * batch["depths_input"].float()

    def train_loss(self, batch: Dict[str, torch.Tensor], step,
                   generator: Optional[torch.Generator] = None,
                   noise: Optional[torch.Tensor] = None,
                   t: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The training loss of one batch (keys of the reference data
        contract, data/base.py:158-243: rgbs_input [b, v, 3, h, w],
        c2ws_input, fxfycxcys_input, depths_input, masks_input, and rgbs /
        c2ws / fxfycxcys for the supervision views).

        View 0 stays the clean condition, views 1: get q_sample noise at a
        timestep t ~ U[0, T) per batch element; the denoiser (no xyz
        clamp, as in the reference's training path) gives Gaussians that
        render every supervision view; the loss sums the terms weighted by
        C(lambda, step).  `noise` [b, v, 3, h, w] and `t` [b] replace the
        draws from `generator` when given (parity tests inject the JAX
        package's draws).  Under data parallelism `batch` is this data
        rank's slice of the global batch: the generator draws the global
        batch's noise and t (in that order, as one rank would) and this
        rank takes its rows, so dp ranks see the draws of one.  Returns
        (loss, metrics) with the unweighted terms, psnr and the render's
        overflow counters."""
        cfg = self.cfg
        if self._lpips_missing and C_max(cfg.lambda_lpips) > 0:
            raise RuntimeError(
                "LPIPS is weighted in this config (lambda_lpips="
                f"{cfg.lambda_lpips}) but no pretrained VGG-LPIPS weights "
                "are available. Provide system.lpips_weights (NPZ from "
                "tools/convert_lpips_weights.py), or explicitly waive the "
                "term with system.use_lpips=false / system.lambda_lpips=0.0 "
                "/ system.allow_random_lpips=true.")
        images = batch["rgbs_input"].float()
        b, v, _, h, w = images.shape
        dev = images.device
        ray_o, ray_d = rays_chw(batch["c2ws_input"],
                                batch["fxfycxcys_input"], h, w)
        dp, d = ((1, 0) if self.mesh is None
                 else (self.mesh.dp, self.mesh.data_rank))
        rows = slice(d * b, (d + 1) * b)
        if noise is None:
            noise = torch.randn((dp * b, *images.shape[1:]),
                                generator=generator, dtype=torch.float32,
                                device=dev)[rows]
        if t is None:
            t = torch.randint(0, cfg.num_train_timesteps, (dp * b,),
                              generator=generator, device=dev)[rows]
        noisy = q_sample(self.sched_train, images[:, 1:], t, noise[:, 1:])
        x = torch.cat([images[:, :1], noisy], dim=1)

        gaussians, img_xyz = self.model(x, ray_o, ray_d, t)
        out = rasterize.render(gaussians, batch["c2ws"], batch["fxfycxcys"],
                               h, w, bg_color=cfg.bg_color, cfg=cfg.raster)
        lo = losses_lib.compute_losses(
            out["render"], batch["rgbs"].float(), ray_o,
            img_aligned_xyz=img_xyz,
            gt_img_aligned_xyz=self._gt_xyz(batch, ray_o, ray_d),
            masks=batch.get("masks_input"),
            lpips_params=self.lpips_params, use_lpips=cfg.use_lpips)

        parts = {
            "loss_diffusion": (lo.l2.mean(), cfg.lambda_diffusion),
            "loss_lpips": (lo.lpips, cfg.lambda_lpips),
            "loss_ssim": (lo.ssim.mean(), cfg.lambda_ssim),
            "loss_pointsdist": (lo.pointsdist.mean(), cfg.lambda_pointsdist),
            "loss_xyz": (lo.xyz, cfg.lambda_xyz),
        }
        total = torch.zeros((), dtype=torch.float32, device=dev)
        metrics = {
            "psnr": lo.psnr.mean().detach(),
            "overflow_gaussians": out["overflow_gaussians"],
            "overflow_tiles": out["overflow_tiles"],
            # fraction of per-tile candidate entries dropped by the K cap
            # (docs/CAPACITY.md)
            "overflow_frac": out["overflow_gaussians"].float()
            / torch.clamp(out["binned_entries"], min=1).float(),
        }
        for name, (value, lam) in parts.items():
            metrics[name] = value.detach()
            total = total + value * C(lam, step)
        metrics["loss"] = total.detach()
        return total, metrics

    def make_model_fn(self, c2w: torch.Tensor, fxfycxcy: torch.Tensor,
                      h: int, w: int, skip_cond_render: int = 0):
        """model_fn(images, t) -> (renders, (gaussians, alpha, counters))
        for the diffusion loop: renders the views it is fed, minus the first
        `skip_cond_render` (condition) views, whose renders the loop never
        reads."""
        ray_o, ray_d = rays_chw(c2w, fxfycxcy, h, w)
        rc2w = c2w[:, skip_cond_render:]
        rfxy = fxfycxcy[:, skip_cond_render:]

        # named ranges for torch.profiler: the DiT's host time and the
        # rasterizer's glue are read apart in a profiled asset
        def model_fn(images, t):
            with torch.profiler.record_function("denoiser"):
                g, _ = self.model(images, ray_o, ray_d, t)
            with torch.profiler.record_function("render"):
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
               noise_fn=None,
               return_trajectory: bool = False) -> Dict[str, Any]:
        """Generation.  cond_images [b, n_cond, 3, h, w]; c2w / fxfycxcy
        [b, v_total, ...] with the condition views first.  `noise` (the
        initial x_T) and `noise_fn` (per-step noise) replace draws from
        `generator` when given.

        Returns sample, renders (every view, t = 0), gaussians, alpha and
        the t = 0 render's overflow counters; with `return_trajectory`
        also trajectory = (x_t, pred_x0), each [T-1, b, v_noisy, 3, h, w]
        (JAX object_system.py:240-260)."""
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
                            return_trajectory=return_trajectory,
                            final_model_fn=final_fn, noise_fn=noise_fn)
        gaussians, alpha, counters = out.pop("aux")
        out.update(gaussians=gaussians, alpha=alpha, **counters)
        return out
