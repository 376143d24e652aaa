"""Build the port's systems and optimizer configs from the repo's YAML
config surface.

Counterpart of open_diffusiongs_tpu/systems/builder.py:49-151 for the
object and scene systems, from a config read by
utils/config.py::load_config.  The
same configs/*.yaml drive both packages (ROADMAP rule 4): keys that steer
TPU-only machinery are accepted, ignored, and named in one log line.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Optional

import torch

from ..ops.rasterize import TPU_ONLY_FIELDS, RasterizeConfig
from ..parallel.train_step import OptimizerConfig

log = logging.getLogger(__name__)

# reference shape_model keys -> DGSDenoiser arguments (None = ignored)
_SHAPE_MODEL_MAP = {
    "width": "width",
    "in_channels": "in_channels",
    "patch_size": "patch_size",
    "n_gaussians": "n_gaussians",
    "dim_heads": "dim_heads",
    "num_layers": "num_layers",
    "ray_pe_type": "ray_pe_type",
    "hard_pixelalign": "hard_pixelalign",
    # the [-1, 1] xyz clamp of training mode (sampling never applies it)
    "clip_xyz": None,
    "gaussians_sh_degree": "gaussians_sh_degree",
    "range_setting_near": "range_setting_near",
    "range_setting_far": "range_setting_far",
    "gs_raw_offset_scaling": "gs_raw_offset_scaling",
    "gs_raw_offset_opacity": "gs_raw_offset_opacity",
    # block checkpointing (the JAX package's remat)
    "use_checkpoint": "checkpoint",
    # W8A8 int8 serving (ops/quant.py; JAX builder.py:38-39)
    "quant_int8": "quant_int8",
    # reference knobs with a fixed answer (unused by the shipped model)
    "prior_distribution": None, "use_gssplat": None,
    "grad_checkpoint_every": None, "use_downsample": None,
    "num_latents": None, "range_setting_type": None,
    # lifted into ObjectSystemConfig by build_system (load_pretrained)
    "pretrained_model_name_or_path": None,
}


# shape_model keys that steer TPU-only machinery (ignored, logged)
TPU_ONLY_SHAPE_KEYS = ("use_flash", "remat_save_attn", "remat_save_mlp")
LOSS_LAMBDAS = ("lambda_diffusion", "lambda_lpips", "lambda_ssim",
                "lambda_pointsdist", "lambda_xyz")


def shape_model_kwargs(cfg: Dict[str, Any], bf16: bool = True,
                       ignored: Optional[list] = None) -> Dict[str, Any]:
    """Reference shape_model keys -> DGSDenoiser keyword arguments; the
    names of ignored TPU-only keys are appended to `ignored`."""
    out: Dict[str, Any] = {}
    for k, v in dict(cfg).items():
        if k in TPU_ONLY_SHAPE_KEYS:
            if ignored is not None:
                ignored.append(k)
            continue
        if k not in _SHAPE_MODEL_MAP:
            raise ValueError(f"unknown shape_model key {k!r}")
        if _SHAPE_MODEL_MAP[k] is not None:
            out[_SHAPE_MODEL_MAP[k]] = v
    out.setdefault("dtype", torch.bfloat16 if bf16 else torch.float32)
    return out


def raster_config(cfg: Dict[str, Any], ignored: Optional[list] = None
                  ) -> RasterizeConfig:
    """RasterizeConfig from a `system.raster` block; the TPU-only fields it
    sets are accepted, have no effect, and their names are appended to
    `ignored`."""
    if ignored is not None:
        ignored.extend(k for k in cfg if k in TPU_ONLY_FIELDS)
    return RasterizeConfig(**dict(cfg))


def build_system(system_type: str, system_cfg: Dict[str, Any],
                 bf16: bool = True, raster: Optional[RasterizeConfig] = None,
                 device: torch.device | str = "cpu", mesh=None):
    """system_type: 'diffusion-gs-system' | 'diffusion-gs-scene-system'
    (the scene system's DiT defaults to the `plk` ray PE and its config
    takes save_intermediate_video / save_result_for_eval, JAX
    builder.py:85-88, :116-119).  Returns the system with its
    (uninitialized) model on `device`: call `init_params`, then
    `load_pretrained` (the config's weight bootstraps).  `mesh`
    (parallel/mesh.py::Mesh): the run's ranks; where its sp, tp or pp is
    > 1 it goes to the DiT as shape_model's `seq`, `model` or `pipe`, as
    JAX threads sp_mesh / tp_mesh / pp_mesh (builder.py:65-84), and the
    system draws per data rank.  Under tensor or pipeline parallelism the
    model holds this rank's parameters (parallel/shard.py)."""
    from .. import find
    from .object_system import ObjectSystemConfig
    from .scene_system import SCENE_SYSTEM, SceneSystemConfig

    cfg = dict(system_cfg)
    ignored: list = []
    loss = dict(cfg.get("loss", {}))
    noise = dict(cfg.get("noise_scheduler", {}))
    sm = shape_model_kwargs(cfg.get("shape_model", {}), bf16=bf16,
                            ignored=ignored)
    for axis, size in (("seq", "sp"), ("model", "tp"), ("pipe", "pp")):
        if mesh is not None and getattr(mesh, size) > 1:
            sm[axis] = mesh
    scene = system_type == SCENE_SYSTEM
    if scene:
        sm.setdefault("ray_pe_type", "plk")
    kwargs: Dict[str, Any] = dict(
        num_inference_steps=cfg.get("num_inference_steps", 30),
        num_train_timesteps=noise.get("num_train_timesteps", 1000),
        shape_model=sm,
    )
    # the stage-2 bootstraps, when set (JAX builder.py:96-103; missing,
    # null or empty builds without them)
    pmp = (cfg.get("shape_model") or {}).get("pretrained_model_name_or_path")
    if pmp:
        kwargs["pretrained_model_name_or_path"] = pmp
    if cfg.get("weights"):
        kwargs["weights"] = cfg["weights"]
    if cfg.get("weights_ignore_modules"):
        kwargs["weights_ignore_modules"] = tuple(cfg["weights_ignore_modules"])
    if raster is not None:
        kwargs["raster"] = raster
    elif "raster" in cfg:
        kwargs["raster"] = raster_config(cfg["raster"], ignored=ignored)
    for lam in LOSS_LAMBDAS:
        if lam in loss:
            v = loss[lam]
            kwargs[lam] = tuple(v) if isinstance(v, list) else v
    for k in ("use_lpips", "lpips_weights", "allow_random_lpips"):
        if k in cfg:
            kwargs[k] = cfg[k]
    if "bg_color" in cfg:
        kwargs["bg_color"] = tuple(cfg["bg_color"])
    if scene:
        for k in ("save_intermediate_video", "save_result_for_eval"):
            if k in cfg:
                kwargs[k] = cfg[k]
    if ignored:
        log.info("open_diffusiongs_tpu_torch: ignoring TPU-only config keys: "
                 "%s", ", ".join(ignored))
    cfg_cls = SceneSystemConfig if scene else ObjectSystemConfig
    return find(system_type)(cfg_cls(**kwargs), device=device, mesh=mesh)


def build_optimizer_config(system_cfg: Dict[str, Any],
                           trainer_cfg: Dict[str, Any]) -> OptimizerConfig:
    """OptimizerConfig from the `system.optimizer` / `system.scheduler` and
    `trainer` blocks (JAX builder.py:125-151, field for field)."""
    opt = dict(system_cfg.get("optimizer", {}))
    args = dict(opt.get("args", {}))
    sched = dict(system_cfg.get("scheduler", {}))
    sargs = dict(sched.get("args", {}))
    # composite specs (SequentialLR / ChainedScheduler) pass through whole
    # for parse_schedule's recursion
    if sched.get("schedulers"):
        scheduler = sched
    else:
        scheduler = sched.get("name", "constant") or "constant"
    return OptimizerConfig(
        name=opt.get("name", "AdamW"),
        lr=float(args.get("lr", 1e-5)),
        betas=tuple(args.get("betas", (0.9, 0.99))),
        eps=float(args.get("eps", 1e-8)),
        weight_decay=float(args.get("weight_decay", 0.01)),
        grad_clip=float(trainer_cfg.get("gradient_clip_val", 0.0) or 0.0),
        scheduler=scheduler,
        t_max=int(sargs.get("T_max", 500_000)),
        eta_min=float(sargs.get("eta_min", 0.0)),
        accumulate_grad_batches=int(
            trainer_cfg.get("accumulate_grad_batches", 1)),
        params=opt.get("params") or None,
    )
