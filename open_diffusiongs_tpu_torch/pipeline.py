"""DiffusionGSPipeline — single image -> 3D Gaussians (PyTorch).

Counterpart of open_diffusiongs_tpu/pipeline.py:63-294: preprocess the
input image (background removal, foreground-ratio recentring, white pad),
build the 4-view camera template, run the 30-step sampler, filter the
Gaussians and export PLY.  `from_pretrained` (JAX :160-193) loads a
pretrained directory (config.yaml + ckpts/, made from reference weights by
the port's tools/make_pretrained_dir.py); the constructor wraps a system
whose model the caller initialized or loaded.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from PIL import Image

from .ops.gaussians import NumpyGaussians
from .utils.ply import save_gaussians_ply
from .utils.saving import turntable_cameras


@dataclasses.dataclass
class GSPipelineOutput:
    """pipline_obj.py:17-27 equivalent, plus the final render's counters."""

    gaussians: NumpyGaussians
    renders: np.ndarray          # [v, 3, h, w]
    input_image: np.ndarray      # [3, h, w] preprocessed condition
    stats: Dict[str, int] = dataclasses.field(default_factory=dict)


def remove_background(img: np.ndarray, matting: str = "u2net") -> np.ndarray:
    """[h, w, 3] uint8 -> alpha [h, w] in [0, 1], by an explicit method:
      * "u2net": the reference's learned model — its weights are not in
        the repository, so this raises, as the JAX pipeline does without
        its converted weights;
      * "grabcut": from-scratch GrabCut (utils/matting.py, the port's copy
        of the JAX package's module, + native/matting.cpp);
      * "border": the median-border-colour heuristic (studio shots)."""
    if matting == "u2net":
        raise RuntimeError(
            "matting='u2net' needs the U²-Net weights, which this port does "
            "not have; pass matting='grabcut' or 'border' to acknowledge the "
            "fallback")
    if matting == "grabcut":
        from .utils import matting as matting_lib
        if not matting_lib.available():
            raise RuntimeError(
                "matting='grabcut' needs the native min-cut solver (build "
                "native/matting.cpp); use matting='border' to acknowledge "
                "the heuristic fallback")
        return matting_lib.grabcut_alpha(img)
    if matting != "border":
        raise ValueError(f"unknown matting method {matting!r} "
                         "(expected u2net | grabcut | border)")
    border = np.concatenate([img[0], img[-1], img[:, 0], img[:, -1]], axis=0)
    bg = np.median(border.reshape(-1, 3), axis=0)
    dist = np.linalg.norm(img.astype(np.float32) - bg[None, None], axis=-1)
    return np.clip((dist - 20.0) / 40.0, 0.0, 1.0)


def preprocess_image(image: Image.Image, foreground_ratio: float = 0.85,
                     size: int = 512, matting: str = "u2net") -> np.ndarray:
    """Background removal + recentre to foreground_ratio + white pad square
    (pipline_obj.py preprocess_image:97-167).  Returns [3, size, size] f32
    in [0, 1]."""
    rgba = np.asarray(image.convert("RGBA"), np.uint8)
    rgb = rgba[..., :3]
    if (rgba[..., 3] < 250).any():
        alpha = rgba[..., 3].astype(np.float32) / 255.0
    else:
        alpha = remove_background(rgb, matting=matting)
    mask = alpha > 0.5
    if not mask.any():
        mask = np.ones_like(alpha, dtype=bool)
    ys, xs = np.nonzero(mask)
    y0, y1, x0, x1 = ys.min(), ys.max() + 1, xs.min(), xs.max() + 1
    fg = rgb[y0:y1, x0:x1].astype(np.float32)
    fa = alpha[y0:y1, x0:x1]
    comp = fg * fa[..., None] + 255.0 * (1.0 - fa[..., None])

    h, w = comp.shape[:2]
    target = int(size * foreground_ratio)
    s = target / max(h, w)
    nh, nw = max(1, int(round(h * s))), max(1, int(round(w * s)))
    comp_img = Image.fromarray(comp.astype(np.uint8)).resize(
        (nw, nh), Image.LANCZOS)
    canvas = np.full((size, size, 3), 255, np.uint8)
    oy, ox = (size - nh) // 2, (size - nw) // 2
    canvas[oy:oy + nh, ox:ox + nw] = np.asarray(comp_img)
    return canvas.transpose(2, 0, 1).astype(np.float32) / 255.0


def object_camera_template(n_views: int = 4, radius: float = 3.0,
                           elevation_deg: float = 5.0, h: int = 256,
                           w: int = 256):
    """4-view template: view 0 = input, views 1..3 = evenly spaced azimuths
    (pipline_obj.py:269-287); focal = GObjaverse's 1422.222/1024 * res."""
    return turntable_cameras(n_views, radius=radius,
                             elevation_deg=elevation_deg, h=h, w=w,
                             focal=1422.222 / 1024.0 * w)


class DiffusionGSPipeline:
    """Image -> 3D Gaussians over an ObjectSystem whose model holds the
    weights; runs on the system's device."""

    def __init__(self, system):
        self.system = system

    @classmethod
    def from_pretrained(cls, path: str, bf16: bool = True,
                        overrides: Optional[list] = None,
                        device=None) -> "DiffusionGSPipeline":
        """path: a directory with config.yaml + ckpts/ (JAX
        pipeline.py:160-193, local form).  The system is built from the
        config with the dotlist `overrides` applied (serving knobs such
        as "system.raster.max_per_tile=2048", which change no parameter),
        initialized, then loaded strict from the latest checkpoint, its
        EMA weights when it has them.  Runs on the GPU (raising without
        one) unless `device` names another, e.g. "cpu"."""
        from . import select_device
        from .systems.builder import build_system
        from .utils.checkpoint import load_module_weights, load_weights_file
        from .utils.config import load_config

        dev = select_device(device)
        cfg = load_config(os.path.join(path, "config.yaml"),
                          cli_args=list(overrides or []), makedirs=False)
        system = build_system(cfg.system_type, cfg.system, bf16=bf16,
                              device=dev)
        system.init_params(torch.Generator(device=dev).manual_seed(0))
        load_module_weights(system.model, load_weights_file(
            os.path.join(path, "ckpts"), use_ema=True), strict=True)
        return cls(system)

    def __call__(self, image, seed: int = 0, foreground_ratio: float = 0.85,
                 resolution: int = 256, n_views: int = 4,
                 opacity_thres: float = 0.02,
                 crop_bbx: Tuple[float, ...] = (-0.91, 0.91) * 3,
                 save_ply: Optional[str] = None,
                 matting: str = "u2net") -> GSPipelineOutput:
        """Single image -> 3D (pipline_obj.py __call__:229-322)."""
        return self.batch(
            [image], seed=seed, foreground_ratio=foreground_ratio,
            resolution=resolution, n_views=n_views,
            opacity_thres=opacity_thres, crop_bbx=crop_bbx,
            save_ply=[save_ply] if save_ply else None, matting=matting)[0]

    def batch(self, images, seed: int = 0, foreground_ratio: float = 0.85,
              resolution: int = 256, n_views: int = 4,
              opacity_thres: float = 0.02,
              crop_bbx: Tuple[float, ...] = (-0.91, 0.91) * 3,
              save_ply=None, matting: str = "u2net",
              stage_seconds: Optional[Dict[str, float]] = None) -> list:
        """Images (paths, PIL images or [3, h, w] arrays) -> one
        GSPipelineOutput each, sampled together as one batch.  `save_ply`:
        optional per-image output paths (None entries skip).
        `stage_seconds`: a dict that receives each stage's host seconds
        (preprocess, camera_template, sampler, transfer, filters, ply),
        each edge synchronized with the device."""
        dev = self.system.device
        clock = StageClock(stage_seconds, dev)
        conds = []
        for image in images:
            if isinstance(image, str):
                image = Image.open(image)
            if isinstance(image, Image.Image):
                cond = preprocess_image(image, foreground_ratio, resolution,
                                        matting=matting)
            else:
                cond = np.asarray(image, np.float32)
            conds.append(cond)
        clock.stage("preprocess")
        b = len(conds)
        c2ws, fxy = object_camera_template(n_views, h=resolution,
                                           w=resolution)
        cond_t = torch.from_numpy(np.stack(conds)[:, None]).to(dev)
        c2w_t = torch.from_numpy(c2ws).to(dev)[None].expand(b, -1, -1, -1)
        fxy_t = torch.from_numpy(fxy).to(dev)[None].expand(b, -1, -1)
        gen = torch.Generator(device=dev).manual_seed(seed)
        clock.stage("camera_template")
        out = self.system.sample(cond_t, c2w_t, fxy_t, gen)
        clock.stage("sampler")

        g_all = NumpyGaussians.from_tensors(out["gaussians"])
        renders_all = out["renders"].float().cpu().numpy()
        stats = {k: int(out[k]) for k in ("overflow_tiles",
                                          "overflow_gaussians",
                                          "binned_entries")}
        clock.stage("transfer")
        results = []
        for i in range(b):
            g = NumpyGaussians(*(x[i] for x in g_all))
            g = g.apply_all_filters(opacity_thres=opacity_thres,
                                    crop_bbx=crop_bbx)
            clock.stage("filters")
            if save_ply and save_ply[i]:
                save_gaussians_ply(g, save_ply[i])
            clock.stage("ply")
            results.append(GSPipelineOutput(
                gaussians=g, renders=renders_all[i], input_image=conds[i],
                stats=stats))
        return results


class StageClock:
    """Adds the host seconds since the previous edge to `seconds[name]` at
    each `stage(name)`, synchronizing a CUDA device at every edge; does
    nothing when `seconds` is None."""

    def __init__(self, seconds: Optional[Dict[str, float]], device):
        self.seconds = seconds
        self.cuda = torch.device(device).type == "cuda"
        self.t = self._now()

    def _now(self) -> float:
        if self.seconds is not None and self.cuda:
            torch.cuda.synchronize()
        return time.perf_counter()

    def stage(self, name: str) -> None:
        if self.seconds is None:
            return
        t = self._now()
        self.seconds[name] = self.seconds.get(name, 0.0) + t - self.t
        self.t = t
