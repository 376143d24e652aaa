"""DiffusionGSPipeline — single image -> 3D Gaussians (PyTorch).

Counterpart of open_diffusiongs_tpu/pipeline.py:63-294: preprocess the
input image (background removal, foreground-ratio recentring, white pad),
build the 4-view camera template, run the 30-step sampler, filter the
Gaussians and export PLY and, on request, a mesh (ops/mesh.py, whose
density field is a CUDA kernel).  `from_pretrained` (JAX :160-193) loads a
pretrained directory (config.yaml + ckpts/, made from reference weights by
the port's tools/make_pretrained_dir.py); the constructor wraps a system
whose model the caller initialized or loaded.

`batch(..., mesh=)` serves one request bundle over the data ranks of a
parallel/mesh.py::Mesh (JAX `batch(device_mesh=)`, :211-273): each data
rank samples its rows, drawing the whole bundle's noise at every draw and
keeping its rows (so each element gets the noise it gets unsharded), runs
the filters, mesh and PLY of its own elements, and every rank returns the
whole list in input order, gathered over the data ranks.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from PIL import Image

from .ops.gaussians import NumpyGaussians
from .utils.ply import save_gaussians_ply
from .utils.saving import turntable_cameras
from .utils.timing import StageClock


@dataclasses.dataclass
class GSPipelineOutput:
    """pipline_obj.py:17-27 equivalent, plus the final render's counters."""

    gaussians: NumpyGaussians
    renders: np.ndarray          # [v, 3, h, w]
    input_image: np.ndarray      # [3, h, w] preprocessed condition
    stats: Dict[str, int] = dataclasses.field(default_factory=dict)
    mesh: Optional[Tuple[np.ndarray, np.ndarray]] = None  # (verts, tris)
    # host seconds of the mesh export's steps (ops/mesh.py::extract_mesh)
    mesh_seconds: Dict[str, float] = dataclasses.field(default_factory=dict)


_U2NET_CACHE: dict = {}


def _u2net_net(device):
    """The converted U²-Net weights at $U2NET_NPZ (default
    ~/.cache/open_diffusiongs_tpu/u2net.npz) as a module on `device`,
    cached; None when no NPZ is there.  $U2NET_SPEC selects the variant
    ("u2net", the default, or "u2netp") (JAX pipeline.py:48-61)."""
    from .utils import u2net
    spec_name = os.environ.get("U2NET_SPEC", "u2net")
    path = u2net.default_weights_path()
    key = (path, spec_name, str(device))
    if key not in _U2NET_CACHE:
        _U2NET_CACHE[key] = (
            u2net.U2Net(u2net.load_params(path, u2net.SPECS[spec_name]),
                        u2net.SPECS[spec_name]).to(device)
            if os.path.exists(path) else None)
    return _U2NET_CACHE[key]


def remove_background(img: np.ndarray, matting: str = "u2net",
                      device=None) -> np.ndarray:
    """[h, w, 3] uint8 -> alpha [h, w] in [0, 1], by an explicit method
    (JAX pipeline.py:64-107):
      * "u2net": the reference's learned model (utils/u2net.py), from a
        converted weights NPZ at $U2NET_NPZ (tools/convert_u2net_weights.py
        writes one), run on `device` (the GPU, raising without one, unless
        it names another); raises when no NPZ is there;
      * "grabcut": from-scratch GrabCut (utils/matting.py, the port's copy
        of the JAX package's module, + native/matting.cpp);
      * "border": the median-border-colour heuristic (studio shots)."""
    if matting == "u2net":
        from . import select_device
        from .utils import u2net
        net = _u2net_net(select_device(device))
        if net is None:
            raise RuntimeError(
                "Background removal is configured for U²-Net (the "
                "reference's rembg model) but no converted weights NPZ "
                "exists at $U2NET_NPZ / the default cache path. Convert "
                "one with tools/convert_u2net_weights.py, or explicitly "
                "acknowledge the degraded fallback with matting='grabcut' "
                "(or 'border').")
        return u2net.u2net_alpha(net, img)
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
                     size: int = 512, matting: str = "u2net",
                     device=None) -> np.ndarray:
    """Background removal (on `device` for u2net) + recentre to
    foreground_ratio + white pad square (pipline_obj.py
    preprocess_image:97-167).  Returns [3, size, size] f32 in [0, 1]."""
    rgba = np.asarray(image.convert("RGBA"), np.uint8)
    rgb = rgba[..., :3]
    if (rgba[..., 3] < 250).any():
        alpha = rgba[..., 3].astype(np.float32) / 255.0
    else:
        alpha = remove_background(rgb, matting=matting, device=device)
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
                 extract_mesh: bool = False, mesh_resolution: int = 256,
                 opacity_thres: float = 0.02,
                 crop_bbx: Tuple[float, ...] = (-0.91, 0.91) * 3,
                 save_ply: Optional[str] = None,
                 matting: str = "u2net") -> GSPipelineOutput:
        """Single image -> 3D (pipline_obj.py __call__:229-322)."""
        return self.batch(
            [image], seed=seed, foreground_ratio=foreground_ratio,
            resolution=resolution, n_views=n_views,
            extract_mesh=extract_mesh, mesh_resolution=mesh_resolution,
            opacity_thres=opacity_thres, crop_bbx=crop_bbx,
            save_ply=[save_ply] if save_ply else None, matting=matting)[0]

    def batch(self, images, seed: int = 0, foreground_ratio: float = 0.85,
              resolution: int = 256, n_views: int = 4,
              extract_mesh: bool = False, mesh_resolution: int = 256,
              opacity_thres: float = 0.02,
              crop_bbx: Tuple[float, ...] = (-0.91, 0.91) * 3,
              save_ply=None, matting: str = "u2net",
              stage_seconds: Optional[Dict[str, float]] = None,
              mesh=None) -> list:
        """Images (paths, PIL images or [3, h, w] arrays) -> one
        GSPipelineOutput each, sampled together as one batch.  With
        `extract_mesh` each image's filtered Gaussians are meshed as JAX
        meshes them (ops/mesh.py::extract_mesh at `mesh_resolution`, the
        density field on the system's device; each output's
        `mesh_seconds` splits its host time by step).  `save_ply`: optional
        per-image output paths (None entries skip).  `stage_seconds`: a
        dict that receives each stage's host seconds (preprocess,
        camera_template, sampler, transfer, filters, mesh when asked, ply),
        each edge synchronized with the device.  `mesh`: serve over its
        data ranks (module docstring; every rank of the mesh calls this
        with the same arguments); len(images) must divide them."""
        dev = self.system.device
        clock = StageClock(stage_seconds, dev)
        n_all = len(images)
        dp, d = (1, 0) if mesh is None else (mesh.dp, mesh.data_rank)
        if n_all % dp:
            raise ValueError(f"batch {n_all} must divide the data ranks "
                             f"({dp}); pad the request bundle with a repeat "
                             f"image and drop the extras")
        rows = slice(d * n_all // dp, (d + 1) * n_all // dp)
        images = list(images)[rows]
        save_ply = None if save_ply is None else list(save_ply)[rows]
        conds = []
        for image in images:
            if isinstance(image, str):
                image = Image.open(image)
            if isinstance(image, Image.Image):
                cond = preprocess_image(image, foreground_ratio, resolution,
                                        matting=matting, device=dev)
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
        if dp == 1:
            out = self.system.sample(cond_t, c2w_t, fxy_t, gen)
        else:
            def draw(t_idx=None):
                # the whole bundle's draw, this data rank's rows
                return torch.randn((n_all, n_views - 1, 3, resolution,
                                    resolution), generator=gen,
                                   device=dev)[rows]
            out = self.system.sample(cond_t, c2w_t, fxy_t, gen,
                                     noise=draw(), noise_fn=draw)
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
            tris, mesh_seconds = None, {}
            if extract_mesh:
                from .ops.mesh import extract_mesh as _extract
                tris = _extract(g, resolution=mesh_resolution, device=dev,
                                stage_seconds=mesh_seconds)
                clock.stage("mesh")
            if save_ply and save_ply[i]:
                save_gaussians_ply(g, save_ply[i])
            clock.stage("ply")
            results.append(GSPipelineOutput(
                gaussians=g, renders=renders_all[i], input_image=conds[i],
                stats=stats, mesh=tris, mesh_seconds=mesh_seconds))
        if dp == 1:
            return results
        gathered = [None] * dp
        dist.all_gather_object(gathered, results,
                               group=mesh.groups.get("data"))
        return [r for part in gathered for r in part]

