"""GObjaverse object-level dataset — pure NumPy loader.

Replicates the reference BaseDataset pipeline (data/base.py:48-265):
  * 40-view GObjaverse layout `{uid}/campos_512_v4/{idx:05d}/{idx:05d}.png`
    + `.json` camera + `_nd.exr` normal-depth;
  * even-view azimuth sampling for the 4 generation views (:146-155),
    random k of the remaining for the 6 supervision views;
  * camera convention chain (:184-218): Blender-world/OpenCV-cam json ->
    OpenGL -> (optional) relative orbit pose re-anchoring to the first view
    -> OpenCV (COLMAP) -> custom z-up via the axis-swap matrix;
  * camera normalization to norm_radius using the LAST view's distance
    (:222-227), depth scaled along;
  * nearest-neighbor resize to training_res (F.interpolate default) and
    fxfycxcy scaled to pixel units (:229-236);
  * `*_input` = the first gen_views entries (:238-242);
  * error-retry __getitem__ (:245-250).

The port's own copy of open_diffusiongs_tpu/data/objaverse.py (ROADMAP
rule 7), line for line: the same per-draw `random.Random` keyed by
(seed, draw counter), so both packages return the same sample for the
same seed, index and draw order.  Outputs are NumPy dicts consumed by
data/loader.py's thread prefetch loader; the training loop moves them to
the device.
"""

from __future__ import annotations

import json
import os
import random
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
from PIL import Image

from .. import register
from ..utils.exr import read_depth_from_nd_exr
from .cameras import orbit_camera, undo_orbit_camera

# z-up axis swap (data/base.py:112-117)
RT_MATRIX = np.asarray([[1, 0, 0, 0],
                        [0, 0, 1, 0],
                        [0, 1, 0, 0],
                        [0, 0, 0, 1]], np.float64)


@dataclass
class ObjaverseConfig:
    local_dir: str = ""
    image_dir: str = ""
    batch_size: int = 32
    eval_batch_size: int = 1
    num_workers: int = 0
    default_fxfy: float = 1422.222 / 1024
    gen_idxs: Optional[List[int]] = None
    training_res: List[int] = field(default_factory=lambda: [256, 256])
    all_idxs: List[int] = field(default_factory=lambda: [
        0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
        20, 21, 22, 23, 24, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39])
    test_idxs: List[int] = field(default_factory=lambda: [
        0, 1, 2, 3, 4, 16, 17, 18, 19])
    gen_rel_idxs: bool = False
    sel_views: int = 4
    gen_views: int = 4
    load_image: bool = True
    load_albedo: bool = True
    load_depth: bool = True
    norm_camera: bool = True
    norm_radius: float = 1.8
    background_color: Tuple[float, float, float] = (1.0, 1.0, 1.0)


def _nearest_resize(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """torch F.interpolate(mode='nearest') equivalent. img: [..., h, w]."""
    h, w = img.shape[-2:]
    if (h, w) == (out_h, out_w):
        return img
    ys = (np.arange(out_h) * h // out_h)
    xs = (np.arange(out_w) * w // out_w)
    return img[..., ys[:, None], xs[None, :]]


def load_single_image(path: str, background_color) -> Tuple[np.ndarray, np.ndarray]:
    """RGBA png -> (rgb composited on bg [h, w, 3], mask [h, w, 1]) in [0,1]
    (data/base.py:34-45)."""
    img = np.asarray(Image.open(path).convert("RGBA"), np.float32) / 255.0
    mask = img[:, :, 3:4]
    bg = np.asarray(background_color, np.float32)
    rgb = img[:, :, :3] * mask + bg[None, None, :] * (1.0 - mask)
    return rgb, mask


def load_camera_json(path: str) -> np.ndarray:
    with open(path, "r", encoding="utf-8") as f:
        d = json.load(f)
    c2w = np.eye(4)
    c2w[:3, 0] = np.asarray(d["x"])
    c2w[:3, 1] = np.asarray(d["y"])
    c2w[:3, 2] = np.asarray(d["z"])
    c2w[:3, 3] = np.asarray(d["origin"])
    return c2w


def read_dnormal_depth(path: str, cond_pos: np.ndarray) -> np.ndarray:
    """Depth from `_nd.exr` with the near-plane zeroing (data/base.py:20-31)."""
    cond_cam_dis = float(np.linalg.norm(cond_pos))
    near_distance = cond_cam_dis - 0.867  # sqrt(3) * 0.5
    depth = read_depth_from_nd_exr(path).astype(np.float32)
    depth[depth < near_distance] = 0.0
    return depth


def pick_even_view_indices(num_views: int, rng: random.Random) -> List[int]:
    """DiffSplat-style even-azimuth sampling (data/base.py:146-155)."""
    assert 12 % num_views == 0
    if rng.random() < 2.0 / 3.0:
        index0 = rng.randrange(24)
        return [(index0 + (24 // num_views) * i) % 24 for i in range(num_views)]
    index0 = rng.randrange(12)
    return [((index0 + (12 // num_views) * i) % 12 + 27)
            for i in range(num_views)]


@register("Objaverse-datamodule")
class ObjaverseDataset:
    """Map-style dataset; `__getitem__` returns a dict of NumPy arrays."""

    def __init__(self, cfg: ObjaverseConfig, split: str = "train",
                 seed: int = 0):
        if isinstance(cfg, dict):
            cfg = ObjaverseConfig(**cfg)
        self.cfg = cfg
        self.split = split
        with open(os.path.join(cfg.local_dir, f"{split}.json")) as f:
            self.uids = json.load(f)
        self.seed = seed
        # loader threads call __getitem__ concurrently: a shared Random
        # would interleave its state non-deterministically, so each draw
        # gets its own Random keyed by (seed, index, draw counter)
        self._draw_lock = threading.Lock()
        self._draws = 0
        f_ = cfg.default_fxfy
        self.fxfycxcy = np.asarray([f_, f_, 0.5, 0.5], np.float32)

    def _rng(self) -> random.Random:
        with self._draw_lock:
            self._draws += 1
            n = self._draws
        return random.Random((self.seed << 32) ^ (n * 0x9E3779B97F4A7C15))

    def __len__(self):
        return len(self.uids)

    def _get_data(self, index: int) -> Dict[str, Any]:
        cfg = self.cfg
        uid = self.uids[index]
        rng = self._rng()
        if cfg.gen_rel_idxs:
            sel_gen = pick_even_view_indices(cfg.gen_views, rng)
        else:
            sel_gen = list(cfg.gen_idxs)
        remaining = [i for i in cfg.all_idxs if i not in set(sel_gen)]
        sel_train = rng.sample(remaining, k=cfg.sel_views)
        all_idxs = sel_gen + sel_train

        rgbs, masks, depths, c2ws = [], [], [], []
        init_azi = None
        for idx in all_idxs:
            d = os.path.join(cfg.image_dir, uid, "campos_512_v4",
                             f"{idx:05d}")
            prefix = os.path.join(d, f"{idx:05d}")
            rgb, mask = load_single_image(prefix + ".png",
                                          cfg.background_color)
            c2w = load_camera_json(prefix + ".json")
            # Blender world + OpenCV cam -> OpenGL world & cam
            c2w[1] *= -1
            c2w[[1, 2]] = c2w[[2, 1]]
            c2w[:3, 1:3] *= -1
            if cfg.gen_rel_idxs:
                ele, azi, dis = undo_orbit_camera(c2w)
                if init_azi is None:
                    init_azi = azi
                azi = (azi - init_azi) % 360.0
                ele_sign = ele >= 0
                ele = abs(ele) - 1e-8
                ele = ele * (1.0 if ele_sign else -1.0)
                c2w = orbit_camera(ele, azi, dis)
            depth = read_dnormal_depth(prefix + "_nd.exr", c2w[:3, 3:])
            rgbs.append(rgb)
            masks.append(mask)
            depths.append(depth)
            c2ws.append(c2w)

        # [v, c, h, w]
        rgbs = np.stack(rgbs).transpose(0, 3, 1, 2).astype(np.float32)
        masks = np.stack(masks).transpose(0, 3, 1, 2).astype(np.float32)
        depths = np.stack(depths).transpose(0, 3, 1, 2).astype(np.float32)
        c2ws = np.stack(c2ws).astype(np.float32)

        # OpenGL -> OpenCV (COLMAP), then custom z-up (data/base.py:216-218)
        c2ws[:, :3, 1:3] *= -1
        c2ws = (RT_MATRIX[None] @ c2ws).astype(np.float32)

        scale = (cfg.norm_radius / np.linalg.norm(c2ws[-1, :3, 3])
                 if cfg.norm_camera else 1.0)
        c2ws[:, :3, 3] *= scale
        depths = depths * scale

        th, tw = cfg.training_res
        rgbs = _nearest_resize(rgbs, th, tw)
        depths = _nearest_resize(depths, th, tw)
        masks = _nearest_resize(masks, th, tw)
        fxy = np.tile(self.fxfycxcy[None], (rgbs.shape[0], 1)).copy()
        fxy[:, 0] *= th
        fxy[:, 2] *= th
        fxy[:, 1] *= tw
        fxy[:, 3] *= tw

        gv = cfg.gen_views
        return {
            "uid": uid,
            "rgbs": rgbs, "masks": masks, "depths": depths,
            "c2ws": c2ws, "fxfycxcys": fxy,
            "rgbs_input": rgbs[:gv], "masks_input": masks[:gv],
            "depths_input": depths[:gv], "c2ws_input": c2ws[:gv],
            "fxfycxcys_input": fxy[:gv],
        }

    def __getitem__(self, index: int) -> Dict[str, Any]:
        try:
            return self._get_data(index)
        except Exception as e:  # skip-bad-sample policy (data/base.py:245-250)
            print(f"Error in {self.uids[index]}: {e}")
            return self[self._rng().randrange(len(self))]
