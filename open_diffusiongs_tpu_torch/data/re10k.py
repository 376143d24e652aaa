"""RealEstate10K scene dataset — pure NumPy loader.

Replicates the reference scene dataset (data/base_scene.py):
  * train split: full_list.txt of per-scene metadata JSONs (one per line);
    eval split: filtered by `evaluation_index_re10k.json` (input =
    context[0], targets from the index file) (:41-72, 159-172);
  * LANCZOS resize to training_res height, width rounded to patch_size,
    center square crop, intrinsics rescaled/shifted along (:79-120);
  * pose normalization: align to the mean camera then scale translations by
    1/(1.35 * max|t|) (:122-156);
  * `*_input` = first sel_views+1 entries (:197-200); error-retry getitem.

The port's own copy of open_diffusiongs_tpu/data/re10k.py (ROADMAP rule
7), line for line, with the same per-draw rng.
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


@dataclass
class RE10KConfig:
    local_dir: str = ""              # full_list.txt (train)
    local_eval_dir: str = ""         # full_list.txt (eval)
    view_idx_file_path: str = "extra_files/evaluation_index_re10k.json"
    batch_size: int = 32
    eval_batch_size: int = 1
    eval_subset: int = -1
    num_workers: int = 0
    training_res: List[int] = field(default_factory=lambda: [256, 256])
    patch_size: int = 8
    sel_views_train: int = 4
    sel_views: int = 4
    scene_scale_factor: float = 1.35
    square_crop: bool = True
    load_image: bool = True


def preprocess_poses(c2ws: np.ndarray, scene_scale_factor: float = 1.35
                     ) -> np.ndarray:
    """Mean-camera alignment + scale normalization (base_scene.py:122-156)."""
    c2ws = c2ws.astype(np.float64)
    center = c2ws[:, :3, 3].mean(0)
    fwd = c2ws[:, :3, 2].mean(0)
    fwd = fwd / np.linalg.norm(fwd)
    down = c2ws[:, :3, 1].mean(0)
    right = np.cross(down, fwd)
    right = right / np.linalg.norm(right)
    down = np.cross(fwd, right)
    down = down / np.linalg.norm(down)
    avg = np.eye(4)
    avg[:3, :3] = np.stack([right, down, fwd], axis=-1)
    avg[:3, 3] = center
    c2ws = np.linalg.inv(avg)[None] @ c2ws
    scale = scene_scale_factor * np.abs(c2ws[:, :3, 3]).max()
    c2ws[:, :3, 3] /= max(scale, 1e-8)
    return c2ws.astype(np.float32)


@register("Re10k-datamodule")
class RE10KDataset:
    def __init__(self, cfg: RE10KConfig, split: str = "train", seed: int = 0):
        if isinstance(cfg, dict):
            cfg = RE10KConfig(**cfg)
        self.cfg = cfg
        self.split = split
        self.seed = seed
        self._draw_lock = threading.Lock()
        self._draws = 0
        path = cfg.local_dir if split == "train" else cfg.local_eval_dir
        with open(path) as f:
            uids = [l.strip() for l in f.read().splitlines() if l.strip()]
        self.view_idx_list: Dict[str, Any] = {}
        if split != "train" and cfg.view_idx_file_path and \
                os.path.exists(cfg.view_idx_file_path):
            with open(cfg.view_idx_file_path) as f:
                self.view_idx_list = json.load(f)
            keep = {k for k, v in self.view_idx_list.items() if v is not None}
            uids = [u for u in uids
                    if os.path.basename(u).split(".")[0] in keep]
            if cfg.eval_subset > 0:
                uids = uids[:cfg.eval_subset]
        self.uids = uids

    def __len__(self):
        return len(self.uids)

    def _rng(self) -> random.Random:
        # thread-safe per-draw rng (loader threads call __getitem__
        # concurrently; see data/objaverse.py)
        with self._draw_lock:
            self._draws += 1
            n = self._draws
        return random.Random((self.seed << 32) ^ (n * 0x9E3779B97F4A7C15))

    def _preprocess_frames(self, frames, image_paths):
        cfg = self.cfg
        resize_h = cfg.training_res[0]
        images, intr = [], []
        for frame, img_path in zip(frames, image_paths):
            image = Image.open(img_path)
            ow, oh = image.size
            resize_w = int(resize_h / oh * ow)
            resize_w = int(round(resize_w / cfg.patch_size) * cfg.patch_size)
            image = image.resize((resize_w, resize_h), Image.LANCZOS)
            start_h = start_w = 0
            if cfg.square_crop:
                m = min(resize_h, resize_w)
                start_h = (resize_h - m) // 2
                start_w = (resize_w - m) // 2
                image = image.crop((start_w, start_h, start_w + m, start_h + m))
            arr = np.asarray(image, np.float32)[..., :3] / 255.0
            fxy = np.asarray(frame["fxfycxcy"], np.float64).copy()
            fxy *= (resize_w / ow, resize_h / oh, resize_w / ow, resize_h / oh)
            if cfg.square_crop:
                fxy[2] -= start_w
                fxy[3] -= start_h
            images.append(arr.transpose(2, 0, 1))
            intr.append(fxy.astype(np.float32))
        w2cs = np.stack([np.asarray(f["w2c"], np.float64) for f in frames])
        c2ws = np.linalg.inv(w2cs).astype(np.float32)
        return (np.stack(images), np.stack(intr), c2ws)

    def _get_data(self, index: int) -> Dict[str, Any]:
        cfg = self.cfg
        scene_path = self.uids[index].strip()
        with open(scene_path) as f:
            data = json.load(f)
        frames = data["frames"]
        scene_name = data["scene_name"]
        if self.split != "train" and scene_name in self.view_idx_list:
            vi = self.view_idx_list[scene_name]
            image_indices = list(vi["context"][:1]) + list(vi["target"])
        else:
            image_indices = self._rng().sample(
                range(len(frames)), cfg.sel_views + cfg.sel_views_train)
        chosen = [frames[i] for i in image_indices]
        paths = [f["image_path"] for f in chosen]
        rgbs, fxy, c2ws = self._preprocess_frames(chosen, paths)
        c2ws = preprocess_poses(c2ws, cfg.scene_scale_factor)
        n_in = cfg.sel_views + 1
        ret = {
            "uid": scene_name,
            "rgbs": rgbs, "c2ws": c2ws, "fxfycxcys": fxy,
            "masks": np.ones_like(rgbs[:, :1]),
            "image_indices": np.asarray(image_indices, np.int64)[:, None],
        }
        ret["rgbs_input"] = rgbs[:n_in]
        ret["c2ws_input"] = c2ws[:n_in]
        ret["fxfycxcys_input"] = fxy[:n_in]
        ret["masks_input"] = ret["masks"][:n_in]
        return ret

    def __getitem__(self, index: int) -> Dict[str, Any]:
        try:
            return self._get_data(index)
        except Exception as e:
            print(f"Error in {self.uids[index]}: {e}")
            return self[self._rng().randrange(len(self))]
