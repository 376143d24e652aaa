"""Gaussian parameter containers, activations and export filters (PyTorch).

Counterpart of open_diffusiongs_tpu/ops/gaussians.py:23-133 (which imports
jax.numpy, so it is re-implemented here).  `Gaussians` holds raw
(pre-activation) tensors; activations match gs_core.py:330-334
(scaling -> exp, rotation -> L2 normalize, opacity -> sigmoid).  The export
filters run on the host in NumPy, like the JAX package's.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch


class Gaussians(NamedTuple):
    """Raw per-Gaussian parameters [..., N, ...]: xyz [3], features
    [(sh+1)², 3], scaling [3] (log), rotation [4] (unnormalized w, x, y, z),
    opacity [1] (logit)."""

    xyz: torch.Tensor
    features: torch.Tensor
    scaling: torch.Tensor
    rotation: torch.Tensor
    opacity: torch.Tensor

    @property
    def sh_degree(self) -> int:
        return int(round(self.features.shape[-2] ** 0.5)) - 1

    def activate(self) -> "ActivatedGaussians":
        """Render-time activations; opacity is squeezed to [..., N]."""
        rot = self.rotation.float()
        rot = rot / torch.clamp(torch.linalg.norm(rot, dim=-1, keepdim=True),
                                min=1e-12)
        return ActivatedGaussians(
            xyz=self.xyz.float(),
            features=self.features.float(),
            scaling=torch.exp(self.scaling.float()),
            rotation=rot,
            opacity=(1.0 / (1.0 + torch.exp(-self.opacity.float())))
            .squeeze(-1))


class ActivatedGaussians(NamedTuple):
    """Post-activation parameters fed to the rasterizer (opacity [..., N])."""

    xyz: torch.Tensor
    features: torch.Tensor
    scaling: torch.Tensor
    rotation: torch.Tensor
    opacity: torch.Tensor


class NumpyGaussians(NamedTuple):
    """Host-side raw Gaussians for filtering / PLY export."""

    xyz: np.ndarray
    features: np.ndarray
    scaling: np.ndarray
    rotation: np.ndarray
    opacity: np.ndarray

    @staticmethod
    def from_tensors(g: Gaussians) -> "NumpyGaussians":
        return NumpyGaussians(*(x.detach().float().cpu().numpy() for x in g))

    def filter(self, mask: np.ndarray) -> "NumpyGaussians":
        return NumpyGaussians(*(x[mask] for x in self))

    def opacity_activated(self) -> np.ndarray:
        return 1.0 / (1.0 + np.exp(-self.opacity[..., 0]))

    def prune(self, opacity_thres: float = 0.05) -> "NumpyGaussians":
        """Drop low-opacity Gaussians (gs_core.py:420-424)."""
        return self.filter(self.opacity_activated() > opacity_thres)

    def crop(self, bbx: Tuple[float, ...] = (-1, 1, -1, 1, -1, 1)
             ) -> "NumpyGaussians":
        """Keep Gaussians inside an axis-aligned box (gs_core.py:405-418)."""
        x0, x1, y0, y1, z0, z1 = bbx
        p = self.xyz
        keep = ((p[:, 0] >= x0) & (p[:, 0] <= x1)
                & (p[:, 1] >= y0) & (p[:, 1] <= y1)
                & (p[:, 2] >= z0) & (p[:, 2] <= z1))
        return self.filter(keep)

    def prune_by_nearfar(self, cam_origins: np.ndarray,
                         nearfar_percent=(0.01, 0.99)) -> "NumpyGaussians":
        """Drop points outside per-camera distance quantiles
        (gs_core.py:426-461)."""
        dists = np.linalg.norm(self.xyz[:, None, :] - cam_origins[None],
                               axis=-1)
        lo = np.quantile(dists, nearfar_percent[0], axis=0, keepdims=True)
        hi = np.quantile(dists, nearfar_percent[1], axis=0, keepdims=True)
        reject = ((dists < lo) | (dists > hi)).any(axis=1)
        return self.filter(~reject)

    def apply_all_filters(self, opacity_thres: float = 0.05,
                          crop_bbx=(-1, 1, -1, 1, -1, 1),
                          cam_origins: Optional[np.ndarray] = None,
                          nearfar_percent=(0.005, 1.0)) -> "NumpyGaussians":
        """Standard export filter chain (gs_core.py:463-475)."""
        out = self.prune(opacity_thres)
        if crop_bbx is not None:
            out = out.crop(crop_bbx)
        if cam_origins is not None:
            out = out.prune_by_nearfar(cam_origins, nearfar_percent)
        return out
