"""DDIM scheduler (torch).

Counterpart of open_diffusiongs_tpu/diffusion/ddim.py (:33-98), the
compact form of the diffusers-derived DDIMScheduler the reference
registers as `noise_scheduler_type` (models/scheduler/ddim_scheduler.py:
131-520).  The shipped sampler is diffusion/gaussian_diffusion.py; this one
keeps the same surface (set_timesteps / add_noise / step with eta,
prediction_type "sample" | "epsilon" | "v_prediction") for configs that
name it.  The tables stay host NumPy arrays, as in JAX; each call takes
them to the sample's device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .gaussian_diffusion import get_named_beta_schedule


def _table(table: np.ndarray, idx, like: torch.Tensor) -> torch.Tensor:
    """table[idx] as an f32 tensor on like's device."""
    return torch.as_tensor(table, device=like.device)[
        torch.as_tensor(idx, device=like.device)]


class DDIMScheduler:
    """Minimal diffusers-compatible DDIM."""

    def __init__(self, num_train_timesteps: int = 1000,
                 beta_schedule: str = "squaredcos_cap_v2",
                 prediction_type: str = "sample",
                 clip_sample: bool = True,
                 set_alpha_to_one: bool = True, **_unused):
        betas = get_named_beta_schedule(beta_schedule, num_train_timesteps)
        acp = np.cumprod(1.0 - betas)
        self.num_train_timesteps = num_train_timesteps
        self.prediction_type = prediction_type
        self.clip_sample = clip_sample
        self.alphas_cumprod = np.asarray(acp, np.float32)
        self.final_alpha_cumprod = np.float32(
            1.0 if set_alpha_to_one else acp[0])
        self.timesteps = np.arange(num_train_timesteps - 1, -1, -1)
        self.num_inference_steps = num_train_timesteps

    def set_timesteps(self, num_inference_steps: int):
        step = self.num_train_timesteps // num_inference_steps
        self.num_inference_steps = num_inference_steps
        self.timesteps = (np.arange(0, num_inference_steps) * step
                          ).round()[::-1].copy().astype(np.int64)

    def add_noise(self, original: torch.Tensor, noise: torch.Tensor,
                  t) -> torch.Tensor:
        """sqrt(a_t) x0 + sqrt(1 - a_t) noise; t [...] broadcast over the
        trailing dimensions of `original`."""
        t = torch.as_tensor(t, device=original.device)
        a = _table(self.alphas_cumprod, t, original).reshape(
            t.shape + (1,) * (original.dim() - t.dim()))
        return torch.sqrt(a) * original + torch.sqrt(1.0 - a) * noise

    def step(self, model_output: torch.Tensor, t: int,
             sample: torch.Tensor, eta: float = 0.0,
             generator: Optional[torch.Generator] = None):
        """One DDIM update x_t -> x_{t-step}; returns (prev, x0).  eta > 0
        draws its noise from `generator` (on the sample's device)."""
        t = int(t)
        prev_t = t - self.num_train_timesteps // self.num_inference_steps
        a_t = float(self.alphas_cumprod[t])
        a_prev = float(self.alphas_cumprod[prev_t] if prev_t >= 0
                       else self.final_alpha_cumprod)
        # the scalars are f32 as JAX's table entries are
        a_t, a_prev = np.float32(a_t), np.float32(a_prev)
        beta_t = np.float32(1.0) - a_t
        sa, sb = np.sqrt(a_t), np.sqrt(beta_t)
        if self.prediction_type == "epsilon":
            x0 = (sample - float(sb) * model_output) / float(sa)
            eps = model_output
        elif self.prediction_type == "sample":
            x0 = model_output
            eps = (sample - float(sa) * x0) / float(sb)
        elif self.prediction_type == "v_prediction":
            x0 = float(sa) * sample - float(sb) * model_output
            eps = float(sa) * model_output + float(sb) * sample
        else:
            raise ValueError(self.prediction_type)
        if self.clip_sample:
            x0 = x0.clamp(-1.0, 1.0)
        var = ((np.float32(1.0) - a_prev) / (np.float32(1.0) - a_t)
               * (np.float32(1.0) - a_t / a_prev))
        sigma = np.float32(eta) * np.sqrt(var)
        dir_xt = float(np.sqrt(np.maximum(
            np.float32(1.0) - a_prev - sigma ** 2, np.float32(0.0)))) * eps
        prev = float(np.sqrt(a_prev)) * x0 + dir_xt
        if eta > 0:
            if generator is None:
                raise ValueError("DDIMScheduler.step: eta > 0 needs a "
                                 "generator")
            prev = prev + float(sigma) * torch.randn(
                sample.shape, generator=generator, dtype=sample.dtype,
                device=sample.device)
        return prev, x0
