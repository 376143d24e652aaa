"""Rectified-flow / flow-matching scheduler (torch).

Counterpart of open_diffusiongs_tpu/diffusion/rf.py (:18-70): the
reference's FlowMatchEulerDiscreteScheduler (models/scheduler/
rf_scheduler.py:42-310) and the logit-normal timestep density helpers
(systems/rf_utils.py:19-56), present in the reference, unused by shipped
configs.  The tables stay host NumPy arrays, as in JAX.
"""

from __future__ import annotations

import math

import numpy as np
import torch


class FlowMatchEulerDiscreteScheduler:
    """sigma(t) = t / T with optional shift; x_t = (1-sigma) x0 + sigma eps;
    the Euler step follows the velocity prediction v = eps - x0."""

    def __init__(self, num_train_timesteps: int = 1000, shift: float = 1.0,
                 **_unused):
        self.num_train_timesteps = num_train_timesteps
        self.shift = shift
        sigmas = np.linspace(1, num_train_timesteps, num_train_timesteps
                             )[::-1] / num_train_timesteps
        sigmas = shift * sigmas / (1 + (shift - 1) * sigmas)
        self.sigmas = np.asarray(sigmas, np.float32)
        self.timesteps = np.asarray(sigmas * num_train_timesteps, np.float32)
        self.num_inference_steps = None

    def set_timesteps(self, num_inference_steps: int):
        self.num_inference_steps = num_inference_steps
        sigmas = np.linspace(1.0, 1.0 / self.num_train_timesteps,
                             num_inference_steps)
        sigmas = self.shift * sigmas / (1 + (self.shift - 1) * sigmas)
        self.sigmas = np.asarray(np.append(sigmas, 0.0), np.float32)
        self.timesteps = np.asarray(sigmas * self.num_train_timesteps,
                                    np.float32)

    def scale_noise(self, sample: torch.Tensor, t_index,
                    noise: torch.Tensor) -> torch.Tensor:
        """(1 - sigma) x0 + sigma noise at sigma = sigmas[t_index]."""
        t_index = torch.as_tensor(t_index, device=sample.device)
        s = torch.as_tensor(self.sigmas, device=sample.device)[t_index]
        s = s.reshape(t_index.shape + (1,) * (sample.dim() - t_index.dim()))
        return (1.0 - s) * sample + s * noise

    def step(self, model_output: torch.Tensor, step_index: int,
             sample: torch.Tensor) -> torch.Tensor:
        """Euler step with the velocity prediction (eps - x0)."""
        dt = self.sigmas[step_index + 1] - self.sigmas[step_index]
        return sample + float(dt) * model_output


def logit_normal_timestep_density(t: torch.Tensor, m: float = 0.0,
                                  s: float = 1.0) -> torch.Tensor:
    """pi(t) of logit-normal timestep sampling (rf_utils.py:19-38); t in
    (0, 1)."""
    logit = torch.log(t / (1.0 - t))
    return ((1.0 / (s * math.sqrt(2.0 * math.pi)))
            * torch.exp(-((logit - m) ** 2) / (2 * s * s)) / (t * (1.0 - t)))


def sample_logit_normal(generator: torch.Generator, shape, m: float = 0.0,
                        s: float = 1.0, device=None) -> torch.Tensor:
    """t ~ logit-normal(m, s) in (0, 1) (rf_utils.py:41-56): sigmoid(m + s z)
    with z ~ N(0, 1) drawn from `generator` (a JAX key there: the draws
    differ, the function of z is the same)."""
    z = torch.randn(shape, generator=generator, device=device)
    return torch.sigmoid(m + s * z)
