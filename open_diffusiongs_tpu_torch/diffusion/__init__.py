"""Diffusion process: DDPM math, timestep respacing, the sampling loop."""

from .gaussian_diffusion import (DiffusionSchedule, create_schedule,
                                 p_sample_loop, p_sample_step, q_posterior,
                                 q_sample, space_timesteps)

__all__ = ["DiffusionSchedule", "create_schedule", "q_sample", "q_posterior",
           "p_sample_step", "p_sample_loop", "space_timesteps"]
