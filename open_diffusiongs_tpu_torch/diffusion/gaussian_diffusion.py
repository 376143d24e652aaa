"""DDPM diffusion math + spaced sampling (PyTorch).

Counterpart of open_diffusiongs_tpu/diffusion/gaussian_diffusion.py:35-281
(the OpenAI-lineage reference: squaredcos_cap_v2 betas, the model
predicts x0, FIXED_LARGE variance).  The schedule tables are computed in
f64 NumPy and stored as f32 NumPy arrays, exactly as the JAX package does;
the reverse process is a Python loop over T-1 .. 1 with the t = 0 step
peeled, in place of the JAX lax.scan.

Sampling semantics pinned by tests/test_torch_sampling.py:
  * `timestep_map` remaps the spaced index to the model's timestep;
  * the log-variance is FIXED_LARGE;
  * no noise is added at t = 0;
  * the loop runs T-1 .. 1, then a peeled t = 0 step (which may use a
    different model function, e.g. one that renders every view).

Noise comes from an explicit torch.Generator, or from `noise_fn(t_idx)`
when a test replays recorded noise (JAX threefry and torch Philox never
agree, so parity tests inject the noise).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch


def get_named_beta_schedule(schedule_name: str, num_steps: int) -> np.ndarray:
    """Named beta schedules (gaussian_diffusion.py:122-146)."""
    if schedule_name == "linear":
        scale = 1000.0 / num_steps
        return np.linspace(scale * 1e-4, scale * 2e-2, num_steps,
                           dtype=np.float64)
    if schedule_name == "squaredcos_cap_v2":
        def alpha_bar(t):
            return math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2
        betas = []
        for i in range(num_steps):
            t1, t2 = i / num_steps, (i + 1) / num_steps
            betas.append(min(1 - alpha_bar(t2) / alpha_bar(t1), 0.999))
        return np.array(betas, dtype=np.float64)
    raise NotImplementedError(f"unknown beta schedule: {schedule_name}")


def space_timesteps(num_timesteps: int, section_counts) -> set:
    """Subset of original timesteps to retain (respace.py:16-66)."""
    if isinstance(section_counts, str):
        if section_counts.startswith("ddim"):
            desired = int(section_counts[len("ddim"):])
            for i in range(1, num_timesteps):
                if len(range(0, num_timesteps, i)) == desired:
                    return set(range(0, num_timesteps, i))
            raise ValueError(
                f"cannot create exactly {desired} steps with an integer "
                "stride")
        section_counts = [int(x) for x in section_counts.split(",")]
    elif isinstance(section_counts, int):
        section_counts = [section_counts]
    size_per = num_timesteps // len(section_counts)
    extra = num_timesteps % len(section_counts)
    start_idx, all_steps = 0, []
    for i, section_count in enumerate(section_counts):
        size = size_per + (1 if i < extra else 0)
        if size < section_count:
            raise ValueError(
                f"cannot divide section of {size} steps into {section_count}")
        frac_stride = (1 if section_count <= 1
                       else (size - 1) / (section_count - 1))
        cur = 0.0
        for _ in range(section_count):
            all_steps.append(start_idx + round(cur))
            cur += frac_stride
        start_idx += size
    return set(all_steps)


class DiffusionSchedule(NamedTuple):
    """Per-timestep constants (f32 NumPy), one entry per (possibly
    respaced) step; timestep_map[i] is the original timestep fed to the
    model."""

    betas: np.ndarray
    alphas_cumprod: np.ndarray
    alphas_cumprod_prev: np.ndarray
    sqrt_alphas_cumprod: np.ndarray
    sqrt_one_minus_alphas_cumprod: np.ndarray
    sqrt_recip_alphas_cumprod: np.ndarray
    sqrt_recipm1_alphas_cumprod: np.ndarray
    posterior_variance: np.ndarray
    posterior_log_variance_clipped: np.ndarray
    posterior_mean_coef1: np.ndarray
    posterior_mean_coef2: np.ndarray
    fixed_large_variance: np.ndarray
    fixed_large_log_variance: np.ndarray
    timestep_map: np.ndarray

    @property
    def num_steps(self) -> int:
        return self.betas.shape[0]


def _schedule_from_betas(betas: np.ndarray, timestep_map: np.ndarray
                         ) -> DiffusionSchedule:
    betas = np.asarray(betas, np.float64)
    alphas = 1.0 - betas
    acp = np.cumprod(alphas)
    acp_prev = np.append(1.0, acp[:-1])
    post_var = betas * (1.0 - acp_prev) / (1.0 - acp)
    post_logvar = (np.log(np.append(post_var[1], post_var[1:]))
                   if len(post_var) > 1 else np.array([]))
    fl_var = np.append(post_var[1], betas[1:])
    f = np.float32
    return DiffusionSchedule(
        betas=betas.astype(f),
        alphas_cumprod=acp.astype(f),
        alphas_cumprod_prev=acp_prev.astype(f),
        sqrt_alphas_cumprod=np.sqrt(acp).astype(f),
        sqrt_one_minus_alphas_cumprod=np.sqrt(1.0 - acp).astype(f),
        sqrt_recip_alphas_cumprod=np.sqrt(1.0 / acp).astype(f),
        sqrt_recipm1_alphas_cumprod=np.sqrt(1.0 / acp - 1.0).astype(f),
        posterior_variance=post_var.astype(f),
        posterior_log_variance_clipped=np.asarray(post_logvar, f),
        posterior_mean_coef1=(betas * np.sqrt(acp_prev) / (1.0 - acp)
                              ).astype(f),
        posterior_mean_coef2=((1.0 - acp_prev) * np.sqrt(alphas)
                              / (1.0 - acp)).astype(f),
        fixed_large_variance=fl_var.astype(f),
        fixed_large_log_variance=np.log(fl_var).astype(f),
        timestep_map=np.asarray(timestep_map, np.int32),
    )


def create_schedule(timestep_respacing=None,
                    noise_schedule: str = "squaredcos_cap_v2",
                    diffusion_steps: int = 1000) -> DiffusionSchedule:
    """`create_diffusion` equivalent: None / "" for the full process; an
    int or a "30"-style string for spaced inference (respace.py:86-95)."""
    base_betas = get_named_beta_schedule(noise_schedule, diffusion_steps)
    if timestep_respacing is None or timestep_respacing == "":
        return _schedule_from_betas(
            base_betas, np.arange(diffusion_steps, dtype=np.int64))
    use = space_timesteps(diffusion_steps, timestep_respacing)
    acp = np.cumprod(1.0 - base_betas)
    last, new_betas, tmap = 1.0, [], []
    for i, a in enumerate(acp):
        if i in use:
            new_betas.append(1 - a / last)
            last = a
            tmap.append(i)
    return _schedule_from_betas(np.array(new_betas), np.array(tmap))


def _extract(arr: np.ndarray, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """arr[t] as a tensor shaped [b, 1, ...] for an ndim tensor."""
    table = torch.as_tensor(arr, device=t.device)
    return table[t].reshape(t.shape + (1,) * (ndim - 1))


def q_sample(sched: DiffusionSchedule, x_start: torch.Tensor,
             t: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """Forward diffusion q(x_t | x_0) (gaussian_diffusion.py:268-284)."""
    return (_extract(sched.sqrt_alphas_cumprod, t, x_start.dim()) * x_start
            + _extract(sched.sqrt_one_minus_alphas_cumprod, t, x_start.dim())
            * noise)


def q_posterior(sched: DiffusionSchedule, x_start: torch.Tensor,
                x_t: torch.Tensor, t: torch.Tensor):
    """q(x_{t-1} | x_t, x_0) mean / log-variance
    (gaussian_diffusion.py:291-312)."""
    mean = (_extract(sched.posterior_mean_coef1, t, x_t.dim()) * x_start
            + _extract(sched.posterior_mean_coef2, t, x_t.dim()) * x_t)
    return mean, _extract(sched.posterior_log_variance_clipped, t, x_t.dim())


def p_sample_step(sched: DiffusionSchedule, model_fn: Callable,
                  cond: torch.Tensor, x_t: torch.Tensor, t_idx: int,
                  generator: Optional[torch.Generator] = None,
                  clip_denoised: bool = True,
                  noise_fn: Optional[Callable] = None):
    """One reverse step x_t -> x_{t-1} (p_sample, gaussian_diffusion.py:
    479-518).  cond [b, n_cond, 3, h, w] clean views; x_t [b, v_noisy, 3,
    h, w]; t_idx the spaced-timestep index shared by the batch.
    model_fn(images, t_model) -> (renders, aux) with renders covering
    either all views or only the noisy ones.  Returns (x_prev, pred_xstart,
    (renders, aux))."""
    b = x_t.shape[0]
    t_b = torch.full((b,), int(t_idx), dtype=torch.long, device=x_t.device)
    t_model = torch.as_tensor(sched.timestep_map, device=x_t.device)[t_b]
    renders, aux = model_fn(torch.cat([cond, x_t], dim=1), t_model)
    model_output = (renders if renders.shape[1] == x_t.shape[1]
                    else renders[:, cond.shape[1]:])
    pred_xstart = (torch.clamp(model_output, -1.0, 1.0) if clip_denoised
                   else model_output)
    mean, _ = q_posterior(sched, pred_xstart, x_t, t_b)
    logvar = _extract(sched.fixed_large_log_variance, t_b, x_t.dim())
    noise = (noise_fn(t_idx) if noise_fn is not None
             else torch.randn(x_t.shape, generator=generator,
                              dtype=x_t.dtype, device=x_t.device))
    x_prev = mean + float(t_idx != 0) * torch.exp(0.5 * logvar) * noise
    return x_prev, pred_xstart, (renders, aux)


def p_sample_loop(sched: DiffusionSchedule, model_fn: Callable,
                  cond: torch.Tensor, noise: torch.Tensor,
                  generator: Optional[torch.Generator] = None,
                  clip_denoised: bool = True,
                  return_trajectory: bool = False,
                  final_model_fn: Optional[Callable] = None,
                  noise_fn: Optional[Callable] = None):
    """Full reverse process (p_sample_loop_progressive,
    gaussian_diffusion.py:560-603): steps T-1 .. 1, then the peeled t = 0
    step with `final_model_fn` (default `model_fn`).

    Returns a dict with `sample` (final pred_xstart), `renders` (of the
    t = 0 model call), `aux` (its auxiliary output) and, when asked,
    `trajectory` = (x_t [T-1, ...], pred_xstart [T-1, ...])."""
    x = noise
    xs, preds = [], []
    for t_idx in range(sched.num_steps - 1, 0, -1):
        x, pred_x0, _ = p_sample_step(sched, model_fn, cond, x, t_idx,
                                      generator, clip_denoised,
                                      noise_fn=noise_fn)
        if return_trajectory:
            xs.append(x)
            preds.append(pred_x0)
    _, pred_x0, (renders, aux) = p_sample_step(
        sched, final_model_fn or model_fn, cond, x, 0, generator,
        clip_denoised, noise_fn=noise_fn)
    out = {"sample": pred_x0, "renders": renders, "aux": aux}
    if return_trajectory:
        out["trajectory"] = (torch.stack(xs), torch.stack(preds))
    return out
