"""Diffusion likelihood utilities (torch).

Counterpart of open_diffusiongs_tpu/diffusion/diffusion_utils.py (:16-44;
the reference's models/diffusion/diffusion_utils.py:10-104): the KL between
diagonal Gaussians, the tanh-approximated standard normal CDF and the
discretized Gaussian log-likelihood of VLB terms.  The shipped training
path is pure MSE; these serve variance objectives that learn a range.
Elementwise on tensors of any device.
"""

from __future__ import annotations

import math

import torch


def normal_kl(mean1, logvar1, mean2, logvar2) -> torch.Tensor:
    """KL(N(mean1, exp(logvar1)) || N(mean2, exp(logvar2))) elementwise
    (diffusion_utils.py:10-37)."""
    return 0.5 * (-1.0 + logvar2 - logvar1 + torch.exp(logvar1 - logvar2)
                  + ((mean1 - mean2) ** 2) * torch.exp(-logvar2))


def approx_standard_normal_cdf(x: torch.Tensor) -> torch.Tensor:
    """Tanh approximation of Phi(x) (diffusion_utils.py:40-46)."""
    return 0.5 * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                   * (x + 0.044715 * x ** 3)))


def discretized_gaussian_log_likelihood(x: torch.Tensor, *,
                                        means: torch.Tensor,
                                        log_scales: torch.Tensor
                                        ) -> torch.Tensor:
    """Log-likelihood of a Gaussian discretized to [-1, 1] in 1/127.5 bins
    (diffusion_utils.py:78-104).  x in [-1, 1]."""
    centered = x - means
    inv_stdv = torch.exp(-log_scales)
    cdf_plus = approx_standard_normal_cdf(inv_stdv * (centered + 1.0 / 255.0))
    cdf_min = approx_standard_normal_cdf(inv_stdv * (centered - 1.0 / 255.0))
    log_cdf_plus = torch.log(cdf_plus.clamp(min=1e-12))
    log_one_minus_cdf_min = torch.log((1.0 - cdf_min).clamp(min=1e-12))
    log_cdf_delta = torch.log((cdf_plus - cdf_min).clamp(min=1e-12))
    return torch.where(x < -0.999, log_cdf_plus,
                       torch.where(x > 0.999, log_one_minus_cdf_min,
                                   log_cdf_delta))
