"""Losses and metrics (PyTorch).

Counterpart of open_diffusiongs_tpu/systems/losses.py (the reference's
utils/losses.py LossComputer :261-369 and MetricComputer :373-473):
  * SSIM as pytorch_msssim computes it (separable Gaussian window 11 /
    sigma 1.5, valid convolution, K1 0.01 / K2 0.03), or with skimage's
    sample covariance for the eval metric;
  * LPIPS-VGG16 (5 stages, unit-normalized taps, 1x1 linear heads, spatial
    mean, sum) with weights from the NPZ that
    open_diffusiongs_tpu_torch/tools/convert_lpips_weights.py (or the root
    tools/convert_lpips_weights.py) writes,
    or seeded random weights flagged `pretrained=False`; f32, with TF32
    off as the package sets it at import (JAX's semantics); its VGG
    tensors never require grad and belong to no parameter group;
  * per-element MSE / PSNR, the points-distance regularizer and the masked
    xyz MSE.

Numerical hazards pinned by tests/test_torch_losses.py:
  * the points-distance target uses the population std (jnp.std is
    ddof 0; torch.std defaults to the unbiased one): `correction=0`;
  * that target is built from the detached distance (JAX stop_gradient);
  * jax.image.resize(..., "bilinear") antialiases when it downsamples, so
    the 512 -> 256 LPIPS resize is F.interpolate(..., antialias=True); at
    256^2 the resize is the identity and is skipped.
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

# ---------------------------------------------------------------------------
# SSIM (pytorch_msssim-compatible)
# ---------------------------------------------------------------------------


def _gaussian_window(win_size: int, sigma: float) -> np.ndarray:
    coords = np.arange(win_size, dtype=np.float64) - win_size // 2
    g = np.exp(-(coords ** 2) / (2 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


def _filter2d_separable(x: torch.Tensor, win: torch.Tensor) -> torch.Tensor:
    """Depthwise separable valid convolution.  x [n, c, h, w]; win [k]."""
    c, k = x.shape[1], win.shape[0]
    x = F.conv2d(x, win.reshape(1, 1, k, 1).expand(c, 1, k, 1), groups=c)
    return F.conv2d(x, win.reshape(1, 1, 1, k).expand(c, 1, 1, k), groups=c)


def ssim(x: torch.Tensor, y: torch.Tensor, win_size: int = 11,
         sigma: float = 1.5, data_range: float = 1.0,
         use_sample_covariance: bool = False) -> torch.Tensor:
    """Per-image SSIM.  x, y [n, c, h, w] -> [n].  use_sample_covariance
    False: pytorch_msssim (the training loss); True: skimage
    structural_similarity(win_size=11, gaussian_weights=True), the eval
    metric (covariances scaled by N/(N-1), N = win_size**2)."""
    x, y = x.float(), y.float()
    win = torch.from_numpy(_gaussian_window(win_size, sigma)).to(x.device)
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    mu1 = _filter2d_separable(x, win)
    mu2 = _filter2d_separable(y, win)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    npx = win_size * win_size
    cov_norm = npx / (npx - 1.0) if use_sample_covariance else 1.0
    sigma1_sq = cov_norm * (_filter2d_separable(x * x, win) - mu1_sq)
    sigma2_sq = cov_norm * (_filter2d_separable(y * y, win) - mu2_sq)
    sigma12 = cov_norm * (_filter2d_separable(x * y, win) - mu12)
    cs = (2 * sigma12 + c2) / (sigma1_sq + sigma2_sq + c2)
    ssim_map = ((2 * mu12 + c1) / (mu1_sq + mu2_sq + c1)) * cs
    return ssim_map.mean(dim=(1, 2, 3))


# ---------------------------------------------------------------------------
# LPIPS (VGG16 backbone + linear heads)
# ---------------------------------------------------------------------------

# VGG16 conv plan (out_channels, n_convs) per stage; taps after the last
# ReLU of each stage (relu1_2, relu2_2, relu3_3, relu4_3, relu5_3).
VGG_STAGES = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))
# lpips.ScalingLayer constants
_LPIPS_SHIFT = np.asarray([-0.030, -0.088, -0.188], np.float32)
_LPIPS_SCALE = np.asarray([0.458, 0.448, 0.450], np.float32)


def lpips_init_params(npz_path: Optional[str] = None, seed: int = 0,
                      device: torch.device | str = "cpu") -> Dict[str, Any]:
    """LPIPS parameters, the same draws as the JAX package's.

    npz keys: `vgg/{stage}_{conv}/kernel|bias` ([3, 3, cin, cout] HWIO /
    [cout]) and `lin/{stage}/kernel` ([cout]); a missing key raises
    KeyError, a misshapen array ValueError.  Conv kernels are stored as
    torch OIHW here.  Without an NPZ the weights come from
    np.random.default_rng(seed) and `pretrained` is False."""
    params: Dict[str, Any] = {"pretrained": npz_path is not None}
    data = dict(np.load(npz_path)) if npz_path else None
    rng = np.random.default_rng(seed)
    cin = 3

    def t(a, key, shape):
        if a.shape != shape:
            raise ValueError(f"LPIPS NPZ {npz_path}: {key} has shape "
                             f"{a.shape}, want {shape}")
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    for si, (cout, n_convs) in enumerate(VGG_STAGES):
        for ci in range(n_convs):
            key = f"vgg/{si}_{ci}"
            if data is not None:
                k, b = data[key + "/kernel"], data[key + "/bias"]
            else:
                k = rng.normal(0, np.sqrt(2.0 / (9 * cin)),
                               (3, 3, cin, cout)).astype(np.float32)
                b = np.zeros((cout,), np.float32)
            k = t(k, key + "/kernel", (3, 3, cin, cout))
            params[key] = {"kernel": k.permute(3, 2, 0, 1).contiguous(),
                           "bias": t(b, key + "/bias", (cout,))}
            cin = cout
        if data is not None:
            lin = data[f"lin/{si}/kernel"]
        else:
            lin = np.abs(rng.normal(0, 0.01, (cout,))).astype(np.float32)
        params[f"lin/{si}"] = t(lin, f"lin/{si}/kernel", (cout,))
    return params


def _vgg_features(params: Dict[str, Any], x: torch.Tensor
                  ) -> List[torch.Tensor]:
    """x [n, 3, h, w] in [-1, 1] -> the 5 tapped feature maps (NCHW)."""
    shift = torch.from_numpy(_LPIPS_SHIFT).to(x.device).reshape(1, 3, 1, 1)
    scale = torch.from_numpy(_LPIPS_SCALE).to(x.device).reshape(1, 3, 1, 1)
    x = (x - shift) / scale
    feats = []
    for si, (_, n_convs) in enumerate(VGG_STAGES):
        for ci in range(n_convs):
            p = params[f"vgg/{si}_{ci}"]
            x = F.relu(F.conv2d(x, p["kernel"], p["bias"], padding=1))
        feats.append(x)
        if si < len(VGG_STAGES) - 1:
            x = F.max_pool2d(x, 2, 2)
    return feats


def lpips(params: Dict[str, Any], x: torch.Tensor, y: torch.Tensor
          ) -> torch.Tensor:
    """Perceptual distance.  x, y [n, 3, h, w] in [-1, 1] -> [n].  The VGG
    tensors are constants (no grad); a `y` that needs no gradient (the
    target) goes through VGG without building a graph."""
    fx = _vgg_features(params, x)
    with torch.set_grad_enabled(torch.is_grad_enabled() and y.requires_grad):
        fy = _vgg_features(params, y)
    return lpips_heads(params, fx, fy)


def lpips_heads(params: Dict[str, Any], fx: List[torch.Tensor],
                fy: List[torch.Tensor]) -> torch.Tensor:
    """The distance of two images' 5 VGG taps -> [n]: unit-normalized,
    squared difference, 1x1 linear heads, spatial mean, summed."""
    total = 0.0
    for si, (a, b) in enumerate(zip(fx, fy)):
        # lpips.normalize_tensor: x / (||x||_c + eps), eps outside the sqrt
        a = a / (torch.sqrt(torch.sum(a * a, dim=1, keepdim=True)) + 1e-10)
        b = b / (torch.sqrt(torch.sum(b * b, dim=1, keepdim=True)) + 1e-10)
        w = params[f"lin/{si}"].reshape(1, -1, 1, 1)
        total = total + torch.sum((a - b) ** 2 * w, dim=1).mean(dim=(1, 2))
    return total


def resize_bilinear_256(x: torch.Tensor) -> torch.Tensor:
    """jax.image.resize(x, (n, c, 256, 256), "bilinear") for NCHW x:
    half-pixel bilinear, antialiased when downsampling; the identity at
    256^2."""
    if tuple(x.shape[-2:]) == (256, 256):
        return x
    return F.interpolate(x, size=(256, 256), mode="bilinear",
                         align_corners=False, antialias=True)


# ---------------------------------------------------------------------------
# LossComputer / MetricComputer equivalents
# ---------------------------------------------------------------------------

def psnr(mse: torch.Tensor) -> torch.Tensor:
    return -10.0 * torch.log10(mse)


class LossOutputs(NamedTuple):
    l2: torch.Tensor          # [b]
    psnr: torch.Tensor        # [b]
    lpips: torch.Tensor       # [] (mean, as in the reference :309)
    ssim: torch.Tensor        # [b] (1 - ssim)
    pointsdist: torch.Tensor  # [b]
    xyz: torch.Tensor         # [] (mask-normalized sum)


def compute_losses(rendering: torch.Tensor, target: torch.Tensor,
                   ray_o: torch.Tensor,
                   img_aligned_xyz: Optional[torch.Tensor] = None,
                   gt_img_aligned_xyz: Optional[torch.Tensor] = None,
                   masks: Optional[torch.Tensor] = None,
                   lpips_params: Optional[Dict[str, Any]] = None,
                   use_lpips: bool = True,
                   lpips_resize: bool = True) -> LossOutputs:
    """LossComputer.forward (losses.py:261-369).  rendering / target
    [b, v, 3, h, w] in [0, 1]; ray_o, img_aligned_xyz and its ground truth
    [b, v, 3, h, w]; masks [b, v, 1, h, w]."""
    b, v, _, h, w = rendering.shape
    rend = rendering.reshape(b * v, 3, h, w).float()
    targ = target.reshape(b * v, 3, h, w).float()
    zero = rend.new_zeros(())

    l2 = ((rend - targ) ** 2).reshape(b, -1).mean(dim=1)

    if img_aligned_xyz is not None and gt_img_aligned_xyz is not None:
        m = (masks if masks is not None
             else torch.ones_like(img_aligned_xyz[:, :, :1]))
        num = torch.sum(((img_aligned_xyz - gt_img_aligned_xyz) * m) ** 2)
        xyz = num / torch.clamp(torch.sum(m), min=1.0)
    else:
        xyz = zero

    if use_lpips and lpips_params is not None:
        # a profiler range, beside the sampler's "denoiser" / "render"; the
        # render is a [b, v, h, w, 3] buffer viewed channels-first, so the
        # inputs are made contiguous NCHW once and both VGG passes run
        # the same convolutions
        with torch.profiler.record_function("lpips"):
            r = resize_bilinear_256(rend) if lpips_resize else rend
            t_ = resize_bilinear_256(targ) if lpips_resize else targ
            lp = lpips(lpips_params, (r * 2.0 - 1.0).contiguous(),
                       (t_ * 2.0 - 1.0).contiguous()).mean()
    else:
        lp = zero

    ssim_loss = (1.0 - ssim(rend, targ)).reshape(b, v).mean(dim=1)

    # points-distance regularizer (losses.py:323-364)
    if img_aligned_xyz is not None:
        trgt_mean = torch.linalg.norm(ray_o, dim=2, keepdim=True)
        dist = torch.linalg.norm(img_aligned_xyz - ray_o, dim=2, keepdim=True)
        dd = dist.detach()
        d_mean = dd.mean(dim=(2, 3, 4), keepdim=True)
        d_std = dd.std(dim=(2, 3, 4), keepdim=True, correction=0)
        trgt = (dd - d_mean) / (d_std + 1e-8) * 0.5 + trgt_mean
        pd = ((dist - trgt) ** 2).reshape(b, -1).mean(dim=1)
    else:
        pd = rend.new_zeros((b,))

    return LossOutputs(l2=l2, psnr=psnr(l2), lpips=lp, ssim=ssim_loss,
                       pointsdist=pd, xyz=xyz)


def compute_metrics(target: torch.Tensor, rendering: torch.Tensor,
                    lpips_params: Optional[Dict[str, Any]] = None
                    ) -> Dict[str, torch.Tensor]:
    """MetricComputer.forward (losses.py:467-473): [..., 3, h, w] pairs ->
    psnr [n], ssim [n] (skimage semantics) and, with params, lpips [n]."""
    rend = rendering.reshape(-1, *rendering.shape[-3:]).float()
    targ = target.reshape(-1, *target.shape[-3:]).float()
    rend_c = torch.clamp(rend, 0, 1)
    targ_c = torch.clamp(targ, 0, 1)
    mse = ((rend_c - targ_c) ** 2).reshape(rend.shape[0], -1).mean(dim=1)
    out = {"psnr": psnr(mse),
           "ssim": ssim(targ_c, rend_c, use_sample_covariance=True)}
    if lpips_params is not None:
        out["lpips"] = lpips(lpips_params,
                             resize_bilinear_256(rend) * 2.0 - 1.0,
                             resize_bilinear_256(targ) * 2.0 - 1.0)
    return out
