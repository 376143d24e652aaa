"""Fisheye624 (FisheyeRadTanThinPrism) camera model (torch).

Counterpart of open_diffusiongs_tpu/utils/fisheye.py (:26-133), the port of
the reference's nerfstudio-derived model (diffusionGS/models/gsrenderer/
cam_utils.py:627-714 project, :716-838 unproject by Newton's method).
Unused by the shipped pipeline; kept for datasets with fisheye
intrinsics.  Elementwise on tensors of any device, in f32 as JAX runs it.

Parameter layout (per camera): [f_u f_v c_u c_v k_0..k_5 p_0 p_1 s_0..s_3]
(16) or [f c_u c_v k_0..k_5 p_0 p_1 s_0..s_3] (15, fu == fv).

The model:
    a = x/z, b = y/z, r = |(a,b)|, th = atan(r)
    xr_yr = (th + k0 th^3 + ... + k5 th^13) * (a,b)/r
    uv_dist = xr_yr + tangential(p0,p1) + thin_prism(s0..s3)
    uv = diag(fu,fv) @ uv_dist + (cu,cv)
"""

from __future__ import annotations

import torch

_EPS = 1e-9


def _split_params(params: torch.Tensor):
    b = params.shape[0]
    if params.shape[-1] == 15:
        return params[:, 0].reshape(b, 1, 1), params[:, 1:3].reshape(b, 1, 2)
    return params[:, 0:2].reshape(b, 1, 2), params[:, 2:4].reshape(b, 1, 2)


def _coeff(params: torch.Tensor, i: int) -> torch.Tensor:
    return params[:, i].reshape(params.shape[0], 1)


def _distort(xr_yr: torch.Tensor, params: torch.Tensor) -> torch.Tensor:
    """xr_yr [B,N,2] -> distorted uv (without focal/center), [B,N,2]."""
    p0, p1 = _coeff(params, -6), _coeff(params, -5)
    s = [_coeff(params, -4 + i) for i in range(4)]
    xr, yr = xr_yr[..., 0], xr_yr[..., 1]
    xr_sq, yr_sq = xr * xr, yr * yr
    rd_sq = xr_sq + yr_sq
    rd_4 = rd_sq * rd_sq
    u = (xr + (2.0 * xr_sq + rd_sq) * p0 + 2.0 * xr * yr * p1
         + s[0] * rd_sq + s[1] * rd_4)
    v = (yr + (2.0 * yr_sq + rd_sq) * p1 + 2.0 * xr * yr * p0
         + s[2] * rd_sq + s[3] * rd_4)
    return torch.stack([u, v], dim=-1)


def _check(x: torch.Tensor, params: torch.Tensor, last: int):
    if x.dim() != 3 or x.shape[-1] != last or params.dim() != 2 \
            or params.shape[-1] not in (15, 16):
        raise ValueError(f"expected [B, N, {last}] points and [B, 15|16] "
                         f"params, got {tuple(x.shape)}, "
                         f"{tuple(params.shape)}")


def fisheye624_project(xyz: torch.Tensor, params: torch.Tensor
                       ) -> torch.Tensor:
    """xyz [B,N,3], params [B,15|16] -> uv [B,N,2] (cam_utils.py:627-714)."""
    _check(xyz, params, 3)
    b = params.shape[0]
    z = xyz[..., 2:3]
    z = torch.where(z.abs() < _EPS, _EPS * torch.sign(z), z)
    ab = xyz[..., :2] / z
    r = torch.linalg.norm(ab, dim=-1, keepdim=True)
    th = torch.atan(r)
    th_divr = torch.where(r < _EPS, torch.ones_like(ab), ab / r)
    th_k = th
    for i in range(6):
        th_k = th_k + params[:, -12 + i].reshape(b, 1, 1) * th ** (3 + i * 2)
    uv_dist = _distort(th_k * th_divr, params)
    fxy, cxy = _split_params(params)
    return uv_dist * fxy + cxy


def fisheye624_unproject(uv: torch.Tensor, params: torch.Tensor,
                         max_iters: int = 5) -> torch.Tensor:
    """uv [B,N,2], params [B,15|16] -> rays [B,N,3] with z = 1, such that
    X = unproject(project(X)) for z > 0 (cam_utils.py:716-838; Newton,
    `max_iters` steps for the distortion and for theta)."""
    _check(uv, params, 2)
    b = params.shape[0]
    eps = 1e-6
    fxy, cxy = _split_params(params)
    uv_dist = (uv - cxy) / fxy
    p0, p1 = _coeff(params, -6), _coeff(params, -5)
    s = [_coeff(params, -4 + i) for i in range(4)]

    # Newton for xr_yr: solve distort(xr_yr) = uv_dist with the analytic
    # 2x2 Jacobian (tangential + thin-prism terms).
    xr_yr = uv_dist
    for _ in range(max_iters):
        est = _distort(xr_yr, params)
        xr, yr = xr_yr[..., 0], xr_yr[..., 1]
        sq_norm = xr * xr + yr * yr
        j00 = 1.0 + 6.0 * xr * p0 + 2.0 * yr * p1
        j11 = 1.0 + 6.0 * yr * p1 + 2.0 * xr * p0
        joff = 2.0 * (xr * p1 + yr * p0)
        t1 = 2.0 * (s[0] + 2.0 * s[1] * sq_norm)
        t2 = 2.0 * (s[2] + 2.0 * s[3] * sq_norm)
        j00 = j00 + xr * t1
        j01 = joff + yr * t1
        j10 = joff + xr * t2
        j11 = j11 + yr * t2
        det = j00 * j11 - j01 * j10
        diff = uv_dist - est
        e, f = diff[..., 0], diff[..., 1]
        step = torch.stack([(j11 * e - j01 * f), (-j10 * e + j00 * f)],
                           dim=-1) / det[..., None]
        xr_yr = xr_yr + step

    # Newton for theta: solve th * (1 + k0 th^2 + ...) = |xr_yr|.
    norm = torch.linalg.norm(xr_yr, dim=-1, keepdim=True)
    th = norm
    for _ in range(max_iters):
        th_radial = torch.ones_like(th)
        dthd_th = torch.ones_like(th)
        for k in range(6):
            r_k = params[:, -12 + k].reshape(b, 1, 1)
            th_radial = th_radial + r_k * th ** (2 + k * 2)
            dthd_th = dthd_th + (3.0 + 2.0 * k) * r_k * th ** (2 + k * 2)
        step = (norm - th_radial * th) / dthd_th
        step = torch.where(dthd_th.abs() > eps, step,
                           torch.sign(step) * eps * 10.0)
        th = th + step

    close = (th.abs() < eps) & (norm.abs() < eps)
    ray_dir = torch.where(close, xr_yr, torch.tan(th) / torch.where(
        norm == 0, torch.ones_like(norm), norm) * xr_yr)
    return torch.cat([ray_dir, torch.ones_like(th)], dim=-1)
