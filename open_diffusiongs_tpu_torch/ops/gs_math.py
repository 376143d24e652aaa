"""Core 3D Gaussian Splatting math in PyTorch (float32).

Counterpart of open_diffusiongs_tpu/ops/gs_math.py:35-192, with the same
elementwise formulations (and so the same f32 rounding order):
  quat -> rotation + cov3D   forward.cu:118-152 (Sigma = R S Sᵀ Rᵀ)
  EWA 2D covariance          forward.cu:74-113 (+0.3 low-pass, tanfov clamp)
  conic / 3-sigma radius     forward.cu:218-232
  SH -> RGB                  forward.cu:20-71 (clamped to >= 0)
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Normalized quaternion (w, x, y, z) [..., 4] -> rotation [..., 3, 3]."""
    r, x, y, z = q.unbind(-1)
    row0 = torch.stack([1.0 - 2.0 * (y * y + z * z), 2.0 * (x * y - r * z),
                        2.0 * (x * z + r * y)], -1)
    row1 = torch.stack([2.0 * (x * y + r * z), 1.0 - 2.0 * (x * x + z * z),
                        2.0 * (y * z - r * x)], -1)
    row2 = torch.stack([2.0 * (x * z - r * y), 2.0 * (y * z + r * x),
                        1.0 - 2.0 * (x * x + y * y)], -1)
    return torch.stack([row0, row1, row2], dim=-2)


def build_cov3d(scale: torch.Tensor, rot: torch.Tensor,
                scale_modifier: float = 1.0) -> torch.Tensor:
    """Sigma = R diag(s²) Rᵀ as its 6 unique entries [..., 6] ordered
    (xx, xy, xz, yy, yz, zz).  scale [..., 3] post-activation; rot [..., 4]
    normalized."""
    m = quat_to_rotmat(rot) * (scale_modifier * scale)[..., None, :]
    m0, m1, m2 = m[..., 0, :], m[..., 1, :], m[..., 2, :]
    return torch.stack([
        (m0 * m0).sum(-1), (m0 * m1).sum(-1), (m0 * m2).sum(-1),
        (m1 * m1).sum(-1), (m1 * m2).sum(-1), (m2 * m2).sum(-1),
    ], -1)


def ewa_cov2d(mean_world: torch.Tensor, cov3d: torch.Tensor,
              w2c: torch.Tensor, fxfycxcy: torch.Tensor,
              tanfov: torch.Tensor,
              near: Optional[float] = None) -> torch.Tensor:
    """Screen-space covariance (xx, xy, yy) [..., N, 3] with the +0.3
    low-pass.  mean_world [..., N, 3]; cov3d [..., N, 6]; w2c [..., 4, 4];
    fxfycxcy [..., 4]; tanfov [..., 2].

    `near`: the caller culls every Gaussian whose view depth is <= near,
    and for those the Jacobian is taken at depth 1.  Their covariance is
    then finite but not JAX's, and no caller reads it.  At a depth of
    exactly 0 (a point in the camera's plane: f32 rounds the depth onto a
    grid, so it happens) JAX's Jacobian divides 0 by 0.  Its forward
    stays finite, because the Gaussian is culled, but its backward is
    0 * NaN = NaN, and that NaN reaches every parameter.  A culled
    Gaussian's true gradient from this view is 0, and that is what it
    gets here (ROADMAP Queue 3, Limits)."""
    W = w2c[..., :3, :3]
    p = mean_world

    def view_row(i):
        return (W[..., None, i, 0] * p[..., 0] + W[..., None, i, 1] * p[..., 1]
                + W[..., None, i, 2] * p[..., 2] + w2c[..., None, i, 3])

    t_x, t_y, t_z = view_row(0), view_row(1), view_row(2)
    if near is not None:
        t_z = torch.where(t_z > near, t_z, 1.0)
    fx = fxfycxcy[..., None, 0]
    fy = fxfycxcy[..., None, 1]
    limx = 1.3 * tanfov[..., None, 0]
    limy = 1.3 * tanfov[..., None, 1]
    tx = torch.minimum(torch.maximum(t_x / t_z, -limx), limx) * t_z
    ty = torch.minimum(torch.maximum(t_y / t_z, -limy), limy) * t_z
    tz = t_z

    a0 = fx / tz
    a2 = -(fx * tx) / (tz * tz)
    b1 = fy / tz
    b2 = -(fy * ty) / (tz * tz)
    T0 = [a0 * W[..., None, 0, k] + a2 * W[..., None, 2, k] for k in range(3)]
    T1 = [b1 * W[..., None, 1, k] + b2 * W[..., None, 2, k] for k in range(3)]

    c_xx, c_xy, c_xz, c_yy, c_yz, c_zz = cov3d.unbind(-1)

    def quad(u, v):
        return (u[0] * (c_xx * v[0] + c_xy * v[1] + c_xz * v[2])
                + u[1] * (c_xy * v[0] + c_yy * v[1] + c_yz * v[2])
                + u[2] * (c_xz * v[0] + c_yz * v[1] + c_zz * v[2]))

    return torch.stack([quad(T0, T0) + 0.3, quad(T0, T1),
                        quad(T1, T1) + 0.3], -1)


def conic_and_radius(cov2d: torch.Tensor) -> Tuple[
        torch.Tensor, torch.Tensor, torch.Tensor]:
    """Inverse 2D covariance and 3-sigma pixel radius.  cov2d [..., 3] =
    (xx, xy, yy).  Returns (conic [..., 3], radius [...], valid [...]);
    valid is False where det == 0 (the CUDA kernel early-outs there)."""
    a, b, c = cov2d.unbind(-1)
    det = a * c - b * b
    valid = det != 0.0
    det_inv = torch.where(valid, 1.0 / torch.where(valid, det, 1.0), 0.0)
    conic = torch.stack([c * det_inv, -b * det_inv, a * det_inv], -1)
    mid = 0.5 * (a + c)
    disc = torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    lambda1 = mid + disc
    radius = torch.ceil(3.0 * torch.sqrt(torch.maximum(lambda1, mid - disc)))
    return conic, radius, valid


def eval_sh(sh: torch.Tensor, degree: int, dirs: torch.Tensor
            ) -> torch.Tensor:
    """SH colours.  sh [..., (degree+1)², 3]; dirs [..., 3] unnormalized
    view directions (normalized here).  RGB [..., 3], clamped to >= 0
    after the +0.5 offset."""
    result = SH_C0 * sh[..., 0, :]
    if degree > 0:
        d = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
        x, y, z = d[..., 0:1], d[..., 1:2], d[..., 2:3]
        result = (result - SH_C1 * y * sh[..., 1, :]
                  + SH_C1 * z * sh[..., 2, :] - SH_C1 * x * sh[..., 3, :])
        if degree > 1:
            xx, yy, zz = x * x, y * y, z * z
            xy, yz, xz = x * y, y * z, x * z
            result = (result
                      + SH_C2[0] * xy * sh[..., 4, :]
                      + SH_C2[1] * yz * sh[..., 5, :]
                      + SH_C2[2] * (2.0 * zz - xx - yy) * sh[..., 6, :]
                      + SH_C2[3] * xz * sh[..., 7, :]
                      + SH_C2[4] * (xx - yy) * sh[..., 8, :])
            if degree > 2:
                result = (
                    result
                    + SH_C3[0] * y * (3.0 * xx - yy) * sh[..., 9, :]
                    + SH_C3[1] * xy * z * sh[..., 10, :]
                    + SH_C3[2] * y * (4.0 * zz - xx - yy) * sh[..., 11, :]
                    + SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy)
                    * sh[..., 12, :]
                    + SH_C3[4] * x * (4.0 * zz - xx - yy) * sh[..., 13, :]
                    + SH_C3[5] * z * (xx - yy) * sh[..., 14, :]
                    + SH_C3[6] * x * (xx - 3.0 * yy) * sh[..., 15, :])
    return torch.clamp(result + 0.5, min=0.0)
