"""PyTorch port vs the JAX package: the gradient of a Gaussian that a view
culls at its near plane.

Take a Gaussian whose depth in a view is exactly 0 in f32, a point in the
camera's plane. f32 rounds a depth onto a grid, so this does happen: in
`configs/diffusionGS_scene_512.yaml`'s step, pixel Gaussians lie up to 500
units along the input rays, and other views' camera planes cut through
them. JAX's `ewa_cov2d` divides 0 by 0 for such a Gaussian. It is culled
(depth < 0.2), so every forward output stays finite. But its backward is
0 * NaN for its xyz, scaling and rotation, and the clipped update then
spreads the NaN into every parameter. A projective w of exactly -1e-7 does
the same through its xy (0 * inf). The port takes a culled Gaussian's
Jacobian at depth 1 and its w as 1 (`ops/gs_math.py::ewa_cov2d`'s `near`,
`ops/rasterize.py::preprocess_view`). So from that view it gets the zero
gradient that it truly has, and no value of a Gaussian in front of the
camera changes.

Each case renders numpy Gaussians from a seed and compares with jax.grad
of the JAX render. Bars are the rasterizer's: outputs atol 2e-5
(tests/test_rasterize.py:31-40), gradients atol 5e-4 of each field's
largest (tests/test_rasterize.py:114-132).
  * Depth exactly 0 in view 0. JAX's gradient for that Gaussian is NaN.
    The port's is finite and equals JAX's gradient from view 1 alone.
    Every other gradient and every output agrees with JAX.
  * w exactly -1e-7 in view 0: the same.
  * Gaussians behind the camera at other depths: both gradients are
    finite and equal, the culled ones exactly 0. The conic and xy of every
    Gaussian in front are those of the formula without the stand-in, bit
    for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_diffusiongs_tpu.ops import rasterize as jrz
from open_diffusiongs_tpu.ops.gaussians import Gaussians as JGaussians
from open_diffusiongs_tpu_torch.ops import camera as cam_lib
from open_diffusiongs_tpu_torch.ops import gs_math
from open_diffusiongs_tpu_torch.ops import rasterize as rz
from open_diffusiongs_tpu_torch.ops.gaussians import Gaussians
from utils3d import orbit_cameras, random_gaussians

H = W = 64
ROW = 5                     # the Gaussian put on the near-plane hazard
OUT_TOL = dict(atol=2e-5, rtol=0)
GRAD_ATOL = 5e-4            # of each field's largest |gradient|
CFG = dict(max_tiles_per_gaussian=16, max_per_tile=256, rect_clip="center")


def _scene(case):
    """Gaussians [1, 200], cameras [2] and targets for `case`."""
    rng = np.random.default_rng(17)
    g = random_gaussians(rng, 1, 200, scale_mean=-2.5)
    c2ws, fxy = orbit_cameras(2, h=H, w=W)
    c2ws[0] = np.eye(4, dtype=np.float32)     # looks down +z, no rotation
    if case == "depth0":    # camera at z = -0.5: that plane is depth 0
        c2ws[0][2, 3] = -0.5
        g.xyz[0, ROW] = [0.1, 0.05, -0.5]    # and in view 1's frustum
    elif case == "w1e-7":   # camera at the origin: w = z, and w + 1e-7 = 0
        g.xyz[0, ROW] = [0.4, 0.2, -np.float32(1e-7)]
    target = rng.uniform(size=(1, 2, 3, H, W)).astype(np.float32)
    return g, c2ws, fxy, target


def _jax(g, c2ws, fxy, target, views):
    """JAX's outputs and gradients of sum_v mean((render_v - target_v)^2)
    over `views`."""
    def loss(jg):
        out = jrz.render(jg, jnp.asarray(c2ws[views])[None],
                         jnp.asarray(fxy[views])[None], H, W,
                         cfg=jrz.RasterizeConfig(**CFG))
        err = (out["render"] - target[:, views]) ** 2
        return jnp.sum(jnp.mean(err, axis=(0, 2, 3, 4))), out
    jg = JGaussians(*(jnp.asarray(x) for x in g))
    grads, out = jax.grad(loss, has_aux=True)(jg)
    return ({k: np.asarray(out[k]) for k in ("render", "alpha", "depth")},
            [np.asarray(x) for x in grads])


def _port(g, c2ws, fxy, target, views):
    tg = Gaussians(*(torch.from_numpy(np.array(x)).requires_grad_(True)
                     for x in g))
    out = rz.render(tg, torch.from_numpy(c2ws[views])[None],
                    torch.from_numpy(fxy[views])[None], H, W,
                    cfg=rz.RasterizeConfig(**CFG))
    err = (out["render"] - torch.from_numpy(target[:, views])) ** 2
    grads = torch.autograd.grad(err.mean(dim=(0, 2, 3, 4)).sum(), list(tg))
    return ({k: out[k].detach().numpy() for k in ("render", "alpha",
                                                  "depth")},
            [x.numpy() for x in grads])


def _view_depth_and_w(g, c2ws, fxy, view):
    """Row ROW's depth and projective w in `view`, as preprocess_view forms
    them."""
    cam = cam_lib.make_camera(torch.from_numpy(c2ws),
                              torch.from_numpy(fxy), H, W)
    p = torch.from_numpy(g.xyz[0, ROW])

    def row(m, i):
        return float(m[view, i, 0] * p[0] + m[view, i, 1] * p[1]
                     + m[view, i, 2] * p[2] + m[view, i, 3])
    return row(cam.w2c, 2), row(cam.full_proj, 3)


def _close(got, want, name):
    scale = max(np.abs(want).max(), 1e-8)
    np.testing.assert_allclose(got / scale, want / scale, atol=GRAD_ATOL,
                               err_msg=name)


@pytest.mark.parametrize("case", ["depth0", "w1e-7"])
def test_culled_gaussian_gradient_is_finite_where_jax_is_nan(case):
    g, c2ws, fxy, target = _scene(case)
    depth, w = _view_depth_and_w(g, c2ws, fxy, 0)
    assert depth == 0.0 if case == "depth0" else w + np.float32(1e-7) == 0.0
    both = np.array([0, 1])
    j_out, j_grads = _jax(g, c2ws, fxy, target, both)
    _, j_view1 = _jax(g, c2ws, fxy, target, np.array([1]))
    p_out, p_grads = _port(g, c2ws, fxy, target, both)
    # the hazard in JAX: that row's xyz (and, at depth 0, its scaling and
    # rotation) NaN from finite outputs
    assert all(np.isfinite(v).all() for v in j_out.values())
    assert not np.isfinite(j_grads[0][0, ROW]).all()
    for k in j_out:
        np.testing.assert_allclose(p_out[k], j_out[k], **OUT_TOL,
                                   err_msg=k)
    others = np.arange(200) != ROW
    for name, got, want, alone in zip(g._fields, p_grads, j_grads, j_view1):
        assert np.isfinite(got).all(), name
        _close(got[0, others], want[0, others], name)
        # view 0 culls it: its whole gradient is view 1's
        _close(got[0, ROW], alone[0, ROW], f"{name} row {ROW}")
    assert np.abs(p_grads[0][0, ROW]).max() > 0


def test_culled_gaussians_match_jax_where_its_gradient_is_finite():
    g, c2ws, fxy, target = _scene("behind")   # camera 0 at the origin
    view0 = np.array([0])
    j_out, j_grads = _jax(g, c2ws, fxy, target, view0)
    p_out, p_grads = _port(g, c2ws, fxy, target, view0)
    depth = torch.from_numpy(g.xyz[0, :, 2])  # w2c is the identity
    culled = (depth <= rz.NEAR_CULL_Z).numpy()
    assert 20 < culled.sum() < 180
    for k in j_out:
        np.testing.assert_allclose(p_out[k], j_out[k], **OUT_TOL,
                                   err_msg=k)
    for name, got, want in zip(g._fields, p_grads, j_grads):
        assert np.isfinite(want).all(), name
        _close(got, want, name)
        assert not got[0, culled].any(), name
    assert np.abs(p_grads[0]).max() > 0

    # in front of the camera, preprocess_view's values are the formula's
    # without the stand-in, bit for bit
    tg = Gaussians(*(torch.from_numpy(np.array(x[0])) for x in g))
    act = tg.activate()
    cov3d = gs_math.build_cov3d(act.scaling, act.rotation)
    cam = cam_lib.CameraParams(*(x[0] for x in cam_lib.make_camera(
        torch.from_numpy(c2ws), torch.from_numpy(fxy), H, W)))
    pre = rz.preprocess_view(act, cov3d, cam, H, W, 0)
    plain, _, _ = gs_math.conic_and_radius(gs_math.ewa_cov2d(
        act.xyz, cov3d, cam.w2c, cam.fxfycxcy, cam.tanfov))
    px, py, pz = act.xyz.unbind(-1)

    def row(i):
        m = cam.full_proj
        return m[i, 0] * px + m[i, 1] * py + m[i, 2] * pz + m[i, 3]
    rcp_w = 1.0 / (row(3) + 1e-7)
    xy = torch.stack([cam_lib.ndc2pix(row(0) * rcp_w, W),
                      cam_lib.ndc2pix(row(1) * rcp_w, H)], -1)
    front = torch.from_numpy(~culled)
    assert torch.equal(pre.conic[front], plain[front])
    assert torch.equal(pre.xy[front], xy[front])
    assert torch.isfinite(pre.conic).all() and torch.isfinite(pre.xy).all()
