"""PyTorch port vs the JAX package: cameras, rays, Gaussian-splatting math,
activations and the export filter chain.

The same numpy inputs (made from a seed) go through the JAX function and
its port.  Both compute in f32 with the same elementwise formulas, so the
bars are f32 round-off: rtol 1e-5 / atol 1e-6, except where a 4x4 matrix
inverse enters (torch and XLA factor it differently): atol 1e-5.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_diffusiongs_tpu.ops import camera as jcam
from open_diffusiongs_tpu.ops import gs_math as jgs
from open_diffusiongs_tpu.ops import rays as jrays
from open_diffusiongs_tpu.ops.gaussians import Gaussians as JGaussians
from open_diffusiongs_tpu_torch.ops import camera as tcam
from open_diffusiongs_tpu_torch.ops import gs_math as tgs
from open_diffusiongs_tpu_torch.ops import rays as trays
from open_diffusiongs_tpu_torch.ops.gaussians import (Gaussians,
                                                      NumpyGaussians)
from utils3d import orbit_cameras, random_gaussians

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                      "reference_sampling.npz")
F32 = dict(rtol=1e-5, atol=1e-6)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(ours, ref, **tol):
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref),
                               **(tol or F32))


def test_camera_matches_jax():
    c2ws, fxy = orbit_cameras(3, h=48, w=64)
    ref = jcam.make_camera(jnp.asarray(c2ws), jnp.asarray(fxy), 48, 64)
    ours = tcam.make_camera(_t(c2ws), _t(fxy), 48, 64)
    for name in tcam.CameraParams._fields:
        _close(getattr(ours, name), getattr(ref, name), rtol=1e-5,
               atol=1e-5)
    v = np.linspace(-1.2, 1.2, 11, dtype=np.float32)
    _close(tcam.ndc2pix(_t(v), 64), jcam.ndc2pix(jnp.asarray(v), 64))


def test_rays_match_jax():
    c2ws, fxy = orbit_cameras(2, h=24, w=40)
    ro, rd = jrays.rays_chw(jnp.asarray(c2ws), jnp.asarray(fxy), 24, 40)
    to, td = trays.rays_chw(_t(c2ws), _t(fxy), 24, 40)
    assert tuple(td.shape) == (2, 3, 24, 40)
    _close(to, ro)
    _close(td, rd)
    np.testing.assert_allclose(torch.linalg.norm(td, dim=1).numpy(), 1.0,
                               atol=1e-6)


def test_cov3d_cov2d_conic_match_jax(rng):
    g = random_gaussians(rng, 1, 200, scale_mean=-2.5)
    act_j = JGaussians(*(jnp.asarray(x[0]) for x in g)).activate()
    act_t = Gaussians(*(_t(x[0]) for x in g)).activate()
    for name in act_t._fields:
        _close(getattr(act_t, name), getattr(act_j, name))
    _close(tgs.quat_to_rotmat(act_t.rotation),
           jgs.quat_to_rotmat(act_j.rotation))
    cov_j = jgs.build_cov3d(act_j.scaling, act_j.rotation)
    cov_t = tgs.build_cov3d(act_t.scaling, act_t.rotation)
    _close(cov_t, cov_j)

    c2ws, fxy = orbit_cameras(1, h=64, w=64)
    cj = jcam.make_camera(jnp.asarray(c2ws[0]), jnp.asarray(fxy[0]), 64, 64)
    # feed both the same (JAX) camera so only the projection math differs
    ct = tcam.CameraParams(*(_t(x) for x in cj))
    c2d_j = jgs.ewa_cov2d(act_j.xyz, cov_j, cj.w2c, cj.fxfycxcy, cj.tanfov)
    c2d_t = tgs.ewa_cov2d(act_t.xyz, cov_t, ct.w2c, ct.fxfycxcy, ct.tanfov)
    _close(c2d_t, c2d_j, rtol=1e-5, atol=1e-4)     # pixel² units (~1e2)
    for ours, ref in zip(tgs.conic_and_radius(_t(np.asarray(c2d_j))),
                         jgs.conic_and_radius(c2d_j)):
        _close(ours, ref)


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_eval_sh_matches_jax(rng, degree):
    sh = rng.normal(0, 0.5, (64, (degree + 1) ** 2, 3)).astype(np.float32)
    dirs = rng.normal(0, 1, (64, 3)).astype(np.float32)
    _close(tgs.eval_sh(_t(sh), degree, _t(dirs)),
           jgs.eval_sh(jnp.asarray(sh), degree, jnp.asarray(dirs)))


def test_apply_all_filters_matches_reference():
    """The reference filter chain's outputs (gs_core.py:463-475, recorded
    in reference_sampling.npz), bar rtol 1e-6 as in
    tests/test_sampling_golden.py."""
    fx = dict(np.load(GOLDEN))
    g = NumpyGaussians(
        xyz=fx["filt/xyz_in"], features=fx["filt/features_in"],
        scaling=fx["filt/scaling_in"], rotation=fx["filt/rotation_in"],
        opacity=fx["filt/opacity_in"])
    out = g.apply_all_filters(
        opacity_thres=0.02,
        crop_bbx=(-0.91, 0.91, -0.91, 0.91, -0.91, 0.91),
        cam_origins=fx["filt/cam_origins"], nearfar_percent=(0.05, 0.95))
    for name in NumpyGaussians._fields:
        np.testing.assert_allclose(getattr(out, name), fx[f"filt/{name}_out"],
                                   rtol=1e-6)
