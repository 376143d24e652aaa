"""PyTorch port vs the JAX package: losses and metrics (systems/losses.py).

Bars: SSIM in both covariance modes and `compute_losses` field by field at
rtol 1e-5 (same f32 formulas; atol 1e-6 for terms that are near 0);
LPIPS at rtol 2e-4 against the JAX LPIPS with the same seeded random
weights and against tests/golden/reference_lpips.npz, as
tests/test_lpips_golden.py holds the JAX package.  The three hazards of
the module docstring each have a test: the population std, the detached
points-distance target, and the antialiased 512 -> 256 resize.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_diffusiongs_tpu.systems import losses as jl
from open_diffusiongs_tpu_torch.systems import losses as tl

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
sys.path.insert(0, os.path.join(ROOT, "tests"))

TOL = dict(rtol=1e-5, atol=1e-6)


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("sample_cov", [False, True])
def test_ssim_matches_jax(rng, sample_cov):
    x = rng.uniform(size=(3, 3, 24, 24)).astype(np.float32)
    y = np.clip(x + rng.normal(0, 0.1, x.shape), 0, 1).astype(np.float32)
    ours = tl.ssim(_t(x), _t(y), use_sample_covariance=sample_cov)
    ref = jl.ssim(jnp.asarray(x), jnp.asarray(y),
                  use_sample_covariance=sample_cov)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)


def _loss_inputs(rng, b=2, v=2, h=16, w=16):
    f = lambda *s: rng.uniform(size=s).astype(np.float32)  # noqa: E731
    return dict(rendering=f(b, v, 3, h, w), target=f(b, v, 3, h, w),
                ray_o=rng.normal(size=(b, v, 3, h, w)).astype(np.float32),
                img_aligned_xyz=rng.normal(size=(b, v, 3, h, w))
                .astype(np.float32),
                gt_img_aligned_xyz=rng.normal(size=(b, v, 3, h, w))
                .astype(np.float32),
                masks=(f(b, v, 1, h, w) > 0.3).astype(np.float32))


def test_compute_losses_matches_jax_field_by_field(rng):
    inp = _loss_inputs(rng)
    ours = tl.compute_losses(**{k: _t(x) for k, x in inp.items()},
                             use_lpips=False)
    ref = jl.compute_losses(**{k: jnp.asarray(x) for k, x in inp.items()},
                            use_lpips=False)
    for name in jl.LossOutputs._fields:
        np.testing.assert_allclose(getattr(ours, name).numpy(),
                                   np.asarray(getattr(ref, name)), **TOL,
                                   err_msg=name)


def test_pointsdist_uses_population_std_and_a_detached_target(rng):
    """The regularizer's target is (d - mean) / (std_ddof0 + 1e-8) * 0.5
    + |ray_o| of the DETACHED distance: its gradient is 2 (d - target) / n
    through d alone, as jax.grad with stop_gradient gives."""
    inp = _loss_inputs(rng, b=1, v=1)
    xyz = _t(inp["img_aligned_xyz"]).requires_grad_(True)
    ray_o = _t(inp["ray_o"])
    pd = tl.compute_losses(_t(inp["rendering"]), _t(inp["target"]), ray_o,
                           img_aligned_xyz=xyz, use_lpips=False).pointsdist
    dist = torch.linalg.norm(xyz - ray_o, dim=2, keepdim=True).detach()
    trgt = ((dist - dist.mean()) / (dist.std(correction=0) + 1e-8) * 0.5
            + torch.linalg.norm(ray_o, dim=2, keepdim=True))
    np.testing.assert_allclose(
        pd.detach().numpy(), ((dist - trgt) ** 2).mean().reshape(1).numpy(),
        **TOL)
    unbiased = ((dist - dist.mean()) / (dist.std() + 1e-8) * 0.5
                + torch.linalg.norm(ray_o, dim=2, keepdim=True))
    assert not np.allclose(pd.detach().numpy(),
                           ((dist - unbiased) ** 2).mean().numpy(), rtol=1e-5)
    (got,) = torch.autograd.grad(pd.sum(), xyz)

    def jax_pd(x):
        return jl.compute_losses(
            jnp.asarray(inp["rendering"]), jnp.asarray(inp["target"]),
            jnp.asarray(inp["ray_o"]), img_aligned_xyz=x,
            use_lpips=False).pointsdist.sum()

    want = jax.grad(jax_pd)(jnp.asarray(inp["img_aligned_xyz"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-6)


def test_lpips_matches_jax_with_seeded_random_weights(rng):
    x = rng.uniform(-1, 1, size=(2, 3, 16, 16)).astype(np.float32)
    y = rng.uniform(-1, 1, size=(2, 3, 16, 16)).astype(np.float32)
    ours_p = tl.lpips_init_params(None, seed=3)
    assert ours_p["pretrained"] is False
    ours = tl.lpips(ours_p, _t(x), _t(y))
    ref = jl.lpips(jl.lpips_init_params(None, seed=3), jnp.asarray(x),
                   jnp.asarray(y))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=2e-4)


def test_lpips_reproduces_the_reference_golden(tmp_path):
    from convert_lpips_weights import convert_arrays
    from test_lpips_golden import _weights
    fx = dict(np.load(os.path.join(ROOT, "tests", "golden",
                                   "reference_lpips.npz")))
    path = str(tmp_path / "lpips_vgg.npz")
    np.savez(path, **convert_arrays(*_weights()))
    params = tl.lpips_init_params(npz_path=path)
    assert params["pretrained"] is True
    val = tl.lpips(params, _t(fx["x"]), _t(fx["y"]))
    np.testing.assert_allclose(val.numpy(), fx["lpips"], rtol=2e-4,
                               atol=1e-6)


def test_resize_matches_jax_antialiased_downsample(rng):
    x = rng.uniform(size=(2, 3, 512, 512)).astype(np.float32)
    ours = tl.resize_bilinear_256(_t(x))
    ref = jl.resize_bilinear_256(jnp.asarray(x))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5)
    plain = torch.nn.functional.interpolate(_t(x), size=(256, 256),
                                            mode="bilinear")
    assert np.abs(plain.numpy() - np.asarray(ref)).max() > 1e-3
    same = rng.uniform(size=(1, 3, 256, 256)).astype(np.float32)
    assert torch.equal(tl.resize_bilinear_256(_t(same)), _t(same))
    np.testing.assert_allclose(np.asarray(jl.resize_bilinear_256(
        jnp.asarray(same))), same, atol=1e-6)


def test_compute_metrics_matches_jax(rng):
    """PSNR and the eval SSIM (skimage covariance) on clamped images; the
    LPIPS entry is lpips on resize_bilinear_256 inputs, both held above."""
    t = rng.uniform(size=(2, 3, 32, 32)).astype(np.float32)
    r = np.clip(t + rng.normal(0, 0.2, t.shape), -0.2, 1.2).astype(np.float32)
    ours = tl.compute_metrics(_t(t), _t(r))
    ref = jl.compute_metrics(jnp.asarray(t), jnp.asarray(r))
    assert set(ours) == set(ref) == {"psnr", "ssim"}
    for name in ("psnr", "ssim"):
        np.testing.assert_allclose(ours[name].numpy(), np.asarray(ref[name]),
                                   **TOL, err_msg=name)
