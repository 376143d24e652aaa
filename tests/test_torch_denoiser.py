"""PyTorch port vs the reference goldens and the JAX package: the denoiser.

* The reference state dicts in tests/golden/reference_denoiser*_tiny.npz
  (`sd/*`, produced by executing the reference PyTorch code) load into the
  port with `load_state_dict(strict=True)` — the port keeps the
  reference's module names — and reproduce its recorded outputs at the
  bar of tests/test_golden_reference.py:90 (rtol 2e-4, atol 2e-5).
* The JAX DGSDenoiser (f32, 2 layers, width 128) with params bridged by
  utils/convert.py::state_dict_from_flax, through both the XLA attention
  and the interpret-mode packed Pallas kernel: same bar.
* The bridge inverts tools/convert_reference_ckpt.py::convert_state_dict.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_diffusiongs_tpu.models.denoiser import DGSDenoiser as JDenoiser
from open_diffusiongs_tpu.ops.rays import rays_chw
from open_diffusiongs_tpu_torch.models.denoiser import DGSDenoiser
from open_diffusiongs_tpu_torch.utils.convert import (flatten_params,
                                                      state_dict_from_flax)
from utils3d import orbit_cameras

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
from convert_reference_ckpt import convert_state_dict  # noqa: E402

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "golden")
FIXTURES = ["reference_denoiser_tiny.npz",
            "reference_denoiser_scene_tiny.npz"]
TOL = dict(rtol=2e-4, atol=2e-5)
OUTS = ("xyz", "features", "scaling", "rotation", "opacity")


def _golden(name):
    fx = dict(np.load(os.path.join(GOLDEN_DIR, name)))
    sd = {k[len("sd/"):]: v for k, v in fx.items() if k.startswith("sd/")}
    return fx, sd


@pytest.mark.parametrize("name", FIXTURES)
def test_reference_state_dict_loads_strict_and_reproduces_outputs(name):
    fx, sd = _golden(name)
    model = DGSDenoiser(
        width=64, in_channels=9, patch_size=8, n_gaussians=2, dim_heads=32,
        num_layers=2, ray_pe_type=str(fx["ray_pe_type"]),
        range_setting_near=float(fx["range_setting_near"]),
        range_setting_far=float(fx["range_setting_far"]))
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                          strict=True)
    with torch.no_grad():
        g, img_xyz = model(*(torch.from_numpy(fx[k]) for k in
                             ("images", "ray_o", "ray_d", "t")))
    for field in OUTS:
        np.testing.assert_allclose(getattr(g, field).numpy(),
                                   fx[f"out_{field}"], err_msg=field, **TOL)
    np.testing.assert_allclose(img_xyz.numpy(), fx["out_img_xyz"], **TOL)


def _jax_case(attn_impl, ray_pe_type="relative_plk", hard_pixelalign=True,
              v=2, res=16):
    rng = np.random.default_rng(5)
    kw = dict(width=128, patch_size=8, n_gaussians=2, dim_heads=64,
              num_layers=2, ray_pe_type=ray_pe_type,
              hard_pixelalign=hard_pixelalign, range_setting_far=10.0)
    jm = JDenoiser(**kw, dtype=jnp.float32, remat=False, attn_impl=attn_impl)
    c2ws, fxy = orbit_cameras(v, h=res, w=res)
    ray_o, ray_d = (np.asarray(x)[None] for x in rays_chw(
        jnp.asarray(c2ws), jnp.asarray(fxy), res, res))
    images = rng.uniform(0, 1, (1, v, 3, res, res)).astype(np.float32)
    t = np.asarray([421], np.int32)
    args = tuple(jnp.asarray(x) for x in (images, ray_o, ray_d, t))
    params = jm.init(jax.random.PRNGKey(0), *args)
    # non-zero biases and LayerNorm scales, so the bridge's placement of
    # every leaf is exercised (flax inits them to 0 / 1)
    params = jax.tree.map(
        lambda p: p + 0.05 * jnp.asarray(rng.normal(size=p.shape),
                                         p.dtype), params)
    jg, jxyz = jm.apply(params, *args)
    return kw, params, (images, ray_o, ray_d, t), jg, jxyz


@pytest.mark.parametrize("attn_impl,ray_pe_type,hard_pixelalign", [
    ("xla", "relative_plk", True), ("flash", "relative_plk", True),
    ("xla", "plk", True), ("xla", "relative_plk", False)])
def test_bridged_jax_params_match_jax_denoiser(attn_impl, ray_pe_type,
                                               hard_pixelalign):
    kw, params, inputs, jg, jxyz = _jax_case(attn_impl, ray_pe_type,
                                             hard_pixelalign)
    model = DGSDenoiser(**kw)
    model.load_state_dict(state_dict_from_flax(
        jax.device_get(params), ray_pe_type=ray_pe_type), strict=True)
    with torch.no_grad():
        g, img_xyz = model(*(torch.from_numpy(np.array(x)) for x in inputs))
    for field in OUTS:
        np.testing.assert_allclose(getattr(g, field).numpy(),
                                   np.asarray(getattr(jg, field)),
                                   err_msg=field, **TOL)
    np.testing.assert_allclose(img_xyz.numpy(), np.asarray(jxyz), **TOL)


@pytest.mark.parametrize("name", FIXTURES)
def test_bridge_inverts_the_reference_converter(name):
    """reference sd -> convert_state_dict (flax paths) -> state_dict_from_flax
    gives back the reference sd, bit for bit; and a JAX param tree survives
    the opposite round trip."""
    fx, sd = _golden(name)
    back = state_dict_from_flax(convert_state_dict(sd),
                                ray_pe_type=str(fx["ray_pe_type"]))
    assert set(back) == set(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)

    _, params, _, _, _ = _jax_case("xla")
    flat = flatten_params(jax.device_get(params))
    again = convert_state_dict({k: t.numpy() for k, t in
                                state_dict_from_flax(
                                    jax.device_get(params)).items()})
    assert set(again) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(again[k], v, err_msg=k)


def test_bf16_compute_keeps_f32_residual_and_outputs():
    """bf16 compute (the flagship setting): Linear outputs are bf16, the
    LayerNorms return f32 like flax, and the Gaussians come back f32."""
    kw, params, inputs, _, _ = _jax_case("xla")
    model = DGSDenoiser(**kw, dtype=torch.bfloat16)
    model.load_state_dict(state_dict_from_flax(jax.device_get(params)))
    x = torch.randn(1, 5, 128, dtype=torch.bfloat16)
    assert model.transformer[0].attn.qkv(x).dtype == torch.bfloat16
    assert model.transformer_input_layernorm(x).dtype == torch.float32
    with torch.no_grad():
        g, img_xyz = model(*(torch.from_numpy(np.array(a)) for a in inputs))
    assert all(t.dtype == torch.float32 for t in g)
    assert all(torch.isfinite(t).all() for t in g)
