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
* The general attention route: a qk_norm DiTBlock (the reference's
  DiTBlock_QK_Norm) and denoisers whose head layout fails the packed lane
  test (width 96, heads of 24) or takes the packed kernels at dh 16 (width
  128), against the JAX modules with attn_impl="xla" at the same bar;
  subset attention; and the route each (width, dim_heads, qk_norm) takes,
  against the route JAX's own modules take.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_diffusiongs_tpu.models import transformer as jtr
from open_diffusiongs_tpu.models.denoiser import DGSDenoiser as JDenoiser
from open_diffusiongs_tpu.ops.rays import rays_chw
from open_diffusiongs_tpu_torch.models import transformer as ttr
from open_diffusiongs_tpu_torch.models.denoiser import DGSDenoiser
from open_diffusiongs_tpu_torch.utils.convert import (
    block_state_dict_from_flax, flatten_params, state_dict_from_flax)
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
              v=2, res=16, width=128, dim_heads=64):
    rng = np.random.default_rng(5)
    kw = dict(width=width, patch_size=8, n_gaussians=2, dim_heads=dim_heads,
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


def _perturbed(params, rng):
    """Every leaf moved off flax's init (zero biases, unit scales), so the
    bridge's placement of each one is exercised."""
    return jax.tree.map(lambda p: p + 0.05 * jnp.asarray(
        rng.normal(size=p.shape), p.dtype), params)


def test_qk_norm_block_matches_jax():
    """The reference's DiTBlock_QK_Norm: port DiTBlock(qk_norm=True) (the
    general route, flash_full_mha's twin on CPU) vs JAX DiTBlock(qk_norm=
    True, attn_impl="xla"); the bridge carries the q/k RMSNorm scales."""
    rng = np.random.default_rng(9)
    width, heads, l = 128, 4, 37
    x = rng.normal(size=(2, l, width)).astype(np.float32)
    c = rng.normal(size=(2, width)).astype(np.float32)
    jb = jtr.DiTBlock(width, heads, qk_norm=True, attn_impl="xla")
    params = _perturbed(jb.init(jax.random.PRNGKey(1), jnp.asarray(x),
                                jnp.asarray(c)), rng)
    want = np.asarray(jb.apply(params, jnp.asarray(x), jnp.asarray(c)))
    sd = block_state_dict_from_flax(jax.device_get(params))
    flat = flatten_params(jax.device_get(params))
    for name in ("q_norm", "k_norm"):
        np.testing.assert_array_equal(sd[f"attn.{name}.weight"].numpy(),
                                      flat[f"attn/{name}/weight"])
    block = ttr.DiTBlock(width, heads, qk_norm=True)
    block.load_state_dict(sd, strict=True)
    assert not block.attn.packed
    with torch.no_grad():
        got = block(torch.from_numpy(x), torch.from_numpy(c))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("width,dim_heads,packed", [(96, 24, False),
                                                    (128, 16, True)])
def test_general_and_dh16_denoisers_match_jax(width, dim_heads, packed):
    """4 heads of 24 fail the lane test and take the general route; 8 heads
    of 16 take the packed kernels at dh 16."""
    kw, params, inputs, jg, jxyz = _jax_case("xla", width=width,
                                             dim_heads=dim_heads)
    model = DGSDenoiser(**kw)
    model.load_state_dict(state_dict_from_flax(jax.device_get(params)),
                          strict=True)
    assert all(blk.attn.packed == packed for blk in model.transformer)
    with torch.no_grad():
        g, img_xyz = model(*(torch.from_numpy(np.array(x)) for x in inputs))
    for field in OUTS:
        np.testing.assert_allclose(getattr(g, field).numpy(),
                                   np.asarray(getattr(jg, field)),
                                   err_msg=field, **TOL)
    np.testing.assert_allclose(img_xyz.numpy(), np.asarray(jxyz), **TOL)


@pytest.mark.parametrize("impl", ["auto", "xla", "splash"])
def test_subset_attention_matches_jax(impl, monkeypatch):
    """Queries [0:s] see keys [0:s], queries [s:] see all
    (tests/test_attention.py:205-227); s >= l is full attention.  'splash'
    against JAX's splash route, its `_splash_attention` replaced by exact
    XLA attention on the pre-scaled q as tests/test_attention.py:100-114
    does on the CPU."""
    monkeypatch.setattr(jtr, "_splash_attention", lambda q_, k_, v_: (
        jax.nn.dot_product_attention(q_ * q_.shape[-1] ** 0.5, k_, v_)))
    rng = np.random.default_rng(2)
    q, k, v = (rng.normal(size=(1, 24, 2, 16)).astype(np.float32)
               for _ in range(3))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    for s_ in (9, 24):
        want = np.asarray(jtr.subset_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), subset_size=s_,
            impl="splash" if impl == "splash" else "xla"))
        got = ttr.subset_attention(tq, tk, tv, subset_size=s_, impl=impl)
        np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)


@pytest.mark.parametrize("impl", ["auto", "flash", "splash"])
def test_heads_wider_than_128_raise(impl):
    """The splash route takes heads up to 128 (tests/test_torch_wide_heads.py
    holds 80, 96 and 128 against JAX); d = 160 raises."""
    x = torch.zeros(1, 6, 2, 160)
    with pytest.raises(ValueError, match="d <= 128"):
        ttr.fused_attention(x, x, x, impl)


def _jax_route(width, dim_heads, qk_norm):
    """The route JAX's own modules take with attn_impl 'flash': shapes only
    (jax.eval_shape of init), with the two attention entry points replaced
    by recorders.  JAX's stack has no qk_norm, so a qk_norm block is built
    as the stack would hand it the packed plan."""
    seen = []

    def packed(*args, **kwargs):
        seen.append("packed")
        return lambda q, k, v: q

    def general(q, k, v, impl="auto"):
        seen.append("general")
        return q

    heads = width // dim_heads
    x, c = jnp.zeros((1, 5, width)), jnp.zeros((1, width))
    if qk_norm:
        module = jtr.DiTBlock(width, heads, attn_impl="flash", qk_norm=True,
                              packed_l=5, packed_blocks=(512, 512))
    else:
        module = jtr.DiTStack(width, heads, 1, remat=False, attn_impl="flash")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtr, "resolve_attn_impl", lambda impl: impl)
        mp.setattr(jtr, "_make_packed_attn", packed)
        mp.setattr(jtr, "fused_attention", general)
        jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), x, c))
    assert len(set(seen)) == 1, seen
    return seen[0]


@pytest.mark.parametrize("width,dim_heads,qk_norm", [
    (1024, 64, False), (1024, 64, True), (768, 48, False), (1024, 16, False),
    (128, 16, False), (96, 24, False), (64, 32, False), (128, 32, False),
    (512, 8, False), (256, 64, True)])
def test_routing_matches_jax(width, dim_heads, qk_norm):
    heads = width // dim_heads
    port = ttr.Attention(width, heads, qk_norm=qk_norm)
    route = "packed" if port.packed else "general"
    assert route == _jax_route(width, dim_heads, qk_norm)
    assert port.packed == ttr.takes_packed(width, heads, qk_norm)
    assert not ttr.Attention(width, heads, attn_impl="xla").packed
