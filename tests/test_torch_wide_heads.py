"""Wide heads (64 < d <= 128), `attn_impl: splash` and `clip_xyz`: the
PyTorch port against the JAX package on the CPU.

JAX sends every head wider than 64, and every `attn_impl: splash`, to
splash on `q * d^-1/2` (models/transformer.py:159-166); the port runs that
function on its own kernels (ops/attention.py::splash_attention: #5s + #5b
under grad, #5s without its lse otherwise), whose plain twins run here.
The JAX side runs as tests/test_attention.py:100-114 runs it on the CPU:
`resolve_attn_impl` forced to 'flash' and `_splash_attention` replaced by
exact XLA attention on the pre-scaled q (the test patches it; the JAX
package is not edited).  Bars: attention atol 2e-4 / rtol 1e-3 (the f32
attention bar of tests/test_attention.py), the denoiser rtol 2e-4 / atol
2e-5 (tests/test_golden_reference.py:90).

Also: the bridge at dim_heads 128, the bf16 pre-scale at d = 128, heads
past 128 raising, and the denoiser's [-1, 1] clamp of the pixel-aligned
points under training=True (JAX denoiser.py:200-203) with points pushed
past the cube, and the builder passing the key through.
"""

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
from open_diffusiongs_tpu_torch.ops import attention
from open_diffusiongs_tpu_torch.systems.builder import shape_model_kwargs
from open_diffusiongs_tpu_torch.utils.convert import (flatten_params,
                                                      state_dict_from_flax)
from utils3d import orbit_cameras

ATT_TOL = dict(atol=2e-4, rtol=1e-3)
TOL = dict(rtol=2e-4, atol=2e-5)
OUTS = ("xyz", "features", "scaling", "rotation", "opacity")
WIDE = dict(width=256, dim_heads=128, num_layers=2, patch_size=8,
            n_gaussians=2)


@pytest.fixture
def jax_splash(monkeypatch):
    """JAX's routing as on its chip: 'auto' resolves to 'flash', and splash
    is exact XLA attention on the pre-scaled q (no further scale)."""
    monkeypatch.setattr(jtr, "resolve_attn_impl",
                        lambda impl: "flash" if impl == "auto" else impl)

    def fake_splash(q, k, v):
        return jax.nn.dot_product_attention(q * q.shape[-1] ** 0.5, k, v)

    monkeypatch.setattr(jtr, "_splash_attention", fake_splash)


def _qkvd(seed, b, lq, lk, h, d):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, lq, h, d)).astype(np.float32)
    k, v = (rng.normal(size=(b, lk, h, d)).astype(np.float32)
            for _ in range(2))
    do = rng.normal(size=(b, lq, h, d)).astype(np.float32)
    return q, k, v, do


def _jax_vjp(fn, q, k, v, do):
    out, vjp = jax.vjp(fn, *map(jnp.asarray, (q, k, v)))
    return [np.asarray(x) for x in (out, *vjp(jnp.asarray(do)))]


@pytest.mark.parametrize("d,impl", [(80, "auto"), (128, "flash"),
                                    (128, "splash"), (96, "auto"),
                                    (48, "splash")])
def test_splash_route_matches_jax(jax_splash, d, impl):
    """fused_attention forward and gradients; under grad it runs
    FlashFullMHA, under no_grad the splash twin (the training function, not
    #5's serving one), and each CPU call launches nothing."""
    q, k, v, do = _qkvd(d, 2, 37, 37, 2, d)
    want = _jax_vjp(lambda *x: jtr.fused_attention(*x, impl), q, k, v, do)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    leaves = [x.clone().requires_grad_() for x in (tq, tk, tv)]
    got = ttr.fused_attention(*leaves, impl)
    assert "FlashFullMHA" in type(got.grad_fn).__name__
    np.testing.assert_allclose(got.detach().numpy(), want[0], **ATT_TOL)
    for g, w in zip(torch.autograd.grad(got, leaves, torch.from_numpy(do)),
                    want[1:]):
        np.testing.assert_allclose(g.numpy(), w, **ATT_TOL)
    before = attention.LAUNCHES_SPLASH
    with torch.no_grad():
        served = ttr.fused_attention(tq, tk, tv, impl)
    assert attention.LAUNCHES_SPLASH == before
    assert torch.equal(served, attention.flash_full_mha_stats_ref(
        tq, tk, tv)[0])
    np.testing.assert_allclose(served.numpy(), want[0], **ATT_TOL)


@pytest.mark.parametrize("d", [80, 128])
def test_wide_subset_attention_matches_jax(jax_splash, d):
    q, k, v, do = _qkvd(d + 1, 1, 24, 24, 2, d)
    for s_ in (9, 24):
        want = _jax_vjp(lambda *x: jtr.subset_attention(
            *x, subset_size=s_, impl="auto"), q, k, v, do)
        leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
        got = ttr.subset_attention(*leaves, subset_size=s_)
        np.testing.assert_allclose(got.detach().numpy(), want[0], **ATT_TOL)
        for g, w in zip(torch.autograd.grad(got, leaves,
                                            torch.from_numpy(do)), want[1:]):
            np.testing.assert_allclose(g.numpy(), w, **ATT_TOL)


def test_wide_prescale_is_jax_bf16_bit_for_bit():
    """At d = 128 the training q~ is JAX's `q * d**-0.5` on bf16, bit for
    bit, and the twin's output under no_grad is a bf16 tensor."""
    rng = np.random.default_rng(128)
    q = rng.normal(size=(2, 33, 2, 128)).astype(np.float32)
    want = np.asarray((jnp.asarray(q, jnp.bfloat16) * 128 ** -0.5)
                      .astype(jnp.float32))
    tq = torch.from_numpy(q).to(torch.bfloat16)
    np.testing.assert_array_equal(
        attention._train_prescaled_q(tq).float().numpy(), want)
    with torch.no_grad():
        out = attention.splash_attention(tq, tq, tq)
    assert out.dtype == torch.bfloat16 and out.shape == tq.shape


@pytest.mark.parametrize("fn", ["splash_attention", "splash_mha"])
def test_heads_past_128_raise(fn):
    """The message names the ROADMAP entry the wider heads are left to;
    under grad too."""
    x = torch.zeros(1, 4, 2, 160)
    with pytest.raises(ValueError, match="d <= 128 .*Limits"):
        getattr(attention, fn)(x, x, x)
    with pytest.raises(ValueError, match="Limits"):
        getattr(attention, fn)(x.requires_grad_(), x, x)


def test_splash_launch_refuses_grad():
    """Off the CPU the serving launch records no gradient (a meta tensor
    stands in for a CUDA one)."""
    q = torch.empty(1, 8, 2, 128, device="meta", requires_grad=True)
    with pytest.raises(RuntimeError, match="splash_attention"):
        attention.splash_mha(q, q, q)


def _jax_denoiser(jax_kw, v=2, res=16, seed=5):
    """A JAX DGSDenoiser (f32) with params moved off flax's zero / one
    init, and its inputs."""
    rng = np.random.default_rng(seed)
    jm = JDenoiser(**jax_kw, dtype=jnp.float32, remat=False,
                   attn_impl="auto")
    c2ws, fxy = orbit_cameras(v, h=res, w=res)
    ray_o, ray_d = (np.asarray(x)[None] for x in rays_chw(
        jnp.asarray(c2ws), jnp.asarray(fxy), res, res))
    images = rng.uniform(0, 1, (1, v, 3, res, res)).astype(np.float32)
    t = np.asarray([421], np.int32)
    inputs = (images, ray_o, ray_d, t)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0),
                              *map(jnp.asarray, inputs))
    params = jax.tree.map(lambda p: p + 0.05 * jnp.asarray(
        rng.normal(size=p.shape), p.dtype), params)
    return jm, params, inputs


def _port_denoiser(kw, params):
    model = DGSDenoiser(**kw)
    model.load_state_dict(state_dict_from_flax(jax.device_get(params)),
                          strict=True)
    return model


def _weights(jg, jxyz, seed=11):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=np.shape(x)).astype(np.float32)
            for x in (*jg, jxyz)]


def test_wide_head_denoiser_matches_jax(jax_splash):
    """width 256, 2 heads of 128, 2 layers: outputs under no_grad (the
    splash twin) and every parameter's gradient of a weighted sum of the
    outputs against jax.grad."""
    jm, params, inputs = _jax_denoiser(WIDE)
    jargs = tuple(map(jnp.asarray, inputs))
    jg, jxyz = jm.apply(params, *jargs)
    w = _weights(jg, jxyz)

    def loss(p):
        g, xyz = jm.apply(p, *jargs)
        return sum(jnp.sum(x * wi) for x, wi in zip((*g, xyz), w))

    jgrads = jax.jit(jax.grad(loss))(params)
    model = _port_denoiser(WIDE, params)
    assert not any(blk.attn.packed for blk in model.transformer)
    targs = [torch.from_numpy(np.array(x)) for x in inputs]
    with torch.no_grad():
        g, xyz = model(*targs)
    for field, got in zip(OUTS, g):
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(getattr(jg, field)),
                                   err_msg=field, **TOL)
    np.testing.assert_allclose(xyz.numpy(), np.asarray(jxyz), **TOL)
    g, xyz = model(*targs)
    sum((x * torch.from_numpy(wi)).sum()
        for x, wi in zip((*g, xyz), w)).backward()
    want = state_dict_from_flax(jax.device_get(jgrads))
    named = dict(model.named_parameters())
    assert set(named) == set(want)
    for name, p in named.items():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   err_msg=name, **TOL)


def test_bridge_round_trip_at_dim_heads_128():
    """The numpy bridge at dim_heads 128: JAX params -> the reference's
    fused names -> flax paths again, bit for bit, and a strict load."""
    import os
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools"))
    from convert_reference_ckpt import convert_state_dict
    _, params, _ = _jax_denoiser(WIDE)
    flat = flatten_params(jax.device_get(params))
    sd = state_dict_from_flax(jax.device_get(params))
    assert sd["transformer.0.attn.qkv.weight"].shape == (3 * 256, 256)
    again = convert_state_dict({k: t.numpy() for k, t in sd.items()})
    assert set(again) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(again[k], v, err_msg=k)
    _port_denoiser(WIDE, params)


@pytest.mark.parametrize("clip_xyz", [True, False])
def test_clip_xyz_under_training_matches_jax(clip_xyz):
    """training=True on the relative_plk PE with a depth range that puts
    pixel-aligned points past the [-1, 1] cube: JAX clamps them where
    clip_xyz is on, and so does the port; training=False never does."""
    kw = dict(width=64, dim_heads=32, num_layers=1, patch_size=8,
              n_gaussians=2, rel_depth_scale=20.0, clip_xyz=clip_xyz)
    jm, params, inputs = _jax_denoiser(kw)
    jargs = tuple(map(jnp.asarray, inputs))
    model = _port_denoiser(kw, params)
    targs = [torch.from_numpy(np.array(x)) for x in inputs]
    outs = {}
    apply = jax.jit(jm.apply, static_argnames="training")
    for training in (True, False):
        jg, jxyz = apply(params, *jargs, training=training)
        with torch.no_grad():
            g, xyz = model(*targs, training=training)
        for field, got in zip(OUTS, g):
            np.testing.assert_allclose(got.numpy(),
                                       np.asarray(getattr(jg, field)),
                                       err_msg=field, **TOL)
        np.testing.assert_allclose(xyz.numpy(), np.asarray(jxyz), **TOL)
        outs[training] = xyz
    assert float(outs[False].abs().max()) > 1.5    # past the cube
    clipped = float(outs[True].abs().max())
    assert clipped == (1.0 if clip_xyz else float(outs[False].abs().max()))


def test_builder_passes_clip_xyz():
    assert shape_model_kwargs({"clip_xyz": False})["clip_xyz"] is False
    assert DGSDenoiser(width=64, dim_heads=32, num_layers=1,
                       **shape_model_kwargs({"clip_xyz": False}, bf16=False)
                       ).clip_xyz is False
    assert DGSDenoiser(width=64, dim_heads=32, num_layers=1).clip_xyz
