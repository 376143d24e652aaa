"""Training through the general attention route, PyTorch port vs the JAX
package, on the CPU.

JAX trains that route through splash on `q * d^-1/2`
(models/transformer.py:116-152); the port runs the same function on its
own pair, `FlashFullMHA` = the stats forward #5s + the backward #5b
(ops/attention.py), whose plain twins run here:

  * the stats twin (o and the base-2 lse), `FlashFullMHA` under autograd
    and the backward twin (dq, dk, dv) against `jax.vjp` of JAX's 'xla'
    attention on the same numpy q, k, v and dO, at d 64 / 48 / 40 / 20,
    lk != lq and ragged lengths; bar atol 2e-4 / rtol 1e-3, the f32
    attention bar of tests/test_attention.py;
  * the training pre-scale bf16(q * bf16(d^-1/2)) bit for bit against
    JAX's `q * d**-0.5` on bf16 arrays, and the route under grad computing
    it (not #5's serving pre-scale, 0.18 % apart at d = 64);
  * DiTBlock(qk_norm=True): output and every parameter's gradient against
    jax.grad of JAX DiTBlock(qk_norm=True, attn_impl="xla") with bridged
    params, rtol 2e-4 / atol 2e-5;
  * `train_loss` and every parameter's gradient of a width-96 denoiser
    with heads of 24 (the general route) against JAX with injected noise
    and t, the bars of tests/test_torch_train.py;
  * block checkpointing gives bit-identical gradients through the route;
  * the raw launches still refuse grad; subset attention is
    differentiable and matches jax.vjp.
The kernels are held against these twins on the GPU by chip_smoke.py
(phase 16).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_diffusiongs_tpu.models import transformer as jtr
from open_diffusiongs_tpu.ops import rasterize as jrz
from open_diffusiongs_tpu.systems.object_system import \
    ObjectSystem as JaxSystem
from open_diffusiongs_tpu.systems.object_system import \
    ObjectSystemConfig as JaxSystemConfig
from open_diffusiongs_tpu_torch.models import transformer as ttr
from open_diffusiongs_tpu_torch.models.denoiser import DGSDenoiser
from open_diffusiongs_tpu_torch.ops import attention
from open_diffusiongs_tpu_torch.ops import rasterize as rz
from open_diffusiongs_tpu_torch.systems.object_system import (
    ObjectSystem, ObjectSystemConfig)
from open_diffusiongs_tpu_torch.utils.convert import (
    block_state_dict_from_flax, state_dict_from_flax)
from test_torch_train import RASTER, _batch, _torch_batch

ATT_TOL = dict(atol=2e-4, rtol=1e-3)
TOL = dict(rtol=2e-4, atol=2e-5)
LOG2E = 1.4426950408889634

# (b, lq, lk, h, d, sigma of q/k, seed)
CASES = {
    "d64": (2, 70, 70, 3, 64, 1.0, 0),
    "d48": (1, 65, 65, 4, 48, 1.0, 1),
    "d40": (2, 33, 33, 3, 40, 1.0, 2),
    "d20": (2, 47, 47, 3, 20, 1.0, 3),
    "lk_ne_lq": (2, 21, 53, 2, 64, 1.0, 4),
    "ragged_129_sigma3": (1, 129, 129, 2, 48, 3.0, 5),
}


def _case(name):
    b, lq, lk, h, d, sigma, seed = CASES[name]
    rng = np.random.default_rng(seed)
    q = rng.normal(0, sigma, (b, lq, h, d)).astype(np.float32)
    k = rng.normal(0, sigma, (b, lk, h, d)).astype(np.float32)
    v = rng.normal(size=(b, lk, h, d)).astype(np.float32)
    do = rng.normal(size=(b, lq, h, d)).astype(np.float32)
    return q, k, v, do


def _jax_attention(q, k, v, do):
    """o, the base-2 lse [b, h, l] and (dq, dk, dv) of JAX's 'xla' route."""
    return [np.asarray(x) for x in _jax_attention_jit(
        *map(jnp.asarray, (q, k, v, do)))]


@jax.jit
def _jax_attention_jit(q, k, v, do):
    o, vjp = jax.vjp(lambda *x: jtr.fused_attention(*x, "xla"), q, k, v)
    s = jnp.einsum("blhd,bmhd->bhlm", q, k) * q.shape[-1] ** -0.5
    lse = jax.nn.logsumexp(s, axis=-1) / math.log(2.0)
    return (o, lse, *vjp(do))


@pytest.mark.parametrize("case", list(CASES))
def test_stats_twin_and_function_match_jax_vjp(case):
    q, k, v, do = _case(case)
    o_want, lse_want, *grads_want = _jax_attention(q, k, v, do)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = attention.flash_full_mha_stats_ref(tq, tk, tv)
    assert lse.shape == (q.shape[0], q.shape[2], q.shape[1])
    np.testing.assert_allclose(o.numpy(), o_want, **ATT_TOL)
    np.testing.assert_allclose(lse.numpy(), lse_want, **ATT_TOL)
    for got, want in zip(attention.flash_full_mha_bwd_ref(tq, tk, tv, o, tdo,
                                                          lse), grads_want):
        np.testing.assert_allclose(got.numpy(), want, **ATT_TOL)
    # the autograd Function: forward and backward are these twins
    leaves = [x.clone().requires_grad_() for x in (tq, tk, tv)]
    out = attention.FlashFullMHA.apply(*leaves)
    assert torch.equal(out.detach(), o)
    for got, want in zip(torch.autograd.grad(out, leaves, tdo), grads_want):
        np.testing.assert_allclose(got.numpy(), want, **ATT_TOL)


@pytest.mark.parametrize("d", [64, 48, 20])
def test_train_prescale_is_jax_bf16_bit_for_bit(d):
    """bf16(q * bf16(d^-1/2)), as JAX's `q_ * scale` on a bf16 array with a
    weak-typed scale (transformer.py:141-146), bit for bit; at d 48 and 20
    it is not the product with the f32 scale.  Not #5's serving pre-scale:
    its logit scale bf16(d^-1/2 log2 e) / log2 e is 0.18 % off at d = 64."""
    rng = np.random.default_rng(d)
    q = rng.normal(size=(2, 97, 3, d)).astype(np.float32)
    jq = jnp.asarray(q, jnp.bfloat16)
    want = np.asarray((jq * d ** -0.5).astype(jnp.float32))
    tq = torch.from_numpy(q).to(torch.bfloat16)
    got = attention._train_prescaled_q(tq)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)
    f32_scale = (tq.float() * d ** -0.5).to(torch.bfloat16)
    assert torch.equal(got, f32_scale) == (d == 64)
    serving = attention._full_scale(d, torch.bfloat16) / LOG2E
    train = attention._train_scale(d, torch.bfloat16)
    if d == 64:
        assert abs(serving / train - 1.0) > 1.5e-3


def test_route_under_grad_runs_the_training_function_in_bf16():
    """On CPU tensors that require grad, `fused_attention` runs
    `FlashFullMHA`: the bf16 output is the stats twin's (training
    pre-scale), not #5's serving twin; under no_grad it is #5's."""
    q, k, v, _ = _case("d64")
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    want = attention.flash_full_mha_stats_ref(tq, tk, tv)[0]
    serving = attention.flash_full_mha_ref(tq, tk, tv)
    assert not torch.equal(want, serving)
    got = ttr.fused_attention(tq.requires_grad_(), tk, tv)
    assert got.grad_fn is not None and "FlashFullMHA" in type(
        got.grad_fn).__name__
    assert torch.equal(got.detach(), want)
    with torch.no_grad():
        assert torch.equal(ttr.fused_attention(tq, tk, tv), serving)


def test_qk_norm_block_output_and_grads_match_jax():
    rng = np.random.default_rng(9)
    width, heads, l = 128, 4, 37
    x = rng.normal(size=(2, l, width)).astype(np.float32)
    c = rng.normal(size=(2, width)).astype(np.float32)
    r = rng.normal(size=(2, l, width)).astype(np.float32)
    jb = jtr.DiTBlock(width, heads, qk_norm=True, attn_impl="xla")
    params = jb.init(jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(c))
    params = jax.tree.map(lambda p: p + 0.05 * jnp.asarray(
        rng.normal(size=p.shape), p.dtype), params)

    def loss(p, x_):
        return jnp.sum(jb.apply(p, x_, jnp.asarray(c)) * r)

    want, (jgp, jgx) = jax.jit(lambda p, x_: (
        jb.apply(p, x_, jnp.asarray(c)),
        jax.grad(loss, argnums=(0, 1))(p, x_)))(params, jnp.asarray(x))
    block = ttr.DiTBlock(width, heads, qk_norm=True)
    block.load_state_dict(block_state_dict_from_flax(
        jax.device_get(params)), strict=True)
    assert not block.attn.packed
    tx = torch.from_numpy(x).requires_grad_()
    got = block(tx, torch.from_numpy(c))
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
    (got * torch.from_numpy(r)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), **TOL)
    want_g = block_state_dict_from_flax(jax.device_get(jgp))
    named = dict(block.named_parameters())
    assert set(named) == set(want_g)
    for name, p in named.items():
        np.testing.assert_allclose(p.grad.numpy(), want_g[name].numpy(),
                                   err_msg=name, **TOL)


GENERAL = dict(width=96, num_layers=2, patch_size=8, dim_heads=24)


def test_general_route_train_loss_and_grads_match_jax(monkeypatch):
    """The width-96 denoiser with 4 heads of 24 (the general route) at step
    151, 16² and 2 + 2 views: loss and metrics within rtol 2e-4 / atol
    2e-5, every gradient within rel-max 1e-3 of jax.grad, and the backward
    ran through FlashFullMHA once per layer."""
    jsys = JaxSystem(JaxSystemConfig(
        use_lpips=False, shape_model=dict(GENERAL, dtype=jnp.float32,
                                          remat=False),
        raster=jrz.RasterizeConfig(**RASTER)))
    params = jsys.init_params(jax.random.PRNGKey(0), 16, 16, v=2)
    batch = _batch(np.random.default_rng(1), res=16, v=2)
    jbatch = {k: jnp.asarray(x) for k, x in batch.items()}
    rng = jax.random.PRNGKey(3)
    step = 151
    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jsys.train_loss(p, jbatch, rng, jnp.int32(step)),
        has_aux=True))(params)
    rng_noise, rng_t = jax.random.split(rng)
    noise = np.array(jax.random.normal(rng_noise, batch["rgbs_input"].shape,
                                       jnp.float32))
    t = np.array(jax.random.randint(rng_t, (1,), 0, 1000))

    system = ObjectSystem(ObjectSystemConfig(
        use_lpips=False, shape_model=GENERAL,
        raster=rz.RasterizeConfig(**RASTER)))
    system.model.load_state_dict(state_dict_from_flax(
        jax.device_get(params)), strict=True)
    assert not any(blk.attn.packed for blk in system.model.transformer)
    calls = []
    bwd = attention.flash_full_mha_bwd
    monkeypatch.setattr(attention, "flash_full_mha_bwd",
                        lambda *a: calls.append(1) or bwd(*a))
    loss, metrics = system.train_loss(
        _torch_batch(batch), step, noise=torch.from_numpy(noise),
        t=torch.from_numpy(t).long())
    loss.backward()
    assert len(calls) == GENERAL["num_layers"]
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **TOL)
    for name, ref in jmetrics.items():
        np.testing.assert_allclose(float(metrics[name]), float(ref),
                                   err_msg=name, **TOL)
    want = state_dict_from_flax(jax.device_get(jgrads))
    got = dict(system.model.named_parameters())
    assert set(want) == set(got)
    for name, ref in want.items():
        g = got[name].grad
        scale = float(ref.abs().max())
        if scale == 0.0:
            assert g is None or not g.any(), name
            continue
        err = float((g - ref).abs().max()) / scale
        assert err <= 1e-3, f"{name}: rel-max {err:.3g}"


def test_block_checkpointing_is_bit_identical_through_the_general_route():
    rng = np.random.default_rng(2)
    images = torch.from_numpy(rng.uniform(size=(1, 2, 3, 16, 16))
                              .astype(np.float32))
    rays = torch.from_numpy(rng.normal(size=(2, 1, 2, 3, 16, 16))
                            .astype(np.float32))
    t = torch.tensor([10])
    grads = []
    for ckpt in (False, True):
        model = DGSDenoiser(**GENERAL, checkpoint=ckpt)
        assert not any(blk.attn.packed for blk in model.transformer)
        model.init_weights(torch.Generator().manual_seed(0))
        g, xyz = model(images, rays[0], rays[1], t)
        loss = sum(x.square().mean() for x in g) + xyz.square().mean()
        grads.append(torch.autograd.grad(loss, list(model.parameters())))
    for a, b in zip(*grads):
        assert torch.equal(a, b)


@pytest.mark.parametrize("fn", ["flash_full_mha", "flash_full_mha_stats",
                                "flash_full_mha_bwd"])
def test_raw_launches_refuse_grad(fn):
    """Off the CPU the raw launches record no gradient: an input that
    requires grad under grad mode raises, naming the differentiable route
    (a meta tensor stands in for a CUDA one)."""
    q = torch.empty(1, 8, 2, 64, device="meta", requires_grad=True)
    args = (q, q, q)
    if fn == "flash_full_mha_bwd":
        args += (q, q, torch.empty(1, 2, 8, device="meta"))
    with pytest.raises(RuntimeError, match="FlashFullMHA"):
        getattr(attention, fn)(*args)


def _subset_vjp(q, k, v, do, s_):
    out, vjp = jax.vjp(lambda *x: jtr.subset_attention(
        *x, subset_size=s_, impl="xla"), q, k, v)
    return (out, *vjp(do))


def test_subset_attention_is_differentiable_and_matches_jax_vjp():
    rng = np.random.default_rng(7)
    q, k, v, do = (rng.normal(size=(1, 24, 2, 20)).astype(np.float32)
                   for _ in range(4))
    for s_ in (9, 24):
        want, *grads = jax.jit(lambda q_, k_, v_, do_: _subset_vjp(
            q_, k_, v_, do_, s_))(*map(jnp.asarray, (q, k, v, do)))
        leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
        got = ttr.subset_attention(*leaves, subset_size=s_)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   **ATT_TOL)
        for g, w in zip(torch.autograd.grad(got, leaves,
                                            torch.from_numpy(do)), grads):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **ATT_TOL)


def test_backward_layouts():
    """The backward reads lse and delta as [b, h, stats_pitch(l)] f32: the
    stats forward's view is taken as it lies, another layout is copied;
    delta is rowsum(dO * O) per head with zero pad columns."""
    b, l, h, d = 2, 7, 3, 5
    pitch = attention.stats_pitch(l)
    full = torch.arange(b * h * pitch, dtype=torch.float32).reshape(
        b, h, pitch)
    view = full[..., :l]
    assert attention._full_stats_layout(view).data_ptr() == view.data_ptr()
    dense = view.contiguous()
    moved = attention._full_stats_layout(dense)
    assert moved.stride() == (h * pitch, pitch, 1)
    assert torch.equal(moved, dense)
    rng = np.random.default_rng(0)
    do, o = (torch.from_numpy(rng.normal(size=(b, l, h, d))
                              .astype(np.float32)) for _ in range(2))
    delta = attention._full_delta(do, o)
    assert delta.shape == (b, h, pitch) and not delta[..., l:].any()
    torch.testing.assert_close(delta[..., :l],
                               (do * o).sum(-1).transpose(1, 2))
