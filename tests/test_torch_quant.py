"""W8A8 serving: the port's ops/quant.py and the `quant_int8` flag against
the JAX package's (open_diffusiongs_tpu/ops/quant.py, models/, builder).

* `quantize_rows` / `int8_matmul` bit for bit against JAX's
  `_quantize_rows` / `int8_matmul` in f32, with one outlier row;
* `QuantLinear` against `QuantDense` in f32 and bf16;
* the fused qkv QuantLinear against JAX's separate q / k / v QuantDenses,
  bit for bit in f32;
* a 2-layer, width-128 DGSDenoiser(quant_int8=True) against JAX's with
  bridged params: cosine >= 0.9999 and mean relative error <= 1e-3 on xyz
  and depth (a token whose f32 activation lands on a rounding edge rounds
  to another int8 step in one package; measured here: 1 - cos 2e-14,
  mean relative error 1.1e-7);
* training=True raises; the builder maps the key;
* a 2-step 16² sample through from_pretrained(overrides=[quant_int8=true])
  against the JAX sampler with the same override (bar below).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_diffusiongs_tpu.diffusion import p_sample_loop as jax_loop
from open_diffusiongs_tpu.models.denoiser import DGSDenoiser as JDenoiser
from open_diffusiongs_tpu.ops import quant as jquant
from open_diffusiongs_tpu.ops.rays import rays_chw
from open_diffusiongs_tpu.systems.builder import \
    build_system as jax_build_system
from open_diffusiongs_tpu.utils.config import load_config as jax_load_config
from open_diffusiongs_tpu_torch.models.denoiser import DGSDenoiser
from open_diffusiongs_tpu_torch.models.transformer import Attention
from open_diffusiongs_tpu_torch.ops import quant
from open_diffusiongs_tpu_torch.pipeline import (DiffusionGSPipeline,
                                                 object_camera_template)
from open_diffusiongs_tpu_torch.systems.builder import shape_model_kwargs
from open_diffusiongs_tpu_torch.tools.make_pretrained_dir import (
    main as make_pretrained_main)
from open_diffusiongs_tpu_torch.utils.convert import state_dict_from_flax
from torch_reference_weights import reference_state_dict, save_lightning_ckpt
from utils3d import orbit_cameras

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
from convert_reference_ckpt import (convert_state_dict,  # noqa: E402
                                    load_converted_params)

QUANT = "system.shape_model.quant_int8=true"
# the sample's bar: the renders' and the Gaussians' cosine to the JAX
# sampler's (measured on this case: 1 - cos < 1e-13 for both)
SAMPLE_COS = 0.999


def _cos(a, b):
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def _x(rng, m, k, outlier=False):
    x = rng.normal(0, 1.0, (m, k)).astype(np.float32)
    if outlier:
        x[3] *= 1000.0
    return x


@pytest.mark.parametrize("outlier", [False, True])
def test_quantize_rows_and_int8_matmul_match_jax_bit_for_bit(outlier):
    rng = np.random.default_rng(0)
    x = _x(rng, 32, 256, outlier)
    w = rng.normal(0, 0.05, (256, 128)).astype(np.float32)   # flax [in, out]
    xq, sx = quant.quantize_rows(torch.from_numpy(x), -1)
    jxq, jsx = jquant._quantize_rows(jnp.asarray(x), axis=-1)
    np.testing.assert_array_equal(xq.numpy(), np.asarray(jxq))
    np.testing.assert_array_equal(sx.numpy(), np.asarray(jsx))
    assert xq.dtype == torch.int8 and int(xq.abs().max()) == 127
    wq, sw = quant.quantize_rows(torch.from_numpy(w.T.copy()), 1)
    jwq, jsw = jquant._quantize_rows(jnp.asarray(w), axis=0)
    np.testing.assert_array_equal(wq.numpy(), np.asarray(jwq).T)
    np.testing.assert_array_equal(sw.numpy(), np.asarray(jsw).T)

    got = quant.int8_matmul(torch.from_numpy(x), torch.from_numpy(w.T.copy()))
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jquant.int8_matmul(jnp.asarray(x), jnp.asarray(w))))
    if outlier:   # per-token scales keep the other rows accurate
        other = np.arange(32) != 3
        want = x[other] @ w
        rel = np.abs(got.numpy()[other] - want) / np.abs(want).mean()
        assert rel.mean() < 0.01, rel.mean()


def test_int8_matmul_counts_its_products_and_keeps_leading_dims():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(2, 5, 24)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(16, 24)).astype(np.float32))
    before = quant.LAUNCHES
    y = quant.int8_matmul(x, w)
    assert quant.LAUNCHES == before + 1
    assert y.shape == (2, 5, 16) and y.dtype == torch.float32


@pytest.mark.parametrize("dtype,jdtype", [(torch.float32, jnp.float32),
                                          (torch.bfloat16, jnp.bfloat16)])
def test_quant_linear_matches_quant_dense(dtype, jdtype):
    rng = np.random.default_rng(2)
    x = rng.normal(0, 1, (2, 9, 64)).astype(np.float32)
    kernel = rng.normal(0, 0.05, (64, 48)).astype(np.float32)
    bias = rng.normal(0, 0.1, (48,)).astype(np.float32)
    lin = quant.QuantLinear(64, 48, compute_dtype=dtype)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(kernel.T.copy()))
        lin.bias.copy_(torch.from_numpy(bias))
    xt = torch.from_numpy(x).to(dtype)
    with torch.no_grad():
        got = lin(xt)
    want = jquant.QuantDense(48, dtype=jdtype).apply(
        {"params": {"kernel": jnp.asarray(kernel), "bias": jnp.asarray(bias)}},
        jnp.asarray(x, jdtype))
    assert got.dtype == dtype
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


def test_fused_qkv_matches_separate_quant_denses():
    """One [3d, d] QuantLinear = JAX's q, k, v QuantDenses, concatenated."""
    rng = np.random.default_rng(3)
    d = 64
    x = rng.normal(0, 1, (1, 20, d)).astype(np.float32)
    x[0, 7] *= 300.0                                   # an outlier token
    kernels = [rng.normal(0, 0.05, (d, d)).astype(np.float32)
               for _ in range(3)]
    biases = [rng.normal(0, 0.1, (d,)).astype(np.float32) for _ in range(3)]
    attn = Attention(d, 2, quant_int8=True)
    assert isinstance(attn.qkv, quant.QuantLinear)
    assert isinstance(attn.proj, quant.QuantLinear)
    with torch.no_grad():
        attn.qkv.weight.copy_(torch.from_numpy(
            np.concatenate([k.T for k in kernels])))
        attn.qkv.bias.copy_(torch.from_numpy(np.concatenate(biases)))
    with torch.no_grad():
        got = attn.qkv(torch.from_numpy(x)).numpy()
    want = np.concatenate([np.asarray(jquant.QuantDense(d).apply(
        {"params": {"kernel": jnp.asarray(k), "bias": jnp.asarray(b)}},
        jnp.asarray(x))) for k, b in zip(kernels, biases)], -1)
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def case():
    """(denoiser kwargs, JAX module, perturbed params, JAX inputs, numpy
    inputs) of a 2-layer, width-128 quant_int8 denoiser."""
    res, v = 16, 2
    rng = np.random.default_rng(5)
    kw = dict(width=128, patch_size=8, n_gaussians=2, dim_heads=64,
              num_layers=2, range_setting_far=10.0)
    jm = JDenoiser(**kw, dtype=jnp.float32, remat=False, attn_impl="xla",
                   quant_int8=True)
    c2ws, fxy = orbit_cameras(v, h=res, w=res)
    ray_o, ray_d = (np.asarray(x)[None] for x in rays_chw(
        jnp.asarray(c2ws), jnp.asarray(fxy), res, res))
    images = rng.uniform(0, 1, (1, v, 3, res, res)).astype(np.float32)
    t = np.asarray([421], np.int32)
    args = tuple(jnp.asarray(x) for x in (images, ray_o, ray_d, t))
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), *args)
    params = jax.tree.map(lambda p: p + 0.05 * jnp.asarray(
        rng.normal(size=p.shape), p.dtype), params)
    return kw, jm, params, args, (images, ray_o, ray_d, t)


def test_quant_denoiser_matches_jax(case):
    kw, jm, params, args, inputs = case
    jg, jxyz = jax.jit(jm.apply)(params, *args)
    model = DGSDenoiser(**kw, quant_int8=True)
    model.load_state_dict(state_dict_from_flax(jax.device_get(params)),
                          strict=True)
    float_model = DGSDenoiser(**kw)
    float_model.load_state_dict(model.state_dict(), strict=True)
    tin = tuple(torch.from_numpy(np.array(x)) for x in inputs)
    before = quant.LAUNCHES
    with torch.no_grad():
        g, img_xyz = model(*tin)
        gf, _ = float_model(*tin)
    assert quant.LAUNCHES - before == 2 * 4          # layers x projections
    for name, a, b in (("xyz", g.xyz, jg.xyz), ("depth", img_xyz, jxyz)):
        a, b = a.numpy().astype(np.float64), np.asarray(b, np.float64)
        assert np.isfinite(a).all(), name
        assert _cos(a, b) >= 0.9999, (name, _cos(a, b))
        rel = np.abs(a - b).mean() / np.abs(b).mean()
        assert rel <= 1e-3, (name, rel)
    # the int8 path ran: the float model's output differs
    assert not torch.allclose(g.xyz, gf.xyz)


def test_quant_training_raises(case):
    kw, _, _, _, inputs = case
    model = DGSDenoiser(**kw, quant_int8=True)
    tin = tuple(torch.from_numpy(np.array(x)) for x in inputs)
    with pytest.raises(ValueError, match="serving-mode"):
        model(*tin, training=True)
    with torch.no_grad():
        DGSDenoiser(**kw)(*tin, training=True)       # the float model may


def test_builder_maps_quant_int8():
    kw = shape_model_kwargs({"width": 64, "quant_int8": True})
    assert kw["quant_int8"] is True
    model = DGSDenoiser(**dict(kw, num_layers=1, dim_heads=32))
    blk = model.transformer[0]
    assert all(isinstance(m, quant.QuantLinear) for m in
               (blk.attn.qkv, blk.attn.proj, blk.mlp.fc1, blk.mlp.fc2))
    assert not isinstance(blk.adaLN_modulation[1], quant.QuantLinear)
    assert shape_model_kwargs({"quant_int8": False})["quant_int8"] is False


RES, VIEWS, STEPS = 16, 2, 2
CFG = """
exp_root_dir: "{out}"
name: "pre"
tag: "t"
use_timestamp: false
system_type: "diffusion-gs-system"
system:
  num_inference_steps: 2
  use_lpips: false
  shape_model:
    width: 64
    in_channels: 9
    patch_size: 8
    n_gaussians: 2
    dim_heads: 32
    num_layers: 2
  noise_scheduler:
    num_train_timesteps: 50
  raster:
    max_tiles_per_gaussian: 16
    max_per_tile: 1056
    blend_chunk: 32
"""


def test_quant_sample_from_pretrained_matches_jax_sampler(tmp_path):
    sd = reference_state_dict(np.random.default_rng(0))
    config = tmp_path / "config.yaml"
    config.write_text(CFG.format(out=tmp_path / "outputs"))
    ckpt = save_lightning_ckpt(sd, tmp_path / "model.ckpt")
    out = str(tmp_path / "dir")
    make_pretrained_main(["--config", str(config), "--weights", ckpt,
                          "--out", out, "--device", "cpu"])
    pipe = DiffusionGSPipeline.from_pretrained(out, bf16=False, device="cpu",
                                               overrides=[QUANT])
    assert pipe.system.model.quant_int8

    rng = np.random.default_rng(1)
    cond = rng.uniform(0, 1, (1, 1, 3, RES, RES)).astype(np.float32)
    x_T = rng.normal(size=(1, VIEWS - 1, 3, RES, RES)).astype(np.float32)
    noise = rng.normal(size=(STEPS, 1, VIEWS - 1, 3, RES, RES)
                       ).astype(np.float32)
    c2w, fxy = (x[None] for x in object_camera_template(VIEWS, h=RES,
                                                        w=RES))
    before = quant.LAUNCHES
    got = pipe.system.sample(torch.from_numpy(cond), torch.from_numpy(c2w),
                             torch.from_numpy(fxy),
                             noise=torch.from_numpy(x_T),
                             noise_fn=lambda t: torch.from_numpy(noise[t]))
    assert quant.LAUNCHES - before == 2 * 4 * STEPS

    jcfg = jax_load_config(str(config), cli_args=[QUANT], makedirs=False)
    jsys = jax_build_system(jcfg.system_type, jcfg.system, bf16=False)
    npz = str(tmp_path / "w.npz")
    np.savez(npz, **convert_state_dict(sd))
    params = load_converted_params(npz, jsys.init_params(
        jax.random.PRNGKey(0), RES, RES, v=VIEWS))
    jnoise = jnp.asarray(noise)
    ref = jax_loop(jsys.sched_infer,
                   jsys.make_model_fn(params, c2w, fxy, RES, RES,
                                      skip_cond_render=1),
                   cond, x_T, jax.random.PRNGKey(1), clip_denoised=False,
                   final_model_fn=jsys.make_model_fn(params, c2w, fxy, RES,
                                                     RES),
                   noise_fn=lambda t: jnoise[t])
    renders = got["renders"].numpy()
    assert np.isfinite(renders).all()
    assert _cos(renders, ref["renders"]) >= SAMPLE_COS
    assert _cos(got["gaussians"].xyz.numpy(),
                ref["aux"][0].xyz) >= SAMPLE_COS
