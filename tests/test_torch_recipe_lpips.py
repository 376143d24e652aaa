"""The recipes' training loss with the LPIPS term on, and the port's two
weight converters.

  * `ObjectSystem.train_loss` with LPIPS on (the random-frozen VGG of
    `lpips_init_params(None)`: the same seeded numpy draws in both
    packages, waived in by `allow_random_lpips`) on the tiny system
    (width 64, 2 layers, 16², one batch element, 2 + 2 views, K = 4608 >=
    N) against the JAX `train_loss` with bridged params and JAX's noise
    and t, at step 0 (lambda_lpips 0) and step 151 (0.5): loss and
    metrics within rtol 2e-4 / atol 2e-5, every parameter's gradient
    within rel-max 1e-3 (tests/test_torch_train.py's bars).  The scene
    system the same way at the scene recipe's lambda_lpips 0.1.
    `resize_bilinear_256` lifts the 16² renders, so VGG runs at 256²;
  * the term reaches the DiT: at step 151 the gradients differ from the
    same step's with lambda_lpips 0; the VGG tensors need no grad;
  * the configs' dotlist `system.use_lpips=true
    system.allow_random_lpips=true` builds the random VGG, and without
    the waiver the guard raises;
  * the card-against-CPU LPIPS gradient check of chip_smoke.py phase 20
    compares on shared ReLU / max-pool decisions (`lpips_routed`): on a
    flat render (a white background ties every pool window) f32 and f64
    on the CPU take different subgradients (rel-max > 1e-3), on the
    f32 pass's recorded decisions they agree within 1e-5, and the routed
    function equals `losses.lpips` bit for bit;
  * `tools/convert_lpips_weights.py` of the port on torchvision-layout
    VGG16 and lpips-head state dicts of the full spec saved with
    `torch.save`: its NPZ equals the root tool's `convert_arrays` key for
    key and bit for bit and loads through `lpips_init_params`; a missing
    or misshapen key raises in the converter and in the loader;
  * `tools/convert_u2net_weights.py` of the port on a u2netp state dict
    on disk: its NPZ equals the root tool's `convert_state_dict` and loads
    through `utils/u2net.py::load_params`; the full spec's keys and shapes
    from an in-memory state dict of broadcast views; a missing or
    misshapen key raises in the converter and in the loader.
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_diffusiongs_tpu.ops import rasterize as jrz
from open_diffusiongs_tpu.systems.object_system import \
    ObjectSystem as JaxObjectSystem
from open_diffusiongs_tpu.systems.object_system import \
    ObjectSystemConfig as JaxObjectConfig
from open_diffusiongs_tpu.systems.scene_system import \
    SceneSystem as JaxSceneSystem
from open_diffusiongs_tpu.systems.scene_system import \
    SceneSystemConfig as JaxSceneConfig
from open_diffusiongs_tpu_torch.ops import rasterize as rz
from open_diffusiongs_tpu_torch.pipeline import object_camera_template
from open_diffusiongs_tpu_torch.systems import builder, losses
from open_diffusiongs_tpu_torch.systems.object_system import (
    ObjectSystem, ObjectSystemConfig)
from open_diffusiongs_tpu_torch.systems.scene_system import (
    SceneSystem, SceneSystemConfig)
from open_diffusiongs_tpu_torch.tools import convert_lpips_weights as clp
from open_diffusiongs_tpu_torch.tools import convert_u2net_weights as cu2
from open_diffusiongs_tpu_torch.utils import u2net
from open_diffusiongs_tpu_torch.utils.checkpoint import load_module_weights
from open_diffusiongs_tpu_torch.utils.config import load_config
from open_diffusiongs_tpu_torch.utils.convert import state_dict_from_flax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
import convert_lpips_weights as root_lpips  # noqa: E402
import convert_u2net_weights as root_u2net  # noqa: E402

RES, V = 16, 2
RASTER = dict(max_tiles_per_gaussian=16, max_per_tile=4608)
OBJECT_TINY = dict(width=64, num_layers=2, patch_size=8, dim_heads=32)
SCENE_TINY = dict(OBJECT_TINY, ray_pe_type="plk", range_setting_near=0.0,
                  range_setting_far=500.0)
# configs/diffusionGS_scene.yaml's loss block
SCENE_LAMBDAS = dict(lambda_diffusion=1.0, lambda_lpips=0.1,
                     lambda_ssim=0.0, lambda_pointsdist=0.0, lambda_xyz=0.0)
LPIPS_ON = dict(use_lpips=True, allow_random_lpips=True)
JAX_RNG = jax.random.PRNGKey(3)     # train_loss's key: its noise and t


def _batch(rng):
    """One object of 2 input and 2 supervision views at 16²."""
    c2ws, fxy = object_camera_template(V, h=RES, w=RES)
    cams = dict(c2ws=c2ws[None].copy(), fxfycxcys=fxy[None].copy())
    shape = (1, V, 3, RES, RES)
    return {
        "rgbs_input": rng.uniform(size=shape).astype(np.float32),
        "c2ws_input": cams["c2ws"], "fxfycxcys_input": cams["fxfycxcys"],
        "depths_input": rng.uniform(2.0, 4.0, (1, V, 1, RES, RES))
        .astype(np.float32),
        "masks_input": np.ones((1, V, 1, RES, RES), np.float32),
        "rgbs": rng.uniform(size=shape).astype(np.float32), **cams,
    }


def _bridged(jax_cls, jax_cfg_cls, cls, cfg_cls, tiny, batch, **kw):
    """The JAX system's params and its jitted value-and-grad of
    train_loss on `batch` (step traced), and the port system holding the
    same weights; LPIPS on."""
    jsys = jax_cls(jax_cfg_cls(
        shape_model=dict(tiny, dtype=jnp.float32, remat=False),
        raster=jrz.RasterizeConfig(**RASTER), **LPIPS_ON, **kw))
    params = jsys.init_params(jax.random.PRNGKey(0), RES, RES, v=V)
    jbatch = {k: jnp.asarray(x) for k, x in batch.items()}
    loss_and_grad = jax.jit(jax.value_and_grad(
        lambda p, step: jsys.train_loss(p, jbatch, JAX_RNG, step),
        has_aux=True))
    system = cls(cfg_cls(shape_model=tiny, raster=rz.RasterizeConfig(**RASTER),
                         **LPIPS_ON, **kw))
    load_module_weights(system.model, state_dict_from_flax(
        jax.device_get(params)), strict=True)
    return params, loss_and_grad, system


@pytest.fixture(scope="module")
def batch():
    return _batch(np.random.default_rng(1))


@pytest.fixture(scope="module")
def object_pair(batch):
    return _bridged(JaxObjectSystem, JaxObjectConfig, ObjectSystem,
                    ObjectSystemConfig, OBJECT_TINY, batch)


def _port_loss(system, batch, step, noise, t, **cfg):
    """The port's loss, metrics and parameter gradients at `step`; `cfg`
    replaces config fields for this call."""
    saved = system.cfg
    system.cfg = dataclasses.replace(saved, **cfg)
    try:
        system.model.zero_grad()
        loss, metrics = system.train_loss(
            {k: torch.from_numpy(x) for k, x in batch.items()}, step,
            noise=torch.from_numpy(noise), t=torch.from_numpy(t).long())
        loss.backward()
    finally:
        system.cfg = saved
    grads = {k: p.grad.clone() for k, p in system.model.named_parameters()
             if p.grad is not None}
    return loss.detach(), metrics, grads


def _jax_draws(rng, batch):
    """The noise and t of JAX train_loss (object_system.py:168-170)."""
    rng_noise, rng_t = jax.random.split(rng)
    noise = np.array(jax.random.normal(rng_noise, batch["rgbs_input"].shape,
                                       jnp.float32))
    return noise, np.array(jax.random.randint(rng_t, (1,), 0, 1000))


def _check_against_jax(params, loss_and_grad, system, batch, step):
    (jloss, jmetrics), jgrads = loss_and_grad(params, jnp.int32(step))
    noise, t = _jax_draws(JAX_RNG, batch)
    loss, metrics, grads = _port_loss(system, batch, step, noise, t)
    assert int(metrics["overflow_gaussians"]) == 0
    assert float(metrics["loss_lpips"]) > 0
    np.testing.assert_allclose(float(loss), float(jloss), rtol=2e-4,
                               atol=2e-5)
    for name, ref in jmetrics.items():
        np.testing.assert_allclose(float(metrics[name]), float(ref),
                                   rtol=2e-4, atol=2e-5, err_msg=name)
    want = state_dict_from_flax(jax.device_get(jgrads))
    assert set(want) == set(dict(system.model.named_parameters()))
    for name, ref in want.items():
        g = grads.get(name)
        scale = float(ref.abs().max())
        if scale == 0.0:
            assert g is None or not g.any(), name
            continue
        err = float((g - ref).abs().max()) / scale
        assert err <= 1e-3, f"{name}: rel-max {err:.3g}"
    return metrics


@pytest.mark.parametrize("step", [0, 151])
def test_object_train_loss_with_lpips_matches_jax(object_pair, batch, step):
    metrics = _check_against_jax(*object_pair, batch, step)
    # lambda_lpips [150, 0, 0.5, 151]: off at 0, 0.5 from 151
    terms = {k: float(metrics[k]) for k in metrics if k.startswith("loss_")}
    weight = 0.5 if step == 151 else 0.0
    want = (terms["loss_pointsdist"] if step == 0 else
            terms["loss_diffusion"] + weight * terms["loss_lpips"]
            + 0.025 * terms["loss_xyz"])
    np.testing.assert_allclose(float(metrics["loss"]), want, rtol=1e-5)


def test_scene_train_loss_with_lpips_matches_jax(batch):
    scene_batch = {k: v for k, v in batch.items()
                   if k not in ("depths_input", "masks_input")}
    pair = _bridged(JaxSceneSystem, JaxSceneConfig, SceneSystem,
                    SceneSystemConfig, SCENE_TINY, scene_batch,
                    **SCENE_LAMBDAS)
    metrics = _check_against_jax(*pair, scene_batch, 0)
    assert float(metrics["loss_xyz"]) == 0.0      # no depth ground truth


def test_lpips_term_reaches_the_dit(object_pair, batch):
    system = object_pair[2]
    vgg = [t for v in system.lpips_params.values() if not isinstance(v, bool)
           for t in (v.values() if isinstance(v, dict) else [v])]
    assert len(vgg) == 31 and not any(t.requires_grad for t in vgg)
    noise, t = _jax_draws(JAX_RNG, batch)
    _, m_on, on = _port_loss(system, batch, 151, noise, t)
    _, m_off, off = _port_loss(system, batch, 151, noise, t,
                               lambda_lpips=0.0)
    assert float(m_on["loss_lpips"]) == float(m_off["loss_lpips"]) > 0
    np.testing.assert_allclose(
        float(m_on["loss"]) - float(m_off["loss"]),
        0.5 * float(m_on["loss_lpips"]), rtol=1e-5)
    diff = {k: float((on[k] - off[k]).abs().max()) for k in on}
    assert diff["transformer.0.attn.qkv.weight"] > 0
    assert diff["image_token_decoder.linear.weight"] > 0


@pytest.mark.parametrize("config,lam", [
    ("diffusionGS_rel.yaml", (150, 0.0, 0.5, 151)),
    ("diffusionGS_scene.yaml", 0.1)])
def test_configs_with_lpips_on_build_the_random_vgg(config, lam):
    tiny = ["system.shape_model.width=64", "system.shape_model.num_layers=1",
            "system.shape_model.dim_heads=32"]
    cfg = load_config(os.path.join(ROOT, "configs", config), cli_args=[
        "system.use_lpips=false", *tiny, "system.use_lpips=true",
        "system.allow_random_lpips=true"], makedirs=False)
    system = builder.build_system(cfg.system_type, cfg.system)
    assert system.cfg.lambda_lpips == lam
    assert system.cfg.allow_random_lpips is True
    assert system.lpips_params["pretrained"] is False
    # no waiver: the guard raises at the first loss
    cfg = load_config(os.path.join(ROOT, "configs", config), cli_args=tiny,
                      makedirs=False)
    system = builder.build_system(cfg.system_type, cfg.system)
    assert system.lpips_params is None
    with pytest.raises(RuntimeError, match="LPIPS"):
        system.train_loss({k: torch.from_numpy(x) for k, x in
                           _batch(np.random.default_rng(0)).items()}, 151)


def test_routed_lpips_gradient_is_unique_where_lpips_is_not():
    import chip_smoke
    p32 = losses.lpips_init_params(None)
    p64 = {k: ({n: t.double() for n, t in v.items()} if isinstance(v, dict)
               else v.double() if torch.is_tensor(v) else v)
           for k, v in p32.items()}
    yy, xx = np.mgrid[0:256, 0:256] / 256.0
    blob = np.exp(-((xx - 0.5) ** 2 + (yy - 0.5) ** 2) / 0.02)
    x = torch.from_numpy(np.broadcast_to(1.0 - 0.6 * blob, (1, 3, 256, 256))
                         .astype(np.float32) * 2.0 - 1.0)
    y = torch.from_numpy(np.random.default_rng(0).uniform(
        -1, 1, (1, 3, 256, 256)).astype(np.float32))

    def grad(params, xi, yi, routes=None, routed=True):
        xi = xi.clone().requires_grad_()
        if routed:
            value, routes = chip_smoke.lpips_routed(torch, params, xi, yi,
                                                    routes)
        else:
            value = losses.lpips(params, xi, yi)
        (g,) = torch.autograd.grad(value.sum(), xi)
        return value.detach(), g, routes

    v, g, routes = grad(p32, x, y)
    v_plain, g_plain, _ = grad(p32, x, y, routed=False)
    assert torch.equal(v, v_plain) and torch.equal(g, g_plain)
    _, g64_own, _ = grad(p64, x.double(), y.double(), routed=False)
    _, g64, _ = grad(p64, x.double(), y.double(), routes)

    def rel_max(a, b):
        return float((a.double() - b).abs().max() / b.abs().max())

    assert rel_max(g, g64_own) > 1e-3
    assert rel_max(g, g64) < 1e-5


# ---------------------------------------------------------------------------
# The weight converters
# ---------------------------------------------------------------------------

def _lpips_state_dicts(seed=0):
    """torchvision's VGG16 `features.*` and the lpips heads, full spec,
    in torch layout (some head weights negative: the clamp)."""
    rng = np.random.default_rng(seed)
    vgg, lin, cin = {}, {}, 3
    for si, idxs in enumerate(clp.STAGE_CONV_IDXS):
        cout = clp.VGG_STAGES[si][0]
        for i in idxs:
            vgg[f"features.{i}.weight"] = rng.normal(
                0, 0.05, (cout, cin, 3, 3)).astype(np.float32)
            vgg[f"features.{i}.bias"] = rng.normal(
                0, 0.05, (cout,)).astype(np.float32)
            cin = cout
        lin[f"lin{si}.model.1.weight"] = rng.normal(
            0.02, 0.05, (1, cout, 1, 1)).astype(np.float32)
    vgg["classifier.6.bias"] = np.zeros((1000,), np.float32)   # ignored
    return vgg, lin


def _save(sd, path):
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    return str(path)


@pytest.fixture(scope="module")
def lpips_files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("lpips")
    vgg, lin = _lpips_state_dicts()
    return (vgg, lin, _save(vgg, tmp / "vgg16.pth"),
            _save(lin, tmp / "vgg.pth"), tmp)


def test_lpips_converter_equals_root_tool(lpips_files):
    vgg, lin, vgg_path, lin_path, tmp = lpips_files
    out = str(tmp / "lpips_vgg.npz")
    clp.main(["--vgg16", vgg_path, "--lin", lin_path, "--out", out])
    want = root_lpips.convert_arrays(
        [[vgg[f"features.{i}.weight"] for i in idxs]
         for idxs in clp.STAGE_CONV_IDXS],
        [[vgg[f"features.{i}.bias"] for i in idxs]
         for idxs in clp.STAGE_CONV_IDXS],
        [lin[f"lin{si}.model.1.weight"] for si in range(5)])
    with np.load(out) as got:
        assert sorted(got.files) == sorted(want)
        for k, v in want.items():
            assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
            assert got[k].tobytes() == v.tobytes(), k
        assert min(float(got[f"lin/{si}/kernel"].min())
                   for si in range(5)) == 0.0
    params = losses.lpips_init_params(out)
    assert params["pretrained"] is True
    np.testing.assert_array_equal(
        params["vgg/2_1"]["kernel"].numpy(),
        vgg["features.12.weight"])                  # OIHW = torch layout
    x = torch.from_numpy(np.random.default_rng(2).uniform(
        -1, 1, (2, 3, 32, 32)).astype(np.float32))
    assert torch.isfinite(losses.lpips(params, x, x.flip(0))).all()


def test_lpips_converter_and_loader_raise_on_bad_keys(lpips_files):
    vgg, lin, _, lin_path, tmp = lpips_files
    missing = {k: v for k, v in vgg.items() if k != "features.14.bias"}
    with pytest.raises(KeyError, match="features.14.bias"):
        clp.convert_files(_save(missing, tmp / "missing.pth"), lin_path)
    bad = dict(vgg, **{"features.14.weight": vgg["features.14.weight"][:, :8]})
    with pytest.raises(ValueError, match="vgg/2_2/kernel"):
        clp.convert_files(_save(bad, tmp / "bad.pth"), lin_path)
    arrays = clp.convert_files(_save(vgg, tmp / "ok.pth"), lin_path)
    np.savez(tmp / "no_lin.npz", **{k: v for k, v in arrays.items()
                                    if k != "lin/4/kernel"})
    with pytest.raises(KeyError):
        losses.lpips_init_params(str(tmp / "no_lin.npz"))
    np.savez(tmp / "short.npz", **dict(
        arrays, **{"vgg/3_0/bias": arrays["vgg/3_0/bias"][:-1]}))
    with pytest.raises(ValueError, match="vgg/3_0/bias"):
        losses.lpips_init_params(str(tmp / "short.npz"))


def _u2net_state_dict(spec, values):
    """A torch-naming U²-Net state dict with the spec's keys, from
    `values(shape)` (the inverse of convert_state_dict's renames)."""
    inv = {v: k for k, v in cu2._BN_RENAME.items()}
    sd = {}
    for key, shape in u2net.param_shapes(spec).items():
        mod, field = key.rsplit(".", 1)
        if ".bn_s1" in key:
            sd[f"{mod}.{inv[field]}"] = values(shape)
            if field == "var":
                sd[f"{mod}.num_batches_tracked"] = np.asarray(7, np.int64)
        elif field == "kernel":
            kh, kw, cin, cout = shape
            sd[f"{mod}.weight"] = values((cout, cin, kh, kw))
        else:
            sd[key] = values(shape)
    return sd


def test_u2net_converter_equals_root_tool(tmp_path):
    rng = np.random.default_rng(3)
    sd = _u2net_state_dict(u2net.U2NETP, lambda s: rng.normal(
        0, 0.1, s).astype(np.float32))
    ckpt = str(tmp_path / "u2netp.pth")
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()},
               ckpt)
    out = str(tmp_path / "u2netp.npz")
    cu2.main(["--ckpt", ckpt, "--spec", "u2netp", "--out", out])
    want = root_u2net.convert_state_dict(sd)
    with np.load(out) as got:
        assert sorted(got.files) == sorted(want)
        for k, v in want.items():
            assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
            assert got[k].tobytes() == v.tobytes(), k
    params = u2net.load_params(out, u2net.U2NETP)
    assert set(params) == set(u2net.param_shapes(u2net.U2NETP))
    # the full spec, keys and shapes only: broadcast views, no storage
    zero = np.zeros((), np.float32)
    full = _u2net_state_dict(u2net.U2NET_FULL,
                             lambda s: np.broadcast_to(zero, s))
    got = cu2.convert_state_dict(full)
    cu2.check_layout(got, "u2net")
    want = root_u2net.convert_state_dict(full)
    assert {k: v.shape for k, v in got.items()} == \
        {k: v.shape for k, v in want.items()}
    with pytest.raises(ValueError, match="shape"):
        cu2.check_layout(got, "u2netp")         # same names, other widths


def test_u2net_converter_and_loader_raise_on_bad_keys(tmp_path):
    rng = np.random.default_rng(4)
    sd = _u2net_state_dict(u2net.U2NETP, lambda s: rng.normal(
        0, 0.1, s).astype(np.float32))
    key = "stage3.rebnconv2.conv_s1.weight"
    for name, bad in (("missing", {k: v for k, v in sd.items()
                                   if k != key}),
                      ("short", dict(sd, **{key: sd[key][:-1]}))):
        path = str(tmp_path / f"{name}.pth")
        torch.save({k: torch.from_numpy(np.asarray(v))
                    for k, v in bad.items()}, path)
        with pytest.raises(ValueError, match="stage3.rebnconv2.conv_s1"):
            cu2.convert_file(path, "u2netp")
    params = cu2.convert_state_dict(sd)
    kernel = "stage3.rebnconv2.conv_s1.kernel"
    np.savez(tmp_path / "missing.npz", **{k: v for k, v in params.items()
                                          if k != kernel})
    with pytest.raises(ValueError, match="missing"):
        u2net.load_params(str(tmp_path / "missing.npz"), u2net.U2NETP)
    np.savez(tmp_path / "short.npz",
             **dict(params, **{kernel: params[kernel][..., :-1]}))
    with pytest.raises(ValueError, match=kernel):
        u2net.load_params(str(tmp_path / "short.npz"), u2net.U2NETP)
