"""PyTorch port vs the JAX package: the object training step.

  * `ObjectSystem.train_loss` on the tiny system (width 64, 2 layers,
    32x32, 4 + 4 views, K = 4608 >= N) against the JAX `train_loss` with
    bridged params and the noise and t that JAX draws (computed here with
    JAX's own split and injected), at step 0 and step 151: loss and
    metrics within rtol 2e-4 / atol 2e-5, and every parameter's gradient
    against jax.grad mapped through the same bridge, rel-max <= 1e-3;
  * the optimizer against the optax chain of the JAX package
    (clip_by_global_norm + adamw + cosine + MultiSteps(2), per-prefix
    groups) on the same numpy gradients, params within atol 1e-7;
    `parse_schedule` against the JAX one for every leaf and composite;
  * the builder repairs: `use_checkpoint` drives block checkpointing
    (bit-identical CPU gradients on and off), `system.loss` / `use_lpips`
    / `lpips_weights` reach the config, `build_optimizer_config` equals the
    JAX one field for field;
  * the lambda gate, the EMA, the LPIPS guard and an overfit run, as
    tests/test_system_train.py and tests/test_overfit.py hold the JAX
    package.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from open_diffusiongs_tpu.parallel import train_step as jts
from open_diffusiongs_tpu.systems import builder as jbuilder
from open_diffusiongs_tpu.systems.object_system import \
    ObjectSystem as JaxSystem
from open_diffusiongs_tpu.systems.object_system import \
    ObjectSystemConfig as JaxSystemConfig
from open_diffusiongs_tpu.ops import rasterize as jrz
from open_diffusiongs_tpu_torch.models.denoiser import DGSDenoiser
from open_diffusiongs_tpu_torch.ops import rasterize as rz
from open_diffusiongs_tpu_torch.ops.gaussians import Gaussians
from open_diffusiongs_tpu_torch.parallel import train_step as tts
from open_diffusiongs_tpu_torch.pipeline import object_camera_template
from open_diffusiongs_tpu_torch.systems import builder
from open_diffusiongs_tpu_torch.systems.object_system import (
    ObjectSystem, ObjectSystemConfig)
from open_diffusiongs_tpu_torch.utils.config import load_config
from open_diffusiongs_tpu_torch.utils.convert import state_dict_from_flax
from utils3d import orbit_cameras, random_gaussians

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "configs", "diffusionGS_rel.yaml")
TINY = dict(width=64, num_layers=2, patch_size=8, dim_heads=32)
RES, V = 32, 4
RASTER = dict(max_tiles_per_gaussian=16, max_per_tile=4608)


def _batch(rng, b=1, res=RES, v=V):
    c2ws, fxy = object_camera_template(v, h=res, w=res)
    cams = dict(c2ws=np.broadcast_to(c2ws, (b, v, 4, 4)).copy(),
                fxfycxcys=np.broadcast_to(fxy, (b, v, 4)).copy())
    return {
        "rgbs_input": rng.uniform(size=(b, v, 3, res, res)).astype(np.float32),
        "c2ws_input": cams["c2ws"], "fxfycxcys_input": cams["fxfycxcys"],
        "depths_input": rng.uniform(2.0, 4.0, (b, v, 1, res, res))
        .astype(np.float32),
        "masks_input": np.ones((b, v, 1, res, res), np.float32),
        "rgbs": rng.uniform(size=(b, v, 3, res, res)).astype(np.float32),
        "masks": np.ones((b, v, 1, res, res), np.float32), **cams,
    }


def _torch_batch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(x))
            for k, x in batch.items()}


def _port_system(**kw):
    kw.setdefault("shape_model", TINY)
    kw.setdefault("raster", rz.RasterizeConfig(**RASTER))
    return ObjectSystem(ObjectSystemConfig(use_lpips=False, **kw))


@pytest.fixture(scope="module")
def bridged():
    """The JAX tiny system, its params, one batch, the jitted JAX
    value-and-grad of train_loss (step traced), and the port system holding
    the same weights."""
    jsys = JaxSystem(JaxSystemConfig(
        use_lpips=False, shape_model=dict(TINY, dtype=jnp.float32,
                                          remat=False),
        raster=jrz.RasterizeConfig(**RASTER)))
    params = jsys.init_params(jax.random.PRNGKey(0), RES, RES, v=V)
    batch = _batch(np.random.default_rng(1))
    jbatch = {k: jnp.asarray(x) for k, x in batch.items()}
    rng = jax.random.PRNGKey(3)
    loss_and_grad = jax.jit(jax.value_and_grad(
        lambda p, step: jsys.train_loss(p, jbatch, rng, step),
        has_aux=True))
    system = _port_system()
    system.model.load_state_dict(state_dict_from_flax(
        jax.device_get(params)), strict=True)
    return params, batch, rng, loss_and_grad, system


@pytest.mark.parametrize("step", [0, 151])
def test_train_loss_and_grads_match_jax(bridged, step):
    params, batch, rng, loss_and_grad, system = bridged
    # the draws of JAX train_loss (object_system.py:168-170)
    rng_noise, rng_t = jax.random.split(rng)
    noise = np.array(jax.random.normal(rng_noise, batch["rgbs_input"].shape,
                                       jnp.float32))
    t = np.array(jax.random.randint(rng_t, (1,), 0, 1000))
    (jloss, jmetrics), jgrads = loss_and_grad(params, jnp.int32(step))
    system.model.zero_grad()
    loss, metrics = system.train_loss(
        _torch_batch(batch), step, noise=torch.from_numpy(noise),
        t=torch.from_numpy(t).long())
    loss.backward()
    assert int(metrics["overflow_gaussians"]) == 0
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=2e-4,
                               atol=2e-5)
    for name, ref in jmetrics.items():
        np.testing.assert_allclose(float(metrics[name]), float(ref),
                                   rtol=2e-4, atol=2e-5, err_msg=name)
    if step == 0:     # only the points-distance term is weighted
        np.testing.assert_allclose(float(loss.detach()),
                                   float(metrics["loss_pointsdist"]),
                                   rtol=1e-5)
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


def _opt_cfg(**kw):
    base = dict(lr=1e-2, betas=(0.9, 0.99), eps=1e-8, weight_decay=0.01,
                grad_clip=0.5, scheduler="CosineAnnealingLR", t_max=4,
                eta_min=1e-3, accumulate_grad_batches=2,
                params={"head": {"lr": 3e-3, "weight_decay": 0.1}})
    base.update(kw)
    return base


@pytest.mark.parametrize("accumulate", [2, 1])
@pytest.mark.parametrize("name", ["AdamW", "Adam", "SGD"])
def test_optimizer_matches_optax_chain(name, accumulate):
    """With accumulate = 1 the step is handed the global norm, as
    make_train_step hands it, and clips with it."""
    rng = np.random.default_rng(0)
    shapes = {"body/w": (4, 3), "body/b": (3,), "head/w": (3, 2)}
    # weights at init scale; XLA compiles MultiSteps' branch (lax.cond) and
    # sums the global norm in its own order, so agreement is to the last
    # f32 ulp of the params, not bitwise
    init = {k: rng.normal(0, 0.1, size=s).astype(np.float32)
            for k, s in shapes.items()}
    grads = [{k: (rng.normal(size=s) * (0.1 if i % 3 else 2.0))
              .astype(np.float32) for k, s in shapes.items()}
             for i in range(5)]
    cfg = _opt_cfg(name=name, accumulate_grad_batches=accumulate)
    tx = jts.make_optimizer(jts.OptimizerConfig(**cfg))
    jparams = {"body": {"w": jnp.asarray(init["body/w"]),
                        "b": jnp.asarray(init["body/b"])},
               "head": {"w": jnp.asarray(init["head/w"])}}
    jstate = tx.init(jparams)
    tparams = {k.replace("/", "."): torch.nn.Parameter(torch.from_numpy(
        v.copy())) for k, v in init.items()}
    opt = tts.make_optimizer(tts.OptimizerConfig(**cfg), tparams.items())
    for g in grads:
        jg = {"body": {"w": jnp.asarray(g["body/w"]),
                       "b": jnp.asarray(g["body/b"])},
              "head": {"w": jnp.asarray(g["head/w"])}}
        upd, jstate = tx.update(jg, jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        for k, p in tparams.items():
            p.grad = torch.from_numpy(g[k.replace(".", "/")])
        opt.step(tts.global_norm([p.grad for p in tparams.values()])
                 if accumulate == 1 else None)
        for k, p in tparams.items():
            a, b = k.split(".")
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(jparams[a][b]), atol=1e-7,
                                       rtol=0, err_msg=k)
    assert (opt.count, opt.mini_step) == ((2, 1) if accumulate == 2
                                          else (5, 0))


@pytest.mark.parametrize("spec", [
    "constant", "CosineAnnealingLR",
    {"name": "CosineAnnealingLR", "args": {"T_max": 7, "eta_min": 1e-4}},
    {"name": "LinearLR", "args": {"start_factor": 0.1, "total_iters": 4}},
    {"name": "ConstantLR", "args": {"factor": 0.5, "total_iters": 3}},
    {"name": "ExponentialLR", "args": {"gamma": 0.9}},
    {"name": "StepLR", "args": {"step_size": 3, "gamma": 0.5}},
    {"name": "MultiStepLR", "args": {"milestones": [2, 5], "gamma": 0.3}},
    {"name": "SequentialLR", "milestones": [3],
     "schedulers": [{"name": "LinearLR", "args": {"start_factor": 0.2,
                                                  "total_iters": 3}},
                    {"name": "CosineAnnealingLR", "args": {"T_max": 6}}]},
    {"name": "ChainedScheduler",
     "schedulers": [{"name": "ConstantLR", "args": {"factor": 0.5,
                                                    "total_iters": 2}},
                    {"name": "ExponentialLR", "args": {"gamma": 0.8}}]},
])
def test_parse_schedule_matches_jax(spec):
    ours = tts.parse_schedule(spec, 1e-3, t_max=10, eta_min=1e-5)
    ref = jts.parse_schedule(spec, 1e-3, t_max=10, eta_min=1e-5)
    for step in range(12):
        np.testing.assert_allclose(ours(step), float(ref(step)), rtol=1e-6,
                                   err_msg=f"step {step}")


@pytest.mark.parametrize("spec", [0.25, 3, [150, 0.0, 1.0, 151],
                                  [150, 1.0, 0.0, 151], [0.5, 1.5, 10],
                                  [2, 0.1, 0.9, 2]])
def test_loss_lambda_schedule_matches_jax(spec):
    from open_diffusiongs_tpu.utils.config import C_max as jax_c_max
    from open_diffusiongs_tpu.utils.schedules import C as jax_c
    from open_diffusiongs_tpu_torch.utils.schedules import C, C_max
    for step in (0, 1, 5, 149, 150, 151, 152, 1000):
        np.testing.assert_allclose(C(spec, step), float(jax_c(spec, step)),
                                   rtol=1e-6, err_msg=f"step {step}")
    assert C_max(spec) == jax_c_max(spec)


def test_build_optimizer_config_matches_jax():
    cfg = load_config(CONFIG, makedirs=False)
    ours = builder.build_optimizer_config(cfg.system, cfg.trainer)
    ref = jbuilder.build_optimizer_config(cfg.system, cfg.trainer)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert ours.grad_clip == 0.5 and ours.weight_decay == 0.01


def test_builder_reads_loss_lpips_and_checkpoint_keys():
    cfg = load_config(CONFIG, makedirs=False)
    system_cfg = dict(cfg.system, use_lpips=False,
                      lpips_weights="lpips.npz")
    system_cfg["shape_model"] = dict(system_cfg["shape_model"], **TINY)
    system = builder.build_system(cfg.system_type, system_cfg)
    loss = cfg.system["loss"]
    for lam in builder.LOSS_LAMBDAS:
        v = loss[lam]
        assert getattr(system.cfg, lam) == (tuple(v) if isinstance(v, list)
                                            else v), lam
    assert system.cfg.use_lpips is False
    assert system.cfg.lpips_weights == "lpips.npz"
    assert system.model.transformer.checkpoint is True   # use_checkpoint
    assert "use_checkpoint" not in builder.TPU_ONLY_SHAPE_KEYS


def test_block_checkpointing_gives_bit_identical_grads():
    rng = np.random.default_rng(2)
    images = torch.from_numpy(rng.uniform(size=(1, 2, 3, 16, 16))
                              .astype(np.float32))
    rays = torch.from_numpy(rng.normal(size=(2, 1, 2, 3, 16, 16))
                            .astype(np.float32))
    t = torch.tensor([10])
    grads = []
    for ckpt in (False, True):
        model = DGSDenoiser(**TINY, checkpoint=ckpt)
        model.init_weights(torch.Generator().manual_seed(0))
        g, xyz = model(images, rays[0], rays[1], t)
        loss = sum(x.square().mean() for x in g) + xyz.square().mean()
        grads.append({k: p for k, p in zip(
            dict(model.named_parameters()),
            torch.autograd.grad(loss, list(model.parameters())))})
    for k in grads[0]:
        assert torch.equal(grads[0][k], grads[1][k]), k


def test_lpips_guard_raises_without_weights():
    system = ObjectSystem(ObjectSystemConfig(
        shape_model=TINY, raster=rz.RasterizeConfig(**RASTER)))
    batch = _torch_batch(_batch(np.random.default_rng(0), res=16, v=2))
    with pytest.raises(RuntimeError, match="LPIPS"):
        system.train_loss(batch, 0)


def test_train_step_updates_params_and_ema():
    system = _port_system(raster=rz.RasterizeConfig(16, 576, 32))
    system.init_params(torch.Generator().manual_seed(0))
    params = dict(system.model.named_parameters())
    old = {k: p.detach().clone() for k, p in params.items()}
    opt = tts.make_optimizer(tts.OptimizerConfig(lr=1e-3, t_max=1000),
                             params.items())
    state = tts.init_train_state(params, opt, ema_decay=0.9)
    gen = torch.Generator().manual_seed(2)
    step = tts.make_train_step(
        lambda b, s: system.train_loss(b, s, generator=gen), opt,
        ema_decay=0.9)
    batch = _torch_batch(_batch(np.random.default_rng(0), b=2, res=16, v=2))
    state, metrics = step(state, batch)
    assert state.step == 1
    assert max(float((params[k].detach() - old[k]).abs().max())
               for k in old) > 0
    for k in old:
        np.testing.assert_allclose(state.ema_params[k].numpy(),
                                   (old[k] * 0.9 + params[k].detach() * 0.1)
                                   .numpy(), atol=1e-6, err_msg=k)
    assert np.isfinite(float(metrics["grad_norm"]))
    assert float(metrics["grad_norm"]) > 0


def test_overfit_one_batch():
    """A tiny denoiser + rasterizer fits one fixed batch (fixed noise and
    t): the rendering loss must halve, so gradients flow through DiT ->
    Gaussians -> blend backward."""
    h = w = 16
    rng = np.random.default_rng(0)
    g = random_gaussians(rng, 1, 200, scale_mean=-2.5)
    c2ws, fxy = orbit_cameras(2, h=h, w=w)
    c2w, fxy_t = torch.from_numpy(c2ws)[None], torch.from_numpy(fxy)[None]
    cfg_r = rz.RasterizeConfig(16, 576, 32)
    with torch.no_grad():
        target = rz.render(Gaussians(*(torch.from_numpy(np.array(x))
                                       for x in g)),
                           c2w, fxy_t, h, w, cfg=cfg_r)["render"]
    system = _port_system(
        lambda_diffusion=1.0, lambda_lpips=0.0, lambda_ssim=0.0,
        lambda_pointsdist=0.0, lambda_xyz=0.0, raster=cfg_r)
    system.init_params(torch.Generator().manual_seed(0))
    params = dict(system.model.named_parameters())
    opt = tts.make_optimizer(tts.OptimizerConfig(
        lr=3e-3, grad_clip=1.0, scheduler="constant"), params.items())
    state = tts.init_train_state(params, opt, ema_decay=None)
    noise = torch.from_numpy(rng.normal(size=(1, 2, 3, h, w))
                             .astype(np.float32))
    t = torch.tensor([500])
    step = tts.make_train_step(
        lambda b, s: system.train_loss(b, s, noise=noise, t=t), opt,
        ema_decay=None)
    batch = {"rgbs_input": target, "c2ws_input": c2w,
             "fxfycxcys_input": fxy_t,
             "depths_input": torch.full((1, 2, 1, h, w), 3.0),
             "masks_input": torch.ones((1, 2, 1, h, w)),
             "rgbs": target, "c2ws": c2w, "fxfycxcys": fxy_t}
    losses = []
    for _ in range(40):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss_diffusion"]))
    assert np.isfinite(losses).all()
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    assert last < first * 0.5, (first, last)


def test_ten_train_steps_match_jax_train_step():
    """Ten steps of the recipe's optimizer (configs/diffusionGS_rel.yaml at
    the convergence protocol's lr 5e-5: AdamW, cosine, clip 0.5) from
    bridged params at TINY width (16², 2 + 2 views), steps 146-155 (across
    the loss weights' switch at 150), a new batch each step, JAX's noise
    and t fed through `train_loss`'s hooks, against JAX's `train_step`:
    every step's loss within rtol 2e-4 / atol 2e-5; each parameter's move
    over the ten steps within 1e-3 of JAX's in L2 norm, and the EMA's move
    within 1e-3 plus the f32 rounding of ten EMA updates.  The EMA decays
    at 0.9, not the recipe's 0.9999: there its ten moves are 1e-4 of the
    params', at the f32 ulp of the EMA itself, where no comparison sees
    them.  Not elementwise: Adam's first steps move every element by about
    lr whatever its gradient's size, so an element whose gradient sits at
    the f32 noise of the rest (the single step's gradients agree to
    rel-max 1e-3, test above) moves by +-lr on that noise in either
    package."""
    cfg = load_config(CONFIG, cli_args=["system.optimizer.args.lr=5.e-5"],
                      makedirs=False)
    ocfg = builder.build_optimizer_config(cfg.system, cfg.trainer)
    assert ocfg.lr == 5e-5 and ocfg.grad_clip == 0.5
    start, n, ema, res, v = 146, 10, 0.9, 16, 2
    jsys = JaxSystem(JaxSystemConfig(
        use_lpips=False, shape_model=dict(TINY, dtype=jnp.float32,
                                          remat=False),
        raster=jrz.RasterizeConfig(**RASTER)))
    params = jsys.init_params(jax.random.PRNGKey(0), res, res, v=v)
    tx = jts.make_optimizer(jbuilder.build_optimizer_config(cfg.system,
                                                            cfg.trainer))
    jstate = jts.init_train_state(params, tx, ema_decay=ema)._replace(
        step=jnp.int32(start))
    jstep = jts.make_train_step(jsys.train_loss, tx, ema_decay=ema,
                                donate=False)
    system = _port_system()
    system.model.load_state_dict(state_dict_from_flax(
        jax.device_get(params)), strict=True)
    named = dict(system.model.named_parameters())
    start_params = {k: p.detach().clone() for k, p in named.items()}
    opt = tts.make_optimizer(ocfg, named.items())
    state = tts.init_train_state(named, opt, ema_decay=ema)
    state.step = start
    rng = jax.random.PRNGKey(3)
    draws = {}
    pstep = tts.make_train_step(lambda batch, step: system.train_loss(
        batch, step, noise=draws[step][0], t=draws[step][1]), opt,
        ema_decay=ema)
    data = np.random.default_rng(7)
    for i in range(n):
        batch = _batch(data, res=res, v=v)
        # train_step folds the step into the key, train_loss splits it
        # (object_system.py:168-170)
        rng_noise, rng_t = jax.random.split(jax.random.fold_in(
            rng, start + i))
        draws[start + i] = (
            torch.from_numpy(np.array(jax.random.normal(
                rng_noise, batch["rgbs_input"].shape, jnp.float32))),
            torch.from_numpy(np.array(jax.random.randint(
                rng_t, (1,), 0, 1000))).long())
        jstate, jmetrics = jstep(jstate, {k: jnp.asarray(x)
                                          for k, x in batch.items()}, rng)
        state, metrics = pstep(state, _torch_batch(batch))
        np.testing.assert_allclose(float(metrics["loss"]),
                                   float(jmetrics["loss"]), rtol=2e-4,
                                   atol=2e-5, err_msg=f"step {start + i}")
    assert state.step == int(jstate.step) == start + n
    want = state_dict_from_flax(jax.device_get(jstate.params))
    want_ema = state_dict_from_flax(jax.device_get(jstate.ema_params))
    assert set(want) == set(state.params) == set(state.ema_params)
    eps = torch.finfo(torch.float32).eps
    for k, ref in want.items():
        moved = state.params[k].detach() - start_params[k]
        ref_moved = ref - start_params[k]
        err = float((moved - ref_moved).norm() / ref_moved.norm())
        assert err <= 1e-3, f"{k}: moves {err:.3g} apart in L2"
        # the EMA's moves: 1e-3 in L2, plus each package's rounding of
        # the EMA (half an ulp an element a step) over the n steps
        ema_moved = state.ema_params[k] - start_params[k]
        ref_ema_moved = want_ema[k] - start_params[k]
        assert float(ref_ema_moved.norm()) > 0, k
        err = float((ema_moved - ref_ema_moved).norm())
        bar = (1e-3 * float(ref_ema_moved.norm())
               + n * eps * float(want_ema[k].norm()))
        assert err <= bar, f"ema {k}: moves {err:.3g} apart, bar {bar:.3g}"
