"""The port's scene system (RE10K) against the JAX package's, and its
evaluation CLIs on the CPU.

  * `SceneSystem.train_loss` on the tiny scene system (width 64, 2 layers,
    `plk` PE, [0, 500] depth head, 16², K = 1056 >= N = 1026) against JAX
    `SceneSystem.train_loss` with bridged params and the noise and t that
    JAX draws: loss and metrics within rtol 2e-4 / atol 2e-5, every
    parameter's gradient within rel-max 1e-3 (tests/test_torch_train.py's
    bars);
  * a 2-step 16² `sample` (K = 1056 >= N = 1026) with its trajectory
    against the JAX sampler on the same weights and numpy noise: renders,
    sample, trajectory atol 2e-5; Gaussians rtol 2e-4 / atol 2e-5;
  * the slerp path video's frames against the JAX render (atol 2e-5);
  * the builder's scene branch against JAX builder.py's;
  * `eval_scene_result` on npz (and `.pt`) dumps: PSNR / SSIM against JAX
    systems/losses.py's compute_metrics at 1e-5, both protocols;
  * `launch` on a synthetic RE10K tree: train 2 steps with
    use_lpips false, then --validate writes the npz dumps, grids,
    trajectory videos, PLY + path videos and val_metrics.json, which the
    metric CLI scores; the metric CLI raises without a card.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_diffusiongs_tpu.diffusion import p_sample_loop as jax_loop
from open_diffusiongs_tpu.ops import rasterize as jrz
from open_diffusiongs_tpu.ops.gaussians import Gaussians as JaxGaussians
from open_diffusiongs_tpu.systems import builder as jbuilder
from open_diffusiongs_tpu.systems import losses as jlosses
from open_diffusiongs_tpu.systems.scene_system import \
    SceneSystem as JaxSceneSystem
from open_diffusiongs_tpu.systems.scene_system import \
    SceneSystemConfig as JaxSceneConfig
from open_diffusiongs_tpu.utils.pose_interp import \
    get_interpolated_poses_many as jax_path
from open_diffusiongs_tpu_torch import eval_scene_result, launch
from open_diffusiongs_tpu_torch.data.loader import collate
from open_diffusiongs_tpu_torch.data.re10k import RE10KDataset
from open_diffusiongs_tpu_torch.ops import rasterize as rz
from open_diffusiongs_tpu_torch.ops.gaussians import NumpyGaussians
from open_diffusiongs_tpu_torch.pipeline import object_camera_template
from open_diffusiongs_tpu_torch.systems import builder, eval_utils
from open_diffusiongs_tpu_torch.systems.scene_system import (
    SceneSystem, SceneSystemConfig)
from open_diffusiongs_tpu_torch.utils.checkpoint import load_module_weights
from open_diffusiongs_tpu_torch.utils.convert import state_dict_from_flax
from open_diffusiongs_tpu_torch.utils.config import load_config
from synthetic_fixtures import make_re10k_tree
from utils3d import random_gaussians

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(width=64, num_layers=2, patch_size=8, dim_heads=32,
            ray_pe_type="plk", range_setting_near=0.0,
            range_setting_far=500.0)
LAMBDAS = dict(lambda_diffusion=1.0, lambda_lpips=0.0, lambda_ssim=0.1,
               lambda_pointsdist=0.1, lambda_xyz=0.0)


@pytest.fixture(scope="module", autouse=True)
def no_tensorboard():
    """Where TensorFlow is installed, TensorBoard's writer imports it
    (~18 s); tests/test_torch_launch.py tests the loggers."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(launch, "_loggers", lambda cfg: (None, None))
        yield


def _scene_batch(full_list, res, sel_views, sel_views_train, n=1):
    ds = RE10KDataset(dict(local_dir=full_list, training_res=[res, res],
                           sel_views=sel_views,
                           sel_views_train=sel_views_train), seed=0)
    return {k: v for k, v in collate([ds[i] for i in range(n)]).items()
            if isinstance(v, np.ndarray) and k != "image_indices"}


@pytest.fixture(scope="module")
def re10k(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("re10k")
    return tmp, str(make_re10k_tree(tmp, np.random.default_rng(0),
                                    n_scenes=2, n_frames=8, res=(36, 64)))


def _bridged(res, v, k, **cfg):
    jsys = JaxSceneSystem(JaxSceneConfig(
        use_lpips=False, shape_model=dict(TINY, dtype=jnp.float32,
                                          remat=False),
        raster=jrz.RasterizeConfig(max_tiles_per_gaussian=16,
                                   max_per_tile=k), **cfg))
    params = jsys.init_params(jax.random.PRNGKey(0), res, res, v=v)
    system = SceneSystem(SceneSystemConfig(
        use_lpips=False, shape_model=TINY,
        raster=rz.RasterizeConfig(max_tiles_per_gaussian=16, max_per_tile=k),
        **cfg))
    # the plk variant's free-Gaussian embedding is [1, n, w] in the port
    load_module_weights(system.model, state_dict_from_flax(
        jax.device_get(params)), strict=True)
    return jsys, params, system


def test_scene_train_loss_and_grads_match_jax(re10k):
    _, full_list = re10k
    batch = _scene_batch(full_list, 16, sel_views=3, sel_views_train=1)
    assert "depths_input" not in batch
    jsys, params, system = _bridged(16, 4, 1056, **LAMBDAS)
    jbatch = {k: jnp.asarray(x) for k, x in batch.items()}
    rng = jax.random.PRNGKey(3)
    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jsys.train_loss(p, jbatch, rng, jnp.int32(0)),
        has_aux=True))(params)
    rng_noise, rng_t = jax.random.split(rng)
    noise = np.array(jax.random.normal(rng_noise, batch["rgbs_input"].shape,
                                       jnp.float32))
    t = np.array(jax.random.randint(rng_t, (1,), 0, 1000))
    loss, metrics = system.train_loss(
        {k: torch.from_numpy(x) for k, x in batch.items()}, 0,
        noise=torch.from_numpy(noise), t=torch.from_numpy(t).long())
    loss.backward()
    assert int(metrics["overflow_gaussians"]) == 0
    assert float(metrics["loss_xyz"]) == 0.0      # no depth ground truth
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=2e-4,
                               atol=2e-5)
    for name, ref in jmetrics.items():
        np.testing.assert_allclose(float(metrics[name]), float(ref),
                                   rtol=2e-4, atol=2e-5, err_msg=name)
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


def test_scene_sample_matches_jax_sampler(re10k):
    _, full_list = re10k
    res, views, steps = 16, 4, 2
    batch = _scene_batch(full_list, res, sel_views=3, sel_views_train=1)
    jsys, params, system = _bridged(res, views, 1056, num_inference_steps=2,
                                    num_train_timesteps=50)
    rng = np.random.default_rng(1)
    cond = batch["rgbs_input"][:, :1]
    c2w, fxy = batch["c2ws_input"], batch["fxfycxcys_input"]
    x_T = rng.normal(size=(1, views - 1, 3, res, res)).astype(np.float32)
    noise = rng.normal(size=(steps, 1, views - 1, 3, res, res)
                       ).astype(np.float32)
    got = system.sample(torch.from_numpy(cond), torch.from_numpy(c2w),
                        torch.from_numpy(fxy), noise=torch.from_numpy(x_T),
                        noise_fn=lambda t: torch.from_numpy(noise[t]),
                        return_trajectory=True)
    jnoise = jnp.asarray(noise)
    ref = jax_loop(jsys.sched_infer,
                   jsys.make_model_fn(params, c2w, fxy, res, res,
                                      skip_cond_render=1),
                   cond, x_T, jax.random.PRNGKey(1), clip_denoised=False,
                   return_trajectory=True,
                   final_model_fn=jsys.make_model_fn(params, c2w, fxy, res,
                                                     res),
                   noise_fn=lambda t: jnoise[t])
    ref_g, ref_alpha = ref["aux"]
    assert int(got["overflow_gaussians"]) == 0
    for name, value in (("renders", ref["renders"]), ("sample", ref["sample"]),
                        ("alpha", ref_alpha)):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(value),
                                   atol=2e-5, err_msg=name)
    for mine, theirs in zip(got["trajectory"], ref["trajectory"]):
        assert mine.shape == (steps - 1, 1, views - 1, 3, res, res)
        np.testing.assert_allclose(mine.numpy(), np.asarray(theirs),
                                   atol=2e-5)
    for name in ("xyz", "features", "scaling", "rotation", "opacity"):
        np.testing.assert_allclose(getattr(got["gaussians"], name).numpy(),
                                   np.asarray(getattr(ref_g, name)),
                                   rtol=2e-4, atol=2e-5, err_msg=name)


def test_path_video_frames_match_jax_render(rng):
    res = 32
    g = NumpyGaussians(*(np.asarray(x[0]) for x in random_gaussians(
        rng, 1, 300)))
    c2ws, fxy = (x[None] for x in object_camera_template(2, h=res, w=res))
    cfg = dict(max_tiles_per_gaussian=16, max_per_tile=512)
    got = eval_utils.path_video_frames(g, c2ws[0], fxy[0], res, res,
                                       steps_per_transition=3,
                                       raster_cfg=rz.RasterizeConfig(**cfg))
    path = jax_path(c2ws[0], 3)
    jfxy = np.tile(fxy[0][:1], (len(path), 1))
    want = jrz.render(JaxGaussians(*(jnp.asarray(x)[None] for x in g)),
                      jnp.asarray(path)[None], jnp.asarray(jfxy)[None],
                      res, res, cfg=jrz.RasterizeConfig(**cfg),
                      channels_first=False)["render"][0]
    assert got.shape == (4, res, res, 3)
    np.testing.assert_allclose(got, np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("config", ["diffusionGS_scene.yaml",
                                    "diffusionGS_scene_eval.yaml",
                                    "diffusionGS_scene_eval_512.yaml"])
def test_builder_scene_branch_matches_jax(config):
    cfg = load_config(os.path.join(ROOT, "configs", config), makedirs=False)
    system = builder.build_system(cfg.system_type, cfg.system,
                                  device="meta")
    jsys = jbuilder.build_system(cfg.system_type, cfg.system)
    assert isinstance(system, SceneSystem)
    assert system.cfg.shape_model["ray_pe_type"] == "plk"
    assert system.model.ray_pe_type == "plk"
    for k in ("save_intermediate_video", "save_result_for_eval",
              "num_inference_steps", "lambda_lpips", "lambda_diffusion"):
        assert getattr(system.cfg, k) == getattr(jsys.cfg, k), k
    # without the key the scene DiT still takes the plk PE
    sc = dict(cfg.system, shape_model={
        k: v for k, v in cfg.system["shape_model"].items()
        if k != "ray_pe_type"})
    assert builder.build_system(cfg.system_type, sc, device="meta"
                                ).model.ray_pe_type == "plk"


def _dumps(d, rng, n=3, v=4, res=24):
    """n npz dumps of the scene system's layout; returns the arrays."""
    os.makedirs(d, exist_ok=True)
    out = []
    for i in range(n):
        r = rng.uniform(-0.1, 1.1, size=(v, 3, res, res)).astype(np.float32)
        g = rng.uniform(size=(v, 3, res, res)).astype(np.float32)
        np.savez_compressed(os.path.join(d, f"s{i}.npz"), render_images=r,
                            image=g)
        out.append((r, g))
    return out


@pytest.mark.parametrize("protocol", ["reference", "strict"])
def test_eval_scene_result_matches_jax_metrics(tmp_path, rng, protocol):
    d = str(tmp_path / "res")
    dumps = _dumps(d, rng)
    got = eval_scene_result.main(["--result_dir", d, "--protocol", protocol,
                                  "--chunk", "5", "--device", "cpu"])
    lo = 0 if protocol == "reference" else 1
    preds = np.concatenate([r[lo:] for r, _ in dumps])
    gts = np.concatenate([g[lo:] for _, g in dumps])
    m = jlosses.compute_metrics(jnp.asarray(gts), jnp.asarray(preds), None)
    assert got["num_scenes"] == 3 and got["num_views"] == len(preds)
    np.testing.assert_allclose(got["psnr"], float(np.mean(m["psnr"])),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got["ssim"], float(np.mean(m["ssim"])),
                               rtol=1e-5, atol=1e-5)
    assert json.load(open(os.path.join(d, "eval_result.json"))) == got


def test_eval_scene_result_reads_reference_pt_dumps(tmp_path, rng):
    a, b = str(tmp_path / "npz"), str(tmp_path / "pt")
    dumps = _dumps(a, rng, n=2)
    os.makedirs(b)
    for i, (r, g) in enumerate(dumps):
        torch.save({"render_images": torch.from_numpy(r),
                    "image": torch.from_numpy(g)},
                   os.path.join(b, f"s{i}.pt"))
    want = eval_scene_result.main(["--result_dir", a, "--device", "cpu"])
    assert eval_scene_result.main(["--result_dir", b, "--device", "cpu"]
                                  ) == want


def test_eval_scene_result_raises_without_a_card(tmp_path, rng,
                                                 monkeypatch):
    d = str(tmp_path / "res")
    _dumps(d, rng, n=1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        eval_scene_result.main(["--result_dir", d])


SCENE_CFG = """
exp_root_dir: "{out}"
name: "tiny_scene"
tag: "t"
use_timestamp: false
seed: 0
data_type: "Re10k-datamodule"
data:
  local_dir: "{full_list}"
  local_eval_dir: "{full_list}"
  view_idx_file_path: ""
  sel_views: 2
  sel_views_train: 1
  training_res: [16, 16]
  batch_size: 1
  eval_batch_size: 2
  num_workers: 1
system_type: "diffusion-gs-scene-system"
system:
  num_inference_steps: 2
  use_lpips: false
  save_intermediate_video: true
  save_result_for_eval: true
  shape_model_type: "diffusion-gs-model-scene"
  shape_model:
    width: 64
    in_channels: 9
    patch_size: 8
    n_gaussians: 2
    dim_heads: 32
    num_layers: 2
    ray_pe_type: 'plk'
    range_setting_near: 0
    range_setting_far: 500
  noise_scheduler:
    num_train_timesteps: 50
  raster:
    max_tiles_per_gaussian: 16
    max_per_tile: 800
    blend_chunk: 32
  loss:
    lambda_diffusion: 1.0
    lambda_lpips: 0.0
    lambda_ssim: 0.0
    lambda_pointsdist: 0.0
    lambda_xyz: 0.0
  optimizer:
    name: AdamW
    args: {{lr: 1.e-4}}
trainer:
  log_every_n_steps: 1
  precision: fp32
checkpoint:
  every_n_train_steps: 100
"""


def test_launch_scene_train_validate_and_score(re10k):
    tmp, full_list = re10k
    cfg = tmp / "scene.yaml"
    cfg.write_text(SCENE_CFG.format(out=tmp / "outputs",
                                    full_list=full_list))
    trained = launch.main(["--config", str(cfg), "--train", "--max_steps",
                           "2", "--device", "cpu"])
    assert trained["state"].step == 2
    trial = trained["trial_dir"]
    out = launch.main(["--config", str(cfg), "--validate", "--device", "cpu",
                       f"resume={trial}/ckpts"])
    save_dir = os.path.join(trial, "save", "it2")
    assert out["out_dir"] == save_dir and out["scenes"] == 2
    files = set(os.listdir(save_dir))
    for s in ("scene0", "scene1"):
        assert {f"{s}.png", f"{s}.npz", f"{s}_traj_xt.avi",
                f"{s}_traj_xstart.avi", f"{s}.ply", f"{s}_path.avi"} <= files
    with np.load(os.path.join(save_dir, "scene0.npz")) as d:
        assert d["render_images"].shape == (3, 3, 16, 16)
        assert d["image"].shape == (3, 3, 16, 16)
    val = json.load(open(os.path.join(save_dir, "val_metrics.json")))
    assert val["num_views"] == 4 and np.isfinite(val["psnr"])
    result = eval_scene_result.main(["--result_dir", save_dir,
                                     "--device", "cpu"])
    assert result["num_scenes"] == 2 and result["num_views"] == 6
    assert np.isfinite(result["psnr"]) and np.isfinite(result["ssim"])
