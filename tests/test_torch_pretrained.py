"""Serving from a checkpoint: reference weights -> make_pretrained_dir ->
DiffusionGSPipeline.from_pretrained -> a sample, against the JAX sampler
fed the same weights through tools/convert_reference_ckpt.py.

Bar: the whole-slice bar of test_torch_sampling.py::
test_object_slice_matches_jax_sampler (renders, sample and alpha atol
2e-5; Gaussians rtol 2e-4, atol 2e-5), with K = 1056 >= N = 514 so no
near-tie depth rank crosses the nearest-K cut.  Noise is injected with
numpy on both sides.
"""

import os
import sys

import jax
import numpy as np
import pytest
import torch

from open_diffusiongs_tpu.diffusion import p_sample_loop as jax_loop
from open_diffusiongs_tpu.systems.builder import \
    build_system as jax_build_system
from open_diffusiongs_tpu.utils.config import load_config as jax_load_config
from open_diffusiongs_tpu_torch import run
from open_diffusiongs_tpu_torch.pipeline import (DiffusionGSPipeline,
                                                 object_camera_template)
from open_diffusiongs_tpu_torch.tools.make_pretrained_dir import (
    main as make_pretrained_main)
from torch_reference_weights import reference_state_dict, save_lightning_ckpt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
from convert_reference_ckpt import (convert_state_dict,  # noqa: E402
                                    load_converted_params)

IMAGE = os.path.join(ROOT, "extra_files", "test_cases", "sphere.png")
RES, VIEWS, STEPS = 16, 2, 2
CFG = """
exp_root_dir: "{out}"
name: "pre"
tag: "t"
use_timestamp: false
data:
  training_res: [16, 16]
  gen_views: 2
system_type: "diffusion-gs-system"
system:
  num_inference_steps: 2
  use_lpips: false
  shape_model_type: "diffusion-gs-model"
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
  optimizer:
    name: AdamW
    args:
      lr: 1.e-5
trainer:
  gradient_clip_val: 0.5
"""


@pytest.fixture(scope="module")
def pretrained(tmp_path_factory):
    """(reference state dict, config path, pretrained dir made from a
    Lightning-style .ckpt on the CPU)."""
    tmp = tmp_path_factory.mktemp("pretrained")
    sd = reference_state_dict(np.random.default_rng(0))
    config = tmp / "config.yaml"
    config.write_text(CFG.format(out=tmp / "outputs"))
    ckpt = save_lightning_ckpt(sd, tmp / "model.ckpt")
    out = str(tmp / "dir")
    make_pretrained_main(["--config", str(config), "--weights", ckpt,
                          "--out", out, "--device", "cpu"])
    return sd, str(config), out


def _assert_weights(model, sd):
    state = model.state_dict()
    assert set(state) == set(sd)
    for name, value in state.items():
        assert torch.equal(value, torch.from_numpy(sd[name])), name


def test_from_pretrained_sample_matches_jax_sampler(pretrained, tmp_path):
    sd, config, out = pretrained
    assert sorted(os.listdir(out)) == ["ckpts", "config.yaml"]
    pipe = DiffusionGSPipeline.from_pretrained(out, bf16=False, device="cpu")
    _assert_weights(pipe.system.model, sd)

    rng = np.random.default_rng(1)
    cond = rng.uniform(0, 1, (1, 1, 3, RES, RES)).astype(np.float32)
    x_T = rng.normal(size=(1, VIEWS - 1, 3, RES, RES)).astype(np.float32)
    noise = rng.normal(size=(STEPS, 1, VIEWS - 1, 3, RES, RES)
                       ).astype(np.float32)
    c2w, fxy = (x[None] for x in object_camera_template(VIEWS, h=RES,
                                                        w=RES))
    got = pipe.system.sample(torch.from_numpy(cond), torch.from_numpy(c2w),
                             torch.from_numpy(fxy),
                             noise=torch.from_numpy(x_T),
                             noise_fn=lambda t: torch.from_numpy(noise[t]))

    jcfg = jax_load_config(config, makedirs=False)
    jsys = jax_build_system(jcfg.system_type, jcfg.system, bf16=False)
    npz = str(tmp_path / "w.npz")
    np.savez(npz, **convert_state_dict(sd))
    params = load_converted_params(npz, jsys.init_params(
        jax.random.PRNGKey(0), RES, RES, v=VIEWS))
    jnoise = jax.numpy.asarray(noise)
    ref = jax_loop(jsys.sched_infer,
                   jsys.make_model_fn(params, c2w, fxy, RES, RES,
                                      skip_cond_render=1),
                   cond, x_T, jax.random.PRNGKey(1), clip_denoised=False,
                   final_model_fn=jsys.make_model_fn(params, c2w, fxy, RES,
                                                     RES),
                   noise_fn=lambda t: jnoise[t])
    ref_g, ref_alpha = ref["aux"]

    assert int(got["overflow_gaussians"]) == 0
    for name, value in (("renders", ref["renders"]), ("sample", ref["sample"]),
                        ("alpha", ref_alpha)):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(value),
                                   atol=2e-5, err_msg=name)
    for name in ("xyz", "features", "scaling", "rotation", "opacity"):
        np.testing.assert_allclose(getattr(got["gaussians"], name).numpy(),
                                   np.asarray(getattr(ref_g, name)),
                                   rtol=2e-4, atol=2e-5, err_msg=name)


def test_make_pretrained_dir_reads_the_npz(pretrained, tmp_path):
    sd, config, _ = pretrained
    npz = str(tmp_path / "w.npz")
    np.savez(npz, **convert_state_dict(sd))
    out = str(tmp_path / "from_npz")
    make_pretrained_main(["--config", config, "--weights", npz, "--out", out,
                          "--device", "cpu"])
    pipe = DiffusionGSPipeline.from_pretrained(out, device="cpu")
    _assert_weights(pipe.system.model, sd)


def test_ema_is_preferred_over_params(pretrained, tmp_path):
    import shutil
    sd, _, out = pretrained
    d = str(tmp_path / "ema")
    shutil.copytree(out, d)
    path = os.path.join(d, "ckpts", "0.pt")
    ckpt = torch.load(path, weights_only=True)
    ckpt["ema_params"] = {k: v + 1.0 for k, v in ckpt["ema_params"].items()}
    torch.save(ckpt, path)
    pipe = DiffusionGSPipeline.from_pretrained(d, device="cpu")
    for name, value in pipe.system.model.state_dict().items():
        assert torch.equal(value, torch.from_numpy(sd[name]) + 1.0), name


def test_an_override_changes_the_config_not_the_params(pretrained):
    sd, _, out = pretrained
    pipe = DiffusionGSPipeline.from_pretrained(out, device="cpu", overrides=[
        "system.shape_model.gs_raw_offset_opacity=3.0",
        "system.raster.max_per_tile=2048"])
    assert pipe.system.model.gs_raw_offset_opacity == 3.0
    assert pipe.system.cfg.raster.max_per_tile == 2048
    _assert_weights(pipe.system.model, sd)


def test_run_main_with_ckpt_writes_ply(pretrained, tmp_path):
    _, _, out = pretrained
    dest = tmp_path / "out"
    run.main(["--image", IMAGE, "--ckpt", out, "--device", "cpu",
              "--matting", "border", "--resolution", str(RES),
              "--out", str(dest)])
    ply = dest / "gaussians.ply"
    assert ply.stat().st_size > 0
    assert b"element vertex" in ply.read_bytes()[:4096]
    assert sorted(p.name for p in dest.glob("render_*.png")) == [
        f"render_{i}.png" for i in range(4)]


def test_entry_points_raise_without_a_card(pretrained, tmp_path,
                                           monkeypatch):
    """No entry point falls back to the CPU unless asked to."""
    _, config, out = pretrained
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DiffusionGSPipeline.from_pretrained(out)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run.main(["--image", IMAGE, "--ckpt", out, "--out",
                  str(tmp_path / "o")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_pretrained_main(["--config", config, "--weights",
                              os.path.join(out, "ckpts"), "--out",
                              str(tmp_path / "p")])
