"""The port's training / evaluation CLI (open_diffusiongs_tpu_torch.launch)
in process on the CPU, at 16², width 64, 2 layers, on a synthetic
G-Objaverse tree (tests/synthetic_fixtures.py).

Modelled on the JAX package's tests/test_launch_cli.py (slow there,
subprocesses): train, then resume from the checkpoint with
log_every_n_steps = 100 so that only the first step after the restart
logs; the fixed-batch eval right after the restore equals the eval at the
save bit for bit; a restored state equals the saved one bit for bit;
--export writes PLY, PNG and AVI; --validate writes its grids and
val_metrics.json; the parallelism keys that are not ported raise and
seq_parallel must divide the world size; without `--device cpu` and with
no card the CLI raises.
"""

import csv
import json
import os
import sys
import types

import numpy as np
import pytest
import torch

from open_diffusiongs_tpu_torch import launch
from open_diffusiongs_tpu_torch.parallel import mesh
from synthetic_fixtures import make_gobjaverse_tree

TINY_CFG = """
exp_root_dir: "{out}"
name: "tiny"
tag: "t"
use_timestamp: false
seed: 0
data_type: "Objaverse-datamodule"
data:
  local_dir: "{root}"
  image_dir: "{img}/"
  gen_idxs: [30, 33, 36, 39]
  sel_views: 2
  gen_views: 4
  training_res: [16, 16]
  batch_size: 1
  num_workers: 1
  norm_camera: true
  norm_radius: 3.
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
  loss:
    lambda_diffusion: 1.0
    lambda_lpips: 0.0
    lambda_ssim: 0.0
    lambda_pointsdist: 0.1
    lambda_xyz: 0.0
  optimizer:
    name: AdamW
    args: {{lr: 1.e-4}}
  scheduler:
    name: CosineAnnealingLR
    args: {{T_max: 100}}
trainer:
  log_every_n_steps: 1
  eval_every_n_steps: 3
  gradient_clip_val: 0.5
  precision: fp32
checkpoint:
  every_n_train_steps: 2
"""


LOGGERS = launch._loggers


@pytest.fixture(scope="module", autouse=True)
def no_tensorboard():
    """Where TensorFlow is installed, TensorBoard's writer imports it
    (~18 s); the loggers have their own test."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(launch, "_loggers", lambda cfg: (None, None))
        yield


def test_loggers_degrade_with_a_printed_line(tmp_path, capsys,
                                             monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    monkeypatch.setitem(sys.modules, "wandb", None)
    cfg = types.SimpleNamespace(
        trial_dir=str(tmp_path), name="n",
        system={"loggers": {"wandb": {"enable": True}}})
    assert LOGGERS(cfg) == (None, None)
    out = capsys.readouterr().out
    assert "tensorboard disabled" in out
    assert "wandb logging disabled" in out


def _rows(path):
    with open(path) as f:
        return [r for r in csv.reader(f) if r]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gobj")
    root, img = make_gobjaverse_tree(tmp, np.random.default_rng(0),
                                     res=32, uids=("000/obj1", "000/obj2"))
    (root / "test.json").write_text(json.dumps(["000/obj1", "000/obj2"]))
    cfg = tmp / "tiny.yaml"
    cfg.write_text(TINY_CFG.format(out=tmp / "outputs", root=root, img=img))
    return tmp, str(cfg)


@pytest.fixture(scope="module")
def trained(tree):
    """3 steps, then a resume to 5 under log_every_n_steps = 100, then an
    export from the last checkpoint."""
    tmp, cfg = tree
    first = launch.main(["--config", cfg, "--train", "--max_steps", "3",
                         "--device", "cpu"])
    trial = first["trial_dir"]
    saved = {k: v.clone() for k, v in first["state"].params.items()}
    resumed = launch.main(["--config", cfg, "--train", "--max_steps", "5",
                           "--device", "cpu", f"resume={trial}/ckpts",
                           "trainer.log_every_n_steps=100"])
    exported = launch.main(["--config", cfg, "--export", "--device", "cpu",
                            f"resume={trial}/ckpts",
                            "trainer.limit_val_batches=1"])
    return trial, first, saved, resumed, exported


def test_train_snapshots_and_checkpoints(trained):
    trial, first, _, resumed, _ = trained
    for name in ("cmd.txt", "parsed.yaml", "metrics.csv", "eval_metrics.csv"):
        assert os.path.exists(os.path.join(trial, name)), name
    # every 2 steps and forced at the end of each run
    assert sorted(int(f[:-3]) for f in os.listdir(os.path.join(
        trial, "ckpts"))) == [2, 3, 4, 5]
    assert [s["bytes"] > 0 for s in first["saves"]] == [True, True]
    assert first["state"].step == 3 and resumed["state"].step == 5


def test_metrics_csv_spans_the_restart(trained):
    trial = trained[0]
    rows = _rows(os.path.join(trial, "metrics.csv"))
    header, data = rows[0], rows[1:]
    assert [int(r[0]) for r in data] == [1, 2, 3, 4]
    for name in ("loss", "psnr", "overflow_frac", "grad_norm",
                 "steps_per_sec"):
        assert name in header, header
    assert all(np.isfinite(float(x)) for r in data for x in r[1:])


def test_eval_after_restore_equals_eval_at_save(trained):
    rows = _rows(os.path.join(trained[0], "eval_metrics.csv"))
    header, data = rows[0], rows[1:]
    assert "psnr" in header and "loss" in header
    # step 0, the save at 3, then the first eval after the restore at 3
    assert [r[0] for r in data] == ["0", "3", "3"]
    assert data[1] == data[2]
    assert data[0] != data[1]


def test_restored_state_equals_saved_state(trained):
    _, first, saved, resumed, exported = trained
    state = exported["state"]
    final = resumed["state"]
    assert state.step == final.step == 5
    for name, value in final.params.items():
        assert torch.equal(state.params[name], value), name
        assert torch.equal(state.ema_params[name], final.ema_params[name])
    mu, want = (s.optimizer.state_dict()["mu"] for s in (state, final))
    assert set(mu) == set(want)
    for name in mu:
        assert torch.equal(mu[name], want[name]), name
    assert state.optimizer.count == final.optimizer.count == 5
    # and the resumed run trained on from the saved params
    assert any(not torch.equal(saved[k], v) for k, v in final.params.items())


def test_export_writes_ply_png_avi(trained):
    trial, exported = trained[0], trained[4]
    out = os.path.join(trial, "save", "it5-export")
    assert exported["out_dir"] == out and exported["scenes"] == 1
    # uids are paths below image_dir, "000/obj1"
    files = os.listdir(os.path.join(out, "000"))
    assert {"obj1.png", "obj1.ply", "obj1_path.avi"} <= set(files)


def test_validate_writes_grids_and_metrics(trained, tree):
    _, cfg = tree
    out = launch.main(["--config", cfg, "--validate", "--device", "cpu",
                       f"resume={trained[0]}/ckpts", "--use_ema"])
    assert "val_metrics.json" in os.listdir(out["out_dir"])
    assert {"obj1.png", "obj2.png"} <= set(os.listdir(
        os.path.join(out["out_dir"], "000")))
    metrics = json.load(open(os.path.join(out["out_dir"],
                                          "val_metrics.json")))
    # 2 objects x 3 novel views (4 input views, view 0 the condition)
    assert metrics["num_views"] == 6 and metrics["step"] == 5
    assert np.isfinite(metrics["psnr"])


def test_test_mode_keeps_its_own_dir(trained, tree):
    _, cfg = tree
    out = launch.main(["--config", cfg, "--test", "--device", "cpu",
                       f"resume={trained[0]}/ckpts",
                       "trainer.limit_val_batches=0.5"])
    assert out["out_dir"].endswith(os.path.join("save", "it5-test"))
    assert out["scenes"] == 1            # half of the 2 objects' batches
    assert json.load(open(os.path.join(out["out_dir"], "val_metrics.json"))
                     )["num_views"] == 3


@pytest.mark.parametrize("key", ["model_parallel", "seq_parallel",
                                 "pipe_parallel"])
def test_parallelism_keys_raise(tree, key):
    """Tensor, sequence and pipeline parallelism are ported; an axis of 2
    does not divide the world size of one process."""
    _, cfg = tree
    with pytest.raises(ValueError, match=f"trainer.{key}=2 does not divide "
                                         f"the world size 1"):
        launch.main(["--config", cfg, "--train", "--max_steps", "1",
                     "--device", "cpu", f"trainer.{key}=2"])


def test_zero1_raises_with_more_than_one_data_rank():
    """ZeRO-1 is ported: check_parallelism accepts it with one data rank
    and with two, alone and beside a seq ring."""
    assert mesh.check_parallelism({"zero1": True}) == (1, 1, 1, 1)
    assert mesh.check_parallelism({"zero1": True},
                                  world_size=2) == (2, 1, 1, 1)
    assert mesh.check_parallelism({"zero1": True, "seq_parallel": 2},
                                  world_size=4) == (2, 1, 2, 1)


def test_launch_raises_without_a_card(tree, monkeypatch):
    _, cfg = tree
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch.main(["--config", cfg, "--train", "--max_steps", "1"])


def test_draws_fold_the_step():
    assert launch.fold_seed(1, 5) == launch.fold_seed(1, 5)
    assert len({launch.fold_seed(s, i) for s in (1, 2) for i in (0, 1)}) == 4
    a = torch.randn(3, generator=launch.generator("cpu", 1, 7))
    b = torch.randn(3, generator=launch.generator("cpu", 1, 7))
    assert torch.equal(a, b)
