"""The port's two root-script CLIs on the CPU.

  * `process_data`: a synthetic pixelSplat `.torch` chunk (two scenes of
    JPEG-byte tensors and camera rows, written with `torch.save`) becomes
    PNGs, metadata JSON and `full_list.txt` equal to those of the root
    `process_data.py` functions bit for bit (paths compared below each
    run's own output directory);
  * `download_scene_ckpt`: `--ckpt` with a seeded reference-layout tiny
    scene checkpoint builds a pretrained directory whose params and EMA
    equal the checkpoint's tensors bit for bit; `--evaluate --device cpu`
    on a synthetic RE10K tree (tests/synthetic_fixtures.py) at a tiny
    width through `--override` writes `eval_result.json` and prints
    `PARITY_ROW`; without `--ckpt` and without `huggingface_hub` it exits
    2.  Nothing is downloaded.
"""

import glob
import io
import json
import os
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from open_diffusiongs_tpu_torch import download_scene_ckpt, launch
from open_diffusiongs_tpu_torch import process_data
from open_diffusiongs_tpu_torch.systems.builder import build_system
from open_diffusiongs_tpu_torch.utils.config import load_config
from synthetic_fixtures import make_re10k_tree
from test_torch_scene import SCENE_CFG
from torch_reference_weights import save_lightning_ckpt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import process_data as root_process_data  # noqa: E402


def _jpeg(rng, h, w) -> torch.Tensor:
    buf = io.BytesIO()
    Image.fromarray(rng.uniform(0, 255, (h, w, 3)).astype(np.uint8)).save(
        buf, format="JPEG", quality=90)
    return torch.frombuffer(bytearray(buf.getvalue()), dtype=torch.uint8)


def _chunk(path, rng):
    """Two scenes in the pixelSplat layout: JPEG bytes per frame and camera
    rows [fx, fy, cx, cy (normalized), 2 unused, 12 w2c entries]."""
    scenes = []
    for key, n, (h, w) in (("5aca87f95a9412c6", 3, (24, 40)),
                           ("0b2c3d4e5f607182", 2, (30, 20))):
        cams = rng.normal(size=(n, 18)).astype(np.float32)
        cams[:, :4] = rng.uniform(0.3, 1.2, (n, 4))
        scenes.append({"key": key, "url": f"https://example.invalid/{key}",
                       "timestamps": torch.arange(n),
                       "cameras": torch.from_numpy(cams),
                       "images": [_jpeg(rng, h, w) for _ in range(n)]})
    torch.save(scenes, str(path))


def _tree(top: str) -> dict:
    """{relative path: bytes} of every file below `top`, with `top` itself
    written as <OUT> inside the text files."""
    out = {}
    for p in sorted(glob.glob(os.path.join(top, "**", "*"), recursive=True)):
        if os.path.isfile(p):
            data = open(p, "rb").read()
            if p.endswith((".json", ".txt")):
                data = data.replace(os.path.abspath(top).encode(), b"<OUT>")
            out[os.path.relpath(p, top)] = data
    return out


def test_process_data_matches_the_root_script_bit_for_bit(tmp_path):
    base = tmp_path / "pixelsplat"
    (base / "test").mkdir(parents=True)
    _chunk(base / "test" / "000000.torch", np.random.default_rng(0))
    ref_out = str(tmp_path / "ref" / "test")
    root_process_data.process_directory(str(base / "test"), ref_out)
    root_process_data.generate_full_list(os.path.join(ref_out, "metadata"),
                                         ref_out)
    path = process_data.main(["--mode", "test", "--base_path", str(base),
                              "--output_dir", str(tmp_path / "port")])
    assert path == str(tmp_path / "port" / "test" / "full_list.txt")
    got, want = _tree(str(tmp_path / "port" / "test")), _tree(ref_out)
    assert len(got) == 3 + 2 + 2 + 1       # PNGs, JSONs, full_list.txt
    assert got == want
    meta = json.loads(got[os.path.join("metadata",
                                       "5aca87f95a9412c6.json")])
    assert len(meta["frames"]) == 3
    assert np.asarray(meta["frames"][0]["w2c"]).shape == (4, 4)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """(tmp dir, tiny scene config path, a seeded reference-layout .ckpt of
    its denoiser, the state dict in it)."""
    tmp = tmp_path_factory.mktemp("scene_ckpt")
    full_list = make_re10k_tree(tmp, np.random.default_rng(0), n_scenes=2,
                                n_frames=8, res=(36, 64))
    config = tmp / "scene.yaml"
    config.write_text(SCENE_CFG.format(out=tmp / "outputs",
                                       full_list=full_list))
    cfg = load_config(str(config), makedirs=False)
    system = build_system(cfg.system_type, cfg.system, bf16=False,
                          device=torch.device("cpu"))
    rng = np.random.default_rng(3)
    sd = {k: rng.normal(0, 0.02, v.shape).astype(np.float32)
          for k, v in system.model.state_dict().items()}
    ckpt = save_lightning_ckpt(sd, tmp / "scene.ckpt")
    return tmp, str(config), ckpt, sd


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    """Where TensorFlow is installed, TensorBoard's writer imports it
    (~18 s); tests/test_torch_launch.py tests the loggers."""
    monkeypatch.setattr(launch, "_loggers", lambda cfg: (None, None))


def test_ckpt_builds_a_pretrained_dir_bit_for_bit(scene):
    tmp, config, ckpt, sd = scene
    out = download_scene_ckpt.main(["--ckpt", ckpt, "--out",
                                    str(tmp / "a"), "--config", config,
                                    "--device", "cpu"])
    pretrained = str(tmp / "a" / "pretrained")
    assert out == {"pretrained": pretrained}
    assert sorted(os.listdir(pretrained)) == ["ckpts", "config.yaml"]
    state = torch.load(os.path.join(pretrained, "ckpts", "0.pt"),
                       weights_only=True)
    assert state["step"] == 0
    for store in ("params", "ema_params"):
        assert set(state[store]) == set(sd)
        for name, want in sd.items():
            np.testing.assert_array_equal(state[store][name].numpy(), want,
                                          err_msg=f"{store} {name}")


def test_evaluate_writes_eval_result_and_prints_the_parity_row(scene,
                                                               capsys):
    tmp, config, ckpt, _ = scene
    out = download_scene_ckpt.main([
        "--ckpt", ckpt, "--out", str(tmp / "b"), "--config", config,
        "--evaluate", "--device", "cpu", "--protocol", "strict",
        "--override", f"exp_root_dir={tmp / 'eval_outputs'}",
        "--override", "system.save_intermediate_video=false"])
    rows = [line for line in capsys.readouterr().out.splitlines()
            if line.startswith("PARITY_ROW ")]
    assert len(rows) == 1
    row = json.loads(rows[0][len("PARITY_ROW "):])
    assert row == out["parity_row"]
    assert row["benchmark"] == "RE10K" and row["protocol"] == "strict"
    assert row["num_scenes"] == 2
    assert np.isfinite(row["psnr"]) and np.isfinite(row["ssim"])
    assert row["reference_published"] == {"psnr": 21.26, "ssim": 0.672,
                                          "lpips": 0.257}
    results = glob.glob(str(tmp / "eval_outputs" / "**" / "eval_result.json"),
                        recursive=True)
    assert len(results) == 1
    assert json.load(open(results[0]))["psnr"] == row["psnr"]


def test_no_ckpt_and_no_hub_exits_2(tmp_path, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "huggingface_hub", None)
    with pytest.raises(SystemExit) as exit_info:
        download_scene_ckpt.main(["--out", str(tmp_path), "--device", "cpu"])
    assert exit_info.value.code == 2
    err = capsys.readouterr().err
    assert "huggingface_hub is not installed" in err
    assert "--ckpt scene_ckpt_256.ckpt" in err
    assert not os.listdir(tmp_path)
