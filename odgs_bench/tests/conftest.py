"""Tests of the benchmark harness.  Those marked `card` drive a run on an
NVIDIA card and skip without one; the rest run on the CPU at tiny sizes:
    python3 -m pytest odgs_bench/tests -q"""

import copy
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card; skipped without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this machine")
    return torch.device("cuda", 0)


def tiny(cell: dict, steps: int = 5) -> dict:
    """A cell cut to CPU size: width 128 in heads of 32, 3 layers, 32²
    renders of 4 views, `steps` sampler steps, 2 images a call."""
    cell = copy.deepcopy(cell)
    cfg = cell["config"]
    cfg["system"]["shape_model"].update(width=128, dim_heads=32, num_layers=3)
    cfg["system"]["num_inference_steps"] = steps
    cfg["data"]["training_res"] = [32, 32]
    cell["traffic"].update(batch=2, pool=3, image_size=64)
    cell["check"]["check_steps"] = 3
    return cell


@pytest.fixture
def spec():
    from odgs_bench import harness
    return harness.load_spec(ROOT)


@pytest.fixture
def tiny_cell(spec):
    from odgs_bench import harness
    return tiny(harness.cell(spec, ROOT, "obj256.sample_b4"))


TRAIN_TRAFFIC = {"kind": "train", "batch": 2, "views_in": 4, "views": 5,
                 "pool": 4, "start_step": 151, "ema_decay": 0.9999}


@pytest.fixture
def tiny_train_cell():
    """A training cell of diffusionGS_rel cut to CPU size (BENCHMARK.json
    has none yet): width 64 in heads of 16, one layer, 32² renders, 5
    views of which 4 are input, 2 objects a step, K = 64 candidates a
    tile; limits between the program's readings and the control's at
    this size."""
    import json
    cfg = json.loads((ROOT / "odgs_bench" / "configs"
                      / "diffusionGS_rel.json").read_text())
    cfg["system"]["shape_model"].update(width=64, dim_heads=16, num_layers=1)
    cfg["system"]["raster"].update(max_per_tile=64)
    cfg["data"]["training_res"] = [32, 32]
    return {"config": cfg, "traffic": dict(TRAIN_TRAFFIC),
            "check": {"trace_steps": 2, "limits": {
                "loss_gap": 1.2e-3, "grad_gap": 1e-3, "change_gap": 1.8e-3,
                "ema_gap": 1e-2}},
            "metrics": {"end_to_end": [
                {"name": "train_samples_per_s.tiny", "unit": "samples/s"},
                {"name": "setup_s", "unit": "s"}], "per_layer": []}}
