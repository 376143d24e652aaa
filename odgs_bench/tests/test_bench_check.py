"""The check that decides `correct`, at a CPU size: the plain reference
agrees with the port's CPU path, the program passes, the control a
precision lower fails, and so does a run whose timed path is broken in
each way a sampling cell can break.  (A cell on one card has no exchange
between cards to leave out.)"""

import copy
import time

import numpy as np
import pytest
import torch

from odgs_bench import run
from odgs_bench.kinds import sample

CPU = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}


def run_tiny(cell, seed, control=None, check_mode=None):
    res = sample.run(cell, seed, 0.0, False, time.perf_counter(), "cpu",
                     control, check_mode)
    return run.result(cell, res, False, CPU)


def test_reference_agrees_with_the_port_cpu_path(tiny_cell, monkeypatch):
    """The port computing in f32 meets the f32 reference to rounding."""
    from open_diffusiongs_tpu_torch.pipeline import DiffusionGSPipeline
    from open_diffusiongs_tpu_torch.systems.builder import build_system

    def build_f32(config, device, control=None):
        system = build_system(config["system_type"],
                              copy.deepcopy(config["system"]), bf16=False,
                              device=device)
        return system, DiffusionGSPipeline(system)

    monkeypatch.setattr(sample, "build", build_f32)
    g = run_tiny(tiny_cell, 2 ** 31 + 5)["checks"]
    assert g["start_gap"]["value"] == 0 and g["filter_gap"]["value"] == 0
    assert g["embed_gap"]["value"] < 1e-5
    assert g["stack_gap"]["value"] < 1e-4
    assert g["dit_gap"]["value"] < 1e-5
    assert g["step_gap"]["value"] < 1e-5


@pytest.mark.parametrize("seed", [2 ** 31 + 11, 2 ** 33 + 7, 12345])
def test_program_passes_and_the_control_fails(tiny_cell, seed):
    assert run_tiny(tiny_cell, seed)["correct"]
    low = run_tiny(tiny_cell, seed, check_mode="low")
    assert not low["correct"]
    failed = {k for k, v in low["checks"].items() if v["value"] > v["limit"]}
    assert failed >= {"embed_gap", "stack_gap", "dit_gap", "step_gap"}


def _unchanged_step(monkeypatch):
    from open_diffusiongs_tpu_torch.diffusion import gaussian_diffusion as gd
    orig = gd.p_sample_step

    def step(sched, model_fn, cond, x_t, t_idx, *a, **k):
        _, pred, aux = orig(sched, model_fn, cond, x_t, t_idx, *a, **k)
        return x_t, pred, aux
    monkeypatch.setattr(gd, "p_sample_step", step)


def _half_batch(monkeypatch):
    from open_diffusiongs_tpu_torch.models.denoiser import DGSDenoiser
    from open_diffusiongs_tpu_torch.ops.gaussians import Gaussians
    orig = DGSDenoiser.forward

    def forward(self, images, ray_o, ray_d, t, training=False):
        h = images.shape[0] // 2
        g, xyz = orig(self, images[:h], ray_o[:h], ray_d[:h], t[:h],
                      training)

        def fill(x):
            return torch.cat([x, x.mean(0, keepdim=True).expand(
                images.shape[0] - h, *x.shape[1:])])
        return Gaussians(*(fill(x) for x in g)), fill(xyz)
    monkeypatch.setattr(DGSDenoiser, "forward", forward)


def _answer_altered(monkeypatch):
    from open_diffusiongs_tpu_torch.models.denoiser import DGSDenoiser
    orig = DGSDenoiser.forward

    def forward(self, images, ray_o, ray_d, t, training=False):
        g, xyz = orig(self, images, ray_o, ray_d, t, training)
        if int(t[0]) == 0:
            g = g._replace(opacity=g.opacity + 0.5 * (
                torch.arange(g.opacity.shape[0]) == 0).view(-1, 1, 1))
        return g, xyz
    monkeypatch.setattr(DGSDenoiser, "forward", forward)


def _export_altered(monkeypatch):
    from open_diffusiongs_tpu_torch.ops.gaussians import NumpyGaussians
    orig = NumpyGaussians.apply_all_filters

    def filters(self, *a, **k):
        out = orig(self, *a, **k)
        return out._replace(xyz=np.where(np.arange(len(out.xyz))[:, None]
                                         == 0, out.xyz + 1e-3, out.xyz))
    monkeypatch.setattr(NumpyGaussians, "apply_all_filters", filters)


@pytest.mark.parametrize("fault", [_unchanged_step, _half_batch,
                                   _answer_altered, _export_altered])
def test_a_broken_timed_path_is_not_correct(tiny_cell, monkeypatch, fault):
    fault(monkeypatch)
    assert not run_tiny(tiny_cell, 2 ** 31 + 77)["correct"]


@pytest.mark.card
def test_control_fails_on_the_card(card, spec):
    """The control a precision lower at the cell's own size (run it on the
    chip: python3 -m pytest odgs_bench/tests -m card)."""
    from odgs_bench import harness
    cell = harness.cell(spec, harness.HERE.parent, "obj256.sample_b4")
    for seed in (2 ** 31 + 1, 2 ** 31 + 2, 2 ** 31 + 3):
        res = sample.run(cell, seed, 0.0, False, time.perf_counter(), card,
                         check_mode="low")
        out = run.result(cell, res, False, CPU)
        assert not out["correct"]
