"""The training check at a CPU size: the plain reference's three steps
agree with the port's CPU path in f32, the program passes, the reference
a precision lower in its place fails, and so does a run whose train step
is broken in each way a one-card training cell can break (a step that
leaves the state unchanged, an EMA left unchanged or decayed at the wrong
rate, half the batch left out, the loss altered where it is produced).
The tests marked `card` run the control and the half-batch fault at the
cell's own size (python3 -m pytest odgs_bench/tests -m card)."""

import time

import pytest
import torch

from odgs_bench import run
from odgs_bench.kinds import train

CPU = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
SEED = 2 ** 31 + 3
CARD_SEEDS = (2 ** 31 + 21, 2 ** 31 + 22, 2 ** 31 + 23)


def run_tiny(cell, seed=SEED, device="cpu"):
    res = train.run(cell, seed, 0.0, False, time.perf_counter(), device)
    return run.result(cell, res, False, CPU)


def test_reference_agrees_with_the_port_cpu_path(tiny_train_cell,
                                                 monkeypatch):
    from open_diffusiongs_tpu_torch.systems import builder
    orig = builder.build_system
    monkeypatch.setattr(builder, "build_system",
                        lambda *a, **k: orig(*a, **dict(k, bf16=False)))
    g = run_tiny(tiny_train_cell)["checks"]
    assert g["loss_gap"]["value"] < 1e-5
    assert g["grad_gap"]["value"] < 1e-4
    assert g["change_gap"]["value"] < 1e-3
    assert g["ema_gap"]["value"] < 1e-4


def test_program_passes_and_the_control_fails(tiny_train_cell):
    assert run_tiny(tiny_train_cell)["correct"]
    out = run.result(tiny_train_cell, train.control(tiny_train_cell, SEED,
                                                    "cpu"), False, CPU)
    assert not out["correct"]
def _unchanged_state(monkeypatch):
    from open_diffusiongs_tpu_torch.parallel import train_step
    monkeypatch.setattr(train_step.Optimizer, "step",
                        lambda self, grad_norm=None: True)


def _ema_unchanged(monkeypatch):
    from open_diffusiongs_tpu_torch.parallel import train_step
    monkeypatch.setattr(train_step.TrainState, "has_ema",
                        property(lambda self: False))


def _ema_wrong_decay(monkeypatch):
    from open_diffusiongs_tpu_torch.parallel import train_step
    orig = train_step.make_train_step
    monkeypatch.setattr(train_step, "make_train_step",
                        lambda loss_fn, opt, ema_decay=0.9999: orig(
                            loss_fn, opt, ema_decay=0.999))


def _half_batch(monkeypatch):
    from open_diffusiongs_tpu_torch.systems.object_system import \
        ObjectSystem
    orig = ObjectSystem.train_loss

    def loss(self, batch, step, generator=None, noise=None, t=None):
        b = batch["rgbs"].shape[0]
        noise = torch.randn((b, *batch["rgbs_input"].shape[1:]),
                            generator=generator,
                            device=batch["rgbs"].device)
        t = torch.randint(0, 1000, (b,), generator=generator,
                          device=batch["rgbs"].device)
        half = {k: v[:b // 2] for k, v in batch.items()}
        return orig(self, half, step, noise=noise[:b // 2], t=t[:b // 2])
    monkeypatch.setattr(ObjectSystem, "train_loss", loss)


def _loss_altered(monkeypatch):
    from open_diffusiongs_tpu_torch.systems.object_system import \
        ObjectSystem
    orig = ObjectSystem.train_loss

    def loss(self, *a, **k):
        total, metrics = orig(self, *a, **k)
        total = total * 1.05
        return total, dict(metrics, loss=total.detach())
    monkeypatch.setattr(ObjectSystem, "train_loss", loss)


@pytest.mark.parametrize("fault", [_unchanged_state, _ema_unchanged,
                                   _ema_wrong_decay, _half_batch,
                                   _loss_altered])
def test_a_broken_train_step_is_not_correct(tiny_train_cell, monkeypatch,
                                            fault):
    fault(monkeypatch)
    assert not run_tiny(tiny_train_cell)["correct"]


def _card_cell():
    from odgs_bench import harness
    spec = harness.load_spec(harness.HERE.parent)
    return harness.cell(spec, harness.HERE.parent, "obj256.train_b4")


def _printed(what, seed, out):
    print(what, seed, {k: v["value"] for k, v in out["checks"].items()})


@pytest.mark.card
def test_control_fails_on_the_card(card):
    """The reference a precision lower in the program's place, at the
    cell's own size, judged by run.result."""
    cell = _card_cell()
    for seed in CARD_SEEDS:
        out = run.result(cell, train.control(cell, seed, card), False, CPU)
        _printed("control", seed, out)
        assert not out["correct"]


@pytest.mark.card
def test_half_batch_fails_on_the_card(card, monkeypatch):
    """Half of each step's batch left out, at the cell's own size."""
    _half_batch(monkeypatch)
    cell = _card_cell()
    for seed in CARD_SEEDS:
        res = train.run(cell, seed, 0.0, False, time.perf_counter(), card)
        out = run.result(cell, res, False, CPU)
        _printed("half batch", seed, out)
        assert not out["correct"]
