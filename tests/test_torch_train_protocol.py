"""open_diffusiongs_tpu_torch/tools/train_protocol.py on the CPU: the
protocol's two legs through `launch` at 16², width 64, 2 layers, on trees
the port's generators write (object and scene recipe), the eval after the
restore equal to the eval at the save bit for bit, the eval draws
reproducing the logged eval bit for bit, and the summary's reading of the
CSVs (the curve, the PSNR gains, the windows without an eval); and
JAX_EVAL_T against the t that JAX's `train_loss` draws from JAX launch's
fixed-eval keys.
"""

import csv

import jax
import numpy as np
import pytest
import torch

from open_diffusiongs_tpu.systems import object_system as jos

from open_diffusiongs_tpu_torch import launch
from open_diffusiongs_tpu_torch.tools import make_synthetic_objaverse as po
from open_diffusiongs_tpu_torch.tools import make_synthetic_re10k as pr
from open_diffusiongs_tpu_torch.tools import train_protocol

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these width-64 steps: beside the other test
    workers on a few cores, more threads only spin against them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TINY = ["system.shape_model.width=64", "system.shape_model.num_layers=2",
        "system.shape_model.dim_heads=32", "data.training_res=[16,16]",
        "system.raster.max_per_tile=1056", "data.num_workers=1",
        "trainer.log_every_n_steps=1"]


def _write(path, header, rows):
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(header)
        w.writerows(rows)


def test_summary_reads_the_curve(tmp_path):
    psnr = {0: 11.0, 50: 10.8, 100: 10.5, 150: 10.6, 200: 11.0, 400: 15.0,
            600: 12.5}
    evals = [[s, p, 0.1, 0.9, 5.0, 6.0] for s, p in psnr.items()]
    evals.append([600, 99.0, 0.1, 0.9, 5.0, 6.0])   # the resume's repeat
    _write(tmp_path / "eval_metrics.csv", ["step", "psnr", "loss",
                                           "overflow_frac", "overflow_tiles",
                                           "overflow_gaussians"], evals)
    # logged every 5 steps: the windows holding an eval (50, 100, ...) and
    # the first step after the restart are not clean
    train = [[s, 1.0 if s % 50 == 0 else 4.0, 0.0, 0.5]
             for s in range(5, 605, 5)] + [[601, 0.1, 0.0, 0.5],
                                           [605, 3.0, 0.0, 0.5]]
    _write(tmp_path / "metrics.csv", ["step", "steps_per_sec",
                                      "loader_wait_s", "overflow_frac"],
           train)
    out = train_protocol.summarize(str(tmp_path), eval_every=50,
                                   log_every=5, save_step=600)
    assert out["psnr_min_0_150"] == 10.5
    assert out["gain_600_over_min_0_150"] == pytest.approx(2.0)
    assert out["gain_400_over_step0"] == pytest.approx(4.0)
    assert list(out["at_steps"]) == [0, 150, 400, 600]
    assert out["at_steps"][600]["psnr"] == 12.5
    assert (out["last_step"], out["psnr_last"]) == (600, 12.5)
    assert out["steps_per_sec_median"] == 4.0
    assert out["steps_per_sec_windows"] == 120 - 12 + 1
    assert len(out["curve"]) == 8


def test_summary_refuses_non_finite(tmp_path):
    _write(tmp_path / "eval_metrics.csv", ["step", "psnr", "loss",
                                           "overflow_frac", "overflow_tiles",
                                           "overflow_gaussians"],
           [[0, "nan", 0.1, 0.0, 0, 0]])
    _write(tmp_path / "metrics.csv", ["step", "steps_per_sec",
                                      "loader_wait_s", "overflow_frac"],
           [[1, 1.0, 0.0, 0.0]])
    with pytest.raises(AssertionError, match="non-finite"):
        train_protocol.summarize(str(tmp_path), 50, 5, -1)


@pytest.mark.parametrize("recipe", ["object", "scene"])
def test_protocol_legs_on_a_generated_tree(tmp_path, monkeypatch, recipe):
    monkeypatch.setattr(launch, "_loggers", lambda cfg: (None, None))
    tree = str(tmp_path / "tree")
    if recipe == "object":
        po.main(["--out", tree, "--objects", "2", "--res", "32",
                 "--gaussians", "256", "--device", "cpu"])
    else:
        pr.main(["--out", tree, "--scenes", "1", "--frames", "8", "--res",
                 "32", "--wall-step", "0.5", "--lobes", "4", "--device",
                 "cpu"])
    out = train_protocol.main([
        "--recipe", recipe, "--tree", tree, "--out", str(tmp_path / "runs"),
        "--max-steps", "2", "--resume-steps", "1", "--device", "cpu",
        "--json", str(tmp_path / "run.json"), *TINY,
        "trainer.eval_every_n_steps=2"])
    assert out["resume_eval_equal"]
    assert [r["step"] for r in out["curve"]] == [0, 2, 2]
    assert out["trial_dir"].endswith(f"protocol_{recipe}/run")
    assert set(train_protocol.PROTOCOL) <= set(out["overrides"])
    assert out["profile"] is None and out["card"] is None
    draws = out["eval_draws"]
    assert draws["reproduces_logged_eval"]
    assert draws["psnr_port_t"] == out["curve"][1]["psnr"]
    assert draws["jax_t"] == list(train_protocol.JAX_EVAL_T)
    assert len(draws["port_t"]) == 4
    assert sorted(draws["psnr_by_t"]) == list(train_protocol.SWEEP_T)
    assert all(np.isfinite(v) for v in draws["psnr_by_t"].values())
    assert (tmp_path / "run.json").exists()


class _Drawn(Exception):
    pass


def test_jax_eval_t_is_what_jax_draws(monkeypatch):
    """JAX launch's fixed eval calls train_loss with PRNGKey(10_000 + i),
    i < 4 (launch.py:267); the t it draws at b = 1, read where train_loss
    hands it to q_sample."""
    seen = []

    def drawn(sched, x, t, noise):
        seen.append(int(t[0]))
        raise _Drawn

    monkeypatch.setattr(jos, "q_sample", drawn)
    system = jos.ObjectSystem(jos.ObjectSystemConfig(use_lpips=False,
                                                     lambda_lpips=0.0))
    eye = np.broadcast_to(np.eye(4, dtype=np.float32), (1, 2, 4, 4))
    batch = {"rgbs_input": np.zeros((1, 2, 3, 8, 8), np.float32),
             "c2ws_input": eye,
             "fxfycxcys_input": np.full((1, 2, 4), 4.0, np.float32)}
    for i in range(4):
        with pytest.raises(_Drawn):
            system.train_loss(None, batch, jax.random.PRNGKey(10_000 + i),
                              10 ** 6)
    assert tuple(seen) == train_protocol.JAX_EVAL_T


def test_max_steps_must_meet_an_eval(tmp_path):
    with pytest.raises(SystemExit):
        train_protocol.main(["--recipe", "object", "--tree", str(tmp_path),
                             "--out", str(tmp_path), "--max-steps", "75",
                             "--device", "cpu"])
