"""The port's data parallelism, ZeRO-1 and sequence-parallel training in two
gloo processes on the CPU (tests/torch_dist.py::parallel_cases, one world
of 2), against the one-process train step of the same code:

  * DDP (dp = 2, one sample a rank) equals the one-process step on both
    samples with the same draws (the global batch's noise and t, taken by
    row): loss (the ranks' mean) rtol 1e-5, grad_norm rtol 1e-4, and the
    change of the params and of the EMA over two steps at rel-max 1e-2 of
    the one-process change, tensor by tensor (Adam moves an element whose
    gradient is near eps by up to lr·g/(|g| + eps), which the two
    summation orders of the gradient can shift, so an element-wise bar
    would measure eps, not the reduction);
  * ZeRO-1 (dp = 2) equals DDP bit for bit over two steps: params, EMA,
    Adam moments (gathered) and grad_norm, with two param groups and the
    clip active; each rank holds half the moments;
  * checkpoints move across world sizes: ZeRO-1's (written by rank 0 from
    the gathered shards) restores on one process bit for bit, and a
    one-process checkpoint restores under ZeRO-1 bit for bit;
  * sp = 2 (a 290-token DiT on the packed route, padded to 512: one full
    shard and one of 34 real rows) equals the one-process step with the
    same bars;
  * a two-process `launch --train` with trainer.zero1, and one with
    trainer.model_parallel=2: only rank 0 writes, and its checkpoint
    restores on one process bit for bit.
"""

import os

import numpy as np
import pytest
import torch

from open_diffusiongs_tpu_torch.parallel import train_step as ts
from open_diffusiongs_tpu_torch.utils.checkpoint import CheckpointManager
from test_torch_launch import TINY_CFG
from test_torch_train import _batch
from synthetic_fixtures import make_gobjaverse_tree
from torch_dist import build_tiny_system, parallel_cases, run_world, \
    train_steps

SYSTEM = {
    "use_lpips": False,
    "shape_model": {"width": 64, "num_layers": 2, "patch_size": 8,
                    "dim_heads": 32},
    "raster": {"max_tiles_per_gaussian": 16, "max_per_tile": 1056,
               "blend_chunk": 32},
    "loss": {"lambda_diffusion": 1.0, "lambda_lpips": 0.0,
             "lambda_ssim": 0.0, "lambda_pointsdist": 0.1,
             "lambda_xyz": 0.0},
}
# the packed route (2 heads of 64) at 290 tokens: 2 + 2 views x 144
SP_SYSTEM = dict(SYSTEM, shape_model={"width": 128, "num_layers": 2,
                                      "patch_size": 4, "dim_heads": 64})
# two param groups, the clip active (the norms are ~0.03)
OPT = dict(lr=1e-3, grad_clip=0.01, scheduler="constant",
           params={"transformer": {"lr": 5e-4, "weight_decay": 0.1}})


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel")
    rng = np.random.default_rng(0)
    case = dict(system=SYSTEM, opt=OPT, batch=_batch(rng, b=2, res=16, v=2))
    sp_case = dict(system=SP_SYSTEM, opt=OPT,
                   batch=_batch(rng, b=2, res=48, v=2))
    refs = {"ddp": train_steps(case, None, 2, slice(0, 2)),
            "one": train_steps(case, None, 1, slice(0, 2),
                               save=str(tmp / "one")),
            "sp2": train_steps(sp_case, None, 1, slice(0, 2))}
    root, img = make_gobjaverse_tree(tmp, np.random.default_rng(1), res=32,
                                     uids=("000/obj1", "000/obj2"))
    cfg = tmp / "tiny.yaml"
    cfg.write_text(TINY_CFG.format(out=tmp / "outputs", root=root, img=img))
    argv = ["--config", str(cfg), "--train", "--max_steps", "2", "--device",
            "cpu", "--dist-backend", "gloo", "trainer.zero1=true"]
    inputs = dict(case=case, sp_case=sp_case, save_dir=str(tmp / "zero1"),
                  one_dir=str(tmp / "one"), launch=argv,
                  launch_tp=argv[:-1] + ["trainer.model_parallel=2",
                                         "tag=tp"])
    outs = run_world(parallel_cases, 2, tmp / "world", inputs)
    return dict(refs=refs, outs=outs, tmp=tmp, cfg=str(cfg))


def _close(got, want, **tol):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   err_msg=k, **tol)


def _equal(got, want):
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def _change_close(got, want, init):
    """rel-max 1e-2 of each tensor's change from `init`."""
    assert set(got) == set(want)
    for k in want:
        scale = float((want[k] - init[k]).abs().max())
        err = float((got[k] - want[k]).abs().max())
        assert err <= 1e-2 * scale + 1e-12, f"{k}: {err:.3g} of {scale:.3g}"


def _matches_one_process(outs, ref, key, case):
    init = dict(build_tiny_system(case).model.named_parameters())
    init = {k: v.detach() for k, v in init.items()}
    for i, m in enumerate(ref["metrics"]):
        loss = np.mean([o[key]["metrics"][i]["loss"] for o in outs])
        np.testing.assert_allclose(loss, m["loss"], rtol=1e-5)
        for o in outs:
            np.testing.assert_allclose(o[key]["metrics"][i]["grad_norm"],
                                       m["grad_norm"], rtol=1e-4)
    for o in outs:
        _change_close(o[key]["params"], ref["params"], init)
        _change_close(o[key]["ema"], ref["ema"], init)


def test_ddp_step_equals_one_process(world):
    _matches_one_process(world["outs"], world["refs"]["ddp"], "ddp",
                         dict(system=SYSTEM))
    a, b = world["outs"]
    _equal(a["ddp"]["params"], b["ddp"]["params"])   # ranks stay equal


def test_zero1_equals_ddp_bit_for_bit(world):
    for o in world["outs"]:
        ddp, z = o["ddp"], o["zero1"]
        assert z["zero1"] and not ddp["zero1"]
        for key in ("params", "ema", "mu", "nu"):
            _equal(z[key], ddp[key])
        assert [m["grad_norm"] for m in z["metrics"]] == \
            [m["grad_norm"] for m in ddp["metrics"]]
        assert [m["loss"] for m in z["metrics"]] == \
            [m["loss"] for m in ddp["metrics"]]
    # the EMA lives as half-size shards on each rank (as do the moments)
    n = sum(p.numel() for p in world["outs"][0]["ddp"]["params"].values())
    shard = sum(t.numel() for t in world["outs"][0]["zero1"]["shard"])
    assert n / 2 <= shard < n / 2 + 2 * 128


def _one_process_state(case):
    system = build_tiny_system(case)
    params = dict(system.model.named_parameters())
    opt = ts.make_optimizer(ts.OptimizerConfig(**OPT), params.items())
    return ts.init_train_state(params, opt, ema_decay=0.9)


def test_zero1_checkpoint_restores_on_one_process(world):
    z = world["outs"][0]["zero1"]
    state = _one_process_state(dict(system=SYSTEM))
    CheckpointManager(str(world["tmp"] / "zero1")).restore(state)
    assert state.step == 2 and state.optimizer.count == 2
    _equal(state.params, z["params"])
    _equal(state.ema_params, z["ema"])
    sd = state.optimizer.state_dict()
    _equal(sd["mu"], z["mu"])
    _equal(sd["nu"], z["nu"])


def test_one_process_checkpoint_restores_under_zero1(world):
    one = world["refs"]["one"]
    for o in world["outs"]:
        r = o["resume"]
        assert r["zero1"] and r["count"] == 1
        for key in ("params", "ema", "mu", "nu"):
            _equal(r[key], one[key])


def test_seq_parallel_step_equals_one_process(world):
    _matches_one_process(world["outs"], world["refs"]["sp2"], "sp2",
                         dict(system=SP_SYSTEM))


def test_two_process_launch_train(world):
    _launch_restores(world, "launch")


def test_two_process_launch_train_tensor_parallel(world):
    """trainer.model_parallel=2: the checkpoint holds the whole tensors."""
    _launch_restores(world, "launch_tp")


def _launch_restores(world, key):
    from open_diffusiongs_tpu_torch import _register_builtins
    from open_diffusiongs_tpu_torch.systems.builder import (
        build_optimizer_config, build_system)
    from open_diffusiongs_tpu_torch.utils.config import load_config
    r0, r1 = (o[key] for o in world["outs"])
    assert r1["writes"] == []
    assert r0["trial_dir"] == r1["trial_dir"] and r0["step"] == 2
    trial = r0["trial_dir"]
    assert {"cmd.txt", "parsed.yaml", "metrics.csv",
            "ckpts"} <= set(os.listdir(trial))
    assert os.listdir(os.path.join(trial, "ckpts")) == ["2.pt"]
    steps = [row.split(",")[0] for row in
             open(os.path.join(trial, "metrics.csv")).read().split()[1:]]
    assert steps == ["1", "2"]
    _register_builtins()
    cfg = load_config(world["cfg"], makedirs=False)
    system = build_system(cfg.system_type, cfg.system, bf16=False)
    system.init_params(torch.Generator().manual_seed(0))
    params = dict(system.model.named_parameters())
    opt = ts.make_optimizer(build_optimizer_config(cfg.system,
                                                   dict(cfg.trainer)),
                            params.items())
    state = ts.init_train_state(params, opt, ema_decay=0.9999)
    CheckpointManager(os.path.join(trial, "ckpts")).restore(state)
    assert state.step == 2
    _equal(state.params, r0["params"])
    _equal(state.ema_params, r0["ema"])
    _equal(state.optimizer.state_dict()["mu"], r0["mu"])


def test_rank_layout_and_backend_rules(monkeypatch):
    """Ranks d·sp + s: one ring per data row, one gradient group per seq
    column; nccl refuses more local ranks than cards and names the flag;
    gloo shares a card."""
    from open_diffusiongs_tpu_torch.parallel import mesh
    groups = mesh.axis_groups(8, sp=4)
    assert groups["seq"] == [[0, 1, 2, 3], [4, 5, 6, 7]]
    assert groups["data"] == [[0, 4], [1, 5], [2, 6], [3, 7]]
    one = mesh.Mesh(world=8, rank=6, sp=4)
    assert (one.dp, one.data_rank, one.seq_rank) == (2, 1, 2)
    assert mesh.default_backend(torch.device("cpu")) == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="--dist-backend gloo"):
        mesh.rank_device("cuda", 1, 2, "nccl")
    assert mesh.rank_device("cuda", 1, 2, "gloo") == torch.device("cuda", 0)
    assert mesh.rank_device("cpu", 1, 2, None) == torch.device("cpu")
    assert mesh.local_batch_slice(4, one) == slice(2, 4)
    assert mesh.eval_shard_indices(5, mesh=one) == [1, 3]


@pytest.mark.parametrize("dp", [2, 3])
def test_zero1_shard_is_the_flat_bucket_shard(dp):
    """`_Flat.shard_of` copies only a shard's range, and equals the shard
    of the whole flat bucket bit for bit (tensors straddling a shard edge,
    the zero padding of the last shard)."""
    gen = torch.Generator().manual_seed(3)
    tensors = [torch.randn(s, generator=gen)
               for s in ((7, 5), (300,), (3, 3, 3), (129,))]
    lay = ts._Flat(tensors, dp)
    flat = lay.flatten(tensors)
    for r in range(dp):
        got = lay.shard_of(tensors, r)
        assert torch.equal(got, lay.shard(flat, r))
        assert got.data_ptr() != flat.data_ptr()
