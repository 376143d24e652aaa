"""The port's weight loading and checkpoints (utils/checkpoint.py).

A checkpoint in the reference's names loads into the port's DGSDenoiser
bit for bit from each of its three sources: a Lightning-style torch file,
the NPZ of tools/convert_reference_ckpt.py and a directory of the port's
own checkpoints.  `load_module_weights` keeps the JAX package's semantics
(open_diffusiongs_tpu/utils/checkpoint.py:115-163): strict raises KeyError
on a missing target, a shape mismatch raises ValueError, extra source keys
are allowed, filtered targets keep their values.  A TrainState restores
bit for bit.  What the port cannot read raises: an orbax directory, a
torch file that `weights_only` refuses.
"""

import argparse
import os
import sys

import numpy as np
import pytest
import torch

from open_diffusiongs_tpu_torch.models.denoiser import DGSDenoiser
from open_diffusiongs_tpu_torch.parallel import train_step as tts
from open_diffusiongs_tpu_torch.utils import checkpoint as ck
from torch_reference_weights import reference_state_dict, save_lightning_ckpt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
from convert_reference_ckpt import convert_state_dict  # noqa: E402

TINY = dict(width=64, num_layers=2, patch_size=8, dim_heads=32)


def _model(seed=0, **kw):
    model = DGSDenoiser(**dict(TINY, **kw))
    model.init_weights(torch.Generator().manual_seed(seed))
    return model


def _state(model, accumulate=1):
    params = dict(model.named_parameters())
    opt = tts.make_optimizer(tts.OptimizerConfig(
        lr=1e-3, accumulate_grad_batches=accumulate), params.items())
    return tts.init_train_state(params, opt, ema_decay=0.9)


def _save_port_dir(sd, tmp_path):
    model = _model()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    ck.CheckpointManager(str(tmp_path / "pre" / "ckpts")).maybe_save(
        _state(model), force=True)
    return str(tmp_path / "pre")


SOURCES = {
    "lightning_ckpt": lambda sd, tmp: save_lightning_ckpt(
        sd, tmp / "model.ckpt"),
    "denoiser_prefix_pt": lambda sd, tmp: save_lightning_ckpt(
        sd, tmp / "stage1.pt", prefix="denoiser."),
    "converted_npz": lambda sd, tmp: (
        np.savez(tmp / "w.npz", **convert_state_dict(sd)),
        str(tmp / "w.npz"))[1],
    "port_ckpts_dir": _save_port_dir,
}


@pytest.mark.parametrize("source", sorted(SOURCES))
def test_reference_names_load_bit_for_bit(source, tmp_path, rng):
    sd = reference_state_dict(rng)
    path = SOURCES[source](sd, tmp_path)
    model = _model(seed=5)
    ck.load_module_weights(model, path, strict=True)
    state = model.state_dict()
    assert set(state) == set(sd)
    for name, value in state.items():
        assert torch.equal(value, torch.from_numpy(sd[name])), name


def test_strict_load_raises_on_a_missing_key(rng):
    src = {k: torch.from_numpy(v) for k, v in reference_state_dict(rng).items()}
    src.pop("transformer.1.mlp.fc2.bias")
    with pytest.raises(KeyError, match="transformer.1.mlp.fc2.bias"):
        ck.load_module_weights(_model(), src, strict=True)
    # non-strict: the missing target keeps its value, the rest load
    model = _model()
    before = model.transformer[1].mlp.fc2.bias.detach().clone()
    ck.load_module_weights(model, src, strict=False)
    assert torch.equal(model.transformer[1].mlp.fc2.bias, before)
    assert torch.equal(model.transformer[0].attn.qkv.weight,
                       src["transformer.0.attn.qkv.weight"])


def test_a_shape_mismatch_raises(rng):
    src = {k: torch.from_numpy(v) for k, v in reference_state_dict(rng).items()}
    src["upsampler.linear.weight"] = torch.zeros(15, 64)
    for strict in (True, False):
        with pytest.raises(ValueError, match="upsampler.linear.weight"):
            ck.load_module_weights(_model(), src, strict=strict)


def test_extra_source_keys_are_allowed_under_strict(rng):
    src = {k: torch.from_numpy(v) for k, v in reference_state_dict(rng).items()}
    src["transformer.9.attn.qkv.weight"] = torch.zeros(3)
    ck.load_module_weights(_model(), src, strict=True)


def test_ignore_keeps_the_ignored_module(rng):
    src = {k: torch.from_numpy(v) for k, v in reference_state_dict(rng).items()}
    model = _model()
    init = {k: v.clone() for k, v in model.state_dict().items()}
    ck.load_module_weights(model, src, ignore=r"^(?:upsampler|t_embedder)(\.|$)")
    for name, value in model.state_dict().items():
        kept = name.startswith(("upsampler.", "t_embedder."))
        assert torch.equal(value, init[name] if kept else src[name]), name


def test_scene_embedding_loads_across_layouts(rng):
    """The NPZ keeps the free-Gaussian embedding as [n, w]; the scene
    variant's model holds [1, n, w] (convert_state_dict :90-91)."""
    src = {k: torch.from_numpy(v) for k, v in reference_state_dict(rng).items()}
    model = _model(ray_pe_type="plk")
    ck.load_module_weights(model, src, strict=True)
    assert torch.equal(model.gaussians_pos_embedding,
                       src["gaussians_pos_embedding"][None])


@pytest.mark.parametrize("accumulate", [1, 2])
def test_train_state_restores_bit_for_bit(accumulate, tmp_path):
    """Step, params, Adam moments and count, the accumulator mid-window,
    and EMA; the step after the restore equals the step without one."""
    targets = {k: torch.randn(v.shape, generator=torch.Generator()
                              .manual_seed(i))
               for i, (k, v) in enumerate(_model().named_parameters())}

    def loss_fn(batch, step):
        return sum(((p - targets[k] * batch) ** 2).sum()
                   for k, p in params.items()), {}

    model = _model()
    params = dict(model.named_parameters())
    state = _state(model, accumulate)
    step = tts.make_train_step(loss_fn, state.optimizer, ema_decay=0.9)
    for batch in (1.0, 0.5, 2.0):
        state, _ = step(state, batch)
    mngr = ck.CheckpointManager(str(tmp_path / "ckpts"), 2)
    assert mngr.maybe_save(state) is False           # step 3: not due
    assert mngr.maybe_save(state, force=True) is True
    assert mngr.maybe_save(state, force=True) is False   # saved already
    assert mngr.latest_step() == 3

    fresh = _state(_model(seed=9), accumulate)
    restored = mngr.restore(fresh)
    assert restored.step == 3
    a, b = state.optimizer.state_dict(), restored.optimizer.state_dict()
    assert (a["count"], a["mini_step"]) == (b["count"], b["mini_step"])
    for store in ("mu", "nu", "acc"):
        if a[store] is None:
            assert b[store] is None
            continue
        assert set(a[store]) == set(b[store]) == set(state.params)
        for k in a[store]:
            assert torch.equal(a[store][k], b[store][k]), (store, k)
    for k in state.params:
        assert torch.equal(state.params[k], restored.params[k]), k
        assert torch.equal(state.ema_params[k], restored.ema_params[k]), k

    state, _ = step(state, 1.5)
    params = restored.params
    restored, _ = tts.make_train_step(loss_fn, restored.optimizer,
                                      ema_decay=0.9)(restored, 1.5)
    for k in state.params:
        assert torch.equal(state.params[k], restored.params[k]), k
        assert torch.equal(state.ema_params[k], restored.ema_params[k]), k


def test_ema_is_preferred_over_params(tmp_path):
    model = _model()
    state = _state(model)
    with torch.no_grad():
        for e in state.ema_params.values():
            e.add_(1.0)
    ck.CheckpointManager(str(tmp_path / "ckpts")).maybe_save(state,
                                                             force=True)
    ema = ck.load_weights_file(str(tmp_path))
    raw = ck.load_weights_file(str(tmp_path), use_ema=False)
    for k, p in model.state_dict().items():
        assert torch.equal(raw[k], p), k
        assert torch.equal(ema[k], p + 1.0), k


def test_an_orbax_directory_raises(tmp_path):
    (tmp_path / "ckpts" / "0").mkdir(parents=True)
    (tmp_path / "ckpts" / "0" / "_CHECKPOINT_METADATA").write_text("{}")
    with pytest.raises(ValueError, match="convert_reference_ckpt.py"):
        ck.load_weights_file(str(tmp_path))


def test_a_refused_pickle_raises_naming_the_global(tmp_path, rng):
    sd = reference_state_dict(rng)
    path = tmp_path / "hparams.ckpt"
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in sd.items()},
                "hyper_parameters": argparse.Namespace(lr=1e-5)}, str(path))
    with pytest.raises(RuntimeError, match="argparse.Namespace"):
        ck.load_weights_file(str(path))
