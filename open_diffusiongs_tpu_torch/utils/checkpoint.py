"""Checkpoint save / restore and weight loading (PyTorch).

Counterpart of open_diffusiongs_tpu/utils/checkpoint.py and of the
prefix strip of tools/convert_reference_ckpt.py::strip_prefix (:120-125).
The JAX package checkpoints with orbax; the port saves its whole
`TrainState` with `torch.save`, one file per step, `<dir>/<step>.pt`.

Weight sources (`load_weights_file`), all read into one flat
{reference dotted name: tensor} dict (the port's module names are the
reference's):
  * a torch file (`.ckpt` / `.pt` / `.pth`): a Lightning checkpoint's
    `state_dict`, else `model`, else the bare dict, with `shape_model.` or
    `denoiser.` stripped and the `loss_computer` keys dropped; or a
    checkpoint of the port (its EMA params when `use_ema` and present);
  * the NPZ of tools/convert_reference_ckpt.py ('/'-joined flax paths),
    through utils/convert.py;
  * a directory of the port's checkpoints (a pretrained dir holding
    `ckpts/`, or `ckpts/` itself): the latest step.
An orbax directory of the JAX package is refused: its way in is the
reference checkpoint or the NPZ.  Torch files are read with
`weights_only=True` and never unpickled otherwise.
"""

from __future__ import annotations

import os
import pickle
import re
import zipfile
from typing import Dict, Optional

import numpy as np
import torch

from ..parallel.shard import gather_state_dict, shard_for_mesh
from ..parallel.train_step import TrainState
from .convert import state_dict_from_flat

FORMAT = "open_diffusiongs_tpu_torch.TrainState"
_STEP_FILE = re.compile(r"^(\d+)\.pt$")
# reference checkpoints keep the denoiser under one of these prefixes
# (Lightning: pipline_obj.py:69-71; stage-1 dumps: denoiser.py:263-267)
_PREFIXES = ("shape_model.", "denoiser.")
ORBAX_MESSAGE = (
    "is an orbax checkpoint of the JAX package, which the port does not "
    "read; give the port the reference checkpoint (.ckpt) or its NPZ from "
    "tools/convert_reference_ckpt.py, and make a pretrained directory with "
    "python -m open_diffusiongs_tpu_torch.tools.make_pretrained_dir")


def _steps(directory: str) -> list:
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for m in map(_STEP_FILE.match,
                                                os.listdir(directory)) if m)


def _is_orbax(directory: str) -> bool:
    return any(name == "_CHECKPOINT_METADATA" or (
        name.isdigit() and os.path.isdir(os.path.join(directory, name)))
        for name in os.listdir(directory))


def _torch_load(path: str):
    try:
        return torch.load(path, map_location="cpu", weights_only=True,
                          mmap=zipfile.is_zipfile(path))
    except pickle.UnpicklingError as e:
        raise RuntimeError(
            f"{path}: torch.load(weights_only=True) refused an object in "
            f"the file; the port unpickles nothing else. Save the weights "
            f"alone (torch.save(ckpt['state_dict'], path)). torch said: {e}"
        ) from e


class CheckpointManager:
    """The whole TrainState (step, params, optimizer moments and count,
    EMA) saved every `every_n_train_steps` steps as `<directory>/<step>.pt`
    with `torch.save`; every periodic checkpoint is kept (the reference's
    save_top_k = -1).  `restore` copies into an existing state in place,
    bit for bit.

    With a `mesh` of several ranks every rank calls `maybe_save` (ZeRO-1's
    moment and EMA shards are gathered first, then every tensor over
    `model` and `pipe` into its whole in the reference's name,
    parallel/shard.py: collectives) and rank 0 alone writes, between
    barriers; every rank restores, cutting out its own tensor- and
    pipeline-parallel part and keeping its own ZeRO-1 shard.  The file is
    the one-rank layout either way, so a checkpoint moves across
    layouts."""

    def __init__(self, directory: str, every_n_train_steps: int = 1000,
                 mesh=None):
        self.directory = os.path.abspath(directory)
        self.mesh = mesh
        self.writes = mesh is None or mesh.is_main
        if self.writes:
            os.makedirs(self.directory, exist_ok=True)
        self.every_n = max(1, int(every_n_train_steps))

    def all_steps(self) -> list:
        return _steps(self.directory)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def maybe_save(self, state: TrainState, force: bool = False,
                   step: Optional[int] = None) -> bool:
        """Save when the step is a multiple of every_n (or `force`);
        re-saving a saved step is a no-op.  The file appears whole: it is
        written beside its name and renamed."""
        step = int(state.step if step is None else step)
        if not force and step % self.every_n != 0:
            return False
        saved = step in self.all_steps()
        self._barrier()      # every rank has looked before rank 0 writes
        if saved:
            return False
        path = os.path.join(self.directory, f"{step}.pt")

        def plain(tensors):
            return (None if tensors is None else gather_state_dict(
                {k: t.detach() for k, t in tensors.items()}, self.mesh))
        opt = state.optimizer.state_dict()
        opt.update({k: plain(opt[k]) for k in ("mu", "nu", "acc")})
        whole = {"format": FORMAT, "step": step,
                 "params": plain(state.params), "optimizer": opt,
                 "ema_params": plain(state.full_ema())}
        if self.writes:
            torch.save(whole, path + ".tmp")
            os.replace(path + ".tmp", path)
        self._barrier()
        return True

    def _barrier(self) -> None:
        if self.mesh is not None:
            self.mesh.barrier()

    def restore(self, state_like: TrainState,
                step: Optional[int] = None) -> TrainState:
        """Copy checkpoint `step` (default: the latest) into `state_like`
        in place: its params (the model's own tensors), optimizer and
        EMA.  Returns `state_like`."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        ckpt = _torch_load(os.path.join(self.directory, f"{step}.pt"))
        if (ckpt["ema_params"] is None) != (not state_like.has_ema):
            raise ValueError("checkpoint and state disagree on EMA")

        def mine(tensors):
            return (None if tensors is None else
                    shard_for_mesh(tensors, self.mesh))
        params = mine(ckpt["params"])
        with torch.no_grad():
            if set(params) != set(state_like.params):
                raise KeyError("params: checkpoint keys differ from the "
                               "state's")
            for k, t in state_like.params.items():
                t.copy_(params[k])
        if state_like.has_ema:
            state_like.load_ema(mine(ckpt["ema_params"]))
        opt = dict(ckpt["optimizer"])
        opt.update({k: mine(opt[k]) for k in ("mu", "nu", "acc")})
        state_like.optimizer.load_state_dict(opt)
        state_like.step = int(ckpt["step"])
        return state_like


def strip_prefix(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Select and strip the denoiser's prefix (the first of `shape_model.`
    and `denoiser.` that a key carries) and drop the loss_computer keys;
    a dict without either prefix is returned without them."""
    for prefix in _PREFIXES:
        out = {k[len(prefix):]: v for k, v in sd.items()
               if k.startswith(prefix) and "loss_computer" not in k}
        if out:
            return out
    return {k: v for k, v in sd.items() if "loss_computer" not in k}


def load_weights_file(path: str, use_ema: bool = True
                      ) -> Dict[str, torch.Tensor]:
    """A weight source (module docstring) -> {reference dotted name: CPU
    tensor}."""
    if os.path.isdir(path):
        d = (os.path.join(path, "ckpts")
             if os.path.isdir(os.path.join(path, "ckpts")) else path)
        steps = _steps(d)
        if not steps:
            if _is_orbax(d):
                raise ValueError(f"{path} {ORBAX_MESSAGE}")
            raise FileNotFoundError(f"no checkpoint (<step>.pt) under {path}")
        path = os.path.join(d, f"{steps[-1]}.pt")
    elif not os.path.exists(path):
        raise FileNotFoundError(f"no such weight file: {path}")
    if path.endswith(".npz"):
        with np.load(path) as data:
            return state_dict_from_flat(dict(data))
    obj = _torch_load(path)
    if isinstance(obj, dict) and obj.get("format") == FORMAT:
        use = obj["ema_params"] if use_ema else None
        return dict(obj["params"] if use is None else use)
    if isinstance(obj, dict):
        for key in ("state_dict", "model"):
            if isinstance(obj.get(key), dict):
                obj = obj[key]
                break
    if not isinstance(obj, dict):
        raise ValueError(f"{path}: expected a state dict, got "
                         f"{type(obj).__name__}")
    return strip_prefix({k: v for k, v in obj.items()
                         if isinstance(v, torch.Tensor)})


def load_module_weights(model: torch.nn.Module, source,
                        include: Optional[str] = None,
                        ignore: Optional[str] = None,
                        strict: bool = False) -> torch.nn.Module:
    """Copy matching tensors of `source` (a flat {name: tensor} dict, or a
    path for `load_weights_file`) into `model`'s state, in place, by the
    reference's dotted names (the JAX package's semantics, not
    `load_state_dict`'s):
      include / ignore: regexes searched in each target name; a target
        they filter out keeps its value;
      strict: every target not filtered out must be in the source, or
        KeyError; extra source keys are allowed either way;
      a shape mismatch always raises ValueError.  The free-Gaussian
        embedding loads across the [n, w] / [1, n, w] layouts of the two
        variants (convert_state_dict :90-91)."""
    src = load_weights_file(source) if isinstance(source, str) else source
    loaded, skipped, missing = [], [], []
    with torch.no_grad():
        for key, tgt in model.state_dict().items():
            if ((include and not re.search(include, key))
                    or (ignore and re.search(ignore, key))):
                skipped.append(key)
                continue
            if key not in src:
                missing.append(key)
                continue
            w = src[key]
            if (key == "gaussians_pos_embedding"
                    and w.squeeze(0).shape == tgt.squeeze(0).shape):
                w = w.reshape(tgt.shape)
            if w.shape != tgt.shape:
                raise ValueError(f"shape mismatch for {key}: source "
                                 f"{tuple(w.shape)} vs model "
                                 f"{tuple(tgt.shape)}")
            tgt.copy_(w)
            loaded.append(key)
    if strict and missing:
        raise KeyError(f"strict load: {len(missing)} target tensors not in "
                       f"the source, e.g. {missing[:5]}")
    print(f"[open_diffusiongs_tpu_torch] loaded {len(loaded)} tensors"
          + (f", {len(missing)} missing" if missing else "")
          + (f", {len(skipped)} filtered out" if skipped else ""))
    return model
