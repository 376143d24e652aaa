"""Assemble a pretrained directory for `DiffusionGSPipeline.from_pretrained`
and `run --ckpt` from reference weights.

  python -m open_diffusiongs_tpu_torch.tools.make_pretrained_dir \\
      --config configs/diffusionGS_rel_512.yaml \\
      --weights obj_ckpt_512.ckpt --out pretrained/obj_512 [--device cpu]

Counterpart of tools/make_pretrained_dir.py.  `--weights` is a reference
torch checkpoint (.ckpt / .pt / .pth, Lightning layout or a bare state
dict) or the NPZ of tools/convert_reference_ckpt.py; every parameter of
the config's denoiser must be in it.  The directory holds `config.yaml`
and `ckpts/<step>.pt`: a TrainState at step 0 whose params and EMA are
the weights, under the config's own optimizer (so a training run can
resume from it).  Runs on the GPU unless `--device cpu`.
"""

from __future__ import annotations

import argparse
import os
import shutil


def make_pretrained_dir(config: str, weights: str, out: str,
                        device=None) -> str:
    """Write `out`/config.yaml and `out`/ckpts/0.pt; returns `out`."""
    import torch

    from .. import select_device
    from ..parallel.train_step import init_train_state, make_optimizer
    from ..systems.builder import build_optimizer_config, build_system
    from ..utils.checkpoint import CheckpointManager, load_module_weights
    from ..utils.config import load_config

    dev = select_device(device)
    cfg = load_config(config, makedirs=False)
    system = build_system(cfg.system_type, cfg.system, bf16=False,
                          device=dev)
    system.init_params(torch.Generator(device=dev).manual_seed(0))
    load_module_weights(system.model, weights, strict=True)
    params = dict(system.model.named_parameters())
    optimizer = make_optimizer(
        build_optimizer_config(cfg.system, dict(cfg.trainer)), params.items())
    state = init_train_state(params, optimizer, ema_decay=0.9999)
    os.makedirs(out, exist_ok=True)
    shutil.copy2(config, os.path.join(out, "config.yaml"))
    CheckpointManager(os.path.join(out, "ckpts")).maybe_save(state,
                                                             force=True)
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--config", required=True)
    p.add_argument("--weights", required=True,
                   help="reference .ckpt/.pt/.pth or the NPZ of "
                        "tools/convert_reference_ckpt.py")
    p.add_argument("--out", required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    make_pretrained_dir(args.config, args.weights, args.out, args.device)
    print(f"pretrained dir ready: {args.out}")


if __name__ == "__main__":
    main()
