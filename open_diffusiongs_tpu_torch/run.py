"""Single image -> 3D Gaussians on the GPU (the port of run.py).

  python -m open_diffusiongs_tpu_torch.run --ckpt <dir with config.yaml +
      ckpts/> --image input.png --matting border --extract-mesh --out output/

Writes gaussians.ply, input_processed.png, render_<i>.png and, with
`--extract-mesh`, mesh.obj.  `--matting u2net` (the default, as in JAX)
reads converted U²-Net weights from $U2NET_NPZ (and the variant from
$U2NET_SPEC) and raises without them.

`--ckpt` takes a pretrained directory (the port's
tools/make_pretrained_dir.py makes one from a reference checkpoint or its
NPZ).  Without it the object model of `--config` runs from random init
(plus the config's own weight bootstraps, if it sets any): a smoke test of
the sampling path, not a quality result.  Runs on the GPU unless
`--device cpu`.
"""

from __future__ import annotations

import argparse
import logging
import os

import numpy as np
from PIL import Image

CONFIG = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs", "diffusionGS_rel.yaml")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--image", required=True, nargs="+",
                   help="one or more input images (sampled as one batch)")
    p.add_argument("--ckpt", default=None,
                   help="pretrained dir (config.yaml + ckpts/); random "
                        "weights if omitted")
    p.add_argument("--config", default=CONFIG,
                   help="the config of a run without --ckpt")
    p.add_argument("--out", default="output")
    p.add_argument("--seed", type=int, default=62)
    p.add_argument("--foreground-ratio", type=float, default=0.825)
    p.add_argument("--resolution", type=int, default=256)
    p.add_argument("--extract-mesh", action="store_true",
                   help="also write mesh.obj (density field on the device, "
                        "native iso-surface and clean-up)")
    p.add_argument("--matting", default="u2net",
                   choices=["u2net", "grabcut", "border"],
                   help="background removal; u2net (reference parity) "
                        "needs a converted weights NPZ at $U2NET_NPZ — pass "
                        "grabcut/border to acknowledge the fallback")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a GPU) or cpu")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")

    import torch

    from open_diffusiongs_tpu_torch import select_device
    from open_diffusiongs_tpu_torch.pipeline import DiffusionGSPipeline
    from open_diffusiongs_tpu_torch.systems.builder import build_system
    from open_diffusiongs_tpu_torch.utils.config import load_config

    if args.ckpt:
        pipe = DiffusionGSPipeline.from_pretrained(args.ckpt,
                                                   device=args.device)
    else:
        device = select_device(args.device)
        cfg = load_config(args.config, makedirs=False)
        system = build_system(cfg.system_type, cfg.system, device=device)
        logging.warning("no --ckpt: random init (smoke-test mode)")
        system.init_params(torch.Generator(device=device).manual_seed(0))
        system.load_pretrained()
        pipe = DiffusionGSPipeline(system)

    multi = len(args.image) > 1
    subdirs = [os.path.join(args.out, os.path.splitext(
                   os.path.basename(im))[0]) if multi else args.out
               for im in args.image]
    for d in subdirs:
        os.makedirs(d, exist_ok=True)
    outs = pipe.batch(args.image, seed=args.seed,
                      foreground_ratio=args.foreground_ratio,
                      resolution=args.resolution, matting=args.matting,
                      extract_mesh=args.extract_mesh,
                      save_ply=[os.path.join(d, "gaussians.ply")
                                for d in subdirs])

    def save_png(path, chw):
        img = np.clip(np.moveaxis(chw, 0, -1), 0.0, 1.0)
        Image.fromarray((img * 255.0 + 0.5).astype(np.uint8)).save(path)

    for d, out in zip(subdirs, outs):
        save_png(os.path.join(d, "input_processed.png"), out.input_image)
        for i in range(out.renders.shape[0]):
            save_png(os.path.join(d, f"render_{i}.png"), out.renders[i])
        if out.mesh is not None:
            from open_diffusiongs_tpu_torch.ops.mesh import save_mesh_obj
            save_mesh_obj(os.path.join(d, "mesh.obj"), *out.mesh)
        print(f"saved outputs to {d}/ ({out.gaussians.xyz.shape[0]} "
              f"gaussians, overflow {out.stats})")


if __name__ == "__main__":
    main()
