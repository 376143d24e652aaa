"""Scene evaluation metric CLI on the GPU: the port of eval_scene_result.py.

Loads the result packages dumped by the scene system's
save_result_for_eval (render_images [v, 3, h, w] + image [v_in, 3, h, w]),
computes chunked PSNR / SSIM / LPIPS through systems/losses.py and writes
eval_result.json (reference eval_scene_result.py:9-56).

--protocol reference (default) compares ALL saved views against GT —
including the conditioning view 0 — like the reference CLI (:22-37), so
numbers are comparable to the published RE10K 21.26/0.672/0.257.
--protocol strict excludes the conditioning view (novel views only).

  python -m open_diffusiongs_tpu_torch.eval_scene_result \
      --result_dir outputs/.../save/it0 [--protocol reference|strict] \
      [--chunk 16] [--lpips-weights lpips_vgg.npz] [--device cpu]

Reads the port's and the JAX package's `.npz` dumps, and the reference's
`.pt` dumps through torch.load(weights_only=True) (the JAX module reads
them with its own torch-free unpickler).  Runs on the GPU unless
`--device cpu`; LPIPS is left out without `--lpips-weights`.
"""

from __future__ import annotations

import argparse
import glob
import json
import os

import numpy as np


def load_result(path: str):
    """(render_images, image) of one dump, as float32 NumPy."""
    if path.endswith(".pt"):
        import torch
        d = torch.load(path, map_location="cpu", weights_only=True)
        return (np.asarray(d["render_images"].float()),
                np.asarray(d["image"].float()))
    with np.load(path) as d:
        return (np.asarray(d["render_images"], np.float32),
                np.asarray(d["image"], np.float32))


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--result_dir", required=True)
    p.add_argument("--protocol", choices=("reference", "strict"),
                   default="reference")
    p.add_argument("--chunk", type=int, default=16)
    p.add_argument("--lpips-weights", default=None)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a GPU) or cpu")
    args = p.parse_args(argv)

    import torch

    from . import select_device
    from .systems import losses as L

    device = select_device(args.device)
    files = sorted(glob.glob(os.path.join(args.result_dir, "*.npz"))
                   + glob.glob(os.path.join(args.result_dir, "*.pt")))
    assert files, f"no .npz/.pt results in {args.result_dir}"
    lpips_params = (L.lpips_init_params(args.lpips_weights, device=device)
                    if args.lpips_weights else None)
    if lpips_params is None:
        print("[warn] no --lpips-weights: LPIPS omitted from results")

    lo = 0 if args.protocol == "reference" else 1
    gts, preds = [], []
    for fp in files:
        render, gt = load_result(fp)     # [v, 3, h, w] (incl. view 0)
        v = min(render.shape[0], gt.shape[0])
        preds.append(render[lo:v])
        gts.append(gt[lo:v])
    preds = np.concatenate(preds)
    gts = np.concatenate(gts)
    print(f"{len(files)} scenes, {len(preds)} views ({args.protocol})")

    psnrs, ssims, lpipss = [], [], []
    with torch.no_grad():
        for i in range(0, len(preds), args.chunk):
            m = L.compute_metrics(
                torch.from_numpy(gts[i:i + args.chunk]).to(device),
                torch.from_numpy(preds[i:i + args.chunk]).to(device),
                lpips_params)
            psnrs.append(m["psnr"].cpu().numpy())
            ssims.append(m["ssim"].cpu().numpy())
            if "lpips" in m:
                lpipss.append(m["lpips"].cpu().numpy())
    result = {
        "psnr": float(np.concatenate(psnrs).mean()),
        "ssim": float(np.concatenate(ssims).mean()),
        "num_scenes": len(files),
        "num_views": int(len(preds)),
        "protocol": args.protocol,
    }
    if lpipss:
        result["lpips"] = float(np.concatenate(lpipss).mean())
    out_path = os.path.join(args.result_dir, "eval_result.json")
    with open(out_path, "w") as f:
        json.dump(result, f, indent=2)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
