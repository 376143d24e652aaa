"""Fetch the published DiffusionGS scene checkpoint, lay out a pretrained
directory, and optionally run the RE10K evaluation protocol on it.

  python -m open_diffusiongs_tpu_torch.download_scene_ckpt \\
      --ckpt scene_ckpt_256.ckpt [--out scene_ckpts] \\
      [--config configs/diffusionGS_scene.yaml] [--evaluate \\
      --override data.local_eval_dir=... --protocol reference] \\
      [--device cpu]

Counterpart of the root `download_scene_ckpt.py` (the reference's
hf_hub_download of CaiYuanhao/DiffusionGS scene_ckpt_256.ckpt):
  * without `--ckpt` the file comes from the Hugging Face hub (same repo and
    filename) when `huggingface_hub` imports; otherwise the script exits 2
    and says how to run it offline;
  * the torch checkpoint goes straight to `tools/make_pretrained_dir.py`,
    which reads the reference layout, into `<out>/pretrained` (no NPZ step);
  * `--evaluate` runs `launch --validate` on it and then
    `eval_scene_result`, both in process, and prints a `PARITY_ROW` beside
    the reference's published scene_ckpt_256 numbers (21.26 dB / 0.672 /
    0.257; README.md:160-193 of the reference).
Runs on the GPU unless `--device cpu`.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO_ID = "CaiYuanhao/DiffusionGS"
FILENAME = "scene_ckpt_256.ckpt"
PUBLISHED = {"psnr": 21.26, "ssim": 0.672, "lpips": 0.257}


def fetch(out: str) -> str:
    """The checkpoint from the hub into `out`; exits 2 without
    huggingface_hub."""
    try:
        from huggingface_hub import hf_hub_download
    except ImportError:
        print("huggingface_hub is not installed (zero-egress image?).\n"
              f"Download {REPO_ID}/{FILENAME} on a connected machine and "
              "re-run:\n  python -m open_diffusiongs_tpu_torch."
              f"download_scene_ckpt --ckpt {FILENAME}", file=sys.stderr)
        raise SystemExit(2)
    os.makedirs(out, exist_ok=True)
    path = hf_hub_download(repo_id=REPO_ID, filename=FILENAME,
                           repo_type="model", cache_dir=out)
    print(f"downloaded {path}")
    return path


def evaluate(pretrained: str, overrides: list, protocol: str,
             device: str) -> dict:
    """launch --validate on the pretrained directory's weights (every val
    scene sampled, views dumped), then the metric CLI over the dumps;
    writes `eval_result.json` beside them and prints the PARITY row."""
    from . import eval_scene_result, launch
    record = launch.main(["--config", os.path.join(pretrained, "config.yaml"),
                          "--validate", "--device", device,
                          f"resume={os.path.join(pretrained, 'ckpts')}",
                          *overrides])
    result = eval_scene_result.main(["--result_dir", record["out_dir"],
                                     "--protocol", protocol,
                                     "--device", device])
    row = {"benchmark": "RE10K", "protocol": result["protocol"],
           "psnr": result.get("psnr"), "ssim": result.get("ssim"),
           "lpips": result.get("lpips"),
           "num_scenes": result.get("num_scenes"),
           "reference_published": PUBLISHED}
    print("PARITY_ROW " + json.dumps(row))
    return row


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ckpt", default=None,
                    help="already-downloaded .ckpt (skips the hub fetch)")
    ap.add_argument("--out", default="scene_ckpts",
                    help="output dir for the pretrained layout")
    ap.add_argument("--config", default="configs/diffusionGS_scene.yaml")
    ap.add_argument("--evaluate", action="store_true",
                    help="after the pretrained dir is built, run launch "
                         "--validate on it and eval_scene_result: RE10K "
                         "PSNR / SSIM (/ LPIPS with weights)")
    ap.add_argument("--override", action="append", default=[],
                    help="dotlist config override passed to launch "
                         "(repeatable), e.g. data.local_eval_dir=...")
    ap.add_argument("--protocol", choices=("reference", "strict"),
                    default="reference")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)

    from .tools.make_pretrained_dir import make_pretrained_dir
    ckpt = args.ckpt if args.ckpt is not None else fetch(args.out)
    pretrained = make_pretrained_dir(args.config, ckpt,
                                     os.path.join(args.out, "pretrained"),
                                     args.device)
    print(f"pretrained dir ready: {pretrained}")
    out = {"pretrained": pretrained}
    if args.evaluate:
        out["parity_row"] = evaluate(pretrained, args.override,
                                     args.protocol, args.device)
    return out


if __name__ == "__main__":
    main()
