"""RE10K preprocessing CLI: pixelSplat `.torch` chunks -> per-frame PNGs,
per-scene metadata JSON and `full_list.txt`.

  python -m open_diffusiongs_tpu_torch.process_data \\
      --base_path <pixelSplat re10k dir> --output_dir <dir> \\
      [--mode train|test] [--num_processes N]

Counterpart of the root `process_data.py` (the reference's
process_data.py:31-185), with the same layout, names and flags:

  {output_dir}/{mode}/images/{scene}/{idx:05d}.png
  {output_dir}/{mode}/metadata/{scene}.json
      {"scene_name", "frames": [{"image_path", "fxfycxcy" (pixels),
                                 "w2c" (4x4)}]}
  {output_dir}/{mode}/full_list.txt

A chunk is a torch-saved list of scenes, each with "key", "images" (JPEG
bytes as uint8 tensors) and "cameras" rows [fx, fy, cx, cy (normalized),
2 unused, 12 w2c entries] (process_data.py:97-106).  Chunks load with
`torch.load(weights_only=True)`: tensors, strings and containers only.
PIL decodes the JPEG bytes and writes the PNGs.  Runs on the host.
"""

from __future__ import annotations

import argparse
import io
import json
import logging
import os
import time

import numpy as np
import torch

log = logging.getLogger(__name__)


def process_torch_file(file_path: str, output_dir: str) -> bool:
    """One chunk's scenes into `output_dir`/images and /metadata; False if
    the chunk does not load (a frame that fails is logged and skipped)."""
    from PIL import Image

    images_dir = os.path.join(output_dir, "images")
    meta_dir = os.path.join(output_dir, "metadata")
    os.makedirs(images_dir, exist_ok=True)
    os.makedirs(meta_dir, exist_ok=True)
    try:
        data = torch.load(file_path, map_location="cpu", weights_only=True)
    except Exception as e:
        log.error(f"Error loading {file_path}: {e}")
        return False

    for scene in data:
        scene_name = scene["key"]
        if hasattr(scene_name, "item"):
            scene_name = scene_name.item()
        seq_dir = os.path.join(images_dir, str(scene_name))
        os.makedirs(seq_dir, exist_ok=True)
        frames = []
        cameras = scene["cameras"]
        for idx, img_data in enumerate(scene["images"]):
            try:
                if hasattr(img_data, "numpy"):
                    img_data = img_data.numpy()
                img = Image.open(io.BytesIO(img_data.tobytes()))
                w, h = img.size
                img_path = os.path.join(seq_dir, f"{idx:05d}.png")
                img.save(img_path)

                pose = cameras[idx]
                if hasattr(pose, "tolist"):
                    pose = pose.tolist()
                fx, fy, cx, cy = (float(pose[0]) * w, float(pose[1]) * h,
                                  float(pose[2]) * w, float(pose[3]) * h)
                w2c = np.asarray(pose[6:], np.float32).reshape(3, 4)
                w2c = np.vstack([w2c, [0, 0, 0, 1]])
                frames.append({"image_path": img_path,
                               "fxfycxcy": [fx, fy, cx, cy],
                               "w2c": w2c.tolist()})
            except Exception as e:
                log.error(f"Error processing image {idx} in {file_path}: "
                          f"{e}")
        with open(os.path.join(meta_dir, f"{scene_name}.json"), "w") as f:
            json.dump({"scene_name": scene_name, "frames": frames}, f,
                      indent=4)
    return True


def process_directory(input_dir: str, output_dir: str,
                      num_processes: int = 0) -> None:
    """Every `.torch` chunk of `input_dir`, in name order; `num_processes`
    > 1 spreads the chunks over a process pool."""
    files = sorted(os.path.join(input_dir, f) for f in os.listdir(input_dir)
                   if f.endswith(".torch"))
    log.info(f"Found {len(files)} files in {input_dir}")
    t0 = time.time()
    if num_processes > 1:
        import multiprocessing as mp
        with mp.Pool(num_processes) as pool:
            results = pool.starmap(process_torch_file,
                                   [(f, output_dir) for f in files])
    else:
        results = [process_torch_file(f, output_dir) for f in files]
    ok = sum(bool(r) for r in results)
    log.info(f"Processed {ok}/{len(files)} files in "
             f"{time.time() - t0:.1f}s")


def generate_full_list(meta_dir: str, output_dir: str) -> str:
    """`output_dir`/full_list.txt: the absolute paths of the metadata JSONs,
    sorted, one a line."""
    json_files = sorted(os.path.abspath(os.path.join(meta_dir, f))
                        for f in os.listdir(meta_dir) if f.endswith(".json"))
    path = os.path.join(output_dir, "full_list.txt")
    with open(path, "w") as f:
        f.write("\n".join(json_files) + "\n")
    return path


def main(argv=None) -> str:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--mode", default="train", choices=["train", "test"])
    parser.add_argument("--num_processes", type=int, default=0)
    parser.add_argument("--output_dir", required=True)
    parser.add_argument("--base_path", required=True)
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s - %(levelname)s - %(message)s")
    input_dir = os.path.join(args.base_path, args.mode)
    output_dir = os.path.join(args.output_dir, args.mode)
    process_directory(input_dir, output_dir, args.num_processes)
    path = generate_full_list(os.path.join(output_dir, "metadata"),
                              output_dir)
    log.info("Full list generated!")
    return path


if __name__ == "__main__":
    main()
