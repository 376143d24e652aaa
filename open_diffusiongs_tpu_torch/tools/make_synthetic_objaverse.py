"""Generate a multi-view-consistent synthetic GObjaverse-convention dataset,
rendered by the port's own rasterizer.

  python -m open_diffusiongs_tpu_torch.tools.make_synthetic_objaverse \\
      --out outputs/synth_obja [--objects 8] [--res 256] [--gaussians 4096] \\
      [--seed 0] [--device cuda]

Counterpart of tools/make_synthetic_objaverse.py: the same scenes, numpy
draws (in the same order), cameras and files.  A ground-truth 3DGS blob
per object, in the z-up training world frame, is viewed from the
GObjaverse camera layout (a 24-view ring at 5° elevation, three views
below, a 12-view ring at 25° and one near the top; training samples the
even-view sets 0..23 and 27..38) at radius 2.4, with the exact ray
distance where alpha > 0.25 as depth.  The loader re-anchors azimuth to
the first sampled view, a rigid rotation of every camera about the world
z axis, which is the same as rotating the scene: the views of one sample
stay views of one object.

Layout written (what data/objaverse.py reads):
  out/meta/train.json, out/meta/test.json    the uids (synth/{i:03d});
                                             test.json is for
                                             `launch --export`, which
                                             reads the test split
  out/images/{uid}/campos_512_v4/{i:05d}/{i:05d}.png      RGBA
  out/images/{uid}/campos_512_v4/{i:05d}/{i:05d}.json     raw camera
  out/images/{uid}/campos_512_v4/{i:05d}/{i:05d}_nd.exr   depth in A

Renders run on the GPU (raises without one) unless `--device cpu`.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from ..ops.gaussians import Gaussians

DIS = 2.4          # orbit radius; the loader rescales to norm_radius
FXFY = 1422.222 / 1024.0
MAX_PER_TILE = 512


def view_layout():
    """(ele, azi) per GObjaverse view index 0..39: 24-view low ring,
    indices 24-26 auxiliary, 27-38 upper ring, 39 top-down-ish — only the
    even-view sets (0..23, 27..38) are sampled by training."""
    views = {}
    for i in range(24):
        views[i] = (5.0, 15.0 * i)
    for j, i in enumerate(range(24, 27)):
        views[i] = (-45.0, 120.0 * j)
    for j, i in enumerate(range(27, 39)):
        views[i] = (25.0, 30.0 * j)
    views[39] = (85.0, 0.0)
    return views


def make_scene(rng: np.random.Generator, n: int):
    """GT Gaussian blob in the final (z-up) training world frame."""
    # cluster of soft ellipsoids: a few lobes so views differ meaningfully
    centers = rng.normal(0, 0.35, (6, 3))
    which = rng.integers(0, len(centers), n)
    xyz = centers[which] + rng.normal(0, 0.22, (n, 3))
    xyz = np.clip(xyz, -0.85, 0.85)
    # raw (pre-activation) params: scaling is log-space, opacity is logit
    scaling = np.log(rng.uniform(0.02, 0.06, (n, 3)))
    rotation = rng.normal(0, 1, (n, 4))
    opacity = rng.uniform(1.0, 3.0, (n, 1))              # sigmoid -> .73-.95
    base = rng.uniform(0.1, 0.9, (len(centers), 3))
    rgb = np.clip(base[which] + rng.normal(0, 0.08, (n, 3)), 0.02, 0.98)
    sh0 = (rgb - 0.5) / 0.28209479177387814               # RGB2SH, degree 0
    return Gaussians(
        xyz=xyz.astype(np.float32)[None],
        features=sh0.astype(np.float32)[None, :, None, :],
        scaling=scaling.astype(np.float32)[None],
        rotation=rotation.astype(np.float32)[None],
        opacity=opacity.astype(np.float32)[None])


def render_object(gauss, res: int, device="cuda", views=range(40)):
    """Render the `views` (all 40 by default) of `gauss` (numpy fields, as
    `make_scene` makes them) on `device`; returns (rgb [V,h,w,3], alpha,
    ray_depth, c2w [V,4,4], counters): numpy f32 arrays and the
    rasterizer's overflow_tiles / overflow_gaussians / binned_entries."""
    import torch

    from ..data.cameras import orbit_camera
    from ..data.objaverse import RT_MATRIX
    from ..ops.rasterize import RasterizeConfig, render
    from ..ops.rays import pixel_rays

    c2ws = []
    for i in views:
        ele, azi = view_layout()[i]
        c2w = orbit_camera(ele, azi, DIS)                 # OpenGL
        c2w[:3, 1:3] *= -1                                # -> OpenCV
        c2ws.append(RT_MATRIX @ c2w)                      # -> z-up frame
    c2w = np.stack(c2ws).astype(np.float32)[None]         # [1, V, 4, 4]
    f = FXFY * res
    fxy = np.tile(np.asarray([f, f, res / 2.0, res / 2.0], np.float32),
                  (1, len(c2ws), 1))

    dev = torch.device(device)
    g = Gaussians(*(torch.from_numpy(np.asarray(x)).to(dev) for x in gauss))
    c2w_t, fxy_t = (torch.from_numpy(a).to(dev) for a in (c2w, fxy))
    with torch.no_grad():
        out = render(g, c2w_t, fxy_t, res, res, bg_color=(0.0, 0.0, 0.0),
                     cfg=RasterizeConfig(max_per_tile=MAX_PER_TILE))
        ro, rd = pixel_rays(c2w_t[0], fxy_t[0], res, res)
    color = out["render"][0].permute(0, 2, 3, 1).cpu().numpy()  # [V,h,w,3]
    alpha = out["alpha"][0, :, 0].cpu().numpy()           # [V, h, w]
    zacc = out["depth"][0, :, 0].cpu().numpy()
    counters = {k: int(out[k]) for k in ("overflow_tiles",
                                         "overflow_gaussians",
                                         "binned_entries")}
    # un-premultiply: rasterizer color/depth are alpha-weighted sums
    a = np.maximum(alpha, 1e-6)
    rgb = np.clip(color / a[..., None], 0.0, 1.0)
    zview = zacc / a
    # view-z -> Euclidean ray distance (gt_xyz = ray_o + ray_d * depth with
    # unit ray_d, systems/object_system.py)
    fwd = c2w[0, :, :3, 2]                                # OpenCV cam +z
    cos = np.einsum("vhwc,vc->vhw", rd.cpu().numpy(), fwd)
    # threshold BELOW any mask consumer's 0.5 cut: boundary pixels whose
    # png-quantized alpha rounds above 0.5 must still carry real depth,
    # or the xyz loss sees GT points at the camera origin
    depth = np.where(alpha > 0.25, zview / np.maximum(cos, 1e-6), 0.0)
    return rgb, alpha, depth.astype(np.float32), c2w[0], counters


def write_view(prefix: str, rgb, alpha, depth, index: int) -> None:
    """One view's PNG (RGBA), camera JSON and `_nd.exr` (depth in A)."""
    from PIL import Image

    from ..data.cameras import orbit_camera
    from ..utils.exr import write_exr

    rgba = np.concatenate([rgb, alpha[..., None]], axis=-1)
    Image.fromarray((rgba * 255).astype(np.uint8), "RGBA").save(
        prefix + ".png")
    # json in the raw (Blender-ish) convention load_camera_json inverts:
    # write the OpenGL c2w back through the loader's row/col ops run in
    # reverse
    ele, azi = view_layout()[index]
    raw = orbit_camera(ele, azi, DIS)
    raw[:3, 1:3] *= -1                  # undo cols 1:3 *= -1
    raw[[1, 2]] = raw[[2, 1]]           # undo row swap
    raw[1] *= -1                        # undo row 1 negate
    with open(prefix + ".json", "w") as fh:
        json.dump({"x": raw[:3, 0].tolist(), "y": raw[:3, 1].tolist(),
                   "z": raw[:3, 2].tolist(),
                   "origin": raw[:3, 3].tolist()}, fh)
    res = depth.shape[0]
    nd = np.zeros((res, res, 4), np.float32)
    nd[..., 3] = depth
    write_exr(prefix + "_nd.exr", nd, ["R", "G", "B", "A"])


def main(argv=None) -> dict:
    """Write the tree; returns (and prints as one JSON line) its summary:
    the seconds, counters and render seconds of each object."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="outputs/synth_obja")
    ap.add_argument("--objects", type=int, default=8)
    ap.add_argument("--res", type=int, default=256)
    ap.add_argument("--gaussians", type=int, default=4096)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)

    from .. import select_device

    dev = select_device(args.device)
    root = os.path.join(args.out, "meta")
    img_dir = os.path.join(args.out, "images")
    os.makedirs(root, exist_ok=True)
    uids = [f"synth/{i:03d}" for i in range(args.objects)]
    for split in ("train", "test"):
        with open(os.path.join(root, f"{split}.json"), "w") as fh:
            json.dump(uids, fh)
    rng = np.random.default_rng(args.seed)

    objects = []
    for oi, uid in enumerate(uids):
        t0 = time.perf_counter()
        gauss = make_scene(rng, args.gaussians)
        rgb, alpha, depth, _, counters = render_object(gauss, args.res, dev)
        render_s = time.perf_counter() - t0     # ends in copies to the host
        for i in range(40):
            d = os.path.join(img_dir, uid, "campos_512_v4", f"{i:05d}")
            os.makedirs(d, exist_ok=True)
            write_view(os.path.join(d, f"{i:05d}"), rgb[i], alpha[i],
                       depth[i], i)
        objects.append({"seconds": time.perf_counter() - t0,
                        "render_seconds": render_s, **counters})
        print(f"object {oi + 1}/{args.objects} done {json.dumps(counters)}",
              flush=True)
    summary = {"out": args.out, "objects": args.objects, "res": args.res,
               "uids": uids, "device": str(dev), "per_object": objects}
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
