"""Generate a multi-view-consistent synthetic RealEstate10K-convention
dataset, rendered by the port's own rasterizer.

  python -m open_diffusiongs_tpu_torch.tools.make_synthetic_re10k \\
      --out outputs/synth_re10k [--scenes 8] [--frames 48] [--res 256] \\
      [--seed 0] [--wall-step 0.18] [--lobes 10] [--device cuda]

Counterpart of tools/make_synthetic_re10k.py (whose `--cpu` is
`--device cpu` here): the same rooms, trajectories, numpy draws (in the
same order) and files.  A ground-truth 3DGS room per scene (five
wallpapered box walls and floating coloured lobes, so every ray hits
geometry as in a real interior) is viewed along a forward dolly with
gentle lateral sway and yaw, the RE10K camera statistics.

data/re10k.py normalises the chosen frames' poses by a rigid mean-camera
alignment and a translation scale 1/s.  A rigid transform of all cameras
is one of the scene, and scaling camera translations by 1/s gives the
images of the whole scene (positions and sizes) scaled by 1/s, so every
normalised sample stays consistent with one scene.

Layout written (what data/re10k.py reads):
  out/images/synthscene{S:03d}/{F:05d}.png   RGB frames
  out/meta/synthscene{S:03d}.json            {scene_name, frames: [{
                                               image_path, fxfycxcy, w2c}]}
  out/full_list.txt                          one metadata path per line

Frames render with generous capacities (D = 256 tile slots, K = 4096
candidates a tile): exactness over speed, and both overflow counters
must read 0.  Renders run on the GPU (raises without one) unless
`--device cpu`.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from ..ops.gaussians import Gaussians

# Room box (world units, OpenCV world: x right, y DOWN, z forward).
ROOM_X, ROOM_Y, ROOM_Z = 3.0, 2.0, 8.0
FOCAL_REL = 1.4          # fx = fy = 1.4 * res -> ~39 deg FOV, RE10K-like
MAX_TILES_PER_GAUSSIAN, MAX_PER_TILE = 256, 4096
CHUNK_VIEWS = 8


def look_at_c2w(origin: np.ndarray, target: np.ndarray) -> np.ndarray:
    """OpenCV c2w (x right, y down, z forward), world down = +y."""
    z = target - origin
    z = z / np.linalg.norm(z)
    x = np.cross(np.asarray([0.0, 1.0, 0.0]), z)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = x, y, z, origin
    return c2w


def trajectory(rng: np.random.Generator, n: int) -> np.ndarray:
    """Forward dolly with lateral sway + drifting look-at (c2w [n,4,4])."""
    phase = rng.uniform(0, 2 * np.pi, 3)
    amp_x = rng.uniform(0.1, 0.3)
    amp_y = rng.uniform(0.05, 0.12)
    span = rng.uniform(1.8, 2.6)                 # forward travel
    c2ws = []
    for i in range(n):
        u = i / max(n - 1, 1)
        origin = np.asarray([
            amp_x * np.sin(2 * np.pi * u + phase[0]),
            amp_y * np.sin(4 * np.pi * u + phase[1]),
            span * u])
        target = origin + np.asarray([
            0.5 * np.sin(2 * np.pi * u + phase[2]),
            0.15 * np.cos(2 * np.pi * u + phase[1]),
            3.0])
        c2ws.append(look_at_c2w(origin, target))
    return np.stack(c2ws).astype(np.float64)


def _wallpaper(pts: np.ndarray, base: np.ndarray,
               freqs: np.ndarray, phases: np.ndarray) -> np.ndarray:
    """Smooth per-point color pattern so walls carry learnable structure."""
    s = np.stack([np.sin(pts @ freqs[c] + phases[c]) for c in range(3)],
                 axis=-1)
    return np.clip(base + 0.25 * s, 0.05, 0.95)


def make_room(rng: np.random.Generator, step: float = 0.18,
              n_lobes: int = 10, per: int = 160):
    """GT Gaussians: 5 box walls + floating lobes (raw-param Gaussians)."""
    planes = []
    # back wall z=ROOM_Z; side walls x=+-ROOM_X; floor/ceiling y=+-ROOM_Y
    gx = np.arange(-ROOM_X, ROOM_X + 1e-6, step)
    gy = np.arange(-ROOM_Y, ROOM_Y + 1e-6, step)
    gz = np.arange(-0.5, ROOM_Z + 1e-6, step)
    xx, yy = np.meshgrid(gx, gy, indexing="ij")
    planes.append(np.stack([xx, yy, np.full_like(xx, ROOM_Z)], -1)
                  .reshape(-1, 3))
    zz, yy2 = np.meshgrid(gz, gy, indexing="ij")
    for sx in (-ROOM_X, ROOM_X):
        planes.append(np.stack([np.full_like(zz, sx), yy2, zz], -1)
                      .reshape(-1, 3))
    xx2, zz2 = np.meshgrid(gx, gz, indexing="ij")
    for sy in (-ROOM_Y, ROOM_Y):
        planes.append(np.stack([xx2, np.full_like(xx2, sy), zz2], -1)
                      .reshape(-1, 3))
    wall_xyz = np.concatenate(planes) + rng.normal(0, 0.02, (1, 3))

    base = rng.uniform(0.25, 0.75, 3)
    freqs = rng.uniform(-2.2, 2.2, (3, 3))
    phases = rng.uniform(0, 2 * np.pi, 3)
    wall_rgb = _wallpaper(wall_xyz, base, freqs, phases)
    n_w = len(wall_xyz)
    wall_scale = np.log(np.full((n_w, 3), 0.6 * step))

    # floating furniture lobes, kept off the camera corridor
    centers = np.stack([rng.uniform(-2.0, 2.0, n_lobes),
                        rng.uniform(-1.4, 1.4, n_lobes),
                        rng.uniform(1.5, 7.0, n_lobes)], -1)
    centers[:, 0] += np.sign(centers[:, 0] + 1e-3) * 0.6
    which = np.repeat(np.arange(n_lobes), per)
    lobe_xyz = centers[which] + rng.normal(0, 0.18, (n_lobes * per, 3))
    lobe_base = rng.uniform(0.1, 0.9, (n_lobes, 3))
    lobe_rgb = np.clip(lobe_base[which]
                       + rng.normal(0, 0.06, (n_lobes * per, 3)), 0.02, 0.98)
    lobe_scale = np.log(rng.uniform(0.04, 0.10, (n_lobes * per, 3)))

    xyz = np.concatenate([wall_xyz, lobe_xyz])
    rgb = np.concatenate([wall_rgb, lobe_rgb])
    scaling = np.concatenate([wall_scale, lobe_scale])
    n = len(xyz)
    sh0 = (rgb - 0.5) / 0.28209479177387814      # RGB2SH, degree 0
    return Gaussians(
        xyz=xyz.astype(np.float32)[None],
        features=sh0.astype(np.float32)[None, :, None, :],
        scaling=scaling.astype(np.float32)[None],
        rotation=np.tile(np.asarray([1.0, 0, 0, 0], np.float32),
                         (n, 1))[None],
        opacity=np.full((1, n, 1), 3.0, np.float32))  # sigmoid -> 0.95


def render_scene(gauss, c2ws: np.ndarray, res: int, device="cuda"):
    """Render every frame of `gauss` (numpy fields, as `make_room` makes
    them) on `device`, CHUNK_VIEWS frames a call; returns (rgb [F,h,w,3]
    numpy f32, counters): overflow_tiles / overflow_gaussians /
    binned_entries summed over the chunks."""
    import torch

    from ..ops.rasterize import RasterizeConfig, render

    f = FOCAL_REL * res
    v = len(c2ws)
    fxy = np.tile(np.asarray([f, f, res / 2.0, res / 2.0], np.float32),
                  (1, v, 1))
    cfg = RasterizeConfig(max_tiles_per_gaussian=MAX_TILES_PER_GAUSSIAN,
                          max_per_tile=MAX_PER_TILE)
    dev = torch.device(device)
    g = Gaussians(*(torch.from_numpy(np.asarray(x)).to(dev) for x in gauss))
    c2w_t = torch.from_numpy(c2ws[None].astype(np.float32)).to(dev)
    fxy_t = torch.from_numpy(fxy).to(dev)
    chunks = []
    counters = dict.fromkeys(("overflow_tiles", "overflow_gaussians",
                              "binned_entries"), 0)
    for lo in range(0, v, CHUNK_VIEWS):          # bound per-call memory
        with torch.no_grad():
            out = render(g, c2w_t[:, lo:lo + CHUNK_VIEWS],
                         fxy_t[:, lo:lo + CHUNK_VIEWS], res, res,
                         bg_color=(0.0, 0.0, 0.0), cfg=cfg)
        for k in counters:
            counters[k] += int(out[k])
        # over a black background the colour is already sum(w * c): alpha
        # < 1 leaks black, as a camera in this world sees it
        color = out["render"][0].permute(0, 2, 3, 1).cpu().numpy()
        chunks.append(np.clip(color, 0.0, 1.0))
    return np.concatenate(chunks), counters


def main(argv=None) -> dict:
    """Write the tree; returns (and prints as one JSON line) its summary:
    the seconds, Gaussian count and counters of each scene."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="outputs/synth_re10k")
    ap.add_argument("--scenes", type=int, default=8)
    ap.add_argument("--frames", type=int, default=48)
    ap.add_argument("--res", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--wall-step", type=float, default=0.18,
                    help="wall Gaussian spacing (bigger = fewer, for tests)")
    ap.add_argument("--lobes", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)

    from PIL import Image

    from .. import select_device

    dev = select_device(args.device)
    meta_dir = os.path.join(args.out, "meta")
    os.makedirs(meta_dir, exist_ok=True)
    rng = np.random.default_rng(args.seed)
    f = FOCAL_REL * args.res

    meta_paths, scenes = [], []
    for s in range(args.scenes):
        t0 = time.perf_counter()
        name = f"synthscene{s:03d}"
        img_dir = os.path.join(args.out, "images", name)
        os.makedirs(img_dir, exist_ok=True)
        gauss = make_room(rng, step=args.wall_step, n_lobes=args.lobes)
        c2ws = trajectory(rng, args.frames)
        rgb, counters = render_scene(gauss, c2ws, args.res, dev)
        render_s = time.perf_counter() - t0     # ends in copies to the host
        overflow = counters["overflow_tiles"] + counters["overflow_gaussians"]
        assert overflow == 0, f"capacity clipped GT renders: {counters}"
        frames = []
        for i in range(args.frames):
            p = os.path.join(img_dir, f"{i:05d}.png")
            Image.fromarray((rgb[i] * 255).astype(np.uint8)).save(p)
            w2c = np.linalg.inv(c2ws[i])
            frames.append({
                "image_path": p,
                "fxfycxcy": [f, f, args.res / 2.0, args.res / 2.0],
                "w2c": w2c.tolist()})
        mp = os.path.join(meta_dir, f"{name}.json")
        with open(mp, "w") as fh:
            json.dump({"scene_name": name, "frames": frames}, fh)
        meta_paths.append(mp)
        n_gauss = int(gauss.xyz.shape[1])
        scenes.append({"seconds": time.perf_counter() - t0,
                       "render_seconds": render_s, "n_gauss": n_gauss,
                       **counters})
        print(f"scene {s + 1}/{args.scenes} done (n_gauss={n_gauss}) "
              f"{json.dumps(counters)}", flush=True)

    full_list = os.path.join(args.out, "full_list.txt")
    with open(full_list, "w") as fh:
        fh.write("\n".join(meta_paths) + "\n")
    summary = {"out": args.out, "scenes": args.scenes,
               "frames": args.frames, "full_list": full_list,
               "device": str(dev), "per_scene": scenes}
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
