"""The one traffic generator: seeded inputs from a traffic file's numbers.

Images are cut-outs as users hand them in: RGBA of `image_size` squared
pixels, an object of smooth random colour inside a rotated superellipse
of random size and place, alpha 255 inside and 0 outside with a soft rim.
Every seed gives the same sizes; only the content and its order change.
"""

from __future__ import annotations

import numpy as np


def rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & (2 ** 63 - 1), *stream])


def cutout(r: np.random.Generator, size: int) -> np.ndarray:
    """One [size, size, 4] uint8 cut-out."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    cx, cy = r.uniform(0.4, 0.6, 2)
    ax, ay = r.uniform(0.18, 0.38, 2)
    th = r.uniform(0, np.pi)
    ex = r.uniform(1.5, 4.0)
    dx, dy = xx - cx, yy - cy
    u = (np.cos(th) * dx + np.sin(th) * dy) / ax
    v = (-np.sin(th) * dx + np.cos(th) * dy) / ay
    rad = (np.abs(u) ** ex + np.abs(v) ** ex) ** (1.0 / ex)
    alpha = np.clip((1.0 - rad) * size * 0.05, 0.0, 1.0)
    rgb = np.zeros((size, size, 3), np.float32)
    for c in range(3):
        f = r.uniform(1.0, 6.0, (4, 2))
        ph = r.uniform(0, 2 * np.pi, 4)
        amp = r.uniform(0.05, 0.25, 4)
        field = r.uniform(0.2, 0.8) + sum(
            a * np.sin(2 * np.pi * (fx * xx + fy * yy) + p)
            for (fx, fy), p, a in zip(f, ph, amp))
        rgb[..., c] = field
    rgb = np.clip(rgb + r.normal(0, 0.02, rgb.shape), 0, 1)
    return np.concatenate([rgb * 255, alpha[..., None] * 255], -1).round(
        ).astype(np.uint8)


def cutouts(seed: int, n: int, size: int) -> list:
    """`n` cut-outs drawn from `seed`."""
    return [cutout(rng(seed, 1, i), size) for i in range(n)]


def _look_at(eye: "torch.Tensor"):
    """c2w [..., 4, 4] (OpenCV, z-up world) of cameras at `eye` looking at
    the origin."""
    import torch
    z = -eye / torch.linalg.norm(eye, dim=-1, keepdim=True)
    up = torch.zeros_like(z)
    up[..., 2] = 1.0
    x = torch.linalg.cross(z, up)
    x = x / torch.linalg.norm(x, dim=-1, keepdim=True)
    y = torch.linalg.cross(z, x)
    c2w = torch.zeros(eye.shape[:-1] + (4, 4), device=eye.device)
    c2w[..., :3, 0], c2w[..., :3, 1], c2w[..., :3, 2] = x, y, z
    c2w[..., :3, 3] = eye
    c2w[..., 3, 3] = 1.0
    return c2w


def train_batches(seed: int, n: int, b: int, views_in: int, views: int,
                  res: int, device) -> list:
    """`n` training batches of `b` objects drawn on the card from the
    seed, in the loader's layout (data/objaverse.py): `views` posed views
    a sample, the first `views_in` of them the input.  Each object is a
    sphere of radius 0.35-0.7 at the origin with a smooth random colour
    field, seen on a white background from cameras at radius 3 looking at
    it: input views at evenly spaced azimuths, the rest at random ones,
    elevations in [-10, 30] degrees; depth is the distance along each
    pixel's unit ray to the sphere (0 where it misses), masks where it
    meets it; the
    G-Objaverse focal (1422.222 / 1024 of the side)."""
    import torch
    gen = torch.Generator(device=device).manual_seed(int(seed) + 1)

    def u(*shape, lo=0.0, hi=1.0):
        return lo + (hi - lo) * torch.rand(shape, generator=gen,
                                           device=device)

    f = 1422.222 / 1024.0 * res
    fxy = torch.tensor([f, f, res / 2.0, res / 2.0], device=device)
    yy, xx = torch.meshgrid(torch.arange(res, device=device).float(),
                            torch.arange(res, device=device).float(),
                            indexing="ij")
    d_cam = torch.stack([(xx + 0.5 - res / 2.0) / f,
                         (yy + 0.5 - res / 2.0) / f,
                         torch.ones_like(xx)], -1)           # [h, w, 3]
    out = []
    for _ in range(n):
        base = u(b, 1, hi=2 * np.pi)
        azi = torch.cat([base + torch.arange(views_in, device=device)
                         * (2 * np.pi / views_in),
                         u(b, views - views_in, hi=2 * np.pi)], 1)
        ele = u(b, views, lo=np.radians(-10.0), hi=np.radians(30.0))
        eye = 3.0 * torch.stack([torch.cos(ele) * torch.cos(azi),
                                 torch.cos(ele) * torch.sin(azi),
                                 torch.sin(ele)], -1)
        c2w = _look_at(eye)                                  # [b, v, 4, 4]
        rad = u(b, 1, 1, 1, lo=0.35, hi=0.7)
        freq = u(b, 3, 3, lo=1.0, hi=4.0)
        phase = u(b, 1, 1, 1, 3, lo=0.0, hi=2 * np.pi)
        # rays through pixel centres; distance to the sphere along them
        d = torch.einsum("hwc,bvdc->bvhwd", d_cam, c2w[..., :3, :3])
        dn = d / torch.linalg.norm(d, dim=-1, keepdim=True)
        o = c2w[..., None, None, :3, 3]
        od = (o * dn).sum(-1)
        disc = od * od - ((o * o).sum(-1) - rad ** 2)
        hit = disc > 0
        tt = torch.where(hit, -od - torch.sqrt(torch.clamp(disc, min=0.0)),
                         torch.zeros_like(od))
        p = o + tt[..., None] * dn                           # [b, v, h, w, 3]
        col = 0.5 + 0.4 * torch.sin(torch.einsum("bvhwk,bkc->bvhwc", p, freq)
                                    + phase)
        rgb = torch.where(hit[..., None], col, torch.ones_like(col))
        depth = tt
        mask = hit.float()
        bt = {"rgbs": rgb.permute(0, 1, 4, 2, 3).contiguous(),
              "masks": mask[:, :, None].contiguous(),
              "depths": depth[:, :, None].contiguous(),
              "c2ws": c2w.contiguous(),
              "fxfycxcys": fxy.expand(b, views, 4).contiguous()}
        for k in list(bt):
            bt[k + "_input"] = bt[k][:, :views_in].contiguous()
        out.append(bt)
    return out
