"""Plain reference of the DiffusionGS object model and its image->3D path.

Float32 PyTorch with TF32 off, no kernels, no caches, written from the
published model (Open-DiffusionGS: models/denoiser/denoiser.py, the DiT of
utils_transformer.py, the diff-gaussian-rasterization forward) and frozen
here: it imports nothing of the measured program.

  * `param_shapes` / `embed`, `blocks`, `gaussians` (`dit_forward`): the
    posed-image DiT (relative Plücker ray embedding, 8x8 patches, 2 free
    Gaussian tokens, adaLN blocks with exact softmax attention and a
    tanh-GELU MLP, two adaLN heads, hard pixel alignment) on the
    reference's state-dict names; `r=fp8` rounds every product's
    operands to float8 e4m3 (the precision control);
  * `render`: 16x16-tile splatting with the program's capacity semantics
    (D tile slots a Gaussian with the centred rect clip, K candidates a
    tile, the farthest dropped), blended front to back in chunks of 32
    candidates with in-chunk prefix products, differentiable;
  * `train_loss`, `lpips`, `adamw`: the object training step (x0 MSE,
    LPIPS-VGG16, the masked xyz term; AdamW with global-norm clipping and
    the cosine learning rate);
  * `schedule`: the spaced cosine DDPM schedule of the sampler (x0
    prediction, fixed-large variance);
  * `turntable_cameras`, `pixel_rays`, `preprocess_rgba`,
    `filter_gaussians`: the pipeline's camera template, rays,
    cut-out preprocessing and export filters.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from PIL import Image
from torch.utils.checkpoint import checkpoint

TILE = 16
NEAR_CULL_Z = 0.2
ZNEAR, ZFAR = 0.01, 100.0
EARLY_STOP_T = 1e-4
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
CHUNK = 32
ATTN_ROWS = 2048          # query rows a block of the exact attention


def no_tf32() -> None:
    """Full f32 products on the card (the reference's precision)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# --------------------------------------------------------------------------
# The DiT
# --------------------------------------------------------------------------

def gs_channels(sh_degree: int = 0) -> int:
    return 3 + (sh_degree + 1) ** 2 * 3 + 3 + 4 + 1


def param_shapes(sm: dict) -> Dict[str, Tuple[int, ...]]:
    """Names and shapes of the denoiser's parameters for a `shape_model`
    block of the config."""
    d = sm["width"]
    p = sm["patch_size"]
    n = sm["n_gaussians"]
    ch = gs_channels(sm.get("gaussians_sh_degree", 0))
    out = {
        "gaussians_pos_embedding": (n, d),
        "image_tokenizer.1.weight": (d, sm["in_channels"] * p * p),
        "t_embedder.mlp.0.weight": (d, 256), "t_embedder.mlp.0.bias": (d,),
        "t_embedder.mlp.2.weight": (d, d), "t_embedder.mlp.2.bias": (d,),
        "transformer_input_layernorm.weight": (d,),
    }
    for i in range(sm["num_layers"]):
        pre = f"transformer.{i}."
        out.update({
            pre + "attn.qkv.weight": (3 * d, d),
            pre + "attn.qkv.bias": (3 * d,),
            pre + "attn.proj.weight": (d, d), pre + "attn.proj.bias": (d,),
            pre + "mlp.fc1.weight": (4 * d, d), pre + "mlp.fc1.bias": (4 * d,),
            pre + "mlp.fc2.weight": (d, 4 * d), pre + "mlp.fc2.bias": (d,),
            pre + "adaLN_modulation.1.weight": (6 * d, d),
            pre + "adaLN_modulation.1.bias": (6 * d,),
        })
    for head, rows in (("upsampler", ch), ("image_token_decoder", p * p * ch)):
        out.update({
            head + ".adaLN_modulation.1.weight": (2 * d, d),
            head + ".adaLN_modulation.1.bias": (2 * d,),
            head + ".layernorm.weight": (d,),
            head + ".linear.weight": (rows, d),
        })
    return out


def _timestep_embedding(t: torch.Tensor, dim: int = 256) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], -1)


def _norm(x: torch.Tensor, eps: float) -> torch.Tensor:
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps)


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale for the tensor (amax onto
    448), back in f32: the operand of an fp8 product; its gradient passes
    straight through the rounding."""
    s = torch.clamp(x.detach().abs().amax(), min=1e-30) / 448.0
    q = (x.detach() / s).to(torch.float8_e4m3fn).float() * s
    return x + (q - x.detach())


def _same(x):
    return x


def _attention(q, k, v, r=_same) -> torch.Tensor:
    """Exact softmax attention on [b, l, h, dh] f32, in blocks of query
    rows so that the scores fit; `r` rounds the products' operands."""
    scale = q.shape[-1] ** -0.5
    kt = r(k.permute(0, 2, 3, 1))                # [b, h, dh, l]
    vv = r(v.permute(0, 2, 1, 3))                # [b, h, l, dh]
    q = r(q)
    out = torch.empty_like(q)
    for r0 in range(0, q.shape[1], ATTN_ROWS):
        qb = q[:, r0:r0 + ATTN_ROWS].permute(0, 2, 1, 3)
        s = torch.softmax(torch.matmul(qb, kt) * scale, dim=-1)
        out[:, r0:r0 + ATTN_ROWS] = torch.matmul(r(s), vv).permute(0, 2, 1,
                                                                   3)
    return out


def _linear(x, W, name, bias=True, r=_same):
    y = torch.matmul(r(x), r(W[name + ".weight"]).t())
    return y + W[name + ".bias"] if bias else y


def product(W, name: str, x, r=_same):
    """One Linear of the model (`name` without .weight) on x."""
    return _linear(x, W, name, bias=name + ".bias" in W, r=r)


class Embedded(NamedTuple):
    x: torch.Tensor          # [b, L, d] the blocks' input
    silu_t: torch.Tensor     # [b, d] SiLU of the timestep embedding
    o_dot_d: torch.Tensor    # [b, v, 1, h, w]


def embed(W, sm: dict, images, ray_o, ray_d, t, r=_same) -> Embedded:
    """images [b, v, 3, h, w] in [0, 1] (view 0 the clean condition); rays
    [b, v, 3, h, w]; t [b] model timesteps -> the blocks' input tokens
    (free Gaussian tokens, then the views' 8x8 patches of the relative
    Plücker-posed images) after the input LayerNorm."""
    b, v, _, h, w = images.shape
    d, p, n = sm["width"], sm["patch_size"], sm["n_gaussians"]
    o_dot_d = torch.sum(-ray_o * ray_d, dim=2, keepdim=True)
    posed = torch.cat([images * 2.0 - 1.0, ray_d, ray_o + o_dot_d * ray_d], 2)
    c = posed.shape[2]
    patches = (posed.reshape(b, v, c, h // p, p, w // p, p)
               .permute(0, 1, 3, 5, 4, 6, 2).reshape(b, -1, p * p * c))
    tokens = _linear(patches, W, "image_tokenizer.1", bias=False, r=r)
    temb = _linear(F.silu(_linear(_timestep_embedding(t), W,
                                  "t_embedder.mlp.0", r=r)), W,
                   "t_embedder.mlp.2", r=r)
    g_pos = W["gaussians_pos_embedding"].reshape(n, d)
    x = torch.cat([g_pos[None].expand(b, n, d), tokens], 1)
    x = _norm(x, 1e-5) * W["transformer_input_layernorm.weight"]
    return Embedded(x, F.silu(temb), o_dot_d)


def _block(W, sm: dict, i: int, x, silu_t, r=_same) -> torch.Tensor:
    b, _, d = x.shape
    heads = d // sm["dim_heads"]
    pre = f"transformer.{i}."
    mod = _linear(silu_t, W, pre + "adaLN_modulation.1", r=r).chunk(6, -1)
    sh_a, sc_a, g_a, sh_m, sc_m, g_m = (m[:, None, :] for m in mod)
    y = _norm(x, 1e-6) * (1.0 + sc_a) + sh_a
    qkv = _linear(y, W, pre + "attn.qkv", r=r)
    q, k, vv = (z.reshape(b, -1, heads, d // heads) for z in qkv.chunk(3, -1))
    o = _attention(q, k, vv, r).reshape(b, -1, d)
    x = x + g_a * _linear(o, W, pre + "attn.proj", r=r)
    y = _norm(x, 1e-6) * (1.0 + sc_m) + sh_m
    y = F.gelu(_linear(y, W, pre + "mlp.fc1", r=r), approximate="tanh")
    return x + g_m * _linear(y, W, pre + "mlp.fc2", r=r)


def blocks(W, sm: dict, x, silu_t, r=_same, remat: bool = False
           ) -> torch.Tensor:
    """The adaLN DiT blocks on [b, L, d] tokens; `remat` recomputes each
    block in the backward instead of keeping its activations."""
    for i in range(sm["num_layers"]):
        if remat:
            x = checkpoint(functools.partial(_block, W, sm, i, r=r), x,
                           silu_t, use_reentrant=False)
        else:
            x = _block(W, sm, i, x, silu_t, r)
    return x


def gaussians(W, sm: dict, x, e: Embedded, ray_o, ray_d, r=_same
              ) -> Dict[str, torch.Tensor]:
    """The two adaLN heads on the blocks' output, the Gaussian activations'
    raw offsets and hard pixel alignment: the raw Gaussians {xyz [b, N, 3],
    features [b, N, 1, 3], scaling [b, N, 3], rotation [b, N, 4], opacity
    [b, N, 1]}, N = n_gaussians + v h w."""
    b, v, _, h, w = ray_o.shape
    p, n = sm["patch_size"], sm["n_gaussians"]

    def head(name, z):
        shift, scale = _linear(e.silu_t, W, name + ".adaLN_modulation.1",
                               r=r).chunk(2, -1)
        z = (_norm(z, 1e-5) * W[name + ".layernorm.weight"]
             * (1.0 + scale[:, None]) + shift[:, None])
        return _linear(z, W, name + ".linear", bias=False, r=r)

    ch = gs_channels(sm.get("gaussians_sh_degree", 0))
    all_gs = torch.cat([head("upsampler", x[:, :n]),
                        head("image_token_decoder", x[:, n:]
                             ).reshape(b, -1, ch)], 1)
    xyz, feats, scaling, rotation, opacity = torch.split(
        all_gs, [3, ch - 11, 3, 4, 1], dim=2)
    scaling = torch.clamp(scaling + sm.get("gs_raw_offset_scaling", 0.0)
                          - 2.3, max=-1.2)
    opacity = opacity + sm.get("gs_raw_offset_opacity", 0.0) - 2.0
    # hard pixel alignment: each pixel Gaussian sits on its ray at a depth
    # from the mean of its three xyz outputs
    hh, ww = h // p, w // p
    pix = (xyz[:, n:].reshape(b, v, hh, ww, p, p, 3)
           .permute(0, 1, 6, 2, 4, 3, 5).reshape(b, v, 3, h, w))
    depth = ((2.0 * torch.sigmoid(pix.mean(2, keepdim=True)) - 1.0)
             * 1.8 + e.o_dot_d)
    pix = ray_o + depth * ray_d
    pts = (pix.reshape(b, v, 3, hh, p, ww, p).permute(0, 1, 3, 5, 4, 6, 2)
           .reshape(b, -1, 3))
    return {"xyz": torch.cat([xyz[:, :n], pts], 1),
            "features": feats.reshape(b, feats.shape[1], -1, 3),
            "scaling": scaling, "rotation": rotation, "opacity": opacity,
            "pix_xyz": pix}


def dit_forward(W, sm: dict, images, ray_o, ray_d, t, r=_same):
    """The whole denoiser: embed, blocks, heads."""
    e = embed(W, sm, images, ray_o, ray_d, t, r)
    return gaussians(W, sm, blocks(W, sm, e.x, e.silu_t, r), e, ray_o,
                     ray_d, r)


# --------------------------------------------------------------------------
# Cameras, rays, preprocessing, filters
# --------------------------------------------------------------------------

def turntable_cameras(n: int, radius: float, elevation_deg: float,
                      res: int, focal: float):
    """Orbit c2ws (OpenCV, z-up world) and intrinsics, f32 numpy."""
    ele = np.radians(elevation_deg)
    c2ws, fxy = [], []
    for i in range(n):
        ang = 2 * np.pi * i / n
        eye = np.asarray([radius * np.cos(ele) * np.cos(ang),
                          radius * np.cos(ele) * np.sin(ang),
                          radius * np.sin(ele)], np.float64)
        z = -eye / np.linalg.norm(eye)
        x = np.cross(z, np.asarray([0.0, 0.0, 1.0]))
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        c2w = np.eye(4)
        c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = x, y, z, eye
        c2ws.append(c2w)
        fxy.append([focal, focal, res / 2.0, res / 2.0])
    return (np.stack(c2ws).astype(np.float32),
            np.asarray(fxy, np.float32))


def object_cameras(n_views: int, res: int):
    """The 4-view object template: radius 3, elevation 5 degrees, the
    G-Objaverse focal 1422.222 / 1024 of the resolution."""
    return turntable_cameras(n_views, 3.0, 5.0, res, 1422.222 / 1024.0 * res)


def pixel_rays(c2w: torch.Tensor, fxy: torch.Tensor, h: int, w: int):
    """World rays through pixel centres, [..., 3, h, w] each; unit ray_d."""
    dev = c2w.device
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev),
                            indexing="ij")
    fx, fy, cx, cy = (fxy[..., i, None, None] for i in range(4))
    d_cam = torch.stack([(xx + 0.5 - cx) / fx, (yy + 0.5 - cy) / fy,
                         torch.ones_like(xx + cx)], -1)
    d = torch.einsum("...hwc,...dc->...hwd", d_cam, c2w[..., :3, :3])
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    o = c2w[..., None, None, :3, 3].expand(d.shape)
    return o.movedim(-1, -3), d.movedim(-1, -3)


def preprocess_rgba(rgba: np.ndarray, size: int,
                    foreground_ratio: float = 0.85) -> np.ndarray:
    """A cut-out [H, W, 4] uint8 image -> [3, size, size] f32 in [0, 1]:
    composite on white, crop to the alpha > 0.5 box, resize (Lanczos) to
    `foreground_ratio` of the side and centre on a white square."""
    rgb = rgba[..., :3]
    alpha = rgba[..., 3].astype(np.float32) / 255.0
    mask = alpha > 0.5
    if not mask.any():
        mask = np.ones_like(alpha, dtype=bool)
    ys, xs = np.nonzero(mask)
    y0, y1, x0, x1 = ys.min(), ys.max() + 1, xs.min(), xs.max() + 1
    fa = alpha[y0:y1, x0:x1]
    comp = (rgb[y0:y1, x0:x1].astype(np.float32) * fa[..., None]
            + 255.0 * (1.0 - fa[..., None]))
    h, w = comp.shape[:2]
    s = int(size * foreground_ratio) / max(h, w)
    nh, nw = max(1, int(round(h * s))), max(1, int(round(w * s)))
    img = Image.fromarray(comp.astype(np.uint8)).resize((nw, nh),
                                                        Image.LANCZOS)
    canvas = np.full((size, size, 3), 255, np.uint8)
    oy, ox = (size - nh) // 2, (size - nw) // 2
    canvas[oy:oy + nh, ox:ox + nw] = np.asarray(img)
    return canvas.transpose(2, 0, 1).astype(np.float32) / 255.0


def filter_gaussians(g: Dict[str, np.ndarray], opacity_thres: float,
                     bbx) -> Dict[str, np.ndarray]:
    """Export filters: keep opacity sigmoid > thres, then the box."""
    keep = 1.0 / (1.0 + np.exp(-g["opacity"][..., 0])) > opacity_thres
    g = {k: x[keep] for k, x in g.items()}
    x0, x1, y0, y1, z0, z1 = bbx
    p = g["xyz"]
    keep = ((p[:, 0] >= x0) & (p[:, 0] <= x1) & (p[:, 1] >= y0)
            & (p[:, 1] <= y1) & (p[:, 2] >= z0) & (p[:, 2] <= z1))
    return {k: x[keep] for k, x in g.items()}


# --------------------------------------------------------------------------
# The sampler's schedule
# --------------------------------------------------------------------------

class Schedule(NamedTuple):
    coef1: np.ndarray        # posterior mean coefficient of x0
    coef2: np.ndarray        # ... of x_t
    sigma: np.ndarray        # exp(0.5 log fixed-large variance)
    timestep_map: np.ndarray


def schedule(steps: int, train_steps: int = 1000) -> Schedule:
    """The squaredcos_cap_v2 schedule respaced to `steps` evenly spread
    timesteps; tables rounded to f32 as the sampler keeps them."""
    def abar(t):
        return math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2
    betas = np.array([min(1 - abar((i + 1) / train_steps)
                          / abar(i / train_steps), 0.999)
                      for i in range(train_steps)], np.float64)
    frac, cur, use = (train_steps - 1) / (steps - 1), 0.0, set()
    for _ in range(steps):
        use.add(round(cur))
        cur += frac
    acp = np.cumprod(1.0 - betas)
    last, nb, tmap = 1.0, [], []
    for i, a in enumerate(acp):
        if i in use:
            nb.append(1 - a / last)
            last = a
            tmap.append(i)
    b = np.array(nb)
    acp = np.cumprod(1.0 - b)
    acp_prev = np.append(1.0, acp[:-1])
    post_var = b * (1.0 - acp_prev) / (1.0 - acp)
    fl_var = np.append(post_var[1], b[1:])
    f = np.float32
    return Schedule(
        coef1=(b * np.sqrt(acp_prev) / (1.0 - acp)).astype(f),
        coef2=((1.0 - acp_prev) * np.sqrt(1.0 - b) / (1.0 - acp)).astype(f),
        sigma=np.exp(0.5 * np.log(fl_var).astype(f)).astype(f),
        timestep_map=np.asarray(tmap, np.int64))


# --------------------------------------------------------------------------
# The rasterizer
# --------------------------------------------------------------------------

def _camera(c2w: torch.Tensor, fxy: torch.Tensor, h: int, w: int):
    w2c = torch.linalg.inv(c2w)
    fx, fy, cx, cy = fxy.unbind(-1)
    proj = torch.zeros((4, 4), dtype=torch.float32, device=c2w.device)
    proj[0, 0], proj[0, 2] = 2.0 * fx / w, 2.0 * (cx / w) - 1.0
    proj[1, 1], proj[1, 2] = 2.0 * fy / h, 2.0 * (cy / h) - 1.0
    proj[2, 2] = -(ZFAR + ZNEAR) / (ZFAR - ZNEAR)
    proj[2, 3] = -(2.0 * ZFAR * ZNEAR) / (ZFAR - ZNEAR)
    proj[3, 2] = 1.0
    tanfov = torch.stack([w / (2.0 * fx), h / (2.0 * fy)])
    return w2c, torch.matmul(proj, w2c), c2w[:3, 3], tanfov


def _cov3d(scale, rot):
    """Sigma = R S S R^T as (xx, xy, xz, yy, yz, zz), forward.cu's order."""
    r, x, y, z = rot.unbind(-1)
    m = torch.stack([
        torch.stack([1.0 - 2.0 * (y * y + z * z), 2.0 * (x * y - r * z),
                     2.0 * (x * z + r * y)], -1),
        torch.stack([2.0 * (x * y + r * z), 1.0 - 2.0 * (x * x + z * z),
                     2.0 * (y * z - r * x)], -1),
        torch.stack([2.0 * (x * z - r * y), 2.0 * (y * z + r * x),
                     1.0 - 2.0 * (x * x + y * y)], -1)], -2)
    m = m * scale[..., None, :]
    m0, m1, m2 = m[..., 0, :], m[..., 1, :], m[..., 2, :]
    return torch.stack([(m0 * m0).sum(-1), (m0 * m1).sum(-1),
                        (m0 * m2).sum(-1), (m1 * m1).sum(-1),
                        (m1 * m2).sum(-1), (m2 * m2).sum(-1)], -1)


def _preprocess(g, cov, cam, fxy, h, w):
    """Screen-space means, depth, conic, colour, tile rect and validity of
    every Gaussian in one view, in forward.cu's order of operations."""
    w2c, full, cam_pos, tanfov = cam
    p = g["xyz"]
    px, py, pz = p[:, 0], p[:, 1], p[:, 2]

    def row(m, i):
        return m[i, 0] * px + m[i, 1] * py + m[i, 2] * pz + m[i, 3]

    depth = row(w2c, 2)
    in_front = depth > NEAR_CULL_Z
    rcp_w = 1.0 / (torch.where(in_front, row(full, 3), 1.0) + 1e-7)
    xy = torch.stack([((row(full, 0) * rcp_w + 1.0) * w - 1.0) * 0.5,
                      ((row(full, 1) * rcp_w + 1.0) * h - 1.0) * 0.5], -1)
    W = w2c[:3, :3]
    t_x, t_y = row(w2c, 0), row(w2c, 1)
    t_z = torch.where(depth > NEAR_CULL_Z, depth, 1.0)
    limx, limy = 1.3 * tanfov[0], 1.3 * tanfov[1]
    tx = torch.minimum(torch.maximum(t_x / t_z, -limx), limx) * t_z
    ty = torch.minimum(torch.maximum(t_y / t_z, -limy), limy) * t_z
    fx, fy = fxy[0], fxy[1]
    a0, a2 = fx / t_z, -(fx * tx) / (t_z * t_z)
    b1, b2 = fy / t_z, -(fy * ty) / (t_z * t_z)
    T0 = [a0 * W[0, k] + a2 * W[2, k] for k in range(3)]
    T1 = [b1 * W[1, k] + b2 * W[2, k] for k in range(3)]
    cxx, cxy, cxz, cyy, cyz, czz = cov.unbind(-1)

    def quad(u, v):
        return (u[0] * (cxx * v[0] + cxy * v[1] + cxz * v[2])
                + u[1] * (cxy * v[0] + cyy * v[1] + cyz * v[2])
                + u[2] * (cxz * v[0] + cyz * v[1] + czz * v[2]))

    a, bb, c = quad(T0, T0) + 0.3, quad(T0, T1), quad(T1, T1) + 0.3
    det = a * c - bb * bb
    det_ok = det != 0.0
    det_inv = torch.where(det_ok, 1.0 / torch.where(det_ok, det, 1.0), 0.0)
    conic = torch.stack([c * det_inv, -bb * det_inv, a * det_inv], -1)
    mid = 0.5 * (a + c)
    disc = torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radius = torch.ceil(3.0 * torch.sqrt(torch.maximum(mid + disc,
                                                       mid - disc)))
    tiles_x, tiles_y = -(-w // TILE), -(-h // TILE)
    rect = torch.stack([
        torch.clamp(torch.floor((xy[:, 0] - radius) / TILE), 0, tiles_x),
        torch.clamp(torch.floor((xy[:, 1] - radius) / TILE), 0, tiles_y),
        torch.clamp(torch.floor((xy[:, 0] + radius + TILE - 1) / TILE), 0,
                    tiles_x),
        torch.clamp(torch.floor((xy[:, 1] + radius + TILE - 1) / TILE), 0,
                    tiles_y)], -1).long()
    nonempty = (rect[:, 2] - rect[:, 0]) * (rect[:, 3] - rect[:, 1]) > 0
    color = torch.clamp(0.28209479177387814 * g["features"][:, 0] + 0.5,
                        min=0.0)
    return xy, depth, conic, color, rect, in_front & det_ok & nonempty


def _clip_center(rect, xy, valid, d_slots):
    """Rects over D tiles shrink to a centred window of <= D tiles."""
    x0, y0, x1, y1 = rect.unbind(-1)
    rw, rh = x1 - x0, y1 - y0
    area = rw * rh
    over = valid & (area > d_slots)
    s = torch.sqrt(d_slots / torch.clamp(area, min=1).float())
    cw = torch.minimum(torch.clamp((rw.float() * s).long(), min=1),
                       torch.clamp(rw, max=d_slots))
    ch = torch.minimum(torch.clamp((rh.float() * s).long(), min=1), rh)
    ch = torch.minimum(torch.clamp(torch.minimum(
        ch, d_slots // torch.clamp(cw, min=1)), min=1), rh)

    def centre(coord, lo, hi):
        t = torch.clamp(torch.floor(coord / TILE), -2.0 ** 30, 2.0 ** 30)
        return torch.minimum(torch.maximum(t.long(), lo), hi - 1)

    nx0 = torch.minimum(torch.maximum(centre(xy[:, 0], x0, x1) - cw // 2, x0),
                        x1 - cw)
    ny0 = torch.minimum(torch.maximum(centre(xy[:, 1], y0, y1) - ch // 2, y0),
                        y1 - ch)
    return torch.where(over[:, None],
                       torch.stack([nx0, ny0, nx0 + cw, ny0 + ch], -1), rect)


def _bin(rect, depth, valid, tiles_x, tiles_y, d_slots, k_cap):
    """[T, K] candidate rows per tile in (tile, depth) order, the farthest
    beyond K dropped; sentinel N past each tile's count."""
    n = depth.shape[0]
    dev = depth.device
    T = tiles_x * tiles_y
    x0, y0 = rect[:, 0], rect[:, 1]
    rw, rh = rect[:, 2] - x0, rect[:, 3] - y0
    slot = torch.arange(d_slots, device=dev)[:, None]
    rws = torch.clamp(rw, min=1)
    tile = (y0 + slot // rws) * tiles_x + (x0 + slot % rws)
    tile = torch.where((slot < rw * rh) & valid, tile, T).reshape(-1)
    order = torch.argsort(depth, stable=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(n, device=dev)
    row = torch.arange(n, device=dev).repeat(d_slots)
    # sort by tile, then by depth rank (lexicographic: two stable sorts)
    o1 = torch.argsort(rank.repeat(d_slots), stable=True)
    o2 = torch.argsort(tile[o1], stable=True)
    perm = o1[o2]
    tile_s, row_s = tile[perm], row[perm]
    counts_raw = torch.bincount(tile_s, minlength=T + 1)[:T]
    starts = torch.cumsum(counts_raw, 0) - counts_raw
    k_ar = torch.arange(k_cap, device=dev)
    pos = torch.clamp(starts[:, None] + k_ar[None], max=row_s.numel() - 1)
    counts = torch.clamp(counts_raw, max=k_cap)
    idx = torch.where(k_ar[None] < counts[:, None], row_s[pos], n)
    return idx, counts


def _blend(rows, idx, counts, tiles_x):
    """Front-to-back alpha blend per pixel over its tile's candidates:
    alpha = min(0.99, o exp(power)), skipped below 1/255 or at power > 0;
    a pixel stops before the candidate that would take its transmittance
    under 1e-4.  Returns (T_final [T, 256], colour [T, 256, 3])."""
    T, K = idx.shape
    dev = rows.device
    t = torch.arange(T, device=dev)[:, None]
    lp = torch.arange(TILE * TILE, device=dev)[None]
    px = ((t % tiles_x) * TILE + lp % TILE).float()
    py = ((t // tiles_x) * TILE + lp // TILE).float()
    tr = torch.ones((T, TILE * TILE), dtype=torch.float32, device=dev)
    done = torch.zeros_like(tr, dtype=torch.bool)
    acc = torch.zeros((T, TILE * TILE, 3), dtype=torch.float32, device=dev)
    kmax = int(counts.max()) if T else 0
    for c0 in range(0, kmax, CHUNK):
        kc = min(CHUNK, K - c0)
        a = rows[idx[:, c0:c0 + kc]][:, :, None, :]        # [T, kc, 1, 9]
        dx = a[..., 0] - px[:, None]
        dy = a[..., 1] - py[:, None]
        power = (-0.5 * (a[..., 2] * dx * dx + a[..., 4] * dy * dy)
                 - a[..., 3] * dx * dy)
        alpha = torch.clamp(a[..., 8] * torch.exp(power), max=ALPHA_MAX)
        slot = c0 + torch.arange(kc, device=dev)
        skip = ((slot[None] >= counts[:, None])[..., None] | (power > 0.0)
                | (alpha < ALPHA_MIN))
        one_minus = 1.0 - torch.where(skip, 0.0, alpha)
        excl = torch.cat([torch.ones_like(one_minus[:, :1]),
                          torch.cumprod(one_minus, 1)[:, :-1]], 1)
        t_before = tr[:, None] * excl
        viol = ~skip & (t_before * (1.0 - alpha) < EARLY_STOP_T)
        earlier = (torch.cumsum(viol.int(), 1) - viol.int()) > 0
        contrib = ~skip & ~viol & ~earlier & ~done[:, None]
        wgt = torch.where(contrib, alpha * t_before, 0.0)
        acc = acc + torch.einsum("tkp,tkc->tpc", wgt, a[:, :, 0, 5:8])
        tr = tr * torch.where(contrib, 1.0 - alpha, 1.0).prod(1)
        done = done | viol.any(1)
        if bool(done.all()):
            break
    return tr, acc


def bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bfloat16, back in f32 (the gradient passes straight
    through the rounding)."""
    return x + (x.detach().to(torch.bfloat16).float() - x.detach())


def render(g: Dict[str, torch.Tensor], c2w: torch.Tensor, fxy: torch.Tensor,
           h: int, w: int, raster: dict, bg=(1.0, 1.0, 1.0), r=_same,
           remat: bool = False) -> torch.Tensor:
    """Raw Gaussians (fields [N, ...], one object) seen from views c2w
    [V, 4, 4] / fxy [V, 4] -> colour [V, 3, h, w].  `r=bf16` rounds the
    Gaussians and the blend's operands to bfloat16 (the precision
    control); `remat` recomputes each view in the backward."""
    raw = [r(g[k]) for k in ("xyz", "features", "scaling", "rotation",
                             "opacity")]
    out = []
    for v in range(c2w.shape[0]):
        fn = functools.partial(_render_view, c2w[v], fxy[v], h, w, raster,
                               bg, r)
        out.append(checkpoint(fn, *raw, use_reentrant=False) if remat
                   else fn(*raw))
    return torch.stack(out)


def _render_view(c2w, fxy, h, w, raster, bg, r, xyz, features, scaling,
                 rotation, opacity) -> torch.Tensor:
    d_slots = raster.get("max_tiles_per_gaussian", 16)
    k_cap = raster.get("max_per_tile", 1024)
    rot = rotation / torch.clamp(torch.linalg.norm(rotation, dim=-1,
                                                   keepdim=True), min=1e-12)
    act = {"xyz": xyz, "features": features,
           "opacity": (1.0 / (1.0 + torch.exp(-opacity)))[..., 0]}
    cov = _cov3d(torch.exp(scaling), rot)
    tiles_x, tiles_y = -(-w // TILE), -(-h // TILE)
    bg_t = torch.as_tensor(bg, dtype=torch.float32, device=c2w.device)
    cam = _camera(c2w, fxy, h, w)
    xy, depth, conic, color, rect, valid = _preprocess(act, cov, cam, fxy,
                                                       h, w)
    rect = _clip_center(rect, xy, valid, d_slots)
    idx, counts = _bin(rect, depth.detach(), valid, tiles_x, tiles_y,
                       d_slots, k_cap)
    rows = r(torch.cat([xy, conic, color, act["opacity"][:, None]], -1))
    rows = torch.cat([rows, rows.new_zeros((1, 9))])
    tr, acc = _blend(rows, idx, counts, tiles_x)
    img = acc + tr[..., None] * bg_t
    img = (img.reshape(tiles_y, tiles_x, TILE, TILE, 3)
           .permute(0, 2, 1, 3, 4).reshape(tiles_y * TILE, tiles_x * TILE, 3))
    return img[:h, :w].permute(2, 0, 1)


# --------------------------------------------------------------------------
# The training step
# --------------------------------------------------------------------------

VGG_STAGES = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))
LPIPS_SHIFT = (-0.030, -0.088, -0.188)
LPIPS_SCALE = (0.458, 0.448, 0.450)


def lpips_shapes() -> Dict[str, Tuple[int, ...]]:
    """LPIPS-VGG16: conv kernels (OIHW) and biases, the 5 linear heads."""
    out, cin = {}, 3
    for si, (cout, n) in enumerate(VGG_STAGES):
        for ci in range(n):
            out[f"vgg.{si}_{ci}.kernel"] = (cout, cin, 3, 3)
            out[f"vgg.{si}_{ci}.bias"] = (cout,)
            cin = cout
        out[f"lin.{si}.kernel"] = (cout,)
    return out


def lpips(P: Dict[str, torch.Tensor], x: torch.Tensor, y: torch.Tensor
          ) -> torch.Tensor:
    """Perceptual distance of [n, 3, h, w] images in [-1, 1] -> [n]: the
    VGG16 taps after each stage, unit-normalised over channels, squared
    differences weighted by the linear heads, spatial mean, summed."""
    shift = torch.tensor(LPIPS_SHIFT, device=x.device).reshape(1, 3, 1, 1)
    scale = torch.tensor(LPIPS_SCALE, device=x.device).reshape(1, 3, 1, 1)

    def taps(z):
        z = (z - shift) / scale
        out = []
        for si, (_, n) in enumerate(VGG_STAGES):
            for ci in range(n):
                z = F.relu(F.conv2d(z, P[f"vgg.{si}_{ci}.kernel"],
                                    P[f"vgg.{si}_{ci}.bias"], padding=1))
            out.append(z)
            if si < len(VGG_STAGES) - 1:
                z = F.max_pool2d(z, 2, 2)
        return out

    total = 0.0
    for si, (a, b) in enumerate(zip(taps(x), taps(y))):
        a = a / (torch.sqrt(torch.sum(a * a, 1, keepdim=True)) + 1e-10)
        b = b / (torch.sqrt(torch.sum(b * b, 1, keepdim=True)) + 1e-10)
        wl = P[f"lin.{si}.kernel"].reshape(1, -1, 1, 1)
        total = total + torch.sum((a - b) ** 2 * wl, 1).mean((1, 2))
    return total


def forward_tables(train_steps: int = 1000):
    """sqrt(abar_t), sqrt(1 - abar_t) of the cosine schedule, f32."""
    def abar(t):
        return math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2
    betas = np.array([min(1 - abar((i + 1) / train_steps)
                          / abar(i / train_steps), 0.999)
                      for i in range(train_steps)], np.float64)
    acp = np.cumprod(1.0 - betas)
    return (np.sqrt(acp).astype(np.float32),
            np.sqrt(1.0 - acp).astype(np.float32))


def ramp(spec, step: int) -> float:
    """A loss weight: a number, or [start, v0, v1, end] ramped linearly."""
    if isinstance(spec, (int, float)):
        return float(spec)
    s0, v0, v1, s1 = spec
    frac = min(max((step - s0) / max(s1 - s0, 1e-8), 0.0), 1.0)
    return v0 + (v1 - v0) * frac


def train_loss(W, P, system: dict, batch: dict, noise, t, step: int,
               r=_same, r_render=_same):
    """The object training loss of one batch: views 1: of the input get
    q_sample noise at timestep t, the DiT (blocks recomputed in the
    backward) gives Gaussians that render every supervision view; the
    loss weighs the x0 MSE, LPIPS (at most 256², bilinear with
    antialiasing above) and the masked xyz term by the config's ramps at
    `step` (SSIM and the points distance are weighted 0 from step 151 and
    left out).  `r` rounds the DiT's products, `r_render` the render's
    operands (the precision control).  Returns (loss, l2, lpips, xyz)."""
    sm, raster = system["shape_model"], system.get("raster", {})
    lo = system.get("loss", {})
    images = batch["rgbs_input"]
    b, v, _, h, w = images.shape
    for key, spec in (("lambda_ssim", 0.0), ("lambda_pointsdist", 0.0)):
        if ramp(lo.get(key, spec), step) != 0.0:
            raise NotImplementedError(f"{key} is weighted at step {step}")
    ray_o, ray_d = pixel_rays(batch["c2ws_input"], batch["fxfycxcys_input"],
                              h, w)
    sa, sb = (torch.from_numpy(tab).to(images.device)[t].reshape(-1, 1, 1, 1,
                                                                  1)
              for tab in forward_tables())
    x = torch.cat([images[:, :1], sa * images[:, 1:] + sb * noise[:, 1:]], 1)
    e = embed(W, sm, x, ray_o, ray_d, t, r)
    g = gaussians(W, sm, blocks(W, sm, e.x, e.silu_t, r, remat=True), e,
                  ray_o, ray_d, r)
    rend = torch.stack([render({k: g[k][i] for k in g}, batch["c2ws"][i],
                               batch["fxfycxcys"][i], h, w, raster,
                               r=r_render, remat=True) for i in range(b)])
    target = batch["rgbs"]
    l2 = ((rend - target) ** 2).mean()
    rr = rend.reshape(-1, 3, h, w)
    tt = target.reshape(-1, 3, h, w)
    if h != 256:
        rr, tt = (F.interpolate(z, size=(256, 256), mode="bilinear",
                                align_corners=False, antialias=True)
                  for z in (rr, tt))
    lp = lpips(P, rr * 2.0 - 1.0, tt * 2.0 - 1.0).mean()
    m = batch["masks_input"]
    gt = ray_o + ray_d * batch["depths_input"]
    xyz = (torch.sum(((g["pix_xyz"] - gt) * m) ** 2)
           / torch.clamp(torch.sum(m), min=1.0))
    loss = (ramp(lo.get("lambda_diffusion", 1.0), step) * l2
            + ramp(lo.get("lambda_lpips", 0.0), step) * lp
            + ramp(lo.get("lambda_xyz", 0.0), step) * xyz)
    return loss, l2, lp, xyz


def adamw(params: dict, grads: dict, state: dict, opt: dict, train: dict
          ) -> dict:
    """One AdamW update in place: gradients clipped to the global norm
    `gradient_clip_val` (scaled by clip / norm when the norm reaches it),
    the cosine-annealed learning rate at the count of updates so far,
    bias-corrected moments, decoupled weight decay.  Returns the clipped
    gradients."""
    a = opt["args"]
    b1, b2 = a.get("betas", (0.9, 0.99))
    eps, wd = a.get("eps", 1e-8), a.get("weight_decay", 0.01)
    sa = opt.get("scheduler", {}).get("args", {})
    t_max, eta_min = sa.get("T_max", 500000), sa.get("eta_min", 0.0)
    count = state.setdefault("count", 0)
    lr = eta_min + (a["lr"] - eta_min) * 0.5 * (
        1.0 + math.cos(math.pi * min(count / t_max, 1.0)))
    clip = train.get("gradient_clip_val", 0.0)
    norm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
    scale = 1.0 if not clip or norm < clip else clip / norm
    out = {}
    n = count + 1
    for k, p in params.items():
        g = grads[k] * scale
        out[k] = g
        m = state.setdefault("m." + k, torch.zeros_like(p))
        v = state.setdefault("v." + k, torch.zeros_like(p))
        m.mul_(b1).add_(g * (1.0 - b1))
        v.mul_(b2).add_(g * g * (1.0 - b2))
        upd = (m / (1.0 - b1 ** n)) / (torch.sqrt(v / (1.0 - b2 ** n)) + eps)
        p.sub_(lr * (upd + wd * p))
    state["count"] = n
    return out


def ema_update(ema: dict, params: dict, decay: float) -> None:
    """The EMA of the updated weights in place, e <- e·d + p·(1 - d), with
    d and 1 - d held in f32 as a training state's scalars are."""
    d = float(np.float32(decay))
    one_minus = float(np.float32(1.0 - d))
    for k, e in ema.items():
        e.mul_(d).add_(params[k].detach() * one_minus)
