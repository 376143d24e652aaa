"""3D Gaussian tile rasterizer (PyTorch + the CUDA blend kernels).

Counterpart of open_diffusiongs_tpu/ops/rasterize.py with the same capacity
semantics (docs/CAPACITY.md): D = max_tiles_per_gaussian tile slots per
Gaussian, K = max_per_tile candidates per tile (the farthest are dropped),
the centred rect clip, and the three exact counters.  `render` is
differentiable with respect to the raw Gaussians.

Per view:
  preprocess_view      per-Gaussian projection, conic, radius, tile rect,
                       SH colour (forward.cu preprocessCUDA:156-256)
  _clip_rect_centered  rects over D shrunk to a centred <= D-tile window
  _bin_tiles_single    N*D (tile << rank_bits | depth rank) int64 keys,
                       torch.sort, searchsorted tile bounds, and the [T, K]
                       contiguous-row gather of candidate indices
  blend_tiles          the CUDA tile-blend kernel (ops/blend_kernel.py),
                       reading rows of the packed [N + 1, 10] table
  blend_tiles_g        + bg·T_final, tiles assembled into the image

Gradients: activation, cov3D, EWA, SH and `pack_rows` are plain autograd;
the blend is `BlendTiles` (ops/blend_kernel.py: forward kernel, backward
kernel).  Its per-candidate gradient rows dg [T, K, 10] go back onto the
packed table without atomics and without a second sort (JAX scatters them
with `.at[].add`, rasterize.py:473-502; torch's CUDA `index_add_` would use
atomics).  The binning sort already places every (slot s, Gaussian n) key
at a sorted position p; its entry is tile t, candidate k = p - starts[t],
kept iff t < T and k < K.  `_bin_tiles_single` inverts the sort's
permutation (a permutation scatter, no accumulation) into gidx [D, N] =
t*K + k or the sentinel T*K, and the backward gathers dg through gidx and
sums over the D = 16 slots — the same result every run.

The JAX package's split/payload binning, `early_exit` while-loop, remat and
optimization barriers are TPU devices with no counterpart here; their
config fields are accepted and ignored.  Single-stream binning is exact
against split binning (tests/test_rasterize.py::
test_split_binning_exact_vs_single_stream).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from . import camera as cam_lib
from . import gs_math
from .blend_kernel import TILE, BlendTiles, blend_tiles
from .gaussians import ActivatedGaussians, Gaussians

NEAR_CULL_Z = 0.2            # auxiliary.h in_frustum

# RasterizeConfig fields that steer TPU-only machinery; the port accepts and
# ignores them (ROADMAP rule 4).
TPU_ONLY_FIELDS = ("blend_chunk", "split_slots", "big_select", "big_per_tile",
                   "early_exit", "remat", "pallas_blend", "pallas_bwd")


class RasterizeConfig(NamedTuple):
    """Capacity knobs, the same fields and defaults as the JAX package's.

    max_tiles_per_gaussian: D tile slots per Gaussian (rect tiles beyond D
      are counted in `overflow_tiles`);
    max_per_tile: K candidates per tile (the farthest beyond K are dropped,
      counted in `overflow_gaussians`);
    rect_clip: 'center' shrinks a rect over D to a centred window,
      'first' keeps its first D tiles in row-major order.
    The remaining fields (TPU_ONLY_FIELDS) are accepted and ignored.
    """

    max_tiles_per_gaussian: int = 16
    max_per_tile: int = 1024
    blend_chunk: int = 32
    rect_clip: str = "center"
    split_slots: int = 0
    big_select: int = 0
    big_per_tile: int = 0
    early_exit: bool = False
    remat: bool = True
    pallas_blend: str = "auto"
    pallas_bwd: str = "auto"


class PreprocessedView(NamedTuple):
    """Per-view screen-space Gaussian data ([N, ...])."""

    xy: torch.Tensor       # [N, 2] pixel-space mean
    depth: torch.Tensor    # [N] view-space z
    conic: torch.Tensor    # [N, 3] inverse 2D covariance (xx, xy, yy)
    color: torch.Tensor    # [N, 3] RGB from SH
    opacity: torch.Tensor  # [N]
    rect: torch.Tensor     # [N, 4] int32 (tx0, ty0, tx1, ty1), max exclusive
    valid: torch.Tensor    # [N] bool


class TileBins(NamedTuple):
    idx: torch.Tensor       # [T, K] int32 Gaussian rows, depth-sorted;
    #                         sentinel N past counts[t]
    counts: torch.Tensor    # [T] int32 live candidates (<= K)
    overflow_tiles: torch.Tensor      # [] rect tiles beyond D
    overflow_gaussians: torch.Tensor  # [] per-tile entries beyond K
    entries: torch.Tensor             # [] total binned entries
    gidx: Optional[torch.Tensor] = None  # [D, N] int32 flat candidate
    #                         index t*K + k of each slot, or T*K (unbinned);
    #                         built only for the backward (grad_map=True)


def preprocess_view(act: ActivatedGaussians, cov3d: torch.Tensor,
                    cam: cam_lib.CameraParams, h: int, w: int,
                    sh_degree: int) -> PreprocessedView:
    """Per-Gaussian view preprocessing for one scene ([N, ...]) and one
    view; `cov3d` [N, 6] is precomputed once per scene."""
    p = act.xyz
    px, py, pz = p[..., 0], p[..., 1], p[..., 2]

    def affine_row(m, row):
        return m[row, 0] * px + m[row, 1] * py + m[row, 2] * pz + m[row, 3]

    depth = affine_row(cam.w2c, 2)
    in_front = depth > NEAR_CULL_Z
    hom_x = affine_row(cam.full_proj, 0)
    hom_y = affine_row(cam.full_proj, 1)
    p_w = affine_row(cam.full_proj, 3)
    # a Gaussian culled at the near plane is never read, but a projective
    # w of exactly -1e-7 would make its xy infinite and its gradient
    # 0 * inf = NaN: culled ones divide by 1 + 1e-7 (see ewa_cov2d's near)
    rcp_w = 1.0 / (torch.where(in_front, p_w, 1.0) + 1e-7)
    xy = torch.stack([cam_lib.ndc2pix(hom_x * rcp_w, w),
                      cam_lib.ndc2pix(hom_y * rcp_w, h)], -1)

    cov2d = gs_math.ewa_cov2d(p, cov3d, cam.w2c, cam.fxfycxcy, cam.tanfov,
                              near=NEAR_CULL_Z)
    conic, radius, det_ok = gs_math.conic_and_radius(cov2d)

    tiles_x = -(-w // TILE)
    tiles_y = -(-h // TILE)
    # getRect (auxiliary.h:46-56): floor, then clamp into the tile grid
    tx0 = torch.clamp(torch.floor((xy[..., 0] - radius) / TILE), 0, tiles_x)
    ty0 = torch.clamp(torch.floor((xy[..., 1] - radius) / TILE), 0, tiles_y)
    tx1 = torch.clamp(torch.floor((xy[..., 0] + radius + TILE - 1) / TILE),
                      0, tiles_x)
    ty1 = torch.clamp(torch.floor((xy[..., 1] + radius + TILE - 1) / TILE),
                      0, tiles_y)
    rect = torch.stack([tx0, ty0, tx1, ty1], -1).to(torch.int32)
    nonempty = ((rect[..., 2] - rect[..., 0])
                * (rect[..., 3] - rect[..., 1])) > 0

    color = gs_math.eval_sh(act.features, sh_degree, p - cam.cam_pos)
    return PreprocessedView(xy=xy, depth=depth, conic=conic, color=color,
                            opacity=act.opacity, rect=rect,
                            valid=in_front & det_ok & nonempty)


def _clip_rect_centered(pre: PreprocessedView, d_slots: int):
    """Shrink every rect with area > D to a <= D-tile window centred on the
    Gaussian's centre tile (rect_clip='center').  s = sqrt(D / area) scales
    both sides (truncated to int, like the JAX astype(int32)), the height is
    then cut so cw·ch <= D, and the window is clamped inside the original
    rect.  Returns (pre with clipped rects, clipped slot count [])."""
    rect = pre.rect
    x0, y0, x1, y1 = rect.unbind(-1)
    rw = x1 - x0
    rh = y1 - y0
    area = rw * rh
    over = pre.valid & (area > d_slots)
    s = torch.sqrt(d_slots / torch.clamp(area, min=1).float())
    cw = torch.minimum(torch.maximum((rw.float() * s).to(torch.int32),
                                     torch.ones_like(rw)),
                       torch.clamp(rw, max=d_slots))
    ch = torch.minimum(torch.maximum((rh.float() * s).to(torch.int32),
                                     torch.ones_like(rh)), rh)
    # cw >= 1 on every rect the clip rewrites; the clamp only keeps the
    # integer division defined on the rects it leaves alone (rw = 0)
    ch = torch.minimum(torch.maximum(
        torch.minimum(ch, d_slots // torch.clamp(cw, min=1)),
        torch.ones_like(rh)), rh)

    def centre_tile(coord, lo, hi):
        # float -> int saturating like XLA's convert, then into [lo, hi - 1]
        t = torch.clamp(torch.floor(coord / TILE), -2.0 ** 30, 2.0 ** 30)
        return torch.minimum(torch.maximum(t.to(torch.int32), lo), hi - 1)

    ctx = centre_tile(pre.xy[:, 0], x0, x1)
    cty = centre_tile(pre.xy[:, 1], y0, y1)
    nx0 = torch.minimum(torch.maximum(ctx - cw // 2, x0), x1 - cw)
    ny0 = torch.minimum(torch.maximum(cty - ch // 2, y0), y1 - ch)
    new_rect = torch.stack([nx0, ny0, nx0 + cw, ny0 + ch], -1)
    rect = torch.where(over[:, None], new_rect, rect)
    clipped = torch.where(over, area - cw * ch, 0).sum()
    return pre._replace(rect=rect), clipped


def _depth_ranks(depth: torch.Tensor) -> torch.Tensor:
    """[N] depth rank of every Gaussian (0 = nearest; ties by index, the
    order of a stable radix sort)."""
    order = torch.argsort(depth, stable=True)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(depth.shape[0], device=depth.device)
    return inv


def _bin_tiles_single(pre: PreprocessedView, tiles_x: int, tiles_y: int,
                      cfg: RasterizeConfig, grad_map: bool = False
                      ) -> TileBins:
    """Single-stream N·D-key binning (rasterizer_impl.cu duplicateWithKeys
    + radix sort + identifyTileRanges).  Slot s of a Gaussian covers tile
    (x0 + s % rw, y0 + s // rw) while s < area (row-major walk of its rect);
    other slots carry the sentinel tile T.  One int64 key per slot,
    (tile << rank_bits) | depth rank, sorts into (tile, depth) order.
    `grad_map` also returns gidx, the backward's candidate index of every
    slot (module docstring)."""
    n = pre.depth.shape[0]
    dev = pre.depth.device
    d_slots, k_cap = cfg.max_tiles_per_gaussian, cfg.max_per_tile
    num_tiles = tiles_x * tiles_y
    rank_bits = max(1, (n - 1).bit_length())

    x0, y0 = pre.rect[:, 0].long(), pre.rect[:, 1].long()
    rw = pre.rect[:, 2].long() - x0
    rh = pre.rect[:, 3].long() - y0
    area = rw * rh
    overflow_tiles = torch.where(pre.valid, torch.clamp(area - d_slots, min=0),
                                 0).sum()

    slot = torch.arange(d_slots, device=dev)[:, None]            # [D, 1]
    rw_safe = torch.clamp(rw, min=1)
    tile = (y0 + slot // rw_safe) * tiles_x + (x0 + slot % rw_safe)
    tile = torch.where((slot < area) & pre.valid, tile, num_tiles)  # [D, N]
    key = (tile << rank_bits) | _depth_ranks(pre.depth)
    key_s, perm = torch.sort(key.reshape(-1))
    gauss_s = (perm % n).to(torch.int32)                         # slot -> row

    tids = torch.arange(num_tiles + 1, device=dev) << rank_bits
    bounds = torch.searchsorted(key_s, tids)
    starts = bounds[:-1]
    counts_raw = bounds[1:] - bounds[:-1]
    # [T, K] contiguous rows gauss_s[starts[t] : starts[t] + K], sentinel n
    # past the tile's own entries
    padded = torch.cat([gauss_s, torch.full((k_cap,), n, dtype=torch.int32,
                                            device=dev)])
    k_ar = torch.arange(k_cap, device=dev)
    idx = padded[starts[:, None] + k_ar[None, :]]
    counts = torch.clamp(counts_raw, max=k_cap)
    idx = torch.where(k_ar[None, :] < counts[:, None], idx, n)
    gidx = None
    if grad_map:
        pos = torch.empty_like(perm)               # sorted position of key f
        pos[perm] = torch.arange(perm.numel(), device=dev)
        tile_f = tile.reshape(-1)
        kk = pos - starts[torch.clamp(tile_f, max=num_tiles - 1)]
        keep = (tile_f < num_tiles) & (kk < k_cap)
        gidx = torch.where(keep, tile_f * k_cap + kk, num_tiles * k_cap)
        gidx = gidx.reshape(d_slots, n).to(torch.int32)
    return TileBins(idx=idx.to(torch.int32).contiguous(),
                    counts=counts.to(torch.int32),
                    overflow_tiles=overflow_tiles,
                    overflow_gaussians=torch.clamp(counts_raw - k_cap,
                                                   min=0).sum(),
                    entries=counts_raw.sum(), gidx=gidx)


def pack_rows(pre: PreprocessedView) -> torch.Tensor:
    """[N + 1, 10] f32 attribute table (x, y, conic, rgb, opacity, depth)
    with an all-zero sentinel row N: a zero row blends to nothing (opacity
    0 < 1/255 is a skip, forward.cu:345)."""
    packed = torch.cat([pre.xy, pre.conic, pre.color, pre.opacity[:, None],
                        pre.depth[:, None]], -1).float()
    return torch.cat([packed, packed.new_zeros((1, 10))]).contiguous()


def blend_tiles_g(t_fin: torch.Tensor, acc_c: torch.Tensor,
                  acc_d: torch.Tensor, tiles_x: int, tiles_y: int,
                  bg: torch.Tensor):
    """Background term (out = C + T·bg, forward.cu:370-372) and tile
    assembly.  Returns (color [Hp, Wp, 3], alpha [Hp, Wp], depth [Hp, Wp])
    with Hp = tiles_y·16, Wp = tiles_x·16."""
    color = acc_c + t_fin[..., None] * bg

    def assemble(img):                   # [T, 256, c] -> [Hp, Wp, c]
        c = img.shape[-1]
        return (img.reshape(tiles_y, tiles_x, TILE, TILE, c)
                .permute(0, 2, 1, 3, 4)
                .reshape(tiles_y * TILE, tiles_x * TILE, c))

    return (assemble(color), assemble((1.0 - t_fin)[..., None])[..., 0],
            assemble(acc_d[..., None])[..., 0])


def rasterize_single_view(act: ActivatedGaussians, cov3d: torch.Tensor,
                          cam: cam_lib.CameraParams, h: int, w: int,
                          sh_degree: int, bg: torch.Tensor,
                          cfg: RasterizeConfig):
    tiles_x = -(-w // TILE)
    tiles_y = -(-h // TILE)
    pre = preprocess_view(act, cov3d, cam, h, w, sh_degree)
    clipped = torch.zeros((), dtype=torch.int64, device=bg.device)
    if cfg.rect_clip == "center":
        pre, clipped = _clip_rect_centered(pre, cfg.max_tiles_per_gaussian)
    elif cfg.rect_clip != "first":
        raise ValueError(f"unknown rect_clip {cfg.rect_clip!r}")
    packed = pack_rows(pre)
    differentiable = torch.is_grad_enabled() and packed.requires_grad
    bins = _bin_tiles_single(pre, tiles_x, tiles_y, cfg,
                             grad_map=differentiable)
    if differentiable:
        t_fin, acc_c, acc_d = BlendTiles.apply(packed, bins.idx, bins.counts,
                                               bins.gidx, tiles_x)
    else:
        t_fin, acc_c, acc_d = blend_tiles(packed, bins.idx, bins.counts,
                                          tiles_x)
    color, alpha, depth = blend_tiles_g(t_fin, acc_c, acc_d, tiles_x,
                                        tiles_y, bg)
    return (color[:h, :w], alpha[:h, :w], depth[:h, :w],
            bins.overflow_tiles + clipped, bins.overflow_gaussians,
            bins.entries)


def render(gaussians: Gaussians, c2w: torch.Tensor, fxfycxcy: torch.Tensor,
           h: int, w: int, bg_color=(1.0, 1.0, 1.0),
           cfg: RasterizeConfig = RasterizeConfig()):
    """Batched multi-view render.

    gaussians: raw Gaussians, fields [B, N, ...]; c2w [B, V, 4, 4];
    fxfycxcy [B, V, 4].  Returns a dict:
      render [B, V, 3, h, w],
      alpha / depth [B, V, 1, h, w],
      overflow_tiles / overflow_gaussians / binned_entries: [] int64
      ("no silent caps": nonzero means a capacity clipped real work).
    Views run one after another (one blend launch each).  Differentiable
    with respect to the Gaussians when they require grad."""
    dev = gaussians.xyz.device
    bg = torch.as_tensor(bg_color, dtype=torch.float32, device=dev)
    colors, alphas, depths = [], [], []
    counters = torch.zeros(3, dtype=torch.int64, device=dev)
    for bi in range(gaussians.xyz.shape[0]):
        act = Gaussians(*(x[bi] for x in gaussians)).activate()
        cov3d = gs_math.build_cov3d(act.scaling, act.rotation)
        cams = cam_lib.make_camera(c2w[bi], fxfycxcy[bi], h, w)
        per_view = []
        for vi in range(c2w.shape[1]):
            cam = cam_lib.CameraParams(*(x[vi] for x in cams))
            c, a, d, otile, ogauss, entries = rasterize_single_view(
                act, cov3d, cam, h, w, gaussians.sh_degree, bg, cfg)
            counters += torch.stack([otile, ogauss, entries]).long()
            per_view.append((c, a, d))
        colors.append(torch.stack([c for c, _, _ in per_view]))
        alphas.append(torch.stack([a for _, a, _ in per_view]))
        depths.append(torch.stack([d for _, _, d in per_view]))
    return {
        "render": torch.stack(colors).permute(0, 1, 4, 2, 3),
        "alpha": torch.stack(alphas)[:, :, None],
        "depth": torch.stack(depths)[:, :, None],
        "overflow_tiles": counters[0],
        "overflow_gaussians": counters[1],
        "binned_entries": counters[2],
    }
