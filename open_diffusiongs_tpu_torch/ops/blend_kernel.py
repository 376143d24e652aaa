"""Per-tile alpha blend of the rasterizer forward: CUDA kernel + plain twin.

Counterpart of open_diffusiongs_tpu/ops/blend_kernel.py::blend_tiles_pallas.
The kernel (csrc/blend_fwd.cu) is one 256-thread block per 16x16 tile, one
thread per pixel, reading the candidates through the [T, K] index list and
the packed [N + 1, 10] attribute table (zero sentinel row N) instead of a
materialized [T, K, 10] copy.  `blend_tiles_ref` is the plain PyTorch
version: a loop over the K candidate slots, vectorized over [T, 256]
pixels.  `blend_tiles` takes the plain version only for CPU tensors; on a
CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from . import _build

TILE = 16
PPT = TILE * TILE
EARLY_STOP_T = 1e-4          # forward.cu:348
ALPHA_MIN = 1.0 / 255.0      # forward.cu:345
ALPHA_MAX = 0.99             # forward.cu:344

LAUNCHES = 0   # kernel launches by blend_tiles (CUDA tensors only)


def _check(packed, idx, counts):
    if packed.dim() != 2 or packed.shape[1] != 10:
        raise ValueError(f"packed must be [N + 1, 10], got "
                         f"{tuple(packed.shape)}")
    if idx.dim() != 2 or counts.shape != (idx.shape[0],):
        raise ValueError(f"idx [T, K] / counts [T] mismatch: "
                         f"{tuple(idx.shape)}, {tuple(counts.shape)}")


def blend_tiles_ref(packed: torch.Tensor, idx: torch.Tensor,
                    counts: torch.Tensor, tiles_x: int):
    """Plain PyTorch blend: a loop over the candidate slots, vectorized over
    every (tile, pixel).  Same semantics and the same sequential T product
    as the kernel.  Returns (t_fin [T, 256], acc_c [T, 256, 3],
    acc_d [T, 256])."""
    _check(packed, idx, counts)
    num_tiles, k = idx.shape
    dev = packed.device
    # integer pixel coordinates, row-major within each tile (forward.cu:283)
    t = torch.arange(num_tiles, device=dev)[:, None]
    lp = torch.arange(PPT, device=dev)[None, :]
    px = ((t % tiles_x) * TILE + lp % TILE).float()
    py = ((t // tiles_x) * TILE + lp // TILE).float()
    tr = torch.ones((num_tiles, PPT), dtype=torch.float32, device=dev)
    done = torch.zeros((num_tiles, PPT), dtype=torch.bool, device=dev)
    acc_c = torch.zeros((num_tiles, PPT, 3), dtype=torch.float32, device=dev)
    acc_d = torch.zeros((num_tiles, PPT), dtype=torch.float32, device=dev)
    kmax = int(counts.max()) if num_tiles else 0
    for j in range(min(k, kmax)):
        a = packed[idx[:, j].long()]                       # [T, 10]
        dx = a[:, 0:1] - px
        dy = a[:, 1:2] - py
        power = (-0.5 * (a[:, 2:3] * dx * dx + a[:, 4:5] * dy * dy)
                 - a[:, 3:4] * dx * dy)
        alpha = torch.clamp(a[:, 8:9] * torch.exp(power), max=ALPHA_MAX)
        live = ((j < counts)[:, None] & ~done & ~(power > 0.0)
                & ~(alpha < ALPHA_MIN))
        test_t = tr * (1.0 - alpha)
        stop = live & (test_t < EARLY_STOP_T)
        contrib = live & ~stop
        w = torch.where(contrib, alpha * tr, 0.0)
        acc_c += a[:, None, 5:8] * w[..., None]
        acc_d += a[:, 9:10] * w
        tr = torch.where(contrib, test_t, tr)
        done |= stop
    return tr, acc_c, acc_d


def blend_tiles(packed: torch.Tensor, idx: torch.Tensor,
                counts: torch.Tensor, tiles_x: int):
    """Front-to-back blend of every 16x16 tile over its depth-sorted
    candidates.

    packed: [N + 1, 10] f32 attribute rows (x, y, conic a/b/c, r, g, b,
      opacity, depth) with an all-zero sentinel row N;
    idx: [T, K] int32 candidate rows per tile (sentinel N past counts[t]);
    counts: [T] int32 live candidates per tile (<= K).
    Returns (t_fin [T, 256], acc_c [T, 256, 3], acc_d [T, 256]) — the
    accumulators before the background term."""
    global LAUNCHES
    _check(packed, idx, counts)
    if packed.device.type == "cpu":
        return blend_tiles_ref(packed, idx, counts, tiles_x)
    if packed.device.type != "cuda":
        raise RuntimeError(f"blend_tiles: unsupported device {packed.device}")
    for name, x, dt in (("packed", packed, torch.float32),
                        ("idx", idx, torch.int32),
                        ("counts", counts, torch.int32)):
        if x.device != packed.device:
            raise ValueError(f"{name} is on {x.device}, packed on "
                             f"{packed.device}")
        if x.dtype != dt:
            raise TypeError(f"{name}: the kernel takes {dt}, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    num_tiles, k = idx.shape
    dev = packed.device
    t_fin = torch.empty((num_tiles, PPT), dtype=torch.float32, device=dev)
    acc_c = torch.empty((num_tiles, PPT, 3), dtype=torch.float32, device=dev)
    acc_d = torch.empty((num_tiles, PPT), dtype=torch.float32, device=dev)
    lib = _build.load_library()
    err = lib.odgs_blend_fwd(
        packed.data_ptr(), idx.data_ptr(), counts.data_ptr(), num_tiles, k,
        tiles_x, t_fin.data_ptr(), acc_c.data_ptr(), acc_d.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "blend_tiles")
    LAUNCHES += 1
    return t_fin, acc_c, acc_d
