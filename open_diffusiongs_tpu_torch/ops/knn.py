"""k-nearest-neighbour mean distances, the `simple-knn` equivalent (torch).

Counterpart of open_diffusiongs_tpu/ops/knn.py (:20-48).  The reference
ships a CUDA extension (submodules/simple-knn, simple_knn.cu:186-222) whose
one entry point `distCUDA2(points)` returns each point's mean squared
distance to its 3 nearest other points (3DGS's scale initialisation); it
is installed but never imported by diffusionGS.  JAX computes it with XLA
matmuls, not with Pallas, so its port is plain torch too: a blocked exact
top-k over |a|^2 + |b|^2 - 2 a.b on the points' device.
"""

from __future__ import annotations

import torch

# bytes of one block's f32 distance matrix (a 4096-row block of the 256^2
# asset's 262,146 points would take 4.3 GB)
BLOCK_BYTES = 1 << 30


def knn_block_rows(n: int, block_bytes: int = BLOCK_BYTES) -> int:
    """Query rows per block: as many as keep a [rows, n] f32 distance
    matrix (and its masked copy) within `block_bytes`, at least 1."""
    return max(1, min(n, block_bytes // (8 * max(n, 1))))


def knn_mean_sq_dist(points: torch.Tensor, k: int = 3,
                     block: int | None = None) -> torch.Tensor:
    """[N, 3] -> [N] f32 mean squared distance to the k nearest neighbours,
    self excluded (`distCUDA2` semantics, spatial.cu:14-24), on the points'
    device.  As JAX: distances |q|^2 + |p|^2 - 2 q.p in f32 with the
    product at full f32 precision (TF32 off: JAX's Precision.HIGHEST),
    clamped at 0 (a duplicate point gives 0, not a negative distance), the
    point itself and NaN distances set to +inf; with fewer than k other
    points the missing neighbours count as +inf.  `block`: query rows per
    block (default: `knn_block_rows`)."""
    pts = points.to(torch.float32)
    n = pts.shape[0]
    block = block or knn_block_rows(n)
    sq = (pts * pts).sum(-1)
    kk = min(k, n)
    out = torch.empty(n, dtype=torch.float32, device=pts.device)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for start in range(0, n, block):
            stop = min(start + block, n)
            d2 = torch.addmm(sq[None, :], pts[start:stop], pts.T, beta=1.0,
                             alpha=-2.0)
            d2 = (d2 + sq[start:stop, None]).clamp_(min=0.0)
            rows = torch.arange(stop - start, device=pts.device)
            d2[rows, rows + start] = torch.inf
            d2.masked_fill_(d2.isnan(), torch.inf)
            top = torch.topk(d2, kk, dim=-1, largest=False).values
            if kk < k:
                top = torch.cat([top, top.new_full((stop - start, k - kk),
                                                   torch.inf)], -1)
            out[start:stop] = top.mean(-1)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return out
