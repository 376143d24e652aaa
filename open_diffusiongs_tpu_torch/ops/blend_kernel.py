"""Per-tile alpha blend of the rasterizer: CUDA kernels + plain twins.

Counterpart of open_diffusiongs_tpu/ops/blend_kernel.py::blend_tiles_pallas
(forward) and ::blend_bwd_pallas (backward).  The kernels (csrc/blend_fwd.cu,
csrc/blend_bwd.cu, shared pieces in csrc/blend.cuh) give each warp an 8x4
pixel rectangle of a 16x16 tile; a warp walks the tile's depth-sorted
candidates on its own through a cp.async ring of rows read via the [T, K]
index list from the packed [N + 1, 10] attribute table (zero sentinel row
N), skipping whole candidates whose opacity-aware footprint misses its
rectangle (`misses_rect` mirrors that cull in f32).  The forward also
writes each pixel's end slot (`n_end`: its stopping candidate, or
counts[t]), which bounds the backward's re-walk.
`blend_tiles_ref` and `blend_bwd_ref` are the plain PyTorch versions:
loops over the K candidate slots in chunks of 32, vectorized over [T, 256]
pixels, with in-chunk prefix products and sums (the TPU kernels' form).
Each wrapper takes its plain version only for CPU tensors; on a CUDA
tensor it launches its kernel or raises.

Gradients: `BlendTiles` is the autograd Function of the blend (forward
kernel, backward kernel, then the deterministic gather-sum of the
per-candidate rows onto the table, `candidate_grads_to_rows`).  The raw
CUDA forward records no graph, so it refuses a table that requires grad
while grad mode is on.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import _build

TILE = 16
PPT = TILE * TILE
EARLY_STOP_T = 1e-4          # forward.cu:348
ALPHA_MIN = 1.0 / 255.0      # forward.cu:345
ALPHA_MAX = 0.99             # forward.cu:344

RECT_W, RECT_H = 8, 4        # one warp's pixels (csrc/blend.cuh)
TILE_WARPS = PPT // (RECT_W * RECT_H)
CULL_RHO = 2.0 ** -18        # 32 FLT_EPSILON (csrc/blend.cuh)

LAUNCHES = 0       # forward kernel launches (CUDA tensors only)
LAUNCHES_BWD = 0   # backward kernel launches


def _check(packed, idx, counts):
    if packed.dim() != 2 or packed.shape[1] != 10:
        raise ValueError(f"packed must be [N + 1, 10], got "
                         f"{tuple(packed.shape)}")
    if idx.dim() != 2 or counts.shape != (idx.shape[0],):
        raise ValueError(f"idx [T, K] / counts [T] mismatch: "
                         f"{tuple(idx.shape)}, {tuple(counts.shape)}")


def _pixels(num_tiles: int, tiles_x: int, dev):
    """Integer pixel coordinates [T, 256], row-major within each tile
    (forward.cu:283)."""
    t = torch.arange(num_tiles, device=dev)[:, None]
    lp = torch.arange(PPT, device=dev)[None, :]
    return (((t % tiles_x) * TILE + lp % TILE).float(),
            ((t // tiles_x) * TILE + lp // TILE).float())


def warp_pixels(dev=None) -> torch.Tensor:
    """[8, 32] tile pixel of each (warp, lane) of the kernels: warp w owns
    the 8x4 rectangle at ((w % 2) * 8, (w // 2) * 4) (csrc/blend.cuh)."""
    w = torch.arange(TILE_WARPS, device=dev)[:, None]
    lane = torch.arange(32, device=dev)[None, :]
    return (((w // 2) * RECT_H + lane // RECT_W) * TILE + (w % 2) * RECT_W
            + lane % RECT_W)


def warp_rects(num_tiles: int, tiles_x: int, dev=None) -> torch.Tensor:
    """[T, 8, 4] f32 pixel-centre bounds (x0, y0, x1, y1) of every warp
    rectangle, inclusive."""
    t = torch.arange(num_tiles, device=dev)[:, None]
    w = torch.arange(TILE_WARPS, device=dev)[None, :]
    x0 = (t % tiles_x) * TILE + (w % 2) * RECT_W
    y0 = (t // tiles_x) * TILE + (w // 2) * RECT_H
    return torch.stack([x0, y0, x0 + RECT_W - 1, y0 + RECT_H - 1],
                        -1).float()


def misses_rect(rows: torch.Tensor, rect: torch.Tensor) -> torch.Tensor:
    """The kernels' conservative cull in f32, operation for operation
    (csrc/blend.cuh::misses_rect, whose note derives it): True where no
    pixel centre of `rect` (..., 4: x0, y0, x1, y1) can blend the candidate
    row (..., 10); broadcasts."""
    def f(v):
        return torch.tensor(v, dtype=torch.float32, device=rows.device)

    x, y, ca, cb, cc, o = (rows[..., i] for i in (0, 1, 2, 3, 4, 8))
    det = ca * cc - cb * cb
    rdet = torch.reciprocal(det)
    s = ca + cc
    rho = f(CULL_RHO) * (s * s) * rdet
    tau = torch.log(f(255.0) * o)
    certain = ((ca > 0) & (det > 0) & (rho <= 0.5) & torch.isfinite(x)
               & torch.isfinite(y) & torch.isfinite(det)
               & torch.isfinite(tau))
    q = f(2.0) * (tau * f(1.001) + f(1e-4)) * (f(1.0) + f(2.0) * rho)
    hx = (torch.sqrt(q * cc * rdet) * f(1.001) + f(0.01)
          + f(1e-5) * torch.abs(x))
    hy = (torch.sqrt(q * ca * rdet) * f(1.001) + f(0.01)
          + f(1e-5) * torch.abs(y))
    out = ((x + hx < rect[..., 0]) | (x - hx > rect[..., 2])
           | (y + hy < rect[..., 1]) | (y - hy > rect[..., 3]))
    return (o < f(ALPHA_MIN)) | (certain & out)


def cull_mask(packed: torch.Tensor, idx: torch.Tensor, counts: torch.Tensor,
              tiles_x: int) -> torch.Tensor:
    """[T, 8, K] bool: the (candidate slot, warp) pairs the kernels' cull
    skips (slots >= counts[t] are not walked and read False)."""
    num_tiles, k = idx.shape
    rows = packed[idx.long()][:, None]                     # [T, 1, K, 10]
    rect = warp_rects(num_tiles, tiles_x, packed.device)[:, :, None]
    live = torch.arange(k, device=packed.device) < counts[:, None]
    return misses_rect(rows, rect) & live[:, None, :]


def _check_cuda(what: str, ref: torch.Tensor, **tensors):
    """Device, dtype (idx/counts int32, the rest f32) and contiguity checks
    of a kernel launch."""
    if ref.device.type != "cuda":
        raise RuntimeError(f"{what}: unsupported device {ref.device}")
    for name, x in tensors.items():
        dt = (torch.int32 if name in ("idx", "counts", "n_end")
              else torch.float32)
        if x.device != ref.device:
            raise ValueError(f"{what}: {name} is on {x.device}, not "
                             f"{ref.device}")
        if x.dtype != dt:
            raise TypeError(f"{what}: {name}: the kernel takes {dt}, got "
                            f"{x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")


CHUNK = 32   # candidate slots per step of the plain versions


class _Chunk(NamedTuple):
    """Forward state of candidate slots c0 .. c0 + kc - 1 ([T, kc, 256])."""

    a: torch.Tensor          # [T, kc, 1, 10] attribute rows
    dx: torch.Tensor
    dy: torch.Tensor
    gexp: torch.Tensor       # exp(power)
    og: torch.Tensor         # opacity * exp(power), before the clamp
    alpha: torch.Tensor
    t_before: torch.Tensor   # transmittance in front of each candidate
    contrib: torch.Tensor    # bool: the candidate is blended
    w: torch.Tensor          # alpha * t_before where contrib, else 0
    viol: torch.Tensor       # bool: the candidate would stop the pixel
    stopped: torch.Tensor    # [T, 256] bool: a pixel stops in this chunk


def _chunk(packed, idx, counts, c0, px, py, tr, done, n_end=None
           ) -> _Chunk:
    """Recompute the forward state of one chunk of slots: the TPU kernel's
    form (blend_kernel.py:71-97), with the transmittance product and the
    'stopped earlier' test as in-chunk prefix products / sums.  With
    `n_end` ([T, 256] end slots from the forward) a pixel's walk also ends
    at its end slot."""
    kc = min(CHUNK, idx.shape[1] - c0)
    a = packed[idx[:, c0:c0 + kc].long()][:, :, None, :]   # [T, kc, 1, 10]
    dx = a[..., 0] - px[:, None, :]                        # [T, kc, 256]
    dy = a[..., 1] - py[:, None, :]
    power = (-0.5 * (a[..., 2] * dx * dx + a[..., 4] * dy * dy)
             - a[..., 3] * dx * dy)
    gexp = torch.exp(power)
    og = a[..., 8] * gexp
    alpha = torch.clamp(og, max=ALPHA_MAX)
    slot = c0 + torch.arange(kc, device=packed.device)
    skip = ((slot[None, :] >= counts[:, None])[..., None] | (power > 0.0)
            | (alpha < ALPHA_MIN))
    beyond = None
    if n_end is not None:
        beyond = slot[None, :, None] >= n_end[:, None, :]
        skip = skip | beyond
    one_minus = 1.0 - torch.where(skip, 0.0, alpha)
    excl = torch.cat([torch.ones_like(one_minus[:, :1]),
                      torch.cumprod(one_minus, dim=1)[:, :-1]], dim=1)
    t_before = tr[:, None, :] * excl
    viol = ~skip & (t_before * (1.0 - alpha) < EARLY_STOP_T)
    earlier = (torch.cumsum(viol.int(), dim=1) - viol.int()) > 0
    contrib = ~skip & ~viol & ~earlier & ~done[:, None, :]
    w = torch.where(contrib, alpha * t_before, 0.0)
    stopped = viol.any(dim=1)
    if beyond is not None:
        stopped = stopped | beyond.any(dim=1)
    return _Chunk(a, dx, dy, gexp, og, alpha, t_before, contrib, w, viol,
                  stopped)


class _Walk:
    """Iterate (c0, chunk) over the slots in front-to-back chunks, carrying
    the transmittance `tr`, the stopped pixels and their end slots `end`
    (the stopping candidate, or counts[t]); ends once every pixel of every
    tile has stopped (the kernels' exit) or the slots run out.  Afterwards
    `tr` is the final transmittance."""

    def __init__(self, packed, idx, counts, tiles_x, n_end=None):
        self.args = (packed, idx, counts)
        self.n_end = n_end
        num_tiles = idx.shape[0]
        dev = packed.device
        self.px, self.py = _pixels(num_tiles, tiles_x, dev)
        self.tr = torch.ones((num_tiles, PPT), dtype=torch.float32,
                             device=dev)
        self.end = counts[:, None].expand(num_tiles, PPT).to(torch.int32)
        self.kmax = min(idx.shape[1], int(counts.max())) if num_tiles else 0

    def __iter__(self):
        done = torch.zeros_like(self.tr, dtype=torch.bool)
        for c0 in range(0, self.kmax, CHUNK):
            ch = _chunk(*self.args, c0, self.px, self.py, self.tr, done,
                        self.n_end)
            yield c0, ch
            self.tr = self.tr * torch.where(ch.contrib, 1.0 - ch.alpha,
                                            1.0).prod(dim=1)
            first = c0 + torch.argmax(ch.viol.int(), dim=1)
            self.end = torch.where(ch.viol.any(dim=1) & ~done,
                                   first.to(torch.int32), self.end)
            done = done | ch.stopped
            if bool(done.all()):
                return


def blend_tiles_ref(packed: torch.Tensor, idx: torch.Tensor,
                    counts: torch.Tensor, tiles_x: int,
                    return_end: bool = False):
    """Plain PyTorch blend, vectorized over every (tile, pixel): the slots
    are walked front to back in chunks of 32, with in-chunk prefix products
    for the transmittance (the TPU kernel's form; the CUDA kernel multiplies
    sequentially, so the two differ by f32 reassociation only).  Returns
    (t_fin [T, 256], acc_c [T, 256, 3], acc_d [T, 256]), and with
    `return_end` also n_end [T, 256] int32: each pixel's stopping slot, or
    counts[t]."""
    _check(packed, idx, counts)
    num_tiles = idx.shape[0]
    dev = packed.device
    acc_c = torch.zeros((num_tiles, PPT, 3), dtype=torch.float32, device=dev)
    acc_d = torch.zeros((num_tiles, PPT), dtype=torch.float32, device=dev)
    walk = _Walk(packed, idx, counts, tiles_x)
    for _, ch in walk:
        acc_c = acc_c + torch.einsum("tkp,tkc->tpc", ch.w, ch.a[:, :, 0, 5:8])
        acc_d = acc_d + (ch.w * ch.a[..., 9]).sum(dim=1)
    out = (walk.tr, acc_c, acc_d)
    return out + (walk.end.contiguous(),) if return_end else out


def blend_tiles(packed: torch.Tensor, idx: torch.Tensor,
                counts: torch.Tensor, tiles_x: int, return_end: bool = False):
    """Front-to-back blend of every 16x16 tile over its depth-sorted
    candidates.

    packed: [N + 1, 10] f32 attribute rows (x, y, conic a/b/c, r, g, b,
      opacity, depth) with an all-zero sentinel row N;
    idx: [T, K] int32 candidate rows per tile (sentinel N past counts[t]);
    counts: [T] int32 live candidates per tile (<= K).
    Returns (t_fin [T, 256], acc_c [T, 256, 3], acc_d [T, 256]) — the
    accumulators before the background term — and with `return_end` also
    n_end [T, 256] int32, each pixel's stopping slot or counts[t].
    Records no gradient on CUDA: see `BlendTiles`."""
    global LAUNCHES
    _check(packed, idx, counts)
    if packed.device.type == "cpu":
        return blend_tiles_ref(packed, idx, counts, tiles_x, return_end)
    _check_cuda("blend_tiles", packed, packed=packed, idx=idx, counts=counts)
    if torch.is_grad_enabled() and packed.requires_grad:
        raise RuntimeError("blend_tiles: the raw CUDA launch records no "
                           "gradient; a table that requires grad must go "
                           "through BlendTiles")
    num_tiles, k = idx.shape
    dev = packed.device
    t_fin = torch.empty((num_tiles, PPT), dtype=torch.float32, device=dev)
    acc_c = torch.empty((num_tiles, PPT, 3), dtype=torch.float32, device=dev)
    acc_d = torch.empty((num_tiles, PPT), dtype=torch.float32, device=dev)
    n_end = torch.empty((num_tiles, PPT), dtype=torch.int32, device=dev)
    lib = _build.load_library()
    err = lib.odgs_blend_fwd(
        packed.data_ptr(), idx.data_ptr(), counts.data_ptr(), num_tiles, k,
        tiles_x, t_fin.data_ptr(), acc_c.data_ptr(), acc_d.data_ptr(),
        n_end.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "blend_tiles")
    LAUNCHES += 1
    out = (t_fin, acc_c, acc_d)
    return out + (n_end,) if return_end else out


def blend_bwd_ref(packed: torch.Tensor, idx: torch.Tensor,
                  counts: torch.Tensor, t_fin: torch.Tensor,
                  acc_c: torch.Tensor, acc_d: torch.Tensor,
                  d_tfin: torch.Tensor, d_accc: torch.Tensor,
                  d_accd: torch.Tensor, tiles_x: int,
                  n_end: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch backward of the blend: the explicit algebra of the TPU
    kernel (blend_kernel.py:117-218), vectorized over every (tile, pixel)
    and walked front to back in chunks of 32 slots, recomputing the forward
    state.  With A_i = dC·rgb_i + dD z_i, the running Q_i = Σ_{j<=i} w_j A_j
    (an in-chunk prefix sum) and e = dC·acc_c + dD acc_d + dT t_fin, a
    contributing candidate gets dL/dα_i = T_i A_i - (e - Q_i) / (1 - α_i),
    passed to its power and opacity only while o_i e^power_i < 0.99.
    Returns dg [T, K, 10]: the gradient of each candidate slot's attribute
    row summed over the tile's pixels (zero for skipped, masked or
    post-stop slots).  `n_end` (the forward's end slots) bounds each
    pixel's walk; it changes no gradient."""
    _check(packed, idx, counts)
    num_tiles, k = idx.shape
    dc = d_accc[:, None]                                   # [T, 1, 256, 3]
    dd = d_accd[:, None]
    e = ((d_accc[..., 0] * acc_c[..., 0] + d_accc[..., 1] * acc_c[..., 1]
          + d_accc[..., 2] * acc_c[..., 2])
         + d_accd * acc_d + d_tfin * t_fin)[:, None]       # [T, 1, 256]
    q = torch.zeros_like(t_fin)
    dg = torch.zeros((num_tiles, k, 10), dtype=torch.float32,
                     device=packed.device)
    for c0, ch in _Walk(packed, idx, counts, tiles_x, n_end):
        col = lambda c: ch.a[..., c]                       # noqa: E731
        big_a = (col(5) * dc[..., 0] + col(6) * dc[..., 1]
                 + col(7) * dc[..., 2] + col(9) * dd)
        q_incl = q[:, None] + torch.cumsum(ch.w * big_a, dim=1)
        dalpha = torch.where(
            ch.contrib,
            ch.t_before * big_a - (e - q_incl) / (1.0 - ch.alpha), 0.0)
        unclamped = ch.og < ALPHA_MAX
        dpow = torch.where(unclamped, dalpha * ch.alpha, 0.0)
        dx, dy = ch.dx, ch.dy
        rows = torch.stack([
            dpow * (-(col(2) * dx + col(3) * dy)),          # mean x
            dpow * (-(col(4) * dy + col(3) * dx)),          # mean y
            dpow * (-0.5 * dx * dx),                        # conic a
            dpow * (-dx * dy),                              # conic b
            dpow * (-0.5 * dy * dy),                        # conic c
            ch.w * dc[..., 0], ch.w * dc[..., 1], ch.w * dc[..., 2],
            torch.where(unclamped, dalpha * ch.gexp, 0.0),  # opacity
            ch.w * dd,                                      # depth
        ], dim=-1)
        dg[:, c0:c0 + rows.shape[1]] = rows.sum(dim=2)
        q = q_incl[:, -1]
    return dg


def blend_bwd(packed: torch.Tensor, idx: torch.Tensor, counts: torch.Tensor,
              t_fin: torch.Tensor, acc_c: torch.Tensor, acc_d: torch.Tensor,
              d_tfin: torch.Tensor, d_accc: torch.Tensor,
              d_accd: torch.Tensor, tiles_x: int,
              n_end: torch.Tensor | None = None) -> torch.Tensor:
    """Per-candidate gradient rows dg [T, K, 10] of `blend_tiles` for the
    cotangents (d_tfin, d_accc, d_accd) of its outputs (t_fin, acc_c,
    acc_d).  `n_end`, the forward's end slots (`blend_tiles(...,
    return_end=True)`), bounds each warp's re-walk; without it every walk
    runs to counts[t].  CPU tensors: `blend_bwd_ref`; CUDA tensors: the
    sm_90a kernel of csrc/blend_bwd.cu (deterministic: no atomics)."""
    global LAUNCHES_BWD
    _check(packed, idx, counts)
    if packed.device.type == "cpu":
        return blend_bwd_ref(packed, idx, counts, t_fin, acc_c, acc_d,
                             d_tfin, d_accc, d_accd, tiles_x, n_end)
    num_tiles, k = idx.shape
    fields = dict(packed=packed, idx=idx, counts=counts, t_fin=t_fin,
                  acc_c=acc_c, acc_d=acc_d, d_tfin=d_tfin, d_accc=d_accc,
                  d_accd=d_accd)
    if n_end is not None:
        fields["n_end"] = n_end
    _check_cuda("blend_bwd", packed, **fields)
    for name in ("t_fin", "acc_d", "d_tfin", "d_accd", "n_end"):
        if name not in fields:
            continue
        if fields[name].shape != (num_tiles, PPT):
            raise ValueError(f"blend_bwd: {name} must be "
                             f"{(num_tiles, PPT)}")
    for name in ("acc_c", "d_accc"):
        if fields[name].shape != (num_tiles, PPT, 3):
            raise ValueError(f"blend_bwd: {name} must be "
                             f"{(num_tiles, PPT, 3)}")
    dg = torch.empty((num_tiles, k, 10), dtype=torch.float32,
                     device=packed.device)
    lib = _build.load_library()
    err = lib.odgs_blend_bwd(
        packed.data_ptr(), idx.data_ptr(), counts.data_ptr(),
        None if n_end is None else n_end.data_ptr(), num_tiles, k,
        tiles_x, t_fin.data_ptr(), acc_c.data_ptr(), acc_d.data_ptr(),
        d_tfin.data_ptr(), d_accc.data_ptr(), d_accd.data_ptr(),
        dg.data_ptr(), torch.cuda.current_stream(packed.device).cuda_stream)
    _build.check(err, "blend_bwd")
    LAUNCHES_BWD += 1
    return dg


def candidate_grads_to_rows(dg: torch.Tensor, gidx: torch.Tensor
                            ) -> torch.Tensor:
    """Sum the per-candidate rows dg [T, K, 10] onto the table rows.

    gidx [D, N] int32 holds, for tile slot s of Gaussian n, the flat
    candidate index t*K + k of its entry, or T*K where the entry was not
    binned (sentinel tile, or dropped past K) — see
    rasterize._bin_tiles_single.  A gather and a sum over the D slots: no
    atomics, the same result every run.  Returns [N + 1, 10] (the sentinel
    row's gradient is 0)."""
    flat = torch.cat([dg.reshape(-1, dg.shape[-1]),
                      dg.new_zeros((1, dg.shape[-1]))])
    rows = flat[gidx.long()].sum(0)                        # [N, 10]
    return torch.cat([rows, rows.new_zeros((1, rows.shape[-1]))])


class BlendTiles(torch.autograd.Function):
    """blend_tiles with its backward: forward kernel (or plain twin on the
    CPU), backward kernel, then `candidate_grads_to_rows` onto the packed
    table.  Inputs (packed [N + 1, 10], idx, counts, gidx, tiles_x);
    outputs (t_fin, acc_c, acc_d)."""

    @staticmethod
    def forward(ctx, packed, idx, counts, gidx, tiles_x: int):
        t_fin, acc_c, acc_d, n_end = blend_tiles(packed, idx, counts,
                                                 tiles_x, return_end=True)
        ctx.save_for_backward(packed, idx, counts, gidx, t_fin, acc_c, acc_d,
                              n_end)
        ctx.tiles_x = tiles_x
        return t_fin, acc_c, acc_d

    @staticmethod
    def backward(ctx, d_tfin, d_accc, d_accd):
        (packed, idx, counts, gidx, t_fin, acc_c, acc_d,
         n_end) = ctx.saved_tensors
        dg = blend_bwd(packed, idx, counts, t_fin, acc_c, acc_d,
                       d_tfin.contiguous(), d_accc.contiguous(),
                       d_accd.contiguous(), ctx.tiles_x, n_end)
        return candidate_grads_to_rows(dg, gidx), None, None, None, None
