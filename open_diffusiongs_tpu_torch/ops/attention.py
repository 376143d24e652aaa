"""Full multi-head attention: CUDA kernels + plain PyTorch twins.

Counterparts of open_diffusiongs_tpu/ops/attention.py:
  * `flash_mha_packed` (with and without stats, and `scalar_max=True`) and
    `flash_mha_packed_bwd` on the DiT's packed layout [b, Lp, h*dh]:
    csrc/flash_attn_fwd.cu (forward, optionally with the base-2
    log-sum-exp, or with one running max per q tile) and
    csrc/flash_attn_bwd.cu (the dQ and dK/dV kernels);
  * `flash_full_mha` (:638-665) on [b, l, h, d], the DiT's general route:
    csrc/flash_full_fwd.cu, which also runs the bench variant `mha_full`
    of tools/bench_attn2.py (:89-126) on [h, L, 64] and, in a kernel of
    its own (flash_full_stats_kernel), the route's training forward;
    csrc/flash_full_bwd.cu is that forward's backward (see below).
All the kernels are warp-specialised TMA + mbarrier rings feeding `wgmma`
(csrc/hopper.cuh).
The plain versions (`*_ref`) compute the same functions with explicit f32
formulas.  Each wrapper takes its plain version only for CPU tensors (the
test oracle); on a CUDA tensor it launches its kernel or raises — never a
silent fallback.

Gradients: the raw CUDA launches record no autograd graph, so they refuse
inputs that require grad while grad mode is on.  The differentiable entry
is `flash_attention(qkv, ...)`, which routes through `FlashMHAPacked`: its
forward runs the stats forward and saves (qkv, o, lse), as the JAX
custom_vjp saves (q, k, v, o, lse) (models/transformer.py:266-283); its
backward runs the backward kernels and returns one contiguous [b, L, 3·h·dh]
gradient for the fused qkv projection.  Under `torch.no_grad` (sampling)
`flash_attention` runs the stats-free forward.

The general route trains through `flash_full_attention(q, k, v)`, which
routes through `FlashFullMHA`: JAX differentiates that route through
splash on `q * d^-1/2` (transformer.py:116-152, a JAX library kernel), so
the port has its own pair: the stats forward #5s (a flag of
csrc/flash_full_fwd.cu) computes that training function and its base-2
lse, and csrc/flash_full_bwd.cu (#5b) its dq, dk and dv.  The training
function rounds q's pre-scale as splash's input does, bf16(q·bf16(d^-½)),
not as #5's serving forward, bf16(q·bf16(d^-½·log₂e)) (`_full_prescaled_q`,
0.18 % apart at d = 64); `flash_full_attention` under no_grad runs #5, as
JAX keeps that primal for inference.

The splash route (`splash_attention`): JAX sends every head wider than 64
and every `attn_impl: splash` to splash on `q * d^-1/2` in training and
inference alike (transformer.py:159-166).  That is the training function
above, so under grad it is `FlashFullMHA` and under no_grad `splash_mha`,
#5s's kernel without its lse (never #5's serving pre-scale).  #5s and #5b
take heads up to 128 (a DH = 128 tile, two 128-byte swizzle spans a row);
#5 keeps JAX's d <= 64.

The JAX DiT pads the token axis once around the whole stack to a block
multiple (transformer.py:525-538, plan_packed :125-139: 4098 -> 4608 at
256^2).  The port's kernels mask the ragged tile themselves, so the port's
DiT runs at Lp = L on one rank; the real rows agree either way.  Under
sequence parallelism it pads to `plan_packed`'s length, which the ranks
split evenly (models/transformer.py).

Query and key extents: the packed kernels #1s and #3 take `lq_real` (the
query rows whose lse and dq they produce) apart from `lk_real` (the keys
that take part, and the dk / dv rows they produce); `l_real` sets both.
The ring steps of parallel/ring.py need them apart: a full query shard
meets the tail shard's keys, and the tail's queries meet a full shard's.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from . import _build

LOG2E = math.log2(math.e)

LAUNCHES = 0         # stats-free forward kernel launches (CUDA tensors only)
LAUNCHES_STATS = 0   # forward-with-lse kernel launches
LAUNCHES_SMAX = 0    # scalar-max packed forward launches
LAUNCHES_BWD = 0     # backward launches (one dQ + one dK/dV kernel each)
LAUNCHES_FULL = 0    # flash_full_mha kernel launches (the general route)
LAUNCHES_MHA_FULL = 0  # mha_full (bench variant) kernel launches
LAUNCHES_FULL_STATS = 0  # flash_full_mha_stats (#5s) kernel launches
LAUNCHES_FULL_BWD = 0    # flash_full_mha_bwd (#5b) calls (3 launches each)
LAUNCHES_SPLASH = 0      # splash_mha (#5s, its lse dropped) launches

PACKED_DH = (16, 32, 64)   # head widths of the packed kernels
FULL_MAX_D = 64            # widest head of #5 (JAX's flash_full_mha)
SPLASH_MAX_D = 128         # widest head of #5s / #5b (the splash route)
SMAX_BLOCK_ROWS = 64       # q rows per block of the scalar-max kernel
FULL_BWD_KEYS = 128        # keys per CTA of #5b's main pass (a key block)
# #5s (csrc/flash_full_fwd.cu, flash_full_stats_kernel): keys of a key
# tile, and the base-2 rise of a row's max that moves it (the schedule by
# tile width: full_fwd_schedule)
FULL_FWD_KEYS = 128
FULL_FWD_RESCALE_TAU = 8.0


def _check_shapes(q, k, v, num_heads: int, l_real=None, lq_real=None,
                  lk_real=None):
    """Shapes and extents of a packed call: (b, Lp, h*dh, dh, lq_real,
    lk_real), each extent defaulting to `l_real`."""
    if q.dim() != 3 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q/k/v must share one [b, Lp, h*dh] shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, lp, hd = q.shape
    if hd % num_heads:
        raise ValueError(f"width {hd} is not divisible by {num_heads} heads")
    lq = l_real if lq_real is None else lq_real
    lk = l_real if lk_real is None else lk_real
    for name, n in (("lq_real", lq), ("lk_real", lk)):
        if n is None:
            raise ValueError(f"give l_real or {name}")
        if not 1 <= n <= lp:
            raise ValueError(f"{name}={n} outside [1, Lp={lp}]")
    return b, lp, hd, hd // num_heads, int(lq), int(lk)


def plan_packed(l: int) -> tuple[int, tuple[int, int]]:
    """(padded length, (bq, bkv)) for a DiT token count l: JAX's plan
    (ops/attention.py:125-139 of the JAX package), copied.  The port pads
    to this length under sequence parallelism only (the ranks split it
    evenly: 4098 -> 4608, 16386 -> 16896); its kernels need no block
    multiple, so the blocks are the TPU's and unused here."""
    lp = -(-l // 512) * 512
    if l > 2048 and lp % 1536 == 0:
        return lp, ((1536, 512) if l >= 8192 else (1536, 768))
    return lp, (512, 512)


def tma_compatible(data_ptr: int, strides, itemsize: int) -> bool:
    """TMA's rule for a tensor map over a view: the base 16-byte aligned and
    every stride but the last (contiguous) one a multiple of 16 bytes, so
    every row starts 16-byte aligned."""
    return (data_ptr % 16 == 0
            and all(s * itemsize % 16 == 0 for s in tuple(strides)[:-1]))


def stats_pitch(lp: int) -> int:
    """Row pitch of the backward kernels' lse / delta layout [b, h, pitch]:
    Lp rounded up to a multiple of 4 f32, so each row starts 16-byte
    aligned for TMA (csrc/flash_attn_bwd.cu::stats_pitch)."""
    return -(-lp // 4) * 4


def _stats_by_head(x: torch.Tensor) -> torch.Tensor:
    """[b, Lp, h] f32 -> zero-padded [b, h, stats_pitch(Lp)]."""
    b, lp, h = x.shape
    out = x.new_zeros((b, h, stats_pitch(lp)))
    out[..., :lp] = x.transpose(1, 2)
    return out


def _delta_by_head(do: torch.Tensor, o: torch.Tensor, num_heads: int,
                   l_real: int) -> torch.Tensor:
    """delta = rowsum(dO * O) per head in f32, reduced straight into the
    backward kernels' zero-padded [b, h, stats_pitch(Lp)] layout over the
    query rows < l_real (a launch's lq_real) only: the kernels never read
    dO, O or delta on the rows past it (their tensor maps end there), so dO
    needs no mask."""
    b, lp, hd = o.shape
    out = torch.zeros((b, num_heads, stats_pitch(lp)), dtype=torch.float32,
                      device=o.device)
    prod = do[:, :l_real].to(torch.float32, copy=True).mul_(o[:, :l_real])
    torch.sum(prod.reshape(b, l_real, num_heads, hd // num_heads), -1,
              out=out[..., :l_real].transpose(1, 2))
    return out


def _check_bf16_cuda(what: str, xs: dict, aligned: bool = True):
    """Device, dtype and layout checks of a kernel launch's bf16 operands:
    on the first one's CUDA device, last dimension contiguous and, with
    `aligned`, every row starting 16-byte aligned (column slices of a fused
    projection qualify)."""
    ref = next(iter(xs.values()))
    if ref.device.type != "cuda":
        raise RuntimeError(f"{what}: unsupported device {ref.device}")
    for name, x in xs.items():
        if x.device != ref.device:
            raise ValueError(f"{what}: {name} is on {x.device}, not "
                             f"{ref.device}")
        if x.dtype != torch.bfloat16:
            raise TypeError(f"{what}: {name} must be bfloat16, got {x.dtype}")
        if x.stride(-1) != 1:
            raise ValueError(f"{what}: {name}: last dimension must be "
                             f"contiguous")
        if aligned and not tma_compatible(x.data_ptr(), x.stride(),
                                          x.element_size()):
            raise ValueError(f"{what}: {name}: rows must start 16-byte "
                             f"aligned (strides {x.stride()})")


def _check_cuda(what: str, ref: torch.Tensor, dh: int, bf16: dict,
                f32: dict = None):
    """Launch checks of the packed kernels: dh, the `bf16` operands as
    `_check_bf16_cuda` (rows aligned), `f32` tensors contiguous on ref's
    device."""
    if dh not in PACKED_DH:
        raise ValueError(f"{what}: head dim {dh}: the packed kernels take dh "
                         f"16, 32 or 64 (JAX also packs 8, 4, 2 and 1; the "
                         f"port does not)")
    _check_bf16_cuda(what, bf16)
    for name, x in (f32 or {}).items():
        if x.device != ref.device:
            raise ValueError(f"{what}: {name} is on {x.device}, not "
                             f"{ref.device}")
        if x.dtype != torch.float32 or not x.is_contiguous():
            raise TypeError(f"{what}: {name} must be contiguous float32")


def _refuse_grad(what: str, *xs: torch.Tensor, route: str =
                 "flash_attention (FlashMHAPacked)"):
    if torch.is_grad_enabled() and any(x.requires_grad for x in xs):
        raise RuntimeError(
            f"{what}: the raw CUDA launch records no gradient; inputs that "
            f"require grad must go through {route}")


def _heads(x: torch.Tensor, n: int, num_heads: int) -> torch.Tensor:
    """[b, Lp, h*dh] -> f32 [b, h, n, dh] of the first n rows."""
    b, _, hd = x.shape
    return x[:, :n].float().reshape(b, n, num_heads,
                                    hd // num_heads).transpose(1, 2)


def _unheads(x: torch.Tensor) -> torch.Tensor:
    """[b, h, n, dh] -> [b, n, h*dh]."""
    b, h, n, dh = x.shape
    return x.transpose(1, 2).reshape(b, n, h * dh)


def _prescaled_q(q: torch.Tensor, dh: int) -> torch.Tensor:
    """q~ = q * dh^-1/2 * log2(e), rounded to q's dtype (as the kernels):
    PyTorch multiplies a bf16 / f16 tensor by a Python scalar in f32 and
    rounds once, which is bf16(f32(q) * f32(scale)) without an f32 copy
    of q (held bit for bit by tests/test_torch_build.py and on the card by
    chip_smoke.py phase 6)."""
    return q * (dh ** -0.5 * LOG2E)


def _block_max(s: torch.Tensor, block_rows: int, pad_keys: bool
               ) -> torch.Tensor:
    """The scalar-max kernel's shared max: over each block of `block_rows`
    q rows (the last one partial) and every key of s [b, h, Lp, n], and the
    pad keys' score 0 when there are any; broadcast back to [b, h, Lp, 1]."""
    b, h, lp, n = s.shape
    nb = -(-lp // block_rows)
    sp = torch.nn.functional.pad(s.amax(-1), (0, nb * block_rows - lp),
                                 value=-torch.inf)
    m = sp.reshape(b, h, nb, block_rows).amax(-1)
    if pad_keys:
        m = m.clamp(min=0.0)
    return m.repeat_interleave(block_rows, dim=-1)[..., :lp, None]


def flash_mha_packed_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, num_heads: int, l_real: int | None = None,
                         lq_real: int | None = None,
                         lk_real: int | None = None,
                         with_stats: bool = False, scalar_max: bool = False,
                         block_rows: int = SMAX_BLOCK_ROWS,
                         out_f32: bool = False):
    """Plain PyTorch version of the forward kernel: explicit f32 matmuls and
    a softmax in base 2 over the keys < lk_real, with q~ as the kernels form
    it.  Returns o [b, Lp, h*dh] in q's dtype, or unrounded f32 with
    `out_f32` (every row computed; rows >= lq_real are the caller's pad
    rows), and with `with_stats` also lse [b, Lp, h] f32: m + log2(sum
    2^(s - m)) of every row < lq_real, 0 past it.  `l_real` sets both
    extents.

    `scalar_max` is the block-scalar recurrence of `_fwd_kernel_packed_smax`
    (JAX :146-210) in closed form: one shared max M per block of
    `block_rows` q rows (the kernel's q tile: 64 for the CUDA kernel, bq on
    the TPU) and head, over all its rows < Lp (pad rows included) and keys
    < lk_real, plus the zeroed pad keys' score 0 when Lp > lk_real; then
    p = 2^(s - M) and o = p·v / max(sum p, 1e-30).  A row whose scores all
    sit > ~126 below M underflows to o = 0, as on the TPU (precondition
    :157-163)."""
    b, lp, hd, dh, lq, lk = _check_shapes(q, k, v, num_heads, l_real,
                                          lq_real, lk_real)
    if scalar_max and with_stats:
        raise ValueError("flash_mha_packed: scalar_max exports no stats "
                         "(the stats need the row-max kernel)")
    s = torch.matmul(_heads(_prescaled_q(q, dh), lp, num_heads),
                     _heads(k, lk, num_heads).transpose(-1, -2))
    m = (_block_max(s, block_rows, lp > lk) if scalar_max
         else s.amax(dim=-1, keepdim=True))
    p = torch.exp2(s - m)
    l = p.sum(dim=-1, keepdim=True)
    if scalar_max:
        l = l.clamp(min=1e-30)
    o = _unheads(torch.matmul(p, _heads(v, lk, num_heads)) / l)
    o = o.to(torch.float32 if out_f32 else q.dtype)
    if not with_stats:
        return o
    lse = (m + torch.log2(l))[..., 0].transpose(1, 2)       # [b, Lp, h]
    real = torch.arange(lp, device=q.device)[None, :, None] < lq
    return o, torch.where(real, lse, 0.0).contiguous()


def flash_mha_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     num_heads: int, l_real: int | None = None,
                     lq_real: int | None = None, lk_real: int | None = None,
                     with_stats: bool = False, scalar_max: bool = False,
                     out_f32: bool = False):
    """Full MHA on the packed layout [b, Lp, h*dh] (head h in columns
    h*dh .. h*dh+dh-1); keys >= lk_real are excluded.  Returns a new
    contiguous [b, Lp, h*dh] tensor in q's dtype (rows >= lq_real are the
    caller's pad rows, computed and meaningless), and with `with_stats`
    also the base-2 lse [b, Lp, h] f32 of every row < lq_real (0 past it).
    `l_real` sets both extents (the one-rank DiT: lq_real = lk_real = L);
    a ring step sets them apart (parallel/ring.py) and takes o in f32
    (`out_f32`: the values the bf16 output rounds, for a merge that rounds
    once).
    `scalar_max` runs the block-scalar recurrence (one running max per
    64-row q tile and head; see `flash_mha_packed_ref`), which exports no
    stats.

    CPU tensors: `flash_mha_packed_ref` (with block_rows 64, the kernel's q
    tile).  CUDA tensors: the sm_90a kernel, which takes bf16, dh in
    {16, 32, 64} (the packed layouts of dh <= 64 with 128 % dh == 0; the
    flagship's 64), a contiguous last dimension and 16-byte aligned rows —
    q/k/v may be column slices of one fused qkv projection.  It records no
    gradient: see `flash_attention`."""
    global LAUNCHES, LAUNCHES_STATS, LAUNCHES_SMAX
    b, lp, hd, dh, lq, lk = _check_shapes(q, k, v, num_heads, l_real,
                                          lq_real, lk_real)
    if scalar_max and with_stats:
        raise ValueError("flash_mha_packed: scalar_max exports no stats "
                         "(the stats need the row-max kernel)")
    if q.device.type == "cpu":
        return flash_mha_packed_ref(q, k, v, num_heads=num_heads,
                                    lq_real=lq, lk_real=lk,
                                    with_stats=with_stats,
                                    scalar_max=scalar_max, out_f32=out_f32)
    _check_cuda("flash_mha_packed", q, dh, dict(q=q, k=k, v=v))
    _refuse_grad("flash_mha_packed", q, k, v)
    out = torch.empty((b, lp, hd), device=q.device,
                      dtype=torch.float32 if out_f32 else q.dtype)
    lse = (torch.empty((b, lp, num_heads), dtype=torch.float32,
                       device=q.device) if with_stats else None)
    lib = _build.load_library()
    err = lib.odgs_flash_attn_fwd_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), b, lp, num_heads, dh,
        lk, lq, dh ** -0.5 * LOG2E,
        q.stride(0), q.stride(1), k.stride(0), k.stride(1),
        v.stride(0), v.stride(1), int(scalar_max), int(out_f32),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_mha_packed")
    if with_stats:
        LAUNCHES_STATS += 1
        return out, lse
    if scalar_max:
        LAUNCHES_SMAX += 1
    else:
        LAUNCHES += 1
    return out


def _masked_cotangent(do: torch.Tensor, o: torch.Tensor, num_heads: int,
                      l_real: int):
    """dO with rows >= l_real zeroed, in o's dtype, and
    delta = rowsum(dO * O) per head [b, Lp, h] f32 (JAX :468-473)."""
    b, lp, hd = o.shape
    real = torch.arange(lp, device=do.device)[None, :, None] < l_real
    do = torch.where(real, do, 0).to(o.dtype).contiguous()
    delta = (do.float() * o.float()).reshape(b, lp, num_heads, -1).sum(-1)
    return do, delta.contiguous()


def flash_mha_packed_bwd_ref(q, k, v, o, do, lse, *, num_heads: int,
                             l_real: int | None = None,
                             lq_real: int | None = None,
                             lk_real: int | None = None, out_dtype=None):
    """Plain PyTorch version of the backward kernels (explicit f32):
    P = exp2(q~·kᵀ - lse), dS = P ∘ (dO·vᵀ - δ), dq = dh^-1/2 dS·k,
    dk = ln2 dSᵀ·q~, dv = Pᵀ·dO over keys < lk_real, with dO and the rows
    of P and dS zeroed on query rows >= lq_real.  Returns (dq, dk, dv) in
    the primal dtypes (or `out_dtype`), dq rows >= lq_real and dk / dv rows
    >= lk_real exactly 0.  `l_real` sets both extents."""
    b, lp, hd, dh, lq, lk = _check_shapes(q, k, v, num_heads, l_real,
                                          lq_real, lk_real)
    do, delta = _masked_cotangent(do, o, num_heads, lq)
    qs = _heads(_prescaled_q(q, dh), lp, num_heads)             # [b,h,Lp,dh]
    kh, vh = _heads(k, lk, num_heads), _heads(v, lk, num_heads)
    doh = _heads(do, lp, num_heads)
    real = (torch.arange(lp, device=q.device) < lq)[None, None, :, None]
    p = torch.exp2(torch.matmul(qs, kh.transpose(-1, -2))
                   - lse.transpose(1, 2)[..., None].float())
    p = torch.where(real, p, 0.0)
    ds = p * (torch.matmul(doh, vh.transpose(-1, -2))
              - delta.transpose(1, 2)[..., None])
    ds = torch.where(real, ds, 0.0)
    dq = torch.where(real, torch.matmul(ds, kh), 0.0) * dh ** -0.5
    pad = (0, 0, 0, lp - lk)
    dk = torch.nn.functional.pad(
        torch.matmul(ds.transpose(-1, -2), qs) / LOG2E, pad)
    dv = torch.nn.functional.pad(torch.matmul(p.transpose(-1, -2), doh), pad)
    return (_unheads(dq).to(out_dtype or q.dtype),
            _unheads(dk).to(out_dtype or k.dtype),
            _unheads(dv).to(out_dtype or v.dtype))


def _bwd_fused(q, k, v, o, do, lse, num_heads: int, lq_real: int,
               lk_real: int, out_f32: bool = False) -> torch.Tensor:
    """(dq | dk | dv) as one [b, Lp, 3*h*dh] tensor, in q's dtype or, with
    `out_f32`, f32 (a ring step's parts, summed before they are rounded)."""
    global LAUNCHES_BWD
    b, lp, hd, dh, lq, lk = _check_shapes(q, k, v, num_heads, None, lq_real,
                                          lk_real)
    out_dtype = torch.float32 if out_f32 else q.dtype
    if q.device.type == "cpu":
        return torch.cat(flash_mha_packed_bwd_ref(
            q, k, v, o, do, lse, num_heads=num_heads, lq_real=lq,
            lk_real=lk, out_dtype=out_dtype), -1)
    do = do.to(o.dtype).contiguous()    # no copy for the DiT's cotangent
    _check_cuda("flash_mha_packed_bwd", q, dh, dict(q=q, k=k, v=v, o=o,
                                                    do=do), dict(lse=lse))
    if lse.shape != (b, lp, num_heads):
        raise ValueError(f"flash_mha_packed_bwd: lse must be "
                         f"{(b, lp, num_heads)}, got {tuple(lse.shape)}")
    _refuse_grad("flash_mha_packed_bwd", q, k, v, o, do)
    # the kernels read q~ (formed once here, as the forward rounds it), dO
    # as given (TMA reads its rows >= lq_real as 0) and lse / delta per
    # head, each through a TMA tensor map
    qs = _prescaled_q(q, dh)
    lse_h = _stats_by_head(lse)
    delta_h = _delta_by_head(do, o, num_heads, lq)
    dqkv = torch.empty((b, lp, 3 * hd), dtype=out_dtype, device=q.device)
    dq, dk, dv = dqkv.chunk(3, dim=-1)
    lib = _build.load_library()
    err = lib.odgs_flash_attn_bwd_bf16(
        qs.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse_h.data_ptr(), delta_h.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), b, lp, num_heads, dh, lk, lq, dh ** -0.5 * LOG2E,
        qs.stride(0), qs.stride(1), k.stride(0), k.stride(1),
        v.stride(0), v.stride(1), do.stride(0), do.stride(1),
        dq.stride(0), dq.stride(1), dk.stride(0), dk.stride(1),
        dv.stride(0), dv.stride(1), int(out_f32),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_mha_packed_bwd")
    LAUNCHES_BWD += 1
    return dqkv


def flash_mha_packed_bwd(q, k, v, o, do, lse, *, num_heads: int,
                         l_real: int | None = None,
                         lq_real: int | None = None,
                         lk_real: int | None = None):
    """(dq, dk, dv) of `flash_mha_packed` from the stats forward's o and
    lse and the output cotangent do (pad rows may hold garbage: they are
    masked).  Primal dtypes; dq rows >= lq_real and dk / dv rows >=
    lk_real exactly 0.  `l_real` sets both extents; a ring step passes the
    global o and lse of its query rows with the extents of its query shard
    and its key slice (parallel/ring.py).

    CPU tensors: `flash_mha_packed_bwd_ref`.  CUDA tensors: the two
    sm_90a kernels of csrc/flash_attn_bwd.cu (bf16, dh 16, 32 or 64), whose
    three outputs are column slices of one fused [b, Lp, 3*h*dh] tensor.
    delta = rowsum(dO * O) is formed here in plain torch, as in JAX."""
    lq, lk = _check_shapes(q, k, v, num_heads, l_real, lq_real, lk_real)[4:]
    return _bwd_fused(q, k, v, o, do, lse, num_heads, lq, lk).chunk(3, -1)


class FlashMHAPacked(torch.autograd.Function):
    """Attention over the fused qkv projection [b, L, 3*h*dh] (q | k | v
    column thirds): forward = the stats forward, backward = the backward
    kernels.  Saves only qkv (= q, k, v), o and lse."""

    @staticmethod
    def forward(ctx, qkv, num_heads: int, l_real: int):
        q, k, v = qkv.chunk(3, dim=-1)
        o, lse = flash_mha_packed(q, k, v, num_heads=num_heads,
                                  l_real=l_real, with_stats=True)
        ctx.save_for_backward(qkv, o, lse)
        ctx.num_heads, ctx.l_real = num_heads, l_real
        return o

    @staticmethod
    def backward(ctx, do):
        qkv, o, lse = ctx.saved_tensors
        q, k, v = qkv.chunk(3, dim=-1)
        return (_bwd_fused(q, k, v, o, do, lse, ctx.num_heads, ctx.l_real,
                           ctx.l_real), None, None)


def flash_attention(qkv: torch.Tensor, *, num_heads: int, l_real: int
                    ) -> torch.Tensor:
    """The DiT's attention on its fused qkv projection: differentiable
    through `FlashMHAPacked` when qkv requires grad and grad mode is on,
    otherwise the stats-free forward on column slices of qkv."""
    if torch.is_grad_enabled() and qkv.requires_grad:
        return FlashMHAPacked.apply(qkv, num_heads, l_real)
    q, k, v = qkv.chunk(3, dim=-1)
    return flash_mha_packed(q, k, v, num_heads=num_heads, l_real=l_real)


# ---------------------------------------------------------------------------
# The general route: [b, l, h, d], any d <= 64 (JAX flash_full_mha), its
# training pair and the splash route (d <= 128), and the bench variant
# mha_full of tools/bench_attn2.py.
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _full_scale(d: int, dtype: torch.dtype) -> float:
    """d^-1/2 * log2(e) rounded to `dtype`, as JAX forms it (:652)."""
    return float(torch.tensor(d ** -0.5 * LOG2E, dtype=dtype))


def _full_prescaled_q(q: torch.Tensor) -> torch.Tensor:
    """q~ of flash_full_mha: `q * scale` with the scale AND the product in
    q's dtype (JAX :652-654).  In bf16 the scale itself is rounded (d = 64:
    0.18066 for 0.18034, +0.18 %), unlike the packed path's `_prescaled_q`,
    which multiplies in f32 and rounds once."""
    return q * torch.tensor(_full_scale(q.shape[-1], q.dtype),
                            dtype=q.dtype, device=q.device)


def _check_full(q, k, v, max_d: int = FULL_MAX_D):
    """q [b, l, h, d] and k/v [b, lk, h, d] (lk may differ: the second half
    of subset attention), d <= max_d; returns (b, l, lk, h, d)."""
    if (q.dim() != 4 or k.dim() != 4 or k.shape != v.shape
            or (q.shape[0], *q.shape[2:]) != (k.shape[0], *k.shape[2:])
            or k.shape[1] == 0):
        raise ValueError(f"q/k/v must be [b, l, h, d] / [b, lk, h, d], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if not 1 <= q.shape[-1] <= max_d:
        if max_d == FULL_MAX_D:
            raise ValueError(f"flash_full_mha: head dim {q.shape[-1]}: the "
                             f"kernel takes d <= 64 (JAX sends wider heads "
                             f"to splash: splash_attention)")
        raise ValueError(f"head dim {q.shape[-1]}: the splash route's "
                         f"kernels take d <= {SPLASH_MAX_D} (wider heads: "
                         f"ROADMAP, Limits, not faults)")
    b, l, h, d = q.shape
    return b, l, k.shape[1], h, d


def flash_full_mha_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                       ) -> torch.Tensor:
    """Plain PyTorch version of the general-route kernel: q~ as
    `_full_prescaled_q`, then f32 scores, a base-2 softmax over all keys
    with the denominator clamped at 1e-30 (:73), and P·V in f32.  Returns
    [b, l, h, d] in q's dtype."""
    _check_full(q, k, v)
    s = torch.einsum("blhd,bmhd->bhlm", _full_prescaled_q(q).float(),
                     k.float())
    p = torch.exp2(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True).clamp(min=1e-30)
    o = torch.einsum("bhlm,bmhd->blhd", p / l, v.float())
    return o.to(q.dtype)


def full_tile_width(d: int) -> int:
    """The general-route kernels' tile width for a head width d <= 128: the
    smallest of 16, 32, 64 and 128 that holds it (one swizzle span a row,
    two at 128)."""
    return 16 if d <= 16 else 32 if d <= 32 else 64 if d <= 64 else 128


def full_takes_view(data_ptr: int, shape, strides, itemsize: int) -> bool:
    """Whether csrc/flash_full_fwd.cu reads a [b, l, h, d] view as it lies,
    through its 4-D TMA map {d, h, l, b}: last dimension contiguous, base
    16-byte aligned, d and the stride of every dimension longer than 1
    multiples of 16 bytes.  A rule on shapes and strides alone; a view it
    refuses goes to the kernel as a zero-padded copy (`_full_operands`)."""
    if strides[-1] != 1 or data_ptr % 16 or shape[-1] * itemsize % 16:
        return False
    for n, s in zip(shape[:-1], strides[:-1]):
        if n > 1 and s * itemsize % 16:
            return False
    return True


def _full_operands(*xs: torch.Tensor):
    """The kernel's operands and the columns its maps read: the views
    themselves (d) when `full_takes_view` takes all of them, else
    contiguous copies zero-padded to the tile width (one copy each)."""
    d = xs[0].shape[-1]
    if all(full_takes_view(x.data_ptr(), x.shape, x.stride(),
                           x.element_size()) for x in xs):
        return xs, d
    width = full_tile_width(d)
    padded = []
    for x in xs:
        p = x.new_zeros((*x.shape[:-1], width))
        p[..., :d] = x
        padded.append(p)
    return tuple(padded), width


def _launch_full(what: str, q, k, v, out, lk: int, scale: float,
                 pv_f32: bool, score_bf16: bool) -> None:
    """One launch of csrc/flash_full_fwd.cu: q [b, lq, h, d] and k/v
    [b, >= lk, h, d] bf16 views, out a contiguous [b, lq, h, d]; views TMA
    cannot address are padded first."""
    (q, k, v), dm = _full_operands(q, k, v)
    b, lq, h, _ = q.shape
    err = _build.load_library().odgs_flash_full_fwd_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, lq, lk,
        h, out.shape[-1], dm, scale, *q.stride()[:3], *k.stride()[:3],
        *v.stride()[:3], int(pv_f32), int(score_bf16),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, what)


def flash_full_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                   ) -> torch.Tensor:
    """Full multi-head attention on q/k/v [b, l, h, d] with any d <= 64, any
    h and any l (JAX flash_full_mha; the kernel masks its ragged tiles).
    k/v may hold another number of rows than q (subset attention's second
    half; JAX's kernel takes equal lengths only).  Returns a new contiguous
    [b, l, h, d] tensor in q's dtype.

    CPU tensors: `flash_full_mha_ref`.  CUDA tensors: the sm_90a kernel of
    csrc/flash_full_fwd.cu (bf16, last dimension contiguous), which reads
    the views through TMA where `full_takes_view` allows (column slices of
    a fused qkv, d 64 / 48 / 40, subset halves) and zero-padded copies
    otherwise (e.g. d = 20: 40-byte heads).  It records no gradient and
    refuses inputs that require grad under grad mode: training goes
    through `flash_full_attention` (`FlashFullMHA`)."""
    global LAUNCHES_FULL
    b, l, lk, h, d = _check_full(q, k, v)
    if q.device.type == "cpu":
        return flash_full_mha_ref(q, k, v)
    _refuse_grad("flash_full_mha", q, k, v, route=FULL_ROUTE)
    _check_bf16_cuda("flash_full_mha", dict(q=q, k=k, v=v), aligned=False)
    out = torch.empty((b, l, h, d), dtype=q.dtype, device=q.device)
    _launch_full("flash_full_mha", q, k, v, out, lk, _full_scale(d, q.dtype),
                 pv_f32=True, score_bf16=False)
    LAUNCHES_FULL += 1
    return out


FULL_ROUTE = "flash_full_attention (FlashFullMHA)"


@functools.lru_cache(maxsize=None)
def _train_scale(d: int, dtype: torch.dtype) -> float:
    """d^-1/2 rounded to `dtype`: the scale of the general route's training
    function, splash on `q_ * scale` with a weak-typed Python scale
    (transformer.py:141-146), which JAX rounds to q's dtype."""
    return float(torch.tensor(d ** -0.5, dtype=dtype))


def _train_prescaled_q(q: torch.Tensor) -> torch.Tensor:
    """q~ of the training function: q · `_train_scale`, the product taken in
    f32 and rounded once to q's dtype (PyTorch's rule for a Python scalar),
    which for bf16 is JAX's bf16 product bit for bit: two bf16 values
    multiply exactly in f32.  In bf16 this is NOT #5's `_full_prescaled_q`
    (whose scale folds in log2 e before rounding)."""
    return q * _train_scale(q.shape[-1], q.dtype)


def flash_full_mha_stats_ref(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor):
    """Plain PyTorch version of #5s: q~ = `_train_prescaled_q(q)`, f32
    scores s = q~·kᵀ, a natural-base softmax over all keys (taken as
    2^(s·log2 e - m)) and P·V in f32.  Returns o [b, l, h, d] in q's dtype
    and the base-2 lse [b, h, l] f32, log2 Σ_keys 2^(s·log2 e).  Any
    d <= 128."""
    _check_full(q, k, v, SPLASH_MAX_D)
    s = torch.einsum("blhd,bmhd->bhlm", _train_prescaled_q(q).float(),
                     k.float()) * LOG2E
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp2(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhlm,bmhd->blhd", p / l, v.float())
    return o.to(q.dtype), (m + torch.log2(l))[..., 0]


def _check_full_bwd(q, k, v, o, do, lse):
    b, l, lk, h, d = _check_full(q, k, v, SPLASH_MAX_D)
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"o / do must be {tuple(q.shape)}, got "
                         f"{tuple(o.shape)}, {tuple(do.shape)}")
    if lse.shape != (b, h, l):
        raise ValueError(f"lse must be {(b, h, l)}, got {tuple(lse.shape)}")
    return b, l, lk, h, d


def flash_full_mha_bwd_ref(q, k, v, o, do, lse):
    """Plain PyTorch version of #5b (explicit f32): P = exp2(log2 e ·
    (q~·kᵀ) - lse), dS = P ∘ (dO·vᵀ - δ) with δ = rowsum(dO ∘ O),
    dq = `_train_scale` · dS·k, dk = dSᵀ·q~, dv = Pᵀ·dO.  Returns
    (dq, dk, dv) in the primal dtypes."""
    b, l, lk, h, d = _check_full_bwd(q, k, v, o, do, lse)
    qs = _train_prescaled_q(q).float()
    kf, dof = k.float(), do.float()
    p = torch.exp2(torch.einsum("blhd,bmhd->bhlm", qs, kf) * LOG2E
                   - lse.float()[..., None])
    delta = (dof * o.float()).sum(-1).transpose(1, 2)[..., None]
    ds = p * (torch.einsum("blhd,bmhd->bhlm", dof, v.float()) - delta)
    dq = torch.einsum("bhlm,bmhd->blhd", ds, kf) * _train_scale(d, q.dtype)
    dk = torch.einsum("bhlm,blhd->bmhd", ds, qs)
    dv = torch.einsum("bhlm,blhd->bmhd", p, dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class FullFwdSchedule(NamedTuple):
    """#5s's schedule at a head tile (csrc/flash_full_fwd.cu, Sched):
    `consumers` warpgroups of 64 q rows (three run their key tiles
    serially, two take turns: `pingpong`), `stages` of the K / V ring, and
    the setmaxnreg counts of a consumer warpgroup and of the producer's."""
    pingpong: bool
    consumers: int
    stages: int
    consumer_regs: int
    producer_regs: int


def full_fwd_schedule(tile: int) -> FullFwdSchedule:
    """Three serial consumers at tiles <= 64, two in ping-pong at 128."""
    if tile > 64:
        return FullFwdSchedule(True, 2, 3, 240, 24)
    return FullFwdSchedule(False, 3, 4, 160, 32)


class FullFwdPlan(NamedTuple):
    """How #5s covers one call: `tile` the head tile, `rows` the q rows of
    a tile (64 a consumer), `n_q_tiles` / `n_key_tiles` the q tiles and
    FULL_FWD_KEYS-key tiles of one (batch, head), `tail_keys` the keys of
    the last key tile, `tiles` the q tiles of the call, `grid` the CTAs of
    the persistent walk (one an SM, at most one a tile), `smem_bytes` a
    CTA's dynamic shared memory, `pitch` the lse row pitch."""
    tile: int
    rows: int
    n_q_tiles: int
    n_key_tiles: int
    tail_keys: int
    tiles: int
    grid: int
    smem_bytes: int
    pitch: int


def full_fwd_plan(b: int, lq: int, lk: int, h: int, d: int, n_sm: int
                  ) -> FullFwdPlan:
    """#5s's plan for q [b, lq, h, d] over lk keys on a card of n_sm SMs.
    Shared memory: the q tile and the stages of K and V, each 1024-byte
    aligned, the ring's mbarriers, and 1024 bytes of alignment slack
    (csrc/hopper.cuh, smem_bytes)."""
    tile = full_tile_width(d)
    sched = full_fwd_schedule(tile)
    rows, keys = 64 * sched.consumers, FULL_FWD_KEYS
    n_qt = -(-lq // rows)
    n_kt = -(-lk // keys)
    tiles = b * h * n_qt
    tiles_bytes = 2 * tile * (rows + 2 * sched.stages * keys)
    barriers = 8 * (2 * sched.stages + 2)
    smem = -(-(tiles_bytes + barriers) // 1024) * 1024 + 1024
    return FullFwdPlan(tile, rows, n_qt, n_kt, lk - (n_kt - 1) * keys, tiles,
                       max(1, min(tiles, n_sm)), smem, stats_pitch(lq))


def flash_full_mha_stats(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """#5s: the general route's training forward on q [b, l, h, d] and k/v
    [b, lk, h, d] (any d <= 128, lk may differ from l).  Returns o, a new
    contiguous [b, l, h, d] in q's dtype, and the base-2 lse [b, h, l] f32
    (on the card a view of the backward's [b, h, stats_pitch(l)] layout).

    CPU tensors: `flash_full_mha_stats_ref`.  CUDA tensors: the sm_90a
    kernel flash_full_stats_kernel of csrc/flash_full_fwd.cu (bf16, views
    read as `flash_full_mha` reads them, a persistent grid of
    `full_fwd_plan`).  It records no gradient: see `FlashFullMHA`."""
    global LAUNCHES_FULL_STATS
    _check_full(q, k, v, SPLASH_MAX_D)
    if q.device.type == "cpu":
        return flash_full_mha_stats_ref(q, k, v)
    _refuse_grad("flash_full_mha_stats", q, k, v, route=FULL_ROUTE)
    out = _launch_stats("flash_full_mha_stats", q, k, v)
    LAUNCHES_FULL_STATS += 1
    return out


def _launch_stats(what: str, q, k, v):
    """One launch of #5s (the training function; csrc/flash_full_fwd.cu,
    flash_full_stats_kernel) on bf16 CUDA views.  Returns o [b, l, h, d]
    and the lse [b, h, l], a view of its [b, h, stats_pitch(l)] f32
    buffer."""
    b, l, lk, h, d = _check_full(q, k, v, SPLASH_MAX_D)
    _check_bf16_cuda(what, dict(q=q, k=k, v=v), aligned=False)
    plan = full_fwd_plan(b, l, lk, h, d, _sm_count(q.device.index or 0))
    out = torch.empty((b, l, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, plan.pitch), dtype=torch.float32,
                      device=q.device)
    (q, k, v), dm = _full_operands(q, k, v)
    err = _build.load_library().odgs_flash_full_fwd_stats_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), b, l, lk, h, d, dm, _train_scale(d, q.dtype),
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], plan.grid,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, what)
    return out, lse[..., :l]


def _full_stats_layout(lse: torch.Tensor) -> torch.Tensor:
    """lse [b, h, l] f32 in the backward's [b, h, stats_pitch(l)] layout:
    the stats forward's own view as it lies, anything else copied."""
    b, h, l = lse.shape
    pitch = stats_pitch(l)
    if (lse.dtype == torch.float32 and lse.data_ptr() % 16 == 0
            and lse.stride() == (h * pitch, pitch, 1)):
        return lse
    out = lse.new_zeros((b, h, pitch), dtype=torch.float32)
    out[..., :l] = lse
    return out[..., :l]


def _full_delta(do: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO ∘ O) per head in f32, reduced straight into the
    backward's zero-padded [b, h, stats_pitch(l)] layout: the plain version
    of the delta that #5b's prep launch writes."""
    b, l, h, _ = o.shape
    out = torch.zeros((b, h, stats_pitch(l)), dtype=torch.float32,
                      device=o.device)
    prod = do.to(torch.float32, copy=True).mul_(o)
    torch.sum(prod, -1, out=out[..., :l].transpose(1, 2))
    return out


class FullBwdPlan(NamedTuple):
    """How #5b's main pass (csrc/flash_full_bwd.cu) covers one call:
    `tile` the head tile, `q_step` query rows a step, `n_q_tiles` /
    `n_key_blocks` the query tiles and 128-key blocks of one (batch, head),
    `groups` the CTAs each key block gets (heads run `groups` at a time),
    `grid` = groups x n_key_blocks CTAs, `acc_shape` the f32 dQ accumulator
    [b*h, n_q_tiles * q_step, tile], `counters` the hand-off counters plus
    the ticket, `pitch` the lse / delta row pitch."""
    tile: int
    q_step: int
    n_q_tiles: int
    n_key_blocks: int
    groups: int
    grid: int
    acc_shape: tuple
    counters: int
    pitch: int


def full_bwd_plan(b: int, lq: int, lk: int, h: int, d: int, n_sm: int
                  ) -> FullBwdPlan:
    """#5b's plan for q [b, lq, h, d] over lk keys on a card of n_sm SMs.
    The grid is persistent: as many groups of n_key_blocks CTAs as fit on
    the SMs (one CTA an SM), at least one and at most one a head."""
    tile = full_tile_width(d)
    q_step = 32 if tile > 64 else 64
    n_qt = -(-lq // q_step)
    n_kb = -(-lk // FULL_BWD_KEYS)
    groups = max(1, min(b * h, n_sm // n_kb))
    return FullBwdPlan(tile, q_step, n_qt, n_kb, groups, groups * n_kb,
                       (b * h, n_qt * q_step, tile), b * h * n_qt + 1,
                       stats_pitch(lq))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _full_bwd_scratch(plan: FullBwdPlan, b: int, lq: int, h: int, dm: int,
                      device) -> tuple:
    """#5b's buffers, uninitialised (torch.empty): q~ [b, lq, h, dm] bf16,
    delta [b, h, pitch] f32, the counters (int32, zeroed by the prep
    launch) and the f32 dQ accumulator."""
    return (torch.empty((b, lq, h, dm), dtype=torch.bfloat16, device=device),
            torch.empty((b, h, plan.pitch), dtype=torch.float32,
                        device=device),
            torch.empty(plan.counters, dtype=torch.int32, device=device),
            torch.empty(plan.acc_shape, dtype=torch.float32, device=device))


def _full_bwd_prep(q, o, do, qs, delta, counters) -> None:
    """#5b's prep launch: q~ (`_train_prescaled_q`, zero past d) into qs,
    delta (`_full_delta`) into its [b, h, pitch] layout, the counters
    zeroed."""
    b, l, h, d = q.shape
    err = _build.load_library().odgs_flash_full_bwd_prep_bf16(
        q.data_ptr(), o.data_ptr(), do.data_ptr(), qs.data_ptr(),
        delta.data_ptr(), counters.data_ptr(), b, l, h, d, qs.shape[-1],
        counters.numel(), _train_scale(d, q.dtype), *q.stride()[:3],
        *o.stride()[:3], *do.stride()[:3],
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_full_mha_bwd (prep)")


def flash_full_mha_bwd(q, k, v, o, do, lse):
    """#5b: (dq, dk, dv) of `flash_full_mha_stats` from its o and lse and
    the output cotangent do, in the primal dtypes.

    CPU tensors: `flash_full_mha_bwd_ref`.  CUDA tensors: csrc/
    flash_full_bwd.cu (bf16, any d <= 128), three launches: the prep (q~
    and delta, as `_train_prescaled_q` and `_full_delta` form them), one
    deterministic pass over key blocks (`full_bwd_plan`) and an epilogue
    that rounds dq.  Views TMA cannot address go to the kernel as
    zero-padded copies."""
    global LAUNCHES_FULL_BWD
    b, l, lk, h, d = _check_full_bwd(q, k, v, o, do, lse)
    if q.device.type == "cpu":
        return flash_full_mha_bwd_ref(q, k, v, o, do, lse)
    do = do.to(o.dtype).contiguous()    # no copy for the DiT's cotangent
    _refuse_grad("flash_full_mha_bwd", q, k, v, o, do, route=FULL_ROUTE)
    _check_bf16_cuda("flash_full_mha_bwd", dict(q=q, k=k, v=v, o=o, do=do),
                     aligned=False)
    lse = _full_stats_layout(lse)
    (k, v, dom), dm = _full_operands(k, v, do)
    plan = full_bwd_plan(b, l, lk, h, d, _sm_count(q.device.index or 0))
    qs, delta, counters, acc = _full_bwd_scratch(plan, b, l, h, dm, q.device)
    dq = torch.empty((b, l, h, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, lk, h, d), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    _full_bwd_prep(q, o, do, qs, delta, counters)
    err = _build.load_library().odgs_flash_full_bwd_bf16(
        qs.data_ptr(), k.data_ptr(), v.data_ptr(), dom.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), acc.data_ptr(),
        counters.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b,
        l, lk, h, d, dm, plan.groups, _train_scale(d, q.dtype),
        *k.stride()[:3], *v.stride()[:3], *dom.stride()[:3],
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_full_mha_bwd")
    LAUNCHES_FULL_BWD += 1
    return dq, dk, dv


class FlashFullMHA(torch.autograd.Function):
    """The general route's training attention on q [b, l, h, d] and k/v
    [b, lk, h, d]: forward = #5s (`flash_full_mha_stats`), backward = #5b
    (`flash_full_mha_bwd`); saves q, k, v, o and lse, as JAX's custom_vjp
    keeps splash's residuals.  On CPU tensors both are the plain twins."""

    @staticmethod
    def forward(ctx, q, k, v):
        o, lse = flash_full_mha_stats(q, k, v)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        return flash_full_mha_bwd(q, k, v, o, do, lse)


def flash_full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                         ) -> torch.Tensor:
    """The DiT's general route on [b, l, h, d]: differentiable through
    `FlashFullMHA` (JAX's training function) when grad mode is on and an
    input requires grad, otherwise #5's serving forward `flash_full_mha`."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashFullMHA.apply(q, k, v)
    return flash_full_mha(q, k, v)


SPLASH_ROUTE = "splash_attention (FlashFullMHA)"


def splash_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
               ) -> torch.Tensor:
    """The splash route's serving forward on q [b, l, h, d] and k/v
    [b, lk, h, d], any d <= 128: JAX's `_splash_attention(q * d^-1/2, k,
    v)` (transformer.py:159-166), i.e. the training function of
    `flash_full_mha_stats` without its lse.  Returns a new contiguous
    [b, l, h, d] tensor in q's dtype.

    CPU tensors: `flash_full_mha_stats_ref`'s output.  CUDA tensors:
    #5s's kernel (`flash_full_mha_stats`), its lse dropped (the training
    pre-scale `_train_scale`, not #5's `_full_scale`); no gradient."""
    global LAUNCHES_SPLASH
    _check_full(q, k, v, SPLASH_MAX_D)
    if q.device.type == "cpu":
        return flash_full_mha_stats_ref(q, k, v)[0]
    _refuse_grad("splash_mha", q, k, v, route=SPLASH_ROUTE)
    out, _ = _launch_stats("splash_mha", q, k, v)
    LAUNCHES_SPLASH += 1
    return out


def splash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                     ) -> torch.Tensor:
    """The splash route on [b, l, h, d] (`attn_impl: splash`, and any head
    wider than 64: transformer.py:159-166, splash on q·d^-1/2 in q's dtype,
    differentiated by splash's own backward): `FlashFullMHA` (#5s + #5b)
    when grad mode is on and an input requires grad, otherwise
    `splash_mha`.  Heads wider than 128 raise (ROADMAP, "Limits, not
    faults")."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashFullMHA.apply(q, k, v)
    return splash_mha(q, k, v)


def _round_bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _check_mha_full(q, k, v, l_real: int):
    if q.dim() != 3 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q/k/v must share one [h, L, d] shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if not 1 <= l_real <= q.shape[1]:
        raise ValueError(f"l_real={l_real} outside [1, L={q.shape[1]}]")


def mha_full_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 l_real: int, pv_f32: bool = False, score_bf16: bool = False
                 ) -> torch.Tensor:
    """Plain PyTorch version of the bench variant (tools/bench_attn2.py::
    mha_full): q/k/v [h, L, d], q PRE-SCALED by d^-1/2 * log2(e); keys
    < l_real.  `score_bf16` rounds the scores, s - m and 2^(s - m) to bf16
    (:55-63); without `pv_f32` P is rounded to bf16 for P·V and for the
    row sum, which the TPU takes through the same matmul (:72-78).  Takes
    the final row max directly; the kernel's online rescaling differs from
    it only by rounding.  Returns [h, L, d] in q's dtype (every row
    computed)."""
    _check_mha_full(q, k, v, l_real)
    s = torch.matmul(q.float(), k[:, :l_real].float().transpose(-1, -2))
    if score_bf16:
        s = _round_bf16(s)
    x = s - s.amax(dim=-1, keepdim=True)
    p = torch.exp2(_round_bf16(x)) if score_bf16 else torch.exp2(x)
    if score_bf16 or not pv_f32:
        p = _round_bf16(p)
    l = p.sum(dim=-1, keepdim=True).clamp(min=1e-30)
    return (torch.matmul(p, v[:, :l_real].float()) / l).to(q.dtype)


def mha_full(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
             l_real: int, pv_f32: bool = False, score_bf16: bool = False
             ) -> torch.Tensor:
    """The bench variant of the general-route kernel (tools/bench_attn2.py::
    mha_full): q/k/v [h, L, 64], q pre-scaled, keys < l_real; `pv_f32` takes
    the f32 P·V (two bf16 products, as flash_full_mha), otherwise P is a
    bf16 operand; `score_bf16` rounds the softmax's scores to bf16.
    Returns [h, L, 64] in q's dtype.

    CPU tensors: `mha_full_ref`.  CUDA tensors: csrc/flash_full_fwd.cu with
    the two flags (bf16, d = 64), each head as a batch element of one head,
    [h, L, 1, 64] (the same tensor maps as flash_full_mha); no gradient."""
    global LAUNCHES_MHA_FULL
    _check_mha_full(q, k, v, l_real)
    if q.device.type == "cpu":
        return mha_full_ref(q, k, v, l_real=l_real, pv_f32=pv_f32,
                            score_bf16=score_bf16)
    h, lq, d = q.shape
    if d != 64:
        raise ValueError(f"mha_full: head dim {d}: the bench variants take "
                         f"d = 64")
    _check_bf16_cuda("mha_full", dict(q=q, k=k, v=v), aligned=False)
    _refuse_grad("mha_full", q, k, v, route="no route (bench only)")
    out = torch.empty((h, lq, d), dtype=q.dtype, device=q.device)
    _launch_full("mha_full", q.unsqueeze(2), k.unsqueeze(2), v.unsqueeze(2),
                 out.unsqueeze(2), l_real, 1.0, pv_f32=pv_f32,
                 score_bf16=score_bf16)
    LAUNCHES_MHA_FULL += 1
    return out
