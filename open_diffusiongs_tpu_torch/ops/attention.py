"""Packed-layout full multi-head attention: CUDA kernels + plain PyTorch twins.

Counterpart of open_diffusiongs_tpu/ops/attention.py::flash_mha_packed
(with and without stats) and ::flash_mha_packed_bwd.  The kernels are
hand-written for sm_90a: csrc/flash_attn_fwd.cu (forward, optionally with
the base-2 log-sum-exp) and csrc/flash_attn_bwd.cu (the dQ and dK/dV
kernels).  The plain versions `flash_mha_packed_ref` and
`flash_mha_packed_bwd_ref` compute the same functions with explicit f32
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

The JAX DiT pads the token axis once around the whole stack to a block
multiple (transformer.py:525-538, plan_packed :125-139: 4098 -> 4608 at
256^2).  The port's kernels mask the ragged tile themselves, so the port's
DiT runs at Lp = L; the real rows agree either way.
"""

from __future__ import annotations

import math

import torch

from . import _build

LOG2E = math.log2(math.e)

LAUNCHES = 0         # stats-free forward kernel launches (CUDA tensors only)
LAUNCHES_STATS = 0   # forward-with-lse kernel launches
LAUNCHES_BWD = 0     # backward launches (one dQ + one dK/dV kernel each)


def _check_shapes(q, k, v, num_heads: int, l_real: int):
    if q.dim() != 3 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q/k/v must share one [b, Lp, h*dh] shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, lp, hd = q.shape
    if hd % num_heads:
        raise ValueError(f"width {hd} is not divisible by {num_heads} heads")
    if not 1 <= l_real <= lp:
        raise ValueError(f"l_real={l_real} outside [1, Lp={lp}]")
    return b, lp, hd, hd // num_heads


def _check_cuda(what: str, ref: torch.Tensor, dh: int, bf16: dict,
                f32: dict = None):
    """Device, dtype and layout checks of a kernel launch: `bf16` tensors
    need a contiguous last dimension and 16-byte aligned rows (column
    slices of a fused projection qualify); `f32` tensors must be
    contiguous."""
    if ref.device.type != "cuda":
        raise RuntimeError(f"{what}: unsupported device {ref.device}")
    for name, x in bf16.items():
        if x.device != ref.device:
            raise ValueError(f"{what}: {name} is on {x.device}, not "
                             f"{ref.device}")
        if x.dtype != torch.bfloat16:
            raise TypeError(f"{what}: {name} must be bfloat16, got {x.dtype}")
        if x.stride(2) != 1:
            raise ValueError(f"{what}: {name}: last dimension must be "
                             f"contiguous")
        if x.data_ptr() % 16 or x.stride(0) % 8 or x.stride(1) % 8:
            raise ValueError(f"{what}: {name}: rows must start 16-byte "
                             f"aligned (strides {x.stride()})")
    for name, x in (f32 or {}).items():
        if x.device != ref.device:
            raise ValueError(f"{what}: {name} is on {x.device}, not "
                             f"{ref.device}")
        if x.dtype != torch.float32 or not x.is_contiguous():
            raise TypeError(f"{what}: {name} must be contiguous float32")
    if dh not in (32, 64):
        raise ValueError(f"{what}: head dim {dh}: the kernels take dh 32 or "
                         f"64")


def _refuse_grad(what: str, *xs: torch.Tensor):
    if torch.is_grad_enabled() and any(x.requires_grad for x in xs):
        raise RuntimeError(
            f"{what}: the raw CUDA launch records no gradient; inputs that "
            f"require grad must go through flash_attention (FlashMHAPacked)")


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
    """q~ = q * dh^-1/2 * log2(e), rounded to q's dtype (as the kernels)."""
    return (q.float() * (dh ** -0.5 * LOG2E)).to(q.dtype)


def flash_mha_packed_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, num_heads: int, l_real: int,
                         with_stats: bool = False):
    """Plain PyTorch version of the forward kernel: explicit f32 matmuls and
    a softmax in base 2 over the keys < l_real, with q~ as the kernels form
    it.  Returns o [b, Lp, h*dh] in q's dtype (rows >= l_real garbage), and
    with `with_stats` also lse [b, Lp, h] f32: m + log2(sum 2^(s - m)) of
    every real row, 0 on pad rows."""
    b, lp, hd, dh = _check_shapes(q, k, v, num_heads, l_real)
    s = torch.matmul(_heads(_prescaled_q(q, dh), lp, num_heads),
                     _heads(k, l_real, num_heads).transpose(-1, -2))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp2(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = _unheads(torch.matmul(p, _heads(v, l_real, num_heads)) / l)
    o = o.to(q.dtype)
    if not with_stats:
        return o
    lse = (m + torch.log2(l))[..., 0].transpose(1, 2)       # [b, Lp, h]
    real = torch.arange(lp, device=q.device)[None, :, None] < l_real
    return o, torch.where(real, lse, 0.0).contiguous()


def flash_mha_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     num_heads: int, l_real: int, with_stats: bool = False):
    """Full MHA on the packed layout [b, Lp, h*dh] (head h in columns
    h*dh .. h*dh+dh-1); keys >= l_real are excluded.  Returns a new
    contiguous [b, Lp, h*dh] tensor in q's dtype (pad rows garbage), and
    with `with_stats` also the base-2 lse [b, Lp, h] f32 (pad rows 0).

    CPU tensors: `flash_mha_packed_ref`.  CUDA tensors: the sm_90a kernel,
    which takes bf16, dh in {32, 64} (the flagship's 64 and the tiny
    configs' 32), a contiguous last dimension and 16-byte aligned rows —
    q/k/v may be column slices of one fused qkv projection.  It records no
    gradient: see `flash_attention`."""
    global LAUNCHES, LAUNCHES_STATS
    b, lp, hd, dh = _check_shapes(q, k, v, num_heads, l_real)
    if q.device.type == "cpu":
        return flash_mha_packed_ref(q, k, v, num_heads=num_heads,
                                    l_real=l_real, with_stats=with_stats)
    _check_cuda("flash_mha_packed", q, dh, dict(q=q, k=k, v=v))
    _refuse_grad("flash_mha_packed", q, k, v)
    out = torch.empty((b, lp, hd), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, lp, num_heads), dtype=torch.float32,
                       device=q.device) if with_stats else None)
    lib = _build.load_library()
    err = lib.odgs_flash_attn_fwd_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), b, lp, num_heads, dh,
        l_real, dh ** -0.5 * LOG2E,
        q.stride(0), q.stride(1), k.stride(0), k.stride(1),
        v.stride(0), v.stride(1),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_mha_packed")
    if with_stats:
        LAUNCHES_STATS += 1
        return out, lse
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
                             l_real: int):
    """Plain PyTorch version of the backward kernels (explicit f32):
    P = exp2(q~·kᵀ - lse), dS = P ∘ (dO·vᵀ - δ), dq = dh^-1/2 dS·k,
    dk = ln2 dSᵀ·q~, dv = Pᵀ·dO over keys < l_real, with dO and the rows
    of P and dS zeroed on rows >= l_real.  Returns (dq, dk, dv) in the
    primal dtypes, rows >= l_real exactly 0."""
    b, lp, hd, dh = _check_shapes(q, k, v, num_heads, l_real)
    do, delta = _masked_cotangent(do, o, num_heads, l_real)
    qs = _heads(_prescaled_q(q, dh), lp, num_heads)             # [b,h,Lp,dh]
    kh, vh = _heads(k, l_real, num_heads), _heads(v, l_real, num_heads)
    doh = _heads(do, lp, num_heads)
    real = (torch.arange(lp, device=q.device) < l_real)[None, None, :, None]
    p = torch.exp2(torch.matmul(qs, kh.transpose(-1, -2))
                   - lse.transpose(1, 2)[..., None].float())
    p = torch.where(real, p, 0.0)
    ds = p * (torch.matmul(doh, vh.transpose(-1, -2))
              - delta.transpose(1, 2)[..., None])
    ds = torch.where(real, ds, 0.0)
    dq = torch.where(real, torch.matmul(ds, kh), 0.0) * dh ** -0.5
    pad = (0, 0, 0, lp - l_real)
    dk = torch.nn.functional.pad(
        torch.matmul(ds.transpose(-1, -2), qs) / LOG2E, pad)
    dv = torch.nn.functional.pad(torch.matmul(p.transpose(-1, -2), doh), pad)
    return (_unheads(dq).to(q.dtype), _unheads(dk).to(k.dtype),
            _unheads(dv).to(v.dtype))


def _bwd_fused(q, k, v, o, do, lse, num_heads: int, l_real: int
               ) -> torch.Tensor:
    """(dq | dk | dv) as one [b, Lp, 3*h*dh] tensor."""
    global LAUNCHES_BWD
    b, lp, hd, dh = _check_shapes(q, k, v, num_heads, l_real)
    if q.device.type == "cpu":
        return torch.cat(flash_mha_packed_bwd_ref(
            q, k, v, o, do, lse, num_heads=num_heads, l_real=l_real), -1)
    do, delta = _masked_cotangent(do, o, num_heads, l_real)
    _check_cuda("flash_mha_packed_bwd", q, dh, dict(q=q, k=k, v=v, o=o,
                                                    do=do),
                dict(lse=lse, delta=delta))
    if lse.shape != (b, lp, num_heads):
        raise ValueError(f"flash_mha_packed_bwd: lse must be "
                         f"{(b, lp, num_heads)}, got {tuple(lse.shape)}")
    _refuse_grad("flash_mha_packed_bwd", q, k, v, o, do)
    dqkv = torch.empty((b, lp, 3 * hd), dtype=q.dtype, device=q.device)
    dq, dk, dv = dqkv.chunk(3, dim=-1)
    lib = _build.load_library()
    err = lib.odgs_flash_attn_bwd_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), b, lp, num_heads, dh, l_real, dh ** -0.5 * LOG2E,
        q.stride(0), q.stride(1), k.stride(0), k.stride(1),
        v.stride(0), v.stride(1), do.stride(0), do.stride(1),
        dq.stride(0), dq.stride(1), dk.stride(0), dk.stride(1),
        dv.stride(0), dv.stride(1),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_mha_packed_bwd")
    LAUNCHES_BWD += 1
    return dqkv


def flash_mha_packed_bwd(q, k, v, o, do, lse, *, num_heads: int,
                         l_real: int):
    """(dq, dk, dv) of `flash_mha_packed` from the stats forward's o and
    lse and the output cotangent do (pad rows may hold garbage: they are
    masked).  Primal dtypes, rows >= l_real exactly 0.

    CPU tensors: `flash_mha_packed_bwd_ref`.  CUDA tensors: the two
    sm_90a kernels of csrc/flash_attn_bwd.cu (bf16, dh 32 or 64), whose
    three outputs are column slices of one fused [b, Lp, 3*h*dh] tensor.
    delta = rowsum(dO * O) is formed here in plain torch, as in JAX."""
    return _bwd_fused(q, k, v, o, do, lse, num_heads, l_real).chunk(3, -1)


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
        return (_bwd_fused(q, k, v, o, do, lse, ctx.num_heads, ctx.l_real),
                None, None)


def flash_attention(qkv: torch.Tensor, *, num_heads: int, l_real: int
                    ) -> torch.Tensor:
    """The DiT's attention on its fused qkv projection: differentiable
    through `FlashMHAPacked` when qkv requires grad and grad mode is on,
    otherwise the stats-free forward on column slices of qkv."""
    if torch.is_grad_enabled() and qkv.requires_grad:
        return FlashMHAPacked.apply(qkv, num_heads, l_real)
    q, k, v = qkv.chunk(3, dim=-1)
    return flash_mha_packed(q, k, v, num_heads=num_heads, l_real=l_real)
