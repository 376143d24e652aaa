"""Ring attention: exact full self-attention over a token-sharded sequence.

Counterpart of open_diffusiongs_tpu/parallel/ring.py (:113-287).  Each seq
rank of a data row (parallel/mesh.py) holds lq = Lp/sp rows of the DiT's
padded token axis; attention is the only op of a block that couples
tokens, so it is the only one that talks to the other ranks.

`ring_attention` on the packed layout: the local fused qkv [b, lq, 3·h·dh]
attends to every rank's k|v slice, which travels round the ring as one
contiguous [b, lq, 2·h·dh] buffer (the fused projection's k and v views
are strided).  Each ring step is one launch of the stats forward #1s
(ops/attention.py::flash_mha_packed(with_stats=True)) on the local q
against the slice it holds, with the slice's own key extent (JAX
:134-142) and the local query extent; the per-step (o_t, lse_t) pairs
merge exactly by the base-2 recurrence of JAX :146-164, in plain torch as
JAX does it in XLA:
    m = max_t lse_t,  s = Σ_t 2^(lse_t - m),  o = Σ_t o_t 2^(lse_t - m) / s,
and the global LSE = m + log2 s.  Each o_t comes out of the kernel in f32
and the merge runs in f32, so o is rounded to bf16 once, as the one-rank
launch over every key rounds it (JAX's XLA ring likewise accumulates o in
f32 across its steps).  The backward (`RingAttention`) runs one
launch of #3 (flash_mha_packed_bwd) per step with the GLOBAL o and LSE of
the local rows: exp2(q~·k - LSE) is then the global softmax restricted to
the slice, so each step's dq, dk and dv are exact parts of the whole.  dq
accumulates locally; the dk|dv accumulator travels with its k|v slice and
reaches the slice's owner after sp shifts.  The kernel writes each step's
parts in f32 and the accumulators are f32: within one slice's keys
Σ_j dS_ij is not 0, so the parts can be far larger than their sum, and
rounded to bf16 one by one they would cancel away their bits (the one-rank
kernel sums every key in f32 before its one rounding).

Pad rows: global rows >= l_real are padding.  A query shard whose rows
are all padding, or a slice whose keys all are, takes no launch (its
output rows are 0 and its gradient parts 0); the DiT's shapes on the card
never have one.

Layouts the packed kernels do not take (qk_norm, or a head layout failing
the lane test, models/transformer.py) do what XLA does in JAX
(transformer.py:386-405): `gather_seq` all-gathers k and v over the seq
group (its backward is a reduce-scatter that sums), the caller slices
them to the real rows and runs the general route on the local q against
all keys (#5s / #5b with lq != lk).  On CPU tensors every launch is its
plain twin.

The gradient rule of the seq axis: every seq rank computes the same loss
after the stack's final gather, whose backward sums the sp identical
cotangents; the train step then averages every gradient over all dp·sp
ranks (parallel/train_step.py), which gives the one-rank gradient.  A
parameter used by every token (the projections, each block's modulation
and so the timestep embedder behind it) gets on each rank its sum over
that rank's tokens, rounded to the model's dtype there, as a data rank
rounds its half of the batch's sum.
"""

from __future__ import annotations

import torch

from ..ops import attention as attn
from .mesh import Mesh

_NEG = -1e30


def shard_extent(l_real: int, lq: int, index: int) -> int:
    """Real rows of shard `index` of lq rows each: 0 .. lq."""
    return max(0, min(lq, l_real - index * lq))


def _forward(q: torch.Tensor, kv: torch.Tensor, num_heads: int,
             l_real: int, mesh: Mesh):
    """(o [b, lq, h·dh] in q's dtype, LSE [b, lq, h] f32: 0 on pad rows)."""
    b, lq, hd = q.shape
    dh = hd // num_heads
    sp, me = mesh.sp, mesh.seq_rank
    lq_real = shard_extent(l_real, lq, me)
    m = torch.full((b, lq, num_heads), _NEG, dtype=torch.float32,
                   device=q.device)
    ssum = torch.zeros_like(m)
    acc = torch.zeros((b, lq, num_heads, dh), dtype=torch.float32,
                      device=q.device)
    cur = kv
    for t in range(sp):
        shift = mesh.ring_shift([cur]) if t < sp - 1 else None
        lk_real = shard_extent(l_real, lq, (me - t) % sp)
        if lq_real > 0 and lk_real > 0:
            o_t, lse_t = attn.flash_mha_packed(
                q, cur[..., :hd], cur[..., hd:], num_heads=num_heads,
                lq_real=lq_real, lk_real=lk_real, with_stats=True,
                out_f32=True)
            m_new = torch.maximum(m, lse_t)
            alpha = torch.exp2(m - m_new)
            w = torch.exp2(lse_t - m_new)
            ssum = ssum * alpha + w
            acc = (acc * alpha[..., None]
                   + o_t.reshape(b, lq, num_heads, dh) * w[..., None])
            m = m_new
        if shift is not None:
            cur = shift.wait()[0]
    out = acc / torch.clamp(ssum, min=1e-30)[..., None]
    real = (torch.arange(lq, device=q.device) < lq_real)[None, :, None]
    lse = torch.where(real, m + torch.log2(torch.clamp(ssum, min=1e-30)),
                      0.0)
    return out.reshape(b, lq, hd).to(q.dtype), lse.contiguous()


class RingAttention(torch.autograd.Function):
    """Ring attention on the local fused qkv [b, lq, 3·h·dh]: forward = one
    #1s launch per ring step and the exact merge, backward = one #3 launch
    per step (module docstring).  Saves qkv, o and the global LSE."""

    @staticmethod
    def forward(ctx, qkv, num_heads: int, l_real: int, mesh: Mesh):
        hd = qkv.shape[-1] // 3
        q, kv = qkv[..., :hd], qkv[..., hd:].contiguous()
        o, lse = _forward(q, kv, num_heads, l_real, mesh)
        ctx.save_for_backward(qkv, o, lse)
        ctx.num_heads, ctx.l_real, ctx.mesh = num_heads, l_real, mesh
        return o

    @staticmethod
    def backward(ctx, do):
        qkv, o, lse = ctx.saved_tensors
        h, mesh = ctx.num_heads, ctx.mesh
        b, lq, hd3 = qkv.shape
        hd = hd3 // 3
        q, cur = qkv[..., :hd], qkv[..., hd:].contiguous()
        sp, me = mesh.sp, mesh.seq_rank
        lq_real = shard_extent(ctx.l_real, lq, me)
        dq = torch.zeros((b, lq, hd), dtype=torch.float32, device=qkv.device)
        dkv = torch.zeros((b, lq, 2 * hd), dtype=torch.float32,
                          device=qkv.device)
        do = do.to(qkv.dtype).contiguous()
        for t in range(sp):
            shift = mesh.ring_shift([cur]) if t < sp - 1 else None
            lk_real = shard_extent(ctx.l_real, lq, (me - t) % sp)
            if lq_real > 0 and lk_real > 0:
                g = attn._bwd_fused(q, cur[..., :hd], cur[..., hd:], o, do,
                                    lse, h, lq_real, lk_real, out_f32=True)
                dq += g[..., :hd]
                dkv += g[..., hd:]
            # the accumulator follows its slice: after sp shifts it is home
            dkv = mesh.ring_shift([dkv]).wait()[0]
            if shift is not None:
                cur = shift.wait()[0]
        return torch.cat([dq, dkv], -1).to(qkv.dtype), None, None, None


def ring_attention(qkv: torch.Tensor, *, num_heads: int, l_real: int,
                   mesh: Mesh) -> torch.Tensor:
    """Exact full MHA of this rank's rows over the whole ring.  qkv: the
    local [b, lq, 3·h·dh] fused projection (q | k | v thirds, head-major
    columns) of rows [s·lq, (s+1)·lq) of a sequence whose rows >= l_real
    are padding.  Returns the local [b, lq, h·dh] output in qkv's dtype
    (pad rows meaningless).  Differentiable through `RingAttention` when
    qkv requires grad; the forward is the same either way."""
    if torch.is_grad_enabled() and qkv.requires_grad:
        return RingAttention.apply(qkv, num_heads, l_real, mesh)
    hd = qkv.shape[-1] // 3
    return _forward(qkv[..., :hd], qkv[..., hd:].contiguous(), num_heads,
                    l_real, mesh)[0]


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh: Mesh, dim: int):
        ctx.mesh, ctx.dim = mesh, dim
        return mesh.all_gather(x, "seq", dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.reduce_scatter(g, "seq", ctx.dim), None, None


def gather_seq(x: torch.Tensor, mesh: Mesh, dim: int = 1) -> torch.Tensor:
    """The seq ranks' shards of x concatenated along `dim`, by seq rank.
    Its backward is a reduce-scatter that sums the ranks' cotangents
    (torch.distributed.nn.functional.all_gather's rule)."""
    if mesh.sp == 1:
        return x
    return _GatherSeq.apply(x, mesh, dim)
