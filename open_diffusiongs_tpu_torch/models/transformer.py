"""DiT building blocks (torch.nn), with the reference's state-dict names.

Counterpart of open_diffusiongs_tpu/models/transformer.py:39-477 (and the
reference's models/transformers/utils_transformer.py):
  * TimestepEmbedder: sinusoidal (cos first) -> Linear -> SiLU -> Linear;
  * DiTBlock: adaLN 6-way modulation around pre-norm attention and a
    tanh-GELU MLP; the norms have no affine params (eps 1e-6, computed in
    f32 and cast back, transformer.py:433-438); gates scale the residual
    branches;
  * DiTStack: a ModuleList of blocks, so the keys read
    `transformer.{i}.attn.qkv.weight` like the reference checkpoints; with
    `checkpoint=True` each block runs under
    torch.utils.checkpoint (non-reentrant), the counterpart of the JAX
    stack's `remat` (transformer.py:488, 585): the backward recomputes the
    block's forward, attention kernel included.

Numerical hazards pinned here:
  * the reference fuses q | k | v into one [3d, d] Linear (rows q, then k,
    then v); the JAX package keeps three Denses, and utils/convert.py
    fuses them;
  * torch Linear weights are [out, in], flax Dense kernels [in, out];
  * `Linear` computes in the module's compute dtype like flax
    Dense(dtype=bf16): input, weight and bias are cast to bf16 and the
    output is bf16, while parameters stay f32;
  * GELU is the tanh approximation (transformer.py:426).

Attention routing (transformer.py:376-380 with :530-532): a block takes
the packed kernels on the fused qkv (ops/attention.py::flash_attention)
only when it has no qk_norm, dh <= 64, 128 % dh == 0 and
heads % (128 // dh) == 0; every other block takes the general route
(`fused_attention` on [b, l, h, d], flash_full_mha).  The GPU kernels do
not need the TPU's lane test; it is kept so that one config computes one
function in both packages: the two routes round the q pre-scale
differently.

W8A8 serving (`quant_int8`, transformer.py:352-361, :413-418, :455-476):
q/k/v/proj and fc1/fc2 of every block become ops/quant.py::QuantLinear;
adaLN_modulation stays full precision, as in JAX.

Training through the general route: JAX differentiates it through splash
on `q * d^-1/2` (transformer.py:116-152); the port runs that training
function on its own kernels, `FlashFullMHA` (ops/attention.py: the stats
forward #5s and the backward #5b), whenever grad mode is on and an input
requires grad, and #5's serving forward otherwise.  Heads wider than 64
and `attn_impl: splash` take splash's function in serving too
(transformer.py:159-166; ops/attention.py::splash_attention, d <= 128).

Sequence parallelism (transformer.py:192-200, 370-373, 525-551): with a
`seq` mesh of sp > 1 ranks (parallel/mesh.py), DiTStack pads the token axis
to `plan_packed`'s length, keeps this rank's Lp/sp rows through every
per-token op and all-gathers after the last block (`gather_seq`, whose
backward sums the ranks' cotangents); packed blocks attend through the
ring (parallel/ring.py: #1s and #3 per ring step), the others gather k and
v over the ring and run the general route on the local queries.

Tensor parallelism (transformer.py:204-301, :356-398; parallel/shard.py
for which rank holds what): with a `model` mesh of tp > 1 ranks each
block holds its model rank's shards of qkv and fc1 (column-parallel, input
through parallel/tensor_parallel.py::copy_to_model) and of proj and fc2
(row-parallel, output summed over `model` in rank order before the whole
bias is added once).  Attention runs on the num_heads / tp local heads and
takes the route JAX's rule gives the local head count (transformer.py:
376-380): at 16 heads of 64 and tp = 2 the packed kernels run on 8 heads;
a tp that leaves the local layout failing the lane test takes the general
route.  Under sp > 1 too, the ring runs on the local heads.  `q_norm` /
`k_norm` are replicated and see only the local heads, so their cotangent
is summed over `model` as well.

Pipeline parallelism (transformer.py:611-642): with a `pipe` mesh of
pp > 1 stages, DiTStack holds its stage's num_layers / pp blocks and runs
them through parallel/pipeline.py::pipeline_apply (GPipe microbatches,
in training and under no_grad); every stage returns the whole output.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from ..ops.attention import FULL_MAX_D, flash_attention, \
    flash_full_attention, plan_packed, splash_attention
from ..ops.quant import QuantLinear
from ..parallel.pipeline import pipeline_apply
from ..parallel.ring import gather_seq, ring_attention
from ..parallel.tensor_parallel import copy_to_model, reduce_from_model

ATTN_IMPLS = ("auto", "flash", "splash", "xla")


class Linear(nn.Linear):
    """nn.Linear that computes in `compute_dtype` (flax Dense(dtype=...)):
    the input, weight and bias are cast to it; parameters stay f32.

    `parallel` with a `tp_mesh` of tp > 1 (its features are this model
    rank's shard, parallel/shard.py): "column" passes the cast input
    through `copy_to_model` (its cotangent summed over `model`); "row"
    sums the bias-free partial products over `model` (f32, rank order,
    parallel/tensor_parallel.py), adds the whole bias and casts once."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, compute_dtype=torch.float32,
                 parallel=None, tp_mesh=None):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = compute_dtype
        tp = tp_mesh is not None and tp_mesh.tp > 1
        self.parallel = parallel if tp else None
        self.tp_mesh = tp_mesh if tp else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        x = x.to(dt)
        if self.parallel == "column":
            x = copy_to_model(x, self.tp_mesh)
        if self.parallel == "row":
            y = reduce_from_model(F.linear(x, self.weight.to(dt)),
                                  self.tp_mesh)
            if self.bias is not None:
                y = y + self.bias.to(dt).float()
            return y.to(dt)
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x, self.weight.to(dt), bias)


class LayerNorm32(nn.LayerNorm):
    """LayerNorm with scale and no bias, computed and returned in f32 (flax
    nn.LayerNorm promotes a bf16 input with its f32 scale to f32)."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__(dim, eps=eps, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            None, self.eps)


def modulate(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor
             ) -> torch.Tensor:
    """x [b, l, d]; shift / scale [b, d] (utils_transformer.py:26-27)."""
    return x * (1.0 + scale[:, None, :]) + shift[:, None, :]


def timestep_embedding(t: torch.Tensor, dim: int,
                       max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal embedding, cos first: t [b] -> [b, dim] f32."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32,
                                     device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], -1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], -1)
    return emb


def norm_noaffine(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm without affine params, eps 1e-6, computed in f32 and cast
    back to x's dtype."""
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = ((x32 - mean) ** 2).mean(-1, keepdim=True)
    return ((x32 - mean) * torch.rsqrt(var + eps)).to(x.dtype)


class TimestepEmbedder(nn.Module):
    def __init__(self, hidden_size: int, frequency_embedding_size: int = 256,
                 dtype=torch.float32):
        super().__init__()
        self.frequency_embedding_size = frequency_embedding_size
        self.mlp = nn.Sequential(
            Linear(frequency_embedding_size, hidden_size, compute_dtype=dtype),
            nn.SiLU(),
            Linear(hidden_size, hidden_size, compute_dtype=dtype))

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        return self.mlp(timestep_embedding(t, self.frequency_embedding_size))


def resolve_attn_impl(impl: str) -> str:
    """'auto' is 'flash': the port has its kernels on the card and their
    plain twins on the CPU (the JAX package picks 'xla' off the TPU)."""
    if impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl {impl!r} not in {ATTN_IMPLS}")
    return "flash" if impl == "auto" else impl


def dot_product_attention(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor) -> torch.Tensor:
    """Exact softmax(q·kᵀ / sqrt(d))·v on [b, l, h, d] in f32 (the JAX
    package's 'xla' route, jax.nn.dot_product_attention); q's dtype out."""
    s = torch.einsum("blhd,bmhd->bhlm", q.float(), k.float())
    p = torch.softmax(s * q.shape[-1] ** -0.5, dim=-1)
    return torch.einsum("bhlm,bmhd->blhd", p, v.float()).to(q.dtype)


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    impl: str = "auto") -> torch.Tensor:
    """q/k/v [b, l, h, d] (transformer.py:155-167).  'auto'/'flash' with
    d <= 64: ops/attention.py::flash_full_attention, which trains through
    `FlashFullMHA` (#5s + #5b, JAX's splash-differentiated function) when
    grad mode is on and an input requires grad and serves through #5
    otherwise; 'splash', and 'auto'/'flash' with d > 64 (JAX: "the flash
    kernel assumes d <= 64"): ops/attention.py::splash_attention, splash's
    function on q·d^-1/2 in training and serving alike (#5s + #5b, or #5s
    without its lse), up to d = 128; kernels on CUDA tensors, plain twins
    on CPU ones.  'xla': exact plain attention."""
    impl = resolve_attn_impl(impl)
    if impl == "flash" and q.shape[-1] > FULL_MAX_D:
        impl = "splash"
    if impl == "splash":
        return splash_attention(q, k, v)
    if impl == "xla":
        return dot_product_attention(q, k, v)
    return flash_full_attention(q, k, v)


def subset_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     subset_size: int | None = None, impl: str = "auto"
                     ) -> torch.Tensor:
    """Asymmetric "subset" attention (transformer.py:175-188): queries
    [0:s] attend only among keys [0:s]; queries [s:] attend over all keys.
    q/k/v [b, l, h, d]."""
    if subset_size is None or subset_size >= q.shape[1]:
        return fused_attention(q, k, v, impl)
    s = subset_size
    head = fused_attention(q[:, :s], k[:, :s], v[:, :s], impl)
    rest = fused_attention(q[:, s:], k, v, impl)
    return torch.cat([head, rest], dim=1)


def takes_packed(dim: int, num_heads: int, qk_norm: bool = False,
                 tp: int = 1) -> bool:
    """JAX's packed-route test (transformer.py:376-380, :530-532) on the
    num_heads / tp heads of one model rank."""
    dh = dim // num_heads
    return (not qk_norm and dh <= 64 and 128 % dh == 0
            and num_heads % tp == 0
            and (num_heads // tp) % (128 // dh) == 0)


def _tp(mesh) -> int:
    return 1 if mesh is None else mesh.tp


class RMSNorm(nn.Module):
    """RMSNorm with a learned scale, computed in f32 and cast back
    (transformer.py:304-316).  With a `tp_mesh` of tp > 1 it normalizes
    the local heads and its weight's cotangent is summed over `model`."""

    def __init__(self, dim: int, eps: float = 1e-6, tp_mesh=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.tp_mesh = tp_mesh

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        norm = x32 * torch.rsqrt((x32 * x32).mean(-1, keepdim=True)
                                 + self.eps)
        return (norm * copy_to_model(self.weight, self.tp_mesh)).to(x.dtype)


class Attention(nn.Module):
    """Multi-head self-attention with a fused qkv projection (timm layout:
    output rows q | k | v, head-major columns inside each third).

    Routed as JAX routes it (`takes_packed`): packed blocks run
    ops/attention.py::flash_attention on the qkv output (column slices, no
    copy), differentiable through its backward kernels when training, the
    stats-free forward under no_grad; every other block (qk_norm, or a head
    layout failing the lane test) splits qkv into [b, l, h, d], applies the
    per-head q/k RMSNorm when `qk_norm`, and runs `fused_attention`,
    differentiable through the general route's own kernels (#5s forward,
    #5b backward) when training, #5's forward under no_grad.  The
    lane test is the TPU's, not the GPU's: it is kept because the two
    routes round the q pre-scale differently, and one config must compute
    one function in both packages.

    With `quant_int8` the fused qkv and proj are QuantLinears.  The fused
    [3d, d] qkv weight quantizes to the same per-row scales as JAX's
    separate q / k / v QuantDenses (a row is one output channel of one of
    them) and to the same per-token activation scales (all three read the
    same input), so its output is theirs, concatenated
    (tests/test_torch_quant.py holds this bit for bit in f32).

    With a `seq` mesh of sp > 1 ranks, x holds this rank's rows of a
    sequence whose rows >= `l_real` (a forward argument) are padding:
    packed blocks run `ring_attention` on the local qkv, the others gather
    k and v over the ring (`gather_seq`), slice them to the real rows and
    attend the local queries to them, as XLA does in JAX
    (transformer.py:370-405).

    With a `model` mesh of tp > 1 ranks (module docstring) qkv is
    column-parallel (rows q[m] | k[m] | v[m], parallel/shard.py), proj
    row-parallel, and everything above runs on the local heads."""

    def __init__(self, dim: int, num_heads: int, dtype=torch.float32,
                 attn_impl: str = "auto", qk_norm: bool = False,
                 quant_int8: bool = False, seq=None, model=None):
        super().__init__()
        tp = _tp(model)
        if num_heads % tp:
            raise ValueError(f"{num_heads} heads do not split over "
                             f"model_parallel={tp}")
        self.num_heads = num_heads // tp       # this model rank's heads
        self.seq = seq
        self.attn_impl = resolve_attn_impl(attn_impl)
        self.packed = (self.attn_impl == "flash"
                       and takes_packed(dim, num_heads, qk_norm, tp))
        dense = QuantLinear if quant_int8 else Linear
        self.qkv = dense(dim, 3 * dim // tp, compute_dtype=dtype,
                         parallel="column", tp_mesh=model)
        if qk_norm:
            self.q_norm = RMSNorm(dim // num_heads, tp_mesh=model)
            self.k_norm = RMSNorm(dim // num_heads, tp_mesh=model)
        self.qk_norm = qk_norm
        self.proj = dense(dim // tp, dim, compute_dtype=dtype,
                          parallel="row", tp_mesh=model)

    def forward(self, x: torch.Tensor, l_real: int | None = None
                ) -> torch.Tensor:
        b, l, _ = x.shape
        qkv = self.qkv(x)
        if self.seq is not None and self.seq.sp > 1:
            return self.proj(self._seq_attention(qkv, l_real))
        if self.packed:
            return self.proj(flash_attention(qkv, num_heads=self.num_heads,
                                             l_real=l))
        q, k, v = (t.reshape(b, l, self.num_heads, -1)
                   for t in qkv.chunk(3, dim=-1))
        if self.qk_norm:
            q, k = self.q_norm(q), self.k_norm(k)
        o = fused_attention(q, k, v, self.attn_impl)
        return self.proj(o.reshape(b, l, -1))

    def _seq_attention(self, qkv: torch.Tensor, l_real: int) -> torch.Tensor:
        if l_real is None:
            raise ValueError("sequence-parallel attention needs l_real, the "
                             "real rows of the whole sequence")
        if self.packed:
            return ring_attention(qkv, num_heads=self.num_heads,
                                  l_real=l_real, mesh=self.seq)
        b, lq, d3 = qkv.shape
        q, k, v = (t.reshape(b, lq, self.num_heads, -1)
                   for t in qkv.chunk(3, dim=-1))
        if self.qk_norm:
            q, k = self.q_norm(q), self.k_norm(k)
        k = gather_seq(k, self.seq)[:, :l_real]
        v = gather_seq(v, self.seq)[:, :l_real]
        o = fused_attention(q, k, v, self.attn_impl)
        return o.reshape(b, lq, d3 // 3)


class Mlp(nn.Module):
    """fc1 -> tanh-GELU -> fc2; with a `model` mesh of tp > 1 ranks fc1 is
    column-parallel and fc2 row-parallel over the hidden features."""

    def __init__(self, dim: int, mlp_ratio: float = 4.0, dtype=torch.float32,
                 quant_int8: bool = False, model=None):
        super().__init__()
        hidden = int(dim * mlp_ratio)
        tp = _tp(model)
        if hidden % tp:
            raise ValueError(f"{hidden} hidden features do not split over "
                             f"model_parallel={tp}")
        dense = QuantLinear if quant_int8 else Linear
        self.fc1 = dense(dim, hidden // tp, compute_dtype=dtype,
                         parallel="column", tp_mesh=model)
        self.fc2 = dense(hidden // tp, dim, compute_dtype=dtype,
                         parallel="row", tp_mesh=model)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


class DiTBlock(nn.Module):
    """adaLN DiT block (utils_transformer.py:246-290); `quant_int8`
    quantizes the attention and MLP projections, not adaLN_modulation."""

    def __init__(self, hidden_size: int, num_heads: int,
                 mlp_ratio: float = 4.0, dtype=torch.float32,
                 attn_impl: str = "auto", qk_norm: bool = False,
                 quant_int8: bool = False, seq=None, model=None):
        super().__init__()
        self.attn = Attention(hidden_size, num_heads, dtype=dtype,
                              attn_impl=attn_impl, qk_norm=qk_norm,
                              quant_int8=quant_int8, seq=seq, model=model)
        self.mlp = Mlp(hidden_size, mlp_ratio, dtype=dtype,
                       quant_int8=quant_int8, model=model)
        self.adaLN_modulation = nn.Sequential(
            nn.SiLU(), Linear(hidden_size, 6 * hidden_size,
                              compute_dtype=dtype))

    def forward(self, x: torch.Tensor, c: torch.Tensor,
                l_real: int | None = None) -> torch.Tensor:
        """`l_real`: the real rows of the whole sequence when x is a seq
        rank's shard (Attention)."""
        (shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp,
         gate_mlp) = self.adaLN_modulation(c).chunk(6, dim=-1)
        x = x + gate_msa[:, None, :] * self.attn(
            modulate(norm_noaffine(x), shift_msa, scale_msa), l_real)
        x = x + gate_mlp[:, None, :] * self.mlp(
            modulate(norm_noaffine(x), shift_mlp, scale_mlp))
        return x


class DiTStack(nn.ModuleList):
    """`num_layers` DiT blocks run in a Python loop (the JAX package scans
    one block over stacked params).  On one rank it runs at the real token
    count L: the attention kernel masks its ragged tile itself, so no
    padding.  With a `seq` mesh of sp > 1 ranks (transformer.py:525-551) it
    pads the tokens to `plan_packed(L)`'s length Lp (Lp % sp == 0), runs
    the blocks on this rank's Lp/sp rows and all-gathers the result over
    the ring before slicing it back to L: every seq rank returns the whole
    [b, L, d].  With a `model` mesh of tp > 1 ranks every block holds its
    tensor-parallel shards (module docstring).  With a `pipe` mesh of
    pp > 1 stages, stage p holds layers [p·n, (p+1)·n) of n = num_layers
    / pp, as blocks 0 .. n - 1, and runs them through `pipeline_apply` on
    pp microbatches of the batch (JAX's default; gcd(b, pp) when pp does
    not divide b, where JAX asserts); every stage returns the whole
    output.  `checkpoint`: recompute each block in the backward instead
    of keeping its activations (only while grad mode is on).
    Like JAX's stack it takes `attn_impl`, `quant_int8` and no `qk_norm`
    (transformer.py:480-642)."""

    def __init__(self, hidden_size: int, num_heads: int, num_layers: int,
                 mlp_ratio: float = 4.0, dtype=torch.float32,
                 checkpoint: bool = False, attn_impl: str = "auto",
                 quant_int8: bool = False, seq=None, model=None, pipe=None):
        pp = 1 if pipe is None else pipe.pp
        if num_layers % pp:
            raise ValueError(f"{num_layers} layers do not split over "
                             f"pipe_parallel={pp}")
        super().__init__(DiTBlock(hidden_size, num_heads, mlp_ratio,
                                  dtype=dtype, attn_impl=attn_impl,
                                  quant_int8=quant_int8, seq=seq,
                                  model=model)
                         for _ in range(num_layers // pp))
        self.checkpoint = checkpoint
        self.seq = seq
        self.pipe = pipe if pp > 1 else None

    def _run(self, x: torch.Tensor, c: torch.Tensor, l_real=None
             ) -> torch.Tensor:
        remat = self.checkpoint and torch.is_grad_enabled()
        for block in self:
            if remat:
                x = torch.utils.checkpoint.checkpoint(block, x, c, l_real,
                                                      use_reentrant=False)
            else:
                x = block(x, c, l_real)
        return x

    def forward(self, x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        if self.pipe is not None:
            return pipeline_apply(self.pipe, self._run, x, c,
                                  params=list(self.parameters()))
        sp = 1 if self.seq is None else self.seq.sp
        if sp == 1:
            return self._run(x, c)
        l = x.shape[1]
        lp = plan_packed(l)[0]
        if lp % sp:
            raise ValueError(f"padded token axis {lp} does not divide "
                             f"seq_parallel={sp}")
        lq, s = lp // sp, self.seq.seq_rank
        x = F.pad(x, (0, 0, 0, lp - l))[:, s * lq:(s + 1) * lq]
        return gather_seq(self._run(x, c, l), self.seq)[:, :l]
