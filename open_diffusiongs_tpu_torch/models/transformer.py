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

Left out of this port (ROADMAP Queue 1): splash routing, subset
attention, ring / pipeline / tensor-parallel meshes, qk_norm and W8A8.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from ..ops.attention import flash_attention


class Linear(nn.Linear):
    """nn.Linear that computes in `compute_dtype` (flax Dense(dtype=...)):
    the input, weight and bias are cast to it; parameters stay f32."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, compute_dtype=torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


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


class Attention(nn.Module):
    """Multi-head self-attention with a fused qkv projection (timm layout:
    output rows q | k | v, head-major columns inside each third).  The
    attention itself is ops/attention.py::flash_attention on the qkv
    output (column slices, no copy): differentiable through its backward
    kernels when training, the stats-free forward under no_grad."""

    def __init__(self, dim: int, num_heads: int, dtype=torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = Linear(dim, 3 * dim, compute_dtype=dtype)
        self.proj = Linear(dim, dim, compute_dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        o = flash_attention(self.qkv(x), num_heads=self.num_heads,
                            l_real=x.shape[1])
        return self.proj(o)


class Mlp(nn.Module):
    def __init__(self, dim: int, mlp_ratio: float = 4.0, dtype=torch.float32):
        super().__init__()
        hidden = int(dim * mlp_ratio)
        self.fc1 = Linear(dim, hidden, compute_dtype=dtype)
        self.fc2 = Linear(hidden, dim, compute_dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


class DiTBlock(nn.Module):
    """adaLN DiT block (utils_transformer.py:246-290)."""

    def __init__(self, hidden_size: int, num_heads: int,
                 mlp_ratio: float = 4.0, dtype=torch.float32):
        super().__init__()
        self.attn = Attention(hidden_size, num_heads, dtype=dtype)
        self.mlp = Mlp(hidden_size, mlp_ratio, dtype=dtype)
        self.adaLN_modulation = nn.Sequential(
            nn.SiLU(), Linear(hidden_size, 6 * hidden_size,
                              compute_dtype=dtype))

    def forward(self, x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        (shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp,
         gate_mlp) = self.adaLN_modulation(c).chunk(6, dim=-1)
        x = x + gate_msa[:, None, :] * self.attn(
            modulate(norm_noaffine(x), shift_msa, scale_msa))
        x = x + gate_mlp[:, None, :] * self.mlp(
            modulate(norm_noaffine(x), shift_mlp, scale_mlp))
        return x


class DiTStack(nn.ModuleList):
    """`num_layers` DiT blocks run in a Python loop (the JAX package scans
    one block over stacked params).  Runs at the real token count L: the
    attention kernel masks its ragged tile itself, so no padding.
    `checkpoint`: recompute each block in the backward instead of keeping
    its activations (only while grad mode is on)."""

    def __init__(self, hidden_size: int, num_heads: int, num_layers: int,
                 mlp_ratio: float = 4.0, dtype=torch.float32,
                 checkpoint: bool = False):
        super().__init__(DiTBlock(hidden_size, num_heads, mlp_ratio,
                                  dtype=dtype) for _ in range(num_layers))
        self.checkpoint = checkpoint

    def forward(self, x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        remat = self.checkpoint and torch.is_grad_enabled()
        for block in self:
            if remat:
                x = torch.utils.checkpoint.checkpoint(block, x, c,
                                                      use_reentrant=False)
            else:
                x = block(x, c)
        return x
