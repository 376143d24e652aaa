"""Megatron's two conjugate functions over the `model` axis.

Counterpart of what XLA inserts for JAX's tensor parallelism
(open_diffusiongs_tpu/parallel/mesh.py::dit_tp_rule: column-parallel q / k
/ v and fc1, row-parallel proj and fc2).  The port runs one process per
model rank, so it writes the collectives itself, as autograd Functions:
  * `copy_to_model` at a column-parallel input: the identity forward, the
    sum over `model` backward.  Each rank's qkv / fc1 shard gives only its
    part of the input's cotangent; without the sum every replicated
    parameter before it (adaLN, the embedders) would train on one rank's
    part.
  * `reduce_from_model` at a row-parallel output: the sum over `model`
    forward, the identity backward (every model rank then holds the whole
    output and the same cotangent).

Both sums are the same deterministic reduction (`ordered_sum`): the model
ranks' tensors are all-gathered in the tensor's dtype and added in f32 in
model-rank order 0, 1, ..., tp - 1, so every rank holds the same bits.
With bf16 compute each rank's partial product has already been rounded to
bf16 by its own GEMM (f32 accumulation inside); the sum of the partials is
f32, the row-parallel layer adds its bias to it and rounds to bf16 once
(models/transformer.py::Linear).  A one-rank layer rounds once, so TP adds
one bf16 rounding of each partial.  `BYTES` counts the bytes of every
tensor so reduced (one all-reduce's payload each).
"""

from __future__ import annotations

import torch

BYTES = 0     # payload bytes of the sums over `model` this process made


def ordered_sum(t: torch.Tensor, mesh) -> torch.Tensor:
    """The sum over the model ranks of `t`, in f32, added in rank order
    (`Mesh.ordered_sum`), counted in `BYTES`."""
    global BYTES
    BYTES += t.numel() * t.element_size()
    return mesh.ordered_sum(t, "model")


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ordered_sum(g, ctx.mesh).to(g.dtype), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.dtype = x.dtype
        return ordered_sum(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype), None


def _active(mesh) -> bool:
    return mesh is not None and mesh.tp > 1


def copy_to_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """x itself; its cotangent is summed over `model` (a column-parallel
    layer's input, or a replicated parameter used on local heads)."""
    if not _active(mesh) or not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _CopyToModel.apply(x, mesh)


def reduce_from_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """The f32 sum of x over `model` (a row-parallel layer's partial
    products); its cotangent passes through unchanged."""
    if not _active(mesh):
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _ReduceFromModel.apply(x, mesh)
    return ordered_sum(x, mesh)
