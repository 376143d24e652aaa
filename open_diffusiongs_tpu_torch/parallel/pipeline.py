"""Pipeline parallelism: GPipe microbatches over the `pipe` stages.

Counterpart of open_diffusiongs_tpu/parallel/pipeline.py (:42-102).  Stage
p of S (parallel/mesh.py's pipe axis, one process each) holds layers
[p·L/S, (p+1)·L/S) of the DiT stack (models/transformer.py::DiTStack).
The batch's rows are split into n_microbatches microbatches; stage p runs
microbatch m once stage p - 1 has sent it, so at step t it runs
microbatch t - p, JAX's schedule, with its S - 1 steps of fill and drain.
Activations go to the next stage over the pipe group with `Mesh.send` /
`Mesh.recv`, staged through pinned host buffers under gloo as the ring's
shifts are (gloo has no point-to-point on CUDA tensors).  The last stage's
output goes to every stage (a broadcast, JAX's masked psum :99-101), so
the heads, the renderer and the loss run SPMD on every stage.

The backward is the reverse pipeline, one autograd Function per stage
(`_Pipeline`): the last stage takes its own output's cotangent (every
stage computed the same loss; the other stages' copies are not counted),
each stage runs the backward of its layers microbatch by microbatch, in
the forward's order, and sends the cotangent of its input to the stage
before it.  Block checkpointing composes per block inside `stage_fn`.
What is replicated over `pipe` gets its gradient counted once:
  * the conditioning c (the timestep embedding) feeds every stage's
    adaLN, so its cotangent is the sum over the stages (f32, in stage
    order) before it reaches the t-embedder;
  * the stack's input gets its cotangent on stage 0 only, and stage 0's
    is sent to every stage, so the embedders before the stack train alike
    on every stage;
  * the heads after the stack get the same cotangent on every stage, so
    their gradient is whole on each already.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch


def _microbatches(b: int, s: int, n: Optional[int]) -> int:
    n = n or math.gcd(b, s)
    if b % n:
        raise ValueError(f"batch {b} does not split into {n} microbatches")
    return n


def _forward(mesh, stage_fn, x, c, n: int, grad: bool):
    """This stage's part of the schedule.  Returns the stack's output on
    every stage and, with `grad`, each microbatch's (input, c, output)."""
    s, p = mesh.pp, mesh.pipe_rank
    xs, cs = x.chunk(n), c.chunk(n)
    outs, saved, sends = [], [], []
    for m in range(n):
        h = xs[m] if p == 0 else mesh.recv(xs[m], "pipe", p - 1, tag=m)
        c_m = cs[m]
        if grad:
            h = h.detach().requires_grad_()
            c_m = c_m.detach().requires_grad_()
            with torch.enable_grad():
                y = stage_fn(h, c_m)
            saved.append((h, c_m, y))
        else:
            y = stage_fn(h, c_m)
        if p < s - 1:
            sends.append(mesh.send(y.detach(), "pipe", p + 1, tag=m))
        else:
            outs.append(y.detach())
    for w in sends:
        w.wait()
    out = torch.cat(outs) if p == s - 1 else torch.empty_like(x)
    return mesh.broadcast_(out, "pipe", s - 1), saved


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, stage_fn, n, x, c, *params):
        out, saved = _forward(mesh, stage_fn, x, c, n, grad=True)
        ctx.mesh, ctx.n, ctx.saved, ctx.params = mesh, n, saved, params
        ctx.x_meta = (x.shape, x.dtype, x.device)
        return out

    @staticmethod
    def backward(ctx, g):
        mesh, n, params = ctx.mesh, ctx.n, ctx.params
        s, p = mesh.pp, mesh.pipe_rank
        g_chunks = g.chunk(n)
        g_x, g_c, g_p, sends = [], [], [None] * len(params), []
        for m, (h, c_m, y) in enumerate(ctx.saved):
            g_y = (g_chunks[m] if p == s - 1 else
                   mesh.recv(y, "pipe", p + 1, tag=n + m))
            gh, gc, *gp = torch.autograd.grad(
                y, (h, c_m, *params), g_y.to(y.dtype), allow_unused=True)
            if p > 0:
                sends.append(mesh.send(gh, "pipe", p - 1, tag=n + m))
            else:
                g_x.append(gh)
            g_c.append(gc if gc is not None else torch.zeros_like(c_m))
            g_p = [a if b is None else (b if a is None else a + b)
                   for a, b in zip(g_p, gp)]
        for w in sends:
            w.wait()
        ctx.saved = None
        shape, dtype, device = ctx.x_meta
        gx = (torch.cat(g_x) if p == 0 else
              torch.empty(shape, dtype=dtype, device=device))
        mesh.broadcast_(gx, "pipe", 0)
        gc = torch.cat(g_c)
        return (None, None, None, gx,
                mesh.ordered_sum(gc, "pipe").to(gc.dtype), *g_p)


def pipeline_apply(mesh, stage_fn: Callable, x: torch.Tensor,
                   c: torch.Tensor, n_microbatches: Optional[int] = None,
                   params: Sequence[torch.Tensor] = ()) -> torch.Tensor:
    """Run `stage_fn(h, c_mb) -> h` (this stage's layers on one microbatch)
    as an S-stage GPipe pipeline over `mesh`'s pipe axis.  x [b, ...]: the
    stack's input (read on stage 0; every stage passes one of the same
    shape and dtype), c [b, ...]: per-sample conditioning, both this data
    rank's batch.  `n_microbatches` must divide b (default: S, or
    gcd(b, S) when S does not divide b).  `params`: the stage's
    parameters, which `stage_fn` uses.  Returns the last stage's output on
    every stage; differentiable (module docstring) when grad mode is on
    and x, c or a parameter requires grad."""
    n = _microbatches(x.shape[0], mesh.pp, n_microbatches)
    if torch.is_grad_enabled() and (
            x.requires_grad or c.requires_grad
            or any(q.requires_grad for q in params)):
        return _Pipeline.apply(mesh, stage_fn, n, x, c, *params)
    return _forward(mesh, stage_fn, x, c, n, grad=False)[0]
