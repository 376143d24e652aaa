"""W8A8 int8 projections for serving (the DiT's q/k/v/proj and fc1/fc2).

Counterpart of open_diffusiongs_tpu/ops/quant.py:48-88, with the same
arithmetic so one checkpoint gives one function in both packages:
  * weights: per-output-channel absmax/127 scales, taken in f32 from the
    f32 master weight (not its bf16 copy), on every call, as JAX computes
    them inside the graph;
  * activations: dynamic per-token absmax/127 scales;
  * round half to even, clip to ±127;
  * an int8 x int8 -> int32 product (exact: 127 * 127 * cin < 2^31 for
    any cin < 133k);
  * `acc.float() * sx * sw` in that order, then the f32 bias, then a cast
    to the compute dtype.

The int32 product is `torch._int_mm` (cuBLASLt on the card, PyTorch's own
loop on the CPU); JAX leaves it to XLA's `dot_general`, not to a Pallas
kernel.  On CUDA `_int_mm` takes m > 16 and k, n multiples of 8: any other
shape raises, since there is no float fallback.  `LAUNCHES` counts its
calls on either device.

Under tensor parallelism (JAX tests/test_quant.py:120-155) a
column-parallel QuantLinear holds whole weight rows and reads the whole
input, so its scales and its output columns are the one-rank layer's.  A
row-parallel one (`tp_mesh`) holds a slice of every weight row and of
every input row: the per-token and per-channel absmax are each a MAX over
`model` before quantizing, and the int32 accumulators are summed over
`model` before the dequantization.  Integer sums are exact, so its output
equals the one-rank layer's bit for bit.

Serving only: rounding has zero gradient almost everywhere, so the
denoiser refuses `training=True` with `quant_int8` (models/denoiser.py).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn

LAUNCHES = 0   # torch._int_mm calls (int8 products), on any device


def quantize_rows(x: torch.Tensor, dim: int, tp_mesh=None):
    """Symmetric int8 quantization along `dim` (absmax/127 scales), in f32.
    Returns (int8 values, f32 scales with `dim` kept as size 1).  With a
    `tp_mesh` of tp > 1 the rows are split over `model` and the absmax is
    the whole row's (a MAX over the model ranks)."""
    x32 = x.float()
    amax = x32.abs().amax(dim=dim, keepdim=True)
    if tp_mesh is not None and tp_mesh.tp > 1:
        tp_mesh.all_reduce_(amax, "model", op=dist.ReduceOp.MAX)
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(x32 / scale), -127, 127)
    return q.to(torch.int8), scale


def int8_matmul(x: torch.Tensor, weight: torch.Tensor, tp_mesh=None
                ) -> torch.Tensor:
    """[..., cin] @ weight[cout, cin]ᵀ through an int8 product; returns f32.
    Per-token activation scales, per-output-channel weight scales.  With a
    `tp_mesh` of tp > 1, x and weight hold this model rank's slice of cin
    (row-parallel): the scales and the int32 product are the whole
    rows' (module docstring)."""
    global LAUNCHES
    cout, cin = weight.shape
    xq, sx = quantize_rows(x, -1, tp_mesh)
    wq, sw = quantize_rows(weight, 1, tp_mesh)     # [cout, cin], [cout, 1]
    x2 = xq.reshape(-1, cin)
    m = x2.shape[0]
    if x2.is_cuda and not (m > 16 and cin % 8 == 0 and cout % 8 == 0):
        raise ValueError(
            f"int8_matmul: torch._int_mm on CUDA takes m > 16 and k, n "
            f"multiples of 8; got m={m}, k={cin}, n={cout}")
    acc = torch._int_mm(x2, wq.t())                # [m, cout] int32
    LAUNCHES += 1
    if tp_mesh is not None and tp_mesh.tp > 1:
        tp_mesh.all_reduce_(acc, "model")          # exact: integers
    return (acc.float().reshape(*x.shape[:-1], cout) * sx
            * sw.reshape(cout))


class QuantLinear(nn.Linear):
    """`models/transformer.py::Linear` with the W8A8 product: the same
    parameters (f32 weight [out, in], f32 bias), so a checkpoint of the
    float model loads unchanged; the output is cast to `compute_dtype`.
    `parallel="row"` with a `tp_mesh` of tp > 1: this rank's slice of the
    input features (module docstring); "column" needs nothing more."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, compute_dtype=torch.float32,
                 parallel=None, tp_mesh=None):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = compute_dtype
        self.tp_mesh = tp_mesh if parallel == "row" else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = int8_matmul(x, self.weight, self.tp_mesh)
        if self.bias is not None:
            y = y + self.bias.float()
        return y.to(self.compute_dtype)

