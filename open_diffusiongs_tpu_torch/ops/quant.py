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

Serving only: rounding has zero gradient almost everywhere, so the
denoiser refuses `training=True` with `quant_int8` (models/denoiser.py).
"""

from __future__ import annotations

import torch
from torch import nn

LAUNCHES = 0   # torch._int_mm calls (int8 products), on any device


def quantize_rows(x: torch.Tensor, dim: int):
    """Symmetric int8 quantization along `dim` (absmax/127 scales), in f32.
    Returns (int8 values, f32 scales with `dim` kept as size 1)."""
    x32 = x.float()
    scale = torch.clamp(x32.abs().amax(dim=dim, keepdim=True),
                        min=1e-12) / 127.0
    q = torch.clamp(torch.round(x32 / scale), -127, 127)
    return q.to(torch.int8), scale


def int8_matmul(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """[..., cin] @ weight[cout, cin]ᵀ through an int8 product; returns f32.
    Per-token activation scales, per-output-channel weight scales."""
    global LAUNCHES
    cout, cin = weight.shape
    xq, sx = quantize_rows(x, -1)
    wq, sw = quantize_rows(weight, 1)              # [cout, cin], [cout, 1]
    x2 = xq.reshape(-1, cin)
    m = x2.shape[0]
    if x2.is_cuda and not (m > 16 and cin % 8 == 0 and cout % 8 == 0):
        raise ValueError(
            f"int8_matmul: torch._int_mm on CUDA takes m > 16 and k, n "
            f"multiples of 8; got m={m}, k={cin}, n={cout}")
    acc = torch._int_mm(x2, wq.t())                # [m, cout] int32
    LAUNCHES += 1
    return (acc.float().reshape(*x.shape[:-1], cout) * sx
            * sw.reshape(cout))


class QuantLinear(nn.Linear):
    """`models/transformer.py::Linear` with the W8A8 product: the same
    parameters (f32 weight [out, in], f32 bias), so a checkpoint of the
    float model loads unchanged; the output is cast to `compute_dtype`."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, compute_dtype=torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = int8_matmul(x, self.weight)
        if self.bias is not None:
            y = y + self.bias.float()
        return y.to(self.compute_dtype)

