"""Operations, bytes and the card's peaks: the yardstick of every roofline
and model-FLOP share the benchmark reports.

Peaks are the published dense rates of one NVIDIA H100 SXM (at its full
700 W limit): 989 TFLOP/s in bf16, 3.35 TB/s of HBM.  A bound is the
larger of operations over the peak and bytes over the bandwidth.
"""

from __future__ import annotations

BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
BF16 = 2


def bound_s(flops: float, nbytes: float) -> float:
    return max(flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S)


def attn_fwd(b: int, l: int, heads: int, dh: int) -> tuple:
    """(operations, bytes) of one attention forward: q·kᵀ and P·V over
    every key, 4·b·h·L²·d; q, k, v read and o written once in bf16."""
    return 4 * b * heads * l * l * dh, 4 * b * l * heads * dh * BF16


def attn_fwd_stats(b: int, l: int, heads: int, dh: int) -> tuple:
    """The training forward, which also writes the f32 log-sum-exp."""
    f, nb = attn_fwd(b, l, heads, dh)
    return f, nb + 4 * b * heads * l


def attn_bwd(b: int, l: int, heads: int, dh: int) -> tuple:
    """The backward: 2.5x the forward's operations (S, dP, dQ, dK, dV);
    q, k, v, o, dO and the lse read, dq, dk, dv written once."""
    f, _ = attn_fwd(b, l, heads, dh)
    return 2.5 * f, 8 * b * l * heads * dh * BF16 + 4 * b * heads * l


def tokens(sm: dict, res: int, views: int) -> int:
    """L = free Gaussian tokens + views · (res / patch)²."""
    return sm["n_gaussians"] + views * (res // sm["patch_size"]) ** 2


def dit_flops(sm: dict, l: int) -> float:
    """Model FLOPs of one DiT forward of one sample: 2 × the blocks'
    per-token Linear parameters (q, k, v, proj, fc1, fc2: 12 d²) × L, plus
    4·L²·d·heads of attention a layer.  The tokenizer, the heads, the
    per-sample adaLN modulation, the rasterizer and LPIPS are not counted."""
    d, n_layers = sm["width"], sm["num_layers"]
    return n_layers * (2 * 12 * d * d * l + 4 * l * l * d)


def dit_shape(config: dict, views: int) -> tuple:
    """(shape_model, L, heads, head size) of a configuration's DiT over
    `views` views at its training resolution."""
    sm = config["system"]["shape_model"]
    l = tokens(sm, config["data"]["training_res"][0], views)
    return sm, l, sm["width"] // sm["dim_heads"], sm["dim_heads"]
