"""Rasterizer and blend: device ms an asset of the kernels from the
denoiser's return to the next step (the trace's `render` phase: the
rasterizer, the blend, the sampler's few elementwise operations, and the
results' transfer after the last step)."""

from odgs_bench.trace import phase_ms


def read(ctx):
    return phase_ms(ctx, "render", "assets")
