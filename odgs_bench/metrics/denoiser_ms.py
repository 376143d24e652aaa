"""DiT: device ms an asset of the kernels between the denoiser's entry
and its return (the trace's `denoiser` phase)."""

from odgs_bench.trace import phase_ms


def read(ctx):
    return phase_ms(ctx, "denoiser", "assets")
