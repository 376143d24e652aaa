"""Losses: device ms a step of the port's LPIPS function, forward and
backward (the trace's `lpips` phase, marked at the function's edges)."""

from odgs_bench.trace import phase_ms


def read(ctx):
    return phase_ms(ctx, "lpips", "steps")
