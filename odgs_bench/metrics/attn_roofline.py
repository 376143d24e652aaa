"""Attention kernels: the share of their roofline (odgs_bench/counts.py)
that the packed attention kernels reach, their bound over their device
time.  Sampling: the forward (#1, flash_fwd_kernel), one launch a layer
on the call's batch.  Training: the forward with the log-sum-exp (#1s,
twice a layer: the forward and the blocks' recompute) and the backward
(#3, flash_bwd_dq_kernel + flash_bwd_dkv_kernel, counted once a call by
its dq kernel).  b = the traffic's batch, L = 2 + views·(res/8)²."""

from odgs_bench import counts


def _sums(kernels, part):
    hits = [v for k, v in kernels.items() if part in k]
    return sum(v[0] for v in hits), sum(v[1] for v in hits)


def read(ctx):
    k, traffic = ctx["trace"]["kernels"], ctx["traffic"]
    n_fwd, s_fwd = _sums(k, "flash_fwd_kernel")
    if traffic["kind"] == "sample":
        _, l, heads, dh = counts.dit_shape(ctx["config"], traffic["views"])
        bound = n_fwd * counts.bound_s(*counts.attn_fwd(
            traffic["batch"], l, heads, dh))
        secs = s_fwd
        if not n_fwd:
            return None
    else:
        n_bwd, _ = _sums(k, "flash_bwd_dq_kernel")
        _, s_bwd = _sums(k, "flash_bwd_d")
        if not n_fwd or not n_bwd:
            return None
        _, l, heads, dh = counts.dit_shape(ctx["config"],
                                           traffic["views_in"])
        b = traffic["batch"]
        bound = (n_fwd * counts.bound_s(*counts.attn_fwd_stats(
            b, l, heads, dh)) + n_bwd * counts.bound_s(
                *counts.attn_bwd(b, l, heads, dh)))
        secs = s_fwd + s_bwd
    return 100.0 * bound / secs if secs > 0 else None
