"""Model-FLOP share of the card's bf16 peak over the traced window: the
DiT's forward FLOPs (counts.dit_flops) of the work completed, over
window × 989 TFLOP/s.  Sampling: the sampler's steps a call × the assets.
Training: 3 × one sample's forward (forward and backward, not the
blocks' recompute) × the samples."""

from odgs_bench import counts


def read(ctx):
    t, traffic = ctx["trace"], ctx["traffic"]
    if t["window_s"] <= 0:
        return None
    if traffic["kind"] == "sample":
        sm, l, _, _ = counts.dit_shape(ctx["config"], traffic["views"])
        work = ctx["config"]["system"].get("num_inference_steps", 30) * ctx[
            "assets"]
    else:
        sm, l, _, _ = counts.dit_shape(ctx["config"], traffic["views_in"])
        work = 3 * ctx["samples"]
    if not work:
        return None
    return (100.0 * counts.dit_flops(sm, l) * work
            / (t["window_s"] * counts.BF16_FLOPS))
