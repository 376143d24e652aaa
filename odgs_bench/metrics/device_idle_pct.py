"""Device: the share of the traced window in which no kernel, copy or
set ran on the card: 1 - (union of device intervals) / window."""


def read(ctx):
    t = ctx["trace"]
    if t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
