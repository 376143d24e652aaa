"""The traced run: torch.profiler's device activity over the traced calls,
kept in memory and reduced to a summary that the per-layer readers take
their numbers from.

Only device activity is recorded (kernels, copies, sets), which keeps the
profiler's host cost small.  To tell the layers apart on the device
timeline the harness launches a one-cycle marker kernel (`spin_kernel`,
torch.cuda._sleep) on the program's one stream at each boundary it can
see: before every call or step, in sampling when the denoiser is
entered and when it returns (forward hooks), and in training at the
edges of the port's LPIPS function, forward and backward (`bracket`).  The markers run in launch
order, so the k-th marker on the device is the k-th label launched, and
every kernel belongs to the phase the marker before it opened:
  pipeline   from a call's start to its first denoiser step (the
             condition's upload, the initial noise);
  denoiser   the DiT of one step;
  render     from the denoiser's return to the next step (the rasterizer,
             the blend and the sampler's few elementwise operations) and,
             after the last step, the transfer of the results;
  step       a training step but its LPIPS (training cells mark each
             step);
  lpips      the LPIPS function's forward, and its backward: from the
             gradient's arrival at its output to its departure at its
             inputs (the autograd engine runs the function's nodes
             together, the latest-made first).

Summary keys:
  window_s    host seconds of the traced calls;
  busy_s      seconds in which something ran on the card: the union of
              the device intervals;
  kernels     {name: [launches, device seconds]};
  phases      {phase: device seconds of its kernels};
  device_ops  the ten device operations that took most time;
  idle_gaps   the gaps between device intervals by the phase whose
              launches the card was waiting for: each phase's total, then
              the longest single gaps (ten entries in all).
"""

from __future__ import annotations

import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

MARKER = "spin_kernel"
WAITING_FOR = {"pipeline": "host: pipeline stages between calls",
               "denoiser": "host: DiT launches",
               "render": "host: rasterizer and sampler launches",
               "step": "host: train step launches",
               "lpips": "host: LPIPS launches"}


class _Edge(torch.autograd.Function):
    """The identity; its forward launches the marker `fwd` and its
    backward the marker `bwd`."""

    @staticmethod
    def forward(ctx, x, mark, fwd, bwd):
        ctx.mark, ctx.bwd = mark, bwd
        mark(fwd)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        ctx.mark(ctx.bwd)
        return g, None, None, None


class Tracer:
    """Markers at the denoiser's edges (forward hooks; none when
    `denoiser` is None) and wherever the harness calls `mark`, and the
    profiler around the traced calls."""

    def __init__(self, denoiser=None):
        self.labels = []
        self.hooks = [] if denoiser is None else [
            denoiser.register_forward_pre_hook(
                lambda m, a: self.mark("denoiser"), prepend=True),
            denoiser.register_forward_hook(
                lambda m, a, o: self.mark("render"), prepend=True)]
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.t0 = None
        self.undo = []

    def mark(self, label: str) -> None:
        torch.cuda._sleep(1)
        self.labels.append(label)

    def bracket(self, owner, attr: str, label: str, after: str) -> None:
        """Until `stop`, owner.attr opens the phase `label` when it is
        called and `after` when it returns; in the backward, the gradient
        reaching its output opens `label` and leaving its inputs `after`."""
        fn = getattr(owner, attr)
        mark = self.mark

        def bracketed(*args):
            if not any(torch.is_tensor(a) and a.requires_grad for a in args):
                mark(label)
            args = [_Edge.apply(a, mark, label, after)
                    if torch.is_tensor(a) and a.requires_grad else a
                    for a in args]
            return _Edge.apply(fn(*args), mark, after, label)

        setattr(owner, attr, bracketed)
        self.undo.append((owner, attr, fn))

    def start(self) -> None:
        torch.cuda.synchronize()
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    def stop(self) -> dict:
        torch.cuda.synchronize()
        window = time.perf_counter() - self.t0
        self.prof.__exit__(None, None, None)
        for h in self.hooks:
            h.remove()
        for owner, attr, fn in self.undo:
            setattr(owner, attr, fn)
        t0 = time.perf_counter()
        device = []
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() != DeviceType.CPU:
                device.append((e.start_ns(), e.end_ns(), e.name()))
        self.prof = None
        summary = summarize(device, self.labels, window)
        summary["events"] = len(device)
        summary["reduce_s"] = time.perf_counter() - t0
        return summary


def summarize(device: list, labels: list, window_s: float) -> dict:
    """device: (start_ns, end_ns, name) of every device operation; labels:
    the markers' phases in launch order -> the summary (module
    docstring)."""
    device = sorted(device)
    marks = [d for d in device if MARKER in d[2]]
    if len(marks) != len(labels):
        raise RuntimeError(f"{len(marks)} markers on the device for "
                           f"{len(labels)} launched")
    work = [d for d in device if MARKER not in d[2]]
    if not work:
        raise RuntimeError("the profiler recorded no device activity")
    m_start = np.array([m[0] for m in marks], dtype=np.int64)
    iv = np.array([(s, e) for s, e, _ in work], dtype=np.float64)
    # each operation's phase: that of the last marker started before it
    which = np.searchsorted(m_start, iv[:, 0], side="right")
    phase_of = np.array([labels[0] if labels else "pipeline"]
                        + list(labels))[which]
    kernels, phases = {}, {}
    for (s, e, n), ph in zip(work, phase_of):
        k = kernels.setdefault(_short(n), [0, 0.0])
        k[0] += 1
        k[1] += (e - s) / 1e9
        phases[str(ph)] = phases.get(str(ph), 0.0) + (e - s) / 1e9
    # the union of the intervals and the gaps between its pieces
    ends = np.maximum.accumulate(iv[:, 1])
    new = np.r_[True, iv[1:, 0] > ends[:-1]]
    first = np.flatnonzero(new)
    starts_u = iv[first, 0]
    ends_u = np.r_[ends[first[1:] - 1], ends[-1]]
    busy = float((ends_u - starts_u).sum()) / 1e9
    gaps = starts_u[1:] - ends_u[:-1]
    cause = phase_of[first[1:]]
    idle = []
    for ph in WAITING_FOR:
        sel = (cause == ph) & (gaps > 0)
        if sel.any():
            idle.append([f"{WAITING_FOR[ph]}: all {int(sel.sum())} gaps",
                         float(gaps[sel].sum()) / 1e9])
    idle += [[f"{WAITING_FOR[str(cause[i])]}: one gap", float(gaps[i]) / 1e9]
             for i in np.argsort(-gaps)[:10 - len(idle)] if gaps[i] > 0]
    ops = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:10]
    return {"window_s": window_s, "busy_s": busy, "kernels": kernels,
            "phases": phases, "device_ops": [[n, v[1]] for n, v in ops],
            "idle_gaps": idle}


def _short(name: str) -> str:
    for junk in ("void ", "(anonymous namespace)::", "at::native::"):
        name = name.replace(junk, "")
    return name[:80]


def phase_ms(ctx: dict, phase: str, per: str):
    """Device ms of a phase's kernels per unit of the window's work
    (`per`: "assets" or "steps"); None when the trace has none."""
    s = ctx["trace"]["phases"].get(phase, 0.0)
    return 1e3 * s / ctx[per] if s > 0 and ctx.get(per) else None
