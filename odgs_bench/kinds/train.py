"""Training cells: back-to-back steps of the train step that
`make_train_step` returns over `ObjectSystem.train_loss`, as `launch.py`
builds it (the configuration's AdamW, clipping, cosine schedule, EMA
0.9999), from the traffic's start step, on seeded on-card batches.

Set-up builds the one train step object, seeded weights loaded, and
drives it through its first three steps on three different batches: they
warm every shape up and are what the check compares.  The window then
runs steps on further batches; `train_samples_per_s` is the samples of
every step it ran over its length, the last step synchronised.

The check, once the window has closed and the program is freed: the
plain reference (f32, TF32 off) runs the same three steps from the same
weights, EMA, batches and noise draws, and
  loss_gap    each step's loss, relative, worst of three;
  grad_gap    the first step's clipped gradient as the optimizer got it
              (its first moment / (1 - beta1)), by leaf: the gap of the
              two norms against the larger of the reference leaf's norm
              and the median leaf's; the median over the leaves;
  change_gap  the weights' change after three steps, likewise;
  ema_gap     the EMA's change after three steps, likewise, worst leaf.
The median leaf for the gradient and the change, not the worst: the two
free Gaussians' leaves (the upsampler head and their embedding) reach
the loss through 2 of the 262,146 Gaussians, whose tiles keep the
nearest K candidates by depth, and their gaps swing 100-fold from seed
to seed with the order of the candidates near the cap; the worst leaf is
printed beside the verdict.  Leaves whose reference gradient is under a
thousandth of the median leaf's are left out of those two (a gradient
that is round-off under Adam's normalisation moves its leaf by
round-off).  The EMA starts away from the weights, as a state resumed at
the start step holds it (`ema_start`), so that each step's pull of
(1 - decay)·(weights - EMA) is thousands of f32 ulps: an EMA left
unchanged reads 1, a wrong decay reads its error.
"""

from __future__ import annotations

import gc
import sys
import time

import numpy as np
import torch

from .. import generator, weights

GAPS = ("loss_gap", "grad_gap", "change_gap", "ema_gap")


def lpips_std(name: str, shape) -> float:
    """He scale for the VGG's kernels; the linear heads 0.01 (made
    positive below)."""
    if ".kernel" in name and len(shape) == 4:
        return float(np.sqrt(2.0 / (shape[1] * 9)))
    return 0.01


def lpips_weights(ref, seed: int, device) -> dict:
    p = weights.make(ref.lpips_shapes(), seed + 1, device, std=lpips_std)
    for k in p:
        if k.startswith("lin."):
            p[k] = p[k].abs()
    return p


def to_port_lpips(p: dict) -> dict:
    """The benchmark's LPIPS weights in the layout of the port's
    `lpips_params`."""
    out = {"pretrained": False}
    for k, v in p.items():
        kind, rest = k.split(".", 1)
        if kind == "vgg":
            stage, what = rest.split(".")
            out.setdefault(f"vgg/{stage}", {})[
                "kernel" if what == "kernel" else "bias"] = v
        else:
            out[f"lin/{rest.split('.')[0]}"] = v
    return out


def batches(config: dict, traffic: dict, seed: int, device) -> list:
    res = config["data"]["training_res"][0]
    return generator.train_batches(seed, traffic["pool"], traffic["batch"],
                                   traffic["views_in"], traffic["views"],
                                   res, device)


def ema_start(w0: dict, seed: int, device) -> dict:
    """The EMA a state resumed at the start step holds: the weights plus
    an N(0, 0.02) offset on every leaf, drawn from the seed in one call."""
    names = sorted(w0)
    sizes = [w0[n].numel() for n in names]
    gen = torch.Generator(device=device).manual_seed(int(seed) + 3)
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    flat.mul_(weights.STD)
    return {n: w0[n] + t.view_as(w0[n])
            for n, t in zip(names, flat.split(sizes))}


def leaf_norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.norm(v.float().flatten()))
            for k, v in tensors.items()}


def build(config: dict, device, seed: int, ref):
    """The program: system, optimizer, state and the train step."""
    from open_diffusiongs_tpu_torch.parallel.train_step import (
        init_train_state, make_optimizer, make_train_step)
    from open_diffusiongs_tpu_torch.systems.builder import (
        build_optimizer_config, build_system)
    sys_cfg = dict(config["system"], allow_random_lpips=True)
    system = build_system(config["system_type"], sys_cfg, bf16=True,
                          device=device)
    system.model.load_state_dict(weights.make(
        ref.param_shapes(sys_cfg["shape_model"]), seed, device), strict=True)
    system.lpips_params = to_port_lpips(lpips_weights(ref, seed, device))
    params = dict(system.model.named_parameters())
    optimizer = make_optimizer(build_optimizer_config(
        config["system"], config["trainer"]), params.items())
    return system, params, optimizer, init_train_state, make_train_step


def first_steps(ref, config: dict, traffic: dict, seed: int, device):
    """Build the train step and run its first three steps on three
    different batches: ((system, optimizer, state, step, batches), the
    numbers the check compares)."""
    ema_decay = traffic["ema_decay"]
    system, params, optimizer, init_state, make_step = build(
        config, device, seed, ref)
    shapes = ref.param_shapes(config["system"]["shape_model"])
    state = init_state(params, optimizer, ema_decay=ema_decay)
    state.load_ema(ema_start(weights.make(shapes, seed, device), seed,
                             device))
    state.step = traffic["start_step"]
    gen = torch.Generator(device=device).manual_seed(seed + 2)
    step = make_step(lambda batch, s: system.train_loss(batch, s,
                                                        generator=gen),
                     optimizer, ema_decay=ema_decay)
    feed = batches(config, traffic, seed, device)
    losses, grad1 = [], None
    b1 = config["system"]["optimizer"]["args"]["betas"][0]
    for k in range(3):
        state, metrics = step(state, feed[k])
        losses.append(metrics["loss"])
        if k == 0:
            mu = optimizer.state_dict()["mu"]
            # (a moment the step never made reads as no gradient)
            grad1 = {n: float(torch.linalg.norm(mu[n].flatten())) / (1 - b1)
                     if n in mu else 0.0 for n in params}
    w0 = weights.make(shapes, seed, device)
    e0 = ema_start(w0, seed, device)
    with torch.no_grad():
        change = leaf_norms({n: params[n] - w0[n] for n in params})
        ema = leaf_norms({n: state.ema_params[n] - e0[n] for n in params})
    del w0, e0
    got = {"losses": [float(x) for x in losses], "grad1": grad1,
           "change": change, "ema": ema}
    return (system, optimizer, state, step, feed), got


def readings(cell: dict, seed: int, count: int, device):
    """The check's numbers of seeds seed .. seed + count - 1 without a
    window, one row each, with the worst leaves (the control: `control`)."""
    from .. import harness
    config, traffic = cell["config"], cell["traffic"]
    ref = harness.reference(config["reference"])
    for s in range(seed, seed + count):
        t0 = time.perf_counter()
        prog, got = first_steps(ref, config, traffic, s, device)
        del prog
        _free(device)
        with torch.enable_grad():
            want = reference_steps(ref, config, traffic, s, device)
            row = {"seed": s, "gaps": compare(got, want, worst=True),
                   "losses": got["losses"], "ref_losses": want["losses"]}
        row["seconds"] = time.perf_counter() - t0
        yield row


def control(cell: dict, seed: int, device) -> dict:
    """A run's pieces with the reference a precision lower (fp8 DiT
    products, bf16 render operands) in the program's place for the three
    steps the check compares; no window."""
    from .. import harness
    config, traffic = cell["config"], cell["traffic"]
    ref = harness.reference(config["reference"])
    with torch.enable_grad():
        got = reference_steps(ref, config, traffic, seed, device, low=True)
    gaps = check(ref, config, traffic, seed, device, got)
    return {"setup_s": 0.0, "gaps": gaps, "memory_peak_bytes": 0,
            "attempted": 0, "window": {"steps": 0, "samples": 0,
                                       "window_s": 0.0,
                                       "losses": got["losses"]}}


def _free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def run(cell: dict, seed: int, seconds: float, traced: bool, t_start: float,
        device, ref=None) -> dict:
    """One run of a training cell; returns the harness's pieces of the
    result line."""
    from .. import harness, trace
    config, traffic = cell["config"], cell["traffic"]
    ref = ref or harness.reference(config["reference"])
    cuda = torch.device(device).type == "cuda"
    b = traffic["batch"]

    def sync():
        if cuda:
            torch.cuda.synchronize()

    prog, got = first_steps(ref, config, traffic, seed, device)
    system, optimizer, state, step, feed = prog
    gc.collect()
    gc.freeze()
    sync()
    setup_s = time.perf_counter() - t_start
    tracer = trace.Tracer(None) if traced else None
    if tracer:
        from open_diffusiongs_tpu_torch.systems import losses
        tracer.bracket(losses, "lpips", "lpips", "step")
        tracer.start()
    t0 = time.perf_counter()
    n = 0
    while True:
        if tracer:
            tracer.mark("step")
        state, _ = step(state, feed[3 + n % (len(feed) - 3)])
        n += 1
        if traced:
            if n >= cell["check"]["trace_steps"]:
                break
        elif time.perf_counter() - t0 >= seconds:
            break
    sync()
    elapsed = time.perf_counter() - t0
    win = {"steps": n, "samples": n * b, "window_s": elapsed,
           "losses": got["losses"]}
    if tracer:
        win["trace"] = tracer.stop()
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    gc.unfreeze()
    del system, optimizer, state, step, feed, prog
    _free(device)
    gaps = check(ref, config, traffic, seed, device, got)
    return {"setup_s": setup_s, "window": win, "gaps": gaps,
            "memory_peak_bytes": int(peak), "attempted": n}


def reference_steps(ref, config: dict, traffic: dict, seed: int, device,
                    low: bool = False) -> dict:
    """The reference's three steps: losses, the first clipped gradient's
    leaf norms, the weights' and the EMA's change by leaf after three.
    `low`: computed a precision lower (fp8 products in the DiT, bf16
    render operands), the control."""
    ref.no_tf32()
    kw = {"r": ref.fp8, "r_render": ref.bf16} if low else {}
    sm = config["system"]["shape_model"]
    w0 = weights.make(ref.param_shapes(sm), seed, device)
    w = {k: v.clone().requires_grad_(True) for k, v in w0.items()}
    e0 = ema_start(w0, seed, device)
    ema = {k: v.clone() for k, v in e0.items()}
    p = lpips_weights(ref, seed, device)
    st = {}
    gen = torch.Generator(device=device).manual_seed(seed + 2)
    feed = batches(config, traffic, seed, device)[:3]
    b = traffic["batch"]
    out = {"losses": []}
    for k, bt in enumerate(feed):
        res = config["data"]["training_res"][0]
        noise = torch.randn((b, traffic["views_in"], 3, res, res),
                            generator=gen, device=device)
        t = torch.randint(0, 1000, (b,), generator=gen, device=device)
        loss = ref.train_loss(w, p, config["system"], bt, noise, t,
                              traffic["start_step"] + k, **kw)[0]
        grads = dict(zip(w, torch.autograd.grad(loss, list(w.values()),
                                                allow_unused=True)))
        grads = {n: torch.zeros_like(w[n]) if g is None else g
                 for n, g in grads.items()}
        with torch.no_grad():
            clipped = ref.adamw(w, grads, st, config["system"]["optimizer"],
                                config["trainer"])
            ref.ema_update(ema, w, traffic["ema_decay"])
        out["losses"].append(float(loss.detach()))
        if k == 0:
            out["grad1"] = leaf_norms(clipped)
            out["raw1"] = leaf_norms(grads)
        del grads, clipped, loss
    with torch.no_grad():
        out["change"] = leaf_norms({n: w[n] - w0[n] for n in w})
        out["ema"] = leaf_norms({n: ema[n] - e0[n] for n in w})
    return out


def leaf_gaps(got: dict, want: dict, keep: list) -> dict:
    """Each kept leaf's gap of norms against the larger of the reference
    leaf's norm and the median leaf's."""
    med = float(np.median([want[n] for n in keep]))
    return {n: abs(got[n] - want[n]) / max(want[n], med) for n in keep}


def compare(got: dict, want: dict, worst: bool = False) -> dict:
    """The check's numbers (module docstring); with `worst`, also the
    worst leaf of each, by name."""
    med = float(np.median(list(want["raw1"].values())))
    keep = [n for n, g in want["raw1"].items() if g >= 1e-3 * med]
    out = {"loss_gap": max(abs(a - c) / abs(c) for a, c in
                           zip(got["losses"], want["losses"]))}
    for key, name in (("grad1", "grad_gap"), ("change", "change_gap")):
        gaps = leaf_gaps(got[key], want[key], keep)
        out[name] = float(np.median(list(gaps.values())))
        if worst:
            leaf = max(gaps, key=gaps.get)
            out[name + "_worst_leaf"] = [leaf, gaps[leaf]]
    gaps = leaf_gaps(got["ema"], want["ema"], list(want["ema"]))
    out["ema_gap"] = max(gaps.values())
    if worst:
        leaf = max(gaps, key=gaps.get)
        out["ema_gap_worst_leaf"] = [leaf, gaps[leaf]]
    return out


def check(ref, config, traffic, seed, device, got: dict) -> dict:
    with torch.enable_grad():
        want = reference_steps(ref, config, traffic, seed, device)
    if not all(np.isfinite(got["losses"])):
        return dict.fromkeys(GAPS, float("inf"))
    gaps = compare(got, want, worst=True)
    print("worst leaves (grad and change compare the median leaf): " + ", ".join(
        f"{k}: {v[0]} {v[1]:.3g}" for k, v in gaps.items()
        if k.endswith("_worst_leaf")), file=sys.stderr)
    return {k: gaps[k] for k in GAPS}


def e2e(res: dict) -> dict:
    w = res["window"]
    # (a control has no window)
    return {"train_samples_per_s": w["samples"] / w["window_s"]
            if w["samples"] else 0.0}


def window_line(res: dict) -> str:
    w = res["window"]
    return (f"window: {w['steps']} steps, {w['samples']} samples in "
            f"{w['window_s']:.3f} s; first losses {w['losses']}; peak "
            f"{res['memory_peak_bytes']} bytes")
