"""Sampling cells: closed-loop image->3D through DiffusionGSPipeline.batch.

One client sends back-to-back calls of `batch` cut-out images.  The window
starts at the first timed call and ends when the first call that finishes
after `--seconds` returns; assets_per_s is every asset it completed over
its length.

What a call produces is checked once the window has closed, against the
plain reference.  The sampler is a chain of 30 noisy steps, so the
reference follows the program step by step from the program's own state:
forward hooks on the denoiser and its block stack keep, for one call drawn
from the seed, each step's input images, timestep and Gaussians, and at
`check_steps` steps drawn from the seed (the last among them) the blocks'
input and output tokens.  Then, with the same weights, inputs and noise
made again from the seed:
  start_gap   every step's condition view and timestep, and the first
              step's noisy views, against the reference's own
              preprocessing, schedule and initial noise (exact);
  embed_gap   at the kept steps, the blocks' input tokens against the
              reference's embedding of the same images (relative L2);
  proj_gap    the four projections (qkv, proj, fc1, fc2) of one block
              drawn from the seed against the reference's f32 products
              of the same inputs, worst relative L2;
  stack_gap   the blocks' output against the reference blocks run from
              the program's block input, relative to what the blocks add;
  dit_gap     the Gaussians against the reference heads on that output,
              worst attribute's relative L2;
  step_gap    at every step, the render the program's next state implies
              through the posterior step (the last step's is the call's
              output renders) against the reference's render of the
              program's own Gaussians, RMS over pixels;
  filter_gap  values of the exported (filtered) Gaussians that differ from
              the reference filters applied to the last step's Gaussians
              (exact).
"""

from __future__ import annotations

import copy
import gc
import time

import numpy as np
import torch

from .. import generator, weights

GAPS = ("start_gap", "embed_gap", "proj_gap", "stack_gap", "dit_gap",
        "step_gap", "filter_gap")
FIELDS = ("xyz", "features", "scaling", "rotation", "opacity")
PROJ = ("attn.qkv", "attn.proj", "mlp.fc1", "mlp.fc2")


class Capture:
    """Forward hooks on the denoiser and on its block stack.  While `on`,
    every step of the call keeps its input images, timestep and the
    Gaussians the denoiser returned; the steps in `keep` also keep the
    blocks' input and output tokens."""

    def __init__(self, keep=(), block: int = 0):
        self.on = False
        self.keep = set(keep)
        self.block = block
        self.clear()

    def clear(self):
        self.images, self.t, self.stack, self.g = [], [], {}, {}
        self.proj = {}

    def attach(self, model) -> list:
        blk = model.transformer[self.block]
        hooks = [model.transformer.register_forward_hook(self._stack),
                 model.register_forward_hook(self._model)]
        for name in PROJ:
            mod = blk.get_submodule(name)
            hooks.append(mod.register_forward_hook(
                lambda m, a, o, name=name: self._proj(name, a, o)))
        return hooks

    def _proj(self, name, args, output):
        if self.on and len(self.images) in self.keep:
            self.proj.setdefault(len(self.images), {})[name] = (
                args[0].detach().float().clone(),
                output.detach().float().clone())

    def _stack(self, module, args, output):
        if self.on and len(self.images) in self.keep:
            self.stack[len(self.images)] = (args[0].detach().float().clone(),
                                            output.detach().float().clone())

    def _model(self, module, args, output):
        if self.on:
            k = len(self.images)
            self.images.append(args[0].detach().clone())
            self.t.append(args[3].detach().clone())
            self.g[k] = {f: getattr(output[0], f).detach().float().clone()
                         for f in FIELDS}


def kept_steps(seed: int, n_steps: int, count: int) -> set:
    """`count` steps of the chain drawn from the seed, the last among
    them (it makes the output)."""
    r = generator.rng(seed, 3)
    return {n_steps - 1} | {int(k) for k in r.choice(
        n_steps - 1, size=min(count, n_steps) - 1, replace=False)}


def kept_block(seed: int, n_layers: int) -> int:
    """The DiT block whose projections are checked, drawn from the seed."""
    return int(generator.rng(seed, 4).integers(0, n_layers))


def build(config: dict, device, control: str | None = None):
    """The program: the object system of the configuration with the
    seeded weights loaded, and its pipeline.  `control` "w8a8" switches
    on the program's own int8 serving path (the precision control)."""
    from open_diffusiongs_tpu_torch.pipeline import DiffusionGSPipeline
    from open_diffusiongs_tpu_torch.systems.builder import build_system
    sys_cfg = copy.deepcopy(config["system"])
    if control == "w8a8":
        sys_cfg["shape_model"]["quant_int8"] = True
    elif control is not None:
        raise ValueError(f"unknown control {control!r}")
    system = build_system(config["system_type"], sys_cfg, bf16=True,
                          device=device)
    return system, DiffusionGSPipeline(system)


def load_weights(system, ref, config: dict, seed: int, device) -> None:
    w = weights.make(ref.param_shapes(config["system"]["shape_model"]),
                     seed, device)
    system.model.load_state_dict(w, strict=True)


def inputs(traffic: dict, seed: int) -> list:
    from PIL import Image
    return [Image.fromarray(a, "RGBA") for a in
            generator.cutouts(seed, traffic["pool"], traffic["image_size"])]


def call_seed(seed: int, i: int) -> int:
    return (int(seed) * 7919 + 1 + i) % (2 ** 63)


def call_images(pool: list, traffic: dict, i: int) -> list:
    b = traffic["batch"]
    return [pool[(i * b + j) % len(pool)] for j in range(b)]


def one_call(pipe, pool, traffic, res, seed, i, stage_seconds=None):
    return pipe.batch(call_images(pool, traffic, i), seed=call_seed(seed, i),
                      foreground_ratio=traffic["foreground_ratio"],
                      resolution=res, n_views=traffic["views"],
                      opacity_thres=traffic["opacity_thres"],
                      crop_bbx=tuple(traffic["crop_bbx"]),
                      stage_seconds=stage_seconds)


def window(pipe, cap, pool, traffic, res, seed, seconds, capture_idx,
           trace_calls=0, sync=lambda: None):
    """Back-to-back calls for `seconds` (with `trace_calls` > 0: exactly
    that many calls, traced).  Returns the window's numbers and the
    captured call's outputs."""
    from .. import trace
    stages = {} if trace_calls else None
    tracer = trace.Tracer(pipe.system.model) if trace_calls else None
    if tracer:
        tracer.start()
    sync()
    t0 = time.perf_counter()
    n, captured, ends = 0, None, []
    while True:
        cap.on = n == capture_idx
        if tracer:
            tracer.mark("pipeline")
        outs = one_call(pipe, pool, traffic, res, seed, n, stages)
        ends.append(time.perf_counter() - t0)
        if cap.on:
            captured = outs
            cap.on = False
        n += 1
        if trace_calls:
            if n >= trace_calls:
                break
        elif n > capture_idx and time.perf_counter() - t0 >= seconds:
            break
    sync()
    elapsed = time.perf_counter() - t0
    out = {"calls": n, "assets": n * traffic["batch"], "window_s": elapsed,
           "captured": captured, "stage_seconds": stages,
           "call_s": np.diff([0.0] + ends).tolist()}
    if tracer:
        out["trace"] = tracer.stop()
    return out


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.linalg.norm((a - b).flatten())
                 / torch.clamp(torch.linalg.norm(b.flatten()), min=1e-30))


def check(ref, cap: Capture, outs: list, images: list, config: dict,
          traffic: dict, wseed: int, cseed: int, device,
          control: str | None = None) -> dict:
    """The gaps of one captured call (module docstring).  With `control`
    "low" the reference computed a precision lower stands in the
    program's place (fp8 products in the DiT at the kept steps, from the
    program's input images and the block's projection inputs; bf16
    Gaussians and blend operands in the render of every step) and is
    judged as the program is."""
    ref.no_tf32()
    sm = config["system"]["shape_model"]
    raster = config["system"].get("raster", {})
    res = config["data"]["training_res"][0]
    nv, b = traffic["views"], traffic["batch"]
    n_steps = config["system"].get("num_inference_steps", 30)
    gaps = dict.fromkeys(GAPS, 0.0)
    if (len(cap.images) != n_steps or len(cap.g) != n_steps
            or set(cap.stack) != cap.keep or set(cap.proj) != cap.keep
            or len(outs) != b
            or any(x.shape[0] != b for x in cap.images)
            or any(x.shape[0] != b for st in cap.stack.values() for x in st)
            or any(x.shape[0] != b for g in cap.g.values()
                   for x in g.values())):
        # a step, a row or an output the call should have made is missing
        return dict.fromkeys(GAPS, float("inf"))
    low = control == "low"
    w = weights.make(ref.param_shapes(sm), wseed, device)
    c2w_np, fxy_np = ref.object_cameras(nv, res)
    c2w = torch.from_numpy(c2w_np).to(device)
    fxy = torch.from_numpy(fxy_np).to(device)
    ray_o, ray_d = (r[None] for r in ref.pixel_rays(c2w, fxy, res, res))
    cond = torch.from_numpy(np.stack([
        ref.preprocess_rgba(np.asarray(im.convert("RGBA")), res,
                            traffic["foreground_ratio"])
        for im in images])).to(device)[:, None]
    gen = torch.Generator(device=device).manual_seed(cseed)
    shape = (b, nv - 1, 3, res, res)
    x_t = torch.randn(shape, generator=gen, device=device)
    sch = ref.schedule(n_steps)
    gaps["start_gap"] = float((cap.images[0][:, 1:] - x_t).abs().max())
    for k in range(n_steps):
        t_idx = n_steps - 1 - k
        imgs = cap.images[k]
        t_ref = torch.full((1,), int(sch.timestep_map[t_idx]),
                           dtype=torch.long, device=device)
        z = torch.randn(shape, generator=gen, device=device)
        gaps["start_gap"] = max(
            gaps["start_gap"], float((imgs[:, :1] - cond).abs().max()),
            float((cap.t[k] != t_ref).sum()))
        views = slice(1, None) if t_idx > 0 else slice(None)
        for i in range(b):
            g_obs = {f: cap.g[k][f][i] for f in FIELDS}
            if k in cap.keep:
                # the DiT, from the program's input images and block input
                e = ref.embed(w, sm, imgs[i:i + 1], ray_o, ray_d, t_ref)
                if low:
                    ec = ref.embed(w, sm, imgs[i:i + 1], ray_o, ray_d, t_ref,
                                   ref.fp8)
                    x_in = ec.x
                    x_out = ref.blocks(w, sm, x_in, ec.silu_t, ref.fp8)
                    g_obs = {f: v[0] for f, v in ref.gaussians(
                        w, sm, x_out, ec, ray_o, ray_d, ref.fp8).items()}
                else:
                    x_in = cap.stack[k][0][i:i + 1]
                    x_out = cap.stack[k][1][i:i + 1]
                gaps["embed_gap"] = max(gaps["embed_gap"], _rel(x_in, e.x))
                for name, (p_in, p_out) in cap.proj[k].items():
                    wn = f"transformer.{cap.block}.{name}"
                    p_ref = ref.product(w, wn, p_in[i])
                    p_obs = (ref.product(w, wn, p_in[i], ref.fp8) if low
                             else p_out[i])
                    gaps["proj_gap"] = max(gaps["proj_gap"],
                                           _rel(p_obs, p_ref))
                x_ref = ref.blocks(w, sm, x_in, e.silu_t)
                gaps["stack_gap"] = max(gaps["stack_gap"], float(
                    torch.linalg.norm((x_out - x_ref).flatten())
                    / torch.linalg.norm((x_ref - x_in).flatten())))
                g_ref = {f: v[0] for f, v in ref.gaussians(
                    w, sm, x_ref, e, ray_o, ray_d).items()}
                gaps["dit_gap"] = max(gaps["dit_gap"], max(
                    _rel(g_obs[f], g_ref[f]) for f in FIELDS))
                del e, x_ref, g_ref
            # the render and the sampler's step, from the Gaussians
            r_ref = ref.render(g_obs, c2w[views], fxy[views], res, res,
                               raster)
            if low:
                r_obs = ref.render(g_obs, c2w[views], fxy[views], res, res,
                                   raster, r=ref.bf16)
            elif t_idx > 0:
                r_obs = ((cap.images[k + 1][i, 1:]
                          - float(sch.coef2[t_idx]) * imgs[i, 1:]
                          - float(sch.sigma[t_idx]) * z[i])
                         / float(sch.coef1[t_idx]))
            else:
                r_obs = torch.from_numpy(outs[i].renders).to(device)
            gaps["step_gap"] = max(gaps["step_gap"], float(
                torch.sqrt(((r_obs - r_ref) ** 2).mean())))
    g_last = cap.g[n_steps - 1]
    for i in range(b):
        want = ref.filter_gaussians(
            {f: g_last[f][i].cpu().numpy() for f in FIELDS},
            traffic["opacity_thres"], traffic["crop_bbx"])
        got = outs[i].gaussians
        for f in FIELDS:
            a, c = getattr(got, f), want[f]
            gaps["filter_gap"] += (float(max(a.size, c.size))
                                   if a.shape != c.shape
                                   else float((a != c).sum()))
    return {k: float(v) for k, v in gaps.items()}


def run(cell: dict, seed: int, seconds: float, traced: bool, t_start: float,
        device, control: str | None = None, check_mode: str | None = None,
        ref=None) -> dict:
    """One run of a sampling cell; returns the harness's pieces of the
    result line.  `control` is build's, `check_mode` check's `control`."""
    from .. import harness
    config, traffic, chk = cell["config"], cell["traffic"], cell["check"]
    ref = ref or harness.reference(config["reference"])
    res = config["data"]["training_res"][0]
    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    system, pipe = build(config, device, control)
    load_weights(system, ref, config, seed, device)
    pool = inputs(traffic, seed)
    n_steps = config["system"].get("num_inference_steps", 30)
    cap = Capture(kept_steps(seed, n_steps, chk["check_steps"]),
                  kept_block(seed, config["system"]["shape_model"][
                      "num_layers"]))
    hooks = cap.attach(system.model)
    # warm-up: the window's own shapes, once, captured so that the
    # capture's buffers are in the allocator's cache before the window
    cap.on = True
    one_call(pipe, pool, traffic, res, seed, -1)
    cap.on = False
    cap.clear()
    capture_idx = int(generator.rng(seed, 2).integers(
        0, max(1, chk["capture_among"])))
    trace_calls = max(chk["trace_calls"], capture_idx + 1) if traced else 0
    # the set-up's objects go to the collector's permanent generation, as a
    # long-lived server keeps them, so that a collection in the window
    # walks only what the window made
    gc.collect()
    gc.freeze()
    sync()
    setup_s = time.perf_counter() - t_start
    win = window(pipe, cap, pool, traffic, res, seed, seconds, capture_idx,
                 trace_calls, sync)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    gc.unfreeze()
    for h in hooks:
        h.remove()
    outs = win.pop("captured")
    images = call_images(pool, traffic, capture_idx)
    del pipe, system
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    with torch.no_grad():
        gaps = check(ref, cap, outs, images, config, traffic, seed,
                     call_seed(seed, capture_idx), device, check_mode)
    return {"setup_s": setup_s, "window": win, "gaps": gaps,
            "memory_peak_bytes": int(peak), "attempted": win["assets"],
            "capture_idx": capture_idx, "raster_counters": outs[0].stats}


def e2e(res: dict) -> dict:
    w = res["window"]
    return {"assets_per_s": w["assets"] / w["window_s"]}


def window_line(res: dict) -> str:
    w = res["window"]
    return (f"window: {w['calls']} calls, {w['assets']} assets in "
            f"{w['window_s']:.3f} s (calls "
            f"{' '.join(f'{c:.3f}' for c in w['call_s'])}); captured call "
            f"{res['capture_idx']}; peak {res['memory_peak_bytes']} bytes; "
            f"its last render's counters {res['raster_counters']}")


def readings(cell: dict, seed: int, count: int, device,
             control: str | None = None):
    """The check's numbers of seeds seed .. seed + count - 1, one captured
    call each, the program built once, one row each: the program's (with
    `control` "w8a8" its int8 path's) and, from the same call, the
    reference's a precision lower in its place (check's control "low")."""
    from .. import harness
    config, traffic = cell["config"], cell["traffic"]
    ref = harness.reference(config["reference"])
    res = config["data"]["training_res"][0]
    n_steps = config["system"].get("num_inference_steps", 30)
    system, pipe = build(config, device, control)
    for s in range(seed, seed + count):
        t0 = time.perf_counter()
        load_weights(system, ref, config, s, device)
        pool = inputs(traffic, s)
        cap = Capture(kept_steps(s, n_steps, cell["check"]["check_steps"]),
                      kept_block(s, config["system"]["shape_model"][
                          "num_layers"]))
        hooks = cap.attach(system.model)
        cap.on = True
        outs = one_call(pipe, pool, traffic, res, s, 0)
        cap.on = False
        for h in hooks:
            h.remove()
        t1 = time.perf_counter()
        row = {"seed": s, "control": control, "call_s": t1 - t0}
        for mode in (None, "low"):
            with torch.no_grad():
                row["gaps" if mode is None else "low_gaps"] = check(
                    ref, cap, outs, call_images(pool, traffic, 0), config,
                    traffic, s, call_seed(s, 0), device, mode)
            row["check_s" if mode is None else "low_check_s"] = (
                time.perf_counter() - t1)
            t1 = time.perf_counter()
        del cap, outs
        yield row
